"""Stage 1: category-agnostic mask proposals (port of
premvos_tpu/stages/proposals.py). The 28×28 mask logits stay in box frame;
`proposal_masks_fullres` pastes them where a full-resolution mask is
needed (the five-stage pipeline's JSON)."""

from __future__ import annotations

import torch

from premvos_tpu_torch.data.preprocess import normalize
from premvos_tpu_torch.ops.masks import paste_mask


def run_proposals(model, images, anchors) -> dict:
    """images [T, H, W, 3] raw RGB (uint8 or [0, 1]) on the model's device;
    H, W 32-multiples. Returns the detection dict of padded tensors: boxes
    [T, N, 4], scores [T, N], valid [T, N], mask_logits [T, N, 28, 28]."""
    from premvos_tpu_torch.pipeline.runner import float32_precision

    fmt = torch.channels_last if images.is_cuda else torch.contiguous_format
    with torch.inference_mode(), float32_precision():
        x = normalize(images).permute(0, 3, 1, 2).contiguous(memory_format=fmt)
        return model(x, anchors)


def proposal_masks_fullres(boxes, mask_logits, valid, height: int, width: int):
    """Paste box-frame mask logits [N, M, M] of xyxy boxes [N, 4] into
    [N, height, width] probabilities, float32 (0 where not `valid` [N])."""
    probs = torch.sigmoid(mask_logits.to(torch.float32))
    pasted = paste_mask(probs, boxes, height, width)
    return pasted * valid[:, None, None].to(pasted.dtype)
