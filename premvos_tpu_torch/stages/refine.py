"""Stage 2: proposal refinement (port of premvos_tpu/stages/refine.py),
batched over frames.

Crop extraction and paste-back are the interpolation matmuls of
ops.roi_align.crop_and_resize and ops.masks.paste_mask; `precision` is
RefineConfig.interp_precision ("highest" = float32, "default" = bfloat16
operands).
"""

from __future__ import annotations

import torch

from premvos_tpu_torch.ops.masks import paste_mask
from premvos_tpu_torch.ops.roi_align import crop_and_resize


def expand_boxes(boxes: torch.Tensor, margin: float, height, width) -> torch.Tensor:
    """Margin-expand xyxy boxes and clip to the image."""
    return torch.stack(
        [
            torch.clamp(boxes[..., 0] - margin, 0, width),
            torch.clamp(boxes[..., 1] - margin, 0, height),
            torch.clamp(boxes[..., 2] + margin, 0, width),
            torch.clamp(boxes[..., 3] + margin, 0, height),
        ],
        dim=-1,
    )


def make_refine_crops(image, boxes, mask_logits, crop_size=385, margin=50.0,
                      precision=None):
    """4-channel refinement inputs.

    image [B, 3, H, W] normalized; boxes [B, N, 4] xyxy; mask_logits
    [B, N, M, M] box-frame coarse masks. Returns (crops [B, N, 4, S, S],
    crop_boxes [B, N, 4]).
    """
    h, w = image.shape[-2:]
    crop_boxes = expand_boxes(boxes, margin, h, w)
    norm = torch.stack(
        [
            crop_boxes[..., 1] / (h - 1),
            crop_boxes[..., 0] / (w - 1),
            crop_boxes[..., 3] / (h - 1),
            crop_boxes[..., 2] / (w - 1),
        ],
        dim=-1,
    )
    rgb = crop_and_resize(image, norm, crop_size, precision)  # [B, N, 3, S, S]

    # Mask channel: the coarse box-frame mask pasted into crop coordinates.
    cw = torch.clamp(crop_boxes[..., 2] - crop_boxes[..., 0], min=1e-6)
    ch = torch.clamp(crop_boxes[..., 3] - crop_boxes[..., 1], min=1e-6)
    sx = crop_size / cw
    sy = crop_size / ch
    box_in_crop = torch.stack(
        [
            (boxes[..., 0] - crop_boxes[..., 0]) * sx,
            (boxes[..., 1] - crop_boxes[..., 1]) * sy,
            (boxes[..., 2] - crop_boxes[..., 0]) * sx,
            (boxes[..., 3] - crop_boxes[..., 1]) * sy,
        ],
        dim=-1,
    )
    probs = torch.sigmoid(mask_logits.to(torch.float32))
    mask_ch = paste_mask(probs, box_in_crop, crop_size, crop_size, precision)
    return torch.cat([rgb, mask_ch[:, :, None]], dim=2), crop_boxes


def refined_fullres(refine_logits, crop_boxes, valid, height, width, precision=None):
    """[..., N, S, S] crop-frame logits → [..., N, H, W] soft masks (0 where
    invalid), float32."""
    probs = torch.sigmoid(refine_logits.to(torch.float32))
    pasted = paste_mask(probs, crop_boxes, height, width, precision)
    return pasted * valid[..., None, None].to(pasted.dtype)


def run_refine(model, image, boxes, mask_logits, valid, cfg):
    """Refine one frame's proposals → (crop-frame logits [N, S, S], zero
    where not `valid` [N]; crop boxes [N, 4]), as the JAX run_refine.

    image [3, H, W] normalized; boxes [N, 4] xyxy; mask_logits [N, M, M];
    cfg a RefineConfig (crops and pastes at its interp_precision). Paste
    the logits with `refined_fullres` where full-resolution masks are
    needed.
    """
    from premvos_tpu_torch.pipeline.runner import float32_precision

    s = cfg.crop_size
    fmt = torch.channels_last if image.is_cuda else torch.contiguous_format
    with torch.inference_mode(), float32_precision():
        crops, crop_boxes = make_refine_crops(
            image[None], boxes[None], mask_logits[None], s, cfg.box_margin,
            cfg.interp_precision,
        )
        logits = model(crops[0].contiguous(memory_format=fmt)).reshape(-1, s, s)
        logits = logits * valid[:, None, None].to(logits.dtype)
    return logits, crop_boxes[0]
