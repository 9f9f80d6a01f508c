"""Stage 3 helpers: backward mask warping by flow (port of
premvos_tpu/stages/flow.py). Flow is [2, H, W] (u, v), current → previous
frame; warping pulls each current pixel's value from the previous frame."""

from __future__ import annotations

import torch

from premvos_tpu_torch.ops.resample2d import resample2d
from premvos_tpu_torch.ops.resize import resize_bilinear


def warp_masks(masks: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """Backward-warp [K, H, W] masks by one [2, H, W] flow: the K masks are
    the channels of one exact bilinear warp."""
    return resample2d(masks[None], flow[None])[0]


def warp_masks_coarse(masks: torch.Tensor, flow: torch.Tensor, stride: int) -> torch.Tensor:
    """Warp at 1/stride resolution, then upsample bilinearly (stride 1 is the
    full-resolution warp). Downsampling antialiases, as jax.image.resize."""
    if stride <= 1:
        return warp_masks(masks, flow)
    h, w = masks.shape[-2:]
    hs, ws = h // stride, w // stride
    flow_s = resize_bilinear(flow[None], (hs, ws))[0] / float(stride)
    masks_s = resize_bilinear(masks[None], (hs, ws))[0]
    warped_s = warp_masks(masks_s, flow_s)
    return resize_bilinear(warped_s[None], (h, w))[0]
