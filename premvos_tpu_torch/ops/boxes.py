"""Box utilities, xyxy float coordinates (port of premvos_tpu/ops/boxes.py).

All functions broadcast over leading dimensions and work on padded arrays
(callers carry validity masks).
"""

from __future__ import annotations

import torch

# Faster R-CNN box-delta clamp: log(1000/16).
BBOX_XFORM_CLIP = 4.135166556742356


def box_area(boxes: torch.Tensor) -> torch.Tensor:
    """Area of [..., 4] xyxy boxes."""
    w = torch.clamp(boxes[..., 2] - boxes[..., 0], min=0.0)
    h = torch.clamp(boxes[..., 3] - boxes[..., 1], min=0.0)
    return w * h


def box_iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Pairwise IoU between [..., N, 4] and [..., M, 4] boxes → [..., N, M]."""
    lt = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    rb = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    wh = torch.clamp(rb - lt, min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    union = box_area(a)[..., :, None] + box_area(b)[..., None, :] - inter
    return torch.where(
        union > 0, inter / torch.clamp(union, min=1e-12), torch.zeros_like(inter)
    )


def clip_boxes(boxes: torch.Tensor, height, width) -> torch.Tensor:
    """Clip xyxy boxes to [0, width] x [0, height]."""
    return torch.stack(
        [
            torch.clamp(boxes[..., 0], 0.0, width),
            torch.clamp(boxes[..., 1], 0.0, height),
            torch.clamp(boxes[..., 2], 0.0, width),
            torch.clamp(boxes[..., 3], 0.0, height),
        ],
        dim=-1,
    )


def decode_boxes(deltas: torch.Tensor, anchors: torch.Tensor) -> torch.Tensor:
    """Apply (dx, dy, dw, dh) deltas to anchors → xyxy boxes."""
    aw = anchors[..., 2] - anchors[..., 0]
    ah = anchors[..., 3] - anchors[..., 1]
    ax = anchors[..., 0] + 0.5 * aw
    ay = anchors[..., 1] + 0.5 * ah

    dx, dy = deltas[..., 0], deltas[..., 1]
    dw = torch.clamp(deltas[..., 2], max=BBOX_XFORM_CLIP)
    dh = torch.clamp(deltas[..., 3], max=BBOX_XFORM_CLIP)

    cx = dx * aw + ax
    cy = dy * ah + ay
    w = torch.exp(dw) * aw
    h = torch.exp(dh) * ah
    return torch.stack(
        [cx - 0.5 * w, cy - 0.5 * h, cx + 0.5 * w, cy + 0.5 * h], dim=-1
    )
