"""Anchor generation for the RPN (port of premvos_tpu/models/anchors.py).

Anchors are laid out [H, W, A] per level — the order in which the RPN's
outputs are flattened (models/rpn.py).
"""

from __future__ import annotations

import numpy as np

from premvos_tpu_torch.models.fpn import FPN_LEVELS, FPN_STRIDES


def level_anchors(feat_h: int, feat_w: int, stride: int, scale: float, ratios) -> np.ndarray:
    """[feat_h * feat_w * A, 4] xyxy anchors for one pyramid level."""
    cy = (np.arange(feat_h) + 0.5) * stride
    cx = (np.arange(feat_w) + 0.5) * stride
    ws = np.asarray([scale / np.sqrt(r) for r in ratios])[None, None, :]
    hs = np.asarray([scale * np.sqrt(r) for r in ratios])[None, None, :]
    cxg = cx[None, :, None]
    cyg = cy[:, None, None]
    shape = (feat_h, feat_w, len(ratios))
    boxes = np.stack(
        [
            np.broadcast_to(cxg - ws / 2, shape),
            np.broadcast_to(cyg - hs / 2, shape),
            np.broadcast_to(cxg + ws / 2, shape),
            np.broadcast_to(cyg + hs / 2, shape),
        ],
        axis=-1,
    )
    return boxes.reshape(-1, 4).astype(np.float32)


def pyramid_anchors(image_h: int, image_w: int, scales, ratios) -> dict:
    """{level: [Ni, 4]} anchors for every FPN level of a padded image."""
    out = {}
    for lvl, scale in zip(FPN_LEVELS, scales):
        s = FPN_STRIDES[lvl]
        fh, fw = (image_h + s - 1) // s, (image_w + s - 1) // s
        out[lvl] = level_anchors(fh, fw, s, scale, ratios)
    return out
