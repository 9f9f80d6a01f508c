"""Region Proposal Network head + padded proposal generation (port of
premvos_tpu/models/rpn.py), batched over images."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from premvos_tpu_torch.models.layers import Conv
from premvos_tpu_torch.ops.boxes import clip_boxes, decode_boxes
from premvos_tpu_torch.ops.nms import NEG_INF, nms


class RPNHead(nn.Module):
    """Shared 3×3 conv + 1×1 objectness/deltas, applied per level."""

    def __init__(self, num_anchors=3, channels=256, dtype=torch.float32):
        super().__init__()
        self.num_anchors = num_anchors
        self.Conv_0 = Conv(channels, channels, 3, padding=1, dtype=dtype)
        self.Conv_1 = Conv(channels, num_anchors, 1, dtype=dtype)
        self.Conv_2 = Conv(channels, num_anchors * 4, 1, dtype=dtype)

    def forward(self, feat):
        x = F.relu(self.Conv_0(feat))
        b, _, h, w = feat.shape
        # Flatten in [H, W, A] order, the anchors' order.
        logits = self.Conv_1(x).permute(0, 2, 3, 1).reshape(b, h * w * self.num_anchors)
        deltas = self.Conv_2(x).permute(0, 2, 3, 1).reshape(b, h * w * self.num_anchors, 4)
        return logits, deltas


def top_k(x: torch.Tensor, k: int):
    """Top-k along the last axis with ties broken toward the lower index
    (lax.top_k's order; torch.topk does not promise one)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def generate_proposals(
    level_logits: dict,
    level_deltas: dict,
    level_anchors: dict,
    image_hw: tuple,
    pre_nms_topk: int = 1024,
    post_nms_topk: int = 256,
    nms_threshold: float = 0.7,
):
    """Per-level top-k → decode → clip → joint padded NMS, batched.

    level_logits [B, Ni], level_deltas [B, Ni, 4], level_anchors [Ni, 4].
    Returns (boxes [B, K, 4], scores [B, K], valid [B, K]), K = post_nms_topk.
    """
    h, w = image_hw
    all_boxes, all_scores = [], []
    for lvl, logits in level_logits.items():
        deltas = level_deltas[lvl]
        anchors = level_anchors[lvl]
        k = min(pre_nms_topk, logits.shape[-1])
        top_scores, idx = top_k(logits, k)
        d = torch.gather(deltas, 1, idx[..., None].expand(*idx.shape, 4))
        boxes = clip_boxes(decode_boxes(d, anchors[idx]), float(h), float(w))
        all_boxes.append(boxes)
        all_scores.append(top_scores)

    boxes = torch.cat(all_boxes, dim=1)
    scores = torch.cat(all_scores, dim=1)
    idx, keep = nms(
        boxes,
        torch.sigmoid(scores.to(torch.float32)),
        max_outputs=post_nms_topk,
        iou_threshold=nms_threshold,
        score_threshold=0.0,
        valid=scores > NEG_INF / 2,
    )
    safe = torch.clamp(idx, min=0).to(torch.int64)
    picked = torch.gather(boxes, 1, safe[..., None].expand(*safe.shape, 4))
    out_boxes = torch.where(keep[..., None], picked, torch.zeros_like(picked))
    out_scores = torch.where(
        keep,
        torch.sigmoid(torch.gather(scores, 1, safe).to(torch.float32)),
        torch.zeros(keep.shape, device=keep.device),
    )
    return out_boxes, out_scores, keep
