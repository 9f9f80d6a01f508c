"""Train-time metrics (port of premvos_tpu/eval/metrics.py).

The OnAVOS-family engines report per-step measures (pixel accuracy, IoU)
alongside the loss; these are tensor versions, mask-aware for padded
batches, on whatever device their inputs live on.
"""

from __future__ import annotations

import torch

from premvos_tpu_torch.stages.reid import pairwise_sq_distances


def pixel_accuracy(logits, labels, mask=None):
    """Binary segmentation accuracy from logits; labels ∈ {0, 1}."""
    pred = (logits > 0).to(torch.float32)
    correct = (pred == labels).to(torch.float32)
    if mask is not None:
        correct = correct * mask
        return correct.sum() / torch.clamp(mask.sum(), min=1.0)
    return correct.mean()


def binary_iou(logits, labels, mask=None, eps: float = 1.0):
    """Mean foreground IoU over the batch from logits; labels ∈ {0, 1}.

    logits/labels: [B, ...]; mask: optional same-shape element validity.
    """
    pred = (logits > 0).to(torch.float32)
    lab = (labels > 0.5).to(torch.float32)
    if mask is not None:
        pred = pred * mask
        lab = lab * mask
    dims = tuple(range(1, pred.ndim))
    inter = (pred * lab).sum(dims)
    union = pred.sum(dims) + lab.sum(dims) - inter
    return ((inter + eps) / (union + eps)).mean()


def embedding_retrieval_accuracy(emb, ids, mask=None):
    """Top-1 same-identity retrieval accuracy (ReID training measure):
    fraction of anchors whose nearest other embedding shares their id."""
    d = pairwise_sq_distances(emb, emb)
    n = emb.shape[0]
    big = torch.tensor(1e9, dtype=d.dtype, device=d.device)
    d = torch.where(torch.eye(n, dtype=torch.bool, device=d.device), big, d)
    if mask is not None:
        d = torch.where(mask[:, None] & mask[None, :], d, big)
    nearest = torch.argmin(d, dim=1)
    correct = (ids[nearest] == ids).to(torch.float32)
    if mask is not None:
        correct = correct * mask
        return correct.sum() / torch.clamp(mask.sum(), min=1.0)
    return correct.mean()
