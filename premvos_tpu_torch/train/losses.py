"""Training losses of Mask R-CNN (port of premvos_tpu/train/losses.py).

Mask-aware for padded batches: a masked loss is sum(loss · mask) /
max(mask.sum(), 1), and a loss with an explicit normalizer divides by
max(norm, 1), as in the JAX package. `batch_hard_triplet`, `endpoint_error`
and `multiscale_epe` come with the ReID and flow training engines.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _masked_mean(loss: torch.Tensor, mask) -> torch.Tensor:
    if mask is None:
        return loss.mean()
    return (loss * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def sigmoid_xent(logits, labels, mask=None):
    """Mean binary cross-entropy from logits; optional element mask."""
    loss = -(labels * F.logsigmoid(logits) + (1.0 - labels) * F.logsigmoid(-logits))
    return _masked_mean(loss, mask)


def softmax_xent(logits, labels, mask=None):
    """Mean categorical cross-entropy; integer labels; optional row mask."""
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, labels[..., None].to(torch.int64))[..., 0]
    return _masked_mean(nll, mask)


def smooth_l1(pred, target, beta: float = 1.0 / 9.0, mask=None):
    """Huber / smooth-L1 over the last axis, averaged over valid rows."""
    d = torch.abs(pred - target)
    loss = torch.where(d < beta, 0.5 * d * d / beta, d - 0.5 * beta).sum(-1)
    return _masked_mean(loss, mask)


def sigmoid_focal(logits, labels, alpha: float = 0.25, gamma: float = 2.0,
                  mask=None, norm=None):
    """Sigmoid focal loss (RetinaNet) from logits.

    labels ∈ {0, 1} float; mask zeroes ignored elements; `norm` overrides
    the normalizer (RetinaNet convention: number of positives, min 1).
    """
    p = torch.sigmoid(logits)
    ce = -(labels * F.logsigmoid(logits) + (1.0 - labels) * F.logsigmoid(-logits))
    p_t = labels * p + (1.0 - labels) * (1.0 - p)
    a_t = labels * alpha + (1.0 - labels) * (1.0 - alpha)
    loss = a_t * torch.pow(1.0 - p_t, gamma) * ce
    if mask is not None:
        loss = loss * mask
    if norm is None:
        norm = mask.sum() if mask is not None else loss.numel()
    return loss.sum() / torch.clamp(torch.as_tensor(norm, dtype=loss.dtype, device=loss.device), min=1.0)
