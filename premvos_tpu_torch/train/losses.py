"""Training losses (port of premvos_tpu/train/losses.py): Mask R-CNN's,
the ReID net's batch-hard triplet loss and FlowNet's (multi-scale)
endpoint error.

Mask-aware for padded batches: a masked loss is sum(loss · mask) /
max(mask.sum(), 1), and a loss with an explicit normalizer divides by
max(norm, 1), as in the JAX package. Flows are NCHW here ([B, 2, H, W],
the components on axis 1), where the JAX package's are NHWC.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from premvos_tpu_torch.ops.resize import resize_bilinear
from premvos_tpu_torch.stages.reid import pairwise_sq_distances


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


def batch_hard_triplet(emb, ids, margin: float = 0.2, mask=None):
    """Batch-hard triplet loss (hardest positive and hardest negative per
    anchor; soft margin, softplus, when margin < 0).

    emb: [B, E]; ids: [B] int identity labels; mask: [B] valid rows. The
    masked distances are selected with `torch.where`, so they get no
    gradient, and ties at the hardest pair share it, as under JAX.
    """
    d = torch.sqrt(pairwise_sq_distances(emb, emb) + 1e-12)
    same = ids[:, None] == ids[None, :]
    eye = torch.eye(emb.shape[0], dtype=torch.bool, device=emb.device)
    if mask is not None:
        mask = mask.to(torch.bool)
        valid_pair = mask[:, None] & mask[None, :]
    else:
        valid_pair = torch.ones_like(same)
    pos = same & ~eye & valid_pair
    neg = ~same & valid_pair

    hardest_pos = torch.amax(torch.where(pos, d, torch.zeros_like(d)), dim=1)
    hardest_neg = torch.amin(torch.where(neg, d, torch.full_like(d, float("inf"))), dim=1)
    has_both = pos.any(dim=1) & neg.any(dim=1)
    diff = hardest_pos - hardest_neg
    if margin >= 0:
        per = torch.maximum(diff + margin, torch.zeros_like(diff))
    else:  # soft margin
        per = torch.logaddexp(diff, torch.zeros_like(diff))
    per = torch.where(has_both, per, torch.zeros_like(per))
    return per.sum() / torch.clamp(has_both.sum(), min=1)


def endpoint_error(pred, target, mask=None):
    """Mean flow endpoint error ‖pred − target‖₂ over pixels: pred, target
    [B, 2, H, W]; mask [B, H, W]."""
    epe = torch.sqrt(torch.sum((pred - target) ** 2, dim=1) + 1e-12)
    return _masked_mean(epe, mask)


def multiscale_epe(pred_flows, target, weights=None):
    """FlowNet multi-scale EPE: a coarse → fine list of [B, 2, h_i, w_i]
    predictions against a full-resolution target [B, 2, H, W], resized
    to each scale (jax.image.resize semantics: antialiased when it
    shrinks) and scaled by the width ratio. The default weights put 0.32
    on the finest flow."""
    weights = weights or (0.32, 0.08, 0.02, 0.01, 0.005)[: len(pred_flows)][::-1]
    total = 0.0
    for wgt, p in zip(weights, pred_flows):
        t = resize_bilinear(target, tuple(p.shape[-2:]))
        scale = p.shape[-1] / target.shape[-1]
        total = total + wgt * endpoint_error(p, t * scale)
    return total
