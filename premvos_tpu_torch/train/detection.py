"""Mask R-CNN training: target assignment and losses (port of
premvos_tpu/train/detection.py).

The assignment functions and the losses take one image, as the JAX functions
do under `vmap`; `maskrcnn_loss_fn` runs the networks batched and the
per-image part in a loop over the batch, then averages over images, so every
mask sum and positive count normalizes one image.

Two choices differ in form from the JAX package, not in result:

  * The best anchor of each valid GT is forced positive with OR semantics:
    an anchor is forced if any valid GT picks it. The JAX scatter
    `force.at[best_anchor_per_gt].set(gt_valid)` lets a padded GT (IoU −1
    everywhere, so its argmax is anchor 0) write False over a valid GT's
    True at anchor 0, in an undefined order.
  * `mask_targets` crops all G GT masks at every proposal and keeps each
    proposal's matched one, instead of first gathering a [K, H, W] copy of
    the matched masks (at 480×864 and K = 256 that copy is 425 MB per image;
    the crops' largest intermediate is [K, G, R, W], 198 MB at G = 8).
"""

from __future__ import annotations

import torch

from premvos_tpu_torch.models.maskrcnn import multilevel_roi_align
from premvos_tpu_torch.models.rpn import top_k
from premvos_tpu_torch.ops.boxes import box_iou, encode_boxes
from premvos_tpu_torch.ops.roi_align import crop_and_resize
from premvos_tpu_torch.train.losses import (
    sigmoid_focal, sigmoid_xent, smooth_l1, softmax_xent,
)


def _match(anchors, gt_boxes, gt_valid):
    """IoU against the valid GTs (−1 for padded ones), each anchor's best GT
    and IoU, and the anchors forced positive as some valid GT's best."""
    iou = box_iou(anchors, gt_boxes)  # [A, G]
    iou = torch.where(gt_valid[None, :], iou, torch.full_like(iou, -1.0))
    best_gt = torch.argmax(iou, dim=1)
    best_iou = torch.amax(iou, dim=1)
    best_anchor_per_gt = torch.argmax(iou, dim=0)  # [G]
    hits = torch.zeros(anchors.shape[0], dtype=torch.int32, device=anchors.device)
    hits.index_add_(0, best_anchor_per_gt, gt_valid.to(torch.int32))
    return best_gt, best_iou, hits > 0


def assign_rpn_targets(
    anchors: torch.Tensor,
    gt_boxes: torch.Tensor,
    gt_valid: torch.Tensor,
    generator: torch.Generator,
    pos_iou: float = 0.7,
    neg_iou: float = 0.3,
    num_samples: int = 256,
    pos_fraction: float = 0.5,
):
    """Label anchors and pick a balanced training sample (top-k over random
    priorities drawn from `generator`, which lives on the anchors' device).

    Returns (labels [A] ∈ {1 pos, 0 neg, −1 ignore after sampling},
             box_targets [A, 4]).
    """
    a = anchors.shape[0]
    best_gt, best_iou, force = _match(anchors, gt_boxes, gt_valid)
    pos = (best_iou >= pos_iou) | force
    neg = (best_iou < neg_iou) & ~pos

    k_pos = int(num_samples * pos_fraction)
    k_neg = num_samples - k_pos
    u = torch.rand((2, a), generator=generator, device=anchors.device)
    minus = torch.full_like(u[0], -1.0)
    _, pos_idx = top_k(torch.where(pos, u[0], minus), min(k_pos, a))
    _, neg_idx = top_k(torch.where(neg, u[1], minus), min(k_neg, a))

    labels = torch.full((a,), -1, dtype=torch.int32, device=anchors.device)
    none = torch.full_like(labels, -1)
    labels[pos_idx] = torch.where(pos[pos_idx], 1, none[pos_idx])
    labels[neg_idx] = torch.where(neg[neg_idx], 0, none[neg_idx])
    return labels, encode_boxes(gt_boxes[best_gt], anchors)


def rpn_loss(logits, deltas, labels, box_targets):
    """logits [A], deltas [A, 4] vs assign_rpn_targets output."""
    valid = (labels >= 0).to(logits.dtype)
    pos = (labels == 1).to(logits.dtype)
    cls = sigmoid_xent(logits, pos, mask=valid)
    box = smooth_l1(deltas, box_targets, mask=pos)
    return cls, box


def assign_rpn_labels_dense(
    anchors: torch.Tensor,
    gt_boxes: torch.Tensor,
    gt_valid: torch.Tensor,
    pos_iou: float = 0.7,
    neg_iou: float = 0.3,
):
    """IoU-threshold labels for every anchor, no sampling.

    Returns (labels [A] ∈ {1 pos, 0 neg, −1 ignore in the IoU dead band},
             box_targets [A, 4]).
    """
    best_gt, best_iou, force = _match(anchors, gt_boxes, gt_valid)
    pos = (best_iou >= pos_iou) | force
    neg = (best_iou < neg_iou) & ~pos
    labels = torch.where(
        pos, 1, torch.where(neg, 0, -1)
    ).to(torch.int32)
    return labels, encode_boxes(gt_boxes[best_gt], anchors)


def rpn_dense_loss(logits, deltas, labels, box_targets,
                   alpha: float = 0.25, gamma: float = 2.0):
    """Focal objectness over all labeled anchors (normalized by #pos) +
    smooth-L1 box loss on positives."""
    valid = (labels >= 0).to(logits.dtype)
    pos = (labels == 1).to(logits.dtype)
    cls = sigmoid_focal(logits, pos, alpha=alpha, gamma=gamma, mask=valid,
                        norm=pos.sum())
    box = smooth_l1(deltas, box_targets, mask=pos)
    return cls, box


def assign_roi_targets(
    proposals: torch.Tensor,
    prop_valid: torch.Tensor,
    gt_boxes: torch.Tensor,
    gt_valid: torch.Tensor,
    fg_iou: float = 0.5,
):
    """Label proposals for the second stage.

    Returns (cls_labels [K] ∈ {0 bg, 1 fg}, matched_gt [K] int,
             box_targets [K, 4], fg [K] bool, valid [K] bool).
    """
    iou = box_iou(proposals, gt_boxes)
    iou = torch.where(gt_valid[None, :], iou, torch.full_like(iou, -1.0))
    best_gt = torch.argmax(iou, dim=1)
    best_iou = torch.amax(iou, dim=1)
    fg = (best_iou >= fg_iou) & prop_valid
    box_targets = encode_boxes(gt_boxes[best_gt], proposals)
    return fg.to(torch.int32), best_gt, box_targets, fg, prop_valid


def mask_targets(
    gt_masks: torch.Tensor,
    matched_gt: torch.Tensor,
    proposals: torch.Tensor,
    resolution: int,
    image_hw: tuple,
):
    """Crop each proposal's matched GT mask ([G, H, W]) to [K, R, R] targets
    (exact crop_and_resize at the proposal box)."""
    h, w = image_hw
    norm = torch.stack(
        [
            proposals[:, 1] / (h - 1),
            proposals[:, 0] / (w - 1),
            proposals[:, 3] / (h - 1),
            proposals[:, 2] / (w - 1),
        ],
        dim=-1,
    )
    crops = crop_and_resize(gt_masks[None], norm[None], resolution)[0]  # [K, G, R, R]
    return crops[torch.arange(crops.shape[0], device=crops.device), matched_gt]


def detection_loss(
    cls_logits,
    box_deltas,
    mask_logits,
    cls_labels,
    box_targets,
    mask_tgts,
    fg,
    valid,
):
    """Second-stage loss triple (cls, box, mask)."""
    vmask = valid.to(cls_logits.dtype)
    fmask = (fg & valid).to(cls_logits.dtype)
    cls = softmax_xent(cls_logits, cls_labels, mask=vmask)
    box = smooth_l1(box_deltas, box_targets, mask=fmask)
    # Per-pixel mask loss only on foreground RoIs.
    pix_mask = fmask[:, None, None] * torch.ones_like(mask_logits)
    mask = sigmoid_xent(mask_logits, (mask_tgts > 0.5).to(mask_logits.dtype),
                        mask=pix_mask)
    return cls, box, mask


def maskrcnn_loss_fn(model, anchors: dict, cfg, image_hw, seed: int = 0):
    """Build a loss(batch) closure over `model` for the train step.

    batch = (images [B, H, W, 3] normalized, gt_boxes [B, G, 4], gt_masks
    [B, G, H, W], gt_valid [B, G][, seeds [B] per-image sampling seeds]), on
    the model's device except `seeds` (host integers). The seeds, or else
    `seed` (the same draw every step), seed the sampled RPN loss
    (cfg.rpn_loss "sampled"); the dense loss draws nothing.
    """
    flat_anchors = torch.cat([anchors[k] for k in sorted(anchors)], dim=0)

    def loss_fn(batch):
        images, gt_boxes, gt_masks, gt_valid = batch[:4]
        seeds = batch[4] if len(batch) == 5 else None
        b = images.shape[0]
        fmt = torch.channels_last if images.is_cuda else torch.contiguous_format
        feats = model.features(images.permute(0, 3, 1, 2).contiguous(memory_format=fmt))
        logits, deltas = model.rpn_outputs(feats)
        # Proposals are constants (the JAX package's stop_gradient): the RPN
        # trains through its own loss only, and RoIAlign needs no box
        # gradient.
        with torch.no_grad():
            rois, _, roi_valid = model.proposals(feats, anchors, image_hw, rpn=(logits, deltas))
        flat_logits = torch.cat([logits[k] for k in sorted(logits)], dim=1)
        flat_deltas = torch.cat([deltas[k] for k in sorted(deltas)], dim=1)

        k = rois.shape[1]
        rf = multilevel_roi_align(feats, rois, cfg.roi_align_size)
        cls_logits, box_deltas = model.box_head(rf.reshape(b * k, -1))
        mf = multilevel_roi_align(feats, rois, cfg.mask_roi_align_size)
        p = mf.shape[2]
        m_logits = model.mask_head(mf.reshape(b * k, p, p, -1).permute(0, 3, 1, 2))
        r = m_logits.shape[-1]
        cls_logits = cls_logits.reshape(b, k, -1)
        box_deltas = box_deltas.reshape(b, k, 4)
        m_logits = m_logits.reshape(b, k, r, r)

        gen = None
        losses = []
        for i in range(b):
            if cfg.rpn_loss == "dense":
                labels, tgts = assign_rpn_labels_dense(flat_anchors, gt_boxes[i], gt_valid[i])
                l_rpn_cls, l_rpn_box = rpn_dense_loss(
                    flat_logits[i], flat_deltas[i], labels, tgts,
                    alpha=cfg.focal_alpha, gamma=cfg.focal_gamma,
                )
            else:
                if seeds is not None:
                    gen = torch.Generator(device=images.device).manual_seed(int(seeds[i]))
                elif gen is None:
                    gen = torch.Generator(device=images.device).manual_seed(seed)
                labels, tgts = assign_rpn_targets(flat_anchors, gt_boxes[i], gt_valid[i], gen)
                l_rpn_cls, l_rpn_box = rpn_loss(flat_logits[i], flat_deltas[i], labels, tgts)

            cls_labels, matched, box_tgts, fg, valid = assign_roi_targets(
                rois[i], roi_valid[i], gt_boxes[i], gt_valid[i]
            )
            m_tgts = mask_targets(gt_masks[i], matched, rois[i], r, image_hw)
            l_cls, l_box, l_mask = detection_loss(
                cls_logits[i], box_deltas[i], m_logits[i], cls_labels, box_tgts,
                m_tgts, fg, valid,
            )
            losses.append(l_rpn_cls + l_rpn_box + l_cls + l_box + l_mask)
        return torch.stack(losses).mean()

    return loss_fn
