"""Category-agnostic Mask R-CNN proposal generator (port of
premvos_tpu/models/maskrcnn.py), batched over images.

Every output is fixed-shape and padded with validity masks, as in the JAX
package. RoIAlign samples each RoI on its own FPN level, by one of two
functions named after their JAX counterparts: `multilevel_roi_align_auto`
(inference, the fused multilevel kernel) and `multilevel_roi_align`
(training, differentiable in the features).
"""

from __future__ import annotations

import torch
from torch import nn

from premvos_tpu_torch.config import ProposalConfig
from premvos_tpu_torch.models.fpn import FPN
from premvos_tpu_torch.models.heads import BoxHead, MaskHead
from premvos_tpu_torch.models.resnet import ResNet
from premvos_tpu_torch.models.rpn import RPNHead, generate_proposals
from premvos_tpu_torch.ops.boxes import box_area, clip_boxes, decode_boxes
from premvos_tpu_torch.ops.nms import nms
from premvos_tpu_torch.ops import roi_align

ALIGN_LEVELS = ("P2", "P3", "P4", "P5")


def roi_levels(boxes: torch.Tensor) -> torch.Tensor:
    """FPN level assignment: floor(4 + log2(sqrt(area)/224)), clipped to 2..5."""
    scale = torch.sqrt(torch.clamp(box_area(boxes), min=1e-6))
    lvl = torch.floor(4.0 + torch.log2(scale / 224.0 + 1e-12))
    return torch.clamp(lvl, 2, 5).to(torch.int32)


def multilevel_roi_align_auto(
    feats: dict, boxes: torch.Tensor, output_size: int, sampling_ratio: int = 2
) -> torch.Tensor:
    """RoIAlign over P2..P5, each RoI on its level from `roi_levels`, for
    inference (ops/roi_align.py::multilevel_roi_align: the fused kernel on
    CUDA, no gradient).

    feats: {"P2".."P5": [B, C, H, W]}; boxes [B, N, 4] image coordinates.
    Returns [B, N, P, P, C] in the features' dtype.
    """
    levels = roi_levels(boxes)
    nhwc = [feats[k].permute(0, 2, 3, 1) for k in ALIGN_LEVELS]
    return roi_align.multilevel_roi_align(nhwc, boxes, levels, output_size, sampling_ratio)


def multilevel_roi_align(
    feats: dict, boxes: torch.Tensor, output_size: int, sampling_ratio: int = 2
) -> torch.Tensor:
    """The training form of the same align, differentiable in the features
    (ops/roi_align.py::roi_align_levels: on CUDA the single-level kernel and
    its backward once per level; on the CPU the JAX package's
    compute-every-level-and-select). The JAX version's `roi_chunk` only
    caps XLA's intermediates and does not change the result; the kernels
    hold none, so there is no counterpart.

    feats: {"P2".."P5": [B, C, H, W]}; boxes [B, N, 4], no gradient.
    Returns [B, N, P, P, C] in the features' dtype.
    """
    levels = roi_levels(boxes)
    nhwc = [feats[k].permute(0, 2, 3, 1) for k in ALIGN_LEVELS]
    return roi_align.roi_align_levels(nhwc, boxes, levels, output_size, sampling_ratio)


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x [B, N, ...] rows at idx [B, K] → [B, K, ...]."""
    shape = (*idx.shape, *x.shape[2:])
    flat = idx.reshape(*idx.shape, *([1] * (x.dim() - 2))).expand(shape)
    return torch.gather(x, 1, flat)


class MaskRCNN(nn.Module):
    def __init__(self, cfg: ProposalConfig = ProposalConfig(), dtype=torch.float32):
        super().__init__()
        self.cfg = cfg
        c = cfg.fpn_channels
        self.backbone = ResNet(depth=cfg.backbone_depth, norm=cfg.norm, dtype=dtype)
        self.fpn = FPN(channels=c, dtype=dtype)
        self.rpn = RPNHead(num_anchors=len(cfg.anchor_ratios), channels=c, dtype=dtype)
        self.box_head = BoxHead(
            cfg.roi_align_size ** 2 * c, num_classes=cfg.num_classes, dtype=dtype
        )
        self.mask_head = MaskHead(c, dtype=dtype)

    def features(self, images: torch.Tensor) -> dict:
        """[B, 3, H, W] normalized images → {P2..P6} feature maps."""
        return self.fpn(self.backbone(images))

    def rpn_outputs(self, feats: dict):
        """RPN logits {level: [B, Ni]} and deltas {level: [B, Ni, 4]}."""
        logits, deltas = {}, {}
        for lvl, f in feats.items():
            logits[lvl], deltas[lvl] = self.rpn(f)
        return logits, deltas

    def proposals(self, feats: dict, anchors: dict, image_hw, rpn=None):
        """Padded RPN proposals: [B, K, 4], [B, K], [B, K]. `rpn` takes
        already computed (logits, deltas) instead of running the head."""
        logits, deltas = self.rpn_outputs(feats) if rpn is None else rpn
        cfg = self.cfg
        return generate_proposals(
            logits, deltas, anchors, image_hw,
            pre_nms_topk=cfg.rpn_pre_nms_topk,
            post_nms_topk=cfg.rpn_post_nms_topk,
            nms_threshold=cfg.rpn_nms_threshold,
        )

    def detect(self, feats: dict, rois, roi_valid, image_hw):
        """Second stage: box refinement + NMS → padded detections."""
        h, w = image_hw
        cfg = self.cfg
        b, n = rois.shape[:2]
        roi_feats = multilevel_roi_align_auto(feats, rois, cfg.roi_align_size)
        logits, deltas = self.box_head(roi_feats.reshape(b * n, -1))
        probs = torch.softmax(logits.to(torch.float32), dim=-1)
        scores = probs[:, 1].reshape(b, n) * roi_valid.to(torch.float32)
        boxes = clip_boxes(
            decode_boxes(deltas.to(torch.float32).reshape(b, n, 4), rois),
            float(h), float(w),
        )
        idx, keep = nms(
            boxes,
            scores,
            max_outputs=cfg.detections_per_frame,
            iou_threshold=cfg.detection_nms_threshold,
            score_threshold=cfg.detection_score_threshold,
            valid=roi_valid,
        )
        safe = torch.clamp(idx, min=0).to(torch.int64)
        det_boxes = torch.where(keep[..., None], _take(boxes, safe), 0.0)
        det_scores = torch.where(keep, _take(scores, safe), 0.0)
        return det_boxes, det_scores, keep

    def masks(self, feats: dict, det_boxes):
        """Mask branch → [B, D, 2P, 2P] mask logits in the box frame."""
        b, d = det_boxes.shape[:2]
        mf = multilevel_roi_align_auto(feats, det_boxes, self.cfg.mask_roi_align_size)
        p = mf.shape[2]
        logits = self.mask_head(mf.reshape(b * d, p, p, -1).permute(0, 3, 1, 2))
        return logits.reshape(b, d, *logits.shape[-2:])

    def forward(self, images: torch.Tensor, anchors: dict):
        """images [B, 3, H, W] normalized, H/W 32-multiples; anchors
        {level: [Ni, 4]}. Returns boxes [B, D, 4], scores [B, D],
        valid [B, D], mask_logits [B, D, 2P, 2P]."""
        h, w = images.shape[-2:]
        feats = self.features(images)
        rois, _, roi_valid = self.proposals(feats, anchors, (h, w))
        det_boxes, det_scores, det_valid = self.detect(feats, rois, roi_valid, (h, w))
        mask_logits = self.masks(feats, det_boxes)
        return {
            "boxes": det_boxes,
            "scores": det_scores,
            "valid": det_valid,
            "mask_logits": mask_logits,
        }
