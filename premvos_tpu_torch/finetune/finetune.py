"""Per-video fine-tuning helpers (port of premvos_tpu/finetune/finetune.py).

Only `labels_to_boxes_masks` so far, which Mask R-CNN training uses to turn
annotated frames into GT boxes and masks; the fine-tune itself is still to
port.
"""

from __future__ import annotations

import numpy as np


def labels_to_boxes_masks(labels: np.ndarray, max_objects: int):
    """[H, W] int label map → (boxes [K, 4], masks [K, H, W], valid [K])."""
    h, w = labels.shape
    boxes = np.zeros((max_objects, 4), np.float32)
    masks = np.zeros((max_objects, h, w), np.float32)
    valid = np.zeros((max_objects,), bool)
    for slot, obj in enumerate(
        [int(i) for i in np.unique(labels) if i > 0][:max_objects]
    ):
        m = labels == obj
        ys, xs = np.nonzero(m)
        if len(ys) == 0:
            continue
        boxes[slot] = [xs.min(), ys.min(), xs.max() + 1, ys.max() + 1]
        masks[slot] = m
        valid[slot] = True
    return boxes, masks, valid
