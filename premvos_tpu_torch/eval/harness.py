"""Precompute once, replay the merge per candidate: the harness of
merge-weight experiments (port of premvos_tpu/eval/harness.py).

Only the merge stage depends on MergeConfig, so stages 1–4 run once per
sequence (pipeline.runner.precompute_sequence, whose outputs stay on the
device) and each candidate weight vector replays only the merge
(merge_labels_from_precomputed).

Weight vector ([9]; the replay also takes the first 6 or 8):
  (w_objectness, w_reid, w_warp, w_overlap, reid_sigma,
   new_object_score_floor, warp_decay, reid_ema, reid_reacquire)
"""

from __future__ import annotations

import numpy as np
import torch

from premvos_tpu_torch.eval.davis_eval import evaluate_dataset, evaluate_sequence
from premvos_tpu_torch.pipeline.runner import (
    merge_labels_from_precomputed,
    precompute_sequence,
    resolve_device,
)

# MergeConfig's defaults (warp_decay 1.0, reid_ema 0.0, reid_reacquire 2.0 =
# disabled since a similarity is at most 1).
DEFAULT_WEIGHTS = np.array(
    [1.0, 1.0, 1.0, 1.0, 1.0, 0.0, 1.0, 0.0, 2.0], np.float32
)
WEIGHT_NAMES = (
    "w_objectness", "w_reid", "w_warp", "w_overlap", "reid_sigma",
    "new_object_score_floor", "warp_decay", "reid_ema", "reid_reacquire",
)


def weights_from_merge_cfg(cfg_m) -> np.ndarray:
    return np.array([getattr(cfg_m, name) for name in WEIGHT_NAMES], np.float32)


def precompute_split(
    models, cfg, ds, sequences=None, max_frames=None, verbose=True, device=None
) -> list:
    """Stages 1–4 of each sequence of a split, on `device` (CUDA unless
    given).

    Returns a list of (pre, gt_masks, num_objects, gt_labels): pre and
    gt_masks on the device, gt_labels numpy, cropped to the sequence's own
    resolution.
    """
    device = resolve_device(device)
    p = cfg.pipeline
    out = []
    for seq in sequences if sequences is not None else ds.sequences:
        data = ds.load_sequence(
            seq, p.image_height, p.image_width, p.max_objects, max_frames=max_frames
        )
        gt_masks = data["gt_masks"]
        n_obj = data["num_objects"]
        pre = precompute_sequence(models, cfg, data["frames"], gt_masks, n_obj, device=device)
        oh, ow = data["orig_hw"]
        out.append((pre, torch.as_tensor(gt_masks, device=device), n_obj,
                    np.asarray(data["gt_labels"])[:, :oh, :ow]))
        if verbose:
            print(f"[precompute] {seq}: {data['frames'].shape[0]} frames", flush=True)
    return out


def evaluate_weights(
    precomputed: list, weights, warp_stride: int = 1, warp_impl: str = "block"
):
    """Mean J&F of one weight vector across precomputed sequences.

    Returns (dataset J&F, per-sequence result list)."""
    results = []
    for pre, gt_masks, num_objects, gt_labels in precomputed:
        labels = merge_labels_from_precomputed(
            pre, gt_masks, num_objects, weights, warp_stride=warp_stride,
            warp_impl=warp_impl,
        ).cpu().numpy()
        labels = labels[:, : gt_labels.shape[1], : gt_labels.shape[2]]
        results.append(evaluate_sequence(labels, gt_labels, int(num_objects)))
    return evaluate_dataset(results)["J&F"], results
