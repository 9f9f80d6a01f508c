"""Per-video refine fine-tuning of several videos (port of
premvos_tpu/finetune/multi_video.py).

The JAX package stacks V videos' parameters along a leading axis and steps
them together (vmap, the videos sharded over the mesh): V independent
optimizations. On one card the port runs the same V optimizations as V
copies of the net, each with its own Adam, stepped in turn; each video's
result is the one its own run gives (`train_refine_pools`). The JAX
package pads V to a multiple of the mesh size; with one card there is
nothing to pad, and the port does not.

The host draws keep the JAX package's order on one
numpy.random.default_rng(seed): each video's lucid pool of
min(num_augmentations, max(steps, 32)) and its refine examples, video
after video, then for each step, for each video, that video's batch rows.
"""

from __future__ import annotations

import numpy as np
import torch

from premvos_tpu_torch.config import FinetuneConfig, RefineConfig
from premvos_tpu_torch.data.lucid import lucid_batch
from premvos_tpu_torch.finetune.finetune import make_refine_examples, refine_loss_fn
from premvos_tpu_torch.pipeline.runner import check_on, resolve_device
from premvos_tpu_torch.train.trainer import PoolDraws, fresh_train_state, make_pool_train_step


def train_refine_pools(model, pools: list, rows: list, learning_rate: float):
    """One fine-tune of a copy of `model` (its own Adam) per video: pools[v]
    = (crops [M, S, S, 4], targets [M, S, S]) on the host, rows[v] [steps,
    batch] the pool rows of each step's batch. The videos step in turn,
    each through its own make_pool_train_step. Returns (the V fine-tuned
    copies, the last step's loss of each, read once at the end)."""
    dev = next(model.parameters()).device
    runs = []
    for pool, r in zip(pools, rows):
        state = fresh_train_state(model, learning_rate)
        r = torch.as_tensor(np.asarray(r), dtype=torch.int64)
        draws = PoolDraws(r, torch.zeros(len(r), dtype=torch.int64))
        runs.append((state.model, make_pool_train_step(refine_loss_fn(state.model),
                                                       state.optimizer, pool, draws, dev)))
    losses = [torch.tensor(float("nan"))] * len(runs)
    for i in range(max((len(r) for r in rows), default=0)):
        for v, (_, step) in enumerate(runs):
            losses[v] = step(i)
    return [module for module, _ in runs], np.array([float(x) for x in losses], np.float32)


def finetune_refine_videos(model, videos: list, refine_cfg: RefineConfig = RefineConfig(),
                           ft_cfg: FinetuneConfig = FinetuneConfig(), seed: int = 0,
                           device=None):
    """Fine-tune the refinement net on V videos, on `device` (CUDA unless
    the caller passes one), where `model` must already lie.

    Args:
      videos: list of (first_frame [H, W, 3] uint8, first_labels [H, W] int).

    Returns (list of V fine-tuned copies of `model`, in the order of
    `videos`; the V final losses). A video without any refine example
    trains on one all-zero example, as in the JAX package.
    """
    check_on(model, resolve_device(device), "finetune_refine_videos")
    rng = np.random.default_rng(seed)
    bs = max(ft_cfg.batch_size // 2, 2)
    s = refine_cfg.crop_size
    pools = []
    for frame, labels in videos:
        imgs, labs = lucid_batch(frame, labels, rng,
                                 min(ft_cfg.num_augmentations, max(ft_cfg.steps, 32)))
        crops, tgts = make_refine_examples(imgs, labs, s, refine_cfg.box_margin, rng)
        if len(crops) == 0:  # degenerate video: train on zeros
            crops = np.zeros((1, s, s, 4), np.float32)
            tgts = np.zeros((1, s, s), np.float32)
        pools.append((crops, tgts))
    rows = [[] for _ in pools]
    for _ in range(ft_cfg.steps):
        for v, (crops, _) in enumerate(pools):
            rows[v].append(rng.integers(0, len(crops), size=bs))
    rows = [np.asarray(r, np.int64).reshape(ft_cfg.steps, bs) for r in rows]
    return train_refine_pools(model, pools, rows, ft_cfg.learning_rate)
