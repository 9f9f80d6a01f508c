"""Per-video refine fine-tuning of several videos (port of
premvos_tpu/finetune/multi_video.py).

The JAX package stacks V videos' parameters along a leading axis and steps
them together (vmap, the videos sharded over the mesh): V independent
optimizations. The port runs the same V optimizations as V copies of the
net, each with its own Adam, stepped in turn; each video's result is the
one its own run gives (`train_refine_pools`).

With `mesh=` (parallel/mesh.py), as in the JAX package: V is padded to a
multiple of the mesh size n by repeating the last video, rank r fine-tunes
its block of V/n videos (P("data") order), no step needs a collective, and
at the end each video's weights are broadcast from the rank that tuned it
and the losses gathered, so every rank returns all V (the padded ones cut
off). Without a mesh nothing is padded.

The host draws keep the JAX package's order on one
numpy.random.default_rng(seed), on every rank: each (padded) video's lucid
pool of min(num_augmentations, max(steps, 32)) and its refine examples,
video after video, then for each step, for each video, that video's batch
rows; a rank uses only its own videos' rows.
"""

from __future__ import annotations

import copy

import numpy as np
import torch

from premvos_tpu_torch.config import FinetuneConfig, RefineConfig
from premvos_tpu_torch.data.lucid import lucid_batch
from premvos_tpu_torch.finetune.finetune import make_refine_examples, refine_loss_fn
from premvos_tpu_torch.parallel.mesh import as_mesh
from premvos_tpu_torch.pipeline.runner import check_on
from premvos_tpu_torch.train.trainer import PoolDraws, fresh_train_state, make_pool_train_step


def train_refine_pools(model, pools: list, rows: list, learning_rate: float):
    """One fine-tune of a copy of `model` (its own Adam) per video: pools[v]
    = (crops [M, S, S, 4], targets [M, S, S]) on the host, rows[v] [steps,
    batch] the pool rows of each step's batch. The videos step in turn,
    each through its own make_pool_train_step. Returns (the V fine-tuned
    copies, the last step's loss of each, read once at the end)."""
    one = as_mesh(None, next(model.parameters()).device)
    runs = []
    for pool, r in zip(pools, rows):
        state = fresh_train_state(model, learning_rate)
        r = torch.as_tensor(np.asarray(r), dtype=torch.int64)
        draws = PoolDraws(r, torch.zeros(len(r), dtype=torch.int64))
        runs.append((state.model, make_pool_train_step(refine_loss_fn(state.model),
                                                       state.optimizer, pool, draws, one)))
    losses = [torch.tensor(float("nan"))] * len(runs)
    for i in range(max((len(r) for r in rows), default=0)):
        for v, (_, step) in enumerate(runs):
            losses[v] = step(i)
    return [module for module, _ in runs], np.array([float(x) for x in losses], np.float32)


def finetune_refine_videos(model, videos: list, refine_cfg: RefineConfig = RefineConfig(),
                           ft_cfg: FinetuneConfig = FinetuneConfig(), seed: int = 0,
                           device=None, mesh=None):
    """Fine-tune the refinement net on V videos, on `device` (CUDA unless
    the caller passes one; with a `mesh`, the mesh's device, the videos
    sharded over it), where `model` must already lie.

    Args:
      videos: list of (first_frame [H, W, 3] uint8, first_labels [H, W] int).

    Returns (list of V fine-tuned copies of `model`, in the order of
    `videos`; the V final losses), on every rank. A video without any refine
    example trains on one all-zero example, as in the JAX package.
    """
    mesh = as_mesh(mesh, device)
    check_on(model, mesh.device, "finetune_refine_videos")
    n = mesh.size
    v_real = len(videos)
    vids = list(videos) + [videos[-1]] * (-(-v_real // n) * n - v_real)
    rng = np.random.default_rng(seed)
    bs = max(ft_cfg.batch_size // 2, 2)
    s = refine_cfg.crop_size
    pools = []
    for frame, labels in vids:
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
    per = len(vids) // n
    own = slice(mesh.rank * per, (mesh.rank + 1) * per)
    tuned, losses = train_refine_pools(model, pools[own], rows[own], ft_cfg.learning_rate)
    out = []
    for i in range(v_real):
        owner, j = divmod(i, per)
        module = tuned[j] if owner == mesh.rank else copy.deepcopy(model)
        with torch.no_grad():
            for t in [*module.parameters(), *module.buffers()]:
                mesh.broadcast_(t.data, owner)
        out.append(module)
    losses = mesh.all_gather(torch.from_numpy(losses).to(mesh.device)).cpu().numpy()
    return out, losses[:v_real]
