"""Per-video fine-tuning on a host-built lucid pool (port of
premvos_tpu/finetune/finetune.py): the reference-shaped oracle,
`FinetuneConfig.method = "pool"` (finetune/fused.py::finetune_video).

Before tracking a video, PReMVOS fine-tunes its refinement and proposal
nets on lucid-dream augmentations of the annotated first frame. Here, as in
the JAX package's oracle:

  * one pool of min(num_augmentations, max(steps, 64)) augmentations is
    built on the host (`build_lucid_pool`, data/lucid.py), from
    numpy.random.default_rng(seed), and serves both nets;
  * the refine net trains on (crop, perturbed coarse mask) → mask examples
    cut from the pool (`make_refine_examples`), batch max(batch_size, 1);
  * the proposal net trains on whole pool frames with their GT boxes and
    masks, batch max(1, batch_size // 2), the Mask R-CNN training loss at
    the frame's size;
  * each fine-tune starts a fresh default_rng(seed) (the same stream the
    pool was built from, as the reference does), uploads its pool once and
    gathers each step's batch on the device (train/trainer.py::
    make_pool_train_step) by rows drawn up front from a host
    torch.Generator seeded with `seed` (`draw`: replaceable, so a test can
    feed the JAX package's draws); the loss is read on the host once per
    `FinetuneConfig.chunk` steps.

The host work is numpy and needs no OpenCV (data/cv_compat.py). The
fine-tunes copy the caller's module (a fresh Adam over the copy) and return
the copy, which lives on the device the module lives on.

With `mesh=` (parallel/mesh.py) a fine-tune is data-parallel, as the JAX
package's: every rank builds the same pool from default_rng(seed) and makes
the same row draws of the global batch, the refine net's max(batch_size,
n) − (that % n) rows and the proposal net's max(b − b % n, n) with b =
max(1, batch_size // 2); each rank gathers its block of the rows, and the
gradients and loss are averaged over the mesh. The module must lie on the
mesh's device; rank 0's copy is replicated first.
"""

from __future__ import annotations

import time
from typing import Callable

import numpy as np
import torch

from premvos_tpu_torch.config import FinetuneConfig, RefineConfig
from premvos_tpu_torch.data.cv_compat import dilate, erode, resize_linear_u8
from premvos_tpu_torch.data.lucid import lucid_batch
from premvos_tpu_torch.data.preprocess import IMAGENET_MEAN, IMAGENET_STD, resize_linear
from premvos_tpu_torch.parallel.mesh import as_mesh
from premvos_tpu_torch.train.detection import maskrcnn_loss_fn
from premvos_tpu_torch.train.losses import sigmoid_xent
from premvos_tpu_torch.train.trainer import (
    dp_batch_size,
    fresh_train_state,
    make_pool_train_step,
    replicate_state,
    sample_pool_draws,
)

_MEAN = np.asarray(IMAGENET_MEAN, np.float32)
_STD = np.asarray(IMAGENET_STD, np.float32)


def pool_size(ft_cfg: FinetuneConfig) -> int:
    """The number of augmentations in a video's pool."""
    return min(ft_cfg.num_augmentations, max(ft_cfg.steps, 64))


def build_lucid_pool(first_frame: np.ndarray, first_labels: np.ndarray,
                     ft_cfg: FinetuneConfig = FinetuneConfig(), seed: int = 0) -> tuple:
    """ONE lucid-augmentation pool for a video, shared by both per-video
    fine-tunes: (images [N, H, W, 3] uint8, labels [N, H, W])."""
    rng = np.random.default_rng(seed)
    return lucid_batch(first_frame, first_labels, rng, pool_size(ft_cfg))


def perturb_mask(mask: np.ndarray, rng) -> np.ndarray:
    """Simulate a coarse proposal mask from a GT mask (random morphological
    perturbation + shift)."""
    m = mask.astype(np.uint8)
    k = int(rng.integers(1, 6))
    if rng.uniform() < 0.5:
        m = dilate(m, k)
    else:
        m = erode(m, k)
    dx, dy = rng.integers(-4, 5, size=2)
    m = np.roll(np.roll(m, dy, 0), dx, 1)
    return m.astype(np.float32)


def make_refine_examples(images: np.ndarray, labels: np.ndarray, crop_size: int,
                         margin: float, rng) -> tuple[np.ndarray, np.ndarray]:
    """Augmented frames → (crops [M, S, S, 4], targets [M, S, S]), NHWC as
    in the JAX package.

    One example per (sample, object): RGB crop around the margin-expanded,
    jittered object box + a perturbed-coarse-mask channel; target is the true
    mask in the crop frame. The jitter is drawn before the size check, and
    the perturbation after it, as in the JAX package.
    """
    crops, targets = [], []
    s = crop_size
    for img, lab in zip(images, labels):
        h, w = lab.shape
        for obj in [int(i) for i in np.unique(lab) if i > 0]:
            m = (lab == obj).astype(np.float32)
            ys, xs = np.nonzero(m)
            if len(ys) < 4:
                continue
            jx, jy = rng.integers(-8, 9, size=2)
            x1 = max(0, xs.min() - margin + jx)
            y1 = max(0, ys.min() - margin + jy)
            x2 = min(w, xs.max() + margin + jx)
            y2 = min(h, ys.max() + margin + jy)
            if x2 - x1 < 8 or y2 - y1 < 8:
                continue
            rows, cols = slice(int(y1), int(y2)), slice(int(x1), int(x2))
            rgb = resize_linear_u8(img[rows, cols], (s, s)).astype(np.float32) / 255.0
            rgb = (rgb - _MEAN) / _STD
            coarse = resize_linear(perturb_mask(m, rng)[rows, cols], (s, s))
            tgt = resize_linear(m[rows, cols], (s, s))
            crops.append(np.concatenate([rgb, coarse[..., None]], -1).astype(np.float32))
            targets.append((tgt > 0.5).astype(np.float32))
    if not crops:
        return np.zeros((0, s, s, 4), np.float32), np.zeros((0, s, s), np.float32)
    return np.stack(crops), np.stack(targets)


def _nchw(x: torch.Tensor) -> torch.Tensor:
    """NHWC → NCHW: channels-last in memory on CUDA (as finetune/fused.py
    feeds the refine net), contiguous on the CPU."""
    x = x.permute(0, 3, 1, 2)
    return x.contiguous(memory_format=torch.channels_last) if x.is_cuda else x.contiguous()


def refine_loss_fn(module):
    """loss(batch) of the refine net: sigmoid cross-entropy of its logits
    on crops [B, S, S, 4] (NHWC) against targets [B, S, S]."""

    def loss_fn(batch):
        x, y = batch
        return sigmoid_xent(module(_nchw(x)), y)

    return loss_fn


def proposal_loss_fn(module, anchors: dict, proposal_cfg, image_hw):
    """loss(batch) of the proposal net on a pool batch (images [B, H, W, 3]
    uint8, GT boxes, GT masks uint8, GT validity, on the module's device;
    per-item seeds on the host): the images normalized, the masks cast,
    then the Mask R-CNN training loss at `image_hw`."""
    base_loss = maskrcnn_loss_fn(module, anchors, proposal_cfg, image_hw)
    dev = next(module.parameters()).device
    mean, std = torch.tensor(_MEAN, device=dev), torch.tensor(_STD, device=dev)

    def loss_fn(batch):
        im, gb, gm, gv, sd = batch
        im = (im.to(torch.float32) / 255.0 - mean) / std
        return base_loss((im, gb, gm.to(torch.float32), gv, sd))

    return loss_fn


def run_chunks(step: Callable, steps: int, chunk: int, log_every: int = 0,
               label: str = "", stats: dict | None = None) -> float:
    """`steps` calls step(0), step(1), …, reading the loss on the host once
    per `chunk` steps. Returns the last loss (NaN without steps). `stats`,
    where given, gets "chunks": one (steps, seconds, loss) per read, the
    seconds on the host clock from the chunk's first step to its read."""
    chunks, loss, done = [], float("nan"), 0
    chunk = max(int(chunk), 1)
    while done < steps:
        n = min(chunk, steps - done)
        t0 = time.perf_counter()
        for i in range(done, done + n):
            last = step(i)
        loss = last.item()
        chunks.append((n, time.perf_counter() - t0, loss))
        done += n
        if log_every and done % log_every < n:
            print(f"[finetune{label}] step {done}/{steps} loss={loss:.4f}", flush=True)
    if stats is not None:
        stats["chunks"] = chunks
    return loss


def finetune_refine(model, first_frame: np.ndarray, first_labels: np.ndarray,
                    refine_cfg: RefineConfig = RefineConfig(),
                    ft_cfg: FinetuneConfig = FinetuneConfig(), seed: int = 0,
                    log_every: int = 0, pool: tuple | None = None,
                    draw: Callable | None = None, stats: dict | None = None,
                    mesh=None):
    """Fine-tune the refinement net on one video's first frame, on the
    device `model` lives on (with a `mesh`, data-parallel over it; see the
    module's docstring).

    Returns (fine-tuned copy of `model`, final loss), or (`model`, NaN)
    when no example survives. `pool` = a prebuilt (images, labels) lucid
    pool (build_lucid_pool); without it one is built from this fine-tune's
    generator. `draw(gen, steps, pool_n, batch_size)` gives the steps'
    PoolDraws (by default this module's `sample_pool_draws`, looked up at
    call time). `stats`, where given, gets "examples_s" (host seconds of
    make_refine_examples) and the loss reads' "chunks".
    """
    mesh = as_mesh(mesh, next(model.parameters()).device)
    rng = np.random.default_rng(seed)
    bs = dp_batch_size(ft_cfg.batch_size, mesh.size)
    if pool is None:
        pool = lucid_batch(first_frame, first_labels, rng, pool_size(ft_cfg))
    imgs, labs = pool
    t0 = time.perf_counter()
    crops, tgts = make_refine_examples(imgs, labs, refine_cfg.crop_size, refine_cfg.box_margin,
                                       rng)
    if stats is not None:
        stats["examples_s"] = time.perf_counter() - t0
        stats["examples"] = len(crops)
    if len(crops) == 0:
        return model, float("nan")
    state = replicate_state(fresh_train_state(model, ft_cfg.learning_rate), mesh)
    draws = (draw or sample_pool_draws)(torch.Generator().manual_seed(seed), ft_cfg.steps,
                                        len(crops), bs)
    step = make_pool_train_step(refine_loss_fn(state.model), state.optimizer, (crops, tgts),
                                draws, mesh)
    loss = run_chunks(step, ft_cfg.steps, ft_cfg.chunk, log_every, "-refine", stats)
    return state.model, loss


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


def proposal_pool(labels: np.ndarray, max_objects: int) -> tuple:
    """GT of each pool frame: (boxes [N, K, 4] float32, masks [N, K, H, W]
    uint8, valid [N, K] bool)."""
    gt = [labels_to_boxes_masks(lab, max_objects) for lab in labels]
    return (np.stack([g[0] for g in gt]), np.stack([g[1] for g in gt]).astype(np.uint8),
            np.stack([g[2] for g in gt]))


def finetune_proposals(model, anchors: dict, proposal_cfg, first_frame: np.ndarray,
                       first_labels: np.ndarray, ft_cfg: FinetuneConfig = FinetuneConfig(),
                       seed: int = 0, max_objects: int = 8, log_every: int = 0,
                       pool: tuple | None = None, draw: Callable | None = None,
                       stats: dict | None = None, mesh=None):
    """Per-video fine-tune of the Mask R-CNN proposal net on the pool's
    frames at their full size (anchors: the pyramid's at that size, on the
    model's device), on the device `model` lives on (with a `mesh`,
    data-parallel over it). Returns (fine-tuned copy of `model`, final
    loss).

    The pool is stored uint8 on the device and normalized per batch; each
    pool frame has a per-item seed (drawn after the pool, in [0, 2³¹ − 1)),
    and each step adds its salt to the batch's seeds, wrapping mod 2³² as
    the JAX package's uint32 add does; the sampled RPN loss draws from
    them (the dense one draws nothing). `pool` and `draw` as in
    finetune_refine.
    """
    mesh = as_mesh(mesh, next(model.parameters()).device)
    rng = np.random.default_rng(seed)
    h, w = np.asarray(first_frame).shape[:2]
    bs = dp_batch_size(max(1, ft_cfg.batch_size // 2), mesh.size)
    if pool is None:
        pool = lucid_batch(first_frame, first_labels, rng, pool_size(ft_cfg))
    imgs, labs = pool
    pool_n = len(imgs)
    gt_boxes, gt_masks, gt_valid = proposal_pool(labs, max_objects)
    seeds = rng.integers(0, 2**31 - 1, size=pool_n).astype(np.uint32)

    state = replicate_state(fresh_train_state(model, ft_cfg.learning_rate), mesh)

    def resalt_seeds(batch, rows, salt):
        # A fresh salt a step, so resampling a pool item does not repeat
        # its RPN sampling; uint32 wraps.
        return (*batch, seeds[rows] + np.uint32(salt))

    draws = (draw or sample_pool_draws)(torch.Generator().manual_seed(seed), ft_cfg.steps,
                                        pool_n, bs)
    step = make_pool_train_step(proposal_loss_fn(state.model, anchors, proposal_cfg, (h, w)),
                                state.optimizer, (imgs, gt_boxes, gt_masks, gt_valid), draws,
                                mesh, batch_transform=resalt_seeds)
    loss = run_chunks(step, ft_cfg.steps, ft_cfg.chunk, log_every, "-prop", stats)
    return state.model, loss
