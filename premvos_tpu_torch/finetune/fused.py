"""Fused per-video fine-tuning on one device (port of
premvos_tpu/finetune/fused.py).

PReMVOS fine-tunes the refinement net (DeepLabv3+) and the proposal net
(Mask R-CNN) on lucid-dream augmentations of each video's first frame
before it tracks the video. As in the JAX package's default
(`FinetuneConfig.method = "fused"`), every step generates its batch on the
device (finetune/lucid_device.py): the host's one job is inpainting the
background, once per video (data/lucid.py). Each step is draws → batch →
loss → backward → Adam, with no read back to the host; `chunk` is the
number of steps between two host reads of the loss (one `.item()` per
chunk).

  * Refine net: batch `batch_size` of RGB crops (crop_size²) around a
    jittered, margin-expanded object box, with the object's mask perturbed
    as the fourth channel; sigmoid cross-entropy on the crop's mask, masked
    by whether the example holds an object. Crops and pastes at
    RefineConfig.interp_precision.
  * Proposal net: batch `batch_size // 2` of whole lucid frames at
    `proposal_finetune_hw` (the frame scaled by `proposal_scale`, on the
    backbone's 32-px grid), anchors rebuilt for that size, the Mask R-CNN
    training loss (train/detection.py::maskrcnn_loss_fn, proposals held
    constant). Crops and pastes in float32.

The caller's modules are never changed: each net is deep-copied with a
fresh Adam (`trainer.fresh_train_state`), and `finetune_video_fused`
returns new `Models` with the two fine-tuned nets. Random streams are explicit
`torch.Generator`s seeded from `seed`: one on the device per net for the
augmentation draws, one on the host for the proposal batch's RPN sampling
seeds.

`finetune_video` also dispatches to the host-pool oracle (`method "pool"`,
`finetune_video_pool`, built on finetune/finetune.py).

With `mesh=` (parallel/mesh.py) every entry point is data-parallel, as the
JAX package's `shard_map` + `pmean`: each rank builds batch_size // n
examples a step (the proposal net (batch_size // 2) // n, at least 1) from
generators of its own, and the gradients and loss are averaged over the
mesh (train/trainer.py::make_dp_train_step). Rank 0 seeds both generators
with `seed`, exactly as one device does; rank r > 0 seeds both with
`rank_seed(seed, r)` = np.random.SeedSequence([seed, r]).generate_state(1)[0]
(the JAX package folds the shard's axis_index into the key). Pass
`build_fused_runner` the same mesh.

Left out, by design: `chunk_lengths` and `steps_list`, which exist only to
pre-compile XLA scan programs per chunk length.
"""

from __future__ import annotations

import time
from typing import Callable, NamedTuple

import numpy as np
import torch

from premvos_tpu_torch.config import FinetuneConfig, RefineConfig
from premvos_tpu_torch.data.lucid import inpaint_background
from premvos_tpu_torch.data.preprocess import resize_area_u8, resize_nearest
from premvos_tpu_torch.finetune.finetune import (
    build_lucid_pool,
    finetune_proposals,
    finetune_refine,
    labels_to_boxes_masks,
    run_chunks,
)
from premvos_tpu_torch.finetune.lucid_device import (
    proposal_batch,
    refine_examples,
    sample_proposal_draws,
    sample_refine_draws,
)
from premvos_tpu_torch.models.anchors import pyramid_anchors
from premvos_tpu_torch.parallel.mesh import Mesh, as_mesh
from premvos_tpu_torch.pipeline.runner import check_on, get_anchors, resolve_device
from premvos_tpu_torch.train.detection import maskrcnn_loss_fn
from premvos_tpu_torch.train.losses import sigmoid_xent
from premvos_tpu_torch.train.trainer import (
    fresh_train_state,
    make_dp_train_step,
    replicate_state,
)


class Consts(NamedTuple):
    """A video's fine-tune constants on the device: the first frame and its
    inpainted background [3, H, W] (float32, 0..255), the object masks
    [K, H, W], and which slots hold an object (host booleans [K])."""

    image255: torch.Tensor
    masks: torch.Tensor
    valid: np.ndarray
    background255: torch.Tensor


class FusedRun(NamedTuple):
    """One net's fused step, built for a frame size, in three parts (none
    syncs with the host): `draw(gen, host_gen)` draws a batch's random
    values, `batch(draws, consts)` builds the batch from them on the
    device, `loss(module, batch)` is the batch loss of `module`."""

    draw: Callable
    batch: Callable
    loss: Callable
    image_hw: tuple


def _prep_consts(frame0, lab0, max_objects: int, device, background=None, hw=None) -> Consts:
    """Host-side set-up, once per video: inpaint the background (unless
    given), resize to `hw` (area for images, nearest for labels), split the
    labels into padded mask slots, upload."""
    frame0 = np.asarray(frame0, np.uint8)
    lab0 = np.asarray(lab0).astype(np.int32)
    if background is None:
        background = inpaint_background(frame0, lab0)
    if hw is not None and tuple(hw) != frame0.shape[:2]:
        frame0 = resize_area_u8(frame0, hw)
        background = resize_area_u8(np.asarray(background, np.uint8), hw)
        lab0 = resize_nearest(lab0, hw)
    _, masks, valid = labels_to_boxes_masks(lab0, max_objects)
    chw = lambda x: torch.from_numpy(np.ascontiguousarray(x, np.float32)).permute(2, 0, 1)  # noqa: E731
    return Consts(
        image255=chw(frame0).contiguous().to(device),
        masks=torch.from_numpy(masks).to(device),
        valid=valid,
        background255=chw(background).contiguous().to(device),
    )


def rank_seed(seed: int, rank: int) -> int:
    """The seed of rank `rank`'s generators: `seed` itself at rank 0,
    np.random.SeedSequence([seed, rank]).generate_state(1)[0] above."""
    return seed if rank == 0 else int(np.random.SeedSequence([seed, rank]).generate_state(1)[0])


def _run_chunks(run: FusedRun, state, consts: Consts, seed: int, steps: int, chunk: int,
                mesh: Mesh, log_every: int = 0, label: str = "", stats: dict | None = None):
    """`steps` steps over the mesh, reading the loss on the host once per
    `chunk` steps (finetune.py::run_chunks, which fills `stats`; rank 0
    alone logs). Returns (module, final loss)."""
    if steps < 1:
        raise ValueError(
            f"fused fine-tune needs steps >= 1 (got {steps}); with 0 steps "
            "there is no loss to report — use the initial modules directly"
        )
    module = state.model
    gen = torch.Generator(device=mesh.device).manual_seed(rank_seed(seed, mesh.rank))
    host_gen = torch.Generator().manual_seed(rank_seed(seed, mesh.rank))
    loss_fn = lambda d: run.loss(module, run.batch(d, consts))  # noqa: E731
    step = make_dp_train_step(loss_fn, state.optimizer, mesh)
    loss = run_chunks(lambda i: step(run.draw(gen, host_gen)), steps, chunk,
                      log_every if mesh.rank == 0 else 0, f"-fused{label}", stats)
    return module, loss


def _channels_last(x: torch.Tensor) -> torch.Tensor:
    return x.contiguous(memory_format=torch.channels_last) if x.is_cuda else x


def build_refine_fused_runs(image_hw, refine_cfg: RefineConfig = RefineConfig(),
                            ft_cfg: FinetuneConfig = FinetuneConfig(),
                            max_objects: int = 8, mesh=None) -> FusedRun:
    """The refine net's fused step at frame size `image_hw` (with a mesh,
    each rank's batch_size // n examples)."""
    h, w = image_hw
    bs = max(ft_cfg.batch_size // (mesh.size if mesh else 1), 1)
    patch = min(ft_cfg.aug_patch, min(h, w))

    def draw(gen, host_gen):
        return sample_refine_draws(gen, bs, max_objects, h, w, patch)

    def batch(draws, consts):
        return refine_examples(draws, consts, patch, refine_cfg.crop_size,
                               refine_cfg.box_margin, refine_cfg.interp_precision)

    def loss(module, examples):
        x, tgt, ok = examples
        logits = module(_channels_last(x))
        mask = ok[:, None, None].expand_as(logits).to(torch.float32)
        return sigmoid_xent(logits, tgt, mask=mask)

    return FusedRun(draw, batch, loss, (h, w))


def finetune_refine_fused(model, frame0, lab0, refine_cfg: RefineConfig = RefineConfig(),
                          ft_cfg: FinetuneConfig = FinetuneConfig(), seed: int = 0,
                          max_objects: int = 8, log_every: int = 0, background=None,
                          built: FusedRun | None = None, stats: dict | None = None,
                          mesh=None):
    """Per-video refine-net fine-tune on the device `model` lives on (with a
    `mesh`, data-parallel over it, rank 0's weights replicated first).
    Returns (fine-tuned copy of `model`, final loss)."""
    mesh = as_mesh(mesh, next(model.parameters()).device)
    consts = _prep_consts(frame0, lab0, max_objects, mesh.device, background)
    hw = tuple(consts.image255.shape[1:])
    run = built or build_refine_fused_runs(hw, refine_cfg, ft_cfg, max_objects, mesh)
    state = replicate_state(fresh_train_state(model, ft_cfg.learning_rate), mesh)
    return _run_chunks(run, state, consts, seed, ft_cfg.steps, max(int(ft_cfg.chunk), 1), mesh,
                       log_every, "-refine", stats)


def proposal_finetune_hw(frame_hw, ft_cfg: FinetuneConfig) -> tuple:
    """Mask R-CNN fine-tune resolution: the frame scaled by
    ft_cfg.proposal_scale, rounded (half to even, Python's round) to the
    backbone's 32-px grid, at least 64."""
    fh, fw = frame_hw
    sc = float(ft_cfg.proposal_scale)
    return (max(round(fh * sc / 32) * 32, 64), max(round(fw * sc / 32) * 32, 64))


def build_proposal_fused_runs(proposal_cfg, image_hw, ft_cfg: FinetuneConfig = FinetuneConfig(),
                              max_objects: int = 8, device=None, mesh=None) -> FusedRun:
    """The Mask R-CNN fused step at `image_hw`, with anchors rebuilt for it
    on `device` (with a mesh, each rank's (batch_size // 2) // n images, at
    least 1)."""
    h, w = image_hw
    anchors = {
        k: torch.from_numpy(v).to(resolve_device(device))
        for k, v in pyramid_anchors(h, w, proposal_cfg.anchor_scales,
                                    proposal_cfg.anchor_ratios).items()
    }
    bs = max(max(1, ft_cfg.batch_size // 2) // (mesh.size if mesh else 1), 1)
    patch = min(ft_cfg.aug_patch, min(h, w))

    def draw(gen, host_gen):
        return sample_proposal_draws(gen, host_gen, bs, max_objects, h, w, patch)

    def batch(draws, consts):
        return proposal_batch(draws, consts, patch)

    def loss(module, images):
        return maskrcnn_loss_fn(module, anchors, proposal_cfg, (h, w))(images)

    return FusedRun(draw, batch, loss, (h, w))


def finetune_proposals_fused(model, proposal_cfg, frame0, lab0,
                             ft_cfg: FinetuneConfig = FinetuneConfig(), seed: int = 0,
                             max_objects: int = 8, log_every: int = 0, background=None,
                             image_hw=None, built: FusedRun | None = None,
                             stats: dict | None = None, mesh=None):
    """Per-video Mask R-CNN fine-tune on the device `model` lives on, at
    `image_hw` (default: proposal_finetune_hw of the frame); with a `mesh`,
    data-parallel over it. Returns (fine-tuned copy of `model`, final
    loss)."""
    mesh = as_mesh(mesh, next(model.parameters()).device)
    if image_hw is None:
        image_hw = built.image_hw if built else proposal_finetune_hw(
            np.asarray(frame0).shape[:2], ft_cfg)
    run = built or build_proposal_fused_runs(proposal_cfg, image_hw, ft_cfg, max_objects,
                                             mesh.device, mesh)
    consts = _prep_consts(frame0, lab0, max_objects, mesh.device, background, hw=image_hw)
    state = replicate_state(fresh_train_state(model, ft_cfg.learning_rate), mesh)
    return _run_chunks(run, state, consts, seed, ft_cfg.steps, max(int(ft_cfg.chunk), 1), mesh,
                       log_every, "-prop", stats)


def finetune_video(models, frame0, lab0, cfg, ft_cfg: FinetuneConfig | None = None,
                   seed: int = 0, log_every: int = 0, built: dict | None = None,
                   device=None, stats: dict | None = None, mesh=None):
    """Method-dispatching per-video fine-tune of both nets: "fused" (the
    default) runs finetune_video_fused, "pool" the host-pool oracle
    finetune_video_pool (`built` serves the fused runs only); with a
    `mesh`, either data-parallel over it. Returns (models', {"refine":
    loss, "proposal": loss})."""
    ft = ft_cfg or cfg.finetune
    if ft.method == "fused":
        return finetune_video_fused(models, frame0, lab0, cfg, ft, seed, log_every, built,
                                    device, stats, mesh)
    if ft.method == "pool":
        return finetune_video_pool(models, frame0, lab0, cfg, ft, seed, log_every, device,
                                   stats, mesh)
    raise ValueError(f"unknown FinetuneConfig.method {ft.method!r}")


def _check_models_on(models, dev, who: str) -> None:
    for name in ("refine", "maskrcnn"):
        check_on(getattr(models, name), dev, f"{who} (models.{name})")


def finetune_video_pool(models, frame0, lab0, cfg, ft_cfg: FinetuneConfig | None = None,
                        seed: int = 0, log_every: int = 0, device=None,
                        stats: dict | None = None, mesh=None):
    """Fine-tune both nets for one video on one host-built lucid pool (the
    JAX package's `method "pool"` branch of finetune_video; finetune/
    finetune.py): the pool from default_rng(seed), then the refine net on
    examples cut from it and the proposal net on its frames at the frame's
    size (frame0 at the pipeline canvas, whose anchors it uses).

    models on `device` (CUDA unless the caller passes one; with a `mesh`,
    the mesh's device, every rank building the same pool, data-parallel
    steps). Returns (models with new `refine` and `maskrcnn` modules,
    {"refine": loss, "proposal": loss}). `stats`, where given, gets
    "pool_s" (host seconds of the pool), and under "refine" ("examples_s":
    host seconds of make_refine_examples, "examples", "chunks") and
    "proposal" ("chunks") each net's log.
    """
    mesh = as_mesh(mesh, device)
    dev = mesh.device
    _check_models_on(models, dev, "finetune_video_pool")
    ft = ft_cfg or cfg.finetune
    frame0 = np.asarray(frame0, np.uint8)
    lab0 = np.asarray(lab0)
    t0 = time.perf_counter()
    pool = build_lucid_pool(frame0, lab0, ft, seed=seed)
    if stats is not None:
        stats["pool_s"] = time.perf_counter() - t0
    sub = (lambda key: stats.setdefault(key, {})) if stats is not None else (lambda key: None)
    refine, loss_r = finetune_refine(models.refine, frame0, lab0, cfg.refine, ft, seed=seed,
                                     log_every=log_every, pool=pool, stats=sub("refine"),
                                     mesh=mesh)
    maskrcnn, loss_p = finetune_proposals(
        models.maskrcnn, get_anchors(cfg, dev), cfg.proposal, frame0, lab0, ft, seed=seed,
        max_objects=cfg.pipeline.max_objects, log_every=log_every, pool=pool,
        stats=sub("proposal"), mesh=mesh,
    )
    return models._replace(refine=refine, maskrcnn=maskrcnn), {"refine": loss_r, "proposal": loss_p}


def build_fused_runner(models, cfg, ft_cfg: FinetuneConfig | None = None, image_hw=None,
                       device=None, mesh=None) -> dict:
    """Both nets' fused steps for one frame size (every sequence of a
    dataset run shares the pipeline canvas), to pass to finetune_video as
    `built` (with the same `mesh`)."""
    ft = ft_cfg or cfg.finetune
    if image_hw is None:
        image_hw = (cfg.pipeline.image_height, cfg.pipeline.image_width)
    prop_hw = proposal_finetune_hw(image_hw, ft)
    k = cfg.pipeline.max_objects
    return {
        "refine": build_refine_fused_runs(image_hw, cfg.refine, ft, k, mesh),
        "proposal": build_proposal_fused_runs(cfg.proposal, prop_hw, ft, k,
                                              device or next(models.maskrcnn.parameters()).device,
                                              mesh),
        "proposal_hw": prop_hw,
        "image_hw": tuple(image_hw),
    }


def finetune_video_fused(models, frame0, lab0, cfg, ft_cfg: FinetuneConfig | None = None,
                         seed: int = 0, log_every: int = 0, built: dict | None = None,
                         device=None, stats: dict | None = None, mesh=None):
    """Fine-tune both nets for one video, sharing one host inpainting (with
    a `mesh`, each net data-parallel over it, on the mesh's device).

    models: the pipeline's `Models` (build_models), on `device` (CUDA
    unless the caller passes one; without a card and without device="cpu"
    this raises). frame0 [H, W, 3] uint8 and lab0 [H, W] int labels of the
    first frame. Returns (models with new `refine` and `maskrcnn` modules,
    {"refine": loss, "proposal": loss}); the other two modules and the
    caller's are untouched. `stats`, where given, gets "inpaint_s" (host
    seconds) and each net's chunk log under "refine" and "proposal".
    """
    mesh = as_mesh(mesh, device)
    dev = mesh.device
    _check_models_on(models, dev, "finetune_video_fused")
    ft = ft_cfg or cfg.finetune
    frame0 = np.asarray(frame0, np.uint8)
    lab0 = np.asarray(lab0)
    t0 = time.perf_counter()
    bg = inpaint_background(frame0, lab0.astype(np.int32))
    if stats is not None:
        stats["inpaint_s"] = time.perf_counter() - t0
    sub = (lambda key: stats.setdefault(key, {})) if stats is not None else (lambda key: None)
    k = cfg.pipeline.max_objects
    refine, loss_r = finetune_refine_fused(
        models.refine, frame0, lab0, cfg.refine, ft, seed=seed, max_objects=k,
        log_every=log_every, background=bg, built=built["refine"] if built else None,
        stats=sub("refine"), mesh=mesh,
    )
    maskrcnn, loss_p = finetune_proposals_fused(
        models.maskrcnn, cfg.proposal, frame0, lab0, ft, seed=seed, max_objects=k,
        log_every=log_every, background=bg,
        image_hw=built["proposal_hw"] if built else None,
        built=built["proposal"] if built else None, stats=sub("proposal"), mesh=mesh,
    )
    return models._replace(refine=refine, maskrcnn=maskrcnn), {"refine": loss_r, "proposal": loss_p}
