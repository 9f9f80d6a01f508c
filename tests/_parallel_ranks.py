"""Rank bodies for tests/test_torch_parallel.py: each runs in a fresh
process started by premvos_tpu_torch.parallel.dryrun.spawn, so this module
imports neither JAX nor the JAX package (nor the test modules, which do).

`parity_rank(mesh, cases)` runs every data-parallel case of `cases` on
this rank and returns what the test holds against JAX and against one
rank: losses, parameters after the step, and digests of parameters for
the check that every rank holds the same weights.
"""

from __future__ import annotations

import hashlib

import numpy as np
import torch

from premvos_tpu_torch.finetune.finetune import refine_loss_fn
from premvos_tpu_torch.finetune.fused import build_refine_fused_runs
from premvos_tpu_torch.finetune.multi_video import finetune_refine_videos
from premvos_tpu_torch.models.anchors import pyramid_anchors
from premvos_tpu_torch.models.deeplab import DeepLabV3Plus
from premvos_tpu_torch.models.maskrcnn import MaskRCNN
from premvos_tpu_torch.parallel.mesh import run_sequences_sharded
from premvos_tpu_torch.pipeline.runner import build_models
from premvos_tpu_torch.train.detection import maskrcnn_loss_fn
from premvos_tpu_torch.train.trainer import (
    create_train_state,
    make_dp_train_step,
    replicate_state,
    shard_train_batch,
)


def params_of(module) -> dict:
    return {n: p.detach().cpu().numpy().copy() for n, p in module.named_parameters()}


def digest(module) -> str:
    h = hashlib.sha256()
    for t in [*module.parameters(), *module.buffers()]:
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def _module(kind, cfg, state_dict):
    m = {"refine": DeepLabV3Plus, "maskrcnn": MaskRCNN}[kind](cfg)
    m.load_state_dict(state_dict)
    return m


def dp_step(mesh, kind, cfg, state_dict, batch, image_hw=None, perturb_rank=False):
    """One make_dp_train_step of the refine net or Mask R-CNN (Adam 1e-4)
    on this rank's shard of `batch` (numpy, [B, ...]): the mesh's loss, the
    gradients Adam was given (the mesh's mean), the parameters after the
    step and the loss of the whole batch after it. With perturb_rank, ranks
    above 0 start from other weights, which replicate_state must overwrite
    with rank 0's."""
    m = _module(kind, cfg, state_dict)
    if perturb_rank and mesh.rank:
        with torch.no_grad():
            for p in m.parameters():
                p.add_(1.0)
    if kind == "refine":
        loss_fn = refine_loss_fn(m)
    else:
        anchors = {k: torch.from_numpy(v) for k, v in pyramid_anchors(
            *image_hw, cfg.anchor_scales, cfg.anchor_ratios).items()}
        loss_fn = maskrcnn_loss_fn(m, anchors, cfg, image_hw)
    local = tuple(torch.from_numpy(np.ascontiguousarray(a))
                  for a in shard_train_batch(batch, mesh))
    out = _recorded_step(mesh, m, loss_fn, 1e-4, local)
    with torch.no_grad():
        out["loss_after"] = float(loss_fn(tuple(torch.from_numpy(np.ascontiguousarray(a))
                                                for a in batch)))
    return out


def _recorded_step(mesh, m, loss_fn, learning_rate, local):
    """One make_dp_train_step of `m` on `local`, rank 0's weights
    replicated first: the mesh's loss, the gradients Adam was given, the
    parameters after and their digest."""
    state = replicate_state(create_train_state(m, learning_rate), mesh)
    step = make_dp_train_step(loss_fn, state.optimizer, mesh)
    grads, adam_step = {}, state.optimizer.step

    def record_then_step(*a, **k):
        grads.update({n: p.grad.detach().numpy().copy() for n, p in m.named_parameters()})
        return adam_step(*a, **k)

    state.optimizer.step = record_then_step
    loss = float(step(local))
    return dict(loss=loss, grads=grads, params=params_of(m), digest=digest(m))


def reid_train(mesh, images, ann, cfg, state_dict):
    """train_reid at one step, P = K = 2 a rank, over the mesh."""
    from premvos_tpu_torch.data.crops import InstanceCropDataset
    from premvos_tpu_torch.models.reid import ReIDNet
    from premvos_tpu_torch.train.train_reid import train_reid

    m = ReIDNet(cfg)
    m.load_state_dict(state_dict)
    m, loss = train_reid(InstanceCropDataset(images, ann, crop_size=cfg.crop_size), cfg,
                         steps=1, p=2, k=2, seed=0, model=m, log_every=0, mesh=mesh)
    return dict(loss=loss, digest=digest(m))


def fused_step(mesh, cfg, ft, max_objects, state_dict, consts, draws):
    """One fused refine step over the mesh, rank r fed draws[r] (the JAX
    package's shard r draws) in place of its own generators'."""
    h, w = consts[0].shape[1:]
    run = build_refine_fused_runs((h, w), cfg, ft, max_objects, mesh)
    m = _module("refine", cfg, state_dict)
    return _recorded_step(mesh, m, lambda d: run.loss(m, run.batch(d, consts)),
                          ft.learning_rate, draws[mesh.rank])


def multi_video(mesh, cfg, ft, state_dict, videos):
    m = _module("refine", cfg, state_dict)
    tuned, losses = finetune_refine_videos(m, videos, cfg, ft, mesh=mesh)
    return dict(losses=np.asarray(losses), digests=[digest(t) for t in tuned])


def sharded_inference(mesh, cfg, state_dicts, frames, gt, num_objects):
    models = build_models(cfg, device=mesh.device)
    for name, sd in state_dicts.items():
        getattr(models, name).load_state_dict(sd)
    labels = run_sequences_sharded(models, cfg, frames, gt, num_objects, mesh)
    return dict(labels=labels.cpu().numpy())


def maskrcnn_train(mesh, root, cfg, state_dict, image_hw):
    """train_maskrcnn over the mesh: one step at a global batch of 2."""
    from premvos_tpu_torch.data.davis import DavisDataset
    from premvos_tpu_torch.train.train_maskrcnn import train_maskrcnn

    m, loss = train_maskrcnn(DavisDataset(root), cfg, image_hw=image_hw, max_objects=2, steps=1,
                             batch_size=2, seed=0, model=_module("maskrcnn", cfg, state_dict),
                             log_every=0, mesh=mesh)
    return dict(loss=loss, digest=digest(m))


def refine_train(mesh, root, cfg, state_dict, image_hw):
    """train_refine over the mesh: one step at a global batch of 4."""
    from premvos_tpu_torch.data.davis import DavisDataset
    from premvos_tpu_torch.train.train_refine import train_refine

    m, loss = train_refine(DavisDataset(root, split="val"), cfg, steps=1, batch_size=4, seed=0,
                           model=_module("refine", cfg, state_dict), image_hw=image_hw,
                           log_every=0, mesh=mesh)
    return dict(loss=loss, digest=digest(m))


def flow_train(mesh, chairs, max_displacement, crop_hw, state_dict):
    """train_flownet_c over the mesh: one step at a global batch of 2."""
    from premvos_tpu_torch.data.flow_pairs import FlowPairDataset
    from premvos_tpu_torch.models.flownet import FlowNetC
    from premvos_tpu_torch.train.train_flow import train_flownet_c

    m = FlowNetC(max_displacement=max_displacement)
    m.load_state_dict(state_dict)
    m, loss = train_flownet_c(FlowPairDataset(chairs), steps=1, batch_size=2, crop_hw=crop_hw,
                              max_displacement=max_displacement, seed=0, model=m, log_every=0,
                              mesh=mesh)
    return dict(loss=loss, digest=digest(m))


def pool_finetune(mesh, cfg, state_dicts, frame, labels, draws):
    """finetune_video(method "pool") over the mesh, each pool step's draws
    of the global batch looked up in `draws` ({(pool rows, batch):
    PoolDraws}) in place of the port's own."""
    from premvos_tpu_torch.finetune import finetune as tft
    from premvos_tpu_torch.finetune.fused import finetune_video
    from premvos_tpu_torch.pipeline.runner import Models

    tft.sample_pool_draws = lambda gen, steps, pool_n, bs: draws[(pool_n, bs)]
    models = Models(maskrcnn=_module("maskrcnn", cfg.proposal, state_dicts["maskrcnn"]),
                    refine=_module("refine", cfg.refine, state_dicts["refine"]),
                    flow=torch.nn.Linear(2, 2), reid=torch.nn.Linear(2, 2))
    new, losses = finetune_video(models, frame, labels, cfg, mesh=mesh)
    return dict(losses=losses, digests={n: digest(getattr(new, n)) for n in ("refine", "maskrcnn")})


def refine_cli(mesh, argv):
    """train_refine.main(argv) on this rank (its mesh from the group),
    torch.save recorded, not written: the paths each rank saved to."""
    from premvos_tpu_torch.train import train_refine

    saved, real = [], torch.save
    torch.save = lambda obj, path: saved.append(str(path))
    try:
        train_refine.main(argv)
    finally:
        torch.save = real
    return dict(saved=saved)


def run_davis_cli(mesh, argv):
    """run_davis.main(argv) on this rank (its mesh from the group)."""
    from premvos_tpu_torch.pipeline import run_davis

    return dict(summary=run_davis.main(argv))


def fail_on_rank_one(mesh):
    if mesh.rank == 1:
        raise ValueError("rank one fails")
    mesh.all_reduce_(torch.zeros(1))  # rank 0 waits in a collective
    return mesh.rank


CASES = {"dp_step": dp_step, "reid": reid_train, "fused": fused_step,
         "multi_video": multi_video, "sharded": sharded_inference, "run_davis": run_davis_cli,
         "maskrcnn_train": maskrcnn_train, "refine_train": refine_train, "flow_train": flow_train,
         "pool_finetune": pool_finetune, "refine_cli": refine_cli}


def parity_rank(mesh, cases: dict) -> dict:
    """Every case of `cases` ({name: (kind, kwargs)}) on this rank, in
    order."""
    return {name: CASES[kind](mesh, **kw) for name, (kind, kw) in cases.items()}
