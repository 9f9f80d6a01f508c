"""Local ranks, and the multi-rank dry run (port of
__graft_entry__.py::dryrun_multichip).

`spawn(fn, world_size, backend, *args)` runs fn(mesh, *args) in
`world_size` fresh processes of this machine, joined by a process group
whose rendezvous is a FileStore in a temporary directory (no TCP port, so
concurrent test workers cannot collide), and returns each rank's result.
`fn` must be importable by name in a fresh interpreter (a module-level
function of a module that does not import JAX).

`dryrun_multichip(n)` runs, at the JAX package's tiny configuration, (a) a
data-parallel refine-net step, (b) a data-parallel Mask R-CNN step, (c)
the multi-video fine-tune (one video a rank) and the fused fine-tune over
the mesh, (d) sequence-sharded inference of n tiny sequences. It runs n
NCCL ranks, one a card, and raises with fewer than n visible cards unless
the caller asks for the CPU (device="cpu", `--device cpu`): then n gloo
ranks on the CPU, the JAX package's virtual-mesh strategy, and it says so.

  python -m premvos_tpu_torch.parallel.dryrun --devices N [--device cpu]
"""

from __future__ import annotations

import argparse
import datetime
import os
import tempfile
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from premvos_tpu_torch.parallel.mesh import make_mesh

# How long a spawn's ranks may run, and each collective may wait.
TIMEOUT_S = 1800.0


def _rank_main(fn, rank, world_size, backend, device, threads, tmp, args):
    os.environ["LOCAL_RANK"] = str(rank)
    torch.set_num_threads(threads)
    try:
        store = dist.FileStore(os.path.join(tmp, "store"), world_size)
        dist.init_process_group(backend, store=store, rank=rank, world_size=world_size,
                                timeout=datetime.timedelta(seconds=TIMEOUT_S))
        result = fn(make_mesh(world_size, device=device, backend=backend), *args)
        torch.save(result, os.path.join(tmp, f"rank{rank}.pt"))
    except BaseException:
        with open(os.path.join(tmp, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn(fn, world_size: int, backend: str, *args, device=None):
    """fn(mesh, *args) on `world_size` local ranks (`backend` "gloo" or
    "nccl"; the mesh on `device` if given, else make_mesh's choice); each
    rank runs torch with this process's intra-op thread count. Returns the
    list of the ranks' results (torch.save'd by each rank, loaded onto the
    CPU). Raises, with each failed rank's traceback, if any rank fails or
    the ranks outlast TIMEOUT_S; the other ranks are then stopped, and no
    partial result is returned."""
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="premvos_spawn_") as tmp:
        procs = [ctx.Process(target=_rank_main, args=(
            fn, r, world_size, backend, device, torch.get_num_threads(), tmp, args))
            for r in range(world_size)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + TIMEOUT_S
        try:
            while any(p.is_alive() for p in procs):
                if any(p.exitcode not in (None, 0) for p in procs):
                    break
                if time.monotonic() > deadline:
                    break
                time.sleep(0.05)
        finally:
            for p in procs:
                if p.is_alive():
                    p.terminate()
                p.join()
        failed = [r for r, p in enumerate(procs) if p.exitcode != 0]
        if failed:
            errs = []
            for r in failed:
                path = os.path.join(tmp, f"rank{r}.err")
                text = open(path).read() if os.path.exists(path) else ""
                errs.append(f"rank {r} (exit code {procs[r].exitcode}):\n{text}")
            raise RuntimeError(f"spawn of {world_size} {backend} ranks failed:\n" + "\n".join(errs))
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"), map_location="cpu",
                           weights_only=False) for r in range(world_size)]


def tiny_config():
    """The JAX package's `_tiny_config` (__graft_entry__.py), in the port's
    config classes."""
    from premvos_tpu_torch.config import (
        FlowConfig,
        PipelineConfig,
        PremvosConfig,
        ProposalConfig,
        RefineConfig,
        ReIDConfig,
    )

    return PremvosConfig(
        proposal=ProposalConfig(backbone_depth=26, fpn_channels=32, rpn_pre_nms_topk=32,
                                rpn_post_nms_topk=8, detections_per_frame=4),
        refine=RefineConfig(crop_size=33, backbone_depth=26),
        flow=FlowConfig(variant="flownetc", max_displacement=4, infer_height=64,
                        infer_width=64),
        reid=ReIDConfig(backbone_depth=26, embedding_dim=8, crop_size=32),
        pipeline=PipelineConfig(image_height=64, image_width=64, max_objects=2,
                                max_proposals=4, dtype="float32"),
    )


def dryrun_rank(mesh) -> dict:
    """One rank of the dry run (see the module's docstring): returns each
    part's loss or the labels' shape; rank 0 prints a line a part."""
    from premvos_tpu_torch.config import FinetuneConfig
    from premvos_tpu_torch.finetune.finetune import refine_loss_fn
    from premvos_tpu_torch.finetune.fused import finetune_refine_fused
    from premvos_tpu_torch.finetune.multi_video import finetune_refine_videos
    from premvos_tpu_torch.models.anchors import pyramid_anchors
    from premvos_tpu_torch.models.deeplab import DeepLabV3Plus
    from premvos_tpu_torch.models.layers import init_module
    from premvos_tpu_torch.models.maskrcnn import MaskRCNN
    from premvos_tpu_torch.parallel.mesh import run_sequences_sharded, shard_batch
    from premvos_tpu_torch.pipeline.runner import build_models, init_params, place
    from premvos_tpu_torch.train.detection import maskrcnn_loss_fn
    from premvos_tpu_torch.train.trainer import (
        create_train_state,
        make_dp_train_step,
        replicate_state,
    )

    n, dev = mesh.size, mesh.device
    say = print if mesh.rank == 0 else (lambda *a, **k: None)
    cfg = tiny_config()
    pl, s = cfg.pipeline, cfg.refine.crop_size
    rng = np.random.default_rng(0)
    out = {}

    # (a) The refine net: replicated weights, a sharded crop batch.
    model = DeepLabV3Plus(cfg.refine)
    init_module(model, torch.Generator().manual_seed(0))
    model = place(model, dev).train()
    crops = rng.standard_normal((2 * n, s, s, 4)).astype(np.float32)
    targets = (rng.uniform(0, 1, (2 * n, s, s)) > 0.5).astype(np.float32)
    x, y = (torch.from_numpy(a).to(dev) for a in shard_batch((crops, targets), mesh))
    state = replicate_state(create_train_state(model, 1e-4), mesh)
    step = make_dp_train_step(refine_loss_fn(model), state.optimizer, mesh)
    out["refine_loss"] = float(step((x, y)))
    say(f"[dryrun] DP train step on {n} ranks: loss={out['refine_loss']:.4f}", flush=True)

    # (b) Mask R-CNN: the full detection loss, sharded over images.
    det = MaskRCNN(cfg.proposal)
    init_module(det, torch.Generator().manual_seed(2))
    det = place(det, dev).train()
    hw = (pl.image_height, pl.image_width)
    anchors = {k: torch.from_numpy(v).to(dev) for k, v in pyramid_anchors(
        *hw, cfg.proposal.anchor_scales, cfg.proposal.anchor_ratios).items()}
    g = pl.max_objects
    imgs = rng.standard_normal((n, *hw, 3)).astype(np.float32)
    boxes = np.tile(np.asarray([[4.0, 4.0, 28.0, 28.0]] * g, np.float32), (n, 1, 1))
    masks = np.zeros((n, g, *hw), np.float32)
    masks[:, :, 8:24, 8:24] = 1.0
    valid = np.ones((n, g), bool)
    seeds = np.arange(n, dtype=np.uint32)
    im, gb, gm, gv, sd = shard_batch((imgs, boxes, masks, valid, seeds), mesh)
    det_state = replicate_state(create_train_state(det, 1e-4), mesh)
    det_step = make_dp_train_step(maskrcnn_loss_fn(det, anchors, cfg.proposal, hw),
                                  det_state.optimizer, mesh)
    batch = (*(torch.from_numpy(a).to(dev) for a in (im, gb, gm, gv)), sd)
    out["maskrcnn_loss"] = float(det_step(batch))
    say(f"[dryrun] Mask R-CNN DP train step on {n} ranks: loss={out['maskrcnn_loss']:.4f}",
        flush=True)

    # (c) Per-video fine-tunes over the mesh: one video a rank, and the
    # fused fine-tune data-parallel.
    frame0 = rng.integers(0, 255, (*hw, 3)).astype(np.uint8)
    lab0 = np.zeros(hw, np.int32)
    lab0[8:24, 8:24] = 1
    lab0[40:56, 30:50] = 2
    ft = FinetuneConfig(num_augmentations=4, steps=2, batch_size=2 * n, chunk=2, aug_patch=32)
    tuned, vlosses = finetune_refine_videos(model, [(frame0, lab0)] * n, cfg.refine, ft,
                                            mesh=mesh)
    assert len(tuned) == n and np.isfinite(vlosses).all(), vlosses
    out["video_losses"] = vlosses
    say(f"[dryrun] video-parallel finetune: {n} videos sharded across {n} ranks", flush=True)
    _, floss = finetune_refine_fused(model, frame0, lab0, cfg.refine, ft,
                                     max_objects=pl.max_objects, mesh=mesh)
    out["fused_loss"] = floss
    say(f"[dryrun] fused finetune (on-device lucid aug, DP x{n}): loss={floss:.4f}", flush=True)

    # (d) Sequence-sharded inference: one tiny sequence a rank.
    models = init_params(build_models(cfg, dev), cfg, seed=1, device=dev)
    frames = rng.integers(0, 255, (n, 2, *hw, 3)).astype(np.uint8)
    gt = np.zeros((n, g, *hw), np.float32)
    gt[:, 0, 10:20, 10:20] = 1.0
    labels = run_sequences_sharded(models, cfg, frames, gt, np.ones(n, np.int32), mesh)
    out["labels_shape"] = tuple(labels.shape)
    say(f"[dryrun] sharded inference on {n} ranks: labels {tuple(labels.shape)}", flush=True)
    return out


def dryrun_multichip(n_devices: int, device=None) -> list:
    """The dry run on `n_devices` ranks (see the module's docstring):
    NCCL ranks, one CUDA card each, unless `device` names the CPU (gloo
    ranks there). Returns each rank's dryrun_rank result."""
    if device is not None and torch.device(device).type == "cpu":
        print(f"[dryrun] {n_devices} gloo ranks on the CPU (the JAX package's virtual-mesh "
              "strategy)", flush=True)
        return spawn(dryrun_rank, n_devices, "gloo", device="cpu")
    cards = torch.cuda.device_count()
    if cards < n_devices:
        raise RuntimeError(
            f"{n_devices} NCCL ranks need {n_devices} CUDA cards, {cards} visible: pass "
            f"device='cpu' (--device cpu) for {n_devices} gloo ranks on the CPU")
    return spawn(dryrun_rank, n_devices, "nccl")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--devices", type=int, required=True, help="number of ranks")
    ap.add_argument("--device", default=None,
                    help="cpu: gloo ranks on the CPU (default: one CUDA card a rank; "
                    "raises with fewer cards than ranks)")
    args = ap.parse_args(argv)
    dryrun_multichip(args.devices, args.device)


if __name__ == "__main__":
    main()
