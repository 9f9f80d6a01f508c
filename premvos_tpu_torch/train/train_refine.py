"""Refinement-net general training (port of premvos_tpu/train/train_refine.py).

The OnAVOS-family Engine trains the DeepLabv3+ refinement net with
proposal-conditioned inputs before any per-video fine-tuning. Here, as in
the JAX package, examples are cut from the annotated frames of any
DAVIS-layout dataset: each (crop + perturbed coarse-mask channel) →
GT-mask example of finetune/finetune.py::make_refine_examples. The step of
train/trainer.py, float32 without TF32, on one device or, with `mesh=`,
data-parallel over the mesh's ranks (examples sharded; under torchrun the
CLI builds the mesh and rank 0 alone logs and saves). Runs on CUDA unless
the caller passes device="cpu".

  python -m premvos_tpu_torch.train.train_refine --davis_root D --split train \\
      --steps 5000 [--batch_size 8] [--out model.pt]
  torchrun --nproc_per_node N -m premvos_tpu_torch.train.train_refine ...
"""

from __future__ import annotations

import argparse
import logging

import numpy as np
import torch

from premvos_tpu_torch.config import RefineConfig
from premvos_tpu_torch.data.davis import DavisDataset
from premvos_tpu_torch.finetune.finetune import make_refine_examples, refine_loss_fn
from premvos_tpu_torch.models.deeplab import DeepLabV3Plus
from premvos_tpu_torch.models.layers import init_module
from premvos_tpu_torch.parallel.mesh import as_mesh, init_from_env, shard_batch
from premvos_tpu_torch.pipeline.runner import place
from premvos_tpu_torch.train.trainer import dp_batch_size, run_steps


def example_stream(ds, cfg: RefineConfig, rng, max_objects=8, pool_frames=64,
                   image_hw=(480, 864)):
    """Host-side generator of (crops [M, S, S, 4], targets [M, S, S]) from
    one random annotated frame of a random sequence at a time, drawn from
    `rng` in the JAX package's order. `ds`: anything with `sequences` and
    `load_sequence(seq, h, w, max_objects)` returning "frames" and
    "gt_labels" (data/davis.py's DavisDataset, or an in-memory one)."""
    h, w = image_hw
    while True:
        seq = ds.sequences[rng.integers(0, len(ds.sequences))]
        data = ds.load_sequence(seq, h, w, max_objects)
        if not len(data["gt_labels"]):
            continue
        t = rng.integers(0, len(data["gt_labels"]))
        crops, tgts = make_refine_examples(
            data["frames"][t:t + 1], data["gt_labels"][t:t + 1],
            cfg.crop_size, cfg.box_margin, rng,
        )
        if len(crops):
            yield crops, tgts


def example_batches(stream, batch_size: int, device, mesh=None):
    """next_batch() of `batch_size` examples from `stream`'s pools, in
    order, carried over between batches, as tensors on `device`; with a
    `mesh`, this rank's block of each batch."""
    buf_x, buf_y = [], []

    def next_batch():
        while len(buf_x) < batch_size:
            cx, cy = next(stream)
            buf_x.extend(cx)
            buf_y.extend(cy)
        x, y = np.stack(buf_x[:batch_size]), np.stack(buf_y[:batch_size])
        del buf_x[:batch_size], buf_y[:batch_size]
        if mesh is not None:
            x, y = shard_batch((x, y), mesh)
        return torch.from_numpy(x).to(device), torch.from_numpy(y).to(device)

    return next_batch


def train_refine(
    ds,
    cfg: RefineConfig = RefineConfig(),
    steps: int = 1000,
    batch_size: int = 8,
    learning_rate: float = 1e-4,
    seed: int = 0,
    model: DeepLabV3Plus | None = None,
    image_hw=(480, 864),
    log_every: int = 100,
    device=None,
    mesh=None,
):
    """Train `model` (else a DeepLabV3Plus(cfg) with weights drawn from
    `seed`) for `steps` Adam steps on batches of `batch_size` refine
    examples of `ds` (see example_stream), drawn from numpy's generator
    seeded by `seed`. With a `mesh`: a global batch of max(batch_size −
    batch_size % n, n) examples taken whole on every rank, each rank's
    block on its device. Returns (model, last loss)."""
    mesh = as_mesh(mesh, device)
    device, bs = mesh.device, dp_batch_size(batch_size, mesh.size)
    if model is None:
        model = DeepLabV3Plus(cfg)
        init_module(model, torch.Generator().manual_seed(seed))
    model = place(model, device).train()
    rng = np.random.default_rng(seed)
    stream = example_stream(ds, cfg, rng, image_hw=image_hw)
    loss = run_steps(model, refine_loss_fn(model), example_batches(stream, bs, device, mesh),
                     steps, mesh, learning_rate, log_every, "refine")
    return model, loss


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--davis_root", required=True)
    ap.add_argument("--split", default="train")
    ap.add_argument("--steps", type=int, default=1000)
    ap.add_argument("--batch_size", type=int, default=8)
    ap.add_argument("--device", default=None, help="default: cuda (raises without a card)")
    ap.add_argument("--out", default=None, help="save the trained state_dict here")
    args = ap.parse_args(argv)

    logging.basicConfig(level=logging.INFO)
    mesh = init_from_env(args.device)
    model, loss = train_refine(DavisDataset(args.davis_root, split=args.split),
                               steps=args.steps, batch_size=args.batch_size,
                               mesh=mesh)
    if mesh.rank != 0:
        return
    if args.out:
        torch.save(model.state_dict(), args.out)
    print({"final_loss": loss})


if __name__ == "__main__":
    main()
