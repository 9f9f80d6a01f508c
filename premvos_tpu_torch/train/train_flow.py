"""FlowNetC training: multi-scale endpoint error on image pairs (port of
premvos_tpu/train/train_flow.py).

flownet2-pytorch's train loop with its `MultiScale` loss on
FlyingChairs-layout pairs (data/flow_pairs.py): the net predicts
flow / DIV_FLOW at 1/4 resolution, and every level of its pyramid is
supervised. The step of train/trainer.py, float32 without TF32, on one
device or, with `mesh=`, data-parallel over the mesh's ranks (pairs
sharded; under torchrun the CLI builds the mesh and rank 0 alone logs and
saves). The cost volume's forward and backward run as CUDA kernels on the
card (ops/correlation.py). Runs on CUDA unless the caller passes
device="cpu".

  python -m premvos_tpu_torch.train.train_flow --data <chairs_dir> \\
      --steps 1000 [--batch_size 8 --crop 64 64] [--out model.pt | DIR]
  torchrun --nproc_per_node N -m premvos_tpu_torch.train.train_flow ...
"""

from __future__ import annotations

import argparse
import logging

import numpy as np
import torch

from premvos_tpu_torch.data.flow_pairs import FlowPairDataset
from premvos_tpu_torch.models.flownet import FlowNetC
from premvos_tpu_torch.models.layers import init_module
from premvos_tpu_torch.parallel.mesh import as_mesh, init_from_env, shard_batch
from premvos_tpu_torch.pipeline.runner import place
from premvos_tpu_torch.train.losses import multiscale_epe
from premvos_tpu_torch.train.trainer import dp_batch_size, run_steps
from premvos_tpu_torch.utils.checkpoint import save_net

DIV_FLOW = 20.0


def device_batch(arrays, device):
    """(img1, img2, flow) [B, H, W, C] numpy, as FlowPairDataset.batch gives
    them → NCHW tensors on `device` (channels-last in memory)."""
    return tuple(torch.from_numpy(a).to(device).permute(0, 3, 1, 2) for a in arrays)


def flow_loss_fn(model: FlowNetC):
    """loss(batch) of a FlowNetC: the multi-scale EPE of its pyramid
    against the target flow / DIV_FLOW."""

    def loss_fn(batch):
        i1, i2, gt = batch
        _, flows = model(i1, i2)
        return multiscale_epe(flows, gt / DIV_FLOW)

    return loss_fn


def train_flownet_c(
    dataset: FlowPairDataset,
    steps: int = 1000,
    batch_size: int = 8,
    crop_hw=(64, 64),
    max_displacement: int = 20,
    learning_rate: float = 1e-4,
    seed: int = 0,
    model: FlowNetC | None = None,
    log_every: int = 100,
    device=None,
    mesh=None,
):
    """Train `model` (else a FlowNetC(max_displacement)
    with weights drawn from `seed`) for `steps` Adam steps on random crops
    of `dataset`'s pairs, drawn from numpy's generator seeded by `seed`.
    With a `mesh`: a global batch of max(batch_size − batch_size % n, n)
    pairs drawn whole on every rank, each rank's block on its device, the
    gradients and loss averaged over the mesh. Returns (model, last loss)."""
    mesh = as_mesh(mesh, device)
    device, bs = mesh.device, dp_batch_size(batch_size, mesh.size)
    if model is None:
        model = FlowNetC(max_displacement=max_displacement)
        init_module(model, torch.Generator().manual_seed(seed))
    model = place(model, device).train()
    rng = np.random.default_rng(seed)
    loss = run_steps(
        model, flow_loss_fn(model),
        lambda: device_batch(shard_batch(dataset.batch(rng, bs, crop_hw), mesh), device),
        steps, mesh, learning_rate, log_every, "flow",
    )
    return model, loss


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--data", required=True, help="a FlyingChairs-layout directory")
    ap.add_argument("--steps", type=int, default=1000)
    ap.add_argument("--batch_size", type=int, default=8)
    ap.add_argument("--crop", type=int, nargs=2, default=(64, 64), metavar=("H", "W"))
    ap.add_argument("--max_displacement", type=int, default=20)
    ap.add_argument("--device", default=None, help="default: cuda (raises without a card)")
    ap.add_argument("--out", default=None,
                    help="save the trained net here: its state_dict to a path ending in .pt, "
                         "else an orbax directory the JAX package restores")
    args = ap.parse_args(argv)

    logging.basicConfig(level=logging.INFO)
    mesh = init_from_env(args.device)
    model, loss = train_flownet_c(
        FlowPairDataset(args.data), steps=args.steps, batch_size=args.batch_size,
        crop_hw=tuple(args.crop), max_displacement=args.max_displacement,
        mesh=mesh,
    )
    if mesh.rank != 0:
        return
    if args.out:
        save_net(args.out, model)
    print({"final_loss": loss})


if __name__ == "__main__":
    main()
