"""ReID training: batch-hard triplet loss over PK batches (port of
premvos_tpu/train/train_reid.py).

The OnAVOS-family ReID net trained on object crops (data/crops.py: COCO,
PASCAL-VOC or DAVIS objects), each batch P identities × K crops,
ImageNet-normalised, the step of train/trainer.py, float32 without TF32.
On one device a step is one PK group. With `mesh=` it is one PK group a
rank, as in the JAX package: every rank draws all n groups in rank order
(group d's ids offset by d·P), keeps its own, mines its hardest triplets
within it, and the loss and gradients are averaged over the mesh. A
triplet over the gathered global batch would be another loss. Under
torchrun the CLI builds the mesh and rank 0 alone logs and saves. Runs on
CUDA unless the caller passes device="cpu".

  python -m premvos_tpu_torch.train.train_reid --images <dir> \\
      --annotations instances.json --steps 1000 [--out model.pt]
  torchrun --nproc_per_node N -m premvos_tpu_torch.train.train_reid ...
"""

from __future__ import annotations

import argparse
import logging

import numpy as np
import torch

from premvos_tpu_torch.config import ReIDConfig
from premvos_tpu_torch.data.crops import InstanceCropDataset
from premvos_tpu_torch.data.preprocess import IMAGENET_MEAN, IMAGENET_STD
from premvos_tpu_torch.models.layers import init_module
from premvos_tpu_torch.models.reid import ReIDNet
from premvos_tpu_torch.parallel.mesh import as_mesh, init_from_env
from premvos_tpu_torch.pipeline.runner import place
from premvos_tpu_torch.train.losses import batch_hard_triplet
from premvos_tpu_torch.train.trainer import run_steps


def pk_device_batch(dataset, rng: np.random.Generator, p: int, k: int, device, mesh=None):
    """One PK batch from `dataset.pk_batch(rng, p, k)`, ImageNet-normalised:
    (crops [P·K, 3, S, S] on `device`, channels-last in memory, ids [P·K]).
    With a `mesh`, n groups are drawn and rank r keeps group r, its ids
    offset by r·P."""
    n, r = (mesh.size, mesh.rank) if mesh else (1, 0)
    groups = [dataset.pk_batch(rng, p, k) for _ in range(n)]
    crops, ids = groups[r][0], np.asarray(groups[r][1]) + r * p
    mean = np.asarray(IMAGENET_MEAN, np.float32)
    std = np.asarray(IMAGENET_STD, np.float32)
    crops = torch.from_numpy((crops - mean) / std).to(device).permute(0, 3, 1, 2)
    return crops, torch.from_numpy(np.asarray(ids)).to(device)


def reid_loss_fn(model: ReIDNet, margin: float):
    """loss(batch) = the batch-hard triplet loss of the batch's embeddings."""

    def loss_fn(batch):
        crops, ids = batch
        return batch_hard_triplet(model(crops), ids, margin)

    return loss_fn


def train_reid(
    dataset,
    cfg: ReIDConfig = ReIDConfig(),
    steps: int = 1000,
    p: int = 8,
    k: int = 4,
    learning_rate: float = 1e-4,
    seed: int = 0,
    model: ReIDNet | None = None,
    log_every: int = 100,
    device=None,
    mesh=None,
):
    """Train `model` (else a ReIDNet(cfg) with weights drawn from `seed`)
    for `steps` Adam steps on PK batches of `dataset` (anything with
    `pk_batch(rng, p, k)`), drawn from numpy's generator seeded by `seed`;
    with a `mesh`, one PK group a rank (see the module's docstring).
    Returns (model, last loss)."""
    mesh = as_mesh(mesh, device)
    device = mesh.device
    if model is None:
        model = ReIDNet(cfg)
        init_module(model, torch.Generator().manual_seed(seed))
    model = place(model, device).train()
    rng = np.random.default_rng(seed)
    loss = run_steps(
        model, reid_loss_fn(model, cfg.triplet_margin),
        lambda: pk_device_batch(dataset, rng, p, k, device, mesh),
        steps, mesh, learning_rate, log_every, "reid",
    )
    return model, loss


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--images", required=True)
    ap.add_argument("--annotations", required=True)
    ap.add_argument("--steps", type=int, default=1000)
    ap.add_argument("--device", default=None, help="default: cuda (raises without a card)")
    ap.add_argument("--out", default=None, help="save the trained state_dict here")
    args = ap.parse_args(argv)

    logging.basicConfig(level=logging.INFO)
    mesh = init_from_env(args.device)
    ds = InstanceCropDataset(args.images, args.annotations)
    model, loss = train_reid(ds, steps=args.steps, mesh=mesh)
    if mesh.rank != 0:
        return
    if args.out:
        torch.save(model.state_dict(), args.out)
    print({"final_loss": loss})


if __name__ == "__main__":
    main()
