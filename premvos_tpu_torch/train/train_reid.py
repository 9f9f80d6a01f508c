"""ReID training: batch-hard triplet loss over PK batches (port of
premvos_tpu/train/train_reid.py).

The OnAVOS-family ReID net trained on object crops (data/crops.py: COCO,
PASCAL-VOC or DAVIS objects), each batch P identities × K crops,
ImageNet-normalised. One device (one PK group per step, so batch-hard
mining sees whole identities), the single-device step of
train/trainer.py, float32 without TF32. Runs on CUDA unless the caller
passes device="cpu".

  python -m premvos_tpu_torch.train.train_reid --images <dir> \\
      --annotations instances.json --steps 1000 [--out model.pt]
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
from premvos_tpu_torch.pipeline.runner import place, resolve_device
from premvos_tpu_torch.train.losses import batch_hard_triplet
from premvos_tpu_torch.train.trainer import run_steps


def pk_device_batch(dataset, rng: np.random.Generator, p: int, k: int, device):
    """One PK batch from `dataset.pk_batch(rng, p, k)`, ImageNet-normalised:
    (crops [P·K, 3, S, S] on `device`, channels-last in memory, ids [P·K])."""
    crops, ids = dataset.pk_batch(rng, p, k)
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
):
    """Train `model` (else a ReIDNet(cfg) with weights drawn from `seed`)
    for `steps` Adam steps on PK batches of `dataset` (anything with
    `pk_batch(rng, p, k)`), drawn from numpy's generator seeded by `seed`.
    Returns (model, last loss)."""
    device = resolve_device(device)
    if model is None:
        model = ReIDNet(cfg)
        init_module(model, torch.Generator().manual_seed(seed))
    model = place(model, device).train()
    rng = np.random.default_rng(seed)
    loss = run_steps(
        model, reid_loss_fn(model, cfg.triplet_margin),
        lambda: pk_device_batch(dataset, rng, p, k, device),
        steps, learning_rate, log_every, "reid",
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
    ds = InstanceCropDataset(args.images, args.annotations)
    model, loss = train_reid(ds, steps=args.steps, device=args.device)
    if args.out:
        torch.save(model.state_dict(), args.out)
    print({"final_loss": loss})


if __name__ == "__main__":
    main()
