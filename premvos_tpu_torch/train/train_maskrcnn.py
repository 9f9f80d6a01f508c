"""Mask R-CNN training (port of premvos_tpu/train/train_maskrcnn.py).

Trains on any DAVIS-layout dataset (anything with `.sequences` and
`.load_sequence(seq, h, w, max_objects)`): every annotated frame yields an
image with GT boxes and masks, through the full detection loss
(train/detection.py) and the step of train/trainer.py, on one device or,
with `mesh=`, data-parallel over the mesh's ranks (the global batch sharded
by image; under torchrun the CLI builds the mesh and rank 0 alone logs and
saves). Runs on CUDA unless the caller passes device="cpu".

  python -m premvos_tpu_torch.train.train_maskrcnn --davis_root D --split train \\
      --steps 5000 [--height 480 --width 864] [--out model.pt]
  torchrun --nproc_per_node N -m premvos_tpu_torch.train.train_maskrcnn ...
"""

from __future__ import annotations

import argparse
import logging

import numpy as np
import torch

from premvos_tpu_torch.config import ProposalConfig
from premvos_tpu_torch.data.davis import DavisDataset
from premvos_tpu_torch.data.preprocess import IMAGENET_MEAN, IMAGENET_STD
from premvos_tpu_torch.finetune.finetune import labels_to_boxes_masks
from premvos_tpu_torch.models.anchors import pyramid_anchors
from premvos_tpu_torch.models.layers import init_module
from premvos_tpu_torch.models.maskrcnn import MaskRCNN
from premvos_tpu_torch.parallel.mesh import as_mesh, init_from_env, shard_batch
from premvos_tpu_torch.pipeline.runner import place
from premvos_tpu_torch.train.detection import maskrcnn_loss_fn
from premvos_tpu_torch.train.trainer import dp_batch_size, run_steps


def sample_batch(ds, rng: np.random.Generator, image_hw, max_objects: int,
                 batch_size: int, device, mesh=None):
    """One batch, drawn from `rng` in the JAX engine's order: for each image
    a sequence, then one of its annotated frames (frames without an object
    are drawn again), then the per-image sampling seeds.

    Returns (images [B, H, W, 3] normalized, gt_boxes [B, K, 4], gt_masks
    [B, K, H, W], gt_valid [B, K]) on `device`, and seeds [B] uint32 on the
    host; with a `mesh`, every rank draws the whole batch and keeps its
    block of B / n images.
    """
    h, w = image_hw
    mean = np.asarray(IMAGENET_MEAN, np.float32)
    std = np.asarray(IMAGENET_STD, np.float32)
    imgs, gbs, gms, gvs = [], [], [], []
    while len(imgs) < batch_size:
        seq = ds.sequences[rng.integers(0, len(ds.sequences))]
        data = ds.load_sequence(seq, h, w, max_objects)
        if not len(data["gt_labels"]):
            continue
        t = rng.integers(0, len(data["gt_labels"]))
        boxes, masks, valid = labels_to_boxes_masks(data["gt_labels"][t], max_objects)
        if not valid.any():
            continue
        img = data["frames"][t].astype(np.float32) / 255.0
        imgs.append((img - mean) / std)
        gbs.append(boxes)
        gms.append(masks)
        gvs.append(valid)
    seeds = rng.integers(0, 2**31 - 1, size=batch_size).astype(np.uint32)
    arrays = (np.stack(imgs), np.stack(gbs), np.stack(gms), np.stack(gvs), seeds)
    if mesh is not None:
        arrays = shard_batch(arrays, mesh)
    return (*(torch.from_numpy(a).to(device) for a in arrays[:4]), arrays[4])


def train_maskrcnn(
    ds,
    cfg: ProposalConfig = ProposalConfig(),
    image_hw=(480, 864),
    max_objects: int = 8,
    steps: int = 1000,
    batch_size: int = 2,
    learning_rate: float = 1e-4,
    seed: int = 0,
    model: MaskRCNN | None = None,
    log_every: int = 100,
    device=None,
    mesh=None,
):
    """Train `model` (else a MaskRCNN(cfg) with weights drawn from `seed`)
    for `steps` Adam steps in float32. With a `mesh`: the global batch is
    max(batch_size − batch_size % n, n) images, drawn whole on every rank,
    each rank's block on its device, rank 0's weights replicated first, the
    gradients and loss averaged over the mesh. Returns (model, last loss)."""
    mesh = as_mesh(mesh, device)
    device, bs = mesh.device, dp_batch_size(batch_size, mesh.size)
    h, w = image_hw
    if model is None:
        model = MaskRCNN(cfg)
        init_module(model, torch.Generator().manual_seed(seed))
    model = place(model, device).train()
    anchors = {
        k: torch.from_numpy(v).to(device)
        for k, v in pyramid_anchors(h, w, cfg.anchor_scales, cfg.anchor_ratios).items()
    }
    rng = np.random.default_rng(seed)
    loss = run_steps(
        model, maskrcnn_loss_fn(model, anchors, cfg, image_hw),
        lambda: sample_batch(ds, rng, image_hw, max_objects, bs, device, mesh),
        steps, mesh, learning_rate, log_every, "maskrcnn",
    )
    return model, loss


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--davis_root", required=True)
    ap.add_argument("--split", default="train")
    ap.add_argument("--steps", type=int, default=1000)
    ap.add_argument("--batch_size", type=int, default=2)
    ap.add_argument("--height", type=int, default=480)
    ap.add_argument("--width", type=int, default=864)
    ap.add_argument("--device", default=None, help="default: cuda (raises without a card)")
    ap.add_argument("--out", default=None, help="save the trained state_dict here")
    args = ap.parse_args(argv)

    logging.basicConfig(level=logging.INFO)
    mesh = init_from_env(args.device)
    ds = DavisDataset(args.davis_root, split=args.split)
    model, loss = train_maskrcnn(
        ds, image_hw=(args.height, args.width), steps=args.steps,
        batch_size=args.batch_size, mesh=mesh,
    )
    if mesh.rank != 0:
        return
    if args.out:
        torch.save(model.state_dict(), args.out)
    print({"final_loss": loss})


if __name__ == "__main__":
    main()
