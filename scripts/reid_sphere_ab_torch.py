#!/usr/bin/env python3
"""A/B: raw against l2-normalised triplet embeddings on the benchmark
world (port of scripts/reid_sphere_ab.py).

    python3 scripts/reid_sphere_ab_torch.py --data_root ROOT [--steps 800] \
        [--device cpu] [--json PATH]

ROOT is a DAVIS-layout tree with train and val splits, such as
`data/synthetic_vos.py::make_synthetic_vos` writes. Each arm trains the
ReID net of `bench_config(canvas=(128, 192))` (`ReIDConfig.l2_normalize`
False, then True) with `train/train_reid.py::train_reid` on the train
split's object crops (`data/crops.py::DavisObjectCrops`, P 4 × K 4, Adam
3e-4, seed 0, `--steps` steps), then scores top-1 retrieval on the val
split: frame 0's ground-truth crops as anchors against the ground-truth
crops of frames 2, 5, ..., 23 where both objects show, with the mean and
least margin of the right similarity over the wrong one. Prints each arm
and last one JSON line. Runs on the card unless given `--device cpu`.
Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CANVAS = (128, 192)
ARMS = (("raw", False), ("l2norm", True))


def retrieval(model, ds_val, cfg, device) -> tuple:
    """Per val sequence: frame 0's ground-truth crops of objects 1 and 2 as
    anchors against every later sampled frame's (2, 5, ..., 23) where both
    show; (top-1 accuracy, mean margin, least margin), the margin being
    the right similarity less the wrong one (reid_similarity, σ 1)."""
    import torch

    from premvos_tpu_torch.data.preprocess import IMAGENET_MEAN, IMAGENET_STD
    from premvos_tpu_torch.stages.reid import reid_similarity, run_reid

    mean, std = np.float32(IMAGENET_MEAN), np.float32(IMAGENET_STD)
    hits = tot = 0
    margins = []
    for seq in ds_val.sequences:
        d = ds_val.load_sequence(seq, *CANVAS, cfg.pipeline.max_objects)

        def embed(fidx):
            img = (np.asarray(d["frames"][fidx], np.float32) / 255.0 - mean) / std
            lab = np.asarray(d["gt_labels"][fidx])
            bs, vs = [], []
            for k2 in (1, 2):
                ys, xs = np.nonzero(lab == k2)
                if len(ys) == 0:
                    bs.append([0, 0, 1, 1])
                    vs.append(False)
                    continue
                bs.append([xs.min(), ys.min(), xs.max() + 1, ys.max() + 1])
                vs.append(True)
            b = np.pad(np.asarray(bs, np.float32), ((0, 6), (0, 0)))
            v = np.asarray(vs + [False] * 6)
            with torch.no_grad():
                e = run_reid(model, torch.from_numpy(img).permute(2, 0, 1)[None].to(device),
                             torch.from_numpy(b)[None].to(device),
                             torch.from_numpy(v)[None].to(device), cfg.reid.crop_size)
            return e[0, :2], np.asarray(vs)

        ref, vref = embed(0)
        for t in range(2, 24, 3):
            et, vt = embed(t)
            if not (vref.all() and vt.all()):
                continue
            sim = reid_similarity(ref, et, 1.0).cpu().numpy()
            for k2 in range(2):
                tot += 1
                if sim[k2].argmax() == k2:
                    hits += 1
                margins.append(sim[k2, k2] - sim[k2, 1 - k2])
    return hits / max(tot, 1), float(np.mean(margins)), float(np.min(margins))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description="ReID A/B: raw against l2-normalised embeddings.")
    ap.add_argument("--data_root", required=True, help="DAVIS-layout tree (train and val)")
    ap.add_argument("--steps", type=int, default=800, help="training steps an arm")
    ap.add_argument("--device", default=None, help="torch device (default: the card)")
    ap.add_argument("--json", help="also write the result (JSON) here")
    args = ap.parse_args(argv)
    sys.path.insert(0, REPO)
    from premvos_tpu_torch.data.crops import DavisObjectCrops
    from premvos_tpu_torch.data.davis import DavisDataset
    from premvos_tpu_torch.eval.synthetic_benchmark import bench_config
    from premvos_tpu_torch.pipeline.runner import resolve_device
    from premvos_tpu_torch.train.train_reid import train_reid

    device = resolve_device(args.device)
    cfg = bench_config(canvas=CANVAS)
    crops = DavisObjectCrops(DavisDataset(args.data_root, split="train"), cfg.reid.crop_size,
                             CANVAS, max_objects=4)
    print("identities:", len(crops.ids), flush=True)
    ds_val = DavisDataset(args.data_root, split="val")
    out = {}
    for name, l2 in ARMS:
        rc = dataclasses.replace(cfg.reid, l2_normalize=l2)
        t0 = time.perf_counter()
        model, loss = train_reid(crops, rc, steps=args.steps, p=4, k=4, learning_rate=3e-4,
                                 seed=0, log_every=400, device=device)
        model.eval()
        acc, mmean, mmin = retrieval(model, ds_val, dataclasses.replace(cfg, reid=rc), device)
        out[name] = {"loss": float(loss), "top1": acc, "margin_mean": mmean, "margin_min": mmin,
                     "train_s": time.perf_counter() - t0}
        print(name, out[name], flush=True)
    print(json.dumps(out))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(out, f, indent=1)
    return out


if __name__ == "__main__":
    main()
