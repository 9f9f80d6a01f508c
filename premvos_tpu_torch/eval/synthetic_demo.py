"""Trained-accuracy demonstration: the pipeline learns and tracks (port of
scripts/train_synthetic_demo.py).

The four GroupNorm nets are trained from scratch on one synthetic DAVIS
sequence at `demo_config()` (10 frames of 64×96, two objects), then
`run_sequence` tracks it and the record gives J&F, gated at --threshold
(0.7, as the JAX script; random weights score about 0). Training follows
the JAX script's order and settings: the proposal net 2·base steps at
batch 4, the refinement net base steps at batch 8, the ReID net base/2
steps on the objects' crops (P 2, K 4), FlowNetC base/2 steps on
constant-shift pairs cut from the sequence's own frames, all Adam 3e-4;
base is 400, or 80 with --quick.

It runs on the card (`--device`, CUDA by default: it raises without one)
through the port's trainers and `run_sequence`. --save-params writes an
orbax directory the JAX package's `load_params` restores (a path ending
in `.pt`: a torch.save file); --load-params takes either and skips
training. The record has the JAX record's keys plus the card's name and
power limit and the wall seconds of each net and of the run.

  python -m premvos_tpu_torch.eval.synthetic_demo              # full demo
  python -m premvos_tpu_torch.eval.synthetic_demo --quick      # reduced steps
  python -m premvos_tpu_torch.eval.synthetic_demo --device cpu --load-params DIR --diagnose

The command exits 1 when J&F misses the threshold; `main(argv)` returns
the record.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np
import torch

from premvos_tpu_torch.data.davis import DavisDataset, make_synthetic_davis
from premvos_tpu_torch.data.flow_pairs import FlowPairDataset
from premvos_tpu_torch.data.preprocess import resize_linear
from premvos_tpu_torch.eval.davis_eval import evaluate_sequence
from premvos_tpu_torch.eval.synthetic_benchmark import card_info, demo_config, make_shift_pairs
from premvos_tpu_torch.finetune.finetune import labels_to_boxes_masks
from premvos_tpu_torch.pipeline.runner import (
    build_models,
    float32_precision,
    init_params,
    precompute_sequence,
    resolve_device,
    run_sequence,
)
from premvos_tpu_torch.stages.merge import init_state, merge_frame
from premvos_tpu_torch.train.train_flow import train_flownet_c
from premvos_tpu_torch.train.train_maskrcnn import train_maskrcnn
from premvos_tpu_torch.train.train_refine import train_refine
from premvos_tpu_torch.train.train_reid import train_reid
from premvos_tpu_torch.utils.checkpoint import load_params, save_params

CONFIG_NAME = "demo_config() — depth-26 GroupNorm nets, 64×96 canvas"


class SyntheticObjectCrops:
    """PK sampler of per-object crops from a DAVIS-layout dataset
    (identities = object slots; views = frames), each sequence read at
    64×96. Crops are float32 in [0, 1], resized as OpenCV's INTER_LINEAR
    (`resize_linear`); `pk_batch` draws from the caller's generator in the
    JAX class's order."""

    def __init__(self, ds, crop_size: int, max_objects: int = 8):
        self.crop_size = crop_size
        self.by_id: dict[int, list[np.ndarray]] = {}
        for seq in ds.sequences:
            data = ds.load_sequence(seq, 64, 96, max_objects)
            for t in range(len(data["gt_labels"])):
                lab = np.asarray(data["gt_labels"][t])
                img = np.asarray(data["frames"][t]).astype(np.float32) / 255.0
                boxes, _, valid = labels_to_boxes_masks(lab, max_objects)
                for k in range(max_objects):
                    if not valid[k]:
                        continue
                    x1, y1, x2, y2 = boxes[k].astype(int)
                    crop = img[max(y1, 0) : y2 + 1, max(x1, 0) : x2 + 1]
                    if crop.size == 0:
                        continue
                    crop = resize_linear(crop, (crop_size, crop_size))
                    self.by_id.setdefault(k, []).append(crop)
        self.ids = sorted(self.by_id)

    def pk_batch(self, rng, p: int, k: int):
        """(crops [P·K, S, S, 3] float32, ids [P·K] int32)."""
        p = min(p, len(self.ids))
        chosen = rng.choice(self.ids, size=p, replace=False)
        crops, ids = [], []
        for i, obj in enumerate(chosen):
            views = self.by_id[obj]
            for _ in range(k):
                crops.append(views[rng.integers(0, len(views))])
            ids.extend([i] * k)
        return np.stack(crops).astype(np.float32), np.asarray(ids, np.int32)


def diagnose(cfg, models, data, device=None) -> list[str]:
    """Per-frame stage quality: each object's best valid proposal IoU
    (detection and refinement recall) and the merge's pick, which tells
    "the proposals are bad" from "the merge picked wrong". Prints the JAX
    script's `[diag]` lines and returns them."""
    device = resolve_device(device)
    frames = data["frames"]
    n_obj = int(data["num_objects"])
    pre = precompute_sequence(models, cfg, frames, data["gt_masks"], n_obj, device=device)
    gt_labels = np.asarray(data["gt_labels"])
    lines = []
    with torch.inference_mode(), float32_precision():
        gt_masks = torch.as_tensor(data["gt_masks"], device=device).to(torch.float32)
        state = init_state(gt_masks, pre["gt_emb"], n_obj)
        for t in range(int(pre["scores"].shape[0])):
            pm = pre["prop_masks"][t].float().cpu().numpy()
            va = pre["valid"][t].cpu().numpy()
            state, _, info = merge_frame(
                state, pre["prop_masks"][t], pre["scores"][t], pre["emb"][t],
                pre["valid"][t], pre["flow"][t], cfg.merge,
            )
            assign = info["assign"].cpu().numpy()
            rows = []
            for k in range(n_obj):
                g = (gt_labels[t + 1] == k + 1).astype(np.float32)
                ious = [
                    float(np.minimum(pm[j], g).sum() / max(np.maximum(pm[j], g).sum(), 1e-6))
                    for j in range(pm.shape[0])
                    if va[j]
                ]
                best = int(np.argmax(ious)) if ious else -1
                chose = int(assign[k])
                chose_iou = ious[chose] if 0 <= chose < len(ious) else float("nan")
                rows.append(
                    f"obj{k + 1}: best_prop_iou={max(ious) if ious else 0:.2f}"
                    f"(#{best}) merge_chose=#{chose} iou={chose_iou:.2f}"
                )
            line = f"[diag] t={t + 1} n_valid={int(va.sum())} | " + " | ".join(rows)
            print(line, flush=True)
            lines.append(line)
    return lines


def steps_of(args) -> dict:
    """Each net's training steps: the flags, else the JAX script's
    defaults from base 400 (80 with --quick)."""
    base = 80 if args.quick else 400
    given = {"det": args.steps_det, "refine": args.steps_refine,
             "reid": args.steps_reid, "flow": args.steps_flow}
    default = {"det": 2 * base, "refine": base, "reid": base // 2, "flow": base // 2}
    return {k: default[k] if v is None else v for k, v in given.items()}


def train_demo(args, cfg, ds, root, device, seconds: dict):
    """The four nets from `init_params(seed)`, trained in the JAX script's
    order on the demo sequence (FlowNetC, fresh from the seed, on shift
    pairs written under `root`, then put into the FlowNet2 wrapper).
    Returns the Models in eval mode; `seconds` gets each net's wall s."""
    p = cfg.pipeline
    hw = (p.image_height, p.image_width)
    steps = steps_of(args)
    models = init_params(build_models(cfg, device), cfg, args.seed, device)

    def stage(name, short, what, fn):
        print(f"[demo] training {what} ...", flush=True)
        t0 = time.perf_counter()
        loss = fn(max(steps[name] // 4, 1))
        seconds[name] = time.perf_counter() - t0
        print(f"[demo] {short} loss {loss:.4f}", flush=True)

    stage("det", "proposal", "proposal net", lambda every: train_maskrcnn(
        ds, cfg.proposal, image_hw=hw, max_objects=p.max_objects, steps=steps["det"],
        batch_size=4, learning_rate=3e-4, seed=args.seed, model=models.maskrcnn,
        log_every=every, device=device)[1])
    stage("refine", "refine", "refinement net", lambda every: train_refine(
        ds, cfg.refine, steps=steps["refine"], batch_size=8, learning_rate=3e-4,
        seed=args.seed, model=models.refine, image_hw=hw, log_every=every, device=device)[1])
    stage("reid", "reid", "reid net", lambda every: train_reid(
        SyntheticObjectCrops(ds, cfg.reid.crop_size, p.max_objects), cfg.reid,
        steps=steps["reid"], p=2, k=4, learning_rate=3e-4, seed=args.seed,
        model=models.reid, log_every=every, device=device)[1])

    def flow(every):
        pairs = make_shift_pairs(root, os.path.join(root, "flow_pairs"),
                                 hw=(cfg.flow.infer_height, cfg.flow.infer_width))
        net, loss = train_flownet_c(
            FlowPairDataset(pairs), steps=steps["flow"], batch_size=4,
            crop_hw=(cfg.flow.infer_height, cfg.flow.infer_width),
            max_displacement=cfg.flow.max_displacement, learning_rate=3e-4,
            seed=args.seed, log_every=every, device=device)
        models.flow.flownetc.load_state_dict(net.state_dict())
        return loss

    stage("flow", "flow", "flow net on synthetic shifts", flow)
    for m in models:
        m.eval()
    return models


def run_eval(args, cfg, models, ds, device, seconds: dict, t_run: float) -> dict:
    """Track the demo sequence and score it: the record (written to --out
    when given; seconds["total"] from `t_run` to the score), with the
    --diagnose lines printed before it."""
    p = cfg.pipeline
    print("[demo] running the pipeline ...", flush=True)
    t0 = time.perf_counter()
    data = ds.load_sequence("demo", p.image_height, p.image_width, p.max_objects)
    labels = run_sequence(models, cfg, data["frames"], data["gt_masks"], data["num_objects"],
                          device=device).cpu().numpy()
    result = evaluate_sequence(labels, np.asarray(data["gt_labels"]), data["num_objects"])
    seconds["eval"] = time.perf_counter() - t0
    seconds["total"] = time.perf_counter() - t_run
    report = {
        "J": result["J"], "F": result["F"], "J&F": result["J&F"],
        "threshold": args.threshold,
        "passed": bool(result["J&F"] >= args.threshold),
        "config": CONFIG_NAME,
        "card": card_info(device),
        "seconds": seconds,
    }
    if args.diagnose:
        diagnose(cfg, models, data, device)
    print(json.dumps(report, indent=2), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(report, f, indent=2)
    return report


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true", help="reduced steps")
    ap.add_argument("--steps-det", type=int, default=None)
    ap.add_argument("--steps-refine", type=int, default=None)
    ap.add_argument("--steps-reid", type=int, default=None)
    ap.add_argument("--steps-flow", type=int, default=None)
    ap.add_argument("--threshold", type=float, default=0.7)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="docs/SYNTHETIC_ACCURACY_TORCH.json")
    ap.add_argument("--device", default=None,
                    help="default: cuda (raises without a card); cpu runs the plain versions")
    ap.add_argument("--save-params", default=None,
                    help="save the trained nets: an orbax directory the JAX package restores "
                         "(a path ending in .pt: a torch.save file)")
    ap.add_argument("--load-params", default=None,
                    help="load the nets (orbax directory or .pt) and skip training")
    ap.add_argument("--diagnose", action="store_true",
                    help="print per-frame proposal/assignment quality")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    device = resolve_device(args.device)
    t_run = time.perf_counter()
    cfg = demo_config()
    p = cfg.pipeline
    seconds = {}
    with tempfile.TemporaryDirectory(prefix="synthetic_demo_") as root:
        make_synthetic_davis(root, sequences=("demo",), t=10,
                             hw=(p.image_height, p.image_width), num_objects=2)
        ds = DavisDataset(root)
        if args.load_params:
            models = load_params(args.load_params, build_models(cfg, device))
        else:
            models = train_demo(args, cfg, ds, root, device, seconds)
            if args.save_params:
                save_params(args.save_params, models)
                print(f"[demo] params saved to {args.save_params}", flush=True)
        return run_eval(args, cfg, models, ds, device, seconds, t_run)


if __name__ == "__main__":
    sys.exit(0 if main()["passed"] else 1)
