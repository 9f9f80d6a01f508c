"""Held-out synthetic tracking benchmark (port of
scripts/run_synthetic_benchmark.py, with `demo_config` and
`make_shift_pairs` of scripts/train_synthetic_demo.py).

The protocol:
  1. generate train (every entity annotated) / tune / val (tracked only)
     splits (data/synthetic_vos.py);
  2. train all four nets from scratch on the train split (GroupNorm nets;
     the flow net on the generator's ground-truth backward-flow pairs);
  3. tune the merge weights on the tune splits (eval/tune.py);
  4. precompute stages 1-4 once per val sequence and score J&F with the
     tuned weights (the held-out number; gate: every draw ≥ --threshold),
     with the default weights, and with the per-object best-IoU proposal
     (the oracle, the proposal-quality ceiling);
  5. ablate each merge term of the tuned vector, and score a stride-2
     warp, bf16 crop/paste interpolation and flow at half resolution;
  6. with --finetune, fine-tune the proposal and refinement nets on each
     val sequence's frame 0 and score the pair.

It runs on the card (`--device`, CUDA by default: it raises without one)
through the port's trainers, `precompute_sequence` and the replay harness.
The JSON record has the JAX record's keys plus the card's name and power
limit and each stage's wall seconds. Its data are the JAX generator's
files (data/synthetic_vos.py writes the same JPEG frames byte for byte).
Its `gather_warp` row is the JAX script's: the val draw precomputed again
with the exact warp in FlowNet2 and in the merge, scored with the tuned
weights.

  python -m premvos_tpu_torch.eval.synthetic_benchmark                # full
  python -m premvos_tpu_torch.eval.synthetic_benchmark --quick        # reduced
  python -m premvos_tpu_torch.eval.synthetic_benchmark --canvas 128 192 --depth 26 \\
      --tune-seeds 0 1 2 --val-seeds 0 1 2                              # the record's
The command exits 1 when a draw misses the threshold; `main(argv)`
returns the record.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from premvos_tpu_torch.config import (
    FinetuneConfig,
    FlowConfig,
    MergeConfig,
    PipelineConfig,
    PremvosConfig,
    ProposalConfig,
    RefineConfig,
    ReIDConfig,
)
from premvos_tpu_torch.data.crops import DavisObjectCrops
from premvos_tpu_torch.data.davis import DavisDataset
from premvos_tpu_torch.data.flow_pairs import FlowPairDataset
from premvos_tpu_torch.data.synthetic_vos import make_synthetic_vos
from premvos_tpu_torch.eval.davis_eval import evaluate_dataset, evaluate_sequence
from premvos_tpu_torch.eval.harness import (
    DEFAULT_WEIGHTS,
    WEIGHT_NAMES,
    evaluate_weights,
    precompute_split,
)
from premvos_tpu_torch.eval.tune import ablation_weights, tune_weights
from premvos_tpu_torch.io_compat.flo import write_flo
from premvos_tpu_torch.io_compat.ppm import write_ppm
from premvos_tpu_torch.pipeline.runner import (
    build_models,
    init_params,
    resolve_device,
    with_flow_warp,
)
from premvos_tpu_torch.train.train_flow import train_flownet_c
from premvos_tpu_torch.train.train_maskrcnn import train_maskrcnn
from premvos_tpu_torch.train.train_refine import train_refine
from premvos_tpu_torch.train.train_reid import train_reid
from premvos_tpu_torch.utils.checkpoint import load_params, save_params


def demo_config() -> PremvosConfig:
    """Depth-26 GroupNorm nets on a 64×96 canvas, exact (stride-1) warp."""
    return PremvosConfig(
        proposal=ProposalConfig(
            backbone_depth=26,
            fpn_channels=32,
            anchor_scales=(8.0, 16.0, 32.0, 64.0, 128.0),
            # generous RPN budgets: at 16 post-NMS slots one miscalibrated
            # FPN level can flood joint NMS and starve true positives
            rpn_pre_nms_topk=128,
            rpn_post_nms_topk=64,
            detections_per_frame=8,
            norm="group_norm",
        ),
        refine=RefineConfig(
            crop_size=65, backbone_depth=26, box_margin=12.0, norm="group_norm",
        ),
        flow=FlowConfig(
            variant="flownetc", max_displacement=4, infer_height=64, infer_width=128,
        ),
        reid=ReIDConfig(
            backbone_depth=26, embedding_dim=32, crop_size=32, norm="group_norm",
        ),
        # 10-px objects: a coarse (stride-2) warp degrades the warp prior
        merge=MergeConfig(warp_stride=1),
        pipeline=PipelineConfig(
            image_height=64, image_width=96, max_objects=2, max_proposals=8,
            dtype="float32", scan_chunk=4,
        ),
    )


def make_shift_pairs(root, out_dir, n_pairs: int = 64, hw=(64, 128)):
    """Constant-shift flow pairs (FlyingChairs layout) from a DAVIS-layout
    tree's own frames: each pair is a frame and the frame rolled by
    (dx, dy) ∈ [−3, 3]², with that flow."""
    os.makedirs(out_dir, exist_ok=True)
    rng = np.random.default_rng(3)
    ds = DavisDataset(root)
    frames = []
    for seq in ds.sequences:
        data = ds.load_sequence(seq, hw[0], hw[1], 2)
        frames.extend(np.asarray(data["frames"]))
    h, w = hw
    for i in range(n_pairs):
        img = frames[rng.integers(0, len(frames))]
        dx, dy = int(rng.integers(-3, 4)), int(rng.integers(-3, 4))
        img2 = np.roll(np.roll(img, dy, axis=0), dx, axis=1)
        flow = np.zeros((h, w, 2), np.float32)
        flow[..., 0] = dx
        flow[..., 1] = dy
        write_ppm(f"{out_dir}/{i:05d}_img1.ppm", img)
        write_ppm(f"{out_dir}/{i:05d}_img2.ppm", img2)
        write_flo(f"{out_dir}/{i:05d}_flow.flo", flow)
    return out_dir


def bench_config(score_threshold=0.01, max_proposals=16, canvas=None, depth=None):
    """demo_config() nets on the benchmark canvas, exact warp.

    score_threshold / max_proposals: the detector's inference-side recall
    knobs (a low threshold and many proposals, as the reference runs its
    proposal net). canvas (H, W): the same world rendered at that size
    (32-multiples at 64:96). depth: the proposal and refine backbones'
    depth (the FPN then gets at least 64 channels).
    """
    cfg = demo_config()
    if depth is not None:
        cfg = dataclasses.replace(
            cfg,
            proposal=dataclasses.replace(
                cfg.proposal, backbone_depth=depth,
                fpn_channels=max(cfg.proposal.fpn_channels, 64),
            ),
            refine=dataclasses.replace(cfg.refine, backbone_depth=depth),
        )
    if canvas is not None:
        ch, cw = canvas
        if ch % 32 or cw % 32 or abs(ch / 64 - cw / 96) > 1e-6:
            raise ValueError(
                f"--canvas {ch}x{cw}: needs 32-multiples at 64:96 aspect (e.g. 128 192)"
            )
        cfg = dataclasses.replace(
            cfg,
            pipeline=dataclasses.replace(cfg.pipeline, image_height=ch, image_width=cw),
            flow=dataclasses.replace(cfg.flow, infer_height=ch, infer_width=cw),
        )
    if score_threshold is not None:
        cfg = dataclasses.replace(
            cfg,
            proposal=dataclasses.replace(cfg.proposal, detection_score_threshold=score_threshold),
        )
    if max_proposals is not None:
        cfg = dataclasses.replace(
            cfg,
            proposal=dataclasses.replace(cfg.proposal, detections_per_frame=max_proposals),
            pipeline=dataclasses.replace(cfg.pipeline, max_proposals=max_proposals),
        )
    return cfg


ABLATIONS = (
    ("tuned", {}),
    ("no_reid", {"w_reid": 0.0}),
    ("no_warp", {"w_warp": 0.0}),
    ("no_overlap", {"w_overlap": 0.0}),
    ("no_objectness", {"w_objectness": 0.0}),
    ("no_floor", {"new_object_score_floor": 0.0}),  # the anti-identity-swap floor
    ("no_reacquire", {"reid_reacquire": 2.0}),  # ReID-gated floor relief off
)


def oracle_jf(precomputed, min_iou: float = 0.1) -> float:
    """Proposal-quality ceiling: per object and frame, the valid proposal
    with the best IoU against the ground truth (higher IoU wins a pixel
    both claim). The tuned-vs-oracle gap is the merge's selection loss."""
    results = []
    for pre, _gt_masks, n_obj, gt_labels in precomputed:
        t_steps = int(pre["scores"].shape[0])
        k = int(n_obj)
        h, w = gt_labels.shape[1], gt_labels.shape[2]
        labels = np.zeros((t_steps + 1, h, w), np.int32)
        labels[0] = gt_labels[0]
        for t in range(t_steps):
            pm = pre["prop_masks"][t].float().cpu().numpy()[:, :h, :w]
            va = pre["valid"][t].cpu().numpy()
            sel = np.zeros((k, h, w), np.float32)
            sc = np.zeros(k)
            for ki in range(k):
                g = (gt_labels[t + 1] == ki + 1).astype(np.float32)
                if g.sum() == 0:
                    continue
                inter = np.minimum(pm, g[None]).sum((1, 2))
                union = np.maximum(pm, g[None]).sum((1, 2))
                ious = np.where(va, inter / np.maximum(union, 1e-6), 0.0)
                b = int(np.argmax(ious))
                if ious[b] > min_iou:
                    sel[ki] = pm[b]
                    sc[ki] = ious[b]
            lab = np.zeros((h, w), np.int32)
            for ki in np.argsort(sc):  # higher IoU wins pixel conflicts
                if sc[ki] > 0:
                    lab[sel[ki] > 0.5] = ki + 1
            labels[t + 1] = lab
        results.append(evaluate_sequence(labels, gt_labels, k))
    return float(evaluate_dataset(results)["J&F"])


def train_all(args, cfg, ds_train, root, device, seconds=None):
    """The four nets from `init_params(seed)`, trained in turn on the train
    split (and the flow net, fresh from the seed, on root/flow_pairs).
    With --save-params a checkpoint is written after each net and a rerun
    skips the nets already trained. Returns the Models, in eval mode;
    `seconds` gets each net's wall seconds."""
    p = cfg.pipeline
    seconds = {} if seconds is None else seconds
    models = init_params(build_models(cfg, device), cfg, args.seed, device)
    done_file, done = None, set()
    if args.save_params:
        done_file = args.save_params + ".stages_done"
        if os.path.exists(done_file):
            done = {s for s in Path(done_file).read_text().split() if s}
            if done:
                load_params(args.save_params, models)
                print(f"[bench] resuming; trained stages: {sorted(done)}", flush=True)

    def mark(stage):
        if args.save_params:
            save_params(args.save_params, models)
            done.add(stage)
            Path(done_file).write_text("\n".join(sorted(done)))

    # The train split annotates distractors too: detection, refinement and
    # ReID learn every object-like entity.
    train_max_objects = args.n_tracked + args.n_distractors + 1

    def stage(name, fn):
        if name in done:
            return
        print(f"[bench] training {name} ...", flush=True)
        t0 = time.perf_counter()
        loss = fn()
        seconds[name] = time.perf_counter() - t0
        print(f"[bench] {name} loss {loss:.4f} ({seconds[name]:.0f}s)", flush=True)
        mark(name)

    stage("det", lambda: train_maskrcnn(
        ds_train, cfg.proposal, image_hw=(p.image_height, p.image_width),
        max_objects=train_max_objects, steps=args.steps_det, batch_size=4,
        learning_rate=3e-4, seed=args.seed, model=models.maskrcnn,
        log_every=max(args.steps_det // 5, 1), device=device)[1])
    stage("refine", lambda: train_refine(
        ds_train, cfg.refine, steps=args.steps_refine, batch_size=8, learning_rate=3e-4,
        seed=args.seed, model=models.refine, image_hw=(p.image_height, p.image_width),
        log_every=max(args.steps_refine // 5, 1), device=device)[1])

    def reid():
        crops = DavisObjectCrops(ds_train, cfg.reid.crop_size, (p.image_height, p.image_width),
                                 max_objects=train_max_objects)
        print(f"[bench] reid identities: {len(crops.ids)}", flush=True)
        return train_reid(crops, cfg.reid, steps=args.steps_reid, p=4, k=4,
                          learning_rate=3e-4, seed=args.seed, model=models.reid,
                          log_every=max(args.steps_reid // 5, 1), device=device)[1]

    stage("reid", reid)

    def flow():
        net, loss = train_flownet_c(
            FlowPairDataset(os.path.join(root, "flow_pairs")), steps=args.steps_flow,
            batch_size=4, crop_hw=(cfg.flow.infer_height, cfg.flow.infer_width),
            max_displacement=cfg.flow.max_displacement, learning_rate=3e-4,
            seed=args.seed, log_every=max(args.steps_flow // 5, 1), device=device)
        models.flow.flownetc.load_state_dict(net.state_dict())
        return loss

    stage("flow", flow)
    for m in models:
        m.eval()
    return models


def finetune_pair(args, cfg, models, ds_val, precomputed_plain, device, weights=None,
                  ds_select=None):
    """Per-video fine-tune on each val sequence's frame 0 → the J&F with
    and without it, over --finetune-steps (the steps-vs-J&F curve, the step
    count chosen on `ds_select`, the tune split, when several are given),
    and for the fused method one val row at proposal_scale 1."""
    from premvos_tpu_torch.finetune.fused import build_fused_runner, finetune_video

    weights = DEFAULT_WEIGHTS if weights is None else weights
    p = cfg.pipeline
    without_ft, _ = evaluate_weights(precomputed_plain, weights, args.warp_stride)
    built = None
    if args.ft_method == "fused":
        built = build_fused_runner(models, cfg, FinetuneConfig(
            steps=max(args.finetune_steps), learning_rate=1e-4, batch_size=8, method="fused"),
            device=device)

    def finetune_one(ds, seq, ft_cfg, built):
        data = ds.load_sequence(seq, p.image_height, p.image_width, p.max_objects)
        t0 = time.perf_counter()
        tuned, losses = finetune_video(models, data["frames"][0], data["gt_labels"][0], cfg,
                                       ft_cfg, seed=args.seed, built=built, device=device)
        dt = time.perf_counter() - t0
        print(f"[finetune/{ft_cfg.steps}] {seq}: refine {losses['refine']:.4f} "
              f"prop {losses['proposal']:.4f} ({dt:.0f}s)", flush=True)
        pre = precompute_split(tuned, cfg, ds, [seq], verbose=False, device=device)
        _, res = evaluate_weights(pre, weights, args.warp_stride)
        return res, dt

    def curve_for(ds, label):
        curve = []
        for steps in args.finetune_steps:
            ft_cfg = FinetuneConfig(num_augmentations=max(steps, 64), steps=steps,
                                    learning_rate=1e-4, batch_size=8, method=args.ft_method)
            results, total_t = [], 0.0
            for seq in ds.sequences:
                res, dt = finetune_one(ds, seq, ft_cfg, built)
                results.extend(res)
                total_t += dt
            with_ft = evaluate_dataset(results)["J&F"]
            curve.append({"steps": steps, "J&F": round(float(with_ft), 4),
                          "seconds_per_video": round(total_t / len(ds.sequences), 1)})
            print(f"[finetune/{label}] steps={steps}: J&F {with_ft:.4f} "
                  f"(no-finetune {without_ft:.4f})", flush=True)
        return curve

    report = {"without_finetune_JF": round(float(without_ft), 4), "method": args.ft_method,
              "proposal_scale": cfg.finetune.proposal_scale}
    curve = curve_for(ds_val, "val")
    report["curve"] = curve
    if len(args.finetune_steps) > 1 and ds_select is not None:
        report["select_curve"] = curve_for(ds_select, "tune")
        sel = max(report["select_curve"], key=lambda r: r["J&F"])["steps"]
        report["selected_on"] = "tune"
    else:
        sel = args.finetune_steps[0]
        report["selected_on"] = "preregistered"
    report["with_finetune_JF"] = next(r for r in curve if r["steps"] == sel)["J&F"]
    report["finetune_steps"] = sel
    if args.ft_method == "fused" and cfg.finetune.proposal_scale != 1.0:
        ft_native = FinetuneConfig(steps=sel, learning_rate=1e-4, batch_size=8,
                                   method="fused", proposal_scale=1.0)
        native = build_fused_runner(models, cfg, ft_native, device=device)
        results = []
        for seq in ds_val.sequences:
            results.extend(finetune_one(ds_val, seq, ft_native, native)[0])
        report["proposal_scale_1_JF"] = round(float(evaluate_dataset(results)["J&F"]), 4)
        print(f"[finetune] proposal_scale=1.0 @ steps={sel}: "
              f"J&F {report['proposal_scale_1_JF']:.4f}", flush=True)
    return report


def card_info(device) -> dict:
    """The card's name and power limit (nvidia-smi), or the CPU."""
    if device.type != "cuda":
        return {"name": "cpu", "power_limit": None}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    return {"name": torch.cuda.get_device_name(device), "nvidia_smi": smi.splitlines()[0]}


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true", help="reduced steps + fewer sequences")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--n-train", type=int, default=None)
    ap.add_argument("--n-val", type=int, default=None)
    ap.add_argument("--n-tracked", type=int, default=2)
    ap.add_argument("--n-distractors", type=int, default=1)
    ap.add_argument("--frames", type=int, default=24)
    ap.add_argument("--steps-det", type=int, default=None)
    ap.add_argument("--steps-refine", type=int, default=None)
    ap.add_argument("--steps-reid", type=int, default=None)
    ap.add_argument("--steps-flow", type=int, default=None)
    ap.add_argument("--steps-finetune", type=int, default=150,
                    help="deprecated alias for --finetune-steps N")
    ap.add_argument("--finetune-steps", type=int, nargs="+", default=None,
                    help="step counts for the steps-vs-J&F curve")
    ap.add_argument("--ft-method", default="fused", choices=["fused", "pool"],
                    help="on-device fine-tune (the default) or the host-pool oracle")
    ap.add_argument("--threshold", type=float, default=0.6)
    ap.add_argument("--warp-stride", type=int, default=1)
    ap.add_argument("--tune-objective", default="min", choices=["min", "mean"],
                    help="multi-seed trial score: the smallest per-seed tune J&F "
                         "(the every-draw gate) or the pooled mean")
    ap.add_argument("--tune-trials", type=int, default=192,
                    help="random-search trials on the tune split")
    ap.add_argument("--tune-local", type=int, default=96,
                    help="local-refinement trials around the best")
    ap.add_argument("--n-tune", type=int, default=None)
    ap.add_argument("--tune-seeds", type=int, nargs="+", default=None,
                    help="generator seeds whose tune splits the search pools "
                         "(default: just --seed)")
    ap.add_argument("--val-seeds", type=int, nargs="+", default=None,
                    help="generator seeds scored as independent held-out draws "
                         "(default: just --seed); the gate needs every draw")
    ap.add_argument("--tuned-out", default="configs/merge_tuned_torch.json",
                    help="where to write the tuned weights + trial log")
    ap.add_argument("--finetune", action="store_true",
                    help="also measure the per-video fine-tune J&F pair")
    ap.add_argument("--no-ablation", action="store_true")
    ap.add_argument("--out", default="docs/SYNTHETIC_BENCHMARK_TORCH.json")
    ap.add_argument("--device", default=None,
                    help="default: cuda (raises without a card); cpu runs the plain versions")
    ap.add_argument("--save-params", default=None)
    ap.add_argument("--load-params", default=None)
    ap.add_argument("--data-root", default=None,
                    help="reuse a generated dataset dir (else a fresh temporary one)")
    ap.add_argument("--score-threshold", type=float, default=None,
                    help="override detection_score_threshold (default 0.01)")
    ap.add_argument("--max-proposals", type=int, default=None,
                    help="override detections_per_frame / max_proposals (default 16)")
    ap.add_argument("--canvas", type=int, nargs=2, default=None, metavar=("H", "W"),
                    help="render the same world at H x W (32-multiples, 64:96, e.g. 128 192)")
    ap.add_argument("--depth", type=int, default=None,
                    help="proposal/refine backbone depth (e.g. 50)")
    args = ap.parse_args(argv)
    if args.finetune_steps is None:
        args.finetune_steps = [args.steps_finetune]
    base = 150 if args.quick else 600
    args.steps_det = 2 * base if args.steps_det is None else args.steps_det
    args.steps_refine = base if args.steps_refine is None else args.steps_refine
    # ReID needs the long schedule to separate look-alike distractors
    args.steps_reid = 4 * base if args.steps_reid is None else args.steps_reid
    args.steps_flow = base // 2 if args.steps_flow is None else args.steps_flow
    args.n_train = args.n_train or (3 if args.quick else 16)
    args.n_val = args.n_val or (2 if args.quick else 4)
    args.n_tune = args.n_tune or (2 if args.quick else 6)
    return args


def _round(x) -> float:
    return round(float(x), 4)


def main(argv=None) -> dict:
    args = parse_args(argv)
    device = resolve_device(args.device)
    t_run = time.perf_counter()
    seconds = {}
    # None → the recall recipe 0.01 / 16 of bench_config, not demo_config's 0.05 / 8
    cfg = bench_config(
        0.01 if args.score_threshold is None else args.score_threshold,
        16 if args.max_proposals is None else args.max_proposals,
        tuple(args.canvas) if args.canvas else None,
        depth=args.depth,
    )
    p = cfg.pipeline
    gen_kw = dict(n_tune=args.n_tune, n_val=args.n_val, t=args.frames,
                  hw=(p.image_height, p.image_width), n_tracked=args.n_tracked,
                  n_distractors=args.n_distractors, size_scale=p.image_height / 64.0)
    t0 = time.perf_counter()
    root = args.data_root or tempfile.mkdtemp(prefix="synthetic_vos_")
    if not os.path.exists(os.path.join(root, "ImageSets")):
        print(f"[bench] generating dataset at {root}", flush=True)
        make_synthetic_vos(root, n_train=args.n_train, seed=args.seed,
                           pairs_hw=(cfg.flow.infer_height, cfg.flow.infer_width), **gen_kw)
    ds_train = DavisDataset(root, split="train")
    tune_seeds = args.tune_seeds or [args.seed]
    val_seeds = args.val_seeds or [args.seed]

    def world_root(s):
        if s == args.seed:
            return root
        r = f"{root.rstrip('/')}_s{s}"
        if not os.path.exists(os.path.join(r, "ImageSets")):
            print(f"[bench] generating seed-{s} world at {r}", flush=True)
            make_synthetic_vos(r, n_train=0, seed=s, flow_pairs=False, **gen_kw)
        return r

    tune_sets = [DavisDataset(world_root(s), split="tune") for s in tune_seeds]
    val_sets = {s: DavisDataset(world_root(s), split="val") for s in val_seeds}
    ds_val = val_sets[val_seeds[0]]
    seconds["generate"] = time.perf_counter() - t0

    if args.load_params:
        models = load_params(args.load_params,
                             init_params(build_models(cfg, device), cfg, args.seed, device))
    else:
        train_s = {}
        models = train_all(args, cfg, ds_train, root, device, train_s)
        seconds["train"] = train_s
        if args.save_params:
            save_params(args.save_params, models)
            print(f"[bench] params saved to {args.save_params}", flush=True)

    print(f"[bench] precomputing tune sequences (seeds {tune_seeds}) ...", flush=True)
    t0 = time.perf_counter()
    pre_tune_groups = [precompute_split(models, cfg, ds_t, device=device) for ds_t in tune_sets]
    seconds["precompute_tune"] = time.perf_counter() - t0
    pre_tune = [p_ for g in pre_tune_groups for p_ in g]
    t0 = time.perf_counter()
    tuned_w, tune_jf, trial_log = tune_weights(pre_tune, args, groups=pre_tune_groups)
    seconds["search"] = time.perf_counter() - t0
    seconds["search_trials"] = len(trial_log)
    if args.tuned_out:
        os.makedirs(os.path.dirname(args.tuned_out) or ".", exist_ok=True)
        with open(args.tuned_out, "w") as f:
            json.dump({
                "weights": dict(zip(WEIGHT_NAMES, [float(x) for x in tuned_w])),
                "tune_JF": round(tune_jf, 4),
                "baseline_tune_JF": trial_log[0]["tune_JF"],
                "protocol": "random+local search on the tune splits of generator seeds "
                            f"{tune_seeds} (disjoint from train and every val draw); "
                            f"objective={args.tune_objective} per-seed tune J&F",
                "tune_seeds": tune_seeds,
                "trials": trial_log,
            }, f, indent=2)
        print(f"[tune] best J&F = {tune_jf:.4f} → {args.tuned_out}", flush=True)

    draws, precomputed = {}, None
    t0 = time.perf_counter()
    for vs in val_seeds:
        print(f"[bench] precomputing val sequences (seed {vs}) ...", flush=True)
        pre_v = precompute_split(models, cfg, val_sets[vs], device=device)
        if vs == val_seeds[0]:
            precomputed = pre_v
        jf_v, per_seq_v = evaluate_weights(pre_v, tuned_w, args.warp_stride)
        default_v, _ = evaluate_weights(pre_v, DEFAULT_WEIGHTS, args.warp_stride)
        oracle_v = oracle_jf(pre_v)
        abl_v = {}
        if not args.no_ablation:
            for name, over in ABLATIONS[1:]:  # term ablations on every draw
                score, _ = evaluate_weights(pre_v, ablation_weights(tuned_w, over),
                                            args.warp_stride)
                abl_v[name] = _round(score)
        draws[str(vs)] = {
            "J&F": _round(jf_v),
            "J": _round(np.mean([r["J"] for r in per_seq_v])),
            "F": _round(np.mean([r["F"] for r in per_seq_v])),
            "default_weights_JF": _round(default_v),
            "oracle_selection_JF": _round(oracle_v),
            "per_sequence": {s: _round(r["J&F"])
                             for s, r in zip(val_sets[vs].sequences, per_seq_v)},
            "ablation": abl_v,
        }
        print(f"[bench] draw {vs}: HELD-OUT J&F = {jf_v:.4f} (defaults {default_v:.4f}, "
              f"oracle {oracle_v:.4f}, ablations {abl_v})", flush=True)
    seconds["val"] = time.perf_counter() - t0

    jf_all = [d["J&F"] for d in draws.values()]
    held_out = {
        "J&F": _round(np.mean(jf_all)),
        "J&F_min_draw": _round(np.min(jf_all)),
        "default_weights_JF": _round(np.mean([d["default_weights_JF"] for d in draws.values()])),
        "oracle_selection_JF": _round(np.mean([d["oracle_selection_JF"]
                                               for d in draws.values()])),
        "draws": draws,
        "tune_seeds": tune_seeds,
        "val_seeds": val_seeds,
    }
    print(f"[bench] HELD-OUT J&F = {held_out['J&F']:.4f} mean / "
          f"{held_out['J&F_min_draw']:.4f} min over {len(val_seeds)} draws "
          f"(gate {args.threshold})", flush=True)

    ablation = []
    if not args.no_ablation:
        t0 = time.perf_counter()
        for name, over in ABLATIONS:
            if name == "tuned":
                scores = jf_all
            else:
                scores = [draws[str(vs)]["ablation"][name] for vs in val_seeds]
            ablation.append({"name": name, "J&F": _round(np.mean(scores)),
                             "per_draw": [_round(s) for s in scores],
                             **{k: float(v) for k, v in over.items()}})
            print(f"[ablation] {name:>14}: J&F = {ablation[-1]['J&F']:.4f} "
                  f"per-draw {ablation[-1]['per_draw']}", flush=True)
        ws2, _ = evaluate_weights(precomputed, tuned_w, warp_stride=2)
        ablation.append({"name": "warp_stride2", "J&F": _round(ws2)})
        # The block warp against the exact ("gather") warp, in FlowNet2 and
        # the merge: a gather config, a fresh precompute, the tuned weights.
        gather_cfg = dataclasses.replace(
            cfg, flow=dataclasses.replace(cfg.flow, warp_impl="gather"),
            merge=dataclasses.replace(cfg.merge, warp_impl="gather"))
        pre_g = precompute_split(with_flow_warp(models, "gather"), gather_cfg, ds_val,
                                 verbose=False, device=device)
        gw, _ = evaluate_weights(pre_g, tuned_w, args.warp_stride, warp_impl="gather")
        ablation.append({"name": "gather_warp", "J&F": _round(gw)})
        print(f"[ablation]    gather_warp: J&F = {gw:.4f}", flush=True)
        # bf16 crop/paste interpolation against the float32 default, and
        # flow at half inference resolution (rounded up to 64-multiples)
        bf_cfg = dataclasses.replace(
            cfg, refine=dataclasses.replace(cfg.refine, interp_precision="default"))
        fh = max(64, (cfg.flow.infer_height // 2 + 63) // 64 * 64)
        fw = max(64, (cfg.flow.infer_width // 2 + 63) // 64 * 64)
        half_cfg = dataclasses.replace(
            cfg, flow=dataclasses.replace(cfg.flow, infer_height=fh, infer_width=fw))
        for name, c in (("interp_bf16", bf_cfg), (f"flow_half_res_{fh}x{fw}", half_cfg)):
            pre = precompute_split(models, c, ds_val, verbose=False, device=device)
            score, _ = evaluate_weights(pre, tuned_w, args.warp_stride)
            ablation.append({"name": name, "J&F": _round(score)})
            print(f"[ablation] {name:>14}: J&F = {score:.4f}", flush=True)
        seconds["ablation_extra"] = time.perf_counter() - t0

    report = {
        "held_out": held_out,
        "ablation": ablation,
        "tuned_weights": dict(zip(WEIGHT_NAMES, [float(x) for x in tuned_w])),
        "dataset": {
            "n_train": args.n_train, "n_val": args.n_val, "frames": args.frames,
            "canvas": [p.image_height, p.image_width],
            "n_tracked": args.n_tracked, "n_distractors": args.n_distractors,
            "seed": args.seed,
            "difficulty": "crossing+occlusion, full disappearance/re-appearance, "
                          "look-alike distractors, scale change",
            "frames_format": "jpeg at quality 96, the JAX generator's files",
        },
        "steps": ({"loaded_from": args.load_params} if args.load_params else {
            "det": args.steps_det, "refine": args.steps_refine,
            "reid": args.steps_reid, "flow": args.steps_flow,
        }),
        "warp_stride": args.warp_stride,
        "detector": {
            "score_threshold": cfg.proposal.detection_score_threshold,
            "max_proposals": p.max_proposals,
        },
        "threshold": args.threshold,
        # the gate needs every independent draw to clear the threshold
        "passed": bool(held_out["J&F_min_draw"] >= args.threshold),
        "platform": "gpu" if device.type == "cuda" else device.type,
        "card": card_info(device),
        "config": (f"bench_config(depth={cfg.proposal.backbone_depth}) — "
                   f"depth-{cfg.proposal.backbone_depth} GroupNorm nets, "
                   f"{p.image_height}×{p.image_width} canvas"),
        "seconds": seconds,
    }

    def write():
        if args.out:
            os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
            with open(args.out, "w") as f:
                json.dump(report, f, indent=2)

    # the gate's record first: a fine-tune phase that fails keeps it
    seconds["total"] = time.perf_counter() - t_run
    write()
    if args.finetune:
        t0 = time.perf_counter()
        report["finetune"] = finetune_pair(args, cfg, models, ds_val, precomputed, device,
                                           weights=tuned_w, ds_select=tune_sets[0])
        seconds["finetune"] = time.perf_counter() - t0
        seconds["total"] = time.perf_counter() - t_run
        print(f"[bench] finetune pair: {report['finetune']}", flush=True)
    print(json.dumps(report, indent=2), flush=True)
    write()
    return report


if __name__ == "__main__":
    sys.exit(0 if main()["passed"] else 1)
