"""Merge-weight search on a tune split (port of scripts/tune_merge.py, and
of `tune_weights` / `ablation_weights` in scripts/run_synthetic_benchmark.py).

Stages 1-4 are precomputed once per sequence (eval/harness.py); every
candidate weight vector replays only the merge. The searches draw from a
seeded `np.random.Generator` in the JAX scripts' order, so the same
precompute gives the same trials and the same chosen vector.

The command line (`main`) is the random search of scripts/tune_merge.py
over (w_objectness, w_reid, w_warp, w_overlap, reid_sigma,
new_object_score_floor, warp_decay, reid_ema, reid_reacquire) against
J&F, on the card (`--device`, CUDA by default: it raises without one):

  python -m premvos_tpu_torch.eval.tune --synthetic --trials 64        # self-contained
  python -m premvos_tpu_torch.eval.tune --demo --checkpoint DIR       # the demo's nets
  python -m premvos_tpu_torch.eval.tune --benchmark --checkpoint DIR  # + held-out val J&F
  python -m premvos_tpu_torch.eval.tune --data /path/DAVIS --trials 256 --checkpoint CKPT

--checkpoint takes an orbax directory (either package's) or a `.pt` file
of utils/checkpoint.py; without one the nets are drawn from seed 0. The
tuned weights go to --out (configs/merge_tuned_torch.json, the synthetic
protocol's --tuned-out) in the JAX file's structure.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile

import numpy as np

from premvos_tpu_torch.config import (
    FlowConfig,
    PipelineConfig,
    PremvosConfig,
    ProposalConfig,
    RefineConfig,
    ReIDConfig,
    load_config,
)
from premvos_tpu_torch.data.davis import DavisDataset, make_synthetic_davis
from premvos_tpu_torch.data.synthetic_vos import make_synthetic_vos
from premvos_tpu_torch.eval.harness import (
    DEFAULT_WEIGHTS,
    WEIGHT_NAMES,
    evaluate_weights,
    precompute_split,
)
from premvos_tpu_torch.pipeline.runner import build_models, init_params, resolve_device
from premvos_tpu_torch.utils.checkpoint import load_params


def sample_weights(rng: np.random.Generator) -> np.ndarray:
    """Log-uniform weights, a uniform score floor; warp_decay, reid_ema and
    reid_reacquire mix the reference value (1.0 / 0.0 / disabled, half the
    mass) with a search range. Returns a [9] float32 vector."""
    w = np.exp(rng.uniform(np.log(0.2), np.log(3.0), size=4))
    sigma = np.exp(rng.uniform(np.log(0.3), np.log(3.0)))
    floor = rng.uniform(0.0, 1.5)
    decay = 1.0 if rng.random() < 0.5 else rng.uniform(0.4, 1.0)
    ema = 0.0 if rng.random() < 0.5 else rng.uniform(0.0, 0.5)
    # ReID-gated floor relief (similarity in (0, 1]; 2.0 = disabled)
    reacq = 2.0 if rng.random() < 0.5 else rng.uniform(0.4, 0.98)
    return np.array([*w, sigma, floor, decay, ema, reacq], np.float32)


def ablation_weights(base: np.ndarray, overrides: dict) -> np.ndarray:
    """`base` with the named entries replaced."""
    w = np.asarray(base, np.float32).copy()
    for k, v in overrides.items():
        w[WEIGHT_NAMES.index(k)] = v
    return w


def _entry(w, t, kind):
    return {"w": [float(x) for x in w], "tune_JF": round(float(t), 4), "kind": kind}


def tune_weights(pre_tune, args, rng=None, groups=None):
    """Random search, local refinement and term dropout on the tune split.

    args: `seed`, `tune_objective` ("min" or "mean"), `warp_stride`,
    `tune_trials`, `tune_local` (the benchmark's flags). With `groups` (one
    precompute list per generator seed) and objective "min", a trial scores
    the smallest per-seed J&F, the proxy for a gate every held-out draw
    must pass. Returns (best weights, best tune J&F, trial log).
    """
    rng = rng or np.random.default_rng(args.seed)

    if groups and len(groups) > 1 and args.tune_objective == "min":
        def score(w):
            return min(float(evaluate_weights(g, w, args.warp_stride)[0]) for g in groups)
    else:
        def score(w):
            return float(evaluate_weights(pre_tune, w, args.warp_stride)[0])

    best_w = np.asarray(DEFAULT_WEIGHTS, np.float32)
    best_t = score(best_w)
    log = [_entry(best_w, best_t, "baseline")]
    print(f"[tune] baseline (reference defaults) J&F = {best_t:.4f}", flush=True)
    # Structured seeds around the anti-identity-swap score floor, so the
    # search visits that region even at small trial budgets.
    seeds = [
        [1, 1, 1, 1, 1.0, f, d, 0.0, r]
        for f in (0.5, 1.0, 1.5)
        for d in (1.0, 0.6)
        for r in (2.0, 0.7)  # floor relief off / ReID-confident band
    ]
    for w in seeds:
        w = np.asarray(w, np.float32)
        t = score(w)
        log.append(_entry(w, t, "seed"))
        if t > best_t:
            best_t, best_w = t, w
            print(f"[tune] seed floor={w[5]} decay={w[6]} J&F={t:.4f}", flush=True)
    for i in range(args.tune_trials):
        w = sample_weights(rng)
        t = score(w)
        log.append(_entry(w, t, "random"))
        if t > best_t:
            best_t, best_w = t, w
            print(f"[tune] {i + 1}/{args.tune_trials} J&F={t:.4f} "
                  f"w={np.round(w, 3).tolist()}", flush=True)
    for i in range(args.tune_local):
        w = (best_w * np.exp(rng.normal(0, 0.22, size=9))).astype(np.float32)
        w[5] = max(0.0, float(best_w[5] + rng.normal(0, 0.2)))
        w[6] = float(np.clip(best_w[6] * np.exp(rng.normal(0, 0.1)), 0.3, 1.0))
        w[7] = float(np.clip(best_w[7] + rng.normal(0, 0.08), 0.0, 0.7))
        # jitter the relief when it is on; when it is off (≥ 1), half the
        # trials try turning it on
        if best_w[8] < 1.0:
            w[8] = float(np.clip(best_w[8] + rng.normal(0, 0.08), 0.3, 0.99))
        else:
            w[8] = 2.0 if rng.random() < 0.5 else float(rng.uniform(0.5, 0.95))
        t = score(w)
        log.append(_entry(w, t, "local"))
        if t > best_t:
            best_t, best_w = t, w
            print(f"[tune] local {i + 1}/{args.tune_local} J&F={t:.4f}", flush=True)
    # Term dropout: every subset of {objectness, reid, overlap} zeroed (and
    # the relief off) around the incumbent, then one more local pass around
    # a new winner (zeros stay zero under the multiplicative jitter).
    drop_sets = [[0], [1], [3], [0, 1], [0, 3], [1, 3], [0, 1, 3]]
    pre_drop_w = best_w.copy()
    for idxs in drop_sets:
        for reacq_off in (False, True):
            w = pre_drop_w.copy()
            for j in idxs:
                w[j] = 0.0
            if reacq_off:
                w[8] = 2.0
            t = score(w)
            log.append(_entry(w, t, "drop"))
            if t > best_t:
                best_t, best_w = t, w
                print(f"[tune] drop {idxs} reacq_off={reacq_off} J&F={t:.4f}", flush=True)
    if not np.array_equal(best_w, pre_drop_w):
        for i in range(max(args.tune_local // 2, 1)):
            w = (best_w * np.exp(rng.normal(0, 0.15, size=9))).astype(np.float32)
            w[5] = max(0.0, float(best_w[5] + rng.normal(0, 0.15)))
            w[6] = float(np.clip(best_w[6] * np.exp(rng.normal(0, 0.08)), 0.3, 1.0))
            w[7] = float(np.clip(best_w[7] + rng.normal(0, 0.05), 0.0, 0.7))
            if best_w[8] < 1.0:
                w[8] = float(np.clip(best_w[8] + rng.normal(0, 0.05), 0.3, 0.99))
            t = score(w)
            log.append(_entry(w, t, "drop-local"))
            if t > best_t:
                best_t, best_w = t, w
                print(f"[tune] drop-local {i + 1} J&F={t:.4f}", flush=True)
    return best_w, float(best_t), log


def synthetic_config() -> PremvosConfig:
    """--synthetic's small nets and 64×96 canvas (frozen BN), which run
    anywhere, the CPU included."""
    return PremvosConfig(
        proposal=ProposalConfig(
            backbone_depth=26, fpn_channels=32, rpn_pre_nms_topk=32,
            rpn_post_nms_topk=8, detections_per_frame=4,
        ),
        refine=RefineConfig(crop_size=33, backbone_depth=26),
        flow=FlowConfig(variant="flownetc", max_displacement=4,
                        infer_height=64, infer_width=64),
        reid=ReIDConfig(backbone_depth=26, embedding_dim=8, crop_size=32),
        pipeline=PipelineConfig(image_height=64, image_width=96, max_objects=2,
                                max_proposals=4, dtype="float32", scan_chunk=4),
    )


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description="Merge-weight random search against J&F.")
    ap.add_argument("--data", help="DAVIS root (JPEGImages/Annotations)")
    ap.add_argument("--synthetic", action="store_true",
                    help="tune on generated moving-squares sequences")
    ap.add_argument("--demo", action="store_true",
                    help="tune on the trained-accuracy demo's sequence and config "
                         "(eval/synthetic_demo.py; its --save-params via --checkpoint)")
    ap.add_argument("--benchmark", action="store_true",
                    help="tune on the synthetic benchmark's tune split (eval/synthetic_benchmark.py "
                         "config; its --save-params via --checkpoint), then report the best "
                         "weights' J&F on the unseen val split")
    ap.add_argument("--split", default="val")
    ap.add_argument("--trials", type=int, default=64)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--config", help="JSON config preset")
    ap.add_argument("--checkpoint", help="orbax directory or .pt file (else random weights)")
    ap.add_argument("--max-frames", type=int, default=None)
    ap.add_argument("--max-seqs", type=int, default=None)
    ap.add_argument("--out", default="configs/merge_tuned_torch.json")
    ap.add_argument("--device", default=None,
                    help="default: cuda (raises without a card); cpu runs the plain versions")
    return ap, ap.parse_args(argv)


def main(argv=None) -> dict:
    """The search: precompute once, then the defaults and --trials random
    vectors replayed. Writes and returns {"merge": best weights,
    "_tuning": {...}} (with --benchmark also the val split's J&F of the
    best and the default weights)."""
    # the protocol's module imports this one: its configs load here
    from premvos_tpu_torch.eval.synthetic_benchmark import bench_config, demo_config

    ap, args = parse_args(argv)
    device = resolve_device(args.device)
    if args.demo:
        cfg = demo_config()
    elif args.benchmark:
        cfg = bench_config()
    elif args.config:
        cfg = load_config(args.config)
    elif args.synthetic:
        cfg = synthetic_config()
    else:
        cfg = PremvosConfig()
    if not (args.data or args.demo or args.benchmark or args.synthetic):
        ap.error("--data or --synthetic required")
    with tempfile.TemporaryDirectory(prefix="tune_merge_") as tmp:
        return search(args, cfg, tmp, device)


def search(args, cfg, tmp, device) -> dict:
    """main's work; generated trees go under `tmp`."""
    hw = (cfg.pipeline.image_height, cfg.pipeline.image_width)

    if args.demo:
        args.data = os.path.join(tmp, "demo")
        make_synthetic_davis(args.data, sequences=("demo",), t=10, hw=hw, num_objects=2)
    elif args.benchmark:
        root = args.data or os.path.join(tmp, "bench")
        if not os.path.exists(os.path.join(root, "ImageSets")):
            # the synthetic benchmark's split sizes and seed, so the tune and
            # val sequences are the benchmark run's (its --data-root is
            # better still)
            make_synthetic_vos(root, n_train=6, n_tune=2, n_val=4, t=24, hw=hw,
                               seed=args.seed, flow_pairs=False)
        args.data = root
        args.split = "tune"
    elif args.synthetic:
        args.data = os.path.join(tmp, "synthetic")
        make_synthetic_davis(args.data, sequences=("seq_a", "seq_b"), t=6, hw=(64, 96),
                             num_objects=2)
    ds = DavisDataset(args.data, split=args.split)
    models = build_models(cfg, device)
    models = (load_params(args.checkpoint, models) if args.checkpoint
              else init_params(models, cfg, 0, device))

    sequences = ds.sequences[: args.max_seqs]
    precomputed = precompute_split(models, cfg, ds, sequences, max_frames=args.max_frames,
                                   device=device)

    rng = np.random.default_rng(args.seed)
    ws = cfg.merge.warp_stride
    baseline, _ = evaluate_weights(precomputed, DEFAULT_WEIGHTS, ws)
    print(f"[tune] baseline (all-1.0) J&F = {baseline:.4f}", flush=True)
    best_w, best_score = DEFAULT_WEIGHTS, baseline
    for t in range(args.trials):
        w = sample_weights(rng)
        score, _ = evaluate_weights(precomputed, w, ws)
        mark = ""
        if score > best_score:
            best_w, best_score, mark = w, score, "  ← best"
        print(f"[tune] {t + 1}/{args.trials} J&F={score:.4f} "
              f"w={np.round(w, 3).tolist()}{mark}", flush=True)

    out = {
        "merge": {k: float(v) for k, v in zip(WEIGHT_NAMES, best_w)},
        "_tuning": {
            "J&F": best_score,
            "baseline_J&F": baseline,
            "trials": args.trials,
            "split": args.split,
            "synthetic": bool(args.synthetic),
            "sequences": list(sequences),
        },
    }
    if args.benchmark:
        # the tuned weights on the val split, which the search never saw
        pre_val = precompute_split(models, cfg, DavisDataset(args.data, split="val"),
                                   device=device)
        val_best, _ = evaluate_weights(pre_val, best_w, ws)
        val_base, _ = evaluate_weights(pre_val, DEFAULT_WEIGHTS, ws)
        out["_tuning"]["val_J&F"] = float(val_best)
        out["_tuning"]["val_baseline_J&F"] = float(val_base)
        print(f"[tune] held-out val: tuned {val_best:.4f} vs baseline {val_base:.4f}",
              flush=True)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=2)
    print(f"[tune] best J&F = {best_score:.4f} → {args.out}", flush=True)
    return out


if __name__ == "__main__":
    main()
