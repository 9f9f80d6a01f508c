#!/usr/bin/env python3
"""Do the score floor, the warp decay and the ReID sigma fix the
identity-swap losses? The merge-knob probe (port of
scripts/probe_merge_knobs.py).

    python3 scripts/probe_merge_knobs_torch.py --checkpoint CKPT --data_root ROOT \
        [--device cpu] [--json PATH]

Builds the benchmark nets at `bench_config(canvas=(128, 192))`, loads
CKPT into them (`utils/checkpoint.py::load_params`: a `save_params` file
or an orbax directory, such as `eval/synthetic_demo.py --save-params`
writes), runs stages 1-4 of ROOT's val split once
(`eval/harness.py::precompute_split`; ROOT is a DAVIS-layout tree, such
as `data/synthetic_vos.py::make_synthetic_vos` writes), then replays the
merge with each of the JAX script's candidate weight vectors at warp
stride 1 (`evaluate_weights`) and prints its J&F; last, one JSON line with
the proposals' oracle J&F and every candidate's. Runs on the card unless
given `--device cpu`. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# The JAX script's candidates: (w_obj, w_reid, w_warp, w_overlap,
# reid_sigma, floor, warp_decay, reid_ema); reid_reacquire keeps its
# default.
CANDIDATES = {
    "defaults": [1, 1, 1, 1, 1.0, 0.0, 1.0, 0.0],
    "floor0.5": [1, 1, 1, 1, 1.0, 0.5, 1.0, 0.0],
    "floor1.0": [1, 1, 1, 1, 1.0, 1.0, 1.0, 0.0],
    "decay0.6": [1, 1, 1, 1, 1.0, 0.0, 0.6, 0.0],
    "floor1+decay0.6": [1, 1, 1, 1, 1.0, 1.0, 0.6, 0.0],
    "floor1+decay0.3": [1, 1, 1, 1, 1.0, 1.0, 0.3, 0.0],
    "f1+d0.6+sig0.4": [1, 1, 1, 1, 0.4, 1.0, 0.6, 0.0],
    "f1+d0.6+ov0.3": [1, 1, 1, 0.3, 1.0, 1.0, 0.6, 0.0],
    "f1+d0.6+reid2": [1, 2, 1, 1, 1.0, 1.0, 0.6, 0.0],
    "f1+d0.6+ov0.3+reid2": [1, 2, 1, 0.3, 1.0, 1.0, 0.6, 0.0],
    "f1.5+d0.4+ov0.3+reid2": [1, 2, 1, 0.3, 1.0, 1.5, 0.4, 0.0],
}


def probe(precomputed, verbose=False) -> dict:
    """{candidate: dataset J&F} of each candidate's merge replay over
    `precomputed` (precompute_split's list) at warp stride 1."""
    from premvos_tpu_torch.eval.harness import evaluate_weights

    out = {}
    for name, w in CANDIDATES.items():
        jf, _ = evaluate_weights(precomputed, np.asarray(w, np.float32), 1)
        out[name] = float(jf)
        if verbose:
            print(f"{name:24s} J&F = {jf:.4f}", flush=True)
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description="The merge-knob probe on a checkpoint's "
                                             "precomputed val split.")
    ap.add_argument("--checkpoint", required=True, help="save_params file or orbax directory")
    ap.add_argument("--data_root", required=True, help="DAVIS-layout tree with a val split")
    ap.add_argument("--device", default=None, help="torch device (default: the card)")
    ap.add_argument("--json", help="also write the result (JSON) here")
    args = ap.parse_args(argv)
    sys.path.insert(0, REPO)
    from premvos_tpu_torch.data.davis import DavisDataset
    from premvos_tpu_torch.eval.harness import precompute_split
    from premvos_tpu_torch.eval.synthetic_benchmark import bench_config, oracle_jf
    from premvos_tpu_torch.pipeline.runner import build_models, resolve_device
    from premvos_tpu_torch.utils.checkpoint import load_params

    device = resolve_device(args.device)
    cfg = bench_config(canvas=(128, 192))
    models = load_params(args.checkpoint, build_models(cfg, device=device))
    t0 = time.perf_counter()
    pre = precompute_split(models, cfg, DavisDataset(args.data_root, split="val"),
                           verbose=False, device=device)
    print(f"[precompute] {time.perf_counter() - t0:.1f}s", flush=True)
    result = {"oracle": oracle_jf(pre), "probe": probe(pre, verbose=True)}
    print(json.dumps(result))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(result, f, indent=1)
    return result


if __name__ == "__main__":
    main()
