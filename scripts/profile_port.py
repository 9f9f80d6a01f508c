#!/usr/bin/env python3
"""Where the time goes in the PyTorch port's `run_sequence` on one CUDA card.

    python3 scripts/profile_port.py [--config configs/davis2017_val.json]
                                    [--json PATH]

Random weights from seed 0 and 9 synthetic frames (one chunk of 8 steps), as
in chip_smoke.py's phase 5. After a warm-up run it makes two measured runs:

  1. stage spans: CUDA events recorded around each stage call (the networks,
     the crop/paste steps, the flow resizes and the per-frame merge) — each
     span is the device-timeline interval between its two events, so time
     the device spent waiting for the host inside a span counts to it;
  2. torch.profiler over a whole run: device time by kernel name, and the
     device's busy share of the run's wall time.

Prints both as text (and with --json writes them to PATH). Imports nothing
of JAX.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FRAMES = 9
SEED = 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", default=os.path.join(REPO, "configs", "davis2017_val.json"))
    ap.add_argument("--json", help="also write the results (JSON) here")
    args = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("profile_port: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import chip_smoke
    from premvos_tpu_torch.config import load_config
    from premvos_tpu_torch.pipeline import runner

    cfg = load_config(args.config)
    p = cfg.pipeline
    models = runner.init_params(runner.build_models(cfg), cfg, seed=SEED)
    frames, gt = chip_smoke.synthetic_video(
        np, FRAMES, p.image_height, p.image_width, p.max_objects, seed=2
    )
    frames = torch.from_numpy(frames).cuda()
    gt = torch.from_numpy(gt).cuda()

    def run():
        out = runner.run_sequence(models, cfg, frames, gt, 2)
        torch.cuda.synchronize()
        return out

    run()  # warm-up

    # 1. Stage spans from CUDA events around each stage call.
    spans = collections.defaultdict(list)

    def timed(name, fn):
        def wrapper(*a, **kw):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*a, **kw)
            end.record()
            spans[name].append((start, end))
            return out
        return wrapper

    patched = {
        "make_refine_crops": "2 refine: crops",
        "refined_fullres": "2 refine: paste",
        "resize_bilinear": "3 flow: resizes",
        "run_reid": "4 reid (crops + net)",
        "merge_frame": "5 merge (per frame)",
    }
    saved_fns = {k: getattr(runner, k) for k in patched}
    saved_fwd = {}
    for name, label in patched.items():
        setattr(runner, name, timed(label, saved_fns[name]))
    for attr, label in (("maskrcnn", "1 proposals: Mask R-CNN"),
                        ("refine", "2 refine: DeepLabv3+"),
                        ("flow", "3 flow: FlowNet2")):
        mod = getattr(models, attr)
        saved_fwd[attr] = mod.forward
        mod.forward = timed(label, mod.forward)
    t0 = time.perf_counter()
    run()
    wall_ms = (time.perf_counter() - t0) * 1e3
    for name, fn in saved_fns.items():
        setattr(runner, name, fn)
    for attr in saved_fwd:
        del getattr(models, attr).forward
    stage_ms = {
        k: sum(s.elapsed_time(e) for s, e in v) for k, v in sorted(spans.items())
    }
    print(f"run_sequence, {FRAMES} frames: wall {wall_ms:.1f} ms")
    for k, v in stage_ms.items():
        print(f"  {k:28s} {v:9.2f} ms  ({len(spans[k])} calls)")

    # 2. Kernel time by name from torch.profiler.
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        prof_wall_ms = (time.perf_counter() - t0) * 1e3
    rows = []
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:
            continue  # host-side ops; their kernels are listed on their own
        rows.append((ev.key, ev.self_device_time_total / 1e3, ev.count))
    rows.sort(key=lambda r: -r[1])
    busy_ms = sum(r[1] for r in rows)
    print(f"profiled run: wall {prof_wall_ms:.1f} ms, device busy {busy_ms:.1f} ms "
          f"({100 * busy_ms / prof_wall_ms:.1f} %)")
    for key, ms, n in rows[:25]:
        print(f"  {ms:9.3f} ms  {n:6d}  {key[:100]}")

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(smi)
    if not args.json:
        return 0
    os.makedirs(os.path.dirname(os.path.abspath(args.json)), exist_ok=True)
    with open(args.json, "w") as f:
        json.dump({
            "card": smi, "config": args.config, "frames": FRAMES,
            "wall_ms": wall_ms, "stage_ms": stage_ms,
            "stage_calls": {k: len(v) for k, v in spans.items()},
            "profiled_wall_ms": prof_wall_ms, "device_busy_ms": busy_ms,
            "kernels": [{"name": k, "ms": ms, "count": n} for k, ms, n in rows[:60]],
        }, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
