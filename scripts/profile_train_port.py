#!/usr/bin/env python3
"""Where the time goes in the PyTorch port's Mask R-CNN training step on one
CUDA card.

    python3 scripts/profile_train_port.py [--steps N] [--json PATH]

The step of chip_smoke.py's phase 7: ProposalConfig() defaults (ResNet-101
FPN, 256 channels, 256 RoIs per image), 480×864 images, batch 2, 8 object
slots, Adam 1e-4, float32 without TF32, random weights from seed 0, one
fixed batch from the in-memory synthetic dataset. After two warm-up steps:

  1. spans: CUDA events around each part of the step (backbone + FPN, RPN
     head, proposals, the two RoIAligns, the two heads, the per-image
     target assignment and losses, backward, the Adam update), summed over
     `--steps` steps; each span is the device-timeline interval between its
     two events, so device time spent waiting for the host inside a span
     counts to it;
  2. torch.profiler over `--steps` steps: device time by kernel name and
     the device's busy share of the wall time.

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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--json", help="also write the results (JSON) here")
    args = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("profile_train_port: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import chip_smoke
    from premvos_tpu_torch.config import ProposalConfig
    from premvos_tpu_torch.models.anchors import pyramid_anchors
    from premvos_tpu_torch.models.layers import init_module
    from premvos_tpu_torch.models.maskrcnn import MaskRCNN
    from premvos_tpu_torch.pipeline.runner import float32_precision, place
    from premvos_tpu_torch.train import detection
    from premvos_tpu_torch.train.train_maskrcnn import sample_batch
    from premvos_tpu_torch.train.trainer import create_train_state

    cfg, hw, slots, bs = ProposalConfig(), (480, 864), 8, 2
    dev = torch.device("cuda")
    model = MaskRCNN(cfg)
    init_module(model, torch.Generator().manual_seed(0))
    model = place(model, dev).train()
    anchors = {k: torch.from_numpy(v).to(dev)
               for k, v in pyramid_anchors(*hw, cfg.anchor_scales, cfg.anchor_ratios).items()}
    opt = create_train_state(model, 1e-4).optimizer
    batch = sample_batch(chip_smoke.SyntheticDavis(np), np.random.default_rng(1), hw, slots,
                         bs, dev)
    spans = collections.defaultdict(list)
    recording = [False]

    def span(name, fn):
        def wrapper(*a, **kw):
            if not recording[0]:
                return fn(*a, **kw)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*a, **kw)
            end.record()
            spans[name].append((start, end))
            return out
        return wrapper

    model.features = span("1 backbone + FPN", model.features)
    model.rpn_outputs = span("2 RPN head", model.rpn_outputs)
    model.proposals = span("3 proposals (decode, top-k, NMS)", model.proposals)
    model.box_head.forward = span("5 box head", model.box_head.forward)
    model.mask_head.forward = span("6 mask head", model.mask_head.forward)
    for name, label in (("multilevel_roi_align", "4 RoIAlign (box + mask)"),
                        ("assign_rpn_labels_dense", "7 per image: RPN targets"),
                        ("rpn_dense_loss", "7 per image: RPN loss"),
                        ("assign_roi_targets", "7 per image: RoI targets"),
                        ("mask_targets", "7 per image: mask targets"),
                        ("detection_loss", "7 per image: detection loss")):
        setattr(detection, name, span(label, getattr(detection, name)))
    loss_fn = detection.maskrcnn_loss_fn(model, anchors, cfg, hw)
    forward = span("0 forward + loss (all of 1-7)", loss_fn)
    backward = span("8 backward", lambda loss: loss.backward())
    update = span("9 Adam update + zero_grad",
                  lambda: (opt.step(), opt.zero_grad(set_to_none=True)))

    def step():
        with float32_precision():
            loss = forward(batch)
            backward(loss)
            update()
        return loss

    for _ in range(2):
        step()
    torch.cuda.synchronize()

    # 1. Spans.
    recording[0] = True
    t0 = time.perf_counter()
    for _ in range(args.steps):
        step()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / args.steps
    recording[0] = False
    span_ms = {k: sum(s.elapsed_time(e) for s, e in v) / args.steps
               for k, v in sorted(spans.items())}
    print(f"training step (ProposalConfig(), 480x864, batch 2): wall {wall_ms:.2f} ms/step")
    for k, v in span_ms.items():
        print(f"  {k:40s} {v:9.3f} ms/step  ({len(spans[k]) // args.steps} calls/step)")

    # 2. Kernel time by name from torch.profiler.
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.steps):
            step()
        torch.cuda.synchronize()
        prof_wall_ms = (time.perf_counter() - t0) * 1e3 / args.steps
    rows = []
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA or getattr(ev, "is_user_annotation", False):
            # Host-side ops, and annotated regions such as Adam.step, whose
            # kernels are listed on their own.
            continue
        rows.append((ev.key, ev.self_device_time_total / 1e3 / args.steps,
                     ev.count / args.steps))
    rows.sort(key=lambda r: -r[1])
    busy_ms = sum(r[1] for r in rows)
    print(f"profiled: wall {prof_wall_ms:.2f} ms/step, device busy {busy_ms:.2f} ms/step "
          f"({100 * busy_ms / prof_wall_ms:.1f} %)")
    for key, ms, n in rows[:30]:
        print(f"  {ms:9.3f} ms  {n:7.1f}  {key[:100]}")

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
            "card": smi, "steps": args.steps, "wall_ms_per_step": wall_ms,
            "span_ms_per_step": span_ms,
            "span_calls_per_step": {k: len(v) // args.steps for k, v in spans.items()},
            "profiled_wall_ms_per_step": prof_wall_ms, "device_busy_ms_per_step": busy_ms,
            "kernels_per_step": [{"name": k, "ms": ms, "count": n} for k, ms, n in rows[:60]],
        }, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
