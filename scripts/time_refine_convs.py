#!/usr/bin/env python3
"""Device time of each convolution of the refinement net (DeepLabv3+) in one
forward pass on one CUDA card.

    python3 scripts/time_refine_convs.py [--batch 8 256] [--top 6]

configs/davis2017_val.json's refinement net (ResNet-50, output stride 16,
ASPP rates 6/12/18, bf16 compute, channels-last), random weights from seed
0, on random [B, 4, 385, 385] crops: B = 8 is the fused fine-tune's refine
batch, B = 256 the inference path's (8 frames × 32 proposals). For each
batch under inference_mode (and, up to B = 32, with grad enabled), after
two warm-up passes: the wall time of one pass and the largest per-convolution spans
(CUDA events around each convolution module). Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, nargs="+", default=[8, 256])
    ap.add_argument("--top", type=int, default=6)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("time_refine_convs: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from premvos_tpu_torch.config import load_config
    from premvos_tpu_torch.models.layers import Conv
    from premvos_tpu_torch.pipeline.runner import build_models, init_params

    cfg = load_config(os.path.join(REPO, "configs", "davis2017_val.json"))
    net = init_params(build_models(cfg), cfg, seed=0).refine
    spans = {}

    def before(mod, _):
        mod.start = torch.cuda.Event(enable_timing=True)
        mod.start.record()

    def after(mod, _, __):
        end = torch.cuda.Event(enable_timing=True)
        end.record()
        spans.setdefault(mod.label, []).append((mod.start, end))

    for name, mod in net.named_modules():
        if isinstance(mod, Conv):
            mod.label = f"{name} {tuple(mod.weight.shape)} dilation {mod.dilation}"
            mod.register_forward_pre_hook(before)
            mod.register_forward_hook(after)

    s = cfg.refine.crop_size
    for b in args.batch:
        x = torch.randn(b, 4, s, s, device="cuda").contiguous(memory_format=torch.channels_last)
        modes = [("inference_mode", torch.inference_mode)]
        if b <= 32:  # a pass that keeps activations for backward, as training does
            modes.insert(0, ("grad enabled", torch.enable_grad))
        for mode, ctx in modes:
            with ctx():
                for _ in range(2):
                    net(x)
                torch.cuda.synchronize()
                spans.clear()
                t0 = time.perf_counter()
                net(x)
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t0) * 1e3
            total = sorted(((sum(a.elapsed_time(e) for a, e in v), k) for k, v in spans.items()),
                           reverse=True)
            print(f"batch {b}, {mode}: forward wall {wall:.3f} ms, convolutions "
                  f"{sum(t for t, _ in total):.3f} ms")
            for t, k in total[:args.top]:
                print(f"  {t:9.3f} ms  {k}")
    print(f"cuDNN {torch.backends.cudnn.version()}, benchmark={torch.backends.cudnn.benchmark}")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
