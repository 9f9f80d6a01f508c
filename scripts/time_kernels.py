#!/usr/bin/env python3
"""Times of the resample2d and correlation kernels at the main path's shapes,
three ways, on one CUDA card.

    python3 scripts/time_kernels.py [--root DIR] [--json PATH]

`--root` is the checkout whose `premvos_tpu_torch` is imported (default: the
one holding this script), so two trees can be timed in one call, on one card.
For each case it reports:

  wrapper_ms  CUDA events around 50 back-to-back wrapper calls, over 50 (as
              chip_smoke.py times a kernel): the device timeline, so when one
              call's host path is longer than its kernel, this is the host's;
  device_ms   the kernel's own device time by name (torch.profiler over the
              same 50 calls, chip_smoke.device_ms);
  host_us     host time of one wrapper call: a host clock around 200
              back-to-back calls, after a synchronize, over 200;
  library_ms  one PyTorch call computing the same function, where there is
              one (`grid_sample`, border padding, align_corners, on float32
              input), timed as wrapper_ms.

Cases: resample2d at FlowNet2's warp (bf16 [8, 3, 448, 832]) and at the
merge warp (f32 [1, 8, 240, 432]); correlation at FlowNetC's cost volume
([8, 256, 56, 104], max displacement 20, stride 2) with float32 and with
bfloat16 inputs. Prints one JSON object. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ITERS = 50


def host_us(torch, fn, iters=200):
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / iters * 1e6


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=REPO)
    ap.add_argument("--json", help="also write the results (JSON) here")
    args = ap.parse_args()

    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("time_kernels: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from chip_smoke import cuda_ms, device_ms  # this checkout's helpers

    sys.path.insert(0, os.path.abspath(args.root))
    from premvos_tpu_torch import kernels
    from premvos_tpu_torch.ops.correlation import correlation_cuda
    from premvos_tpu_torch.ops.resample2d import resample2d_cuda

    kernels.load()
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)
    rows = []

    for b, c, h, w, dtype in ((8, 3, 448, 832, torch.bfloat16), (1, 8, 240, 432, torch.float32)):
        src = torch.rand(b, c, h, w, generator=gen).to(dev, dtype)
        yy, xx = torch.meshgrid(torch.arange(h), torch.arange(w), indexing="ij")
        smooth = torch.stack([9.0 + 30 * torch.sin(yy / 40.0), -6.0 + 20 * torch.cos(xx / 50.0)])
        flow = (smooth[None] + torch.randn(b, 2, h, w, generator=gen)).to(dev)
        gx = (torch.arange(w, device=dev) + flow[:, 0]) / (w - 1) * 2 - 1
        gy = (torch.arange(h, device=dev)[:, None] + flow[:, 1]) / (h - 1) * 2 - 1
        grid = torch.stack([gx, gy], -1)
        srcf = src.float()

        def run():
            return resample2d_cuda(src, flow)

        def lib():
            return F.grid_sample(srcf, grid, "bilinear", "border", align_corners=True)

        rows.append(dict(
            kernel="resample2d", shape=f"src [{b},{c},{h},{w}] {str(dtype)[6:]}, flow f32",
            wrapper_ms=cuda_ms(run, ITERS), device_ms=device_ms(run, "resample", ITERS),
            host_us=host_us(torch, run), library_ms=cuda_ms(lib, ITERS),
            library_device_ms=device_ms(lib, "grid_sampler", ITERS),
            library_host_us=host_us(torch, lib),
        ))

    b, c, h, w, md, st = 8, 256, 56, 104, 20, 2
    for dtype in (torch.float32, torch.bfloat16):
        f1 = torch.randn(b, h, w, c, generator=gen).to(dev, dtype).permute(0, 3, 1, 2)
        f2 = torch.randn(b, h, w, c, generator=gen).to(dev, dtype).permute(0, 3, 1, 2)

        def run():
            return correlation_cuda(f1, f2, md, st)

        rows.append(dict(
            kernel="correlation", shape=f"f1, f2 [{b},{c},{h},{w}] {str(dtype)[6:]} channels-last",
            wrapper_ms=cuda_ms(run, 20), device_ms=device_ms(run, "corr", 20),
            host_us=host_us(torch, run, 50),
        ))

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    for r in rows:
        print(f"{r['kernel']:12s} {r['shape']:42s} wrapper {r['wrapper_ms']:.5f} ms, "
              f"device {r['device_ms']:.5f} ms, host {r['host_us']:.2f} us"
              + (f", grid_sample {r['library_ms']:.5f} ms" if "library_ms" in r else ""),
              file=sys.stderr)
    result = {"card": smi, "root": os.path.abspath(args.root), "torch": torch.__version__,
              "rows": rows}
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)), exist_ok=True)
        with open(args.json, "w") as f:
            json.dump(result, f, indent=1)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
