#!/usr/bin/env python3
"""Times of the port's kernels at their paths' shapes (inference and
training), three ways, on one CUDA card.

    python3 scripts/time_kernels.py [--root DIR] [--kernels NAME ...] [--json PATH]

`--root` is the checkout whose `premvos_tpu_torch` is imported (default: the
one holding this script), so two trees can be timed in one call, on one card.
`--kernels` keeps only the rows of the named kernels (`nms`,
`multilevel_roi_align`, `resample2d`, `resample2d_block`, `correlation`,
`correlation_backward`, `roi_align`, `roi_align_backward`); the `empty`
row is always timed.
For each case it reports:

  wrapper_ms  CUDA events around 50 back-to-back wrapper calls, over 50 (as
              chip_smoke.py times a kernel): the device timeline, so when one
              call's host path is longer than its kernel, this is the host's;
  host_us     host time of one wrapper call: a host clock around 200
              back-to-back calls, after a synchronize, over 200 (where the
              card is the slower side, its queue holds the host back);
  host_call_us  host time of one call on an idle card: a host clock around
              each of 200 calls, synchronized between them;
  device_ms   the kernel's own device time by name (torch.profiler over 50
              calls): for NMS the mask pass and the sweep together, with
              `device_parts_ms` splitting the whole call into the mask pass,
              the sweep, PyTorch's sort and the rest (score masking, gathers
              and, where the wrapper still runs it, the compaction);
  library_ms  one PyTorch call computing the same function, where there is
              one (`grid_sample`, border padding, align_corners, on float32
              input; for the correlation backward, autograd's backward
              through chip_smoke.py's 21-bmm formulation, TF32 off), timed
              as wrapper_ms; for grid_sample also `library_device_ms`, its
              kernel's device time by name.

NMS rows also give `compact_ms`: the module's `_compact` (the plain
compaction of kept indices, which the parent's CUDA wrapper ran after its
kernels) on the row's result, by CUDA events; `sort_host_call_us`: the
host time of the wrapper's `torch.sort(-scores, stable=True)` alone, as
host_call_us; and `host_ops_us`: the host µs per call of the wrapper's
PyTorch operators (torch.profiler, CPU only).
An `empty` row times `torch.cuda._sleep(0)`, a kernel that returns at
once: the floor under any small kernel's device time and any wrapper's
host time.

Cases (chip_smoke.py's phase-3 inputs): NMS at the RPN's shape (8 × 2384
boxes, IoU 0.7, keep 256), at the detection's (8 × 256, IoU 0.5, score 0.05,
keep 32) and at the RPN's on clustered boxes (the sweep visits all 2384);
multilevel RoIAlign at the box head (bf16 C = 256, 256 RoIs per image,
P = 7) and the mask head (32 RoIs, P = 14); resample2d at FlowNet2's warp
(bf16 [8, 3, 448, 832]) and the merge warp (f32 [1, 8, 240, 432]);
the block warp (`resample2d_block_cuda`) at every block-warp row of
chip_smoke.py's phase 3 (`block_rows`, the inputs of `block_inputs`):
FlowNet2's bf16 and float32 [8, 3, 448, 832] and the merge's float32
[1, 8, 240, 432] at (8, 128) blocks, residual 4, max_flow 64, each on
smooth flow and on ±30 px noise, the lucid warps' backgrounds and
patches at their blocks, and the merge at warp stride 1 (float32
[1, 8, 480, 864], configs/fast_flownetc.json) on both flows; each with the
kernel's `path` there (chip_smoke.py's `block_path`), `bound` (the bytes of source, flow and
output once against 8 flops an output) and `exact_device_ms`, the exact
warp's (`resample2d_cuda`) device time by name on the same inputs;
correlation at FlowNetC's cost volume ([8, 256, 56, 104], max displacement
20, stride 2), float32 and bfloat16 inputs; and the training path's
single-level RoIAlign (`roi_align_levels`: four launches, one per level
P2..P5, into one output) and its backward (`roi_align_levels_backward`,
or in a tree without it the four `roi_align_backward_cuda` calls it
replaced: four launches, each with its gradient's zero fill) at the box
head (P = 7) and the mask head (P = 14): float32 P2..P5 [2, H, W, 256] of a
480×864 image, 256 RoIs per image. Their `device_ms` is the kernel's own
four launches; `device_all_ms` adds everything else the call ran on the
card (for the backward, its gradients' zero fill). In a tree that has it,
the correlation's backward at chip_smoke.py's rows (FlowNetC training's
[8, 256, 32, 32] and [8, 256, 8, 8] at max displacement 20, stride 2,
[2, 64, 23, 37] at stride 2 and 1, [2, 200, 23, 37] and [2, 64, 50, 30]);
its `device_ms` is every kernel named `corr_grad` (one launch a call since
the kernel's redesign, two before), `device_kernels` their names and
records per call, and `bound`, `bound_fp32_fma` and `bound_bytes_ms` come
from chip_smoke.py's `corr_grad_bounds`. The
profiled runs come after
every other timing (a profiled run slows what follows it in the process).
Prints one JSON object. Imports nothing of JAX.
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


def host_call_us(torch, fn, iters=200):
    """Host time of one call made on an idle card: a host clock around each
    of `iters` calls, with a synchronize between them outside the clock (so
    no queue of earlier work can hold the call back)."""
    fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        total += time.perf_counter() - t0
        torch.cuda.synchronize()
    return total / iters * 1e6


def host_ops_us(torch, fn, iters=ITERS) -> dict:
    """{operator: host µs per call} of fn()'s top-level PyTorch operators
    (their self CPU time under torch.profiler, CPU only)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    ops = {ev.key: ev.self_cpu_time_total / iters for ev in prof.key_averages()}
    return dict(sorted(ops.items(), key=lambda kv: -kv[1])[:12])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=REPO)
    ap.add_argument("--kernels", nargs="+", help="time only these kernels' rows")
    ap.add_argument("--json", help="also write the results (JSON) here")
    args = ap.parse_args()

    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("time_kernels: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    # This checkout's helpers and inputs, whichever tree is timed.
    from chip_smoke import (
        CORR_GRAD_CASES,
        block_inputs,
        block_path,
        block_rows,
        bound_ms,
        corr_bmm,
        corr_grad_bounds,
        LEVEL_SHAPES,
        LEVEL_STRIDES,
        NMS_CASES,
        ROI_CASES,
        corr_grad_inputs,
        cuda_ms,
        kernel_times,
        named_ms,
        nms_inputs,
        nms_parts,
        resample_inputs,
        roi_case,
        roi_inputs,
    )

    sys.path.insert(0, os.path.abspath(args.root))
    from premvos_tpu_torch import kernels
    from premvos_tpu_torch.ops import nms as nms_mod
    from premvos_tpu_torch.ops import correlation as corr_mod
    from premvos_tpu_torch.ops.correlation import correlation_cuda
    from premvos_tpu_torch.ops.resample2d import resample2d_block_cuda, resample2d_cuda
    from premvos_tpu_torch.ops import roi_align as roi_mod
    from premvos_tpu_torch.ops.roi_align import multilevel_roi_align_cuda, roi_align_levels

    kernels.load()
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False  # the library calls' float32 products

    def want(name):
        return args.kernels is None or name in args.kernels

    # (row, wrapper call, kernel-name pattern of its device time, library call)
    cases = [(dict(kernel="empty", shape="torch.cuda._sleep(0)"),
              lambda: torch.cuda._sleep(0), "spin", None)]

    # The inference rows (the fine-tune's fourth row has no place here).
    for i, (b, n, k, thr, sthr, clustered, image_hw) in enumerate(
            NMS_CASES[:3] if want("nms") else ()):
        boxes, scores = (t.to(dev) for t in nms_inputs(
            torch, torch.Generator().manual_seed(10 + i), b, n, clustered, image_hw))
        ref = nms_mod.nms_reference(boxes, scores, k, thr, sthr)
        order = torch.sort(-scores, dim=-1, stable=True).indices
        kept = torch.zeros(b, n, dtype=torch.bool, device=dev)
        kept.scatter_(1, ref[0].clamp(min=0).long(), ref[1])
        row = dict(kernel="nms", shape=f"boxes [{b},{n},4]{' clustered' if clustered else ''}, "
                                       f"keep {k}, iou {thr}, score {sthr}",
                   kept=int(ref[1].sum()),
                   compact_ms=cuda_ms(lambda: nms_mod._compact(order, kept, k), ITERS))
        row["sort_host_call_us"] = host_call_us(
            torch, lambda s=scores: torch.sort(-s, dim=-1, stable=True))
        cases.append((row, lambda a=(boxes, scores, k, thr, sthr): nms_mod.nms_cuda(*a),
                      "nms_", None))

    for i, case in enumerate(ROI_CASES[:2] if want("multilevel_roi_align") else ()):
        feats, boxes, levels = roi_inputs(torch, torch.Generator().manual_seed(20 + i), dev, case)
        b, n_rois, p, c, dtype = case[:5]
        row = dict(kernel="multilevel_roi_align",
                   shape=f"P2..P5 {dtype} [{b},H,W,{c}], {n_rois} RoIs/image, P={p}")
        cases.append((row, lambda a=(feats, boxes, levels, p, 2): multilevel_roi_align_cuda(*a),
                      "multilevel", None))

    gen = torch.Generator().manual_seed(0)
    for b, c, h, w, dtype in (((8, 3, 448, 832, torch.bfloat16), (1, 8, 240, 432, torch.float32))
                              if want("resample2d") else ()):
        src, flow, grid = resample_inputs(torch, gen, dev, b, c, h, w, dtype)
        srcf = src.float()
        row = dict(kernel="resample2d", shape=f"src [{b},{c},{h},{w}] {str(dtype)[6:]}, flow f32")
        lib = (lambda s=srcf, g=grid:
               F.grid_sample(s, g, "bilinear", "border", align_corners=True))
        cases.append((row, lambda s=src, f=flow: resample2d_cuda(s, f), "resample", lib))

    # The block warp's rows, each on its inputs' own generator; beside each,
    # the exact warp on the same inputs (its device time only).
    exact_calls = []
    for i in range(len(block_rows())) if want("resample2d_block") else ():
        src, flow, _, (block, r, lf) = block_inputs(torch, dev, i)
        b, c, h, w = src.shape
        nbytes = src.numel() * src.element_size() + flow.numel() * 4 + b * c * h * w * 4
        row = dict(kernel="resample2d_block",
                   shape=f"src [{b},{c},{h},{w}] {str(src.dtype)[6:]}, flow f32 "
                         f"({block_rows()[i][1]}), block {block}, residual {r}, max_flow {lf}",
                   bound=bound_ms(nbytes, b * c * h * w * 8.0), bound_bytes=nbytes,
                   path=block_path(torch, src, block, r))
        cases.append((row, lambda a=(src, flow, block, r, lf): resample2d_block_cuda(*a),
                      "resample_block", None))
        exact_calls.append((row, lambda s=src, f=flow: resample2d_cuda(s, f)))

    b, c, h, w, md, st = 8, 256, 56, 104, 20, 2
    for dtype in (torch.float32, torch.bfloat16) if want("correlation") else ():
        f1 = torch.randn(b, h, w, c, generator=gen).to(dev, dtype).permute(0, 3, 1, 2)
        f2 = torch.randn(b, h, w, c, generator=gen).to(dev, dtype).permute(0, 3, 1, 2)
        row = dict(kernel="correlation",
                   shape=f"f1, f2 [{b},{c},{h},{w}] {str(dtype)[6:]} channels-last")
        cases.append((row, lambda a=(f1, f2, md, st): correlation_cuda(*a), "corr", None))

    grad_fn = getattr(corr_mod, "correlation_backward_cuda", None)
    for i, case in enumerate(CORR_GRAD_CASES
                             if grad_fn is not None and want("correlation_backward") else ()):
        f1, f2, g = corr_grad_inputs(torch, torch.Generator().manual_seed(50 + i), dev, case)
        b, c, h, w, md, st = case
        row = dict(kernel="correlation_backward",
                   shape=f"f1, f2 [{b},{c},{h},{w}] f32, md {md}, stride {st}",
                   **corr_grad_bounds(case))
        # The library call: autograd's backward through the 21-bmm
        # formulation, its graph built once.
        a, v = f1.detach().requires_grad_(True), f2.detach().requires_grad_(True)
        out = corr_bmm(torch, a, v, md, st)
        lib = (lambda o=out, a=a, v=v, g=g:
               torch.autograd.grad(o, (a, v), g, retain_graph=True))
        cases.append((row, lambda a=(f1, f2, g, md, st): grad_fn(*a), "corr_grad", lib))

    # The training RoIAligns (chip_smoke.py phase 3's rows): the forward
    # kernel is `single_kernel`, the backward `backward_kernel` in both the
    # parent's and this tree's kernels/roi_align.cu.
    for i, p in enumerate((7, 14) if want("roi_align") or want("roi_align_backward") else ()):
        feats, boxes, levels = roi_case(torch, torch.Generator().manual_seed(30 + i), dev,
                                        2, 256, 256, torch.float32)
        grad_out = torch.randn(2, 256, p, p, 256, generator=torch.Generator().manual_seed(40 + i))
        grad_out = grad_out.to(dev)
        shape = f"P2..P5 float32 [2,H,W,256], 256 RoIs/image, P={p}, 4 launches"
        if want("roi_align"):
            cases.append((dict(kernel="roi_align", shape=shape),
                          lambda a=(feats, boxes, levels, p, 2): roi_align_levels(*a),
                          "single_kernel", None))

        def backward(g=grad_out, bx=boxes, lv=levels):
            # Training's backward: roi_align_levels_backward where the tree
            # has it, else the per-level wrapper calls it replaced.
            if hasattr(roi_mod, "roi_align_levels_backward"):
                return roi_mod.roi_align_levels_backward(g, bx, lv, LEVEL_SHAPES, 2)
            return [roi_mod.roi_align_backward_cuda(g, bx, hw, 2, 1.0 / st, lv, li + 2)
                    for li, (hw, st) in enumerate(zip(LEVEL_SHAPES, LEVEL_STRIDES))]

        if want("roi_align_backward"):
            cases.append((dict(kernel="roi_align_backward", shape=shape), backward,
                          "backward_kernel", None))

    for row, fn, _, lib in cases:
        row["wrapper_ms"] = cuda_ms(fn, ITERS)
        row["host_us"] = host_us(torch, fn)
        row["host_call_us"] = host_call_us(torch, fn)
        if lib is not None:
            row["library_ms"] = cuda_ms(lib, ITERS)
            row["library_host_us"] = host_us(torch, lib)
    for row, fn, pattern, lib in cases:
        if row["kernel"] == "nms":
            row["host_ops_us"] = host_ops_us(torch, fn)
        counts = {}
        times = kernel_times(fn, ITERS, (pattern,), counts=counts)
        row["device_ms"] = named_ms(times, pattern)
        if row["kernel"] == "correlation_backward":
            row["device_kernels"] = {k: n / ITERS for k, n in counts.items() if pattern in k}
        if row["kernel"].startswith("roi_align"):
            row["device_all_ms"] = sum(times.values())
        if row["kernel"] == "nms":
            row["device_parts_ms"] = nms_parts(times)
            row["device_all_ms"] = sum(times.values())
            row["device_kernels_ms"] = times
        # grid_sample is one kernel; the correlation backward's library call
        # is thousands, and on the H100 a trace that large made the traces
        # after it in the process lose their first records, so it is timed
        # by CUDA events only.
        if lib is not None and row["kernel"] == "resample2d":
            row["library_device_ms"] = named_ms(kernel_times(lib, ITERS, ("grid_sampler",)),
                                                "grid_sampler")
    for row, exact in exact_calls:
        row["exact_device_ms"] = named_ms(kernel_times(exact, ITERS, ("resample",)), "resample")

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    rows = [r for r, *_ in cases]
    for r in rows:
        print(f"{r['kernel']:20s} {r['shape']:58s} wrapper {r['wrapper_ms']:.5f} ms, "
              f"device {r['device_ms']:.5f} ms, host {r['host_us']:.2f} us, "
              f"idle-card host {r['host_call_us']:.2f} us"
              + (f", sort host {r['sort_host_call_us']:.2f} us" if "sort_host_call_us" in r else "")
              + (f", parts {r['device_parts_ms']}" if "device_parts_ms" in r else "")
              + (f", device all {r['device_all_ms']:.5f} ms" if "device_all_ms" in r else "")
              + (f", library {r['library_ms']:.5f} ms" if "library_ms" in r else "")
              + (f", bound {r['bound'][0]:.5f} ms ({r['bound'][1]})" if "bound" in r else "")
              + (f", exact device {r['exact_device_ms']:.5f} ms" if "exact_device_ms" in r
                 else ""),
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
