#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (premvos_tpu_torch) on one CUDA card.

    python3 chip_smoke.py [--json PATH]     # from the root of a checkout

Phases (any failure raises and exits non-zero):
  1. the card's name and power limit (nvidia-smi);
  2. build the CUDA kernels from premvos_tpu_torch/kernels/*.cu with nvcc
     for sm_90a;
  3. hold each kernel against its plain PyTorch version (and the RoIAlign
     backward against the plain version's autograd) on the card at the
     shapes of its path (inference: configs/davis2017_val.json; training:
     ProposalConfig() at 480×864, batch 2), and time kernel, plain version,
     a PyTorch library call where one computes the same function, and the
     least time the card could take (bound); NMS also on clustered boxes
     (the sweep visits every box); multilevel RoIAlign also in float32 at
     C = 32 (the tiny configuration's shape, checked only); correlation
     with bf16 inputs (the path's), float32 inputs and, at a small size,
     stride 1 with max displacement 20 (D = 41); the RoIAlign backward also
     on 8-px boxes piled on one point of P2 (contention) and in one
     unfiltered launch on P2 whose largest RoIs are too large for the
     kernel's shared-memory tables (its second path);
  4. run a tiny configuration end to end on CUDA (kernels) and on the CPU
     (plain versions) with the same seeded weights: ≥ 99 % label agreement;
  5. run `run_sequence` at configs/davis2017_val.json with seeded random
     weights on 9 synthetic frames (one chunk): a warm-up run, then three
     timed runs; launch counters are zeroed just before the first timed run
     and read just after it, and every inference kernel must have launched;
  6. one Mask R-CNN training loss and its gradients at a tiny configuration
     on CUDA (kernels) and on the CPU (plain versions) from the same seeded
     weights: the loss within 1e-4 relative, every parameter's gradient
     within 1e-3 of that parameter's largest |grad|;
  7. Mask R-CNN training at full width (ProposalConfig() defaults, 480×864,
     batch 2, 8 object slots, Adam 1e-4, float32): one step through
     `train_maskrcnn` on an in-memory synthetic dataset, then 5 timed steps
     of `make_train_step` on one fixed batch from the same batch assembly;
     launch counters are zeroed just before the timed steps and read just
     after, every loss must be finite, the last below the first, and NMS,
     RoIAlign and its backward must have launched;
  8. the device time by kernel name (torch.profiler) of NMS (mask pass,
     sweep, and the sort and the rest of its wrapper apart), multilevel
     RoIAlign, correlation, resample2d and the training RoIAlign forward
     and backward (four launches a head) beside phase 3's wrapper times,
     on fresh inputs of the same shapes: last, because the end-to-end
     phases ran slower after a profiled run in the same process.

Prints the card line, a `{"kernels": [...]}` line, and last
`{"ok": true, "device": {...}}`; progress and every measurement go to
stderr, and with --json the whole report to PATH. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))

# Published peaks of one H100 SXM (dense): HBM bytes/s, float32 FLOP/s
# outside the tensor cores (most kernels' arithmetic type) and bf16 FLOP/s
# on the tensor cores (the correlation kernel's).
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
BF16_TC_FLOP_PER_S = 989e12

KERNELS = {
    "nms": ("premvos_tpu_torch/kernels/nms.cu", "premvos_tpu/ops/pallas/nms_pallas.py:70"),
    "multilevel_roi_align": (
        "premvos_tpu_torch/kernels/roi_align.cu",
        "premvos_tpu/ops/pallas/multilevel_roi_align_pallas.py:161",
    ),
    "correlation": (
        "premvos_tpu_torch/kernels/correlation.cu",
        "premvos_tpu/ops/pallas/correlation_pallas.py:58",
    ),
    "resample2d": (
        "premvos_tpu_torch/kernels/resample2d.cu",
        "premvos_tpu/ops/pallas/resample2d_pallas.py:109",
    ),
    "roi_align": (
        "premvos_tpu_torch/kernels/roi_align.cu",
        "premvos_tpu/ops/pallas/roi_align_pallas.py:103",
    ),
    # The JAX package has no backward kernel: training differentiates the
    # XLA einsum form.
    "roi_align_backward": (
        "premvos_tpu_torch/kernels/roi_align.cu",
        "premvos_tpu/ops/roi_align.py:113 (autodiff of roi_align_matmul)",
    ),
}

# The kernels each main path must launch: inference (phase 5) and training
# (phase 7).
INFERENCE_KERNELS = ("nms", "multilevel_roi_align", "correlation", "resample2d")
TRAINING_KERNELS = ("nms", "roi_align", "roi_align_backward")

# FPN levels P2..P5 at 480×864 and their strides.
LEVEL_SHAPES = [(120, 216), (60, 108), (30, 54), (15, 27)]
LEVEL_STRIDES = (4, 8, 16, 32)


def log(msg: str) -> None:
    print(f"[chip_smoke] {msg}", file=sys.stderr, flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of fn() in ms (CUDA events around `iters` calls)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(nbytes: float, flops: float, flop_per_s: float = FP32_FLOP_PER_S):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / flop_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def kernel_times(fn, iters: int = 50, need: tuple = (), wrapper=None, per_call: int = 1) -> dict:
    """{kernel name: mean device ms per call} of everything fn() runs on the
    card (torch.profiler over `iters` calls, after one warm-up call). Each
    kernel named by a pattern in `need` launches `per_call` times per call:
    `wrapper`'s launch counter, where given, must move by iters * per_call,
    so every one of those launches ran (a refused launch raises, a failed
    one fails the synchronize). A profile that then holds fewer records of a
    needed kernel than launches has lost records, not launches: it is logged
    and taken again, three times in all, and a third such profile fails."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for attempt in range(1, 4):
        fn()
        torch.cuda.synchronize()
        before = wrapper.launches if wrapper is not None else None
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        if wrapper is not None and wrapper.launches - before != iters * per_call:
            fail(f"{wrapper.__name__} launched {wrapper.launches - before} times in "
                 f"{iters} profiled calls of {per_call} launches")
        events = [ev for ev in prof.key_averages()
                  if ev.device_type == DeviceType.CUDA and ev.self_device_time_total > 0]
        times = {ev.key: ev.self_device_time_total / 1e3 / iters for ev in events}
        seen = {p: sum(ev.count for ev in events if p in ev.key) for p in need}
        short = {p: k for p, k in seen.items() if k < iters * per_call}
        if not short:
            return times
        log(f"profile {attempt}: {iters * per_call} launches, the profiler recorded {short} "
            "of the needed kernels (records lost)")
    fail(f"three profiles lost records of {sorted(short)}")


def named_ms(times: dict, pattern: str) -> float:
    """The device ms of the kernels whose name holds `pattern`; fails if
    there are none."""
    total = sum(ms for name, ms in times.items() if pattern in name)
    if total <= 0:
        fail(f"the profiler saw no device time of a kernel named *{pattern}*")
    return total


def device_ms(fn, pattern: str, iters: int = 50, wrapper=None, per_call: int = 1) -> float:
    """Mean device time per call of the kernels whose name holds `pattern`."""
    return named_ms(kernel_times(fn, iters, (pattern,), wrapper, per_call), pattern)


def nms_parts(times: dict) -> dict:
    """An NMS wrapper call's device ms by part: the mask pass and the sweep
    (the port's kernels), PyTorch's sort, and the rest (score masking,
    gathers and, where the wrapper still runs it, the compaction)."""
    parts = {"mask": named_ms(times, "nms_mask"), "sweep": named_ms(times, "nms_sweep")}
    parts["sort"] = sum(ms for name, ms in times.items() if "sort" in name.lower())
    parts["other"] = sum(times.values()) - sum(parts.values())
    return parts


def max_abs(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


# ------------------------------------------------------------- phase 3

def nms_inputs(torch, gen, b, n, clustered=False):
    """Boxes [b, n, 4] (xyxy) and scores [b, n] on the CPU over a 480×864
    image. Uniform: corners uniform, sides 4-204 px, so few pairs overlap
    above 0.7 and the RPN sweep keeps 256 boxes early. Clustered: each image
    holds 40 cluster boxes (sides 40-200 px) and every box is one of them
    jittered by 3 % of its size, as neighbouring anchors regressed onto one
    object are: most of a cluster is suppressed by its best box, fewer than
    256 boxes survive, and the sweep visits all n."""
    if not clustered:
        xy = torch.rand(b, n, 2, generator=gen) * torch.tensor([864.0, 480.0])
        wh = torch.rand(b, n, 2, generator=gen) * 200.0 + 4.0
    else:
        k = 40
        ctr = torch.rand(b, k, 2, generator=gen) * torch.tensor([864.0, 480.0])
        side = torch.rand(b, k, 2, generator=gen) * 160.0 + 40.0
        which = torch.randint(0, k, (b, n, 1), generator=gen).expand(b, n, 2)
        ctr, side = torch.gather(ctr, 1, which), torch.gather(side, 1, which)
        wh = side * (1.0 + 0.03 * torch.randn(b, n, 2, generator=gen))
        xy = ctr - wh / 2 + 0.03 * side * torch.randn(b, n, 2, generator=gen)
    boxes = torch.cat([xy, xy + wh], -1)
    return boxes, torch.rand(b, n, generator=gen)


# The NMS rows of phase 3: (B, N, max_outputs, IoU threshold, score
# threshold, clustered): the RPN's, the detection's, and the RPN's on
# clustered boxes (drawn from a generator of its own, so the other rows'
# inputs stay those of earlier runs).
NMS_CASES = ((8, 2384, 256, 0.7, 0.0, False), (8, 256, 32, 0.5, 0.05, False),
             (8, 2384, 256, 0.7, 0.0, True))


def check_nms(torch, gen, dev, case):
    from premvos_tpu_torch.ops.nms import nms_cuda, nms_reference

    b, n, k, thr, score_thr, clustered = case
    boxes, scores = (t.to(dev) for t in nms_inputs(torch, gen, b, n, clustered))
    got = nms_cuda(boxes, scores, k, thr, score_thr)
    want = nms_reference(boxes, scores, k, thr, score_thr)
    if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
        fail(f"nms {case}: kernel indices differ from the plain version")
    err = float((got[0] - want[0]).abs().max())
    ms = cuda_ms(lambda: nms_cuda(boxes, scores, k, thr, score_thr), 20)
    plain = cuda_ms(lambda: nms_reference(boxes, scores, k, thr, score_thr), 2, warmup=1)
    # Ops: the IoUs (≈12 float32 flops each) greedy NMS needs on this data —
    # each kept box against every later box up to the last box the sweep
    # visits (the max_outputs-th kept one, else the last). Bytes: boxes and
    # scores read once, indices and keep written once.
    rank = torch.argsort(torch.sort(-scores, dim=-1, stable=True).indices, dim=-1)
    pairs = 0
    for img in range(b):
        pos = rank[img][want[0][img][want[1][img]].long()].cpu()
        last = int(pos[-1]) if len(pos) == k else n - 1
        pairs += int((last - pos).sum())
    bnd = bound_ms(b * n * 20 + b * k * 5, pairs * 12)
    return dict(shape=f"boxes [{b},{n},4]{' clustered' if clustered else ''}, keep {k}, "
                      f"iou {thr}",
                max_abs_err=err, tol="exact", ms=ms, plain_ms=plain, bound=bnd,
                library_ms=None, kept=int(want[1].sum()), pairs=pairs)


def level_shapes(image_hw):
    return [(image_hw[0] // st, image_hw[1] // st) for st in LEVEL_STRIDES]


def roi_case(torch, gen, dev, b, n_rois, c, dtype, image_hw=(480, 864)):
    """P2..P5 features [b, H, W, c] of an image_hw image and boxes of
    log-uniform size (8 to 720 px) over the image, with their levels."""
    from premvos_tpu_torch.models.maskrcnn import roi_levels

    ih, iw = image_hw
    feats = [torch.randn(b, h, w, c, generator=gen).to(dev, dtype)
             for h, w in level_shapes(image_hw)]
    size = torch.exp(torch.rand(b, n_rois, 1, generator=gen) * 4.5) * 8.0
    ctr = torch.rand(b, n_rois, 2, generator=gen) * torch.tensor([float(iw), float(ih)])
    boxes = torch.cat([ctr - size / 2, ctr + size / 2], -1).clamp(0, iw).to(dev)
    return feats, boxes, roi_levels(boxes)


def sampled_pixels(torch, boxes, levels, p, s=2, image_hw=(480, 864)) -> int:
    """How many feature pixels (over all images and levels) the boxes'
    bilinear taps touch, each RoI on its own level."""
    dev = boxes.device
    touched = 0
    for li, ((h, w), stride) in enumerate(zip(level_shapes(image_hw), LEVEL_STRIDES)):
        on = levels == li + 2
        bx = boxes * (1.0 / stride) - 0.5
        g = (torch.arange(p * s, device=dev, dtype=torch.float32) + 0.5) / (p * s)
        ys = bx[..., 1:2] + g * (bx[..., 3:4] - bx[..., 1:2]).clamp(min=1e-6)
        xs = bx[..., 0:1] + g * (bx[..., 2:3] - bx[..., 0:1]).clamp(min=1e-6)
        y0 = ys.clamp(0, h - 1).floor().long()
        x0 = xs.clamp(0, w - 1).floor().long()
        for img in range(boxes.shape[0]):
            mask = torch.zeros(h, w, dtype=torch.bool, device=dev)
            for yy in (y0[img], (y0[img] + 1).clamp(max=h - 1)):
                for xx in (x0[img], (x0[img] + 1).clamp(max=w - 1)):
                    sel = on[img]
                    idx = yy[sel][:, :, None] * w + xx[sel][:, None, :]
                    mask.view(-1)[idx.reshape(-1)] = True
            touched += int(mask.sum())
    return touched


# The multilevel RoIAlign rows of phase 3: (B, RoIs per image, P, C,
# dtype, image): the box head's and the mask head's at davis2017_val, and
# the tiny configuration's box head (float32, C = 32, checked only).
ROI_CASES = ((8, 256, 7, 256, "bfloat16", (480, 864)), (8, 32, 14, 256, "bfloat16", (480, 864)),
             (2, 8, 7, 32, "float32", (96, 128)))


def roi_inputs(torch, gen, dev, case):
    b, n_rois, _, c, dtype, image_hw = case
    return roi_case(torch, gen, dev, b, n_rois, c, getattr(torch, dtype), image_hw)


def check_roi_align(torch, gen, dev, case, timed=True):
    from premvos_tpu_torch.ops.roi_align import (
        multilevel_roi_align_cuda,
        multilevel_roi_align_reference,
    )

    b, n_rois, p, c, dtype, image_hw = case
    feats, boxes, levels = roi_inputs(torch, gen, dev, case)
    got = multilevel_roi_align_cuda(feats, boxes, levels, p, 2)
    want = multilevel_roi_align_reference(feats, boxes, levels, p, 2)
    err = max_abs(got, want)
    # float32: the sums differ only in order. bf16 output: allow 2 ulp at
    # the largest magnitude (the two sides round differently-ordered float32
    # sums).
    tol = 1e-5 if dtype == "float32" else 2.0 ** -7 * float(want.float().abs().max())
    if not err <= tol:
        fail(f"multilevel_roi_align {case}: max |diff| {err} > {tol}")
    row = dict(shape=f"P2..P5 {dtype} [{b},H,W,{c}] of {image_hw[0]}x{image_hw[1]}, "
                     f"{n_rois} RoIs/image, P={p}",
               max_abs_err=err, tol=tol, library_ms=None)
    if not timed:
        return row
    row["ms"] = cuda_ms(lambda: multilevel_roi_align_cuda(feats, boxes, levels, p, 2), 20)
    row["plain_ms"] = cuda_ms(
        lambda: multilevel_roi_align_reference(feats, boxes, levels, p, 2), 3, warmup=1
    )
    # Bytes: the feature pixels this run's boxes sample (each once), boxes,
    # and the output. Ops: 4 taps × 2 + 2 per sample per channel.
    s, size = 2, feats[0].element_size()
    touched = sampled_pixels(torch, boxes, levels, p, s, image_hw)
    nbytes = touched * c * size + boxes.numel() * 4 + got.numel() * size
    flops = b * n_rois * p * p * c * s * s * 10
    row["bound"] = bound_ms(nbytes, flops)
    return row


# The training RoIAlign forward rows of phase 3: (P, dtype).
TRAIN_ALIGN_CASES = ((7, "float32"), (14, "float32"), (7, "bfloat16"))


def check_roi_align_train(torch, gen, dev, p, dtype):
    """The training align's forward (ops/roi_align.py::roi_align_levels on
    CUDA: the single-level kernel once per level P2..P5, each launch on the
    RoIs of its level, into one output) vs its plain version."""
    from premvos_tpu_torch.ops.roi_align import multilevel_roi_align_reference, roi_align_levels

    b, n, c, s = 2, 256, 256, 2
    feats, boxes, levels = roi_case(torch, gen, dev, b, n, c, dtype)
    got = roi_align_levels(feats, boxes, levels, p, s)
    want = multilevel_roi_align_reference(feats, boxes, levels, p, s)
    err = max_abs(got, want)
    # float32: the sums differ only in order. bf16 output: 2 ulp at the
    # largest magnitude.
    tol = 1e-5 if dtype == torch.float32 else 2.0 ** -7 * float(want.float().abs().max())
    if not err <= tol:
        fail(f"roi_align {dtype} P={p}: max |diff| {err} > {tol}")
    ms = cuda_ms(lambda: roi_align_levels(feats, boxes, levels, p, s), 20)
    plain = cuda_ms(lambda: multilevel_roi_align_reference(feats, boxes, levels, p, s), 3, warmup=1)
    # Bytes: the sampled feature pixels (each once), boxes, levels, output.
    # Ops: 4 taps × 2 + 2 per sample per channel.
    size = feats[0].element_size()
    nbytes = (sampled_pixels(torch, boxes, levels, p, s) * c * size + b * n * 20
              + got.numel() * size)
    flops = b * n * p * p * c * s * s * 10
    return dict(shape=f"P2..P5 {str(dtype)[6:]} [2,H,W,256], 256 RoIs/image, P={p}, "
                      "4 launches (one per level)",
                max_abs_err=err, tol=tol, ms=ms, plain_ms=plain,
                bound=bound_ms(nbytes, flops), library_ms=None)


# The RoIAlign backward rows of phase 3 beyond the two dense ones: (P, kind).
# "contention": 256 RoIs per image of about 8 px around one point, all on P2
# (hundreds of taps add into each pixel of a few); "unfiltered": one
# unfiltered single-level launch on P2 over the log-uniform boxes, whose
# large RoIs' footprints are too large for the kernel's shared-memory table
# (the second path) while the small ones take the first.
BACKWARD_CASES = ((14, "contention"), (14, "unfiltered"))


def footprint_sides(torch, boxes, p, s, stride, hw):
    """Per RoI, the sides (fh, fw) of the rectangle of level pixels its
    sample taps span on a level of `stride` (the backward's footprint)."""
    bx = boxes.double() / stride - 0.5
    g = (torch.arange(p * s, dtype=torch.float64, device=boxes.device) + 0.5) / (p * s)
    sides = []
    for lo, hi, size in ((1, 3, hw[0]), (0, 2, hw[1])):
        c = bx[..., lo:lo + 1] + g * (bx[..., hi:hi + 1] - bx[..., lo:lo + 1]).clamp(min=1e-6)
        c = c.clamp(0, size - 1)
        sides.append((c.max(-1).values.floor() + 1).clamp(max=size - 1)
                     - c.min(-1).values.floor() + 1)
    return sides


def second_path(fh, fw, p):
    """Whether the backward kernel sends a footprint down its second path:
    P * max(fh, fw) above kWRows = 2048 or a side above kMaxSpan = 512
    (kernels/roi_align.cu)."""
    import torch

    return (p * torch.maximum(fh, fw) > 2048) | (torch.maximum(fh, fw) > 512)


def backward_inputs(torch, gen, dev, p, kind="dense"):
    """Features, boxes, levels and an output gradient for a backward row:
    phase 3's training shapes (P2..P5 float32 [2, H, W, 256] of 480×864,
    256 RoIs per image), with the boxes of `kind`."""
    from premvos_tpu_torch.models.maskrcnn import roi_levels

    b, n, c = 2, 256, 256
    feats, boxes, levels = roi_case(torch, gen, dev, b, n, c, torch.float32)
    if kind == "contention":
        ctr = torch.tensor([432.0, 240.0]) + torch.rand(b, n, 2, generator=gen) * 12.0
        half = 4.0 + torch.rand(b, n, 1, generator=gen)
        boxes = torch.cat([ctr - half, ctr + half], -1).to(dev)
        levels = roi_levels(boxes)
    grad_out = torch.randn(b, n, p, p, c, generator=gen).to(dev)
    return feats, boxes, levels, grad_out


def backward_run(torch, boxes, levels, grad_out, p, kind="dense"):
    """The backward launches of a row: training's backward (one launch per
    level with the level filter), or one unfiltered launch on P2."""
    from premvos_tpu_torch.ops.roi_align import roi_align_backward_cuda, roi_align_levels_backward

    if kind == "unfiltered":
        return [roi_align_backward_cuda(grad_out, boxes, LEVEL_SHAPES[0], 2, 0.25)]
    return roi_align_levels_backward(grad_out, boxes, levels, LEVEL_SHAPES, 2)


def check_roi_align_backward(torch, gen, dev, p, kind="dense"):
    """The backward kernel vs the autograd of the plain version; each
    level's gradient within 1e-4 of its largest |grad| (float32 atomics add
    in a varying order)."""
    from premvos_tpu_torch.ops.roi_align import multilevel_roi_align_reference, roi_align_reference

    b, n, c, s = 2, 256, 256, 2
    feats, boxes, levels, grad_out = backward_inputs(torch, gen, dev, p, kind)
    run = lambda: backward_run(torch, boxes, levels, grad_out, p, kind)  # noqa: E731
    got = run()
    if kind == "unfiltered":
        big = second_path(*footprint_sides(torch, boxes, p, s, 4, LEVEL_SHAPES[0]), p)
        if not (0 < int(big.sum()) < big.numel()):
            fail(f"roi_align_backward unfiltered: {int(big.sum())} of {big.numel()} RoIs "
                 "take the second path; the row needs both paths")
        leaves = [feats[0].clone().requires_grad_(True)]
        out = roi_align_reference(leaves[0], boxes, p, s, 0.25)
    else:
        leaves = [f.clone().requires_grad_(True) for f in feats]
        out = multilevel_roi_align_reference(leaves, boxes, levels, p, s)
    want = torch.autograd.grad(out, leaves, grad_out, retain_graph=True)
    err = 0.0
    for li, (g, w) in enumerate(zip(got, want)):
        e, tol = max_abs(g, w), 1e-4 * float(w.abs().max())
        if not e <= tol:
            fail(f"roi_align_backward P={p} {kind}, level P{li + 2}: max |diff| {e} > {tol}")
        err = max(err, e)
    ms = cuda_ms(run, 20)
    plain = cuda_ms(lambda: torch.autograd.grad(out, leaves, grad_out, retain_graph=True), 3,
                    warmup=1)
    # Bytes: the output gradient read once, boxes and levels, and every
    # element of the float32 feature gradients written once (the zero fill;
    # the sampled pixels are among them). Ops: 4 taps × (2 mul + 1 add) per
    # sample per channel. Beside them, the bytes the kernel's vector atomics
    # move: each RoI's footprint (on its level) once.
    nbytes = grad_out.numel() * 4 + b * n * 20 + sum(g.numel() for g in got) * 4
    flops = b * n * p * p * c * s * s * 12
    if kind == "unfiltered":
        fh, fw = footprint_sides(torch, boxes, p, s, 4, LEVEL_SHAPES[0])
        fp = fh * fw
        shape = f"grad [2,256,{p},{p},256] f32 → P2 [2,120,216,256] f32, 1 unfiltered launch"
    else:
        fp = 0
        for li, (hw, st) in enumerate(zip(LEVEL_SHAPES, LEVEL_STRIDES)):
            fh, fw = footprint_sides(torch, boxes, p, s, st, hw)
            fp = fp + (fh * fw)[levels == li + 2].sum()
        shape = (f"grad [2,256,{p},{p},256] f32 → P2..P5 [2,H,W,256] f32, 4 launches "
                 f"(one per level){', 8-px boxes on P2' if kind == 'contention' else ''}")
    return dict(shape=shape, max_abs_err=err, tol="1e-4 of each level's max |grad|", ms=ms,
                plain_ms=plain, bound=bound_ms(nbytes, flops), library_ms=None,
                footprint_bytes=int(fp.sum()) * c * 4)


def corr_bmm(torch, f1, f2, md, stride):
    """The cost volume as 21 batched matmuls + a diagonal gather (a PyTorch
    formulation timed as a yardstick; the port never calls it)."""
    import torch.nn.functional as F

    b, c, h, w = f1.shape
    d = 2 * (md // stride) + 1
    f2p = F.pad(f2, (md, md, md, md))
    a = f1.permute(0, 2, 3, 1).reshape(b * h, w, c)
    cols = torch.arange(w, device=f1.device)[:, None] + torch.arange(d, device=f1.device) * stride
    out = []
    for i in range(d):
        rows = f2p[:, :, i * stride:i * stride + h].permute(0, 2, 1, 3).reshape(b * h, c, -1)
        m = torch.bmm(a, rows)  # [B·H, W, W + 2md]
        out.append(torch.gather(m, 2, cols.expand(b * h, w, d)))
    vol = torch.stack(out, 2).reshape(b, h, w, d * d) / c
    return vol.permute(0, 3, 1, 2)


# The correlation rows (input dtype, (B, C, H, W, max displacement,
# stride)) and the resample2d rows (B, C, H, W, src dtype) of phase 3.
CORR_CASES = (("bfloat16", (8, 256, 56, 104, 20, 2)), ("float32", (8, 256, 56, 104, 20, 2)),
              ("float32", (2, 64, 24, 48, 20, 1)))
RESAMPLE_CASES = ((8, 3, 448, 832, "bfloat16"), (1, 8, 240, 432, "float32"))


def corr_inputs(torch, gen, dev, dtype, case):
    """f1, f2 [B, C, H, W] channels-last, as FlowNetC gives them."""
    b, c, h, w = case[:4]
    return [torch.randn(b, h, w, c, generator=gen).to(dev, dtype).permute(0, 3, 1, 2)
            for _ in range(2)]


def resample_inputs(torch, gen, dev, b, c, h, w, dtype):
    """src, a smooth flow with noise, and the same sample points as
    grid_sample's grid (border padding, align_corners=True: the same clamped
    bilinear warp on float32 input)."""
    src = torch.rand(b, c, h, w, generator=gen).to(dev, dtype)
    yy, xx = torch.meshgrid(torch.arange(h), torch.arange(w), indexing="ij")
    smooth = torch.stack([9.0 + 30 * torch.sin(yy / 40.0), -6.0 + 20 * torch.cos(xx / 50.0)])
    flow = (smooth[None] + torch.randn(b, 2, h, w, generator=gen)).to(dev)
    gx = (torch.arange(w, device=dev) + flow[:, 0]) / (w - 1) * 2 - 1
    gy = (torch.arange(h, device=dev)[:, None] + flow[:, 1]) / (h - 1) * 2 - 1
    return src, flow, torch.stack([gx, gy], -1)


def check_correlation(torch, gen, dev, dtype, case):
    """The kernel with `dtype` inputs (channels-last, as FlowNetC gives them)
    vs the plain version on their float32 values, atol 1e-5. Bound: for bf16
    inputs the least time of the call (bytes, or the products on the tensor
    cores); for float32 inputs the yardstick the first kernel was held to,
    the products as float32 FMAs outside the tensor cores, with the byte
    bound beside it."""
    from premvos_tpu_torch.ops.correlation import correlation_cuda, correlation_reference

    b, c, h, w, md, st = case
    f1, f2 = corr_inputs(torch, gen, dev, dtype, case)
    got = correlation_cuda(f1, f2, md, st)
    want = correlation_reference(f1, f2, md, st)
    err = max_abs(got, want)
    tol = 1e-5
    if not err <= tol:
        fail(f"correlation {dtype} {case}: max |diff| {err} > {tol}")
    ms = cuda_ms(lambda: correlation_cuda(f1, f2, md, st), 20)
    plain = cuda_ms(lambda: correlation_reference(f1, f2, md, st), 3, warmup=1)
    d2 = (2 * (md // st) + 1) ** 2
    nbytes = 2 * b * c * h * w * f1.element_size() + b * d2 * h * w * 4
    flops = 2.0 * b * h * w * d2 * c
    row = dict(shape=f"f1, f2 [{b},{c},{h},{w}] {str(dtype)[6:]} → [{b},{d2},{h},{w}], "
                     f"md {md}, stride {st}",
               max_abs_err=err, tol=tol, ms=ms, plain_ms=plain, library_ms=None)
    if dtype == torch.bfloat16:
        row["bound"] = bound_ms(nbytes, flops, BF16_TC_FLOP_PER_S)
    else:
        row["bound"] = bound_ms(nbytes, flops)
        row["bound_bytes_ms"] = nbytes / HBM_BYTES_PER_S * 1e3
        prev_tf32 = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        row["bmm_formulation_err"] = max_abs(corr_bmm(torch, f1, f2, md, st), want)
        row["bmm_formulation_ms"] = cuda_ms(lambda: corr_bmm(torch, f1, f2, md, st), 5)
        torch.backends.cuda.matmul.allow_tf32 = prev_tf32
    return row


def check_resample(torch, gen, dev, b, c, h, w, dtype):
    import torch.nn.functional as F

    from premvos_tpu_torch.ops.resample2d import resample2d_cuda, resample2d_reference

    src, flow, grid = resample_inputs(torch, gen, dev, b, c, h, w, dtype)
    got = resample2d_cuda(src, flow)
    want = resample2d_reference(src, flow)
    err = max_abs(got, want)
    tol = 1e-5
    if not err <= tol:
        fail(f"resample2d {src.shape}: max |diff| {err} > {tol}")
    ms = cuda_ms(lambda: resample2d_cuda(src, flow), 50)
    plain = cuda_ms(lambda: resample2d_reference(src, flow), 10)
    srcf = src.float()

    def lib():
        return F.grid_sample(srcf, grid, "bilinear", "border", align_corners=True)

    lib_err = max_abs(lib(), want)
    lib_ms = cuda_ms(lib, 50)
    nbytes = src.numel() * src.element_size() + flow.numel() * 4 + got.numel() * 4
    flops = b * c * h * w * 8.0
    return dict(shape=f"src [{b},{c},{h},{w}] {str(dtype)[6:]}, flow f32",
                max_abs_err=err, tol=tol, ms=ms, plain_ms=plain,
                bound=bound_ms(nbytes, flops), library_ms=lib_ms, library_err=lib_err)


# ------------------------------------------------------------- phase 8

def device_times(torch, dev, checks) -> None:
    """The kernels' own device time by name (torch.profiler) for the timed
    rows of phase 3, on fresh inputs of each row's shape: NMS by part (mask
    pass, sweep, sort, the rest), multilevel RoIAlign, correlation,
    resample2d and grid_sample, and the training RoIAligns (the four
    launches of a head; for the backward also with its zero fill). It runs
    last: a profiled run leaves the card's activity tracing set up in the
    process, and the end-to-end phases after it ran slower (PERF.md,
    section 6)."""
    import torch.nn.functional as F

    from premvos_tpu_torch.ops.correlation import correlation_cuda
    from premvos_tpu_torch.ops.nms import nms_cuda
    from premvos_tpu_torch.ops.resample2d import resample2d_cuda
    from premvos_tpu_torch.ops.roi_align import (
        multilevel_roi_align_cuda,
        roi_align_backward_cuda,
        roi_align_cuda,
        roi_align_levels,
    )

    gen = torch.Generator().manual_seed(1)
    for row, (b, n, k, thr, sthr, clustered) in zip(checks["nms"], NMS_CASES):
        boxes, scores = (t.to(dev) for t in nms_inputs(torch, gen, b, n, clustered))
        parts = nms_parts(kernel_times(lambda: nms_cuda(boxes, scores, k, thr, sthr), 20,
                                       ("nms_mask", "nms_sweep"), nms_cuda))
        row["device_parts_ms"] = parts
        row["device_ms"] = parts["mask"] + parts["sweep"]
    for row, case in zip(checks["multilevel_roi_align"], ROI_CASES[:2]):
        feats, boxes, levels = roi_inputs(torch, gen, dev, case)
        row["device_ms"] = device_ms(
            lambda: multilevel_roi_align_cuda(feats, boxes, levels, case[2], 2), "multilevel", 20,
            multilevel_roi_align_cuda)
    for row, (dtype, case) in zip(checks["correlation"], CORR_CASES):
        f1, f2 = corr_inputs(torch, gen, dev, getattr(torch, dtype), case)
        row["device_ms"] = device_ms(lambda: correlation_cuda(f1, f2, *case[4:]), "corr", 20,
                                     correlation_cuda)
    for row, (b, c, h, w, dtype) in zip(checks["resample2d"], RESAMPLE_CASES):
        src, flow, grid = resample_inputs(torch, gen, dev, b, c, h, w, getattr(torch, dtype))
        srcf = src.float()
        row["device_ms"] = device_ms(lambda: resample2d_cuda(src, flow), "resample",
                                     wrapper=resample2d_cuda)
        row["library_device_ms"] = device_ms(
            lambda: F.grid_sample(srcf, grid, "bilinear", "border", align_corners=True),
            "grid_sampler")
    # The training RoIAligns, added later: a generator of their own.
    gen = torch.Generator().manual_seed(2)
    for row, (p, dtype) in zip(checks["roi_align"], TRAIN_ALIGN_CASES):
        feats, boxes, levels = roi_case(torch, gen, dev, 2, 256, 256, getattr(torch, dtype))
        row["device_ms"] = device_ms(
            lambda: roi_align_levels(feats, boxes, levels, p, 2), "single_kernel", 20,
            roi_align_cuda, per_call=4)
    for row, (p, kind) in zip(checks["roi_align_backward"],
                              ((7, "dense"), (14, "dense"), *BACKWARD_CASES)):
        _, boxes, levels, grad_out = backward_inputs(torch, gen, dev, p, kind)
        times = kernel_times(lambda: backward_run(torch, boxes, levels, grad_out, p, kind), 20,
                             ("backward_kernel",), roi_align_backward_cuda,
                             per_call=1 if kind == "unfiltered" else 4)
        row["device_ms"] = named_ms(times, "backward_kernel")
        row["device_all_ms"] = sum(times.values())  # with the gradients' zero fill


# ------------------------------------------------------------- phase 4

def tiny_config():
    from premvos_tpu_torch import config as tc

    return tc.PremvosConfig(
        proposal=tc.ProposalConfig(
            backbone_depth=26, fpn_channels=32, rpn_pre_nms_topk=32,
            rpn_post_nms_topk=8, detections_per_frame=4,
        ),
        refine=tc.RefineConfig(crop_size=33, backbone_depth=26),
        flow=tc.FlowConfig(variant="flownet2", max_displacement=4,
                           infer_height=64, infer_width=64),
        reid=tc.ReIDConfig(backbone_depth=26, embedding_dim=8, crop_size=32),
        merge=tc.MergeConfig(warp_stride=2, new_object_score_floor=0.9),
        pipeline=tc.PipelineConfig(
            image_height=96, image_width=128, max_objects=2, max_proposals=4,
            dtype="float32", scan_chunk=2,
        ),
    )


def synthetic_video(np, t, h, w, k, seed):
    """Smooth background + textured rectangles drifting a few pixels per
    frame; masks of the first frame's rectangles (K slots, 2 used)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    base = np.stack([128 + 60 * np.sin(xx / 37.0), 128 + 60 * np.cos(yy / 23.0),
                     128 + 40 * np.sin((xx + yy) / 51.0)], -1)
    objs = [(h // 5, w // 6, h // 3, w // 4, (-3, 2)), (h // 2, w // 2, h // 3, w // 3, (2, -3))]
    frames = np.zeros((t, h, w, 3), np.float32)
    gt = np.zeros((k, h, w), np.float32)
    for f in range(t):
        img = base.copy()
        for i, (y, x, hh, ww, (dy, dx)) in enumerate(objs):
            y0, x0 = y + dy * f, x + dx * f
            tex = rng.uniform(0, 255, (hh, ww, 3)) * 0.3 + 150 * (i + 1) % 255
            img[y0:y0 + hh, x0:x0 + ww] = tex
            if f == 0:
                gt[i, y0:y0 + hh, x0:x0 + ww] = 1.0
        frames[f] = img + rng.normal(0, 4, img.shape)
    return np.clip(frames, 0, 255).astype(np.uint8), gt


# ------------------------------------------------------------- phase 6

def tiny_train_case(np, torch):
    """The tiny Mask R-CNN (seeded weights, RPN delta head zeroed) on the
    CPU, its anchors, and a batch of two 64×64 images with two GT slots
    (the second of image 1 padded). Returns (cfg, hw, model, anchors,
    batch)."""
    from premvos_tpu_torch import config as tc
    from premvos_tpu_torch.models.anchors import pyramid_anchors
    from premvos_tpu_torch.models.layers import init_module
    from premvos_tpu_torch.models.maskrcnn import MaskRCNN

    cfg = tc.ProposalConfig(backbone_depth=26, fpn_channels=32, rpn_pre_nms_topk=64,
                            rpn_post_nms_topk=16, detections_per_frame=8)
    hw = (64, 64)
    model = MaskRCNN(cfg)
    init_module(model, torch.Generator().manual_seed(0))
    # A zero RPN delta head makes the proposals the clipped anchors on both
    # devices, so float32 noise in the deltas cannot move the RoIs.
    with torch.no_grad():
        for t in model.rpn.Conv_2.parameters():
            t.zero_()
    anchors = {k: torch.from_numpy(v)
               for k, v in pyramid_anchors(*hw, cfg.anchor_scales, cfg.anchor_ratios).items()}
    # GT boxes are some of the model's own largest proposals, so foreground
    # RoIs (and with them the box and mask losses) exist.
    rng = np.random.default_rng(4)
    images = torch.from_numpy(rng.standard_normal((2, *hw, 3)).astype(np.float32))
    with torch.no_grad():
        rois = model.proposals(model.features(images.permute(0, 3, 1, 2)), anchors, hw)[0]
    sizes = (rois[..., 2] - rois[..., 0]) * (rois[..., 3] - rois[..., 1])
    gt_boxes = torch.zeros(2, 2, 4)
    gt_valid = torch.tensor([[True, True], [True, False]])
    gt_masks = torch.zeros(2, 2, *hw)
    for i in range(2):
        for j in range(int(gt_valid[i].sum())):
            gt_boxes[i, j] = torch.round(rois[i, torch.argsort(-sizes[i])[j]])
            x1, y1, x2, y2 = gt_boxes[i, j].long().tolist()
            gt_masks[i, j, y1:y2, x1 + 1:x2 - 1] = 1.0
    return cfg, hw, model, anchors, (images, gt_boxes, gt_masks, gt_valid)


def tiny_loss_grads(torch, case, device: str):
    """The training loss of `case` on `device` and every parameter's
    gradient (float32 on the CPU), with TF32 off."""
    import copy

    from premvos_tpu_torch.pipeline.runner import float32_precision, place
    from premvos_tpu_torch.train.detection import maskrcnn_loss_fn

    cfg, hw, model, anchors, batch = case
    m = place(copy.deepcopy(model), torch.device(device)).train()
    anc = {k: v.to(device) for k, v in anchors.items()}
    with float32_precision():
        loss = maskrcnn_loss_fn(m, anc, cfg, hw)(tuple(x.to(device) for x in batch))
        loss.backward()
    return loss.item(), {n: t.grad.detach().float().cpu() for n, t in m.named_parameters()}


def grad_ratios(got: dict, want: dict) -> list:
    """[(max |got − want| / max |want|, name)] per parameter, worst first."""
    out = []
    for name, w in want.items():
        scale = max(float(w.abs().max()), 1e-12)
        out.append((float((got[name] - w).abs().max()) / scale, name))
    return sorted(out, reverse=True)


def tiny_train_parity(np, torch):
    """One loss and its gradients of the tiny Mask R-CNN on CUDA and on the
    CPU from the same seeded weights and batch. Returns a report dict."""
    case = tiny_train_case(np, torch)
    lc, gc = tiny_loss_grads(torch, case, "cuda")
    lp, gp = tiny_loss_grads(torch, case, "cpu")
    rel = abs(lc - lp) / abs(lp)
    if not (np.isfinite(lc) and rel <= 1e-4):
        fail(f"tiny training loss: CUDA {lc} vs CPU {lp} (relative {rel} > 1e-4)")
    ratios = grad_ratios(gc, gp)
    if not ratios[0][0] <= 1e-3:
        fail(f"tiny training gradient {ratios[0][1]}: max |diff| {ratios[0][0]} of its "
             "max |grad| > 1e-3")
    if not any(n.startswith("mask_head.") and float(g.abs().max()) > 0 for n, g in gp.items()):
        fail("tiny training: the mask loss gave no gradient")
    return dict(loss_cuda=lc, loss_cpu=lp, loss_rel_diff=rel, worst_grad_ratios=ratios[:5])


# ------------------------------------------------------------- phase 7

class SyntheticDavis:
    """An in-memory dataset with the DAVIS reader's interface (`.sequences`,
    `.load_sequence(seq, h, w, max_objects)`): each sequence is one
    annotated frame of `synthetic_video`, seeded by its index."""

    def __init__(self, np, n_sequences: int = 2):
        self.np = np
        self.sequences = [f"synthetic_{i}" for i in range(n_sequences)]

    def load_sequence(self, seq, h, w, max_objects):
        np = self.np
        frames, gt = synthetic_video(np, 1, h, w, max_objects, seed=10 + self.sequences.index(seq))
        ids = np.arange(1, max_objects + 1)[:, None, None]
        labels = (ids * (gt > 0.5)).max(0).astype(np.int32)
        return {"frames": frames, "gt_labels": labels[None]}


def train_full_width(np, torch, wrappers, n_steps: int = 5):
    """Mask R-CNN training at ProposalConfig() defaults, 480×864, batch 2,
    8 object slots: one step through `train_maskrcnn`, then `n_steps` timed
    steps on one fixed batch. Returns a report dict."""
    from premvos_tpu_torch.config import ProposalConfig
    from premvos_tpu_torch.models.anchors import pyramid_anchors
    from premvos_tpu_torch.train.detection import maskrcnn_loss_fn
    from premvos_tpu_torch.train.train_maskrcnn import sample_batch, train_maskrcnn
    from premvos_tpu_torch.train.trainer import create_train_state, make_train_step

    cfg, hw, slots, bs = ProposalConfig(), (480, 864), 8, 2
    dev = torch.device("cuda")
    ds = SyntheticDavis(np)
    t0 = time.perf_counter()
    model, warm_loss = train_maskrcnn(ds, cfg, image_hw=hw, max_objects=slots, steps=1,
                                      batch_size=bs, seed=0, log_every=0)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    if not np.isfinite(warm_loss):
        fail(f"training warm-up step: loss {warm_loss}")
    anchors = {k: torch.from_numpy(v).to(dev)
               for k, v in pyramid_anchors(*hw, cfg.anchor_scales, cfg.anchor_ratios).items()}
    state = create_train_state(model, 1e-4)
    step = make_train_step(maskrcnn_loss_fn(model, anchors, cfg, hw), state.optimizer)
    batch = sample_batch(ds, np.random.default_rng(1), hw, slots, bs, dev)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fn in wrappers.values():
        fn.launches = 0
    # The steps run back to back as in train_maskrcnn, which reads no loss
    # between steps; CUDA events between steps give each step's span on the
    # device's timeline, idle gaps included.
    events = [torch.cuda.Event(enable_timing=True) for _ in range(n_steps + 1)]
    out = []
    t0 = time.perf_counter()
    events[0].record()
    for i in range(n_steps):
        out.append(step(batch))
        events[i + 1].record()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in wrappers.items()}
    peak = torch.cuda.max_memory_allocated()
    times = [a.elapsed_time(b) / 1e3 for a, b in zip(events, events[1:])]
    losses = [float(x) for x in out]
    if not all(np.isfinite(x) for x in losses):
        fail(f"training losses not finite: {losses}")
    if not losses[-1] < losses[0]:
        fail(f"training loss did not fall over {n_steps} steps on one batch: {losses}")
    missing = [k for k in TRAINING_KERNELS if launches[k] <= 0]
    if missing:
        fail(f"kernels not launched on the training path: {missing}")
    med = statistics.median(times)
    return dict(config="ProposalConfig() (R101-FPN, 256 ch, 256 RoIs/image), 480x864, "
                       "batch 2, 8 slots, Adam 1e-4, float32 without TF32",
                first_step_s_incl_init=first_s, warmup_loss=warm_loss, losses=losses,
                step_s=times, median_s_per_step=med, images_per_s=bs / med,
                wall_s_per_step=wall / n_steps, peak_bytes=peak, launches=launches)


def main() -> int:
    ap = argparse.ArgumentParser(description="Smoke test of the port on one CUDA card.")
    ap.add_argument("--json", help="also write the full report (JSON) here")
    args = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(REPO, "premvos_tpu_torch")):
        print("chip_smoke: run from a checkout (premvos_tpu_torch/ missing)", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from premvos_tpu_torch import kernels
    from premvos_tpu_torch.config import load_config
    from premvos_tpu_torch.ops import correlation, nms, resample2d, roi_align
    from premvos_tpu_torch.pipeline.runner import build_models, init_params, run_sequence, stages_batch, get_anchors

    wrappers = {
        "nms": nms.nms_cuda,
        "multilevel_roi_align": roi_align.multilevel_roi_align_cuda,
        "correlation": correlation.correlation_cuda,
        "resample2d": resample2d.resample2d_cuda,
        "roi_align": roi_align.roi_align_cuda,
        "roi_align_backward": roi_align.roi_align_backward_cuda,
    }
    report = {}

    # Phase 1 — the card.
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    report["card"] = smi
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")

    # Phase 2 — build.
    t0 = time.perf_counter()
    lib_path = kernels.build()
    kernels.load()
    report["build_s"] = time.perf_counter() - t0
    log(f"built {os.path.basename(lib_path)} in {report['build_s']:.1f} s")
    with open(lib_path.replace("libpremvos_kernels_", "ptxas_").replace(".so", ".log")) as f:
        ptxas = [ln.strip() for ln in f if "registers" in ln or "Compiling entry" in ln]
    report["ptxas"] = ptxas

    # Phase 3 — each kernel vs its plain version at production shapes.
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)
    checks = {
        "nms": [check_nms(torch, gen, dev, NMS_CASES[0]),
                check_nms(torch, gen, dev, NMS_CASES[1])],
        "multilevel_roi_align": [check_roi_align(torch, gen, dev, ROI_CASES[0]),
                                 check_roi_align(torch, gen, dev, ROI_CASES[1])],
        "correlation": [check_correlation(torch, gen, dev, getattr(torch, dt), case)
                        for dt, case in CORR_CASES],
        "resample2d": [check_resample(torch, gen, dev, b, c, h, w, getattr(torch, dt))
                       for b, c, h, w, dt in RESAMPLE_CASES],
        "roi_align": [check_roi_align_train(torch, gen, dev, p, getattr(torch, dt))
                      for p, dt in TRAIN_ALIGN_CASES],
        "roi_align_backward": [check_roi_align_backward(torch, gen, dev, 7),
                               check_roi_align_backward(torch, gen, dev, 14)],
    }
    # Rows added after the first runs come last, each from its own
    # generator, so the rows above see the inputs of earlier runs.
    checks["nms"].append(check_nms(torch, torch.Generator().manual_seed(3), dev, NMS_CASES[2]))
    checks["multilevel_roi_align"].append(
        check_roi_align(torch, torch.Generator().manual_seed(4), dev, ROI_CASES[2], timed=False))
    for i, (p_bw, kind) in enumerate(BACKWARD_CASES):
        checks["roi_align_backward"].append(check_roi_align_backward(
            torch, torch.Generator().manual_seed(5 + i), dev, p_bw, kind))
    torch.cuda.synchronize()
    report["kernel_checks"] = checks
    for name, rows in checks.items():
        for r in rows:
            if "ms" not in r:
                log(f"{name}: {r['shape']}: err {r['max_abs_err']:.3g} (tol {r['tol']})")
                continue
            log(f"{name}: {r['shape']}: err {r['max_abs_err']:.3g} (tol {r['tol']}), "
                f"{r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
                f"bound {r['bound'][0]:.4f} ms ({r['bound'][1]}), library {r['library_ms']}")

    # Phase 4 — tiny config: CUDA (kernels) vs CPU (plain versions).
    tiny = tiny_config()
    frames, gt = synthetic_video(np, 4, 96, 128, 2, seed=1)
    labels = {}
    for d in ("cuda", "cpu"):
        m = init_params(build_models(tiny, device=d), tiny, seed=0, device=d)
        labels[d] = run_sequence(m, tiny, frames, gt, 2, device=d).cpu().numpy()
    agree = float((labels["cuda"] == labels["cpu"]).mean())
    report["tiny_agreement"] = agree
    log(f"tiny config: CUDA vs CPU label agreement {agree:.5f}")
    if agree < 0.99 or not np.array_equal(labels["cuda"][0], labels["cpu"][0]):
        fail(f"tiny config: CUDA vs CPU agreement {agree} < 0.99 or frame 0 differs")

    # Phase 5 — the production preset on 9 frames.
    cfg = load_config(os.path.join(REPO, "configs", "davis2017_val.json"))
    p = cfg.pipeline
    t0 = time.perf_counter()
    models = init_params(build_models(cfg), cfg, seed=0)
    report["init_s"] = time.perf_counter() - t0
    n_frames = 9
    frames, gt = synthetic_video(np, n_frames, p.image_height, p.image_width, p.max_objects, seed=2)
    frames_d = torch.from_numpy(frames).cuda()
    gt_d = torch.from_numpy(gt).cuda()

    t0 = time.perf_counter()
    run_sequence(models, cfg, frames_d, gt_d, 2).cpu()
    report["warmup_s"] = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    times, out = [], None
    for i in range(3):
        if i == 0:
            for fn in wrappers.values():
                fn.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = run_sequence(models, cfg, frames_d, gt_d, 2)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        if i == 0:
            launches = {k: fn.launches for k, fn in wrappers.items()}
    peak = torch.cuda.max_memory_allocated()
    lab = out.cpu().numpy()
    if lab.shape != (n_frames, p.image_height, p.image_width) or lab.dtype != np.int32:
        fail(f"labels {lab.shape} {lab.dtype}")
    if not set(np.unique(lab)) <= {0, 1, 2}:
        fail(f"labels hold ids {np.unique(lab)}")
    ids = (np.arange(1, p.max_objects + 1)[:, None, None] * (gt > 0.5)).max(0)
    if not np.array_equal(lab[0], ids):
        fail("frame 0 labels differ from the annotation")
    missing = [k for k in INFERENCE_KERNELS if launches[k] <= 0]
    if missing:
        fail(f"kernels not launched on the inference path: {missing}")
    with torch.inference_mode():
        f = frames_d[1:9].float() / 255.0
        outs = stages_batch(models, cfg, get_anchors(cfg, "cuda"), f, frames_d[0:8].float() / 255.0)
    for name, x in zip(("prop_masks", "scores", "emb", "valid", "flow"), outs):
        if not torch.isfinite(x.float()).all():
            fail(f"stages_batch {name} is not finite")
    med = statistics.median(times)
    report["production"] = dict(
        frames=n_frames, run_s=times, median_s=med,
        frames_per_s=n_frames / med, tracked_frames_per_s=(n_frames - 1) / med,
        peak_bytes=peak, launches=launches,
        labels_per_frame=[int((lab[t] > 0).sum()) for t in range(n_frames)],
    )
    log(f"davis2017_val, {n_frames} frames: median {med:.3f} s → "
        f"{n_frames / med:.2f} frames/s, peak {peak / 2**30:.2f} GiB, launches {launches}")
    del models, outs, frames_d, gt_d, out, f
    torch.cuda.empty_cache()

    # Phase 6 — tiny training step: CUDA (kernels) vs CPU (plain versions).
    report["tiny_training"] = tiny_train_parity(np, torch)
    log(f"tiny training: {report['tiny_training']}")

    # Phase 7 — Mask R-CNN training at full width.
    tr = train_full_width(np, torch, wrappers)
    report["training"] = tr
    log(f"training at full width: median {tr['median_s_per_step']:.4f} s/step → "
        f"{tr['images_per_s']:.2f} images/s, peak {tr['peak_bytes'] / 2**30:.2f} GiB, "
        f"losses {tr['losses']}, launches {tr['launches']}")

    # Phase 8 — device times by kernel name, after the timed phases.
    device_times(torch, dev, checks)
    for name in KERNELS:
        for r in checks[name]:
            if "device_ms" not in r:
                continue
            log(f"{name}: {r['shape']}: wrapper {r['ms']:.5f} ms, device {r['device_ms']:.5f} ms"
                + (f" ({r['device_parts_ms']})" if "device_parts_ms" in r else "")
                + (f", with zero fill {r['device_all_ms']:.5f} ms" if "device_all_ms" in r else "")
                + (f", grid_sample device {r['library_device_ms']:.5f} ms"
                   if "library_device_ms" in r else ""))

    # Each kernel's launches on the path that runs it.
    path_launches = {k: launches[k] for k in INFERENCE_KERNELS}
    path_launches.update({k: tr["launches"][k] for k in TRAINING_KERNELS if k != "nms"})
    kernels_line = []
    for name, (source, replaces) in KERNELS.items():
        main = checks[name][0]
        kernels_line.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": path_launches[name], "max_abs_err": main["max_abs_err"],
            "ms": main["ms"], "plain_ms": main["plain_ms"],
            "bound_ms": main["bound"][0], "bound_by": main["bound"][1],
            "library_ms": main["library_ms"],
        })
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)), exist_ok=True)
        with open(args.json, "w") as fh:
            json.dump(report, fh, indent=1, default=str)
    print(json.dumps({"kernels": kernels_line}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
