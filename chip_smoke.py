#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (premvos_tpu_torch) on one CUDA card.

    python3 chip_smoke.py [--json PATH]     # from the root of a checkout

Phases (any failure raises and exits non-zero):
  1. the card's name and power limit (nvidia-smi);
  2. build the CUDA kernels from premvos_tpu_torch/kernels/*.cu with nvcc
     for sm_90a, and beside them the three host libraries (the JPEG
     decoder, the RLE codec and the zstd decoder, kernels/*.cc) with g++,
     all started together;
  3. hold each kernel against its plain PyTorch version (and the RoIAlign
     backward against the plain version's autograd) on the card at the
     shapes of its path (inference: configs/davis2017_val.json; training:
     ProposalConfig() at 480×864, batch 2), and time kernel, plain version,
     a PyTorch library call where one computes the same function, and the
     least time the card could take (bound); NMS also on clustered boxes
     (the sweep visits every box); multilevel RoIAlign also in float32 at
     C = 32 (the tiny configuration's shape, checked only); correlation
     with bf16 inputs (the path's), float32 inputs and, at a small size,
     stride 1 with max displacement 20 (D = 41), and in float32 at
     FlowNetC training's shapes [8, 256, 32, 32] and [8, 256, 8, 8] (md 20,
     stride 2); the correlation bounds count only the products whose
     displaced pixel lies on the image; the RoIAlign backward also
     on 8-px boxes piled on one point of P2 (contention) and in one
     unfiltered launch on P2 whose largest RoIs are too large for the
     kernel's shared-memory tables (its second path); resample2d also at
     the fine-tune's lucid warps (the backgrounds [8, 3, 480, 864] and the
     object patches [16 | 64, 4, 256, 256], under their affine, rotation
     and elastic flows); and NMS and the training RoIAlign forward and
     backward at the fine-tune's proposal net (batch 4 at 256×448: 1956
     RPN boxes per image, bf16 features at P = 7 and 14, a bf16 output
     gradient); and the correlation backward (float32, each gradient within
     1e-5 of its largest |grad|; library: autograd's backward through the
     21-bmm formulation) at FlowNetC's training shapes [8, 256, 32, 32]
     (256² crops) and [8, 256, 8, 8] (64²), md 20, stride 2, and at an odd
     [2, 64, 23, 37] at stride 2 (D = 21) and 1 (D = 41), at C = 200
     ([2, 200, 23, 37]) and at H = 50 ([2, 64, 50, 30]), with its bound
     as 3xTF32 on the tensor cores beside the float32-FMA bound; and NMS and the
     training RoIAlign forward and backward at the host-pool fine-tune's
     proposal net (batch 4 of the full 480×864 canvas: 2384 RPN boxes per
     image, bf16 features at P = 7 and 14, 256 RoIs per image, a bf16
     output gradient; `check_pool_shapes` ties them to davis2017_val);
     and NMS (1×2384 → 256, 1×256 → 32) and the multilevel RoIAlign
     (B = 1) at run_stages' proposals stage, which runs the proposal net
     one frame at a time (`check_stage_shapes` ties them to davis2017_val);
     and the correlation backward's error on each of its CUDA test's cases
     (the training shapes, c200, h50_w30, d61_groups, d61_c72, ...) as a
     share of its 1e-5 tolerance;
  4. run a tiny configuration end to end on CUDA (kernels) and on the CPU
     (plain versions) with the same seeded weights: ≥ 99 % label agreement;
  5. run `run_sequence` at configs/davis2017_val.json with seeded random
     weights on 9 synthetic frames (one chunk): a warm-up run, then three
     timed runs; launch counters are zeroed just before the first timed run
     and read just after it, and every inference kernel must have launched;
  6. one Mask R-CNN training loss and its gradients at a tiny configuration
     on CUDA (kernels) and on the CPU (plain versions) from the same seeded
     weights: the loss within 1e-4 relative, every parameter's gradient
     within 1e-3 of that parameter's largest |grad|; then one fused
     fine-tune step of each net (refine and proposal) at a tiny
     configuration from the same seeded weights and one set of draws made
     on the CPU: the same bounds, and the lucid canvases within 1e-3 of
     255 and masks equal (except where a pasted value lies within 1e-4 of
     0.5); then FlowNetC's multi-scale EPE (64×64, batch 2, md 4) and the
     ReID net's batch-hard triplet loss (R26, P = 2, K = 2) at the same
     bounds; then one host-pool fine-tune step of each net at the tiny
     configuration (one lucid pool built on the host, the same batch rows
     on both devices) at the same bounds; then the tiny Mask R-CNN's
     training loss with group_norm against the CPU in float64 (every
     gradient but the backbone's, whose ReLUs tie at its 2×2 stage), and
     the refinement net (R26) and the ReID
     net with group_norm and the refinement net on Xception-65 (frozen BN,
     33² crops): each float32 loss, then the loss and every gradient in
     float64 on both devices, at the same bounds;
  7. Mask R-CNN training at full width (ProposalConfig() defaults, 480×864,
     batch 2, 8 object slots, Adam 1e-4, float32): one step through
     `train_maskrcnn` on an in-memory synthetic dataset, then 5 timed steps
     of `make_train_step` on one fixed batch from the same batch assembly;
     launch counters are zeroed just before the timed steps and read just
     after, every loss must be finite, the last below the first, and NMS,
     RoIAlign and its backward must have launched; the same again with
     ProposalConfig(norm="group_norm"); then the per-video fused
     fine-tune at configs/davis2017_val.json (FinetuneConfig(steps=40):
     chunks of 16, 16 and 8) through `finetune_video_fused` on bench.py's
     synthetic 480×864 frame with two objects: a warm-up run, then a timed
     run with the launch counters zeroed just before and read just after;
     every loss finite, both nets' parameters changed, resample2d launched
     by both nets (two launches a step each), NMS, RoIAlign and its
     backward by the proposal net; then `run_sequence` with the fine-tuned
     models on phase 5's 9 frames (shape, ids, frame 0 = annotation); then
     FlowNetC training at full width (batch 8 of 256² crops of 384×512
     pairs written as PPM files, md 20, stride 2, Adam 1e-4, float32): one
     step through `train_flownet_c`, then 5 timed steps on one fixed batch
     with the correlation forward and backward launched exactly 5 times
     each; and ReID training at ReIDConfig() (R50, 128² crops, P = 8,
     K = 4) on an in-memory PK sampler: one step through `train_reid`, then
     5 timed steps; for both every loss finite and the last below the
     first; then the host-pool fine-tune (`finetune_video`, method "pool")
     at davis2017_val with FinetuneConfig(steps=40) on the fused run's
     frame: the pool of 64 lucid images built on the host, the refine net
     at batch 8 on the examples cut from it, the proposal net at batch 4 of
     the 480×864 frames, with the launch counters zeroed just before and
     read just after: losses finite, both nets changed, NMS launched 40
     times and the training RoIAlign forward and backward 320 times each;
     then the multi-video refine fine-tune (`finetune_refine_videos`) of
     that frame and its mirror image at davis2017_val's refine net with
     FinetuneConfig(steps=8) (pools of 32 lucid images, batch 4 a video):
     both losses finite, both copies on the card and changed;
     and refine-net training (`train_refine`) at RefineConfig() (385²
     crops, batch 8, float32) on an in-memory dataset of synthetic 480×864
     frames: one step through `train_refine`, then 5 timed steps on one
     fixed batch, every loss finite and the last below the first; the same
     at RefineConfig(backbone="xception65"); and `run_sequence` at
     davis2017_val with the refinement net on Xception-65 on phase 5's 9
     frames (as phase 5: frames/s, peak bytes, every inference kernel
     launched);
  7b. the DAVIS command lines and the merge-tuning replay at davis2017_val
     (seeded random weights) on a synthetic DAVIS tree of two 9-frame
     sequences of 480×854 PNG frames with two objects each, written by the
     port's codec, each CLI called through its main(argv) in this process,
     each path's launch counters zeroed just before it and read just after:
     (a) `run_davis` with no --device (so on CUDA): 9 PNGs of 480×854 a
     sequence, frame 0 the annotation, the summary's keys; frames/s of the
     timed window and with the host's PNG decode, PNG encode and J&F
     (measured apart on the same files), peak bytes, and the decode time of
     a port-written frame and of an all-Paeth 480×854 one; (b) `run_davis
     --finetune` on one sequence from a preset that differs only in
     finetune.steps = 40; (c) the five `run_stages` stages on 5 frames of
     one sequence: the JSON schema, the .flo names and their [480, 864, 2]
     fields, the PNGs, NMS and the multilevel RoIAlign launched twice a
     frame by the proposals stage; (d) `precompute_split` and
     `evaluate_weights` at the preset's merge weights (warp stride 2) and
     two other vectors: each candidate's merge and J&F seconds against the
     precompute's, its bytes a step, and the preset's replay against (a)'s
     labels (≥ 99.9 % of pixels, frame 0 exact);
  7c. the held-out synthetic protocol (premvos_tpu_torch.eval.
     synthetic_benchmark) through its main(argv), cut (SYNTHETIC_CUT: the
     record's 128×192 configuration with 2 / 1 / 1 sequences, 20 / 10 / 20
     / 10 training steps, 4 + 2 search trials, one seed, an 8-step fused
     fine-tune), in a temporary directory, the launch counters zeroed just
     before and read just after: every J&F finite and in [0, 1], the four
     trained nets changed, every kernel launched;
  7d. checkpoints and JPEG frames at davis2017_val: (a) seeded random
     source nets (frozen-BN statistics and biases drawn away from 1 and 0)
     written as a TF dict (Mask R-CNN, refinement, ReID), a
     torchvision-named ResNet state dict (the Mask R-CNN backbone) and a
     flownet2-pytorch state dict, each converted into fresh modules: every
     parameter bit for bit equal, each converter's host seconds; (b)
     `run_sequence` with the converted nets and no device argument on phase
     5's 9 frames: labels equal to the source nets', every inference kernel
     launched (counters zeroed just before, read just after), frames/s and
     peak bytes; (c) the converted nets on the first 3 frames on the CPU
     against the card, in float32 and bfloat16, object by object over the
     pixels either labels: frame 0 exact, each object's IoU ≥ 0.99 in
     float32, the bfloat16 IoUs reported; (d) the committed JPEG fixtures
     (tests/data/jpeg, 480×854, quality 96) decoded without Pillow equal to
     their committed Pillow decodes, ms a frame beside the PNG codec's, and
     `run_davis` through main(argv) with --checkpoint (the converted
     weights saved by utils/checkpoint.py) on a 32-frame tree of those
     frames in a cycle: 480×854 PNGs, frame 0 the annotation, frames/s;
     then frame 0 in the codings of tests/data/jpeg/codings (arithmetic
     sequential and progressive, lossless, a progressive file cut before
     its sixth scan, block-smoothed) decoded equal to their Pillow decodes,
     ms a frame each, and `run_davis` likewise on a 9-frame tree cycling
     through them, every inference kernel launched; (e) the C++
     RLE codec equal to the numpy one on 480×854 masks, both timed, and
     `mask_iou` on the card equal to the CPU's;
  7f. the JAX package's own orbax checkpoint (tests/data/orbax/
     davis2017_val_tiled, written by scripts/make_orbax_fixtures.py with
     its save_params: OCDBT, zarr v2, zstd), read without JAX: (a)
     `read_orbax` of its 1359 leaves (1.14 GB), host seconds and MB/s, every
     array's sha256 equal to its record's; (b) `run_davis --checkpoint
     <that directory>` through main(argv), no --device, on phase 7b's first
     sequence (9 PNG frames of 480×854): frame 0 the annotation, a pixel
     labelled after it, NMS 2, multilevel RoIAlign 2, correlation 1 and
     resample2d 12 launches in its zeroed window; (c) in float32, its
     labels equal to those of the same nets saved by utils/checkpoint.py
     and read back through --checkpoint model.pt, over the pixels either
     labels; (d) a checksummed zstd frame decoded, and refused with a
     flipped checksum byte and cut short;
  7e. data parallelism (premvos_tpu_torch.parallel): (a) a world-size-1
     NCCL group in this process on cuda:0, Mask R-CNN at full width
     (ProposalConfig(), 480×864, batch 2, float32 without TF32):
     make_dp_train_step against make_train_step from the same weights,
     the loss equal bit for bit and every parameter after Adam within
     1e-2 of its norm (DP_PARAM_BOUND: two plain steps are not repeatable,
     the RoIAlign backward adds with float atomics, and their distance is
     reported beside it), and on the exact gradients of one backward
     (`exact_grad_loss`) the DP step equal to make_train_step bit for
     bit; 5 timed steps of each and the NCCL all_reduce of the gradient
     bucket; (b) two gloo ranks sharing cuda:0 (CUDA tensors through the
     host: not NVLink, and two processes share the card's SMs, so the
     numbers show the code path, not scaling), spawned with their launch
     counters zeroed at the start and read at the end: (i) the DP Mask
     R-CNN step at global batch 2, one image a rank, against (a)'s
     one-process step: loss 1e-5 relative, every averaged gradient 1e-4
     of its largest |grad| from one process's at batch 2, every parameter
     after Adam within DP_PARAM_BOUND of its norm, both ranks' parameters
     equal bit for bit, and on exact gradients (rank r's: one process's
     times r + 1) the parameters equal, bit for bit, to one process's
     Adam step on their mean; (ii)
     `run_sequences_sharded` at davis2017_val in float32 on phase 5's 9
     frames and their mirror image, one sequence a rank, against
     `run_sequence` of each: frame 0 exact, each object's IoU ≥ 0.99;
     (iii) the fused fine-tune over the mesh, FinetuneConfig(steps=8):
     finite losses, both nets changed, both ranks equal; (iv) the
     two-video fine-tune, one video a rank: both copies changed and equal
     on both ranks; (v) one `train_flownet_c` step over the mesh at
     phase 7's FlowNetC configuration (a global batch of 8, 4 a rank):
     loss 1e-5 relative from one process's, both ranks equal; s/step of
     each path and the ms of an all_reduce of each net's gradient bytes;
     NMS, both RoIAligns, the RoIAlign backward, the correlation and its
     backward and resample2d must have launched (`launches_by_path` "dp");
  8. the device time by kernel name (torch.profiler) of NMS (mask pass,
     sweep, and the sort and the rest of its wrapper apart), multilevel
     RoIAlign, correlation and its backward, resample2d and the training
     RoIAlign forward and backward (four launches a head; also at the
     host-pool fine-tune's shapes) beside phase 3's wrapper times,
     on fresh inputs of the same shapes: last, because the end-to-end
     phases ran slower after a profiled run in the same process.

Prints the card line, a `{"kernels": [...]}` line (each kernel's
`launches` is the sum over the paths that run it, each counted in its own
zeroed window of phase 5, 7, 7b, 7c, 7d, 7f or 7e, and `launches_by_path` gives each path's
count), and last
`{"ok": true, "device": {...}}`; progress and every measurement go to
stderr, and with --json the whole report to PATH. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import os
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))

# Published peaks of one H100 SXM (dense): HBM bytes/s, float32 FLOP/s
# outside the tensor cores (most kernels' arithmetic type), bf16 FLOP/s on
# the tensor cores (the correlation kernel's) and TF32 FLOP/s on the tensor
# cores (the correlation backward's, three products per float32 product).
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
BF16_TC_FLOP_PER_S = 989e12
TF32_TC_FLOP_PER_S = 495e12

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
    # Nor for the cost volume's gradient: an XLA scan in its custom VJP.
    "correlation_backward": (
        "premvos_tpu_torch/kernels/correlation.cu",
        "premvos_tpu/ops/correlation.py:113 (_correlation_grads, an XLA scan)",
    ),
}

# The host libraries phase 2 builds beside the kernels (g++): the JPEG
# decoder, the RLE codec and the checkpoint reader's zstd decoder.
HOST_SOURCES = ("jpeg_decode.cc", "rle.cc", "zstd_decode.cc")

# The kernels each main path must launch: inference (phase 5) and training
# (phase 7).
INFERENCE_KERNELS = ("nms", "multilevel_roi_align", "correlation", "resample2d")
TRAINING_KERNELS = ("nms", "roi_align", "roi_align_backward")
FINETUNE_KERNELS = ("resample2d", "nms", "roi_align", "roi_align_backward")
# FlowNetC training (phase 7) launches the cost volume's forward and
# backward once a step each; ReID training runs no kernel of the port.
FLOW_TRAIN_KERNELS = ("correlation", "correlation_backward")

# FPN levels P2..P5 at 480×864 and their strides.
LEVEL_SHAPES = [(120, 216), (60, 108), (30, 54), (15, 27)]
LEVEL_STRIDES = (4, 8, 16, 32)

# The per-video fine-tune's proposal net at davis2017_val (phase 7): batch
# 4 (batch_size // 2) at proposal_finetune_hw = 256×448, so FPN levels
# (64, 112) .. (8, 14), and 1956 RPN boxes per image into NMS (each level's
# top 512 or all its anchors); main() checks these against the config.
FT_HW = (256, 448)
FT_BATCH = 4
FT_NMS_BOXES = 1956

# The host-pool fine-tune's proposal net at davis2017_val (phase 7): batch
# 4 (batch_size // 2) of whole 480×864 pool frames, 2384 RPN boxes per image
# (the inference RPN's count); check_pool_shapes checks these.
POOL_HW = (480, 864)
POOL_BATCH = 4
POOL_NMS_BOXES = 2384
# The kernels the host-pool fine-tune launches (its proposal net's) and
# how often a step: NMS once, the training RoIAlign forward and backward
# four times a head.
POOL_FINETUNE_KERNELS = {"nms": 1, "roi_align": 8, "roi_align_backward": 8}


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


def kernel_times(fn, iters: int = 50, need: tuple = (), wrapper=None, per_call: int = 1,
                 counts: dict | None = None) -> dict:
    """{kernel name: mean device ms per call} of everything fn() runs on the
    card (torch.profiler over `iters` calls, after one warm-up call), and in
    `counts`, where given, {kernel name: records in the profile}. The trace
    opens with one `torch.cuda._sleep(0)`, whose record, where the profiler
    keeps it, is taken out: the first kernel of a trace can go unrecorded
    (on the H100, after large traces, every later trace in the process lost
    its first records). Each
    kernel named by a pattern in `need` launches `per_call` times per call:
    `wrapper`'s launch counter, where given, must move by iters * per_call,
    so every one of those launches ran (a refused launch raises, a failed
    one fails the synchronize). A profile that then holds fewer records of a
    needed kernel than launches has lost records, not launches: it is logged
    and taken again, six times in all, and a sixth such profile fails (on
    the H100, phase 8 has recorded 0, 0 and 19 of the multilevel RoIAlign's
    20 launches in three takes in a row)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for attempt in range(1, 7):
        fn()
        torch.cuda.synchronize()
        before = wrapper.launches if wrapper is not None else None
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            torch.cuda._sleep(0)
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        if wrapper is not None and wrapper.launches - before != iters * per_call:
            fail(f"{wrapper.__name__} launched {wrapper.launches - before} times in "
                 f"{iters} profiled calls of {per_call} launches")
        events = [ev for ev in prof.key_averages()
                  if ev.device_type == DeviceType.CUDA and ev.self_device_time_total > 0]
        recorded = {ev.key: ev.count for ev in events}
        totals = {ev.key: ev.self_device_time_total for ev in events}
        spin = [k for k in recorded if "spin_kernel" in k]
        if spin and sum(recorded[k] for k in spin) > (iters if "spin" in need else 0):
            k = spin[0]  # the opening kernel's record, at its key's mean
            totals[k] -= totals[k] / recorded[k]
            recorded[k] -= 1
        times = {k: t / 1e3 / iters for k, t in totals.items() if recorded[k] > 0}
        seen = {p: sum(n for k, n in recorded.items() if p in k) for p in need}
        short = {p: k for p, k in seen.items() if k < iters * per_call}
        if not short:
            if counts is not None:
                counts.update({k: n for k, n in recorded.items() if n > 0})
            return times
        log(f"profile {attempt}: {iters * per_call} launches, the profiler recorded {short} "
            "of the needed kernels (records lost)")
    fail(f"six profiles lost records of {sorted(short)}")


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

def nms_inputs(torch, gen, b, n, clustered=False, image_hw=(480, 864)):
    """Boxes [b, n, 4] (xyxy) and scores [b, n] on the CPU over an image_hw
    image. Uniform: corners uniform, sides 4-204 px at 480×864 (scaled with
    the image's height), so few pairs overlap above 0.7 and the RPN sweep
    keeps 256 boxes early. Clustered: each image
    holds 40 cluster boxes (sides 40-200 px) and every box is one of them
    jittered by 3 % of its size, as neighbouring anchors regressed onto one
    object are: most of a cluster is suppressed by its best box, fewer than
    256 boxes survive, and the sweep visits all n."""
    ih, iw = image_hw
    if not clustered:
        xy = torch.rand(b, n, 2, generator=gen) * torch.tensor([float(iw), float(ih)])
        wh = (torch.rand(b, n, 2, generator=gen) * 200.0 + 4.0) * (ih / 480.0)
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
# threshold, clustered, image): the RPN's, the detection's, the RPN's on
# clustered boxes, the fused fine-tune's RPN and the host-pool fine-tune's
# (the last three each drawn from a generator of its own, so the other
# rows' inputs stay those of earlier runs).
NMS_CASES = ((8, 2384, 256, 0.7, 0.0, False, (480, 864)),
             (8, 256, 32, 0.5, 0.05, False, (480, 864)),
             (8, 2384, 256, 0.7, 0.0, True, (480, 864)),
             (FT_BATCH, FT_NMS_BOXES, 256, 0.7, 0.0, False, FT_HW),
             (POOL_BATCH, POOL_NMS_BOXES, 256, 0.7, 0.0, False, POOL_HW),
             # run_stages' proposals stage: one frame at a time (added last).
             (1, 2384, 256, 0.7, 0.0, False, (480, 864)),
             (1, 256, 32, 0.5, 0.05, False, (480, 864)))


def check_nms(torch, gen, dev, case):
    from premvos_tpu_torch.ops.nms import nms_cuda, nms_reference

    b, n, k, thr, score_thr, clustered, image_hw = case
    boxes, scores = (t.to(dev) for t in nms_inputs(torch, gen, b, n, clustered, image_hw))
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
    return dict(shape=f"boxes [{b},{n},4]{' clustered' if clustered else ''} on "
                      f"{image_hw[0]}x{image_hw[1]}, keep {k}, iou {thr}",
                max_abs_err=err, tol="exact", ms=ms, plain_ms=plain, bound=bnd,
                library_ms=None, kept=int(want[1].sum()), pairs=pairs)


def check_finetune_shapes(cfg) -> None:
    """FT_HW, FT_BATCH and FT_NMS_BOXES are the fine-tune's proposal net's
    at `cfg`, with 256 RoIs per image."""
    from premvos_tpu_torch.finetune.fused import proposal_finetune_hw
    from premvos_tpu_torch.models.anchors import pyramid_anchors

    pc, ft = cfg.proposal, cfg.finetune
    hw = proposal_finetune_hw((cfg.pipeline.image_height, cfg.pipeline.image_width), ft)
    anchors = pyramid_anchors(*hw, pc.anchor_scales, pc.anchor_ratios)
    boxes = sum(min(pc.rpn_pre_nms_topk, len(a)) for a in anchors.values())
    got = (hw, max(1, ft.batch_size // 2), boxes, pc.rpn_post_nms_topk)
    if got != (FT_HW, FT_BATCH, FT_NMS_BOXES, 256):
        fail(f"the fine-tune's proposal shapes (image, batch, NMS boxes, RoIs) are {got}, "
             f"not {(FT_HW, FT_BATCH, FT_NMS_BOXES, 256)}")


def check_pool_shapes(cfg) -> None:
    """POOL_HW, POOL_BATCH and POOL_NMS_BOXES are the host-pool fine-tune's
    proposal net's at `cfg` (it trains on whole frames at the pipeline
    canvas), with 256 RoIs per image."""
    from premvos_tpu_torch.models.anchors import pyramid_anchors

    pc, ft, p = cfg.proposal, cfg.finetune, cfg.pipeline
    hw = (p.image_height, p.image_width)
    anchors = pyramid_anchors(*hw, pc.anchor_scales, pc.anchor_ratios)
    boxes = sum(min(pc.rpn_pre_nms_topk, len(a)) for a in anchors.values())
    got = (hw, max(1, ft.batch_size // 2), boxes, pc.rpn_post_nms_topk)
    if got != (POOL_HW, POOL_BATCH, POOL_NMS_BOXES, 256):
        fail(f"the host-pool fine-tune's proposal shapes (image, batch, NMS boxes, RoIs) are "
             f"{got}, not {(POOL_HW, POOL_BATCH, POOL_NMS_BOXES, 256)}")


def check_stage_shapes(cfg) -> None:
    """The batch-1 NMS and RoIAlign rows are the proposals stage's at `cfg`:
    the RPN's boxes at the pipeline canvas → rpn_post_nms_topk, those RoIs
    → detections_per_frame, at cfg's thresholds, and the heads' RoIs and
    pooled sizes."""
    from premvos_tpu_torch.models.anchors import pyramid_anchors

    pc, p = cfg.proposal, cfg.pipeline
    hw = (p.image_height, p.image_width)
    anchors = pyramid_anchors(*hw, pc.anchor_scales, pc.anchor_ratios)
    boxes = sum(min(pc.rpn_pre_nms_topk, len(a)) for a in anchors.values())
    want = ((1, boxes, pc.rpn_post_nms_topk, pc.rpn_nms_threshold, 0.0, False, hw),
            (1, pc.rpn_post_nms_topk, pc.detections_per_frame, pc.detection_nms_threshold,
             pc.detection_score_threshold, False, hw))
    rois = ((1, pc.rpn_post_nms_topk, pc.roi_align_size, pc.fpn_channels, p.dtype, hw),
            (1, pc.detections_per_frame, pc.mask_roi_align_size, pc.fpn_channels, p.dtype, hw))
    if NMS_CASES[STAGE_NMS:] != want or ROI_CASES[STAGE_ROI:] != rois:
        fail(f"the proposals stage's NMS and RoIAlign shapes are {want}, {rois}, not "
             f"{NMS_CASES[STAGE_NMS:]}, {ROI_CASES[STAGE_ROI:]}")


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
             (2, 8, 7, 32, "float32", (96, 128)),
             # run_stages' proposals stage (batch 1), added last.
             (1, 256, 7, 256, "bfloat16", (480, 864)), (1, 32, 14, 256, "bfloat16", (480, 864)))
# The batch-1 rows of NMS_CASES and ROI_CASES; check_stage_shapes ties them
# to davis2017_val.
STAGE_NMS, STAGE_ROI = 5, 3


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


# The training RoIAlign forward rows of phase 3: (P, dtype) at training's
# shapes (batch 2 of 480×864); and the fine-tune's proposal net's (phase 7,
# added after them): bf16 features, batch 4 of 256×448, the box head's
# P = 7 and the mask head's 14.
TRAIN_ALIGN_CASES = ((7, "float32"), (14, "float32"), (7, "bfloat16"))
FT_ALIGN_PS = (7, 14)


def check_roi_align_train(torch, gen, dev, p, dtype, b=2, image_hw=(480, 864)):
    """The training align's forward (ops/roi_align.py::roi_align_levels on
    CUDA: the single-level kernel once per level P2..P5, each launch on the
    RoIs of its level, into one output) vs its plain version."""
    from premvos_tpu_torch.ops.roi_align import multilevel_roi_align_reference, roi_align_levels

    n, c, s = 256, 256, 2
    feats, boxes, levels = roi_case(torch, gen, dev, b, n, c, dtype, image_hw)
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
    nbytes = (sampled_pixels(torch, boxes, levels, p, s, image_hw) * c * size + b * n * 20
              + got.numel() * size)
    flops = b * n * p * p * c * s * s * 10
    return dict(shape=f"P2..P5 {str(dtype)[6:]} [{b},H,W,256] of {image_hw[0]}x{image_hw[1]}, "
                      f"256 RoIs/image, P={p}, 4 launches (one per level)",
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


def backward_inputs(torch, gen, dev, p, kind="dense", b=2, image_hw=(480, 864),
                    grad_dtype="float32"):
    """Features, boxes, levels and an output gradient for a backward row:
    P2..P5 float32 [b, H, W, 256] of image_hw (training's: batch 2 of
    480×864), 256 RoIs per image, with the boxes of `kind`, and the output
    gradient in `grad_dtype` (the forward's output dtype)."""
    from premvos_tpu_torch.models.maskrcnn import roi_levels

    n, c = 256, 256
    feats, boxes, levels = roi_case(torch, gen, dev, b, n, c, torch.float32, image_hw)
    if kind == "contention":
        ctr = torch.tensor([432.0, 240.0]) + torch.rand(b, n, 2, generator=gen) * 12.0
        half = 4.0 + torch.rand(b, n, 1, generator=gen)
        boxes = torch.cat([ctr - half, ctr + half], -1).to(dev)
        levels = roi_levels(boxes)
    grad_out = torch.randn(b, n, p, p, c, generator=gen).to(dev, getattr(torch, grad_dtype))
    return feats, boxes, levels, grad_out


def backward_run(torch, boxes, levels, grad_out, p, kind="dense", image_hw=(480, 864)):
    """The backward launches of a row: training's backward (one launch per
    level with the level filter), or one unfiltered launch on P2."""
    from premvos_tpu_torch.ops.roi_align import roi_align_backward_cuda, roi_align_levels_backward

    if kind == "unfiltered":
        return [roi_align_backward_cuda(grad_out, boxes, LEVEL_SHAPES[0], 2, 0.25)]
    return roi_align_levels_backward(grad_out, boxes, levels, level_shapes(image_hw), 2)


def check_roi_align_backward(torch, gen, dev, p, kind="dense", b=2, image_hw=(480, 864),
                             grad_dtype="float32"):
    """The backward kernel vs the autograd of the plain version (float32
    features, the output gradient in float32); each level's gradient within
    1e-4 of its largest |grad| (float32 atomics add in a varying order)."""
    from premvos_tpu_torch.ops.roi_align import multilevel_roi_align_reference, roi_align_reference

    n, c, s = 256, 256, 2
    feats, boxes, levels, grad_out = backward_inputs(torch, gen, dev, p, kind, b, image_hw,
                                                     grad_dtype)
    run = lambda: backward_run(torch, boxes, levels, grad_out, p, kind, image_hw)  # noqa: E731
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
    grad32 = grad_out.float()
    want = torch.autograd.grad(out, leaves, grad32, retain_graph=True)
    err = 0.0
    for li, (g, w) in enumerate(zip(got, want)):
        e, tol = max_abs(g, w), 1e-4 * float(w.abs().max())
        if not e <= tol:
            fail(f"roi_align_backward P={p} {kind}, level P{li + 2}: max |diff| {e} > {tol}")
        err = max(err, e)
    ms = cuda_ms(run, 20)
    plain = cuda_ms(lambda: torch.autograd.grad(out, leaves, grad32, retain_graph=True), 3,
                    warmup=1)
    # Bytes: the output gradient read once, boxes and levels, and every
    # element of the float32 feature gradients written once (the zero fill;
    # the sampled pixels are among them). Ops: 4 taps × (2 mul + 1 add) per
    # sample per channel. Beside them, the bytes the kernel's vector atomics
    # move: each RoI's footprint (on its level) once.
    nbytes = (grad_out.numel() * grad_out.element_size() + b * n * 20
              + sum(g.numel() for g in got) * 4)
    flops = b * n * p * p * c * s * s * 12
    if kind == "unfiltered":
        fh, fw = footprint_sides(torch, boxes, p, s, 4, LEVEL_SHAPES[0])
        fp = fh * fw
        shape = f"grad [2,256,{p},{p},256] f32 → P2 [2,120,216,256] f32, 1 unfiltered launch"
    else:
        fp = 0
        for li, (hw, st) in enumerate(zip(level_shapes(image_hw), LEVEL_STRIDES)):
            fh, fw = footprint_sides(torch, boxes, p, s, st, hw)
            fp = fp + (fh * fw)[levels == li + 2].sum()
        gd = "f32" if grad_dtype == "float32" else grad_dtype
        shape = (f"grad [{b},256,{p},{p},256] {gd} → P2..P5 [{b},H,W,256] f32 of "
                 f"{image_hw[0]}x{image_hw[1]}, 4 launches (one per level)"
                 f"{', 8-px boxes on P2' if kind == 'contention' else ''}")
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
# FlowNetC training's forward, float32, at 256² crops (phase 7's shape) and
# at 64² crops (the JAX engine's default: most displacements read only
# padding); added later, so checked last from a generator of their own.
CORR_TRAIN_CASES = (("float32", (8, 256, 32, 32, 20, 2)), ("float32", (8, 256, 8, 8, 20, 2)))
RESAMPLE_CASES = ((8, 3, 448, 832, "bfloat16"), (1, 8, 240, 432, "float32"))


def corr_pairs(h, w, md, st):
    """(pixel, displacement) pairs of one image whose displaced pixel lies
    on the image: the products the cost volume and its gradients need (the
    others read or land in the zero padding)."""
    r = md // st

    def on_image(n):
        return sum(1 for y in range(n) for i in range(-r, r + 1) if 0 <= y + i * st < n)

    return on_image(h) * on_image(w)


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
    return src, flow, grid_of(torch, flow)


def check_correlation(torch, gen, dev, dtype, case):
    """The kernel with `dtype` inputs (channels-last, as FlowNetC gives them)
    vs the plain version on their float32 values, atol 1e-5. Bound: the
    inputs read and the whole volume written once, against the on-image
    products (corr_pairs); for bf16 inputs on the tensor cores, for float32
    inputs as float32 FMAs outside them (the yardstick the first kernel was
    held to), with the byte bound beside it."""
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
    flops = 2.0 * b * corr_pairs(h, w, md, st) * c
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


# The correlation backward rows of phase 3, (B, C, H, W, max displacement,
# stride), float32: FlowNetC's training shape at 256² crops (the main row)
# and at 64² crops (the JAX engine's default), an odd shape at stride 2
# (D = 21) and at stride 1 (D = 41), and, added later, C = 200 (not a
# multiple of the kernel's 128-channel chunk) and H = 50 (not a multiple of
# its blocks' R·s = 16 rows).
CORR_GRAD_CASES = ((8, 256, 32, 32, 20, 2), (8, 256, 8, 8, 20, 2), (2, 64, 23, 37, 20, 2),
                   (2, 64, 23, 37, 20, 1), (2, 200, 23, 37, 20, 2), (2, 64, 50, 30, 20, 2))


def corr_grad_inputs(torch, gen, dev, case):
    """f1, f2 [B, C, H, W] channels-last and g [B, D², H, W], float32."""
    b, c, h, w, md, st = case
    d = 2 * (md // st) + 1
    f1, f2 = corr_inputs(torch, gen, dev, torch.float32, case)
    return f1, f2, torch.randn(b, d * d, h, w, generator=gen).to(dev)


def corr_grad_bounds(case) -> dict:
    """The correlation backward's bounds at `case`: f1, f2, df1, df2 and the
    entries of g at on-image pairs (corr_pairs) once, against both
    gradients' 2·B·pairs·C FLOP each (the products whose displaced pixel is
    off the image are zero and need no work). `bound`: the kernel's route,
    3xTF32 on the tensor cores (three products each, at the TF32 peak);
    `bound_fp32_fma`: the same FLOP as float32 FMAs (the first kernel's
    route); `bound_bytes_ms` and `bound_tf32_ops_ms`: the bytes alone and
    the three products alone."""
    b, c, h, w, md, st = case
    pairs = corr_pairs(h, w, md, st)
    nbytes = 4 * (b * pairs + 4 * b * c * h * w)
    flops = 2 * 2.0 * b * pairs * c
    return dict(bound=bound_ms(nbytes, 3 * flops, TF32_TC_FLOP_PER_S),
                bound_fp32_fma=bound_ms(nbytes, flops),
                bound_bytes_ms=nbytes / HBM_BYTES_PER_S * 1e3,
                bound_tf32_ops_ms=3 * flops / TF32_TC_FLOP_PER_S * 1e3, on_image_pairs=b * pairs)


def check_correlation_backward(torch, gen, dev, case):
    """The backward kernel vs correlation_grads_reference, each gradient
    within 1e-5 of its largest |value|. Library: autograd's backward
    through the 21-bmm formulation (corr_bmm; TF32 off), the graph built
    once. Bounds: corr_grad_bounds."""
    from premvos_tpu_torch.ops.correlation import (
        correlation_backward_cuda,
        correlation_grads_reference,
    )

    b, c, h, w, md, st = case
    f1, f2, g = corr_grad_inputs(torch, gen, dev, case)
    got = correlation_backward_cuda(f1, f2, g, md, st)
    want = correlation_grads_reference(f1, f2, g, md, st)
    errs = []
    for name, x, y in zip(("df1", "df2"), got, want):
        scale = float(y.abs().max())
        errs.append(max_abs(x, y) / max(scale, 1e-30))
        if not errs[-1] <= 1e-5:
            fail(f"correlation backward {case} {name}: max |diff| {errs[-1]} of its max "
                 "|grad| > 1e-5")
    ms = cuda_ms(lambda: correlation_backward_cuda(f1, f2, g, md, st), 20)
    plain = cuda_ms(lambda: correlation_grads_reference(f1, f2, g, md, st), 3, warmup=1)
    prev_tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    a, v = f1.detach().requires_grad_(True), f2.detach().requires_grad_(True)
    out = corr_bmm(torch, a, v, md, st)
    lib_err = max(max_abs(x, y) for x, y in zip(torch.autograd.grad(out, (a, v), g,
                                                                    retain_graph=True), want))
    library = cuda_ms(lambda: torch.autograd.grad(out, (a, v), g, retain_graph=True), 5)
    torch.backends.cuda.matmul.allow_tf32 = prev_tf32
    del out
    d2 = (2 * (md // st) + 1) ** 2
    return dict(shape=f"g [{b},{d2},{h},{w}], f1, f2 [{b},{c},{h},{w}] f32 → df1, df2, "
                      f"md {md}, stride {st}",
                max_abs_err=max(max_abs(x, y) for x, y in zip(got, want)),
                max_err_of_max_grad=max(errs), tol="1e-5 of each gradient's max |grad|",
                ms=ms, plain_ms=plain, library_ms=library, library_max_abs_err=lib_err,
                **corr_grad_bounds(case))


def check_resample(torch, gen, dev, b, c, h, w, dtype):
    src, flow, grid = resample_inputs(torch, gen, dev, b, c, h, w, dtype)
    return resample_row(torch, src, flow, grid,
                        f"src [{b},{c},{h},{w}] {str(dtype)[6:]}, flow f32")


def grid_of(torch, flow):
    """grid_sample's grid for the same clamped bilinear warp (border
    padding, align_corners=True)."""
    _, _, h, w = flow.shape
    gx = (torch.arange(w, device=flow.device) + flow[:, 0]) / (w - 1) * 2 - 1
    gy = (torch.arange(h, device=flow.device)[:, None] + flow[:, 1]) / (h - 1) * 2 - 1
    return torch.stack([gx, gy], -1)


# The resample2d rows of the fine-tune's lucid warps (phase 3, added after
# the others): the backgrounds of a refine batch and the object patches of
# two valid slots × 8 and of all 8 slots × 8.
LUCID_RESAMPLE_CASES = ("background", "patches16", "patches64")


def lucid_resample_inputs(torch, gen, dev, kind):
    """Unit-scale sources and the lucid warps' flows: the backgrounds
    [8, 3, 480, 864] under the largest background affine (5°, scale 0.9,
    shift 5 %), or object patches [N, 4, 256, 256] under rotations of
    ±15°, scales 0.9-1.1 and the elastic field."""
    from premvos_tpu_torch.finetune.lucid_device import rot_scale_flow, smooth_field

    if kind == "background":
        h, w = 480, 864
        src = torch.rand(8, 3, h, w, generator=gen).to(dev)
        ang, sc = torch.deg2rad(torch.tensor(5.0)), 0.9
        yy = torch.arange(h, dtype=torch.float32)[:, None] - (h - 1) / 2
        xx = torch.arange(w, dtype=torch.float32)[None, :] - (w - 1) / 2
        cos, sin = torch.cos(ang) / sc, torch.sin(ang) / sc
        fx = cos * (xx - 0.05 * w) + sin * (yy - 0.05 * h) - xx
        fy = -sin * (xx - 0.05 * w) + cos * (yy - 0.05 * h) - yy
        flow = torch.stack([fx, fy])[None].expand(8, 2, h, w).contiguous().to(dev)
    else:
        n = int(kind[len("patches"):])
        src = torch.rand(n, 4, 256, 256, generator=gen).to(dev)
        ang = torch.deg2rad(torch.rand(n, generator=gen) * 30 - 15)
        sc = torch.rand(n, generator=gen) * 0.2 + 0.9
        noise = torch.rand(n, 2, 32, 32, generator=gen) * 2 - 1
        flow = rot_scale_flow(256, ang, sc, smooth_field(noise, 256, 256)).contiguous().to(dev)
    return src, flow, grid_of(torch, flow)


def check_lucid_resample(torch, gen, dev, kind):
    src, flow, grid = lucid_resample_inputs(torch, gen, dev, kind)
    b, c, h, w = src.shape
    return resample_row(torch, src, flow, grid,
                        f"src [{b},{c},{h},{w}] f32, flow f32 (lucid {kind})")


def resample_row(torch, src, flow, grid, shape):
    """The kernel vs the plain version (atol 1e-5) and grid_sample on one
    input, with times and the byte bound (source, flow and output once)."""
    import torch.nn.functional as F

    from premvos_tpu_torch.ops.resample2d import resample2d_cuda, resample2d_reference

    got = resample2d_cuda(src, flow)
    want = resample2d_reference(src, flow)
    err = max_abs(got, want)
    tol = 1e-5
    if not err <= tol:
        fail(f"resample2d {shape}: max |diff| {err} > {tol}")
    ms = cuda_ms(lambda: resample2d_cuda(src, flow), 50)
    plain = cuda_ms(lambda: resample2d_reference(src, flow), 10)
    srcf = src.float()

    def lib():
        return F.grid_sample(srcf, grid, "bilinear", "border", align_corners=True)

    lib_err = max_abs(lib(), want)
    lib_ms = cuda_ms(lib, 50)
    b, c, h, w = src.shape
    nbytes = src.numel() * src.element_size() + flow.numel() * 4 + got.numel() * 4
    flops = b * c * h * w * 8.0
    return dict(shape=shape, max_abs_err=err, tol=tol, ms=ms, plain_ms=plain,
                bound=bound_ms(nbytes, flops), bound_bytes=nbytes, library_ms=lib_ms,
                library_err=lib_err)


def corr_grad_margins(torch, dev) -> dict:
    """The correlation backward's error on each case of
    tests/test_torch_cuda.py (its inputs) as a share of the tolerance, 1e-5
    of each gradient's largest |grad|: {case: {"df1": share, "df2": share}};
    fails above 1."""
    from premvos_tpu_torch.ops.correlation import (
        correlation_backward_cuda,
        correlation_grads_reference,
    )
    from tests.test_torch_cuda import CORR_GRAD_CASES, _corr_grad_inputs

    out = {}
    for name, case in CORR_GRAD_CASES.items():
        f1, f2, g = _corr_grad_inputs(dev, case)
        md, stride = case[4:]
        got = correlation_backward_cuda(f1, f2, g, md, stride)
        want = correlation_grads_reference(f1, f2, g, md, stride)
        out[name] = {k: max_abs(x, y) / (1e-5 * float(y.abs().max()))
                     for k, x, y in zip(("df1", "df2"), got, want)}
        if max(out[name].values()) > 1:
            fail(f"correlation backward {name}: {out[name]} of the tolerance")
    return out


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

    from premvos_tpu_torch.ops.correlation import correlation_backward_cuda, correlation_cuda
    from premvos_tpu_torch.ops.nms import nms_cuda
    from premvos_tpu_torch.ops.resample2d import resample2d_cuda
    from premvos_tpu_torch.ops.roi_align import (
        multilevel_roi_align_cuda,
        roi_align_backward_cuda,
        roi_align_cuda,
        roi_align_levels,
    )

    def nms_row(row, gen, case):
        b, n, k, thr, sthr, clustered, image_hw = case
        boxes, scores = (t.to(dev) for t in nms_inputs(torch, gen, b, n, clustered, image_hw))
        parts = nms_parts(kernel_times(lambda: nms_cuda(boxes, scores, k, thr, sthr), 20,
                                       ("nms_mask", "nms_sweep"), nms_cuda))
        row["device_parts_ms"] = parts
        row["device_ms"] = parts["mask"] + parts["sweep"]

    gen = torch.Generator().manual_seed(1)
    for row, case in zip(checks["nms"][:3], NMS_CASES[:3]):
        nms_row(row, gen, case)
    for row, case in zip(checks["multilevel_roi_align"], ROI_CASES[:2]):
        feats, boxes, levels = roi_inputs(torch, gen, dev, case)
        row["device_ms"] = device_ms(
            lambda: multilevel_roi_align_cuda(feats, boxes, levels, case[2], 2), "multilevel", 20,
            multilevel_roi_align_cuda)
    for row, (dtype, case) in zip(checks["correlation"], CORR_CASES):
        f1, f2 = corr_inputs(torch, gen, dev, getattr(torch, dtype), case)
        row["device_ms"] = device_ms(lambda: correlation_cuda(f1, f2, *case[4:]), "corr", 20,
                                     correlation_cuda)
    # Added later, each from a generator of its own: the forward at
    # FlowNetC training's shapes, and the backward, whose wrapper call must
    # be one launch of one kernel (df1 and df2 together).
    train_gen = torch.Generator().manual_seed(5)
    for row, (dtype, case) in zip(checks["correlation"][len(CORR_CASES):], CORR_TRAIN_CASES):
        f1, f2 = corr_inputs(torch, train_gen, dev, getattr(torch, dtype), case)
        row["device_ms"] = device_ms(lambda: correlation_cuda(f1, f2, *case[4:]), "corr", 20,
                                     correlation_cuda)
    grad_gen = torch.Generator().manual_seed(4)
    for row, case in zip(checks["correlation_backward"], CORR_GRAD_CASES):
        f1, f2, g = corr_grad_inputs(torch, grad_gen, dev, case)
        counts = {}
        times = kernel_times(lambda: correlation_backward_cuda(f1, f2, g, *case[4:]), 20,
                             ("corr_grad",), correlation_backward_cuda, counts=counts)
        names = {k: n for k, n in counts.items() if "corr_grad" in k}
        if len(names) != 1 or sum(names.values()) != 20:
            fail(f"correlation backward {case}: 20 calls ran the kernels {names}, not one "
                 "kernel 20 times")
        row["device_ms"] = named_ms(times, "corr_grad")
    lucid = [(row, lucid_resample_inputs(torch, torch.Generator().manual_seed(20 + i), dev, kind))
             for i, (row, kind) in enumerate(zip(checks["resample2d"][len(RESAMPLE_CASES):],
                                                 LUCID_RESAMPLE_CASES))]
    plain = [(row, resample_inputs(torch, gen, dev, b, c, h, w, getattr(torch, dtype)))
             for row, (b, c, h, w, dtype) in zip(checks["resample2d"], RESAMPLE_CASES)]
    for row, (src, flow, grid) in plain + lucid:
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
    def backward_row(row, gen, p, kind, b=2, image_hw=(480, 864), grad_dtype="float32"):
        _, boxes, levels, grad_out = backward_inputs(torch, gen, dev, p, kind, b, image_hw,
                                                     grad_dtype)
        times = kernel_times(
            lambda: backward_run(torch, boxes, levels, grad_out, p, kind, image_hw), 20,
            ("backward_kernel",), roi_align_backward_cuda,
            per_call=1 if kind == "unfiltered" else 4)
        row["device_ms"] = named_ms(times, "backward_kernel")
        row["device_all_ms"] = sum(times.values())  # with the gradients' zero fill

    for row, (p, kind) in zip(checks["roi_align_backward"],
                              ((7, "dense"), (14, "dense"), *BACKWARD_CASES)):
        backward_row(row, gen, p, kind)
    # The fine-tune's rows, added later: a generator of their own.
    gen = torch.Generator().manual_seed(3)
    nms_row(checks["nms"][3], gen, NMS_CASES[3])
    n_train = len(TRAIN_ALIGN_CASES)
    for row, p in zip(checks["roi_align"][n_train:], FT_ALIGN_PS):
        feats, boxes, levels = roi_case(torch, gen, dev, FT_BATCH, 256, 256, torch.bfloat16,
                                        FT_HW)
        row["device_ms"] = device_ms(
            lambda: roi_align_levels(feats, boxes, levels, p, 2), "single_kernel", 20,
            roi_align_cuda, per_call=4)
    n_train = 2 + len(BACKWARD_CASES)
    for row, p in zip(checks["roi_align_backward"][n_train:], FT_ALIGN_PS):
        backward_row(row, gen, p, "dense", FT_BATCH, FT_HW, "bfloat16")
    # The host-pool fine-tune's rows, added last: a generator of their own.
    gen = torch.Generator().manual_seed(6)
    nms_row(checks["nms"][4], gen, NMS_CASES[4])
    n_before = len(TRAIN_ALIGN_CASES) + len(FT_ALIGN_PS)
    for row, p in zip(checks["roi_align"][n_before:], FT_ALIGN_PS):
        feats, boxes, levels = roi_case(torch, gen, dev, POOL_BATCH, 256, 256, torch.bfloat16,
                                        POOL_HW)
        row["device_ms"] = device_ms(
            lambda: roi_align_levels(feats, boxes, levels, p, 2), "single_kernel", 20,
            roi_align_cuda, per_call=4)
    n_before = 2 + len(BACKWARD_CASES) + len(FT_ALIGN_PS)
    for row, p in zip(checks["roi_align_backward"][n_before:], FT_ALIGN_PS):
        backward_row(row, gen, p, "dense", POOL_BATCH, POOL_HW, "bfloat16")
    # The proposals stage's batch-1 rows, added after them: a generator of
    # their own.
    gen = torch.Generator().manual_seed(7)
    for row, case in zip(checks["nms"][STAGE_NMS:], NMS_CASES[STAGE_NMS:]):
        nms_row(row, gen, case)
    for row, case in zip(checks["multilevel_roi_align"][STAGE_ROI:], ROI_CASES[STAGE_ROI:]):
        feats, boxes, levels = roi_inputs(torch, gen, dev, case)
        row["device_ms"] = device_ms(
            lambda: multilevel_roi_align_cuda(feats, boxes, levels, case[2], 2), "multilevel", 20,
            multilevel_roi_align_cuda)


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


def video_objects(h, w):
    """synthetic_video's two rectangles: (y, x, height, width, (dy, dx) per
    frame)."""
    return [(h // 5, w // 6, h // 3, w // 4, (-3, 2)), (h // 2, w // 2, h // 3, w // 3, (2, -3))]


def video_labels(np, t, h, w):
    """[t, h, w] uint8 label maps of synthetic_video's rectangles in every
    frame (ids 1, 2; the second drawn over the first)."""
    labels = np.zeros((t, h, w), np.uint8)
    for f in range(t):
        for i, (y, x, hh, ww, (dy, dx)) in enumerate(video_objects(h, w)):
            labels[f, y + dy * f:y + dy * f + hh, x + dx * f:x + dx * f + ww] = i + 1
    return labels


def synthetic_video(np, t, h, w, k, seed):
    """Smooth background + textured rectangles drifting a few pixels per
    frame; masks of the first frame's rectangles (K slots, 2 used)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    base = np.stack([128 + 60 * np.sin(xx / 37.0), 128 + 60 * np.cos(yy / 23.0),
                     128 + 40 * np.sin((xx + yy) / 51.0)], -1)
    objs = video_objects(h, w)
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


def track_preset(np, torch, wrappers, cfg, n_frames: int = 9):
    """`run_sequence` at `cfg` (a full-width preset) with seeded random
    weights on `n_frames` synthetic frames (one chunk): a warm-up run, then
    three timed runs; the launch counters zeroed just before the first
    timed run and read just after. Fails unless the labels have the right
    shape and ids with frame 0 the annotation, every inference kernel
    launched (the correlation backward not), and stages_batch's outputs
    are finite. Returns a report dict."""
    from premvos_tpu_torch.pipeline.runner import (
        build_models, get_anchors, init_params, run_sequence, stages_batch,
    )

    p = cfg.pipeline
    t0 = time.perf_counter()
    models = init_params(build_models(cfg), cfg, seed=0)
    init_s = time.perf_counter() - t0
    frames, gt = synthetic_video(np, n_frames, p.image_height, p.image_width, p.max_objects, seed=2)
    frames_d = torch.from_numpy(frames).cuda()
    gt_d = torch.from_numpy(gt).cuda()

    t0 = time.perf_counter()
    run_sequence(models, cfg, frames_d, gt_d, 2).cpu()
    warmup_s = time.perf_counter() - t0
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
    if launches["correlation_backward"]:
        fail("inference launched the correlation backward (it runs without grad)")
    with torch.inference_mode():
        f = frames_d[1:9].float() / 255.0
        outs = stages_batch(models, cfg, get_anchors(cfg, "cuda"), f, frames_d[0:8].float() / 255.0)
    for name, x in zip(("prop_masks", "scores", "emb", "valid", "flow"), outs):
        if not torch.isfinite(x.float()).all():
            fail(f"stages_batch {name} is not finite")
    med = statistics.median(times)
    return dict(
        frames=n_frames, init_s=init_s, warmup_s=warmup_s, run_s=times, median_s=med,
        frames_per_s=n_frames / med, tracked_frames_per_s=(n_frames - 1) / med,
        peak_bytes=peak, launches=launches,
        labels_per_frame=[int((lab[t] > 0).sum()) for t in range(n_frames)],
    )


# ------------------------------------------------------------- phase 6

def tiny_train_case(np, torch, norm="frozen_bn"):
    """The tiny Mask R-CNN (seeded weights, RPN delta head zeroed, `norm`
    in its backbone) on the CPU, its anchors, and a batch of two 64×64
    images with two GT slots (the second of image 1 padded). Returns (cfg,
    hw, model, anchors, batch)."""
    from premvos_tpu_torch import config as tc
    from premvos_tpu_torch.models.anchors import pyramid_anchors
    from premvos_tpu_torch.models.layers import init_module
    from premvos_tpu_torch.models.maskrcnn import MaskRCNN

    cfg = tc.ProposalConfig(backbone_depth=26, fpn_channels=32, rpn_pre_nms_topk=64,
                            rpn_post_nms_topk=16, detections_per_frame=8, norm=norm)
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


def as_float64(torch, module):
    """A float64 copy of a port module: parameters and compute dtype."""
    import copy

    m = copy.deepcopy(module).double()
    for sub in m.modules():
        if isinstance(getattr(sub, "dtype", None), torch.dtype):
            sub.dtype = torch.float64
    return m


def tiny_loss_grads(torch, model, loss_fn_of, batch, device: str, float64: bool = False):
    """The loss `loss_fn_of(m)(batch)` of a copy m of `model` on `device`
    (the batch's tensors moved there, host values left as they are) and
    every parameter's gradient (float32 on the CPU), with TF32 off; with
    `float64`, model and batch in float64."""
    import copy

    from premvos_tpu_torch.pipeline.runner import float32_precision, place

    m = as_float64(torch, model) if float64 else copy.deepcopy(model)
    m = place(m, torch.device(device)).train()

    def move(x):
        if not torch.is_tensor(x):
            return x
        return (x.double() if float64 and x.is_floating_point() else x).to(device)

    with float32_precision():
        loss = loss_fn_of(m)(tuple(move(x) for x in batch))
        loss.backward()
    return loss.item(), {n: t.grad.detach().float().cpu() for n, t in m.named_parameters()}


def grad_ratios(got: dict, want: dict) -> list:
    """[(max |got − want| / max |want|, name)] per parameter, worst first."""
    out = []
    for name, w in want.items():
        scale = max(float(w.abs().max()), 1e-12)
        out.append((float((got[name] - w).abs().max()) / scale, name))
    return sorted(out, reverse=True)


def tiny_loss_parity(np, torch, name, model, loss_fn_of, batch, top: int = 3,
                     float64: bool = False, exclude: tuple = (), cpu_float64: bool = False):
    """One loss of `model` and its gradients on CUDA and on the CPU from the
    same weights and batch: the loss within 1e-4 relative, every gradient
    (but those of parameters named with an `exclude` prefix) within 1e-3 of
    its parameter's largest |grad| (phase 6's bounds); with `float64`, both
    sides in float64 (cuDNN's double convolutions on CUDA), with
    `cpu_float64` the CPU side alone. Returns (report dict, the CPU's
    gradients)."""
    lc, gc = tiny_loss_grads(torch, model, loss_fn_of, batch, "cuda", float64)
    lp, gp = tiny_loss_grads(torch, model, loss_fn_of, batch, "cpu", float64 or cpu_float64)
    rel = abs(lc - lp) / abs(lp)
    if not (np.isfinite(lc) and lp > 0 and rel <= 1e-4):
        fail(f"tiny {name} loss: CUDA {lc} vs CPU {lp} (relative {rel} > 1e-4)")
    ratios = grad_ratios(gc, {n: g for n, g in gp.items() if not n.startswith(exclude)})
    if not ratios[0][0] <= 1e-3:
        fail(f"tiny {name} gradient {ratios[0][1]}: max |diff| {ratios[0][0]} of its "
             "max |grad| > 1e-3")
    return dict(loss_cuda=lc, loss_cpu=lp, loss_rel_diff=rel, worst_grad_ratios=ratios[:top],
                float64=float64, cpu_float64=cpu_float64, excluded=list(exclude)), gp


def tiny_train_parity(np, torch, norm="frozen_bn"):
    """One loss and its gradients of the tiny Mask R-CNN (`norm` in its
    backbone) on CUDA and on the CPU from the same seeded weights and batch.
    With group_norm the CPU side runs in float64: its float32 convolutions
    put the mask head's conv2 weight gradient 1.7e-3 of its scale from
    float64, cuDNN's 4.4e-5 (measured on one H100); and the backbone's
    gradients are left out: at 64² its stage 5 is 2×2, and a float32
    pre-activation within rounding of zero flips a ReLU's gradient (4e-3 of
    a gradient's scale between the CPU's float32 and float64); the
    GroupNorm ResNet's gradients are held in float64 by
    tiny_norm_xception_parity, and the kernels' by the heads' gradients
    here. Returns a report dict."""
    from premvos_tpu_torch.train.detection import maskrcnn_loss_fn

    cfg, hw, model, anchors, batch = tiny_train_case(np, torch, norm)

    def loss_fn_of(m):
        t = next(m.parameters())
        return maskrcnn_loss_fn(m, {k: v.to(t.device, t.dtype) for k, v in anchors.items()},
                                cfg, hw)

    gn = norm == "group_norm"
    report, gp = tiny_loss_parity(np, torch, "training", model, loss_fn_of, batch, top=5,
                                  exclude=("backbone.",) if gn else (), cpu_float64=gn)
    if not any(n.startswith("mask_head.") and float(g.abs().max()) > 0 for n, g in gp.items()):
        fail("tiny training: the mask loss gave no gradient")
    return report


def to_device(x, device):
    """Tensors (in NamedTuples, at any depth) moved to `device`."""
    if hasattr(x, "_fields"):
        return type(x)(*(to_device(v, device) for v in x))
    return x.to(device)


def tiny_finetune_case(np, torch):
    """The fused fine-tune at phase 4's tiny configuration (batch 2, patch
    32): a frame with two objects and its labels, seeded refine and
    proposal nets (RPN delta head zeroed, as in phase 6), both nets' fused
    steps, and one set of draws of each made on the CPU."""
    import dataclasses

    from premvos_tpu_torch.data.lucid import inpaint_background
    from premvos_tpu_torch.finetune import fused
    from premvos_tpu_torch.models.deeplab import DeepLabV3Plus
    from premvos_tpu_torch.models.layers import init_module
    from premvos_tpu_torch.models.maskrcnn import MaskRCNN

    cfg = tiny_config()
    ft = dataclasses.replace(cfg.finetune, batch_size=2, aug_patch=32)
    p = cfg.pipeline
    hw, k = (p.image_height, p.image_width), p.max_objects
    frames, gt = synthetic_video(np, 1, *hw, k, seed=3)
    lab = (np.arange(1, k + 1)[:, None, None] * (gt > 0.5)).max(0).astype(np.int32)
    refine, maskrcnn = DeepLabV3Plus(cfg.refine), MaskRCNN(cfg.proposal)
    init_module(refine, torch.Generator().manual_seed(0))
    init_module(maskrcnn, torch.Generator().manual_seed(1))
    with torch.no_grad():
        for t in maskrcnn.rpn.Conv_2.parameters():
            t.zero_()
    prop_hw = fused.proposal_finetune_hw(hw, ft)
    runs = {"refine": fused.build_refine_fused_runs(hw, cfg.refine, ft, k),
            "proposal": fused.build_proposal_fused_runs(cfg.proposal, prop_hw, ft, k, "cpu")}
    gen, host_gen = torch.Generator().manual_seed(5), torch.Generator().manual_seed(5)
    draws = {name: run.draw(gen, host_gen) for name, run in runs.items()}
    return dict(cfg=cfg, ft=ft, frame=frames[0], lab=lab, bg=inpaint_background(frames[0], lab),
                nets={"refine": refine, "proposal": maskrcnn}, draws=draws, prop_hw=prop_hw)


def tiny_finetune_on(torch, case, device: str):
    """Each net's fused batch loss and gradients on `device` from the CPU
    draws (TF32 off), and the refine batch's lucid canvases and masks."""
    import copy

    from premvos_tpu_torch.finetune import fused
    from premvos_tpu_torch.finetune.lucid_device import lucid_frames
    from premvos_tpu_torch.pipeline.runner import float32_precision, place

    cfg, ft, k = case["cfg"], case["ft"], case["cfg"].pipeline.max_objects
    hw = case["frame"].shape[:2]
    runs = {"refine": fused.build_refine_fused_runs(hw, cfg.refine, ft, k),
            "proposal": fused.build_proposal_fused_runs(cfg.proposal, case["prop_hw"], ft, k,
                                                        device)}
    consts = {"refine": fused._prep_consts(case["frame"], case["lab"], k, device, case["bg"]),
              "proposal": fused._prep_consts(case["frame"], case["lab"], k, device, case["bg"],
                                             hw=case["prop_hw"])}
    out = {}
    for name, run in runs.items():
        draws = case["draws"][name]
        if name == "proposal":  # the RPN seeds stay on the host
            draws = draws._replace(lucid=to_device(draws.lucid, device))
        else:
            draws = to_device(draws, device)
        m = place(copy.deepcopy(case["nets"][name]), torch.device(device))
        with float32_precision():
            loss = run.loss(m, run.batch(draws, consts[name]))
            loss.backward()
        out[name] = (loss.item(), {n: t.grad.detach().float().cpu()
                                   for n, t in m.named_parameters()})
    lucid = to_device(case["draws"]["refine"].lucid, device)
    canvas, masks = lucid_frames(lucid, *consts["refine"], min(ft.aug_patch, *hw),
                                 cfg.refine.interp_precision)
    out["lucid"] = (canvas.cpu(), masks.cpu())
    return out


def tiny_finetune_parity(np, torch):
    """One fused fine-tune step of each net at the tiny configuration on
    CUDA (kernels) and on the CPU (plain versions) from the same weights
    and draws: each loss within 1e-4 relative, every gradient within 1e-3
    of its parameter's largest |grad| (phase 6's bounds); the lucid masks
    equal except where a pasted value lies within 1e-4 of 0.5, the
    canvases within 1e-3 of 255 where the labels agree. Returns a report
    dict."""
    from premvos_tpu_torch.finetune.lucid_device import object_patches
    from premvos_tpu_torch.ops.masks import paste_mask

    case = tiny_finetune_case(np, torch)
    got, want = tiny_finetune_on(torch, case, "cuda"), tiny_finetune_on(torch, case, "cpu")
    report = {}
    for name in ("refine", "proposal"):
        (lc, gc), (lp, gp) = got[name], want[name]
        rel = abs(lc - lp) / abs(lp)
        if not (np.isfinite(lc) and rel <= 1e-4):
            fail(f"tiny fine-tune {name} loss: CUDA {lc} vs CPU {lp} (relative {rel} > 1e-4)")
        ratios = grad_ratios(gc, gp)
        if not ratios[0][0] <= 1e-3:
            fail(f"tiny fine-tune {name} gradient {ratios[0][1]}: max |diff| {ratios[0][0]} of "
                 "its max |grad| > 1e-3")
        report[name] = dict(loss_cuda=lc, loss_cpu=lp, loss_rel_diff=rel,
                            worst_grad_ratios=ratios[:3])
    (cc, mc), (cp, mp) = got["lucid"], want["lucid"]
    differ = (mc != mp).any(1)
    if bool(differ.any()):
        k = case["cfg"].pipeline.max_objects
        img, masks = (torch.from_numpy(case["frame"]).permute(2, 0, 1).float(),
                      torch.from_numpy(case["lab"] == np.arange(1, k + 1)[:, None, None]).float())
        slots = [j for j in range(k) if bool(masks[j].any())]
        _, m, dst, on = object_patches(case["draws"]["refine"].lucid, img, masks, slots,
                                       min(case["ft"].aug_patch, *case["frame"].shape[:2]))
        h, w = case["frame"].shape[:2]
        soft = torch.stack([paste_mask(m[:, i], dst[:, i], h, w) * on[i]
                            for i in range(len(slots))], 1)
        if not bool(((soft - 0.5).abs() <= 1e-4).any(1)[differ].all()):
            fail("tiny fine-tune: CUDA and CPU lucid masks differ away from the 0.5 threshold")
    keep = ~differ[:, None].expand_as(cc)
    canvas_err = float((cc - cp).abs()[keep].max())
    if not canvas_err <= 1e-3 * 255:
        fail(f"tiny fine-tune: lucid canvas max |diff| {canvas_err} > 1e-3 of 255")
    report["lucid"] = dict(mask_pixels_differ=int(differ.sum()), canvas_max_abs_err=canvas_err)
    return report


def tiny_flow_reid_parity(np, torch):
    """FlowNetC's multi-scale EPE at 64×64, batch 2, max displacement 4
    (the cost volume's forward and backward kernels on CUDA), and the ReID
    net's batch-hard triplet loss (R26, 8-dim embeddings, 32² crops, P = 2,
    K = 2), each on CUDA and on the CPU from the same seeded weights."""
    from premvos_tpu_torch.config import ReIDConfig
    from premvos_tpu_torch.models.flownet import FlowNetC
    from premvos_tpu_torch.models.layers import init_module
    from premvos_tpu_torch.models.reid import ReIDNet
    from premvos_tpu_torch.train.train_flow import flow_loss_fn
    from premvos_tpu_torch.train.train_reid import reid_loss_fn

    rng = np.random.default_rng(6)
    flownet = FlowNetC(max_displacement=4)
    init_module(flownet, torch.Generator().manual_seed(0))
    i1, i2 = (torch.from_numpy(rng.uniform(0, 1, (2, 3, 64, 64)).astype(np.float32))
              for _ in range(2))
    gt = torch.from_numpy(rng.normal(0, 4, (2, 2, 64, 64)).astype(np.float32))
    report = {"flow": tiny_loss_parity(np, torch, "FlowNetC", flownet, flow_loss_fn,
                                       (i1, i2, gt))[0]}
    cfg = ReIDConfig(backbone_depth=26, embedding_dim=8, crop_size=32)
    reid = ReIDNet(cfg)
    init_module(reid, torch.Generator().manual_seed(0))
    crops = torch.from_numpy(rng.standard_normal((4, 3, 32, 32)).astype(np.float32))
    ids = torch.tensor([0, 0, 1, 1], dtype=torch.int32)
    report["reid"] = tiny_loss_parity(np, torch, "ReID", reid,
                                      lambda m: reid_loss_fn(m, cfg.triplet_margin),
                                      (crops, ids))[0]
    return report


def tiny_norm_xception_parity(np, torch):
    """The refinement net (R26, 33² crops) and the ReID net (R26, P = 2,
    K = 2) with group_norm, and the refinement net on Xception-65 (frozen
    BN, the preset's norm; 33² crops, narrow ASPP and decoder), from the
    same seeded weights on CUDA and on the CPU: each float32 loss within
    1e-4 relative, and the loss and every gradient in float64 at phase 6's
    bounds. (In float32 a pre-activation within rounding of zero flips a
    ReLU's gradient on one side; at these 3×3 deep maps that moved an
    Xception gradient by 2 % on the card; no custom kernel runs here.)"""
    from premvos_tpu_torch.config import RefineConfig, ReIDConfig
    from premvos_tpu_torch.finetune.finetune import refine_loss_fn
    from premvos_tpu_torch.models.deeplab import DeepLabV3Plus
    from premvos_tpu_torch.models.layers import init_module
    from premvos_tpu_torch.models.reid import ReIDNet
    from premvos_tpu_torch.train.train_reid import reid_loss_fn

    rng = np.random.default_rng(8)
    crops = torch.from_numpy(rng.standard_normal((2, 33, 33, 4)).astype(np.float32))
    target = torch.from_numpy((rng.uniform(0, 1, (2, 33, 33)) > 0.6).astype(np.float32))
    cfg = ReIDConfig(backbone_depth=26, embedding_dim=8, crop_size=32, norm="group_norm")
    reid_crops = torch.from_numpy(rng.standard_normal((4, 3, 32, 32)).astype(np.float32))
    ids = torch.tensor([0, 0, 1, 1], dtype=torch.int32)
    cases = []
    for name, rcfg in (
        ("refine_group_norm", RefineConfig(crop_size=33, backbone_depth=26, norm="group_norm")),
        ("refine_xception65", RefineConfig(crop_size=33, backbone="xception65", aspp_channels=32,
                                           low_level_channels=16, decoder_channels=32)),
    ):
        cases.append((name, DeepLabV3Plus(rcfg), refine_loss_fn, (crops, target)))
    cases.append(("reid_group_norm", ReIDNet(cfg), lambda m: reid_loss_fn(m, cfg.triplet_margin),
                  (reid_crops, ids)))
    report = {}
    for name, net, loss_fn_of, batch in cases:
        init_module(net, torch.Generator().manual_seed(0))
        l32 = {d: tiny_loss_grads(torch, net, loss_fn_of, batch, d)[0] for d in ("cuda", "cpu")}
        rel = abs(l32["cuda"] - l32["cpu"]) / abs(l32["cpu"])
        if not (np.isfinite(l32["cuda"]) and rel <= 1e-4):
            fail(f"tiny {name} float32 loss: CUDA {l32['cuda']} vs CPU {l32['cpu']}")
        report[name] = tiny_loss_parity(np, torch, name, net, loss_fn_of, batch,
                                        float64=True)[0]
        report[name]["float32_loss_rel_diff"] = rel
    return report


def tiny_pool_parity(np, torch):
    """One host-pool fine-tune step of each net at phase 4's tiny
    configuration on CUDA (kernels) and on the CPU (plain versions): one
    lucid pool of 4 augmentations built on the host, the refine examples
    cut from it, the first step's batch rows (drawn as the fine-tune draws
    them) gathered from the pool, the same seeded weights (RPN delta head
    zeroed, as in phase 6); each loss within 1e-4 relative, every gradient
    within 1e-3 of its parameter's largest |grad|. Returns a report dict."""
    import dataclasses

    from premvos_tpu_torch.finetune import finetune as ftmod
    from premvos_tpu_torch.models.deeplab import DeepLabV3Plus
    from premvos_tpu_torch.models.layers import init_module
    from premvos_tpu_torch.models.maskrcnn import MaskRCNN
    from premvos_tpu_torch.pipeline.runner import get_anchors
    from premvos_tpu_torch.train.trainer import sample_pool_draws

    cfg = tiny_config()
    ft = dataclasses.replace(cfg.finetune, steps=1, batch_size=2, num_augmentations=4)
    p = cfg.pipeline
    hw, k = (p.image_height, p.image_width), p.max_objects
    frames, gt = synthetic_video(np, 1, *hw, k, seed=3)
    lab = (np.arange(1, k + 1)[:, None, None] * (gt > 0.5)).max(0).astype(np.int32)
    imgs, labs = ftmod.build_lucid_pool(frames[0], lab, ft, seed=0)
    crops, tgts = ftmod.make_refine_examples(imgs, labs, cfg.refine.crop_size,
                                             cfg.refine.box_margin, np.random.default_rng(0))
    boxes, masks, valid = ftmod.proposal_pool(labs, k)
    seeds = np.random.default_rng(0).integers(0, 2**31 - 1, size=len(imgs)).astype(np.uint32)
    refine, maskrcnn = DeepLabV3Plus(cfg.refine), MaskRCNN(cfg.proposal)
    init_module(refine, torch.Generator().manual_seed(0))
    init_module(maskrcnn, torch.Generator().manual_seed(1))
    with torch.no_grad():
        for t in maskrcnn.rpn.Conv_2.parameters():
            t.zero_()
    rows = sample_pool_draws(torch.Generator().manual_seed(0), 1, len(crops), 2).idx[0].numpy()
    prop_rows = sample_pool_draws(torch.Generator().manual_seed(0), 1, len(imgs), 1).idx[0].numpy()
    report = {"refine": tiny_loss_parity(
        np, torch, "pool refine", refine, ftmod.refine_loss_fn,
        (torch.from_numpy(crops[rows]), torch.from_numpy(tgts[rows])))[0]}

    def prop_loss_of(m):
        dev = next(m.parameters()).device
        return ftmod.proposal_loss_fn(m, get_anchors(cfg, dev), cfg.proposal, hw)

    batch = tuple(torch.from_numpy(x[prop_rows]) for x in (imgs, boxes, masks, valid))
    report["proposal"] = tiny_loss_parity(np, torch, "pool proposal", maskrcnn, prop_loss_of,
                                          (*batch, seeds[prop_rows]))[0]
    report["examples"] = len(crops)
    return report


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


def timed_steps(np, torch, wrappers, step, batch, n_steps: int = 5, must_fall: bool = True):
    """`n_steps` steps of `step` on one batch, back to back as the trainers
    run them (no loss read between steps), with the launch counters zeroed
    just before and read just after; CUDA events between steps give each
    step's span on the device's timeline. Fails unless every loss is
    finite and (with must_fall) the last is below the first."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fn in wrappers.values():
        fn.launches = 0
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
    times = [a.elapsed_time(b) / 1e3 for a, b in zip(events, events[1:])]
    losses = [float(x) for x in out]
    if not all(np.isfinite(x) for x in losses):
        fail(f"training losses not finite: {losses}")
    if must_fall and not losses[-1] < losses[0]:
        fail(f"training loss did not fall over {n_steps} steps on one batch: {losses}")
    return dict(losses=losses, step_s=times, median_s_per_step=statistics.median(times),
                wall_s_per_step=wall / n_steps, peak_bytes=torch.cuda.max_memory_allocated(),
                launches=launches)


def train_full_width(np, torch, wrappers, n_steps: int = 5, norm="frozen_bn"):
    """Mask R-CNN training at ProposalConfig() defaults (with `norm`),
    480×864, batch 2, 8 object slots: one step through `train_maskrcnn`,
    then `n_steps` timed steps on one fixed batch. Returns a report dict."""
    from premvos_tpu_torch.config import ProposalConfig
    from premvos_tpu_torch.models.anchors import pyramid_anchors
    from premvos_tpu_torch.train.detection import maskrcnn_loss_fn
    from premvos_tpu_torch.train.train_maskrcnn import sample_batch, train_maskrcnn
    from premvos_tpu_torch.train.trainer import create_train_state, make_train_step

    cfg, hw, slots, bs = ProposalConfig(norm=norm), (480, 864), 8, 2
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
    rep = timed_steps(np, torch, wrappers, step, batch, n_steps)
    missing = [k for k in TRAINING_KERNELS if rep["launches"][k] <= 0]
    if missing:
        fail(f"kernels not launched on the training path: {missing}")
    return dict(config=f"ProposalConfig(norm={norm!r}) (R101-FPN, 256 ch, 256 RoIs/image), "
                       "480x864, batch 2, 8 slots, Adam 1e-4, float32 without TF32",
                first_step_s_incl_init=first_s, warmup_loss=warm_loss,
                images_per_s=bs / rep["median_s_per_step"], **rep)


def bench_finetune_frame(np, h, w):
    """bench.py's fine-tune input: a uniform-noise frame (seed 0) and two
    rectangular objects."""
    r = np.random.default_rng(0)
    frame0 = r.integers(0, 255, (h, w, 3)).astype(np.uint8)
    lab0 = np.zeros((h, w), np.int32)
    lab0[100:200, 150:300] = 1
    lab0[250:350, 500:650] = 2
    return frame0, lab0


def changed(a, b) -> bool:
    """Whether any parameter of module b differs from module a's."""
    pa = dict(a.named_parameters())
    return any(not bool((pa[n] == t).all()) for n, t in b.named_parameters())


def finetune_full_width(np, torch, wrappers, cfg, steps: int = 40):
    """The fused per-video fine-tune of both nets at `cfg` (davis2017_val)
    with FinetuneConfig(steps=steps), seeded random weights: a warm-up run,
    then a timed run with the launch counters zeroed just before it and
    read just after. Returns (report dict, fine-tuned models)."""
    import dataclasses

    from premvos_tpu_torch.finetune.fused import finetune_video_fused
    from premvos_tpu_torch.pipeline.runner import build_models, init_params

    ft = dataclasses.replace(cfg.finetune, steps=steps)
    p = cfg.pipeline
    models = init_params(build_models(cfg), cfg, seed=0)
    frame0, lab0 = bench_finetune_frame(np, p.image_height, p.image_width)
    t0 = time.perf_counter()
    _, warm = finetune_video_fused(models, frame0, lab0, cfg, ft_cfg=ft)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    for fn in wrappers.values():
        fn.launches = 0
    stats = {}
    t0 = time.perf_counter()
    tuned, losses = finetune_video_fused(models, frame0, lab0, cfg, ft_cfg=ft, stats=stats)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in wrappers.items()}
    peak = torch.cuda.max_memory_allocated()
    report = dict(config="configs/davis2017_val.json, FinetuneConfig(steps=%d): refine batch "
                         "%d at %d^2 crops on 480x864 lucid frames, proposals batch %d at "
                         "proposal_finetune_hw, patch %d, chunk %d, Adam %g, bf16 compute"
                         % (steps, ft.batch_size, cfg.refine.crop_size,
                            max(1, ft.batch_size // 2), ft.aug_patch, ft.chunk,
                            ft.learning_rate),
                  warmup_s=warm_s, warmup_losses=warm, wall_s=wall, losses=losses,
                  inpaint_s=stats["inpaint_s"], peak_bytes=peak, launches=launches)
    for net, mod in (("refine", "refine"), ("proposal", "maskrcnn")):
        chunks = stats[net]["chunks"]
        if not all(np.isfinite(loss) for _, _, loss in chunks):
            fail(f"fine-tune {net} losses not finite: {chunks}")
        if not changed(getattr(models, mod), getattr(tuned, mod)):
            fail(f"fine-tune {net}: no parameter changed")
        report[net] = dict(chunks=chunks, s_per_step=sum(c[1] for c in chunks) / steps,
                           chunk_s_per_step=[c[1] / c[0] for c in chunks])
    # Each net launches resample2d twice a step (backgrounds, patches).
    if launches["resample2d"] != 4 * steps:
        fail(f"fine-tune: resample2d launched {launches['resample2d']} times, not "
             f"2 per step for each net ({4 * steps})")
    missing = [k for k in FINETUNE_KERNELS if launches[k] <= 0]
    if missing:
        fail(f"kernels not launched on the fine-tune path: {missing}")
    del models
    return report, tuned


def pool_finetune_full_width(np, torch, wrappers, cfg, steps: int = 40):
    """The host-pool fine-tune of both nets (`finetune_video`, method
    "pool") at `cfg` (davis2017_val) with FinetuneConfig(steps=steps),
    seeded random weights, on bench.py's fine-tune frame: one run, with the
    launch counters zeroed just before it and read just after. Fails unless
    every loss read is finite, both nets changed and the proposal net's
    kernels launched as often as its steps need. Returns a report dict."""
    import dataclasses

    from premvos_tpu_torch.finetune.fused import finetune_video
    from premvos_tpu_torch.pipeline.runner import build_models, init_params

    ft = dataclasses.replace(cfg.finetune, steps=steps, method="pool")
    p = cfg.pipeline
    models = init_params(build_models(cfg), cfg, seed=0)
    frame0, lab0 = bench_finetune_frame(np, p.image_height, p.image_width)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fn in wrappers.values():
        fn.launches = 0
    stats = {}
    t0 = time.perf_counter()
    tuned, losses = finetune_video(models, frame0, lab0, cfg, ft_cfg=ft, stats=stats)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in wrappers.items()}
    peak = torch.cuda.max_memory_allocated()
    report = dict(config="configs/davis2017_val.json, FinetuneConfig(steps=%d, method='pool'): "
                         "a pool of %d lucid images of 480x864 built on the host, refine batch "
                         "%d of %d^2 crops cut from it, proposals batch %d of 480x864 frames, "
                         "chunk %d, Adam %g, bf16 compute"
                         % (steps, min(ft.num_augmentations, max(steps, 64)), ft.batch_size,
                            cfg.refine.crop_size, max(1, ft.batch_size // 2), ft.chunk,
                            ft.learning_rate),
                  wall_s=wall, losses=losses, pool_s=stats["pool_s"],
                  examples_s=stats["refine"]["examples_s"], examples=stats["refine"]["examples"],
                  peak_bytes=peak, launches=launches)
    for net, mod in (("refine", "refine"), ("proposal", "maskrcnn")):
        chunks = stats[net]["chunks"]
        if not all(np.isfinite(loss) for _, _, loss in chunks):
            fail(f"pool fine-tune {net} losses not finite: {chunks}")
        if not changed(getattr(models, mod), getattr(tuned, mod)):
            fail(f"pool fine-tune {net}: no parameter changed")
        later = chunks[1:] or chunks
        report[net] = dict(chunks=chunks, s_per_step=sum(c[1] for c in chunks) / steps,
                           s_per_step_after_first_chunk=sum(c[1] for c in later)
                           / sum(c[0] for c in later))
    want = {name: per_step * steps for name, per_step in POOL_FINETUNE_KERNELS.items()}
    wrong = {name: launches[name] for name, n in want.items() if launches[name] != n}
    if wrong:
        fail(f"pool fine-tune: launches {wrong}, not {want}")
    del models, tuned
    return report


def multi_video_full_width(np, torch, wrappers, cfg, steps: int = 8):
    """The multi-video refine fine-tune (`finetune_refine_videos`) of two
    videos at `cfg`'s refine net (davis2017_val's: RefineConfig()) with
    FinetuneConfig(steps=steps), seeded random weights, on bench.py's
    fine-tune frame and its mirror image: pools of max(steps, 32) lucid
    480×864 images each, batch max(8 // 2, 2) = 4 a video. One run with the
    launch counters zeroed just before it and read just after (the refine
    net runs none of the port's kernels). Fails unless both losses are
    finite and both copies lie on the card and changed. Returns a report
    dict."""
    import dataclasses

    from premvos_tpu_torch.finetune.multi_video import finetune_refine_videos
    from premvos_tpu_torch.models.deeplab import DeepLabV3Plus
    from premvos_tpu_torch.models.layers import init_module
    from premvos_tpu_torch.pipeline.runner import place

    ft = dataclasses.replace(cfg.finetune, steps=steps)
    p = cfg.pipeline
    frame0, lab0 = bench_finetune_frame(np, p.image_height, p.image_width)
    videos = [(frame0, lab0), (np.ascontiguousarray(frame0[:, ::-1]),
                               np.ascontiguousarray(lab0[:, ::-1]))]
    model = DeepLabV3Plus(cfg.refine, getattr(torch, cfg.pipeline.dtype))
    init_module(model, torch.Generator().manual_seed(0))
    model = place(model, torch.device("cuda"))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fn in wrappers.values():
        fn.launches = 0
    t0 = time.perf_counter()
    tuned, losses = finetune_refine_videos(model, videos, cfg.refine, ft)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in wrappers.items()}
    if not np.isfinite(losses).all():
        fail(f"multi-video fine-tune losses not finite: {losses}")
    for v, m in enumerate(tuned):
        if not next(m.parameters()).is_cuda or not changed(model, m):
            fail(f"multi-video fine-tune: video {v}'s copy is not on the card or did not train")
    report = dict(config="configs/davis2017_val.json's refine net, FinetuneConfig(steps=%d): "
                         "2 videos of 480x864, a pool of %d lucid images each, batch %d of "
                         "%d^2 crops a video, Adam %g, %s compute"
                         % (steps, min(ft.num_augmentations, max(steps, 32)),
                            max(ft.batch_size // 2, 2), cfg.refine.crop_size, ft.learning_rate,
                            cfg.pipeline.dtype),
                  wall_s=wall, losses=[float(x) for x in losses],
                  peak_bytes=torch.cuda.max_memory_allocated(), launches=launches)
    del model, tuned
    return report


def train_refine_full_width(np, torch, wrappers, n_steps: int = 5, backbone="resnet"):
    """Refine-net training at RefineConfig(backbone=...) (DeepLabv3+ R50 or
    Xception-65, 385² crops), batch 8, Adam 1e-4, float32, on an in-memory
    dataset of synthetic 480×864 frames: one step through `train_refine`,
    then `n_steps` timed steps on one fixed batch of its examples."""
    from premvos_tpu_torch.config import RefineConfig
    from premvos_tpu_torch.finetune.finetune import refine_loss_fn
    from premvos_tpu_torch.train.train_refine import example_batches, example_stream, train_refine
    from premvos_tpu_torch.train.trainer import create_train_state, make_train_step

    cfg, bs = RefineConfig(backbone=backbone), 8
    ds = SyntheticDavis(np, n_sequences=4)
    t0 = time.perf_counter()
    model, warm_loss = train_refine(ds, cfg, steps=1, batch_size=bs, seed=0, log_every=0)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    if not np.isfinite(warm_loss):
        fail(f"refine training warm-up step: loss {warm_loss}")
    batch = example_batches(example_stream(ds, cfg, np.random.default_rng(1)), bs,
                            torch.device("cuda"))()
    state = create_train_state(model, 1e-4)
    step = make_train_step(refine_loss_fn(model), state.optimizer)
    rep = timed_steps(np, torch, wrappers, step, batch, n_steps)
    enc = "Xception-65" if backbone == "xception65" else "R50"
    return dict(config=f"RefineConfig(backbone={backbone!r}) (DeepLabv3+ {enc}, 385x385 crops), "
                       "batch 8 of examples cut from 480x864 frames, sigmoid cross-entropy, "
                       "Adam 1e-4, float32 without TF32",
                first_step_s_incl_init=first_s, warmup_loss=warm_loss,
                images_per_s=bs / rep["median_s_per_step"], **rep)


def train_flow_full_width(np, torch, wrappers, n_steps: int = 5):
    """FlowNetC training at full width: batch 8 of 256×256 crops
    (flownet2-pytorch's --crop_size) of 384×512 pairs (FlyingChairs' size),
    max displacement 20, stride 2, Adam 1e-4, float32: a synthetic
    FlyingChairs tree written with the numpy PPM writer, one step through
    `train_flownet_c`, then `n_steps` timed steps on one fixed batch; the
    cost volume's forward and backward must each launch once a step."""
    import tempfile

    from premvos_tpu_torch.data.flow_pairs import FlowPairDataset, make_synthetic_chairs
    from premvos_tpu_torch.train.train_flow import device_batch, flow_loss_fn, train_flownet_c
    from premvos_tpu_torch.train.trainer import create_train_state, make_train_step

    bs, crop = 8, (256, 256)
    with tempfile.TemporaryDirectory() as tmp:
        ds = FlowPairDataset(make_synthetic_chairs(tmp, n=bs, hw=(384, 512)))
        t0 = time.perf_counter()
        model, warm_loss = train_flownet_c(ds, steps=1, batch_size=bs, crop_hw=crop,
                                           max_displacement=20, seed=0, log_every=0)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        batch = device_batch(ds.batch(np.random.default_rng(1), bs, crop), torch.device("cuda"))
    if not np.isfinite(warm_loss):
        fail(f"flow training warm-up step: loss {warm_loss}")
    state = create_train_state(model, 1e-4)
    step = make_train_step(flow_loss_fn(model), state.optimizer)
    rep = timed_steps(np, torch, wrappers, step, batch, n_steps)
    wrong = {k: rep["launches"][k] for k in FLOW_TRAIN_KERNELS if rep["launches"][k] != n_steps}
    if wrong:
        fail(f"flow training: kernels not launched once a step ({n_steps} steps): {wrong}")
    return dict(config="FlowNetC (md 20, stride 2), batch 8 of 256x256 crops of 384x512 pairs, "
                       "multi-scale EPE, Adam 1e-4, float32 without TF32",
                first_step_s_incl_init=first_s, warmup_loss=warm_loss,
                images_per_s=bs / rep["median_s_per_step"], **rep)


class SyntheticCrops:
    """An in-memory PK sampler (the crop readers' `pk_batch` interface):
    `identities` smooth random images of S×S; a view is its identity's
    image under a random flip, shift and brightness, with noise."""

    def __init__(self, np, size: int, identities: int = 32, seed: int = 0):
        self.np = np
        r = np.random.default_rng(seed)
        coarse = r.uniform(0, 1, (identities, size // 8, size // 8, 3))
        self.images = np.repeat(np.repeat(coarse, 8, 1), 8, 2).astype(np.float32)

    def pk_batch(self, rng, p: int = 8, k: int = 4):
        np = self.np
        chosen = rng.choice(len(self.images), size=p, replace=False)
        crops, ids = [], []
        for ident, idx in enumerate(chosen):
            for _ in range(k):
                v = np.roll(self.images[idx], rng.integers(-8, 9, 2), (0, 1))
                v = v[:, ::-1] if rng.uniform() < 0.5 else v
                v = v * rng.uniform(0.8, 1.2) + rng.normal(0, 0.05, v.shape)
                crops.append(np.clip(v, 0, 1))
                ids.append(ident)
        return np.stack(crops).astype(np.float32), np.asarray(ids, np.int32)


def train_reid_full_width(np, torch, wrappers, n_steps: int = 5):
    """ReID training at ReIDConfig() (R50, 128² crops, 128-dim), P = 8,
    K = 4 (batch 32), Adam 1e-4, float32: one step through `train_reid` on
    an in-memory PK sampler, then `n_steps` timed steps on one fixed
    batch."""
    from premvos_tpu_torch.config import ReIDConfig
    from premvos_tpu_torch.train.train_reid import pk_device_batch, reid_loss_fn, train_reid
    from premvos_tpu_torch.train.trainer import create_train_state, make_train_step

    cfg, p, k = ReIDConfig(), 8, 4
    ds = SyntheticCrops(np, cfg.crop_size)
    t0 = time.perf_counter()
    model, warm_loss = train_reid(ds, cfg, steps=1, p=p, k=k, seed=0, log_every=0)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    if not np.isfinite(warm_loss):
        fail(f"ReID training warm-up step: loss {warm_loss}")
    batch = pk_device_batch(ds, np.random.default_rng(1), p, k, torch.device("cuda"))
    state = create_train_state(model, 1e-4)
    step = make_train_step(reid_loss_fn(model, cfg.triplet_margin), state.optimizer)
    rep = timed_steps(np, torch, wrappers, step, batch, n_steps)
    return dict(config="ReIDConfig() (R50, 128x128 crops, 128-dim), P 8 x K 4 = 32 crops, "
                       "batch-hard triplet (margin 0.2), Adam 1e-4, float32 without TF32",
                first_step_s_incl_init=first_s, warmup_loss=warm_loss,
                images_per_s=p * k / rep["median_s_per_step"], **rep)


def track_after_finetune(np, torch, tuned, cfg, n_frames: int = 9):
    """`run_sequence` with the fine-tuned models on phase 5's frames:
    labels of the right shape and ids, frame 0 the annotation."""
    from premvos_tpu_torch.pipeline.runner import run_sequence

    p = cfg.pipeline
    frames, gt = synthetic_video(np, n_frames, p.image_height, p.image_width, p.max_objects,
                                 seed=2)
    lab = run_sequence(tuned, cfg, frames, gt, 2).cpu().numpy()
    if lab.shape != (n_frames, p.image_height, p.image_width) or lab.dtype != np.int32:
        fail(f"labels after the fine-tune: {lab.shape} {lab.dtype}")
    if not set(np.unique(lab)) <= {0, 1, 2}:
        fail(f"labels after the fine-tune hold ids {np.unique(lab)}")
    ids = (np.arange(1, p.max_objects + 1)[:, None, None] * (gt > 0.5)).max(0)
    if not np.array_equal(lab[0], ids):
        fail("frame 0 labels after the fine-tune differ from the annotation")
    return [int((lab[t] > 0).sum()) for t in range(n_frames)]

# ------------------------------------------------------------- phase 7c

# The cut of the synthetic protocol phase 7c runs: the record's
# configuration (bench_config(depth=26) on the 128×192 canvas, 24 frames)
# with fewer sequences, steps, trials and seeds (the record: 16 / 6 / 4
# sequences, det 1200, refine 600, reid 2400, flow 300 steps, 192 + 96
# trials, seeds 0 1 2), and an 8-step fused fine-tune per val sequence.
SYNTHETIC_CUT = ["--canvas", "128", "192", "--depth", "26", "--n-train", "2", "--n-tune", "1",
                 "--n-val", "1", "--steps-det", "20", "--steps-refine", "10", "--steps-reid",
                 "20", "--steps-flow", "10", "--tune-trials", "4", "--tune-local", "2",
                 "--finetune", "--finetune-steps", "8"]


def synthetic_protocol_cut(np, torch, wrappers):
    """`python -m premvos_tpu_torch.eval.synthetic_benchmark` through its
    main(argv) with SYNTHETIC_CUT, on the card, in a temporary directory
    (nothing is written in the repo; its printing goes to stderr), the
    launch counters zeroed just before and read just after: every J&F
    finite and in [0, 1], all four trained nets changed from their seeded
    draw, and every kernel of the port launched."""
    import contextlib
    import tempfile

    from premvos_tpu_torch.eval import synthetic_benchmark as sb
    from premvos_tpu_torch.pipeline.runner import build_models, init_params
    from premvos_tpu_torch.utils.checkpoint import load_params

    with tempfile.TemporaryDirectory() as tmp:
        params = os.path.join(tmp, "params.pt")
        argv = SYNTHETIC_CUT + ["--data-root", os.path.join(tmp, "data"),
                                "--out", os.path.join(tmp, "record.json"),
                                "--tuned-out", os.path.join(tmp, "tuned.json"),
                                "--save-params", params]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for fn in wrappers.values():
            fn.launches = 0
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(sys.stderr):
            record = sb.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {k: fn.launches for k, fn in wrappers.items()}
        cfg = sb.bench_config(canvas=(128, 192), depth=26)
        fresh = init_params(build_models(cfg), cfg, seed=0)
        trained = load_params(params, init_params(build_models(cfg), cfg, seed=0))
    same = [n for n in ("maskrcnn", "refine", "flow", "reid")
            if not changed(getattr(fresh, n), getattr(trained, n))]
    if same:
        fail(f"synthetic protocol: nets unchanged by training: {same}")
    scores = [record["held_out"]["J&F"], record["held_out"]["oracle_selection_JF"],
              record["held_out"]["default_weights_JF"], record["finetune"]["with_finetune_JF"]]
    scores += [r["J&F"] for r in record["ablation"]]
    if not all(np.isfinite(x) and 0.0 <= x <= 1.0 for x in scores):
        fail(f"synthetic protocol: J&F outside [0, 1]: {scores}")
    missing = [k for k in KERNELS if launches[k] <= 0]
    if missing:
        fail(f"kernels not launched on the synthetic protocol's path: {missing}")
    return dict(argv=SYNTHETIC_CUT, wall_s=wall, seconds=record["seconds"],
                held_out=record["held_out"], ablation=record["ablation"],
                finetune=record["finetune"], peak_bytes=torch.cuda.max_memory_allocated(),
                launches=launches)


# ------------------------------------------------------------- phase 7d

# The JPEG fixtures (scripts/make_jpeg_fixtures.py, written by Pillow): three
# 480×854 frames at quality 96, frame 0's annotation, and each frame's
# Pillow decode as PNG.
JPEG_FIXTURES = os.path.join(REPO, "tests", "data", "jpeg")
# Frame 0 in the codings Pillow reads and cannot write
# (scripts/make_jpeg_codings_fixtures.py), with Pillow's decodes.
JPEG_CODINGS = os.path.join(JPEG_FIXTURES, "codings")
CODINGS = ("arith_seq", "arith_prog", "lossless", "smoothed")
NETS = ("maskrcnn", "refine", "flow", "reid")


def converted_nets(np, torch, cfg):
    """Phase 7d (a): seeded random source nets at `cfg` (davis2017_val) on
    the card, their frozen BN statistics and biases drawn away from 1 and 0;
    a checkpoint in each source format written from them by the helper the
    tier-1 test uses (io_compat/_synthetic_checkpoints.py): a TF dict for the
    Mask R-CNN, refinement and ReID nets, a torchvision-named ResNet state
    dict for the Mask R-CNN backbone, a flownet2-pytorch state dict for
    FlowNet2; each converted into fresh modules on the card, every
    parameter equal to its source bit for bit. Returns (src, dst, report):
    each converter's host seconds (its checkpoint's writing apart)."""
    from premvos_tpu_torch.io_compat import _synthetic_checkpoints as sc
    from premvos_tpu_torch.io_compat.convert_flownet import convert_flownet2_state_dict
    from premvos_tpu_torch.io_compat.convert_resnet import convert_resnet_state_dict
    from premvos_tpu_torch.io_compat.convert_tf_maskrcnn import convert_tf_maskrcnn
    from premvos_tpu_torch.io_compat.convert_tf_refine import convert_tf_refine
    from premvos_tpu_torch.io_compat.convert_tf_reid import convert_tf_reid
    from premvos_tpu_torch.pipeline.runner import build_models, init_params

    ra, fpn = cfg.proposal.roi_align_size, cfg.proposal.fpn_channels
    src = init_params(build_models(cfg), cfg, seed=0)
    gen = torch.Generator(device="cuda").manual_seed(12)
    for net in NETS:
        sc.perturb(getattr(src, net), gen)
    dst = build_models(cfg)

    def flownet(ck):
        state, unused = convert_flownet2_state_dict(ck, dst.flow)
        if unused:
            fail(f"flownet2 converter left keys unused: {unused[:5]}")
        return state

    # (converter, net, checkpoint writer, converter call, the part it fills)
    steps = (
        ("tf_maskrcnn", "maskrcnn", lambda: sc.tf_maskrcnn_vars(src.maskrcnn, ra, fpn),
         lambda ck: convert_tf_maskrcnn(ck, dst.maskrcnn, ra, fpn), ""),
        ("resnet", "maskrcnn", lambda: sc.torchvision_resnet_state_dict(src.maskrcnn, ("backbone",)),
         lambda ck: convert_resnet_state_dict(ck, dst.maskrcnn, ("backbone",)), "backbone."),
        ("tf_refine", "refine", lambda: sc.tf_refine_vars(src.refine),
         lambda ck: convert_tf_refine(ck, dst.refine), ""),
        ("tf_reid", "reid", lambda: sc.tf_reid_vars(src.reid),
         lambda ck: convert_tf_reid(ck, dst.reid), ""),
        ("flownet2", "flow", lambda: sc.flownet2_state_dict(src.flow), flownet, ""),
    )
    report = {}
    for name, net, write, convert, prefix in steps:
        t0 = time.perf_counter()
        ck = write()
        write_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        state = convert(ck)
        convert_s = time.perf_counter() - t0
        want = getattr(src, net).state_dict()
        bad = [k for k, v in state.items() if k.startswith(prefix)
               and not torch.equal(v, want[k].cpu())]
        if bad:
            fail(f"{name}: converted parameters differ from the source: {bad[:5]}")
        getattr(dst, net).load_state_dict(state, strict=True)
        report[name] = dict(convert_s=convert_s, checkpoint_write_s=write_s,
                            entries=len(ck), converted=sum(k.startswith(prefix) for k in state))
    for net in NETS:
        want = getattr(src, net).state_dict()
        for k, v in getattr(dst, net).state_dict().items():
            if not torch.equal(v, want[k]):
                fail(f"converted {net}.{k} differs from its source on the card")
    return src, dst, report


def object_ious(np, a, b, k):
    """Per frame of two label stacks [T, H, W]: {object id: IoU} for each
    of the k objects that either labels there, and the share of the pixels
    that either labels on which they agree."""
    rows = []
    for la, lb in zip(a, b):
        either = (la > 0) | (lb > 0)
        ious = {}
        for i in range(1, k + 1):
            ia, ib = la == i, lb == i
            union = int((ia | ib).sum())
            if union:
                ious[i] = float((ia & ib).sum()) / union
        rows.append(dict(iou=ious, labelled=(int((la > 0).sum()), int((lb > 0).sum())),
                         union_agreement=float((la[either] == lb[either]).mean())
                         if either.any() else 1.0))
    return rows


# Phase 7d (c)'s bound on each object's IoU, CUDA against the CPU, in
# float32 (both devices labelled every pixel alike on "NVIDIA H100 80GB
# HBM3, 700.00 W").
CPU_IOU_MIN = 0.99


def track_converted(np, torch, wrappers, cfg, src, dst, n_frames: int = 9, cpu_frames: int = 3):
    """Phase 7d (b) and (c): `run_sequence` with the converted nets on
    phase 5's frames (one chunk), with no device argument, its labels equal
    to the source nets' on the same frames; the launch counters zeroed just
    before the converted run and read just after, every inference kernel
    launched; frames/s and peak bytes of that run. Then the converted nets
    on the first `cpu_frames` frames on the CPU (device="cpu", plain
    versions) against the card, in float32 and in the preset's bfloat16,
    compared object by object over the pixels either device labels: frame
    0 exact in both; in float32 every object's IoU ≥ CPU_IOU_MIN on every
    frame. At random weights each selected mask peaks near 0.52, so
    bfloat16's step of 2^-8 at the 0.5 threshold flips much of it (and as
    much between bfloat16 and float32 on one device): the bfloat16 IoUs
    are reported beside each device's bfloat16-against-float32 IoUs, with
    no bound (scripts/cuda_cpu_label_gap.py takes the gap apart). Returns a
    report dict."""
    from premvos_tpu_torch.pipeline.runner import build_models, run_sequence

    p = cfg.pipeline
    frames, gt = synthetic_video(np, n_frames, p.image_height, p.image_width, p.max_objects, seed=2)
    frames_d, gt_d = torch.from_numpy(frames).cuda(), torch.from_numpy(gt).cuda()
    want = run_sequence(src, cfg, frames_d, gt_d, 2).cpu().numpy()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    for fn in wrappers.values():
        fn.launches = 0
    t0 = time.perf_counter()
    got = run_sequence(dst, cfg, frames_d, gt_d, 2)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in wrappers.items()}
    peak = torch.cuda.max_memory_allocated()
    got = got.cpu().numpy()
    if got.shape != want.shape or not np.array_equal(got, want):
        fail(f"converted nets' labels differ from the source nets' on "
             f"{float((got != want).mean()) if got.shape == want.shape else 1.0:.5f} of pixels")
    if not (got[1:] > 0).any():
        fail("run_sequence on converted weights labelled no pixel after frame 0: "
             "the comparison would hold nothing")
    missing = [k for k in INFERENCE_KERNELS if launches[k] <= 0]
    if missing:
        fail(f"kernels not launched by run_sequence on converted weights: {missing}")

    labels, cpu_s = {}, {}
    for dtype in ("float32", p.dtype):
        cfg_x = dataclasses.replace(cfg, pipeline=dataclasses.replace(p, dtype=dtype))
        on = {"cuda": dst if dtype == p.dtype else build_models(cfg_x),
              "cpu": build_models(cfg_x, device="cpu")}
        for dev, models in on.items():
            for net in NETS:
                getattr(models, net).load_state_dict(
                    {k: v.to(dev) for k, v in getattr(dst, net).state_dict().items()}, strict=True)
        t0 = time.perf_counter()
        labels["cpu", dtype] = run_sequence(
            on["cpu"], cfg_x, frames[:cpu_frames], gt, 2, device="cpu").numpy()
        cpu_s[dtype] = time.perf_counter() - t0
        labels["cuda", dtype] = run_sequence(
            on["cuda"], cfg_x, frames_d[:cpu_frames], gt_d, 2).cpu().numpy()
        del on
        if not np.array_equal(labels["cpu", dtype][0], labels["cuda", dtype][0]):
            fail(f"davis2017_val, converted nets, {dtype}: CUDA vs CPU frame 0 differs")
    k = p.max_objects
    vs = {f"cuda_vs_cpu_{dt}": object_ious(np, labels["cuda", dt], labels["cpu", dt], k)
          for dt in ("float32", p.dtype)}
    for dev in ("cuda", "cpu"):
        vs[f"{dev}_{p.dtype}_vs_float32"] = object_ious(
            np, labels[dev, p.dtype], labels[dev, "float32"], k)
    f32 = vs["cuda_vs_cpu_float32"]
    low = [(t, i, v) for t, row in enumerate(f32) for i, v in row["iou"].items()
           if v < CPU_IOU_MIN]
    if low:
        fail(f"davis2017_val, converted nets, float32: CUDA vs CPU object IoU below "
             f"{CPU_IOU_MIN} (frame, object, IoU): {low}")
    if not all(row["iou"] for row in f32[1:]):
        fail("davis2017_val, converted nets, float32: a frame with no object labelled")
    return dict(frames=n_frames, run_s=run_s, frames_per_s=n_frames / run_s,
                tracked_frames_per_s=(n_frames - 1) / run_s, peak_bytes=peak,
                launches=launches, labels_per_frame=[int((got[t] > 0).sum()) for t in range(n_frames)],
                cpu_frames=cpu_frames, cpu_s=cpu_s, cuda_vs_cpu=vs)


def _decode_fixtures(np, paths, decoded, repeats):
    """Each JPEG in `paths` decoded by the port (no Pillow), equal to its
    Pillow decode in `decoded` (a PNG of the same stem, read by the port's
    codec); the decode's and the PNG read's ms (the median of `repeats`)."""
    from premvos_tpu_torch.io_compat.jpeg import read_jpeg
    from premvos_tpu_torch.io_compat.png import read_png

    jpeg_ms, png_ms = [], []
    for path in paths:
        want_path = os.path.join(decoded, os.path.basename(path)[:-4] + ".png")
        times = []
        for _ in range(repeats):
            t0 = time.perf_counter()
            got = read_jpeg(path)
            times.append(time.perf_counter() - t0)
        jpeg_ms.append(1e3 * statistics.median(times))
        times = []
        for _ in range(repeats):
            t0 = time.perf_counter()
            want = read_png(want_path)[0]
            times.append(time.perf_counter() - t0)
        png_ms.append(1e3 * statistics.median(times))
        if got.shape != (480, 854, 3) or not np.array_equal(got, want):
            fail(f"{path}: the port's decode differs from Pillow's")
    return jpeg_ms, png_ms


def _run_davis_on_jpeg_tree(np, torch, wrappers, tmp, seq, sources, ckpt):
    """`run_davis` through main(argv) with --checkpoint on a one-sequence
    DAVIS tree of the JPEG files `sources` in order (frame 0 annotated with
    the fixtures' annotation): 480×854 PNGs out, frame 0 the annotation,
    every frame tracked, the launch counters zeroed just before and read
    just after, every inference kernel launched."""
    import shutil

    from premvos_tpu_torch.data.palette import load_indexed_png
    from premvos_tpu_torch.pipeline import run_davis

    preset = os.path.join(REPO, "configs", "davis2017_val.json")
    root = os.path.join(tmp, seq)
    fd = os.path.join(root, "JPEGImages", "480p", seq)
    ad = os.path.join(root, "Annotations", "480p", seq)
    os.makedirs(fd)
    os.makedirs(ad)
    os.makedirs(os.path.join(root, "ImageSets", "2017"))
    with open(os.path.join(root, "ImageSets", "2017", "val.txt"), "w") as f:
        f.write(seq)
    seq_names = [f"{i:05d}.jpg" for i in range(len(sources))]
    for name, src in zip(seq_names, sources):
        shutil.copy(src, os.path.join(fd, name))
    shutil.copy(os.path.join(JPEG_FIXTURES, "annotation.png"), os.path.join(ad, "00000.png"))
    out = os.path.join(tmp, seq + "_out")
    torch.cuda.synchronize()
    for fn in wrappers.values():
        fn.launches = 0
    t0 = time.perf_counter()
    summary = run_davis.main(["--davis_root", root, "--output", out, "--config", preset,
                              "--checkpoint", ckpt])
    wall_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    launches = {k: fn.launches for k, fn in wrappers.items()}
    files = sorted(os.listdir(os.path.join(out, seq)))
    if files != [n[:-4] + ".png" for n in seq_names]:
        fail(f"run_davis on {seq} wrote {files}")
    labs = np.stack([load_indexed_png(os.path.join(out, seq, f)) for f in files])
    if labs.shape != (len(sources), 480, 854):
        fail(f"run_davis on {seq}: labels {labs.shape}")
    if not np.array_equal(labs[0], load_indexed_png(os.path.join(ad, "00000.png"))):
        fail(f"run_davis on {seq}: frame 0 differs from the annotation")
    if summary["frames"] != len(sources) - 1:
        fail(f"run_davis on {seq} tracked {summary['frames']} frames")
    missing = [k for k in INFERENCE_KERNELS if launches[k] <= 0]
    if missing:
        fail(f"kernels not launched by run_davis on {seq}: {missing}")
    return dict(summary=summary, frames_per_s=summary["fps"], wall_s=wall_s, launches=launches,
                labelled_pixels=[int((lab > 0).sum()) for lab in labs])


def jpeg_full_width(np, torch, wrappers, cfg, dst, repeats: int = 5, seq_frames: int = 32,
                    codings_frames: int = 9):
    """Phase 7d (d): the committed JPEG fixtures decoded by the port (no
    Pillow) equal their committed Pillow decodes exactly, with the decode's
    ms per 480×854 frame beside the PNG codec's on the same pixels (the
    median of `repeats`): the three Huffman frames, and frame 0 in each
    coding of tests/data/jpeg/codings (arithmetic-coded sequential and
    progressive, lossless, a progressive file cut before its sixth scan,
    which libjpeg block-smooths). Then `run_davis` through main(argv) with
    the converted weights saved by utils/checkpoint.py and passed by
    --checkpoint, on two DAVIS trees: `seq_frames` Huffman frames (the three
    fixtures in a cycle) and `codings_frames` frames cycling through the
    four codings, frame 0 annotated in each: 480×854 PNGs out, frame 0 the
    annotation, the summary's frames/s over the tracked frames, the launch
    counters zeroed just before and read just after each run. Returns a
    report dict."""
    import tempfile

    from premvos_tpu_torch.utils.checkpoint import save_params

    names = sorted(os.listdir(os.path.join(JPEG_FIXTURES, "frames")))
    frames = [os.path.join(JPEG_FIXTURES, "frames", n) for n in names]
    jpeg_ms, png_ms = _decode_fixtures(np, frames, os.path.join(JPEG_FIXTURES, "decoded"),
                                       repeats)
    codings = [os.path.join(JPEG_CODINGS, f"frame_{c}.jpg") for c in CODINGS]
    codings_ms, codings_png_ms = _decode_fixtures(
        np, codings, os.path.join(JPEG_CODINGS, "decoded"), repeats)
    report = dict(frames=names, jpeg_decode_ms=jpeg_ms, png_decode_ms=png_ms,
                  codings=list(CODINGS), codings_decode_ms=codings_ms,
                  codings_png_decode_ms=codings_png_ms)
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, "converted.pt")
        t0 = time.perf_counter()
        save_params(ckpt, dst)
        report["checkpoint_save_s"] = time.perf_counter() - t0
        run = _run_davis_on_jpeg_tree(np, torch, wrappers, tmp, "jpeg_seq",
                                      [frames[i % len(frames)] for i in range(seq_frames)], ckpt)
        report.update(run)
        report["codings_run"] = _run_davis_on_jpeg_tree(
            np, torch, wrappers, tmp, "codings_seq",
            [codings[i % len(codings)] for i in range(codings_frames)], ckpt)
    if "PIL" in sys.modules:
        fail("the JPEG path loaded PIL")
    return report


def codecs_full_width(np, torch, repeats: int = 5):
    """Phase 7d (e): the C++ RLE codec (io_compat/rle_native.py, built from
    kernels/rle.cc) equal to the numpy codec on 480×854 masks (the JPEG
    fixture's two objects and two seeded random masks): strings, masks and
    IoUs, with both codecs' encode + decode ms (median of `repeats`); and
    `ops.mask_iou` on the card equal to the CPU's on [8, 480, 854] soft
    masks."""
    from premvos_tpu_torch.data.palette import load_indexed_png
    from premvos_tpu_torch.io_compat import rle, rle_native
    from premvos_tpu_torch.ops import mask_iou

    if not rle_native.available():
        fail("rle_native did not build")
    ann = load_indexed_png(os.path.join(JPEG_FIXTURES, "annotation.png"))
    rng = np.random.default_rng(13)
    masks = [(ann == 1).astype(np.uint8), (ann == 2).astype(np.uint8),
             (rng.uniform(0, 1, ann.shape) < 0.2).astype(np.uint8),
             (rng.uniform(0, 1, ann.shape) < 0.7).astype(np.uint8)]

    def ms(fn):
        times = []
        for _ in range(repeats):
            t0 = time.perf_counter()
            fn()
            times.append(time.perf_counter() - t0)
        return 1e3 * statistics.median(times)

    rows = []
    for i, m in enumerate(masks):
        r = rle.encode(m)
        if rle_native.encode(m) != r or not np.array_equal(rle_native.decode(r), m):
            fail(f"rle_native differs from the numpy codec on mask {i}")
        for j in range(i):
            rj = rle.encode(masks[j])
            if abs(rle_native.iou(r, rj) - rle.iou(r, rj)) > 1e-12:
                fail(f"rle_native IoU differs from the numpy codec's on masks {j}, {i}")
        rows.append(dict(runs=len(rle.decode_counts(r["counts"])),
                         native_ms=ms(lambda: rle_native.decode(rle_native.encode(m))),
                         numpy_ms=ms(lambda: rle.decode(rle.encode(m)))))
    a = torch.from_numpy(rng.uniform(0, 1, (8, *ann.shape)).astype(np.float32))
    b = torch.from_numpy(rng.uniform(0, 1, (8, *ann.shape)).astype(np.float32))
    want = mask_iou(a, b)
    got = mask_iou(a.cuda(), b.cuda()).cpu()
    if not torch.equal(got, want):
        fail(f"mask_iou on the card differs from the CPU's by {float((got - want).abs().max())}")
    return dict(rle=rows, mask_iou_max_abs_err=0.0)


# ------------------------------------------------------------- phase 7b

# The kernels run_stages' stages launch: the proposals stage NMS and the
# multilevel RoIAlign twice a frame (RPN and detection NMS; box and mask
# head), the flow stage FlowNet2's, the merge stage the mask warp.
STAGES_KERNELS = ("nms", "multilevel_roi_align", "correlation", "resample2d")


def write_davis_tree(np, root, names, t, hw):
    """A DAVIS-layout tree (ImageSets/2017/val.txt, JPEGImages and
    Annotations under 480p) of synthetic_video sequences at hw, PNG frames
    and palette annotations of every frame, written by the port's codec."""
    from premvos_tpu_torch.data.palette import save_indexed_png
    from premvos_tpu_torch.io_compat.png import write_png

    os.makedirs(os.path.join(root, "ImageSets", "2017"))
    with open(os.path.join(root, "ImageSets", "2017", "val.txt"), "w") as f:
        f.write("\n".join(names))
    for s, name in enumerate(names):
        frames, _ = synthetic_video(np, t, *hw, 2, seed=70 + s)
        labels = video_labels(np, t, *hw)
        for kind, arrays, write in (("JPEGImages", frames, write_png),
                                    ("Annotations", labels, save_indexed_png)):
            d = os.path.join(root, kind, "480p", name)
            os.makedirs(d)
            for i, a in enumerate(arrays):
                write(os.path.join(d, f"{i:05d}.png"), a)


def png_decode_times(np, tmp, frame_path, hw):
    """Host seconds to decode one PNG frame the port wrote (filter None:
    zlib's speed) and one 480×854 RGB image whose every row is
    Paeth-filtered (the codec's slowest case: a Python loop over bytes)."""
    import struct
    import zlib

    from premvos_tpu_torch.io_compat.png import SIGNATURE, read_png

    t0 = time.perf_counter()
    read_png(frame_path)
    port_s = time.perf_counter() - t0
    h, w = hw
    rows = np.random.default_rng(0).integers(0, 256, (h, 1 + 3 * w)).astype(np.uint8)
    rows[:, 0] = 4

    def chunk(kind, body):
        return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))

    path = os.path.join(tmp, "paeth.png")
    with open(path, "wb") as f:
        f.write(SIGNATURE + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(rows.tobytes())) + chunk(b"IEND", b""))
    t0 = time.perf_counter()
    read_png(path)
    return dict(port_frame_s=port_s, paeth_frame_s=time.perf_counter() - t0)


def davis_cli_full_width(np, torch, wrappers, cfg, n_frames: int = 9, stage_frames: int = 5,
                         hw=(480, 854)):
    """The DAVIS command lines and the merge-tuning replay at
    configs/davis2017_val.json (`cfg`) with seeded random weights, on a
    synthetic DAVIS tree of two 9-frame sequences of hw (480×854) PNG
    frames with two objects each, each CLI called through its main(argv) in this process:
    (a) run_davis (no --device: CUDA); (b) run_davis --finetune on one
    sequence from a preset that differs only in finetune.steps = 40; (c)
    the five run_stages stages on 5 frames of one sequence; (d)
    precompute_split and evaluate_weights at the preset's merge weights and
    two others, the preset's replay held against (a)'s labels. Each path's
    launch counters are zeroed just before it and read just after. Returns
    a report dict."""
    import dataclasses
    import tempfile

    from premvos_tpu_torch.config import save_config
    from premvos_tpu_torch.data.davis import DavisDataset, save_results
    from premvos_tpu_torch.data.palette import load_indexed_png
    from premvos_tpu_torch.eval.davis_eval import evaluate_sequence
    from premvos_tpu_torch.eval.harness import (
        DEFAULT_WEIGHTS,
        WEIGHT_NAMES,
        evaluate_weights,
        precompute_split,
        weights_from_merge_cfg,
    )
    from premvos_tpu_torch.io_compat.flo import read_flo
    from premvos_tpu_torch.pipeline import run_davis, run_stages
    from premvos_tpu_torch.pipeline.runner import (
        build_models,
        init_params,
        merge_labels_from_precomputed,
    )

    preset = os.path.join(REPO, "configs", "davis2017_val.json")
    names, p = ("seq_a", "seq_b"), cfg.pipeline
    canvas = (p.image_height, p.image_width)
    report = {}

    def zero():
        torch.cuda.synchronize()
        for fn in wrappers.values():
            fn.launches = 0

    def read():
        torch.cuda.synchronize()
        return {k: fn.launches for k, fn in wrappers.items()}

    def results_of(out, name, n):
        d = os.path.join(out, name)
        files = sorted(os.listdir(d))
        if files != [f"{i:05d}.png" for i in range(n)]:
            fail(f"{d}: PNGs {files}")
        labs = np.stack([load_indexed_png(os.path.join(d, f)) for f in files])
        if labs.shape != (n, *hw):
            fail(f"{d}: labels {labs.shape}, not {(n, *hw)}")
        ann0 = load_indexed_png(os.path.join(root, "Annotations", "480p", name, "00000.png"))
        if not np.array_equal(labs[0], ann0):
            fail(f"{d}: frame 0 differs from the annotation")
        return labs

    with tempfile.TemporaryDirectory() as tmp:
        root = os.path.join(tmp, "davis")
        t0 = time.perf_counter()
        write_davis_tree(np, root, names, n_frames, hw)
        report["tree_write_s"] = time.perf_counter() - t0

        # (a) run_davis on the card by default.
        out = os.path.join(tmp, "out")
        torch.cuda.reset_peak_memory_stats()
        zero()
        t0 = time.perf_counter()
        summary = run_davis.main(["--davis_root", root, "--output", out, "--config", preset])
        wall = time.perf_counter() - t0
        launches = read()
        peak = torch.cuda.max_memory_allocated()
        if set(summary) != {"frames", "seconds", "fps", "J", "F", "J&F"}:
            fail(f"run_davis summary keys {sorted(summary)}")
        if summary["frames"] != len(names) * (n_frames - 1):
            fail(f"run_davis tracked {summary['frames']} frames")
        missing = [k for k in INFERENCE_KERNELS if launches[k] <= 0]
        if missing:
            fail(f"kernels not launched by run_davis: {missing}")
        labels_a = {name: results_of(out, name, n_frames) for name in names}
        # The host's work around the timed window, measured apart: PNG
        # decode of the frames and annotations, PNG encode of the labels,
        # J&F.
        ds = DavisDataset(root)
        host = dict(png_decode_s=0.0, png_encode_s=0.0, jf_s=0.0)
        for name in names:
            t0 = time.perf_counter()
            seq = ds.load_sequence(name, *canvas, p.max_objects)
            host["png_decode_s"] += time.perf_counter() - t0
            t0 = time.perf_counter()
            save_results(os.path.join(tmp, "encode"), name, labels_a[name])
            host["png_encode_s"] += time.perf_counter() - t0
            t0 = time.perf_counter()
            evaluate_sequence(labels_a[name], seq["gt_labels"][:, :hw[0], :hw[1]],
                              seq["num_objects"])
            host["jf_s"] += time.perf_counter() - t0
        host_s = sum(host.values())
        report["run_davis"] = dict(
            summary=summary, wall_s=wall, peak_bytes=peak, launches=launches, host=host,
            frames_per_s=summary["fps"],
            frames_per_s_with_host=summary["frames"] / (summary["seconds"] + host_s),
            host_share=host_s / (summary["seconds"] + host_s),
            labelled_pixels={k: [int((v[t] > 0).sum()) for t in range(n_frames)]
                             for k, v in labels_a.items()},
            png=png_decode_times(np, tmp, os.path.join(root, "JPEGImages", "480p", names[0],
                                                       "00000.png"), hw))

        # (b) run_davis --finetune on one sequence, 40 steps per net.
        ft_cfg = dataclasses.replace(cfg, finetune=dataclasses.replace(cfg.finetune, steps=40))
        ft_path = os.path.join(tmp, "davis2017_val_ft40.json")
        save_config(ft_path, ft_cfg)
        zero()
        t0 = time.perf_counter()
        summary_ft = run_davis.main(["--davis_root", root, "--output", os.path.join(tmp, "ft"),
                                     "--config", ft_path, "--finetune", "--sequences", names[0]])
        wall_ft = time.perf_counter() - t0
        launches_ft = read()
        missing = [k for k in FINETUNE_KERNELS + INFERENCE_KERNELS if launches_ft[k] <= 0]
        if missing:
            fail(f"kernels not launched by run_davis --finetune: {missing}")
        results_of(os.path.join(tmp, "ft"), names[0], n_frames)
        report["run_davis_finetune"] = dict(summary=summary_ft, wall_s=wall_ft,
                                            launches=launches_ft)

        # (c) the five run_stages stages on stage_frames frames.
        work = os.path.join(tmp, "work")
        stages = {}
        for stage in ("proposals", "refine", "flow", "reid", "merge"):
            zero()
            t0 = time.perf_counter()
            run_stages.main([stage, "--davis_root", root, "--seq", names[0], "--work", work,
                             "--config", preset, "--max_frames", str(stage_frames)])
            stages[stage] = dict(wall_s=time.perf_counter() - t0, launches=read())
        got = stages["proposals"]["launches"]
        if got["nms"] != 2 * stage_frames or got["multilevel_roi_align"] != 2 * stage_frames:
            fail(f"the proposals stage launched {got}, not NMS and the multilevel RoIAlign "
                 f"twice a frame")
        for stage, kernels in (("flow", ("correlation", "resample2d")), ("merge", ("resample2d",))):
            if any(stages[stage]["launches"][k] <= 0 for k in kernels):
                fail(f"the {stage} stage launched {stages[stage]['launches']}")
        for t in range(stage_frames):
            path = os.path.join(work, "proposals", names[0], f"frame_{t:05d}.json")
            with open(path) as f:
                props = json.load(f)
            if not 0 < len(props) <= p.max_proposals:
                fail(f"{path}: {len(props)} proposals")
            for d in props:
                if (set(d) != {"bbox", "score", "segmentation", "ReID"} or len(d["bbox"]) != 4
                        or d["segmentation"]["size"] != list(canvas)
                        or len(d["ReID"]) != cfg.reid.embedding_dim):
                    fail(f"{path}: proposal {sorted(d)} breaks the schema")
        flos = sorted(os.listdir(os.path.join(work, "flow", names[0])))
        if flos != [f"{t:05d}.flo" for t in range(1, stage_frames)]:
            fail(f"flow stage wrote {flos}")
        for name in flos:
            fl = read_flo(os.path.join(work, "flow", names[0], name))
            if fl.shape != (*canvas, 2) or not np.isfinite(fl).all():
                fail(f"{name}: flow {fl.shape}, finite {np.isfinite(fl).all()}")
        results_of(os.path.join(work, "results"), names[0], stage_frames)
        report["run_stages"] = stages

        # (d) the replay: stages 1–4 once, the merge per weight vector.
        models = init_params(build_models(cfg), cfg, seed=0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pre = precompute_split(models, cfg, ds, verbose=False)
        torch.cuda.synchronize()
        pre_s = time.perf_counter() - t0
        steps = sum(x[0]["scores"].shape[0] for x in pre)
        per_step = sum(v.numel() * v.element_size() for x in pre for k, v in x[0].items()
                       if k not in ("gt_emb", "gt_valid")) / steps
        w0 = weights_from_merge_cfg(cfg.merge)
        stride = cfg.merge.warp_stride
        candidates = {"preset": w0}
        for key, val in (("w_reid", 0.0), ("new_object_score_floor", 0.5)):
            w = w0.copy()
            w[WEIGHT_NAMES.index(key)] = val
            candidates[f"{key}={val}"] = w
        zero()
        replay = {}
        for key, w in candidates.items():
            t0 = time.perf_counter()
            for x in pre:
                merge_labels_from_precomputed(x[0], x[1], x[2], w, warp_stride=stride)
            torch.cuda.synchronize()
            merge_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            jf, _ = evaluate_weights(pre, w, warp_stride=stride)
            replay[key] = dict(weights=w.tolist(), jf=jf, merge_s=merge_s,
                               with_jf_s=time.perf_counter() - t0)
        launches_replay = read()
        if launches_replay["resample2d"] <= 0:
            fail(f"the replay's merge launched {launches_replay}")
        agree = {}
        for name, x in zip(names, pre):
            lab = merge_labels_from_precomputed(x[0], x[1], x[2], w0, warp_stride=stride)
            lab = lab.cpu().numpy()[:, :hw[0], :hw[1]]
            if not np.array_equal(lab[0], labels_a[name][0]):
                fail(f"replay {name}: frame 0 differs from run_davis's")
            differ = int((lab != labels_a[name]).sum())
            agree[name] = dict(pixels=int(lab.size), differ=differ,
                               share=1.0 - differ / lab.size)
            if differ > 0.001 * lab.size:
                fail(f"replay {name}: {differ} of {lab.size} pixels differ from run_davis's")
        report["replay"] = dict(
            precompute_s=pre_s, steps=steps, bytes_per_step=per_step,
            preset_is_default=bool(np.array_equal(w0, DEFAULT_WEIGHTS)), warp_stride=stride,
            candidates=replay, agreement=agree, launches=launches_replay)
        del pre, models
    torch.cuda.empty_cache()
    return report


# ------------------------------------------------------------- phase 7f

# The JAX package's orbax checkpoint of davis2017_val's nets, written by
# scripts/make_orbax_fixtures.py with premvos_tpu.utils.checkpoint.save_params
# (OCDBT, zarr v2, zstd), and its record: each leaf's path, dtype, shape and
# the sha256 of its array as orbax restores it.
ORBAX_FIXTURE = os.path.join(REPO, "tests", "data", "orbax", "davis2017_val_tiled")
# The launches of one run_davis window on one 9-frame sequence: NMS and the
# multilevel RoIAlign twice (RPN and detections; box and mask head), the
# cost volume once, resample2d 12 times (4 FlowNet2 warps, 8 merge warps).
ORBAX_RUN_LAUNCHES = {"nms": 2, "multilevel_roi_align": 2, "correlation": 1, "resample2d": 12}
# A zstd frame (level 3, content size and XXH64 checksum) of ZSTD_TEXT.
ZSTD_TEXT = b"PReMVOS checkpoint reader: a zstd frame with an XXH64 content checksum. " * 3
ZSTD_FRAME = bytes.fromhex(
    "28b52ffd24d86d020024045052654d564f5320636865636b706f696e74207265616465723a2061207a"
    "737464206672616d65207769746820616e20585848363420636f6e74656e7473756d2e2002008d2550"
    "dd7950506cf55742")


def zstd_refusals():
    """Phase 7f (d): the decoder decodes ZSTD_FRAME and refuses it with a
    flipped checksum byte and cut short, each by name."""
    from premvos_tpu_torch.io_compat import zstd

    if zstd.decompress(ZSTD_FRAME) != ZSTD_TEXT:
        fail("zstd: the checksummed frame decodes wrong")
    refused = {}
    for kind, frame, error in (
            ("checksum", ZSTD_FRAME[:-1] + bytes([ZSTD_FRAME[-1] ^ 1]), zstd.ZstdChecksum),
            ("truncated", ZSTD_FRAME[:-9], zstd.ZstdTruncated)):
        try:
            zstd.decompress(frame, size=len(ZSTD_TEXT))
        except error as e:
            refused[kind] = str(e)
            continue
        fail(f"zstd: a {kind} frame was not refused")
    return refused


def orbax_full_width(np, torch, wrappers, cfg, n_frames: int = 9, hw=(480, 854)):
    """Phase 7f: the JAX package's own orbax checkpoint at davis2017_val,
    read without JAX. (a) `read_orbax` of ORBAX_FIXTURE (1359 float32
    leaves, 1.14 GB): host seconds and MB/s of the decoded bytes, then
    every array's sha256 equal to the record's; (b) `run_davis` through
    main(argv) with --checkpoint ORBAX_FIXTURE and no --device on phase 7b's
    first sequence (9 PNG frames of 480×854, the same seed): frame 0 the
    annotation, a pixel labelled after it, the launch counters zeroed just
    before and read just after equal to ORBAX_RUN_LAUNCHES; (c) in float32
    (the preset with pipeline.dtype float32), the same run against the same
    nets saved by utils/checkpoint.py::save_params and read back through
    --checkpoint model.pt: every object's pixels equal over the pixels
    either side labels; (d) zstd_refusals. Returns a report dict."""
    import tempfile

    from premvos_tpu_torch.config import save_config
    from premvos_tpu_torch.data.palette import load_indexed_png
    from premvos_tpu_torch.io_compat.orbax_ckpt import read_orbax
    from premvos_tpu_torch.pipeline import run_davis
    from premvos_tpu_torch.pipeline.runner import build_models
    from premvos_tpu_torch.utils.checkpoint import load_params, save_params

    report = {}
    with open(ORBAX_FIXTURE + ".json") as f:
        record = {leaf["path"]: leaf for leaf in json.load(f)["leaves"]}
    t0 = time.perf_counter()
    tree = read_orbax(ORBAX_FIXTURE)
    read_s = time.perf_counter() - t0
    arrays = {}

    def walk(node, prefix):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, prefix + (k,))
            else:
                arrays[".".join(prefix + (k,))] = v

    walk(tree, ())
    if set(arrays) != set(record):
        fail(f"orbax: leaves differ from the record: {sorted(set(arrays) ^ set(record))[:5]}")
    t0 = time.perf_counter()
    for path, a in arrays.items():
        leaf = record[path]
        if (str(a.dtype), list(a.shape)) != (leaf["dtype"], leaf["shape"]):
            fail(f"orbax: {path} is {a.dtype} {list(a.shape)}, the record says "
                 f"{leaf['dtype']} {leaf['shape']}")
        if hashlib.sha256(a.tobytes()).hexdigest() != leaf["sha256"]:
            fail(f"orbax: {path}'s sha256 differs from the record's")
    nbytes = sum(a.nbytes for a in arrays.values())
    report["read"] = dict(arrays=len(arrays), bytes=nbytes, read_s=read_s,
                          mb_per_s=nbytes / 1e6 / read_s, sha256_s=time.perf_counter() - t0)
    del tree, arrays

    preset = os.path.join(REPO, "configs", "davis2017_val.json")
    with tempfile.TemporaryDirectory() as tmp:
        root, name = os.path.join(tmp, "davis"), "seq_a"
        write_davis_tree(np, root, (name,), n_frames, hw)
        ann0 = load_indexed_png(os.path.join(root, "Annotations", "480p", name, "00000.png"))

        def run(tag, config, ckpt):
            out = os.path.join(tmp, tag)
            torch.cuda.synchronize()
            for fn in wrappers.values():
                fn.launches = 0
            t0 = time.perf_counter()
            summary = run_davis.main(["--davis_root", root, "--output", out, "--config", config,
                                      "--checkpoint", ckpt])
            wall = time.perf_counter() - t0
            torch.cuda.synchronize()
            launches = {k: fn.launches for k, fn in wrappers.items()}
            d = os.path.join(out, name)
            files = sorted(os.listdir(d))
            if files != [f"{i:05d}.png" for i in range(n_frames)]:
                fail(f"run_davis {tag}: PNGs {files}")
            labs = np.stack([load_indexed_png(os.path.join(d, f)) for f in files])
            if labs.shape != (n_frames, *hw) or not np.array_equal(labs[0], ann0):
                fail(f"run_davis {tag}: labels {labs.shape}, or frame 0 is not the annotation")
            if not (labs[1:] > 0).any():
                fail(f"run_davis {tag}: no pixel labelled after frame 0")
            return labs, dict(summary=summary, wall_s=wall, launches=launches,
                              frames_per_s=summary["fps"],
                              labelled_pixels=[int((lab > 0).sum()) for lab in labs])

        # (b) the production preset, as the JAX CLI takes the directory.
        _, report["run"] = run("orbax", preset, ORBAX_FIXTURE)
        got = {k: report["run"]["launches"][k] for k in ORBAX_RUN_LAUNCHES}
        if got != ORBAX_RUN_LAUNCHES:
            fail(f"run_davis --checkpoint (orbax): launches {got}, not {ORBAX_RUN_LAUNCHES}")

        # (c) float32: the orbax route against the torch.save route.
        f32 = os.path.join(tmp, "davis2017_val_f32.json")
        save_config(f32, dataclasses.replace(
            cfg, pipeline=dataclasses.replace(cfg.pipeline, dtype="float32")))
        t0 = time.perf_counter()
        pt = os.path.join(tmp, "model.pt")
        save_params(pt, load_params(ORBAX_FIXTURE, build_models(cfg)))
        report["model_pt_s"] = time.perf_counter() - t0
        torch.cuda.empty_cache()
        labs_orbax, report["run_f32_orbax"] = run("orbax_f32", f32, ORBAX_FIXTURE)
        labs_pt, report["run_f32_pt"] = run("pt_f32", f32, pt)
        rows = object_ious(np, labs_orbax, labs_pt, cfg.pipeline.max_objects)
        report["f32_object_ious"] = [row["iou"] for row in rows]
        if any(row["union_agreement"] != 1.0 for row in rows):
            fail(f"run_davis in float32: the orbax checkpoint's labels differ from model.pt's: "
                 f"{rows}")
    report["zstd_refusals"] = zstd_refusals()
    return report


# ------------------------------------------------------------- phase 7e

# The kernels phase 7e (b)'s data-parallel paths launch on each rank: the
# Mask R-CNN step and the fused fine-tune's proposal net (NMS, the
# training RoIAlign and its backward), the fused fine-tune's lucid warps
# and sharded inference (NMS, multilevel RoIAlign, correlation,
# resample2d), the FlowNetC step (the correlation and its backward). The
# multi-video fine-tune's refine net runs none.
DP_KERNELS = ("nms", "multilevel_roi_align", "correlation", "resample2d", "roi_align",
              "roi_align_backward", "correlation_backward")


def kernel_wrappers():
    """The launch-counting wrappers, by kernel name (this process's own)."""
    from premvos_tpu_torch.ops import correlation, nms, resample2d, roi_align

    return {
        "nms": nms.nms_cuda,
        "multilevel_roi_align": roi_align.multilevel_roi_align_cuda,
        "correlation": correlation.correlation_cuda,
        "resample2d": resample2d.resample2d_cuda,
        "roi_align": roi_align.roi_align_cuda,
        "roi_align_backward": roi_align.roi_align_backward_cuda,
        "correlation_backward": correlation.correlation_backward_cuda,
    }


def dp_maskrcnn_case(np, torch, dev):
    """Phase 7's Mask R-CNN at full width (ProposalConfig(), 480×864, 8
    slots) from seeded weights (seed 0), and its batch of 2 from phase 7's
    batch assembly (seed 1): (model, loss_fn, batch)."""
    from premvos_tpu_torch.config import ProposalConfig
    from premvos_tpu_torch.models.anchors import pyramid_anchors
    from premvos_tpu_torch.models.layers import init_module
    from premvos_tpu_torch.models.maskrcnn import MaskRCNN
    from premvos_tpu_torch.pipeline.runner import place
    from premvos_tpu_torch.train.detection import maskrcnn_loss_fn
    from premvos_tpu_torch.train.train_maskrcnn import sample_batch

    cfg, hw, slots = ProposalConfig(), (480, 864), 8
    model = MaskRCNN(cfg)
    init_module(model, torch.Generator().manual_seed(0))
    model = place(model, dev).train()
    anchors = {k: torch.from_numpy(v).to(dev)
               for k, v in pyramid_anchors(*hw, cfg.anchor_scales, cfg.anchor_ratios).items()}
    batch = sample_batch(SyntheticDavis(np), np.random.default_rng(1), hw, slots, 2, dev)
    return model, lambda m: maskrcnn_loss_fn(m, anchors, cfg, hw), batch


def float32_cfg(cfg):
    return dataclasses.replace(cfg, pipeline=dataclasses.replace(cfg.pipeline, dtype="float32"))


def dp_sequences(np, cfg, n_frames: int = 9):
    """Phase 5's frames and annotation, and their mirror image: frames
    [2, T, H, W, 3], gt [2, K, H, W]."""
    p = cfg.pipeline
    frames, gt = synthetic_video(np, n_frames, p.image_height, p.image_width, p.max_objects,
                                 seed=2)
    return (np.stack([frames, np.ascontiguousarray(frames[:, :, ::-1])]),
            np.stack([gt, np.ascontiguousarray(gt[:, :, ::-1])]))


def largest(d: dict) -> tuple:
    """The largest (value, name) of {name: value}."""
    return max((v, n) for n, v in d.items())


def norm_ratios(torch, module, ref: dict) -> dict:
    """{name: |p − ref[name]| / |ref[name]|} (L2) for module's parameters."""
    return {n: float((p.detach().cpu() - ref[n]).norm() / ref[n].norm().clamp_min(1e-30))
            for n, p in module.named_parameters()}


def params_equal(torch, a, b) -> bool:
    """Whether modules a and b hold equal parameters, bit for bit."""
    return all(torch.equal(x, y) for x, y in zip(a.parameters(), b.parameters()))


def digest(module) -> str:
    """sha256 of a module's parameters and buffers, in order."""
    h = hashlib.sha256()
    for t in [*module.parameters(), *module.buffers()]:
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def params_digest(module) -> str:
    """sha256 of a module's parameters, in order."""
    h = hashlib.sha256()
    for t in module.parameters():
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def flow_train_step(np, torch, mesh):
    """One train_flownet_c step over `mesh` at phase 7's FlowNetC
    configuration (md 20, a global batch of 8 random 256² crops of
    synthetic 384×512 pairs, seed 0): (model, loss)."""
    import tempfile

    from premvos_tpu_torch.data.flow_pairs import FlowPairDataset, make_synthetic_chairs
    from premvos_tpu_torch.train.train_flow import train_flownet_c

    with tempfile.TemporaryDirectory() as tmp:
        ds = FlowPairDataset(make_synthetic_chairs(tmp, n=8, hw=(384, 512)))
        return train_flownet_c(ds, steps=1, batch_size=8, crop_hw=(256, 256),
                               max_displacement=20, seed=0, log_every=0, mesh=mesh)


# The bound on a data-parallel step's parameters after Adam against one
# process's step from the same weights, as a share of each parameter's
# norm (L2). The card's float32 step is not repeatable (the RoIAlign
# backward adds with float atomics; Adam's first step turns that noise into
# whole steps where a gradient is near zero): two plain steps lie 1.7e-3 of
# a norm apart. The bit-for-bit checks on exact gradients
# (`exact_grad_loss`) are the ones a fault in the reduce or the step fails.
DP_PARAM_BOUND = 1e-2


def exact_grad_loss(model, grads: list):
    """A loss whose gradient is `grads` exactly (Σ over the parameters of
    sum(p · g), `grads` in the order of model.parameters()): its backward
    multiplies ones by g and rounds nothing, so a step on it is
    repeatable, and a DP step on it must equal one process's Adam step on
    the ranks' mean gradients bit for bit."""
    params = list(model.parameters())
    return lambda batch: sum((p * g).sum() for p, g in zip(params, grads))


def step_ratios(torch, module, ref: dict, before: dict) -> dict:
    """{name: |p − ref[name]| / |ref[name] − before[name]|} (L2): the
    distance from the reference step as a share of that step's length."""
    return {n: float((p.detach().cpu() - ref[n]).norm()
                     / (ref[n] - before[n]).norm().clamp_min(1e-30))
            for n, p in module.named_parameters()}


def dp_one_rank_nccl(np, torch, wrappers, n_steps: int = 5):
    """Phase 7e (a): a world-size-1 NCCL group in this process (FileStore
    rendezvous) on cuda:0. From one seeded Mask R-CNN at full width and
    one batch of 2, float32 without TF32: make_train_step twice and
    make_dp_train_step once, one step each. The losses must be equal bit
    for bit, and the DP step's parameters within DP_PARAM_BOUND of each
    norm from the plain step's (the two plain steps' own distance is
    reported beside it: the floor). On the exact gradients of one backward
    (`exact_grad_loss`), the DP step (bucket, NCCL all_reduce, Adam) must
    equal make_train_step bit for bit. Then 5 timed steps of each (plain,
    DP, DP, plain; finite losses: the runs go on from their first step, so
    the loss need not fall), and the all_reduce of the net's gradient
    bucket (ms). Returns (report, {"loss", "params", "grads": the plain
    step's loss and parameters after it, and one process's gradients at
    batch 2})."""
    import copy
    import tempfile

    import torch.distributed as dist

    from premvos_tpu_torch.parallel.mesh import make_mesh
    from premvos_tpu_torch.pipeline.runner import float32_precision
    from premvos_tpu_torch.train.trainer import (
        create_train_state,
        make_dp_train_step,
        make_train_step,
        replicate_state,
    )

    dev = torch.device("cuda", 0)
    base, loss_of, batch = dp_maskrcnn_case(np, torch, dev)
    before = {n: p.detach().cpu().clone() for n, p in base.named_parameters()}
    report = {}
    with tempfile.TemporaryDirectory(prefix="premvos_nccl_") as tmp:
        dist.init_process_group("nccl", store=dist.FileStore(os.path.join(tmp, "store"), 1),
                                rank=0, world_size=1)
        try:
            mesh = make_mesh(1, backend="nccl")

            def one_step(name, loss_fn_of, data):
                m = copy.deepcopy(base)
                st = create_train_state(m, 1e-4)
                step = (make_train_step(loss_fn_of(m), st.optimizer) if "plain" in name else
                        make_dp_train_step(loss_fn_of(m), replicate_state(st, mesh).optimizer,
                                           mesh))
                return m, float(step(data)), step

            runs = {name: one_step(name, loss_of, batch) for name in ("plain", "plain_again",
                                                                      "dp")}
            torch.cuda.synchronize()
            losses = {k: v[1] for k, v in runs.items()}
            if not (np.float32(losses["dp"]).tobytes() == np.float32(losses["plain"]).tobytes()):
                fail(f"one-rank NCCL DP step: loss {losses['dp']!r} != make_train_step's "
                     f"{losses['plain']!r}")
            ref = dict(loss=losses["plain"], params={
                n: p.detach().cpu().clone() for n, p in runs["plain"][0].named_parameters()})
            floor = largest(norm_ratios(torch, runs["plain_again"][0], ref["params"]))
            dp_err = largest(norm_ratios(torch, runs["dp"][0], ref["params"]))
            if not dp_err[0] <= DP_PARAM_BOUND:
                fail(f"one-rank NCCL DP step: {dp_err[1]} {dp_err[0]:.3g} of its norm from "
                     f"make_train_step's (bound {DP_PARAM_BOUND}; two plain steps {floor[0]:.3g})")
            dp_step_err = largest(step_ratios(torch, runs["dp"][0], ref["params"], before))
            floor_step = largest(step_ratios(torch, runs["plain_again"][0], ref["params"], before))
            # One process's gradients at batch 2, float32 without TF32, then
            # both steps on exactly those gradients.
            m = copy.deepcopy(base)
            with float32_precision():
                loss_of(m)(batch).backward()
            grads = [(p.grad if p.grad is not None else torch.zeros_like(p)).detach()
                     for p in m.parameters()]
            ref["grads"] = {n: g.cpu() for (n, _), g in zip(m.named_parameters(), grads)}
            del m
            exact = {name: one_step(name, lambda m: exact_grad_loss(m, grads), None)
                     for name in ("plain", "dp")}
            if not (params_equal(torch, exact["plain"][0], exact["dp"][0])
                    and exact["plain"][1] == exact["dp"][1]):
                fail("one-rank NCCL DP step on exact gradients differs from make_train_step's")
            del exact, grads
            report.update(losses=losses, dp_vs_plain=dp_err, plain_vs_plain=floor,
                          dp_vs_plain_of_step=dp_step_err, plain_vs_plain_of_step=floor_step,
                          exact_grads_bit_equal=True)
            times = {}
            for name in ("plain", "dp", "dp_again", "plain_again"):
                key = name.replace("_again", "")
                rep = timed_steps(np, torch, wrappers, runs[key][2], batch, n_steps,
                                  must_fall=False)
                times.setdefault(key, []).append(rep["median_s_per_step"])
            report["s_per_step"] = times
            numel = sum(p.numel() for p in base.parameters())
            flat = torch.zeros(numel + 1, device=dev)
            report["allreduce_ms"] = cuda_ms(lambda: mesh.all_reduce_(flat), 10)
            report["bucket_bytes"] = 4 * (numel + 1)
            del runs
        finally:
            dist.destroy_process_group()
    return report, ref


def dp_rank(mesh, cfg, ref_path):
    """Phase 7e (b), one rank of two sharing cuda:0 over gloo (CUDA
    tensors through the host). Every launch counter is zeroed at the start
    and read at the end. Returns this rank's report."""
    import numpy as np
    import torch

    from premvos_tpu_torch.finetune.fused import finetune_video_fused
    from premvos_tpu_torch.finetune.multi_video import finetune_refine_videos
    from premvos_tpu_torch.models.deeplab import DeepLabV3Plus
    from premvos_tpu_torch.models.layers import init_module
    from premvos_tpu_torch.parallel.mesh import replicate, run_sequences_sharded
    from premvos_tpu_torch.pipeline.runner import build_models, init_params, place
    from premvos_tpu_torch.train.trainer import (
        create_train_state,
        make_dp_train_step,
        replicate_state,
        shard_train_batch,
    )

    dev = mesh.device
    wrappers = kernel_wrappers()
    for fn in wrappers.values():
        fn.launches = 0
    out = {"rank": mesh.rank, "device": str(dev)}

    # (i) Mask R-CNN at global batch 2, one image a rank, against one
    # process's step at batch 2: the averaged gradients Adam is given (the
    # optimizer's step records them) and the parameters after it.
    model, loss_of, batch = dp_maskrcnn_case(np, torch, dev)
    st = replicate_state(create_train_state(model, 1e-4), mesh)
    step = make_dp_train_step(loss_of(model), st.optimizer, mesh)
    grads, adam_step = {}, st.optimizer.step

    def record_then_step(*a, **k):
        grads.update({n: p.grad.detach().cpu() for n, p in model.named_parameters()})
        st.optimizer.step = adam_step  # the first step only
        return adam_step(*a, **k)

    st.optimizer.step = record_then_step
    local = shard_train_batch(batch, mesh)
    t0 = time.perf_counter()
    loss = float(step(local))
    first = time.perf_counter() - t0
    ref = torch.load(ref_path, weights_only=True)
    ratios = norm_ratios(torch, model, ref["params"])
    grad_err = {n: float((g - ref["grads"][n]).abs().max()
                         / ref["grads"][n].abs().max().clamp_min(1e-30)) for n, g in grads.items()}
    out["maskrcnn"] = dict(loss=loss, first_step_s=first, grads_vs_plain=largest(grad_err),
                           params_vs_plain=largest(ratios), digest=digest(model),
                           grad_numel=sum(p.numel() for p in model.parameters()))
    grads.clear()
    t0 = time.perf_counter()
    for _ in range(3):
        step(local)
    torch.cuda.synchronize(dev)
    out["maskrcnn"]["s_per_step"] = (time.perf_counter() - t0) / 3
    del model, st, step
    # The DP step on exact gradients: rank r's are one process's gradients
    # at batch 2 times r + 1 (exact_grad_loss), with the parameters' strides.
    model, _, _ = dp_maskrcnn_case(np, torch, dev)
    grads = [torch.empty_like(p).copy_(ref["grads"][n] * (mesh.rank + 1))
             for n, p in model.named_parameters()]
    st = replicate_state(create_train_state(model, 1e-4), mesh)
    make_dp_train_step(exact_grad_loss(model, grads), st.optimizer, mesh)(None)
    out["maskrcnn"]["exact_digest"] = params_digest(model)
    del model, st, grads
    torch.cuda.empty_cache()

    # (ii) Sequence-sharded inference at davis2017_val in float32.
    c32 = float32_cfg(cfg)
    models = init_params(build_models(c32, dev), c32, seed=0, device=dev)
    frames, gt = dp_sequences(np, c32)
    nobj = np.array([2, 2], np.int32)
    run_sequences_sharded(models, c32, frames, gt, nobj, mesh)  # warm-up
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    for m in models:  # the replication each call begins with, alone
        replicate(m, mesh)
    torch.cuda.synchronize(dev)
    replicate_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    labels = run_sequences_sharded(models, c32, frames, gt, nobj, mesh)
    torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    out["sharded"] = dict(wall_s=wall, replicate_s=replicate_s,
                          frames=int(frames.shape[0] * frames.shape[1]),
                          labels=labels.cpu().numpy() if mesh.rank == 0 else None,
                          labels_digest=hashlib.sha256(labels.cpu().numpy().tobytes()).hexdigest())
    del models
    torch.cuda.empty_cache()

    # (iii) The fused fine-tune over the mesh, 8 steps a net.
    ft = dataclasses.replace(cfg.finetune, steps=8)
    models = init_params(build_models(cfg, dev), cfg, seed=0, device=dev)
    p = cfg.pipeline
    frame0, lab0 = bench_finetune_frame(np, p.image_height, p.image_width)
    stats = {}
    t0 = time.perf_counter()
    tuned, losses = finetune_video_fused(models, frame0, lab0, cfg, ft, stats=stats, mesh=mesh)
    torch.cuda.synchronize(dev)
    out["fused"] = dict(
        wall_s=time.perf_counter() - t0, losses=losses,
        changed={n: changed(getattr(models, n), getattr(tuned, n)) for n in ("refine", "maskrcnn")},
        digests={n: digest(getattr(tuned, n)) for n in ("refine", "maskrcnn")},
        s_per_step={n: sum(c[1] for c in stats[k]["chunks"]) / ft.steps
                    for n, k in (("refine", "refine"), ("maskrcnn", "proposal"))})
    grad_numel = {n: sum(q.numel() for q in getattr(models, n).parameters())
                  for n in ("refine", "flow", "reid")}
    del models, tuned
    torch.cuda.empty_cache()

    # (iv) Two videos over the mesh, one a rank.
    model = DeepLabV3Plus(cfg.refine, getattr(torch, cfg.pipeline.dtype))
    init_module(model, torch.Generator().manual_seed(0))
    model = place(model, dev)
    videos = [(frame0, lab0), (np.ascontiguousarray(frame0[:, ::-1]),
                               np.ascontiguousarray(lab0[:, ::-1]))]
    t0 = time.perf_counter()
    vt, vlosses = finetune_refine_videos(model, videos, cfg.refine, ft, mesh=mesh)
    torch.cuda.synchronize(dev)
    out["videos"] = dict(wall_s=time.perf_counter() - t0, losses=[float(x) for x in vlosses],
                         changed=[changed(model, m) for m in vt], digests=[digest(m) for m in vt],
                         on_card=[next(m.parameters()).is_cuda for m in vt])
    del model, vt

    # (v) FlowNetC through train_flownet_c over the mesh: phase 7's step
    # (batch 8 of 256² crops, md 20), 4 pairs a rank.
    t0 = time.perf_counter()
    flow, flow_loss = flow_train_step(np, torch, mesh=mesh)
    torch.cuda.synchronize(dev)
    out["flow"] = dict(loss=flow_loss, wall_s=time.perf_counter() - t0, digest=digest(flow))
    del flow
    out["launches"] = {k: fn.launches for k, fn in wrappers.items()}

    # The all_reduce of each net's gradient bucket (float32, on the card,
    # through the host on gloo), after the launch window.
    grad_numel["maskrcnn"] = out["maskrcnn"]["grad_numel"]
    ms = {}
    for n, numel in grad_numel.items():
        flat = torch.zeros(numel + 1, device=dev)
        times = []
        for _ in range(4):
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            mesh.all_reduce_(flat)
            torch.cuda.synchronize(dev)
            times.append(1e3 * (time.perf_counter() - t0))
        ms[n] = dict(bytes=4 * (numel + 1), ms=statistics.median(times[1:]))
        del flat
    out["allreduce"] = ms
    return out


def dp_two_ranks(np, torch, cfg, ref):
    """Phase 7e (b): two gloo ranks sharing cuda:0 (parallel/dryrun.py::
    spawn), each running dp_rank; the checks and the report."""
    import tempfile

    from premvos_tpu_torch.parallel.dryrun import spawn
    from premvos_tpu_torch.parallel.mesh import as_mesh
    from premvos_tpu_torch.pipeline.runner import build_models, init_params, run_sequence
    from premvos_tpu_torch.train.trainer import create_train_state

    # The single-process references: each sequence alone, float32 (the
    # first run also warms up; the second's seconds are one process's rate).
    c32 = float32_cfg(cfg)
    frames, gt = dp_sequences(np, c32)
    models = init_params(build_models(c32), c32, seed=0)
    alone, alone_s = [], []
    for s in range(2):
        t0 = time.perf_counter()
        alone.append(run_sequence(models, c32, frames[s], gt[s], 2).cpu().numpy())
        alone_s.append(time.perf_counter() - t0)
    del models
    # One process's Adam step on the ranks' mean exact gradients ((g + 2g) / 2,
    # the sum rounded as the reduce rounds it), and its FlowNetC step.
    dev = torch.device("cuda", 0)
    model, _, _ = dp_maskrcnn_case(np, torch, dev)
    for n, p in model.named_parameters():
        g = ref["grads"][n].to(dev)
        p.grad = torch.empty_like(p).copy_((g + 2 * g) / 2)
    create_train_state(model, 1e-4).optimizer.step()
    exact_digest = params_digest(model)
    del model
    flow_loss = flow_train_step(np, torch, as_mesh(None, dev))[1]
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="premvos_dp_") as tmp:
        ref_path = os.path.join(tmp, "maskrcnn_after_one_step.pt")
        torch.save(ref, ref_path)
        t0 = time.perf_counter()
        ranks = spawn(dp_rank, 2, "gloo", cfg, ref_path, device="cuda:0")
        wall = time.perf_counter() - t0
    a, b = ranks
    # (i)
    mr = [r["maskrcnn"] for r in ranks]
    if mr[0]["digest"] != mr[1]["digest"]:
        fail("DP Mask R-CNN step: the two ranks' parameters differ")
    for r in mr:
        if not abs(r["loss"] - ref["loss"]) <= 1e-5 * abs(ref["loss"]):
            fail(f"DP Mask R-CNN step: loss {r['loss']} vs one process {ref['loss']}")
        err, name = r["grads_vs_plain"]
        if not err <= 1e-4:
            fail(f"DP Mask R-CNN step: {name}'s averaged gradient {err:.3g} of its largest "
                 "|grad| from one process's at batch 2")
        err, name = r["params_vs_plain"]
        if not err <= DP_PARAM_BOUND:
            fail(f"DP Mask R-CNN step: {name} {err:.3g} of its norm from one process's step "
                 f"(bound {DP_PARAM_BOUND})")
        if r["exact_digest"] != exact_digest:
            fail("DP Mask R-CNN step on exact gradients: parameters differ from one process's "
                 "Adam step on their mean")
    # (ii)
    labels = a["sharded"]["labels"]
    if a["sharded"]["labels_digest"] != b["sharded"]["labels_digest"]:
        fail("sharded inference: the ranks gathered different labels")
    ious = []
    for s in range(2):
        if not np.array_equal(labels[s, 0], alone[s][0]):
            fail(f"sharded inference: sequence {s} frame 0 differs from run_sequence's")
        rows = object_ious(np, labels[s], alone[s], c32.pipeline.max_objects)
        low = [(t, i, v) for t, row in enumerate(rows) for i, v in row["iou"].items()
               if v < CPU_IOU_MIN]
        if low:
            fail(f"sharded inference: sequence {s} object IoU below {CPU_IOU_MIN}: {low}")
        ious.append([row["iou"] for row in rows])
    # (iii), (iv)
    for r in ranks:
        f = r["fused"]
        if not all(np.isfinite(v) for v in f["losses"].values()) or not all(f["changed"].values()):
            fail(f"DP fused fine-tune on rank {r['rank']}: losses {f['losses']}, changed "
                 f"{f['changed']}")
        v = r["videos"]
        if not (np.isfinite(v["losses"]).all() and all(v["changed"]) and all(v["on_card"])):
            fail(f"DP two-video fine-tune on rank {r['rank']}: {v}")
    if a["fused"]["digests"] != b["fused"]["digests"]:
        fail("DP fused fine-tune: the two ranks' parameters differ")
    if a["videos"]["digests"] != b["videos"]["digests"]:
        fail("DP two-video fine-tune: the two ranks returned different nets")
    # (v)
    if a["flow"]["digest"] != b["flow"]["digest"]:
        fail("DP FlowNetC step: the two ranks' parameters differ")
    for r in ranks:
        if not abs(r["flow"]["loss"] - flow_loss) <= 1e-5 * abs(flow_loss):
            fail(f"DP FlowNetC step: loss {r['flow']['loss']} vs one process {flow_loss}")
    launches = {k: a["launches"][k] + b["launches"][k] for k in a["launches"]}
    missing = [k for k in DP_KERNELS if launches[k] <= 0]
    if missing:
        fail(f"kernels not launched on the data-parallel paths: {missing}")
    for r in ranks:
        r["sharded"].pop("labels")
    return dict(spawn_wall_s=wall, ranks=ranks, launches=launches, sharded_ious=ious,
                one_process_sequence_s=alone_s, one_process_flow_loss=flow_loss,
                sharded_frames_per_s=a["sharded"]["frames"] / max(a["sharded"]["wall_s"],
                                                                   b["sharded"]["wall_s"]),
                transport="gloo, CUDA tensors copied through the host (not NVLink); two "
                          "processes share one card's SMs: this shows the code path, not "
                          "scaling")


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
    from premvos_tpu_torch.pipeline.runner import build_models, init_params, run_sequence

    wrappers = kernel_wrappers()
    report = {}

    # Phase 1 — the card.
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    report["card"] = smi
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")

    # Phase 2 — build: the kernels (one nvcc a source) and, beside them, the
    # three host libraries (g++), all started together.
    from concurrent.futures import ThreadPoolExecutor

    from premvos_tpu_torch.io_compat import jpeg, rle_native, zstd

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(HOST_SOURCES)) as pool:
        host = [pool.submit(kernels.build_host, src) for src in HOST_SOURCES]
        lib_path = kernels.build()
        host_libs = [f.result() for f in host]
    kernels.load()
    jpeg.load()
    zstd.load()
    if not rle_native.available():
        fail("rle_native did not load")
    report["build_s"] = time.perf_counter() - t0
    log(f"built {os.path.basename(lib_path)} and "
        f"{', '.join(os.path.basename(h) for h in host_libs)} in {report['build_s']:.1f} s")
    with open(lib_path.replace("libpremvos_kernels_", "ptxas_").replace(".so", ".log")) as f:
        ptxas = [ln.strip() for ln in f if "registers" in ln or "Compiling entry" in ln]
    report["ptxas"] = ptxas

    # Phase 3 — each kernel vs its plain version at production shapes.
    cfg = load_config(os.path.join(REPO, "configs", "davis2017_val.json"))
    check_finetune_shapes(cfg)
    check_pool_shapes(cfg)
    check_stage_shapes(cfg)
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
    for i, kind in enumerate(LUCID_RESAMPLE_CASES):
        checks["resample2d"].append(
            check_lucid_resample(torch, torch.Generator().manual_seed(20 + i), dev, kind))
    # The fine-tune's proposal net: its RPN's NMS, and the training
    # RoIAlign forward and backward of its box and mask heads.
    checks["nms"].append(check_nms(torch, torch.Generator().manual_seed(30), dev, NMS_CASES[3]))
    for i, p_ft in enumerate(FT_ALIGN_PS):
        checks["roi_align"].append(check_roi_align_train(
            torch, torch.Generator().manual_seed(31 + i), dev, p_ft, torch.bfloat16, FT_BATCH,
            FT_HW))
        checks["roi_align_backward"].append(check_roi_align_backward(
            torch, torch.Generator().manual_seed(33 + i), dev, p_ft, "dense", FT_BATCH, FT_HW,
            "bfloat16"))
    # The host-pool fine-tune's proposal net, at the full canvas.
    checks["nms"].append(check_nms(torch, torch.Generator().manual_seed(50), dev, NMS_CASES[4]))
    for i, p_pool in enumerate(FT_ALIGN_PS):
        checks["roi_align"].append(check_roi_align_train(
            torch, torch.Generator().manual_seed(51 + i), dev, p_pool, torch.bfloat16,
            POOL_BATCH, POOL_HW))
        checks["roi_align_backward"].append(check_roi_align_backward(
            torch, torch.Generator().manual_seed(53 + i), dev, p_pool, "dense", POOL_BATCH,
            POOL_HW, "bfloat16"))
    # run_stages' proposals stage: the proposal net one frame at a time.
    for i, case in enumerate(NMS_CASES[STAGE_NMS:]):
        checks["nms"].append(check_nms(torch, torch.Generator().manual_seed(60 + i), dev, case))
    for i, case in enumerate(ROI_CASES[STAGE_ROI:]):
        checks["multilevel_roi_align"].append(
            check_roi_align(torch, torch.Generator().manual_seed(62 + i), dev, case))
    # FlowNetC training's cost volume, forward and gradient.
    train_gen = torch.Generator().manual_seed(41)
    checks["correlation"] += [check_correlation(torch, train_gen, dev, getattr(torch, dt), case)
                              for dt, case in CORR_TRAIN_CASES]
    grad_gen = torch.Generator().manual_seed(40)
    checks["correlation_backward"] = [check_correlation_backward(torch, grad_gen, dev, case)
                                      for case in CORR_GRAD_CASES]
    report["corr_grad_margins"] = corr_grad_margins(torch, dev)
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
    log("correlation backward, error as a share of its tolerance (1e-5 of each gradient's "
        "max |grad|), the CUDA test's cases: " + ", ".join(
            f"{k} df1 {v['df1']:.3f} df2 {v['df2']:.3f}"
            for k, v in report["corr_grad_margins"].items()))

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
    prod = track_preset(np, torch, wrappers, cfg)
    report["production"] = prod
    launches = prod["launches"]
    log(f"davis2017_val, {prod['frames']} frames: median {prod['median_s']:.3f} s → "
        f"{prod['frames_per_s']:.2f} frames/s, peak {prod['peak_bytes'] / 2**30:.2f} GiB, "
        f"launches {launches}")
    torch.cuda.empty_cache()

    # Phase 6 — tiny training step: CUDA (kernels) vs CPU (plain versions).
    report["tiny_training"] = tiny_train_parity(np, torch)
    log(f"tiny training: {report['tiny_training']}")
    report["tiny_training_group_norm"] = tiny_train_parity(np, torch, "group_norm")
    log(f"tiny training, group_norm: {report['tiny_training_group_norm']}")
    report["tiny_norm_xception"] = tiny_norm_xception_parity(np, torch)
    log(f"tiny group_norm refine and ReID, Xception-65 refine: {report['tiny_norm_xception']}")
    report["tiny_finetune"] = tiny_finetune_parity(np, torch)
    log(f"tiny fine-tune: {report['tiny_finetune']}")
    report["tiny_flow_reid"] = tiny_flow_reid_parity(np, torch)
    log(f"tiny FlowNetC and ReID training: {report['tiny_flow_reid']}")
    report["tiny_pool_finetune"] = tiny_pool_parity(np, torch)
    log(f"tiny host-pool fine-tune: {report['tiny_pool_finetune']}")

    # Phase 7 — Mask R-CNN training at full width.
    tr = train_full_width(np, torch, wrappers)
    report["training"] = tr
    log(f"training at full width: median {tr['median_s_per_step']:.4f} s/step → "
        f"{tr['images_per_s']:.2f} images/s, peak {tr['peak_bytes'] / 2**30:.2f} GiB, "
        f"losses {tr['losses']}, launches {tr['launches']}")

    torch.cuda.empty_cache()
    tr_gn = train_full_width(np, torch, wrappers, norm="group_norm")
    report["training_group_norm"] = tr_gn
    log(f"training at full width, group_norm: median {tr_gn['median_s_per_step']:.4f} s/step → "
        f"{tr_gn['images_per_s']:.2f} images/s, peak {tr_gn['peak_bytes'] / 2**30:.2f} GiB, "
        f"losses {tr_gn['losses']}, launches {tr_gn['launches']}")
    torch.cuda.empty_cache()

    # Phase 7, continued — the per-video fused fine-tune at full width.
    ftr, tuned = finetune_full_width(np, torch, wrappers, cfg)
    report["finetune"] = ftr
    log(f"fine-tune at davis2017_val, 40 steps per net: refine {ftr['refine']['s_per_step']:.4f} "
        f"s/step, proposal {ftr['proposal']['s_per_step']:.4f} s/step, inpaint "
        f"{ftr['inpaint_s']:.3f} s (host), peak {ftr['peak_bytes'] / 2**30:.2f} GiB, "
        f"losses {ftr['losses']}, launches {ftr['launches']}")
    ftr["tracked_labels_per_frame"] = track_after_finetune(np, torch, tuned, cfg)
    del tuned
    torch.cuda.empty_cache()

    # Phase 7, continued — FlowNetC and ReID training at full width.
    flow_tr = train_flow_full_width(np, torch, wrappers)
    report["train_flow"] = flow_tr
    log(f"FlowNetC training at full width: median {flow_tr['median_s_per_step']:.4f} s/step → "
        f"{flow_tr['images_per_s']:.2f} pairs/s, peak {flow_tr['peak_bytes'] / 2**30:.2f} GiB, "
        f"losses {flow_tr['losses']}, launches {flow_tr['launches']}")
    torch.cuda.empty_cache()
    reid_tr = train_reid_full_width(np, torch, wrappers)
    report["train_reid"] = reid_tr
    log(f"ReID training at full width: median {reid_tr['median_s_per_step']:.4f} s/step → "
        f"{reid_tr['images_per_s']:.2f} crops/s, peak {reid_tr['peak_bytes'] / 2**30:.2f} GiB, "
        f"losses {reid_tr['losses']}, launches {reid_tr['launches']}")
    torch.cuda.empty_cache()

    # Phase 7, continued — the host-pool fine-tune and refine training.
    pool_ft = pool_finetune_full_width(np, torch, wrappers, cfg)
    report["pool_finetune"] = pool_ft
    log(f"pool fine-tune at davis2017_val, 40 steps per net: host pool {pool_ft['pool_s']:.3f} s, "
        f"make_refine_examples {pool_ft['examples_s']:.3f} s ({pool_ft['examples']} examples), "
        f"refine {pool_ft['refine']['s_per_step']:.4f} s/step, proposal "
        f"{pool_ft['proposal']['s_per_step']:.4f} s/step, peak {pool_ft['peak_bytes']} bytes, "
        "both nets changed")
    log(f"pool fine-tune: losses {pool_ft['losses']}, launches {pool_ft['launches']}, s/step "
        f"after the first chunk: refine {pool_ft['refine']['s_per_step_after_first_chunk']:.4f}, "
        f"proposal {pool_ft['proposal']['s_per_step_after_first_chunk']:.4f}")
    torch.cuda.empty_cache()
    mv = multi_video_full_width(np, torch, wrappers, cfg)
    report["multi_video"] = mv
    log(f"multi-video refine fine-tune, 2 videos at davis2017_val, 8 steps: {mv['wall_s']:.3f} s "
        f"(host pools and examples included), losses {mv['losses']}, peak {mv['peak_bytes']} "
        f"bytes, launches {mv['launches']}, both copies on the card and changed")
    torch.cuda.empty_cache()
    refine_tr = train_refine_full_width(np, torch, wrappers)
    report["train_refine"] = refine_tr
    log(f"refine training at full width: median {refine_tr['median_s_per_step']:.4f} s/step → "
        f"{refine_tr['images_per_s']:.2f} crops/s, peak {refine_tr['peak_bytes']} bytes, "
        f"losses {refine_tr['losses']}")
    torch.cuda.empty_cache()

    # Phase 7, continued — Xception-65: refine training and inference.
    xrefine_tr = train_refine_full_width(np, torch, wrappers, backbone="xception65")
    report["train_refine_xception65"] = xrefine_tr
    log(f"refine training at full width, Xception-65: median "
        f"{xrefine_tr['median_s_per_step']:.4f} s/step → {xrefine_tr['images_per_s']:.2f} "
        f"crops/s, peak {xrefine_tr['peak_bytes']} bytes, losses {xrefine_tr['losses']}")
    torch.cuda.empty_cache()
    xinf = track_preset(np, torch, wrappers, dataclasses.replace(
        cfg, refine=dataclasses.replace(cfg.refine, backbone="xception65")))
    report["production_xception65"] = xinf
    log(f"davis2017_val with Xception-65, {xinf['frames']} frames: median {xinf['median_s']:.3f} s "
        f"→ {xinf['frames_per_s']:.2f} frames/s (ResNet: "
        f"{report['production']['frames_per_s']:.2f}), peak {xinf['peak_bytes'] / 2**30:.2f} GiB "
        f"(ResNet: {report['production']['peak_bytes'] / 2**30:.2f}), launches {xinf['launches']}")
    torch.cuda.empty_cache()

    # Phase 7b — the DAVIS command lines and the merge-tuning replay.
    t0 = time.perf_counter()
    cli = davis_cli_full_width(np, torch, wrappers, cfg)
    cli["phase_s"] = time.perf_counter() - t0
    report["davis_cli"] = cli
    rd, rp = cli["run_davis"], cli["replay"]
    log(f"run_davis at davis2017_val, 2 x 9 frames of 480x854 PNG: {rd['frames_per_s']:.2f} "
        f"tracked frames/s ({rd['summary']['seconds']:.3f} s), {rd['frames_per_s_with_host']:.2f} "
        f"with the host's PNG and J&F work ({rd['host']}), wall {rd['wall_s']:.2f} s, peak "
        f"{rd['peak_bytes']} bytes, J&F {rd['summary']['J&F']:.4f}, launches {rd['launches']}")
    log(f"PNG decode: port frame {rd['png']['port_frame_s']:.4f} s, Paeth-filtered frame "
        f"{rd['png']['paeth_frame_s']:.3f} s")
    log(f"run_davis --finetune (40 steps a net), 1 sequence: wall "
        f"{cli['run_davis_finetune']['wall_s']:.2f} s, launches "
        f"{cli['run_davis_finetune']['launches']}")
    log("run_stages, 5 frames: " + ", ".join(
        f"{k} {v['wall_s']:.2f} s {v['launches']}" for k, v in cli["run_stages"].items()))
    log(f"replay: precompute {rp['precompute_s']:.3f} s for {rp['steps']} steps "
        f"({rp['bytes_per_step']:.0f} bytes a step on the card); candidates "
        + ", ".join(f"{k}: J&F {v['jf']:.4f}, merge {v['merge_s']:.3f} s, with J&F "
                    f"{v['with_jf_s']:.3f} s" for k, v in rp["candidates"].items())
        + f"; agreement with run_davis {rp['agreement']}; launches {rp['launches']}; "
        f"phase {cli['phase_s']:.1f} s")

    torch.cuda.empty_cache()

    # Phase 7c — the held-out synthetic protocol, cut.
    syn = synthetic_protocol_cut(np, torch, wrappers)
    report["synthetic"] = syn
    log(f"synthetic protocol (cut: {' '.join(SYNTHETIC_CUT)}): wall {syn['wall_s']:.1f} s, "
        f"held-out J&F {syn['held_out']['J&F']:.4f}, oracle "
        f"{syn['held_out']['oracle_selection_JF']:.4f}, with fine-tune "
        f"{syn['finetune']['with_finetune_JF']:.4f}, seconds {syn['seconds']}, launches "
        f"{syn['launches']}")
    torch.cuda.empty_cache()

    # Phase 7d — converted checkpoints, JPEG frames, rle_native, mask_iou.
    t0 = time.perf_counter()
    src, dst, conv = converted_nets(np, torch, cfg)
    log("converters at davis2017_val, host s: " + ", ".join(
        f"{k} {v['convert_s']:.3f} (checkpoint written in {v['checkpoint_write_s']:.3f}, "
        f"{v['converted']} tensors)" for k, v in conv.items()) + "; every parameter equal")
    track = track_converted(np, torch, wrappers, cfg, src, dst)
    log(f"run_sequence on converted weights, {track['frames']} frames: {track['run_s']:.3f} s → "
        f"{track['frames_per_s']:.2f} frames/s, peak {track['peak_bytes']} bytes, labels equal "
        f"to the source nets', launches {track['launches']}; on {track['cpu_frames']} frames, "
        f"CPU s {track['cpu_s']}, object IoU and union agreement by frame: " + "; ".join(
            f"{name} " + ", ".join(f"{row['iou']} {row['union_agreement']:.5f}" for row in rows)
            for name, rows in track["cuda_vs_cpu"].items()))
    del src
    torch.cuda.empty_cache()
    jpg = jpeg_full_width(np, torch, wrappers, cfg, dst)
    log(f"JPEG 480x854 decode (port, no Pillow): {jpg['jpeg_decode_ms']} ms a frame; PNG decode "
        f"of the same pixels {jpg['png_decode_ms']} ms; run_davis --checkpoint on the JPEG tree: "
        f"{jpg['frames_per_s']:.2f} tracked frames/s, wall {jpg['wall_s']:.2f} s, checkpoint "
        f"saved in {jpg['checkpoint_save_s']:.2f} s, launches {jpg['launches']}")
    cr = jpg["codings_run"]
    log("JPEG 480x854 decode by coding, ms a frame (Huffman above): " + ", ".join(
        f"{c} {ms:.3f}" for c, ms in zip(jpg["codings"], jpg["codings_decode_ms"]))
        + f"; run_davis --checkpoint on {len(cr['labelled_pixels'])} frames cycling through "
        f"them: {cr['frames_per_s']:.2f} tracked frames/s, wall {cr['wall_s']:.2f} s, "
        f"launches {cr['launches']}")
    del dst
    torch.cuda.empty_cache()
    codecs = codecs_full_width(np, torch)
    log(f"rle_native vs numpy RLE at 480x854, encode + decode ms: "
        + ", ".join(f"{r['runs']} runs {r['native_ms']:.3f} vs {r['numpy_ms']:.3f}"
                    for r in codecs["rle"]) + "; mask_iou on the card equals the CPU's")
    report["converted"] = dict(converters=conv, track=track, jpeg=jpg, codecs=codecs,
                               phase_s=time.perf_counter() - t0)
    torch.cuda.empty_cache()

    # Phase 7f — the JAX package's own orbax checkpoint, read without JAX.
    t0 = time.perf_counter()
    orb = orbax_full_width(np, torch, wrappers, cfg)
    orb["phase_s"] = time.perf_counter() - t0
    report["orbax"] = orb
    ob, orun = orb["read"], orb["run"]
    log(f"orbax checkpoint at davis2017_val: read {ob['arrays']} arrays, {ob['bytes']} bytes in "
        f"{ob['read_s']:.3f} s of host time ({ob['mb_per_s']:.1f} MB/s), every sha256 equal "
        f"(hashed in {ob['sha256_s']:.3f} s); run_davis --checkpoint <orbax dir>, "
        f"{len(orun['labelled_pixels'])} frames: {orun['frames_per_s']:.2f} tracked frames/s "
        f"({orun['summary']['seconds']:.3f} s), wall {orun['wall_s']:.2f} s, labelled pixels "
        f"{orun['labelled_pixels']}, launches {orun['launches']}; float32: orbax wall "
        f"{orb['run_f32_orbax']['wall_s']:.2f} s, model.pt wall {orb['run_f32_pt']['wall_s']:.2f} "
        f"s (written in {orb['model_pt_s']:.2f} s), labels equal, object IoUs "
        f"{orb['f32_object_ious']}; zstd refusals {orb['zstd_refusals']}; phase "
        f"{orb['phase_s']:.1f} s")
    torch.cuda.empty_cache()

    # Phase 7e — data parallelism: one rank on NCCL, two ranks sharing the
    # card on gloo.
    t0 = time.perf_counter()
    dp1, dp_ref = dp_one_rank_nccl(np, torch, wrappers)
    log(f"one-rank NCCL mesh, Mask R-CNN at full width: loss {dp1['losses']}; the DP step's "
        f"farthest parameter from make_train_step's {dp1['dp_vs_plain'][1]} "
        f"{dp1['dp_vs_plain'][0]:.3g} of its norm ({dp1['dp_vs_plain_of_step'][0]:.3g} of its "
        f"step), two plain steps' {dp1['plain_vs_plain'][1]} {dp1['plain_vs_plain'][0]:.3g} "
        f"({dp1['plain_vs_plain_of_step'][0]:.3g}); on exact gradients the DP step equals "
        f"make_train_step bit for bit; s/step plain {dp1['s_per_step']['plain']}, DP "
        f"{dp1['s_per_step']['dp']}; NCCL all_reduce of {dp1['bucket_bytes']} bytes "
        f"{dp1['allreduce_ms']:.3f} ms")
    torch.cuda.empty_cache()
    dp2 = dp_two_ranks(np, torch, cfg, dp_ref)
    ref_loss = dp_ref["loss"]
    del dp_ref
    r0, r1 = dp2["ranks"]
    log(f"two gloo ranks on one card ({dp2['transport']}), spawn wall {dp2['spawn_wall_s']:.1f} s: "
        f"Mask R-CNN global batch 2 loss {r0['maskrcnn']['loss']} / {r1['maskrcnn']['loss']} (one "
        f"process {ref_loss}), farthest gradient from one process's at batch 2 "
        f"{r0['maskrcnn']['grads_vs_plain'][1]} {r0['maskrcnn']['grads_vs_plain'][0]:.3g} of its "
        f"largest |grad|, farthest parameter after Adam {r0['maskrcnn']['params_vs_plain'][1]} "
        f"{r0['maskrcnn']['params_vs_plain'][0]:.3g} of its norm (on exact gradients: one "
        f"process's Adam step on their mean, bit for bit), s/step "
        f"{r0['maskrcnn']['s_per_step']:.4f} "
        f"/ {r1['maskrcnn']['s_per_step']:.4f}; sharded davis2017_val float32, 2 x 9 frames: "
        f"{dp2['sharded_frames_per_s']:.2f} frames/s (of its {r0['sharded']['wall_s']:.2f} s, "
        f"replicating the nets from rank 0 through the host {r0['sharded']['replicate_s']:.2f} "
        f"s; one process alone: a 9-frame sequence in {dp2['one_process_sequence_s'][1]:.2f} s), "
        f"object IoUs vs run_sequence "
        f"{dp2['sharded_ious']}; fused fine-tune 8 steps a net: losses {r0['fused']['losses']}, "
        f"s/step {r0['fused']['s_per_step']} / {r1['fused']['s_per_step']}; two videos: losses "
        f"{r0['videos']['losses']}, wall {r0['videos']['wall_s']:.2f} / "
        f"{r1['videos']['wall_s']:.2f} s; FlowNetC step (4 pairs a rank) loss "
        f"{r0['flow']['loss']} (one process {dp2['one_process_flow_loss']}), wall "
        f"{r0['flow']['wall_s']:.2f} / {r1['flow']['wall_s']:.2f} s; all_reduce ms of each "
        f"net's gradient bytes "
        f"{r0['allreduce']}; launches {dp2['launches']}")
    report["data_parallel"] = dict(one_rank_nccl=dp1, two_ranks_gloo=dp2,
                                   phase_s=time.perf_counter() - t0)
    torch.cuda.empty_cache()

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

    # Each kernel's launches in each path's own zeroed window, and their sum.
    by_path = {name: {path: counts[name] for path, counts, names in (
        ("inference", launches, INFERENCE_KERNELS),
        ("training", tr["launches"], TRAINING_KERNELS),
        ("finetune", ftr["launches"], FINETUNE_KERNELS),
        ("train_flow", flow_tr["launches"], FLOW_TRAIN_KERNELS),
        ("pool_finetune", pool_ft["launches"], POOL_FINETUNE_KERNELS),
        ("davis_cli", rd["launches"], INFERENCE_KERNELS),
        ("davis_cli_finetune", cli["run_davis_finetune"]["launches"],
         FINETUNE_KERNELS + INFERENCE_KERNELS),
        ("stages_cli", {k: sum(v["launches"][k] for v in cli["run_stages"].values())
                        for k in KERNELS}, STAGES_KERNELS),
        ("replay", rp["launches"], ("resample2d",)),
        ("training_group_norm", tr_gn["launches"], TRAINING_KERNELS),
        ("inference_xception65", xinf["launches"], INFERENCE_KERNELS),
        ("synthetic", syn["launches"], tuple(KERNELS)),
        ("converted_inference", track["launches"], INFERENCE_KERNELS),
        ("davis_cli_jpeg", jpg["launches"], INFERENCE_KERNELS),
        ("davis_cli_jpeg_codings", jpg["codings_run"]["launches"], INFERENCE_KERNELS),
        ("davis_cli_orbax", orun["launches"], INFERENCE_KERNELS),
        ("dp", dp2["launches"], DP_KERNELS)) if name in names}
        for name in KERNELS}
    kernels_line = []
    for name, (source, replaces) in KERNELS.items():
        main = checks[name][0]
        kernels_line.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": sum(by_path[name].values()), "launches_by_path": by_path[name],
            "max_abs_err": main["max_abs_err"],
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
