#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (premvos_tpu_torch) on one CUDA card.

    python3 chip_smoke.py [--json PATH]     # from the root of a checkout

Phases (any failure raises and exits non-zero):
  1. the card's name and power limit (nvidia-smi);
  2. build the four CUDA kernels from premvos_tpu_torch/kernels/*.cu with
     nvcc for sm_90a;
  3. hold each kernel against its plain PyTorch version on the card at the
     shapes of the production path (configs/davis2017_val.json), and time
     kernel, plain version, a PyTorch library call where one computes the
     same function, and the least time the card could take (bound);
  4. run a tiny configuration end to end on CUDA (kernels) and on the CPU
     (plain versions) with the same seeded weights: ≥ 99 % label agreement;
  5. run `run_sequence` at configs/davis2017_val.json with seeded random
     weights on 9 synthetic frames (one chunk): a warm-up run, then three
     timed runs; launch counters are zeroed just before the first timed run
     and read just after it, and every kernel must have launched.

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

# Published peaks of one H100 SXM (dense): HBM bytes/s and float32 FLOP/s
# outside the tensor cores (the kernels' arithmetic type).
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12

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
}


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


def bound_ms(nbytes: float, flops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_abs(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


# ------------------------------------------------------------- phase 3

def check_nms(torch, gen, dev, case):
    from premvos_tpu_torch.ops.nms import nms_cuda, nms_reference

    b, n, k, thr, score_thr = case
    xy = torch.rand(b, n, 2, generator=gen) * torch.tensor([864.0, 480.0])
    wh = torch.rand(b, n, 2, generator=gen) * 200.0 + 4.0
    boxes = torch.cat([xy, xy + wh], -1).to(dev)
    scores = torch.rand(b, n, generator=gen).to(dev)
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
    return dict(shape=f"boxes [{b},{n},4], keep {k}, iou {thr}", max_abs_err=err,
                tol="exact", ms=ms, plain_ms=plain, bound=bnd, library_ms=None)


def check_roi_align(torch, gen, dev, n_rois, p):
    from premvos_tpu_torch.models.maskrcnn import roi_levels
    from premvos_tpu_torch.ops.roi_align import (
        multilevel_roi_align_cuda,
        multilevel_roi_align_reference,
    )

    b, c = 8, 256
    shapes = [(120, 216), (60, 108), (30, 54), (15, 27)]
    feats = [
        torch.randn(b, h, w, c, generator=gen).to(dev, torch.bfloat16)
        for h, w in shapes
    ]
    size = torch.exp(torch.rand(b, n_rois, 1, generator=gen) * 4.5) * 8.0
    ctr = torch.rand(b, n_rois, 2, generator=gen) * torch.tensor([864.0, 480.0])
    boxes = torch.cat([ctr - size / 2, ctr + size / 2], -1).clamp(0, 864).to(dev)
    levels = roi_levels(boxes)
    got = multilevel_roi_align_cuda(feats, boxes, levels, p, 2)
    want = multilevel_roi_align_reference(feats, boxes, levels, p, 2)
    err = max_abs(got, want)
    # bf16 output: allow 2 ulp at the largest magnitude (the two sides round
    # differently-ordered float32 sums).
    tol = 2.0 ** -7 * float(want.float().abs().max())
    if not err <= tol:
        fail(f"multilevel_roi_align P={p}: max |diff| {err} > {tol}")
    ms = cuda_ms(lambda: multilevel_roi_align_cuda(feats, boxes, levels, p, 2), 20)
    plain = cuda_ms(
        lambda: multilevel_roi_align_reference(feats, boxes, levels, p, 2), 3, warmup=1
    )
    # Bytes: the feature pixels this run's boxes sample (each once), boxes,
    # and the output. Ops: 4 taps × 2 + 2 per sample per channel.
    touched = 0
    s = 2
    for li, ((h, w), stride) in enumerate(zip(shapes, (4, 8, 16, 32))):
        on = levels == li + 2
        bx = boxes * (1.0 / stride) - 0.5
        g = (torch.arange(p * s, device=dev, dtype=torch.float32) + 0.5) / (p * s)
        ys = bx[..., 1:2] + g * (bx[..., 3:4] - bx[..., 1:2]).clamp(min=1e-6)
        xs = bx[..., 0:1] + g * (bx[..., 2:3] - bx[..., 0:1]).clamp(min=1e-6)
        y0 = ys.clamp(0, h - 1).floor().long()
        x0 = xs.clamp(0, w - 1).floor().long()
        for img in range(b):
            mask = torch.zeros(h, w, dtype=torch.bool, device=dev)
            for yy in (y0[img], (y0[img] + 1).clamp(max=h - 1)):
                for xx in (x0[img], (x0[img] + 1).clamp(max=w - 1)):
                    sel = on[img]
                    idx = yy[sel][:, :, None] * w + xx[sel][:, None, :]
                    mask.view(-1)[idx.reshape(-1)] = True
            touched += int(mask.sum())
    nbytes = touched * c * 2 + boxes.numel() * 4 + got.numel() * 2
    flops = b * n_rois * p * p * c * s * s * 10
    return dict(shape=f"P2..P5 bf16 [8,H,W,256], {n_rois} RoIs/image, P={p}",
                max_abs_err=err, tol=tol, ms=ms, plain_ms=plain,
                bound=bound_ms(nbytes, flops), library_ms=None)


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


def check_correlation(torch, gen, dev):
    from premvos_tpu_torch.ops.correlation import correlation_cuda, correlation_reference

    b, c, h, w, md, st = 8, 256, 56, 104, 20, 2
    f1 = torch.randn(b, h, w, c, generator=gen).to(dev).permute(0, 3, 1, 2)
    f2 = torch.randn(b, h, w, c, generator=gen).to(dev).permute(0, 3, 1, 2)
    got = correlation_cuda(f1, f2, md, st)
    want = correlation_reference(f1, f2, md, st)
    err = max_abs(got, want)
    tol = 1e-5
    if not err <= tol:
        fail(f"correlation: max |diff| {err} > {tol}")
    ms = cuda_ms(lambda: correlation_cuda(f1, f2, md, st), 20)
    plain = cuda_ms(lambda: correlation_reference(f1, f2, md, st), 3, warmup=1)
    prev_tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    bmm_err = max_abs(corr_bmm(torch, f1, f2, md, st), want)
    bmm_ms = cuda_ms(lambda: corr_bmm(torch, f1, f2, md, st), 5)
    torch.backends.cuda.matmul.allow_tf32 = prev_tf32
    d2 = (2 * (md // st) + 1) ** 2
    nbytes = 2 * b * c * h * w * 4 + b * d2 * h * w * 4
    flops = 2.0 * b * h * w * d2 * c
    return dict(shape=f"f1, f2 [{b},{c},{h},{w}] f32 → [{b},{d2},{h},{w}]",
                max_abs_err=err, tol=tol, ms=ms, plain_ms=plain,
                bound=bound_ms(nbytes, flops), library_ms=None,
                bmm_formulation_ms=bmm_ms, bmm_formulation_err=bmm_err)


def check_resample(torch, gen, dev, b, c, h, w, dtype):
    import torch.nn.functional as F

    from premvos_tpu_torch.ops.resample2d import resample2d_cuda, resample2d_reference

    src = torch.rand(b, c, h, w, generator=gen).to(dev, dtype)
    yy, xx = torch.meshgrid(torch.arange(h), torch.arange(w), indexing="ij")
    smooth = torch.stack([9.0 + 30 * torch.sin(yy / 40.0), -6.0 + 20 * torch.cos(xx / 50.0)])
    flow = (smooth[None] + torch.randn(b, 2, h, w, generator=gen)).to(dev)
    got = resample2d_cuda(src, flow)
    want = resample2d_reference(src, flow)
    err = max_abs(got, want)
    tol = 1e-5
    if not err <= tol:
        fail(f"resample2d {src.shape}: max |diff| {err} > {tol}")
    ms = cuda_ms(lambda: resample2d_cuda(src, flow), 50)
    plain = cuda_ms(lambda: resample2d_reference(src, flow), 10)
    # grid_sample with border padding and align_corners=True is the same
    # clamped bilinear warp (on float32 input; the grid is built outside the
    # timed call).
    gx = (torch.arange(w, device=dev) + flow[:, 0]) / (w - 1) * 2 - 1
    gy = (torch.arange(h, device=dev)[:, None] + flow[:, 1]) / (h - 1) * 2 - 1
    grid = torch.stack([gx, gy], -1)
    srcf = src.float()

    def lib():
        return F.grid_sample(srcf, grid, "bilinear", "border", align_corners=True)

    lib_err = max_abs(lib(), want)
    lib_ms = cuda_ms(lib, 50)
    nbytes = src.numel() * src.element_size() + flow.numel() * 4 + got.numel() * 4
    flops = b * c * h * w * 8.0
    return dict(shape=f"src [{b},{c},{h},{w}] {str(dtype)[6:]}, flow f32",
                max_abs_err=err, tol=tol, ms=ms, plain_ms=plain,
                bound=bound_ms(nbytes, flops), library_ms=lib_ms,
                library_err=lib_err)


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
        "nms": [check_nms(torch, gen, dev, (8, 2384, 256, 0.7, 0.0)),
                check_nms(torch, gen, dev, (8, 256, 32, 0.5, 0.05))],
        "multilevel_roi_align": [check_roi_align(torch, gen, dev, 256, 7),
                                 check_roi_align(torch, gen, dev, 32, 14)],
        "correlation": [check_correlation(torch, gen, dev)],
        "resample2d": [check_resample(torch, gen, dev, 8, 3, 448, 832, torch.bfloat16),
                       check_resample(torch, gen, dev, 1, 8, 240, 432, torch.float32)],
    }
    torch.cuda.synchronize()
    report["kernel_checks"] = checks
    for name, rows in checks.items():
        for r in rows:
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
    missing = [k for k, v in launches.items() if v <= 0]
    if missing:
        fail(f"kernels not launched on the main path: {missing}")
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

    kernels_line = []
    for name, (source, replaces) in KERNELS.items():
        main = checks[name][0]
        kernels_line.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[name], "max_abs_err": main["max_abs_err"],
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
