#!/usr/bin/env python3
"""Where the time goes in the PyTorch port's Mask R-CNN training step on one
CUDA card.

    python3 scripts/profile_train_port.py [--steps N] [--json PATH]
    python3 scripts/profile_train_port.py --finetune [--steps N] [--json PATH]
    python3 scripts/profile_train_port.py --flow_reid [--steps N] [--json PATH]
    python3 scripts/profile_train_port.py --pool [--steps N] [--json PATH]
    python3 scripts/profile_train_port.py --dp [--root DIR] [--steps N] [--json PATH]

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

With --finetune, the fused per-video fine-tune step of each net instead
(finetune/fused.py at configs/davis2017_val.json, FinetuneConfig()
defaults, seeded random weights, bench.py's synthetic 480×864 frame): CUDA
event spans of the step's parts (draws; the batch, i.e. lucid augmentation
and example assembly; forward + loss; backward; Adam), then the device's
busy share and the largest kernels by name under torch.profiler.

With --flow_reid, the FlowNetC and ReID training steps of chip_smoke.py's
phase 7 instead (FlowNetC md 20, stride 2, batch 8 of 256² crops of
synthetic 384×512 pairs; ReIDConfig(), P 8 × K 4 synthetic 128² crops;
Adam 1e-4, float32 without TF32, seeded random weights, one fixed batch
each): the same spans (forward + loss; backward; Adam) and profile.

With --pool, first the host seconds of the lucid pool and its refine
examples at configs/davis2017_val.json with FinetuneConfig(steps=40) (64
images) and with its default steps (500 images), then the host-pool
fine-tune step of each net (finetune/finetune.py, the 64-image pool
uploaded once, each step's rows drawn as the fine-tune draws them) and the
refine-net training step of chip_smoke.py's phase 7 (RefineConfig(),
batch 8, float32, one fixed batch): the steps the package ships
(make_pool_train_step, make_train_step), with spans of the whole step,
forward + loss, backward, Adam and zero_grad timed from outside them (the
rest of the whole step is the gather and the host's work), and the
profile.

With --dp, the training step of the default mode through the steps the
package ships, in a world-size-1 NCCL group of this process (FileStore
rendezvous): make_train_step and make_dp_train_step from the same weights
on the same batch, in the order plain, DP, DP, plain, each `--steps` steps
after 3 warm-up ones, with the device's busy share, the largest kernels
and the largest host-side calls (the CUDA runtime's among them) under
torch.profiler. `--root DIR` imports the package from another checkout
(e.g. a parent commit unpacked by `git archive`), so two versions of the
step compare in one call.

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
    ap.add_argument("--finetune", action="store_true",
                    help="profile the fused fine-tune step of each net instead")
    ap.add_argument("--flow_reid", action="store_true",
                    help="profile the FlowNetC and ReID training steps instead")
    ap.add_argument("--pool", action="store_true",
                    help="profile the host-pool fine-tune steps and refine training instead")
    ap.add_argument("--dp", action="store_true",
                    help="profile make_dp_train_step at one NCCL rank beside make_train_step")
    ap.add_argument("--root", default=REPO, help="the checkout whose package --dp imports")
    args = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("profile_train_port: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(args.root) if args.dp else REPO)
    if args.dp:
        return profile_dp(args)
    if args.finetune:
        return profile_finetune(args)
    if args.flow_reid:
        return profile_flow_reid(args)
    if args.pool:
        return profile_pool(args)
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


def device_profile(torch, fn, steps: int, top: int = 15):
    """(wall ms per call, device busy ms per call, [(kernel, ms, count)]) of
    `steps` calls of fn() under torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / steps
    rows = sorted(((ev.key, ev.self_device_time_total / 1e3 / steps, ev.count / steps)
                   for ev in prof.key_averages()
                   if ev.device_type == DeviceType.CUDA
                   and not getattr(ev, "is_user_annotation", False)), key=lambda r: -r[1])
    return wall, sum(r[1] for r in rows), rows[:top]


def profile_parts(torch, name, step_of, steps: int, warmup: int = 3, top: int = 15) -> dict:
    """Spans and kernel profile of one training step. `step_of(timed)`
    returns the step, which runs each part as `timed(label, fn, *args)`:
    CUDA events around each part, summed over `steps` steps after `warmup`
    ones, then the device's busy share and the largest kernels by name
    under torch.profiler. Prints them and returns them as a dict."""
    spans = {}
    recording = [False]

    def timed(label, fn, *a):
        if not recording[0]:
            return fn(*a)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        r = fn(*a)
        end.record()
        spans.setdefault(label, []).append((start, end))
        return r

    step = step_of(timed)
    for _ in range(warmup):
        step()
    torch.cuda.synchronize()
    recording[0] = True
    t0 = time.perf_counter()
    for _ in range(steps):
        step()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3 / steps
    recording[0] = False
    span_ms = {lb: sum(a.elapsed_time(b) for a, b in v) / steps for lb, v in sorted(spans.items())}
    prof_wall, busy, rows = device_profile(torch, step, steps, top)
    print(f"{name}: wall {wall:.2f} ms/step")
    for lb, v in span_ms.items():
        print(f"  {lb:44s} {v:9.3f} ms/step")
    print(f"  profiled: wall {prof_wall:.2f} ms/step, device busy {busy:.2f} ms/step "
          f"({100 * busy / prof_wall:.1f} %)")
    for key, ms, n in rows:
        print(f"    {ms:9.3f} ms  {n:7.1f}  {key[:90]}")
    return {"wall_ms_per_step": wall, "span_ms_per_step": span_ms,
            "profiled_wall_ms_per_step": prof_wall, "device_busy_ms_per_step": busy,
            "kernels_per_step": [{"name": kk, "ms": ms, "count": n} for kk, ms, n in rows]}


def host_profile(torch, fn, steps: int, top: int = 12):
    """The largest host-side calls by self time (ms per call of fn) of
    `steps` calls under torch.profiler: the CUDA runtime's calls
    (cudaMalloc, cudaFree, synchronizations) among them."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
    rows = sorted(((ev.key, ev.self_cpu_time_total / 1e3 / steps, ev.count / steps)
                   for ev in prof.key_averages() if ev.device_type == DeviceType.CPU),
                  key=lambda r: -r[1])
    return rows[:top]


def profile_dp(args) -> int:
    """make_train_step and make_dp_train_step at one NCCL rank: spans of
    the whole step, the kernel profile and the host's largest calls."""
    import copy
    import tempfile

    import numpy as np
    import torch
    import torch.distributed as dist

    import chip_smoke
    from premvos_tpu_torch.parallel.mesh import make_mesh
    from premvos_tpu_torch.train.trainer import (
        create_train_state,
        make_dp_train_step,
        make_train_step,
        replicate_state,
    )

    print(f"package from {os.path.abspath(args.root)}", flush=True)
    base, loss_of, batch = chip_smoke.dp_maskrcnn_case(np, torch, torch.device("cuda", 0))
    out = {"root": os.path.abspath(args.root)}
    with tempfile.TemporaryDirectory(prefix="premvos_nccl_") as tmp:
        dist.init_process_group("nccl", store=dist.FileStore(os.path.join(tmp, "store"), 1),
                                rank=0, world_size=1)
        try:
            mesh = make_mesh(1, backend="nccl")
            steps = {}
            for name in ("plain", "dp"):
                m = copy.deepcopy(base)
                st = create_train_state(m, 1e-4)
                steps[name] = (make_train_step(loss_of(m), st.optimizer) if name == "plain" else
                               make_dp_train_step(loss_of(m),
                                                  replicate_state(st, mesh).optimizer, mesh))
            for key in ("plain", "dp", "dp_again", "plain_again"):
                step = steps[key.replace("_again", "")]
                res = profile_parts(torch, f"Mask R-CNN training step, {key}",
                                    lambda timed, step=step: lambda: timed("1 whole step", step,
                                                                           batch),
                                    args.steps)
                res["host_calls_per_step"] = [
                    {"name": kk, "ms": ms, "count": n}
                    for kk, ms, n in host_profile(torch, lambda: step(batch), args.steps)]
                for row in res["host_calls_per_step"]:
                    print(f"    host {row['ms']:9.3f} ms  {row['count']:7.1f}  {row['name'][:80]}")
                out[key] = res
            del steps
        finally:
            dist.destroy_process_group()
    return write_report(args, out)


def write_report(args, out: dict) -> int:
    """Print the card; with --json write `out` (and the card) there."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(smi)
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)), exist_ok=True)
        with open(args.json, "w") as f:
            json.dump({"card": smi, "steps": args.steps, **out}, f, indent=1)
    return 0


def profile_finetune(args) -> int:
    """Spans and kernel profile of each net's fused fine-tune step."""
    import numpy as np
    import torch

    import chip_smoke
    from premvos_tpu_torch.config import load_config
    from premvos_tpu_torch.finetune import fused
    from premvos_tpu_torch.pipeline.runner import build_models, float32_precision, init_params
    from premvos_tpu_torch.train.trainer import fresh_train_state

    cfg = load_config(os.path.join(REPO, "configs", "davis2017_val.json"))
    ft, p = cfg.finetune, cfg.pipeline
    hw, k = (p.image_height, p.image_width), p.max_objects
    dev = torch.device("cuda")
    models = init_params(build_models(cfg), cfg, seed=0)
    frame0, lab0 = chip_smoke.bench_finetune_frame(np, *hw)
    t0 = time.perf_counter()
    bg = fused.inpaint_background(frame0, lab0)
    inpaint_s = time.perf_counter() - t0
    prop_hw = fused.proposal_finetune_hw(hw, ft)
    nets = {
        "refine": (models.refine, fused.build_refine_fused_runs(hw, cfg.refine, ft, k),
                   fused._prep_consts(frame0, lab0, k, dev, bg)),
        "proposal": (models.maskrcnn,
                     fused.build_proposal_fused_runs(cfg.proposal, prop_hw, ft, k, dev),
                     fused._prep_consts(frame0, lab0, k, dev, bg, hw=prop_hw)),
    }
    out = {"inpaint_s": inpaint_s}
    print(f"inpaint_background at {hw[0]}x{hw[1]}: {inpaint_s:.3f} s (host)")
    for name, (module, run, consts) in nets.items():
        state = fresh_train_state(module, ft.learning_rate)
        m, opt = state.model, state.optimizer
        gen = torch.Generator(device=dev).manual_seed(0)
        host_gen = torch.Generator().manual_seed(0)

        def step_of(timed):
            def step():
                with float32_precision():
                    draws = timed("1 draws", run.draw, gen, host_gen)
                    batch = timed("2 batch (lucid augmentation + examples)", run.batch, draws,
                                  consts)
                    loss = timed("3 forward + loss", run.loss, m, batch)
                    timed("4 backward", loss.backward)
                    timed("5 Adam + zero_grad",
                          lambda: (opt.step(), opt.zero_grad(set_to_none=True)))
                return loss
            return step

        out[name] = profile_parts(torch, f"fine-tune step, {name} net", step_of, args.steps)
        del state, m, opt
    return write_report(args, out)


def profile_flow_reid(args) -> int:
    """Spans and kernel profile of the FlowNetC and ReID training steps."""
    import tempfile

    import numpy as np
    import torch

    import chip_smoke
    from premvos_tpu_torch.config import ReIDConfig
    from premvos_tpu_torch.data.flow_pairs import FlowPairDataset, make_synthetic_chairs
    from premvos_tpu_torch.models.flownet import FlowNetC
    from premvos_tpu_torch.models.layers import init_module
    from premvos_tpu_torch.models.reid import ReIDNet
    from premvos_tpu_torch.pipeline.runner import float32_precision, place
    from premvos_tpu_torch.train.train_flow import device_batch, flow_loss_fn
    from premvos_tpu_torch.train.train_reid import pk_device_batch, reid_loss_fn
    from premvos_tpu_torch.train.trainer import create_train_state

    dev = torch.device("cuda")
    flownet = FlowNetC(max_displacement=20)
    reid = ReIDNet(ReIDConfig())
    for model in (flownet, reid):
        init_module(model, torch.Generator().manual_seed(0))
        place(model, dev).train()
    with tempfile.TemporaryDirectory() as tmp:
        pairs = FlowPairDataset(make_synthetic_chairs(tmp, n=8, hw=(384, 512)))
        flow_batch = device_batch(pairs.batch(np.random.default_rng(1), 8, (256, 256)), dev)
    reid_batch = pk_device_batch(chip_smoke.SyntheticCrops(np, 128), np.random.default_rng(1),
                                 8, 4, dev)
    nets = {"flow": (flownet, flow_loss_fn(flownet), flow_batch),
            "reid": (reid, reid_loss_fn(reid, ReIDConfig().triplet_margin), reid_batch)}
    out = {}
    for name, (model, loss_fn, batch) in nets.items():
        opt = create_train_state(model, 1e-4).optimizer

        def step_of(timed):
            def step():
                with float32_precision():
                    loss = timed("1 forward + loss", loss_fn, batch)
                    timed("2 backward", loss.backward)
                    timed("3 Adam + zero_grad",
                          lambda: (opt.step(), opt.zero_grad(set_to_none=True)))
                return loss
            return step

        out[name] = profile_parts(torch, f"{name} training step", step_of, args.steps, top=20)
        del opt
    return write_report(args, out)


def shipped_spans(timed, loss_fn, optimizer):
    """Spans of a shipped train step's parts, timed from outside it: returns
    `loss_fn` wrapped ("2 forward + loss", and the loss's own backward as
    "3 backward"), and patches `optimizer`'s step ("4 Adam") and zero_grad
    ("5 zero_grad") on the instance. The step that is profiled is the one
    make_train_step / make_pool_train_step build."""

    def spanned(batch):
        loss = timed("2 forward + loss", loss_fn, batch)
        backward = loss.backward
        loss.backward = lambda: timed("3 backward", backward)
        return loss

    step, zero_grad = optimizer.step, optimizer.zero_grad
    optimizer.step = lambda: timed("4 Adam", step)
    optimizer.zero_grad = lambda set_to_none=True: timed("5 zero_grad", zero_grad, set_to_none)
    return spanned


def with_rest(res: dict) -> dict:
    """Adds the whole step's span less its parts' (the gather, the batch
    transform and the host's own work between the parts)."""
    spans = res["span_ms_per_step"]
    spans["0 rest (whole step less 2-5)"] = spans["1 whole step"] - sum(
        v for k, v in spans.items() if k[0] in "2345")
    print(f"  rest (whole step less its parts): {spans['0 rest (whole step less 2-5)']:.3f} ms/step")
    return res


def profile_pool(args) -> int:
    """Host seconds of the pool and its examples (at 40 steps' pool and at
    FinetuneConfig()'s), then spans and kernel profile of each net's
    host-pool fine-tune step and of the refine-net training step, each
    through the step the package ships."""
    import dataclasses

    import numpy as np
    import torch

    import chip_smoke
    from premvos_tpu_torch.config import RefineConfig, load_config
    from premvos_tpu_torch.finetune import finetune as ftmod
    from premvos_tpu_torch.parallel.mesh import as_mesh
    from premvos_tpu_torch.pipeline.runner import build_models, get_anchors, init_params
    from premvos_tpu_torch.train.train_refine import (
        example_batches,
        example_stream,
        train_refine,
    )
    from premvos_tpu_torch.train.trainer import (
        create_train_state,
        make_pool_train_step,
        make_train_step,
        sample_pool_draws,
    )

    cfg = load_config(os.path.join(REPO, "configs", "davis2017_val.json"))
    p = cfg.pipeline
    hw, k = (p.image_height, p.image_width), p.max_objects
    frame0, lab0 = chip_smoke.bench_finetune_frame(np, *hw)
    out = {}
    for steps in (40, cfg.finetune.steps):
        ft = dataclasses.replace(cfg.finetune, steps=steps, method="pool")
        t0 = time.perf_counter()
        imgs, labs = ftmod.build_lucid_pool(frame0, lab0, ft, seed=0)
        pool_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        crops, tgts = ftmod.make_refine_examples(imgs, labs, cfg.refine.crop_size,
                                                 cfg.refine.box_margin, np.random.default_rng(0))
        examples_s = time.perf_counter() - t0
        out[f"host_{steps}_steps"] = {"pool_s": pool_s, "pool": len(imgs),
                                      "examples_s": examples_s, "examples": len(crops)}
        print(f"host, {steps} steps: pool of {len(imgs)} {hw[0]}x{hw[1]} lucid images "
              f"{pool_s:.3f} s, {len(crops)} refine examples {examples_s:.3f} s", flush=True)
        if steps == 40:
            pool40 = (imgs, labs, crops, tgts)
        del imgs, labs, crops, tgts
    imgs, labs, crops, tgts = pool40
    ft = dataclasses.replace(cfg.finetune, steps=40, method="pool")
    dev = torch.device("cuda")
    models = init_params(build_models(cfg), cfg, seed=0)
    boxes, masks, valid = ftmod.proposal_pool(labs, k)
    seeds = np.random.default_rng(0).integers(0, 2**31 - 1, size=len(imgs)).astype(np.uint32)
    nets = {
        "refine": (models.refine, ftmod.refine_loss_fn, (crops, tgts), max(ft.batch_size, 1),
                   None),
        "proposal": (models.maskrcnn,
                     lambda m: ftmod.proposal_loss_fn(m, get_anchors(cfg, dev), cfg.proposal, hw),
                     (imgs, boxes, masks, valid), max(1, ft.batch_size // 2),
                     lambda batch, rows, salt: (*batch, seeds[rows] + np.uint32(salt))),
    }
    for name, (module, loss_of, pool, bs, transform) in nets.items():
        state = create_train_state(module, ft.learning_rate)
        draws = sample_pool_draws(torch.Generator().manual_seed(0), 64, len(pool[0]), bs)
        it = [0]

        def step_of(timed):
            shipped = make_pool_train_step(
                shipped_spans(timed, loss_of(state.model), state.optimizer), state.optimizer,
                pool, draws, as_mesh(None, dev), batch_transform=transform)

            def step():
                i = it[0] % len(draws.idx)
                it[0] += 1
                return timed("1 whole step", shipped, i)
            return step

        out[name] = with_rest(profile_parts(torch, f"pool fine-tune step, {name} net", step_of,
                                            args.steps))
        del state
    del models
    torch.cuda.empty_cache()
    ds = chip_smoke.SyntheticDavis(np, n_sequences=4)
    model, _ = train_refine(ds, RefineConfig(), steps=1, batch_size=8, log_every=0)
    batch = example_batches(example_stream(ds, RefineConfig(), np.random.default_rng(1)), 8,
                            dev)()
    opt = create_train_state(model, 1e-4).optimizer

    def refine_step_of(timed):
        shipped = make_train_step(shipped_spans(timed, ftmod.refine_loss_fn(model), opt), opt)
        return lambda: timed("1 whole step", shipped, batch)

    out["train_refine"] = with_rest(profile_parts(torch, "refine training step", refine_step_of,
                                                  args.steps, top=20))
    return write_report(args, out)


if __name__ == "__main__":
    sys.exit(main())
