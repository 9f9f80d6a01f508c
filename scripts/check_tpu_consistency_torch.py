#!/usr/bin/env python3
"""CUDA-against-CPU consistency of the port's pipeline on a tiny
configuration (port of scripts/check_tpu_consistency.py).

    python3 scripts/check_tpu_consistency_torch.py [--json PATH]

Runs the JAX script's tiny pipeline (ResNet-50 backbones, 32 FPN channels,
FlowNetC alone at max displacement 4 on 64×64, float32; three 64×64
frames, two 10×10 objects) with the same seeded weights on the card, where
the CUDA kernels run, and on the CPU, where their plain versions run, and
compares the tracked labels: the share of all pixels on which they agree,
and each object's IoU on each frame over the pixels either labels. It
fails when the share, or the IoU of an object that either device labels
on MIN_OBJECT_PIXELS pixels or more, falls below the JAX script's 0.97, or
frame 0 differs; smaller objects are reported. Without a card it exits
with an error and checks nothing: the check is of the card.

`check()` is what chip_smoke.py's phase 4 calls. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# The JAX script's bound on the share of agreeing pixels; here also on
# each object's IoU.
THRESHOLD = 0.97
# The IoU bound holds objects that either device labels on this many
# pixels of a frame or more (chip_smoke.py phase 7i's floor). At random
# weights a mask value within rounding of the threshold can make a
# one-pixel object on one device: on "NVIDIA H100 80GB HBM3, 700.00 W" the
# card labelled one pixel of frame 2 as object 1 and the CPU none (share
# 0.99992, every other object IoU 1.0).
MIN_OBJECT_PIXELS = 16


def tiny_config():
    """The JAX script's configuration (scripts/check_tpu_consistency.py:34-46):
    every other field at its default, so the merge warps at stride 1 and
    the crops and pastes run at "highest" precision, as fast_flownetc.json
    has them."""
    from premvos_tpu_torch.config import (
        FlowConfig,
        PipelineConfig,
        PremvosConfig,
        ProposalConfig,
        RefineConfig,
        ReIDConfig,
    )

    return PremvosConfig(
        proposal=ProposalConfig(
            backbone_depth=50, fpn_channels=32, rpn_pre_nms_topk=32,
            rpn_post_nms_topk=8, detections_per_frame=4,
        ),
        refine=RefineConfig(crop_size=33, backbone_depth=50),
        flow=FlowConfig(variant="flownetc", max_displacement=4, infer_height=64, infer_width=64),
        reid=ReIDConfig(backbone_depth=50, embedding_dim=8, crop_size=32),
        pipeline=PipelineConfig(image_height=64, image_width=64, max_objects=2, max_proposals=4,
                                dtype="float32"),
    )


def video():
    """The JAX script's three frames (seed 0) and two annotations."""
    rng = np.random.default_rng(0)
    frames = rng.integers(0, 255, (3, 64, 64, 3)).astype(np.uint8)
    gt = np.zeros((2, 64, 64), np.float32)
    gt[0, 10:20, 10:20] = 1.0
    gt[1, 40:50, 40:50] = 1.0
    return frames, gt


def run_on(device) -> np.ndarray:
    """The tiny pipeline's labels [3, 64, 64] on `device`, weights seeded 0
    (drawn on the CPU, so every device gets the same)."""
    from premvos_tpu_torch.pipeline.runner import build_models, init_params, run_sequence

    cfg = tiny_config()
    models = init_params(build_models(cfg, device=device), cfg, seed=0, device=device)
    frames, gt = video()
    return run_sequence(models, cfg, frames, gt, 2, device=device).cpu().numpy()


def object_ious(a: np.ndarray, b: np.ndarray, k: int) -> list:
    """[(frame, object, IoU, pixels)] of every object either label stack
    holds on a frame, over the `pixels` either labels as it."""
    out = []
    for t, (la, lb) in enumerate(zip(a, b)):
        for i in range(1, k + 1):
            union = int(((la == i) | (lb == i)).sum())
            if union:
                out.append((t, i, float(((la == i) & (lb == i)).sum()) / union, union))
    return out


def check(device="cuda") -> dict:
    """The tiny pipeline on `device` against the CPU: the share of agreeing
    pixels, the foreground share (over pixels either labels, as the JAX
    script prints), every object's IoU, the least IoU of the objects of
    MIN_OBJECT_PIXELS or more, the pixels each labels a frame, and `ok`
    (agreement and that least IoU at least THRESHOLD, frame 0 equal)."""
    got, want = run_on(device), run_on("cpu")
    fg = (got > 0) | (want > 0)
    ious = object_ious(got, want, tiny_config().pipeline.max_objects)
    agree = float((got == want).mean())
    least = min((v for _, _, v, n in ious if n >= MIN_OBJECT_PIXELS), default=1.0)
    return dict(
        device=str(device), agreement=agree,
        foreground_agreement=float((got == want)[fg].mean()) if fg.any() else 1.0,
        object_iou=ious, min_object_iou=least,
        labelled=[[int((x[t] > 0).sum()) for t in range(len(x))] for x in (got, want)],
        frame0_equal=bool(np.array_equal(got[0], want[0])),
        ok=agree >= THRESHOLD and least >= THRESHOLD and bool(np.array_equal(got[0], want[0])),
    )


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--json", help="also write the result (JSON) here")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("check_tpu_consistency_torch: no CUDA device; this check holds the card "
              "against the CPU and has nothing to check without one", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    result = check("cuda")
    print(f"label agreement: {result['agreement']:.4f}  (foreground-region: "
          f"{result['foreground_agreement']:.4f}), least IoU of an object of "
          f"{MIN_OBJECT_PIXELS} pixels or more {result['min_object_iou']:.4f}, pixels labelled "
          f"a frame (CUDA, CPU) {result['labelled']}, objects (frame, id, IoU, pixels) "
          f"{result['object_iou']}")
    if args.json:
        with open(args.json, "w") as f:
            json.dump(result, f, indent=1)
    if not result["ok"]:
        print(f"FAIL: the card and the CPU part beyond {THRESHOLD} (or on frame 0)")
        return 1
    print("PASS")
    return 0


if __name__ == "__main__":
    sys.exit(main())
