#!/usr/bin/env python3
"""How far the port's float32 training gradients on one CUDA card are from
float64, and which library setting moves them.

    python3 scripts/check_train_precision.py [--json PATH]

One loss and its gradients of chip_smoke.py's tiny Mask R-CNN training case
(seeded weights, two 64×64 images), computed

  * on the CPU in float64 (the yardstick; RoIAlign's plain version and the
    mask-target crops still compute in float32) and in float32;
  * on CUDA as the port trains (float32, TF32 off: runner.float32_precision);
  * on CUDA with cuDNN disabled (PyTorch's own convolutions);
  * on CUDA with TF32 allowed (PyTorch's defaults for convolutions).

For each it prints the three parameters whose gradients are farthest from
float64, as max |diff| over that parameter's largest |grad|. Imports nothing
of JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--json", help="also write the results (JSON) here")
    args = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("check_train_precision: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import chip_smoke
    from premvos_tpu_torch.pipeline.runner import float32_precision, place
    from premvos_tpu_torch.train.detection import maskrcnn_loss_fn

    cfg, hw, model, anchors, batch = chip_smoke.tiny_train_case(np, torch)

    def grads(device, dtype, ctx):
        m = place(copy.deepcopy(model).to(dtype), torch.device(device)).train()
        for mod in m.modules():  # the layers' compute dtype
            if isinstance(getattr(mod, "dtype", None), torch.dtype):
                mod.dtype = dtype
        anc = {k: v.to(device, dtype) for k, v in anchors.items()}
        b = tuple(x.to(device, dtype) if x.is_floating_point() else x.to(device)
                  for x in batch)
        with ctx():
            loss = maskrcnn_loss_fn(m, anc, cfg, hw)(b)
            loss.backward()
        return loss.item(), {n: t.grad.double().cpu() for n, t in m.named_parameters()}

    @contextlib.contextmanager
    def without_cudnn():
        with float32_precision():
            torch.backends.cudnn.enabled = False
            try:
                yield
            finally:
                torch.backends.cudnn.enabled = True

    @contextlib.contextmanager
    def tf32_allowed():
        prev = torch.backends.cudnn.allow_tf32
        torch.backends.cudnn.allow_tf32 = True
        try:
            yield
        finally:
            torch.backends.cudnn.allow_tf32 = prev

    base_loss, base = grads("cpu", torch.float64, contextlib.nullcontext)
    runs = {
        "cpu float32": ("cpu", float32_precision),
        "cuda float32, TF32 off (the port)": ("cuda", float32_precision),
        "cuda float32, TF32 off, cuDNN disabled": ("cuda", without_cudnn),
        "cuda float32, TF32 allowed in cuDNN": ("cuda", tf32_allowed),
    }
    report = {"loss_float64": base_loss}
    for tag, (device, ctx) in runs.items():
        loss, g = grads(device, torch.float32, ctx)
        worst = chip_smoke.grad_ratios(g, base)[:3]
        report[tag] = {"loss": loss, "worst_grad_ratios": worst}
        print(f"{tag}: loss {loss} (float64 {base_loss})")
        for ratio, name in worst:
            print(f"    {ratio:.3e}  {name}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(smi)
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)), exist_ok=True)
        with open(args.json, "w") as f:
            json.dump({"card": smi, "torch": torch.__version__, **report}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
