#!/usr/bin/env python3
"""Where the correlation backward kernel's time goes, on one CUDA card.

    python3 scripts/corr_grad_breakdown.py [--json PATH]

Builds kernels/correlation.cu as it is and in variants that each leave out
one part of `corr_grad_kernel` (by text substitution; the script fails if a
part is not found), and gives each variant's device time by name
(torch.profiler over 50 calls) at chip_smoke.py's correlation backward
rows. Only the unchanged kernel's output is right: it is held against
`correlation_grads_reference` (1e-5 of each gradient's largest |value|).

  kernel        the kernel as it is
  one_product   big*big only, not 3xTF32 (so two thirds of the products
                are left out)
  no_products   no wgmma
  no_band       no staging of g's band (the A operand)
  no_source     no staging of the source columns (the B operand)
  write_only    none of those and no split: the loop, the barriers and the
                write-out of both gradients

Each variant is built in premvos_tpu_torch/kernels/build/breakdown/ with
nvcc, all at once, and bound with ctypes like the port's own library.
Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PRODUCTS = """          wgmma_tf32(acc, as[h], db);
          wgmma_tf32(acc, ab[h], ds);
          wgmma_tf32(acc, ab[h], db);"""
_BAND = "      if (row_on && u_i >= 0 && u_i < d) {\n        // The band"
_SOURCE = "      for (int kl = tid / kPieces; kl < kn; kl += blockDim.x / kPieces) {"
_SPLIT = "    for (int qi = tid; qi < kn / 4 * kCC; qi += blockDim.x) {"
_ROWS = "    if (max(t0, qr - d + 1) > min(min(t0 + 3, live - 1), qr)) continue;"
NO_BAND = (_BAND, "      if (false) {\n        // The band")
NO_SOURCE = (_SOURCE, _SOURCE.replace("kl < kn;", "false;"))
NO_SPLIT = (_SPLIT, _SPLIT.replace("qi < kn / 4 * kCC;", "false;"))
NO_ROWS = (_ROWS, "    continue;")
VARIANTS = {
    "kernel": [],
    "one_product": [(_PRODUCTS, "          wgmma_tf32(acc, ab[h], db);")],
    "no_products": [(_PRODUCTS, "")],
    "no_band": [NO_BAND],
    "no_source": [NO_SOURCE],
    "write_only": [NO_BAND, NO_SOURCE, NO_SPLIT, NO_ROWS],
}


def build(kdir: str, out_dir: str) -> dict:
    """{variant: path of its shared library}, built by nvcc in parallel."""
    from premvos_tpu_torch import kernels

    src = open(os.path.join(kdir, "correlation.cu")).read()
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for name, subs in VARIANTS.items():
        text = src
        for old, new in subs:
            if old not in text:
                raise SystemExit(f"corr_grad_breakdown: {name}: part not found in correlation.cu")
            text = text.replace(old, new)
        cu = os.path.join(out_dir, f"{name}.cu")
        with open(cu, "w") as f:
            f.write(text)
        so = os.path.join(out_dir, f"{name}.so")
        cmd = [kernels._nvcc(), *kernels.NVCC_FLAGS, "-shared", "-I", kdir, "-o", so, cu]
        procs[name] = (so, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise SystemExit(f"corr_grad_breakdown: {name} did not build:\n{log[-3000:]}")
        libs[name] = so
    return libs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--json", help="also write the results (JSON) here")
    args = ap.parse_args()

    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("corr_grad_breakdown: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from chip_smoke import CORR_GRAD_CASES, corr_grad_inputs
    from premvos_tpu_torch import kernels
    from premvos_tpu_torch.ops.correlation import correlation_grads_reference

    libs = build(os.path.dirname(os.path.abspath(kernels.__file__)),
                 os.path.join(kernels.BUILD_DIR, "breakdown"))
    fns = {}
    for name, so in libs.items():
        fn = ctypes.CDLL(so).premvos_correlation_backward
        fn.argtypes = kernels.signatures()["premvos_correlation_backward"]
        fn.restype = ctypes.c_int
        fns[name] = fn
    dev = torch.device("cuda")
    rows = []
    for i, case in enumerate(CORR_GRAD_CASES):
        f1, f2, g = corr_grad_inputs(torch, torch.Generator().manual_seed(60 + i), dev, case)
        b, c, h, w, md, st = case
        a, v = (t.permute(0, 2, 3, 1).contiguous() for t in (f1, f2))
        df1, df2 = torch.empty_like(a), torch.empty_like(v)
        row = dict(shape=f"f1, f2 [{b},{c},{h},{w}] f32, md {md}, stride {st}", device_us={})
        for name, fn in fns.items():
            def call(fn=fn):
                err = fn(a.data_ptr(), v.data_ptr(), g.data_ptr(), b, h, w, c, md, st,
                         df1.data_ptr(), df2.data_ptr(), torch.cuda.current_stream().cuda_stream)
                if err:
                    raise SystemExit(f"corr_grad_breakdown: {name}: CUDA error {err}")

            call()
            torch.cuda.synchronize()
            if name == "kernel":
                for got, ref in zip((df1, df2), correlation_grads_reference(f1, f2, g, md, st)):
                    scale = float(ref.abs().max())
                    err = float((got.permute(0, 3, 1, 2) - ref).abs().max())
                    if not err <= 1e-5 * scale:
                        raise SystemExit(f"corr_grad_breakdown: {case}: error {err} of {scale}")
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(50):
                    call()
                torch.cuda.synchronize()
            row["device_us"][name] = sum(ev.self_device_time_total for ev in prof.key_averages()
                                         if "corr_grad" in ev.key) / 50
        print(row["shape"], {k: round(t, 2) for k, t in row["device_us"].items()},
              file=sys.stderr, flush=True)
        rows.append(row)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    result = {"card": smi, "torch": torch.__version__, "rows": rows}
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)), exist_ok=True)
        with open(args.json, "w") as f:
            json.dump(result, f, indent=1)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
