#!/usr/bin/env python3
"""Cold build time of the port's CUDA kernels by two routes, on a machine
with a CUDA card and toolkit.

    python3 scripts/time_kernel_build.py [--json PATH]

  a. `torch.utils.cpp_extension.load`: the four `.cu` sources plus a small
     `.cpp` binding that includes PyTorch's headers (it binds resample2d
     with typed tensor arguments; the header parse dominates its compile,
     so binding all four would take about as long). Needs `ninja`.
  b. the port's own build (`premvos_tpu_torch.kernels.build`): nvcc on each
     source in parallel, no PyTorch headers, bound with ctypes.

Both build into fresh temporary directories, so neither reuses a cache.
Route (a)'s extension is called once and held against route (b)'s kernel,
to show that it built something that runs. Prints one JSON object.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

BINDING = r"""
#include <ATen/cuda/CUDAContext.h>
#include <torch/extension.h>

#include "premvos_kernels.h"

torch::Tensor resample2d(torch::Tensor src, torch::Tensor flow) {
  TORCH_CHECK(src.is_cuda() && src.is_contiguous() && src.dim() == 4);
  TORCH_CHECK(flow.scalar_type() == at::kFloat && flow.is_contiguous());
  auto out = torch::empty(src.sizes(), flow.options());
  const int err = premvos_resample2d(
      src.data_ptr(), src.scalar_type() == at::kBFloat16,
      flow.data_ptr<float>(), src.size(0), src.size(1), src.size(2),
      src.size(3), out.data_ptr<float>(), at::cuda::getCurrentCUDAStream());
  TORCH_CHECK(err == 0, "resample2d failed to launch: error ", err);
  return out;
}

PYBIND11_MODULE(TORCH_EXTENSION_NAME, m) { m.def("resample2d", &resample2d); }
"""


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--json", help="also write the result here")
    args = ap.parse_args()

    import torch
    from torch.utils import cpp_extension

    if not torch.cuda.is_available():
        print("time_kernel_build: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from premvos_tpu_torch import kernels
    from premvos_tpu_torch.ops.resample2d import resample2d_cuda

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    result = {"card": smi, "torch": torch.__version__, "cuda": torch.version.cuda,
              "cpu_count": os.cpu_count()}

    with tempfile.TemporaryDirectory() as tmp:
        # (b) first: route (a)'s check below calls the port's kernel.
        kernels.BUILD_DIR = os.path.join(tmp, "b")
        t0 = time.perf_counter()
        kernels.load()
        result["ctypes_nvcc_s"] = time.perf_counter() - t0

        result["ninja"] = cpp_extension.is_ninja_available()
        if result["ninja"]:
            build_a = os.path.join(tmp, "a")
            os.makedirs(build_a)
            binding = os.path.join(build_a, "binding.cpp")
            with open(binding, "w") as f:
                f.write(BINDING)
            kdir = os.path.dirname(kernels.__file__)
            undef = [f"-U__CUDA_NO_{k}__" for k in (
                "HALF_OPERATORS", "HALF_CONVERSIONS", "BFLOAT16_CONVERSIONS",
                "HALF2_OPERATORS")]
            t0 = time.perf_counter()
            ext = cpp_extension.load(
                name="premvos_kernels_ext",
                sources=[binding, *(os.path.join(kdir, s) for s in kernels.SOURCES)],
                build_directory=build_a,
                extra_include_paths=[kdir],
                extra_cuda_cflags=["-O3", "-gencode=arch=compute_90a,code=sm_90a", *undef],
                verbose=False,
            )
            result["cpp_extension_load_s"] = time.perf_counter() - t0
            gen = torch.Generator().manual_seed(0)
            src = torch.rand(2, 3, 64, 96, generator=gen).cuda()
            flow = (torch.randn(2, 2, 64, 96, generator=gen) * 5).cuda()
            diff = (ext.resample2d(src, flow) - resample2d_cuda(src, flow)).abs().max()
            result["cpp_extension_vs_ctypes_max_abs"] = float(diff)
    print(json.dumps(result), flush=True)
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)), exist_ok=True)
        with open(args.json, "w") as f:
            json.dump(result, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
