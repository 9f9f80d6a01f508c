"""Build and bind the port's CUDA kernels.

Four CUDA C++ sources sit beside this file, for the five TPU kernels of the
JAX package:

  nms.cu          ← premvos_tpu/ops/pallas/nms_pallas.py::nms_pallas
  roi_align.cu    ← premvos_tpu/ops/pallas/multilevel_roi_align_pallas.py and
                    premvos_tpu/ops/pallas/roi_align_pallas.py (with the
                    single-level kernel's backward)
  correlation.cu  ← premvos_tpu/ops/pallas/correlation_pallas.py (with the
                    gradient, which the JAX package computes with the XLA
                    scan premvos_tpu/ops/correlation.py::_correlation_grads)
  resample2d.cu   ← premvos_tpu/ops/pallas/resample2d_pallas.py (the block
                    warp; beside it the exact warp, the counterpart of the
                    JAX package's XLA gather warp)

Each exports a plain C function (pointers, sizes, a CUDA stream) that
returns the `cudaError_t` of its launches. Those functions are declared once,
in `premvos_kernels.h`, which every source includes: a definition that
drifts from its declaration does not compile, and `load()` reads the ctypes
argument types from the same declarations. `build()` compiles the sources
with `nvcc` for `sm_90a` at first use, one `nvcc` process per source, all
started together, then links one shared library. No source includes
PyTorch's headers, so a cold build takes seconds. The library lands in
`build/` next to this file (listed in .gitignore), under a name that hashes
the sources, the header and the flags, so an edited source rebuilds.

The launch path is bound once. `load()` builds and opens the library, sets
each `premvos_*` function's ctypes types and keeps it, with its argument
count, in a table. A wrapper's `launch(name, ...)` is then one table lookup,
the argument-count check (ctypes would pass surplus arguments on) and the
call, and it raises if the returned error is not 0: a refused launch never
runs, and nothing falls back. `stream_of` reads the raw handle of PyTorch's
current stream without building a `torch.cuda.Stream`, and `require_cuda`
checks only what the wrappers do not already ensure (the device; they make
their inputs contiguous themselves). At the merge warp's shape the kernel
runs for a few microseconds, so this host path is what a call costs
(PERF.md, section 6).

Four host libraries sit here too, C++ with a plain C interface and no
CUDA: `jpeg_decode.cc` and `jpeg_encode.cc` (the frame readers' JPEG
decoder and the generators' encoder, io_compat/jpeg.py), `rle.cc` (the
COCO RLE codec, io_compat/rle_native.py) and `zstd_decode.cc` (the
checkpoint reader's zstd decoder, io_compat/zstd.py, declared in the
header's host section). `build_host()` compiles one with the host C++
compiler (`g++`, which nvcc also uses) at first use, into the same
`build/`, and raises if that fails.

Nothing here runs at import time: this module is imported on machines with
no CUDA toolkit, where only the plain PyTorch versions of the ops run.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading

import torch

SOURCES = ("nms.cu", "roi_align.cu", "correlation.cu", "resample2d.cu")
HEADER = "premvos_kernels.h"
NVCC_FLAGS = (
    "-gencode=arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-Xcompiler=-fPIC",
    "-Xptxas=-v",
)

_HERE = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(_HERE, "build")

# Scalar parameter types of the header; every pointer (and the stream) is a
# c_void_p, or ctypes would pass it as a 32-bit int and cut it.
_SCALARS = {"int": ctypes.c_int, "float": ctypes.c_float, "cudaStream_t": ctypes.c_void_p}


def signatures() -> dict:
    """{function: [ctypes argument types]} read from premvos_kernels.h."""
    with open(os.path.join(_HERE, HEADER)) as f:
        text = re.sub(r"//[^\n]*", "", f.read())
    sigs = {}
    for name, params in re.findall(r"\bint\s+(premvos_\w+)\s*\(([^)]*)\)\s*;", text):
        types = []
        for param in params.split(","):
            kind = param.strip().rsplit(None, 1)[0]  # drop the parameter name
            if "*" in kind:
                types.append(ctypes.c_void_p)
            elif kind in _SCALARS:
                types.append(_SCALARS[kind])
            else:
                raise ValueError(f"{HEADER}: {name} has a parameter of type {kind!r}")
        sigs[name] = types
    return sigs


_lock = threading.Lock()
_lib = None
# {name without the premvos_ prefix: (bound C function, argument count)},
# filled once by load().
_FNS: dict = {}
# The raw handle of a device's current stream, as an int, without building a
# Stream object (only CUDA builds have it, and only CUDA tensors reach
# stream_of).
_raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None)


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in (*SOURCES, HEADER):
        with open(os.path.join(_HERE, name), "rb") as f:
            h.update(name.encode() + f.read())
    return h.hexdigest()[:16]


def build() -> str:
    """Compile the sources (in parallel) and link the shared library.

    Returns its path; a library already built from these sources is reused.
    The compiler's report (registers, shared memory, spills per kernel) is
    kept in `build/ptxas_<digest>.log`.
    """
    os.makedirs(BUILD_DIR, exist_ok=True)
    tag = _digest()
    lib_path = os.path.join(BUILD_DIR, f"libpremvos_kernels_{tag}.so")
    if os.path.exists(lib_path):
        return lib_path
    nvcc = _nvcc()
    objs, procs = [], []
    for name in SOURCES:
        obj = os.path.join(BUILD_DIR, f"{name[:-3]}_{tag}.o")
        objs.append(obj)
        cmd = [nvcc, *NVCC_FLAGS, "-c", os.path.join(_HERE, name), "-o", obj]
        procs.append(
            (name, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True))
        )
    report, failed = [], []
    for name, proc in procs:
        out, _ = proc.communicate()
        report.append(f"== {name}\n{out}")
        if proc.returncode != 0:
            failed.append(name)
    log = "\n".join(report)
    with open(os.path.join(BUILD_DIR, f"ptxas_{tag}.log"), "w") as f:
        f.write(log)
    if failed:
        raise RuntimeError(f"nvcc failed for {', '.join(failed)}:\n{log}")
    tmp = f"{lib_path}.{os.getpid()}.tmp"
    subprocess.run(
        [nvcc, "-shared", "-gencode=arch=compute_90a,code=sm_90a", *objs,
         "-o", tmp],
        check=True,
    )
    os.replace(tmp, lib_path)
    return lib_path


HOST_FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC")


def _cxx() -> str:
    found = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
    if found is None:
        raise RuntimeError("no host C++ compiler: set CXX or put g++ on PATH")
    return found


def build_host(source: str) -> str:
    """Compile the host source `source` (a file beside this one) into a
    shared library in build/, named by a hash of the source, the header and
    the flags; a library already built from it is reused. Raises with the
    compiler's output if it fails."""
    path = os.path.join(_HERE, source)
    h = hashlib.sha256(" ".join(HOST_FLAGS).encode())
    for name in (source, HEADER):  # a source may include the header
        with open(os.path.join(_HERE, name), "rb") as f:
            h.update(f.read())
    tag = h.hexdigest()[:16]
    os.makedirs(BUILD_DIR, exist_ok=True)
    lib_path = os.path.join(BUILD_DIR, f"lib{os.path.splitext(source)[0]}_{tag}.so")
    if os.path.exists(lib_path):
        return lib_path
    tmp = f"{lib_path}.{os.getpid()}.{threading.get_ident()}.tmp"
    proc = subprocess.run([_cxx(), *HOST_FLAGS, path, "-o", tmp],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"building {source} failed:\n{proc.stdout}")
    os.replace(tmp, lib_path)
    return lib_path


def load():
    """The bound library (built on first use); fills the launch table."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            for name, argtypes in signatures().items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
                _FNS[name[len("premvos_"):]] = (fn, len(argtypes))
            _lib = lib
    return _lib


def launch(name: str, *args) -> None:
    """Call the library's `premvos_<name>` with `args` (ints, floats and
    data pointers, the stream last) and raise if a launch was refused: a
    refused launch never runs, and a later synchronize would not report it.
    ctypes lets a C function take more arguments than its declaration, so
    the count is checked here."""
    try:
        fn, nargs = _FNS[name]
    except KeyError:
        load()
        fn, nargs = _FNS[name]
    if len(args) != nargs:
        raise TypeError(f"premvos_{name} takes {nargs} arguments, got {len(args)}")
    err = fn(*args)
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: error {err}")


def stream_of(t: torch.Tensor) -> int:
    """The handle of PyTorch's current stream on `t`'s device."""
    return _raw_stream(t.get_device())


def refuse_grad(name: str, *tensors: torch.Tensor) -> None:
    """Check of the forward-only wrappers: with grad enabled, no input may
    require grad (the kernel's output would silently carry no graph)."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise ValueError(
            f"{name}: the CUDA kernel has no backward; call it on inputs that "
            "do not require grad, or under torch.no_grad()"
        )


def require_cuda(name: str, *tensors: torch.Tensor) -> None:
    """Shared argument check of the kernel wrappers: every tensor on one
    CUDA device. The wrappers pass contiguous tensors (they call
    `.contiguous()`, or check a tensor the caller hands in)."""
    dev = tensors[0].get_device()
    if dev < 0:
        raise ValueError(f"{name}: all tensors must be on one CUDA device")
    for t in tensors[1:]:
        if t.get_device() != dev:
            raise ValueError(f"{name}: all tensors must be on one CUDA device")
