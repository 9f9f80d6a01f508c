"""FlowNetC correlation (cost volume), forward only (port of
premvos_tpu/ops/correlation.py and of the Pallas kernel
premvos_tpu/ops/pallas/correlation_pallas.py).

  out[b, i·D + j, y, x] = (1/C) · Σ_c f1[b, c, y, x] ·
                          f2[b, c, y + i·stride − md, x + j·stride − md]

with D = 2·(md // stride) + 1 and f2 zero outside the image. Layout: NCHW in
(any memory format) and NCHW out, [B, D², H, W] — the layout the next
convolution (FlowNetC's conv3_1) reads. The JAX package returns
[B, H, W, D²]; the displacement order along that axis is the same.
Computed in float32 from float32 or bfloat16 inputs (a bf16 input is read
as its exact float32 value).

`correlation` dispatches on the device: CUDA tensors go to the kernel
(kernels/correlation.cu), CPU tensors to `correlation_reference`.

The kernel replaces the TPU's correlation_pallas. It forms the cost volume
as a banded matrix product on the tensor cores (mma.sync, bf16 in, float32
sums; float32 inputs as three tf32 products), so on the H100 it is bound by
the bytes it moves. The wrapper therefore hands bf16 features to it as they
are: FlowNetC's bf16 path reads half the bytes of a float32 cast.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from premvos_tpu_torch import kernels

_KERNEL_DTYPES = (torch.float32, torch.bfloat16)


def num_displacements(max_displacement: int, stride: int) -> int:
    """D: displacements per axis."""
    return 2 * (max_displacement // stride) + 1


def correlation_reference(
    f1: torch.Tensor, f2: torch.Tensor, max_displacement: int = 20,
    stride: int = 2,
) -> torch.Tensor:
    """Plain version: one shifted product per displacement."""
    f1 = f1.to(torch.float32)
    f2 = f2.to(torch.float32)
    b, c, h, w = f1.shape
    pad = max_displacement
    d = num_displacements(max_displacement, stride)
    f2p = F.pad(f2, (pad, pad, pad, pad))
    out = f1.new_empty((b, d * d, h, w))
    for i in range(d):
        for j in range(d):
            dy, dx = i * stride, j * stride
            shifted = f2p[:, :, dy:dy + h, dx:dx + w]
            out[:, i * d + j] = torch.sum(f1 * shifted, dim=1)
    return out / c


def correlation_cuda(
    f1: torch.Tensor, f2: torch.Tensor, max_displacement: int = 20,
    stride: int = 2,
) -> torch.Tensor:
    """The CUDA kernel (kernels/correlation.cu); same contract as
    correlation_reference, for any max displacement and stride.
    bfloat16 and float32 inputs go to the kernel as they are, others as
    float32. `correlation_cuda.launches` counts its launches."""
    if f1.dim() != 4 or f1.shape != f2.shape:
        raise ValueError(
            f"correlation: f1 {tuple(f1.shape)} and f2 {tuple(f2.shape)} must be "
            "one [B, C, H, W] shape"
        )
    if stride < 1 or max_displacement < 0:
        raise ValueError(
            f"correlation: stride {stride} must be >= 1 and max displacement "
            f"{max_displacement} >= 0"
        )
    if f1.dtype != f2.dtype or f1.dtype not in _KERNEL_DTYPES:
        f1, f2 = f1.to(torch.float32), f2.to(torch.float32)
    b, c, h, w = f1.shape
    # The kernel reads channels innermost: a channels-last tensor passes
    # through without a copy.
    a = f1.permute(0, 2, 3, 1).contiguous()
    v = f2.permute(0, 2, 3, 1).contiguous()
    kernels.require_cuda("correlation", a, v)
    d = num_displacements(max_displacement, stride)
    out = a.new_empty((b, d * d, h, w), dtype=torch.float32)
    kernels.launch(
        "correlation", a.data_ptr(), v.data_ptr(), int(a.dtype == torch.bfloat16),
        b, h, w, c, max_displacement, stride, out.data_ptr(), kernels.stream_of(a),
    )
    correlation_cuda.launches += 1
    return out


correlation_cuda.launches = 0


def correlation(
    f1: torch.Tensor, f2: torch.Tensor, max_displacement: int = 20,
    stride: int = 2,
) -> torch.Tensor:
    """Dispatching entry point (forward only)."""
    fn = correlation_cuda if f1.is_cuda else correlation_reference
    return fn(f1, f2, max_displacement, stride)
