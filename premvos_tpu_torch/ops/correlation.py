"""FlowNetC correlation (cost volume) and its gradient (port of
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

`correlation` dispatches on the device: CUDA tensors go to the kernels
(kernels/correlation.cu) through an autograd Function, CPU tensors to
`correlation_reference`, which autograd differentiates through plain ops.

The forward kernel replaces the TPU's correlation_pallas. It forms the cost
volume as a banded matrix product on the tensor cores (mma.sync, bf16 in,
float32 sums; float32 inputs as three tf32 products), so on the H100 it is
bound by the bytes it moves. The wrapper therefore hands bf16 features to
it as they are: FlowNetC's bf16 path reads half the bytes of a float32 cast.
The backward kernel replaces the JAX package's VJP, the XLA scan
`_correlation_grads`: both gradients in float32, in one launch, as banded
matrix products on the tensor cores (3xTF32, within about 2^-21 of each
float32 product), df2 as a gather over its own pixels (deterministic, no
atomics); `correlation_grads_reference` is its plain version.
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


def correlation_grads_reference(
    f1: torch.Tensor, f2: torch.Tensor, g: torch.Tensor,
    max_displacement: int = 20, stride: int = 2,
):
    """Plain version of the gradient, in float32: for g = dL/dout
    [B, D², H, W], with (dy, dx) = (i·stride − md, j·stride − md),

      df1[b, c, y, x] = (1/C) Σ_d g[b, d, y, x] · f2[b, c, y + dy, x + dx]
      df2[b, c, v, u] = (1/C) Σ_d g[b, d, v − dy, u − dx] · f1[b, c, v − dy, u − dx]

    with zero padding outside the image: the terms that land in the padding
    are dropped, as the JAX package's crop of its padded df2 does."""
    f1 = f1.to(torch.float32)
    f2 = f2.to(torch.float32)
    g = g.to(torch.float32)
    b, c, h, w = f1.shape
    pad = max_displacement
    d = num_displacements(max_displacement, stride)
    f2p = F.pad(f2, (pad, pad, pad, pad))
    df1 = torch.zeros_like(f1)
    df2p = torch.zeros_like(f2p)
    for i in range(d):
        for j in range(d):
            dy, dx = i * stride, j * stride
            g_d = g[:, i * d + j, None]
            df1 += g_d * f2p[:, :, dy:dy + h, dx:dx + w]
            df2p[:, :, dy:dy + h, dx:dx + w] += g_d * f1
    df2 = df2p[:, :, pad:pad + h, pad:pad + w]
    return df1 / c, df2 / c


def _check(f1, f2, max_displacement, stride):
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


def _channels_last(t: torch.Tensor) -> torch.Tensor:
    """[B, C, H, W] → contiguous [B, H, W, C]: no copy for a channels-last
    tensor."""
    return t.permute(0, 2, 3, 1).contiguous()


def _forward(a, v, max_displacement, stride):
    """The forward kernel on channels-last [B, H, W, C] features."""
    kernels.require_cuda("correlation", a, v)
    b, h, w, c = a.shape
    d = num_displacements(max_displacement, stride)
    out = a.new_empty((b, d * d, h, w), dtype=torch.float32)
    kernels.launch(
        "correlation", a.data_ptr(), v.data_ptr(), int(a.dtype == torch.bfloat16),
        b, h, w, c, max_displacement, stride, out.data_ptr(), kernels.stream_of(a),
    )
    correlation_cuda.launches += 1
    return out


def correlation_backward_cuda(
    f1: torch.Tensor, f2: torch.Tensor, g: torch.Tensor,
    max_displacement: int = 20, stride: int = 2, needs=(True, True),
):
    """The backward kernel (kernels/correlation.cu); same contract as
    correlation_grads_reference. f1, f2 [B, C, H, W] (any memory format;
    cast to float32), g [B, D², H, W]. Returns (df1, df2), float32
    [B, C, H, W] with channels-last strides; a gradient that `needs` does
    not ask for is None and not computed. One kernel launch computes
    every gradient asked for; `correlation_backward_cuda.launches` counts
    those launches."""
    _check(f1, f2, max_displacement, stride)
    b, c, h, w = f1.shape
    d = num_displacements(max_displacement, stride)
    if tuple(g.shape) != (b, d * d, h, w):
        raise ValueError(
            f"correlation backward: g {tuple(g.shape)} must be {(b, d * d, h, w)}"
        )
    a = _channels_last(f1.to(torch.float32))
    v = _channels_last(f2.to(torch.float32))
    g = g.to(torch.float32).contiguous()
    kernels.require_cuda("correlation_backward", a, v, g)
    df1 = torch.empty_like(a) if needs[0] else None
    df2 = torch.empty_like(v) if needs[1] else None
    if df1 is None and df2 is None:
        return None, None
    kernels.launch(
        "correlation_backward", a.data_ptr(), v.data_ptr(), g.data_ptr(),
        b, h, w, c, max_displacement, stride,
        None if df1 is None else df1.data_ptr(),
        None if df2 is None else df2.data_ptr(), kernels.stream_of(a),
    )
    correlation_backward_cuda.launches += 1
    return tuple(None if t is None else t.permute(0, 3, 1, 2) for t in (df1, df2))


correlation_backward_cuda.launches = 0


class _Correlation(torch.autograd.Function):
    """The forward kernel, differentiated by the backward kernel (in
    float32; a bf16 input gets its gradient cast back to bf16)."""

    @staticmethod
    def forward(ctx, f1, f2, max_displacement, stride):
        a, v = _channels_last(f1), _channels_last(f2)
        ctx.save_for_backward(f1, f2)
        ctx.args = (max_displacement, stride)
        return _forward(a, v, max_displacement, stride)

    @staticmethod
    def backward(ctx, g):
        f1, f2 = ctx.saved_tensors
        grads = correlation_backward_cuda(f1, f2, g, *ctx.args, needs=ctx.needs_input_grad[:2])
        df1, df2 = (None if t is None else t.to(f.dtype) for t, f in zip(grads, (f1, f2)))
        return df1, df2, None, None


def correlation_cuda(
    f1: torch.Tensor, f2: torch.Tensor, max_displacement: int = 20,
    stride: int = 2,
) -> torch.Tensor:
    """The CUDA kernels (kernels/correlation.cu); same contract as
    correlation_reference, for any max displacement and stride.
    bfloat16 and float32 inputs go to the forward kernel as they are,
    others as float32. Differentiable: the backward is
    `correlation_backward_cuda`. `correlation_cuda.launches` counts the
    forward's launches."""
    _check(f1, f2, max_displacement, stride)
    if f1.dtype != f2.dtype or f1.dtype not in _KERNEL_DTYPES:
        f1, f2 = f1.to(torch.float32), f2.to(torch.float32)
    return _Correlation.apply(f1, f2, max_displacement, stride)


correlation_cuda.launches = 0


def correlation(
    f1: torch.Tensor, f2: torch.Tensor, max_displacement: int = 20,
    stride: int = 2,
) -> torch.Tensor:
    """Dispatching entry point (differentiable on both devices)."""
    fn = correlation_cuda if f1.is_cuda else correlation_reference
    return fn(f1, f2, max_displacement, stride)
