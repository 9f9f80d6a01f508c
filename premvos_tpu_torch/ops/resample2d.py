"""Resample2d: backward bilinear warp by a flow field (port of
premvos_tpu/ops/resample2d.py and of the Pallas kernel
premvos_tpu/ops/pallas/resample2d_pallas.py).

  out[b, c, y, x] = bilinear(src[b, c], y + flow[b, 1, y, x],
                                        x + flow[b, 0, y, x])

Flow channel 0 is u (x), channel 1 is v (y); the sample point is clamped
into the image (edge clamp). Layout: src [B, C, H, W], flow [B, 2, H, W];
the output has the promoted dtype of src and flow.

The port's warp is the EXACT bilinear warp: it equals the JAX package's
`resample2d_reference` / `warp_impl="gather"` for every flow, and its
`warp_impl="block"` only inside that implementation's envelope (|flow| ≤ 64
and a per-block residual ≤ 4), outside which "block" clamps to its window.

`resample2d` dispatches on the device: CUDA tensors go to the kernel
(kernels/resample2d.cu), CPU tensors to `resample2d_reference`.

The kernel replaces the TPU's block warp (resample2d_block_pallas). On the
H100 it is bound by bytes, and at the merge warp's shape ([1, 8, 240, 432])
it runs for a few microseconds, less than the host takes to launch it; so
the wrapper does only what the kernel needs: one check of types and shapes,
`.contiguous()`, the output, and the launch through the table that
`kernels.load()` bound once. The kernel picks its own split of the work
(pixels per thread, channel groups) from the shape.
"""

from __future__ import annotations

import torch

from premvos_tpu_torch import kernels

_KERNEL_DTYPES = (torch.float32, torch.bfloat16)


def resample2d_reference(src: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """Plain version: four-corner gathers."""
    b, c, h, w = src.shape
    out_dtype = torch.promote_types(src.dtype, flow.dtype)
    yy = torch.arange(h, dtype=flow.dtype, device=flow.device)[:, None]
    xx = torch.arange(w, dtype=flow.dtype, device=flow.device)[None, :]
    sx = torch.clamp(xx + flow[:, 0], 0.0, w - 1.0)
    sy = torch.clamp(yy + flow[:, 1], 0.0, h - 1.0)
    x0f, y0f = torch.floor(sx), torch.floor(sy)
    x0, y0 = x0f.to(torch.int64), y0f.to(torch.int64)
    x1 = torch.clamp(x0 + 1, max=w - 1)
    y1 = torch.clamp(y0 + 1, max=h - 1)
    wx = (sx - x0f)[:, None]
    wy = (sy - y0f)[:, None]
    flat = src.reshape(b, c, h * w)

    def tap(yi, xi):
        idx = (yi * w + xi).reshape(b, 1, h * w).expand(b, c, h * w)
        return torch.gather(flat, 2, idx).reshape(b, c, h, w)

    top = tap(y0, x0) * (1 - wx) + tap(y0, x1) * wx
    bot = tap(y1, x0) * (1 - wx) + tap(y1, x1) * wx
    return (top * (1 - wy) + bot * wy).to(out_dtype)


def resample2d_cuda(src: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """The CUDA kernel (kernels/resample2d.cu); same contract as
    resample2d_reference, forward only: with grad enabled and an input that
    requires grad it raises instead of returning a result without a graph.
    `resample2d_cuda.launches` counts its launches."""
    kernels.refuse_grad("resample2d", src, flow)
    b, c, h, w = src.shape
    if src.dtype not in _KERNEL_DTYPES or flow.dtype != torch.float32:
        raise ValueError(
            f"resample2d: src {src.dtype} must be float32 or bfloat16, flow {flow.dtype} float32"
        )
    if flow.shape != (b, 2, h, w):
        raise ValueError(f"resample2d: flow {tuple(flow.shape)} vs src {tuple(src.shape)}")
    src = src.contiguous()
    flow = flow.contiguous()
    kernels.require_cuda("resample2d", src, flow)
    out = torch.empty_like(src, dtype=torch.float32)
    kernels.launch(
        "resample2d", src.data_ptr(), int(src.dtype == torch.bfloat16),
        flow.data_ptr(), b, c, h, w, out.data_ptr(), kernels.stream_of(src),
    )
    resample2d_cuda.launches += 1
    return out


resample2d_cuda.launches = 0


def resample2d(src: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """Dispatching entry point (differentiable on the CPU only)."""
    fn = resample2d_cuda if src.is_cuda else resample2d_reference
    return fn(src, flow)
