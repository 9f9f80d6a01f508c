"""Resample2d: backward bilinear warps by a flow field (port of
premvos_tpu/ops/resample2d.py and of the Pallas kernel
premvos_tpu/ops/pallas/resample2d_pallas.py).

Layout: src [B, C, H, W], flow [B, 2, H, W] (channel 0 is u, the x
displacement; channel 1 is v); the output has the promoted dtype of src and
flow. Two warps, as in the JAX package, chosen by `warp_impl` (FlowConfig,
MergeConfig; `warp` takes the name):

"gather" — `resample2d`, the EXACT bilinear warp, the JAX package's
`resample2d_reference` (its XLA gather warp) for every flow:

  out[b, c, y, x] = bilinear(src[b, c], y + flow[b, 1, y, x],
                                        x + flow[b, 0, y, x])

with the sample point clamped into the image (edge clamp).

"block" (the default) — `resample2d_block`, the block warp: the function
that the TPU kernel resample2d_block_pallas computes (with the JAX
package's `_block_prep`). For blocks (by, bx), r = residual, lf = max_flow
and win = 2r + 2:
  - sy = clip(y + v, −lf, H − 1 + lf), and sx likewise;
  - each block, with origin (oy, ox), takes m_y = round_half_even(S / n),
    S the sum of (sy − y) over the block's pixels inside the image (the
    padded tail of a ragged block does not count), n their count, the
    division in float32; S is summed in float64 here and in the kernel, so
    the two agree whatever their order of summation;
  - ws_y = oy + m_y − r, and t_y = clip((sy − ws_y) − (y − oy), 0, win − 1)
    in float32, the two subtractions in this order;
  - out = Σ_dy max(0, 1 − |t_y − dy|) · Σ_dx max(0, 1 − |t_x − dx|) ·
    src[clamp(ws_y + (y − oy) + dy), clamp(ws_x + (x − ox) + dx)], where
    only dy = ⌊t_y⌋ and ⌊t_y⌋ + 1 have weight (and so for x).
It equals the exact warp while each pixel's displacement lies within r of
its block's rounded mean and |flow| ≤ lf; a pixel outside that window (a
motion boundary across a block) is clamped to the window's edge. The
defaults (8, 128), 4, 64 are the TPU kernel's; the JAX package's XLA
fallback on the CPU takes (32, 128), which is another function.

Each warp dispatches on the device: CUDA tensors go to a kernel
(kernels/resample2d.cu: `premvos_resample2d_block`, which replaces
resample2d_block_pallas, and `premvos_resample2d`, the counterpart of the
XLA gather warp, which has no TPU kernel), CPU tensors to the plain
versions `resample2d_block_reference` and `resample2d_reference`. Both
kernels are bound by bytes; at the merge warp's shape ([1, 8, 240, 432])
they run for a few microseconds, less than the host takes to launch them,
so the wrappers do only what the kernels need: one check of types and
shapes, `.contiguous()`, the output, and the launch through the table that
`kernels.load()` bound once.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

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


def _check(name, src, flow):
    b, c, h, w = src.shape
    if src.dtype not in _KERNEL_DTYPES or flow.dtype != torch.float32:
        raise ValueError(
            f"{name}: src {src.dtype} must be float32 or bfloat16, flow {flow.dtype} float32"
        )
    if flow.shape != (b, 2, h, w):
        raise ValueError(f"{name}: flow {tuple(flow.shape)} vs src {tuple(src.shape)}")


def resample2d_cuda(src: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """The CUDA kernel (kernels/resample2d.cu); same contract as
    resample2d_reference, forward only: with grad enabled and an input that
    requires grad it raises instead of returning a result without a graph.
    `resample2d_cuda.launches` counts its launches."""
    kernels.refuse_grad("resample2d", src, flow)
    _check("resample2d", src, flow)
    b, c, h, w = src.shape
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
    """The exact warp, dispatching on the device (differentiable on the CPU
    only)."""
    fn = resample2d_cuda if src.is_cuda else resample2d_reference
    return fn(src, flow)


# The block kernel's limit: one thread block a block of pixels, at most 16
# pixels a thread in 256 threads.
MAX_BLOCK_PIXELS = 4096


def _check_block(block, residual, max_flow):
    by, bx = (int(v) for v in block)
    if by < 1 or bx < 1 or by * bx > MAX_BLOCK_PIXELS or residual < 0 or max_flow < 0:
        raise ValueError(
            f"resample2d_block: block {tuple(block)} must hold 1 to {MAX_BLOCK_PIXELS} pixels, "
            f"residual {residual} and max_flow {max_flow} must not be negative"
        )
    return by, bx


def block_taps(flow: torch.Tensor, block=(8, 128), residual: int = 4, max_flow: int = 64):
    """The block warp's index arithmetic (the module docstring) for flow
    [B, 2, H, W], each [B, H, W]: every pixel's window start ws_y, ws_x
    (its block's), its local coordinates t_y, t_x and its first tap's row
    and column y0 = ws_y + ry + ⌊t_y⌋, x0 = ws_x + rx + ⌊t_x⌋, before the
    clamp into the image."""
    by, bx = _check_block(block, residual, max_flow)
    b, _, h, w = flow.shape
    f32, i64, dev = torch.float32, torch.int64, flow.device
    r, lf = int(residual), float(max_flow)
    flow = flow.to(f32)
    iy = torch.arange(h, device=dev)
    ix = torch.arange(w, device=dev)
    yy, xx = iy.to(f32)[:, None], ix.to(f32)[None, :]
    sy = torch.clamp(yy + flow[:, 1], -lf, h - 1.0 + lf)
    sx = torch.clamp(xx + flow[:, 0], -lf, w - 1.0 + lf)
    nby, nbx = -(-h // by), -(-w // bx)
    oy, ox = torch.arange(0, h, by, device=dev), torch.arange(0, w, bx, device=dev)
    # the count of each block's pixels inside the image
    n = ((h - oy).clamp(max=by)[:, None] * (w - ox).clamp(max=bx)[None, :]).to(f32)
    pad = (0, nbx * bx - w, 0, nby * by - h)  # the padded tail adds 0

    def window_start(s, coord, origin):
        """[B, H, W] per pixel: its block's origin + rounded mean − r."""
        d = F.pad(s - coord, pad).reshape(b, nby, by, nbx, bx)
        mean = torch.round(d.sum((2, 4), dtype=torch.float64).to(f32) / n)
        ws = origin + mean.to(i64) - r
        return ws[:, iy // by][:, :, ix // bx]

    ws_y = window_start(sy, yy, oy[:, None])
    ws_x = window_start(sx, xx, ox[None, :])
    ry, rx = (iy % by)[:, None], (ix % bx)[None, :]
    win = 2 * r + 2
    t_y = torch.clamp((sy - ws_y.to(f32)) - ry.to(f32), 0.0, win - 1.0)
    t_x = torch.clamp((sx - ws_x.to(f32)) - rx.to(f32), 0.0, win - 1.0)
    y0 = ws_y + ry + torch.floor(t_y).to(i64)
    x0 = ws_x + rx + torch.floor(t_x).to(i64)
    return ws_y, ws_x, t_y, t_x, y0, x0


def resample2d_block_reference(src: torch.Tensor, flow: torch.Tensor, block=(8, 128),
                               residual: int = 4, max_flow: int = 64) -> torch.Tensor:
    """Plain version of the block warp (the module docstring), in float32
    over every pixel at once: each pixel's window row and column
    (block_taps), its two weights a side, then four gathers."""
    b, c, h, w = src.shape
    out_dtype = torch.promote_types(src.dtype, flow.dtype)
    _, _, t_y, t_x, y0, x0 = block_taps(flow, block, residual, max_flow)
    d_y, d_x = torch.floor(t_y), torch.floor(t_x)

    def weight(t, d):
        return torch.clamp(1.0 - (t - d).abs(), min=0.0)[:, None]

    wy0, wy1 = weight(t_y, d_y), weight(t_y, d_y + 1)
    wx0, wx1 = weight(t_x, d_x), weight(t_x, d_x + 1)
    flat = src.to(torch.float32).reshape(b, c, h * w)

    def tap(yi, xi):
        idx = (yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)).reshape(b, 1, h * w)
        return torch.gather(flat, 2, idx.expand(b, c, h * w)).reshape(b, c, h, w)

    top = wx0 * tap(y0, x0) + wx1 * tap(y0, x0 + 1)
    bot = wx0 * tap(y0 + 1, x0) + wx1 * tap(y0 + 1, x0 + 1)
    return (wy0 * top + wy1 * bot).to(out_dtype)


def resample2d_block_cuda(src: torch.Tensor, flow: torch.Tensor, block=(8, 128),
                          residual: int = 4, max_flow: int = 64) -> torch.Tensor:
    """The block warp's CUDA kernel (kernels/resample2d.cu,
    `premvos_resample2d_block`); same contract as resample2d_block_reference,
    forward only (with grad enabled and an input that requires grad it
    raises). `resample2d_block_cuda.launches` counts its launches."""
    kernels.refuse_grad("resample2d_block", src, flow)
    by, bx = _check_block(block, residual, max_flow)
    _check("resample2d_block", src, flow)
    b, c, h, w = src.shape
    src = src.contiguous()
    flow = flow.contiguous()
    kernels.require_cuda("resample2d_block", src, flow)
    out = torch.empty_like(src, dtype=torch.float32)
    kernels.launch(
        "resample2d_block", src.data_ptr(), int(src.dtype == torch.bfloat16),
        flow.data_ptr(), b, c, h, w, by, bx, int(residual), int(max_flow), out.data_ptr(),
        kernels.stream_of(src),
    )
    resample2d_block_cuda.launches += 1
    return out


resample2d_block_cuda.launches = 0


def resample2d_block(src: torch.Tensor, flow: torch.Tensor, block=(8, 128),
                     residual: int = 4, max_flow: int = 64) -> torch.Tensor:
    """The block warp, dispatching on the device; the defaults are the TPU
    kernel's."""
    fn = resample2d_block_cuda if src.is_cuda else resample2d_block_reference
    return fn(src, flow, block, residual, max_flow)


WARP_IMPLS = ("block", "gather")


def warp(src: torch.Tensor, flow: torch.Tensor, impl: str = "block") -> torch.Tensor:
    """The warp that a `warp_impl` names: "block" (resample2d_block at its
    defaults) or "gather" (the exact resample2d)."""
    if impl == "block":
        return resample2d_block(src, flow)
    if impl == "gather":
        return resample2d(src, flow)
    raise ValueError(f"warp_impl must be one of {WARP_IMPLS}, got {impl!r}")
