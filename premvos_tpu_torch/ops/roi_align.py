"""RoIAlign and crop-and-resize (port of premvos_tpu/ops/roi_align.py and of
the Pallas kernel premvos_tpu/ops/pallas/multilevel_roi_align_pallas.py).

  * `crop_and_resize` — exact `tf.image.crop_and_resize` sampling as two
    interpolation matmuls (plain torch ops, as the JAX package left them to
    XLA).
  * `roi_align_reference` — single-level aligned RoIAlign, gather form.
  * `multilevel_roi_align_reference` / `multilevel_roi_align_cuda` — FPN
    RoIAlign where each RoI is sampled on its own level: the plain version
    and the CUDA kernel (kernels/roi_align.cu). `multilevel_roi_align`
    dispatches on the tensors' device: CUDA tensors go to the kernel, CPU
    tensors to the plain version.

Layouts: images NCHW; RoIAlign features [B, H, W, C] (channels innermost,
which a channels-last NCHW tensor gives without a copy); boxes [B, N, 4].
"""

from __future__ import annotations

import torch

from premvos_tpu_torch import kernels

# FPN levels P2..P5 and their strides (models/fpn.py).
LEVEL_STRIDES = (4, 8, 16, 32)

# RefineConfig.interp_precision → operand dtype of the interpolation matmuls.
_PRECISION_DTYPES = {
    "highest": torch.float32,
    "high": torch.float32,
    "default": torch.bfloat16,
}


def interp_dtype(name: str | None) -> torch.dtype:
    """Operand dtype of the crop/paste matmuls for a precision name: float32
    for "highest"/"high" (and None), bfloat16 for "default" (float32
    accumulation, output cast back to float32)."""
    return torch.float32 if name is None else _PRECISION_DTYPES[name]


def _bilinear_1d(coords: torch.Tensor, size: int):
    """1-D bilinear indices + weights, edge-clamped; samples farther than one
    pixel outside get zero weight."""
    inside = (coords > -1.0) & (coords < size)
    c = torch.clamp(coords, 0.0, size - 1)
    i0f = torch.floor(c)
    i0 = i0f.to(torch.int64)
    i1 = torch.clamp(i0 + 1, max=size - 1)
    w1 = c - i0f
    w0 = 1.0 - w1
    zero = torch.zeros_like(w0)
    return i0, i1, torch.where(inside, w0, zero), torch.where(inside, w1, zero)


def _interp_matrix(coords: torch.Tensor, size: int) -> torch.Tensor:
    """[..., K] sample coords → [..., K, size] bilinear weight matrix."""
    i0, i1, w0, w1 = _bilinear_1d(coords, size)
    m = torch.zeros(*coords.shape, size, dtype=coords.dtype, device=coords.device)
    m.scatter_add_(-1, i0[..., None], w0[..., None])
    m.scatter_add_(-1, i1[..., None], w1[..., None])
    return m


def crop_and_resize(
    image: torch.Tensor, boxes: torch.Tensor, crop_size: int,
    precision: str | None = None,
) -> torch.Tensor:
    """`tf.image.crop_and_resize` bilinear semantics.

    image [B, C, H, W]; boxes [B, N, 4] normalized [y1, x1, y2, x2]; sample k
    of P maps to y1·(H−1) + k/(P−1)·(y2−y1)·(H−1); out-of-range samples are 0.
    Returns [B, N, C, P, P] float32.
    """
    h, w = image.shape[-2:]
    p = crop_size
    dev = image.device
    if p > 1:
        t = torch.arange(p, dtype=torch.float32, device=dev) / (p - 1)
    else:
        t = torch.full((1,), 0.5, dtype=torch.float32, device=dev)
    y1, x1, y2, x2 = boxes.unbind(-1)
    ys = (y1[..., None] + t * (y2 - y1)[..., None]) * (h - 1)
    xs = (x1[..., None] + t * (x2 - x1)[..., None]) * (w - 1)
    dt = interp_dtype(precision)
    wy = _interp_matrix(ys, h).to(dt)  # [B, N, P, H]
    wx = _interp_matrix(xs, w).to(dt)  # [B, N, P, W]
    tmp = torch.einsum("bnkh,bchw->bnckw", wy, image.to(dt))
    out = torch.einsum("bnqw,bnckw->bnckq", wx, tmp)
    return out.to(torch.float32)


def roi_align_reference(
    features: torch.Tensor,
    boxes: torch.Tensor,
    output_size: int = 7,
    sampling_ratio: int = 2,
    spatial_scale: float = 1.0,
) -> torch.Tensor:
    """Gather-based aligned RoIAlign on one level, in float32.

    features [B, H, W, C]; boxes [B, N, 4] xyxy image coordinates.
    Returns [B, N, P, P, C] float32.
    """
    b, h, w, c = features.shape
    n = boxes.shape[1]
    p, s = output_size, sampling_ratio
    bx = boxes.to(torch.float32) * spatial_scale
    x1, y1 = bx[..., 0] - 0.5, bx[..., 1] - 0.5
    x2, y2 = bx[..., 2] - 0.5, bx[..., 3] - 0.5
    bw = torch.clamp(x2 - x1, min=1e-6)
    bh = torch.clamp(y2 - y1, min=1e-6)
    grid = (torch.arange(p * s, dtype=torch.float32, device=boxes.device)
            + 0.5) / (p * s)
    ys = y1[..., None] + grid * bh[..., None]  # [B, N, p*s]
    xs = x1[..., None] + grid * bw[..., None]
    yi0, yi1, yw0, yw1 = _bilinear_1d(ys, h)
    xi0, xi1, xw0, xw1 = _bilinear_1d(xs, w)

    flat = features.to(torch.float32).reshape(b, h * w, c)

    def tap(yi, xi):
        idx = (yi[..., :, None] * w + xi[..., None, :]).reshape(b, -1, 1)
        return torch.gather(flat, 1, idx.expand(-1, -1, c)).reshape(
            b, n, p * s, p * s, c
        )

    wy0, wy1 = yw0[..., :, None, None], yw1[..., :, None, None]
    wx0, wx1 = xw0[..., None, :, None], xw1[..., None, :, None]
    out = (
        tap(yi0, xi0) * wy0 * wx0
        + tap(yi0, xi1) * wy0 * wx1
        + tap(yi1, xi0) * wy1 * wx0
        + tap(yi1, xi1) * wy1 * wx1
    )
    return out.reshape(b, n, p, s, p, s, c).mean(dim=(3, 5))


def multilevel_roi_align_reference(
    feats: list, boxes: torch.Tensor, levels: torch.Tensor,
    output_size: int = 7, sampling_ratio: int = 2,
) -> torch.Tensor:
    """Plain version of the multilevel kernel: RoIAlign on every level,
    each RoI keeping its own level's result.

    feats: P2..P5 as [B, H_l, W_l, C]; boxes [B, N, 4]; levels [B, N] in
    2..5. Returns [B, N, P, P, C] in the features' dtype.
    """
    out = None
    for i, (f, stride) in enumerate(zip(feats, LEVEL_STRIDES)):
        crop = roi_align_reference(
            f, boxes, output_size, sampling_ratio, 1.0 / stride
        )
        on = (levels == i + 2).to(crop.dtype)[..., None, None, None]
        out = crop * on if out is None else out + crop * on
    return out.to(feats[0].dtype)


def multilevel_roi_align_cuda(
    feats: list, boxes: torch.Tensor, levels: torch.Tensor,
    output_size: int = 7, sampling_ratio: int = 2,
) -> torch.Tensor:
    """The CUDA kernel (kernels/roi_align.cu); same contract as
    multilevel_roi_align_reference. `multilevel_roi_align_cuda.launches`
    counts its launches."""
    feats = [f.contiguous() for f in feats]
    dtype = feats[0].dtype
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"multilevel_roi_align: unsupported dtype {dtype}")
    if any(f.dtype != dtype for f in feats):
        raise ValueError("multilevel_roi_align: levels differ in dtype")
    b, n = boxes.shape[:2]
    c = feats[0].shape[-1]
    if len(feats) != len(LEVEL_STRIDES) or any(
        f.dim() != 4 or f.shape[0] != b or f.shape[-1] != c for f in feats
    ):
        raise ValueError(
            f"multilevel_roi_align: need {len(LEVEL_STRIDES)} levels [{b}, H, W, {c}], "
            f"got {[tuple(f.shape) for f in feats]}"
        )
    if boxes.shape != (b, n, 4) or levels.shape != (b, n):
        raise ValueError(
            f"multilevel_roi_align: boxes {tuple(boxes.shape)}, levels "
            f"{tuple(levels.shape)}"
        )
    boxes = boxes.to(torch.float32).contiguous()
    levels = levels.to(torch.int32).contiguous()
    kernels.require_cuda("multilevel_roi_align", *feats, boxes, levels)
    out = torch.empty(
        (b, n, output_size, output_size, c), dtype=dtype, device=boxes.device
    )
    dims = [d for f in feats for d in f.shape[1:3]]
    kernels.launch(
        "multilevel_roi_align", *[f.data_ptr() for f in feats], *dims, c,
        int(dtype == torch.bfloat16), boxes.data_ptr(), levels.data_ptr(),
        b, n, output_size, sampling_ratio, out.data_ptr(),
        kernels.stream_of(boxes),
    )
    multilevel_roi_align_cuda.launches += 1
    return out


multilevel_roi_align_cuda.launches = 0


def multilevel_roi_align(
    feats: list, boxes: torch.Tensor, levels: torch.Tensor,
    output_size: int = 7, sampling_ratio: int = 2,
) -> torch.Tensor:
    """Dispatching entry point: the kernel for CUDA tensors, the plain
    version for CPU tensors."""
    fn = multilevel_roi_align_cuda if boxes.is_cuda else multilevel_roi_align_reference
    return fn(feats, boxes, levels, output_size, sampling_ratio)
