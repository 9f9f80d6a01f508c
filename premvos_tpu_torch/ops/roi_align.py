"""RoIAlign and crop-and-resize (port of premvos_tpu/ops/roi_align.py and of
the Pallas kernels premvos_tpu/ops/pallas/roi_align_pallas.py and
premvos_tpu/ops/pallas/multilevel_roi_align_pallas.py).

  * `crop_and_resize` — exact `tf.image.crop_and_resize` sampling as two
    interpolation matmuls (plain torch ops, as the JAX package left them to
    XLA).
  * `roi_align_reference` / `roi_align_cuda` / `roi_align_backward_cuda` —
    single-level aligned RoIAlign: the plain version (gather form, whose
    autograd is the plain gradient), the CUDA forward kernel (with an
    optional level filter) and the CUDA kernel of its gradient with respect
    to the features (kernels/roi_align.cu). `roi_align` (one level) and
    `roi_align_levels` (each RoI on its own FPN level, the training form)
    are differentiable in the features and dispatch on the tensors' device.
  * `multilevel_roi_align_reference` / `multilevel_roi_align_cuda` — FPN
    RoIAlign where each RoI is sampled on its own level, forward only (the
    inference path): the plain version and the fused CUDA kernel.
    `multilevel_roi_align` dispatches on the tensors' device.

Every dispatcher sends CUDA tensors to the kernels (a failed launch raises)
and CPU tensors to the plain versions; boxes get no gradient.

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
    # The sample fractions (k + 0.5) / (p·s), correctly rounded to float32
    # on every device (CUDA divides by a scalar through its reciprocal, an
    # ulp off at times, and at coordinates of 200 that moves a sample by
    # 1e-5 px), as the kernels compute them.
    grid = ((torch.arange(p * s, dtype=torch.float64, device=boxes.device) + 0.5)
            / (p * s)).to(torch.float32)
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


def _check_boxes(name: str, boxes: torch.Tensor, b: int, levels=None) -> None:
    n = boxes.shape[1] if boxes.dim() == 3 else -1
    if boxes.shape != (b, n, 4) or (levels is not None and levels.shape != (b, n)):
        raise ValueError(
            f"{name}: boxes {tuple(boxes.shape)}"
            + ("" if levels is None else f", levels {tuple(levels.shape)}")
            + f" for {b} images"
        )


def _launch_roi_align(features, boxes, levels, level, out, p, s, scale) -> None:
    """One launch of premvos_roi_align on tensors already checked: features
    [B, H, W, C] contiguous, boxes float32 and levels int32 (or None)
    contiguous, `out` the contiguous output."""
    b, h, w, c = features.shape
    kernels.launch(
        "roi_align", features.data_ptr(), h, w, c, int(features.dtype == torch.bfloat16),
        float(scale), boxes.data_ptr(), None if levels is None else levels.data_ptr(),
        int(level), b, boxes.shape[1], p, s, out.data_ptr(), kernels.stream_of(boxes),
    )
    roi_align_cuda.launches += 1


def _launch_roi_align_backward(grad_out, boxes, levels, level, grad, s, scale) -> torch.Tensor:
    """One launch of premvos_roi_align_backward on tensors already checked
    (grad_out float32 [B, N, P, P, C], boxes and levels as for
    _launch_roi_align), adding into `grad`, a zeroed contiguous float32
    [B, H, W, C]. Returns `grad`."""
    b, n, p, _, c = grad_out.shape
    kernels.launch(
        "roi_align_backward", grad_out.data_ptr(), grad.shape[1], grad.shape[2], c,
        float(scale), boxes.data_ptr(), None if levels is None else levels.data_ptr(),
        int(level), b, n, p, s, grad.data_ptr(), kernels.stream_of(boxes),
    )
    roi_align_backward_cuda.launches += 1
    return grad


def _boxes_and_levels(name, boxes, b, levels):
    _check_boxes(name, boxes, b, levels)
    boxes = boxes.to(torch.float32).contiguous()
    if levels is not None:
        levels = levels.to(torch.int32).contiguous()
    return boxes, levels


def roi_align_cuda(
    features: torch.Tensor, boxes: torch.Tensor, output_size: int = 7,
    sampling_ratio: int = 2, spatial_scale: float = 1.0,
    levels: torch.Tensor | None = None, level: int = 0,
    out: torch.Tensor | None = None,
) -> torch.Tensor:
    """The single-level CUDA kernel (kernels/roi_align.cu::premvos_roi_align):
    the contract of roi_align_reference, output in the features' dtype.

    With `levels` [B, N] given, only the RoIs whose level (clamped to 2..5)
    is `level` are sampled, into `out` (required then; the other RoIs' rows
    are left as they are); N is then at most 4096 (the kernel refuses more).
    `roi_align_cuda.launches` counts its launches.
    """
    features = features.contiguous()
    dtype = features.dtype
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"roi_align: unsupported dtype {dtype}")
    if features.dim() != 4:
        raise ValueError(f"roi_align: features must be [B, H, W, C], got {tuple(features.shape)}")
    b, h, w, c = features.shape
    boxes, levels = _boxes_and_levels("roi_align", boxes, b, levels)
    if levels is not None and out is None:
        raise ValueError("roi_align: a level filter needs `out`")
    shape = (b, boxes.shape[1], output_size, output_size, c)
    if out is None:
        out = torch.empty(shape, dtype=dtype, device=boxes.device)
    elif tuple(out.shape) != shape or out.dtype != dtype or not out.is_contiguous():
        raise ValueError(
            f"roi_align: out {tuple(out.shape)} {out.dtype}, need a contiguous {shape} {dtype}"
        )
    kernels.require_cuda("roi_align", features, boxes, out, *(() if levels is None else (levels,)))
    _launch_roi_align(features, boxes, levels, level, out, output_size, sampling_ratio,
                      spatial_scale)
    return out


roi_align_cuda.launches = 0


def _check_grad_out(name, grad_out, boxes):
    if grad_out.dim() != 5 or grad_out.shape[2] != grad_out.shape[3]:
        raise ValueError(f"{name}: grad_out {tuple(grad_out.shape)}")
    if boxes.shape[:2] != grad_out.shape[:2]:
        raise ValueError(f"{name}: boxes {tuple(boxes.shape)} for grad_out "
                         f"{tuple(grad_out.shape)}")
    return grad_out.to(torch.float32).contiguous()


def roi_align_backward_cuda(
    grad_out: torch.Tensor, boxes: torch.Tensor, feature_hw: tuple,
    sampling_ratio: int = 2, spatial_scale: float = 1.0,
    levels: torch.Tensor | None = None, level: int = 0,
) -> torch.Tensor:
    """The gradient kernel (kernels/roi_align.cu::premvos_roi_align_backward):
    grad_out [B, N, P, P, C] of roi_align_cuda → the float32 gradient
    [B, H, W, C] with respect to its features, with the same level filter.
    `roi_align_backward_cuda.launches` counts its launches."""
    grad_out = _check_grad_out("roi_align_backward", grad_out, boxes)
    boxes, levels = _boxes_and_levels("roi_align_backward", boxes, grad_out.shape[0], levels)
    kernels.require_cuda("roi_align_backward", grad_out, boxes,
                         *(() if levels is None else (levels,)))
    b, _, _, _, c = grad_out.shape
    grad = torch.zeros((b, *feature_hw, c), dtype=torch.float32, device=boxes.device)
    return _launch_roi_align_backward(grad_out, boxes, levels, level, grad, sampling_ratio,
                                      spatial_scale)


roi_align_backward_cuda.launches = 0


def roi_align_levels_backward(
    grad_out: torch.Tensor, boxes: torch.Tensor, levels: torch.Tensor, feature_hws: list,
    sampling_ratio: int = 2,
) -> list:
    """The training align's backward on CUDA (what `roi_align_levels`'s
    gradient runs): one roi_align_backward_cuda launch per FPN level
    P2, P3, … (`feature_hws` their [H, W]), each on the RoIs of its level
    into a zeroed gradient of its own, with the checks made once. Returns
    the float32 gradients."""
    grad_out = _check_grad_out("roi_align_levels_backward", grad_out, boxes)
    b, _, _, _, c = grad_out.shape
    boxes, levels = _boxes_and_levels("roi_align_levels_backward", boxes, b, levels)
    kernels.require_cuda("roi_align_levels_backward", grad_out, boxes, levels)
    return [
        _launch_roi_align_backward(
            grad_out, boxes, levels, i + 2,
            torch.zeros((b, *hw, c), dtype=torch.float32, device=boxes.device),
            sampling_ratio, 1.0 / stride,
        )
        for i, (hw, stride) in enumerate(zip(feature_hws, LEVEL_STRIDES))
    ]


class _RoIAlignCUDA(torch.autograd.Function):
    """RoIAlign through the kernels, differentiable in the features.

    With `levels` None, `feats` is one feature map at `scales[0]`; else the
    FPN levels 2, 3, … at `scales`, one forward and one backward launch per
    level, each on the RoIs of its level only, into one output.
    """

    @staticmethod
    def forward(ctx, boxes, levels, output_size, sampling_ratio, scales, *feats):
        if levels is None:
            out = roi_align_cuda(feats[0], boxes, output_size, sampling_ratio, scales[0])
        else:
            # Checked once for the four launches (the host path is most of a
            # launch's cost at the box head).
            feats = [f.contiguous() for f in feats]
            b, c, dtype = feats[0].shape[0], feats[0].shape[-1], feats[0].dtype
            if dtype not in (torch.float32, torch.bfloat16):
                raise ValueError(f"roi_align: unsupported dtype {dtype}")
            if any(f.dim() != 4 or f.shape[0] != b or f.shape[-1] != c or f.dtype != dtype
                   for f in feats):
                raise ValueError("roi_align: levels differ in batch, channels or dtype")
            boxes, levels = _boxes_and_levels("roi_align", boxes, b, levels)
            out = torch.empty(
                (b, boxes.shape[1], output_size, output_size, c), dtype=dtype,
                device=boxes.device,
            )
            kernels.require_cuda("roi_align", boxes, levels, out, *feats)
            for i, (f, scale) in enumerate(zip(feats, scales)):
                _launch_roi_align(f, boxes, levels, i + 2, out, output_size, sampling_ratio,
                                  scale)
        ctx.save_for_backward(boxes, levels)
        ctx.hw = [tuple(f.shape[1:3]) for f in feats]
        ctx.dtypes = [f.dtype for f in feats]
        ctx.sampling_ratio, ctx.scales = sampling_ratio, scales
        return out

    @staticmethod
    def backward(ctx, grad_out):
        boxes, levels = ctx.saved_tensors
        if levels is None:
            grads = [roi_align_backward_cuda(grad_out, boxes, ctx.hw[0], ctx.sampling_ratio,
                                             ctx.scales[0])]
        else:
            grads = roi_align_levels_backward(grad_out, boxes, levels, ctx.hw,
                                              ctx.sampling_ratio)
        grads = [g.to(dtype) if need else None
                 for g, dtype, need in zip(grads, ctx.dtypes, ctx.needs_input_grad[5:])]
        return (None, None, None, None, None, *grads)


def _no_box_grad(name: str, boxes: torch.Tensor) -> None:
    if boxes.requires_grad:
        raise ValueError(
            f"{name}: boxes must not require grad (the gradient is taken with "
            "respect to the features only; detach the boxes)"
        )


def roi_align(
    features: torch.Tensor, boxes: torch.Tensor, output_size: int = 7,
    sampling_ratio: int = 2, spatial_scale: float = 1.0,
) -> torch.Tensor:
    """Single-level RoIAlign, differentiable in the features (the port of
    premvos_tpu/ops/roi_align.py::roi_align, batched over images).

    features [B, H, W, C]; boxes [B, N, 4] image coordinates, no gradient.
    Returns [B, N, P, P, C] in the features' dtype: the kernels for CUDA
    tensors, the plain version and its autograd for CPU tensors.
    """
    _no_box_grad("roi_align", boxes)
    if boxes.is_cuda:
        return _RoIAlignCUDA.apply(
            boxes, None, output_size, sampling_ratio, (spatial_scale,), features
        )
    return roi_align_reference(
        features, boxes, output_size, sampling_ratio, spatial_scale
    ).to(features.dtype)


def roi_align_levels(
    feats: list, boxes: torch.Tensor, levels: torch.Tensor,
    output_size: int = 7, sampling_ratio: int = 2,
) -> torch.Tensor:
    """RoIAlign with each RoI on its own FPN level, differentiable in every
    level (the training form).

    feats: P2..P5 as [B, H_l, W_l, C]; boxes [B, N, 4], no gradient; levels
    [B, N] in 2..5. Returns [B, N, P, P, C] in the features' dtype. CUDA
    tensors: the single-level kernel once per level, each launch sampling
    only the RoIs of its level, and the same four launches of its backward.
    CPU tensors: the plain version, every level selected by `levels` (the
    JAX package's training form), and its autograd.
    """
    _no_box_grad("roi_align_levels", boxes)
    if len(feats) != len(LEVEL_STRIDES):
        raise ValueError(f"roi_align_levels: need {len(LEVEL_STRIDES)} levels, got {len(feats)}")
    if boxes.is_cuda:
        scales = tuple(1.0 / s for s in LEVEL_STRIDES)
        return _RoIAlignCUDA.apply(
            boxes, levels, output_size, sampling_ratio, scales, *feats
        )
    return multilevel_roi_align_reference(feats, boxes, levels, output_size, sampling_ratio)
