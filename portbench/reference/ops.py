"""Plain PyTorch ops of the reference pipeline: boxes, NMS, crop-and-resize,
RoIAlign, mask paste and soft IoU, bilinear resize, the exact and the block
warp, the correlation cost volume and channelnorm.

A frozen copy of what the measured program computes on its inference path,
written from the configuration's semantics with plain tensor operations and
no kernel: the benchmark judges the program against it. Operand precisions
are named as the configuration names them ("highest"/"high"/None: float32,
"default": bfloat16 operands with float32 sums); the control, one precision
below, passes "fp8" (operands rounded to float8 e4m3 under a power-of-two
scale per tensor, `fp8_operand`) for bfloat16 and "tf32" (operands rounded
to TF32, `tf32_operand`) for float32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

NEG_INF = -1e10
BBOX_XFORM_CLIP = 4.135166556742356  # log(1000 / 16)
LEVEL_STRIDES = (4, 8, 16, 32)
FP8_MAX = 448.0  # the largest float8 e4m3 value


def fp8_operand(t: torch.Tensor) -> torch.Tensor:
    """`t` rounded to float8 e4m3 under a power-of-two scale that maps its
    largest magnitude at or below 448, returned in bfloat16 (which holds every
    such value exactly): an fp8 matmul operand with float32 sums."""
    x = t.to(torch.float32)
    amax = x.abs().amax().clamp(min=1e-30)
    scale = torch.exp2(torch.ceil(torch.log2(amax / FP8_MAX)))
    return ((x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale).to(torch.bfloat16)


def tf32_operand(t: torch.Tensor) -> torch.Tensor:
    """`t` rounded to TF32's 10 mantissa bits (to nearest, ties away from
    zero), kept in float32: a TF32 matmul operand."""
    bits = t.to(torch.float32).contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def operand(t: torch.Tensor, dt) -> torch.Tensor:
    """`t` as a matmul operand of precision `dt`: a torch dtype, "fp8" or
    "tf32"."""
    if dt == "fp8":
        return fp8_operand(t)
    if dt == "tf32":
        return tf32_operand(t)
    return t.to(dt)


def interp_dtype(name):
    """Operand precision of the crop and paste matmuls for a precision name."""
    if name is None or name in ("highest", "high"):
        return torch.float32
    if name == "default":
        return torch.bfloat16
    if name in ("fp8", "tf32"):
        return name
    raise ValueError(f"unknown interpolation precision {name!r}")


def compute_dtype(dt):
    """The dtype a matmul of operand precision `dt` computes and returns in."""
    return {"fp8": torch.bfloat16, "tf32": torch.float32}.get(dt, dt)


# ------------------------------------------------------------------ boxes

def box_area(boxes):
    w = torch.clamp(boxes[..., 2] - boxes[..., 0], min=0.0)
    h = torch.clamp(boxes[..., 3] - boxes[..., 1], min=0.0)
    return w * h


def box_iou(a, b):
    """Pairwise IoU [..., N, 4] × [..., M, 4] → [..., N, M]."""
    lt = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    rb = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    wh = torch.clamp(rb - lt, min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    union = box_area(a)[..., :, None] + box_area(b)[..., None, :] - inter
    return torch.where(union > 0, inter / torch.clamp(union, min=1e-12), torch.zeros_like(inter))


def clip_boxes(boxes, height, width):
    return torch.stack([
        torch.clamp(boxes[..., 0], 0.0, width), torch.clamp(boxes[..., 1], 0.0, height),
        torch.clamp(boxes[..., 2], 0.0, width), torch.clamp(boxes[..., 3], 0.0, height),
    ], dim=-1)


def decode_boxes(deltas, anchors):
    """(dx, dy, dw, dh) deltas on xyxy anchors → xyxy boxes."""
    aw = anchors[..., 2] - anchors[..., 0]
    ah = anchors[..., 3] - anchors[..., 1]
    ax = anchors[..., 0] + 0.5 * aw
    ay = anchors[..., 1] + 0.5 * ah
    dw = torch.clamp(deltas[..., 2], max=BBOX_XFORM_CLIP)
    dh = torch.clamp(deltas[..., 3], max=BBOX_XFORM_CLIP)
    cx = deltas[..., 0] * aw + ax
    cy = deltas[..., 1] * ah + ay
    w = torch.exp(dw) * aw
    h = torch.exp(dh) * ah
    return torch.stack([cx - 0.5 * w, cy - 0.5 * h, cx + 0.5 * w, cy + 0.5 * h], dim=-1)


def nms(boxes, scores, max_outputs, iou_threshold=0.5, score_threshold=NEG_INF, valid=None):
    """Greedy NMS batched over images: the stable descending score order,
    the dense IoU matrix and a sequential sweep; a box whose IoU with an
    earlier kept box exceeds the threshold is dropped, as are scores at or
    below score_threshold and invalid rows. Returns (indices [B, max_outputs]
    int32, −1-padded, keep bool)."""
    if valid is not None:
        scores = torch.where(valid, scores, torch.full_like(scores, NEG_INF))
    order = torch.sort(-scores, dim=-1, stable=True).indices
    boxes_s = torch.gather(boxes.to(torch.float32), -2, order[..., None].expand(*order.shape, 4))
    alive = torch.gather(scores, -1, order) > score_threshold
    b, n = scores.shape
    iou = box_iou(boxes_s, boxes_s)
    col = torch.arange(n, device=boxes.device)
    suppressed = torch.zeros_like(alive)
    for i in range(n):
        keep_i = ~suppressed[:, i] & alive[:, i]
        suppressed = suppressed | (keep_i[:, None] & (iou[:, i] > iou_threshold) & (col > i))
    kept = ~suppressed & alive
    rank = torch.cumsum(kept.to(torch.int64), dim=-1) - 1
    slot = torch.where(kept & (rank < max_outputs), rank, torch.full_like(rank, max_outputs))
    indices = torch.full((b, max_outputs + 1), -1, dtype=torch.int32, device=boxes.device)
    indices.scatter_(-1, slot, order.to(torch.int32))
    indices = indices[:, :max_outputs]
    return indices, indices >= 0


# ------------------------------------------------------- crops and RoIAlign

def _bilinear_1d(coords, size):
    inside = (coords > -1.0) & (coords < size)
    c = torch.clamp(coords, 0.0, size - 1)
    i0f = torch.floor(c)
    i0 = i0f.to(torch.int64)
    i1 = torch.clamp(i0 + 1, max=size - 1)
    w1 = c - i0f
    zero = torch.zeros_like(w1)
    return i0, i1, torch.where(inside, 1.0 - w1, zero), torch.where(inside, w1, zero)


def _scatter_matrix(i0, i1, w0, w1, shape, size, dtype, device):
    m = torch.zeros(*shape, size, dtype=dtype, device=device)
    m.scatter_add_(-1, i0[..., None], w0[..., None])
    m.scatter_add_(-1, i1[..., None], w1[..., None])
    return m


def crop_and_resize(image, boxes, crop_size, precision=None):
    """tf.image.crop_and_resize, bilinear: image [B, C, H, W], boxes [B, N, 4]
    normalised (y1, x1, y2, x2); sample k of P at y1·(H−1) + k/(P−1)·(y2−y1)·(H−1);
    samples off the image are 0. Returns [B, N, C, P, P] float32."""
    h, w = image.shape[-2:]
    p = crop_size
    dev = image.device
    t = (torch.arange(p, dtype=torch.float32, device=dev) / (p - 1) if p > 1
         else torch.full((1,), 0.5, dtype=torch.float32, device=dev))
    y1, x1, y2, x2 = boxes.unbind(-1)
    ys = (y1[..., None] + t * (y2 - y1)[..., None]) * (h - 1)
    xs = (x1[..., None] + t * (x2 - x1)[..., None]) * (w - 1)
    dt = interp_dtype(precision)
    wy = operand(_scatter_matrix(*_bilinear_1d(ys, h), ys.shape, h, ys.dtype, dev), dt)
    wx = operand(_scatter_matrix(*_bilinear_1d(xs, w), xs.shape, w, xs.dtype, dev), dt)
    tmp = torch.einsum("bnkh,bchw->bnckw", wy, operand(image, dt))
    if dt in ("fp8", "tf32"):
        tmp = operand(tmp, dt)
    out = torch.einsum("bnqw,bnckw->bnckq", wx, tmp)
    return out.to(torch.float32)


def roi_align(features, boxes, output_size=7, sampling_ratio=2, spatial_scale=1.0):
    """Aligned RoIAlign on one level: features [B, H, W, C], boxes [B, N, 4]
    xyxy image coordinates → [B, N, P, P, C] float32, each bin the mean of
    s × s bilinear samples."""
    b, h, w, c = features.shape
    n = boxes.shape[1]
    p, s = output_size, sampling_ratio
    bx = boxes.to(torch.float32) * spatial_scale
    x1, y1 = bx[..., 0] - 0.5, bx[..., 1] - 0.5
    bw = torch.clamp(bx[..., 2] - 0.5 - x1, min=1e-6)
    bh = torch.clamp(bx[..., 3] - 0.5 - y1, min=1e-6)
    grid = ((torch.arange(p * s, dtype=torch.float64, device=boxes.device) + 0.5)
            / (p * s)).to(torch.float32)
    yi0, yi1, yw0, yw1 = _bilinear_1d(y1[..., None] + grid * bh[..., None], h)
    xi0, xi1, xw0, xw1 = _bilinear_1d(x1[..., None] + grid * bw[..., None], w)
    flat = features.to(torch.float32).reshape(b, h * w, c)

    def tap(yi, xi):
        idx = (yi[..., :, None] * w + xi[..., None, :]).reshape(b, -1, 1)
        return torch.gather(flat, 1, idx.expand(-1, -1, c)).reshape(b, n, p * s, p * s, c)

    wy0, wy1 = yw0[..., :, None, None], yw1[..., :, None, None]
    wx0, wx1 = xw0[..., None, :, None], xw1[..., None, :, None]
    out = (tap(yi0, xi0) * wy0 * wx0 + tap(yi0, xi1) * wy0 * wx1
           + tap(yi1, xi0) * wy1 * wx0 + tap(yi1, xi1) * wy1 * wx1)
    return out.reshape(b, n, p, s, p, s, c).mean(dim=(3, 5))


def roi_levels(boxes):
    """FPN level of each box: floor(4 + log2(sqrt(area) / 224)) in 2..5."""
    scale = torch.sqrt(torch.clamp(box_area(boxes), min=1e-6))
    return torch.clamp(torch.floor(4.0 + torch.log2(scale / 224.0 + 1e-12)), 2, 5).to(torch.int32)


def multilevel_roi_align(feats, boxes, output_size, sampling_ratio=2):
    """RoIAlign of each box on its own FPN level: feats {"P2".."P5": [B, C, H, W]}
    → [B, N, P, P, C] in the features' dtype."""
    levels = roi_levels(boxes)
    out = None
    for i, stride in enumerate(LEVEL_STRIDES):
        f = feats[f"P{i + 2}"].permute(0, 2, 3, 1)
        crop = roi_align(f, boxes, output_size, sampling_ratio, 1.0 / stride)
        on = (levels == i + 2).to(crop.dtype)[..., None, None, None]
        out = crop * on if out is None else out + crop * on
    return out.to(feats["P2"].dtype)


# ------------------------------------------------------------------ masks

def soft_mask_iou(a, b, precision=None):
    """Σ a·b / (Σ a + Σ b − Σ a·b) between [N, H, W] and [M, H, W] → [N, M],
    in the promoted dtype ("tf32": the products' operands rounded to TF32)."""
    dt = torch.promote_types(a.dtype, b.dtype)
    a, b = a.to(dt), b.to(dt)
    if precision == "tf32":
        inter = torch.einsum("nhw,mhw->nm", tf32_operand(a), tf32_operand(b))
    else:
        inter = torch.einsum("nhw,mhw->nm", a, b)
    sa = a.reshape(a.shape[0], -1).sum(-1)
    sb = b.reshape(b.shape[0], -1).sum(-1)
    union = sa[:, None] + sb[None, :] - inter
    return torch.where(union > 0, inter / torch.clamp(union, min=1e-6), torch.zeros_like(inter))


def _paste_weights(c, size):
    inside = (c > -0.5) & (c < size - 0.5)
    cc = torch.clamp(c, 0.0, size - 1.0)
    i0f = torch.floor(cc)
    i0 = i0f.to(torch.int64)
    i1 = torch.clamp(i0 + 1, max=size - 1)
    w1 = cc - i0f
    zero = torch.zeros_like(w1)
    return _scatter_matrix(i0, i1, torch.where(inside, 1.0 - w1, zero),
                           torch.where(inside, w1, zero), c.shape, size, c.dtype, c.device)


def paste_mask(mask, box, height, width, precision=None):
    """Paste [..., M, M] box-frame masks of xyxy boxes [..., 4] into
    [..., height, width] canvases: pixel (y, x) samples the mask bilinearly at
    ((y + .5 − y1) / bh · M − .5, (x + .5 − x1) / bw · M − .5), zero outside
    the box. Two interpolation matmuls; float32 out."""
    m = mask.shape[-1]
    mask = mask.to(torch.float32)
    x1, y1, x2, y2 = (box[..., i, None].to(torch.float32) for i in range(4))
    bw = torch.clamp(x2 - x1, min=1e-6)
    bh = torch.clamp(y2 - y1, min=1e-6)
    yy = torch.arange(height, dtype=torch.float32, device=mask.device)
    xx = torch.arange(width, dtype=torch.float32, device=mask.device)
    dt = interp_dtype(precision)
    wy = operand(_paste_weights((yy + 0.5 - y1) / bh * m - 0.5, m), dt)
    wx = operand(_paste_weights((xx + 0.5 - x1) / bw * m - 0.5, m), dt)
    tmp = torch.matmul(wy, operand(mask, dt))
    if dt in ("fp8", "tf32"):
        tmp = operand(tmp, dt)
    return torch.matmul(tmp, wx.transpose(-1, -2)).to(torch.float32)


# ------------------------------------------------------------ resize, warps

def resize_bilinear(x, size):
    """[N, C, H, W] → [N, C, *size] as jax.image.resize "bilinear": half-pixel
    centres, antialiased (in float32) when an axis shrinks."""
    h, w = x.shape[-2:]
    if size[0] < h or size[1] < w:
        out = F.interpolate(x.float(), size=size, mode="bilinear", align_corners=False,
                            antialias=True)
        return out.to(x.dtype)
    return F.interpolate(x, size=size, mode="bilinear", align_corners=False)


def warp_exact(src, flow):
    """Backward bilinear warp src [B, C, H, W] by flow [B, 2, H, W] (u, v), the
    sample point clamped into the image."""
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


def warp_block(src, flow, block=(8, 128), residual=4, max_flow=64):
    """The block warp: every pixel samples inside a window of 2r + 2 pixels a
    side set by its block's mean displacement, rounded half to even (the sum
    in float64, the division in float32); the sample point is clamped to
    [−lf, size − 1 + lf] first and to the window after; taps outside the
    image read its edge."""
    by, bx = block
    b, c, h, w = src.shape
    out_dtype = torch.promote_types(src.dtype, flow.dtype)
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
    n = ((h - oy).clamp(max=by)[:, None] * (w - ox).clamp(max=bx)[None, :]).to(f32)
    pad = (0, nbx * bx - w, 0, nby * by - h)

    def window_start(s, coord, origin):
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
    d_y, d_x = torch.floor(t_y), torch.floor(t_x)

    def weight(t, d):
        return torch.clamp(1.0 - (t - d).abs(), min=0.0)[:, None]

    wy0, wy1 = weight(t_y, d_y), weight(t_y, d_y + 1)
    wx0, wx1 = weight(t_x, d_x), weight(t_x, d_x + 1)
    flat = src.to(f32).reshape(b, c, h * w)

    def tap(yi, xi):
        idx = (yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)).reshape(b, 1, h * w)
        return torch.gather(flat, 2, idx.expand(b, c, h * w)).reshape(b, c, h, w)

    top = wx0 * tap(y0, x0) + wx1 * tap(y0, x0 + 1)
    bot = wx0 * tap(y0 + 1, x0) + wx1 * tap(y0 + 1, x0 + 1)
    return (wy0 * top + wy1 * bot).to(out_dtype)


def warp(src, flow, impl="block"):
    if impl == "block":
        return warp_block(src, flow)
    if impl == "gather":
        return warp_exact(src, flow)
    raise ValueError(f"unknown warp {impl!r}")


# ------------------------------------------------------------ correlation

def num_displacements(max_displacement, stride):
    return 2 * (max_displacement // stride) + 1


def correlation(f1, f2, max_displacement=20, stride=2, dt=torch.float32):
    """Cost volume [B, D², H, W] in float32: out[b, i·D + j, y, x] =
    (1/C) Σ_c f1[b, c, y, x] · f2[b, c, y + i·stride − md, x + j·stride − md],
    f2 zero off the image; products of operands in precision `dt`."""
    if dt == "fp8":
        f1, f2 = fp8_operand(f1), fp8_operand(f2)
    f1 = f1.to(torch.float32)
    f2 = f2.to(torch.float32)
    b, c, h, w = f1.shape
    pad = max_displacement
    d = num_displacements(max_displacement, stride)
    f2p = F.pad(f2, (pad, pad, pad, pad))
    out = f1.new_empty((b, d * d, h, w))
    for i in range(d):
        for j in range(d):
            shifted = f2p[:, :, i * stride:i * stride + h, j * stride:j * stride + w]
            out[:, i * d + j] = torch.sum(f1 * shifted, dim=1)
    return out / c


def channelnorm(x, eps=1e-12):
    return torch.sqrt(torch.sum(x * x, dim=1, keepdim=True) + eps)
