"""Dense mask operations (port of premvos_tpu/ops/masks.py)."""

from __future__ import annotations

import torch

from premvos_tpu_torch.ops.roi_align import interp_dtype


def mask_iou(a: torch.Tensor, b: torch.Tensor, threshold: float = 0.5) -> torch.Tensor:
    """IoU matrix between [N, H, W] and [M, H, W] masks → [N, M]: each mask
    binarized at `threshold` first (0: the inputs are already binary {0, 1}
    floats), then intersection over union as one matmul, 0 where the union
    is empty."""
    ab = (a > threshold).to(torch.float32) if threshold else a
    bb = (b > threshold).to(torch.float32) if threshold else b
    af = ab.reshape(ab.shape[0], -1)
    bf = bb.reshape(bb.shape[0], -1)
    inter = af @ bf.T
    union = af.sum(-1)[:, None] + bf.sum(-1)[None, :] - inter
    return torch.where(union > 0, inter / torch.clamp(union, min=1.0), torch.zeros_like(inter))


def soft_mask_iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Soft IoU Σmin/Σmax-style: [N, H, W] × [M, H, W] → [N, M] (no
    binarization; computed in the promoted dtype of a and b)."""
    dt = torch.promote_types(a.dtype, b.dtype)
    a, b = a.to(dt), b.to(dt)
    inter = torch.einsum("nhw,mhw->nm", a, b)
    sa = a.reshape(a.shape[0], -1).sum(-1)
    sb = b.reshape(b.shape[0], -1).sum(-1)
    union = sa[:, None] + sb[None, :] - inter
    return torch.where(
        union > 0, inter / torch.clamp(union, min=1e-6), torch.zeros_like(inter)
    )


def _lin(c: torch.Tensor, size: int):
    inside = (c > -0.5) & (c < size - 0.5)
    cc = torch.clamp(c, 0.0, size - 1.0)
    i0f = torch.floor(cc)
    i0 = i0f.to(torch.int64)
    i1 = torch.clamp(i0 + 1, max=size - 1)
    w1 = cc - i0f
    zero = torch.zeros_like(w1)
    return i0, i1, torch.where(inside, 1.0 - w1, zero), torch.where(inside, w1, zero)


def _weights(c: torch.Tensor, size: int) -> torch.Tensor:
    """[..., L] coords → [..., L, size] paste interpolation matrix."""
    i0, i1, w0, w1 = _lin(c, size)
    m = torch.zeros(*c.shape, size, dtype=c.dtype, device=c.device)
    m.scatter_add_(-1, i0[..., None], w0[..., None])
    m.scatter_add_(-1, i1[..., None], w1[..., None])
    return m


def paste_mask(
    mask: torch.Tensor,
    box: torch.Tensor,
    height: int,
    width: int,
    precision: str | None = None,
) -> torch.Tensor:
    """Paste [..., M, M] masks predicted for xyxy boxes [..., 4] into
    [..., height, width] canvases (bilinear, zero outside the box).

    Image pixel (y, x) samples the mask at
    ((y + .5 − y1) / bh · M − .5, (x + .5 − x1) / bw · M − .5), as two
    interpolation matmuls. Returns float32.
    """
    m = mask.shape[-1]
    mask = mask.to(torch.float32)
    x1, y1, x2, y2 = (box[..., i, None].to(torch.float32) for i in range(4))
    bw = torch.clamp(x2 - x1, min=1e-6)
    bh = torch.clamp(y2 - y1, min=1e-6)
    yy = torch.arange(height, dtype=torch.float32, device=mask.device)
    xx = torch.arange(width, dtype=torch.float32, device=mask.device)
    my = (yy + 0.5 - y1) / bh * m - 0.5  # [..., H]
    mx = (xx + 0.5 - x1) / bw * m - 0.5  # [..., W]
    dt = interp_dtype(precision)
    wy = _weights(my, m).to(dt)  # [..., H, M]
    wx = _weights(mx, m).to(dt)  # [..., W, M]
    out = torch.matmul(torch.matmul(wy, mask.to(dt)), wx.transpose(-1, -2))
    return out.to(torch.float32)
