"""Image preprocessing (port of premvos_tpu/data/preprocess.py: `pad_to`,
`normalize`, `to_unit`), and the
host resizes the JAX package does with OpenCV, in numpy: `resize_area_u8`
(INTER_AREA) and `resize_nearest` (INTER_NEAREST) of the fused fine-tune's
set-up (finetune/fused.py), and `resize_linear` (INTER_LINEAR on float32)
of DavisObjectCrops (data/crops.py) and the host-pool fine-tune
(data/lucid.py, finetune/finetune.py; its other OpenCV calls are in
data/cv_compat.py); and `resize_bicubic_pil`, the uint8 resize the JAX
package's COCO and VOC crops do with Pillow."""

from __future__ import annotations

import math

import numpy as np
import torch

# ImageNet statistics (the backbones' pretraining convention).
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def pad_to(image: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """Zero-pad [..., H, W, C] bottom/right to the static canvas."""
    h, w = image.shape[-3:-1]
    return torch.nn.functional.pad(image, (0, 0, 0, width - w, 0, height - h))


def normalize(image: torch.Tensor) -> torch.Tensor:
    """uint8/float [0,255] or [0,1] RGB [..., 3] → ImageNet-normalized float32.

    The range test takes ONE max over the whole tensor (a batch of frames is
    scaled together), as the JAX version does.
    """
    x = image.to(torch.float32)
    x = torch.where(x.amax() > 2.0, x / 255.0, x)
    mean = torch.tensor(IMAGENET_MEAN, dtype=torch.float32, device=x.device)
    std = torch.tensor(IMAGENET_STD, dtype=torch.float32, device=x.device)
    return (x - mean) / std


def to_unit(image: torch.Tensor) -> torch.Tensor:
    """uint8 RGB → [0,1] float32 (flow net convention)."""
    return image.to(torch.float32) / 255.0


def _area_weights(src: int, dst: int) -> np.ndarray:
    """[dst, src] weights of OpenCV's INTER_AREA along one axis (the
    overlap of each destination cell, `src / dst` source pixels wide, with
    each source pixel, over the cell's width), for src ≥ dst."""
    scale = src / dst
    m = np.zeros((dst, src), np.float64)
    for d in range(dst):
        f1 = d * scale
        f2 = f1 + scale
        width = min(scale, src - f1)
        s1 = min(math.ceil(f1), min(math.floor(f2), src - 1))
        s2 = min(math.floor(f2), src - 1)
        if s1 - f1 > 1e-3:
            m[d, s1 - 1] = np.float32((s1 - f1) / width)
        m[d, s1:s2] = np.float32(1.0 / width)
        if f2 - s2 > 1e-3:
            m[d, s2] = np.float32(min(min(f2 - s2, 1.0), width) / width)
    return m


def resize_area_u8(image: np.ndarray, hw: tuple) -> np.ndarray:
    """uint8 [H, W, C] → [h, w, C] downscale as `cv2.resize(...,
    interpolation=cv2.INTER_AREA)`: separable box-overlap weights, rounded
    half to even and saturated as OpenCV rounds (the sums run in another
    order, so a value may land one level apart); for integer factors the
    block mean rounded half up. Needs h ≤ H and w ≤ W."""
    h, w = hw
    src_h, src_w = image.shape[:2]
    if h > src_h or w > src_w:
        raise ValueError(f"resize_area_u8 downscales only: {image.shape[:2]} → {hw}")
    if src_h % h == 0 and src_w % w == 0:
        # Integer factors: OpenCV's block mean, rounded half up.
        fy, fx = src_h // h, src_w // w
        blocks = image.reshape(h, fy, w, fx, -1).astype(np.int64).sum((1, 3))
        return ((blocks + fy * fx // 2) // (fy * fx)).astype(np.uint8).reshape(h, w, *image.shape[2:])
    ay, ax = _area_weights(src_h, h), _area_weights(src_w, w)
    rows = ay @ image.astype(np.float64).reshape(src_h, -1)  # [h, W·C]
    out = np.tensordot(rows.reshape(h, src_w, -1), ax, ([1], [1])).transpose(0, 2, 1)
    return np.clip(np.rint(out), 0, 255).astype(np.uint8).reshape(h, w, *image.shape[2:])


def resize_nearest(labels: np.ndarray, hw: tuple) -> np.ndarray:
    """[H, W] → [h, w] as `cv2.resize(..., interpolation=cv2.INTER_NEAREST)`:
    source index floor(dst · src / dst_size), clamped to the last one."""
    h, w = hw
    src_h, src_w = labels.shape[:2]
    ys = np.minimum(np.floor(np.arange(h) * (src_h / h)).astype(np.int64), src_h - 1)
    xs = np.minimum(np.floor(np.arange(w) * (src_w / w)).astype(np.int64), src_w - 1)
    return labels[ys[:, None], xs[None, :]]


def _linear_taps(src: int, dst: int):
    """Source indices (i0, i1) and the weight of i1 along one axis, as
    OpenCV's INTER_LINEAR computes them: half-pixel centres
    (dst + 0.5) · src / dst − 0.5, the fraction taken in float64 and
    rounded to float32, clamped to the first and last pixel (weight 0
    there)."""
    f = (np.arange(dst) + 0.5) * (src / dst) - 0.5
    i0 = np.floor(f).astype(np.int64)
    frac = (f - i0).astype(np.float32)
    low, high = i0 < 0, i0 >= src - 1
    frac[low | high] = 0.0
    i0 = np.clip(i0, 0, src - 1)
    return i0, np.minimum(i0 + 1, src - 1), frac


def resize_linear(image: np.ndarray, hw: tuple, window=None) -> np.ndarray:
    """float32 [H, W, C] → [h, w, C] as `cv2.resize(image, (w, h))`
    (INTER_LINEAR): half-pixel centres, no antialias when shrinking, edge
    pixels repeated; the rows first, then the columns, in float32.
    `window` (y0, y1, x0, x1): only that part of the [h, w] output."""
    h, w = hw
    src_h, src_w = image.shape[:2]
    x = np.asarray(image, np.float32)
    x0, x1, fx = _linear_taps(src_w, w)
    y0, y1, fy = _linear_taps(src_h, h)
    if window is not None:
        r0, r1, c0, c1 = window
        x0, x1, fx = x0[c0:c1], x1[c0:c1], fx[c0:c1]
        y0, y1, fy = y0[r0:r1], y1[r0:r1], fy[r0:r1]
    shape = (1, len(fx)) + (1,) * (x.ndim - 2)
    fx = fx.reshape(shape)
    rows = x[:, x0] * (np.float32(1) - fx) + x[:, x1] * fx
    fy = fy.reshape((len(fy), 1) + (1,) * (x.ndim - 2))
    return (rows[y0] * (np.float32(1) - fy) + rows[y1] * fy).astype(np.float32)


# Pillow's fixed-point resampling (libImaging/Resample.c): coefficients
# scaled by 2**22, sums started at half of that, each pass's result cut to
# uint8.
_PIL_PRECISION_BITS = 22


def _pil_bicubic(x: float) -> float:
    """Pillow's bicubic filter (a = -0.5, support 2)."""
    x = abs(x)
    if x < 1.0:
        return (1.5 * x - 2.5) * x * x + 1
    if x < 2.0:
        return (((x - 5) * x + 8) * x - 4) * -0.5
    return 0.0


def _pil_bicubic_matrix(src: int, dst: int) -> np.ndarray:
    """[dst, src] int64 fixed-point taps, as Resample.c's precompute_coeffs
    and normalize_coeffs_8bpc compute them (in float64, in its order)."""
    scale = src / dst
    filterscale = max(scale, 1.0)
    support = 2.0 * filterscale
    ss = 1.0 / filterscale
    out = np.zeros((dst, src), np.int64)
    for xx in range(dst):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), src) - xmin
        w = [_pil_bicubic((x + xmin - center + 0.5) * ss) for x in range(xmax)]
        ww = 0.0
        for v in w:
            ww += v
        for x, v in enumerate(w):
            k = v / ww if ww != 0.0 else v
            k *= 1 << _PIL_PRECISION_BITS
            out[xx, xmin + x] = int(k - 0.5) if k < 0 else int(k + 0.5)
    return out


def _pil_pass(x: np.ndarray, taps: np.ndarray, axis: int) -> np.ndarray:
    acc = np.tensordot(x.astype(np.int64), taps, axes=([axis], [1]))
    acc = np.moveaxis(acc, -1, axis) + (1 << (_PIL_PRECISION_BITS - 1))
    return np.clip(acc >> _PIL_PRECISION_BITS, 0, 255).astype(np.uint8)


def resize_bicubic_pil(image: np.ndarray, hw: tuple) -> np.ndarray:
    """uint8 [H, W, C] → [h, w, C] as
    `np.asarray(Image.fromarray(image).resize((w, h)))` (Pillow's default
    BICUBIC on RGB): the columns first, then the rows, each a fixed-point
    convolution whose support widens with the shrink factor, cut to uint8
    between the passes. A pass whose size does not change is skipped, as in
    Pillow."""
    h, w = hw
    x = np.asarray(image, np.uint8)
    if x.shape[1] != w:
        x = _pil_pass(x, _pil_bicubic_matrix(x.shape[1], w), 1)
    if x.shape[0] != h:
        x = _pil_pass(x, _pil_bicubic_matrix(x.shape[0], h), 0)
    return x
