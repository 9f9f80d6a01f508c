"""The OpenCV calls of the host-pool fine-tune, in numpy and scipy.

The JAX package builds its lucid-dream pool (data/lucid.py) and its refine
examples (finetune/finetune.py) with OpenCV; the port runs where OpenCV is
not installed, so each call it needs is written out here with OpenCV's
semantics (held against `cv2` in tests/test_torch_pool_finetune.py):

  * `rotation_matrix_2d` = `cv2.getRotationMatrix2D`, exact;
  * `warp_affine` = `cv2.warpAffine` of uint8 images: the inverse of the
    matrix (OpenCV's inversion, float64), each pixel's source point in
    float32 as OpenCV computes it (`_coords`), then bilinear in float32 along x and then y, rounded half to
    even (about 3 values in 10,000 land one level apart from OpenCV's), or
    nearest (the source point rounded half to even: equal), with
    BORDER_REFLECT (fedcba|abcdef) or a zero border;
  * `remap` = `cv2.remap` with float32 maps: bilinear as warp_affine, or
    nearest (the map rounded half to even, as cvRound);
  * `gaussian_blur` = `cv2.GaussianBlur(x, (0, 0), sigma)` of float32: the
    side round(8σ + 1) | 1, the normalized float64 kernel in float32,
    separable, BORDER_REFLECT_101;
  * `dilate` / `erode` = `cv2.dilate` / `cv2.erode` with ones((k, k)): the
    anchor at k // 2 (an even k spreads towards +1), pixels outside the
    image never win;
  * `resize_linear_u8` = `cv2.resize(x, (w, h))` (INTER_LINEAR) of uint8:
    OpenCV's 11-bit fixed-point weights and the truncations of its vertical
    pass, bit for bit (and its INTER_AREA shortcut for an exact 2× shrink).

`data/preprocess.py` holds the float32 INTER_LINEAR resize (`resize_linear`)
and the INTER_AREA and INTER_NEAREST ones.
"""

from __future__ import annotations

import math

import numpy as np
from scipy import ndimage

from premvos_tpu_torch.data.preprocess import resize_area_u8


def rotation_matrix_2d(center, angle: float, scale: float) -> np.ndarray:
    """`cv2.getRotationMatrix2D(center, angle, scale)`: [2, 3] float64,
    angle in degrees, counter-clockwise."""
    ang = math.radians(angle)
    a, b = math.cos(ang) * scale, math.sin(ang) * scale
    cx, cy = center
    return np.array([[a, b, (1 - a) * cx - b * cy],
                     [-b, a, b * cx + (1 - a) * cy]], np.float64)


def invert_affine(m: np.ndarray) -> np.ndarray:
    """`cv2.invertAffineTransform`, in OpenCV's order of operations."""
    m = np.asarray(m, np.float64).reshape(6).copy()
    d = m[0] * m[4] - m[1] * m[3]
    d = 1.0 / d if d != 0 else 0.0
    a11, a22 = m[4] * d, m[0] * d
    m[0], m[1], m[3], m[4] = a11, m[1] * -d, m[3] * -d, a22
    b1 = -m[0] * m[2] - m[1] * m[5]
    b2 = -m[3] * m[2] - m[4] * m[5]
    m[2], m[5] = b1, b2
    return m.reshape(2, 3)


def _coords(m: np.ndarray, h: int, w: int, region=None):
    """The source point of each output pixel of `region` (y0, y1, x0, x1;
    default the whole [h, w] output) under the inverse of `m`, as OpenCV
    computes it: the matrix in float32, each row's m1 · y + m2 in float32,
    then m0 · x added to it by a fused multiply-add (one rounding; here
    the exact product in float64, then rounded)."""
    y0, y1, x0, x1 = region or (0, h, 0, w)
    im = invert_affine(m).astype(np.float32)
    xs = np.arange(x0, x1, dtype=np.float32)[None, :].astype(np.float64)
    ys = np.arange(y0, y1, dtype=np.float32)[:, None]
    rows = [(im[r, 1] * ys + im[r, 2]).astype(np.float64) for r in (0, 1)]
    return tuple((np.float64(im[r, 0]) * xs + rows[r]).astype(np.float32) for r in (0, 1))


def _packed(src: np.ndarray, pad: int, mode: str):
    """src [H, W(, C)] uint8 padded by `pad` on each side ("symmetric" is
    BORDER_REFLECT, "constant" zeros) with each pixel's channels packed
    into one word (C ≤ 4), for one flat gather a tap."""
    c = 1 if src.ndim == 2 else src.shape[2]
    px = np.zeros(src.shape[:2] + (4,), np.uint8)
    px[..., :c] = src.reshape(src.shape[:2] + (c,))
    px = np.pad(px, ((pad, pad), (pad, pad), (0, 0)), mode=mode)
    return np.ascontiguousarray(px).view(np.uint32)[..., 0], c


def _bilinear(src: np.ndarray, x: np.ndarray, y: np.ndarray, border: str) -> np.ndarray:
    """uint8 [H, W(, C ≤ 4)] sampled bilinearly at float32 (x, y) [h, w],
    as OpenCV interpolates (float32, along x then y) and rounds (half to
    even); taps off the image read the reflected pixel ("reflect") or 0."""
    h, w = src.shape[:2]
    xf, yf = np.floor(x), np.floor(y)
    ax, ay = (x - xf)[..., None], (y - yf)[..., None]
    xi, yi = xf.astype(np.int64), yf.astype(np.int64)
    if not xi.size:
        return np.zeros(x.shape + src.shape[2:], np.uint8)
    inside = xi.min() >= 0 and yi.min() >= 0 and xi.max() + 1 < w and yi.max() + 1 < h
    if border == "reflect" and not inside:
        # Pad far enough that every tap lands in the padded image.
        pad = max(0, int(-xi.min()), int(xi.max()) + 2 - w, int(-yi.min()),
                  int(yi.max()) + 2 - h)
        packed, c = _packed(src, pad, "symmetric")
    else:
        # Only the source pixels the taps reach, with two zero pixels
        # around them; a point farther out reads only zeros from there.
        lx, ly = int(np.clip(xi.min(), 0, w)), int(np.clip(yi.min(), 0, h))
        hx, hy = int(np.clip(xi.max() + 2, 0, w)), int(np.clip(yi.max() + 2, 0, h))
        pad = 2
        src = src[ly:hy, lx:hx]
        xi = np.clip(xi - lx, -2, hx - lx)
        yi = np.clip(yi - ly, -2, hy - ly)
        packed, c = _packed(src, pad, "constant")
    wp = packed.shape[1]
    flat = packed.reshape(-1)
    idx = (yi + pad) * wp + (xi + pad)

    def tap(off):
        return np.take(flat, idx + off).view(np.uint8).reshape(idx.shape + (4,)) \
            .astype(np.float32)

    # v0 = p00 + ax (p01 - p00), v1 = p10 + ax (p11 - p10),
    # v = v0 + ay (v1 - v0), in place.
    p00, p01, p10, p11 = tap(0), tap(1), tap(wp), tap(wp + 1)
    for lo, hi in ((p00, p01), (p10, p11)):
        hi -= lo
        hi *= ax
        lo += hi
    p10 -= p00
    p10 *= ay
    p00 += p10
    v = p00[..., :c]
    out = np.clip(np.rint(v), 0, 255).astype(np.uint8)
    return out.reshape(x.shape + src.shape[2:])


def _nearest(src: np.ndarray, x: np.ndarray, y: np.ndarray) -> np.ndarray:
    """src at (x, y) rounded half to even (cvRound), 0 off the image."""
    h, w = src.shape[:2]
    xi, yi = np.rint(x).astype(np.int64), np.rint(y).astype(np.int64)
    on = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
    flat = src.reshape(h * w, *src.shape[2:])
    out = flat[np.where(on, yi * w + xi, 0)]
    out[~on] = 0
    return out


def warp_affine(src: np.ndarray, m: np.ndarray, dsize, interpolation: str = "linear",
                border: str = "constant", region=None) -> np.ndarray:
    """`cv2.warpAffine(src, m, dsize, flags, borderMode)` of a uint8 image
    [H, W(, C)]: dsize is (width, height) as OpenCV takes it,
    interpolation "linear" or "nearest", border "constant" (0) or
    "reflect" (linear only). `region` (y0, y1, x0, x1): compute only that
    window of the output, 0 elsewhere (for a source that is 0 outside a
    known box, whose image under `m` the window holds)."""
    w, h = dsize
    out = np.zeros((h, w) + src.shape[2:], np.uint8)
    y0, y1, x0, x1 = region or (0, h, 0, w)
    if y1 <= y0 or x1 <= x0:
        return out
    x, y = _coords(m, h, w, (y0, y1, x0, x1))
    if interpolation == "nearest":
        if border != "constant":
            raise ValueError("warp_affine: nearest supports the zero border only")
        out[y0:y1, x0:x1] = _nearest(src, x, y)
    else:
        out[y0:y1, x0:x1] = _bilinear(src, x, y, border)
    return out


def remap(src: np.ndarray, map_x: np.ndarray, map_y: np.ndarray,
          interpolation: str = "linear", border: str = "constant") -> np.ndarray:
    """`cv2.remap(src, map_x, map_y, interpolation, borderMode)` of a uint8
    image with float32 maps [h, w]: "linear" (as warp_affine) or "nearest"
    (the map rounded half to even, 0 off the image); border "constant" (0)
    or "reflect" (linear only)."""
    mx, my = np.asarray(map_x, np.float32), np.asarray(map_y, np.float32)
    if interpolation == "nearest":
        if border != "constant":
            raise ValueError("remap: nearest supports the zero border only")
        return _nearest(src, mx, my)
    return _bilinear(src, mx, my, border)


def gaussian_kernel(sigma: float) -> np.ndarray:
    """OpenCV's float32 Gaussian kernel for a float32 image and ksize (0, 0):
    side round(8σ + 1) | 1, exp(-x² / 2σ²) normalized in float64."""
    n = int(math.floor(sigma * 8 + 1 + 0.5)) | 1
    x = np.arange(n, dtype=np.float64) - (n - 1) * 0.5
    t = np.exp(x * x * (-0.5 / (sigma * sigma)))
    return (t / t.sum()).astype(np.float32)


def gaussian_blur(x: np.ndarray, sigma: float) -> np.ndarray:
    """`cv2.GaussianBlur(x, (0, 0), sigma)` of a float32 [H, W] array:
    separable, rows then columns, BORDER_REFLECT_101."""
    k = gaussian_kernel(sigma).astype(np.float64)
    out = ndimage.correlate1d(np.asarray(x, np.float32), k, axis=1, mode="mirror")
    return ndimage.correlate1d(out, k, axis=0, mode="mirror").astype(np.float32)


def _morph(m: np.ndarray, k: int, op) -> np.ndarray:
    """op (np.maximum / np.minimum) over the k×k window at offsets
    -(k // 2) .. k - 1 - k // 2, pixels off the image left out."""
    a = k // 2
    out = m.copy()
    for axis in (0, 1):
        src, n = out, m.shape[axis]
        out = src.copy()
        for d in range(-a, k - a):
            if d == 0 or abs(d) >= n:
                continue
            dst = [slice(None)] * 2
            from_ = [slice(None)] * 2
            if d > 0:
                dst[axis], from_[axis] = slice(0, n - d), slice(d, n)
            else:
                dst[axis], from_[axis] = slice(-d, n), slice(0, n + d)
            out[tuple(dst)] = op(out[tuple(dst)], src[tuple(from_)])
    return out


def dilate(m: np.ndarray, k: int) -> np.ndarray:
    """`cv2.dilate(m, np.ones((k, k), np.uint8))` of a [H, W] array."""
    return _morph(np.asarray(m), int(k), np.maximum)


def erode(m: np.ndarray, k: int) -> np.ndarray:
    """`cv2.erode(m, np.ones((k, k), np.uint8))` of a [H, W] array."""
    return _morph(np.asarray(m), int(k), np.minimum)


def _u8_linear_taps(src: int, dst: int, clamp: bool):
    """OpenCV's INTER_LINEAR taps along one axis for uint8: source indices
    (i0, i1) and the weights (w0, w1) in 11-bit fixed point (the float32
    fraction × 2048, rounded). For uint8 OpenCV rounds the source
    coordinate to float32 before it takes the floor and the fraction (its
    float32 resize takes the fraction in float64: `resize_linear`). Along
    x (`clamp`) a tap before the first or past the last pixel gets the
    weights (2048, 0); along y OpenCV keeps the fraction and clips the row
    indices."""
    f = ((np.arange(dst) + 0.5) * (src / dst) - 0.5).astype(np.float32)
    i0 = np.floor(f).astype(np.int64)
    frac = f - i0.astype(np.float32)
    if clamp:
        frac[(i0 < 0) | (i0 >= src - 1)] = 0.0
    w1 = np.rint(frac.astype(np.float64) * 2048.0).astype(np.int64)
    w0 = np.rint((np.float32(1.0) - frac).astype(np.float64) * 2048.0).astype(np.int64)
    return np.clip(i0, 0, src - 1), np.clip(i0 + 1, 0, src - 1), w0, w1


def resize_linear_u8(image: np.ndarray, hw: tuple) -> np.ndarray:
    """`cv2.resize(image, (w, h))` (INTER_LINEAR) of a uint8 [H, W(, C)]
    image, bit for bit: the horizontal pass in int32 (weights × 2048), the
    vertical pass as OpenCV computes it for uint8, truncating each product
    ((v0 >> 4) · b0 >> 16 + (v1 >> 4) · b1 >> 16, + 2 >> 2); an exact 2×
    shrink is INTER_AREA, as in OpenCV."""
    h, w = hw
    img = np.asarray(image, np.uint8)
    src_h, src_w = img.shape[:2]
    if (src_h, src_w) == (h, w):
        return img.copy()
    if src_h == 2 * h and src_w == 2 * w:
        return resize_area_u8(img, hw)
    x0, x1, a0, a1 = (t.astype(np.int32) for t in _u8_linear_taps(src_w, w, True))
    y0, y1, b0, b1 = (t.astype(np.int32) for t in _u8_linear_taps(src_h, h, False))
    s = img.astype(np.int32).reshape(src_h, src_w, -1)
    # Horizontal pass (int32: at most 255 · 2048), pre-shifted by 4 as the
    # vertical pass reads it.
    rows = (s[:, x0] * a0[None, :, None] + s[:, x1] * a1[None, :, None]).reshape(src_h, -1) >> 4
    # OpenCV's uint8 vertical pass, vector and scalar alike: int16 lanes,
    # mul_hi = (a · b) >> 16, a saturating add, then + 2 >> 2.
    out = (rows[y0] * b0[:, None] >> 16) + (rows[y1] * b1[:, None] >> 16)
    out = (np.clip(out, -32768, 32767) + 2) >> 2
    out = np.clip(out, 0, 255).astype(np.uint8)
    return out.reshape((h, w) + img.shape[2:])
