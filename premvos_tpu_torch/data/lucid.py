"""Lucid-Data-Dreaming host routines (port of premvos_tpu/data/lucid.py).

`inpaint_background` serves both fine-tunes: the fused one
(finetune/fused.py) runs it once per video on the host and generates every
augmentation on the device; the host-pool one (finetune/finetune.py) also
composites its pool here, on the host, with `lucid_dream` / `lucid_batch`
(each object warped by its own affine and, 8 times in 10, a smooth elastic
field, each layer under its own photometric change, over the warped
inpainted background). The JAX package calls OpenCV; the port needs none:
the warps, the blur and the resizes are data/cv_compat.py's and
data/preprocess.py's numpy versions of OpenCV's, and every draw comes from
the caller's `numpy.random.Generator` in the JAX package's order, so the
same seed gives the same pool up to OpenCV's rounding (a bilinear value may
land one level apart, a few values in a million).

Only the pixels that can change the result are computed: an object's warps
over the box its pixels can land in, its elastic field and remaps over
that box grown by the field's reach (|displacement| ≤ alpha), its
photometric change over the box of its warped mask. Everything outside
those boxes is 0 in the warped layer (`elastic_deform` documents what
that means for its image).

The inpainting: the JAX package calls `cv2.dilate` and `cv2.inpaint(...,
5, cv2.INPAINT_TELEA)`; here it is Telea's fast-marching inpainting written
out in Python and numpy with OpenCV's semantics:

  * the band: the 4-neighbours of the masked region outside it, at T = 0;
    first a march outwards from the band over the pixels within `radius`
    (Chebyshev) of the region, whose distances are then negated, then the
    march inwards that inpaints;
  * the arrival time of a pixel is the least of its four quadrant solutions
    of the eikonal equation (`_solve`), fixed when the pixel is first
    reached, with ties in the heap taken in the order they were pushed;
  * a pixel's colour, once reached, is the weighted sum over the known
    (not inside) pixels within `radius` (Euclidean) of their colour plus
    the gradient term, with weights direction × level × distance
    (|r · ∇T|, 1 / (1 + |ΔT|), 1 / |r|³), the image gradient taken one-sided
    where a neighbour is still inside, and OpenCV's rounding of the result
    (+0.5, then round half to even, saturated to uint8); image borders are
    indexed as OpenCV does.

The arithmetic is float32 where OpenCV's is, and each window's sums run in
OpenCV's row-major order; on the tests' frames the result equals
`cv2.inpaint`. The marches run in Python; the colours are computed
afterwards in numpy, one dependency level at a time (a pixel's level is one
more than that of the earlier-reached pixels whose colours it reads, so a
level's pixels read none of each other's), from what each pixel saw when
the march reached it. At 480×864 with 84,000 pixels to fill this takes a
few seconds of host time.
"""

from __future__ import annotations

import heapq
import math
from array import array

import numpy as np
from scipy import ndimage

from premvos_tpu_torch.data.cv_compat import (
    gaussian_blur,
    remap,
    rotation_matrix_2d,
    warp_affine,
)
from premvos_tpu_torch.data.preprocess import resize_linear

_KNOWN, _BAND, _INSIDE = 0, 1, 2
_FAR = 1.0e6  # the arrival time of a pixel not reached


def _disk(radius: int):
    """Offsets (dy, dx) of the window (dy² + dx² ≤ radius²), row-major."""
    dy, dx = np.mgrid[-radius:radius + 1, -radius:radius + 1]
    on = dy * dy + dx * dx <= radius * radius
    return dy[on].astype(np.int64), dx[on].astype(np.int64)


def _solve(f, t, a: int, b: int) -> float:
    """One quadrant's solution of |∇T| = 1 from neighbours a and b (flat
    indices), in double as OpenCV computes it."""
    a11, a22 = t[a], t[b]
    if f[a] != _INSIDE:
        if f[b] != _INSIDE:
            d = a11 - a22
            if abs(d) >= 1.0:
                return 1.0 + min(a11, a22)
            return (a11 + a22 + math.sqrt(2.0 - d * d)) * 0.5
        return 1.0 + a11
    if f[b] != _INSIDE:
        return 1.0 + a22
    return 1.0 + min(a11, a22)


def _arrival(f, t, p: int, wp: int) -> float:
    """The least of the four quadrant solutions at flat index p."""
    up, dn, lf, rt = p - wp, p + wp, p - 1, p + 1
    return min(_solve(f, t, up, lf), _solve(f, t, dn, lf),
               _solve(f, t, up, rt), _solve(f, t, dn, rt))


def _grad(f, t, q: int, step: int) -> float:
    """One component of ∇T at q along `step` (1: x, the row width: y),
    central where both neighbours are known, one-sided where one is."""
    a_in, b_in = f[q + step] == _INSIDE, f[q - step] == _INSIDE
    if not a_in:
        return (t[q + step] - t[q - step]) * 0.5 if not b_in else t[q + step] - t[q]
    return t[q] - t[q - step] if not b_in else 0.0


def telea_inpaint(image: np.ndarray, mask: np.ndarray, radius: int = 5) -> np.ndarray:
    """`cv2.inpaint(image, mask, radius, cv2.INPAINT_TELEA)` for uint8 RGB
    [H, W, 3] and a [H, W] mask (nonzero = inpaint). Returns uint8."""
    image = np.asarray(image, np.uint8)
    h, w = mask.shape
    inside = np.asarray(mask) != 0
    if not inside.any():
        return image.copy()
    # OpenCV's grid is the image padded by one (a KNOWN border); a margin
    # of `radius` + 1 more keeps every read's flat index inside the arrays.
    m = radius + 2
    hp, wp = h + 2 * m, w + 2 * m
    n = hp * wp
    rows = np.arange(hp)[:, None] - (m - 1)  # OpenCV's padded row index
    cols = np.arange(wp)[None, :] - (m - 1)
    core = (rows >= 1) & (rows <= h) & (cols >= 1) & (cols <= w)  # the image

    ins = np.zeros((hp, wp), bool)
    ins[m:m + h, m:m + w] = inside
    cross = ndimage.binary_dilation(ins, ndimage.generate_binary_structure(2, 1))
    band = cross & ~ins & core
    near = ndimage.binary_dilation(ins, np.ones((2 * radius + 1,) * 2, bool))
    outer = near & ~ins & ~band & core  # the outward march's region

    f = bytearray(np.where(ins, _INSIDE, np.where(band, _BAND, _KNOWN)).astype(np.uint8).tobytes())
    t = array("f", np.where(band, 0.0, _FAR).astype(np.float32).tobytes())
    band_idx = np.flatnonzero(band).tolist()  # row-major, as OpenCV adds them

    # Outward march: distances to the band over `outer`, negated after.
    fo = bytearray(np.where(outer, _INSIDE, _KNOWN).astype(np.uint8).tobytes())
    heap = [(0.0, k, p) for k, p in enumerate(band_idx)]
    count = len(heap)
    changed = []
    while heap:
        _, _, p = heapq.heappop(heap)
        fo[p] = _BAND  # OpenCV's CHANGE: no longer inside
        changed.append(p)
        for q in (p - wp, p - 1, p + wp, p + 1):
            if fo[q] == _INSIDE:
                t[q] = _arrival(fo, t, q, wp)
                fo[q] = _BAND
                heapq.heappush(heap, (t[q], count, q))
                count += 1
    for p in changed:
        t[p] = -t[p]

    # Inward march: each pixel's arrival time, ∇T and place in the order,
    # and its level, one more than the highest of the earlier-reached
    # pixels whose colour it reads (all within `reach` of it); pixels of
    # one level read none of each other's colours, so each level's colours
    # are computed together afterwards.
    reach = radius + 2
    order = np.full(n, n, np.int64)  # never reached: after every pixel
    order[~ins.reshape(-1)] = -1
    level = np.zeros((hp, wp), np.int32)
    reached, grads = [], []
    heap = [(0.0, k, p) for k, p in enumerate(band_idx)]
    count = len(heap)
    while heap:
        _, _, p = heapq.heappop(heap)
        f[p] = _KNOWN
        for q in (p - wp, p - 1, p + wp, p + 1):
            if f[q] != _INSIDE:
                continue
            t[q] = _arrival(f, t, q, wp)
            # ∇T at q, one-sided where a neighbour is still inside.
            grads.append((_grad(f, t, q, 1), _grad(f, t, q, wp)))
            qi, qj = divmod(q, wp)
            level[qi, qj] = 1 + level[qi - reach:qi + reach + 1, qj - reach:qj + reach + 1].max()
            order[q] = len(reached)
            reached.append(q)
            f[q] = _BAND
            heapq.heappush(heap, (t[q], count, q))
            count += 1

    col = np.zeros((n, 3), np.float32)
    col.reshape(hp, wp, 3)[m:m + h, m:m + w] = image
    orig = col.copy()
    reached = np.asarray(reached, np.int64)
    grads = np.asarray(grads, np.float32).reshape(-1, 2)
    lv = level.reshape(-1)[reached]
    by_level = np.argsort(lv, kind="stable")
    bounds = np.searchsorted(lv[by_level], np.arange(1, lv.max() + 2))
    tab = _Tables(h, w, m, wp, radius, rows, cols, core, order, np.frombuffer(t, np.float32))
    for a, b in zip(bounds[:-1], bounds[1:]):
        sel = by_level[a:b]
        col[reached[sel]] = tab.colours(reached[sel], grads[sel], col, orig)
    return col.reshape(hp, wp, 3)[m:m + h, m:m + w].astype(np.uint8)


class _Tables:
    """What the colour of a pixel needs besides the colours: the window,
    OpenCV's weights and indexing, and when each pixel stops being inside
    (`order`: -1 known from the start, else its place in the march)."""

    def __init__(self, h, w, m, wp, radius, rows, cols, core, order, t):
        self.wp, self.order, self.t = wp, order, t
        self.core = core.reshape(-1)
        # OpenCV's image gradient reads colours at (km, lm), (km, lp ± 1),
        # (kp + 1, lm), ...: the pixel's own row and column except on the
        # image's first and last ones, where it shifts inwards (km = k - 1
        # + (k == 1), kp = k - 1 - (k == H), in 0-based image rows). As
        # flat indices of the colours:
        rm, rp = rows + (rows == 1), rows - (rows == h)
        cm, cp = cols + (cols == 1), cols - (cols == w)
        flat = lambda r, c: ((r + m - 1) * wp + (c + m - 1)).reshape(-1)  # noqa: E731
        self.maps = dict(
            centre=flat(rm, cm), right=flat(rm, cp + 1), left=flat(rm, cm - 1),
            xself=flat(rm, cp), down=flat(rp + 1, cm), up=flat(rm - 1, cm), yself=flat(rp, cm),
        )
        dy, dx = _disk(radius)
        self.offs = (dy * wp + dx)[:, None]
        self.ry = (-dy).astype(np.float32)[:, None]  # r = (i - k, j - l)
        self.rx = (-dx).astype(np.float32)[:, None]
        with np.errstate(divide="ignore"):
            lsq = (self.rx * self.rx + self.ry * self.ry).astype(np.float64)
            self.dst = (1.0 / (lsq * np.sqrt(lsq))).astype(np.float32)

    def colours(self, p, grads, col, orig):
        """The colours of pixels p (flat indices, none reading another's
        colour) from their windows, as OpenCV computes each when the march
        reaches it: float32, each sum in the window's row-major order."""
        when = self.order[p][None, :]
        known = lambda q: self.order[q] < when  # noqa: E731

        def colour(q):
            # A colour read while its pixel is still inside (only where
            # OpenCV's border indexing shifts a read) is the original one.
            out = np.take(col, q, axis=0)
            late = self.order[q] >= when
            if late.any():
                out[late] = np.take(orig, q[late], axis=0)
            return out

        k = p[None, :] + self.offs  # [window, pixels]
        sel = known(k) & self.core[k]
        tp = self.t[p][None, :]
        lev = (1.0 / (1.0 + np.abs(self.t[k] - tp).astype(np.float64))).astype(np.float32)
        d = self.rx * grads[:, 0] + self.ry * grads[:, 1]
        d = np.where(np.abs(d) <= np.float32(0.01), np.float32(1e-6), d)
        wt = np.where(sel, np.abs(self.dst * lev * d), np.float32(0.0))[..., None]
        mp = {name: mp[k] for name, mp in self.maps.items()}
        c = colour(mp["centre"])
        right, left = colour(mp["right"]), colour(mp["left"])
        down, up = colour(mp["down"]), colour(mp["up"])
        r_known, l_known = known(k + 1)[..., None], known(k - 1)[..., None]
        d_known, u_known = known(k + self.wp)[..., None], known(k - self.wp)[..., None]
        two = np.float32(2.0)
        gix = np.where(r_known, np.where(l_known, (right - left) * two, right - c),
                       np.where(l_known, colour(mp["xself"]) - left, np.float32(0.0)))
        giy = np.where(d_known, np.where(u_known, (down - up) * two, down - c),
                       np.where(u_known, colour(mp["yself"]) - up, np.float32(0.0)))
        # Sums over axis 0 add the window's entries one after another.
        ia = (wt * np.take(col, k, axis=0)).sum(0, dtype=np.float32)
        jx = -(wt * (gix * self.rx[..., None])).sum(0, dtype=np.float32)
        jy = -(wt * (giy * self.ry[..., None])).sum(0, dtype=np.float32)
        s = wt.sum(0, dtype=np.float32)
        sat = ia / s + (jx + jy) / (np.sqrt(jx * jx + jy * jy) + np.float32(1e-20)) + np.float32(0.5)
        return np.clip(np.rint(sat), 0, 255)


def inpaint_background(image: np.ndarray, labels: np.ndarray) -> np.ndarray:
    """Remove all foreground objects (labels > 0, dilated by a 5×5 square)
    by Telea inpainting with radius 5; uint8 RGB in and out."""
    mask = ndimage.binary_dilation(np.asarray(labels) > 0, np.ones((5, 5), bool))
    return telea_inpaint(image, mask, 5)


# ------------------------------------------------------------ host-pool lucid

def _rand_affine(rng, h, w, max_rot=15.0, scale_lo=0.9, scale_hi=1.1, max_shift=0.1):
    ang = rng.uniform(-max_rot, max_rot)
    scale = rng.uniform(scale_lo, scale_hi)
    m = rotation_matrix_2d((w / 2, h / 2), ang, scale)
    m[0, 2] += rng.uniform(-max_shift, max_shift) * w
    m[1, 2] += rng.uniform(-max_shift, max_shift) * h
    return m


def _photometric(rng, img):
    out = img.astype(np.float32)
    out = out * rng.uniform(0.8, 1.2)  # contrast
    out = out + rng.uniform(-20, 20)  # brightness
    # per-channel gain (illumination color shift)
    out = out * rng.uniform(0.9, 1.1, size=(1, 1, 3))
    return np.clip(out, 0, 255).astype(np.uint8)


def _box(mask: np.ndarray, grow: int = 0):
    """(y0, y1, x0, x1) of the nonzero pixels of a [H, W] mask, grown by
    `grow` and clipped to the image; an empty box for an empty mask."""
    rows, cols = np.flatnonzero(mask.any(1)), np.flatnonzero(mask.any(0))
    if not len(rows):
        return (0, 0, 0, 0)
    h, w = mask.shape
    return (max(rows[0] - grow, 0), min(rows[-1] + 1 + grow, h),
            max(cols[0] - grow, 0), min(cols[-1] + 1 + grow, w))


def _warped_box(mask: np.ndarray, m: np.ndarray):
    """The box of output pixels whose source point under warp_affine(·, m)
    has a tap on a nonzero pixel of `mask`: the mask's box grown by one
    pixel, its corners mapped by m, grown by 2 more for rounding."""
    y0, y1, x0, x1 = _box(mask)
    if y1 <= y0:
        return (0, 0, 0, 0)
    h, w = mask.shape
    corners = np.array([[x, y, 1.0] for x in (x0 - 1, x1) for y in (y0 - 1, y1)])
    xy = corners @ np.asarray(m, np.float64).T
    lo, hi = np.floor(xy.min(0)) - 2, np.ceil(xy.max(0)) + 3
    return (int(max(lo[1], 0)), int(min(hi[1], h)), int(max(lo[0], 0)), int(min(hi[0], w)))


def _elastic_maps(rng, h, w, alpha: float = 8.0, sigma: float = 12.0, window=None):
    """Smooth random displacement fields for non-rigid (thin-plate-style)
    deformation: uniform noise at 1/8 resolution, blurred with sigma / 8
    and upsampled bilinearly (the JAX package's recipe and draws), as
    absolute sample maps (map_x, map_y) of the [h, w] frame, or of its
    `window` (y0, y1, x0, x1)."""
    ds = 8
    sh, sw = max(h // ds, 4), max(w // ds, 4)
    dx = gaussian_blur(rng.uniform(-1, 1, (sh, sw)).astype(np.float32), sigma / ds) * alpha
    dy = gaussian_blur(rng.uniform(-1, 1, (sh, sw)).astype(np.float32), sigma / ds) * alpha
    y0, y1, x0, x1 = window or (0, h, 0, w)
    dx = resize_linear(dx, (h, w), (y0, y1, x0, x1))
    dy = resize_linear(dy, (h, w), (y0, y1, x0, x1))
    xx, yy = np.meshgrid(np.arange(x0, x1, dtype=np.float32),
                         np.arange(y0, y1, dtype=np.float32))
    return xx + dx, yy + dy


def elastic_deform(image, mask, rng, alpha: float = 8.0, sigma: float = 12.0):
    """Apply one smooth non-rigid warp to (image, mask) jointly: bilinear
    with a reflected border for the image, nearest with a zero border for
    the mask. The mask is warped everywhere; the image only within alpha +
    2 pixels of the mask's box (everywhere the warped mask can be set) and
    is 0 elsewhere."""
    h, w = mask.shape
    win = _box(np.asarray(mask) != 0, int(np.ceil(alpha)) + 2)
    mx, my = _elastic_maps(rng, h, w, alpha, sigma, win)
    y0, y1, x0, x1 = win
    img_w = np.zeros_like(image)
    m_w = np.zeros((h, w), np.uint8)
    if y1 > y0:
        img_w[y0:y1, x0:x1] = remap(image, mx, my, "linear", "reflect")
        m_w[y0:y1, x0:x1] = remap(np.asarray(mask).astype(np.uint8), mx, my, "nearest")
    return img_w, m_w


def lucid_dream(
    image: np.ndarray,
    labels: np.ndarray,
    rng: np.random.Generator,
    background: np.ndarray | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """One augmented (image, labels) pair from an annotated frame.

    image: [H, W, 3] uint8; labels: [H, W] int (0 = background).
    Each object gets its own affine + photometric perturbation; the
    background gets an independent affine + photometric change.
    """
    h, w = labels.shape
    if background is None:
        background = inpaint_background(image, labels)

    bg_m = _rand_affine(rng, h, w, max_rot=5.0, max_shift=0.05)
    canvas = warp_affine(background, bg_m, (w, h), border="reflect")
    canvas = _photometric(rng, canvas)
    out_labels = np.zeros((h, w), labels.dtype)

    for obj in [i for i in np.unique(labels) if i > 0]:
        m = (labels == obj).astype(np.uint8)
        fg = image * m[..., None]
        am = _rand_affine(rng, h, w)
        box = _warped_box(m, am)
        fg_w = warp_affine(fg, am, (w, h), region=box)
        m_w = warp_affine(m, am, (w, h), "nearest", region=box)
        if rng.uniform() < 0.8:  # non-rigid deformation on top of the affine
            fg_w, m_w = elastic_deform(fg_w, m_w, rng)
        # The photometric change is per pixel: only the pixels pasted below
        # need it (the draws are the same whatever the size).
        y0, y1, x0, x1 = _box(m_w)
        patch = _photometric(rng, fg_w[y0:y1, x0:x1])
        sel = m_w[y0:y1, x0:x1].astype(bool)
        canvas[y0:y1, x0:x1][sel] = patch[sel]
        out_labels[y0:y1, x0:x1][sel] = obj
    return canvas, out_labels


def lucid_batch(image, labels, rng, n: int, background=None):
    """Generate n augmentations; returns (images [n,H,W,3], labels [n,H,W])."""
    if background is None:
        background = inpaint_background(image, labels)
    imgs, labs = [], []
    for _ in range(n):
        i, l = lucid_dream(image, labels, rng, background)
        imgs.append(i)
        labs.append(l)
    return np.stack(imgs), np.stack(labs)
