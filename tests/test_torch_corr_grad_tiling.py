"""The tiling of the correlation backward kernel, rendered on the CPU.

`tiled_grads` walks the blocks, ring stages and warps of
`kernels/correlation.cu::corr_grad_kernel` with the kernel's own index maps:
blocks of R = 8 output rows × 16 columns of one residue class × a chunk of
8·NT channels, the staged union of source rows (only those on the image),
the source columns staged in k-steps of 8 from the first on-image column
and cut into groups of at most 64, each warp's band W stored as [q][u − uw]
(u = k − q) and read back at the A fragment's (q, k), and the 3xTF32
products with both pieces rounded to tf32 by masking mantissa bits (big to
nearest, small truncated). Each gradient must agree with
`correlation_grads_reference` within 1e-5 of its largest |value|, the
tolerance the CUDA tests hold the kernel to, and every output element must
be written exactly once. `tests/test_torch_flow_train.py` holds that
reference against the JAX package's `_correlation_grads`.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from premvos_tpu_torch.ops.correlation import correlation_grads_reference, num_displacements

Q = 16  # output columns a warp (16 rows of the product)
ROWS = 8  # output rows a block, one warp each
KG_MAX = 64  # source columns a ring stage, at most
STAGES = 3  # depth of the ring
SMEM_MAX = 227 * 1024  # shared memory a block may use, bytes


def _tf32(x: np.ndarray, round_nearest: bool) -> np.ndarray:
    bits = np.ascontiguousarray(x, np.float32).view(np.uint32)
    if round_nearest:
        bits = bits + np.uint32(0x1000)
    return (bits & np.uint32(0xFFFFE000)).view(np.float32)


def _mma3(w: np.ndarray, s: np.ndarray, three: bool = True) -> np.ndarray:
    """w [B, 16, K] @ s [B, K, C] as the kernel's 3xTF32 mma (or plain
    TF32 when `three` is False); the products of tf32 pieces are exact in
    float32, the sums are float32."""
    wb, sb = _tf32(w, True), _tf32(s, True)
    if not three:
        return wb @ sb
    ws, ss = _tf32(w - wb, False), _tf32(s - sb, False)
    return ws @ sb + wb @ ss + wb @ sb


def layout(d: int, w: int, s: int, nt: int, kg_max: int = KG_MAX):
    """The kernel's stage width kg (the most columns a block's k-steps can
    span, halved while shared memory overflows) and band row stride ldj
    (8m + 5)."""
    k8 = (d + Q - 1 + 7) // 8 * 8
    w8 = (-(-w // s) + 7) // 8 * 8
    kg = min(k8, w8, kg_max)
    while True:
        window = min(d, kg + Q - 1)
        ldj = 5 if window <= 5 else (window - 5 + 7) // 8 * 8 + 5
        ring = STAGES * (kg * 8 * nt + ROWS * Q * ldj) + 2 * kg * 8 * nt
        if 4 * max(ring, ROWS * Q * (8 * nt + 8)) <= SMEM_MAX:
            return kg, ldj
        assert kg > 8
        kg = (kg // 2 + 7) // 8 * 8


def tiled_grads(f1, f2, g, md, s, kg_max=KG_MAX, three=True):
    """df1, df2 channels-last [B, H, W, C] from f1, f2 channels-last and g
    [B, D², H, W] (float32 numpy), block by block as the kernel computes
    them; every element must be written once."""
    bsz, h, w, c = f1.shape
    d = num_displacements(md, s)
    nt = 16 if c > 64 else 8
    cc = 8 * nt
    kg, ldj = layout(d, w, s, nt, kg_max)
    groups = (-(-h // s) + ROWS - 1) // ROWS
    tiles = -(-w // (s * Q))
    chunks = -(-c // cc)
    g = g.reshape(bsz, d, d, h, w)
    outs = []
    for df2 in (False, True):
        src = np.zeros((bsz, h, w, chunks * cc), np.float32)
        src[..., :c] = f1 if df2 else f2
        out = np.full((bsz, h, w, c), np.nan, np.float32)
        writes = np.zeros((h, w, c), np.int32)
        for chunk in range(chunks):
            c0 = chunk * cc
            for r in range(s):
                for tile in range(tiles):
                    x0 = tile * s * Q + r
                    for residue in range(s):
                        for group in range(groups):
                            y_start = residue + s * ROWS * group
                            if y_start >= h:
                                continue
                            acc = _block(src, g, c0, cc, x0, y_start, h, w, d, md, s, kg, ldj,
                                         df2, three)
                            for t in range(ROWS):
                                y = y_start + s * t
                                if y >= h:
                                    continue
                                for q in range(Q):
                                    x = x0 + s * q
                                    if x >= w:
                                        continue
                                    n = min(cc, c - c0)
                                    out[:, y, x, c0:c0 + n] = acc[t][:, q, :n] * np.float32(1.0 / c)
                                    writes[y, x, c0:c0 + n] += 1
        assert (writes == 1).all(), "an output element was written other than once"
        outs.append(out)
    return outs


def _block(src, g, c0, cc, x0, y_start, h, w, d, md, s, kg, ldj, df2, three):
    """One block's sums [ROWS][B, 16, cc], stage by stage."""
    bsz = src.shape[0]
    xbase = x0 + md - s * (d - 1) if df2 else x0 - md
    k_lo = 0 if xbase >= 0 else (-xbase + s - 1) // s
    k_hi = -1 if xbase > w - 1 else min(d + Q - 2, (w - 1 - xbase) // s)
    ybase = y_start + md - s * (d - 1) if df2 else y_start - md
    live = min(ROWS, (h - 1 - y_start) // s + 1)
    q_lo = 0 if ybase >= 0 else (-ybase + s - 1) // s
    q_hi = -1 if ybase > h - 1 else min(live + d - 2, (h - 1 - ybase) // s)
    ksteps = (k_hi - k_lo + 8) // 8 if k_hi >= k_lo else 0
    ngk = (8 * ksteps + kg - 1) // kg
    n_stages = (q_hi - q_lo + 1) * ngk if q_hi >= q_lo else 0
    acc = [np.zeros((bsz, Q, cc), np.float32) for _ in range(ROWS)]
    qq = np.arange(Q)[:, None]
    for st in range(n_stages):
        qr, gk = q_lo + st // ngk, st % ngk
        ka, kn = k_lo + gk * kg, min(kg, 8 * ksteps - gk * kg)
        ys = ybase + s * qr
        assert 0 <= ys < h, "a staged source row lies off the image"
        # The ring stage: source columns ka..ka+kn-1 of row ys (zeros past
        # k_hi), channels c0..c0+cc-1 (zeros past C).
        ks = ka + np.arange(kn)
        on = ks <= k_hi
        stage = np.zeros((bsz, kn, cc), np.float32)
        stage[:, on] = src[:, ys, xbase + s * ks[on], c0:c0 + cc]
        for t in range(ROWS):
            y = y_start + s * t
            u_i = qr - t
            if y >= h or not 0 <= u_i < d:
                continue
            i = d - 1 - u_i if df2 else u_i
            # The warp's band at [q][u - uw]: only u in [0, D) whose source
            # column k = u + q is staged and on the image (and, for df1,
            # rows whose output column is on the image) are loaded; the
            # rest stays NaN, as unwritten shared memory may hold anything.
            uw = max(0, ka - (Q - 1))
            un = min(d, ka + kn) - uw
            assert 0 < un <= ldj
            uu = np.arange(un)[None, :]
            u = uw + uu
            k = u + qq
            xg = xbase + s * k if df2 else np.broadcast_to(x0 + s * qq, k.shape)
            valid = (k >= ka) & (k < ka + kn) & (k <= k_hi) & (xg < w)
            j = d - 1 - u if df2 else u
            band = np.full((bsz, Q, ldj), np.nan, np.float32)
            qv, uv = np.nonzero(valid)
            jv = np.broadcast_to(j, k.shape)[qv, uv]
            band[:, qv, uv] = g[:, i, jv, ys if df2 else y, xg[qv, uv]]
            # A = W at (q, k = ka + kl): u = k - q on the band, k on the
            # image.
            ka_abs = ka + np.arange(kn)[None, :]
            ua = ka_abs - qq
            inband = (ua >= 0) & (ua < d) & (ka_abs <= k_hi)
            wa = np.zeros((bsz, Q, kn), np.float32)
            qa, ka_ = np.nonzero(inband)
            wa[:, qa, ka_] = band[:, qa, ua[qa, ka_] - uw]
            acc[t] += _mma3(wa, stage, three)
    return acc


def _inputs(case, seed=0):
    b, c, h, w, md, s = case
    d = num_displacements(md, s)
    rng = np.random.default_rng(seed)
    f1, f2 = (rng.standard_normal((b, h, w, c)).astype(np.float32) for _ in range(2))
    g = rng.standard_normal((b, d * d, h, w)).astype(np.float32)
    return f1, f2, g


def _reference(f1, f2, g, md, s):
    nchw = [torch.from_numpy(x).permute(0, 3, 1, 2) for x in (f1, f2)]
    return [t.permute(0, 2, 3, 1).numpy()
            for t in correlation_grads_reference(*nchw, torch.from_numpy(g), md, s)]


# (B, C, H, W, max displacement, stride) and the stage width's cap: C = 3
# with a max displacement that is not a multiple of the stride; the odd
# shape of the CUDA tests at stride 2 (D = 21) and 1 (D = 41); H < R·s;
# H = 50 (above R·s + 2·md, so the last row's farthest displacement bounds
# the staged rows, and not a multiple of R·s); C = 200 (128-channel
# chunks, the second partly past C); D = 61 (K = 76, two column groups of
# 64); D = 61 with 128-channel chunks (the stage shrinks to 32 columns to
# fit shared memory); and D = 41 cut into groups of 16 columns.
CASES = {
    "c3_md9": ((1, 3, 7, 20, 9, 2), KG_MAX),
    "odd_s2": ((2, 64, 23, 37, 20, 2), KG_MAX),
    "odd_s1": ((2, 64, 23, 37, 20, 1), KG_MAX),
    "h_below_rows": ((1, 16, 5, 40, 6, 2), KG_MAX),
    "h50_w30": ((1, 16, 50, 30, 20, 2), KG_MAX),
    "c200": ((1, 200, 6, 19, 4, 2), KG_MAX),
    "d61_groups": ((1, 8, 9, 70, 30, 1), KG_MAX),
    "d61_c72_shrunk": ((1, 72, 9, 70, 30, 1), KG_MAX),
    "odd_s1_kg16": ((1, 64, 23, 37, 20, 1), 16),
}


@pytest.mark.parametrize("case,kg_max", list(CASES.values()), ids=list(CASES))
def test_tiling_matches_reference(case, kg_max):
    f1, f2, g = _inputs(case)
    md, s = case[4:]
    got = tiled_grads(f1, f2, g, md, s, kg_max)
    for name, x, ref in zip(("df1", "df2"), got, _reference(f1, f2, g, md, s)):
        scale = float(np.abs(ref).max())
        err = float(np.abs(x - ref).max())
        assert err <= 1e-5 * scale, (name, err / scale)


def test_plain_tf32_misses_the_tolerance():
    """The 1e-5 tolerance needs the three products: plain TF32 (big pieces
    only) misses it on the odd stride-2 shape."""
    case = CASES["odd_s2"][0]
    f1, f2, g = _inputs(case)
    md, s = case[4:]
    got = tiled_grads(f1, f2, g, md, s, three=False)
    errs = [float(np.abs(x - ref).max()) / float(np.abs(ref).max())
            for x, ref in zip(got, _reference(f1, f2, g, md, s))]
    assert min(errs) > 1e-5, errs


def test_tf32_pieces():
    """big + small splits a float32 value within 2^-21 of it; big keeps 11
    significant bits, rounded to nearest with ties away from zero."""
    x = np.random.default_rng(1).standard_normal(10_000).astype(np.float32)
    big = _tf32(x, True)
    small = _tf32(x - big, False)
    assert (big.view(np.uint32) & 0x1FFF == 0).all() and (small.view(np.uint32) & 0x1FFF == 0).all()
    assert (np.abs(x - big) <= np.abs(x) * 2.0 ** -11).all()
    assert (np.abs(x - (big + small)) <= np.abs(x) * 2.0 ** -21).all()
    assert _tf32(np.float32([1 + 2 ** -11]), True)[0] == np.float32(1 + 2 ** -10)
