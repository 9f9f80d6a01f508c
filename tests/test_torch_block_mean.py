"""The block warp's rounded block mean at a half, in the port against the
JAX package's XLA block warp, on the CPU.

Each (8, 128) block of the block warp takes m = round_half_even(S / n), S
the sum of its pixels' displacements and n their count. The port sums S
in float64, rounds it to float32 and divides in float32
(premvos_tpu_torch/ops/resample2d.py, the module docstring); the JAX
package's `_block_prep` sums in float32, in XLA's order. Where S / n lies
within float32 rounding of k + 0.5, the two may take windows one pixel
apart.

The flows here are built so that most blocks' exact mean is k + 0.5 or
one float32 step of S either side of it: each displacement is k + f +
j / 4096 (f = 0.5; j drawn up to ±1600, then shifted so that the j sum to
−1, 0 or +1), exact in float32, and so is y + v, so both packages see the
same displacements and part only in how they sum them. A quarter of the
blocks take f = 0.25 instead, a mean far from a half, as controls. Full
and ragged blocks (n = 1024 and 5 · 72 = 360), along y and x.

What is held: the port's window starts are the documented rule computed
in numpy (float64 sum, float32 division, half to even); wherever JAX's
window start differs from the port's, it is by one pixel and in a block
whose exact mean lies within 2^-20 of a half (never a control); and the
port's plain block warp equals JAX's within 1e-5 of the largest |src|
(the tolerance of tests/test_torch_block_warp.py) in every block, those
whose starts part too: every displacement lies within 0.4 of k + 0.5, so
inside both windows, and the two read the same source pixels.

They part: XLA's float32 sum of a 1024-pixel block whose exact sum is
−5632 + 2^-12 lands above −5632, so JAX rounds the mean to −5, while the
port rounds the float64 sum to −5632 (a tie, to even) and the mean −5.5 to
−6 (ROADMAP, queue 3). The test prints each parted block.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from premvos_tpu_torch.ops.resample2d import block_taps, resample2d_block_reference
from tests._threads import few_threads  # noqa: F401

jax_resample2d = importlib.import_module("premvos_tpu.ops.resample2d")

BLOCK, R, LF = (8, 128), 4, 64
STEP = 2.0 ** -12  # the displacements' grain
# (H, W): whole blocks only, and ragged last blocks (5 rows, 72 columns).
SHAPES = [(32, 384), (29, 200)]


def _blocks(h, w):
    by, bx = BLOCK
    for oy in range(0, h, by):
        for ox in range(0, w, bx):
            yield oy, ox, slice(oy, min(oy + by, h)), slice(ox, min(ox + bx, w))


def _half_flow(rng, h, w):
    """flow [2, H, W] float32 (u, v) whose every block's exact mean
    displacement on each axis is k + f + t · STEP / n, t in {−1, 0, 1}, f
    0.5 (or 0.25 in a quarter of the blocks); and the (k, f, t, n) drawn,
    per axis and block."""
    flow = np.zeros((2, h, w), np.float32)
    drawn = {}
    for axis in range(2):
        for oy, ox, ys, xs in _blocks(h, w):
            n = (ys.stop - ys.start) * (xs.stop - xs.start)
            k, t = int(rng.integers(-6, 7)), int(rng.integers(-1, 2))
            f = 0.25 if rng.uniform() < 0.25 else 0.5
            j = rng.integers(-1600, 1601, n)
            q, rest = divmod(t - int(j.sum()), n)
            j += q
            j[:rest] += 1
            assert j.sum() == t
            d = k + f + j * STEP
            assert np.array_equal(d.astype(np.float32).astype(np.float64), d)
            flow[axis, ys, xs] = d.reshape(ys.stop - ys.start, xs.stop - xs.start)
            drawn[axis, oy, ox] = (k, f, t, n)
    return flow, drawn


def _documented_starts(flow, h, w):
    """{(axis, oy, ox): window start} by the port's rule, in numpy."""
    out = {}
    coords = (np.arange(w, dtype=np.float32)[None, :], np.arange(h, dtype=np.float32)[:, None])
    for axis in range(2):
        s = np.clip(coords[axis] + flow[axis], -LF, (w, h)[axis] - 1.0 + LF).astype(np.float32)
        d = (s - coords[axis]).astype(np.float32)
        for oy, ox, ys, xs in _blocks(h, w):
            blk = d[ys, xs]
            mean = np.float32(blk.astype(np.float64).sum()) / np.float32(blk.size)
            out[axis, oy, ox] = (ox, oy)[axis] + int(np.round(mean)) - R
    return out


def _jax_starts(src, flow, h, w):
    """{(axis, oy, ox): window start} of JAX's _block_prep at (8, 128)."""
    _, starts, _, _, g = jax_resample2d._block_prep(
        jnp.asarray(src.transpose(1, 2, 0)), jnp.asarray(flow.transpose(1, 2, 0)), BLOCK, R, LF)
    starts = np.asarray(starts).reshape(g["nby"], g["nbx"], 2)
    margin = (BLOCK[0] + R + LF, BLOCK[1] + R + LF)
    out = {}
    for oy, ox, _, _ in _blocks(h, w):
        sy, sx = starts[oy // BLOCK[0], ox // BLOCK[1]]
        out[0, oy, ox] = int(sx) - margin[1]
        out[1, oy, ox] = int(sy) - margin[0]
    return out


@pytest.mark.parametrize("h,w", SHAPES, ids=[f"{h}x{w}" for h, w in SHAPES])
def test_block_mean_at_a_half_against_jax(h, w):
    rng = np.random.default_rng(h * 1000 + w)
    parted, blocks = [], 0
    for _ in range(6):
        flow, drawn = _half_flow(rng, h, w)
        src = rng.uniform(-2, 2, (3, h, w)).astype(np.float32)
        ws_y, ws_x, *_ = block_taps(torch.from_numpy(flow)[None], BLOCK, R, LF)
        port = {}
        for oy, ox, _, _ in _blocks(h, w):
            port[0, oy, ox] = int(ws_x[0, oy, ox])
            port[1, oy, ox] = int(ws_y[0, oy, ox])
        assert port == _documented_starts(flow, h, w)
        want_ws = _jax_starts(src, flow, h, w)
        got = resample2d_block_reference(torch.from_numpy(src)[None], torch.from_numpy(flow)[None],
                                         BLOCK, R, LF)[0].numpy()
        want = np.asarray(jax_resample2d.resample2d_block(
            jnp.asarray(src.transpose(1, 2, 0)), jnp.asarray(flow.transpose(1, 2, 0)), BLOCK, R,
            LF, use_pallas=False)).transpose(2, 0, 1)
        for oy, ox, ys, xs in _blocks(h, w):
            blocks += 1
            differ = [a for a in range(2) if port[a, oy, ox] != want_ws[a, oy, ox]]
            for a in differ:
                k, f, t, n = drawn[a, oy, ox]
                assert abs(port[a, oy, ox] - want_ws[a, oy, ox]) == 1
                assert f == 0.5 and abs(t * STEP / n) <= 2.0 ** -20, (a, oy, ox, k, f, t, n)
                parted.append((a, oy, ox, k, t, n))
            np.testing.assert_allclose(got[:, ys, xs], want[:, ys, xs], rtol=0, atol=1e-5)
    print(f"{h}x{w}: {len(parted)} of {2 * blocks} block means parted (axis, oy, ox, k, t, n): "
          f"{parted}")
