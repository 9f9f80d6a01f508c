"""The block warp (warp_impl "block", the JAX package's default) in the port
against the JAX package, on the CPU.

The JAX side is the TPU kernel's function: `jax_tpu_block_warp` pins the JAX
package's `resample2d_block` to its XLA path at the Pallas kernel's (8, 128)
blocks (tests/_jax_block_warp.py), and one test holds the port against
resample2d_block_pallas in interpret mode. The flows leave the blocks'
windows on purpose (noise of ±30 px, flow past max_flow, far out of the
image), where the block warp is not the exact warp, and
`test_block_warp_is_not_the_exact_warp` shows that on these flows, so a port
that kept the exact warp fails here. Then FlowNet2, the merge's mask warp,
`run_sequence`, the replay and the lucid patches at "block", each on a flow
that leaves the window.

Tolerances: the plain version against JAX 1e-5 of the largest |src| (both
compute the same float32 operations; measured: equal); FlowNet2 1e-4 of the
largest |flow| (the convolutions' float32 reassociation, as
tests/test_torch_pipeline.py); labels as run_sequence's parity test there
(≥ 99 % of pixels, frame 0 exact); the replay exact; the lucid canvases as
tests/test_torch_finetune.py's lucid test.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from premvos_tpu.finetune import lucid_device as jl
from premvos_tpu.ops.pallas.resample2d_pallas import resample2d_block_pallas
from premvos_tpu.ops.resample2d import resample2d_block as jax_resample2d_block
from premvos_tpu.pipeline import runner as jr
from premvos_tpu.stages.flow import warp_masks_coarse as jax_warp_masks_coarse
from premvos_tpu_torch import config as tc
from premvos_tpu_torch.bridge import flax_tree, params_from_jax
from premvos_tpu_torch.finetune import lucid_device as tl
from premvos_tpu_torch.ops.resample2d import (
    block_taps,
    resample2d_block,
    resample2d_block_reference,
    resample2d_reference,
    warp,
)
from premvos_tpu_torch.ops.resize import resize_bilinear
from premvos_tpu_torch.pipeline import runner as tr
from premvos_tpu_torch.stages.flow import run_flow_pairs, warp_masks_coarse
from tests._jax_block_warp import jax_tpu_block_warp  # noqa: F401 (autouse)
from tests.test_torch_diagnose import hand_precompute, port_entry
from tests.test_torch_finetune import (
    _consts,
    _jax_consts,
    _lucid_draws,
    _port_consts,
    _soft_pastes,
    _stack_lucid,
)
from tests.test_torch_pipeline import JCFG, H, W, _close, _nchw, _video
from tests._threads import few_threads  # noqa: F401

# (block, residual, max_flow): the TPU kernel's defaults (FlowNet2, the
# merge) and the lucid fine-tune's two warps.
PARAMS = {"tpu": ((8, 128), 4, 64), "lucid_bg": ((16, 16), 4, 160),
          "lucid_patch": ((8, 8), 6, 64)}
# (parameters, (H, W), C, src dtype): ragged sizes at every block shape.
CASES = [
    ("tpu", (29, 37), 1, "float32"), ("tpu", (40, 136), 3, "bfloat16"),
    ("tpu", (40, 136), 8, "float32"), ("lucid_bg", (29, 37), 3, "float32"),
    ("lucid_bg", (40, 136), 8, "bfloat16"), ("lucid_patch", (29, 37), 8, "bfloat16"),
    ("lucid_patch", (40, 136), 1, "float32"),
]
FLOW_KINDS = ("noise", "past_max_flow", "far_out", "zero", "half")

JCFG_B = dataclasses.replace(
    JCFG, flow=dataclasses.replace(JCFG.flow, warp_impl="block"),
    merge=dataclasses.replace(JCFG.merge, warp_impl="block"))
TCFG_B = tc._from_dict(tc.PremvosConfig, dataclasses.asdict(JCFG_B))


def _flows(rng, h, w, max_flow):
    """[5, H, W, 2]: one image for each of FLOW_KINDS."""
    return np.stack([
        rng.uniform(-30, 30, (h, w, 2)),
        rng.uniform(-1.5 * max_flow, 1.5 * max_flow, (h, w, 2)),
        np.where(rng.uniform(size=(h, w, 2)) < 0.5, -500.0, 500.0),
        np.zeros((h, w, 2)),
        np.full((h, w, 2), 0.5),
    ]).astype(np.float32)


def _inputs(case, seed=0):
    name, (h, w), c, dtype = case
    rng = np.random.default_rng(seed)
    src = rng.uniform(-2, 2, (len(FLOW_KINDS), h, w, c)).astype(np.float32)
    if dtype == "bfloat16":  # values a bf16 holds, so both sides read the same
        src = np.asarray(jnp.asarray(src, jnp.bfloat16).astype(jnp.float32))
    return src, _flows(rng, h, w, PARAMS[name][2])


def _port(x, dtype="float32"):
    return torch.from_numpy(np.array(x)).permute(0, 3, 1, 2).to(getattr(torch, dtype))


def _nhwc(t):
    return t.permute(0, 2, 3, 1).numpy()


def _leaves_window(flow, block=(8, 128), residual=4, max_flow=64):
    """Whether some pixel of [B, 2, H, W] `flow` leaves its block's window:
    the block warp of a ramp (every pixel its own value) then differs from
    the exact warp."""
    b, _, h, w = flow.shape
    ramp = torch.arange(h * w, dtype=torch.float32).reshape(1, 1, h, w).expand(b, 1, h, w)
    diff = resample2d_block_reference(ramp, flow, block, residual, max_flow) \
        - resample2d_reference(ramp, flow)
    return bool((diff.abs() > 1e-2).any())


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"{c[0]}-{c[1][0]}x{c[1][1]}-c{c[2]}-{c[3]}")
def test_block_reference_matches_jax(case):
    """The plain version against the JAX XLA block warp
    (resample2d_block(use_pallas=False)) at the case's parameters, on every
    flow kind at once: within 1e-5 of the largest |src|."""
    block, residual, max_flow = PARAMS[case[0]]
    src, flow = _inputs(case)
    jsrc = jnp.asarray(src, getattr(jnp, case[3]))
    want = jax.jit(functools.partial(jax_resample2d_block, block=block, residual=residual,
                                     max_flow=max_flow, use_pallas=False))(jsrc, jnp.asarray(flow))
    got = resample2d_block(_port(src, case[3]), _port(flow), block, residual, max_flow)
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), rtol=0,
                               atol=1e-5 * float(np.abs(src).max()))


@pytest.mark.parametrize("c", [3, 8])
def test_block_reference_matches_pallas_interpret(c):
    """The plain version against the TPU kernel itself
    (resample2d_block_pallas, interpret mode), batched over every flow
    kind, at (8, 128) blocks: within 1e-5 of the largest |src|."""
    src, flow = _inputs(("tpu", (40, 136), c, "float32"), seed=c)
    want = resample2d_block_pallas(jnp.asarray(src), jnp.asarray(flow), interpret=True)
    got = resample2d_block(_port(src), _port(flow))
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), rtol=0,
                               atol=1e-5 * float(np.abs(src).max()))


@pytest.mark.parametrize("name", list(PARAMS))
def test_block_warp_is_not_the_exact_warp(name):
    """On the noise and past-max_flow flows the block warp differs from the
    exact warp by more than 0.1 somewhere, and equals it on zero and
    constant flow."""
    block, residual, max_flow = PARAMS[name]
    src, flow = _inputs((name, (40, 136), 3, "float32"))
    got = resample2d_block(_port(src), _port(flow), block, residual, max_flow)
    exact = resample2d_reference(_port(src), _port(flow))
    gap = (got - exact).abs().amax((1, 2, 3))
    assert gap[0] > 0.1 and gap[1] > 0.1, gap
    assert gap[3] <= 1e-6 and gap[4] <= 1e-6, gap
    assert _leaves_window(_port(flow[:2]), block, residual, max_flow)


def _staged_tile(ws, length, win, size, piece):
    """The window tile that the block kernel's staged path
    (kernels/resample2d.cu, `resample_block_staged`) copies into shared
    memory, along one axis of `size` pixels, for blocks of `length` pixels
    with window start `ws`: (origin, extent). The origin is clamp(ws, 0,
    size − span), span = min(length + win, size), rounded down to the
    16-byte `piece` (1 element for rows, 4 float32 or 8 bfloat16 for
    columns); the extent covers span pixels from any such origin. The
    kernel stages only (8, 128) blocks at residual 4 on an image at least a
    tile large (span = length + win); the rule is held here in general."""
    span = min(length + win, size)
    origin = torch.clamp(ws, 0, size - span)
    origin = origin - origin % piece
    return origin, (span + 2 * piece - 2) // piece * piece if piece > 1 else span


@settings(max_examples=80, deadline=None)
@given(data=st.data())
def test_staged_tile_holds_every_clamped_tap(data):
    """The block kernel's staged path copies each block's window tile
    (_staged_tile) into shared memory and reads every tap from there: for
    every pixel, the clamped rows and columns of its four taps (block_taps,
    the plain version's index arithmetic) lie inside its block's tile, whose
    column origin is a multiple of the 16-byte piece. Over image and block
    shapes (ragged blocks, images smaller than a tile), residuals, max_flows,
    pieces of 4 and 8 elements (float32, bfloat16; the width then a
    multiple of the piece) and flows from zero to far past the image."""
    align = data.draw(st.sampled_from([4, 8]), label="piece")
    by, bx = data.draw(st.integers(1, 16), label="by"), data.draw(st.integers(1, 64), label="bx")
    h = data.draw(st.integers(1, 48), label="h")
    w = -(-data.draw(st.integers(1, 48), label="w") // align) * align
    r, lf = data.draw(st.integers(0, 6), label="residual"), data.draw(st.integers(0, 80), label="lf")
    scale = data.draw(st.sampled_from([0.0, 0.5, 5.0, 40.0, 500.0]), label="flow scale")
    rng = np.random.default_rng(data.draw(st.integers(0, 2**32 - 1), label="seed"))
    flow = torch.from_numpy(rng.uniform(-scale, scale, (2, 2, h, w)).astype(np.float32))
    ws_y, ws_x, _, _, y0, x0 = block_taps(flow, (by, bx), r, lf)
    win = 2 * r + 2
    for ws, length, size, piece, tap in ((ws_y, by, h, 1, y0), (ws_x, bx, w, align, x0)):
        origin, extent = _staged_tile(ws, length, win, size, piece)
        assert (origin >= 0).all() and (origin % piece == 0).all()
        for d in (0, 1):
            t = (tap + d).clamp(0, size - 1)
            assert (t >= origin).all() and (t < origin + extent).all()


def test_warp_names_the_two_warps():
    src, flow = _inputs(("tpu", (29, 37), 3, "float32"))
    s, f = _port(src), _port(flow)
    torch.testing.assert_close(warp(s, f, "block"), resample2d_block(s, f), rtol=0, atol=0)
    torch.testing.assert_close(warp(s, f, "gather"), resample2d_reference(s, f), rtol=0, atol=0)
    with pytest.raises(ValueError, match="warp_impl"):
        warp(s, f, "nearest")


@pytest.mark.parametrize("stride", [1, 2])
def test_warp_masks_coarse_block_matches_jax(stride):
    """The merge's mask warp at "block": K = 3 masks as the channels of one
    warp, by a rough flow that leaves the window, port against JAX (jitted,
    as the merge runs it): within 1e-5."""
    rng = np.random.default_rng(3 + stride)
    h, w = 40, 136
    masks = (rng.uniform(size=(3, h, w)) > 0.6).astype(np.float32)
    flow = (rng.uniform(-12, 12, (h, w, 2)) + [9.0, -6.0]).astype(np.float32)
    want = jax.jit(lambda m, f: jax_warp_masks_coarse(m, f, stride, "block"))(
        jnp.asarray(masks), jnp.asarray(flow))
    got = warp_masks_coarse(torch.from_numpy(masks), _port(flow[None])[0], stride, "block")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)
    exact = warp_masks_coarse(torch.from_numpy(masks), _port(flow[None])[0], stride, "gather")
    assert float((got - exact).abs().max()) > 1e-2


def _flax_default(rng, path, leaf):
    """A draw from flax's default initializers, in numpy: kernels lecun
    normal (cut at 2 σ), biases and BN means 0, BN scales and variances 1."""
    name = path[-1].key
    if name == "kernel":
        std = np.float32(1.0 / np.sqrt(np.prod(leaf.shape[:-1])))
        return np.clip(rng.standard_normal(leaf.shape, np.float32), -2, 2) * std
    return (np.ones if name in ("scale", "var") else np.zeros)(leaf.shape, leaf.dtype)


@pytest.fixture(scope="module")
def bridged_block():
    """The tiny configuration of tests/test_torch_pipeline.py with the block
    warp in FlowNet2 and the merge, on both sides, the same weights bridged.
    The weights are drawn in numpy on the flax tree of the port's nets
    (bridge.flax_tree, JAX's init_params tree): FlowNet2's 150 M parameters
    take JAX's init half a minute to compile and draw on the CPU."""
    tm = tr.build_models(TCFG_B, device="cpu")
    rng = np.random.default_rng(0)
    jp = {name: jax.tree_util.tree_map_with_path(lambda p, x: _flax_default(rng, p, x),
                                                 flax_tree(getattr(tm, name)))
          for name in ("maskrcnn", "refine", "flow", "reid")}
    params_from_jax(tm, jp)
    return jr.build_models(JCFG_B), jp, tm


def test_flownet2_block_matches_jax(bridged_block):
    """FlowNet2's four in-net warps at "block", on its random weights' rough
    flow: within 1e-4 of the largest |flow|; the same nets with the exact
    warp give another flow."""
    jm, jp, tm = bridged_block
    assert tm.flow.warp_impl == "block"
    rng = np.random.default_rng(2)
    x1 = rng.uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)
    x2 = rng.uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)
    want = np.asarray(jax.jit(jm.flow.apply)(jp["flow"], x1, x2))
    with torch.no_grad():
        got = tm.flow(_nchw(x1), _nchw(x2))
        exact = tr.with_flow_warp(tm, "gather").flow(_nchw(x1), _nchw(x2))
    _close(got.permute(0, 2, 3, 1), want)
    assert tm.flow.warp_impl == "block"  # with_flow_warp left the model as it was
    gap = float((got - exact).abs().max())
    assert gap > 1e-2 * float(np.abs(want).max()), gap


def test_run_sequence_block_matches_jax(bridged_block):
    """run_sequence at "block" on both sides: ≥ 99 % of label pixels agree,
    frame 0 exactly; the flows the merge warps leave the (8, 128) window."""
    jm, jp, tm = bridged_block
    frames, gt = _video()
    want = np.asarray(jr.run_sequence(jm, jp, JCFG_B, jnp.asarray(frames), jnp.asarray(gt), 2))
    got = tr.run_sequence(tm, TCFG_B, frames, gt, 2, device="cpu").numpy()
    np.testing.assert_array_equal(got[0], want[0])
    assert (got == want).mean() >= 0.99
    with torch.no_grad():
        flow = run_flow_pairs(tm.flow, torch.from_numpy(frames).float() / 255.0,
                              (TCFG_B.flow.infer_height, TCFG_B.flow.infer_width))
    s = TCFG_B.merge.warp_stride
    coarse = resize_bilinear(flow, (H // s, W // s)) / s  # as warp_masks_coarse
    assert _leaves_window(coarse)


def test_replay_block_matches_jax_exactly():
    """The merge replay at "block" on both sides, on a hand-made precompute
    whose flow (noise of ±10 px around a drift) leaves the window: labels
    equal pixel for pixel."""
    pre, gt, k, _ = hand_precompute(1)
    rng = np.random.default_rng(11)
    pre["flow"] = (rng.uniform(-10, 10, pre["flow"].shape) + [3.0, -2.0]).astype(np.float32)
    w = np.float32([1.0, 0.8, 1.2, 0.7, 1.0, 0.3, 0.8, 0.2, 2.0])
    want = np.asarray(jr.merge_labels_from_precomputed(
        {key: jnp.asarray(v) for key, v in pre.items()}, jnp.asarray(gt), jnp.int32(k),
        jnp.asarray(w), warp_stride=1, warp_impl="block"))
    tpre, tgt = port_entry(pre, gt)
    got = tr.merge_labels_from_precomputed(tpre, tgt, k, w, warp_stride=1, warp_impl="block")
    np.testing.assert_array_equal(got.numpy(), want)
    gather = tr.merge_labels_from_precomputed(tpre, tgt, k, w, warp_stride=1, warp_impl="gather")
    assert (gather.numpy() != want).any()
    assert _leaves_window(tpre["flow"])


def test_lucid_patches_leave_the_window_and_match_jax(monkeypatch):
    """lucid_frame with the elastic field on and scaled ×16 on both sides
    (each package's smooth_field), so its patch warp's pixels leave the
    (8, 8) blocks' residual-6 windows: the port's canvas and masks against
    JAX's with tests/test_torch_finetune.py's bounds, and the port's patch
    warp is not the exact warp there."""
    scale = 16.0
    jsf, tsf = jl.smooth_field, tl.smooth_field
    monkeypatch.setattr(jl, "smooth_field", lambda *a, **k: jsf(*a, **k) * scale)
    monkeypatch.setattr(tl, "smooth_field", lambda *a, **k: tsf(*a, **k) * scale)
    calls = []

    def spy(src, flow, block=(8, 128), residual=4, max_flow=64):
        calls.append((src, flow, block, residual, max_flow))
        return resample2d_block(src, flow, block, residual, max_flow)

    monkeypatch.setattr(tl, "resample2d_block", spy)
    h, w, patch = 96, 160, 64
    c = _consts(h, w)
    key = jax.random.PRNGKey(5)
    cj, mj = jl.lucid_frame(key, *_jax_consts(c), patch, elastic_prob=1.0)
    draws = _stack_lucid([_lucid_draws(key, 3, h, w, patch, 1.0)])
    pc = _port_consts(c)
    ct, mt = tl.lucid_frames(draws, *pc, patch)
    assert [call[2:] for call in calls] == [((16, 16), 4, 160), ((8, 8), 6, 64)]
    src, flow = calls[1][:2]
    assert _leaves_window(flow, (8, 8), 6, 64)
    gap = (resample2d_block(src, flow, (8, 8), 6, 64) - resample2d_reference(src, flow)).abs()
    assert float(gap.max()) > 1.0
    ct, mt = ct[0].permute(1, 2, 0).numpy(), mt[0].numpy()
    cj, mj = np.asarray(cj), np.asarray(mj)
    differ = (mt != mj).any(0)
    if differ.any():
        soft = _soft_pastes(draws, pc, patch)[0].numpy()
        assert (np.abs(soft - 0.5) <= 1e-4).any(0)[differ].all()
    assert mt[:2].sum() > 0 and not mt[2].any()
    np.testing.assert_allclose(ct[~differ], cj[~differ], rtol=0, atol=1e-2)
