"""The FlowNet variants other than FlowNet2 and the `fast_flownetc` preset
in the port against the JAX package, on the CPU.

`FlowNet2(variant=)` builds "flownetc" (FlowNetC alone, no in-net warp),
"flownet2cs" (C then one FlowNetS: one warp) and "flownet2css" (two
FlowNetS: two warps) in both packages. For each variant, on weights drawn
in numpy (seeded) and bridged:
  - the forward in float64 on both sides (float32 convolutions reassociate
    differently in XLA and PyTorch, tests/test_torch_convert.py), within
    1e-5 of the largest |flow|, at both `warp_impl`s where the variant
    warps; at "block" the JAX package's warp is pinned to the TPU kernel's
    (8, 128) blocks (tests/_jax_block_warp.py), and the same nets with the
    exact warp give another flow;
  - the flownet2-pytorch converter on a state dict of that variant's nets,
    equal to the JAX converter's tree bit for bit;
  - `bridge.params_from_jax` then `bridge.flax_tree`, which give back the
    drawn trees bit for bit, in the JAX package's paths and shapes.

`configs/fast_flownetc.json` departs from davis2017_val in three places
that reach code (FlowNetC-only flow, the merge warp at stride 1, the
crops and pastes at "highest" precision). `run_sequence` on the tiny
configuration of tests/test_torch_pipeline.py with those three departures,
both warps at "block", holds the port's labels against JAX's object by
object over the pixels either side labels (IoU ≥ 0.99 on every object and
frame; ROADMAP, Traps), frame 0 exact.
"""

import dataclasses
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import premvos_tpu.config as jc
from premvos_tpu.io_compat import convert_flownet as jflownet
from premvos_tpu.models import FlowNet2 as JaxFlowNet2
from premvos_tpu.pipeline import runner as jr
from premvos_tpu_torch import config as tc
from premvos_tpu_torch.bridge import flax_tensors, flax_tree, params_from_jax
from premvos_tpu_torch.io_compat import _synthetic_checkpoints as sc
from premvos_tpu_torch.io_compat import convert_flownet
from premvos_tpu_torch.models.flownet import FlowNet2
from premvos_tpu_torch.models.layers import init_module
from premvos_tpu_torch.pipeline import runner as tr
from tests._jax_block_warp import jax_tpu_block_warp  # noqa: F401 (autouse)
from tests._threads import few_threads  # noqa: F401
from tests.test_torch_convert import _close, _float64, _nhwc, _tree
from tests.test_torch_pipeline import JCFG, _video

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "scripts"))
from check_tpu_consistency_torch import object_ious  # noqa: E402

NETS = ("maskrcnn", "refine", "flow", "reid")
# The variants and the FlowNet2 sub-nets each holds.
VARIANTS = {
    "flownetc": ("flownetc",),
    "flownet2cs": ("flownetc", "flownets_1"),
    "flownet2css": ("flownetc", "flownets_1", "flownets_2"),
}
FORWARD_CASES = [("flownetc", "block"), ("flownet2cs", "block"), ("flownet2cs", "gather"),
                 ("flownet2css", "block"), ("flownet2css", "gather")]

PRESET = "configs/fast_flownetc.json"


def _configs(variant, preset=False):
    """tests/test_torch_pipeline.py's tiny configuration at `variant` with
    both warps at "block"; with `preset`, also fast_flownetc.json's merge
    warp stride (1) and crop precision ("highest")."""
    jcfg = dataclasses.replace(
        JCFG, flow=dataclasses.replace(JCFG.flow, variant=variant, warp_impl="block"),
        merge=dataclasses.replace(JCFG.merge, warp_impl="block"))
    if preset:
        jcfg = dataclasses.replace(
            jcfg, merge=dataclasses.replace(jcfg.merge, warp_stride=1),
            refine=dataclasses.replace(jcfg.refine, interp_precision="highest"))
    return jcfg, tc._from_dict(tc.PremvosConfig, dataclasses.asdict(jcfg))


def _draw(rng, path, leaf):
    """Seeded numpy weights on a flax tree: kernels lecun normal (cut at
    2 σ); biases, the batch norms' too, N(0, 0.01²), so that a swapped bias
    would show; batch-norm scales and variances in [0.95, 1.05), means in
    [−0.05, 0.05)."""
    name = path[-1].key
    if name == "kernel":
        std = np.float32(1.0 / np.sqrt(np.prod(leaf.shape[:-1])))
        return np.clip(rng.standard_normal(leaf.shape, np.float32), -2, 2) * std
    if name in ("scale", "var"):
        return rng.uniform(0.95, 1.05, leaf.shape).astype(np.float32)
    if name == "mean":
        return rng.uniform(-0.05, 0.05, leaf.shape).astype(np.float32)
    return (0.01 * rng.standard_normal(leaf.shape)).astype(np.float32)


def _bridged(variant, preset=False, seed=0):
    """The port's four nets at the variant's tiny configuration, their
    weights drawn in numpy on their flax trees and loaded through
    params_from_jax: (port models, the drawn bundle)."""
    _, tcfg = _configs(variant, preset)
    tm = tr.build_models(tcfg, device="cpu")
    rng = np.random.default_rng(seed)
    bundle = {name: jax.tree_util.tree_map_with_path(lambda p, x: _draw(rng, p, x),
                                                     flax_tree(getattr(tm, name)))
              for name in NETS}
    params_from_jax(tm, bundle)
    return tm, bundle


@pytest.fixture(scope="module")
def bridged():
    """Each variant's bridged nets; "flownetc" at the preset's departures
    (they change no net)."""
    return {v: _bridged(v, preset=v == "flownetc") for v in VARIANTS}


@pytest.mark.parametrize("variant,impl", FORWARD_CASES, ids=[f"{v}-{i}" for v, i in FORWARD_CASES])
def test_variant_forward_matches_jax(bridged, variant, impl):
    """The variant's forward, its nets in float64 on both sides (each
    package hands the flow on in float32 between them), at `impl`: within
    1e-5 of the largest |flow|. At "block" the exact warp gives another
    flow (the random weights' flow leaves the (8, 128) window)."""
    tm, bundle = bridged[variant]
    module = _float64(tm.flow)
    module.warp_impl = impl
    rng = np.random.default_rng(3)
    x1 = rng.uniform(0, 1, (2, 64, 64, 3))
    x2 = rng.uniform(0, 1, (2, 64, 64, 3))
    with jax.enable_x64(True):
        jm = JaxFlowNet2(variant=variant, max_displacement=4, dtype=jnp.float64, warp_impl=impl)
        tree = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), bundle["flow"])
        want = np.asarray(jax.jit(jm.apply)(tree, x1, x2))
    with torch.no_grad():
        got = module(_nhwc(x1), _nhwc(x2)).permute(0, 2, 3, 1)
        if impl == "block" and variant != "flownetc":
            module.warp_impl = "gather"
            exact = module(_nhwc(x1), _nhwc(x2)).permute(0, 2, 3, 1)
            gap = float((got - exact).abs().max())
            assert gap > 1e-2 * float(np.abs(want).max()), gap
    _close(got, want)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_variant_converter_matches_jax_exactly(bridged, variant):
    """A flownet2-pytorch state dict of the variant's nets (the seeded
    draws, in nn.Sequential wrappers where flownet2-pytorch has them),
    converted by both packages into a target holding other weights: the
    port's state dict equals the JAX tree through bridge.flax_tensors and
    the source weights, bit for bit, and no key is left over."""
    src = bridged[variant][0].flow
    ck = sc.flownet2_state_dict(src)
    assert {k.split(".")[0] for k in ck} == set(VARIANTS[variant])
    target = FlowNet2(variant=variant, max_displacement=4)
    init_module(target, torch.Generator().manual_seed(1))
    jtree, junused = jflownet.convert_flownet2_state_dict(ck, _tree(sc.flax_params(target)))
    state, unused = convert_flownet.convert_flownet2_state_dict(ck, target)
    assert junused == [] and unused == []
    want = flax_tensors(target, jax.tree.map(np.asarray, jtree))
    assert set(state) == set(want) == set(target.state_dict())
    source = src.state_dict()
    for key, value in state.items():
        assert value.dtype == torch.float32, key
        assert torch.equal(value, want[key]), key
        assert torch.equal(value, source[key]), key


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_variant_bridge_round_trips(bridged, variant):
    """params_from_jax took the drawn bundle; flax_tree gives it back bit
    for bit, in the paths and shapes of the JAX package's own init_params
    at the variant's configuration."""
    tm, bundle = bridged[variant]
    jcfg, _ = _configs(variant, preset=variant == "flownetc")
    shapes = jax.eval_shape(lambda: jr.init_params(jr.build_models(jcfg), jcfg,
                                                   jax.random.PRNGKey(0)))
    for name in NETS:
        got = jax.tree_util.tree_flatten_with_path(flax_tree(getattr(tm, name)))[0]
        want = dict(jax.tree_util.tree_flatten_with_path(bundle[name])[0])
        assert [p for p, _ in got] == list(want)
        for path, value in got:
            assert value.dtype == want[path].dtype and np.array_equal(value, want[path]), path
        jshape = {p: tuple(v.shape) for p, v in
                  jax.tree_util.tree_flatten_with_path(shapes[name])[0]}
        assert {p: v.shape for p, v in got} == jshape, name
    flow_nets = {k for k in bundle["flow"]["params"]}
    assert flow_nets == set(VARIANTS[variant])


def test_fast_flownetc_preset_loads_as_jax():
    """The preset file gives the same dataclass values in both packages,
    and its departures are the three the tiny run below applies."""
    got, want = tc.load_config(PRESET), jc.load_config(PRESET)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.flow.variant == "flownetc" and (got.flow.infer_height, got.flow.infer_width) == (
        448, 832)
    assert got.merge.warp_stride == 1 and got.refine.interp_precision == "highest"
    assert got.pipeline.dtype == "bfloat16"


def test_run_sequence_fast_flownetc_matches_jax(bridged):
    """run_sequence at the preset's departures on the tiny configuration,
    the same bridged weights on both sides: frame 0 exact, pixels labelled
    after frame 0 on both sides, and every object's IoU ≥ 0.99 on every
    frame."""
    tm, bundle = bridged["flownetc"]
    jcfg, tcfg = _configs("flownetc", preset=True)
    frames, gt = _video()
    want = np.asarray(jr.run_sequence(jr.build_models(jcfg), bundle, jcfg, jnp.asarray(frames),
                                      jnp.asarray(gt), 2))
    got = tr.run_sequence(tm, tcfg, frames, gt, 2, device="cpu").numpy()
    assert got.shape == want.shape == (len(frames), *gt.shape[1:])
    np.testing.assert_array_equal(got[0], want[0])
    assert (got[1:] > 0).any() and (want[1:] > 0).any()
    ious = object_ious(got, want, 2)
    assert {row[0] for row in ious} == set(range(len(frames)))
    low = [row for row in ious if row[2] < 0.99]
    assert not low, low
