"""GroupNorm32 and Xception-65 in the port vs the JAX package, on the CPU.

The same seeded numpy inputs go through the JAX module and the port's, the
port on the JAX parameters bridged (bridge.flax_tensors), with every
GroupNorm scale and bias drawn away from 1 and 0 so that a swapped mapping
shows. Everything is float32.

Tolerances: GroupNorm32 alone 1e-5 of the output's largest |value| at a
zero-mean input; at an offset of 100 the fast variance E[x²] − E[x]²
cancels in float32 (both packages use that formula, and only the order of
their sums differs), and the port is held within twice flax's own distance
from the formula's float64 value. Each net's float32 forward 1e-5 of the
largest |value| of the JAX forward (run in float64); in float64 on both
sides (see `_parity`), the loss, the mean square of the output weighted by
fixed random numbers, 1e-5 relative; each
parameter's gradient 1e-4 of that parameter's largest |grad| (convolutions
and their gradients reassociate float32 sums between XLA and PyTorch), or
of 1e-6 of the net's largest |grad| where the parameter's own is smaller
(a gradient that is rounding noise).
Xception-65's depth and widths are fixed, so its JAX side is built and
differentiated once per crop size, in a module-scoped fixture.
"""

import copy
import dataclasses

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import premvos_tpu.config as jc
from premvos_tpu.models.deeplab import DeepLabV3Plus as JaxDeepLab
from premvos_tpu.models.maskrcnn import MaskRCNN as JaxMaskRCNN
from premvos_tpu.models.reid import ReIDNet as JaxReID
from premvos_tpu.models.resnet import GroupNorm32 as JaxGroupNorm32
from premvos_tpu_torch import config as tc
from premvos_tpu_torch.bridge import flax_tensors, load_flax_tree
from premvos_tpu_torch.models.deeplab import DeepLabV3Plus
from premvos_tpu_torch.models.layers import GroupNorm32, make_norm
from premvos_tpu_torch.models.maskrcnn import MaskRCNN
from premvos_tpu_torch.models.reid import ReIDNet
from premvos_tpu_torch.models.resnet import ResNet
from premvos_tpu_torch.models.xception import Xception65, same_pads
from tests._threads import few_threads  # noqa: F401


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _near(got, want, rel, what, floor=0.0):
    """max |got − want| ≤ rel · max(max |want|, floor)."""
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), floor, 1e-12)
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, f"{what}: max |diff| {err} > {rel} * {scale}"


def _draw_params(jm, x, seed, **kw):
    """A parameter tree of `jm`'s shapes from a seeded numpy generator
    (flax's init traced for its shapes only: jitting it costs more than
    the test): kernels normal / sqrt(fan-in), biases and GroupNorm
    parameters about 0 and 1, frozen-BN variances positive."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jnp.asarray(x), **kw))

    def draw(path, s):
        name = path[-1].key
        v = rng.standard_normal(s.shape).astype(np.float32)
        if name == "kernel":
            return v / np.sqrt(np.prod(s.shape[:-1]))
        if name in ("scale", "var"):
            return 1.0 + 0.3 * np.abs(v) if name == "var" else 1.0 + 0.3 * v
        return 0.3 * v

    return jax.tree_util.tree_map_with_path(draw, shapes)


# ------------------------------------------------------------ GroupNorm32


def _fast_variance_exact(x, groups, scale, bias):
    """flax's GroupNorm formula evaluated in float64: what both float32
    implementations round."""
    n, h, w, c = x.shape
    xd = x.astype(np.float64).reshape(n, h, w, groups, c // groups)
    mu = xd.mean((1, 2, 4), keepdims=True)
    var = np.maximum((xd * xd).mean((1, 2, 4), keepdims=True) - mu * mu, 0.0)
    y = ((xd - mu) / np.sqrt(var + 1e-6)).reshape(x.shape)
    return y * scale.astype(np.float64) + bias.astype(np.float64)


@pytest.mark.parametrize("offset", [0.0, 100.0], ids=["zero_mean", "mean_100"])
@pytest.mark.parametrize("c", [64, 24, 56, 7])
def test_group_norm32_matches_flax(c, offset):
    """Groups: the largest divisor of C ≤ 32 (32, 24, 28, 7). At zero mean
    the port is within 1e-5 of flax. At a mean of 100 the fast variance
    cancels about 1e4 against 1 in float32, so any two summation orders
    differ by about 1e-3 of the output (flax itself is that far from the
    formula's exact value): there the port's distance from the exact
    value must stay within twice flax's own."""
    rng = np.random.default_rng(c)
    x = (offset + rng.standard_normal((2, 5, 6, c))).astype(np.float32)
    jm = JaxGroupNorm32()
    params = _draw_params(jm, x, c)
    want = np.asarray(jm.apply(params, jnp.asarray(x)))
    m = GroupNorm32(c)
    assert m.groups == {64: 32, 24: 24, 56: 28, 7: 7}[c]
    load_flax_tree(m, jax.tree.map(np.asarray, params))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    got = _np(m(xt).permute(0, 2, 3, 1))
    # the same values from a channels-last tensor
    got_cl = m(xt.contiguous(memory_format=torch.channels_last)).permute(0, 2, 3, 1)
    np.testing.assert_array_equal(_np(got_cl), got)
    if not offset:
        _near(got, want, 1e-5, f"C={c}")
        return
    gn = params["params"]["gn"]
    exact = _fast_variance_exact(x, m.groups, np.asarray(gn["scale"]), np.asarray(gn["bias"]))
    flax_err = float(np.abs(want - exact).max())
    port_err = float(np.abs(got - exact).max())
    assert 1e-4 < flax_err < 0.05, flax_err  # the cancellation this case is about
    assert port_err <= 2 * flax_err, (port_err, flax_err)


def test_group_norm32_keeps_the_compute_dtype_and_resets():
    m = GroupNorm32(64, torch.bfloat16)
    with torch.no_grad():
        m.weight.fill_(3.0)
        m.bias.fill_(2.0)
    m.reset_parameters(torch.Generator().manual_seed(0))
    assert torch.equal(m.weight, torch.ones(64)) and torch.equal(m.bias, torch.zeros(64))
    y = m(torch.randn(1, 64, 3, 3, dtype=torch.bfloat16))
    assert y.dtype == torch.bfloat16 and m.weight.dtype == torch.float32
    assert [make_norm(n, 8)[0] for n in ("frozen_bn", "group_norm")] == [
        "FrozenBatchNorm", "GroupNorm32"]
    with pytest.raises(ValueError, match="unknown norm"):
        make_norm("batch_norm", 8)


# ------------------------------------------- the three nets with group_norm


def _proposal_cfg(mod):
    return mod.ProposalConfig(backbone_depth=26, fpn_channels=32, rpn_pre_nms_topk=64,
                              rpn_post_nms_topk=16, detections_per_frame=8, norm="group_norm")


def _features(m, x):
    return m.features(x)


def _case(name):
    """(JAX module, its init/apply method, port module, port call, NHWC
    input)."""
    rng = np.random.default_rng(7)
    if name == "maskrcnn":
        x = rng.standard_normal((2, 64, 64, 3)).astype(np.float32)
        return (JaxMaskRCNN(cfg=_proposal_cfg(jc)), JaxMaskRCNN.features,
                MaskRCNN(_proposal_cfg(tc)), _features, x)
    if name == "refine":
        x = rng.standard_normal((2, 33, 33, 4)).astype(np.float32)
        kw = dict(crop_size=33, backbone_depth=26, box_margin=12.0, norm="group_norm")
        return (JaxDeepLab(cfg=jc.RefineConfig(**kw)), None,
                DeepLabV3Plus(tc.RefineConfig(**kw)), torch.nn.Module.__call__, x)
    x = rng.standard_normal((4, 32, 32, 3)).astype(np.float32)
    kw = dict(backbone_depth=26, embedding_dim=8, crop_size=32, norm="group_norm")
    return (JaxReID(cfg=jc.ReIDConfig(**kw)), None, ReIDNet(tc.ReIDConfig(**kw)),
            torch.nn.Module.__call__, x)


def _flat(out):
    """A net's output as one list of arrays in a fixed order, NHWC for
    feature maps."""
    if isinstance(out, dict):
        return [out[k] for k in sorted(out)]
    return [out]


def _to_nhwc(t):
    return t.permute(0, 2, 3, 1) if t.dim() == 4 else t


def _float64(module):
    """A float64 copy of a port module: parameters and compute dtype."""
    m = copy.deepcopy(module).double()
    for sub in m.modules():
        if isinstance(getattr(sub, "dtype", None), torch.dtype):
            sub.dtype = torch.float64
    return m


def _parity(jm, method, tm, call, x, seed=0):
    """Both sides on the same bridged weights: the port's float32 forward
    against JAX's in float64, and the loss and every gradient in float64 on
    both sides (one compiled JAX function gives all three). (Gradients through ReLU and
    max-pool change by whole terms where a float32 pre-activation lies
    within rounding of zero: at these tiny maps, where a bias gradient sums
    a few positions, one such tie moves it by several %, in either package
    against its own float64. In float64 no value lies that close.)"""
    kw = {} if method is None else {"method": method}
    params = _draw_params(jm, x, seed, **kw)
    shapes = jax.eval_shape(lambda p: jm.apply(p, jnp.asarray(x), **kw), params)
    rng = np.random.default_rng(seed + 2)
    proj = [rng.standard_normal(o.shape) for o in _flat(shapes)]
    with jax.enable_x64(True):
        j64 = jm.clone(dtype=jnp.float64)

        def jloss(p):
            outs = _flat(j64.apply(p, jnp.asarray(x, jnp.float64), **kw))
            return sum(jnp.mean(jnp.square(o * w)) for o, w in zip(outs, proj)), outs

        (jval, outs), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
            jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), params))
        jgrads = jax.tree.map(np.asarray, jgrads)
    # a MaskRCNN's features reach the backbone and FPN only: their tree
    part = _Features if isinstance(tm, MaskRCNN) else (lambda m: m)
    load_flax_tree(part(tm), jax.tree.map(np.asarray, params))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    with torch.no_grad():
        touts = [_to_nhwc(o) for o in _flat(call(tm, xt))]
    t64 = _float64(tm)
    tval = sum((o * torch.from_numpy(w)).square().mean()
               for o, w in zip((_to_nhwc(o) for o in _flat(call(t64, xt.double()))), proj))
    tval.backward()
    holder = part(t64)
    return dict(outs=[np.asarray(o) for o in outs], touts=touts, jval=float(jval),
                tval=float(tval.detach()), jgrads=flax_tensors(holder, jgrads),
                tgrads={n: p.grad for n, p in holder.named_parameters()})


def _check(r, what):
    for i, (got, want) in enumerate(zip(r["touts"], r["outs"])):
        _near(got, want, 1e-5, f"{what} output {i}")
    assert abs(r["tval"] - r["jval"]) <= 1e-5 * abs(r["jval"]), (what, r["tval"], r["jval"])
    assert set(r["tgrads"]) == set(r["jgrads"])
    # A gradient that is zero but for rounding (ASPP's pooled-branch norm at
    # batch 1: 3e-8 against the net's 5) is held against 1e-6 of the net's
    # largest |grad| instead of its own noise.
    floor = 1e-6 * max(float(np.abs(g.numpy()).max()) for g in r["jgrads"].values())
    for name, g in r["tgrads"].items():
        _near(g, r["jgrads"][name], 1e-4, f"{what} grad {name}", floor)


@pytest.mark.parametrize("name", ["maskrcnn", "refine", "reid"])
def test_group_norm_nets_match_jax(name):
    """Mask R-CNN's features (backbone + FPN, where its norms are), the
    DeepLabv3+ logits and the ReID embeddings, with group_norm: the tree's
    GroupNorm32_k/gn leaves land where FrozenBatchNorm_k's would."""
    jm, method, tm, call, x = _case(name)
    names = [n for n, _ in tm.named_modules() if n.rsplit(".", 1)[-1].startswith("GroupNorm32_")]
    assert names and not any("FrozenBatchNorm" in n for n, _ in tm.named_modules())
    _check(_parity(jm, method, tm, call, x), name)


class _Features(torch.nn.Module):
    """Mask R-CNN's backbone and FPN alone, so the features' flax tree
    bridges onto exactly the layers it holds."""

    def __init__(self, m):
        super().__init__()
        self.backbone, self.fpn = m.backbone, m.fpn


def test_reid_net_builds_with_group_norm_and_bridges():
    """ReIDNet(group_norm) at the default depth: 53 GroupNorm32 layers, the
    same ones by name as the JAX tree's."""
    cfg = dict(backbone_depth=50, embedding_dim=8, crop_size=32, norm="group_norm")
    tm = ReIDNet(tc.ReIDConfig(**cfg))
    jm = JaxReID(cfg=jc.ReIDConfig(**cfg))
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3))))
    tree = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes)
    got = flax_tensors(tm, tree)
    gn = [n for n in got if ".GroupNorm32_" in n]
    assert len(gn) == 2 * 53 and all(n.endswith((".weight", ".bias")) for n in gn)
    assert set(got) == set(tm.state_dict())


# ------------------------------------------------------------ Xception-65


def test_same_pads_match_xla():
    """XLA's SAME padding of a 3-tap stride-2 conv: (1, 1) at odd sizes,
    (0, 1) at even ones, as jax.lax reports it."""
    for size in (32, 33, 64, 65, 385, 8, 7):
        want = jax.lax.padtype_to_pads((size,), (3,), (2,), "SAME")[0]
        assert same_pads(size, 3, 2) == tuple(want), size


_XKW = dict(backbone="xception65", crop_size=33, aspp_channels=32, low_level_channels=16,
            decoder_channels=32)


@pytest.fixture(scope="module")
def xception_parity():
    x = np.random.default_rng(33).standard_normal((1, 33, 33, 4)).astype(np.float32)
    jm = JaxDeepLab(cfg=jc.RefineConfig(**{**_XKW, "norm": "group_norm"}))
    tm = DeepLabV3Plus(tc.RefineConfig(**{**_XKW, "norm": "group_norm"}))
    return tm, _parity(jm, None, tm, torch.nn.Module.__call__, x, seed=33)


def test_xception_deeplab_matches_jax(xception_parity):
    """DeepLabv3+ on Xception-65 (group_norm) at an odd crop (33²: the
    stem pads (1, 1)): logits, loss and every gradient. (The even crop's
    (0, 1) padding is test_xception_frozen_bn_features_match_jax's: one
    more compile of the float64 gradient would cost about 30 s.)"""
    tm, r = xception_parity
    assert isinstance(tm.encoder, Xception65) and tm.low_proj.weight.shape[1] == 128
    assert r["touts"][0].shape == (1, 33, 33)
    _check(r, "xception 33")


def test_xception_frozen_bn_features_match_jax():
    """The bare encoder with frozen BN (its default) at output stride 32 on
    an even input (32²: the stem pads (0, 1)): C2 at stride 4 with 128
    channels, C5 at stride 32 with 2048."""
    from premvos_tpu.models.xception import Xception65 as JaxXception

    x = np.random.default_rng(3).standard_normal((1, 32, 32, 3)).astype(np.float32)
    jm = JaxXception(output_stride=32)
    params = _draw_params(jm, x, 5)
    want = jax.jit(jm.apply)(params, jnp.asarray(x))
    tm = Xception65(output_stride=32)
    load_flax_tree(tm, jax.tree.map(np.asarray, params))
    with torch.no_grad():
        got = tm(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert got["C2"].shape == (1, 128, 8, 8) and got["C5"].shape == (1, 2048, 1, 1)
    for k in ("C2", "C5"):
        _near(got[k].permute(0, 2, 3, 1), want[k], 1e-5, k)


def test_resnet_and_xception_refuse_nothing_they_port():
    """The refusals are gone: both norms in the ResNet, both backbones in
    DeepLabv3+, and an unknown norm still raises."""
    for norm in ("frozen_bn", "group_norm"):
        ResNet(depth=26, norm=norm)
        cfg = dataclasses.replace(tc.RefineConfig(backbone_depth=26), norm=norm)
        DeepLabV3Plus(cfg)
        DeepLabV3Plus(dataclasses.replace(cfg, backbone="xception65"))
    with pytest.raises(ValueError, match="unknown norm"):
        ResNet(depth=26, norm="layer_norm")
    with pytest.raises(ValueError, match="output_stride"):
        Xception65(output_stride=8)
