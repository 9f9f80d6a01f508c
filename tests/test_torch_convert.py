"""The port's checkpoint converters against the JAX package's.

No published checkpoint is in the repository, so each converter reads a
synthetic checkpoint in its source format, written from a port module with
seeded weights (distinct frozen-BN statistics and biases) by inverting the
name tables (`io_compat/_synthetic_checkpoints.py`): a TF dict for the Mask
R-CNN, refinement and ReID nets, a torchvision-named ResNet state dict for
the Mask R-CNN backbone, a flownet2-pytorch state dict for FlowNet2. The
JAX converter and the port's read the same file; the JAX tree, through
`bridge.flax_tensors`, must equal the port's state dict exactly, and the
source module's parameters too. Each converted net then runs forward in
both packages at the tiny configuration, in float64 (within 1e-5 of the
largest value), and the JAX tests' refusals are held in the port.
"""

import copy
import dataclasses
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import premvos_tpu.config as jc
from premvos_tpu.io_compat import convert_flownet as jflownet
from premvos_tpu.io_compat import convert_resnet as jresnet
from premvos_tpu.io_compat import convert_tf as jtf
from premvos_tpu.io_compat.convert_tf_maskrcnn import convert_tf_maskrcnn as jconvert_maskrcnn
from premvos_tpu.io_compat.convert_tf_refine import convert_tf_refine as jconvert_refine
from premvos_tpu.io_compat.convert_tf_reid import convert_tf_reid as jconvert_reid
from premvos_tpu.models.resnet import ResNet as JaxResNet
from premvos_tpu.pipeline import runner as jr
from premvos_tpu_torch import config as tc
from premvos_tpu_torch.bridge import flax_tensors
from premvos_tpu_torch.io_compat import _synthetic_checkpoints as sc
from premvos_tpu_torch.io_compat import convert_flownet, convert_resnet, convert_tf
from premvos_tpu_torch.io_compat.convert_tf_maskrcnn import convert_tf_maskrcnn
from premvos_tpu_torch.io_compat.convert_tf_refine import convert_tf_refine
from premvos_tpu_torch.io_compat.convert_tf_reid import convert_tf_reid
from premvos_tpu_torch.pipeline import runner as tr
from tests._threads import few_threads  # noqa: F401

H, W = 64, 96

JCFG = jc.PremvosConfig(
    proposal=jc.ProposalConfig(
        backbone_depth=26, fpn_channels=32, rpn_pre_nms_topk=32,
        rpn_post_nms_topk=8, detections_per_frame=4,
    ),
    refine=jc.RefineConfig(crop_size=33, backbone_depth=26),
    flow=jc.FlowConfig(variant="flownet2", max_displacement=4, infer_height=64,
                       infer_width=64, warp_impl="gather"),
    reid=jc.ReIDConfig(backbone_depth=26, embedding_dim=8, crop_size=32),
    pipeline=jc.PipelineConfig(image_height=H, image_width=W, max_objects=2,
                               max_proposals=4, dtype="float32", scan_chunk=2),
)
TCFG = tc._from_dict(tc.PremvosConfig, dataclasses.asdict(JCFG))
RA, FPN = TCFG.proposal.roi_align_size, TCFG.proposal.fpn_channels


def _tree(flat: dict) -> dict:
    """{flax path: array} → {"params": nested tree}."""
    tree: dict = {}
    for path, v in flat.items():
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = v
    return {"params": tree}


def _checkpoint(name, src):
    """(JAX converter, port converter, source-format checkpoint, net) of
    one converter; each converter maps (checkpoint, target) → its output."""
    if name == "tf_maskrcnn":
        return (lambda ck, like: jconvert_maskrcnn(ck, like, RA, FPN),
                lambda ck, m: convert_tf_maskrcnn(ck, m, RA, FPN),
                sc.tf_maskrcnn_vars(src.maskrcnn, RA, FPN), "maskrcnn")
    if name == "tf_refine":
        return jconvert_refine, convert_tf_refine, sc.tf_refine_vars(src.refine), "refine"
    if name == "tf_reid":
        return jconvert_reid, convert_tf_reid, sc.tf_reid_vars(src.reid), "reid"
    if name == "resnet":
        return (lambda ck, like: jresnet.convert_resnet_state_dict(ck, like, ("backbone",)),
                lambda ck, m: convert_resnet.convert_resnet_state_dict(ck, m, ("backbone",)),
                sc.torchvision_resnet_state_dict(src.maskrcnn, ("backbone",)), "maskrcnn")
    if name == "flownet2":
        def jconv(ck, like):
            tree, unused = jflownet.convert_flownet2_state_dict(ck, like)
            assert unused == []
            return tree

        def tconv(ck, m):
            state, unused = convert_flownet.convert_flownet2_state_dict(ck, m)
            assert unused == []
            return state

        return jconv, tconv, sc.flownet2_state_dict(src.flow), "flow"
    # convert_tf_dict with only the backbone's rule: the heads keep the
    # target's values.
    ck = {k: v for k, v in sc.tf_reid_vars(src.reid).items() if k.startswith("resnet/")}
    return (
        lambda c, like: jtf.convert_tf_dict(c, jtf.resnet_rules(("backbone",), "resnet"), like,
                                            require=(("backbone",),)),
        lambda c, m: convert_tf.convert_tf_dict(c, convert_tf.resnet_rules(("backbone",), "resnet"),
                                                m, require=(("backbone",),)),
        ck, "reid")


CONVERTERS = ["tf_maskrcnn", "tf_refine", "tf_reid", "resnet", "flownet2", "tf_dict_fallback"]
# The part of each net the checkpoint covers (the rest keeps the target's values).
COVERED = {"resnet": "backbone.", "tf_dict_fallback": "backbone."}


@pytest.fixture(scope="module")
def converted():
    """Each converter's JAX and port outputs on one synthetic checkpoint
    from seeded source nets, into targets holding other seeded values."""
    gen = torch.Generator().manual_seed(5)
    src = tr.init_params(tr.build_models(TCFG, device="cpu"), TCFG, seed=0, device="cpu")
    for name in ("maskrcnn", "refine", "flow", "reid"):
        sc.perturb(getattr(src, name), gen)
    target = tr.init_params(tr.build_models(TCFG, device="cpu"), TCFG, seed=1, device="cpu")
    out = {}
    for name in CONVERTERS:
        jconv, tconv, ck, net = _checkpoint(name, src)
        module = getattr(target, net)
        jtree = jconv(ck, _tree(sc.flax_params(module)))
        out[name] = dict(net=net, jtree=jtree, state=tconv(ck, module),
                         src=getattr(src, net).state_dict(), target=module.state_dict(),
                         want=flax_tensors(module, jax.tree.map(np.asarray, jtree)))
    return out


@pytest.mark.parametrize("name", CONVERTERS)
def test_converter_matches_jax_exactly(converted, name):
    """The port's state dict equals the JAX converter's tree through
    bridge.flax_tensors, and the source net's parameters (the target's
    where the checkpoint does not reach), bit for bit."""
    c = converted[name]
    state = c["state"]
    assert set(state) == set(c["want"]) == set(c["target"])
    prefix = COVERED.get(name, "")
    for key, value in state.items():
        assert value.dtype == torch.float32 and value.device.type == "cpu", key
        assert torch.equal(value, c["want"][key]), key
        expect = c["src"] if key.startswith(prefix) else c["target"]
        assert torch.equal(value, expect[key]), key
    assert any(not k.startswith(prefix) for k in state) == bool(prefix)


def test_flax_paths_are_the_jax_packages():
    """The flax trees the synthetic checkpoints come from are shaped like
    the JAX package's own initial trees, path for path and shape for shape."""
    models = tr.build_models(TCFG, device="cpu")
    shapes = jax.eval_shape(lambda: jr.init_params(jr.build_models(JCFG), JCFG,
                                                   jax.random.PRNGKey(0)))
    for name in ("maskrcnn", "refine", "flow", "reid"):
        want = {tuple(str(k.key) for k in kp)[1:]: tuple(v.shape)
                for kp, v in jax.tree_util.tree_flatten_with_path(shapes[name])[0]}
        got = {p: v.shape for p, v in sc.flax_params(getattr(models, name)).items()}
        assert got == want, name


def _nhwc(x):
    return torch.from_numpy(np.array(x)).permute(0, 3, 1, 2)


def _close(got, want, rel=1e-5):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-6)
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, f"max |diff| {err} > {rel} * {scale}"


def _float64(module):
    """A float64 copy of a port module: parameters and compute dtype."""
    m = copy.deepcopy(module).double()
    for sub in m.modules():
        if isinstance(getattr(sub, "dtype", None), torch.dtype):
            sub.dtype = torch.float64
    return m


@pytest.mark.parametrize("name", ["tf_maskrcnn", "tf_refine", "tf_reid", "resnet", "flownet2"])
def test_converted_net_forwards_like_jax(converted, name):
    """Each converted net, loaded into a fresh port module, against the JAX
    net on the JAX converter's tree, both in float64 (float32 convolutions
    reassociate differently in XLA and PyTorch: 3e-5 of the largest value
    through FlowNet2 and the Mask R-CNN heads at these weights): within
    1e-5 of the largest value."""
    c = converted[name]
    tm = tr.build_models(TCFG, device="cpu")
    module = getattr(tm, c["net"])
    module.load_state_dict(c["state"], strict=True)
    module = _float64(module)
    rng = np.random.default_rng(3)
    with jax.enable_x64(True):
        jm = jr.build_models(JCFG, dtype=jnp.float64)
        tree = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), c["jtree"])
        with torch.no_grad():
            if name == "tf_maskrcnn":
                img = rng.standard_normal((2, H, W, 3))
                anchors = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), jr.get_anchors(JCFG))
                want = jax.jit(jm.maskrcnn.apply)(tree, img, anchors)
                got = module(_nhwc(img), {k: v.double() for k, v in
                                          tr.get_anchors(TCFG, "cpu").items()})
                np.testing.assert_array_equal(got["valid"].numpy(), np.asarray(want["valid"]))
                for k in ("boxes", "scores", "mask_logits"):
                    _close(got[k], want[k])
            elif name == "resnet":
                x = rng.standard_normal((2, H, W, 3))
                want = jax.jit(JaxResNet(depth=26, dtype=jnp.float64).apply)(
                    {"params": tree["params"]["backbone"]}, x)
                got = module.backbone(_nhwc(x))
                for k in ("C2", "C3", "C4", "C5"):
                    _close(got[k].permute(0, 2, 3, 1), want[k])
            elif name == "tf_refine":
                x = rng.standard_normal((2, 33, 33, 4))
                _close(module(_nhwc(x)), jax.jit(jm.refine.apply)(tree, x))
            elif name == "tf_reid":
                x = rng.standard_normal((3, 32, 32, 3))
                _close(module(_nhwc(x)), jax.jit(jm.reid.apply)(tree, x))
            else:
                x1 = rng.uniform(0, 1, (2, 64, 64, 3))
                x2 = rng.uniform(0, 1, (2, 64, 64, 3))
                want = jax.jit(jm.flow.apply)(tree, x1, x2)
                _close(module(_nhwc(x1), _nhwc(x2)).permute(0, 2, 3, 1), want)


def test_fc_row_reorder_roundtrip():
    w = np.random.default_rng(7).standard_normal((7 * 7 * 32, 16)).astype(np.float32)
    np.testing.assert_array_equal(
        convert_tf.fc_nchw_to_nhwc(convert_tf.fc_nhwc_to_nchw(w, 7, 32), 7, 32), w)
    np.testing.assert_array_equal(convert_tf.fc_nchw_to_nhwc(w, 7, 32),
                                  jtf.fc_nchw_to_nhwc(w, 7, 32))


def _reid_targets():
    from premvos_tpu.models.reid import ReIDNet as JaxReID
    from premvos_tpu_torch.models.reid import ReIDNet

    like = jax.eval_shape(lambda: JaxReID(cfg=JCFG.reid).init(jax.random.PRNGKey(0),
                                                              jnp.zeros((1, 32, 32, 3))))
    return like, ReIDNet(TCFG.reid)


def _flow_targets():
    from premvos_tpu.models import FlowNet2 as JaxFlowNet2
    from premvos_tpu_torch.models.flownet import FlowNet2

    x = jnp.zeros((1, 64, 64, 3))
    like = jax.eval_shape(JaxFlowNet2(variant="flownetc", max_displacement=4).init,
                          jax.random.PRNGKey(0), x, x)
    return like, FlowNet2(variant="flownetc", max_displacement=4)


def _fc1_rule(name):
    return (("fc1", "kernel"), "none") if name == "fc1/W" else None


# The JAX tests' refusals (test_convert_tf.py:217 and :230,
# test_convert_flownet.py:128) and their neighbours: (targets, JAX call,
# port call, message).
REFUSALS = {
    "tf_shape_mismatch": (
        _reid_targets,
        lambda like: jtf.convert_tf_dict({"fc1/W": np.zeros((3, 3), np.float32)}, _fc1_rule, like),
        lambda m: convert_tf.convert_tf_dict({"fc1/W": np.zeros((3, 3), np.float32)}, _fc1_rule, m),
        "shape"),
    "tf_missing_required": (
        _reid_targets,
        lambda like: jconvert_reid({"fc1/W": np.zeros((2048, 1024), np.float32)}, like),
        lambda m: convert_tf_reid({"fc1/W": np.zeros((2048, 1024), np.float32)}, m),
        "missing"),
    "tf_no_such_param": (
        _reid_targets,
        lambda like: jtf.convert_tf_dict({"x": np.zeros(3)}, lambda n: (("fc9", "kernel"), "none"),
                                         like),
        lambda m: convert_tf.convert_tf_dict({"x": np.zeros(3)},
                                             lambda n: (("fc9", "kernel"), "none"), m),
        "no such param"),
    "flownet_partial": (
        _flow_targets,
        lambda like: jflownet.convert_flownet2_state_dict(
            {"flownetc.conv1.0.weight": torch.zeros(64, 3, 7, 7)}, like),
        lambda m: convert_flownet.convert_flownet2_state_dict(
            {"flownetc.conv1.0.weight": torch.zeros(64, 3, 7, 7)}, m),
        "missing"),
    "flownet_shape_mismatch": (
        _flow_targets,
        lambda like: jflownet.convert_flownet2_state_dict(
            {"flownetc.conv1.0.weight": torch.zeros(64, 3, 5, 5)}, like),
        lambda m: convert_flownet.convert_flownet2_state_dict(
            {"flownetc.conv1.0.weight": torch.zeros(64, 3, 5, 5)}, m),
        "shape"),
    "flownet_missing": (
        _flow_targets,
        lambda like: jflownet.convert_flownet2_state_dict({}, like),
        lambda m: convert_flownet.convert_flownet2_state_dict({}, m),
        "missing"),
    "resnet_missing": (
        _reid_targets,
        lambda like: jresnet.convert_resnet_state_dict(
            {"conv1.weight": torch.zeros(64, 3, 7, 7)}, like, ("backbone",)),
        lambda m: convert_resnet.convert_resnet_state_dict(
            {"conv1.weight": torch.zeros(64, 3, 7, 7)}, m, ("backbone",)),
        "missing"),
    "resnet_shape_mismatch": (
        _reid_targets,
        lambda like: jresnet.convert_resnet_state_dict(
            {"conv1.weight": torch.zeros(64, 3, 3, 3)}, like, ("backbone",)),
        lambda m: convert_resnet.convert_resnet_state_dict(
            {"conv1.weight": torch.zeros(64, 3, 3, 3)}, m, ("backbone",)),
        "shape"),
}


@pytest.mark.parametrize("case", list(REFUSALS))
def test_converter_refusals_match_jax(case):
    """Each refusal raises ValueError in both packages on the same input,
    with the same word in the message."""
    targets, jcall, tcall, match = REFUSALS[case]
    like, module = targets()
    with pytest.raises(ValueError, match=match):
        jcall(like)
    with pytest.raises(ValueError, match=match):
        tcall(module)


def test_load_tf_checkpoint_vars(tmp_path):
    """.npz and pickled re-exports load as {name: array}; a native TF
    checkpoint path raises, saying TensorFlow is needed."""
    vars_ = {"conv0/W": np.arange(6, dtype=np.float32).reshape(2, 3), "global_step": np.int64(3)}
    np.savez(tmp_path / "ck.npz", **vars_)
    with open(tmp_path / "ck.pkl", "wb") as f:
        pickle.dump(vars_, f)
    for path in (tmp_path / "ck.npz", tmp_path / "ck.pkl"):
        got = convert_tf.load_tf_checkpoint_vars(str(path))
        assert set(got) == set(vars_)
        for k in vars_:
            np.testing.assert_array_equal(got[k], vars_[k])
    with pytest.raises(ValueError, match="TensorFlow"):
        convert_tf.load_tf_checkpoint_vars(str(tmp_path / "model.ckpt-1000"))
