"""The port's trainers and host-pool fine-tune over a mesh, through the
entry points a user calls (`train_maskrcnn`, `train_refine`,
`train_flownet_c`, `finetune_video` with method "pool", each with
`mesh=`), on two gloo ranks of the CPU against the JAX package's at
`make_mesh(2)` (tests/conftest.py gives JAX 8 virtual CPU devices).

Each side draws its global batch from the same numpy seed in the JAX
order, shards it over the two ranks and averages the loss over them, so
what is compared is the drawing, the sharding and the averaging of each
trainer; one command line is also started under the process group. The
port's ranks run in ONE spawn (tests/_parallel_ranks.py, which imports no
JAX).

Bounds: a trainer's one-step loss (the loss of the step's batch, before
its update) 1e-5 relative (tests/test_torch_train.py's); the pool
fine-tune's two losses after 2 steps 1e-4 relative
(tests/test_torch_pool_finetune.py's, the port fed the JAX package's
pool-step draws). Across ranks, the weights after the steps are equal bit
for bit.
"""

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import premvos_tpu.config as jc
from premvos_tpu.data import flow_pairs as jpairs
from premvos_tpu.data.davis import DavisDataset as JaxDavis
from premvos_tpu.finetune import finetune as jft
from premvos_tpu.finetune import fused as jfused
from premvos_tpu.models.anchors import pyramid_anchors as jax_pyramid_anchors
from premvos_tpu.models.deeplab import DeepLabV3Plus as JaxDeepLab
from premvos_tpu.models.flownet import FlowNetC as JaxFlowNetC
from premvos_tpu.models.maskrcnn import MaskRCNN as JaxMaskRCNN
from premvos_tpu.parallel import mesh as jmesh
from premvos_tpu.train import train_flow as jtf
from premvos_tpu.train import train_maskrcnn as jtm
from premvos_tpu.train import train_refine as jtr
from premvos_tpu_torch import config as tc
from premvos_tpu_torch.bridge import load_flax_tree
from premvos_tpu_torch.data.davis import make_synthetic_davis
from premvos_tpu_torch.models.deeplab import DeepLabV3Plus
from premvos_tpu_torch.models.flownet import FlowNetC
from premvos_tpu_torch.models.maskrcnn import MaskRCNN
from premvos_tpu_torch.parallel import dryrun
from tests import _parallel_ranks
from tests.test_torch_parallel import few_threads  # noqa: F401 (the module's fixture)
from tests.test_torch_pool_finetune import (  # noqa: F401 (jax_nets: the module's fixture)
    JCFG,
    TCFG,
    _frame_and_labels,
    _jax_draws,
    jax_nets,
)

HW = (64, 64)
MD = 4
JTINY = jc.ProposalConfig(backbone_depth=26, fpn_channels=32, rpn_pre_nms_topk=64,
                          rpn_post_nms_topk=16, detections_per_frame=8)
TTINY = tc.ProposalConfig(backbone_depth=26, fpn_channels=32, rpn_pre_nms_topk=64,
                          rpn_post_nms_topk=16, detections_per_frame=8)
JREFINE = jc.RefineConfig(crop_size=33, backbone_depth=26, box_margin=12.0)
TREFINE = tc.RefineConfig(crop_size=33, backbone_depth=26, box_margin=12.0)


def _np_tree(tree):
    return jax.tree.map(np.asarray, flax.core.unfreeze(tree))


def _state_dict(module):
    return {k: v.clone() for k, v in module.state_dict().items()}


def _maskrcnn_case(root):
    """The tiny Mask R-CNN (its RPN delta head zeroed, as in
    tests/test_torch_train.py: the proposals are the clipped anchors on
    both sides) and JAX's train_maskrcnn loss of one step at batch 2."""
    jm = JaxMaskRCNN(cfg=JTINY)
    anchors = {k: jnp.asarray(v) for k, v in jax_pyramid_anchors(
        *HW, JTINY.anchor_scales, JTINY.anchor_ratios).items()}
    params = flax.core.unfreeze(jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.zeros((1, *HW, 3)),
                                                 anchors))
    params["params"]["rpn"]["Conv_2"] = jax.tree.map(jnp.zeros_like,
                                                     params["params"]["rpn"]["Conv_2"])
    _, jloss = jtm.train_maskrcnn(JaxDavis(root), JTINY, HW, max_objects=2, steps=1,
                                  batch_size=2, seed=0, mesh=jmesh.make_mesh(2), params=params,
                                  log_every=0)
    tm = MaskRCNN(TTINY)
    load_flax_tree(tm, _np_tree(params))
    return dict(state_dict=_state_dict(tm), jloss=jloss)


def _refine_case(root):
    jm = JaxDeepLab(cfg=JREFINE)
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.zeros((1, 33, 33, 4)))
    _, jloss = jtr.train_refine(JaxDavis(root, split="val"), JREFINE, steps=1, batch_size=4,
                                seed=0, mesh=jmesh.make_mesh(2), params=params, image_hw=HW,
                                log_every=0)
    tm = DeepLabV3Plus(TREFINE)
    load_flax_tree(tm, _np_tree(params))
    return dict(state_dict=_state_dict(tm), jloss=jloss)


def _flow_case(chairs):
    jm = JaxFlowNetC(max_displacement=MD, return_pyramid=True)
    z = jnp.zeros((1, *HW, 3))
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), z, z)
    _, jloss = jtf.train_flownet_c(jpairs.FlowPairDataset(chairs), steps=1, batch_size=2,
                                   crop_hw=HW, max_displacement=MD, seed=0,
                                   mesh=jmesh.make_mesh(2), params=params, log_every=0)
    tm = FlowNetC(max_displacement=MD)
    load_flax_tree(tm, _np_tree(params))
    return dict(state_dict=_state_dict(tm), jloss=jloss)


def _pool_case(nets):
    """JAX's finetune_video(method "pool") at make_mesh(2), 2 steps a net,
    its two pool steps' pool rows and global batches captured; the JAX
    draws of each (tests/test_torch_pool_finetune.py::_jax_draws)."""
    models, params, tmodels = nets
    seen = []
    make_step = jft.make_pool_train_step

    def make_step_spy(loss_fn, tx, mesh, pool, batch_size, *a, **k):
        n = mesh.devices.size
        seen.append((len(jax.tree.leaves(pool)[0]), max(batch_size - batch_size % n, n)))
        return make_step(loss_fn, tx, mesh, pool, batch_size, *a, **k)

    img, lab = _frame_and_labels()
    mp = pytest.MonkeyPatch()
    mp.setattr(jft, "make_pool_train_step", make_step_spy)
    try:
        _, jlosses = jfused.finetune_video(models, params, img, lab, jmesh.make_mesh(2), JCFG)
    finally:
        mp.undo()
    assert len(seen) == 2
    draws = {key: _jax_draws()(None, JCFG.finetune.steps, *key) for key in seen}
    return dict(img=img, lab=lab, jlosses=jlosses, draws=draws,
                state_dicts={n: _state_dict(getattr(tmodels, n)) for n in ("refine", "maskrcnn")})


@pytest.fixture(scope="module")
def refs(tmp_path_factory, jax_nets):  # noqa: F811
    root = make_synthetic_davis(tmp_path_factory.mktemp("davis"), sequences=("a", "b"), t=3,
                                hw=HW)
    chairs = jpairs.make_synthetic_chairs(tmp_path_factory.mktemp("chairs"), n=4, hw=HW)
    return dict(root=str(root), chairs=str(chairs), maskrcnn=_maskrcnn_case(root),
                refine=_refine_case(root), flow=_flow_case(chairs), pool=_pool_case(jax_nets))


@pytest.fixture(scope="module")
def ranks(refs):
    """Every trainer on two gloo ranks in one spawn."""
    r = refs
    cases = {
        "maskrcnn": ("maskrcnn_train", dict(root=r["root"], cfg=TTINY, image_hw=HW,
                                            state_dict=r["maskrcnn"]["state_dict"])),
        "refine": ("refine_train", dict(root=r["root"], cfg=TREFINE, image_hw=HW,
                                        state_dict=r["refine"]["state_dict"])),
        "flow": ("flow_train", dict(chairs=r["chairs"], max_displacement=MD, crop_hw=HW,
                                    state_dict=r["flow"]["state_dict"])),
        "pool": ("pool_finetune", dict(cfg=TCFG, state_dicts=r["pool"]["state_dicts"],
                                       frame=r["pool"]["img"], labels=r["pool"]["lab"],
                                       draws=r["pool"]["draws"])),
        "cli": ("refine_cli", dict(argv=["--davis_root", r["root"], "--split", "val", "--steps",
                                         "0", "--device", "cpu", "--out", "refine.pt"])),
    }
    return dryrun.spawn(_parallel_ranks.parity_rank, 2, "gloo", cases, device="cpu")


def _rel(a, b):
    return abs(a - b) / abs(b)


@pytest.mark.parametrize("trainer", ["maskrcnn", "refine", "flow"])
def test_trainer_over_two_ranks_matches_jax(refs, ranks, trainer):
    """One step of the trainer at a global batch of 2 (refine: 4), one half
    a rank: JAX's loss at make_mesh(2), 1e-5 relative; both ranks' weights
    equal after the step."""
    want = refs[trainer]["jloss"]
    for r in ranks:
        got = r[trainer]["loss"]
        assert np.isfinite(got) and _rel(got, want) <= 1e-5, (trainer, got, want)
    assert ranks[0][trainer]["digest"] == ranks[1][trainer]["digest"]


def test_pool_finetune_over_two_ranks_matches_jax(refs, ranks):
    """finetune_video(method "pool"), 2 steps a net, one example (one frame)
    a rank of each step's global batch of 2, the port fed JAX's pool-step
    draws: both losses 1e-4 relative; both ranks' nets equal."""
    want = refs["pool"]["jlosses"]
    for r in ranks:
        got = r["pool"]["losses"]
        for net in ("refine", "proposal"):
            assert np.isfinite(got[net]) and _rel(got[net], want[net]) <= 1e-4, (net, got, want)
    assert ranks[0]["pool"]["digests"] == ranks[1]["pool"]["digests"]


def test_trainer_cli_under_a_process_group(ranks):
    """`train_refine`'s command line started on two gloo ranks builds its
    mesh from the group, and rank 0 alone saves."""
    assert ranks[0]["cli"]["saved"] == ["refine.pt"]
    assert ranks[1]["cli"]["saved"] == []
