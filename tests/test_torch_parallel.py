"""The port's data parallelism (premvos_tpu_torch.parallel, the DP train
step, the fused fine-tune over a mesh) on the CPU: two gloo ranks against
the JAX package at `make_mesh(2)` (tests/conftest.py gives JAX 8 virtual
CPU devices), two ranks against one, and a one-rank mesh against the
single-device code, bit for bit. The multi-video fine-tune, sharded
inference, `run_davis --finetune` under a process group and the dry run
are in tests/test_torch_parallel_videos.py: the two files' JAX references
and spawns then run on two pytest workers.

The JAX references are built once per module. The port's two ranks run in
ONE spawn (premvos_tpu_torch.parallel.dryrun.spawn, a FileStore rendezvous
in a temporary directory) that runs every case (tests/_parallel_ranks.py,
which imports no JAX); a spawn costs a few seconds before any model work.

Bounds (those of the single-device parity tests): a DP step's loss 1e-5
relative and every parameter after its Adam step within 1e-4 of its norm
(tests/test_torch_pool_finetune.py::_assert_params_close: Adam turns
float32 noise in near-zero gradients into a large share of a step). Across
ranks, the weights after a step are equal bit for bit.
"""
import dataclasses
import os

import flax
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.distributed as dist
from jax.sharding import NamedSharding, PartitionSpec as P

import premvos_tpu.config as jc
from premvos_tpu.data import crops as jcrops
from premvos_tpu.finetune import fused as jfused
from premvos_tpu.models.anchors import pyramid_anchors as jax_pyramid_anchors
from premvos_tpu.models.deeplab import DeepLabV3Plus as JaxDeepLab
from premvos_tpu.models.maskrcnn import MaskRCNN as JaxMaskRCNN
from premvos_tpu.models.reid import ReIDNet as JaxReIDNet
from premvos_tpu.parallel import mesh as jmesh
from premvos_tpu.train import detection as jdet
from premvos_tpu.train import trainer as jtrainer
from premvos_tpu.train.losses import sigmoid_xent as jax_sigmoid_xent
from premvos_tpu.train.train_reid import train_reid as jax_train_reid
from premvos_tpu_torch import config as tc
from premvos_tpu_torch.bridge import flax_tensors, load_flax_tree
from premvos_tpu_torch.finetune import fused as tfused
from premvos_tpu_torch.finetune import lucid_device as tl
from premvos_tpu_torch.finetune.finetune import refine_loss_fn
from premvos_tpu_torch.models.anchors import pyramid_anchors
from premvos_tpu_torch.models.deeplab import DeepLabV3Plus
from premvos_tpu_torch.models.layers import init_module
from premvos_tpu_torch.models.maskrcnn import MaskRCNN
from premvos_tpu_torch.models.reid import ReIDNet
from premvos_tpu_torch.parallel import dryrun, make_mesh, replicate, shard_batch
from premvos_tpu_torch.parallel.mesh import Mesh, as_mesh
from premvos_tpu_torch.train import trainer as ttrainer
from premvos_tpu_torch.train.detection import maskrcnn_loss_fn
from tests import _parallel_ranks
from tests.test_torch_finetune import H as FH
from tests.test_torch_finetune import JREFINE, K, TREFINE, W as FW
from tests.test_torch_finetune import _batch_loss, _cells, _consts, _port_consts, _refine_draws
from tests.test_torch_pool_finetune import _frame_and_labels
from tests.test_torch_train import HW, JTINY, TTINY, _train_batch
from tests._threads import few_threads  # noqa: F401

JREID = jc.ReIDConfig(backbone_depth=26, embedding_dim=8, crop_size=32)
TREID = tc._from_dict(tc.ReIDConfig, dataclasses.asdict(JREID))
FT_FUSED = dict(batch_size=4, aug_patch=32, chunk=1, steps=1)


def _np_tree(tree):
    return jax.tree.map(np.asarray, flax.core.unfreeze(tree))


def _jax_dp_step(loss_fn, params, batch):
    """One JAX make_dp_train_step (Adam 1e-4) at make_mesh(2): its loss and
    parameters after; the mean of the two shards' gradients (what its
    pmean hands Adam) and the whole batch's loss after the step."""
    mesh = jmesh.make_mesh(2)
    tx = optax.adam(1e-4)
    state = jtrainer.replicate_state(jtrainer.create_train_state(params, tx), mesh)
    step = jtrainer.make_dp_train_step(loss_fn, tx, mesh)
    state, loss = step(state, jtrainer.shard_train_batch(tuple(map(jnp.asarray, batch)), mesh))
    vg = jax.jit(jax.value_and_grad(loss_fn))
    half = len(batch[0]) // 2
    shards = [tuple(jnp.asarray(a[i * half:(i + 1) * half]) for a in batch) for i in range(2)]
    grads = jax.tree.map(lambda a, b: (np.asarray(a) + np.asarray(b)) / 2,
                         *(vg(params, b)[1] for b in shards))
    # The losses normalise per example, so the batch's is the shards' mean
    # (one compiled shape serves both).
    after = float(np.mean([vg(state.params, b)[0] for b in shards]))
    return float(loss), _np_tree(state.params), _np_tree(grads), after


def _refine_case():
    jm = JaxDeepLab(cfg=JREFINE)
    jp = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.zeros((1, 33, 33, 4)))
    tm = DeepLabV3Plus(TREFINE)
    load_flax_tree(tm, _np_tree(jp))
    rng = np.random.default_rng(0)
    batch = (rng.standard_normal((4, 33, 33, 4)).astype(np.float32),
             (rng.uniform(0, 1, (4, 33, 33)) > 0.5).astype(np.float32))
    jloss, jparams, jgrads, jafter = _jax_dp_step(
        lambda p, b: jax_sigmoid_xent(jm.apply(p, b[0]), b[1]), jp, batch)
    return dict(jm=jm, jp=jp, tm=tm, batch=batch, jloss=jloss, jafter=jafter,
                jparams=flax_tensors(tm, jparams), jgrads=flax_tensors(tm, jgrads))


def _maskrcnn_case():
    jm = JaxMaskRCNN(cfg=JTINY)
    janchors = {k: jnp.asarray(v) for k, v in jax_pyramid_anchors(
        *HW, JTINY.anchor_scales, JTINY.anchor_ratios).items()}
    params = flax.core.unfreeze(jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.zeros((1, *HW, 3)),
                                                 janchors))
    # The zero RPN delta head of tests/test_torch_train.py: the proposals
    # are the clipped anchors on both sides.
    params["params"]["rpn"]["Conv_2"] = jax.tree.map(jnp.zeros_like,
                                                     params["params"]["rpn"]["Conv_2"])
    tm = MaskRCNN(TTINY)
    load_flax_tree(tm, _np_tree(params))
    tanchors = {k: torch.from_numpy(v) for k, v in pyramid_anchors(
        *HW, TTINY.anchor_scales, TTINY.anchor_ratios).items()}
    batch = _train_batch(tm, tanchors)
    jloss, jparams, jgrads, jafter = _jax_dp_step(
        jdet.maskrcnn_loss_fn(jm, janchors, JTINY, HW), params, batch)
    return dict(tm=tm, tanchors=tanchors, batch=batch, jloss=jloss, jafter=jafter,
                jparams=flax_tensors(tm, jparams), jgrads=flax_tensors(tm, jgrads))


def _reid_case(root):
    images, ann = jcrops.make_synthetic_coco(root, num_images=3, per_image=2)
    jm = JaxReIDNet(cfg=JREID)
    jp = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)))
    tm = ReIDNet(TREID)
    load_flax_tree(tm, _np_tree(jp))
    ds = jcrops.InstanceCropDataset(images, ann, crop_size=32)
    _, jloss = jax_train_reid(ds, JREID, steps=1, p=2, k=2, seed=0, mesh=jmesh.make_mesh(2),
                              params=jp, log_every=0)
    return dict(images=str(images), ann=str(ann), tm=tm, jloss=jloss)


def _port_examples(draws):
    """The port's refine batch of `draws` (one shard's) and the soft crop
    of each example's object mask, before its 0.5 threshold."""
    seen = []
    real = tl.crop_and_resize

    def spy(*a, **k):
        seen.append(real(*a, **k))
        return seen[-1]

    run = tfused.build_refine_fused_runs((FH, FW), TREFINE, tc.FinetuneConfig(**FT_FUSED), K,
                                         Mesh(None, 0, 2, torch.device("cpu")))
    mp = pytest.MonkeyPatch()
    mp.setattr(tl, "crop_and_resize", spy)
    try:
        x, tgt, ok = run.batch(draws, _port_consts(_consts()))
    finally:
        mp.undo()
    return x, tgt, ok, seen[-1][:, 0, 3]


def _fused_case(refine):
    """One JAX fused refine step (make_fused_scan, chunk 1) at
    make_mesh(2), batch 4 (2 a shard); shard r's step key is
    fold_in(fold_in(base_key, r), 0) (fused.py:99-102), split into its 2
    examples' keys: the draws of those keys, JAX's examples from them
    (its runner's `one_example`), and the port's. The reference for the
    port's fused DP step is JAX's make_dp_train_step on the port's
    examples (a 0.5-threshold tie in an example's target, which the
    examples' test allows, would move the loss by more than its bound)."""
    mesh = jmesh.make_mesh(2)
    ft = jc.FinetuneConfig(**FT_FUSED)
    runs, tx = jfused.build_refine_fused_runs(refine["jm"], mesh, (FH, FW), JREFINE, ft, K)
    rep = NamedSharding(mesh, P())
    consts = tuple(jax.device_put(jnp.asarray(x), rep) for x in _consts())
    base_key = jax.random.PRNGKey(5)
    _, scan_loss = runs[1](jfused._fresh_state(refine["jp"], tx, mesh), consts, base_key)
    one_example = _cells(_batch_loss(runs))["one_example"].cell_contents
    examples = jax.jit(jax.vmap(lambda k: one_example(k, *consts)))
    jm, jp = refine["jm"], refine["jp"]

    def loss_on(p, b):  # the runner's batch_loss on given examples (fused.py)
        logits = jm.apply(p, b[0])
        msk = jnp.broadcast_to(b[2][:, None, None], logits.shape).astype(jnp.float32)
        return jax_sigmoid_xent(logits, b[1], mask=msk)

    draws, jax_ex, port_ex = [], [], []
    for r in range(2):
        keys = jax.random.split(jax.random.fold_in(jax.random.fold_in(base_key, r), 0), 2)
        draws.append(_refine_draws(list(keys), K, FH, FW, 32))
        jax_ex.append(tuple(np.asarray(a) for a in examples(keys)))
        port_ex.append(_port_examples(draws[-1]))
    shard_losses = [float(jax.jit(loss_on)(jp, ex)) for ex in jax_ex]
    batch = (np.concatenate([e[0].permute(0, 2, 3, 1).numpy() for e in port_ex]),
             np.concatenate([e[1].numpy() for e in port_ex]),
             np.concatenate([e[2].numpy() for e in port_ex]))
    jloss, jparams, jgrads, _ = _jax_dp_step(loss_on, jp, batch)
    return dict(scan_loss=float(scan_loss), shard_losses=shard_losses, jax_examples=jax_ex,
                port_examples=port_ex, draws=draws, jloss=jloss,
                jparams=flax_tensors(refine["tm"], jparams),
                jgrads=flax_tensors(refine["tm"], jgrads))


@pytest.fixture(scope="module")
def jax_refs(tmp_path_factory):
    refine = _refine_case()
    return dict(refine=refine, maskrcnn=_maskrcnn_case(),
                reid=_reid_case(tmp_path_factory.mktemp("coco")), fused=_fused_case(refine))


@pytest.fixture(scope="module")
def ranks(jax_refs):
    """Every case on two gloo ranks in one spawn."""
    r = jax_refs
    sd = lambda m: {k: v.clone() for k, v in m.state_dict().items()}  # noqa: E731
    cases = {
        "refine": ("dp_step", dict(kind="refine", cfg=TREFINE, state_dict=sd(r["refine"]["tm"]),
                                   batch=r["refine"]["batch"], perturb_rank=True)),
        "maskrcnn": ("dp_step", dict(kind="maskrcnn", cfg=TTINY,
                                     state_dict=sd(r["maskrcnn"]["tm"]),
                                     batch=r["maskrcnn"]["batch"], image_hw=HW)),
        "reid": ("reid", dict(images=r["reid"]["images"], ann=r["reid"]["ann"], cfg=TREID,
                              state_dict=sd(r["reid"]["tm"]))),
        "fused": ("fused", dict(cfg=TREFINE, ft=tc.FinetuneConfig(**FT_FUSED), max_objects=K,
                                state_dict=sd(r["refine"]["tm"]),
                                consts=_port_consts(_consts()), draws=r["fused"]["draws"])),
    }
    return dryrun.spawn(_parallel_ranks.parity_rank, 2, "gloo", cases, device="cpu")


def _assert_params_close(got: dict, want: dict, what="", but=()):
    """Each parameter (but those named in `but`) within 1e-4 of its norm
    (L2)."""
    assert set(got) <= set(want) and set(but) <= set(got)
    for name, g in got.items():
        if name in but:
            continue
        w = np.asarray(want[name])
        err = float(np.linalg.norm(np.asarray(g) - w))
        assert err <= 1e-4 * float(np.linalg.norm(w)), (what, name, err)


def _assert_grads_close(got: dict, want: dict, what=""):
    """Every parameter's gradient within 1e-4 of its largest |grad| (the
    bound of tests/test_torch_train.py)."""
    assert set(got) == {n for n in want if not n.endswith((".mean", ".var"))}
    for name, g in got.items():
        w = np.asarray(want[name])
        scale = max(float(np.abs(w).max()), 1e-12)
        err = float(np.abs(g - w).max())
        assert err <= 1e-4 * scale, (what, name, err, scale)


def _rel(a, b):
    return abs(a - b) / abs(b)


# ------------------------------------------------------------- the mesh

def test_shard_order_equals_p_data():
    """Rank r's block of every leaf is what JAX's P("data") puts on device
    r of a 4-device mesh."""
    x = np.arange(8 * 3, dtype=np.float32).reshape(8, 3)
    y = np.arange(8, dtype=np.int32)
    mesh = jmesh.make_mesh(4)
    jx, jy = jmesh.shard_batch((jnp.asarray(x), jnp.asarray(y)), mesh)
    for r in range(4):
        got = shard_batch({"x": x, "y": [torch.from_numpy(y)]}, Mesh(None, r, 4, torch.device("cpu")))
        want_x = next(s.data for s in jx.addressable_shards if s.device == mesh.devices[r])
        want_y = next(s.data for s in jy.addressable_shards if s.device == mesh.devices[r])
        np.testing.assert_array_equal(got["x"], np.asarray(want_x))
        np.testing.assert_array_equal(got["y"][0].numpy(), np.asarray(want_y))


def test_indivisible_batches_are_refused():
    mesh = Mesh(None, 0, 3, torch.device("cpu"))
    with pytest.raises(ValueError, match="does not divide over 3 ranks"):
        shard_batch((np.zeros((4, 2)),), mesh)
    with pytest.raises(ValueError, match="does not divide"):
        ttrainer.shard_train_batch(torch.zeros(5), Mesh(None, 1, 2, torch.device("cpu")))


def test_one_rank_mesh_has_no_collectives(monkeypatch):
    """Without a process group the mesh has one rank, and its step,
    replication and gather call no collective."""
    def boom(*a, **k):
        raise AssertionError("a collective was called")

    for name in ("all_reduce", "broadcast", "all_gather"):
        monkeypatch.setattr(dist, name, boom)
    mesh = make_mesh(device="cpu")
    assert (mesh.group, mesh.rank, mesh.size, mesh.device.type) == (None, 0, 1, "cpu")
    m = DeepLabV3Plus(TREFINE)
    init_module(m, torch.Generator().manual_seed(0))
    replicate(m, mesh)
    state = ttrainer.create_train_state(m, 1e-4)
    step = ttrainer.make_dp_train_step(refine_loss_fn(m), state.optimizer, mesh)
    rng = np.random.default_rng(0)
    batch = (torch.from_numpy(rng.standard_normal((2, 33, 33, 4)).astype(np.float32)),
             torch.from_numpy((rng.uniform(0, 1, (2, 33, 33)) > 0.5).astype(np.float32)))
    assert np.isfinite(float(step(batch)))
    t = torch.arange(3)
    assert mesh.all_gather(t) is t and mesh.all_reduce_(t) is t


def test_make_mesh_needs_a_card_or_explicit_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh()
    with pytest.raises(ValueError, match="needs a process group"):
        make_mesh(2, device="cpu")
    with pytest.raises(ValueError, match="no process group"):
        make_mesh(device="cpu", backend="gloo")


def test_grad_bucket_views_keep_each_parameters_strides():
    """The DP step's bucket: one zeroed buffer, each parameter's `.grad` a
    view of its slot with the parameter's strides (channels-last too),
    into which backward accumulates what it gives a parameter without one;
    float32 only."""
    import copy

    conv = torch.nn.Conv2d(3, 4, 3).to(memory_format=torch.channels_last)
    net = torch.nn.Sequential(conv, torch.nn.Flatten(), torch.nn.Linear(4 * 6 * 6, 2))
    twin = copy.deepcopy(net)
    params = list(net.parameters())
    flat = ttrainer.grad_bucket(params)
    assert flat.numel() == sum(p.numel() for p in params) + 1 and not flat.any()
    for p in params:
        assert p.grad.stride() == p.stride()
        assert p.grad.untyped_storage().data_ptr() == flat.untyped_storage().data_ptr()
    x = torch.randn(2, 3, 8, 8).to(memory_format=torch.channels_last)
    net(x).square().sum().backward()
    twin(x).square().sum().backward()
    for p, q in zip(params, twin.parameters()):
        assert torch.equal(p.grad, q.grad)
    assert flat[:-1].abs().sum() > 0 and flat[-1] == 0
    with pytest.raises(TypeError, match="float32"):
        ttrainer.grad_bucket([torch.nn.Parameter(torch.zeros(2, dtype=torch.float64))])


def test_as_mesh_is_one_rank_on_the_named_device(monkeypatch):
    """An entry point's `mesh=None` is one rank without collectives on its
    device (CUDA unless named: raises without a card); a mesh with another
    device than the entry point's raises."""
    mesh = as_mesh(None, "cpu")
    assert (mesh.group, mesh.rank, mesh.size, mesh.device) == (None, 0, 1, torch.device("cpu"))
    assert as_mesh(mesh) is mesh and as_mesh(mesh, "cpu") is mesh
    with pytest.raises(ValueError, match="is not the mesh's"):
        as_mesh(mesh, "cuda")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        as_mesh(None)


def test_dryrun_multichip_needs_cards_or_explicit_cpu(monkeypatch):
    """Without as many cards as ranks, the dry run raises and names
    device="cpu"; it never moves to the CPU unasked."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    spawned = []
    monkeypatch.setattr(dryrun, "spawn", lambda *a, **k: spawned.append(a))
    with pytest.raises(RuntimeError, match="2 CUDA cards, 1 visible.*device='cpu'"):
        dryrun.dryrun_multichip(2)
    with pytest.raises(RuntimeError, match="CUDA cards"):
        dryrun.main(["--devices", "2"])
    assert not spawned
    dryrun.dryrun_multichip(1)
    dryrun.dryrun_multichip(2, device="cpu")
    assert [a[1:3] for a in spawned] == [(1, "nccl"), (2, "gloo")]


def _weights(module):
    return [p.detach().clone() for p in module.parameters()]


def test_one_rank_mesh_equals_the_single_device_code(tmp_path):
    """A one-rank mesh, with no group and with a world-size-1 gloo group
    (its collectives then run): the DP step equals make_train_step and the
    fused fine-tune equals today's run, bit for bit."""
    rng = np.random.default_rng(0)
    batch = (torch.from_numpy(rng.standard_normal((2, 33, 33, 4)).astype(np.float32)),
             torch.from_numpy((rng.uniform(0, 1, (2, 33, 33)) > 0.5).astype(np.float32)))
    base = DeepLabV3Plus(TREFINE)
    init_module(base, torch.Generator().manual_seed(1))
    frame, lab = _frame_and_labels(64, 96, seed=5)
    ft = tc.FinetuneConfig(batch_size=2, aug_patch=32, chunk=2, steps=2)

    def plain():
        m = DeepLabV3Plus(TREFINE)
        m.load_state_dict(base.state_dict())
        st = ttrainer.create_train_state(m, 1e-4)
        losses = [ttrainer.make_train_step(refine_loss_fn(m), st.optimizer)(batch)
                  for _ in range(2)]
        return losses, _weights(m)

    def dp(mesh):
        m = DeepLabV3Plus(TREFINE)
        m.load_state_dict(base.state_dict())
        st = ttrainer.replicate_state(ttrainer.create_train_state(m, 1e-4), mesh)
        step = ttrainer.make_dp_train_step(refine_loss_fn(m), st.optimizer, mesh)
        return [step(batch) for _ in range(2)], _weights(m)

    def fused(mesh):
        m, loss = tfused.finetune_refine_fused(base, frame, lab, TREFINE, ft, max_objects=2,
                                               mesh=mesh)
        return loss, _weights(m)

    def check(mesh):
        losses, got = dp(mesh)
        assert [x.item() for x in losses] == [x.item() for x in want_losses]
        assert all(torch.equal(a, b) for a, b in zip(got, want))
        loss, got = fused(mesh)
        assert loss == want_fused[0]
        assert all(torch.equal(a, b) for a, b in zip(got, want_fused[1]))

    want_losses, want = plain()
    want_fused = fused(None)
    check(make_mesh(device="cpu"))
    store = dist.FileStore(os.path.join(tmp_path, "store"), 1)
    dist.init_process_group("gloo", store=store, rank=0, world_size=1)
    try:
        mesh = make_mesh(1, backend="gloo")
        assert mesh.group is not None and mesh.size == 1
        check(mesh)
    finally:
        dist.destroy_process_group()


# ------------------------------------------ two gloo ranks against JAX

def test_dp_refine_step_matches_jax(jax_refs, ranks):
    """The refine net, batch 4 (2 a rank; rank 1 starts from other weights,
    which the replication overwrites): the loss 1e-5, the averaged
    gradients 1e-4 of their largest |grad|, every parameter after Adam 1e-4
    of its norm, the loss after the step 1e-4."""
    want = jax_refs["refine"]
    for r in ranks:
        got = r["refine"]
        assert _rel(got["loss"], want["jloss"]) <= 1e-5, (got["loss"], want["jloss"])
        _assert_grads_close(got["grads"], want["jgrads"], "refine")
        _assert_params_close(got["params"], want["jparams"], "refine")
        assert _rel(got["loss_after"], want["jafter"]) <= 1e-4
    assert ranks[0]["refine"]["digest"] == ranks[1]["refine"]["digest"]


def test_dp_maskrcnn_step_matches_jax(jax_refs, ranks):
    """Mask R-CNN, one image a rank, the full detection loss: as the refine
    step. One parameter is held by its gradient and the loss after the step
    only: rpn.Conv_2.bias, which the test zeroes (with the delta kernel, so
    that the proposals are the anchors on both sides). Its norm after the
    step is one Adam step, and its first element's gradient is 1.5e-7,
    15 × Adam's eps, in both packages: there Adam's g / (|g| + eps) turns
    float32 rounding into 8.5e-3 of that norm, as it does on one device
    without a mesh (every other parameter: at most 7.7e-6)."""
    want = jax_refs["maskrcnn"]
    for r in ranks:
        got = r["maskrcnn"]
        assert _rel(got["loss"], want["jloss"]) <= 1e-5, (got["loss"], want["jloss"])
        _assert_grads_close(got["grads"], want["jgrads"], "maskrcnn")
        _assert_params_close(got["params"], want["jparams"], "maskrcnn",
                             but=("rpn.Conv_2.bias",))
        assert _rel(got["loss_after"], want["jafter"]) <= 1e-4
    assert ranks[0]["maskrcnn"]["digest"] == ranks[1]["maskrcnn"]["digest"]


def test_dp_reid_step_mines_per_shard_as_jax(jax_refs, ranks):
    """train_reid over 2 ranks: one PK group a rank (ids offset by rank·P),
    batch-hard mining within it, the loss averaged: JAX's loss, 1e-5."""
    want = jax_refs["reid"]["jloss"]
    for r in ranks:
        assert _rel(r["reid"]["loss"], want) <= 1e-5, (r["reid"]["loss"], want)
    assert ranks[0]["reid"]["digest"] == ranks[1]["reid"]["digest"]


def test_fused_shard_keys_give_jax_shard_examples(jax_refs):
    """Shard r of JAX's fused scan steps on fold_in(fold_in(key, r), step):
    the mean of its shards' losses on the examples of those keys is the
    scan's loss, and the port's batch from the draws of shard r's keys is
    JAX's shard r batch (tests/test_torch_finetune.py's bounds: inputs
    1e-4, `ok` equal, targets equal except where the soft crop lies within
    1e-4 of the 0.5 threshold, the coarse channel equal in every example
    whose target is)."""
    f = jax_refs["fused"]
    assert _rel(float(np.mean(f["shard_losses"])), f["scan_loss"]) <= 1e-6
    for (wx, wt, wok), (x, tgt, ok, soft) in zip(f["jax_examples"], f["port_examples"]):
        np.testing.assert_allclose(x[:, :3].permute(0, 2, 3, 1).numpy(), wx[..., :3], rtol=0,
                                   atol=1e-4)
        np.testing.assert_array_equal(ok.numpy(), wok)
        differ = tgt.numpy() != wt
        assert (np.abs(soft.numpy()[differ] - 0.5) <= 1e-4).all()
        for i in range(len(wt)):
            if not differ[i].any():
                np.testing.assert_array_equal(x[i, 3].numpy(), wx[i, ..., 3])


def test_dp_fused_refine_step_matches_jax(jax_refs, ranks):
    """One fused refine step, 2 examples a rank, rank r fed the draws of JAX
    shard r's key, against JAX's make_dp_train_step on the same examples:
    loss 1e-5, the averaged gradients 1e-4 of their largest |grad|, every
    parameter after Adam 1e-4 of its norm."""
    want = jax_refs["fused"]
    for r in ranks:
        got = r["fused"]
        assert _rel(got["loss"], want["jloss"]) <= 1e-5, (got["loss"], want["jloss"])
        _assert_grads_close(got["grads"], want["jgrads"], "fused")
        _assert_params_close(got["params"], want["jparams"], "fused")
    assert ranks[0]["fused"]["digest"] == ranks[1]["fused"]["digest"]


# ------------------------------------------------------ the port alone

def _one_rank_step(module, loss_fn, batch):
    state = ttrainer.create_train_state(module, 1e-4)
    loss = ttrainer.make_train_step(loss_fn, state.optimizer)(
        tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in batch))
    return float(loss), _parallel_ranks.params_of(module)


def test_two_ranks_equal_one_rank_at_the_same_global_batch(jax_refs, ranks):
    """Shard means average to the batch mean (losses normalise per image or
    per pixel, then average): two ranks at batch 2 + 2 (refine) and 1 + 1
    (Mask R-CNN) against one process at batch 4 and 2."""
    import copy

    ref = jax_refs["refine"]
    m = copy.deepcopy(ref["tm"])
    loss, params = _one_rank_step(m, refine_loss_fn(m), ref["batch"])
    assert _rel(ranks[0]["refine"]["loss"], loss) <= 1e-5
    _assert_params_close(ranks[0]["refine"]["params"], params, "refine, one rank")
    mr = jax_refs["maskrcnn"]
    m = copy.deepcopy(mr["tm"])
    loss, params = _one_rank_step(m, maskrcnn_loss_fn(m, mr["tanchors"], TTINY, HW), mr["batch"])
    assert _rel(ranks[0]["maskrcnn"]["loss"], loss) <= 1e-5
    _assert_params_close(ranks[0]["maskrcnn"]["params"], params, "maskrcnn, one rank")


def test_spawn_raises_when_a_rank_fails():
    """A rank that raises fails the spawn, with its traceback; no partial
    result comes back."""
    with pytest.raises(RuntimeError, match="(?s)rank 1 .*ValueError: rank one fails"):
        dryrun.spawn(_parallel_ranks.fail_on_rank_one, 2, "gloo")
