"""The port's fused per-video fine-tune vs the JAX package, on the CPU.

The port splits every random draw from the work (finetune/lucid_device.py),
so each test re-derives JAX's draws from its PRNG key with `jax.random`,
following the split tree of lucid_device.py:187-189, 214, 230-243 and
fused.py:221-238, and feeds them to the port. The JAX side runs unjitted
where it is a closure of the fused runners, and the refine batch loss under
value_and_grad is jitted alone (never the fused scan, whose proposal
version takes about 25 min to compile on the CPU).
Both sides warp exactly here: JAX's block warps are inside their envelope
at these sizes (measured below). Float32 throughout, tiny nets (frozen BN).

Tolerances, each measured first:
  * smooth_field 1e-5 (the same blur and resize in another library);
  * perturb_mask_device exact (max/min filters and a roll);
  * lucid_frame: canvas within 1e-2 on the 0..255 scale where the labels
    agree (measured: at most 9e-4 with the elastic field off and 4e-3 with
    it on, at patch 64), masks equal except where a pasted value lies
    within 1e-4 of the 0.5 threshold (measured: no pixel differs);
  * the refine batch: inputs 1e-4 (unit-scale, normalized RGB), targets,
    `ok` and the coarse channel equal; the proposal batch: images 1e-4,
    boxes, masks and validity equal;
  * one refine step: loss 1e-5 relative, each gradient 1e-4 of its largest
    |grad|, loss after one Adam step 1e-4 relative (the bounds of
    tests/test_torch_train.py);
  * the inpainting and the uint8 area resize against OpenCV: equal
    (measured: no value differs; the bound allows one level for the area
    resize, whose sums run in another order), the nearest resize equal.
"""

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh

import premvos_tpu.config as jc
from premvos_tpu.finetune import fused as jfused
from premvos_tpu.finetune import lucid_device as jl
from premvos_tpu.models.deeplab import DeepLabV3Plus as JaxDeepLab
from premvos_tpu.models.maskrcnn import MaskRCNN as JaxMaskRCNN
from premvos_tpu_torch import config as tc
from premvos_tpu_torch.bridge import flax_tensors, load_flax_tree
from premvos_tpu_torch.data.lucid import inpaint_background
from premvos_tpu_torch.data.preprocess import resize_area_u8, resize_nearest
from premvos_tpu_torch.finetune import fused as tfused
from premvos_tpu_torch.finetune import lucid_device as tl
from premvos_tpu_torch.models.deeplab import DeepLabV3Plus
from premvos_tpu_torch.models.layers import init_module
from premvos_tpu_torch.ops.masks import paste_mask
from premvos_tpu_torch.pipeline import runner as tr
from premvos_tpu_torch.train.trainer import create_train_state

H, W, K = 64, 96, 3
FT = dict(batch_size=2, aug_patch=32, chunk=2, steps=2)
FT_LR = jc.FinetuneConfig().learning_rate
JREFINE = jc.RefineConfig(crop_size=33, backbone_depth=26)
TREFINE = tc._from_dict(tc.RefineConfig, dataclasses.asdict(JREFINE))
JPROP = jc.ProposalConfig(backbone_depth=26, fpn_channels=32, rpn_pre_nms_topk=64,
                          rpn_post_nms_topk=16, detections_per_frame=8)


def _t(x):
    return torch.from_numpy(np.array(x))


def _consts(h=H, w=W):
    """First frame and background (0..255), K slots of which the first two
    hold rectangles, and the validity of each slot."""
    rng = np.random.default_rng(7)
    img = rng.integers(0, 255, (h, w, 3)).astype(np.float32)
    masks = np.zeros((K, h, w), np.float32)
    masks[0, h // 5:h // 5 + h * 7 // 16, w // 5:w // 5 + w // 3] = 1.0
    masks[1, h // 2:h // 2 + h * 7 // 16, w // 2:w // 2 + w * 2 // 5] = 1.0
    valid = np.array([True, True, False])
    bg = rng.integers(0, 255, (h, w, 3)).astype(np.float32)
    return img, masks, valid, bg


def _jax_consts(c):
    return tuple(jnp.asarray(x) for x in c)


def _port_consts(c):
    img, masks, valid, bg = c
    return (_t(img).permute(2, 0, 1), _t(masks), valid, _t(bg).permute(2, 0, 1))


def _photo(key):
    k1, k2, k3 = jax.random.split(key, 3)
    return np.concatenate([
        [jax.random.uniform(k1, (), jnp.float32, 0.8, 1.2)],
        [jax.random.uniform(k2, (), jnp.float32, -20.0, 20.0)],
        np.asarray(jax.random.uniform(k3, (3,), jnp.float32, 0.9, 1.1)),
    ]).astype(np.float32)


def _lucid_draws(key, k, h, w, patch, elastic_prob=0.8):
    """The values JAX's lucid_frame(key, ...) draws (lucid_device.py:187-189,
    214, 230-243), as one example's numpy arrays."""
    kk = jax.random.split(key, 2 + k)
    aff, noise, el, photo = [], [], [], []
    for j in range(k):
        ks = jax.random.split(kk[2 + j], 4)
        aff.append(np.array(jl.sample_affine(ks[0], 15.0, 0.9, 1.1, 0.1 * w, 0.1 * h), np.float32))
        noise.append(np.asarray(jax.random.uniform(
            ks[1], (2, *tl.noise_hw(patch)), jnp.float32, -1.0, 1.0)))
        el.append(bool(jax.random.uniform(ks[2], ()) < elastic_prob))
        photo.append(_photo(ks[3]))
    return dict(
        bg_affine=np.array(jl.sample_affine(kk[0], 5.0, 0.9, 1.1, 0.05 * w, 0.05 * h), np.float32),
        bg_photo=_photo(kk[1]), affine=np.stack(aff), noise=np.stack(noise),
        elastic=np.array(el), photo=np.stack(photo),
    )


def _stack_lucid(draws):
    return tl.LucidDraws(**{f: _t(np.stack([d[f] for d in draws])) for f in tl.LucidDraws._fields})


def _refine_draws(keys, k, h, w, patch):
    """JAX's one_example draws (fused.py:221-238) for each key."""
    lucid, pri, jit, branch, shift = [], [], [], [], []
    for key in keys:
        k1, k2, k3, k4 = jax.random.split(key, 4)
        lucid.append(_lucid_draws(k1, k, h, w, patch))
        pri.append(np.asarray(jax.random.uniform(k2, (k,))))
        jit.append(np.asarray(jax.random.randint(k3, (2,), -8, 9)))
        p1, p2, _ = jax.random.split(k4, 3)
        branch.append(int(jax.random.randint(p1, (), 0, 5)))
        shift.append(np.asarray(jax.random.randint(p2, (2,), -4, 5)))
    return tl.RefineDraws(_stack_lucid(lucid), _t(np.stack(pri)), _t(np.stack(jit)).long(),
                          torch.tensor(branch), _t(np.stack(shift)).long())


def _cells(fn):
    return {n: c for n, c in zip(fn.__code__.co_freevars, fn.__closure__ or ())}


def _batch_loss(runs):
    """The unjitted `batch_loss` closure of a JAX fused runner."""
    fn = next(iter(runs.values()))
    while hasattr(fn, "__wrapped__"):
        fn = fn.__wrapped__
    return _cells(fn)["batch_loss"].cell_contents


@pytest.fixture(scope="module")
def mesh():
    return Mesh(np.array(jax.devices()[:1]), ("data",))


# ------------------------------------------------------------ lucid_device

def test_smooth_field_matches_jax():
    """Fields of a 32² and a 64×48 patch from the noise JAX draws, 1e-5."""
    for i, (h, w) in enumerate([(32, 32), (64, 48)]):
        key = jax.random.PRNGKey(i)
        noise = jax.random.uniform(key, (2, max(h // 8, 4), max(w // 8, 4)), jnp.float32, -1.0, 1.0)
        want = np.moveaxis(np.asarray(jl.smooth_field(key, h, w)), -1, 0)
        got = tl.smooth_field(_t(noise), h, w).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def _branch_keys():
    """A key for each perturbation branch 0..4 (the first found)."""
    keys = {}
    for i in range(200):
        key = jax.random.PRNGKey(100 + i)
        b = int(jax.random.randint(jax.random.split(key, 3)[0], (), 0, 5))
        keys.setdefault(b, key)
        if len(keys) == 5:
            return keys
    raise AssertionError("no key for some branch")


@pytest.mark.parametrize("branch", range(5))
def test_perturb_mask_device_matches_jax(branch):
    """Each branch (identity, 3×3 / 5×5 dilation, 3×3 / 5×5 erosion) with
    the shift JAX draws: exact."""
    key = _branch_keys()[branch]
    rng = np.random.default_rng(branch)
    mask = (rng.uniform(0, 1, (33, 33)) > 0.6).astype(np.float32)
    mask[5:20, 8:25] = 1.0
    want = np.asarray(jl.perturb_mask_device(key, jnp.asarray(mask)))
    shift = np.asarray(jax.random.randint(jax.random.split(key, 3)[1], (2,), -4, 5))
    got = tl.perturb_mask_device(_t(mask)[None], torch.tensor([branch]), _t(shift)[None].long())
    np.testing.assert_array_equal(got[0].numpy(), want)


def _soft_pastes(draws, consts, patch):
    """Each valid slot's pasted soft mask [B, Kv, H, W] (what the
    compositing thresholds at 0.5)."""
    img, masks, valid, _ = consts
    slots = [j for j in range(K) if valid[j]]
    _, m, dst, on = tl.object_patches(draws, img, masks, slots, patch)
    h, w = img.shape[1:]
    return torch.stack([paste_mask(m[:, i], dst[:, i], h, w) * on[i]
                        for i in range(len(slots))], 1)


@pytest.mark.parametrize("elastic,seed", [(0.0, 0), (0.0, 1), (1.0, 2), (1.0, 3)],
                         ids=["elastic_off-0", "elastic_off-1", "elastic_on-2", "elastic_on-3"])
def test_lucid_frame_matches_jax(elastic, seed):
    """lucid_frame at a 96×160 frame and patch 64 with the draws of a key,
    the elastic field forced off or on (elastic_prob 0 or 1)."""
    h, w, patch = 96, 160, 64
    c = _consts(h, w)
    key = jax.random.PRNGKey(seed)
    cj, mj = jl.lucid_frame(key, *_jax_consts(c), patch, elastic_prob=elastic)
    draws = _stack_lucid([_lucid_draws(key, K, h, w, patch, elastic)])
    assert bool(draws.elastic[0, :2].all()) == (elastic == 1.0)
    pc = _port_consts(c)
    ct, mt = tl.lucid_frames(draws, *pc, patch)
    ct, mt = ct[0].permute(1, 2, 0).numpy(), mt[0].numpy()
    cj, mj = np.asarray(cj), np.asarray(mj)
    differ = (mt != mj).any(0)
    if differ.any():
        soft = _soft_pastes(draws, pc, patch)[0].numpy()
        assert (np.abs(soft - 0.5) <= 1e-4).any(0)[differ].all()
    assert mt[:2].sum() > 0 and not mt[2].any()
    np.testing.assert_allclose(ct[~differ], cj[~differ], rtol=0, atol=1e-2)


def test_lucid_batch_device_matches_jax():
    """lucid_batch_device: 3 draws of a 96×160 frame at patch 64 (elastic
    probability 0.8). JAX's (lucid_frame over jax.random.split(key, 3))
    against the port's lucid_frames on the draws re-derived from the split
    keys, with lucid_frame's bounds; and the port's lucid_batch_device from
    a seeded generator equal to lucid_frames of sample_lucid_draws from
    the same seed."""
    h, w, patch, n = 96, 160, 64, 3
    c = _consts(h, w)
    key = jax.random.PRNGKey(5)
    cj, mj = jl.lucid_batch_device(key, *_jax_consts(c), n, patch)
    draws = _stack_lucid([_lucid_draws(k, K, h, w, patch) for k in jax.random.split(key, n)])
    pc = _port_consts(c)
    ct, mt = tl.lucid_frames(draws, *pc, patch)
    ct, mt = ct.permute(0, 2, 3, 1).numpy(), mt.numpy()
    cj, mj = np.asarray(cj), np.asarray(mj)
    differ = (mt != mj).any(1)
    if differ.any():
        soft = _soft_pastes(draws, pc, patch).numpy()
        assert (np.abs(soft - 0.5) <= 1e-4).any(1)[differ].all()
    assert mt[:, :2].sum() > 0 and not mt[:, 2].any()
    np.testing.assert_allclose(ct[~differ], cj[~differ], rtol=0, atol=1e-2)
    got = tl.lucid_batch_device(torch.Generator().manual_seed(9), *pc, n, patch)
    want = tl.lucid_frames(tl.sample_lucid_draws(torch.Generator().manual_seed(9), n, K, h, w,
                                                 patch), *pc, patch)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


# ------------------------------------------------------- the fused batches

@pytest.fixture(scope="module")
def refine_nets():
    """The tiny JAX DeepLabv3+ and its parameters, bridged into the port."""
    jm = JaxDeepLab(cfg=JREFINE)
    jp = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.zeros((1, 33, 33, 4)))
    tm = DeepLabV3Plus(TREFINE)
    load_flax_tree(tm, jax.tree.map(np.asarray, jp))
    return jm, jp, tm


@pytest.fixture(scope="module")
def refine_batch(refine_nets, mesh):
    """JAX's refine runner at the tiny size, a key, and the batch its
    `batch_loss` builds from that key: `one_example` (the runner's
    closure) under vmap over jax.random.split(key, batch_size), as
    batch_loss does, jitted."""
    jm, _, _ = refine_nets
    ft = jc.FinetuneConfig(**FT)
    runs, _ = jfused.build_refine_fused_runs(jm, mesh, (H, W), JREFINE, ft, K)
    batch_loss = _batch_loss(runs)
    one_example = _cells(batch_loss)["one_example"].cell_contents
    c = _jax_consts(_consts())
    key = jax.random.PRNGKey(11)
    keys = jax.random.split(key, ft.batch_size)
    examples = jax.jit(jax.vmap(lambda k: one_example(k, *c)))(keys)
    return batch_loss, key, list(keys), examples


def test_refine_examples_match_jax(refine_batch):
    """The refine batch from the draws of the keys against JAX's
    `one_example` on each key."""
    _, _, keys, (wx, wt, wok) = refine_batch
    draws = _refine_draws(keys, K, H, W, 32)
    x, tgt, ok = tl.refine_examples(draws, _port_consts(_consts()), 32, 33, JREFINE.box_margin,
                                    None)
    wx = np.asarray(wx)
    np.testing.assert_allclose(x[:, :3].permute(0, 2, 3, 1).numpy(), wx[..., :3], rtol=0, atol=1e-4)
    np.testing.assert_array_equal(x[:, 3].numpy(), wx[..., 3])
    np.testing.assert_array_equal(tgt.numpy(), np.asarray(wt))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(wok))
    assert bool(ok.all()) and (tgt.sum((1, 2)) > 0).all()


def test_proposal_batch_matches_jax(mesh):
    """The proposal batch from the draws of a key against the batch JAX's
    proposal `batch_loss` hands its loss (the loss swapped for one that
    returns its batch; jitted)."""
    jm = JaxMaskRCNN(cfg=JPROP)
    ft = jc.FinetuneConfig(**FT)
    runs, _ = jfused.build_proposal_fused_runs(jm, JPROP, mesh, (H, W), ft, K)
    batch_loss = _batch_loss(runs)
    _cells(batch_loss)["base_loss"].cell_contents = lambda p, b: b
    c = _consts()
    key = jax.random.PRNGKey(9)
    seen = [jax.jit(lambda k, cs: batch_loss(None, k, cs))(key, _jax_consts(c))]
    k1, k2 = jax.random.split(key)
    bs = ft.batch_size // 2
    lucid = _stack_lucid([_lucid_draws(k, K, H, W, 32) for k in jax.random.split(k1, bs)])
    seeds = np.asarray(jax.random.randint(k2, (bs,), 0, jnp.iinfo(jnp.int32).max))
    got = tl.proposal_batch(tl.ProposalDraws(lucid, _t(seeds)), _port_consts(c), 32)
    want = [np.asarray(x) for x in seen[0]]
    np.testing.assert_allclose(got[0].numpy(), want[0], rtol=0, atol=1e-4)
    for g, wnt, name in zip(got[1:4], want[1:4], ("boxes", "masks", "valid")):
        np.testing.assert_array_equal(g.numpy(), wnt, err_msg=name)
    np.testing.assert_array_equal(got[4].numpy(), want[4].astype(np.int64))
    assert want[3].sum() >= 2


@pytest.fixture(scope="module")
def refine_step(refine_nets, refine_batch):
    """One refine fine-tune step on both sides from the same key. JAX: the
    batch loss of its runner, sigmoid_xent of the model on the batch
    `one_example` builds (refine_batch; the examples do not depend on the
    parameters), under value_and_grad, then one optax Adam step. The port:
    its batch loss on the re-derived draws, its gradients and one torch
    Adam step."""
    from premvos_tpu.train.losses import sigmoid_xent as jax_sigmoid_xent

    jm, jp, tm = refine_nets
    batch_loss, key, keys, (xs, ys, oks) = refine_batch
    assert _cells(batch_loss)["sigmoid_xent"].cell_contents is jax_sigmoid_xent

    def loss_on_batch(p):  # batch_loss's loss, from fused.py
        logits = jm.apply(p, xs)
        msk = jnp.broadcast_to(oks[:, None, None], logits.shape).astype(jnp.float32)
        return jax_sigmoid_xent(logits, ys, mask=msk)

    vg = jax.jit(jax.value_and_grad(loss_on_batch))
    jloss, jgrads = vg(jp)
    tx = optax.adam(FT_LR)

    @jax.jit
    def adam_step(p, g):  # one jitted program (optax op by op compiles each leaf's)
        updates, _ = tx.update(g, tx.init(p), p)
        return optax.apply_updates(p, updates)

    jloss_after, _ = vg(adam_step(jp, jgrads))

    run = tfused.build_refine_fused_runs((H, W), TREFINE, tc.FinetuneConfig(**FT), K)
    draws = _refine_draws(keys, K, H, W, 32)
    module = copy.deepcopy(tm)
    consts = _port_consts(_consts())
    tloss = run.loss(module, run.batch(draws, consts))
    tloss.backward()
    grads = {n: p.grad.clone() for n, p in module.named_parameters()}
    state = create_train_state(module, FT_LR)
    state.optimizer.step()
    with torch.no_grad():
        tloss_after = run.loss(module, run.batch(draws, consts))
    return dict(jloss=float(jloss), tloss=tloss.item(), jloss_after=float(jloss_after),
                tloss_after=float(tloss_after), tgrads=grads,
                jgrads=flax_tensors(tm, jax.tree.map(np.asarray, jgrads)))


def test_refine_step_loss_matches_jax(refine_step):
    r = refine_step
    assert np.isfinite(r["tloss"]) and r["tloss"] > 0
    assert abs(r["tloss"] - r["jloss"]) <= 1e-5 * abs(r["jloss"]), (r["tloss"], r["jloss"])


def test_refine_step_gradients_match_jax(refine_step):
    """Every parameter's gradient within 1e-4 of its largest |grad|."""
    jg, tg = refine_step["jgrads"], refine_step["tgrads"]
    assert set(tg) == {n for n in jg if not n.endswith((".mean", ".var"))}
    for name, g in tg.items():
        want = jg[name].numpy()
        scale = max(float(np.abs(want).max()), 1e-12)
        err = float(np.abs(g.numpy() - want).max())
        assert err <= 1e-4 * scale, f"{name}: max |diff| {err} > 1e-4 * {scale}"


def test_refine_step_loss_after_adam_matches_jax(refine_step):
    r = refine_step
    assert abs(r["tloss_after"] - r["jloss_after"]) <= 1e-4 * abs(r["jloss_after"])
    assert r["tloss_after"] != r["tloss"]


# ------------------------------------------------------------ host routines

def _frame_and_labels(h, w):
    """A smooth textured frame and labels with an object in the middle, one
    at the top-left corner and one on the left edge (OpenCV indexes the
    image's first rows and columns apart)."""
    rng = np.random.default_rng(3)
    yy, xx = np.mgrid[0:h, 0:w]
    img = np.stack([128 + 60 * np.sin(xx / 7.0), 128 + 60 * np.cos(yy / 5.0),
                    128 + 40 * np.sin((xx + yy) / 11.0)], -1)
    img = np.clip(img + rng.normal(0, 10, img.shape), 0, 255).astype(np.uint8)
    lab = np.zeros((h, w), np.int32)
    lab[h // 4:h // 2, w // 3:2 * w // 3] = 1
    lab[0:5, 0:9] = 2
    lab[h // 2:h - 10, 0:3] = 3
    return img, lab


def test_inpaint_background_matches_cv2():
    cv2 = pytest.importorskip("cv2")
    img, lab = _frame_and_labels(64, 96)
    mask = cv2.dilate((lab > 0).astype(np.uint8), np.ones((5, 5), np.uint8))
    want = cv2.inpaint(img, mask, 5, cv2.INPAINT_TELEA)
    got = inpaint_background(img, lab)
    assert got.dtype == np.uint8 and got.shape == img.shape
    np.testing.assert_array_equal(got[mask == 0], img[mask == 0])
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("src,dst", [((480, 864), (256, 448)), ((96, 160), (64, 96)),
                                     ((64, 96), (32, 48)), ((37, 51), (10, 13))])
def test_host_resizes_match_cv2(src, dst):
    """Area resize within one uint8 level (measured: equal), nearest equal;
    the first pair is the proposal fine-tune's 480×864 → 256×448 (1.875×,
    1.93×), the third an integer factor."""
    cv2 = pytest.importorskip("cv2")
    rng = np.random.default_rng(sum(src))
    img = rng.integers(0, 256, (*src, 3)).astype(np.uint8)
    want = cv2.resize(img, dst[::-1], interpolation=cv2.INTER_AREA)
    got = resize_area_u8(img, dst)
    assert got.dtype == np.uint8 and got.shape == want.shape
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
    lab = rng.integers(0, 9, src).astype(np.int32)
    np.testing.assert_array_equal(
        resize_nearest(lab, dst), cv2.resize(lab, dst[::-1], interpolation=cv2.INTER_NEAREST))


# ------------------------------------------------------------- end to end

def test_proposal_finetune_hw_matches_jax():
    for hw in [(480, 864), (96, 128), (64, 96), (720, 1280)]:
        for scale in (0.5, 0.25, 1.0):
            assert tfused.proposal_finetune_hw(hw, tc.FinetuneConfig(proposal_scale=scale)) == \
                jfused.proposal_finetune_hw(hw, jc.FinetuneConfig(proposal_scale=scale))
    assert tfused.proposal_finetune_hw((480, 864), tc.FinetuneConfig()) == (256, 448)


TINY = tc.PremvosConfig(
    proposal=tc._from_dict(tc.ProposalConfig, dataclasses.asdict(JPROP)),
    refine=TREFINE,
    flow=tc.FlowConfig(variant="flownet2", max_displacement=4, infer_height=64, infer_width=64),
    reid=tc.ReIDConfig(backbone_depth=26, embedding_dim=8, crop_size=32),
    pipeline=tc.PipelineConfig(image_height=96, image_width=128, max_objects=2,
                               max_proposals=4, dtype="float32", scan_chunk=2),
    finetune=tc.FinetuneConfig(steps=3, chunk=2, batch_size=2, aug_patch=32),
)


def _state(module):
    return {k: v.clone() for k, v in module.state_dict().items()}


def _tiny_models():
    """The tiny proposal and refine nets from seed 0; flow and ReID play no
    part in the fine-tune: small stand-ins that must come back as they went
    in."""
    gen = torch.Generator().manual_seed(0)
    nets = tr.build_models(TINY, device="cpu")
    for net in (nets.maskrcnn, nets.refine):
        init_module(net, gen)
    return nets._replace(flow=torch.nn.Linear(2, 2), reid=torch.nn.Linear(2, 2))


def test_finetune_video_fused_tiny_cpu():
    """Three steps in chunks of 2 and 1 on the CPU: finite losses, the
    refine and proposal nets changed, flow and ReID the same modules, and
    the caller's models untouched."""
    models = _tiny_models()
    before = {name: _state(getattr(models, name)) for name in models._fields}
    img, lab = _frame_and_labels(96, 128)
    stats = {}
    new, losses = tfused.finetune_video_fused(models, img, lab, TINY, device="cpu", stats=stats)
    assert set(losses) == {"refine", "proposal"}
    assert all(np.isfinite(v) for v in losses.values())
    assert [n for n, _, _ in stats["refine"]["chunks"]] == [2, 1]
    assert stats["proposal"]["chunks"][-1][2] == losses["proposal"]
    assert stats["inpaint_s"] > 0
    assert new.flow is models.flow and new.reid is models.reid
    for name in models._fields:
        for k, v in _state(getattr(models, name)).items():
            assert torch.equal(v, before[name][k]), f"caller's {name}.{k} changed"
    for name in ("refine", "maskrcnn"):
        after = _state(getattr(new, name))
        assert any(not torch.equal(after[k], v) for k, v in before[name].items()), name


def test_finetune_video_built_runner_same_losses():
    """finetune_video given build_fused_runner's runs (`built`, which also
    sets the proposal net's size) returns the losses it returns without
    them."""
    models = _tiny_models()
    img, lab = _frame_and_labels(96, 128)
    ft = dataclasses.replace(TINY.finetune, steps=2)
    built = tfused.build_fused_runner(models, TINY, ft, device="cpu")
    assert built["proposal_hw"] == built["proposal"].image_hw == \
        tfused.proposal_finetune_hw((96, 128), ft)
    _, want = tfused.finetune_video(models, img, lab, TINY, ft, device="cpu")
    _, got = tfused.finetune_video(models, img, lab, TINY, ft, built=built, device="cpu")
    assert got == want


def test_finetune_video_methods(monkeypatch):
    """"pool" goes to finetune_video_pool (held against the JAX package in
    tests/test_torch_pool_finetune.py); an unknown method raises."""
    models = tr.Models(None, None, None, None)
    called = []
    monkeypatch.setattr(tfused, "finetune_video_pool", lambda *a, **k: called.append(a) or "pool")
    assert tfused.finetune_video(models, None, None, TINY, dataclasses.replace(
        TINY.finetune, method="pool"), device="cpu") == "pool"
    assert len(called) == 1 and called[0][0] is models
    with pytest.raises(ValueError, match="unknown"):
        tfused.finetune_video(models, None, None, TINY, dataclasses.replace(
            TINY.finetune, method="other"), device="cpu")


def test_finetune_needs_cuda_or_explicit_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tfused.finetune_video_fused(None, np.zeros((8, 8, 3), np.uint8),
                                    np.zeros((8, 8), np.int32), TINY)


# ------------------------------------------- the kernels' gradient refusal

@pytest.mark.parametrize("op", ["resample2d", "correlation"])
def test_forward_only_kernels_refuse_grad_first(op):
    """resample2d_cuda has no backward: with grad enabled, given an input
    that requires grad, it raises before anything else (here: before it
    finds CPU tensors); without grad it goes on to the device check.
    correlation_cuda has a backward: with grad enabled it, too, goes on to
    the device check."""
    from premvos_tpu_torch.ops import correlation, resample2d

    if op == "resample2d":
        fn, args = resample2d.resample2d_cuda, (torch.zeros(1, 3, 6, 6), torch.zeros(1, 2, 6, 6))
    else:
        fn, args = correlation.correlation_cuda, (torch.zeros(1, 4, 6, 6), torch.zeros(1, 4, 6, 6))
    leaf = args[0].clone().requires_grad_(True)
    if op == "resample2d":
        with pytest.raises(ValueError, match="no backward"):
            fn(leaf, *args[1:])
    else:
        with pytest.raises(ValueError, match="CUDA device"):
            fn(leaf, *args[1:])
    with torch.no_grad(), pytest.raises(ValueError, match="CUDA device"):
        fn(leaf, *args[1:])
    with pytest.raises(ValueError, match="CUDA device"):
        fn(*args)
