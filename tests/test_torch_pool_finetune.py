"""The port's host-pool fine-tune (`FinetuneConfig.method "pool"`) vs the JAX
package, on the CPU, and its OpenCV-free image routines vs OpenCV.

The JAX package builds its lucid pool with OpenCV; the port with
data/cv_compat.py. Each routine is held against `cv2` where OpenCV is
installed (the tests skip without it), the lucid generator and the refine examples
against the JAX package on the same numpy generator, and the fine-tune
itself against the JAX package's `finetune_video(method="pool")` on bridged
weights (tiny nets, 96×128 frames), with the JAX package's pool-step draws
(PRNGKey(seed) folded with the step) fed to the port. One JAX run of the
fine-tune serves every comparison: its pool, its examples and its compiled
pool steps are captured (the JAX package's `build_lucid_pool` and
`make_pool_train_step` wrapped, not changed) and stepped again from a fresh
state for the one-step checks.

Tolerances, each measured first:
  * getRotationMatrix2D, the nearest warps, dilate / erode (k = 1..5) and
    the uint8 INTER_LINEAR resize: exact;
  * the bilinear warpAffine and remap: at most one level, at least 99.5 %
    of values equal (OpenCV interpolates in float32 with fused
    multiply-adds; a rare value lands one level apart);
  * GaussianBlur (float32): 1e-6;
  * lucid_dream / lucid_batch from the same generator and background:
    labels at least 99.5 % equal, image values within 2 levels on at least
    99 %, and the generator's next draw equal (the draw order is the JAX
    package's); measured on the three seeds of the test: every label and
    value equal;
  * perturb_mask exact; make_refine_examples on the same pool: crops 1e-6,
    targets equal;
  * one pool step of each net from the JAX package's draws: loss 1e-5
    relative (tests/test_torch_train.py's bound), every parameter after the
    Adam step within 1e-4 of its L2 norm (`_assert_params_close`);
  * finetune_video(method="pool"), 2 steps, each side building its own
    pool: both losses 1e-4 relative;
  * finetune_refine_videos, V = 2, each side its own pools (equal here):
    the last losses 1e-4 relative at the default learning rate (1e-4; at
    1e-3 one Adam step turns the frameworks' float32 differences into
    1.6e-4); each video's copy equal to its own single run.
"""

import dataclasses
import os
import subprocess
import sys

import flax
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh

import premvos_tpu.config as jc
import premvos_tpu.data.lucid as jlucid
import premvos_tpu.finetune.finetune as jft
from premvos_tpu.finetune import fused as jfused
from premvos_tpu.finetune import multi_video as jmv
from premvos_tpu.models.anchors import pyramid_anchors as jax_pyramid_anchors
from premvos_tpu.models.deeplab import DeepLabV3Plus as JaxDeepLab
from premvos_tpu.models.maskrcnn import MaskRCNN as JaxMaskRCNN
from premvos_tpu.pipeline import runner as jrunner
from premvos_tpu.train.trainer import create_train_state as jax_train_state
from premvos_tpu.train.trainer import replicate_state
from premvos_tpu_torch import config as tc
from premvos_tpu_torch.bridge import flax_tensors, load_flax_tree
from premvos_tpu_torch.data import cv_compat as cc
from premvos_tpu_torch.data import lucid as tlucid
from premvos_tpu_torch.finetune import finetune as tft
from premvos_tpu_torch.finetune import fused as tfused
from premvos_tpu_torch.finetune import multi_video as tmv
from premvos_tpu_torch.models.deeplab import DeepLabV3Plus
from premvos_tpu_torch.models.layers import init_module
from premvos_tpu_torch.models.maskrcnn import MaskRCNN
from premvos_tpu_torch.pipeline import runner as trunner
from premvos_tpu_torch.train.trainer import PoolDraws
from tests._threads import few_threads  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H, W = 96, 128
SEED = 0
JREFINE = jc.RefineConfig(crop_size=33, backbone_depth=26, box_margin=6.0)
JPROP = jc.ProposalConfig(backbone_depth=26, fpn_channels=32, rpn_pre_nms_topk=64,
                          rpn_post_nms_topk=16, detections_per_frame=8)
JFT = jc.FinetuneConfig(steps=2, chunk=2, batch_size=2, method="pool", num_augmentations=4)
JCFG = jc.PremvosConfig(
    proposal=JPROP, refine=JREFINE,
    pipeline=jc.PipelineConfig(image_height=H, image_width=W, max_objects=2, max_proposals=4,
                               dtype="float32", scan_chunk=2),
    finetune=JFT,
)
TCFG = tc._from_dict(tc.PremvosConfig, dataclasses.asdict(JCFG))


def _frame_and_labels(h=H, w=W, seed=3):
    """A textured frame with two objects, one at the left edge (the warps'
    borders), and their labels."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    img = np.stack([128 + 60 * np.sin(xx / 7.0), 128 + 60 * np.cos(yy / 5.0),
                    128 + 40 * np.sin((xx + yy) / 11.0)], -1)
    img = np.clip(img + rng.normal(0, 10, img.shape), 0, 255).astype(np.uint8)
    lab = np.zeros((h, w), np.int32)
    lab[h // 4:h // 2 + 8, w // 3:2 * w // 3] = 1
    lab[h // 2:h - 10, 0:w // 5] = 2
    return img, lab


def _affine(rng, h, w, max_rot=15.0, max_shift=0.1):
    """A matrix as data/lucid.py's `_rand_affine` makes them."""
    m = cc.rotation_matrix_2d((w / 2, h / 2), rng.uniform(-max_rot, max_rot),
                              rng.uniform(0.9, 1.1))
    m[0, 2] += rng.uniform(-max_shift, max_shift) * w
    m[1, 2] += rng.uniform(-max_shift, max_shift) * h
    return m


def _level_diffs(want, got):
    d = np.abs(want.astype(np.int64) - got.astype(np.int64))
    return int(d.max()), float((d == 0).mean())


# ------------------------------------------------------- OpenCV routines

@pytest.mark.parametrize("center,angle,scale", [((64, 48), 7.5, 1.05), ((432.0, 240.0), -14.9, 0.9),
                                                ((16.5, 8.0), 0.0, 1.0)])
def test_rotation_matrix_matches_cv2(center, angle, scale):
    cv2 = pytest.importorskip("cv2")
    np.testing.assert_array_equal(cc.rotation_matrix_2d(center, angle, scale),
                                  cv2.getRotationMatrix2D(center, angle, scale))


@pytest.mark.parametrize("border", ["reflect", "constant"])
@pytest.mark.parametrize("hw", [(240, 432), (57, 83)])
def test_warp_affine_linear_matches_cv2(border, hw):
    cv2 = pytest.importorskip("cv2")
    rng = np.random.default_rng(hw[0])
    h, w = hw
    for _ in range(3):
        img = rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
        m = _affine(rng, h, w)
        mode = cv2.BORDER_REFLECT if border == "reflect" else cv2.BORDER_CONSTANT
        worst, equal = _level_diffs(cv2.warpAffine(img, m, (w, h), borderMode=mode),
                                    cc.warp_affine(img, m, (w, h), border=border))
        assert worst <= 1 and equal >= 0.995, (worst, equal)


def test_warp_affine_nearest_matches_cv2():
    cv2 = pytest.importorskip("cv2")
    rng = np.random.default_rng(1)
    for h, w in [(240, 432), (96, 128), (37, 61)]:
        mask = (rng.uniform(size=(h, w)) < 0.5).astype(np.uint8)
        for _ in range(3):
            m = _affine(rng, h, w)
            np.testing.assert_array_equal(
                cc.warp_affine(mask, m, (w, h), "nearest"),
                cv2.warpAffine(mask, m, (w, h), flags=cv2.INTER_NEAREST))


def test_warp_affine_region_is_the_full_warp_there():
    """A window of the output equals the whole warp on it, 0 elsewhere."""
    rng = np.random.default_rng(2)
    img = rng.integers(0, 256, (60, 80, 3)).astype(np.uint8)
    m = _affine(rng, 60, 80)
    full = cc.warp_affine(img, m, (80, 60))
    part = cc.warp_affine(img, m, (80, 60), region=(10, 35, 5, 70))
    np.testing.assert_array_equal(part[10:35, 5:70], full[10:35, 5:70])
    part[10:35, 5:70] = 0
    assert not part.any()


def _elastic_case(rng, h, w):
    """Sample maps as the elastic deformation makes them (data/lucid.py),
    from cv2's blur and resize."""
    import cv2

    sh, sw = max(h // 8, 4), max(w // 8, 4)
    d = [cv2.resize(cv2.GaussianBlur(rng.uniform(-1, 1, (sh, sw)).astype(np.float32),
                                     (0, 0), 1.5) * 8.0, (w, h)) for _ in range(2)]
    xx, yy = np.meshgrid(np.arange(w, dtype=np.float32), np.arange(h, dtype=np.float32))
    return xx + d[0], yy + d[1]


@pytest.mark.parametrize("interp", ["linear", "nearest"])
def test_remap_matches_cv2(interp):
    cv2 = pytest.importorskip("cv2")
    rng = np.random.default_rng(4)
    for h, w in [(240, 432), (96, 128)]:
        mx, my = _elastic_case(rng, h, w)
        if interp == "linear":
            img = rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
            worst, equal = _level_diffs(
                cv2.remap(img, mx, my, cv2.INTER_LINEAR, borderMode=cv2.BORDER_REFLECT),
                cc.remap(img, mx, my, "linear", "reflect"))
            assert worst <= 1 and equal >= 0.995, (worst, equal)
        else:
            mask = (rng.uniform(size=(h, w)) < 0.5).astype(np.uint8)
            np.testing.assert_array_equal(cc.remap(mask, mx, my, "nearest"),
                                          cv2.remap(mask, mx, my, cv2.INTER_NEAREST))


@pytest.mark.parametrize("hw", [(60, 108), (12, 16), (4, 4)])
@pytest.mark.parametrize("sigma", [1.5, 0.8])
def test_gaussian_blur_matches_cv2(hw, sigma):
    cv2 = pytest.importorskip("cv2")
    x = np.random.default_rng(5).uniform(-1, 1, hw).astype(np.float32)
    got = cc.gaussian_blur(x, sigma)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, cv2.GaussianBlur(x, (0, 0), sigma), rtol=0, atol=1e-6)


@pytest.mark.parametrize("k", [1, 2, 3, 4, 5])
def test_dilate_erode_match_cv2(k):
    """Random masks, a single point, and a block at the corner: an even k
    spreads towards +1, and pixels off the image never win."""
    cv2 = pytest.importorskip("cv2")
    rng = np.random.default_rng(k)
    point = np.zeros((12, 12), np.uint8)
    point[4, 4] = 1
    corner = np.zeros((12, 12), np.uint8)
    corner[:6, :6] = 1
    for m in [(rng.uniform(size=(37, 51)) < 0.3).astype(np.uint8), point, corner]:
        kernel = np.ones((k, k), np.uint8)
        np.testing.assert_array_equal(cc.dilate(m, k), cv2.dilate(m, kernel))
        np.testing.assert_array_equal(cc.erode(m, k), cv2.erode(m, kernel))
    if k == 2:
        assert cc.dilate(point, 2)[4:6, 4:6].all() and cc.dilate(point, 2).sum() == 4
    if k == 3:  # the border side of the block is not eroded
        assert cc.erode(corner, 3)[:5, :5].all() and cc.erode(corner, 3).sum() == 25


@pytest.mark.parametrize("src,dst", [((120, 180), (33, 33)), ((57, 83), (385, 385)),
                                     ((64, 96), (32, 48)), ((40, 40), (40, 40)),
                                     ((147, 24), (33, 33)), ((9, 300), (91, 17))])
@pytest.mark.parametrize("channels", [3, 1])
def test_resize_linear_u8_matches_cv2(src, dst, channels):
    """Shrinks and enlargements, an exact 2× shrink (OpenCV's INTER_AREA
    shortcut) and a copy; rows and columns whose taps clamp at the edges."""
    cv2 = pytest.importorskip("cv2")
    rng = np.random.default_rng(sum(src) + channels)
    shape = src + ((3,) if channels == 3 else ())
    img = rng.integers(0, 256, shape).astype(np.uint8)
    got = cc.resize_linear_u8(img, dst)
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, cv2.resize(img, dst[::-1]))


# ------------------------------------------------------------ lucid pool

def test_elastic_maps_match_jax():
    """The sample maps from the same generator: 1e-4 (float32 positions up
    to the frame's width), and the same draws."""
    a, b = np.random.default_rng(6), np.random.default_rng(6)
    jx, jy = jlucid._elastic_maps(a, H, W)
    tx, ty = tlucid._elastic_maps(b, H, W)
    np.testing.assert_allclose(tx, jx, rtol=0, atol=1e-4)
    np.testing.assert_allclose(ty, jy, rtol=0, atol=1e-4)
    wx, wy = tlucid._elastic_maps(np.random.default_rng(6), H, W, window=(10, 50, 20, 90))
    np.testing.assert_array_equal(wx, tx[10:50, 20:90])
    np.testing.assert_array_equal(wy, ty[10:50, 20:90])
    assert a.uniform() == b.uniform()


def _lucid_agree(want, got):
    (wi, wl), (ti, tl) = want, got
    assert ti.dtype == wi.dtype and tl.dtype == wl.dtype and ti.shape == wi.shape
    assert (tl == wl).mean() >= 0.995
    d = np.abs(ti.astype(np.int64) - wi.astype(np.int64))
    assert (d <= 2).mean() >= 0.99, (d.max(), (d <= 2).mean())
    return (tl == wl).mean(), (d == 0).mean()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_lucid_dream_matches_jax(seed):
    img, lab = _frame_and_labels()
    bg = tlucid.inpaint_background(img, lab)
    a, b = np.random.default_rng(seed), np.random.default_rng(seed)
    _lucid_agree(jlucid.lucid_dream(img, lab, a, bg), tlucid.lucid_dream(img, lab, b, bg))
    assert a.uniform() == b.uniform()


def test_lucid_batch_matches_jax():
    """Eight augmentations, the background inpainted inside."""
    img, lab = _frame_and_labels()
    a, b = np.random.default_rng(7), np.random.default_rng(7)
    want = jlucid.lucid_batch(img, lab, a, 8)
    got = tlucid.lucid_batch(img, lab, b, 8)
    assert got[0].shape == (8, H, W, 3) and got[1].shape == (8, H, W)
    _lucid_agree(want, got)
    assert a.uniform() == b.uniform()


def test_elastic_deform_matches_jax_where_the_mask_lands():
    """The mask equal everywhere; the image where the warped mask is set."""
    img, lab = _frame_and_labels()
    fg = img * (lab == 1)[..., None].astype(np.uint8)
    a, b = np.random.default_rng(8), np.random.default_rng(8)
    ji, jm = jlucid.elastic_deform(fg, (lab == 1).astype(np.uint8), a)
    ti, tm = tlucid.elastic_deform(fg, (lab == 1).astype(np.uint8), b)
    np.testing.assert_array_equal(tm, jm)
    sel = jm.astype(bool)
    assert sel.sum() > 100
    assert np.abs(ti[sel].astype(int) - ji[sel].astype(int)).max() <= 1
    assert a.uniform() == b.uniform()


@pytest.mark.parametrize("seed", range(6))
def test_perturb_mask_matches_jax(seed):
    _, lab = _frame_and_labels()
    m = (lab == 1).astype(np.float32)
    a, b = np.random.default_rng(seed), np.random.default_rng(seed)
    got = tft.perturb_mask(m, b)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, jft.perturb_mask(m, a))
    assert a.uniform() == b.uniform()


def test_pool_size_matches_jax():
    for steps, n_aug in [(40, 2500), (500, 2500), (2, 4), (100, 80)]:
        ft = tc.FinetuneConfig(steps=steps, num_augmentations=n_aug)
        assert tft.pool_size(ft) == min(n_aug, max(steps, 64))


# ------------------------------------------------------ the fine-tune

def _jax_draws(seed=SEED):
    """The JAX package's pool-step draws (trainer.py:126-137): step i's rows
    randint(fold_in(PRNGKey(seed), i), (bs,), 0, pool_n) and its salt
    randint(fold_in(that key, 1), (), 0, 2³¹ − 1); as a `draw` for the port."""

    def draw(gen, steps, pool_n, bs):
        idx, salt = [], []
        for i in range(steps):
            key = jax.random.fold_in(jax.random.PRNGKey(seed), i)
            idx.append(np.asarray(jax.random.randint(key, (bs,), 0, pool_n)))
            salt.append(int(jax.random.randint(jax.random.fold_in(key, 1), (), 0,
                                               jnp.iinfo(jnp.int32).max, dtype=jnp.int32)))
        return PoolDraws(torch.from_numpy(np.stack(idx).astype(np.int64)),
                         torch.tensor(salt, dtype=torch.int64))

    return draw


@pytest.fixture(scope="module")
def jax_nets():
    """The tiny JAX refine and proposal nets (the RPN delta head zeroed: the
    proposals are then the clipped anchors, exactly, on both sides) and
    their parameters bridged into the port's modules."""
    jr, jm = JaxDeepLab(cfg=JREFINE), JaxMaskRCNN(cfg=JPROP)
    anchors = {k: jnp.asarray(v) for k, v in
               jax_pyramid_anchors(H, W, JPROP.anchor_scales, JPROP.anchor_ratios).items()}
    pr = jax.jit(jr.init)(jax.random.PRNGKey(0), jnp.zeros((1, 33, 33, 4)))
    pm = flax.core.unfreeze(jax.jit(jm.init)(jax.random.PRNGKey(1), jnp.zeros((1, H, W, 3)),
                                             anchors))
    pm["params"]["rpn"]["Conv_2"] = jax.tree.map(jnp.zeros_like, pm["params"]["rpn"]["Conv_2"])
    tr, tm = DeepLabV3Plus(TCFG.refine), MaskRCNN(TCFG.proposal)
    load_flax_tree(tr, jax.tree.map(np.asarray, pr))
    load_flax_tree(tm, jax.tree.map(np.asarray, pm))
    models = jrunner.Models(maskrcnn=jm, refine=jr, flow=None, reid=None)
    tmodels = trunner.Models(maskrcnn=tm, refine=tr, flow=torch.nn.Linear(2, 2),
                             reid=torch.nn.Linear(2, 2))
    return models, {"refine": pr, "maskrcnn": pm}, tmodels


@pytest.fixture(scope="module")
def jax_pool_run(jax_nets):
    """The JAX package's finetune_video(method="pool"), 2 steps, with its
    pool and its two compiled pool steps captured: `steps` maps "refine"
    and "proposal" to (run, pool on the device, batch size)."""
    models, params, _ = jax_nets
    mesh = Mesh(np.array(jax.devices()[:1]), ("data",))
    seen = {"pool": [], "steps": []}
    build, make_step = jft.build_lucid_pool, jft.make_pool_train_step

    def build_spy(*a, **k):
        seen["pool"].append(build(*a, **k))
        return seen["pool"][-1]

    def make_step_spy(*a, **k):
        run, pool_d = make_step(*a, **k)
        seen["steps"].append((run, pool_d, run.batch_size))
        return run, pool_d

    img, lab = _frame_and_labels()
    mp = pytest.MonkeyPatch()
    mp.setattr(jft, "build_lucid_pool", build_spy)
    mp.setattr(jft, "make_pool_train_step", make_step_spy)
    try:
        new, losses = jfused.finetune_video(models, params, img, lab, mesh, JCFG)
    finally:
        mp.undo()
    assert len(seen["pool"]) == 1 and len(seen["steps"]) == 2
    return dict(mesh=mesh, img=img, lab=lab, params=params, new=new, losses=losses,
                pool=seen["pool"][0], steps=dict(zip(("refine", "proposal"), seen["steps"])))


def test_build_lucid_pool_matches_jax(jax_pool_run):
    img, lab = jax_pool_run["img"], jax_pool_run["lab"]
    got = tft.build_lucid_pool(img, lab, TCFG.finetune, seed=SEED)
    assert len(got[0]) == tft.pool_size(TCFG.finetune) == 4
    _lucid_agree(jax_pool_run["pool"], got)


def test_make_refine_examples_matches_jax(jax_pool_run):
    """On the JAX package's pool, from one generator each: crops 1e-6,
    targets equal, the next draw equal."""
    imgs, labs = jax_pool_run["pool"]
    a, b = np.random.default_rng(5), np.random.default_rng(5)
    jc_, jt = jft.make_refine_examples(imgs, labs, 33, JREFINE.box_margin, a)
    tc_, tt = tft.make_refine_examples(imgs, labs, 33, JREFINE.box_margin, b)
    assert tc_.shape == jc_.shape and len(tc_) >= 4 and tc_.dtype == np.float32
    np.testing.assert_allclose(tc_, jc_, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(tt, jt)
    assert a.uniform() == b.uniform()


def test_make_refine_examples_draws_before_the_size_check():
    """An object whose jittered box is too small draws its jitter and is
    skipped; one with fewer than 4 pixels draws nothing."""
    lab = np.zeros((1, 40, 40), np.int32)
    lab[0, 5:7, 5:7] = 1  # 4 pixels: jitter drawn, box 2 + margin 0 < 8
    lab[0, 20, 20] = 2  # 1 pixel: skipped before any draw
    img = np.zeros((1, 40, 40, 3), np.uint8)
    a, b = np.random.default_rng(9), np.random.default_rng(9)
    got = tft.make_refine_examples(img, lab, 9, 0.0, b)
    want = jft.make_refine_examples(img, lab, 9, 0.0, a)
    assert got[0].shape == want[0].shape == (0, 9, 9, 4)
    assert a.uniform() == b.uniform()


def _jax_one_step(run_pool, params, mesh):
    """One step of a captured JAX pool step from a fresh Adam state: (loss,
    parameters after the step)."""
    run, pool_d, _ = run_pool
    state = replicate_state(jax_train_state(params, optax.adam(JFT.learning_rate)), mesh)
    state, loss = run(state, pool_d, jax.random.PRNGKey(SEED))
    return float(loss), state.params


def _assert_params_close(module, jparams):
    """Each parameter after the Adam step within 1e-4 of its norm, in the
    L2 norm: Adam divides each element's gradient by its own √v, so an
    element whose gradient is near zero turns float32 noise into a large
    share of a step (measured: up to 5e-4 of a weight's largest |value|
    element-wise; 3.8e-5 of its norm at most)."""
    want = flax_tensors(module, jax.tree.map(np.asarray, jparams))
    for name, p in module.named_parameters():
        w = want[name].numpy()
        err = float(np.linalg.norm(p.detach().numpy() - w))
        assert err <= 1e-4 * float(np.linalg.norm(w)), (name, err, float(np.linalg.norm(w)))


def test_pool_refine_step_matches_jax(jax_pool_run, jax_nets):
    """One step of the refine fine-tune on the JAX package's pool with its
    draws: the loss 1e-5 relative, the parameters after Adam 1e-4."""
    _, _, tmodels = jax_nets
    jloss, jparams = _jax_one_step(jax_pool_run["steps"]["refine"],
                                   jax_pool_run["params"]["refine"], jax_pool_run["mesh"])
    ft = dataclasses.replace(TCFG.finetune, steps=1)
    stats = {}
    module, loss = tft.finetune_refine(tmodels.refine, None, None, TCFG.refine, ft, seed=SEED,
                                       pool=jax_pool_run["pool"], draw=_jax_draws(), stats=stats)
    assert stats["examples"] == len(jax.tree.leaves(jax_pool_run["steps"]["refine"][1])[0])
    assert module is not tmodels.refine
    assert abs(loss - jloss) <= 1e-5 * abs(jloss), (loss, jloss)
    _assert_params_close(module, jparams)


def test_pool_proposal_step_matches_jax(jax_pool_run, jax_nets):
    """One step of the proposal fine-tune on the JAX package's pool with its
    draws and salts: the loss 1e-5 relative, the parameters after Adam
    1e-4."""
    _, _, tmodels = jax_nets
    jloss, jparams = _jax_one_step(jax_pool_run["steps"]["proposal"],
                                   jax_pool_run["params"]["maskrcnn"], jax_pool_run["mesh"])
    ft = dataclasses.replace(TCFG.finetune, steps=1)
    module, loss = tft.finetune_proposals(
        tmodels.maskrcnn, trunner.get_anchors(TCFG, "cpu"), TCFG.proposal, jax_pool_run["img"],
        jax_pool_run["lab"], ft, seed=SEED, max_objects=2, pool=jax_pool_run["pool"],
        draw=_jax_draws())
    assert abs(loss - jloss) <= 1e-5 * abs(jloss), (loss, jloss)
    _assert_params_close(module, jparams)


def test_pool_seeds_are_salted_mod_2_32():
    """The proposal batch's per-item seeds: the pool item's seed (drawn
    after the pool from default_rng(seed)) plus the step's salt, wrapping
    mod 2³², as the JAX package's uint32 add. The net's weights are drawn
    from a seed: left as torch.empty gives them, they held whatever an
    earlier test had left in that memory, and NaN boxes then failed the
    RoIAlign's gather."""
    seen = []
    ft = tc.FinetuneConfig(steps=2, batch_size=2, chunk=1)
    model = MaskRCNN(TCFG.proposal)
    init_module(model, torch.Generator().manual_seed(0))
    img, lab = _frame_and_labels()
    pool = (np.stack([img] * 3), np.stack([lab] * 3))

    def draw(gen, steps, pool_n, bs):
        return PoolDraws(torch.tensor([[2], [1]]), torch.tensor([2**31 - 2, 5]))

    def loss_spy(*a, **k):
        base = real(*a, **k)

        def loss_fn(batch):
            seen.append(batch[4])
            return base(batch)

        return loss_fn

    real = tft.maskrcnn_loss_fn
    mp = pytest.MonkeyPatch()
    mp.setattr(tft, "maskrcnn_loss_fn", loss_spy)
    try:
        tft.finetune_proposals(model, trunner.get_anchors(TCFG, "cpu"), TCFG.proposal, img, lab,
                               ft, seed=3, max_objects=2, pool=pool, draw=draw)
    finally:
        mp.undo()
    seeds = np.random.default_rng(3).integers(0, 2**31 - 1, size=3).astype(np.uint32)
    assert [s.dtype for s in seen] == [np.uint32, np.uint32]
    assert int(seen[0][0]) == (int(seeds[2]) + 2**31 - 2) % 2**32
    assert int(seen[1][0]) == (int(seeds[1]) + 5) % 2**32


def test_finetune_video_pool_matches_jax(jax_pool_run, jax_nets, monkeypatch):
    """Both nets, 2 steps, each side building its own pool from the same
    seed, the port fed the JAX package's pool-step draws (in place of its
    default draw): both losses 1e-4 relative; the caller's modules
    untouched, flow and ReID passed through."""
    _, _, tmodels = jax_nets
    before = {k: v.clone() for k, v in tmodels.refine.state_dict().items()}
    stats = {}
    monkeypatch.setattr(tft, "sample_pool_draws", _jax_draws())
    new, losses = tfused.finetune_video(tmodels, jax_pool_run["img"], jax_pool_run["lab"], TCFG,
                                        device="cpu", stats=stats)
    want = jax_pool_run["losses"]
    for net in ("refine", "proposal"):
        assert np.isfinite(losses[net])
        assert abs(losses[net] - want[net]) <= 1e-4 * abs(want[net]), (net, losses, want)
    assert stats["pool_s"] > 0 and stats["refine"]["examples_s"] > 0
    assert [c[0] for c in stats["proposal"]["chunks"]] == [2]
    assert new.flow is tmodels.flow and new.reid is tmodels.reid
    for k, v in tmodels.refine.state_dict().items():
        assert torch.equal(v, before[k])
    assert any(not torch.equal(a, b) for a, b in zip(new.refine.parameters(),
                                                     tmodels.refine.parameters()))


def test_finetune_refine_without_examples_returns_the_model():
    """No object, no example: the caller's module and NaN."""
    model = torch.nn.Conv2d(4, 1, 1)
    empty = (np.zeros((2, 20, 20, 3), np.uint8), np.zeros((2, 20, 20), np.int32))
    got, loss = tft.finetune_refine(model, None, None, TCFG.refine, TCFG.finetune, pool=empty)
    assert got is model and np.isnan(loss)


@pytest.fixture(scope="module")
def multi_video(jax_nets):
    """The JAX package's finetune_refine_videos on two videos (2 steps,
    batch 2, Adam 1e-4) and the port's, each building its own pools."""
    models, params, tmodels = jax_nets
    videos = [_frame_and_labels(64, 64, seed=s) for s in (11, 12)]
    for _, lab in videos:
        lab[lab == 2] = 0
    ft = jc.FinetuneConfig(steps=2, batch_size=4, num_augmentations=4)
    mesh = Mesh(np.array(jax.devices()[:1]), ("data",))
    _, jlosses = jmv.finetune_refine_videos(models.refine, params["refine"], videos, mesh,
                                            JREFINE, ft)
    tft_cfg = tc._from_dict(tc.FinetuneConfig, dataclasses.asdict(ft))
    got, losses = tmv.finetune_refine_videos(tmodels.refine, videos, TCFG.refine, tft_cfg,
                                             device="cpu")
    return dict(videos=videos, ft=tft_cfg, jlosses=np.asarray(jlosses), got=got, losses=losses,
                model=tmodels.refine)


def test_finetune_refine_videos_matches_jax(multi_video):
    r = multi_video
    assert len(r["got"]) == 2 and r["losses"].shape == (2,)
    np.testing.assert_allclose(r["losses"], r["jlosses"], rtol=1e-4, atol=0)
    a, b = (dict(m.named_parameters()) for m in r["got"])
    assert any(not torch.equal(a[n], b[n]) for n in a)


def test_finetune_refine_videos_each_equals_its_own_run(multi_video):
    """Video 1's copy and loss are those of a run on its pool and rows
    alone (the videos' optimizations are independent)."""
    r = multi_video
    rng = np.random.default_rng(0)
    pools = []
    for frame, lab in r["videos"]:
        imgs, labs = tlucid.lucid_batch(frame, lab, rng, min(r["ft"].num_augmentations, 32))
        pools.append(tft.make_refine_examples(imgs, labs, 33, JREFINE.box_margin, rng))
    rows = [[], []]
    for _ in range(2):
        for v in range(2):
            rows[v].append(rng.integers(0, len(pools[v][0]), size=2))
    (alone,), loss = tmv.train_refine_pools(r["model"], pools[1:], [np.stack(rows[1])],
                                            r["ft"].learning_rate)
    assert loss[0] == r["losses"][1]
    for (n, p), q in zip(alone.named_parameters(), r["got"][1].parameters()):
        assert torch.equal(p, q), n


@pytest.mark.parametrize("device", [None, "cuda"])
def test_finetune_refine_videos_keeps_the_device_contract(device):
    """With no device it runs on CUDA, and raises where there is none; a
    module that is not on the device asked for is refused, not moved."""
    model = DeepLabV3Plus(TCFG.refine)
    videos = [_frame_and_labels(64, 64, seed=11)]
    no_card = device is None and not torch.cuda.is_available()
    with pytest.raises(RuntimeError if no_card else ValueError):
        tmv.finetune_refine_videos(model, videos, TCFG.refine, TCFG.finetune, device=device)
    assert next(model.parameters()).device.type == "cpu"


def test_pool_modules_import_no_jax_cv2_or_pil():
    """Importing the pool fine-tune, the multi-video fine-tune, the refine
    trainer, the metrics and the OpenCV-free routines in a fresh interpreter
    loads no jax*, no premvos_tpu(.*), no cv2 and no PIL."""
    code = (
        "import sys\n"
        "import premvos_tpu_torch.finetune.finetune\n"
        "import premvos_tpu_torch.finetune.multi_video\n"
        "import premvos_tpu_torch.train.train_refine\n"
        "import premvos_tpu_torch.eval.metrics\n"
        "import premvos_tpu_torch.data.cv_compat\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in\n"
        "             ('jax', 'jaxlib', 'premvos_tpu', 'cv2', 'PIL'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    env["PYTHONPATH"] = REPO
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_pool_finetune_needs_cuda_or_explicit_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tfused.finetune_video_pool(None, np.zeros((8, 8, 3), np.uint8),
                                   np.zeros((8, 8), np.int32), TCFG)
