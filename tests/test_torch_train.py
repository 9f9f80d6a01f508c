"""The port's Mask R-CNN training path vs the JAX package, on the CPU.

Inputs come from seeded numpy and go through the JAX function and its
counterpart in the port. On the JAX side the single-level RoIAlign runs both
as the Pallas kernel in interpret mode and as the XLA `roi_align`; on the
port's side CPU tensors take the plain versions and their autograd (the CUDA
kernels are held against the same plain versions on the card,
tests/test_torch_cuda.py and chip_smoke.py). Everything is float32.

Tolerances: the losses 1e-6 (the same elementwise formulas; only sums are
ordered differently); RoIAlign 1e-5 absolute on unit-scale inputs (float32
sums of bilinear taps in another order), and for the multilevel align on 70
RoIs, where many taps add into one gradient pixel, 1e-5 of the largest
|value|; the end-to-end loss 1e-5 relative
and each parameter's gradient 1e-4 of that parameter's largest |grad|
(convolutions and their gradients reassociate float32 sums between XLA and
PyTorch); the loss after one Adam step 1e-4 relative (Adam's division by
√v amplifies the gradients' rounding where v is tiny).
"""

import dataclasses

import flax
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import premvos_tpu.config as jc
from premvos_tpu.models.anchors import pyramid_anchors as jax_pyramid_anchors
from premvos_tpu.models.maskrcnn import MaskRCNN as JaxMaskRCNN
from premvos_tpu.models.maskrcnn import multilevel_roi_align as jax_multilevel
from premvos_tpu.ops.pallas.roi_align_pallas import roi_align_pallas
from premvos_tpu.ops.roi_align import roi_align as jax_roi_align
from premvos_tpu.train import detection as jdet
from premvos_tpu.train import losses as jlosses
from premvos_tpu_torch import config as tc
from premvos_tpu_torch.bridge import flax_tensors, load_flax_tree
from premvos_tpu_torch.data.davis import DavisDataset, make_synthetic_davis
from premvos_tpu_torch.models.anchors import pyramid_anchors
from premvos_tpu_torch.models.maskrcnn import MaskRCNN, multilevel_roi_align
from premvos_tpu_torch.ops.roi_align import roi_align
from premvos_tpu_torch.train import detection as tdet
from premvos_tpu_torch.train import losses as tlosses
from premvos_tpu_torch.train.train_maskrcnn import sample_batch, train_maskrcnn
from premvos_tpu_torch.train.trainer import create_train_state


def _t(x):
    return torch.from_numpy(np.array(x))


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# ------------------------------------------------------------------ losses

def _loss_case(name, masked, rng):
    n = 40
    logits = rng.normal(0, 3, n).astype(np.float32)
    mask = (rng.uniform(0, 1, n) > 0.3).astype(np.float32) if masked else None
    if name == "sigmoid_xent":
        labels = (rng.uniform(0, 1, n) > 0.5).astype(np.float32)
        return (logits, labels), {"mask": mask}
    if name == "softmax_xent":
        logits = rng.normal(0, 3, (n, 3)).astype(np.float32)
        labels = rng.integers(0, 3, n).astype(np.int32)
        return (logits, labels), {"mask": mask}
    if name == "smooth_l1":
        pred = rng.normal(0, 0.2, (n, 4)).astype(np.float32)  # |d| on both sides of 1/9
        target = rng.normal(0, 0.2, (n, 4)).astype(np.float32)
        return (pred, target), {"mask": mask}
    labels = (rng.uniform(0, 1, n) > 0.8).astype(np.float32)
    kw = {"mask": mask, "norm": None if mask is None else np.float32(labels.sum())}
    return (logits, labels), kw


@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "masked"])
@pytest.mark.parametrize("name", ["sigmoid_xent", "softmax_xent", "smooth_l1", "sigmoid_focal"])
def test_losses_match_jax(name, masked):
    """Value and gradient with respect to the first argument, 1e-6."""
    rng = np.random.default_rng(0)
    (x, y), kw = _loss_case(name, masked, rng)
    jfn, tfn = getattr(jlosses, name), getattr(tlosses, name)
    jkw = {k: (None if v is None else jnp.asarray(v)) for k, v in kw.items()}
    want, want_g = jax.value_and_grad(lambda a: jfn(a, jnp.asarray(y), **jkw))(jnp.asarray(x))
    xt = _t(x).requires_grad_(True)
    got = tfn(xt, _t(y), **{k: (None if v is None else _t(v)) for k, v in kw.items()})
    got.backward()
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(_np(xt.grad), np.asarray(want_g), rtol=1e-6, atol=1e-6)


# -------------------------------------------------------- RoIAlign (#5)

def _single_level_boxes(scale):
    """Ordinary boxes, a degenerate one, one wholly off the image, ones that
    reach past the right/bottom edge (samples clamp there: both taps of a
    sample hit the last row or column) and one past the top-left corner."""
    b = np.array(
        [
            [2.0, 3.0, 20.0, 18.0],
            [5.5, 7.25, 9.5, 12.75],
            [10.0, 10.0, 10.0, 10.0],      # degenerate
            [-60.0, -50.0, -20.0, -12.0],  # off the image
            [20.0, 14.0, 33.7, 25.3],      # past right and bottom
            [-3.3, -2.6, 8.0, 6.0],        # past the top-left corner
            [0.0, 0.0, 32.0, 24.0],        # the whole image
        ],
        np.float32,
    )
    return b / scale


@pytest.mark.parametrize("p,scale", [(7, 1.0), (5, 0.25)])
def test_roi_align_matches_jax(p, scale):
    """The port's single-level RoIAlign (plain version, CPU) against the
    Pallas kernel in interpret mode and the XLA `roi_align`: forward 1e-5;
    gradient with respect to the features against jax.vjp of `roi_align`,
    1e-5."""
    rng = np.random.default_rng(1)
    feat = rng.standard_normal((24, 32, 16)).astype(np.float32)
    boxes = _single_level_boxes(scale)
    cot = rng.standard_normal((len(boxes), p, p, 16)).astype(np.float32)

    want, vjp = jax.vjp(
        lambda f: jax_roi_align(f, jnp.asarray(boxes), p, 2, scale), jnp.asarray(feat)
    )
    (want_g,) = vjp(jnp.asarray(cot))
    want_pallas = roi_align_pallas(
        jnp.asarray(feat), jnp.asarray(boxes), p, 2, spatial_scale=scale,
        roi_block=2, channel_block=16, interpret=True,
    )
    ft = _t(feat)[None].requires_grad_(True)
    got = roi_align(ft, _t(boxes)[None], p, 2, scale)
    (got * _t(cot)[None]).sum().backward()

    assert np.isfinite(_np(got)).all()
    np.testing.assert_array_equal(_np(got)[0, 3], 0.0)  # off the image
    np.testing.assert_allclose(_np(got)[0], np.asarray(want), rtol=0, atol=1e-5)
    np.testing.assert_allclose(_np(got)[0], np.asarray(want_pallas), rtol=0, atol=1e-5)
    np.testing.assert_allclose(_np(ft.grad)[0], np.asarray(want_g), rtol=0, atol=1e-5)


def test_roi_align_refuses_box_gradients():
    feats = torch.zeros(1, 8, 8, 4, requires_grad=True)
    boxes = torch.zeros(1, 2, 4, requires_grad=True)
    with pytest.raises(ValueError, match="boxes must not require grad"):
        roi_align(feats, boxes)


def _pyramid(rng, c, batch):
    shapes = [(32, 48), (16, 24), (8, 12), (4, 6)]
    return [rng.standard_normal((batch, h, w, c)).astype(np.float32) for h, w in shapes]


def _mixed_boxes(rng, n):
    sizes = rng.uniform(8.0, 400.0, (n,))
    cx = rng.uniform(0, 190, (n,))
    cy = rng.uniform(0, 120, (n,))
    b = np.stack([cx - sizes / 2, cy - sizes / 2, cx + sizes / 2, cy + sizes / 2], 1)
    b[:3] = 0.0  # padded proposals are zero boxes
    return b.astype(np.float32)


def _contention_boxes(rng, n):
    """62 boxes of 2-8 px around one point (on P2 their samples pile onto a
    few pixels: hundreds of taps add into one gradient pixel) after
    n - 62 mixed ones."""
    k = 62
    ctr = np.array([40.0, 30.0]) + rng.uniform(-2.0, 2.0, (k, 2))
    half = rng.uniform(1.0, 4.0, (k, 2))
    near = np.concatenate([ctr - half, ctr + half], 1)
    return np.concatenate([_mixed_boxes(rng, n - k), near]).astype(np.float32)


def _outside_boxes(rng, n):
    """Boxes partly or wholly outside the 128x192 image (centres from -100
    to 290 by -80 to 210), zero-area boxes (a point; zero width; zero
    height) and padded zero boxes."""
    sizes = rng.uniform(8.0, 400.0, (n, 2))
    ctr = rng.uniform([-100.0, -80.0], [290.0, 210.0], (n, 2))
    b = np.concatenate([ctr - sizes / 2, ctr + sizes / 2], 1)
    pts = rng.uniform([-20.0, -20.0], [210.0, 140.0], (12, 2))
    b[3:7, :2] = b[3:7, 2:] = pts[:4]  # a point
    b[7:11, 0] = b[7:11, 2] = pts[4:8, 0]  # zero width
    b[11:15, 1] = b[11:15, 3] = pts[8:12, 1]  # zero height
    b[:3] = 0.0
    return b.astype(np.float32)


def _elongated_boxes(rng, n):
    """Boxes at the top of each level's area range (just below the next
    level's, 0.98 of its side), square or elongated up to 1:16, so each
    RoI's samples span the most level pixels its level allows; P5 boxes
    cover the image."""
    b = np.zeros((n, 4), np.float32)
    for i in range(n):
        level = 2 + i % 4
        side = 0.98 * 224.0 * 2.0 ** (level - 3)
        aspect = 2.0 ** rng.uniform(-4.0, 4.0) if level < 5 else 1.0
        w, h = side * np.sqrt(aspect), side / np.sqrt(aspect)
        cx, cy = rng.uniform(0, 192), rng.uniform(0, 128)
        b[i] = [cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2]
    return b


_BOX_SETS = {"mixed": _mixed_boxes, "contention": _contention_boxes,
             "outside": _outside_boxes, "elongated": _elongated_boxes}


@pytest.mark.parametrize(
    "p,box_set",
    [(7, "mixed"), (14, "mixed"), (7, "contention"), (14, "contention"),
     (7, "outside"), (14, "outside"), (7, "elongated"), (14, "elongated")],
    ids=["7", "14", "7-contention", "14-contention", "7-outside", "14-outside",
         "7-elongated", "14-elongated"],
)
def test_multilevel_roi_align_train_matches_jax(p, box_set):
    """The training multilevel align (CPU: the plain version and its
    autograd) against JAX `multilevel_roi_align(..., roi_chunk=64)` on 70
    RoIs (two chunks): forward and the gradient of every level, each within
    1e-5 of its largest |value| (up to hundreds of taps add into one
    gradient pixel). Box sets: mixed sizes on every level; many tiny
    overlapping boxes on P2; boxes partly or wholly outside the image and
    zero-area ones; and boxes as large and elongated as their level allows
    (the cases the CUDA backward treats specially)."""
    rng = np.random.default_rng(2)
    c, n = 8, 70
    feats = _pyramid(rng, c, 2)
    boxes = np.stack([_BOX_SETS[box_set](rng, n) for _ in range(2)])
    cot = rng.standard_normal((2, n, p, p, c)).astype(np.float32)
    names = ("P2", "P3", "P4", "P5")

    tf = [_t(f).requires_grad_(True) for f in feats]
    got = multilevel_roi_align(
        {k: f.permute(0, 3, 1, 2) for k, f in zip(names, tf)}, _t(boxes), p, 2
    )
    (got * _t(cot)).sum().backward()
    for i in range(2):
        fn = lambda *fs: jax_multilevel(  # noqa: E731
            dict(zip(names, fs)), jnp.asarray(boxes[i]), p, 2, roi_chunk=64
        )
        want, vjp = jax.vjp(fn, *[jnp.asarray(f[i]) for f in feats])
        grads = vjp(jnp.asarray(cot[i]))
        want = np.asarray(want)
        np.testing.assert_allclose(
            _np(got)[i], want, rtol=0, atol=1e-5 * max(1.0, np.abs(want).max())
        )
        for level, (t, g) in enumerate(zip(tf, grads)):
            g = np.asarray(g)
            np.testing.assert_allclose(
                _np(t.grad)[i], g, rtol=0, atol=1e-5 * max(1.0, np.abs(g).max()),
                err_msg=f"P{level + 2}",
            )


# ------------------------------------------------------- target assignment

def _anchors(h=64, w=64):
    a = pyramid_anchors(h, w, (32.0, 64.0, 128.0, 256.0, 512.0), (0.5, 1.0, 2.0))
    return np.concatenate([a[k] for k in sorted(a)])


def _gt():
    """Three GT slots, the last padded (its coordinates are junk on purpose)."""
    boxes = np.array([[6.0, 5.0, 30.0, 40.0], [33.0, 20.0, 60.0, 47.0],
                      [1.0, 2.0, 3.0, 4.0]], np.float32)
    return boxes, np.array([True, True, False])


def test_assign_rpn_labels_dense_matches_jax():
    anchors = _anchors()
    gb, gv = _gt()
    want_l, want_t = jdet.assign_rpn_labels_dense(*map(jnp.asarray, (anchors, gb, gv)))
    got_l, got_t = tdet.assign_rpn_labels_dense(_t(anchors), _t(gb), _t(gv))
    # The case this parity test can state: padded slots, and no valid GT
    # whose best anchor is anchor 0 (there the JAX scatter order decides).
    iou = np.asarray(jdet.box_iou(jnp.asarray(anchors), jnp.asarray(gb)))
    assert (iou[:, gv].argmax(0) != 0).all()
    np.testing.assert_array_equal(_np(got_l), np.asarray(want_l))
    assert (_np(got_l) == 1).sum() > 0 and (_np(got_l) == -1).sum() > 0
    np.testing.assert_allclose(_np(got_t), np.asarray(want_t), rtol=1e-6, atol=1e-6)


def test_forced_positive_anchor_uses_or_rule():
    """A valid GT whose best anchor is anchor 0, next to a padded GT slot
    (whose argmax is also anchor 0): anchor 0 is positive in the dense and
    in the sampled assignment, although its IoU is below 0.7."""
    anchors = np.array([[0, 0, 20, 20], [40, 40, 60, 60], [80, 80, 90, 90]], np.float32)
    gb = np.array([[0, 0, 10, 10], [0, 0, 0, 0]], np.float32)
    gv = np.array([True, False])
    labels, _ = tdet.assign_rpn_labels_dense(_t(anchors), _t(gb), _t(gv))
    assert _np(labels).tolist() == [1, 0, 0]
    gen = torch.Generator().manual_seed(0)
    labels, _ = tdet.assign_rpn_targets(_t(anchors), _t(gb), _t(gv), gen, num_samples=4)
    assert _np(labels).tolist() == [1, 0, 0]


def test_assign_rpn_targets_sampled_properties():
    """The sampled assignment: at most 128 positives and 256 labels in all,
    labels only on anchors that are positive (1) or negative (0) by IoU,
    and the same draw from the same generator seed."""
    anchors = _anchors(128, 128)
    gb, gv = _gt()
    dense, _ = tdet.assign_rpn_labels_dense(_t(anchors), _t(gb * 2), _t(gv))
    runs = []
    for _ in range(2):
        gen = torch.Generator().manual_seed(5)
        labels, tgts = tdet.assign_rpn_targets(_t(anchors), _t(gb * 2), _t(gv), gen)
        runs.append(_np(labels))
    lab, dense = runs[0], _np(dense)
    np.testing.assert_array_equal(runs[0], runs[1])
    assert 0 < (lab == 1).sum() <= 128 and (lab >= 0).sum() <= 256
    assert (lab == 0).sum() == 128  # k_neg is fixed, as in the JAX package
    assert (dense[lab == 1] == 1).all() and (dense[lab == 0] == 0).all()
    assert tgts.shape == (len(anchors), 4)


def test_roi_targets_mask_targets_and_detection_loss_match_jax():
    rng = np.random.default_rng(3)
    h, w, k = 48, 64, 24
    gb, gv = _gt()
    masks = np.zeros((3, h, w), np.float32)
    masks[0, 5:40, 6:30] = 1.0
    masks[1, 20:47, 33:60] = 1.0
    masks[1, 30:35, 40:45] = 0.0
    xy = rng.uniform(0, 40, (k, 2))
    props = np.concatenate([xy, xy + rng.uniform(4, 30, (k, 2))], 1).astype(np.float32)
    props[:4] = gb[[0, 0, 1, 1]] + rng.uniform(-2, 2, (4, 4)).astype(np.float32)
    pv = rng.uniform(0, 1, k) > 0.2
    pv[:4] = True

    want = jdet.assign_roi_targets(*map(jnp.asarray, (props, pv, gb, gv)))
    got = tdet.assign_roi_targets(_t(props), _t(pv), _t(gb), _t(gv))
    for name, g, j in zip(("cls", "matched", "box", "fg", "valid"), got, want):
        np.testing.assert_allclose(_np(g), np.asarray(j), rtol=1e-6, atol=1e-6, err_msg=name)
    assert _np(got[3]).sum() >= 2

    want_m = jdet.mask_targets(jnp.asarray(masks), want[1], jnp.asarray(props), 28, (h, w))
    got_m = tdet.mask_targets(_t(masks), got[1], _t(props), 28, (h, w))
    np.testing.assert_allclose(_np(got_m), np.asarray(want_m), rtol=0, atol=1e-6)

    cls_logits = rng.normal(0, 2, (k, 2)).astype(np.float32)
    box_deltas = rng.normal(0, 0.3, (k, 4)).astype(np.float32)
    m_logits = rng.normal(0, 2, (k, 28, 28)).astype(np.float32)
    want_l = jdet.detection_loss(
        jnp.asarray(cls_logits), jnp.asarray(box_deltas), jnp.asarray(m_logits),
        want[0], want[2], want_m, want[3], want[4],
    )
    got_l = tdet.detection_loss(
        _t(cls_logits), _t(box_deltas), _t(m_logits), got[0], got[2], got_m,
        got[3], got[4],
    )
    for g, j in zip(got_l, want_l):
        np.testing.assert_allclose(_np(g), np.asarray(j), rtol=1e-6, atol=1e-6)


# ------------------------------------------------- maskrcnn_loss_fn end to end

HW = (64, 64)
JTINY = jc.ProposalConfig(
    backbone_depth=26, fpn_channels=32, rpn_pre_nms_topk=64,
    rpn_post_nms_topk=16, detections_per_frame=8,
)
TTINY = tc._from_dict(tc.ProposalConfig, dataclasses.asdict(JTINY))


def _train_batch(model, anchors):
    """Two images, two GT slots each; the second slot of image 1 is padded.
    The GT boxes are some of `model`'s own proposals, rounded, so that
    foreground RoIs (and with them the box and mask losses) exist with
    random weights."""
    rng = np.random.default_rng(4)
    images = rng.standard_normal((2, *HW, 3)).astype(np.float32)
    with torch.no_grad():
        feats = model.features(_t(images).permute(0, 3, 1, 2))
        rois = model.proposals(feats, anchors, HW)[0].numpy()
    sizes = (rois[..., 2] - rois[..., 0]) * (rois[..., 3] - rois[..., 1])
    boxes = np.zeros((2, 2, 4), np.float32)
    valid = np.array([[True, True], [True, False]])
    masks = np.zeros((2, 2, *HW), np.float32)
    for i in range(2):
        for j in range(int(valid[i].sum())):
            boxes[i, j] = np.round(rois[i, np.argsort(-sizes[i])[j]])
            x1, y1, x2, y2 = boxes[i, j].astype(int)
            masks[i, j, y1:y2, x1 + 1:x2 - 1] = 1.0
    return images, boxes, masks, valid


@pytest.fixture(scope="module")
def loss_parity():
    """JAX and the port on bridged weights: loss and gradients, then the
    loss after one Adam(1e-4) step on each side."""
    model = JaxMaskRCNN(cfg=JTINY)
    janchors = {
        k: jnp.asarray(v)
        for k, v in jax_pyramid_anchors(*HW, JTINY.anchor_scales, JTINY.anchor_ratios).items()
    }
    params = jax.jit(model.init)(jax.random.PRNGKey(0), jnp.zeros((1, *HW, 3)), janchors)
    # A zero RPN delta head makes the proposals the clipped anchors, exactly
    # on both sides. With random deltas the two sides' proposals differ by
    # float32 noise (1e-4 px after exp() on 512-px anchors), and with random
    # high-frequency features that moves the mask head's gradients by up to
    # 1e-3 of their largest value, which would hide what this test checks.
    # The delta head still gets its gradient from the RPN box loss.
    params = flax.core.unfreeze(params)
    params["params"]["rpn"]["Conv_2"] = jax.tree.map(
        jnp.zeros_like, params["params"]["rpn"]["Conv_2"]
    )
    tm = MaskRCNN(TTINY)
    load_flax_tree(tm, jax.tree.map(np.asarray, params))
    tanchors = {
        k: torch.from_numpy(v)
        for k, v in pyramid_anchors(*HW, TTINY.anchor_scales, TTINY.anchor_ratios).items()
    }
    batch = _train_batch(tm, tanchors)
    jloss_fn = jdet.maskrcnn_loss_fn(model, janchors, JTINY, HW)
    vg = jax.jit(jax.value_and_grad(jloss_fn))
    jloss, jgrads = vg(params, tuple(map(jnp.asarray, batch)))
    tx = optax.adam(1e-4)
    updates, _ = tx.update(jgrads, tx.init(params), params)
    jloss_after, _ = vg(optax.apply_updates(params, updates), tuple(map(jnp.asarray, batch)))

    tloss_fn = tdet.maskrcnn_loss_fn(tm, tanchors, TTINY, HW)
    tbatch = tuple(map(_t, batch))
    tloss = tloss_fn(tbatch)
    tloss.backward()
    grads = {n: p.grad.clone() for n, p in tm.named_parameters()}
    state = create_train_state(tm, 1e-4)
    state.optimizer.step()
    with torch.no_grad():
        tloss_after = tloss_fn(tbatch)
    return dict(
        jloss=float(jloss), tloss=float(tloss.detach()), jgrads=flax_tensors(tm, jax.tree.map(np.asarray, jgrads)),
        tgrads=grads, jloss_after=float(jloss_after), tloss_after=float(tloss_after),
    )


def test_maskrcnn_loss_matches_jax(loss_parity):
    r = loss_parity
    assert np.isfinite(r["tloss"]) and r["tloss"] > 0
    assert abs(r["tloss"] - r["jloss"]) <= 1e-5 * abs(r["jloss"]), (r["tloss"], r["jloss"])


def test_maskrcnn_gradients_match_jax(loss_parity):
    """Every parameter's gradient within 1e-4 of its largest |grad| (the
    frozen-BN statistics are buffers in the port, zero-gradient parameters
    in JAX)."""
    jg, tg = loss_parity["jgrads"], loss_parity["tgrads"]
    assert set(tg) == {n for n in jg if not n.endswith((".mean", ".var"))}
    for name, g in tg.items():
        want = jg[name].numpy()
        scale = max(float(np.abs(want).max()), 1e-12)
        err = float(np.abs(g.numpy() - want).max())
        assert err <= 1e-4 * scale, f"{name}: max |diff| {err} > 1e-4 * {scale}"
    nonzero = [n for n, g in tg.items() if float(g.abs().max()) > 0]
    assert any(n.startswith("mask_head.") for n in nonzero)  # the mask loss reached
    assert any(n.startswith("box_head.") for n in nonzero)


def test_maskrcnn_loss_after_adam_step_matches_jax(loss_parity):
    r = loss_parity
    assert abs(r["tloss_after"] - r["jloss_after"]) <= 1e-4 * abs(r["jloss_after"])
    assert r["tloss_after"] != r["tloss"]


# ---------------------------------------------------------- the engine

class _RecordingDataset:
    """Two sequences with annotated frames; frame 1 of "b" is empty."""

    sequences = ["a", "b"]

    def __init__(self):
        self.calls = []

    def load_sequence(self, seq, h, w, max_objects):
        self.calls.append(seq)
        labels = np.zeros((3, h, w), np.int32)
        for t in range(3):
            if not (seq == "b" and t == 1):
                labels[t, 4 + t:20 + t, 6:30] = 1
        frames = np.full((3, h, w, 3), 100 + 50 * (seq == "b"), np.uint8)
        return {"frames": frames, "gt_labels": labels}


def test_sample_batch_draws_in_the_jax_order():
    """Sequence, then frame (redrawn when a frame holds no object), then the
    per-image seeds, from one numpy generator: the JAX engine's order, so
    both pick the same frames from the same seed."""
    ds = _RecordingDataset()
    got = sample_batch(ds, np.random.default_rng(7), (32, 40), 2, 3, "cpu")
    rng = np.random.default_rng(7)
    picks = []
    while len(picks) < 3:
        seq = ds.sequences[rng.integers(0, 2)]
        t = rng.integers(0, 3)
        if not (seq == "b" and t == 1):
            picks.append((seq, t))
    seeds = rng.integers(0, 2**31 - 1, size=3).astype(np.uint32)
    np.testing.assert_array_equal(got[4], seeds)
    assert len(ds.calls) >= 3 and got[0].shape == (3, 32, 40, 3)
    for i, (seq, t) in enumerate(picks):
        assert float(got[1][i, 0, 1]) == 4 + t  # y1 of the frame's object
        assert bool(got[3][i, 0]) and not bool(got[3][i, 1])


def test_train_maskrcnn_two_cpu_steps(tmp_path):
    root = make_synthetic_davis(tmp_path / "davis", t=3, hw=HW)
    model, loss = train_maskrcnn(
        DavisDataset(root), TTINY, image_hw=HW, max_objects=2, steps=2,
        batch_size=2, log_every=0, device="cpu",
    )
    assert np.isfinite(loss) and isinstance(model, MaskRCNN)


def test_train_maskrcnn_needs_cuda_or_explicit_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_maskrcnn(_RecordingDataset(), TTINY, image_hw=HW, steps=1)
