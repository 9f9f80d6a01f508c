"""Parity of the PyTorch port's kernel-backed ops with the JAX package.

Each test feeds the same numpy inputs (seeded) to the JAX function — the
Pallas kernel in interpret mode and/or its XLA reference — and to the port's
plain PyTorch version, which is what a CPU tensor dispatches to. The CUDA
kernels themselves are compared with the same plain versions on the card
(tests/test_torch_cuda.py and chip_smoke.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from premvos_tpu.models.maskrcnn import multilevel_roi_align as jax_multilevel
from premvos_tpu.models.maskrcnn import roi_levels as jax_roi_levels
from premvos_tpu.ops.correlation import correlation_reference as jax_corr
from premvos_tpu.ops.masks import paste_mask as jax_paste
from premvos_tpu.ops.masks import soft_mask_iou as jax_soft_iou
from premvos_tpu.ops.nms import nms_reference as jax_nms
from premvos_tpu.ops.pallas.correlation_pallas import correlation_pallas
from premvos_tpu.ops.pallas.multilevel_roi_align_pallas import (
    multilevel_roi_align_pallas,
)
from premvos_tpu.ops.pallas.nms_pallas import nms_pallas
from premvos_tpu.ops.pallas.resample2d_pallas import resample2d_block_pallas
from premvos_tpu.ops.resample2d import resample2d_reference as jax_resample
from premvos_tpu.ops.roi_align import crop_and_resize as jax_crop
from premvos_tpu_torch.models.maskrcnn import multilevel_roi_align_auto, roi_levels
from premvos_tpu_torch.ops import nms as tnms
from premvos_tpu_torch.ops.correlation import correlation, correlation_reference
from premvos_tpu_torch.ops.masks import paste_mask, soft_mask_iou
from premvos_tpu_torch.ops.resample2d import resample2d, resample2d_reference
from premvos_tpu_torch.ops.resize import resize_bilinear
from premvos_tpu_torch.ops.roi_align import crop_and_resize
from tests._threads import few_threads  # noqa: F401


def _t(x):
    return torch.from_numpy(np.array(x))


def _boxes(rng, n, size):
    xy = rng.uniform(0, size, (n, 2))
    wh = rng.uniform(1, size / 2, (n, 2))
    return np.concatenate([xy, xy + wh], 1).astype(np.float32)


# ---------------------------------------------------------------- NMS (#1)

def _nms_cases():
    rng = np.random.default_rng(0)
    cases = []
    for i in range(3):
        b = _boxes(rng, 64, 60.0)
        s = rng.uniform(0, 1, 64).astype(np.float32)
        cases.append((f"random{i}", b, s, 64, 0.5, -1e10, None))
    # Ties: repeated scores must keep the lower index first (stable sort).
    b = _boxes(rng, 40, 80.0)
    s = np.round(rng.uniform(0, 1, 40), 1).astype(np.float32)
    cases.append(("ties", b, s, 40, 0.3, -1e10, None))
    # Padding rows and truncation to fewer outputs than survivors.
    b = _boxes(rng, 32, 500.0)
    s = rng.uniform(0, 1, 32).astype(np.float32)
    v = np.zeros(32, bool)
    v[:10] = True
    cases.append(("padding", b, s, 4, 0.5, -1e10, v))
    # Score threshold (detection NMS: 0.05) with scores straddling it.
    b = _boxes(rng, 48, 50.0)
    s = rng.uniform(0, 0.2, 48).astype(np.float32)
    cases.append(("threshold", b, s, 16, 0.5, 0.05, None))
    # NaN scores are never selected and sort last.
    b = _boxes(rng, 24, 40.0)
    s = rng.uniform(0, 1, 24).astype(np.float32)
    s[[2, 7, 11]] = np.nan
    cases.append(("nan", b, s, 24, 0.5, 0.0, None))
    # Identical boxes: exactly one survives.
    b = np.tile(np.array([[0.0, 0.0, 10.0, 10.0]], np.float32), (8, 1))
    s = np.arange(8, dtype=np.float32)
    cases.append(("identical", b, s, 8, 0.5, -1e10, None))
    return cases


@pytest.mark.parametrize(
    "name,boxes,scores,max_out,thr,score_thr,valid", _nms_cases(),
    ids=[c[0] for c in _nms_cases()],
)
def test_nms_matches_jax_exactly(name, boxes, scores, max_out, thr, score_thr, valid):
    """Indices must be identical to both JAX versions (exact)."""
    jv = None if valid is None else jnp.asarray(valid)
    tv = None if valid is None else _t(valid)
    ia, ka = jax_nms(jnp.asarray(boxes), jnp.asarray(scores), max_out, thr, score_thr, jv)
    ib, kb = nms_pallas(
        jnp.asarray(boxes), jnp.asarray(scores), max_out, thr, score_thr, jv,
        interpret=True,
    )
    ic, kc = tnms.nms(
        _t(boxes)[None], _t(scores)[None], max_out, thr, score_thr,
        None if tv is None else tv[None],
    )
    ic, kc = ic[0], kc[0]
    np.testing.assert_array_equal(ic.numpy(), np.asarray(ia))
    np.testing.assert_array_equal(ic.numpy(), np.asarray(ib))
    np.testing.assert_array_equal(kc.numpy(), np.asarray(ka))
    if name == "identical":
        assert int(kc.sum()) == 1
    if name == "nan":
        assert not np.isin(ic.numpy(), [2, 7, 11]).any()


def test_nms_batched_equals_per_image():
    """The batched call (one kernel launch per batch on the card) equals
    per-image calls."""
    rng = np.random.default_rng(1)
    boxes = np.stack([_boxes(rng, 50, 70.0) for _ in range(3)])
    scores = rng.uniform(0, 1, (3, 50)).astype(np.float32)
    ib, kb = tnms.nms(_t(boxes), _t(scores), 12, 0.6)
    for i in range(3):
        ia, ka = jax_nms(jnp.asarray(boxes[i]), jnp.asarray(scores[i]), 12, 0.6)
        np.testing.assert_array_equal(ib[i].numpy(), np.asarray(ia))
        np.testing.assert_array_equal(kb[i].numpy(), np.asarray(ka))


def _clustered_boxes(rng, n, clusters, jitter):
    """n boxes jittered around `clusters` boxes (neighbouring anchors on one
    object): most of a cluster overlaps its best box above 0.7."""
    ctr = rng.uniform([0, 0], [192, 128], (clusters, 2))
    side = rng.uniform(12, 60, (clusters, 2))
    which = rng.integers(0, clusters, n)
    wh = side[which] * (1 + jitter * rng.standard_normal((n, 2)))
    xy = ctr[which] - wh / 2 + jitter * side[which] * rng.standard_normal((n, 2))
    return np.concatenate([xy, xy + wh], 1).astype(np.float32)


def test_nms_clustered_matches_jax_exactly():
    """Heavy suppression, as on the RPN's path: 512 boxes in eight clusters
    per image, two images, with tied and NaN scores and max_outputs below
    the number of survivors. The port's batched call equals JAX nms and the
    Pallas kernel (interpret mode) on each image, exactly."""
    rng = np.random.default_rng(5)
    b, n, k = 2, 512, 12
    boxes = np.stack([_clustered_boxes(rng, n, 8, 0.12) for _ in range(b)])
    scores = rng.uniform(0, 1, (b, n)).astype(np.float32)
    scores[:, 100:140] = 0.5  # ties
    scores[:, [7, 200, 301]] = np.nan
    ic, kc = tnms.nms(_t(boxes), _t(scores), k, 0.7, 0.0)
    survivors = tnms.nms(_t(boxes), _t(scores), n, 0.7, 0.0)[1].sum(1)
    assert (survivors > k).all() and (survivors < n // 4).all()
    for i in range(b):
        ia, ka = jax_nms(jnp.asarray(boxes[i]), jnp.asarray(scores[i]), k, 0.7, 0.0)
        ib, kb = nms_pallas(jnp.asarray(boxes[i]), jnp.asarray(scores[i]), k, 0.7, 0.0,
                            interpret=True)
        np.testing.assert_array_equal(ic[i].numpy(), np.asarray(ia))
        np.testing.assert_array_equal(ic[i].numpy(), np.asarray(ib))
        np.testing.assert_array_equal(kc[i].numpy(), np.asarray(ka))
    assert not np.isin(ic.numpy(), [7, 200, 301]).any()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float64])
def test_nms_cuda_refuses_other_score_dtypes(dtype):
    """The kernel compares scores in float32 and nms_reference in their own
    dtype, so the CUDA wrapper takes float32 scores only (and checks that
    before it touches a tensor)."""
    boxes = torch.tensor([[[0.0, 0.0, 10.0, 10.0], [1.0, 1.0, 11.0, 11.0]]])
    with pytest.raises(TypeError, match="float32"):
        tnms.nms_cuda(boxes, torch.tensor([[0.9, 0.8]], dtype=dtype), 2)


# ---------------------------------------------------- RoIAlign (#2)

def _pyramid(rng, c, batch=None):
    shapes = [(32, 48), (16, 24), (8, 12), (4, 6)]
    lead = () if batch is None else (batch,)
    return [rng.standard_normal((*lead, h, w, c)).astype(np.float32) for h, w in shapes]


def _mixed_boxes(rng, n):
    sizes = rng.uniform(8.0, 400.0, (n,))
    cx = rng.uniform(0, 190, (n,))
    cy = rng.uniform(0, 120, (n,))
    return np.stack(
        [cx - sizes / 2, cy - sizes / 2, cx + sizes / 2, cy + sizes / 2], 1
    ).astype(np.float32)


@pytest.mark.parametrize("p", [7, 14])
def test_multilevel_roi_align_matches_jax(p):
    """Port (plain version) vs the Pallas kernel in interpret mode and the
    XLA compute-all-levels path, atol 1e-5 (fp32; the only difference is the
    order of a few float32 sums)."""
    rng = np.random.default_rng(2)
    c = 16
    feats = _pyramid(rng, c)
    boxes = _mixed_boxes(rng, 13)
    jf = {k: jnp.asarray(f) for k, f in zip(("P2", "P3", "P4", "P5"), feats)}
    want_xla = np.asarray(jax_multilevel(jf, jnp.asarray(boxes), p, 2))
    want_pallas = np.asarray(
        multilevel_roi_align_pallas(
            *jf.values(), jnp.asarray(boxes), jax_roi_levels(jnp.asarray(boxes)),
            p, 2, roi_block=2, channel_block=16, interpret=True,
        )
    )
    tf = {k: _t(f[None]).permute(0, 3, 1, 2) for k, f in jf.items()}
    got = multilevel_roi_align_auto(tf, _t(boxes)[None], p, 2)[0].numpy()
    np.testing.assert_array_equal(
        roi_levels(_t(boxes)).numpy(), np.asarray(jax_roi_levels(jnp.asarray(boxes)))
    )
    np.testing.assert_allclose(got, want_xla, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got, want_pallas, rtol=0, atol=1e-5)


def test_multilevel_roi_align_batched_and_degenerate():
    """Batch of images (one kernel launch on the card) equals per-image
    calls; zero boxes stay finite."""
    rng = np.random.default_rng(3)
    c = 8
    feats = _pyramid(rng, c, batch=2)
    boxes = np.stack([_mixed_boxes(rng, 6), np.zeros((6, 4), np.float32)])
    tf = {k: _t(f).permute(0, 3, 1, 2) for k, f in zip(("P2", "P3", "P4", "P5"), feats)}
    got = multilevel_roi_align_auto(tf, _t(boxes), 7, 2).numpy()
    assert got.shape == (2, 6, 7, 7, c) and np.isfinite(got).all()
    for i in range(2):
        jf = {k: jnp.asarray(f[i]) for k, f in zip(("P2", "P3", "P4", "P5"), feats)}
        want = np.asarray(jax_multilevel(jf, jnp.asarray(boxes[i]), 7, 2))
        np.testing.assert_allclose(got[i], want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("p", [7, 14])
def test_multilevel_roi_align_c20_every_level_matches_jax(p):
    """C = 20 (the CUDA kernel's one-channel-a-lane layout), two images,
    RoIs on every level, past the image edges, degenerate (zero size,
    inverted) and off the image: the port (batched plain version) vs JAX
    multilevel_roi_align and the Pallas kernel in interpret mode, per image,
    atol 1e-5."""
    rng = np.random.default_rng(6)
    c = 20
    feats = _pyramid(rng, c, batch=2)
    fixed = np.array([
        [10, 12, 60, 70], [0, 0, 8, 8], [40, 20, 190, 127], [-50, -30, 200, 180],
        [-200, -150, 400, 300], [150, 100, 192, 128], [30, 30, 30, 30],
        [80, 60, 70, 50], [300, 200, 340, 240],
    ], np.float32)
    boxes = np.stack([np.concatenate([_mixed_boxes(rng, 7), fixed]) for _ in range(2)])
    tf = {k: _t(f).permute(0, 3, 1, 2) for k, f in zip(("P2", "P3", "P4", "P5"), feats)}
    got = multilevel_roi_align_auto(tf, _t(boxes), p, 2).numpy()
    assert got.shape == (2, 16, p, p, c)
    for i in range(2):
        jf = {k: jnp.asarray(f[i]) for k, f in zip(("P2", "P3", "P4", "P5"), feats)}
        jb = jnp.asarray(boxes[i])
        levels = jax_roi_levels(jb)
        assert set(np.asarray(levels).tolist()) == {2, 3, 4, 5}
        want_xla = np.asarray(jax_multilevel(jf, jb, p, 2))
        want_pallas = np.asarray(multilevel_roi_align_pallas(
            *jf.values(), jb, levels, p, 2, roi_block=4, channel_block=128, interpret=True,
        ))
        np.testing.assert_allclose(got[i], want_xla, rtol=0, atol=1e-5)
        np.testing.assert_allclose(got[i], want_pallas, rtol=0, atol=1e-5)


# ------------------------------------------------- Correlation (#3)

@pytest.mark.parametrize("stride", [2, 1])
def test_correlation_matches_jax(stride):
    """Port (plain version, NCHW out) vs correlation_reference and the
    Pallas kernel in interpret mode, max displacement 4, atol 1e-5."""
    rng = np.random.default_rng(4)
    f1 = rng.standard_normal((2, 12, 20, 24)).astype(np.float32)
    f2 = rng.standard_normal((2, 12, 20, 24)).astype(np.float32)
    want_ref = np.asarray(jax_corr(jnp.asarray(f1), jnp.asarray(f2), 4, stride))
    want_pallas = np.asarray(
        correlation_pallas(jnp.asarray(f1), jnp.asarray(f2), 4, stride,
                           block_rows=4, interpret=True)
    )
    got = correlation(_t(f1).permute(0, 3, 1, 2), _t(f2).permute(0, 3, 1, 2), 4, stride)
    got = got.permute(0, 2, 3, 1).numpy()
    d = 2 * (4 // stride) + 1
    assert got.shape == (2, 12, 20, d * d)
    np.testing.assert_allclose(got, want_ref, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got, want_pallas, rtol=0, atol=1e-5)
    # More than 32 displacements per axis (D = 41 at stride 1, 35 at
    # stride 2), at a small size: most of the volume reads the zero border.
    md = 20 if stride == 1 else 34
    g1, g2 = f1[:, :9, :14], f2[:, :9, :14]
    want = np.asarray(jax_corr(jnp.asarray(g1), jnp.asarray(g2), md, stride))
    got = correlation(_t(g1).permute(0, 3, 1, 2), _t(g2).permute(0, 3, 1, 2), md, stride)
    d = 2 * (md // stride) + 1
    assert d > 32 and got.shape == (2, d * d, 9, 14)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, rtol=0, atol=1e-5)


def test_correlation_bf16_inputs_match_jax_on_float32_casts():
    """bf16 features (FlowNetC's inference path) go to the port's
    correlation as they are; the result equals JAX correlation_reference on
    their float32 casts (the JAX FlowNetC casts before correlating)."""
    rng = np.random.default_rng(8)
    f1 = rng.standard_normal((2, 10, 13, 40)).astype(np.float32)
    f2 = rng.standard_normal((2, 10, 13, 40)).astype(np.float32)
    t1 = _t(f1).to(torch.bfloat16).permute(0, 3, 1, 2)
    t2 = _t(f2).to(torch.bfloat16).permute(0, 3, 1, 2)
    c1 = t1.permute(0, 2, 3, 1).float().numpy()
    c2 = t2.permute(0, 2, 3, 1).float().numpy()
    want = np.asarray(jax_corr(jnp.asarray(c1), jnp.asarray(c2), 6, 2))
    got = correlation(t1, t2, 6, 2)
    assert got.dtype == torch.float32 and got.shape == (2, 49, 10, 13)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, rtol=0, atol=1e-5)


# -------------------------------------------------- Resample2d (#4)

def test_resample2d_matches_reference_on_any_flow():
    """The port's warp is exact for ANY flow: noise flow, far out-of-image
    flow (edge clamp) and zero flow vs resample2d_reference, atol 1e-5."""
    rng = np.random.default_rng(5)
    h, w, c = 29, 37, 3
    src = rng.standard_normal((h, w, c)).astype(np.float32)
    flows = [
        rng.uniform(-30, 30, (h, w, 2)).astype(np.float32),
        np.full((h, w, 2), 500.0, np.float32),
        np.full((h, w, 2), -41.3, np.float32),
        np.zeros((h, w, 2), np.float32),
    ]
    for flow in flows:
        want = np.asarray(jax_resample(jnp.asarray(src), jnp.asarray(flow)))
        got = resample2d(
            _t(src).permute(2, 0, 1)[None], _t(flow).permute(2, 0, 1)[None]
        )[0].permute(1, 2, 0).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_resample2d_matches_block_pallas_on_smooth_flow():
    """Inside the JAX block warp's envelope (smooth flow) the Pallas kernel
    in interpret mode and the port agree, atol 1e-5; packed masks too."""
    rng = np.random.default_rng(6)
    h, w = 40, 136
    yy, xx = np.mgrid[0:h, 0:w]
    flow = np.stack(
        [9.0 + 3 * np.sin(2 * np.pi * yy / 48), -6.0 + 2 * np.cos(2 * np.pi * xx / 40)],
        -1,
    ).astype(np.float32)
    for c in (3, 8):
        src = rng.uniform(0, 1, (2, h, w, c)).astype(np.float32)
        fl = np.stack([flow, flow[::-1]])
        want = np.asarray(
            resample2d_block_pallas(jnp.asarray(src), jnp.asarray(fl), interpret=True)
        )
        got = resample2d(_t(src).permute(0, 3, 1, 2), _t(fl).permute(0, 3, 1, 2))
        np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, rtol=0, atol=1e-5)


# --------------------------------------------- plain ops around them

def test_crop_paste_iou_resize_match_jax():
    rng = np.random.default_rng(7)
    img = rng.standard_normal((30, 40, 3)).astype(np.float32)
    b = rng.uniform(0, 0.5, (5, 2))
    boxes = np.concatenate([b, b + rng.uniform(0.1, 0.5, (5, 2))], 1).astype(np.float32)
    want = np.asarray(jax_crop(jnp.asarray(img), jnp.asarray(boxes), 9))
    got = crop_and_resize(_t(img).permute(2, 0, 1)[None], _t(boxes)[None], 9)[0]
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, atol=1e-5)

    mask = rng.uniform(0, 1, (7, 7)).astype(np.float32)
    box = np.array([3.2, 4.1, 20.7, 17.9], np.float32)
    want = np.asarray(jax_paste(jnp.asarray(mask), jnp.asarray(box), 24, 31))
    got = paste_mask(_t(mask), _t(box), 24, 31).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)

    a = rng.uniform(0, 1, (3, 16, 16)).astype(np.float32)
    m = rng.uniform(0, 1, (4, 16, 16)).astype(np.float32)
    np.testing.assert_allclose(
        soft_mask_iou(_t(a), _t(m)).numpy(),
        np.asarray(jax_soft_iou(jnp.asarray(a), jnp.asarray(m))), atol=1e-6,
    )

    import jax

    x = rng.uniform(0, 1, (2, 48, 64, 3)).astype(np.float32)
    for size in ((32, 40), (96, 80), (48, 64)):
        want = np.asarray(jax.image.resize(jnp.asarray(x), (2, *size, 3), "bilinear"))
        got = resize_bilinear(_t(x).permute(0, 3, 1, 2), size).permute(0, 2, 3, 1)
        np.testing.assert_allclose(got.numpy(), want, atol=2e-5)
