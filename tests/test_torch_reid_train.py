"""The port's ReID training path vs the JAX package, on the CPU.

Inputs come from seeded numpy and go through the JAX function and its
counterpart in the port; weights are the JAX package's, bridged. Everything
is float32.

Tolerances: the triplet loss and its gradient 1e-6 (the same elementwise
formulas); the training step as tests/test_torch_train.py states them for
Mask R-CNN: the loss 1e-5 relative, each parameter's gradient 1e-4 of that
parameter's largest |grad| and the loss after one Adam step 1e-4 relative
(convolutions reassociate float32 sums between XLA and PyTorch); the
crops' bilinear resize 2.4e-7 on [0, 1] values (OpenCV's vector path
fuses multiply and add, numpy rounds twice: a float32 ulp or two).
"""

import dataclasses

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import premvos_tpu.config as jc
from premvos_tpu.data import crops as jcrops
from premvos_tpu.data.preprocess import IMAGENET_MEAN as JMEAN
from premvos_tpu.data.preprocess import IMAGENET_STD as JSTD
from premvos_tpu.io_compat import rle as jrle
from premvos_tpu.models.reid import ReIDNet as JaxReIDNet
from premvos_tpu.train import losses as jlosses
from premvos_tpu_torch import config as tc
from premvos_tpu_torch.bridge import flax_tensors, load_flax_tree
from premvos_tpu_torch.data import crops as tcrops
from premvos_tpu_torch.data.davis import DavisDataset, make_synthetic_davis
from premvos_tpu_torch.data.preprocess import resize_linear
from premvos_tpu_torch.io_compat import rle as trle
from premvos_tpu_torch.models.reid import ReIDNet
from premvos_tpu_torch.train import losses as tlosses
from premvos_tpu_torch.train.train_reid import pk_device_batch, reid_loss_fn, train_reid

JCFG = jc.ReIDConfig(backbone_depth=26, embedding_dim=8, crop_size=32)
TCFG = tc._from_dict(tc.ReIDConfig, dataclasses.asdict(JCFG))


def _t(x):
    return torch.from_numpy(np.array(x))


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# ------------------------------------------------------------ the loss

@pytest.mark.parametrize(
    "margin,masked,ids",
    [
        (0.2, False, [0, 0, 1, 1, 2, 2, 3, 3]),
        (-1.0, False, [0, 0, 1, 1, 2, 2, 3, 3]),
        (0.2, True, [0, 0, 0, 1, 1, 2, 2, 3]),  # identity 3 has no positive
        (5.0, False, [0, 1, 2, 3, 4, 5, 6, 7]),  # no anchor has a positive
    ],
    ids=["margin", "soft", "masked_singleton", "no_positives"],
)
def test_batch_hard_triplet_matches_jax(margin, masked, ids):
    """Value and gradient with respect to the embeddings, 1e-6: hard and
    soft margin, a padded row (mask), an identity without positives and a
    batch where no anchor has both (the loss is 0 and so is its gradient).
    The diagonal's zero distances are masked out by `where`; the 1e-12
    under the root keeps their gradient 0 and not NaN. In the masked case
    the padded row equals row 0, so its zero distance to row 0 is masked
    too. (A zero distance that is selected, between two equal rows of the
    batch, has a gradient set by the rounding of ‖a‖² + ‖b‖² − 2a·b in
    either package, and is not compared.)"""
    rng = np.random.default_rng(0)
    emb = rng.standard_normal((8, 5)).astype(np.float32)
    if masked:
        emb[6] = emb[0]
    ids = np.asarray(ids, np.int32)
    mask = np.array([1, 1, 1, 1, 1, 1, 0, 1], bool) if masked else None
    jmask = None if mask is None else jnp.asarray(mask)
    want, want_g = jax.value_and_grad(
        lambda e: jlosses.batch_hard_triplet(e, jnp.asarray(ids), margin, jmask))(jnp.asarray(emb))
    et = _t(emb).requires_grad_(True)
    got = tlosses.batch_hard_triplet(et, _t(ids), margin, None if mask is None else _t(mask))
    got.backward()
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(_np(et.grad), np.asarray(want_g), rtol=1e-6, atol=1e-6)
    assert np.isfinite(_np(et.grad)).all()


# ---------------------------------------------------------- the engine

@pytest.fixture(scope="module")
def coco(tmp_path_factory):
    """A synthetic COCO tree written by the JAX package."""
    return jcrops.make_synthetic_coco(tmp_path_factory.mktemp("coco"), num_images=3, per_image=2)


@pytest.fixture(scope="module")
def reid_parity(coco):
    """JAX ReIDNet and the port's on bridged weights: the triplet loss of one
    PK batch (P = 2, K = 2), its gradients, and the loss after one
    Adam(1e-4) step (the port's through `train_reid`)."""
    images, ann = coco
    model = JaxReIDNet(cfg=JCFG)
    params = jax.jit(model.init)(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)))
    tm = ReIDNet(TCFG)
    load_flax_tree(tm, jax.tree.map(np.asarray, params))

    crops, ids = jcrops.InstanceCropDataset(images, ann, crop_size=32).pk_batch(
        np.random.default_rng(0), 2, 2)
    crops = (crops - JMEAN) / JSTD

    def jloss_fn(pr, b):
        c, i = b
        return jlosses.batch_hard_triplet(model.apply(pr, c), i, JCFG.triplet_margin)

    vg = jax.jit(jax.value_and_grad(jloss_fn))
    jbatch = (jnp.asarray(crops), jnp.asarray(ids))
    jloss, jgrads = vg(params, jbatch)
    tx = optax.adam(1e-4)
    updates, _ = tx.update(jgrads, tx.init(params), params)
    jloss_after, _ = vg(optax.apply_updates(params, updates), jbatch)

    tds = tcrops.InstanceCropDataset(images, ann, crop_size=32)
    tbatch = pk_device_batch(tds, np.random.default_rng(0), 2, 2, "cpu")
    loss_fn = reid_loss_fn(tm, TCFG.triplet_margin)
    tloss = loss_fn(tbatch)
    tloss.backward()
    grads = {n: p.grad.clone() for n, p in tm.named_parameters()}
    tm.zero_grad(set_to_none=True)
    # One engine step on the batch its seed draws: the batch above.
    tm, _ = train_reid(tds, TCFG, steps=1, p=2, k=2, seed=0, model=tm, log_every=0,
                       device="cpu")
    with torch.no_grad():
        tloss_after = loss_fn(tbatch)
    return dict(
        batch=(crops, ids, tbatch), jloss=float(jloss), tloss=float(tloss.detach()),
        jgrads=flax_tensors(tm, jax.tree.map(np.asarray, jgrads)), tgrads=grads,
        jloss_after=float(jloss_after), tloss_after=float(tloss_after),
    )


def test_reid_batch_matches_jax(reid_parity):
    """pk_device_batch: the JAX engine's PK draw from the same seed,
    ImageNet-normalised, NCHW."""
    crops, ids, (tcrops_, tids) = reid_parity["batch"]
    np.testing.assert_allclose(_np(tcrops_.permute(0, 2, 3, 1)), crops, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(_np(tids), ids)


def test_reid_loss_matches_jax(reid_parity):
    r = reid_parity
    assert np.isfinite(r["tloss"]) and r["tloss"] > 0
    assert abs(r["tloss"] - r["jloss"]) <= 1e-5 * abs(r["jloss"]), (r["tloss"], r["jloss"])


def test_reid_gradients_match_jax(reid_parity):
    """Every parameter's gradient within 1e-4 of its largest |grad| (the
    frozen-BN statistics are buffers in the port, zero-gradient parameters
    in JAX)."""
    jg, tg = reid_parity["jgrads"], reid_parity["tgrads"]
    assert set(tg) == {n for n in jg if not n.endswith((".mean", ".var"))}
    for name, g in tg.items():
        want = jg[name].numpy()
        scale = max(float(np.abs(want).max()), 1e-12)
        err = float(np.abs(g.numpy() - want).max())
        assert err <= 1e-4 * scale, f"{name}: max |diff| {err} > 1e-4 * {scale}"
    assert float(tg["backbone.stem_conv.weight"].abs().max()) > 0


def test_train_reid_step_matches_jax(reid_parity):
    r = reid_parity
    assert abs(r["tloss_after"] - r["jloss_after"]) <= 1e-4 * abs(r["jloss_after"])
    assert r["tloss_after"] != r["tloss"]


def test_train_reid_needs_cuda_or_explicit_cpu(coco, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_reid(tcrops.InstanceCropDataset(*coco, crop_size=32), TCFG, steps=1)


# ------------------------------------------------------------ the data

def test_synthetic_coco_and_pk_batches_equal_jax(coco, tmp_path):
    """The port writes the JAX fixture's annotations and images (PNG, no
    Pillow: the same pixels, which Pillow encodes to the JAX fixture's JPEG
    bytes), reads the same instances and masks from the JAX tree (its JPEG
    decoder and bicubic resize without Pillow), and draws the same PK
    batches from one seed."""
    import io

    from PIL import Image

    from premvos_tpu_torch.io_compat.png import read_png

    images, ann = coco
    timages, tann = tcrops.make_synthetic_coco(tmp_path, num_images=3, per_image=2)
    assert tann.read_text() == ann.read_text().replace(".jpg", ".png")
    for name in sorted(p.name for p in images.iterdir()):
        pixels, _ = read_png(timages / name.replace(".jpg", ".png"))
        buf = io.BytesIO()
        Image.fromarray(pixels).save(buf, "JPEG", quality=95)
        assert buf.getvalue() == (images / name).read_bytes(), name
    jds = jcrops.InstanceCropDataset(images, ann, crop_size=24)
    tds = tcrops.InstanceCropDataset(images, ann, crop_size=24)
    assert len(tds) == len(jds) == 6
    for i in range(len(tds)):
        np.testing.assert_array_equal(tds.instance_mask(i), jds.instance_mask(i))
    for p, k in ((3, 2), (8, 1)):  # p above the instance count: all of them
        want = jds.pk_batch(np.random.default_rng(9), p, k)
        got = tds.pk_batch(np.random.default_rng(9), p, k)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)


def test_voc_crops_equal_jax(tmp_path):
    """The VOC reader lists the same instances (a box under min_area
    dropped) and crops them alike."""
    from PIL import Image

    (tmp_path / "Annotations").mkdir()
    (tmp_path / "JPEGImages").mkdir()
    rng = np.random.default_rng(10)
    for i, boxes in enumerate([[(4, 6, 40, 50), (30, 2, 62, 30)], [(1, 1, 9, 9), (10, 12, 60, 58)]]):
        Image.fromarray(rng.integers(0, 255, (64, 64, 3)).astype(np.uint8)).save(
            tmp_path / "JPEGImages" / f"im{i}.jpg")
        objs = "".join(
            f"<object><bndbox><xmin>{a}</xmin><ymin>{b}</ymin><xmax>{c}</xmax>"
            f"<ymax>{d}</ymax></bndbox></object>" for a, b, c, d in boxes)
        (tmp_path / "Annotations" / f"im{i}.xml").write_text(
            f"<annotation><filename>im{i}.jpg</filename>{objs}</annotation>")
    jds = jcrops.VocCropDataset(tmp_path, crop_size=16)
    tds = tcrops.VocCropDataset(tmp_path, crop_size=16)
    assert tds.instances == jds.instances and len(tds) == 3
    want = jds.pk_batch(np.random.default_rng(11), 3, 2)
    got = tds.pk_batch(np.random.default_rng(11), 3, 2)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("crop_size", [8, 32], ids=["shrink", "grow"])
def test_davis_object_crops_match_jax(tmp_path, crop_size):
    """DavisObjectCrops without OpenCV against the JAX package's (cv2
    INTER_LINEAR): the same identities, crops within 2.4e-7, and the same
    PK draws from one seed."""
    root = make_synthetic_davis(tmp_path / "davis", sequences=("a", "b"), t=3, hw=(48, 64))
    ds = DavisDataset(root)
    jd = jcrops.DavisObjectCrops(ds, crop_size, (48, 64), max_objects=2)
    td = tcrops.DavisObjectCrops(ds, crop_size, (48, 64), max_objects=2)
    assert td.ids == jd.ids and len(td.ids) == 4
    for key in td.ids:
        for got, want in zip(td.by_id[key], jd.by_id[key]):
            np.testing.assert_allclose(got, want, rtol=0, atol=2.4e-7)
    want = jd.pk_batch(np.random.default_rng(12), 3, 2)
    got = td.pk_batch(np.random.default_rng(12), 3, 2)
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=2.4e-7)
    np.testing.assert_array_equal(got[1], want[1])


@pytest.mark.parametrize(
    "src,dst",
    [((10, 10), (32, 32)), ((40, 25), (32, 32)), ((97, 211), (128, 128)), ((64, 17), (20, 90)),
     ((1, 40), (16, 16)), ((33, 33), (33, 33))],
)
def test_resize_linear_matches_cv2(src, dst):
    """resize_linear against cv2.resize (INTER_LINEAR) on float32, growing,
    shrinking, mixed, a single row and the identity."""
    x = np.random.default_rng(13).random((*src, 3)).astype(np.float32)
    want = cv2.resize(x, dst[::-1])
    got = resize_linear(x, dst)
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=2.4e-7)


def test_rle_codec_matches_jax():
    rng = np.random.default_rng(14)
    for shape in ((7, 5), (32, 48), (1, 1)):
        mask = (rng.random(shape) > 0.6).astype(np.uint8)
        mask[0, 0] = 1  # starts with a foreground run
        rle = trle.encode(mask)
        assert rle == jrle.encode(mask)
        np.testing.assert_array_equal(trle.decode(rle), mask)
        assert trle.area(rle) == jrle.area(rle) == int(mask.sum())
        np.testing.assert_array_equal(trle.to_bbox(rle), jrle.to_bbox(rle))
