"""The port's FlowNetC training path vs the JAX package, on the CPU.

Inputs come from seeded numpy and go through the JAX function and its
counterpart in the port; weights are the JAX package's, bridged. On the
port's side CPU tensors take the plain versions (the CUDA kernels are held
against the same plain versions on the card, tests/test_torch_cuda.py and
chip_smoke.py). Everything is float32.

Tolerances: the correlation gradient 1e-5 of each gradient's largest
|value| (float32 sums of up to 441 products in another order); the losses
1e-6 (the same elementwise formulas); FlowNetC's outputs 1e-4 of their
largest |value| and, for the training step, the loss 1e-5 relative, each
parameter's gradient 1e-4 of that parameter's largest |grad| and the loss
after one Adam step 1e-4 relative, as tests/test_torch_train.py states
them for Mask R-CNN (convolutions reassociate float32 sums between XLA and
PyTorch).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from premvos_tpu.data import flow_pairs as jpairs
from premvos_tpu.io_compat import flo as jflo
from premvos_tpu.models.flownet import FlowNetC as JaxFlowNetC
from premvos_tpu.ops.correlation import _correlation_grads
from premvos_tpu.train import losses as jlosses
from premvos_tpu.train.train_flow import DIV_FLOW as JAX_DIV_FLOW
from premvos_tpu_torch.bridge import flax_tensors, load_flax_tree
from premvos_tpu_torch.data import flow_pairs as tpairs
from premvos_tpu_torch.io_compat import flo as tflo
from premvos_tpu_torch.io_compat.ppm import read_ppm, write_ppm
from premvos_tpu_torch.models.flownet import FlowNetC
from premvos_tpu_torch.ops.correlation import correlation_grads_reference, correlation_reference
from premvos_tpu_torch.train import losses as tlosses
from premvos_tpu_torch.train.train_flow import DIV_FLOW, device_batch, flow_loss_fn, train_flownet_c
from tests._threads import few_threads  # noqa: F401


def _t(x):
    return torch.from_numpy(np.array(x))


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(got, want, rel):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-12)
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, f"max |diff| {err} > {rel} * {scale}"


# ------------------------------------------------- the correlation gradient

@pytest.mark.parametrize(
    "case", [(2, 6, 10, 12, 4, 1), (2, 8, 8, 8, 20, 2)], ids=["d9", "d21_md_above_h"],
)
def test_correlation_grads_reference_matches_jax(case):
    """correlation_grads_reference against JAX `_correlation_grads` (NHWC)
    and against autograd of correlation_reference, D = 9 and D = 21 (at the
    JAX engine's 8×8 cost volume, max displacement 20 above H and W: most
    terms read padding). Odd shapes are the CUDA tests' (the same plain
    version is their reference)."""
    b, c, h, w, md, stride = case
    d = 2 * (md // stride) + 1
    rng = np.random.default_rng(0)
    f1, f2 = (rng.standard_normal((b, h, w, c)).astype(np.float32) for _ in range(2))
    g = rng.standard_normal((b, h, w, d * d)).astype(np.float32)
    want1, want2 = _correlation_grads(*map(jnp.asarray, (f1, f2, g)), md, stride)
    nchw = [_t(x).permute(0, 3, 1, 2) for x in (f1, f2, g)]
    got1, got2 = correlation_grads_reference(*nchw, md, stride)
    a1, a2 = (x.clone().requires_grad_(True) for x in nchw[:2])
    auto1, auto2 = torch.autograd.grad(correlation_reference(a1, a2, md, stride), (a1, a2), nchw[2])
    for got, auto, want in ((got1, auto1, want1), (got2, auto2, want2)):
        _close(got.permute(0, 2, 3, 1), want, 1e-5)
        _close(got, auto, 1e-5)
    assert float(got2.abs().max()) > 0


# ------------------------------------------------------------------ losses

@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "masked"])
def test_endpoint_error_matches_jax(masked):
    """Value and gradient with respect to the prediction, 1e-6; one pixel
    where prediction and target agree (the 1e-12 under the root keeps its
    gradient finite)."""
    rng = np.random.default_rng(1)
    pred = rng.standard_normal((2, 6, 7, 2)).astype(np.float32)
    target = rng.standard_normal((2, 6, 7, 2)).astype(np.float32)
    target[0, 1, 1] = pred[0, 1, 1]
    mask = (rng.uniform(0, 1, (2, 6, 7)) > 0.3).astype(np.float32) if masked else None
    jmask = None if mask is None else jnp.asarray(mask)
    want, want_g = jax.value_and_grad(
        lambda p: jlosses.endpoint_error(p, jnp.asarray(target), jmask))(jnp.asarray(pred))
    pt = _t(pred).permute(0, 3, 1, 2).requires_grad_(True)
    got = tlosses.endpoint_error(pt, _t(target).permute(0, 3, 1, 2),
                                 None if mask is None else _t(mask))
    got.backward()
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(_np(pt.grad.permute(0, 2, 3, 1)), np.asarray(want_g),
                               rtol=1e-6, atol=1e-6)
    assert np.isfinite(_np(pt.grad)).all()


def test_multiscale_epe_matches_jax():
    """FlowNetC's five-level pyramid against a full-resolution target: the
    target shrinks with jax.image.resize's antialias, scales by the width
    ratio (a non-square target tells width from height), and the finest
    flow weighs 0.32. Value and every level's gradient, 1e-6 relative."""
    rng = np.random.default_rng(2)
    h, w = 64, 96
    preds = [rng.standard_normal((2, h // s, w // s, 2)).astype(np.float32)
             for s in (64, 32, 16, 8, 4)]
    target = rng.normal(0, 20, (2, h, w, 2)).astype(np.float32)
    want, want_g = jax.value_and_grad(
        lambda ps: jlosses.multiscale_epe(ps, jnp.asarray(target) / JAX_DIV_FLOW))(
        [jnp.asarray(p) for p in preds])
    pts = [_t(p).permute(0, 3, 1, 2).requires_grad_(True) for p in preds]
    got = tlosses.multiscale_epe(pts, _t(target).permute(0, 3, 1, 2) / DIV_FLOW)
    got.backward()
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-6)
    for p, g in zip(pts, want_g):
        _close(p.grad.permute(0, 2, 3, 1), g, 1e-6)
    assert DIV_FLOW == JAX_DIV_FLOW


# ------------------------------------------------------ FlowNetC training

HW = (64, 64)
MD = 4


@pytest.fixture(scope="module")
def chairs(tmp_path_factory):
    """A synthetic FlyingChairs tree written by the JAX package (Pillow)."""
    return jpairs.make_synthetic_chairs(tmp_path_factory.mktemp("chairs"), n=4, hw=HW)


@pytest.fixture(scope="module")
def flow_parity(chairs):
    """JAX FlowNetC(return_pyramid=True) and the port's FlowNetC on bridged weights:
    the pyramid, the training loss of one batch and its gradients, and the
    loss after one Adam(1e-4) step (the port's through
    `train_flownet_c`)."""
    model = JaxFlowNetC(max_displacement=MD, return_pyramid=True)
    z = jnp.zeros((1, *HW, 3))
    params = jax.jit(model.init)(jax.random.PRNGKey(0), z, z)
    tree = jax.tree.map(np.asarray, params)
    tm = FlowNetC(max_displacement=MD)
    load_flax_tree(tm, tree)

    batch = jpairs.FlowPairDataset(chairs).batch(np.random.default_rng(0), 2, HW)

    def jloss_fn(pr, b):
        i1, i2, gt = b
        flow, flows = model.apply(pr, i1, i2)
        return jlosses.multiscale_epe(list(flows), gt / JAX_DIV_FLOW), (flow, flows)

    vg = jax.jit(jax.value_and_grad(jloss_fn, has_aux=True))
    jbatch = tuple(map(jnp.asarray, batch))
    (jloss, (jflow, jflows)), jgrads = vg(params, jbatch)
    tx = optax.adam(1e-4)
    updates, _ = tx.update(jgrads, tx.init(params), params)
    (jloss_after, _), _ = vg(optax.apply_updates(params, updates), jbatch)

    tbatch = device_batch(batch, "cpu")
    with torch.no_grad():
        tflow, tflows = tm(*tbatch[:2])
    tloss = flow_loss_fn(tm)(tbatch)
    tloss.backward()
    grads = {n: p.grad.clone() for n, p in tm.named_parameters()}
    tm.zero_grad(set_to_none=True)
    # One engine step on the batch its seed draws: the batch above.
    tm, _ = train_flownet_c(
        tpairs.FlowPairDataset(chairs), steps=1, batch_size=2, crop_hw=HW,
        max_displacement=MD, seed=0, model=tm, log_every=0, device="cpu",
    )
    with torch.no_grad():
        tloss_after = flow_loss_fn(tm)(tbatch)
    return dict(
        flows=(tflow, tflows, jflow, jflows),
        jloss=float(jloss), tloss=float(tloss.detach()),
        jgrads=flax_tensors(tm, jax.tree.map(np.asarray, jgrads)), tgrads=grads,
        jloss_after=float(jloss_after), tloss_after=float(tloss_after),
    )


def test_flownetc_pyramid_matches_jax(flow_parity):
    """FlowNetC's (flow, flows): the finest flow and the five flows
    coarse → fine (1×1 … 16×16 at 64×64), 1e-4 of each one's largest
    |value|."""
    tflow, tflows, jflow, jflows = flow_parity["flows"]
    assert len(tflows) == len(jflows) == 5
    assert [tuple(f.shape[-2:]) for f in tflows] == [(1, 1), (2, 2), (4, 4), (8, 8), (16, 16)]
    assert tflows[-1] is tflow
    _close(tflow.permute(0, 2, 3, 1), jflow, 1e-4)
    for got, want in zip(tflows, jflows):
        _close(got.permute(0, 2, 3, 1), want, 1e-4)


def test_flownetc_loss_matches_jax(flow_parity):
    r = flow_parity
    assert np.isfinite(r["tloss"]) and r["tloss"] > 0
    assert abs(r["tloss"] - r["jloss"]) <= 1e-5 * abs(r["jloss"]), (r["tloss"], r["jloss"])


def test_flownetc_gradients_match_jax(flow_parity):
    """Every parameter's gradient within 1e-4 of its largest |grad|: the
    encoder's too, which gets its gradient through the cost volume."""
    jg, tg = flow_parity["jgrads"], flow_parity["tgrads"]
    assert set(tg) == set(jg)
    for name, g in tg.items():
        want = jg[name].numpy()
        scale = max(float(np.abs(want).max()), 1e-12)
        err = float(np.abs(g.numpy() - want).max())
        assert err <= 1e-4 * scale, f"{name}: max |diff| {err} > 1e-4 * {scale}"
    assert float(tg["encoder.conv1.Conv_0.weight"].abs().max()) > 0


def test_train_flownet_c_step_matches_jax(flow_parity):
    """The loss after one Adam step of `train_flownet_c` against one
    optax.adam step in JAX, 1e-4 relative."""
    r = flow_parity
    assert abs(r["tloss_after"] - r["jloss_after"]) <= 1e-4 * abs(r["jloss_after"])
    assert r["tloss_after"] != r["tloss"]


def test_train_flownet_c_needs_cuda_or_explicit_cpu(chairs, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_flownet_c(tpairs.FlowPairDataset(chairs), steps=1, max_displacement=MD)


def test_train_flow_main_saves_the_state_dict(chairs, monkeypatch, capsys):
    """The CLI hands its arguments to `train_flownet_c` (recorded here, with
    a stand-in model; without a launcher the mesh is one rank on the named
    device) and the trained state_dict to torch.save (recorded, not
    written)."""
    from premvos_tpu_torch.parallel.mesh import as_mesh
    from premvos_tpu_torch.train import train_flow

    calls, saved = [], []

    def fake_train(ds, **kw):
        calls.append((ds, kw))
        return torch.nn.Linear(2, 2), 0.5

    monkeypatch.setattr(train_flow, "train_flownet_c", fake_train)
    monkeypatch.setattr(torch, "save", lambda obj, path: saved.append((obj, path)))
    train_flow.main(["--data", str(chairs), "--steps", "3", "--batch_size", "2",
                     "--crop", "32", "48", "--max_displacement", str(MD), "--device", "cpu",
                     "--out", "flownetc.pt"])
    (ds, kw), = calls
    assert isinstance(ds, tpairs.FlowPairDataset) and len(ds) == 4
    assert kw == dict(steps=3, batch_size=2, crop_hw=(32, 48), max_displacement=MD,
                      mesh=as_mesh(None, "cpu"))
    (state, path), = saved
    assert path == "flownetc.pt" and set(state) == {"weight", "bias"}
    assert "'final_loss': 0.5" in capsys.readouterr().out


# ----------------------------------------------------- data and file codecs

def test_synthetic_chairs_and_batches_equal_jax(chairs, tmp_path):
    """The port writes the JAX fixture's files byte for byte (its PPM writer
    against Pillow's), and FlowPairDataset.batch draws the same samples and
    crops from one seed."""
    root = tpairs.make_synthetic_chairs(tmp_path / "chairs", n=4, hw=HW)
    names = sorted(os.listdir(chairs))
    assert names == sorted(os.listdir(root)) and len(names) == 12
    for name in names:
        with open(chairs / name, "rb") as a, open(root / name, "rb") as b:
            assert a.read() == b.read(), name
    jds, tds = jpairs.FlowPairDataset(chairs), tpairs.FlowPairDataset(root)
    assert tds.samples == jds.samples
    for crop in (None, (16, 24)):
        want = jds.batch(np.random.default_rng(5), 3, crop)
        got = tds.batch(np.random.default_rng(5), 3, crop)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)


def test_ppm_codec_matches_pillow(tmp_path):
    """write_ppm's bytes are Pillow's; read_ppm reads Pillow's files, a
    header with a comment and other whitespace, and a P5 (gray) file as
    Pillow's convert("RGB") reads it; a header Pillow refuses is refused
    naming the file (tests/test_torch_pnm.py holds every other header)."""
    from PIL import Image

    img = np.random.default_rng(6).integers(0, 256, (7, 11, 3)).astype(np.uint8)
    Image.fromarray(img).save(tmp_path / "pil.ppm")
    write_ppm(tmp_path / "np.ppm", img)
    assert (tmp_path / "pil.ppm").read_bytes() == (tmp_path / "np.ppm").read_bytes()
    np.testing.assert_array_equal(read_ppm(tmp_path / "pil.ppm"), img)
    (tmp_path / "c.ppm").write_bytes(b"P6 # a comment\n11\t7\n255\n" + img.tobytes())
    np.testing.assert_array_equal(read_ppm(tmp_path / "c.ppm"), img)
    np.testing.assert_array_equal(
        np.asarray(Image.open(tmp_path / "c.ppm").convert("RGB")), img)
    (tmp_path / "g.ppm").write_bytes(b"P5\n11 7\n255\n" + img[..., 0].tobytes())
    np.testing.assert_array_equal(read_ppm(tmp_path / "g.ppm"),
                                  np.repeat(img[..., :1], 3, axis=2))
    np.testing.assert_array_equal(
        np.asarray(Image.open(tmp_path / "g.ppm").convert("RGB")), read_ppm(tmp_path / "g.ppm"))
    (tmp_path / "z.ppm").write_bytes(b"P6\n11 7\n0\n" + img.tobytes())
    with pytest.raises(ValueError, match="z.ppm: P6 maxval 0"):
        read_ppm(tmp_path / "z.ppm")


def test_flo_codec_matches_jax(tmp_path):
    flow = np.random.default_rng(7).normal(0, 5, (9, 13, 2)).astype(np.float32)
    tflo.write_flo(tmp_path / "t.flo", flow)
    jflo.write_flo(tmp_path / "j.flo", flow)
    assert (tmp_path / "t.flo").read_bytes() == (tmp_path / "j.flo").read_bytes()
    np.testing.assert_array_equal(tflo.read_flo(tmp_path / "j.flo"), flow)
    (tmp_path / "bad.flo").write_bytes(b"\0" * 16)
    with pytest.raises(ValueError, match="magic"):
        tflo.read_flo(tmp_path / "bad.flo")
