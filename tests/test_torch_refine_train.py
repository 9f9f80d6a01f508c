"""The port's refinement-net trainer (train/train_refine.py) and train-time
metrics (eval/metrics.py) vs the JAX package, on the CPU.

Both trainers read the same synthetic DAVIS tree (make_synthetic_davis) with
their own readers and draw their examples from numpy generators with the
same seed; the tiny DeepLabv3+ (R26, 33² crops) has the JAX package's
initial weights, bridged. The JAX trainer runs on a one-device mesh (its
batch is then `batch_size`, as the port's).

Tolerances: the example stream's crops 1e-6 and targets equal (the uint8
resize is OpenCV's, bit for bit; the float32 ones reorder nothing); the
loss after 3 steps 1e-4 relative (two Adam steps over float32 gradients
that XLA and PyTorch sum in different orders); the metrics 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import premvos_tpu.config as jc
from premvos_tpu.data.davis import DavisDataset as JaxDavis
from premvos_tpu.eval import metrics as jmetrics
from premvos_tpu.models.deeplab import DeepLabV3Plus as JaxDeepLab
from premvos_tpu.train import train_refine as jtr
from premvos_tpu_torch import config as tc
from premvos_tpu_torch.bridge import load_flax_tree
from premvos_tpu_torch.data.davis import DavisDataset, make_synthetic_davis
from premvos_tpu_torch.eval import metrics as tmetrics
from premvos_tpu_torch.models.deeplab import DeepLabV3Plus
from premvos_tpu_torch.train import train_refine as ttr

HW = (64, 96)
JREFINE = jc.RefineConfig(crop_size=33, backbone_depth=26, box_margin=12.0)
TREFINE = tc.RefineConfig(crop_size=33, backbone_depth=26, box_margin=12.0)


@pytest.fixture(scope="module")
def davis_root(tmp_path_factory):
    return make_synthetic_davis(tmp_path_factory.mktemp("davis"), sequences=("a", "b"), t=3,
                                hw=HW)


def test_example_stream_matches_jax(davis_root):
    """The first four pools of examples from one seed each."""
    a, b = np.random.default_rng(4), np.random.default_rng(4)
    want = jtr.example_stream(JaxDavis(davis_root, split="val"), JREFINE, a, image_hw=HW)
    got = ttr.example_stream(DavisDataset(davis_root, split="val"), TREFINE, b, image_hw=HW)
    for _ in range(4):
        (wx, wy), (gx, gy) = next(want), next(got)
        assert gx.shape == wx.shape and gx.shape[1:] == (33, 33, 4)
        np.testing.assert_allclose(gx, wx, rtol=0, atol=1e-6)
        np.testing.assert_array_equal(gy, wy)
    assert a.uniform() == b.uniform()


@pytest.fixture(scope="module")
def refine_init():
    jm = JaxDeepLab(cfg=JREFINE)
    return jm, jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.zeros((1, 33, 33, 4)))


def test_train_refine_matches_jax(davis_root, refine_init):
    """Three steps at batch 2 from the same weights and seed: the last loss
    1e-4 relative; the caller's module is the one trained."""
    jm, params = refine_init
    mesh = Mesh(np.array(jax.devices()[:1]), ("data",))
    _, jloss = jtr.train_refine(JaxDavis(davis_root, split="val"), JREFINE, steps=3,
                                batch_size=2, seed=0, mesh=mesh, params=params, image_hw=HW,
                                log_every=0)
    model = DeepLabV3Plus(TREFINE)
    load_flax_tree(model, jax.tree.map(np.asarray, params))
    before = [p.detach().clone() for p in model.parameters()]
    got, loss = ttr.train_refine(DavisDataset(davis_root, split="val"), TREFINE, steps=3,
                                 batch_size=2, seed=0, model=model, image_hw=HW, log_every=0,
                                 device="cpu")
    assert got is model and np.isfinite(loss)
    assert abs(loss - jloss) <= 1e-4 * abs(jloss), (loss, jloss)
    assert any(not torch.equal(a, p) for a, p in zip(before, model.parameters()))


def test_example_batches_carry_examples_over():
    """Batches take the stream's examples in order and keep the rest for
    the next batch."""
    pools = iter([(np.full((3, 2, 2, 4), i, np.float32), np.full((3, 2, 2), i, np.float32))
                  for i in range(4)])
    nb = ttr.example_batches(pools, 2, "cpu")
    got = [nb()[0][:, 0, 0, 0].tolist() for _ in range(4)]
    assert got == [[0, 0], [0, 1], [1, 1], [2, 2]]


def test_train_refine_main_saves_the_state_dict(davis_root, tmp_path):
    out = tmp_path / "refine.pt"
    ttr.main(["--davis_root", str(davis_root), "--split", "val", "--steps", "0",
              "--device", "cpu", "--out", str(out)])
    state = torch.load(out)
    assert set(state) == set(DeepLabV3Plus(tc.RefineConfig()).state_dict())


def test_train_refine_needs_cuda_or_explicit_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttr.train_refine(None, TREFINE, steps=1)


# --------------------------------------------------------------- metrics

def _metric_inputs(masked):
    rng = np.random.default_rng(2 + masked)
    logits = rng.normal(0, 2, (3, 8, 9)).astype(np.float32)
    labels = (rng.uniform(size=(3, 8, 9)) < 0.4).astype(np.float32)
    mask = (rng.uniform(size=(3, 8, 9)) < 0.7).astype(np.float32) if masked else None
    return logits, labels, mask


@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "masked"])
@pytest.mark.parametrize("name", ["pixel_accuracy", "binary_iou"])
def test_segmentation_metrics_match_jax(name, masked):
    logits, labels, mask = _metric_inputs(masked)
    want = getattr(jmetrics, name)(jnp.asarray(logits), jnp.asarray(labels),
                                   None if mask is None else jnp.asarray(mask))
    got = getattr(tmetrics, name)(torch.from_numpy(logits), torch.from_numpy(labels),
                                  None if mask is None else torch.from_numpy(mask))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), float(want), rtol=0, atol=1e-6)


@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "masked"])
def test_embedding_retrieval_accuracy_matches_jax(masked):
    rng = np.random.default_rng(5)
    ids = np.repeat(np.arange(4), 3).astype(np.int32)
    emb = (rng.normal(0, 1, (4, 6))[ids] + rng.normal(0, 0.8, (12, 6))).astype(np.float32)
    mask = (rng.uniform(size=12) < 0.75) if masked else None
    want = jmetrics.embedding_retrieval_accuracy(jnp.asarray(emb), jnp.asarray(ids),
                                                 None if mask is None else jnp.asarray(mask))
    got = tmetrics.embedding_retrieval_accuracy(
        torch.from_numpy(emb), torch.from_numpy(ids),
        None if mask is None else torch.from_numpy(mask))
    assert 0.0 < float(want) < 1.0
    np.testing.assert_allclose(float(got), float(want), rtol=0, atol=1e-6)
