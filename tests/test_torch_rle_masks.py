"""The port's C++ RLE codec (io_compat/rle_native.py over kernels/rle.cc)
and `ops/masks.py::mask_iou` against the JAX package's functions.

The JAX `rle_native` reads native/lib/librle.so when it is built and
otherwise falls back to its numpy oracle (`io_compat/rle.py`); the port
builds its own copy of the codec into premvos_tpu_torch/kernels/build/ at
first use. Both must give the numpy oracle's strings, masks and IoUs.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from premvos_tpu.io_compat import rle as jrle
from premvos_tpu.io_compat import rle_native as jrle_native
from premvos_tpu.ops.masks import mask_iou as jmask_iou
from premvos_tpu_torch import kernels
from premvos_tpu_torch.io_compat import rle_native
from premvos_tpu_torch.ops import mask_iou
from tests._threads import few_threads  # noqa: F401


def _masks(name):
    rng = np.random.default_rng(MASKS.index(name))
    if name.startswith("random"):
        return (rng.uniform(0, 1, (61, 47)) > 0.6).astype(np.uint8)
    if name == "frame_480x854":
        return (rng.uniform(0, 1, (480, 854)) > 0.8).astype(np.uint8)
    if name == "zeros":
        return np.zeros((5, 5), np.uint8)
    if name == "ones":
        return np.ones((5, 5), np.uint8)
    if name == "eye":
        return np.eye(7, dtype=np.uint8)
    if name == "one_pixel":
        m = np.zeros((9, 4), np.uint8)
        m[8, 3] = 1
        return m
    m = np.indices((16, 12)).sum(0) % 2  # checkerboard: every run of length 1
    return m.astype(np.uint8)


MASKS = ["random_0", "random_1", "random_2", "frame_480x854", "zeros", "ones", "eye",
         "one_pixel", "checkerboard"]


@pytest.mark.parametrize("name", MASKS)
def test_rle_native_encode_decode_match_jax(name):
    m = _masks(name)
    want = jrle.encode(m)
    assert rle_native.encode(m) == want == jrle_native.encode(m)
    np.testing.assert_array_equal(rle_native.decode(want), m)
    np.testing.assert_array_equal(rle_native.decode(want), jrle_native.decode(want))
    # bytes counts, and counts as run lengths
    as_bytes = {"size": want["size"], "counts": want["counts"].encode("ascii")}
    np.testing.assert_array_equal(rle_native.decode(as_bytes), m)
    runs = jrle.decode_counts(want["counts"])
    np.testing.assert_array_equal(rle_native.decode({"size": want["size"], "counts": runs}), m)


def _iou_pair(name):
    if name == "squares":
        a = np.zeros((40, 40), np.uint8)
        b = np.zeros((40, 40), np.uint8)
        a[5:25, 5:25] = 1
        b[15:35, 15:35] = 1
        return a, b
    if name == "empty":
        z = np.zeros((8, 8), np.uint8)
        return z, z
    if name == "one_empty":
        a = np.zeros((8, 8), np.uint8)
        a[2:4, 1:6] = 1
        return a, np.zeros((8, 8), np.uint8)
    rng = np.random.default_rng(int(name[-1]))
    return [(rng.uniform(0, 1, (33, 29)) > 0.5).astype(np.uint8) for _ in range(2)]


@pytest.mark.parametrize("name", ["squares", "empty", "one_empty", "random_0", "random_1",
                                  "random_2"])
def test_rle_native_iou_matches_jax(name):
    a, b = _iou_pair(name)
    ra, rb = jrle.encode(a), jrle.encode(b)
    want = jrle.iou(ra, rb)
    assert rle_native.iou(ra, rb) == pytest.approx(want, rel=1e-12, abs=0)
    assert rle_native.iou(ra, rb) == pytest.approx(jrle_native.iou(ra, rb), rel=1e-12, abs=0)


def test_rle_native_refuses_bad_counts():
    """A truncated counts string and counts that do not cover H×W raise
    ValueError, as in the JAX module."""
    good = jrle.encode(_masks("random_0"))
    for bad in ({"size": good["size"], "counts": good["counts"][:-1] + "a"},
                {"size": [3, 3], "counts": [2, 3]}):
        with pytest.raises(ValueError):
            rle_native.decode(bad)


def test_rle_native_builds_in_the_port_tree():
    """`available()` builds the port's copy of the codec, into the port's
    build directory (never native/lib, the JAX build's)."""
    assert rle_native.available()
    path = kernels.build_host(rle_native.SOURCE)
    assert os.path.dirname(path) == kernels.BUILD_DIR
    assert os.path.basename(path).startswith("librle_")


def test_rle_native_failed_build_raises(monkeypatch):
    """Without its library the port's codec does not fall back to numpy:
    available() says False and every call raises."""
    def broken(source):
        raise RuntimeError(f"building {source} failed")

    monkeypatch.setattr(kernels, "build_host", broken)
    monkeypatch.setattr(rle_native, "_LIB", None)
    assert not rle_native.available()
    m = _masks("eye")
    for call in (lambda: rle_native.encode(m), lambda: rle_native.decode(jrle.encode(m)),
                 lambda: rle_native.iou(jrle.encode(m), jrle.encode(m))):
        with pytest.raises(RuntimeError, match="rle.cc"):
            call()


@pytest.mark.parametrize("threshold", [0.5, 0.3, 0.0])
def test_mask_iou_matches_jax(threshold):
    """Soft masks (binarized at the threshold) or, at threshold 0, binary
    float masks; a mask pair with an empty union gives 0 in both."""
    rng = np.random.default_rng(4)
    a = rng.uniform(0, 1, (3, 16, 16)).astype(np.float32)
    b = rng.uniform(0, 1, (4, 16, 16)).astype(np.float32)
    if threshold == 0.0:
        a, b = (a > 0.5).astype(np.float32), (b > 0.5).astype(np.float32)
    a[1] = 0.0
    b[2] = 0.0
    want = np.asarray(jmask_iou(jnp.asarray(a), jnp.asarray(b), threshold=threshold))
    got = mask_iou(torch.from_numpy(a), torch.from_numpy(b), threshold=threshold)
    assert got.dtype == torch.float32 and got.shape == (3, 4)
    np.testing.assert_array_equal(got.numpy(), want)
    assert got[1, 2] == 0.0


def test_mask_iou_exact():
    """Port of the JAX test: the IoU of binary masks, pair by pair."""
    rng = np.random.default_rng(0)
    a = (rng.uniform(0, 1, (3, 16, 16)) > 0.5).astype(np.float32)
    b = (rng.uniform(0, 1, (4, 16, 16)) > 0.5).astype(np.float32)
    got = mask_iou(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    for i in range(3):
        for j in range(4):
            inter = (a[i] * b[j]).sum()
            union = a[i].sum() + b[j].sum() - inter
            np.testing.assert_allclose(got[i, j], inter / union, rtol=1e-6)
