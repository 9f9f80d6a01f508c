"""The port's JPEG encoder (io_compat/jpeg.py::encode over
kernels/jpeg_encode.cc, built here with g++) against Pillow, and the port's
three synthetic-data writers against the JAX package's.

Every case must equal Pillow's `Image.fromarray(rgb).save(f, "JPEG",
quality=q)` byte for byte: sizes from 1×1 to a 480×854 frame (partial MCUs
both ways, dummy blocks at the right and the bottom), noise, flat colour,
0/255 extremes and gradients, and the qualities 1 to 100 (each quality on
several sizes and contents, not the full cross product). The committed
fixtures (scripts/make_jpeg_encode_fixtures.py, which chip_smoke.py phase 7h
holds the encoder to on the card's machine) and the three committed
480×854 frames of scripts/make_jpeg_fixtures.py are encoded too. The
writers run with Pillow unimportable and must write the JAX package's
trees file for file (OpenCV's IPP off for the VOS generator's background,
as tests/test_torch_synthetic.py).
"""

import io
import itertools
import sys
from pathlib import Path

import cv2
import numpy as np
import pytest
from PIL import Image

from premvos_tpu.data import crops as jcrops
from premvos_tpu.data import davis as jdavis
from premvos_tpu.data import synthetic_vos as jvos
from premvos_tpu_torch import kernels
from premvos_tpu_torch.data import crops as tcrops
from premvos_tpu_torch.data import davis as tdavis
from premvos_tpu_torch.data import synthetic_vos as tvos
from premvos_tpu_torch.io_compat import jpeg
from premvos_tpu_torch.io_compat.png import read_png
from tests._threads import few_threads  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
ENCODED = REPO / "tests" / "data" / "jpeg" / "encoded"
FRAMES = REPO / "tests" / "data" / "jpeg" / "frames"

SIZES = [(1, 1), (1, 17), (7, 9), (8, 8), (15, 16), (16, 16), (17, 33), (30, 40), (48, 64),
         (90, 120), (128, 192), (480, 854)]
CONTENTS = ("noise", "flat", "extremes", "gradient")
QUALITIES = (1, 10, 25, 50, 75, 90, 95, 96, 100)
# Each size with each content, the quality turning through QUALITIES.
CASES = [(hw, content, QUALITIES[i % len(QUALITIES)])
         for i, (hw, content) in enumerate(itertools.product(SIZES, CONTENTS))]


def _pixels(h, w, content, seed=0):
    rng = np.random.default_rng(seed)
    if content == "noise":
        return rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
    if content == "flat":
        return np.full((h, w, 3), (200, 31, 90), np.uint8)
    if content == "extremes":
        return (rng.integers(0, 2, (h, w, 3)) * 255).astype(np.uint8)
    yy, xx = np.mgrid[0:h, 0:w]
    return np.stack([xx * 255 // max(w - 1, 1), yy * 255 // max(h - 1, 1),
                     (3 * xx + 5 * yy) % 256], -1).astype(np.uint8)


def _pillow(rgb, quality):
    buf = io.BytesIO()
    Image.fromarray(rgb).save(buf, "JPEG", quality=quality)
    return buf.getvalue()


@pytest.mark.parametrize("hw,content,quality", CASES,
                         ids=[f"{h}x{w}-{c}-q{q}" for (h, w), c, q in CASES])
def test_encode_equals_pillow(hw, content, quality):
    rgb = _pixels(*hw, content)
    assert jpeg.encode(rgb, quality) == _pillow(rgb, quality)


@pytest.mark.parametrize("quality", QUALITIES)
def test_every_quality_on_a_synthetic_frame(quality):
    """A rendered frame of the synthetic world at the protocol's canvas
    (smooth background, textured entities), every quality."""
    rgb = read_png(ENCODED / "vos_128x192.png")[0]
    assert jpeg.encode(rgb, quality) == _pillow(rgb, quality)


def test_encode_takes_any_layout():
    """A strided view, a Fortran-ordered copy and numpy integer qualities
    encode as their contiguous pixels do."""
    rgb = _pixels(40, 70, "gradient")
    want = _pillow(np.ascontiguousarray(rgb[::2, 1::3]), 90)
    assert jpeg.encode(rgb[::2, 1::3], np.int64(90)) == want
    assert jpeg.encode(np.asfortranarray(rgb), 75) == _pillow(rgb, 75)


def test_write_jpeg_writes_the_encoded_bytes(tmp_path):
    rgb = _pixels(33, 47, "noise")
    jpeg.write_jpeg(tmp_path / "a.jpg", rgb, 96)
    Image.fromarray(rgb).save(tmp_path / "b.jpg", quality=96)
    assert (tmp_path / "a.jpg").read_bytes() == (tmp_path / "b.jpg").read_bytes()


FIXTURES = sorted(p.name for p in ENCODED.glob("*_q*.jpg"))


@pytest.mark.parametrize("name", FIXTURES)
def test_committed_fixtures(name):
    """The files phase 7h encodes on the card, and still what Pillow writes."""
    source, quality = name[:-4].rsplit("_q", 1)
    rgb = read_png(ENCODED / f"{source}.png")[0]
    want = (ENCODED / name).read_bytes()
    assert jpeg.encode(rgb, int(quality)) == want
    assert _pillow(rgb, int(quality)) == want


def test_committed_frames_reencoded():
    """tests/data/jpeg/frames, which the decoder's fixtures and phase 7d
    read, re-encoded from their scene at quality 96."""
    sys.path.insert(0, str(REPO / "scripts"))
    from make_jpeg_fixtures import QUALITY, scene

    names = sorted(p.name for p in FRAMES.glob("*.jpg"))
    assert len(names) == 3
    for t, name in enumerate(names):
        assert jpeg.encode(scene(t)[0], QUALITY) == (FRAMES / name).read_bytes(), name


REFUSALS = {
    "float": (np.zeros((4, 4, 3), np.float32), 90, r"got float32 array of shape \(4, 4, 3\)"),
    "gray": (np.zeros((4, 4), np.uint8), 90, r"got uint8 array of shape \(4, 4\)"),
    "rgba": (np.zeros((4, 4, 4), np.uint8), 90, r"got uint8 array of shape \(4, 4, 4\)"),
    "list": ([[[0, 0, 0]]], 90, "got list"),
    "quality_0": (np.zeros((4, 4, 3), np.uint8), 0, "quality in 1..100, got 0"),
    "quality_101": (np.zeros((4, 4, 3), np.uint8), 101, "quality in 1..100, got 101"),
    "quality_float": (np.zeros((4, 4, 3), np.uint8), 95.0, "quality in 1..100, got 95.0"),
    "quality_bool": (np.zeros((4, 4, 3), np.uint8), True, "quality in 1..100, got True"),
    "empty": (np.zeros((0, 5, 3), np.uint8), 90, "sides in 1..65500, got 0x5"),
    "too_wide": (np.zeros((1, 65501, 3), np.uint8), 90, "sides in 1..65500, got 1x65501"),
}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_encode_refusals_name_the_input(case):
    rgb, quality, message = REFUSALS[case]
    with pytest.raises(ValueError, match=message):
        jpeg.encode(rgb, quality)


def test_encoder_refuses_in_its_own_checks():
    """The C entry point checks size and quality itself."""
    import ctypes

    lib = jpeg.load_encoder()
    err = ctypes.create_string_buffer(256)
    out = np.empty(4096, np.uint8)
    rgb = np.zeros(3, np.uint8)
    for h, w, q, message in ((0, 1, 90, b"image size 0x1 outside 1..65500"),
                             (1, 1, 0, b"quality 0 outside 1..100"),
                             (1, 65501, 90, b"image size 1x65501 outside 1..65500")):
        assert lib.premvos_jpeg_encode(rgb.ctypes.data, h, w, q, out.ctypes.data, out.size,
                                       err, 256) == -1
        assert err.value == message
    assert lib.premvos_jpeg_encode(rgb.ctypes.data, 1, 1, 90, out.ctypes.data, 100, err,
                                   256) == -1
    assert err.value == b"output larger than its bound"


def test_failed_build_raises_and_never_falls_back(monkeypatch):
    def broken(source):
        raise RuntimeError(f"building {source} failed")

    monkeypatch.setattr(kernels, "build_host", broken)
    monkeypatch.setattr(jpeg, "_encoder", None)
    with pytest.raises(RuntimeError, match="jpeg_encode.cc"):
        jpeg.encode(np.zeros((8, 8, 3), np.uint8), 90)


# ------------------------------------------------------------ the writers

def _files(root: Path) -> dict:
    return {p.relative_to(root).as_posix(): p.read_bytes()
            for p in sorted(root.rglob("*")) if p.is_file()}


@pytest.fixture
def no_ipp():
    was = cv2.ipp.useIPP()
    cv2.ipp.setUseIPP(False)
    yield
    cv2.ipp.setUseIPP(was)


def test_writers_without_pillow_write_the_jax_trees(tmp_path, monkeypatch, no_ipp):
    """make_synthetic_vos (no flow pairs), make_synthetic_davis and
    make_synthetic_coco with PIL unimportable: the JAX package's trees,
    file for file and byte for byte."""
    vos_kw = dict(n_train=1, n_tune=0, n_val=1, t=20, hw=(48, 72), seed=2, flow_pairs=False)
    jvos.make_synthetic_vos(tmp_path / "jax" / "vos", **vos_kw)
    jdavis.make_synthetic_davis(tmp_path / "jax" / "davis", sequences=("a", "b"), t=3,
                                hw=(37, 53))
    jcrops.make_synthetic_coco(tmp_path / "jax" / "coco", num_images=3, per_image=2)
    monkeypatch.setitem(sys.modules, "PIL", None)
    tvos.make_synthetic_vos(tmp_path / "port" / "vos", **vos_kw)
    tdavis.make_synthetic_davis(tmp_path / "port" / "davis", sequences=("a", "b"), t=3,
                                hw=(37, 53))
    tcrops.make_synthetic_coco(tmp_path / "port" / "coco", num_images=3, per_image=2)
    for tree, n_jpeg in (("vos", 40), ("davis", 6), ("coco", 3)):
        want, got = _files(tmp_path / "jax" / tree), _files(tmp_path / "port" / tree)
        assert sorted(got) == sorted(want), tree
        assert sum(name.endswith(".jpg") for name in want) == n_jpeg
        for name in want:
            assert got[name] == want[name], f"{tree}/{name}"
