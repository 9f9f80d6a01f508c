"""The port's file codecs and host-side helpers against the JAX package and
against Pillow / OpenCV: the PNG codec (every row filter; images written by
Pillow and by the port), the DAVIS reader without Pillow, the ellipse
element and the J&F measures, the proposals JSON, `save_config`,
`pad_to` / `crop_result` / `save_results`, the sequence prefetch and the
logging helpers. Nothing here builds a network."""

import dataclasses
import glob
import struct
import sys
import zlib

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import premvos_tpu.config as jc
from premvos_tpu.data import davis as jdavis
from premvos_tpu.data.preprocess import pad_to as jax_pad_to
from premvos_tpu.eval import davis_eval as jeval
from premvos_tpu.io_compat import proposals_json as jprops
from premvos_tpu_torch import config as tc
from premvos_tpu_torch.data import davis as tdavis
from premvos_tpu_torch.data.palette import davis_palette, load_indexed_png, save_indexed_png
from premvos_tpu_torch.data.prefetch import prefetch_sequences
from premvos_tpu_torch.data.preprocess import pad_to
from premvos_tpu_torch.eval import davis_eval as teval
from premvos_tpu_torch.io_compat import png
from premvos_tpu_torch.io_compat import proposals_json as tprops
from premvos_tpu_torch.utils import logging as tlog

# ------------------------------------------------------------------ PNG


def _predict(a, b, c, ftype):
    if ftype == 0:
        return 0
    if ftype == 1:
        return a
    if ftype == 2:
        return b
    if ftype == 3:
        return (a + b) >> 1
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return a if pa <= pb and pa <= pc else (b if pb <= pc else c)


def _filter_bytes(rows: np.ndarray, bpp: int, filters) -> bytearray:
    """Scanline bytes [H, stride] → filtered stream, row y filtered with
    filters[y] by the specification's formulas (the test's own encoder)."""
    out, prev = bytearray(), [0] * rows.shape[1]
    for row, ftype in zip(rows.tolist(), filters):
        out.append(ftype)
        for i, x in enumerate(row):
            a = row[i - bpp] if i >= bpp else 0
            c = prev[i - bpp] if i >= bpp else 0
            out.append((x - _predict(a, prev[i], c, ftype)) & 0xFF)
        prev = row
    return out


def _png_file(path, stream: bytes, width, height, depth, color, palette=None, interlace=0):
    def chunk(kind, body):
        return struct.pack(">I", len(body)) + kind + body + struct.pack(
            ">I", zlib.crc32(kind + body))

    data = png.SIGNATURE + chunk(b"IHDR", struct.pack(
        ">IIBBBBB", width, height, depth, color, 0, 0, interlace))
    if palette is not None:
        data += chunk(b"PLTE", palette.tobytes())
    data += chunk(b"IDAT", zlib.compress(bytes(stream))) + chunk(b"IEND", b"")
    with open(path, "wb") as f:
        f.write(data)


def _filtered_png(path, rows: np.ndarray, width: int, depth: int, color: int, filters,
                  palette=None, interlace=0):
    """Write a PNG of raw scanline bytes [H, stride], row y filtered with
    filters[y]."""
    bpp = max(1, {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[color] * depth // 8)
    _png_file(path, _filter_bytes(rows, bpp, filters), width, rows.shape[0], depth, color,
              palette, interlace)


def _pack(samples: np.ndarray, depth: int) -> np.ndarray:
    """[h, w, ch] samples → scanline bytes [h, stride] (big-endian at 16
    bits, packed from the high bits below 8)."""
    flat = samples.reshape(samples.shape[0], -1)
    if depth == 16:
        return flat.astype(">u2").view(np.uint8)
    if depth == 8:
        return flat.astype(np.uint8)
    bits = (flat[..., None] >> np.arange(depth - 1, -1, -1)) & 1
    return np.packbits(bits.reshape(flat.shape[0], -1).astype(np.uint8), axis=1)


def _sample_png(path, samples: np.ndarray, depth: int, color: int, palette=None,
                interlace=0, seed=0):
    """Write [H, W, ch] samples, plain or as the seven Adam7 passes, each
    row with a random filter."""
    rng = np.random.default_rng(seed)
    h, w, ch = samples.shape
    bpp = max(1, ch * depth // 8)
    passes = png._ADAM7 if interlace else ((0, 0, 1, 1),)
    stream = bytearray()
    for x0, y0, dx, dy in passes:
        sub = samples[y0::dy, x0::dx]
        if sub.size:
            stream += _filter_bytes(_pack(sub, depth), bpp, rng.integers(0, 5, sub.shape[0]))
    _png_file(path, stream, w, h, depth, color, palette, interlace)


# (color type, bit depth, channels) of the images each filter case writes.
_KINDS = [(0, 8, 1), (2, 8, 3), (4, 8, 2), (6, 8, 4), (3, 8, 1), (3, 4, 1), (3, 2, 1), (3, 1, 1)]


@pytest.mark.parametrize("filters", [0, 1, 2, 3, 4, "mixed"])
def test_png_reads_every_row_filter(tmp_path, filters):
    """Every filter type (and a mix of all five, row by row) on gray, RGB,
    gray + alpha, RGBA and 8/4/2/1-bit palette images decodes to the
    pixels written."""
    rng = np.random.default_rng(0)
    h, w = 13, 11
    for color, depth, ch in _KINDS:
        pixels = rng.integers(0, 1 << depth, (h, w, ch)).astype(np.uint8)
        if depth < 8:  # pack from the high bits, each row padded to a byte
            bits = (pixels[..., 0, None] >> np.arange(depth - 1, -1, -1)) & 1
            rows = np.packbits(bits.reshape(h, -1).astype(np.uint8), axis=1)
        else:
            rows = pixels.reshape(h, -1)
        ftypes = [y % 5 for y in range(h)] if filters == "mixed" else [filters] * h
        pal = rng.integers(0, 256, (1 << depth, 3)).astype(np.uint8) if color == 3 else None
        path = tmp_path / f"c{color}_{depth}.png"
        _filtered_png(path, rows, w, depth, color, ftypes, pal)
        got, got_pal = png.read_png(path)
        np.testing.assert_array_equal(got, pixels[..., 0] if ch == 1 else pixels)
        if color == 3:
            np.testing.assert_array_equal(got_pal, pal)
            np.testing.assert_array_equal(png.to_rgb(got, got_pal), np.asarray(
                Image.open(path).convert("RGB")))


def _natural(rng, h, w):
    """A smooth image with noise: Pillow's adaptive filters pick several
    filter types on it."""
    y, x = np.mgrid[0:h, 0:w]
    base = np.stack([x * 255 / w, y * 255 / h, (x + y) * 127 / (h + w)], -1)
    return np.clip(base + rng.normal(0, 6, (h, w, 3)), 0, 255).astype(np.uint8)


def _pil_image(kind, rng):
    h, w = 48, 70
    if kind == "rgb":
        return Image.fromarray(_natural(rng, h, w)), {}
    if kind == "rgba":
        a = rng.integers(0, 256, (h, w, 1)).astype(np.uint8)
        return Image.fromarray(np.concatenate([_natural(rng, h, w), a], -1), "RGBA"), {}
    if kind == "gray":
        return Image.fromarray(_natural(rng, h, w)[..., 0]), {}
    if kind == "la":
        return Image.fromarray(_natural(rng, h, w)[..., :2], "LA"), {}
    bits = {"palette": 8, "palette4": 4, "palette2": 2, "palette1": 1}[kind]
    img = Image.fromarray(rng.integers(0, 1 << bits, (h, w)).astype(np.uint8), mode="P")
    img.putpalette(davis_palette(1 << bits).ravel().tolist())
    return img, ({"bits": bits} if bits < 8 else {})


@pytest.mark.parametrize(
    "kind", ["rgb", "rgba", "gray", "la", "palette", "palette4", "palette2", "palette1"])
def test_png_reads_pillow_files(tmp_path, kind):
    """Images Pillow writes (adaptive filters for RGB) decode to Pillow's
    own arrays, and to_rgb equals its convert("RGB")."""
    img, opts = _pil_image(kind, np.random.default_rng(1))
    path = tmp_path / f"{kind}.png"
    img.save(path, **opts)
    got, pal = png.read_png(path)
    ref = Image.open(path)
    np.testing.assert_array_equal(got, np.asarray(ref))
    np.testing.assert_array_equal(png.to_rgb(got, pal), np.asarray(ref.convert("RGB")))
    if kind == "rgb":  # the case the codec's slow filters exist for
        raw = zlib.decompress(b"".join(
            body for kind_, body in png._chunks(path.read_bytes(), path) if kind_ == b"IDAT"))
        stride = 70 * 3 + 1
        assert len({raw[y * stride] for y in range(48)}) >= 2


@pytest.mark.parametrize("kind", ["gray", "rgb", "palette"])
def test_png_written_by_the_port_reads_in_pillow(tmp_path, kind):
    rng = np.random.default_rng(2)
    path = tmp_path / f"{kind}.png"
    if kind == "rgb":
        pixels = _natural(rng, 31, 45)
        png.write_png(path, pixels)
    else:
        pixels = rng.integers(0, 256, (31, 45)).astype(np.uint8)
        png.write_png(path, pixels, davis_palette() if kind == "palette" else None)
    ref = Image.open(path)
    assert ref.mode == {"gray": "L", "rgb": "RGB", "palette": "P"}[kind]
    np.testing.assert_array_equal(np.asarray(ref), pixels)
    if kind == "palette":
        np.testing.assert_array_equal(
            np.asarray(ref.getpalette(), np.uint8).reshape(-1, 3)[:256], davis_palette())
    got, _ = png.read_png(path)
    np.testing.assert_array_equal(got, pixels)


def test_png_refuses_what_it_cannot_read(tmp_path):
    """Corrupt files and invalid headers raise with the file's name, and
    the writer takes uint8 only."""
    p16 = tmp_path / "sixteen.png"
    Image.fromarray(np.arange(600, dtype=np.uint16).reshape(20, 30)).save(p16)
    bad = tmp_path / "corrupt.png"
    data = bytearray(p16.read_bytes())
    data[40] ^= 0xFF
    bad.write_bytes(bytes(data))
    with pytest.raises(ValueError, match="corrupt.png"):
        png.read_png(bad)
    invalid = tmp_path / "palette16.png"
    _filtered_png(invalid, np.zeros((4, 10), np.uint8), 5, 16, 3, [0] * 4,
                  palette=np.zeros((2, 3), np.uint8))
    with pytest.raises(ValueError, match="palette16.png.*invalid PNG header"):
        png.read_png(invalid)
    short = tmp_path / "short.png"
    _sample_png(short, np.zeros((9, 9, 1), np.uint8), 8, 0, interlace=1)
    data = short.read_bytes()
    _png_file(short, zlib.decompress(b"".join(
        body for k, body in png._chunks(data, short) if k == b"IDAT"))[:-1], 9, 9, 8, 0,
        interlace=1)
    with pytest.raises(ValueError, match="short.png: PNG data holds"):
        png.read_png(short)
    with pytest.raises(ValueError, match="uint8"):
        png.write_png(tmp_path / "x.png", np.zeros((2, 2), np.float32))


# (color type, depth, channels) of the images the Pillow-mode cases write:
# every depth the specification allows, plain and Adam7.
_MODES = [(0, 1, 1), (0, 2, 1), (0, 4, 1), (0, 8, 1), (0, 16, 1), (2, 8, 3), (2, 16, 3),
          (3, 1, 1), (3, 2, 1), (3, 4, 1), (3, 8, 1), (4, 8, 2), (4, 16, 2), (6, 8, 4),
          (6, 16, 4)]


@pytest.mark.parametrize("interlace", [0, 1])
@pytest.mark.parametrize("hw", [(13, 11), (3, 2), (17, 33)])
def test_png_reads_every_depth_and_interlace_as_pillow(tmp_path, hw, interlace):
    """Every color type at every bit depth, plain and Adam7-interlaced
    (the (3, 2) image leaves passes empty), reads as Pillow reads it:
    read_png as np.asarray(Image.open), to_rgb as convert("RGB"), and an
    annotation through load_indexed_png as the JAX package's reader."""
    from premvos_tpu.data import palette as jpal

    rng = np.random.default_rng(hw[0] + interlace)
    for color, depth, ch in _MODES:
        samples = rng.integers(0, 1 << depth, (*hw, ch)).astype(np.uint16)
        if depth == 16 and color == 0:
            samples[0, : hw[1] // 2] %= 300  # some gray below and near 255
        pal = davis_palette(1 << depth) if color == 3 else None
        path = tmp_path / f"c{color}_d{depth}_i{interlace}.png"
        _sample_png(path, samples, depth, color, pal, interlace, seed=color * 17 + depth)
        ref = Image.open(path)
        got, got_pal = png.read_png(path)
        want = np.asarray(ref)
        assert got.dtype == want.dtype and got.shape == want.shape, (color, depth)
        np.testing.assert_array_equal(got, want, err_msg=f"{color}/{depth}")
        np.testing.assert_array_equal(png.to_rgb(got, got_pal), np.asarray(ref.convert("RGB")),
                                      err_msg=f"{color}/{depth}")
        np.testing.assert_array_equal(load_indexed_png(path), jpal.load_indexed_png(path),
                                      err_msg=f"{color}/{depth}")


def test_png_reads_pillow_written_16_bit_gray(tmp_path):
    """A 16-bit gray file Pillow writes ("I;16") reads as its array, its
    frame as convert("RGB") (clipped at 255), and its annotation as the JAX
    reader's."""
    from premvos_tpu.data import palette as jpal

    a = np.random.default_rng(4).integers(0, 520, (21, 30)).astype(np.uint16)
    path = tmp_path / "i16.png"
    Image.fromarray(a).save(path)
    got, pal = png.read_png(path)
    np.testing.assert_array_equal(got, a)
    np.testing.assert_array_equal(png.to_rgb(got, pal), np.asarray(Image.open(path).convert("RGB")))
    np.testing.assert_array_equal(load_indexed_png(path), jpal.load_indexed_png(path))
    np.testing.assert_array_equal(tdavis.read_frame(path),
                                  np.asarray(Image.open(path).convert("RGB")))


def test_label_pngs_match_pillow_both_ways(tmp_path):
    """save_indexed_png / load_indexed_png against the JAX package's (Pillow)
    versions, including an RGB annotation mapped back through the palette."""
    from premvos_tpu.data import palette as jpal

    lab = np.random.default_rng(3).integers(0, 6, (40, 50)).astype(np.uint8)
    save_indexed_png(tmp_path / "port.png", lab)
    jpal.save_indexed_png(tmp_path / "jax.png", lab)
    for p in ("port.png", "jax.png"):
        np.testing.assert_array_equal(jpal.load_indexed_png(tmp_path / p), lab)
        np.testing.assert_array_equal(load_indexed_png(tmp_path / p), lab)
    rgb = davis_palette()[lab]
    rgb[0, 0] = (1, 2, 3)  # not a palette color
    Image.fromarray(rgb).save(tmp_path / "rgb.png")
    np.testing.assert_array_equal(
        load_indexed_png(tmp_path / "rgb.png"), jpal.load_indexed_png(tmp_path / "rgb.png"))


def test_davis_reader_needs_pillow_only_for_jpeg(tmp_path, monkeypatch):
    """With Pillow unimportable a PNG tree still loads, equal to the JAX
    reader's arrays, and so does a tree of JPEG frames (the port's own
    decoder; Pillow is needed by neither)."""
    root = tdavis.make_synthetic_davis(tmp_path / "png", t=3, hw=(30, 40))
    want = jdavis.DavisDataset(root).load_sequence("seq_a", 32, 48, 2)
    jroot = jdavis.make_synthetic_davis(tmp_path / "jpg", t=2, hw=(30, 40))
    jwant = jdavis.DavisDataset(jroot).load_sequence("seq_a", 32, 48, 2)
    monkeypatch.setitem(sys.modules, "PIL", None)
    for tree, expect in ((root, want), (jroot, jwant)):
        got = tdavis.DavisDataset(tree).load_sequence("seq_a", 32, 48, 2)
        for k in ("frames", "gt_masks", "gt_labels", "intro_frames"):
            np.testing.assert_array_equal(got[k], expect[k])
        assert got["orig_hw"] == expect["orig_hw"] == (30, 40)


# --------------------------------------------------------- J&F measures


@pytest.mark.parametrize("radius", range(1, 21))
def test_ellipse_element_matches_cv2(radius):
    want = cv2.getStructuringElement(cv2.MORPH_ELLIPSE, (2 * radius + 1, 2 * radius + 1))
    np.testing.assert_array_equal(teval.ellipse_element(radius), want)


def _label_maps(rng, t, h, w, k):
    """t blobby label maps with ids 0..k (a coarse random field upsampled,
    plus speckle), so boundaries are long and touch the image's edges."""
    out = []
    for _ in range(t):
        coarse = rng.integers(0, k + 1, (h // 8 + 1, w // 8 + 1))
        lab = np.kron(coarse, np.ones((8, 8), np.int64))[:h, :w]
        speck = rng.random((h, w)) < 0.01
        lab[speck] = rng.integers(0, k + 1, speck.sum())
        out.append(lab.astype(np.int32))
    return np.stack(out)


@pytest.mark.parametrize("hw", [(37, 53), (480, 854)])
def test_j_and_f_match_jax(hw):
    """j_measure and f_measure against the JAX package's (OpenCV) on blobby
    masks, one pair of them empty, one half-empty."""
    rng = np.random.default_rng(4)
    pred, gt = _label_maps(rng, 2, *hw, 3)
    pairs = [(pred == i, gt == i) for i in range(4)]
    pairs += [(np.zeros(hw, bool), np.zeros(hw, bool)), (pred == 1, np.zeros(hw, bool))]
    for p, g in pairs:
        assert abs(teval.j_measure(p, g) - jeval.j_measure(p, g)) <= 1e-12
        assert abs(teval.f_measure(p, g) - jeval.f_measure(p, g)) <= 1e-12


def test_evaluate_sequence_and_dataset_match_jax():
    rng = np.random.default_rng(5)
    results = {"port": [], "jax": []}
    for t, hw in ((6, (48, 64)), (3, (30, 41))):
        pred, gt = _label_maps(rng, t, *hw, 3), _label_maps(rng, t, *hw, 3)
        got = teval.evaluate_sequence(pred, gt, 3)
        want = jeval.evaluate_sequence(pred, gt, 3)
        for key in ("J", "F", "J&F"):
            assert abs(got[key] - want[key]) <= 1e-12
        assert got["per_object"].keys() == want["per_object"].keys()
        for obj, m in want["per_object"].items():
            for key in ("J", "F"):
                assert abs(got["per_object"][obj][key] - m[key]) <= 1e-12
        results["port"].append(got)
        results["jax"].append(want)
    got, want = teval.evaluate_dataset(results["port"]), jeval.evaluate_dataset(results["jax"])
    assert got.keys() == want.keys()
    for key in want:
        assert abs(got[key] - want[key]) <= 1e-12


# ------------------------------------------------------ files and config


@pytest.mark.parametrize("with_reid", [False, True])
def test_proposals_json_matches_jax_bytes(tmp_path, with_reid):
    """For the same arrays the port writes the JAX module's bytes, and each
    reads the other's file into the same arrays."""
    rng = np.random.default_rng(6)
    n, h, w = 5, 20, 30
    boxes = np.sort(rng.uniform(0, 30, (n, 2, 2)), axis=1).reshape(n, 4).astype(np.float32)
    kw = dict(
        boxes=boxes, scores=rng.uniform(0, 1, n).astype(np.float32),
        masks=(rng.random((n, h, w)) < 0.3).astype(np.uint8),
        valid=np.array([True, True, False, True, False]),
        embeddings=rng.standard_normal((n, 8)).astype(np.float32) if with_reid else None,
    )
    tprops.save_proposals(tmp_path / "port.json", tprops.FrameProposals(**kw))
    jprops.save_proposals(tmp_path / "jax.json", jprops.FrameProposals(**kw))
    assert (tmp_path / "port.json").read_bytes() == (tmp_path / "jax.json").read_bytes()
    got = tprops.load_proposals(tmp_path / "jax.json", 6, (h, w))
    want = jprops.load_proposals(tmp_path / "port.json", 6, (h, w))
    for f in ("boxes", "scores", "masks", "valid", "embeddings"):
        if getattr(want, f) is None:
            assert getattr(got, f) is None
        else:
            np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    assert got.count == 3


@pytest.mark.parametrize("preset", [None] + sorted(glob.glob("configs/*.json")))
def test_save_config_matches_jax_bytes(tmp_path, preset):
    jcfg = jc.load_config(preset) if preset else jc.PremvosConfig()
    tcfg = tc.load_config(preset) if preset else tc.PremvosConfig()
    jc.save_config(tmp_path / "jax.json", jcfg)
    tc.save_config(tmp_path / "port.json", tcfg)
    assert (tmp_path / "port.json").read_bytes() == (tmp_path / "jax.json").read_bytes()
    assert dataclasses.asdict(tc.load_config(tmp_path / "jax.json")) == dataclasses.asdict(tcfg)
    assert dataclasses.asdict(jc.load_config(tmp_path / "port.json")) == dataclasses.asdict(jcfg)


def test_pad_crop_and_save_results_match_jax(tmp_path):
    rng = np.random.default_rng(7)
    frames = rng.integers(0, 256, (2, 90, 120, 3)).astype(np.uint8)
    got = pad_to(torch.from_numpy(frames), 96, 128)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jax_pad_to(jnp.asarray(frames), 96, 128)))
    labels = rng.integers(0, 4, (3, 96, 128)).astype(np.int32)
    out = tdavis.crop_result(labels, (90, 120))
    np.testing.assert_array_equal(out, jdavis.crop_result(labels, (90, 120)))
    tdavis.save_results(tmp_path, "s", out, ["a.png", "b.png", "c.png"])
    tdavis.save_results(tmp_path, "d", out)
    for i, name in enumerate(["a.png", "b.png", "c.png"]):
        np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "s" / name)), out[i])
        np.testing.assert_array_equal(
            np.asarray(Image.open(tmp_path / "d" / f"{i:05d}.png")), out[i])


# ------------------------------------------------------------- prefetch


class _SlowDataset:
    """Sequences whose loads finish out of order (the first is slowest)."""

    def __init__(self, n):
        self.delays = {f"s{i}": 0.05 * (n - i) for i in range(n)}

    def load_sequence(self, name, h, w, k, max_frames=None):
        import time

        time.sleep(self.delays[name])
        i = int(name[1:])
        return {"frames": np.full((2, h, w, 3), i, np.uint8),
                "gt_masks": np.full((k, h, w), i, np.float32),
                "intro_frames": np.zeros((k,), np.int32),
                "gt_labels": np.zeros((0, h, w), np.int32), "name": name}


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_prefetch_keeps_order_and_device(depth):
    names = [f"s{i}" for i in range(4)]
    seen = []
    for name, seq in prefetch_sequences(_SlowDataset(4), names, 8, 8, 2, depth=depth,
                                        device="cpu"):
        seen.append(name)
        for k in ("frames", "gt_masks", "intro_frames"):
            assert isinstance(seq[k], torch.Tensor) and seq[k].device.type == "cpu"
        assert int(seq["frames"][0, 0, 0, 0]) == int(name[1:])
        assert seq["frames"].dtype == torch.uint8 and seq["gt_masks"].dtype == torch.float32
        assert isinstance(seq["gt_labels"], np.ndarray)
    assert seen == names


def test_prefetch_loads_the_dataset_and_needs_a_device(tmp_path, monkeypatch):
    root = tdavis.make_synthetic_davis(tmp_path / "d", sequences=("a", "b"), t=2, hw=(30, 40))
    ds = tdavis.DavisDataset(root)
    for name, seq in prefetch_sequences(ds, ["b", "a"], 32, 48, 2, device="cpu"):
        want = ds.load_sequence(name, 32, 48, 2)
        np.testing.assert_array_equal(seq["frames"].numpy(), want["frames"])
        np.testing.assert_array_equal(seq["gt_masks"].numpy(), want["gt_masks"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        next(prefetch_sequences(ds, ["a"], 32, 48, 2))


def test_logging_helpers():
    results = {}
    for _ in range(2):
        with tlog.stage_timer("x", results) as holder:
            holder["out"] = {"a": [torch.ones(3)]}
    assert results["x"] > 0
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with tlog.trace_annotation("premvos_span"):
            torch.ones(2) + 1
    assert any(e.key == "premvos_span" for e in prof.key_averages())
    assert tlog.get_logger() is tlog.get_logger()
