"""The port's JPEG decoder (io_compat/jpeg.py over kernels/jpeg_decode.cc,
built here with g++) against Pillow, and the DAVIS reader on a JPEG tree
against the JAX package's.

Every case must equal `np.asarray(Image.open(p).convert("RGB"))` bit for
bit. Pillow writes the baseline, progressive, restart and odd-size cases at
the qualities the JAX fixtures use (75 by default, 95 in
data/davis.py::make_synthetic_davis, 96 in data/synthetic_vos.py). It only
writes 4:4:4, 4:2:2 and 4:2:0, so `_encode` below writes the other
sampling factors (4:4:0, 4:1:1, mixed chroma factors), gray at 2×2 and the
RGB-coded files (component ids 'R', 'G', 'B'; Adobe transform 0) and the
four-component files Pillow cannot write (YCCK, Adobe transform 2; CMYK
without the Adobe marker; CMYK with subsampled components): a plain
baseline encoder whose output Pillow then decodes as the reference.
"""

import io

import numpy as np
import pytest
from PIL import Image, ImageFile

from premvos_tpu.data import davis as jdavis
from premvos_tpu_torch import kernels
from premvos_tpu_torch.data import davis as tdavis
from premvos_tpu_torch.io_compat import jpeg


def _image(h, w, seed=0):
    """Smooth gradients, edges and noise: every coefficient band in use."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    a = np.stack([128 + 100 * np.sin(xx / 7.0 + yy / 13.0), 128 + 90 * np.cos(yy / 5.0),
                  (xx * 3 + yy * 2) % 256], -1)
    a[h // 3: h // 2, w // 4: w // 2] = (250, 10, 120)
    return np.clip(a + rng.normal(0, 20, a.shape), 0, 255).astype(np.uint8)


def _pillow(arr, **kw):
    # A progressive 4:4:4 file at 481×855 outgrows Pillow's default buffer.
    ImageFile.MAXBLOCK = max(ImageFile.MAXBLOCK, 1 << 22)
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, "JPEG", **kw)
    return buf.getvalue()


def _pillow_rgb(data):
    return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))


# (name, (H, W), Pillow's save arguments, gray)
PILLOW_CASES = [
    ("q75", (64, 96), {}, False),
    ("q95", (64, 96), dict(quality=95), False),
    ("q96", (64, 96), dict(quality=96), False),
    ("444", (64, 96), dict(quality=90, subsampling=0), False),
    ("422", (64, 96), dict(quality=90, subsampling=1), False),
    ("420", (64, 96), dict(quality=90, subsampling=2), False),
    ("gray", (57, 91), dict(quality=85), True),
    ("progressive", (64, 96), dict(quality=90, progressive=True), False),
    ("progressive_444", (61, 83), dict(quality=90, subsampling=0, progressive=True), False),
    ("progressive_gray", (57, 91), dict(quality=85, progressive=True), True),
    ("restart_blocks", (97, 131), dict(quality=80, restart_marker_blocks=3), False),
    ("restart_rows_422", (97, 131), dict(quality=80, subsampling=1, restart_marker_rows=1),
     False),
    ("restart_progressive", (97, 131), dict(quality=80, restart_marker_rows=1,
                                            progressive=True), False),
    ("optimized_tables", (64, 96), dict(quality=80, optimize=True), False),
    ("q10", (64, 96), dict(quality=10), False),
    ("q100_444", (64, 96), dict(quality=100, subsampling=0), False),
    ("odd_17x23", (17, 23), dict(quality=90), False),
    ("odd_17x23_422", (17, 23), dict(quality=90, subsampling=1), False),
    ("odd_481x855", (481, 855), dict(quality=95), False),
    ("odd_481x855_progressive_444", (481, 855), dict(quality=90, subsampling=0,
                                                     progressive=True), False),
    ("tiny_2x3", (2, 3), dict(quality=90), False),
    ("narrow_33x5", (33, 5), dict(quality=90), False),
    ("frame_480x854_q96", (480, 854), dict(quality=96), False),
]


@pytest.mark.parametrize("name,hw,kw,gray", PILLOW_CASES, ids=[c[0] for c in PILLOW_CASES])
def test_decoder_equals_pillow(name, hw, kw, gray, tmp_path):
    arr = _image(*hw, seed=len(name))
    if gray:
        arr = arr[..., 0].copy()
    path = tmp_path / f"{name}.jpg"
    path.write_bytes(_pillow(arr, **kw))
    got = jpeg.read_jpeg(path)
    assert got.dtype == np.uint8 and got.shape == (*hw, 3)
    np.testing.assert_array_equal(got, _pillow_rgb(path.read_bytes()))


# ------------------------------------------------ a plain baseline encoder

_ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5, 12, 19, 26, 33, 40, 48, 41, 34, 27,
    20, 13, 6, 7, 14, 21, 28, 35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63])
_DCT = np.array([[(np.sqrt(1 / 8) if u == 0 else 0.5) * np.cos((2 * x + 1) * u * np.pi / 16)
                  for x in range(8)] for u in range(8)])
# One DC table (categories 0-11, 4-bit codes) and one AC table (EOB, ZRL and
# every run/size symbol, 8-bit codes): a symbol's code is its index.
_DC_SYMBOLS = list(range(12))
_AC_SYMBOLS = [0x00, 0xF0] + [(r << 4) | s for r in range(16) for s in range(1, 11)]


class _Bits:
    def __init__(self):
        self.out, self.acc, self.n = bytearray(), 0, 0

    def put(self, value, n):
        for i in range(n - 1, -1, -1):
            self.acc = (self.acc << 1) | ((value >> i) & 1)
            self.n += 1
            if self.n == 8:
                self.out.append(self.acc)
                if self.acc == 0xFF:
                    self.out.append(0)
                self.acc, self.n = 0, 0

    def align(self):
        while self.n:
            self.put(1, 1)


def _category(v):
    return int(abs(v)).bit_length()


def _put_value(bits, v):
    s = _category(v)
    bits.put(v if v >= 0 else v + (1 << s) - 1, s)


def _encode(planes, factors, ids=(1, 2, 3), jfif=True, adobe=None, restart=0, quant=3):
    """Baseline JPEG of `planes` (float [H, W] each, 0..255, in the coded
    color space) with sampling factors `factors` [(h, v), ...]: box-filtered
    chroma, one quantization table of `quant`, the tables above."""
    hgt, wid = planes[0].shape
    hmax, vmax = max(f[0] for f in factors), max(f[1] for f in factors)
    mcux, mcuy = -(-wid // (8 * hmax)), -(-hgt // (8 * vmax))
    comps = []
    for plane, (h, v) in zip(planes, factors):
        dh, dw = -(-hgt * v // vmax), -(-wid * h // hmax)
        ry, rx = vmax // v, hmax // h
        p = np.pad(plane, ((0, dh * ry - hgt), (0, dw * rx - wid)), mode="edge")
        p = p.reshape(dh, ry, dw, rx).mean((1, 3))
        p = np.pad(p, ((0, mcuy * v * 8 - dh), (0, mcux * h * 8 - dw)), mode="edge")
        blocks = p.reshape(mcuy * v, 8, mcux * h, 8).transpose(0, 2, 1, 3) - 128.0
        coef = np.round(_DCT @ blocks @ _DCT.T / quant).astype(np.int64)
        comps.append((coef.reshape(*coef.shape[:2], 64)[..., _ZIGZAG], h, v, dh, dw))

    bits, preds = _Bits(), [0] * len(comps)

    def block(ci, zz):
        diff = int(zz[0]) - preds[ci]
        preds[ci] = int(zz[0])
        bits.put(_DC_SYMBOLS.index(_category(diff)), 4)
        _put_value(bits, diff)
        run = 0
        for v in zz[1:]:
            if v == 0:
                run += 1
                continue
            while run > 15:
                bits.put(_AC_SYMBOLS.index(0xF0), 8)
                run -= 16
            bits.put(_AC_SYMBOLS.index((run << 4) | _category(v)), 8)
            _put_value(bits, int(v))
            run = 0
        if run:
            bits.put(_AC_SYMBOLS.index(0x00), 8)

    if len(comps) == 1:
        coef, _, _, dh, dw = comps[0]
        units = [[(0, coef[y, x])] for y in range(-(-dh // 8)) for x in range(-(-dw // 8))]
    else:
        units = [[(ci, coef[my * v + j, mx * h + i])
                  for ci, (coef, h, v, _, _) in enumerate(comps)
                  for j in range(v) for i in range(h)]
                 for my in range(mcuy) for mx in range(mcux)]
    for n, unit in enumerate(units):
        if restart and n and n % restart == 0:
            bits.align()
            bits.out += bytes([0xFF, 0xD0 + (n // restart - 1) % 8])
            preds = [0] * len(comps)
        for ci, zz in unit:
            block(ci, zz)
    bits.align()

    def seg(marker, body):
        return bytes([0xFF, marker]) + (len(body) + 2).to_bytes(2, "big") + bytes(body)

    out = b"\xff\xd8"
    if jfif:
        out += seg(0xE0, b"JFIF\0\x01\x01\x00\x00\x01\x00\x01\x00\x00")
    if adobe is not None:
        out += seg(0xEE, b"Adobe\x00\x64\x00\x00\x00\x00" + bytes([adobe]))
    out += seg(0xDB, bytes([0]) + bytes([quant] * 64))
    sof = [8, *hgt.to_bytes(2, "big"), *wid.to_bytes(2, "big"), len(comps)]
    for cid, (h, v) in zip(ids, factors):
        sof += [cid, (h << 4) | v, 0]
    out += seg(0xC0, sof)
    dht = [0x00] + [12 if n == 4 else 0 for n in range(1, 17)] + _DC_SYMBOLS
    dht += [0x10] + [162 if n == 8 else 0 for n in range(1, 17)] + _AC_SYMBOLS
    out += seg(0xC4, dht)
    if restart:
        out += seg(0xDD, restart.to_bytes(2, "big"))
    sos = [len(comps)]
    for cid in ids[:len(comps)]:
        sos += [cid, 0x00]
    out += seg(0xDA, sos + [0, 63, 0]) + bytes(bits.out) + b"\xff\xd9"
    return out


def _ycc(rgb):
    r, g, b = (rgb[..., i].astype(np.float64) for i in range(3))
    return [0.299 * r + 0.587 * g + 0.114 * b,
            -0.168736 * r - 0.331264 * g + 0.5 * b + 128,
            0.5 * r - 0.418688 * g - 0.081312 * b + 128]


# (name, (H, W), sampling factors, encoder arguments, planes)
ENCODED_CASES = [
    ("440", (37, 29), [(1, 2), (1, 1), (1, 1)], {}, "ycc"),
    ("440_restart", (45, 61), [(1, 2), (1, 1), (1, 1)], dict(restart=2), "ycc"),
    ("411", (37, 61), [(4, 1), (1, 1), (1, 1)], {}, "ycc"),
    ("chroma_h2v1_of_y22", (37, 29), [(2, 2), (1, 2), (1, 2)], {}, "ycc"),
    ("chroma_h1v2_of_y22", (37, 29), [(2, 2), (2, 1), (2, 1)], {}, "ycc"),
    ("420_restart_3", (45, 61), [(2, 2), (1, 1), (1, 1)], dict(restart=3), "ycc"),
    ("420_narrow", (19, 3), [(2, 2), (1, 1), (1, 1)], {}, "ycc"),
    ("gray_2x2", (37, 29), [(2, 2)], {}, "gray"),
    ("rgb_ids", (37, 29), [(1, 1)] * 3, dict(ids=(82, 71, 66), jfif=False), "rgb"),
    ("adobe_rgb", (37, 29), [(1, 1)] * 3, dict(jfif=False, adobe=0), "rgb"),
    ("adobe_ycc", (37, 29), [(2, 1), (1, 1), (1, 1)], dict(jfif=False, adobe=1), "ycc"),
    ("no_markers_ycc", (37, 29), [(2, 2), (1, 1), (1, 1)], dict(jfif=False), "ycc"),
    ("ycck_adobe_2", (37, 29), [(1, 1)] * 4, dict(ids=(1, 2, 3, 4), jfif=False, adobe=2),
     "ycck"),
    ("ycck_adobe_2_420", (45, 61), [(2, 2), (1, 1), (1, 1), (2, 2)],
     dict(ids=(1, 2, 3, 4), jfif=False, adobe=2, restart=2), "ycck"),
    ("cmyk_adobe_0_h2v1", (37, 29), [(2, 1), (1, 1), (1, 1), (1, 1)],
     dict(ids=(1, 2, 3, 4), jfif=False, adobe=0), "cmyk"),
    ("cmyk_no_marker", (37, 29), [(1, 1)] * 4, dict(ids=(1, 2, 3, 4), jfif=False), "cmyk"),
]


@pytest.mark.parametrize("name,hw,factors,kw,planes", ENCODED_CASES,
                         ids=[c[0] for c in ENCODED_CASES])
def test_decoder_equals_pillow_on_other_sampling_and_color(name, hw, factors, kw, planes,
                                                           tmp_path):
    rgb = _image(*hw, seed=7)
    cmy = [255.0 - rgb[..., i] for i in range(3)]
    k = np.clip(_image(*hw, seed=8)[..., 1].astype(np.float64), 40, 220)
    data = {"ycc": _ycc(rgb), "rgb": [rgb[..., i].astype(np.float64) for i in range(3)],
            "gray": [_ycc(rgb)[0]], "cmyk": [*cmy, k], "ycck": [*_ycc(rgb), k]}[planes]
    path = tmp_path / f"{name}.jpg"
    path.write_bytes(_encode(data, factors, **kw))
    np.testing.assert_array_equal(jpeg.read_jpeg(path), _pillow_rgb(path.read_bytes()))


# (name, (H, W), Pillow's save arguments): Pillow writes CMYK inverted, with
# an Adobe marker of transform 0; its `subsampling` samples the first
# component (C) at 2×1 or 2×2 and the other three at 1×1.
CMYK_CASES = [
    ("q75", (64, 96), {}),
    ("q95_444", (61, 83), dict(quality=95, subsampling=0)),
    ("q90_422", (64, 96), dict(quality=90, subsampling=1)),
    ("q90_420", (61, 83), dict(quality=90, subsampling=2)),
    ("q95_progressive", (64, 96), dict(quality=95, progressive=True)),
    ("q80_restart_progressive_420", (97, 131), dict(quality=80, subsampling=2,
                                                    progressive=True, restart_marker_rows=1)),
]


def _adobe_stripped(data):
    """The file without its APP14 "Adobe" segment."""
    at = data.index(b"\xff\xee")
    end = at + 2 + int.from_bytes(data[at + 2:at + 4], "big")
    assert data[at + 4:at + 9] == b"Adobe"
    return data[:at] + data[end:]


@pytest.mark.parametrize("name,hw,kw", CMYK_CASES, ids=[c[0] for c in CMYK_CASES])
def test_decoder_equals_pillow_on_cmyk(name, hw, kw, tmp_path):
    """Pillow-written CMYK JPEGs (Adobe transform 0), and the same files
    without their Adobe marker, read as `Image.open(p).convert("RGB")`, the
    JAX reader's frame (premvos_tpu/data/davis.py:82)."""
    arr = np.array(Image.fromarray(_image(*hw, seed=len(name))).convert("CMYK"))
    arr[..., 3] = _image(*hw, seed=99)[..., 2] // 2  # a K plane of its own
    ImageFile.MAXBLOCK = max(ImageFile.MAXBLOCK, 1 << 22)
    buf = io.BytesIO()
    Image.fromarray(arr, "CMYK").save(buf, "JPEG", **kw)
    data = buf.getvalue()
    assert Image.open(io.BytesIO(data)).mode == "CMYK" and b"Adobe" in data
    for tag, body in (("adobe", data), ("no_marker", _adobe_stripped(data))):
        path = tmp_path / f"{name}_{tag}.jpg"
        path.write_bytes(body)
        got = jpeg.read_jpeg(path)
        assert got.shape == (*hw, 3)
        np.testing.assert_array_equal(got, _pillow_rgb(body), err_msg=tag)


# ------------------------------------------------------------- refusals

def _patched_sof(marker=None, precision=None):
    data = bytearray(_pillow(_image(16, 16)))
    at = data.index(b"\xff\xc0")
    if marker is not None:
        data[at + 1] = marker
    if precision is not None:
        data[at + 4] = precision
    return bytes(data)


REFUSALS = {
    "arithmetic": (lambda: _patched_sof(marker=0xC9), "arithmetic coding"),
    "progressive_arithmetic": (lambda: _patched_sof(marker=0xCA), "arithmetic coding"),
    "12_bit": (lambda: _patched_sof(marker=0xC1, precision=12), "12-bit samples"),
    "lossless": (lambda: _patched_sof(marker=0xC3), "lossless JPEG"),
    "hierarchical": (lambda: _patched_sof(marker=0xC5), "hierarchical"),
    "not_a_jpeg": (lambda: b"\x89PNG\r\n\x1a\n" + bytes(32), "not a JPEG"),
    "truncated_header": (lambda: _pillow(_image(16, 16))[:40], "truncated"),
}


@pytest.mark.parametrize("case", list(REFUSALS))
def test_decoder_refusals_name_file_and_feature(case, tmp_path):
    make, feature = REFUSALS[case]
    path = tmp_path / f"{case}.jpg"
    path.write_bytes(make())
    with pytest.raises(ValueError, match=f"{case}.jpg: .*{feature}"):
        jpeg.read_jpeg(path)


def test_truncated_scan_data_does_not_crash(tmp_path):
    """A file cut inside its scan data, or just before its EOI marker, is
    refused as Pillow refuses it ("image file is truncated"): the port
    raises a ValueError naming the file, and reads nothing past the
    buffer. (Pillow decodes some files that lack only their EOI, where
    libjpeg's read-ahead happens not to pass the end; the port refuses
    every file that ends before EOI.)"""
    for kw in (dict(quality=90), dict(quality=90, progressive=True),
               dict(quality=80, restart_marker_blocks=3)):
        data = _pillow(_image(64, 96), **kw)
        for cut in (len(data) // 2, len(data) * 2 // 3, len(data) - 20, len(data) - 2):
            path = tmp_path / "cut.jpg"
            path.write_bytes(data[:cut])
            with pytest.raises(OSError, match="truncated"):
                _pillow_rgb(data[:cut])
            with pytest.raises(ValueError, match="cut.jpg: truncated file"):
                jpeg.read_jpeg(path)


def test_failed_build_raises_and_never_falls_back(monkeypatch, tmp_path):
    def broken(source):
        raise RuntimeError(f"building {source} failed")

    monkeypatch.setattr(kernels, "build_host", broken)
    monkeypatch.setattr(jpeg, "_lib", None)
    path = tmp_path / "a.jpg"
    path.write_bytes(_pillow(_image(16, 16)))
    with pytest.raises(RuntimeError, match="jpeg_decode.cc"):
        jpeg.read_jpeg(path)


# ---------------------------------------------------------- the readers

def test_davis_reader_on_a_jpeg_tree_equals_jax(tmp_path):
    """The JAX package's fixture (JPEG frames at quality 95, palette
    annotations) read by both packages' DavisDataset."""
    root = jdavis.make_synthetic_davis(tmp_path / "davis", sequences=("a", "b"), t=3,
                                       hw=(61, 93))
    jds, tds = jdavis.DavisDataset(root), tdavis.DavisDataset(root)
    assert tds.sequences == jds.sequences == ["a", "b"]
    for seq in tds.sequences:
        assert [p.suffix for p in tds.frame_paths(seq)] == [".jpg"] * 3
        want = jds.load_sequence(seq, 64, 96, max_objects=3)
        got = tds.load_sequence(seq, 64, 96, max_objects=3)
        assert set(got) == set(want)
        for key, value in want.items():
            if isinstance(value, np.ndarray):
                np.testing.assert_array_equal(got[key], value, err_msg=key)
            else:
                assert got[key] == value, key


def test_read_frame_refuses_other_formats(tmp_path):
    path = tmp_path / "00000.bmp"
    path.write_bytes(b"BM" + bytes(64))
    with pytest.raises(ValueError, match="00000.bmp"):
        tdavis.read_frame(path)
