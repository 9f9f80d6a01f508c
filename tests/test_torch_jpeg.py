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

The codings Pillow reads but cannot write (arithmetic-coded sequential and
progressive JPEG, lossless JPEG, a progressive frame cut before its later
scans) are committed in tests/data/jpeg/codings, written by
scripts/make_jpeg_codings_fixtures.py over libjpeg; the tests also cut
progressive files before each scan (libjpeg block-smooths what is left) and
cut files before their end (the truncation sweep), and Pillow decodes every
one of them as the reference.
"""

import functools
import io
import os

import numpy as np
import pytest
from PIL import Image, ImageFile

from premvos_tpu.data import davis as jdavis
from premvos_tpu_torch import kernels
from premvos_tpu_torch.data import davis as tdavis
from premvos_tpu_torch.io_compat import jpeg
from premvos_tpu_torch.io_compat.png import read_png, write_png
from tests import _jpeg_damage
from tests._threads import few_threads  # noqa: F401

CODINGS = os.path.join(os.path.dirname(__file__), "data", "jpeg", "codings")


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


# ------------------------------------ arithmetic, lossless, smoothing

CODING_FILES = sorted(f[:-4] for f in os.listdir(CODINGS) if f.endswith(".jpg"))
# The frame header each fixture's name promises.
SOF = {"arith_seq": 0xC9, "arith_prog": 0xCA, "lossless": 0xC3, "frame_arith_seq": 0xC9,
       "frame_arith_prog": 0xCA, "frame_lossless": 0xC3, "frame_smoothed": 0xC2}


def _sof_marker(data):
    for marker in (0xC0, 0xC1, 0xC2, 0xC3, 0xC9, 0xCA):
        if bytes([0xFF, marker]) in data:
            return marker
    return None


@pytest.mark.parametrize("name", CODING_FILES)
def test_decoder_equals_pillow_on_codings(name, monkeypatch):
    """Every committed fixture (scripts/make_jpeg_codings_fixtures.py):
    arithmetic-coded sequential and progressive files, lossless files at
    predictors 1-7 and point transforms 0 and 2, and the 480×854 frames,
    equal to Pillow's decode of the file and to the committed decode the
    card checks against."""
    path = os.path.join(CODINGS, name + ".jpg")
    data = _coding(name)
    prefix = next(p for p in sorted(SOF, key=len, reverse=True) if name.startswith(p))
    assert _sof_marker(data) == SOF[prefix]
    got = jpeg.read_jpeg(path)
    monkeypatch.setattr(ImageFile, "MAXBLOCK", 65536)  # Pillow's default read block
    with Image.open(path) as im:
        want = np.asarray(im.convert("RGB"))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, read_png(os.path.join(CODINGS, "decoded", name + ".png"))[0])


def test_arithmetic_file_past_pillows_read_block(monkeypatch):
    """Pillow hands libjpeg 64 KiB at a time (ImageFile.MAXBLOCK), and
    libjpeg's arithmetic decoder cannot wait for the next block (jdarith.c
    get_byte: JERR_CANT_SUSPEND): Pillow refuses an arithmetic-coded file
    whose scan data crosses its first block ("broken data stream"), and so
    does the port. The limit of that rule: at a larger block Pillow reads
    the file; the port follows the default block, which the JAX package
    leaves as it is."""
    path = os.path.join(CODINGS, "large", "arith_seq_444_240x320.jpg")
    data = _coding("large/arith_seq_444_240x320")
    assert len(data) > 65536 and _sof_marker(data) == 0xC9
    monkeypatch.setattr(ImageFile, "MAXBLOCK", 65536)
    assert _pillow_reads(path) is None
    with pytest.raises(ValueError, match="arithmetic-coded scan across a 64 KiB block"):
        jpeg.read_jpeg(path)
    monkeypatch.setattr(ImageFile, "MAXBLOCK", 1 << 20)
    assert _pillow_reads(path) is not None


def _scan_offsets(data):
    """The byte offset of each SOS marker."""
    out, i = [], 2
    while i < len(data) - 1:
        if data[i] == 0xFF and data[i + 1] not in (0x00, 0xFF) and not 0xD0 <= data[i + 1] <= 0xD7:
            if data[i + 1] in (0xD8, 0xD9):
                i += 2
                continue
            if data[i + 1] == 0xDA:
                out.append(i)
            i += 2 + int.from_bytes(data[i + 2:i + 4], "big")
        else:
            i += 1
    return out


# Progressive files to cut before each scan: (name, maker). Pillow writes
# jpeg_simple_progression's ten scans (six for gray), successive
# approximation included; the arithmetic-coded ones are committed.
_PROGRESSIVE = {
    "huffman_gray_57x91": lambda: _pillow(_image(57, 91, seed=1)[..., 0].copy(), quality=85,
                                          progressive=True),
    "huffman_444_61x83": lambda: _pillow(_image(61, 83, seed=2), quality=90, subsampling=0,
                                         progressive=True),
    "huffman_422_37x53": lambda: _pillow(_image(37, 53, seed=3), quality=80, subsampling=1,
                                         progressive=True),
    "huffman_420_64x96": lambda: _pillow(_image(64, 96, seed=4), quality=75, progressive=True),
    "huffman_420_97x131_restart": lambda: _pillow(_image(97, 131, seed=5), quality=60,
                                                  progressive=True, restart_marker_blocks=2),
    "huffman_420_17x23": lambda: _pillow(_image(17, 23, seed=6), quality=95, progressive=True),
    "huffman_444_9x9": lambda: _pillow(_image(9, 9, seed=7), quality=90, subsampling=0,
                                       progressive=True),
    "huffman_420_33x200": lambda: _pillow(_image(33, 200, seed=8), quality=85,
                                          progressive=True),
}
_PROGRESSIVE.update({name: (lambda name=name: _coding(name))
                     for name in CODING_FILES if name.startswith("arith_prog_")})


@pytest.mark.parametrize("name", list(_PROGRESSIVE))
def test_decoder_equals_pillow_on_progressive_cut_before_each_scan(name, tmp_path):
    """A progressive file cut before scan k (EOI appended), for every k:
    libjpeg block-smooths each component whose coefficients 1-9 are not all
    refined (jdcoefct.c, libjpeg-turbo >= 2.1), from the 5×5 neighbourhood
    of DC values, and estimates the DC too while no coefficient 1-9 is
    known. Gray, 4:4:4, 4:2:2 and 4:2:0, sizes that are not whole MCUs,
    restart intervals, Huffman and arithmetic coding."""
    data = _PROGRESSIVE[name]()
    offsets = _scan_offsets(data)
    assert len(offsets) >= 6
    for k in range(1, len(offsets)):
        path = tmp_path / f"{name}_{k}.jpg"
        path.write_bytes(data[:offsets[k]] + b"\xff\xd9")
        got = jpeg.read_jpeg(path)
        np.testing.assert_array_equal(got, _pillow_rgb(path.read_bytes()),
                                      err_msg=f"cut before scan {k} of {len(offsets)}")


# ------------------------------------------------- the truncation sweep

def _gray(h, w, seed):
    return _image(h, w, seed=seed)[..., 0].copy()


# (name, maker, whether Pillow reads some of its cuts). Each file is cut by
# 1-16 bytes: gray, 4:2:0 and 4:4:4; baseline, progressive, restart
# intervals; arithmetic-coded and lossless too; small files (libjpeg's slow
# path throughout), files of 7-23 kB (its fast path first) and files past
# Pillow's 64 KiB read block.
SWEEP = [
    ("gray_64x96_q85", lambda: _pillow(_gray(64, 96, 3), quality=85), True),
    ("gray_37x53_q85", lambda: _pillow(_gray(37, 53, 6), quality=85), True),
    ("gray_57x91_q85", lambda: _pillow(_gray(57, 91, 1), quality=85), False),
    ("420_37x53_q75", lambda: _pillow(_image(37, 53, seed=0), quality=75), True),
    ("420_37x53_q75_b", lambda: _pillow(_image(37, 53, seed=7), quality=75), True),
    ("420_64x96_q75", lambda: _pillow(_image(64, 96, seed=2), quality=75), False),
    ("444_64x96_q90", lambda: _pillow(_image(64, 96, seed=34), quality=90, subsampling=0), True),
    ("444_64x96_q90_b", lambda: _pillow(_image(64, 96, seed=48), quality=90, subsampling=0),
     True),
    ("444_61x83_q90", lambda: _pillow(_image(61, 83, seed=5), quality=90, subsampling=0), False),
    ("restart_blocks_64x96", lambda: _pillow(_image(64, 96, seed=17), quality=80,
                                             restart_marker_blocks=3), True),
    ("restart_blocks_37x53", lambda: _pillow(_image(37, 53, seed=42), quality=80,
                                             restart_marker_blocks=3), True),
    ("restart_rows_97x131", lambda: _pillow(_image(97, 131, seed=9), quality=80,
                                            restart_marker_rows=1), False),
    ("progressive_420_64x96", lambda: _pillow(_image(64, 96, seed=4), quality=75,
                                              progressive=True), False),
    ("progressive_gray_57x91", lambda: _pillow(_gray(57, 91, 1), quality=85, progressive=True),
     False),
    ("progressive_444_restart", lambda: _pillow(_image(61, 83, seed=2), quality=90,
                                                subsampling=0, progressive=True,
                                                restart_marker_rows=1), False),
    ("fast_gray_120x160_q75", lambda: _pillow(_gray(120, 160, 40), quality=75), True),
    ("fast_gray_240x320_q60", lambda: _pillow(_gray(240, 320, 95), quality=60), True),
    ("fast_gray_120x160_q75_b", lambda: _pillow(_gray(120, 160, 80), quality=75), False),
    ("fast_444_96x200_q90", lambda: _pillow(_image(96, 200, seed=237), quality=90,
                                            subsampling=0), False),
    ("block_gray_480x854_q85", lambda: _pillow(_gray(480, 854, 0), quality=85), True),
    ("block_444_300x500_q97", lambda: _pillow(_image(300, 500, seed=78), quality=97,
                                              subsampling=0), True),
    ("arith_seq_gray_45x67", lambda: _coding("arith_seq_gray_45x67"), False),
    ("arith_seq_420_61x83_restart3", lambda: _coding("arith_seq_420_61x83_restart3"), False),
    ("arith_seq_444_33x5_dac", lambda: _coding("arith_seq_444_33x5_dac"), False),
    ("arith_prog_420_45x67", lambda: _coding("arith_prog_420_45x67"), False),
    ("lossless_p2_pt2_420", lambda: _coding("lossless_p2_pt2_420"), True),
    ("lossless_p7_pt2_gray_restart1", lambda: _coding("lossless_p7_pt2_gray_restart1"), True),
    ("lossless_p1_pt0_444_restart1", lambda: _coding("lossless_p1_pt0_444_restart1"), False),
]


def _pillow_reads(path):
    """Pillow's decode of the file at `path`, or None where it raises."""
    try:
        with Image.open(path) as im:
            return np.asarray(im.convert("RGB"))
    except OSError:
        return None


@pytest.mark.parametrize("name,make,pillow_reads_some", SWEEP, ids=[c[0] for c in SWEEP])
def test_truncation_sweep_matches_pillow(name, make, pillow_reads_some, tmp_path, monkeypatch):
    """A file cut by 1-16 bytes, opened by path at Pillow's default read
    block (ImageFile.MAXBLOCK, 64 KiB, which the JAX package leaves as it
    is), as the readers open frames. Pillow reads it where libjpeg asks for
    no byte past the end: a single-scan file (sequential, every component
    in its first scan) whose Huffman bit buffer is not refilled past the
    end (jdhuff.c: on its slow path to 57 bits when the next code or value
    needs more than is left; on its fast path, taken with 512 bytes a block
    of Pillow's block in hand, six bytes at 16 bits or fewer), or whose
    arithmetic decoder needs no byte past it. A multi-scan file is read to
    its EOI marker first and never. The port reads the same files, equal
    bit for bit, and refuses the rest as truncated; `pillow_reads_some`
    keeps both outcomes in the sweep."""
    data = make()
    monkeypatch.setattr(ImageFile, "MAXBLOCK", 65536)
    read = 0
    for cut in range(1, 17):
        path = tmp_path / f"{name}_{cut}.jpg"
        path.write_bytes(data[:-cut])
        want = _pillow_reads(path)
        if want is None:
            with pytest.raises(ValueError, match=f"{name}_{cut}.jpg: truncated file"):
                jpeg.read_jpeg(path)
            continue
        read += 1
        np.testing.assert_array_equal(jpeg.read_jpeg(path), want, err_msg=f"cut by {cut}")
    assert (read > 0) == pillow_reads_some


def test_truncation_depends_on_pillows_read_block(tmp_path, monkeypatch):
    """What is known of the rule's limits: for a file past 64 KiB it
    depends on Pillow's read block, because libjpeg decides its Huffman
    path by the bytes it has been handed. This 123 kB file cut by one byte
    is read at the default block (and the port reads it, bit for bit), and
    refused when Pillow hands over the whole file at once."""
    data = _pillow(_gray(300, 500, 70), quality=97, subsampling=1)
    path = tmp_path / "cut.jpg"
    path.write_bytes(data[:-1])
    monkeypatch.setattr(ImageFile, "MAXBLOCK", 65536)
    want = _pillow_reads(path)
    assert want is not None
    np.testing.assert_array_equal(jpeg.read_jpeg(path), want)
    monkeypatch.setattr(ImageFile, "MAXBLOCK", 1 << 22)
    assert _pillow_reads(path) is None


# ------------------------------------- restart damage and early ends

# Files with restart intervals to damage (tests/_jpeg_damage.py): Pillow-
# written baseline and progressive files, small and at 480×854 (larger
# than one of Pillow's 64 KiB read blocks), and the committed arithmetic
# and lossless codings.
RESTART_FILES = {
    "blocks_97x131": lambda: _pillow(_image(97, 131, 1), quality=80, restart_marker_blocks=3),
    "rows_422_97x131": lambda: _pillow(_image(97, 131, 2), quality=80, subsampling=1,
                                       restart_marker_rows=1),
    "progressive_rows_97x131": lambda: _pillow(_image(97, 131, 3), quality=80,
                                               progressive=True, restart_marker_rows=1),
    "frame_blocks": lambda: _pillow(_image(480, 854, 4), quality=95, restart_marker_blocks=4),
    "frame_rows": lambda: _pillow(_image(480, 854, 5), quality=95, restart_marker_rows=1),
    "frame_progressive": lambda: _pillow(_image(480, 854, 6), quality=90, progressive=True,
                                         restart_marker_rows=1),
    "arith_seq": lambda: _coding("arith_seq_420_61x83_restart3"),
    "arith_prog": lambda: _coding("arith_prog_420_61x83_restart3"),
    "lossless_444": lambda: _coding("lossless_p1_pt0_444_restart1"),
    "lossless_420": lambda: _coding("lossless_p6_pt0_420_restart2"),
}
RESTART_DAMAGE = ("drop", "drop_first", "drop_last", "swap", "duplicate", "garbage",
                  "rst+1", "rst-1", "rst+2", "rst-2", "rst+3", "rst-3")


@functools.lru_cache(maxsize=None)
def _file(table, name):
    return {"restart": RESTART_FILES, "early": EARLY_END_FILES}[table][name]()


def _equal_to_pillow(path):
    with Image.open(path) as im:
        want = np.asarray(im.convert("RGB"))
    np.testing.assert_array_equal(jpeg.read_jpeg(path), want)


@pytest.mark.parametrize("damage", RESTART_DAMAGE)
@pytest.mark.parametrize("name", list(RESTART_FILES))
def test_restart_damage_reads_as_pillow(name, damage, tmp_path, monkeypatch):
    """A restart marker dropped, swapped with the next, doubled, preceded by
    bytes that are no marker, or renumbered by ±1, ±2, ±3: libjpeg's
    read_restart_marker and jpeg_resync_to_restart (Pillow keeps libjpeg's
    default) read the expected marker, discard one too far away, pass over
    RST(n-1) and RST(n-2) to the next marker, or leave RST(n+1), RST(n+2)
    and any other marker unread, so that the coming interval reads as empty;
    Huffman sequential and progressive, arithmetic and lossless scans. Equal
    to Pillow's decode bit for bit."""
    path = tmp_path / f"{name}_{damage}.jpg"
    path.write_bytes(_jpeg_damage.restart_cases(_file("restart", name))[damage])
    monkeypatch.setattr(ImageFile, "MAXBLOCK", 65536)
    _equal_to_pillow(path)


# Files whose scan data is cut and closed with EOI: every coding, small and
# at 480×854, with and without restart intervals.
EARLY_END_FILES = {
    "baseline_97x131": lambda: _pillow(_image(97, 131, 7), quality=80),
    "frame_444": lambda: _pillow(_image(480, 854, 8), quality=95, subsampling=0),
    "frame_420": lambda: _pillow(_image(480, 854, 9), quality=75),
    "frame_restart_rows": lambda: _pillow(_image(480, 854, 5), quality=95,
                                          restart_marker_rows=1),
    "progressive_97x131": lambda: _pillow(_image(97, 131, 10), quality=80, progressive=True),
    "frame_progressive": lambda: _pillow(_image(480, 854, 11), quality=90, progressive=True),
    "progressive_rows_97x131": lambda: _pillow(_image(97, 131, 3), quality=80,
                                               progressive=True, restart_marker_rows=1),
    "frame_smoothed": lambda: _coding("frame_smoothed"),
    "frame_arith_seq": lambda: _coding("frame_arith_seq"),
    "frame_arith_prog": lambda: _coding("frame_arith_prog"),
    "arith_seq_restart": lambda: _coding("arith_seq_420_61x83_restart3"),
    "frame_lossless": lambda: _coding("frame_lossless"),
    "lossless_420": lambda: _coding("lossless_p2_pt2_420"),
    "lossless_restart": lambda: _coding("lossless_p6_pt0_420_restart2"),
}
EARLY_END_AT = (0.1, 0.3, 0.5, 0.7, 0.95)


@pytest.mark.parametrize("at", EARLY_END_AT)
@pytest.mark.parametrize("name", list(EARLY_END_FILES))
def test_early_end_reads_as_pillow(name, at, tmp_path, monkeypatch):
    """Scan data that ends early at a marker (the file cut at `at` of its
    length, EOI appended): libjpeg decodes the MCU in which the bits run
    out with zero bits, then sets insufficient_data and leaves every later
    MCU of the restart interval undecoded (jdhuff.c, jdphuff.c; jdlhuff.c
    zeroes the rows and restarts the predictors); a restart clears the flag
    only with no marker left unread. The arithmetic decoder reads zeros to
    the end instead. A progressive file's block smoothing takes the
    coefficient bits from before the cut scan for every iMCU row past the
    last one begun with data (jdcoefct.c, last_good_iMCU_row). The
    coefficients such scans leave go through the IDCT as libjpeg-turbo's
    SIMD code computes it, 16-bit wraps and saturation included."""
    path = tmp_path / f"{name}_{at}.jpg"
    path.write_bytes(_jpeg_damage.early_end(_file("early", name), at))
    monkeypatch.setattr(ImageFile, "MAXBLOCK", 65536)
    _equal_to_pillow(path)


DAMAGED = os.path.join(os.path.dirname(__file__), "data", "jpeg", "damaged")
DAMAGED_FILES = sorted(f[:-4] for f in os.listdir(DAMAGED) if f.endswith(".jpg"))


@pytest.mark.parametrize("name", DAMAGED_FILES)
def test_committed_damaged_files_read_as_pillow(name, monkeypatch):
    """The damaged files chip_smoke.py reads on the card
    (scripts/make_jpeg_codings_fixtures.py writes them): equal to Pillow's
    decode and to the committed one."""
    path = os.path.join(DAMAGED, name + ".jpg")
    monkeypatch.setattr(ImageFile, "MAXBLOCK", 65536)
    _equal_to_pillow(path)
    np.testing.assert_array_equal(jpeg.read_jpeg(path),
                                  read_png(os.path.join(DAMAGED, "decoded", name + ".png"))[0])


# ------------------------------------------------------------- refusals

def _patched_sof(marker=None, precision=None, data=None, sof=b"\xff\xc0"):
    """A file (by default a Pillow-written baseline one) with its frame
    header's marker or sample precision changed."""
    data = bytearray(_pillow(_image(16, 16)) if data is None else data)
    at = data.index(sof)
    if marker is not None:
        data[at + 1] = marker
    if precision is not None:
        data[at + 4] = precision
    return bytes(data)


def _coding(name):
    with open(os.path.join(CODINGS, name + ".jpg"), "rb") as f:
        return f.read()


def _lossless_patched(adobe_transform=None, **kw):
    """The RGB-coded lossless fixture (Adobe transform 0), its frame header
    or its Adobe transform changed."""
    data = bytearray(_coding("lossless_p1_pt0_444_restart1"))
    if adobe_transform is not None:
        at = data.index(b"\xff\xeeAdobe"[:2])
        assert data[at + 4:at + 9] == b"Adobe"
        data[at + 15] = adobe_transform
    return _patched_sof(data=bytes(data), sof=b"\xff\xc3", **kw)


REFUSALS = {
    "12_bit": (lambda: _patched_sof(marker=0xC1, precision=12), "12-bit samples"),
    "lossless_12_bit": (lambda: _lossless_patched(precision=12), "12-bit samples"),
    "lossless_arithmetic": (lambda: _lossless_patched(marker=0xCB),
                            "arithmetic-coded lossless"),
    "lossless_ycbcr": (lambda: _lossless_patched(adobe_transform=1), "lossless YCbCr"),
    "hierarchical": (lambda: _patched_sof(marker=0xC5), "hierarchical"),
    "hierarchical_arithmetic": (
        lambda: _patched_sof(marker=0xCD, data=_coding("arith_seq_444_45x67"), sof=b"\xff\xc9"),
        "hierarchical"),
    "not_a_jpeg": (lambda: b"\x89PNG\r\n\x1a\n" + bytes(32), "not a JPEG"),
    "truncated_header": (lambda: _pillow(_image(16, 16))[:40], "truncated"),
}


@pytest.mark.parametrize("case", list(REFUSALS))
def test_decoder_refusals_name_file_and_feature(case, tmp_path):
    """Files that Pillow (libjpeg-turbo 3.1) refuses too: 12-bit samples
    (its 8-bit reader), arithmetic-coded lossless JPEG (libjpeg-turbo has no
    decoder for it), hierarchical JPEG (nor for this), a lossless file
    coded in YCbCr (libjpeg converts no color in lossless mode)."""
    make, feature = REFUSALS[case]
    path = tmp_path / f"{case}.jpg"
    path.write_bytes(make())
    with pytest.raises(OSError):
        _pillow_rgb(path.read_bytes())
    with pytest.raises(ValueError, match=f"{case}.jpg: .*{feature}"):
        jpeg.read_jpeg(path)


def test_truncated_scan_data_does_not_crash(tmp_path):
    """A file cut inside its scan data, or just before its EOI marker, is
    refused as Pillow refuses it ("image file is truncated"): the port
    raises a ValueError naming the file, and reads nothing past the
    buffer. (Pillow reads a few single-scan files that lack only their last
    bytes, where libjpeg asks for no byte past the end; the port reads the
    same ones: test_truncation_sweep_matches_pillow.)"""
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


def _one_frame_tree(root, frame_bytes, suffix, annotation):
    fd = root / "JPEGImages" / "480p" / "s"
    ad = root / "Annotations" / "480p" / "s"
    fd.mkdir(parents=True)
    ad.mkdir(parents=True)
    (fd / f"00000{suffix}").write_bytes(frame_bytes)
    jdavis.save_indexed_png(ad / "00000.png", annotation)
    return root


@pytest.mark.parametrize("holds,suffix", [("png", ".jpg"), ("jpeg", ".png")])
def test_read_frame_goes_by_content_as_the_jax_reader(holds, suffix, tmp_path):
    """A `.jpg` that holds PNG data and a `.png` that holds JPEG data read as
    `Image.open` reads them, which goes by the file's first bytes: the
    port's DavisDataset against the JAX package's."""
    rgb = _image(37, 53, seed=11)
    if holds == "png":
        write_png(tmp_path / "f.png", rgb)
        frame = (tmp_path / "f.png").read_bytes()
    else:
        frame = _pillow(rgb, quality=90)
    lab = np.zeros((37, 53), np.uint8)
    lab[5:20, 10:30] = 1
    root = _one_frame_tree(tmp_path / "davis", frame, suffix, lab)
    jds, tds = jdavis.DavisDataset(root), tdavis.DavisDataset(root)
    assert [p.suffix for p in tds.frame_paths("s")] == [suffix]
    want = jds.load_sequence("s", 40, 56, max_objects=2)
    got = tds.load_sequence("s", 40, 56, max_objects=2)
    for key, value in want.items():
        if isinstance(value, np.ndarray):
            np.testing.assert_array_equal(got[key], value, err_msg=key)
        else:
            assert got[key] == value, key
