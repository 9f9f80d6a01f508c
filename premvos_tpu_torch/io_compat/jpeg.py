"""JPEG frames without Pillow, in both directions.

`read_jpeg(path)` returns what `np.asarray(Image.open(path).convert("RGB"))`
returns, bit for bit, for what Pillow's libjpeg-turbo reads: baseline and
progressive JPEG, Huffman- or arithmetic-coded; lossless JPEG (8-bit,
predictors 1-7, any point transform); gray, three components or four
(CMYK, YCCK); any integral sampling factors; restart intervals; a
progressive file whose later scans are missing (libjpeg's block
smoothing); a file cut before its EOI marker where libjpeg still reads it;
damaged restart markers, which libjpeg resyncs; scan data that ends early
at a marker.
The decoder is host C++ (kernels/jpeg_decode.cc), built with the host C++
compiler at first use into kernels/build/ and bound by ctypes; it follows
libjpeg-turbo's defaults, which Pillow runs: the ISLOW integer IDCT (as its
x86 SIMD code computes it), fancy
upsampling (box in a lossless file), jdcolor.c's fixed-point YCbCr → RGB
and YCCK → CMYK, then Pillow's inverted CMYK and its CMYK → RGB. A file
Pillow refuses too (12-bit samples, arithmetic-coded lossless or
hierarchical JPEG, a lossless file needing a color conversion, an
arithmetic-coded scan across one of the 64 KiB blocks Pillow reads, a
truncated file) raises ValueError naming the file and the feature.

`write_jpeg(path, rgb, quality)` writes, and `encode(rgb, quality)`
returns, the bytes of `Image.fromarray(rgb).save(path, "JPEG",
quality=quality)` for an [H, W, 3] uint8 image: baseline JPEG, 4:2:0, the
standard tables scaled to the quality, libjpeg-turbo's ISLOW forward DCT.
The encoder is host C++ too (kernels/jpeg_encode.cc), built and bound as
the decoder is. Anything but [H, W, 3] uint8 pixels, a quality outside
1..100 or a side outside 1..65500 raises ValueError naming it.

For both, a failed build raises, and nothing falls back to Pillow. The JAX
package decodes and encodes on the host with Pillow; this is its
counterpart on the card's machine, which has no Pillow. The calls release
the GIL, so the readers' threads decode in parallel.
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np

from premvos_tpu_torch import kernels

SOURCE = "jpeg_decode.cc"
ENCODER_SOURCE = "jpeg_encode.cc"
_ERR_LEN = 512
_lock = threading.Lock()
_lib = None
_encoder = None


def load():
    """The bound decoder (built on first use)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(kernels.build_host(SOURCE))
            lib.premvos_jpeg_info.argtypes = [
                ctypes.c_char_p, ctypes.c_int64, ctypes.POINTER(ctypes.c_int),
                ctypes.c_char_p, ctypes.c_int]
            lib.premvos_jpeg_decode.argtypes = [
                ctypes.c_char_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64,
                ctypes.c_char_p, ctypes.c_int]
            lib.premvos_jpeg_info.restype = lib.premvos_jpeg_decode.restype = ctypes.c_int
            _lib = lib
    return _lib


def load_encoder():
    """The bound encoder (built on first use)."""
    global _encoder
    with _lock:
        if _encoder is None:
            lib = ctypes.CDLL(kernels.build_host(ENCODER_SOURCE))
            lib.premvos_jpeg_encode_bound.argtypes = [ctypes.c_int, ctypes.c_int]
            lib.premvos_jpeg_encode.argtypes = [
                ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                ctypes.c_int64, ctypes.c_char_p, ctypes.c_int]
            lib.premvos_jpeg_encode_bound.restype = ctypes.c_int64
            lib.premvos_jpeg_encode.restype = ctypes.c_int64
            _encoder = lib
    return _encoder


def decode(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """A JPEG file's bytes → [H, W, 3] uint8 RGB (gray replicated)."""
    lib = load()
    hwc = (ctypes.c_int * 3)()
    err = ctypes.create_string_buffer(_ERR_LEN)
    if lib.premvos_jpeg_info(data, len(data), hwc, err, _ERR_LEN):
        raise ValueError(f"{name}: {err.value.decode()}")
    out = np.empty((hwc[0], hwc[1], 3), np.uint8)
    if lib.premvos_jpeg_decode(data, len(data), out.ctypes.data, out.size, err, _ERR_LEN):
        raise ValueError(f"{name}: {err.value.decode()}")
    return out


def read_jpeg(path) -> np.ndarray:
    """[H, W, 3] uint8: `np.asarray(Image.open(path).convert("RGB"))`."""
    with open(path, "rb") as f:
        data = f.read()
    return decode(data, str(path))


MAX_SIDE = 65500  # libjpeg's JPEG_MAX_DIMENSION


def encode(rgb: np.ndarray, quality: int) -> bytes:
    """[H, W, 3] uint8 RGB → the bytes of Pillow's
    `Image.fromarray(rgb).save(f, "JPEG", quality=quality)`."""
    if not isinstance(rgb, np.ndarray) or rgb.dtype != np.uint8 or rgb.ndim != 3 \
            or rgb.shape[2] != 3:
        got = (f"{rgb.dtype} array of shape {rgb.shape}" if isinstance(rgb, np.ndarray)
               else type(rgb).__name__)
        raise ValueError(f"encode takes [H, W, 3] uint8 pixels, got {got}")
    if isinstance(quality, bool) or not isinstance(quality, (int, np.integer)) \
            or not 1 <= quality <= 100:
        raise ValueError(f"encode takes a quality in 1..100, got {quality!r}")
    h, w = rgb.shape[:2]
    if not (1 <= h <= MAX_SIDE and 1 <= w <= MAX_SIDE):
        raise ValueError(f"encode takes sides in 1..{MAX_SIDE}, got {h}x{w}")
    lib = load_encoder()
    rgb = np.ascontiguousarray(rgb)
    out = np.empty(lib.premvos_jpeg_encode_bound(h, w), np.uint8)
    err = ctypes.create_string_buffer(_ERR_LEN)
    n = lib.premvos_jpeg_encode(rgb.ctypes.data, h, w, int(quality), out.ctypes.data,
                                out.size, err, _ERR_LEN)
    if n < 0:
        raise ValueError(f"encode: {err.value.decode()}")
    return out[:n].tobytes()


def write_jpeg(path, rgb: np.ndarray, quality: int) -> None:
    """Write `encode(rgb, quality)` to `path`: the file Pillow's
    `Image.fromarray(rgb).save(path, quality=quality)` writes."""
    data = encode(rgb, quality)
    with open(path, "wb") as f:
        f.write(data)
