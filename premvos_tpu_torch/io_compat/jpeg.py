"""JPEG frames without Pillow.

`read_jpeg(path)` returns what `np.asarray(Image.open(path).convert("RGB"))`
returns, bit for bit: baseline and progressive Huffman JPEG, 8-bit, gray,
three or four components (CMYK, YCCK), any integral sampling factors,
restart intervals. The decoder is host C++ (kernels/jpeg_decode.cc), built
with the host C++ compiler at first use into kernels/build/ and bound by
ctypes; it follows libjpeg-turbo's defaults, which Pillow runs: the ISLOW
integer IDCT, fancy upsampling, jdcolor.c's fixed-point YCbCr → RGB and
YCCK → CMYK, then Pillow's inverted CMYK and its CMYK → RGB. A file it
cannot read (arithmetic coding, 12-bit samples, lossless or hierarchical
JPEG) raises ValueError naming the file and the feature; a failed build
raises, and nothing falls back to Pillow.

The JAX package decodes on the host with Pillow; this is its counterpart
on the card's machine, which has no Pillow. The call releases the GIL, so
the readers' threads decode in parallel.
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np

from premvos_tpu_torch import kernels

SOURCE = "jpeg_decode.cc"
_ERR_LEN = 512
_lock = threading.Lock()
_lib = None


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
