"""ctypes binding of the port's C++ COCO RLE codec (kernels/rle.cc; port of
premvos_tpu/io_compat/rle_native.py).

`encode`, `decode` and `iou` take and return what `io_compat/rle.py`'s do,
byte for byte. Where the JAX module falls back to numpy without its
library, this one builds its library at first use (the host C++ compiler,
into kernels/build/, never native/lib/): `available()` reports whether that
build succeeds, and a failed build raises in encode, decode and iou.
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np

from premvos_tpu_torch import kernels

SOURCE = "rle.cc"
_lock = threading.Lock()
_LIB = None


def _load():
    global _LIB
    with _lock:
        if _LIB is None:
            lib = ctypes.CDLL(kernels.build_host(SOURCE))
            i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
            u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
            lib.rle_encode_counts.restype = ctypes.c_int
            lib.rle_encode_counts.argtypes = [u8p, ctypes.c_int, ctypes.c_int, i64p]
            lib.rle_decode_mask.restype = ctypes.c_int
            lib.rle_decode_mask.argtypes = [i64p, ctypes.c_int, ctypes.c_int, ctypes.c_int, u8p]
            lib.rle_counts_to_string.restype = ctypes.c_int
            lib.rle_counts_to_string.argtypes = [i64p, ctypes.c_int, ctypes.c_char_p]
            lib.rle_string_to_counts.restype = ctypes.c_int
            lib.rle_string_to_counts.argtypes = [ctypes.c_char_p, ctypes.c_int, i64p]
            lib.rle_iou.restype = ctypes.c_double
            lib.rle_iou.argtypes = [i64p, ctypes.c_int, i64p, ctypes.c_int]
            _LIB = lib
    return _LIB


def available() -> bool:
    """Whether the library builds and loads here."""
    try:
        _load()
    except (RuntimeError, OSError):
        return False
    return True


def _counts(lib, c) -> np.ndarray:
    if isinstance(c, (str, bytes)):
        s = c.encode("ascii") if isinstance(c, str) else c
        out = np.empty(max(len(s), 1), np.int64)
        n = lib.rle_string_to_counts(s, len(s), out)
        if n < 0:
            raise ValueError("truncated RLE counts string")
        return np.ascontiguousarray(out[:n])
    return np.ascontiguousarray(c, np.int64)


def encode(mask: np.ndarray) -> dict:
    """Binary [H, W] mask → {"size": [H, W], "counts": str}."""
    lib = _load()
    m = np.ascontiguousarray(mask, np.uint8)
    h, w = m.shape
    counts = np.empty(h * w + 1, np.int64)
    n = lib.rle_encode_counts(m, h, w, counts)
    buf = ctypes.create_string_buffer(13 * n)
    slen = lib.rle_counts_to_string(counts[:n].copy(), n, buf)
    return {"size": [int(h), int(w)], "counts": buf.raw[:slen].decode("ascii")}


def decode(rle: dict) -> np.ndarray:
    """{"size", "counts" (str, bytes or run lengths)} → [H, W] uint8 mask."""
    lib = _load()
    h, w = rle["size"]
    counts = _counts(lib, rle["counts"])
    mask = np.empty((h, w), np.uint8)
    if lib.rle_decode_mask(counts, len(counts), h, w, mask) != 0:
        raise ValueError("RLE counts do not sum to H*W")
    return mask


def iou(a: dict, b: dict) -> float:
    """IoU of two RLE masks, walking their runs (no pixels)."""
    lib = _load()
    ca, cb = _counts(lib, a["counts"]), _counts(lib, b["counts"])
    return float(lib.rle_iou(ca, len(ca), cb, len(cb)))
