"""Zstandard frames without a zstd module for Python.

`decompress(data)` returns what `zstandard.ZstdDecompressor()` returns for
one or more frames back to back (skippable frames skipped). The decoder is
host C++ (kernels/zstd_decode.cc, RFC 8878), built with the host C++
compiler at first use into kernels/build/ and bound by ctypes; a failed
build raises, and nothing falls back to another decoder. The call releases
the GIL.

A frame that states its content size is decoded into a buffer of that
size; one that states none (tensorstore writes zarr chunks so) needs the
caller's `size`, the most it may decode to. Every refusal raises a
`ZstdError` subclass that names it: `ZstdCorrupt` (and its `ZstdChecksum`
for a content checksum that does not match), `ZstdTruncated`,
`ZstdDictionary` (a frame that needs a dictionary) and `ZstdOutputBound`
(output past `size`). Nothing partial is returned.

`crc32c(data)` is the CRC-32C of OCDBT's footers, from the same library.
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np

from premvos_tpu_torch import kernels

SOURCE = "zstd_decode.cc"
_ERR_LEN = 256
_lock = threading.Lock()
_lib = None


class ZstdError(ValueError):
    """A zstd frame this decoder refuses."""


class ZstdCorrupt(ZstdError):
    pass


class ZstdChecksum(ZstdCorrupt):
    pass


class ZstdTruncated(ZstdError):
    pass


class ZstdDictionary(ZstdError):
    pass


class ZstdOutputBound(ZstdError):
    pass


# The C side's error kinds (zstd_decode.cc's Kind).
_KINDS = {1: ZstdCorrupt, 2: ZstdTruncated, 3: ZstdDictionary, 4: ZstdOutputBound,
          5: ZstdChecksum}


def load():
    """The bound decoder (built on first use)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(kernels.build_host(SOURCE))
            kind = ctypes.POINTER(ctypes.c_int)
            lib.premvos_zstd_content_size.argtypes = [
                ctypes.c_char_p, ctypes.c_int64, kind, ctypes.c_char_p, ctypes.c_int]
            lib.premvos_zstd_content_size.restype = ctypes.c_int64
            lib.premvos_zstd_decode.argtypes = [
                ctypes.c_char_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64, kind,
                ctypes.c_char_p, ctypes.c_int]
            lib.premvos_zstd_decode.restype = ctypes.c_int64
            lib.premvos_crc32c.argtypes = [ctypes.c_char_p, ctypes.c_int64]
            lib.premvos_crc32c.restype = ctypes.c_uint32
            _lib = lib
    return _lib


def _raise(kind: ctypes.c_int, err, name: str):
    raise _KINDS.get(kind.value, ZstdError)(f"{name}: {err.value.decode()}")


def content_size(data: bytes, name: str = "<bytes>") -> int | None:
    """The decoded size the frames state, or None if a frame states none."""
    lib = load()
    kind, err = ctypes.c_int(0), ctypes.create_string_buffer(_ERR_LEN)
    n = lib.premvos_zstd_content_size(data, len(data), ctypes.byref(kind), err, _ERR_LEN)
    if n == -1:
        _raise(kind, err, name)
    return None if n == -2 else n


def decompress_into(data: bytes, out: np.ndarray, name: str = "<bytes>") -> int:
    """Decode every frame of `data` into `out` (a C-contiguous numpy array,
    at most out.nbytes bytes); returns the bytes written."""
    if not out.flags.c_contiguous:
        raise ValueError(f"{name}: the output buffer must be C-contiguous")
    lib = load()
    kind, err = ctypes.c_int(0), ctypes.create_string_buffer(_ERR_LEN)
    n = lib.premvos_zstd_decode(data, len(data), out.ctypes.data, out.nbytes,
                                ctypes.byref(kind), err, _ERR_LEN)
    if n < 0:
        _raise(kind, err, name)
    return n


def decompress(data: bytes, size: int | None = None, name: str = "<bytes>") -> bytes:
    """Every frame of `data`, decoded. `size` bounds the output; it is
    needed when a frame states no content size."""
    cap = content_size(data, name)
    if cap is None:
        if size is None:
            raise ValueError(f"{name}: a frame states no content size; pass size=")
        cap = size
    elif size is not None and cap > size:
        raise ZstdOutputBound(f"{name}: the frames state {cap} bytes, above the bound {size}")
    out = np.empty(cap, np.uint8)
    n = decompress_into(data, out, name)
    return out[:n].tobytes()


def crc32c(data: bytes) -> int:
    """CRC-32C (Castagnoli) of `data`."""
    return load().premvos_crc32c(data, len(data))
