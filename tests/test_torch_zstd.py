"""The port's zstd decoder (kernels/zstd_decode.cc through io_compat/zstd.py)
against the system's libzstd, called through ctypes here only: frames that
libzstd writes at levels 1, 3, 9 and 19 from random, repetitive, float32
weight and text data of 0 bytes to 2 MiB decode bit for bit as libzstd
decodes them, with and without a content size and a checksum, back to back
and beside skippable frames; truncated, flipped, dictionary and oversized
frames are refused by name, where libzstd refuses them too.
"""

import ctypes
import ctypes.util

import numpy as np
import pytest
import torch

from premvos_tpu_torch import kernels
from premvos_tpu_torch.io_compat import zstd

LEVELS = (1, 3, 9, 19)
KINDS = ("random", "repetitive", "weights", "text")
SIZES = (0, 1, 1000, 131_073, 2 << 20)
# ZSTD_cParameter values (zstd.h).
C_LEVEL, C_CONTENT_SIZE, C_CHECKSUM = 100, 200, 201


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two intra-op threads for this module: the suite runs several pytest
    workers on the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def lz():
    path = ctypes.util.find_library("zstd")
    if path is None:
        pytest.skip("no libzstd on this machine to hold the decoder against")
    lib = ctypes.CDLL(path)
    size_t, vp = ctypes.c_size_t, ctypes.c_void_p
    for name, res, args in (
        ("ZSTD_compressBound", size_t, [size_t]),
        ("ZSTD_isError", ctypes.c_uint, [size_t]),
        ("ZSTD_getErrorName", ctypes.c_char_p, [size_t]),
        ("ZSTD_createCCtx", vp, []),
        ("ZSTD_freeCCtx", size_t, [vp]),
        ("ZSTD_CCtx_setParameter", size_t, [vp, ctypes.c_int, ctypes.c_int]),
        ("ZSTD_compress2", size_t, [vp, vp, size_t, ctypes.c_char_p, size_t]),
        ("ZSTD_decompress", size_t, [vp, size_t, ctypes.c_char_p, size_t]),
    ):
        getattr(lib, name).restype = res
        getattr(lib, name).argtypes = args
    return lib


def compress(lz, data: bytes, level: int, checksum=False, content_size=True) -> bytes:
    cctx = lz.ZSTD_createCCtx()
    try:
        for param, value in ((C_LEVEL, level), (C_CHECKSUM, int(checksum)),
                             (C_CONTENT_SIZE, int(content_size))):
            assert not lz.ZSTD_isError(lz.ZSTD_CCtx_setParameter(cctx, param, value))
        cap = lz.ZSTD_compressBound(len(data))
        out = ctypes.create_string_buffer(cap)
        n = lz.ZSTD_compress2(cctx, out, cap, data, len(data))
        assert not lz.ZSTD_isError(n), lz.ZSTD_getErrorName(n)
        return out.raw[:n]
    finally:
        lz.ZSTD_freeCCtx(cctx)


def lib_decompress(lz, frame: bytes, cap: int):
    """libzstd's output, or None where it refuses the frame."""
    out = ctypes.create_string_buffer(max(cap, 1))
    n = lz.ZSTD_decompress(out, cap, frame, len(frame))
    return None if lz.ZSTD_isError(n) else out.raw[:n]


def make_data(kind: str, size: int) -> bytes:
    rng = np.random.default_rng([7, KINDS.index(kind), size])
    if kind == "random":
        return rng.integers(0, 256, size, dtype=np.uint8).tobytes()
    if kind == "repetitive":  # runs of one byte (RLE blocks), short periods, edits
        parts = [bytes([rng.integers(0, 256)]) * int(rng.integers(1, 300_000))
                 if rng.random() < 0.3 else
                 rng.integers(0, 256, int(rng.integers(1, 40)), dtype=np.uint8).tobytes()
                 * int(rng.integers(1, 3000)) for _ in range(12)]
        out = b"".join(parts)
        return (out * (size // max(len(out), 1) + 1))[:size]
    if kind == "weights":
        n = -(-size // 4)
        return (rng.standard_normal(n) * 0.02).astype(np.float32).tobytes()[:size]
    words = [b"zstd", b"frame", b"the", b"block", b"of", b"literals", b"and", b"matches",
             b"offset", b"sequence", b"\n", b"Huffman", b"FSE"]
    out = b" ".join(rng.choice(words, size // 4 + 1))
    return out[:size]


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("level", LEVELS)
def test_decodes_as_libzstd(lz, level, kind, size):
    data = make_data(kind, size)
    frame = compress(lz, data, level)
    assert zstd.content_size(frame) == size
    got = zstd.decompress(frame)
    assert got == data == lib_decompress(lz, frame, size)


@pytest.mark.parametrize("level", LEVELS)
def test_frames_with_checksum_and_without_content_size(lz, level):
    """A checksummed frame decodes; a frame that states no size needs the
    caller's bound and decodes up to it; the checksum is checked."""
    data = make_data("text", 300_000) + make_data("weights", 200_000)
    for checksum in (False, True):
        frame = compress(lz, data, level, checksum=checksum, content_size=False)
        assert zstd.content_size(frame) is None
        with pytest.raises(ValueError, match="no content size"):
            zstd.decompress(frame)
        assert zstd.decompress(frame, size=len(data)) == data
        assert zstd.decompress(frame, size=len(data) + 100) == data
        with pytest.raises(zstd.ZstdOutputBound):
            zstd.decompress(frame, size=len(data) - 1)
    frame = bytearray(compress(lz, data, level, checksum=True))
    frame[-1] ^= 0x10  # the XXH64 checksum's last byte
    assert lib_decompress(lz, bytes(frame), len(data)) is None
    with pytest.raises(zstd.ZstdChecksum, match="checksum"):
        zstd.decompress(bytes(frame))


def test_frames_back_to_back_and_skippable_frames(lz):
    parts = [make_data(kind, size) for kind, size in
             (("text", 5000), ("random", 0), ("weights", 150_000), ("repetitive", 400_000))]
    skippable = (0x184D2A53).to_bytes(4, "little") + (5).to_bytes(4, "little") + b"12345"
    stream = b"".join((
        compress(lz, parts[0], 3, checksum=True), skippable,
        compress(lz, parts[1], 1), compress(lz, parts[2], 19, content_size=False),
        skippable, compress(lz, parts[3], 9),
    ))
    want = b"".join(parts)
    assert zstd.content_size(stream) is None  # one frame states no size
    assert zstd.decompress(stream, size=len(want)) == want == lib_decompress(lz, stream, len(want))
    stated = compress(lz, parts[0], 1) + skippable + compress(lz, parts[3], 19)
    assert zstd.content_size(stated) == len(parts[0]) + len(parts[3])
    assert zstd.decompress(stated) == parts[0] + parts[3]


@pytest.mark.parametrize("level", LEVELS)
def test_truncated_frames_are_refused(lz, level):
    """Every cut of a frame (header, block headers, blocks, the checksum)
    raises ZstdTruncated, where libzstd refuses it too (no bytes at all are
    no frame, and decode to nothing, as in libzstd)."""
    data = make_data("text", 200_000)
    frame = compress(lz, data, level, checksum=True)
    cuts = sorted({1, 3, 4, 5, 6, 9, 12, len(frame) // 3, len(frame) // 2,
                   len(frame) - 5, len(frame) - 4, len(frame) - 2, len(frame) - 1})
    assert zstd.decompress(b"") == b"" == lib_decompress(lz, b"", 1)
    for cut in cuts:
        assert lib_decompress(lz, frame[:cut], len(data)) is None, cut
        with pytest.raises(zstd.ZstdTruncated, match="truncated"):
            zstd.decompress(frame[:cut], size=len(data))


@pytest.mark.parametrize("level", LEVELS)
def test_flipped_bytes_agree_with_libzstd(lz, level):
    """A bit flipped anywhere past the frame header of a checksummed frame:
    where libzstd refuses the frame, the port refuses it by name; where
    libzstd decodes it, the port decodes the same bytes."""
    data = make_data("text", 60_000) + make_data("weights", 20_000)
    frame = compress(lz, data, level, checksum=True)
    rng = np.random.default_rng(level)
    refused = 0
    for pos in sorted(set(rng.integers(6, len(frame), 120).tolist())):
        bad = bytearray(frame)
        bad[pos] ^= 1 << int(rng.integers(0, 8))
        want = lib_decompress(lz, bytes(bad), len(data) + 4096)
        if want is None:
            refused += 1
            with pytest.raises(zstd.ZstdError):
                zstd.decompress(bytes(bad), size=len(data) + 4096)
        else:
            assert zstd.decompress(bytes(bad), size=len(data) + 4096) == want, pos
    assert refused > 100


def test_dictionary_frames_are_refused(lz):
    """A frame naming dictionary 7 (a raw block of 3 bytes): refused."""
    frame = (0xFD2FB528).to_bytes(4, "little") + bytes(
        [0x21, 7, 3, (3 << 3) | 1, 0, 0]) + b"abc"
    assert lib_decompress(lz, frame, 3) is None
    with pytest.raises(zstd.ZstdDictionary, match="dictionary 7"):
        zstd.decompress(frame)
    plain = frame[:4] + bytes([0x20, 3, (3 << 3) | 1, 0, 0]) + b"abc"
    assert zstd.decompress(plain) == b"abc" == lib_decompress(lz, plain, 3)


def test_output_past_the_bound_is_refused(lz):
    data = make_data("repetitive", 100_000)
    frame = compress(lz, data, 3)
    with pytest.raises(zstd.ZstdOutputBound, match="bound"):
        zstd.decompress(frame, size=len(data) - 1)
    out = np.zeros(len(data) - 1, np.uint8)
    with pytest.raises(zstd.ZstdOutputBound):
        zstd.decompress_into(frame, out)
    out = np.zeros(len(data) + 10, np.uint8)
    assert zstd.decompress_into(frame, out) == len(data)
    assert out[:len(data)].tobytes() == data


def _crc32c_bitwise(data: bytes) -> int:
    c = 0xFFFFFFFF
    for b in data:
        c ^= b
        for _ in range(8):
            c = (c >> 1) ^ (0x82F63B78 if c & 1 else 0)
    return c ^ 0xFFFFFFFF


def test_crc32c():
    assert zstd.crc32c(b"123456789") == 0xE3069283
    rng = np.random.default_rng(3)
    for n in (0, 1, 7, 8, 9, 63, 200):
        data = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
        assert zstd.crc32c(data) == _crc32c_bitwise(data), n


def test_built_from_its_source_with_no_fallback(monkeypatch):
    """The decoder is kernels/zstd_decode.cc, built into kernels/build/; a
    failed build raises and nothing else decodes."""
    path = kernels.build_host(zstd.SOURCE)
    assert path.startswith(kernels.BUILD_DIR) and "libzstd_decode_" in path

    def broken(source):
        raise RuntimeError(f"building {source} failed")

    monkeypatch.setattr(kernels, "build_host", broken)
    monkeypatch.setattr(zstd, "_lib", None)
    with pytest.raises(RuntimeError, match="zstd_decode.cc"):
        zstd.decompress(b"\x28\xb5\x2f\xfd\x20\x00\x01\x00\x00")
