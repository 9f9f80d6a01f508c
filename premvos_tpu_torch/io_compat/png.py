"""PNG codec in numpy and zlib (the port's counterpart of Pillow's PNG
plugin, which the card's machine does not have).

`read_png` decodes 8-bit gray, gray + alpha, RGB and RGBA images and
palette images of 1, 2, 4 or 8 bits, with any of the five row filters of
the PNG specification (section 9): None and Up are undone over runs of
rows at once, Sub by a cumulative sum along the row, Average and Paeth
(sequential along a row) byte by byte. 16-bit and interlaced images are
refused. `write_png` writes gray, RGB and palette images with filter None.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
# Color type → channels (PNG specification, table 11.1).
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def _chunks(data: bytes, path):
    """Yield (type, body) of each chunk, checking every CRC."""
    pos = len(SIGNATURE)
    while pos + 12 <= len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        (crc,) = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])
        if len(body) != length or zlib.crc32(kind + body) != crc:
            raise ValueError(f"{path}: corrupt PNG chunk {kind!r}")
        yield kind, body
        if kind == b"IEND":
            return
        pos += 12 + length
    raise ValueError(f"{path}: truncated PNG (no IEND)")


def _paeth_row(raw: bytearray, up: bytes, bpp: int) -> None:
    """Undo the Paeth filter of one row in place (`up`: the row above)."""
    for i in range(len(raw)):
        a = raw[i - bpp] if i >= bpp else 0
        b = up[i]
        c = up[i - bpp] if i >= bpp else 0
        pa, pb, pc = abs(b - c), abs(a - c), abs(a + b - 2 * c)
        pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        raw[i] = (raw[i] + pred) & 0xFF


def _average_row(raw: bytearray, up: bytes, bpp: int) -> None:
    """Undo the Average filter of one row in place."""
    for i in range(len(raw)):
        a = raw[i - bpp] if i >= bpp else 0
        raw[i] = (raw[i] + ((a + up[i]) >> 1)) & 0xFF


def _unfilter(rows: np.ndarray, filters: np.ndarray, bpp: int, path) -> np.ndarray:
    """[H, stride] filtered bytes and each row's filter type → raw bytes."""
    if filters.max(initial=0) > 4:
        raise ValueError(f"{path}: unknown PNG row filter {int(filters.max())}")
    out = rows.copy()
    h, stride = out.shape
    y = 0
    while y < h:
        f = filters[y]
        if f in (0, 2):
            # A run of None and Up rows: each Up row adds the row above, so
            # within the run the rows are a cumulative sum from its last
            # None row (or from the row before the run).
            end = y
            while end < h and filters[end] in (0, 2):
                end += 1
            run = out[y:end]
            up = filters[y:end] == 2
            starts = np.flatnonzero(~up)
            base = out[y - 1] if y > 0 else np.zeros(stride, np.uint8)
            first = starts[0] if len(starts) else end - y
            if first:
                run[:first] = np.cumsum(run[:first], axis=0, dtype=np.uint8) + base
            for s, e in zip(starts, list(starts[1:]) + [end - y]):
                run[s:e] = np.cumsum(run[s:e], axis=0, dtype=np.uint8)
            y = end
            continue
        up = out[y - 1] if y > 0 else np.zeros(stride, np.uint8)
        if f == 1:
            n = stride // bpp
            out[y] = np.cumsum(out[y].reshape(n, bpp), axis=0, dtype=np.uint8).reshape(-1)
        else:
            row = bytearray(out[y].tobytes())
            (_average_row if f == 3 else _paeth_row)(row, up.tobytes(), bpp)
            out[y] = np.frombuffer(bytes(row), np.uint8)
        y += 1
    return out


def read_png(path) -> tuple[np.ndarray, np.ndarray | None]:
    """Decode a PNG file → (pixels, palette).

    pixels: uint8 [H, W] (gray, or palette indices), [H, W, 2] (gray +
    alpha), [H, W, 3] (RGB) or [H, W, 4] (RGBA); palette: [n, 3] uint8 for
    palette images, else None.
    """
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(SIGNATURE):
        raise ValueError(f"{path}: not a PNG file")
    header, palette, idat = None, None, []
    for kind, body in _chunks(data, path):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3).copy()
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError(f"{path}: PNG without IHDR")
    w, h, depth, color, _, _, interlace = header
    if color not in _CHANNELS:
        raise ValueError(f"{path}: unknown PNG color type {color}")
    if interlace:
        raise ValueError(f"{path}: interlaced PNGs are not supported")
    if depth == 16:
        raise ValueError(f"{path}: 16-bit PNGs are not supported")
    if depth != 8 and color != 3:
        raise ValueError(f"{path}: {depth}-bit images of color type {color} are not supported")
    if color == 3 and palette is None:
        raise ValueError(f"{path}: palette PNG without PLTE")
    ch = _CHANNELS[color]
    stride = (w * ch * depth + 7) // 8
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != h * (stride + 1):
        raise ValueError(f"{path}: PNG data holds {raw.size} bytes, not {h * (stride + 1)}")
    raw = raw.reshape(h, stride + 1)
    rows = _unfilter(raw[:, 1:], raw[:, 0], max(1, ch * depth // 8), path)
    if depth < 8:
        # Pixels packed from the high bits; each row starts on a byte.
        bits = np.unpackbits(rows, axis=1).reshape(h, -1, depth)[:, :w]
        weights = (1 << np.arange(depth - 1, -1, -1)).astype(np.uint8)
        pixels = (bits * weights).sum(-1, dtype=np.uint8)
    else:
        pixels = rows.reshape(h, w, ch) if ch > 1 else rows
    return np.ascontiguousarray(pixels), (palette if color == 3 else None)


def _chunk(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))


def write_png(path, pixels: np.ndarray, palette: np.ndarray | None = None) -> None:
    """Write uint8 [H, W] (gray, or palette indices when `palette` [n, 3]
    is given) or [H, W, 3] (RGB) as an 8-bit PNG with filter None."""
    pixels = np.ascontiguousarray(pixels)
    if pixels.dtype != np.uint8:
        raise ValueError(f"write_png takes uint8 pixels, got {pixels.dtype}")
    if pixels.ndim == 3 and pixels.shape[2] == 3 and palette is None:
        color = 2
    elif pixels.ndim == 2:
        color = 0 if palette is None else 3
    else:
        raise ValueError(f"write_png takes [H, W] or [H, W, 3] pixels, got {pixels.shape}")
    h, w = pixels.shape[:2]
    rows = pixels.reshape(h, -1)
    filtered = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1)
    out = [SIGNATURE, _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0))]
    if palette is not None:
        out.append(_chunk(b"PLTE", np.asarray(palette, np.uint8).reshape(-1, 3).tobytes()))
    out.append(_chunk(b"IDAT", zlib.compress(filtered.tobytes(), 6)))
    out.append(_chunk(b"IEND", b""))
    with open(path, "wb") as f:
        f.write(b"".join(out))


def to_rgb(pixels: np.ndarray, palette: np.ndarray | None) -> np.ndarray:
    """read_png's output → [H, W, 3] uint8, as Pillow's convert("RGB"):
    palette colors looked up, gray repeated, alpha dropped."""
    if palette is not None:
        lut = np.zeros((256, 3), np.uint8)
        lut[: len(palette)] = palette[:256]
        return lut[pixels]
    if pixels.ndim == 2:
        return np.repeat(pixels[..., None], 3, axis=-1)
    if pixels.shape[2] == 2:
        return np.repeat(pixels[..., :1], 3, axis=-1)
    return np.ascontiguousarray(pixels[..., :3])
