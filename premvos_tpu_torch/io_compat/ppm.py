"""The PNM family (PBM, PGM, PPM, PFM and Pillow's own headers) in numpy:
FlyingChairs' image format, and the reader the flow pairs go through.

The JAX package reads these with Pillow (`Image.open(p).convert("RGB")`),
which the card's machine does not have. `read_ppm(path)` returns what that
call returns, bit for bit, for every header in Pillow 12's
`PpmImagePlugin.MODES`, and picks the format by the file's content as
`Image.open` does, so a PNG or JPEG named `.ppm` reads too (through the
port's PNG codec and JPEG decoder):

  P1, P4     bitmaps, plain and packed; 1 is black
  P2, P5     gray; maxval 255 as it is, any other rescaled to 8 bits
             (round half to even), and above 255 read as Pillow's mode I:
             a P5 at maxval 65535 keeps its raw values, any other maxval
             above 255 is rescaled to 16 bits, and convert("RGB") clips
             both to 255
  P3, P6     RGB; maxval 255 as it is, any other rescaled to 8 bits
  Pf         one float32 channel (little-endian for a negative scale),
             stored bottom row first; convert("RGB") truncates and clips
             (NaN reads 0)
  P0CMYK, PyCMYK, PyRGBA, PyP
             CMYK (Pillow's CMYK → RGB), RGBA (alpha dropped) and palette
             indices without a palette (black), at a maxval as P6's

Comments (`#` to the end of the line) and any whitespace may come between
the header's fields, and in the plain formats' data. Anything else, a
header field out of range or data that ends early raises PnmFormatError
naming the file and what is wrong. `write_ppm` writes the bytes Pillow's
PPM writer writes for RGB (`P6\\n<w> <h>\\n255\\n` and the rows).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from premvos_tpu_torch.io_compat.jpeg import read_jpeg
from premvos_tpu_torch.io_compat.png import read_png, to_rgb

# Pillow's PpmImagePlugin.MODES: the header's magic → the image mode.
MODES = {b"P1": "1", b"P2": "L", b"P3": "RGB", b"P4": "1", b"P5": "L", b"P6": "RGB",
         b"P0CMYK": "CMYK", b"Pf": "F", b"PyP": "P", b"PyRGBA": "RGBA", b"PyCMYK": "CMYK"}
BANDS = {"L": 1, "I": 1, "P": 1, "RGB": 3, "RGBA": 4, "CMYK": 4}
PLAIN = (b"P1", b"P2", b"P3")
WHITESPACE = b" \t\n\x0b\x0c\r"


class PnmFormatError(ValueError):
    """A PNM file this reader (and Pillow) does not read."""


def _magic(data: bytes) -> tuple[bytes, int]:
    """Up to six bytes before the first whitespace (which is consumed)."""
    magic, pos = b"", 0
    for _ in range(6):
        c = data[pos:pos + 1]
        pos += 1
        if not c or c in WHITESPACE:
            break
        magic += c
    return magic, min(pos, len(data))


def _token(data: bytes, pos: int, where: str) -> tuple[bytes, int]:
    """The next header field after `pos` and the offset past the one
    whitespace byte that ends it, as Pillow's `_read_token` reads it."""
    token = b""
    while len(token) <= 10:
        c = data[pos:pos + 1]
        pos += 1
        if not c:
            break
        if c in WHITESPACE:
            if not token:
                continue
            break
        if c == b"#":  # to the end of the line
            while data[pos:pos + 1] not in (b"\r", b"\n", b""):
                pos += 1
            pos += 1
            continue
        token += c
    if not token:
        raise PnmFormatError(f"{where}: the header ends before its fields do")
    if len(token) > 10:
        raise PnmFormatError(f"{where}: header field {token[:11]!r}... is too long")
    return token, pos


def _int(token: bytes, what: str, where: str) -> int:
    try:
        return int(token)
    except ValueError:
        raise PnmFormatError(f"{where}: {what} {token!r} is not an integer") from None


def _strip_comments(data: bytes) -> bytes:
    """The plain formats' data without comments (`#` to the next CR or LF)."""
    out, pos = [], 0
    while True:
        start = data.find(b"#", pos)
        if start < 0:
            out.append(data[pos:])
            return b"".join(out)
        out.append(data[pos:start])
        ends = [e for e in (data.find(b"\n", start), data.find(b"\r", start)) if e >= 0]
        if not ends:
            return b"".join(out)
        pos = min(ends) + 1


def _rescale(values: np.ndarray, maxval: int, out_max: int) -> np.ndarray:
    """Pillow's round(value / maxval * out_max), half to even, in float64."""
    return np.minimum(np.rint(values / maxval * out_max), out_max).astype(np.int64)


def _to_rgb(pixels: np.ndarray, mode: str) -> np.ndarray:
    """[H, W, bands] in `mode` → Pillow's convert("RGB")."""
    if mode in ("L", "I", "1"):
        return np.repeat(np.minimum(pixels, 255).astype(np.uint8), 3, axis=2)
    if mode == "P":  # no palette: every index reads black
        return np.zeros((*pixels.shape[:2], 3), np.uint8)
    if mode == "RGBA":
        return pixels[..., :3].astype(np.uint8)
    if mode == "CMYK":  # Convert.c cmyk2rgb: nk - MULDIV255(c, nk)
        nk = 255 - pixels[..., 3:].astype(np.int64)
        t = pixels[..., :3].astype(np.int64) * nk + 128
        return np.clip(nk - (((t >> 8) + t) >> 8), 0, 255).astype(np.uint8)
    return pixels.astype(np.uint8)


def decode_pnm(data: bytes, where: str = "<bytes>") -> np.ndarray:
    """A PNM file's bytes → [H, W, 3] uint8, as Pillow's convert("RGB")."""
    magic, pos = _magic(data)
    if magic not in MODES:
        raise PnmFormatError(f"{where}: magic {magic!r} is not a PNM header Pillow reads "
                             f"({', '.join(m.decode() for m in MODES)})")
    name = magic.decode()
    mode = MODES[magic]
    token, pos = _token(data, pos, where)
    w = _int(token, "width", where)
    token, pos = _token(data, pos, where)
    h = _int(token, "height", where)
    if w <= 0 or h <= 0:
        raise PnmFormatError(f"{where}: {name} image of {w}×{h} pixels")
    maxval = scale = None
    if mode == "F":
        token, pos = _token(data, pos, where)
        try:
            scale = float(token)
        except ValueError:
            raise PnmFormatError(f"{where}: Pf scale {token!r} is not a number") from None
        if scale == 0.0 or not np.isfinite(scale):
            raise PnmFormatError(f"{where}: Pf scale {scale} (must be finite and non-zero)")
    elif mode != "1":
        token, pos = _token(data, pos, where)
        maxval = _int(token, "maxval", where)
        if not 0 < maxval < 65536:
            raise PnmFormatError(f"{where}: {name} maxval {maxval} (must be 1-65535)")
        if maxval > 255 and mode == "L":
            mode = "I"
    body = data[pos:]
    bands = BANDS.get(mode, 1)
    count = w * h * bands

    def short(have, need):
        return PnmFormatError(f"{where}: truncated {name} data: {have} of {need} "
                              f"{'samples' if magic in PLAIN else 'bytes'}")

    if mode == "1":
        if magic == b"P1":
            bits = b"".join(_strip_comments(body).split())
            bad = bits.translate(None, b"01")
            if bad:
                raise PnmFormatError(f"{where}: P1 data holds {bad[:1]!r}, not 0 or 1")
            if len(bits) < w * h:
                raise short(len(bits), w * h)
            ones = np.frombuffer(bits[:w * h], np.uint8).reshape(h, w) == ord("1")
        else:
            row = (w + 7) // 8
            if len(body) < row * h:
                raise short(len(body), row * h)
            packed = np.frombuffer(body, np.uint8, count=row * h).reshape(h, row)
            ones = np.unpackbits(packed, axis=1)[:, :w].astype(bool)
        return _to_rgb(np.where(ones, 0, 255)[..., None], "1")
    if mode == "F":
        if len(body) < 4 * w * h:
            raise short(len(body), 4 * w * h)
        v = np.frombuffer(body, "<f4" if scale < 0 else ">f4", count=w * h).reshape(h, w)
        v = np.nan_to_num(v[::-1].astype(np.float64), nan=0.0, posinf=255.0, neginf=0.0)
        return _to_rgb(np.trunc(np.clip(v, 0, 255))[..., None], "L")
    out_max = 65535 if mode == "I" else 255
    if magic in PLAIN:
        tokens = _strip_comments(body).split()
        if len(tokens) < count:
            raise short(len(tokens), count)
        values = np.array([_int(t, f"{name} sample", where) for t in tokens[:count]], np.int64)
        if values.min() < 0 or values.max() > maxval:
            bad = values[(values < 0) | (values > maxval)][0]
            raise PnmFormatError(f"{where}: {name} sample {bad} outside 0-{maxval}")
        pixels = _rescale(values, maxval, out_max)
    else:
        size = 1 if maxval < 256 else 2
        if len(body) < count * size:
            raise short(len(body), count * size)
        values = np.frombuffer(body, np.uint8 if size == 1 else ">u2", count=count)
        if maxval == 255 or (mode == "I" and maxval == 65535):
            pixels = values.astype(np.int64)
        else:
            pixels = _rescale(values, maxval, out_max)
    return _to_rgb(pixels.reshape(h, w, bands), mode)


def read_ppm(path) -> np.ndarray:
    """[H, W, 3] uint8: `np.asarray(Image.open(path).convert("RGB"))`. The
    file's first bytes choose the format: PNM (P and one of 0-6, f, y), PNG
    or JPEG; anything else raises naming the file."""
    path = Path(path)
    data = path.read_bytes()
    if data[:1] == b"P" and data[1:2] and data[1:2] in b"0123456fy":
        return decode_pnm(data, str(path))
    if data[:4] == b"\x89PNG":
        return to_rgb(*read_png(path))
    if data[:2] == b"\xff\xd8":
        return read_jpeg(path)
    raise PnmFormatError(f"{path}: reads PNM, PNG and JPEG images, and this file is none "
                         f"of them (it starts {data[:4].hex()})")


def write_ppm(path, image: np.ndarray) -> None:
    """[H, W, 3] uint8 RGB → a binary PPM file."""
    image = np.asarray(image)
    if image.dtype != np.uint8 or image.ndim != 3 or image.shape[2] != 3:
        raise ValueError(f"PPM image must be [H, W, 3] uint8, got {image.shape} {image.dtype}")
    h, w = image.shape[:2]
    with open(path, "wb") as f:
        f.write(b"P6\n%d %d\n255\n" % (w, h))
        f.write(np.ascontiguousarray(image).tobytes())
