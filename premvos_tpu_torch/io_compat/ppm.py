"""Binary PPM (P6, maxval 255) in numpy: FlyingChairs' image format.

The JAX package reads and writes these with Pillow, which the card's
machine does not have. `write_ppm` writes the bytes Pillow's PPM writer
writes (`P6\\n<w> <h>\\n255\\n` and the RGB rows); `read_ppm` takes any P6
header with maxval 255 (comments and any whitespace between its fields).
"""

from __future__ import annotations

import numpy as np


def _header_fields(data: bytes):
    """The four header fields (magic, width, height, maxval) and the offset
    of the first pixel byte."""
    fields, pos = [], 0
    while len(fields) < 4:
        while pos < len(data) and (data[pos:pos + 1].isspace() or data[pos:pos + 1] == b"#"):
            if data[pos:pos + 1] == b"#":
                end = data.find(b"\n", pos)
                pos = len(data) if end < 0 else end + 1
            else:
                pos += 1
        start = pos
        while pos < len(data) and not data[pos:pos + 1].isspace():
            pos += 1
        if start == pos:
            raise ValueError("truncated PPM header")
        fields.append(data[start:pos])
    return fields, pos + 1  # one whitespace byte ends the header


def read_ppm(path) -> np.ndarray:
    """A binary PPM file → [H, W, 3] uint8 RGB."""
    with open(path, "rb") as f:
        data = f.read()
    (magic, w, h, maxval), start = _header_fields(data)
    if magic != b"P6" or int(maxval) != 255:
        raise ValueError(f"{path}: only binary PPM (P6) with maxval 255 is read, "
                         f"got {magic!r} maxval {int(maxval)}")
    w, h = int(w), int(h)
    pixels = np.frombuffer(data, np.uint8, count=h * w * 3, offset=start)
    return pixels.reshape(h, w, 3).copy()


def write_ppm(path, image: np.ndarray) -> None:
    """[H, W, 3] uint8 RGB → a binary PPM file."""
    image = np.asarray(image)
    if image.dtype != np.uint8 or image.ndim != 3 or image.shape[2] != 3:
        raise ValueError(f"PPM image must be [H, W, 3] uint8, got {image.shape} {image.dtype}")
    h, w = image.shape[:2]
    with open(path, "wb") as f:
        f.write(b"P6\n%d %d\n255\n" % (w, h))
        f.write(np.ascontiguousarray(image).tobytes())
