"""DAVIS-palette indexed PNGs (port of premvos_tpu/data/palette.py).

Pillow is imported inside the functions that read or write images, so the
package imports on a machine without it.
"""

from __future__ import annotations

import numpy as np


def davis_palette(n: int = 256) -> np.ndarray:
    """[n, 3] uint8 VOC/DAVIS colormap."""
    pal = np.zeros((n, 3), np.uint8)
    for i in range(n):
        r = g = b = 0
        c = i
        for j in range(8):
            r |= ((c >> 0) & 1) << (7 - j)
            g |= ((c >> 1) & 1) << (7 - j)
            b |= ((c >> 2) & 1) << (7 - j)
            c >>= 3
        pal[i] = (r, g, b)
    return pal


def save_indexed_png(path, labels: np.ndarray) -> None:
    """Write an [H, W] uint8 label map as a palettized PNG."""
    from PIL import Image

    img = Image.fromarray(labels.astype(np.uint8), mode="P")
    img.putpalette(davis_palette().ravel().tolist())
    img.save(path)


def load_indexed_png(path) -> np.ndarray:
    """Read a palettized (or grayscale) PNG as an [H, W] uint8 label map."""
    from PIL import Image

    img = Image.open(path)
    if img.mode not in ("P", "L"):
        # RGB annotation: map colors back through the palette.
        arr = np.asarray(img.convert("RGB"))
        lut = {tuple(c): i for i, c in enumerate(davis_palette())}
        out = np.array([lut.get(tuple(p), 0) for p in arr.reshape(-1, 3)], np.uint8)
        return out.reshape(arr.shape[:2])
    return np.asarray(img, np.uint8)
