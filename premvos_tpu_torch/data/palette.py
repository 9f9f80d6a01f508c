"""DAVIS-palette indexed PNGs (port of premvos_tpu/data/palette.py),
through the port's own PNG codec (io_compat/png.py): no Pillow."""

from __future__ import annotations

import numpy as np

from premvos_tpu_torch.io_compat.png import read_png, to_rgb, write_png


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
    write_png(path, labels.astype(np.uint8), davis_palette())


def load_indexed_png(path) -> np.ndarray:
    """Read a palettized (or grayscale) PNG as an [H, W] uint8 label map."""
    pixels, palette = read_png(path)
    if pixels.ndim == 2 and pixels.dtype == np.uint8:  # Pillow's "P" or "L"
        return pixels
    # Any other mode (RGB(A), gray + alpha, 1-bit or 16-bit gray): map its
    # RGB colors back through the palette (0 for a color not in it).
    arr = to_rgb(pixels, palette).astype(np.int64)
    pal = davis_palette().astype(np.int64)
    lut = {k: i for i, k in enumerate((pal[:, 0] << 16 | pal[:, 1] << 8 | pal[:, 2]).tolist())}
    codes, inverse = np.unique(arr[..., 0] << 16 | arr[..., 1] << 8 | arr[..., 2],
                               return_inverse=True)
    ids = np.array([lut.get(c, 0) for c in codes.tolist()], np.uint8)
    return ids[inverse.reshape(-1)].reshape(arr.shape[:2])
