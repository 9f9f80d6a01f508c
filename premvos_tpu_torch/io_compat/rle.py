"""COCO run-length-encoded mask codec, pycocotools-compatible (port of
premvos_tpu/io_compat/rle.py; numpy only).

COCO-format annotations carry instance masks as RLE dicts
`{"size": [H, W], "counts": "<ascii>"}` (data/crops.py reads them). From
the published COCO mask API specification:

  * runs are counted in **Fortran (column-major) order**, alternating
    background/foreground and always starting with a (possibly zero)
    background run;
  * the `counts` string packs each run length in little-endian base-32
    (5 bits per ascii char, offset 48, bit 0x20 = continuation), where every
    count after the first two is **delta-encoded** against the count two
    positions back (two's-complement, sign-extended via the 0x10 bit).
"""

from __future__ import annotations

import numpy as np


def mask_to_counts(mask: np.ndarray) -> np.ndarray:
    """Binary [H, W] mask → run lengths in column-major order."""
    flat = np.asfortranarray(mask.astype(bool)).reshape(-1, order="F")
    n = flat.size
    if n == 0:
        return np.zeros((0,), np.int64)
    change = np.flatnonzero(flat[1:] != flat[:-1]) + 1
    starts = np.concatenate([[0], change, [n]])
    runs = np.diff(starts).astype(np.int64)
    if flat[0]:  # must start with a background run
        runs = np.concatenate([[0], runs])
    return runs


def counts_to_mask(counts: np.ndarray, size: tuple[int, int]) -> np.ndarray:
    """Run lengths (column-major) → binary [H, W] uint8 mask."""
    h, w = size
    counts = np.asarray(counts, np.int64)
    total = int(counts.sum())
    if total != h * w:
        raise ValueError(f"RLE counts sum {total} != H*W {h * w}")
    vals = np.zeros(len(counts), np.uint8)
    vals[1::2] = 1
    flat = np.repeat(vals, counts)
    return flat.reshape((h, w), order="F")


def encode_counts(counts) -> str:
    """Pack run lengths into the COCO compressed ascii string."""
    out = bytearray()
    counts = [int(c) for c in counts]
    for i, cnt in enumerate(counts):
        x = cnt - counts[i - 2] if i > 2 else cnt
        more = True
        while more:
            c = x & 0x1F
            x >>= 5  # python's >> on ints is arithmetic: sign-preserving
            more = (x != -1) if (c & 0x10) else (x != 0)
            if more:
                c |= 0x20
            out.append(c + 48)
    return out.decode("ascii")


def decode_counts(s: str) -> np.ndarray:
    """Unpack the COCO compressed ascii string into run lengths."""
    counts: list[int] = []
    i = 0
    n = len(s)
    while i < n:
        x = 0
        k = 0
        while True:
            if i >= n:
                raise ValueError("truncated RLE counts string")
            c = ord(s[i]) - 48
            x |= (c & 0x1F) << (5 * k)
            i += 1
            k += 1
            if not (c & 0x20):
                if c & 0x10:  # sign-extend
                    x |= -1 << (5 * k)
                break
        if len(counts) > 2:
            x += counts[-2]
        counts.append(x)
    return np.asarray(counts, np.int64)


def encode(mask: np.ndarray) -> dict:
    """Binary [H, W] mask → COCO RLE dict {"size": [H, W], "counts": str}."""
    h, w = mask.shape
    return {"size": [int(h), int(w)], "counts": encode_counts(mask_to_counts(mask))}


def decode(rle: dict) -> np.ndarray:
    """COCO RLE dict → binary [H, W] uint8 mask.

    Accepts compressed (str counts) and uncompressed (list counts) forms.
    """
    h, w = rle["size"]
    counts = rle["counts"]
    if isinstance(counts, str):
        counts = decode_counts(counts)
    elif isinstance(counts, bytes):
        counts = decode_counts(counts.decode("ascii"))
    return counts_to_mask(np.asarray(counts, np.int64), (h, w))


def area(rle: dict) -> int:
    """Foreground pixel count of an RLE mask."""
    counts = rle["counts"]
    if isinstance(counts, (str, bytes)):
        counts = decode_counts(counts if isinstance(counts, str) else counts.decode())
    return int(np.asarray(counts)[1::2].sum())


def iou(a: dict, b: dict) -> float:
    """IoU between two RLE masks (dense path; edge-of-pipeline only)."""
    ma, mb = decode(a).astype(bool), decode(b).astype(bool)
    inter = np.logical_and(ma, mb).sum()
    union = np.logical_or(ma, mb).sum()
    return float(inter) / float(union) if union else 0.0


def to_bbox(rle: dict) -> np.ndarray:
    """RLE mask → tight xywh bbox (matches pycocotools `toBbox`)."""
    m = decode(rle)
    ys, xs = np.nonzero(m)
    if len(ys) == 0:
        return np.zeros(4, np.float32)
    return np.array(
        [xs.min(), ys.min(), xs.max() - xs.min() + 1, ys.max() - ys.min() + 1],
        np.float32,
    )
