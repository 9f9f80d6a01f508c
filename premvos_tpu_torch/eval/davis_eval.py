"""DAVIS J&F evaluation in numpy and scipy (port of
premvos_tpu/eval/davis_eval.py, which uses OpenCV; the card's machine has
none).

  * J — region similarity: IoU of the predicted and the annotated mask.
  * F — boundary accuracy: F-measure of boundary precision and recall,
    where a boundary pixel matches when a counterpart lies within a
    tolerance radius (0.008 · the image diagonal) — a dilation by OpenCV's
    elliptic structuring element, as the official evaluator does.

Protocol (semi-supervised): frames 1..T−2 are scored — the first frame is
the given annotation and the last is left out.
"""

from __future__ import annotations

import numpy as np
from scipy import ndimage

from premvos_tpu_torch.data.cv_compat import erode


def ellipse_element(radius: int) -> np.ndarray:
    """`cv2.getStructuringElement(cv2.MORPH_ELLIPSE, (2r+1, 2r+1))`: row
    dy of the element spans the columns c ± dx, dx =
    round(c · sqrt((r² − dy²) · (1 / r²))) with OpenCV's arithmetic (the
    product in float64, rounded half to even)."""
    r = c = int(radius)
    size = 2 * r + 1
    inv_r2 = 1.0 / (float(r) * r) if r else 0.0
    el = np.zeros((size, size), np.uint8)
    for i in range(size):
        dy = i - r
        dx = int(np.rint(c * np.sqrt((r * r - dy * dy) * inv_r2)))
        el[i, max(c - dx, 0):min(c + dx + 1, size)] = 1
    return el


def _boundary(mask: np.ndarray) -> np.ndarray:
    """Binary boundary map: pixels of `mask` that a 3×3 erosion removes
    (off-image pixels never erode, as cv2.erode's default border)."""
    m = mask.astype(np.uint8)
    return (m - erode(m, 3)).astype(bool)


def _dilate(b: np.ndarray, element: np.ndarray) -> np.ndarray:
    """`cv2.dilate(b, element)` of a binary map by ellipse_element's output
    (rows centred on the anchor): each row of the element is a horizontal
    run, so the dilation is an OR of vertically shifted 1-D maximum
    filters, one filter per distinct run length. Off-image pixels never set
    a pixel, as with cv2's default border."""
    r = element.shape[0] // 2
    h = b.shape[0]
    src = b.astype(np.uint8)
    runs = {}
    out = np.zeros(b.shape, bool)
    for dy in range(-min(r, h - 1), min(r, h - 1) + 1):
        half = int(element[dy + r].sum()) // 2
        if half not in runs:
            runs[half] = ndimage.maximum_filter1d(
                src, 2 * half + 1, axis=1, mode="constant", cval=0
            ).astype(bool)
        row = runs[half]
        if dy >= 0:
            out[: h - dy] |= row[dy:]
        else:
            out[-dy:] |= row[: h + dy]
    return out


def j_measure(pred: np.ndarray, gt: np.ndarray) -> float:
    """IoU of two binary masks; 1 when both are empty."""
    p, g = pred.astype(bool), gt.astype(bool)
    union = np.logical_or(p, g).sum()
    if union == 0:
        return 1.0
    return float(np.logical_and(p, g).sum()) / float(union)


def f_measure(pred: np.ndarray, gt: np.ndarray, bound_th: float = 0.008) -> float:
    """Boundary F-measure with tolerance radius bound_th · image diagonal."""
    p, g = pred.astype(bool), gt.astype(bool)
    if not p.any() and not g.any():
        return 1.0
    if not p.any() or not g.any():
        return 0.0

    h, w = pred.shape
    radius = max(1, int(np.ceil(bound_th * np.sqrt(h * h + w * w))))
    element = ellipse_element(radius)

    pb = _boundary(p)
    gb = _boundary(g)
    pb_dil = _dilate(pb, element)
    gb_dil = _dilate(gb, element)

    precision = (
        np.logical_and(pb, gb_dil).sum() / pb.sum() if pb.sum() else 0.0
    )
    recall = np.logical_and(gb, pb_dil).sum() / gb.sum() if gb.sum() else 0.0
    if precision + recall == 0:
        return 0.0
    return float(2 * precision * recall / (precision + recall))


def evaluate_sequence(
    pred_labels: np.ndarray, gt_labels: np.ndarray, num_objects: int
) -> dict:
    """Per-sequence J&F over label maps [T, H, W] (0 = background).

    Returns {"J": mean, "F": mean, "J&F": mean, "per_object": {...}} over
    frames 1..T−2.
    """
    t = pred_labels.shape[0]
    frames = range(1, max(t - 1, 2))  # skip the annotated first and the last
    per_object = {}
    js, fs = [], []
    for obj in range(1, num_objects + 1):
        oj, of = [], []
        for fi in frames:
            p = pred_labels[fi] == obj
            g = gt_labels[fi] == obj
            oj.append(j_measure(p, g))
            of.append(f_measure(p, g))
        per_object[obj] = {"J": float(np.mean(oj)), "F": float(np.mean(of))}
        js.append(np.mean(oj))
        fs.append(np.mean(of))
    j, f = float(np.mean(js)), float(np.mean(fs))
    return {"J": j, "F": f, "J&F": (j + f) / 2, "per_object": per_object}


def evaluate_dataset(results: list[dict]) -> dict:
    """Aggregate evaluate_sequence outputs: the mean over all objects of all
    sequences."""
    js = [o["J"] for r in results for o in r["per_object"].values()]
    fs = [o["F"] for r in results for o in r["per_object"].values()]
    j, f = float(np.mean(js)), float(np.mean(fs))
    return {"J": j, "F": f, "J&F": (j + f) / 2}
