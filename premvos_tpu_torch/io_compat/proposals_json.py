"""Per-frame proposals JSON: the stage-passing contract of the five-stage
pipeline (port of premvos_tpu/io_compat/proposals_json.py; for the same
arrays it writes the same bytes).

The proposal stage writes one JSON per frame holding a list of proposal
dicts

    {"bbox": [x, y, w, h], "score": float,
     "segmentation": {"size": [H, W], "counts": "<RLE>"},
     "ReID": [float × E]}            # appended later by the ReID stage

The refinement stage rewrites `segmentation` with the refined mask; the merge
stage reads everything (pipeline/run_stages.py). The fused pipeline keeps
all of this on the device as padded arrays.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field

import numpy as np

from premvos_tpu_torch.io_compat import rle as rle_codec


@dataclass
class FrameProposals:
    """Padded, array-of-struct view of one frame's proposals.

    boxes are xyxy in image pixels; rows ≥ `count` are zero padding.
    """

    boxes: np.ndarray  # [N, 4] float32 xyxy
    scores: np.ndarray  # [N] float32
    masks: np.ndarray  # [N, H, W] uint8
    valid: np.ndarray  # [N] bool
    embeddings: np.ndarray | None = None  # [N, E] float32
    extra: list = field(default_factory=list)  # passthrough of unknown keys

    @property
    def count(self) -> int:
        return int(self.valid.sum())


def save_proposals(path, props: FrameProposals) -> None:
    """Write reference-schema JSON (COCO xywh bbox, compressed RLE)."""
    out = []
    for i in range(len(props.valid)):
        if not props.valid[i]:
            continue
        x1, y1, x2, y2 = [float(v) for v in props.boxes[i]]
        d = {
            "bbox": [x1, y1, x2 - x1, y2 - y1],
            "score": float(props.scores[i]),
            "segmentation": rle_codec.encode(props.masks[i]),
        }
        if props.embeddings is not None:
            d["ReID"] = [float(v) for v in props.embeddings[i]]
        out.append(d)
    with open(path, "w") as f:
        json.dump(out, f)


def load_proposals(
    path,
    max_proposals: int,
    image_size: tuple[int, int] | None = None,
    embedding_dim: int | None = None,
) -> FrameProposals:
    """Read reference-schema JSON into fixed-size padded arrays."""
    with open(path) as f:
        raw = json.load(f)
    raw = raw[:max_proposals]

    if image_size is None:
        if not raw:
            raise ValueError(f"{path}: empty and no image_size given")
        image_size = tuple(raw[0]["segmentation"]["size"])
    h, w = image_size

    n = max_proposals
    boxes = np.zeros((n, 4), np.float32)
    scores = np.zeros((n,), np.float32)
    masks = np.zeros((n, h, w), np.uint8)
    valid = np.zeros((n,), bool)
    embs = None

    for i, d in enumerate(raw):
        x, y, bw, bh = d["bbox"]
        boxes[i] = [x, y, x + bw, y + bh]
        scores[i] = d.get("score", 0.0)
        if "segmentation" in d:
            masks[i] = rle_codec.decode(d["segmentation"])
        valid[i] = True
        if "ReID" in d:
            if embs is None:
                e = embedding_dim or len(d["ReID"])
                embs = np.zeros((n, e), np.float32)
            embs[i, : len(d["ReID"])] = d["ReID"]
    return FrameProposals(boxes, scores, masks, valid, embs, raw)
