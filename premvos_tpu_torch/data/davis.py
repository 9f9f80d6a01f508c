"""DAVIS 2016/2017 dataset reader (port of premvos_tpu/data/davis.py).

Layout (the standard DAVIS distribution):

  <root>/JPEGImages/480p/<seq>/00000.jpg …
  <root>/Annotations/480p/<seq>/00000.png   (palettized, 0 = background)
  <root>/ImageSets/2017/{train,val,test-dev}.txt

Frames are padded bottom/right to the static canvas on load;
`crop_result` un-pads label maps for evaluation and dumping. PNG frames and
annotations go through the port's own codec (io_compat/png.py), JPEG frames
through its decoder (io_compat/jpeg.py): both read what Pillow reads, and
the port needs no Pillow.
"""

from __future__ import annotations

import os
import warnings
from pathlib import Path

import numpy as np

from premvos_tpu_torch.data.palette import load_indexed_png, save_indexed_png
from premvos_tpu_torch.io_compat.jpeg import read_jpeg, write_jpeg
from premvos_tpu_torch.io_compat.png import read_png, to_rgb


def read_frame(path) -> np.ndarray:
    """One frame → [H, W, 3] uint8 RGB, as Pillow's `convert("RGB")`. The
    file's first bytes choose the format, as `Image.open` chooses it, not its
    suffix: PNG (89 50 4E 47) by the port's codec, JPEG (FF D8) by its
    decoder; anything else raises naming the file."""
    path = Path(path)
    with open(path, "rb") as f:
        head = f.read(4)
    if head == b"\x89PNG":
        return to_rgb(*read_png(path))
    if head[:2] == b"\xff\xd8":
        return read_jpeg(path)
    raise ValueError(f"{path}: reads PNG and JPEG frames, and this file is neither "
                     f"(it starts {head.hex()})")


class DavisDataset:
    def __init__(
        self,
        root,
        split: str = "val",
        year: str = "2017",
        resolution: str = "480p",
    ):
        self.root = Path(root)
        self.resolution = resolution
        imageset = self.root / "ImageSets" / year / f"{split}.txt"
        if imageset.exists():
            self.sequences = [
                s.strip() for s in imageset.read_text().splitlines() if s.strip()
            ]
        else:  # fall back to directory listing
            img_root = self.root / "JPEGImages" / resolution
            self.sequences = sorted(
                d.name for d in img_root.iterdir() if d.is_dir()
            )

    def frame_paths(self, seq: str) -> list[Path]:
        d = self.root / "JPEGImages" / self.resolution / seq
        return sorted(p for p in d.iterdir() if p.suffix in (".jpg", ".png"))

    def annotation_paths(self, seq: str) -> list[Path]:
        d = self.root / "Annotations" / self.resolution / seq
        if not d.exists():
            return []
        return sorted(p for p in d.iterdir() if p.suffix == ".png")

    def load_sequence(
        self,
        seq: str,
        height: int,
        width: int,
        max_objects: int,
        max_frames: int | None = None,
    ) -> dict:
        """Load one sequence padded to the static canvas.

        Returns dict:
          frames [T, height, width, 3] uint8,
          gt_masks [K, height, width] float32 (each object at its first
            annotated frame), intro_frames [K] int32,
          gt_labels [T0, height, width] int32 (all annotated frames),
          num_objects int, object_ids, orig_hw (h, w), name.
        """
        fpaths = self.frame_paths(seq)
        if max_frames:
            fpaths = fpaths[:max_frames]
        frames = []
        orig_hw = None
        for p in fpaths:
            img = read_frame(p)
            orig_hw = img.shape[:2]
            frames.append(_pad_hw(img, height, width))
        frames = np.stack(frames)

        apaths = self.annotation_paths(seq)
        if max_frames:
            apaths = apaths[:max_frames]
        labels = [
            _pad_hw(load_indexed_png(p)[..., None], height, width)[..., 0]
            for p in apaths
        ]
        gt_labels = (
            np.stack(labels).astype(np.int32)
            if labels
            else np.zeros((0, height, width), np.int32)
        )

        # Each object's mask comes from its FIRST annotated frame
        # (YouTube-VOS introduces objects mid-sequence; DAVIS always frame 0).
        ids: list[int] = []
        intro: list[int] = []
        dropped: list[int] = []
        for fi, lab in enumerate(gt_labels):
            for i in np.unique(lab):
                if 0 < i <= 255 and i not in ids and i not in dropped:
                    if len(ids) < max_objects:
                        ids.append(int(i))
                        intro.append(fi)
                    else:
                        dropped.append(int(i))
        if dropped:
            warnings.warn(
                f"sequence '{seq}' has {len(ids) + len(dropped)} annotated "
                f"objects but max_objects={max_objects}; DROPPING object ids "
                f"{dropped}. Raise PipelineConfig.max_objects to track them.",
                stacklevel=2,
            )
        gt_masks = np.zeros((max_objects, height, width), np.float32)
        intro_frames = np.zeros((max_objects,), np.int32)
        for slot, (obj, fi) in enumerate(zip(ids, intro)):
            gt_masks[slot] = gt_labels[fi] == obj
            intro_frames[slot] = fi

        return {
            "name": seq,
            "frames": frames,
            "gt_masks": gt_masks,
            "gt_labels": gt_labels,
            "num_objects": len(ids),
            "intro_frames": intro_frames,
            "object_ids": ids,
            "orig_hw": orig_hw,
        }


def _pad_hw(arr: np.ndarray, height: int, width: int) -> np.ndarray:
    h, w = arr.shape[:2]
    if h > height or w > width:
        arr = arr[:height, :width]
        h, w = arr.shape[:2]
    pads = [(0, height - h), (0, width - w)] + [(0, 0)] * (arr.ndim - 2)
    return np.pad(arr, pads)


def crop_result(labels: np.ndarray, orig_hw) -> np.ndarray:
    """Un-pad [T, H, W] label maps back to the original resolution."""
    h, w = orig_hw
    return labels[:, :h, :w]


def save_results(out_dir, seq: str, labels: np.ndarray, frame_names=None):
    """Dump label maps as DAVIS-palette PNGs (the reference's output
    contract): `<out_dir>/<seq>/<frame name>`, `%05d.png` by default."""
    d = Path(out_dir) / seq
    os.makedirs(d, exist_ok=True)
    for i, lab in enumerate(labels):
        name = frame_names[i] if frame_names else f"{i:05d}.png"
        save_indexed_png(d / name, lab.astype(np.uint8))


def make_synthetic_davis(
    root, sequences=("seq_a",), t: int = 4, hw=(64, 96), num_objects: int = 2
):
    """Build a tiny DAVIS-layout tree with moving squares: JPEG frames at
    quality 95, the JAX package's fixture byte for byte."""
    root = Path(root)
    rng = np.random.default_rng(0)
    h, w = hw
    (root / "ImageSets" / "2017").mkdir(parents=True, exist_ok=True)
    (root / "ImageSets" / "2017" / "val.txt").write_text("\n".join(sequences))
    for seq in sequences:
        jd = root / "JPEGImages" / "480p" / seq
        ad = root / "Annotations" / "480p" / seq
        jd.mkdir(parents=True, exist_ok=True)
        ad.mkdir(parents=True, exist_ok=True)
        bg = rng.integers(0, 255, (h, w, 3)).astype(np.uint8)
        for fi in range(t):
            img = bg.copy()
            lab = np.zeros((h, w), np.uint8)
            for obj in range(1, num_objects + 1):
                y = 8 + 12 * (obj - 1) + fi  # drift down-right
                x = 8 + 24 * (obj - 1) + 2 * fi
                img[y : y + 10, x : x + 10] = [60 * obj, 160, 60]
                lab[y : y + 10, x : x + 10] = obj
            write_jpeg(jd / f"{fi:05d}.jpg", img, 95)
            save_indexed_png(ad / f"{fi:05d}.png", lab)
    return root
