"""Instance-crop datasets for ReID training (port of
premvos_tpu/data/crops.py).

The ReID net trains on COCO + PASCAL object crops, each instance an
identity, with batch-hard triplet loss over PK batches (P identities × K
crops each; Hermans et al.). The readers take COCO-format instance
annotations (decoded with io_compat/rle.py) or PASCAL-VOC boxes and serve
augmented PK batches; `DavisObjectCrops` takes per-object crops from a
DAVIS-layout dataset. Every reader draws from the numpy generator in the
JAX package's order, so one seed gives the same batches in both.

No Pillow (the card's machine has none): images are read by
`data/davis.py::read_frame` (the port's PNG codec and JPEG decoder), COCO
and VOC crops resized by `data/preprocess.py::resize_bicubic_pil` (Pillow's
default BICUBIC, bit for bit), and `DavisObjectCrops` resizes with
`resize_linear` in place of OpenCV's INTER_LINEAR.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

from premvos_tpu_torch.data.davis import read_frame
from premvos_tpu_torch.data.preprocess import resize_bicubic_pil, resize_linear
from premvos_tpu_torch.io_compat import rle as rle_codec
from premvos_tpu_torch.io_compat.jpeg import write_jpeg


class InstanceCropDataset:
    """COCO-format instances → identity-labeled object crops."""

    def __init__(self, images_dir, annotations_json, crop_size: int = 128,
                 min_area: float = 400.0):
        self.images_dir = Path(images_dir)
        self.crop_size = crop_size
        with open(annotations_json) as f:
            coco = json.load(f)
        self.images = {im["id"]: im for im in coco["images"]}
        self.instances = [
            a for a in coco.get("annotations", [])
            if a.get("area", 0) >= min_area and "bbox" in a
        ]

    def __len__(self):
        return len(self.instances)

    def load_crop(self, idx: int, rng=None, jitter: float = 0.1) -> np.ndarray:
        """One [S, S, 3] uint8 crop; optional box jitter for augmentation."""
        ann = self.instances[idx]
        im_info = self.images[ann["image_id"]]
        img = read_frame(self.images_dir / im_info["file_name"])
        h, w = img.shape[:2]
        x, y, bw, bh = ann["bbox"]
        if rng is not None and jitter > 0:
            x += rng.uniform(-jitter, jitter) * bw
            y += rng.uniform(-jitter, jitter) * bh
            bw *= rng.uniform(1 - jitter, 1 + jitter)
            bh *= rng.uniform(1 - jitter, 1 + jitter)
        x1, y1 = max(0, int(x)), max(0, int(y))
        x2 = min(w, int(np.ceil(x + bw)))
        y2 = min(h, int(np.ceil(y + bh)))
        if x2 - x1 < 2 or y2 - y1 < 2:
            x1, y1, x2, y2 = 0, 0, w, h
        crop = img[y1:y2, x1:x2]
        out = resize_bicubic_pil(crop, (self.crop_size, self.crop_size))
        if rng is not None and rng.uniform() < 0.5:
            out = out[:, ::-1]
        return out

    def instance_mask(self, idx: int) -> np.ndarray | None:
        seg = self.instances[idx].get("segmentation")
        if isinstance(seg, dict) and "counts" in seg:
            return rle_codec.decode(seg)
        return None  # polygon segmentations unsupported (not needed here)

    def pk_batch(self, rng, p: int = 8, k: int = 4):
        """Sample a PK batch: (crops [P·K, S, S, 3] float32 in [0, 1],
        ids [P·K]). Identity = instance; its K views are K augmented crops
        (same-instance crops are positives)."""
        n = len(self.instances)
        chosen = rng.choice(n, size=min(p, n), replace=False)
        crops, ids = [], []
        for ident, idx in enumerate(chosen):
            for _ in range(k):
                crops.append(self.load_crop(int(idx), rng))
                ids.append(ident)
        return (
            np.stack(crops).astype(np.float32) / 255.0,
            np.asarray(ids, np.int32),
        )


class VocCropDataset(InstanceCropDataset):
    """PASCAL-VOC layout → identity-labeled object crops.

    Reads `Annotations/*.xml` bounding boxes + `JPEGImages/*.jpg`, and
    reuses the COCO reader's crop and PK machinery on the instance list it
    builds."""

    def __init__(self, voc_root, crop_size: int = 128, min_area: float = 400.0):
        import xml.etree.ElementTree as ET

        voc_root = Path(voc_root)
        self.images_dir = voc_root / "JPEGImages"
        self.crop_size = crop_size
        self.images = {}
        self.instances = []
        aid = 0
        for i, xml_path in enumerate(sorted((voc_root / "Annotations").glob("*.xml"))):
            tree = ET.parse(xml_path)
            fname = tree.findtext("filename") or (xml_path.stem + ".jpg")
            self.images[i] = {"id": i, "file_name": fname}
            for obj in tree.iter("object"):
                bb = obj.find("bndbox")
                x1 = float(bb.findtext("xmin"))
                y1 = float(bb.findtext("ymin"))
                x2 = float(bb.findtext("xmax"))
                y2 = float(bb.findtext("ymax"))
                area = (x2 - x1) * (y2 - y1)
                if area < min_area:
                    continue
                self.instances.append(
                    {
                        "id": aid,
                        "image_id": i,
                        "bbox": [x1, y1, x2 - x1, y2 - y1],
                        "area": area,
                    }
                )
                aid += 1


def make_synthetic_coco(root, num_images: int = 4, per_image: int = 2,
                        hw=(64, 64)):
    """A COCO-format tree: coloured rectangles as instances, the images
    JPEG at quality 95 (`{i:06d}.jpg`): the JAX package's fixture byte for
    byte, `instances.json` too."""
    root = Path(root)
    (root / "images").mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(0)
    h, w = hw
    images, annotations = [], []
    aid = 0
    for i in range(num_images):
        img = rng.integers(0, 255, (h, w, 3)).astype(np.uint8)
        for j in range(per_image):
            x, y = rng.integers(2, w // 3), rng.integers(2, h // 3)
            bw = rng.integers(w // 3, w // 2)
            bh = rng.integers(h // 3, h // 2)
            img[y : y + bh, x : x + bw] = rng.integers(0, 255, 3)
            mask = np.zeros((h, w), np.uint8)
            mask[y : y + bh, x : x + bw] = 1
            annotations.append(
                {
                    "id": aid,
                    "image_id": i,
                    "bbox": [float(x), float(y), float(bw), float(bh)],
                    "area": float(bw * bh),
                    "segmentation": rle_codec.encode(mask),
                    "category_id": 1,
                }
            )
            aid += 1
        name = f"{i:06d}.jpg"
        write_jpeg(root / "images" / name, img, 95)
        images.append({"id": i, "file_name": name, "height": h, "width": w})
    with open(root / "instances.json", "w") as f:
        json.dump({"images": images, "annotations": annotations}, f)
    return root / "images", root / "instances.json"


class DavisObjectCrops:
    """PK sampler of per-object crops from a DAVIS-layout dataset (anything
    with `.sequences` and `.load_sequence(seq, h, w, max_objects)`).

    Identity = (sequence, object id); views = the object's crops across
    frames (frames where it is absent or smaller than `min_area` pixels are
    skipped). Same-instance crops across frames are positives; everything
    else, a look-alike distractor included, is a negative.
    """

    def __init__(self, ds, crop_size: int, image_hw, max_objects: int = 8,
                 min_area: int = 16):
        h, w = image_hw
        self.crop_size = crop_size
        self.by_id: dict[tuple, list[np.ndarray]] = {}
        for seq in ds.sequences:
            data = ds.load_sequence(seq, h, w, max_objects)
            for t in range(len(data["gt_labels"])):
                lab = np.asarray(data["gt_labels"][t])
                img = np.asarray(data["frames"][t]).astype(np.float32) / 255.0
                for obj in [int(i) for i in np.unique(lab) if i > 0]:
                    m = lab == obj
                    if m.sum() < min_area:
                        continue
                    ys, xs = np.nonzero(m)
                    crop = img[ys.min() : ys.max() + 1, xs.min() : xs.max() + 1]
                    if crop.size == 0:
                        continue
                    crop = resize_linear(crop, (crop_size, crop_size))
                    self.by_id.setdefault((seq, obj), []).append(crop)
        # identities need >= 2 views for batch-hard positives
        self.ids = sorted(k for k, v in self.by_id.items() if len(v) >= 2)

    def pk_batch(self, rng, p: int = 8, k: int = 4):
        """(crops [P·K, S, S, 3] float32 in [0, 1], ids [P·K])."""
        p = min(p, len(self.ids))
        chosen = rng.choice(len(self.ids), size=p, replace=False)
        crops, ids = [], []
        for i, ci in enumerate(chosen):
            views = self.by_id[self.ids[int(ci)]]
            for _ in range(k):
                crops.append(views[rng.integers(0, len(views))])
            ids.extend([i] * k)
        return np.stack(crops).astype(np.float32), np.asarray(ids, np.int32)
