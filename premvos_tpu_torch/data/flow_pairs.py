"""Optical-flow training pairs: the FlyingChairs layout (port of
premvos_tpu/data/flow_pairs.py).

Flat directories of `xxxxx_img1.ppm`, `xxxxx_img2.ppm` and
`xxxxx_flow.flo` (flownet2's `datasets.py`). Images are read as Pillow's
`Image.open(p).convert("RGB")` reads them (io_compat/ppm.py::read_ppm:
every PNM header, and a PNG or JPEG by its content) and written as binary
PPM, and ground-truth flow goes through the `.flo` codec, so neither
Pillow nor OpenCV is needed. `batch` draws from
the numpy generator in the JAX package's order (the sample indices, then
each sample's crop corner), so one seed gives the same crops in both.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from premvos_tpu_torch.io_compat.flo import read_flo, write_flo
from premvos_tpu_torch.io_compat.ppm import read_ppm, write_ppm


class FlowPairDataset:
    def __init__(self, root):
        self.root = Path(root)
        self.samples = sorted(
            p.name[:-9] for p in self.root.iterdir() if p.name.endswith("_img1.ppm")
        )

    def __len__(self):
        return len(self.samples)

    def load(self, idx: int):
        """→ (img1 [H,W,3] uint8, img2, flow [H,W,2] float32)."""
        s = self.samples[idx]
        i1 = read_ppm(self.root / f"{s}_img1.ppm")
        i2 = read_ppm(self.root / f"{s}_img2.ppm")
        fl = read_flo(self.root / f"{s}_flow.flo")
        return i1, i2, fl

    def batch(self, rng, batch_size: int, crop_hw=None):
        """(img1, img2 [B, h, w, 3] float32 in [0, 1], flow [B, h, w, 2]),
        random samples and, with crop_hw, random crops of them."""
        idx = rng.integers(0, len(self.samples), size=batch_size)
        i1s, i2s, fls = [], [], []
        for i in idx:
            i1, i2, fl = self.load(int(i))
            if crop_hw is not None:
                ch, cw = crop_hw
                y = rng.integers(0, max(i1.shape[0] - ch, 0) + 1)
                x = rng.integers(0, max(i1.shape[1] - cw, 0) + 1)
                i1 = i1[y : y + ch, x : x + cw]
                i2 = i2[y : y + ch, x : x + cw]
                fl = fl[y : y + ch, x : x + cw]
            i1s.append(i1)
            i2s.append(i2)
            fls.append(fl)
        return (
            np.stack(i1s).astype(np.float32) / 255.0,
            np.stack(i2s).astype(np.float32) / 255.0,
            np.stack(fls).astype(np.float32),
        )


def make_synthetic_chairs(root, n: int = 4, hw=(64, 64)):
    """A FlyingChairs-layout tree: translating random images with the exact
    ground-truth flow (the JAX package's fixture, the same files)."""
    root = Path(root)
    root.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(0)
    h, w = hw
    for i in range(n):
        img = rng.integers(0, 255, (h, w, 3)).astype(np.uint8)
        dx, dy = int(rng.integers(-4, 5)), int(rng.integers(-4, 5))
        img2 = np.roll(np.roll(img, dy, 0), dx, 1)
        # Backward-warp convention: img1(x) = img2(x + flow) ⇒ flow = (dx, dy)
        flow = np.zeros((h, w, 2), np.float32)
        flow[..., 0] = dx
        flow[..., 1] = dy
        write_ppm(root / f"{i:05d}_img1.ppm", img)
        write_ppm(root / f"{i:05d}_img2.ppm", img2)
        write_flo(root / f"{i:05d}_flow.flo", flow)
    return root
