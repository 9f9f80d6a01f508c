#!/usr/bin/env python3
"""Write the JPEG fixtures that chip_smoke.py reads on the card, whose
machine has no JPEG encoder (no Pillow):

    python scripts/make_jpeg_fixtures.py [--out tests/data/jpeg]

  frames/0000{0,1,2}.jpg   three 480×854 synthetic frames, written by Pillow
                           at quality 96 (data/synthetic_vos.py's setting):
                           flat bands and two objects drifting a few pixels a
                           frame, each with a textured patch
  annotation.png           frame 0's palette label map (ids 1 and 2)
  decoded/0000{0,1,2}.png  Pillow's decode of each frame,
                           `Image.open(p).convert("RGB")`, written by the
                           port's PNG codec: what the port's JPEG decoder
                           must return

Needs Pillow; run where it is installed. The outputs are committed (164 kB
in all), so rerun only to change the frames.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HW = (480, 854)
FRAMES = 3
QUALITY = 96


def scene(t: int):
    """Frame t's RGB pixels and label map: horizontal bands, object 1 a
    rectangle moving right, object 2 a disc moving left and down, each with
    a textured patch (seeded)."""
    h, w = HW
    img = np.zeros((h, w, 3), np.uint8)
    bands = [(70, 110, 150), (95, 140, 80), (160, 150, 120), (60, 60, 70)]
    for i, color in enumerate(bands):
        img[i * h // len(bands):(i + 1) * h // len(bands)] = color
    lab = np.zeros((h, w), np.uint8)
    y, x = 120, 160 + 6 * t
    img[y:y + 150, x:x + 110] = (220, 60, 40)
    lab[y:y + 150, x:x + 110] = 1
    yy, xx = np.mgrid[0:h, 0:w]
    disc = (yy - (260 + 4 * t)) ** 2 + (xx - (560 - 5 * t)) ** 2 < 85 ** 2
    img[disc] = (40, 90, 210)
    lab[disc] = 2
    rng = np.random.default_rng(t)
    patch = rng.integers(0, 256, (32, 32, 3)).astype(np.uint8)
    img[y + 40:y + 72, x + 40:x + 72] = patch
    img[230 + 4 * t:262 + 4 * t, 540 - 5 * t:572 - 5 * t] = patch[::-1]
    return img, lab


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=os.path.join(REPO, "tests", "data", "jpeg"))
    args = ap.parse_args(argv)
    sys.path.insert(0, REPO)
    from PIL import Image

    from premvos_tpu_torch.data.palette import save_indexed_png
    from premvos_tpu_torch.io_compat.png import write_png

    for sub in ("frames", "decoded"):
        os.makedirs(os.path.join(args.out, sub), exist_ok=True)
    for t in range(FRAMES):
        img, lab = scene(t)
        jpg = os.path.join(args.out, "frames", f"{t:05d}.jpg")
        Image.fromarray(img).save(jpg, quality=QUALITY)
        with Image.open(jpg) as im:
            write_png(os.path.join(args.out, "decoded", f"{t:05d}.png"),
                      np.asarray(im.convert("RGB")))
        if t == 0:
            save_indexed_png(os.path.join(args.out, "annotation.png"), lab)
    total = sum(os.path.getsize(os.path.join(d, f))
                for d, _, files in os.walk(args.out) for f in files)
    print(f"wrote {args.out}: {total} bytes")
    return 0


if __name__ == "__main__":
    sys.exit(main())
