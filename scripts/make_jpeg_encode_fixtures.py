#!/usr/bin/env python3
"""Write the fixtures of the port's JPEG encoder (io_compat/jpeg.py::encode
over kernels/jpeg_encode.cc): source images and the bytes Pillow writes for
them, which the encoder must reproduce on a machine without Pillow (the
card's, chip_smoke.py phase 7h) and in tests/test_torch_jpeg_encode.py:

    python scripts/make_jpeg_encode_fixtures.py [--out tests/data/jpeg/encoded]

  <name>.png          the source pixels, [H, W, 3] uint8, written by the
                      port's PNG codec
  <name>_q<q>.jpg     `Image.fromarray(pixels).save(f, "JPEG", quality=q)`

  scene_480x854       frame 0 of scripts/make_jpeg_fixtures.py's scene (a
                      DAVIS frame's size), at 95 and 96
  vos_128x192         frame 0 of a synthetic-protocol sequence on the
                      record's 128×192 canvas (data/synthetic_vos.py), at 96
  davis_30x40         the moving-squares frame of make_synthetic_davis, at 95
  noise_17x33         uniform noise, partial MCUs both ways, at 1 and 100

Needs Pillow; run where it is installed. The outputs are committed (about
120 kB), so rerun only to change them.
"""

from __future__ import annotations

import argparse
import io
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(REPO, "tests", "data", "jpeg", "encoded")


def sources() -> dict:
    """name → (pixels, qualities)."""
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    from make_jpeg_fixtures import scene

    from premvos_tpu_torch.data import synthetic_vos as vos

    rng = np.random.default_rng(7)
    hw = (128, 192)
    ents = vos.build_sequence_spec(rng, t=24, hw=hw, n_tracked=3, n_distractors=2)
    bg = vos._smooth_background(rng, *hw)
    frame, _ = vos.render_frame(ents, 0, hw, bg, {i: i + 1 for i in range(len(ents))})

    davis = np.random.default_rng(0).integers(0, 255, (30, 40, 3)).astype(np.uint8)
    for obj in (1, 2):
        y, x = 8 + 12 * (obj - 1), 8 + 24 * (obj - 1)
        davis[y:y + 10, x:x + 10] = [60 * obj, 160, 60]
    noise = np.random.default_rng(3).integers(0, 256, (17, 33, 3)).astype(np.uint8)
    return {"scene_480x854": (scene(0)[0], (95, 96)), "vos_128x192": (frame, (96,)),
            "davis_30x40": (davis, (95,)), "noise_17x33": (noise, (1, 100))}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=OUT)
    args = ap.parse_args(argv)
    sys.path.insert(0, REPO)
    from PIL import Image

    from premvos_tpu_torch.io_compat.png import write_png

    os.makedirs(args.out, exist_ok=True)
    for name, (pixels, qualities) in sources().items():
        write_png(os.path.join(args.out, f"{name}.png"), pixels)
        for q in qualities:
            buf = io.BytesIO()
            Image.fromarray(pixels).save(buf, "JPEG", quality=q)
            with open(os.path.join(args.out, f"{name}_q{q}.jpg"), "wb") as f:
                f.write(buf.getvalue())
    total = sum(os.path.getsize(os.path.join(args.out, f)) for f in os.listdir(args.out))
    print(f"wrote {args.out}: {total} bytes")
    return 0


if __name__ == "__main__":
    sys.exit(main())
