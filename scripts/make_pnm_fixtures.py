#!/usr/bin/env python3
"""Write the PNM fixtures that chip_smoke.py reads on the card, whose
machine has no Pillow:

    python scripts/make_pnm_fixtures.py [--out tests/data/pnm]

  <name>.ppm          every case of tests/_pnm_cases.py: each header of
                      Pillow's PpmImagePlugin.MODES (P1-P6, Pf, P0CMYK,
                      PyP, PyRGBA, PyCMYK) at each class of maxval (255,
                      below it, above it, 65535), and a PNG and a JPEG
                      named .ppm, which Pillow reads by their content
  decoded/<name>.png  Pillow's decode, `Image.open(p).convert("RGB")`,
                      written by the port's PNG codec: what the port's
                      reader (io_compat/ppm.py::read_ppm) must return

Needs Pillow; run where it is installed, not on the card's machine. The
outputs are committed, so rerun only to change them.
"""

from __future__ import annotations

import argparse
import os
import shutil
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=os.path.join(REPO, "tests", "data", "pnm"))
    args = ap.parse_args(argv)
    sys.path.insert(0, REPO)
    from PIL import Image

    from premvos_tpu_torch.io_compat.png import write_png
    from tests import _pnm_cases

    cases = _pnm_cases.pnm_cases()
    cases.update({kind: _pnm_cases.pillow_bytes(kind) for kind in _pnm_cases.OTHER_FORMATS})
    if os.path.isdir(args.out):
        shutil.rmtree(args.out)
    os.makedirs(os.path.join(args.out, "decoded"))
    for name, data in cases.items():
        path = os.path.join(args.out, name + ".ppm")
        with open(path, "wb") as f:
            f.write(data)
        with Image.open(path) as im:
            write_png(os.path.join(args.out, "decoded", name + ".png"),
                      np.asarray(im.convert("RGB")))
    total = sum(os.path.getsize(os.path.join(d, f))
                for d, _, files in os.walk(args.out) for f in files)
    print(f"wrote {len(cases)} files and their decodes to {args.out}: {total} bytes")
    return 0


if __name__ == "__main__":
    sys.exit(main())
