#!/usr/bin/env python3
"""Time the port's JPEG decoder (kernels/jpeg_decode.cc, host C++) on the
committed 480×854 fixtures, against another checkout's decoder in the same
process:

    python3 scripts/time_jpeg_decode.py [--against DIR] [--rounds N] [--json PATH]

Each decoder is built from its checkout's kernels/jpeg_decode.cc with the
port's host compiler and flags into a temporary directory and bound by
ctypes (both have the same C interface). Each round decodes every fixture
once with each decoder, the order alternating between rounds, so both
share whatever else the host is doing. The files are this checkout's:
tests/data/jpeg/frames (Huffman, quality 96) and
tests/data/jpeg/codings/frame_*.jpg (arithmetic sequential and progressive,
lossless, smoothed); each decode is checked against the committed Pillow
decode, and a file a decoder refuses is reported as refused. Prints one
JSON object: per decoder and file, the median ms and the quartiles. Host
code only: it needs no card.
"""

from __future__ import annotations

import argparse
import ctypes
import glob
import json
import os
import subprocess
import sys
import tempfile

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join("premvos_tpu_torch", "kernels", "jpeg_decode.cc")


def fixtures() -> list[tuple[str, str]]:
    """(JPEG, its committed Pillow decode) for every 480×854 fixture."""
    data = os.path.join(REPO, "tests", "data", "jpeg")
    out = []
    for sub, pattern in (("", "frames/*.jpg"), ("codings", "codings/frame_*.jpg")):
        for path in sorted(glob.glob(os.path.join(data, pattern))):
            stem = os.path.basename(path)[:-4]
            out.append((path, os.path.join(data, sub, "decoded", stem + ".png")))
    return out


def bind(root: str, tmp: str, tag: str):
    """`root`'s decoder, built and bound: data → RGB array, or a message."""
    from premvos_tpu_torch import kernels

    lib_path = os.path.join(tmp, f"libjpeg_decode_{tag}.so")
    subprocess.run([kernels._cxx(), *kernels.HOST_FLAGS, os.path.join(root, SOURCE), "-o",
                    lib_path], check=True)
    lib = ctypes.CDLL(lib_path)
    lib.premvos_jpeg_info.argtypes = [ctypes.c_char_p, ctypes.c_int64,
                                      ctypes.POINTER(ctypes.c_int), ctypes.c_char_p, ctypes.c_int]
    lib.premvos_jpeg_decode.argtypes = [ctypes.c_char_p, ctypes.c_int64, ctypes.c_void_p,
                                        ctypes.c_int64, ctypes.c_char_p, ctypes.c_int]

    def decode(data: bytes):
        hwc = (ctypes.c_int * 3)()
        err = ctypes.create_string_buffer(512)
        if lib.premvos_jpeg_info(data, len(data), hwc, err, 512):
            return err.value.decode()
        out = np.empty((hwc[0], hwc[1], 3), np.uint8)
        if lib.premvos_jpeg_decode(data, len(data), out.ctypes.data, out.size, err, 512):
            return err.value.decode()
        return out

    return decode


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--against", help="another checkout whose decoder runs beside this one's")
    ap.add_argument("--rounds", type=int, default=41)
    ap.add_argument("--json", help="also write the result here")
    args = ap.parse_args(argv)
    import time

    sys.path.insert(0, REPO)
    from premvos_tpu_torch.io_compat.png import read_png

    roots = {"this": REPO}
    if args.against:
        roots["against"] = os.path.abspath(args.against)
    files = [(os.path.relpath(p, os.path.join(REPO, "tests", "data", "jpeg")), open(p, "rb").read(),
              read_png(d)[0]) for p, d in fixtures()]
    result = {"roots": roots, "rounds": args.rounds, "ms": {}}
    with tempfile.TemporaryDirectory() as tmp:
        decoders = {tag: bind(root, tmp, tag) for tag, root in roots.items()}
        times = {tag: {} for tag in decoders}
        for tag, decode in decoders.items():
            for name, data, want in files:
                got = decode(data)
                if isinstance(got, str):
                    times[tag][name] = f"refused: {got}"
                elif not np.array_equal(got, want):
                    raise SystemExit(f"{roots[tag]}: {name} differs from Pillow's decode")
                else:
                    times[tag][name] = []
        order = list(decoders)
        for r in range(args.rounds):
            for tag in (order if r % 2 == 0 else order[::-1]):
                for name, data, _ in files:
                    if isinstance(times[tag][name], list):
                        t0 = time.perf_counter()
                        decoders[tag](data)
                        times[tag][name].append(1e3 * (time.perf_counter() - t0))
    for tag, per_file in times.items():
        result["ms"][tag] = {
            name: v if isinstance(v, str) else
            dict(zip(("q1", "median", "q3"), (float(q) for q in np.percentile(v, [25, 50, 75]))))
            for name, v in per_file.items()}
    line = json.dumps(result)
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)), exist_ok=True)
        with open(args.json, "w") as f:
            f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
