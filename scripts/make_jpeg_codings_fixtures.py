#!/usr/bin/env python3
"""Write the JPEG fixtures of the codings Pillow reads and cannot write:
arithmetic-coded sequential (SOF9) and progressive (SOF10) JPEG, lossless
JPEG (SOF3), and a progressive frame whose later scans are cut off, which
libjpeg block-smooths:

    python scripts/make_jpeg_codings_fixtures.py [--out tests/data/jpeg/codings]

  <name>.jpg            the test matrix: small files of every coding
                        (gray, 4:4:4, 4:2:2 and 4:2:0; sizes that are not
                        whole MCUs; restart intervals; DAC conditioning
                        other than the default; lossless predictors 1-7 at
                        point transforms 0 and 2)
  frame_<coding>.jpg    scripts/make_jpeg_fixtures.py's synthetic 480×854
                        frame 0 in each coding: arith_seq, arith_prog,
                        lossless, smoothed (Pillow's progressive file at
                        quality 96 cut before its sixth scan, EOI appended)
  decoded/<name>.png    Pillow's decode of each file, opened by path as the
                        JAX readers open frames, `Image.open(p).convert("RGB")`,
                        written by the port's PNG codec: what the port's
                        JPEG decoder must return
  large/arith_seq_444_240x320.jpg
                        an arithmetic-coded file of 102 kB, whose scan data
                        crosses Pillow's 64 KiB read block: libjpeg's
                        arithmetic decoder cannot wait for the next block,
                        so Pillow refuses it at its default block size and
                        reads it at a larger one (no decode committed)
  ../damaged/<name>.jpg  damaged files (tests/_jpeg_damage.py) that Pillow
                        reads: scripts/make_jpeg_fixtures.py's frame 0
                        written by Pillow with restart intervals and a
                        restart marker dropped, renumbered (+1, -2) or
                        preceded by garbage, or swapped in a progressive
                        file; frames whose scan data ends early at an EOI
                        marker (baseline, progressive, the arithmetic-coded
                        frame above); the small lossless file with a marker
                        dropped and cut early
  ../damaged/decoded/<name>.png
                        Pillow's decode of each, as decoded/ above

The files are written by scripts/jpeg_codings_encoder.c, a small C program
over libjpeg, which this script compiles with gcc against the system's
<jpeglib.h>: linked with the system's libjpeg (-ljpeg, libjpeg-turbo 2.1,
built with arithmetic coding) for SOF9 and SOF10, and with the libjpeg-turbo
3.1 that Pillow bundles (pillow.libs/libjpeg-*.so.62.4.0: libjpeg-turbo 3
has jpeg_enable_lossless, which the 2.1 header does not declare) for SOF3.
Run it on a machine with gcc, libjpeg's headers and Pillow, not on the
card's. The outputs are committed, so rerun only to change them;
`--only damaged` rewrites the damaged files alone (Pillow only, no gcc).
"""

from __future__ import annotations

import argparse
import glob
import io
import os
import shutil
import subprocess
import sys
import tempfile

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENCODER = os.path.join(REPO, "scripts", "jpeg_codings_encoder.c")
SAMPLING = {"gray": None, "444": "1x1,1x1,1x1", "422": "2x1,1x1,1x1", "420": "2x2,1x1,1x1"}

# (name, (H, W), sampling, encoder keys): the test matrix.
ARITH = [
    ("gray_45x67", (45, 67), "gray", {}),
    ("444_45x67", (45, 67), "444", {}),
    ("422_45x67", (45, 67), "422", {}),
    ("420_45x67", (45, 67), "420", {}),
    ("420_61x83_restart3", (61, 83), "420", dict(restart=3)),
    ("422_97x131_restart_rows1", (97, 131), "422", dict(restart_rows=1)),
    ("444_33x5_dac", (33, 5), "444", dict(dac="2,5,10")),
    ("420_17x23_dac_restart1", (17, 23), "420", dict(dac="0,0,1", restart=1)),
    ("gray_57x91_dac_q30", (57, 91), "gray", dict(dac="3,7,30", quality=30)),
    ("420_64x96_q98", (64, 96), "420", dict(quality=98)),
]
LOSSLESS = [
    ("p1_pt0_444_restart1", (45, 67), "444", dict(lossless="1,0", restart_rows=1)),
    ("p1_pt2_gray", (45, 67), "gray", dict(lossless="1,2")),
    ("p2_pt0_gray_restart2", (45, 67), "gray", dict(lossless="2,0", restart_rows=2)),
    ("p2_pt2_420", (45, 67), "420", dict(lossless="2,2")),
    ("p3_pt0_420", (45, 67), "420", dict(lossless="3,0")),
    ("p3_pt2_444_restart3", (45, 67), "444", dict(lossless="3,2", restart_rows=3)),
    ("p4_pt0_444", (45, 67), "444", dict(lossless="4,0")),
    ("p4_pt2_gray", (33, 5), "gray", dict(lossless="4,2")),
    ("p5_pt0_gray", (45, 67), "gray", dict(lossless="5,0")),
    ("p5_pt2_420_restart1", (17, 23), "420", dict(lossless="5,2", restart_rows=1)),
    ("p6_pt0_420_restart2", (45, 67), "420", dict(lossless="6,0", restart_rows=2)),
    ("p6_pt2_444", (45, 67), "444", dict(lossless="6,2")),
    ("p7_pt0_444", (61, 83), "444", dict(lossless="7,0")),
    ("p7_pt2_gray_restart1", (45, 67), "gray", dict(lossless="7,2", restart_rows=1)),
]
SMOOTHED_SCANS = 5  # scans kept of Pillow's ten-scan progressive frame


def texture(h: int, w: int, seed: int) -> np.ndarray:
    """Smooth gradients, an edge and noise: every coefficient band in use."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    a = np.stack([128 + 100 * np.sin(xx / 7.0 + yy / 13.0), 128 + 90 * np.cos(yy / 5.0),
                  (xx * 3 + yy * 2) % 256], -1)
    a[h // 3: h // 2, w // 4: w // 2] = (250, 10, 120)
    return np.clip(a + rng.normal(0, 20, a.shape), 0, 255).astype(np.uint8)


def build_encoders(tmp: str) -> tuple[str, str]:
    """The encoder linked with the system's libjpeg and with Pillow's."""
    import PIL

    libs = glob.glob(os.path.join(os.path.dirname(PIL.__file__), os.pardir, "pillow.libs",
                                  "libjpeg-*.so.62.4.0"))
    if not libs:
        raise SystemExit("Pillow's bundled libjpeg-turbo 3 (pillow.libs/libjpeg-*.so.62.4.0) "
                         "was not found")
    lib = os.path.realpath(libs[0])
    plain, lossless = os.path.join(tmp, "enc"), os.path.join(tmp, "enc_lossless")
    subprocess.run(["gcc", "-O2", "-o", plain, ENCODER, "-ljpeg"], check=True)
    subprocess.run(["gcc", "-O2", "-DWITH_LOSSLESS", "-o", lossless, ENCODER, lib,
                    f"-Wl,-rpath,{os.path.dirname(lib)}"], check=True)
    return plain, lossless


def encode(exe: str, pixels: np.ndarray, path: str, tmp: str, **keys) -> None:
    h, w = pixels.shape[:2]
    raw = os.path.join(tmp, "in.raw")
    with open(raw, "wb") as f:
        f.write(np.ascontiguousarray(pixels).tobytes())
    comps = 1 if pixels.ndim == 2 else 3
    subprocess.run([exe, raw, path, str(w), str(h), str(comps)]
                   + [f"{k}={v}" for k, v in keys.items()], check=True)


def scan_offsets(data: bytes) -> list[int]:
    """The byte offset of each SOS marker."""
    out, i = [], 2
    while i < len(data) - 1:
        if data[i] == 0xFF and data[i + 1] not in (0x00, 0xFF) and not 0xD0 <= data[i + 1] <= 0xD7:
            marker = data[i + 1]
            if marker in (0xD8, 0xD9):
                i += 2
                continue
            if marker == 0xDA:
                out.append(i)
            i += 2 + int.from_bytes(data[i + 2:i + 4], "big")
        else:
            i += 1
    return out


def write_damaged(out: str, codings: str) -> None:
    """The damaged files and Pillow's decodes (docstring above)."""
    from PIL import Image, ImageFile

    from make_jpeg_fixtures import scene
    from premvos_tpu_torch.io_compat.png import write_png
    from tests import _jpeg_damage as damage

    def pillow(**kw) -> bytes:
        buf = io.BytesIO()
        Image.fromarray(scene(0)[0]).save(buf, "JPEG", **kw)
        return buf.getvalue()

    def coding(name: str) -> bytes:
        with open(os.path.join(codings, name + ".jpg"), "rb") as f:
            return f.read()

    rows = pillow(quality=96, restart_marker_rows=1)
    blocks = pillow(quality=90, restart_marker_blocks=6)
    progressive = pillow(quality=90, progressive=True, restart_marker_rows=2)
    middle = lambda data: len(damage.restart_markers(data)) // 2  # noqa: E731
    files = {
        "frame_restart_drop": damage.drop(rows, middle(rows)),
        "frame_restart_rst+1": damage.renumber(rows, middle(rows), 1),
        "frame_restart_rst-2": damage.renumber(blocks, middle(blocks), -2),
        "frame_restart_garbage": damage.garbage_before(blocks, middle(blocks)),
        "frame_progressive_restart_swap": damage.swap(progressive, middle(progressive)),
        "frame_early_end_30": damage.early_end(pillow(quality=96), 0.3),
        "frame_progressive_early_end_50": damage.early_end(pillow(quality=90, progressive=True),
                                                           0.5),
        "frame_arith_seq_early_end_50": damage.early_end(coding("frame_arith_seq"), 0.5),
        "lossless_restart_drop_early_end_70": damage.early_end(
            damage.drop(coding("lossless_p1_pt0_444_restart1"), 10), 0.7),
    }
    if os.path.isdir(out):
        shutil.rmtree(out)
    os.makedirs(os.path.join(out, "decoded"))
    ImageFile.MAXBLOCK = 65536  # Pillow's default read block, as the readers read
    for name, data in files.items():
        path = os.path.join(out, name + ".jpg")
        with open(path, "wb") as f:
            f.write(data)
        with Image.open(path) as im:
            write_png(os.path.join(out, "decoded", name + ".png"), np.asarray(im.convert("RGB")))
    total = sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(out) for f in fs)
    print(f"wrote {len(files)} damaged files and their decodes to {out}: {total} bytes")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=os.path.join(REPO, "tests", "data", "jpeg", "codings"))
    ap.add_argument("--damaged-out", default=os.path.join(REPO, "tests", "data", "jpeg",
                                                          "damaged"))
    ap.add_argument("--only", choices=("all", "codings", "damaged"), default="all")
    args = ap.parse_args(argv)
    sys.path.insert(0, REPO)
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    if args.only != "codings":
        write_damaged(args.damaged_out, args.out)
    if args.only == "damaged":
        return 0
    from PIL import Image

    from make_jpeg_fixtures import scene
    from premvos_tpu_torch.io_compat.png import write_png

    if os.path.isdir(args.out):
        shutil.rmtree(args.out)
    os.makedirs(os.path.join(args.out, "decoded"))
    with tempfile.TemporaryDirectory() as tmp:
        plain, lossless = build_encoders(tmp)
        names = []
        for prefix, rows, exe, base in (("arith_seq", ARITH, plain, dict(arith=1)),
                                        ("arith_prog", ARITH, plain, dict(arith=1, progressive=1)),
                                        ("lossless", LOSSLESS, lossless, {})):
            for name, hw, sampling, keys in rows:
                pixels = texture(*hw, seed=len(names))
                keys = {**base, **keys}
                if SAMPLING[sampling] is None:
                    pixels = pixels[..., 0].copy()
                else:
                    keys["sampling"] = SAMPLING[sampling]
                names.append(f"{prefix}_{name}")
                encode(exe, pixels, os.path.join(args.out, names[-1] + ".jpg"), tmp, **keys)
        frame = scene(0)[0]
        encode(plain, frame, os.path.join(args.out, "frame_arith_seq.jpg"), tmp, arith=1,
               quality=96)
        encode(plain, frame, os.path.join(args.out, "frame_arith_prog.jpg"), tmp, arith=1,
               progressive=1, quality=96)
        encode(lossless, frame, os.path.join(args.out, "frame_lossless.jpg"), tmp,
               lossless="1,0")
        progressive = os.path.join(tmp, "progressive.jpg")
        Image.fromarray(frame).save(progressive, quality=96, progressive=True)
        with open(progressive, "rb") as f:
            data = f.read()
        with open(os.path.join(args.out, "frame_smoothed.jpg"), "wb") as f:
            f.write(data[:scan_offsets(data)[SMOOTHED_SCANS]] + b"\xff\xd9")
        names += ["frame_arith_seq", "frame_arith_prog", "frame_lossless", "frame_smoothed"]
        os.makedirs(os.path.join(args.out, "large"))
        encode(plain, texture(240, 320, seed=len(names)),
               os.path.join(args.out, "large", "arith_seq_444_240x320.jpg"), tmp, arith=1,
               quality=95, sampling=SAMPLING["444"])
    for name in names:
        with Image.open(os.path.join(args.out, name + ".jpg")) as im:
            write_png(os.path.join(args.out, "decoded", name + ".png"),
                      np.asarray(im.convert("RGB")))
    total = sum(os.path.getsize(os.path.join(d, f))
                for d, _, files in os.walk(args.out) for f in files)
    print(f"wrote {len(names)} files and their decodes to {args.out}: {total} bytes")
    return 0


if __name__ == "__main__":
    sys.exit(main())
