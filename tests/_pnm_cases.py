"""PNM files of every header Pillow 12 reads (PpmImagePlugin.MODES), at each
class of maxval, and a PNG and a JPEG named `.ppm`: the cases
tests/test_torch_pnm.py holds against Pillow and
scripts/make_pnm_fixtures.py commits for the card. Made from a seeded
numpy generator; `pillow_bytes` needs Pillow, the rest does not.
"""

from __future__ import annotations

import io

import numpy as np

H, W = 5, 7  # odd sizes: P4 rows end inside a byte


def _rng(name: str):
    return np.random.default_rng([16, sum(name.encode())])


def _plain(values, per_line=9) -> bytes:
    flat = [str(int(v)) for v in np.asarray(values).reshape(-1)]
    lines = [" ".join(flat[i:i + per_line]) for i in range(0, len(flat), per_line)]
    return ("\n".join(lines) + "\n").encode()


def _raw(values, maxval) -> bytes:
    return np.asarray(values, ">u2" if maxval > 255 else np.uint8).tobytes()


def _samples(name, maxval, bands):
    """Samples over the whole range, the extremes and mid points included."""
    v = _rng(name).integers(0, maxval + 1, (H, W, bands))
    v.reshape(-1)[:3] = (0, maxval, maxval // 2)
    return v


def pnm_cases() -> dict:
    """name → file bytes."""
    cases = {}
    bits = _rng("bits").integers(0, 2, (H, W))
    cases["P1"] = (b"P1\n# a comment\n%d %d\n" % (W, H)
                   + b"".join(b"".join(b"%d" % b for b in row) + b"\n" for row in bits))
    cases["P1_spaced"] = b"P1 %d %d\n" % (W, H) + _plain(bits, per_line=4)
    packed = np.packbits(bits, axis=1)
    cases["P4"] = b"P4\n%d %d\n" % (W, H) + packed.tobytes()
    for magic, bands, plain in ((b"P2", 1, True), (b"P5", 1, False), (b"P3", 3, True),
                                (b"P6", 3, False)):
        for maxval in (255, 15, 100, 1000, 65535):
            name = f"{magic.decode()}_max{maxval}"
            v = _samples(name, maxval, bands)
            head = b"%s\n%d %d\n%d\n" % (magic, W, H, maxval)
            cases[name] = head + (_plain(v) if plain else _raw(v, maxval))
    cases["P6_comments_crlf"] = (b"P6\r\n# made by hand\r\n%d  %d # size\r\n255\n" % (W, H)
                                 + _raw(_samples("crlf", 255, 3), 255))
    floats = _rng("pf").uniform(-20, 280, (H, W)).astype(np.float64)
    floats.reshape(-1)[:6] = (0.5, 254.99, -0.5, np.nan, np.inf, -np.inf)
    cases["Pf_little"] = b"Pf\n%d %d\n-1.0\n" % (W, H) + floats.astype("<f4").tobytes()
    cases["Pf_big"] = b"Pf\n%d %d\n2.5\n" % (W, H) + floats.astype(">f4").tobytes()
    for magic, bands in ((b"P0CMYK", 4), (b"PyCMYK", 4), (b"PyRGBA", 4), (b"PyP", 1)):
        for maxval in (255, 1000):
            name = f"{magic.decode()}_max{maxval}"
            v = _samples(name, maxval, bands)
            cases[name] = b"%s\n%d %d\n%d\n" % (magic, W, H, maxval) + _raw(v, maxval)
    return cases


def pillow_bytes(kind: str) -> bytes:
    """A PNG (RGB, palette) or a JPEG that a `.ppm` name may hold."""
    from PIL import Image

    rgb = _rng(kind).integers(0, 256, (H * 3, W * 3, 3), dtype=np.uint8)
    im = Image.fromarray(rgb)
    buf = io.BytesIO()
    if kind == "png_rgb":
        im.save(buf, "PNG")
    elif kind == "png_palette":
        im.quantize(16).save(buf, "PNG")
    else:
        im.save(buf, "JPEG", quality=90)
    return buf.getvalue()


OTHER_FORMATS = ("png_rgb", "png_palette", "jpeg")

# name → (file bytes, what the refusal names)
REFUSALS = {
    "magic_P6X": (b"P6X\n7 5\n255\n" + bytes(105), "magic b'P6X'"),
    "magic_P7": (b"P7\n7 5\n255\n" + bytes(105), "none of them"),
    "maxval_0": (b"P6\n7 5\n0\n" + bytes(105), "maxval 0"),
    "maxval_65536": (b"P5\n7 5\n65536\n" + bytes(70), "maxval 65536"),
    "truncated_P6": (b"P6\n7 5\n255\n" + bytes(100), "truncated P6 data"),
    "truncated_P3": (b"P3\n7 5\n255\n" + b"1 2 3\n", "truncated P3 data"),
    "sample_above_maxval": (b"P2\n2 1\n15\n3 16\n", "P2 sample 16 outside 0-15"),
    "P1_token": (b"P1\n2 1\n0 2\n", "P1 data holds b'2'"),
    "Pf_scale_0": (b"Pf\n1 1\n0.0\n" + bytes(4), "Pf scale 0.0"),
    "header_ends": (b"P6\n7", "header ends"),
    "bmp": (b"BM" + bytes(64), "none of them"),
}
