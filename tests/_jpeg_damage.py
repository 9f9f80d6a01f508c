"""Damaged JPEG files for the decoder's tests and fixtures: restart markers
dropped, swapped, duplicated, prefixed with garbage or renumbered, and scan
data that ends early at an EOI marker. Shared by tests/test_torch_jpeg.py
and scripts/make_jpeg_codings_fixtures.py; it imports neither Pillow nor
the packages.
"""

from __future__ import annotations

EOI = b"\xff\xd9"
GARBAGE = b"\x12\x34\xff\x00\x56"


def restart_markers(data: bytes) -> list:
    """The offset of every RSTn marker after the first scan header."""
    at = data.index(b"\xff\xda")
    out, i = [], at + 2 + int.from_bytes(data[at + 2:at + 4], "big")
    while i < len(data) - 1:
        if data[i] == 0xFF and 0xD0 <= data[i + 1] <= 0xD7:
            out.append(i)
            i += 2
        else:
            i += 1
    return out


def drop(data: bytes, k: int) -> bytes:
    """Marker k taken out."""
    at = restart_markers(data)[k]
    return data[:at] + data[at + 2:]


def swap(data: bytes, k: int) -> bytes:
    """Markers k and k + 1 exchange their numbers."""
    a, b = restart_markers(data)[k:k + 2]
    out = bytearray(data)
    out[a + 1], out[b + 1] = data[b + 1], data[a + 1]
    return bytes(out)


def duplicate(data: bytes, k: int) -> bytes:
    """Marker k twice in a row."""
    at = restart_markers(data)[k]
    return data[:at + 2] + data[at:]


def garbage_before(data: bytes, k: int) -> bytes:
    """Bytes that are no marker (a stuffed FF 00 among them) before marker k."""
    at = restart_markers(data)[k]
    return data[:at] + GARBAGE + data[at:]


def renumber(data: bytes, k: int, by: int) -> bytes:
    """Marker k's number moved by `by` (mod 8)."""
    at = restart_markers(data)[k]
    out = bytearray(data)
    out[at + 1] = 0xD0 + (data[at + 1] - 0xD0 + by) % 8
    return bytes(out)


def restart_cases(data: bytes) -> dict:
    """name → damaged file: each kind of damage at a marker in the middle,
    and every renumbering that reaches jpeg_resync_to_restart's actions
    (n±1 and n±2: leave unread, or pass over; n±3: discard)."""
    n = len(restart_markers(data))
    assert n >= 4, "the file needs four restart markers or more"
    k = n // 2
    cases = {"drop": drop(data, k), "drop_first": drop(data, 0), "drop_last": drop(data, n - 1),
             "swap": swap(data, k), "duplicate": duplicate(data, k),
             "garbage": garbage_before(data, k)}
    for by in (1, -1, 2, -2, 3, -3):
        cases[f"rst{by:+d}"] = renumber(data, k, by)
    return cases


def scan_start(data: bytes) -> int:
    """The offset of the first scan's entropy-coded data."""
    at = data.index(b"\xff\xda")
    return at + 2 + int.from_bytes(data[at + 2:at + 4], "big")


def early_end(data: bytes, fraction: float) -> bytes:
    """The file cut at `fraction` of its length (inside its scans, never
    just after a 0xFF) and closed with EOI: the scan data ends early at a
    marker."""
    start = scan_start(data)
    cut = max(start + 1, int(len(data) * fraction))
    while data[cut - 1] == 0xFF:
        cut -= 1
    return data[:cut] + EOI
