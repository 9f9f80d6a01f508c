"""Middlebury `.flo` optical-flow file codec (port of
premvos_tpu/io_compat/flo.py; numpy only).

Format: 4-byte magic float 202021.25 ("PIEH"), int32 width, int32 height,
then row-major float32 interleaved (u, v) pairs. FlyingChairs ships its
ground truth in it (data/flow_pairs.py reads it).
"""

from __future__ import annotations

import numpy as np

MAGIC = 202021.25


def read_flo(path) -> np.ndarray:
    """Read a .flo file → [H, W, 2] float32 (u=x-displacement, v=y)."""
    with open(path, "rb") as f:
        magic = np.frombuffer(f.read(4), np.float32)[0]
        if magic != np.float32(MAGIC):
            raise ValueError(f"{path}: bad .flo magic {magic}")
        w = int(np.frombuffer(f.read(4), np.int32)[0])
        h = int(np.frombuffer(f.read(4), np.int32)[0])
        data = np.frombuffer(f.read(h * w * 2 * 4), np.float32)
    return data.reshape(h, w, 2).copy()


def write_flo(path, flow: np.ndarray) -> None:
    """Write [H, W, 2] float32 flow to a .flo file."""
    flow = np.asarray(flow, np.float32)
    h, w, c = flow.shape
    if c != 2:
        raise ValueError(f"flow must be [H, W, 2], got {flow.shape}")
    with open(path, "wb") as f:
        f.write(np.float32(MAGIC).tobytes())
        f.write(np.int32(w).tobytes())
        f.write(np.int32(h).tobytes())
        f.write(flow.tobytes())
