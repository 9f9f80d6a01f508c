"""Feature Pyramid Network on ResNet C2..C5 → P2..P6 (port of
premvos_tpu/models/fpn.py), NCHW.

Lateral 1×1 + top-down nearest ×2 + output 3×3; P6 is P5[..., ::2, ::2]
(the JAX package's 1×1 max-pool with stride 2; RPN-only level).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from premvos_tpu_torch.models.layers import Conv

FPN_STRIDES = {"P2": 4, "P3": 8, "P4": 16, "P5": 32, "P6": 64}
FPN_LEVELS = ("P2", "P3", "P4", "P5", "P6")
_IN_CHANNELS = {"C2": 256, "C3": 512, "C4": 1024, "C5": 2048}


class FPN(nn.Module):
    def __init__(self, channels=256, dtype=torch.float32):
        super().__init__()
        for n, c in _IN_CHANNELS.items():
            self.add_module(f"lat_{n}", Conv(c, channels, 1, dtype=dtype))
            self.add_module(
                f"out_P{n[1]}", Conv(channels, channels, 3, padding=1, dtype=dtype)
            )

    def forward(self, feats: dict) -> dict:
        names = list(_IN_CHANNELS)
        laterals = [getattr(self, f"lat_{n}")(feats[n]) for n in names]
        tops = [laterals[-1]]
        for lat in laterals[-2::-1]:
            tops.append(lat + F.interpolate(tops[-1], scale_factor=2, mode="nearest"))
        tops = tops[::-1]
        out = {}
        for n, t in zip(names, tops):
            out[f"P{n[1]}"] = getattr(self, f"out_P{n[1]}")(t)
        out["P6"] = out["P5"][..., ::2, ::2]
        return out
