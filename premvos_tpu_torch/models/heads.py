"""Fast R-CNN box head and class-agnostic mask head (port of
premvos_tpu/models/heads.py)."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from premvos_tpu_torch.models.layers import Conv, ConvTranspose, Dense


class BoxHead(nn.Module):
    """2-FC head → classification logits + class-agnostic box deltas.

    Input [K, P·P·C] — RoI features flattened in (P, P, C) order, as the
    flax head flattens its [K, P, P, C] input.
    """

    def __init__(self, in_features, num_classes=2, hidden=1024, dtype=torch.float32):
        super().__init__()
        self.Dense_0 = Dense(in_features, hidden, dtype)
        self.Dense_1 = Dense(hidden, hidden, dtype)
        self.Dense_2 = Dense(hidden, num_classes, dtype)
        self.Dense_3 = Dense(hidden, 4, dtype)

    def forward(self, x):
        x = F.relu(self.Dense_0(x))
        x = F.relu(self.Dense_1(x))
        return self.Dense_2(x), self.Dense_3(x)


class MaskHead(nn.Module):
    """4× conv + 2× deconv + 1×1 → [K, 2P, 2P] class-agnostic mask logits."""

    def __init__(self, in_ch, channels=256, dtype=torch.float32):
        super().__init__()
        for i in range(4):
            self.add_module(
                f"conv{i}",
                Conv(in_ch if i == 0 else channels, channels, 3, padding=1, dtype=dtype),
            )
        self.deconv = ConvTranspose(channels, channels, 2, 2, 0, dtype)
        self.logits = Conv(channels, 1, 1, dtype=dtype)

    def forward(self, x):
        for i in range(4):
            x = F.relu(getattr(self, f"conv{i}")(x))
        x = F.relu(self.deconv(x))
        return self.logits(x)[:, 0]
