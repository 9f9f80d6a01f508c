"""ChannelNorm: per-pixel L2 norm across channels (port of
premvos_tpu/ops/channelnorm.py). NCHW: [B, C, H, W] → [B, 1, H, W]."""

from __future__ import annotations

import torch


def channelnorm(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    return torch.sqrt(torch.sum(x * x, dim=1, keepdim=True) + eps)
