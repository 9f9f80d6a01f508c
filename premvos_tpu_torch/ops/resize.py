"""Bilinear resize with `jax.image.resize` semantics.

`jax.image.resize(..., "bilinear")` samples at half-pixel centres and
antialiases when it downsamples (a triangle filter widened by the scale).
`F.interpolate(mode="bilinear", align_corners=False)` matches it when
upsampling; when downsampling it matches only with `antialias=True`, which
is therefore passed whenever either axis shrinks. The antialiased path runs
in float32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def resize_bilinear(x: torch.Tensor, size: tuple) -> torch.Tensor:
    """[N, C, H, W] → [N, C, *size], bilinear, jax.image.resize semantics."""
    h, w = x.shape[-2:]
    if size[0] < h or size[1] < w:
        out = F.interpolate(
            x.float(), size=size, mode="bilinear", align_corners=False,
            antialias=True,
        )
        return out.to(x.dtype)
    return F.interpolate(x, size=size, mode="bilinear", align_corners=False)
