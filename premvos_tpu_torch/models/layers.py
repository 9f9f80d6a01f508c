"""Layers shaped like their flax counterparts.

Each layer keeps float32 parameters and computes in its `dtype` (inputs and
parameters are cast on the way in, as flax's `dtype` argument does), so
`pipeline.dtype = "bfloat16"` means bf16 convolutions over fp32 weights.
Parameter names and layouts are PyTorch's (Conv [O, I, kh, kw], Dense
[out, in]); bridge.py maps flax trees onto them. `reset_parameters` draws
flax's default initializers (truncated-normal LeCun for kernels, zeros for
biases) from an explicit torch.Generator.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

# flax's lecun_normal draws a normal truncated to ±2σ and rescales σ so the
# truncated distribution keeps variance 1/fan_in.
_TRUNC_STD = 0.87962566103423978


def _lecun_normal_(w: torch.Tensor, fan_in: int, gen: torch.Generator) -> None:
    """Draw into a fresh contiguous tensor on gen's device, then copy: the
    values land on the same logical elements whatever w's device and memory
    format (an in-place draw into a channels-last tensor would follow its
    storage order)."""
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    draw = torch.empty(w.shape, dtype=torch.float32, device=gen.device)
    nn.init.trunc_normal_(draw, 0.0, std, -2.0 * std, 2.0 * std, generator=gen)
    with torch.no_grad():
        w.copy_(draw)


class Conv(nn.Module):
    """flax `nn.Conv` in NCHW: weight [O, I, k, k], symmetric padding."""

    def __init__(self, in_ch, out_ch, k, stride=1, padding=0, dilation=1,
                 bias=True, dtype=torch.float32):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_ch, in_ch, k, k))
        self.bias = nn.Parameter(torch.zeros(out_ch)) if bias else None
        self.stride, self.padding, self.dilation = stride, padding, dilation
        self.dtype = dtype

    def reset_parameters(self, gen: torch.Generator) -> None:
        o, i, kh, kw = self.weight.shape
        _lecun_normal_(self.weight, i * kh * kw, gen)
        if self.bias is not None:
            with torch.no_grad():
                self.bias.zero_()

    def forward(self, x):
        b = None if self.bias is None else self.bias.to(self.dtype)
        return F.conv2d(
            x.to(self.dtype), self.weight.to(self.dtype), b, self.stride,
            self.padding, self.dilation,
        )


class ConvTranspose(nn.Module):
    """flax `nn.ConvTranspose(k, strides=s, padding="SAME")`.

    For the two shapes used here, (4, s2) and (2, s2), that is torch's
    transposed convolution with padding (k − s) / 2 (1 and 0) and a weight
    [I, O, k, k] equal to the flax kernel flipped in space (bridge.py).
    """

    def __init__(self, in_ch, out_ch, k, stride, padding, dtype=torch.float32):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(in_ch, out_ch, k, k))
        self.bias = nn.Parameter(torch.zeros(out_ch))
        self.stride, self.padding = stride, padding
        self.dtype = dtype

    def reset_parameters(self, gen: torch.Generator) -> None:
        i, o, kh, kw = self.weight.shape
        _lecun_normal_(self.weight, i * kh * kw, gen)
        with torch.no_grad():
            self.bias.zero_()

    def forward(self, x):
        return F.conv_transpose2d(
            x.to(self.dtype), self.weight.to(self.dtype),
            self.bias.to(self.dtype), self.stride, self.padding,
        )


class Dense(nn.Module):
    """flax `nn.Dense`: weight [out, in]."""

    def __init__(self, in_features, out_features, dtype=torch.float32):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        self.bias = nn.Parameter(torch.zeros(out_features))
        self.dtype = dtype

    def reset_parameters(self, gen: torch.Generator) -> None:
        _lecun_normal_(self.weight, self.weight.shape[1], gen)
        with torch.no_grad():
            self.bias.zero_()

    def forward(self, x):
        return F.linear(
            x.to(self.dtype), self.weight.to(self.dtype), self.bias.to(self.dtype)
        )


class FrozenBatchNorm(nn.Module):
    """BatchNorm with frozen statistics, folded to x·inv + b in the compute
    dtype (inv and b computed in float32 first, eps 1e-5)."""

    def __init__(self, c, dtype=torch.float32):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("mean", torch.zeros(c))
        self.register_buffer("var", torch.ones(c))
        self.dtype = dtype

    def reset_parameters(self, gen: torch.Generator) -> None:
        with torch.no_grad():
            self.scale.fill_(1.0)
            self.bias.zero_()
            self.mean.zero_()
            self.var.fill_(1.0)

    def forward(self, x):
        inv = self.scale / torch.sqrt(self.var + 1e-5)
        b = self.bias - self.mean * self.scale / torch.sqrt(self.var + 1e-5)
        return x * inv.to(self.dtype)[:, None, None] + b.to(self.dtype)[:, None, None]


PARAM_LAYERS = (Conv, ConvTranspose, Dense, FrozenBatchNorm)


def init_module(module: nn.Module, gen: torch.Generator) -> None:
    """Re-draw every parameter of `module` from `gen`, in module order."""
    for m in module.modules():
        if isinstance(m, PARAM_LAYERS):
            m.reset_parameters(gen)
