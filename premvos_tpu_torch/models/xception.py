"""Modified-aligned Xception-65 encoder (port of
premvos_tpu/models/xception.py), NCHW: the paper's refinement backbone,
chosen by `RefineConfig.backbone = "xception65"`.

Every conv after the stem is separable (depthwise 3×3 + pointwise 1×1,
norm + ReLU after each); the entry flow downsamples to stride 16, the
middle flow is 16 residual units at width 728, and the exit flow widens to
2048, at stride 1 with dilation 2 for output stride 16. Returns {"C2": the
stride-4 features after entry_block1 (128 channels), "C5": the output
stride features (2048 channels)}. Submodules carry the flax tree's names.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from premvos_tpu_torch.models.layers import Conv, add_norm


def same_pads(size: int, k: int, stride: int) -> tuple[int, int]:
    """XLA's "SAME" padding of one axis: the total that keeps ceil(size /
    stride) outputs, its smaller half before. At stride 2 an even size pads
    (0, 1), not (1, 1)."""
    total = max((-(-size // stride) - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


class SepConv(nn.Module):
    """Depthwise 3×3 + pointwise 1×1, norm + ReLU after each (no ReLU at
    the end when relu_last is False)."""

    def __init__(self, in_ch, filters, stride=1, dilation=1, relu_last=True,
                 dtype=torch.float32, norm="frozen_bn"):
        super().__init__()
        self.depthwise = Conv(in_ch, in_ch, 3, stride=stride, padding=dilation,
                              dilation=dilation, bias=False, dtype=dtype, groups=in_ch)
        self.pointwise = Conv(in_ch, filters, 1, bias=False, dtype=dtype)
        self.norms = [add_norm(self, norm, 0, in_ch, dtype),
                      add_norm(self, norm, 1, filters, dtype)]
        self.relu_last = relu_last

    def forward(self, x):
        n0, n1 = (getattr(self, name) for name in self.norms)
        y = F.relu(n0(self.depthwise(x)))
        y = n1(self.pointwise(y))
        return F.relu(y) if self.relu_last else y


class XceptionBlock(nn.Module):
    """Three separable convs (the stride on the last) with a residual:
    skip "conv" (strided 1×1 projection + norm), "sum" (identity) or
    "none"."""

    def __init__(self, in_ch, filters, stride=1, dilation=1, skip="conv",
                 dtype=torch.float32, norm="frozen_bn"):
        super().__init__()
        ch = in_ch
        for i, f in enumerate(filters):
            last = i == len(filters) - 1
            self.add_module(f"sep{i}", SepConv(
                ch, f, stride=stride if last else 1, dilation=dilation,
                relu_last=not (last and skip != "none"), dtype=dtype, norm=norm,
            ))
            ch = f
        self.n_seps = len(filters)
        self.skip = skip
        if skip == "conv":
            self.proj = Conv(in_ch, filters[-1], 1, stride=stride, bias=False, dtype=dtype)
            self.proj_norm = add_norm(self, norm, 0, filters[-1], dtype)

    def forward(self, x):
        y = x
        for i in range(self.n_seps):
            y = getattr(self, f"sep{i}")(y)
        if self.skip == "conv":
            return F.relu(y + getattr(self, self.proj_norm)(self.proj(x)))
        if self.skip == "sum":
            return F.relu(y + x)
        return y


class Xception65(nn.Module):
    """[N, in_ch, H, W] → {"C2": /4 (128 ch), "C5": /output_stride (2048 ch)}."""

    def __init__(self, output_stride=16, in_ch=3, norm="frozen_bn", dtype=torch.float32):
        super().__init__()
        if output_stride not in (16, 32):
            raise ValueError(f"Xception65 output_stride must be 16 or 32, got {output_stride}")
        self.dtype = dtype
        self.stem_conv0 = Conv(in_ch, 32, 3, stride=2, bias=False, dtype=dtype)  # SAME, in forward
        self.stem_conv1 = Conv(32, 64, 3, padding=1, bias=False, dtype=dtype)
        self.stem_norms = [add_norm(self, norm, 0, 32, dtype), add_norm(self, norm, 1, 64, dtype)]
        kw = dict(dtype=dtype, norm=norm)
        self.entry_block1 = XceptionBlock(64, (128, 128, 128), stride=2, **kw)
        self.entry_block2 = XceptionBlock(128, (256, 256, 256), stride=2, **kw)
        self.entry_block3 = XceptionBlock(256, (728, 728, 728), stride=2, **kw)
        for i in range(16):
            self.add_module(f"middle_block{i}",
                            XceptionBlock(728, (728, 728, 728), skip="sum", **kw))
        d = 2 if output_stride == 16 else 1
        self.exit_block = XceptionBlock(728, (728, 1024, 1024), stride=3 - d, dilation=d, **kw)
        ch = 1024
        for i, f in enumerate((1536, 1536, 2048)):
            self.add_module(f"exit_sep{i}", SepConv(ch, f, dilation=d, **kw))
            ch = f

    def forward(self, x):
        n0, n1 = (getattr(self, name) for name in self.stem_norms)
        x = x.to(self.dtype)
        (top, bottom), (left, right) = (same_pads(s, 3, 2) for s in x.shape[-2:])
        x = F.relu(n0(self.stem_conv0(F.pad(x, (left, right, top, bottom)))))
        x = F.relu(n1(self.stem_conv1(x)))
        x = self.entry_block1(x)
        feats = {"C2": x}
        x = self.entry_block3(self.entry_block2(x))
        for i in range(16):
            x = getattr(self, f"middle_block{i}")(x)
        x = self.exit_block(x)
        for i in range(3):
            x = getattr(self, f"exit_sep{i}")(x)
        feats["C5"] = x
        return feats
