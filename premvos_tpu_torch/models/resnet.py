"""ResNet backbones (port of premvos_tpu/models/resnet.py), NCHW.

Frozen BatchNorm only. `output_stride=32` exposes C2..C5 for the FPN;
`output_stride=16` dilates the C5 stage (DeepLabv3+). Submodules carry the
flax tree's names (stem_conv, stage{n}_block{b}, Conv_i, FrozenBatchNorm_i,
proj) so that bridge.py is a path map.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from premvos_tpu_torch.models.layers import Conv, FrozenBatchNorm

STAGE_BLOCKS = {
    26: (1, 1, 1, 1),  # minimal bottleneck net for tests
    50: (3, 4, 6, 3),
    101: (3, 4, 23, 3),
    152: (3, 8, 36, 3),
}
STAGE_WIDTHS = (64, 128, 256, 512)


class Bottleneck(nn.Module):
    """ResNet v1.5 bottleneck (stride on the 3×3 conv)."""

    def __init__(self, in_ch, filters, strides=1, dilation=1, dtype=torch.float32):
        super().__init__()
        out_ch = filters * 4
        self.Conv_0 = Conv(in_ch, filters, 1, bias=False, dtype=dtype)
        self.FrozenBatchNorm_0 = FrozenBatchNorm(filters, dtype)
        self.Conv_1 = Conv(
            filters, filters, 3, stride=strides, padding=dilation,
            dilation=dilation, bias=False, dtype=dtype,
        )
        self.FrozenBatchNorm_1 = FrozenBatchNorm(filters, dtype)
        self.Conv_2 = Conv(filters, out_ch, 1, bias=False, dtype=dtype)
        self.FrozenBatchNorm_2 = FrozenBatchNorm(out_ch, dtype)
        self.proj = None
        if in_ch != out_ch or strides != 1:
            self.proj = Conv(in_ch, out_ch, 1, stride=strides, bias=False, dtype=dtype)
            self.FrozenBatchNorm_3 = FrozenBatchNorm(out_ch, dtype)

    def forward(self, x):
        y = F.relu(self.FrozenBatchNorm_0(self.Conv_0(x)))
        y = F.relu(self.FrozenBatchNorm_1(self.Conv_1(y)))
        y = self.FrozenBatchNorm_2(self.Conv_2(y))
        residual = x
        if self.proj is not None:
            residual = self.FrozenBatchNorm_3(self.proj(x))
        return F.relu(y + residual)


class ResNet(nn.Module):
    """[N, in_ch, H, W] → {"C2": /4, "C3": /8, "C4": /16, "C5": /32 or /16}."""

    def __init__(self, depth=101, output_stride=32, in_ch=3, norm="frozen_bn",
                 dtype=torch.float32):
        super().__init__()
        if norm != "frozen_bn":
            raise NotImplementedError(f"norm {norm!r} is not ported (frozen_bn only)")
        self.dtype = dtype
        self.stem_conv = Conv(in_ch, 64, 7, stride=2, padding=3, bias=False, dtype=dtype)
        self.FrozenBatchNorm_0 = FrozenBatchNorm(64, dtype)
        self.stages = []
        ch = 64
        for stage, (n_blocks, width) in enumerate(zip(STAGE_BLOCKS[depth], STAGE_WIDTHS)):
            first_stride = 1 if stage == 0 else 2
            dilation = 1
            if stage == 3 and output_stride == 16:
                first_stride, dilation = 1, 2
            names = []
            for b in range(n_blocks):
                name = f"stage{stage + 2}_block{b}"
                self.add_module(
                    name,
                    Bottleneck(ch, width, first_stride if b == 0 else 1, dilation, dtype),
                )
                names.append(name)
                ch = width * 4
            self.stages.append(names)

    def forward(self, x):
        x = x.to(self.dtype)
        x = F.relu(self.FrozenBatchNorm_0(self.stem_conv(x)))
        x = F.max_pool2d(x, 3, stride=2, padding=1)
        feats = {}
        for stage, names in enumerate(self.stages):
            for name in names:
                x = getattr(self, name)(x)
            feats[f"C{stage + 2}"] = x
        return feats
