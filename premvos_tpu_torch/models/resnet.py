"""ResNet backbones (port of premvos_tpu/models/resnet.py), NCHW.

`norm` is "frozen_bn" (pretrained weights, fine-tuning) or "group_norm"
(training from scratch). `output_stride=32` exposes C2..C5 for the FPN;
`output_stride=16` dilates the C5 stage (DeepLabv3+). `remat=True`
recomputes each bottleneck on the backward pass instead of keeping its
activations (`torch.utils.checkpoint`, as the JAX ResNet's `nn.remat`):
it trades compute for device memory and leaves values and gradients as
they are. Submodules carry the
flax tree's names (stem_conv, stage{n}_block{b}, Conv_i, proj, and
FrozenBatchNorm_i or GroupNorm32_i) so that bridge.py is a path map.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from premvos_tpu_torch.models.layers import Conv, add_norm

STAGE_BLOCKS = {
    26: (1, 1, 1, 1),  # minimal bottleneck net for tests
    50: (3, 4, 6, 3),
    101: (3, 4, 23, 3),
    152: (3, 8, 36, 3),
}
STAGE_WIDTHS = (64, 128, 256, 512)


class Bottleneck(nn.Module):
    """ResNet v1.5 bottleneck (stride on the 3×3 conv)."""

    def __init__(self, in_ch, filters, strides=1, dilation=1, dtype=torch.float32,
                 norm="frozen_bn"):
        super().__init__()
        out_ch = filters * 4
        self.Conv_0 = Conv(in_ch, filters, 1, bias=False, dtype=dtype)
        self.Conv_1 = Conv(
            filters, filters, 3, stride=strides, padding=dilation,
            dilation=dilation, bias=False, dtype=dtype,
        )
        self.Conv_2 = Conv(filters, out_ch, 1, bias=False, dtype=dtype)
        self.norms = [add_norm(self, norm, i, c, dtype)
                      for i, c in enumerate((filters, filters, out_ch))]
        self.proj = None
        if in_ch != out_ch or strides != 1:
            self.proj = Conv(in_ch, out_ch, 1, stride=strides, bias=False, dtype=dtype)
            self.norms.append(add_norm(self, norm, 3, out_ch, dtype))

    def forward(self, x):
        n = [getattr(self, name) for name in self.norms]
        y = F.relu(n[0](self.Conv_0(x)))
        y = F.relu(n[1](self.Conv_1(y)))
        y = n[2](self.Conv_2(y))
        residual = x
        if self.proj is not None:
            residual = n[3](self.proj(x))
        return F.relu(y + residual)


class ResNet(nn.Module):
    """[N, in_ch, H, W] → {"C2": /4, "C3": /8, "C4": /16, "C5": /32 or /16}."""

    def __init__(self, depth=101, output_stride=32, in_ch=3, norm="frozen_bn",
                 dtype=torch.float32, remat=False):
        super().__init__()
        self.dtype = dtype
        self.remat = remat
        self.stem_conv = Conv(in_ch, 64, 7, stride=2, padding=3, bias=False, dtype=dtype)
        self.stem_norm = add_norm(self, norm, 0, 64, dtype)
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
                    Bottleneck(ch, width, first_stride if b == 0 else 1, dilation, dtype, norm),
                )
                names.append(name)
                ch = width * 4
            self.stages.append(names)

    def forward(self, x):
        x = x.to(self.dtype)
        x = F.relu(getattr(self, self.stem_norm)(self.stem_conv(x)))
        x = F.max_pool2d(x, 3, stride=2, padding=1)
        feats = {}
        remat = self.remat and torch.is_grad_enabled()
        for stage, names in enumerate(self.stages):
            for name in names:
                block = getattr(self, name)
                x = checkpoint(block, x, use_reentrant=False) if remat else block(x)
            feats[f"C{stage + 2}"] = x
        return feats
