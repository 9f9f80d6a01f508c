"""DeepLabv3+-style proposal refinement network (port of
premvos_tpu/models/deeplab.py), ResNet encoder only, NCHW."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from premvos_tpu_torch.config import RefineConfig
from premvos_tpu_torch.models.layers import Conv, FrozenBatchNorm
from premvos_tpu_torch.models.resnet import ResNet
from premvos_tpu_torch.ops.resize import resize_bilinear


class ASPP(nn.Module):
    """1×1 + atrous 3×3 branches + image-level pooling → 1×1 projection."""

    def __init__(self, in_ch, channels=256, rates=(6, 12, 18), dtype=torch.float32):
        super().__init__()
        self.n_rates = len(rates)
        convs = [Conv(in_ch, channels, 1, bias=False, dtype=dtype)]
        convs += [
            Conv(in_ch, channels, 3, padding=r, dilation=r, bias=False, dtype=dtype)
            for r in rates
        ]
        convs.append(Conv(in_ch, channels, 1, bias=False, dtype=dtype))  # pooling
        convs.append(
            Conv(channels * (len(rates) + 2), channels, 1, bias=False, dtype=dtype)
        )
        for i, conv in enumerate(convs):
            self.add_module(f"Conv_{i}", conv)
            self.add_module(f"FrozenBatchNorm_{i}", FrozenBatchNorm(channels, dtype))

    def _branch(self, i, x):
        return F.relu(getattr(self, f"FrozenBatchNorm_{i}")(getattr(self, f"Conv_{i}")(x)))

    def forward(self, x):
        branches = [self._branch(i, x) for i in range(self.n_rates + 1)]
        pooled = self._branch(self.n_rates + 1, x.mean(dim=(-2, -1), keepdim=True))
        branches.append(pooled.expand_as(branches[0]))
        return self._branch(self.n_rates + 2, torch.cat(branches, dim=1))


class DeepLabV3Plus(nn.Module):
    def __init__(self, cfg: RefineConfig = RefineConfig(), dtype=torch.float32):
        super().__init__()
        if cfg.backbone != "resnet":
            raise NotImplementedError(f"refine backbone {cfg.backbone!r} is not ported")
        self.encoder = ResNet(
            depth=cfg.backbone_depth, output_stride=cfg.output_stride,
            in_ch=cfg.in_channels, norm=cfg.norm, dtype=dtype,
        )
        self.aspp = ASPP(2048, cfg.aspp_channels, cfg.aspp_rates, dtype)
        self.low_proj = Conv(256, cfg.low_level_channels, 1, bias=False, dtype=dtype)
        self.FrozenBatchNorm_0 = FrozenBatchNorm(cfg.low_level_channels, dtype)
        self.dec0 = Conv(
            cfg.aspp_channels + cfg.low_level_channels, cfg.decoder_channels, 3,
            padding=1, bias=False, dtype=dtype,
        )
        self.FrozenBatchNorm_1 = FrozenBatchNorm(cfg.decoder_channels, dtype)
        self.dec1 = Conv(
            cfg.decoder_channels, cfg.decoder_channels, 3, padding=1, bias=False,
            dtype=dtype,
        )
        self.FrozenBatchNorm_2 = FrozenBatchNorm(cfg.decoder_channels, dtype)
        self.cls = Conv(cfg.decoder_channels, 2, 1, dtype=dtype)

    def forward(self, crops: torch.Tensor) -> torch.Tensor:
        """[N, 4, S, S] crops (RGB + coarse-mask channel) → [N, S, S] logits
        (foreground − background), float32."""
        s = crops.shape[-1]
        feats = self.encoder(crops)
        y = self.aspp(feats["C5"])
        low = F.relu(self.FrozenBatchNorm_0(self.low_proj(feats["C2"])))
        y = resize_bilinear(y, low.shape[-2:])
        y = torch.cat([y, low], dim=1)
        y = F.relu(self.FrozenBatchNorm_1(self.dec0(y)))
        y = F.relu(self.FrozenBatchNorm_2(self.dec1(y)))
        logits = resize_bilinear(self.cls(y).to(torch.float32), (s, s))
        return logits[:, 1] - logits[:, 0]
