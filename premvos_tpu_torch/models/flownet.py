"""FlowNet2 optical-flow stack: FlowNetC → S → S ∥ SD → Fusion (port of
premvos_tpu/models/flownet.py), NCHW.

Sub-nets predict flow/div_flow at 1/4 resolution (Fusion at full
resolution); `FlowNet2` rescales at every seam as the JAX package does. The
cost volume is ops.correlation (float32), the inter-net warps are
ops.resample2d (exact bilinear), the brightness error ops.channelnorm.
Module names follow the flax tree (conv3_1, predict_flow6, deconv5,
upsampled_flow6_to_5, Conv_0, ConvTranspose_0, …). Input H, W must be
multiples of 64.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from premvos_tpu_torch.models.layers import Conv, ConvTranspose
from premvos_tpu_torch.ops.channelnorm import channelnorm
from premvos_tpu_torch.ops.correlation import correlation, num_displacements
from premvos_tpu_torch.ops.resample2d import resample2d
from premvos_tpu_torch.ops.resize import resize_bilinear


def _leaky(x):
    return F.leaky_relu(x, negative_slope=0.1)


class ConvBlock(nn.Module):
    def __init__(self, in_ch, ch, k=3, s=1, dtype=torch.float32):
        super().__init__()
        self.Conv_0 = Conv(in_ch, ch, k, stride=s, padding=k // 2, dtype=dtype)

    def forward(self, x):
        return _leaky(self.Conv_0(x))


class Deconv(nn.Module):
    """flax ConvTranspose((4, 4), strides 2, "SAME") (+ leaky ReLU)."""

    def __init__(self, in_ch, ch, dtype=torch.float32, act=True):
        super().__init__()
        self.act = act
        self.ConvTranspose_0 = ConvTranspose(in_ch, ch, 4, 2, 1, dtype)

    def forward(self, x):
        y = self.ConvTranspose_0(x)
        return _leaky(y) if self.act else y


class PredictFlow(nn.Module):
    def __init__(self, in_ch, dtype=torch.float32):
        super().__init__()
        self.Conv_0 = Conv(in_ch, 2, 3, padding=1, dtype=dtype)

    def forward(self, x):
        return self.Conv_0(x)


class FlowDecoder(nn.Module):
    """Coarse-to-fine refinement over a feature tower → (finest flow, all
    flows coarse → fine).

    feat_channels: channel counts of the tower, coarse → fine; deconv_ch[i]
    is the upsampling width into level i+1.
    """

    def __init__(self, feat_channels, deconv_ch=(512, 256, 128, 64), dtype=torch.float32):
        super().__init__()
        self.levels = []
        self.add_module("predict_flow6", PredictFlow(feat_channels[0], dtype))
        x_ch = feat_channels[0]
        for i, fc in enumerate(feat_channels[1:]):
            lvl = 5 - i
            self.add_module(f"deconv{lvl}", Deconv(x_ch, deconv_ch[i], dtype))
            self.add_module(
                f"upsampled_flow{lvl + 1}_to_{lvl}", Deconv(2, 2, dtype, act=False)
            )
            x_ch = fc + deconv_ch[i] + 2
            self.add_module(f"predict_flow{lvl}", PredictFlow(x_ch, dtype))
            self.levels.append(lvl)

    def forward(self, feats):
        coarsest, *finer = feats
        flow = self.predict_flow6(coarsest)
        flows = [flow]
        x = coarsest
        for lvl, feat in zip(self.levels, finer):
            up_feat = getattr(self, f"deconv{lvl}")(x)
            up_flow = getattr(self, f"upsampled_flow{lvl + 1}_to_{lvl}")(flow)
            x = torch.cat([feat, up_feat, up_flow], dim=1)
            flow = getattr(self, f"predict_flow{lvl}")(x)
            flows.append(flow)
        return flow, flows


def upsample_flow(flow: torch.Tensor, hw, scale: float = 1.0) -> torch.Tensor:
    """Bilinear resize of a [B, 2, h, w] flow field; scale magnitudes."""
    return resize_bilinear(flow, tuple(hw)) * scale


class _CEncoder(nn.Module):
    """FlowNetC conv1-3, shared by both images (tied weights)."""

    def __init__(self, dtype=torch.float32):
        super().__init__()
        self.conv1 = ConvBlock(3, 64, 7, 2, dtype)
        self.conv2 = ConvBlock(64, 128, 5, 2, dtype)
        self.conv3 = ConvBlock(128, 256, 5, 2, dtype)

    def forward(self, x):
        c1 = self.conv1(x)
        c2 = self.conv2(c1)
        return c1, c2, self.conv3(c2)


_TOWER = (1024, 512, 512, 256, 128)  # C/S/SD decoder inputs, coarse → fine


class FlowNetC(nn.Module):
    """(img1, img2) [B, 3, H, W] → (flow/div_flow at 1/4 resolution, the
    coarse → fine flow list that multi-scale EPE training supervises)."""

    def __init__(self, max_displacement=20, corr_stride=2, dtype=torch.float32):
        super().__init__()
        self.max_displacement, self.corr_stride = max_displacement, corr_stride
        d = num_displacements(max_displacement, corr_stride)
        self.dtype = dtype
        self.encoder = _CEncoder(dtype)
        self.conv_redir = ConvBlock(256, 32, 1, 1, dtype)
        self.conv3_1 = ConvBlock(d * d + 32, 256, 3, 1, dtype)
        self.conv4 = ConvBlock(256, 512, 3, 2, dtype)
        self.conv4_1 = ConvBlock(512, 512, 3, 1, dtype)
        self.conv5 = ConvBlock(512, 512, 3, 2, dtype)
        self.conv5_1 = ConvBlock(512, 512, 3, 1, dtype)
        self.conv6 = ConvBlock(512, 1024, 3, 2, dtype)
        self.conv6_1 = ConvBlock(1024, 1024, 3, 1, dtype)
        self.decoder = FlowDecoder(_TOWER, dtype=dtype)

    def forward(self, img1, img2):
        _, c2a, c3a = self.encoder(img1)
        _, _, c3b = self.encoder(img2)
        # float32 cost volume of the features as they are: a bf16 input is
        # read as its exact float32 value (JAX casts them first).
        corr = correlation(c3a, c3b, self.max_displacement, self.corr_stride)
        corr = _leaky(corr.to(self.dtype))
        redir = self.conv_redir(c3a)
        x3 = self.conv3_1(torch.cat([corr, redir], dim=1))
        x4 = self.conv4_1(self.conv4(x3))
        x5 = self.conv5_1(self.conv5(x4))
        x6 = self.conv6_1(self.conv6(x5))
        return self.decoder((x6, x5, x4, x3, c2a))


class FlowNetS(nn.Module):
    """Plain encoder variant (12 input channels inside FlowNet2)."""

    def __init__(self, in_ch=12, dtype=torch.float32):
        super().__init__()
        self.conv1 = ConvBlock(in_ch, 64, 7, 2, dtype)
        self.conv2 = ConvBlock(64, 128, 5, 2, dtype)
        self.conv3 = ConvBlock(128, 256, 5, 2, dtype)
        self.conv3_1 = ConvBlock(256, 256, 3, 1, dtype)
        self.conv4 = ConvBlock(256, 512, 3, 2, dtype)
        self.conv4_1 = ConvBlock(512, 512, 3, 1, dtype)
        self.conv5 = ConvBlock(512, 512, 3, 2, dtype)
        self.conv5_1 = ConvBlock(512, 512, 3, 1, dtype)
        self.conv6 = ConvBlock(512, 1024, 3, 2, dtype)
        self.conv6_1 = ConvBlock(1024, 1024, 3, 1, dtype)
        self.decoder = FlowDecoder(_TOWER, dtype=dtype)

    def forward(self, x):
        c2 = self.conv2(self.conv1(x))
        c3 = self.conv3_1(self.conv3(c2))
        c4 = self.conv4_1(self.conv4(c3))
        c5 = self.conv5_1(self.conv5(c4))
        c6 = self.conv6_1(self.conv6(c5))
        return self.decoder((c6, c5, c4, c3, c2))[0]


class FlowNetSD(nn.Module):
    """Small-displacement variant: all-3×3 encoder starting at full res."""

    def __init__(self, dtype=torch.float32):
        super().__init__()
        self.conv0 = ConvBlock(6, 64, 3, 1, dtype)
        self.conv1 = ConvBlock(64, 64, 3, 2, dtype)
        self.conv1_1 = ConvBlock(64, 128, 3, 1, dtype)
        self.conv2 = ConvBlock(128, 128, 3, 2, dtype)
        self.conv2_1 = ConvBlock(128, 128, 3, 1, dtype)
        self.conv3 = ConvBlock(128, 256, 3, 2, dtype)
        self.conv3_1 = ConvBlock(256, 256, 3, 1, dtype)
        self.conv4 = ConvBlock(256, 512, 3, 2, dtype)
        self.conv4_1 = ConvBlock(512, 512, 3, 1, dtype)
        self.conv5 = ConvBlock(512, 512, 3, 2, dtype)
        self.conv5_1 = ConvBlock(512, 512, 3, 1, dtype)
        self.conv6 = ConvBlock(512, 1024, 3, 2, dtype)
        self.conv6_1 = ConvBlock(1024, 1024, 3, 1, dtype)
        self.decoder = FlowDecoder(_TOWER, dtype=dtype)

    def forward(self, x):
        c2 = self.conv2_1(self.conv2(self.conv1_1(self.conv1(self.conv0(x)))))
        c3 = self.conv3_1(self.conv3(c2))
        c4 = self.conv4_1(self.conv4(c3))
        c5 = self.conv5_1(self.conv5(c4))
        c6 = self.conv6_1(self.conv6(c5))
        return self.decoder((c6, c5, c4, c3, c2))[0]


class FlowNetFusion(nn.Module):
    """Full-resolution fusion net: 11-channel input → 2-channel flow."""

    def __init__(self, dtype=torch.float32):
        super().__init__()
        self.conv0 = ConvBlock(11, 64, 3, 1, dtype)
        self.conv1 = ConvBlock(64, 64, 3, 2, dtype)
        self.conv1_1 = ConvBlock(64, 128, 3, 1, dtype)
        self.conv2 = ConvBlock(128, 128, 3, 2, dtype)
        self.conv2_1 = ConvBlock(128, 128, 3, 1, dtype)
        self.decoder = FlowDecoder((128, 128, 64), deconv_ch=(32, 16), dtype=dtype)

    def forward(self, x):
        c0 = self.conv0(x)
        c1 = self.conv1_1(self.conv1(c0))
        c2 = self.conv2_1(self.conv2(c1))
        return self.decoder((c2, c1, c0))[0]


class FlowNet2(nn.Module):
    """(img1, img2) [B, 3, H, W] in [0, 1] → flow [B, 2, H, W] in pixels.

    variant: 'flownetc' | 'flownet2cs' | 'flownet2css' | 'flownet2'
    """

    def __init__(self, variant="flownet2", max_displacement=20, corr_stride=2,
                 div_flow=20.0, dtype=torch.float32):
        super().__init__()
        self.variant, self.div_flow, self.dtype = variant, div_flow, dtype
        self.flownetc = FlowNetC(max_displacement, corr_stride, dtype)
        if variant in ("flownet2cs", "flownet2css", "flownet2"):
            self.flownets_1 = FlowNetS(dtype=dtype)
        if variant in ("flownet2css", "flownet2"):
            self.flownets_2 = FlowNetS(dtype=dtype)
        if variant == "flownet2":
            self.flownetsd = FlowNetSD(dtype)
            self.flownetfusion = FlowNetFusion(dtype)

    def _s_refine(self, net, img1, img2, flow_px):
        """One FlowNetS refinement pass."""
        warped = resample2d(img2, flow_px)
        err = channelnorm(img1 - warped)
        x = torch.cat(
            [img1, img2, warped, flow_px / self.div_flow, err], dim=1
        ).to(self.dtype)
        flow = net(x)
        return upsample_flow(
            flow.to(torch.float32), img1.shape[-2:], 4.0 * self.div_flow
        )

    def forward(self, img1, img2):
        hw = img1.shape[-2:]
        # Per-pair mean: the average of the two images' per-channel means.
        mean = (
            img1.mean(dim=(-2, -1), keepdim=True)
            + img2.mean(dim=(-2, -1), keepdim=True)
        ) / 2
        i1 = (img1 - mean).to(self.dtype)
        i2 = (img2 - mean).to(self.dtype)

        flow_c = self.flownetc(i1, i2)[0]
        flow_px = upsample_flow(flow_c.to(torch.float32), hw, 4.0 * self.div_flow)
        if self.variant == "flownetc":
            return flow_px
        flow_px = self._s_refine(self.flownets_1, i1, i2, flow_px)
        if self.variant == "flownet2cs":
            return flow_px
        flow_px = self._s_refine(self.flownets_2, i1, i2, flow_px)
        if self.variant == "flownet2css":
            return flow_px

        flow_sd_q = self.flownetsd(torch.cat([i1, i2], dim=1))
        flow_sd = upsample_flow(flow_sd_q.to(torch.float32), hw, 4.0 * self.div_flow)
        i1f, i2f = i1.to(torch.float32), i2.to(torch.float32)
        warped_css = resample2d(i2f, flow_px)
        warped_sd = resample2d(i2f, flow_sd)
        fuse_in = torch.cat(
            [
                i1f,
                flow_px / self.div_flow,
                flow_sd / self.div_flow,
                channelnorm(flow_px),
                channelnorm(flow_sd),
                channelnorm(i1f - warped_css),
                channelnorm(i1f - warped_sd),
            ],
            dim=1,
        ).to(self.dtype)
        fused = self.flownetfusion(fuse_in)
        return fused.to(torch.float32) * self.div_flow
