"""The four networks of the reference pipeline in plain PyTorch: Mask R-CNN
(ResNet + FPN + RPN + box and mask heads), DeepLabv3+ (ResNet encoder, ASPP,
decoder), FlowNet2 and its variants, and the ReID net.

Module and parameter names, shapes and layouts are the measured program's
(PyTorch layouts: Conv [O, I/groups, k, k], ConvTranspose [I, O, k, k],
Dense [out, in]), so one state dict loads into either side. Each layer keeps
float32 parameters and computes in its `dtype`: a torch dtype, or "fp8" (the
control: operands rounded by `ops.fp8_operand`, sums in float32, outputs in
bfloat16). `PARAM_RULES` says how the benchmark draws each parameter.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from portbench.reference import ops


def _act(dtype):
    return ops.compute_dtype(dtype)


class Conv(nn.Module):
    def __init__(self, in_ch, out_ch, k, stride=1, padding=0, dilation=1, bias=True,
                 dtype=torch.float32, groups=1):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_ch, in_ch // groups, k, k))
        self.bias = nn.Parameter(torch.zeros(out_ch)) if bias else None
        self.stride, self.padding, self.dilation, self.groups = stride, padding, dilation, groups
        self.dtype = dtype

    def forward(self, x):
        dt = _act(self.dtype)
        b = None if self.bias is None else self.bias.to(dt)
        return F.conv2d(ops.operand(x, self.dtype), ops.operand(self.weight, self.dtype), b,
                        self.stride, self.padding, self.dilation, self.groups)


class ConvTranspose(nn.Module):
    """flax ConvTranspose(k, strides=s, "SAME") at k ∈ {2, 4}, s = 2: torch's
    transposed convolution with padding (k − s) / 2."""

    def __init__(self, in_ch, out_ch, k, stride, padding, dtype=torch.float32):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(in_ch, out_ch, k, k))
        self.bias = nn.Parameter(torch.zeros(out_ch))
        self.stride, self.padding, self.dtype = stride, padding, dtype

    def forward(self, x):
        return F.conv_transpose2d(ops.operand(x, self.dtype), ops.operand(self.weight, self.dtype),
                                  self.bias.to(_act(self.dtype)), self.stride, self.padding)


class Dense(nn.Module):
    def __init__(self, in_features, out_features, dtype=torch.float32):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        self.bias = nn.Parameter(torch.zeros(out_features))
        self.dtype = dtype

    def forward(self, x):
        return F.linear(ops.operand(x, self.dtype), ops.operand(self.weight, self.dtype),
                        self.bias.to(_act(self.dtype)))


class FrozenBatchNorm(nn.Module):
    """x · scale / sqrt(var + 1e-5) + (bias − mean · scale / sqrt(var + 1e-5)),
    the two factors in float32 and applied in the compute dtype."""

    def __init__(self, c, dtype=torch.float32):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("mean", torch.zeros(c))
        self.register_buffer("var", torch.ones(c))
        self.dtype = dtype

    def forward(self, x):
        dt = _act(self.dtype)
        inv = self.scale / torch.sqrt(self.var + 1e-5)
        b = self.bias - self.mean * self.scale / torch.sqrt(self.var + 1e-5)
        return x * inv.to(dt)[:, None, None] + b.to(dt)[:, None, None]


# How the benchmark draws each parameter (portbench/weights.py): flax's
# truncated LeCun normal over the fan-in for kernels, and biases and frozen
# batch-norm statistics drawn away from 0 and 1.
PARAM_RULES = {Conv: "kernel", ConvTranspose: "kernel_transposed", Dense: "kernel",
               FrozenBatchNorm: "frozen_bn"}


def _norm(module, index, c, norm, dtype):
    if norm != "frozen_bn":
        raise ValueError(f"the reference holds frozen batch norm only, not {norm!r}")
    name = f"FrozenBatchNorm_{index}"
    module.add_module(name, FrozenBatchNorm(c, dtype))
    return name


# ------------------------------------------------------------------ ResNet

STAGE_BLOCKS = {26: (1, 1, 1, 1), 50: (3, 4, 6, 3), 101: (3, 4, 23, 3), 152: (3, 8, 36, 3)}
STAGE_WIDTHS = (64, 128, 256, 512)


class Bottleneck(nn.Module):
    def __init__(self, in_ch, filters, strides=1, dilation=1, dtype=torch.float32,
                 norm="frozen_bn"):
        super().__init__()
        out_ch = filters * 4
        self.Conv_0 = Conv(in_ch, filters, 1, bias=False, dtype=dtype)
        self.Conv_1 = Conv(filters, filters, 3, stride=strides, padding=dilation,
                           dilation=dilation, bias=False, dtype=dtype)
        self.Conv_2 = Conv(filters, out_ch, 1, bias=False, dtype=dtype)
        self.norms = [_norm(self, i, c, norm, dtype)
                      for i, c in enumerate((filters, filters, out_ch))]
        self.proj = None
        if in_ch != out_ch or strides != 1:
            self.proj = Conv(in_ch, out_ch, 1, stride=strides, bias=False, dtype=dtype)
            self.norms.append(_norm(self, 3, out_ch, norm, dtype))

    def forward(self, x):
        n = [getattr(self, name) for name in self.norms]
        y = F.relu(n[0](self.Conv_0(x)))
        y = F.relu(n[1](self.Conv_1(y)))
        y = n[2](self.Conv_2(y))
        residual = n[3](self.proj(x)) if self.proj is not None else x
        return F.relu(y + residual)


class ResNet(nn.Module):
    """[N, in_ch, H, W] → {"C2".."C5"}; output stride 16 dilates the C5 stage."""

    def __init__(self, depth=101, output_stride=32, in_ch=3, norm="frozen_bn",
                 dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.stem_conv = Conv(in_ch, 64, 7, stride=2, padding=3, bias=False, dtype=dtype)
        self.stem_norm = _norm(self, 0, 64, norm, dtype)
        self.stages = []
        ch = 64
        for stage, (n_blocks, width) in enumerate(zip(STAGE_BLOCKS[depth], STAGE_WIDTHS)):
            first_stride, dilation = (1 if stage == 0 else 2), 1
            if stage == 3 and output_stride == 16:
                first_stride, dilation = 1, 2
            names = []
            for b in range(n_blocks):
                name = f"stage{stage + 2}_block{b}"
                self.add_module(name, Bottleneck(ch, width, first_stride if b == 0 else 1,
                                                 dilation, dtype, norm))
                names.append(name)
                ch = width * 4
            self.stages.append(names)

    def forward(self, x):
        x = x.to(_act(self.dtype))
        x = F.relu(getattr(self, self.stem_norm)(self.stem_conv(x)))
        x = F.max_pool2d(x, 3, stride=2, padding=1)
        feats = {}
        for stage, names in enumerate(self.stages):
            for name in names:
                x = getattr(self, name)(x)
            feats[f"C{stage + 2}"] = x
        return feats


# --------------------------------------------------------------- Mask R-CNN

FPN_STRIDES = {"P2": 4, "P3": 8, "P4": 16, "P5": 32, "P6": 64}
_FPN_IN = {"C2": 256, "C3": 512, "C4": 1024, "C5": 2048}


def pyramid_anchors(image_h, image_w, scales, ratios, device):
    """{level: [h·w·A, 4]} xyxy anchors in [H, W, A] order."""
    out = {}
    r = torch.tensor(ratios, dtype=torch.float64)
    for (lvl, stride), scale in zip(FPN_STRIDES.items(), scales):
        fh, fw = -(-image_h // stride), -(-image_w // stride)
        cy = ((torch.arange(fh, dtype=torch.float64) + 0.5) * stride)[:, None, None]
        cx = ((torch.arange(fw, dtype=torch.float64) + 0.5) * stride)[None, :, None]
        ws = (scale / torch.sqrt(r))[None, None, :]
        hs = (scale * torch.sqrt(r))[None, None, :]
        shape = (fh, fw, len(ratios))
        boxes = torch.stack([(cx - ws / 2).expand(shape), (cy - hs / 2).expand(shape),
                             (cx + ws / 2).expand(shape), (cy + hs / 2).expand(shape)], dim=-1)
        out[lvl] = boxes.reshape(-1, 4).to(torch.float32).to(device)
    return out


class FPN(nn.Module):
    def __init__(self, channels=256, dtype=torch.float32):
        super().__init__()
        for n, c in _FPN_IN.items():
            self.add_module(f"lat_{n}", Conv(c, channels, 1, dtype=dtype))
            self.add_module(f"out_P{n[1]}", Conv(channels, channels, 3, padding=1, dtype=dtype))

    def forward(self, feats):
        names = list(_FPN_IN)
        laterals = [getattr(self, f"lat_{n}")(feats[n]) for n in names]
        tops = [laterals[-1]]
        for lat in laterals[-2::-1]:
            tops.append(lat + F.interpolate(tops[-1], scale_factor=2, mode="nearest"))
        out = {f"P{n[1]}": getattr(self, f"out_P{n[1]}")(t) for n, t in zip(names, tops[::-1])}
        out["P6"] = out["P5"][..., ::2, ::2]
        return out


class RPNHead(nn.Module):
    def __init__(self, num_anchors=3, channels=256, dtype=torch.float32):
        super().__init__()
        self.num_anchors = num_anchors
        self.Conv_0 = Conv(channels, channels, 3, padding=1, dtype=dtype)
        self.Conv_1 = Conv(channels, num_anchors, 1, dtype=dtype)
        self.Conv_2 = Conv(channels, num_anchors * 4, 1, dtype=dtype)

    def forward(self, feat):
        x = F.relu(self.Conv_0(feat))
        b, _, h, w = feat.shape
        logits = self.Conv_1(x).permute(0, 2, 3, 1).reshape(b, h * w * self.num_anchors)
        deltas = self.Conv_2(x).permute(0, 2, 3, 1).reshape(b, h * w * self.num_anchors, 4)
        return logits, deltas


class BoxHead(nn.Module):
    def __init__(self, in_features, num_classes=2, hidden=1024, dtype=torch.float32):
        super().__init__()
        self.Dense_0 = Dense(in_features, hidden, dtype)
        self.Dense_1 = Dense(hidden, hidden, dtype)
        self.Dense_2 = Dense(hidden, num_classes, dtype)
        self.Dense_3 = Dense(hidden, 4, dtype)

    def forward(self, x):
        x = F.relu(self.Dense_1(F.relu(self.Dense_0(x))))
        return self.Dense_2(x), self.Dense_3(x)


class MaskHead(nn.Module):
    def __init__(self, in_ch, channels=256, dtype=torch.float32):
        super().__init__()
        for i in range(4):
            self.add_module(f"conv{i}", Conv(in_ch if i == 0 else channels, channels, 3,
                                             padding=1, dtype=dtype))
        self.deconv = ConvTranspose(channels, channels, 2, 2, 0, dtype)
        self.logits = Conv(channels, 1, 1, dtype=dtype)

    def forward(self, x):
        for i in range(4):
            x = F.relu(getattr(self, f"conv{i}")(x))
        return self.logits(F.relu(self.deconv(x)))[:, 0]


def _take(x, idx):
    shape = (*idx.shape, *x.shape[2:])
    return torch.gather(x, 1, idx.reshape(*idx.shape, *([1] * (x.dim() - 2))).expand(shape))


def generate_proposals(logits, deltas, anchors, image_hw, pre_nms_topk, post_nms_topk,
                       nms_threshold):
    """Per level the top-k logits (ties to the lower index), decoded and
    clipped; one NMS over all levels of an image on sigmoid scores."""
    h, w = image_hw
    all_boxes, all_scores = [], []
    for lvl, lg in logits.items():
        k = min(pre_nms_topk, lg.shape[-1])
        vals, idx = torch.sort(lg, dim=-1, descending=True, stable=True)
        vals, idx = vals[..., :k], idx[..., :k]
        d = torch.gather(deltas[lvl], 1, idx[..., None].expand(*idx.shape, 4))
        all_boxes.append(ops.clip_boxes(ops.decode_boxes(d, anchors[lvl][idx]), float(h), float(w)))
        all_scores.append(vals)
    boxes = torch.cat(all_boxes, dim=1)
    scores = torch.cat(all_scores, dim=1)
    idx, keep = ops.nms(boxes, torch.sigmoid(scores.to(torch.float32)), post_nms_topk,
                        nms_threshold, 0.0, valid=scores > ops.NEG_INF / 2)
    safe = torch.clamp(idx, min=0).to(torch.int64)
    picked = torch.gather(boxes, 1, safe[..., None].expand(*safe.shape, 4))
    out_scores = torch.where(keep, torch.sigmoid(torch.gather(scores, 1, safe).to(torch.float32)),
                             torch.zeros(keep.shape, device=keep.device))
    return torch.where(keep[..., None], picked, torch.zeros_like(picked)), out_scores, keep


class MaskRCNN(nn.Module):
    """Category-agnostic Mask R-CNN: images [B, 3, H, W] normalised, anchors
    {level: [Ni, 4]} → boxes [B, D, 4], scores [B, D], valid [B, D],
    mask_logits [B, D, 2P, 2P]."""

    def __init__(self, cfg, dtype=torch.float32):
        super().__init__()
        self.cfg = cfg
        c = cfg.fpn_channels
        self.backbone = ResNet(depth=cfg.backbone_depth, norm=cfg.norm, dtype=dtype)
        self.fpn = FPN(channels=c, dtype=dtype)
        self.rpn = RPNHead(num_anchors=len(cfg.anchor_ratios), channels=c, dtype=dtype)
        self.box_head = BoxHead(cfg.roi_align_size ** 2 * c, num_classes=cfg.num_classes,
                                dtype=dtype)
        self.mask_head = MaskHead(c, dtype=dtype)

    def masks(self, feats, det_boxes):
        b, d = det_boxes.shape[:2]
        mf = ops.multilevel_roi_align(feats, det_boxes, self.cfg.mask_roi_align_size)
        p = mf.shape[2]
        logits = self.mask_head(mf.reshape(b * d, p, p, -1).permute(0, 3, 1, 2))
        return logits.reshape(b, d, *logits.shape[-2:])

    def forward(self, images, anchors):
        cfg = self.cfg
        h, w = images.shape[-2:]
        feats = self.fpn(self.backbone(images))
        logits, deltas = {}, {}
        for lvl, f in feats.items():
            logits[lvl], deltas[lvl] = self.rpn(f)
        rois, roi_valid = self.proposals(logits, deltas, anchors, (h, w))
        b, n = rois.shape[:2]
        roi_feats = ops.multilevel_roi_align(feats, rois, cfg.roi_align_size)
        cls, box_deltas = self.box_head(roi_feats.reshape(b * n, -1))
        det_boxes, det_scores, keep = self.detections(rois, roi_valid, cls, box_deltas, (h, w))
        return {"boxes": det_boxes, "scores": det_scores, "valid": keep,
                "mask_logits": self.masks(feats, det_boxes)}

    def proposals(self, logits, deltas, anchors, image_hw):
        """The RPN's outputs {level: [B, Ni]}, {level: [B, Ni, 4]} → rois
        [B, K, 4] and their valid flags [B, K]."""
        cfg = self.cfg
        rois, _, roi_valid = generate_proposals(logits, deltas, anchors, image_hw,
                                                cfg.rpn_pre_nms_topk, cfg.rpn_post_nms_topk,
                                                cfg.rpn_nms_threshold)
        return rois, roi_valid

    def detections(self, rois, roi_valid, cls, box_deltas, image_hw):
        """The box head's outputs on `rois` [B, K, 4] → detections: boxes
        [B, D, 4], scores [B, D], valid [B, D] (decode, clip, NMS and the
        score threshold)."""
        cfg = self.cfg
        h, w = image_hw
        b, n = rois.shape[:2]
        scores = torch.softmax(cls.to(torch.float32), dim=-1)[:, 1].reshape(b, n)
        scores = scores * roi_valid.to(torch.float32)
        boxes = ops.clip_boxes(ops.decode_boxes(box_deltas.to(torch.float32).reshape(b, n, 4),
                                                rois), float(h), float(w))
        idx, keep = ops.nms(boxes, scores, cfg.detections_per_frame,
                            cfg.detection_nms_threshold, cfg.detection_score_threshold,
                            valid=roi_valid)
        safe = torch.clamp(idx, min=0).to(torch.int64)
        det_boxes = torch.where(keep[..., None], _take(boxes, safe), 0.0)
        det_scores = torch.where(keep, _take(scores, safe), 0.0)
        return det_boxes, det_scores, keep


# ---------------------------------------------------------------- DeepLabv3+

class ASPP(nn.Module):
    def __init__(self, in_ch, channels=256, rates=(6, 12, 18), dtype=torch.float32,
                 norm="frozen_bn"):
        super().__init__()
        self.n_rates = len(rates)
        convs = [Conv(in_ch, channels, 1, bias=False, dtype=dtype)]
        convs += [Conv(in_ch, channels, 3, padding=r, dilation=r, bias=False, dtype=dtype)
                  for r in rates]
        convs.append(Conv(in_ch, channels, 1, bias=False, dtype=dtype))
        convs.append(Conv(channels * (len(rates) + 2), channels, 1, bias=False, dtype=dtype))
        self.norms = []
        for i, conv in enumerate(convs):
            self.add_module(f"Conv_{i}", conv)
            self.norms.append(_norm(self, i, channels, norm, dtype))

    def _branch(self, i, x):
        return F.relu(getattr(self, self.norms[i])(getattr(self, f"Conv_{i}")(x)))

    def forward(self, x):
        branches = [self._branch(i, x) for i in range(self.n_rates + 1)]
        pooled = self._branch(self.n_rates + 1, x.mean(dim=(-2, -1), keepdim=True))
        branches.append(pooled.expand_as(branches[0]))
        return self._branch(self.n_rates + 2, torch.cat(branches, dim=1))


class DeepLabV3Plus(nn.Module):
    """[N, 4, S, S] crops (RGB and the coarse mask) → [N, S, S] float32
    logits, foreground − background."""

    def __init__(self, cfg, dtype=torch.float32):
        super().__init__()
        if cfg.backbone != "resnet":
            raise ValueError(f"the reference holds the ResNet encoder only, not {cfg.backbone!r}")
        self.encoder = ResNet(depth=cfg.backbone_depth, output_stride=cfg.output_stride,
                              in_ch=cfg.in_channels, norm=cfg.norm, dtype=dtype)
        self.aspp = ASPP(2048, cfg.aspp_channels, cfg.aspp_rates, dtype, cfg.norm)
        self.low_proj = Conv(256, cfg.low_level_channels, 1, bias=False, dtype=dtype)
        self.dec0 = Conv(cfg.aspp_channels + cfg.low_level_channels, cfg.decoder_channels, 3,
                         padding=1, bias=False, dtype=dtype)
        self.dec1 = Conv(cfg.decoder_channels, cfg.decoder_channels, 3, padding=1, bias=False,
                         dtype=dtype)
        self.cls = Conv(cfg.decoder_channels, 2, 1, dtype=dtype)
        self.norms = [_norm(self, i, c, cfg.norm, dtype) for i, c in enumerate(
            (cfg.low_level_channels, cfg.decoder_channels, cfg.decoder_channels))]

    def head(self, crops):
        """The classifier's two logits [N, 2, S / 4, S / 4] (background,
        foreground), in the compute dtype."""
        feats = self.encoder(crops)
        y = self.aspp(feats["C5"])
        n0, n1, n2 = (getattr(self, name) for name in self.norms)
        low = F.relu(n0(self.low_proj(feats["C2"])))
        y = torch.cat([ops.resize_bilinear(y, low.shape[-2:]), low], dim=1)
        y = F.relu(n2(self.dec1(F.relu(n1(self.dec0(y))))))
        return self.cls(y)

    def forward(self, crops):
        return logit_difference(self.head(crops), crops.shape[-1])


def logit_difference(cls, size):
    """The classifier's logits resized to the crop in float32, foreground −
    background: [N, S, S]."""
    logits = ops.resize_bilinear(cls.to(torch.float32), (size, size))
    return logits[:, 1] - logits[:, 0]


# ------------------------------------------------------------------ FlowNet2

def _leaky(x):
    return F.leaky_relu(x, negative_slope=0.1)


class ConvBlock(nn.Module):
    def __init__(self, in_ch, ch, k=3, s=1, dtype=torch.float32):
        super().__init__()
        self.Conv_0 = Conv(in_ch, ch, k, stride=s, padding=k // 2, dtype=dtype)

    def forward(self, x):
        return _leaky(self.Conv_0(x))


class Deconv(nn.Module):
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
    def __init__(self, feat_channels, deconv_ch=(512, 256, 128, 64), dtype=torch.float32):
        super().__init__()
        self.levels = []
        self.add_module("predict_flow6", PredictFlow(feat_channels[0], dtype))
        x_ch = feat_channels[0]
        for i, fc in enumerate(feat_channels[1:]):
            lvl = 5 - i
            self.add_module(f"deconv{lvl}", Deconv(x_ch, deconv_ch[i], dtype))
            self.add_module(f"upsampled_flow{lvl + 1}_to_{lvl}", Deconv(2, 2, dtype, act=False))
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


def upsample_flow(flow, hw, scale=1.0):
    return ops.resize_bilinear(flow, tuple(hw)) * scale


class _CEncoder(nn.Module):
    def __init__(self, dtype=torch.float32):
        super().__init__()
        self.conv1 = ConvBlock(3, 64, 7, 2, dtype)
        self.conv2 = ConvBlock(64, 128, 5, 2, dtype)
        self.conv3 = ConvBlock(128, 256, 5, 2, dtype)

    def forward(self, x):
        c1 = self.conv1(x)
        c2 = self.conv2(c1)
        return c1, c2, self.conv3(c2)


_TOWER = (1024, 512, 512, 256, 128)


class FlowNetC(nn.Module):
    def __init__(self, max_displacement=20, corr_stride=2, dtype=torch.float32):
        super().__init__()
        self.max_displacement, self.corr_stride, self.dtype = max_displacement, corr_stride, dtype
        d = ops.num_displacements(max_displacement, corr_stride)
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
        corr = ops.correlation(c3a, c3b, self.max_displacement, self.corr_stride,
                               "fp8" if self.dtype == "fp8" else torch.float32)
        corr = _leaky(corr.to(_act(self.dtype)))
        x3 = self.conv3_1(torch.cat([corr, self.conv_redir(c3a)], dim=1))
        x4 = self.conv4_1(self.conv4(x3))
        x5 = self.conv5_1(self.conv5(x4))
        x6 = self.conv6_1(self.conv6(x5))
        return self.decoder((x6, x5, x4, x3, c2a))


class FlowNetS(nn.Module):
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
    """(img1, img2) [B, 3, H, W] in [0, 1] → flow [B, 2, H, W] in pixels, at
    variant "flownetc", "flownet2cs", "flownet2css" or "flownet2"."""

    def __init__(self, variant="flownet2", max_displacement=20, corr_stride=2, div_flow=20.0,
                 dtype=torch.float32, warp_impl="block"):
        super().__init__()
        self.variant, self.div_flow, self.dtype, self.warp_impl = variant, div_flow, dtype, warp_impl
        self.flownetc = FlowNetC(max_displacement, corr_stride, dtype)
        if variant in ("flownet2cs", "flownet2css", "flownet2"):
            self.flownets_1 = FlowNetS(dtype=dtype)
        if variant in ("flownet2css", "flownet2"):
            self.flownets_2 = FlowNetS(dtype=dtype)
        if variant == "flownet2":
            self.flownetsd = FlowNetSD(dtype)
            self.flownetfusion = FlowNetFusion(dtype)

    def _s_refine(self, net, img1, img2, flow_px):
        warped = ops.warp(img2, flow_px, self.warp_impl)
        err = ops.channelnorm(img1 - warped)
        x = torch.cat([img1, img2, warped, flow_px / self.div_flow, err], dim=1)
        flow = net(x.to(_act(self.dtype)))
        return upsample_flow(flow.to(torch.float32), img1.shape[-2:], 4.0 * self.div_flow)

    def forward(self, img1, img2):
        dt = _act(self.dtype)
        hw = img1.shape[-2:]
        mean = (img1.mean(dim=(-2, -1), keepdim=True) + img2.mean(dim=(-2, -1), keepdim=True)) / 2
        i1, i2 = (img1 - mean).to(dt), (img2 - mean).to(dt)
        flow_px = upsample_flow(self.flownetc(i1, i2)[0].to(torch.float32), hw, 4.0 * self.div_flow)
        if self.variant == "flownetc":
            return flow_px
        flow_px = self._s_refine(self.flownets_1, i1, i2, flow_px)
        if self.variant == "flownet2cs":
            return flow_px
        flow_px = self._s_refine(self.flownets_2, i1, i2, flow_px)
        if self.variant == "flownet2css":
            return flow_px
        flow_sd = upsample_flow(self.flownetsd(torch.cat([i1, i2], dim=1)).to(torch.float32),
                                hw, 4.0 * self.div_flow)
        i1f, i2f = i1.to(torch.float32), i2.to(torch.float32)
        warped_css = ops.warp(i2f, flow_px, self.warp_impl)
        warped_sd = ops.warp(i2f, flow_sd, self.warp_impl)
        fuse_in = torch.cat([
            i1f, flow_px / self.div_flow, flow_sd / self.div_flow, ops.channelnorm(flow_px),
            ops.channelnorm(flow_sd), ops.channelnorm(i1f - warped_css),
            ops.channelnorm(i1f - warped_sd)], dim=1).to(dt)
        return self.flownetfusion(fuse_in).to(torch.float32) * self.div_flow


# ---------------------------------------------------------------------- ReID

class ReIDNet(nn.Module):
    """[N, 3, S, S] crops → [N, E] float32 embeddings on the unit sphere."""

    def __init__(self, cfg, dtype=torch.float32):
        super().__init__()
        self.l2_normalize = cfg.l2_normalize
        self.backbone = ResNet(depth=cfg.backbone_depth, norm=cfg.norm, dtype=dtype)
        self.fc1 = Dense(2048, 1024, dtype)
        self.emb = Dense(1024, cfg.embedding_dim, dtype)

    def forward(self, crops):
        x = self.backbone(crops)["C5"].mean(dim=(-2, -1))
        emb = self.emb(F.relu(self.fc1(x))).to(torch.float32)
        if self.l2_normalize:
            emb = emb / torch.clamp(torch.linalg.vector_norm(emb, dim=-1, keepdim=True), min=1e-6)
        return emb
