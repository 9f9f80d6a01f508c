"""Checkpoints in each source format, written from a port module's own
parameters by inverting the converters' name tables.

No published checkpoint is in the repository, so the converters are held
to these: converting one back into a fresh module must give the source
module's parameters bit for bit, and the JAX package's converters must read
the same files into the same values. Used by tests/test_torch_convert.py
and chip_smoke.py; not part of the package's API.
"""

from __future__ import annotations

import re

import numpy as np
import torch

from premvos_tpu_torch.bridge import flax_layout, flax_targets
from premvos_tpu_torch.io_compat.convert_tf import fc_nhwc_to_nchw
from premvos_tpu_torch.models.layers import Conv, ConvTranspose, Dense, FrozenBatchNorm

_BN_INV = {"scale": "gamma", "bias": "beta", "mean": "mean/EMA", "var": "variance/EMA"}
_TV_BN = {"scale": "weight", "bias": "bias", "mean": "running_mean", "var": "running_var"}
# What a TF checkpoint also holds, which the converters must skip.
_TF_EXTRAS = {"global_step": np.zeros((), np.int64), "learning_rate": np.ones((), np.float32)}


def perturb(module: torch.nn.Module, gen: torch.Generator) -> torch.nn.Module:
    """Give `module`'s frozen batch norms and biases distinct values drawn
    from `gen` (a fresh init leaves them at 1 and 0, where a converter that
    swapped two of them would go unseen): scale and var in [0.95, 1.05),
    bias and mean in [-0.05, 0.05), layer biases N(0, 0.01²). Small, so the
    nets still track at random weights. In place; returns it."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, FrozenBatchNorm):
                for name in ("scale", "bias", "mean", "var"):
                    t = getattr(m, name)
                    draw = 0.1 * (torch.rand(t.shape, generator=gen, device=gen.device) - 0.5)
                    t.copy_(draw + 1.0 if name in ("scale", "var") else draw)
            elif isinstance(m, (Conv, ConvTranspose, Dense)) and m.bias is not None:
                m.bias.copy_(0.01 * torch.randn(m.bias.shape, generator=gen, device=gen.device))
    return module


def flax_params(module: torch.nn.Module) -> dict:
    """{flax path: float32 array in flax's layout} of `module`'s layers."""
    state = module.state_dict()
    return {
        path: np.ascontiguousarray(
            flax_layout(layer, leaf, state[name].detach().cpu().float().numpy()))
        for path, (layer, leaf, name) in flax_targets(module).items()
    }


def tf_resnet_name(path: tuple) -> str:
    """Inverse of convert_tf.resnet_rules for a path below the backbone."""
    if path == ("stem_conv", "kernel"):
        return "conv0/W"
    if path[0] == "FrozenBatchNorm_0":
        return f"conv0/bn/{_BN_INV[path[1]]}"
    g, b = re.fullmatch(r"stage(\d)_block(\d+)", path[0]).groups()
    g = int(g) - 2
    mod, leaf = path[1], path[2]
    if mod == "proj":
        return f"group{g}/block{b}/convshortcut/W"
    if mod == "FrozenBatchNorm_3":
        return f"group{g}/block{b}/convshortcut/bn/{_BN_INV[leaf]}"
    if mod.startswith("Conv_"):
        return f"group{g}/block{b}/conv{int(mod[5:]) + 1}/W"
    return f"group{g}/block{b}/conv{int(mod[16:]) + 1}/bn/{_BN_INV[leaf]}"


def _wb(leaf: str) -> str:
    return "W" if leaf == "kernel" else "b"


def tf_maskrcnn_vars(module, roi_align_size: int, fpn_channels: int) -> dict:
    """A tensorpack Mask R-CNN checkpoint dict of a MaskRCNN's parameters
    (fc6's rows in NCHW order, the deconvolution kernel [H, W, out, in])."""
    out = dict(_TF_EXTRAS)
    heads = {"Conv_0": "conv0", "Conv_1": "class", "Conv_2": "box"}
    box = {"Dense_0": "fc6", "Dense_1": "fc7", "Dense_2": "class", "Dense_3": "box"}
    mask = {"conv0": "fcn0", "conv1": "fcn1", "conv2": "fcn2", "conv3": "fcn3",
            "deconv": "deconv", "logits": "conv"}
    for p, w in flax_params(module).items():
        if p[0] == "backbone":
            out[tf_resnet_name(p[1:])] = w
        elif p[0] == "fpn":
            kind = "lateral_1x1_c" if p[1].startswith("lat") else "posthoc_3x3_p"
            out[f"fpn_{kind}{p[1][-1]}/{_wb(p[2])}"] = w
        elif p[0] == "rpn":
            out[f"rpn/{heads[p[1]]}/{_wb(p[2])}"] = w
        elif p[0] == "box_head":
            if p[1] == "Dense_0" and p[2] == "kernel":
                w = fc_nhwc_to_nchw(w, roi_align_size, fpn_channels)
            out[f"fastrcnn/{box[p[1]]}/{_wb(p[2])}"] = w
        elif p[0] == "mask_head":
            if p[1] == "deconv" and p[2] == "kernel":
                w = np.ascontiguousarray(np.transpose(w, (0, 1, 3, 2)))
            out[f"maskrcnn/{mask[p[1]]}/{_wb(p[2])}"] = w
        else:
            raise ValueError(f"no TF name for {p}")
    return out


def tf_refine_vars(module) -> dict:
    """A TF refinement-net checkpoint dict of a DeepLabV3Plus's parameters
    (ResNet encoder)."""
    out = dict(_TF_EXTRAS)
    dec_bn = {"FrozenBatchNorm_0": "low_bn", "FrozenBatchNorm_1": "dec_bn0",
              "FrozenBatchNorm_2": "dec_bn1"}
    convs = {"low_proj": "low_proj", "dec0": "decoder/conv0", "dec1": "decoder/conv1"}
    for p, w in flax_params(module).items():
        if p[0] == "encoder":
            out["resnet/" + tf_resnet_name(p[1:])] = w
        elif p[0] == "aspp" and p[1].startswith("Conv_"):
            out[f"aspp/conv{p[1][5:]}/W"] = w
        elif p[0] == "aspp":
            out[f"aspp/bn{p[1][16:]}/{_BN_INV[p[2]]}"] = w
        elif p[0] in dec_bn:
            out[f"{dec_bn[p[0]]}/{_BN_INV[p[1]]}"] = w
        elif p[0] in convs:
            out[f"{convs[p[0]]}/W"] = w
        elif p[0] == "cls":
            out[f"cls/{_wb(p[1])}"] = w
        else:
            raise ValueError(f"no TF name for {p}")
    return out


def tf_reid_vars(module) -> dict:
    """A TF ReID checkpoint dict of a ReIDNet's parameters."""
    out = {"Adam/beta1_power": np.zeros((), np.float32)}
    for p, w in flax_params(module).items():
        if p[0] == "backbone":
            out["resnet/" + tf_resnet_name(p[1:])] = w
        elif p[0] in ("fc1", "emb"):
            out[f"{p[0]}/{_wb(p[1])}"] = w
        else:
            raise ValueError(f"no TF name for {p}")
    return out


def torchvision_resnet_state_dict(module, prefix: tuple = ()) -> dict:
    """A torchvision-named ResNet state dict of the backbone under `prefix`
    (OIHW weights, BN as weight / bias / running stats, a num_batches_tracked
    the converter skips)."""
    state = module.state_dict()
    out = {"bn1.num_batches_tracked": torch.zeros((), dtype=torch.int64)}
    for path, (_, leaf, name) in flax_targets(module).items():
        if path[:len(prefix)] != prefix:
            continue
        p = path[len(prefix):]
        w = state[name].detach().cpu().float().clone()
        if p[0] == "stem_conv":
            out["conv1.weight"] = w
            continue
        if p[0] == "FrozenBatchNorm_0":
            out[f"bn1.{_TV_BN[leaf]}"] = w
            continue
        s, b = re.fullmatch(r"stage(\d)_block(\d+)", p[0]).groups()
        block = f"layer{int(s) - 1}.{b}"
        if p[1] == "proj":
            out[f"{block}.downsample.0.weight"] = w
        elif p[1] == "FrozenBatchNorm_3":
            out[f"{block}.downsample.1.{_TV_BN[leaf]}"] = w
        elif p[1].startswith("Conv_"):
            out[f"{block}.conv{int(p[1][5:]) + 1}.weight"] = w
        else:
            out[f"{block}.bn{int(p[1][16:]) + 1}.{_TV_BN[leaf]}"] = w
    return out


def flownet2_state_dict(module) -> dict:
    """A flownet2-pytorch state dict of a FlowNet2's parameters (layers in
    nn.Sequential wrappers where flownet2-pytorch has them)."""
    state = module.state_dict()
    out = {}
    for path, (_, leaf, name) in flax_targets(module).items():
        net, suffix = path[0], "weight" if leaf == "kernel" else "bias"
        if path[1] == "decoder":
            layer = path[2]
            wrapped = layer.startswith("deconv")
        else:
            layer = path[2] if path[1] == "encoder" else path[1]
            wrapped = True
        key = f"{net}.{layer}.0.{suffix}" if wrapped else f"{net}.{layer}.{suffix}"
        out[key] = state[name].detach().cpu().float().clone()
    return out
