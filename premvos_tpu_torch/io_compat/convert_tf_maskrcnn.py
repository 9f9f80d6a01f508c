"""TF Mask R-CNN checkpoint → the port's MaskRCNN state dict (port of
premvos_tpu/io_compat/convert_tf_maskrcnn.py).

Tensorpack FasterRCNN names, as the JAX package reads them:

  backbone   conv0, group{0-3}/block{b}/conv{1-3}[,convshortcut] (+/bn)
  FPN        fpn_lateral_1x1_c{2-5}/{W,b}, fpn_posthoc_3x3_p{2-5}/{W,b}
  RPN        rpn/conv0/{W,b}, rpn/class/{W,b}, rpn/box/{W,b}
  box head   fastrcnn/fc6/{W,b}, fastrcnn/fc7/{W,b},
             fastrcnn/class/{W,b}, fastrcnn/box/{W,b}
  mask head  maskrcnn/fcn{0-3}/{W,b}, maskrcnn/deconv/{W,b},
             maskrcnn/conv/{W,b}

fc6 follows tensorpack's NCHW spatial flatten; its rows are reordered to
the box head's (P, P, C) flatten (convert_tf.fc_nchw_to_nhwc).
"""

from __future__ import annotations

import re

from premvos_tpu_torch.io_compat.convert_tf import (
    chain, convert_tf_dict, fc_nchw_to_nhwc, resnet_rules,
)


def _head_rules(roi_align_size: int, fpn_channels: int):
    def rule(name: str):
        m = re.fullmatch(r"fpn_lateral_1x1_c([2-5])/(W|b)", name)
        if m:
            leaf = "kernel" if m.group(2) == "W" else "bias"
            return ("fpn", f"lat_C{m.group(1)}", leaf), "none"
        m = re.fullmatch(r"fpn_posthoc_3x3_p([2-5])/(W|b)", name)
        if m:
            leaf = "kernel" if m.group(2) == "W" else "bias"
            return ("fpn", f"out_P{m.group(1)}", leaf), "none"
        m = re.fullmatch(r"rpn/(conv0|class|box)/(W|b)", name)
        if m:
            idx = {"conv0": 0, "class": 1, "box": 2}[m.group(1)]
            leaf = "kernel" if m.group(2) == "W" else "bias"
            return ("rpn", f"Conv_{idx}", leaf), "none"
        m = re.fullmatch(r"fastrcnn/(fc6|fc7|class|box)/(W|b)", name)
        if m:
            idx = {"fc6": 0, "fc7": 1, "class": 2, "box": 3}[m.group(1)]
            leaf = "kernel" if m.group(2) == "W" else "bias"
            if m.group(1) == "fc6" and leaf == "kernel":
                return ("box_head", "Dense_0", "kernel"), (
                    lambda w: fc_nchw_to_nhwc(w, roi_align_size, fpn_channels)
                )
            return ("box_head", f"Dense_{idx}", leaf), "none"
        m = re.fullmatch(r"maskrcnn/(fcn[0-3]|deconv|conv)/(W|b)", name)
        if m:
            leaf = "kernel" if m.group(2) == "W" else "bias"
            sub = m.group(1)
            if sub.startswith("fcn"):
                return ("mask_head", f"conv{sub[3]}", leaf), "none"
            if sub == "deconv":
                return ("mask_head", "deconv", leaf), "deconv" if leaf == "kernel" else "none"
            return ("mask_head", "logits", leaf), "none"
        return None

    return rule


def convert_tf_maskrcnn(
    tf_vars: dict,
    module,
    roi_align_size: int = 7,
    fpn_channels: int = 256,
    require_heads: bool = True,
) -> dict:
    """A TF Mask R-CNN checkpoint dict → `module`'s (a MaskRCNN) state dict.

    roi_align_size / fpn_channels un-flatten fc6's NCHW rows (pass the
    ProposalConfig's). With require_heads, FPN, RPN and both heads must all
    come from the checkpoint; the backbone always must."""
    rule = chain(resnet_rules(flax_prefix=("backbone",)), _head_rules(roi_align_size, fpn_channels))
    require = [("backbone",)]
    if require_heads:
        require += [("fpn",), ("rpn",), ("box_head",), ("mask_head",)]
    return convert_tf_dict(tf_vars, rule, module, require=tuple(require))
