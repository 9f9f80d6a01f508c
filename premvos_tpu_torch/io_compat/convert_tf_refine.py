"""TF refinement-net checkpoint → the port's DeepLabV3Plus state dict (port
of premvos_tpu/io_compat/convert_tf_refine.py).

The names the JAX package reads (a DeepLabv3+ on a ResNet encoder, in the
OnAVOS-family framework):

  encoder      conv0, group{g}/block{b}/… under prefix "resnet"
  ASPP         aspp/conv{0-5}/W, aspp/bn{0-5}/{gamma,beta,EMAs}
  decoder      low_proj/W + low_bn/…, decoder/conv0/W + dec_bn0/…,
               decoder/conv1/W + dec_bn1/…, cls/{W,b}

The three top-level FrozenBatchNorm_{0,1,2} are the low-level projection's
norm and the two decoder convolutions' norms, in that order.
"""

from __future__ import annotations

import re

from premvos_tpu_torch.io_compat.convert_tf import (
    _BN_LEAF, chain, convert_tf_dict, resnet_rules, table_rule,
)


def _decoder_rules():
    def rule(name: str):
        m = re.fullmatch(r"aspp/conv([0-5])/W", name)
        if m:
            return ("aspp", f"Conv_{m.group(1)}", "kernel"), "none"
        m = re.fullmatch(r"aspp/bn([0-5])/(.+)", name)
        if m and m.group(2) in _BN_LEAF:
            return ("aspp", f"FrozenBatchNorm_{m.group(1)}", _BN_LEAF[m.group(2)]), "none"
        m = re.fullmatch(r"(low_bn|dec_bn0|dec_bn1)/(.+)", name)
        if m and m.group(2) in _BN_LEAF:
            idx = {"low_bn": 0, "dec_bn0": 1, "dec_bn1": 2}[m.group(1)]
            return (f"FrozenBatchNorm_{idx}", _BN_LEAF[m.group(2)]), "none"
        return None

    return rule


def convert_tf_refine(tf_vars: dict, module) -> dict:
    """A TF refinement-net checkpoint dict → `module`'s (a DeepLabV3Plus)
    state dict; encoder, ASPP and classifier must come from it."""
    rule = chain(
        resnet_rules(flax_prefix=("encoder",), tf_prefix="resnet"),
        _decoder_rules(),
        table_rule({
            "low_proj/W": ("low_proj", "kernel"),
            "decoder/conv0/W": ("dec0", "kernel"),
            "decoder/conv1/W": ("dec1", "kernel"),
            "cls/W": ("cls", "kernel"),
            "cls/b": ("cls", "bias"),
        }),
    )
    return convert_tf_dict(tf_vars, rule, module, require=(("encoder",), ("aspp",), ("cls",)))
