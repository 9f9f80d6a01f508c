"""TF ReID-net checkpoint → the port's ReIDNet state dict (port of
premvos_tpu/io_compat/convert_tf_reid.py).

The names the JAX package reads: a ResNet under prefix "resnet", the
bottleneck fc1/{W,b} and the embedding emb/{W,b}.
"""

from __future__ import annotations

from premvos_tpu_torch.io_compat.convert_tf import (
    chain, convert_tf_dict, resnet_rules, table_rule,
)


def convert_tf_reid(tf_vars: dict, module) -> dict:
    """A TF ReID checkpoint dict → `module`'s (a ReIDNet) state dict; every
    parameter must come from it."""
    rule = chain(
        resnet_rules(flax_prefix=("backbone",), tf_prefix="resnet"),
        table_rule({
            "fc1/W": ("fc1", "kernel"),
            "fc1/b": ("fc1", "bias"),
            "emb/W": ("emb", "kernel"),
            "emb/b": ("emb", "bias"),
        }),
    )
    return convert_tf_dict(tf_vars, rule, module, require=(("backbone",), ("fc1",), ("emb",)))
