"""Flax parameter trees → the port's modules.

The port's submodules carry the flax tree's names, so a layer's parameters
sit at the same path in both (`backbone.stage2_block0.Conv_1` ↔
`params/backbone/stage2_block0/Conv_1`). Layouts:

  Conv            kernel [kh, kw, I, O] → weight [O, I, kh, kw]
  Dense           kernel [I, O]         → weight [O, I]
  ConvTranspose   kernel [kh, kw, I, O] → weight [I, O, kh, kw], flipped in
                  space (inverse of the flownet2 converter's mapping)
  FrozenBatchNorm scale / bias / mean / var, copied as they are

Trees are nested dicts of numpy arrays, e.g.
`jax.tree.map(numpy.asarray, params)` of the JAX package's `init_params`.
"""

from __future__ import annotations

import numpy as np
import torch

from premvos_tpu_torch.models.layers import PARAM_LAYERS, Conv, ConvTranspose, Dense


def _converted(module, leaves: dict) -> dict:
    if isinstance(module, Conv):
        out = {"weight": np.transpose(leaves["kernel"], (3, 2, 0, 1))}
    elif isinstance(module, Dense):
        out = {"weight": np.transpose(leaves["kernel"])}
    elif isinstance(module, ConvTranspose):
        out = {"weight": np.transpose(leaves["kernel"][::-1, ::-1], (2, 3, 0, 1))}
    else:  # FrozenBatchNorm
        return {k: leaves[k] for k in ("scale", "bias", "mean", "var")}
    if "bias" in leaves:
        out["bias"] = leaves["bias"]
    return out


def _layer_paths(node: dict, prefix: str = ""):
    """Paths of the tree's layers: the dicts whose values are arrays."""
    for k, v in node.items():
        path = f"{prefix}.{k}" if prefix else k
        if isinstance(v, dict):
            yield from _layer_paths(v, path)
        else:
            yield prefix
            return


def load_flax_tree(module: torch.nn.Module, tree: dict) -> None:
    """Copy one network's flax tree into `module` (in place).

    Raises if a layer of the module has no leaves in the tree, if shapes
    differ, or if the tree holds leaves no layer consumed.
    """
    tree = tree.get("params", tree)
    used = set()
    for name, mod in module.named_modules():
        if not isinstance(mod, PARAM_LAYERS):
            continue
        node = tree
        for part in name.split("."):
            if part not in node:
                raise KeyError(f"flax tree has no {name!r}")
            node = node[part]
        used.add(name)
        for key, value in _converted(mod, node).items():
            target = getattr(mod, key)
            arr = torch.from_numpy(np.array(value, dtype=np.float32))
            if tuple(arr.shape) != tuple(target.shape):
                raise ValueError(
                    f"{name}.{key}: flax {tuple(arr.shape)} vs port {tuple(target.shape)}"
                )
            with torch.no_grad():
                target.copy_(arr)

    unused = sorted(set(_layer_paths(tree)) - used)
    if unused:
        raise ValueError(f"flax leaves not consumed: {unused}")


def params_from_jax(models, params_np: dict):
    """Load the JAX package's parameter bundle ({"maskrcnn", "refine",
    "flow", "reid"} → flax trees of numpy arrays) into the port's Models."""
    for name in ("maskrcnn", "refine", "flow", "reid"):
        load_flax_tree(getattr(models, name), params_np[name])
    return models
