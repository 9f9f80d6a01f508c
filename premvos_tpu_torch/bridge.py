"""Flax parameter trees → the port's modules.

The port's submodules carry the flax tree's names, so a layer's parameters
sit at the same path in both (`backbone.stage2_block0.Conv_1` ↔
`params/backbone/stage2_block0/Conv_1`). Layouts:

  Conv            kernel [kh, kw, I, O] → weight [O, I, kh, kw]
  Dense           kernel [I, O]         → weight [O, I]
  ConvTranspose   kernel [kh, kw, I, O] → weight [I, O, kh, kw], flipped in
                  space (inverse of the flownet2 converter's mapping)
  Conv (depthwise) kernel [kh, kw, 1, C] → weight [C, 1, kh, kw] (the Conv
                  rule; the layer has groups = C)
  FrozenBatchNorm scale / bias / mean / var, copied as they are
  GroupNorm32     `gn` scale / bias → weight / bias (flax keeps them in the
                  nn.GroupNorm named gn inside GroupNorm32_i)

Trees are nested dicts of numpy arrays, e.g.
`jax.tree.map(numpy.asarray, params)` of the JAX package's `init_params`.
"""

from __future__ import annotations

import numpy as np
import torch

from premvos_tpu_torch.models.layers import (
    PARAM_LAYERS, Conv, ConvTranspose, Dense, GroupNorm32,
)


def port_name(module, leaf: str) -> str:
    """The port's attribute for one flax leaf of a layer."""
    if leaf == "kernel" or (isinstance(module, GroupNorm32) and leaf == "scale"):
        return "weight"
    return leaf


def port_layout(module, leaf: str, value):
    """One flax leaf's value in the port's layout (the table above)."""
    if leaf != "kernel":
        return value
    if isinstance(module, Conv):
        return np.transpose(value, (3, 2, 0, 1))
    if isinstance(module, Dense):
        return np.transpose(value)
    return np.transpose(value[::-1, ::-1], (2, 3, 0, 1))  # ConvTranspose


def flax_layout(module, leaf: str, value):
    """Inverse of `port_layout`: a port tensor's value in flax's layout."""
    if leaf != "kernel":
        return value
    if isinstance(module, Conv):
        return np.transpose(value, (2, 3, 1, 0))
    if isinstance(module, Dense):
        return np.transpose(value)
    return np.transpose(value, (2, 3, 0, 1))[::-1, ::-1]  # ConvTranspose


def flax_leaves(module) -> tuple[str, ...]:
    """The flax leaves of one layer of the port."""
    if isinstance(module, (Conv, Dense, ConvTranspose)):
        return ("kernel",) if module.bias is None else ("kernel", "bias")
    if isinstance(module, GroupNorm32):
        return ("scale", "bias")
    return ("scale", "bias", "mean", "var")


def flax_targets(module: torch.nn.Module) -> dict:
    """{flax path (without "params"): (layer, flax leaf, state-dict name)}
    for every parameter and buffer of `module`'s layers (a GroupNorm32's
    leaves sit under `gn`, as in flax)."""
    out = {}
    for name, mod in module.named_modules():
        if not isinstance(mod, PARAM_LAYERS):
            continue
        path = tuple(name.split(".")) if name else ()
        if isinstance(mod, GroupNorm32):
            path += ("gn",)
        for leaf in flax_leaves(mod):
            out[(*path, leaf)] = (mod, leaf, f"{name}.{port_name(mod, leaf)}".lstrip("."))
    return out


def _converted(module, leaves: dict) -> dict:
    names = flax_leaves(module)
    if isinstance(module, (Conv, Dense, ConvTranspose)):
        names = ("kernel", "bias") if "bias" in leaves else ("kernel",)
    return {port_name(module, n): port_layout(module, n, leaves[n]) for n in names}


def _layer_paths(node: dict, prefix: str = ""):
    """Paths of the tree's layers: the dicts whose values are arrays."""
    for k, v in node.items():
        path = f"{prefix}.{k}" if prefix else k
        if isinstance(v, dict):
            yield from _layer_paths(v, path)
        else:
            yield prefix
            return


def flax_tensors(module: torch.nn.Module, tree: dict) -> dict:
    """{name: float32 tensor} in `module`'s state-dict names and layouts for
    a flax tree shaped like its parameters: the parameters themselves, or
    anything with their structure, such as their gradients.

    Raises if a layer of the module has no leaves in the tree, if shapes
    differ, or if the tree holds leaves no layer consumed.
    """
    tree = tree.get("params", tree)
    used, out = set(), {}
    for name, mod in module.named_modules():
        if not isinstance(mod, PARAM_LAYERS):
            continue
        path = f"{name}.gn".lstrip(".") if isinstance(mod, GroupNorm32) else name
        node = tree
        for part in path.split("."):
            if part not in node:
                raise KeyError(f"flax tree has no {path!r}")
            node = node[part]
        used.add(path)
        for key, value in _converted(mod, node).items():
            target = getattr(mod, key)
            arr = torch.from_numpy(np.array(value, dtype=np.float32))
            if tuple(arr.shape) != tuple(target.shape):
                raise ValueError(
                    f"{name}.{key}: flax {tuple(arr.shape)} vs port {tuple(target.shape)}"
                )
            out[f"{name}.{key}".lstrip(".")] = arr

    unused = sorted(set(_layer_paths(tree)) - used)
    if unused:
        raise ValueError(f"flax leaves not consumed: {unused}")
    return out


def flax_tree(module: torch.nn.Module) -> dict:
    """Inverse of `flax_tensors`: {"params": nested dicts} of `module`'s
    parameters and buffers in flax's paths and layouts, on the CPU, each in
    its tensor's dtype (numpy arrays; a bfloat16 tensor stays a
    `torch.bfloat16` tensor, as io_compat/orbax_ckpt.py reads one)."""
    out: dict = {}
    for path, (mod, leaf, _) in flax_targets(module).items():
        t = getattr(mod, port_name(mod, leaf)).detach().cpu()
        bf16 = t.dtype == torch.bfloat16
        bits = (t.view(torch.int16) if bf16 else t).numpy()
        value = np.ascontiguousarray(flax_layout(mod, leaf, bits))
        node = out
        for part in path[:-1]:
            node = node.setdefault(part, {})
        node[path[-1]] = torch.from_numpy(value).view(torch.bfloat16) if bf16 else value
    return {"params": out}


def load_flax_tree(module: torch.nn.Module, tree: dict) -> None:
    """Copy one network's flax tree into `module` (in place), with the
    checks of `flax_tensors`."""
    state = {**dict(module.named_parameters()), **dict(module.named_buffers())}
    with torch.no_grad():
        for name, value in flax_tensors(module, tree).items():
            state[name].copy_(value)


def params_from_jax(models, params_np: dict):
    """Load the JAX package's parameter bundle ({"maskrcnn", "refine",
    "flow", "reid"} → flax trees of numpy arrays) into the port's Models."""
    for name in ("maskrcnn", "refine", "flow", "reid"):
        load_flax_tree(getattr(models, name), params_np[name])
    return models
