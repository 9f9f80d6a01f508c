"""TF checkpoint dict → a port module's state dict (port of
premvos_tpu/io_compat/convert_tf.py).

A "TF checkpoint dict" is `{variable_name: np.ndarray}`: what
`tf.train.load_checkpoint` yields, or an `.npz` / pickle re-export of it.
The per-net name tables live in `convert_tf_maskrcnn.py`,
`convert_tf_refine.py` and `convert_tf_reid.py`. As in the JAX package, a
rule maps a TF name to a flax path and a transform into flax's layout:

  * conv kernels are HWIO, dense kernels [in, out]: no transform;
  * conv-transpose kernels are [H, W, out, in] → flax [H, W, in, out];
  * tensorpack's fc6 flattens NCHW → rows reordered by `fc_nchw_to_nhwc`.

The port's layers carry the flax tree's names (bridge.py), so a flax path
names one layer of the port, and the flax value goes into its state dict
through bridge.py's layout table (HWIO → OIHW, [in, out] → [out, in], a
conv-transpose kernel flipped in space). What comes out is what the JAX
converter's tree gives through `bridge.flax_tensors`.
"""

from __future__ import annotations

import re
from typing import Callable

import numpy as np
import torch

from premvos_tpu_torch.bridge import flax_targets, port_layout

# A rule maps a TF variable name to (flax path, transform) or None.
Rule = Callable[[str], "tuple[tuple[str, ...], str] | None"]

_TRANSFORMS = {
    "none": lambda w: w,
    # TF conv2d_transpose kernel [H, W, out, in] → flax [H, W, in, out].
    "deconv": lambda w: np.transpose(w, (0, 1, 3, 2)),
}

_BN_LEAF = {
    "gamma": "scale",
    "beta": "bias",
    "mean/EMA": "mean",
    "variance/EMA": "var",
}


def fc_nchw_to_nhwc(w: np.ndarray, size: int, channels: int) -> np.ndarray:
    """Reorder a dense kernel's input rows from an NCHW spatial flatten
    (c·size² + y·size + x, tensorpack's fc6) to the NHWC flatten the box
    head uses (y·size·C + x·C + c)."""
    assert w.shape[0] == size * size * channels, (w.shape, size, channels)
    w = w.reshape(channels, size, size, -1)
    return np.transpose(w, (1, 2, 0, 3)).reshape(size * size * channels, -1)


def fc_nhwc_to_nchw(w: np.ndarray, size: int, channels: int) -> np.ndarray:
    """Inverse of `fc_nchw_to_nhwc`."""
    w = w.reshape(size, size, channels, -1)
    return np.transpose(w, (2, 0, 1, 3)).reshape(size * size * channels, -1)


def resnet_rules(flax_prefix: tuple = ("backbone",), tf_prefix: str = "") -> Rule:
    """Tensorpack ResNet names → the ResNet backbone's flax paths:

      conv0/W                             → stem_conv/kernel
      conv0/bn/{gamma,beta,EMAs}          → FrozenBatchNorm_0/…
      group{g}/block{b}/conv{n}/W         → stage{g+2}_block{b}/Conv_{n−1}/kernel
      group{g}/block{b}/conv{n}/bn/…      → …/FrozenBatchNorm_{n−1}/…
      group{g}/block{b}/convshortcut/W    → …/proj/kernel
      group{g}/block{b}/convshortcut/bn/… → …/FrozenBatchNorm_3/…
    """

    def rule(name: str):
        if tf_prefix:
            if not name.startswith(tf_prefix + "/"):
                return None
            name = name[len(tf_prefix) + 1:]
        if name == "conv0/W":
            return (*flax_prefix, "stem_conv", "kernel"), "none"
        m = re.fullmatch(r"conv0/bn/(.+)", name)
        if m and m.group(1) in _BN_LEAF:
            return (*flax_prefix, "FrozenBatchNorm_0", _BN_LEAF[m.group(1)]), "none"
        m = re.fullmatch(r"group(\d)/block(\d+)/(conv\d|convshortcut)(/bn)?/(.+)", name)
        if not m:
            return None
        g, b, conv, is_bn, leaf = m.groups()
        block = f"stage{int(g) + 2}_block{b}"
        if conv == "convshortcut":
            mod = "FrozenBatchNorm_3" if is_bn else "proj"
        else:
            i = int(conv[4:]) - 1
            mod = f"FrozenBatchNorm_{i}" if is_bn else f"Conv_{i}"
        if is_bn:
            if leaf not in _BN_LEAF:
                return None
            return (*flax_prefix, block, mod, _BN_LEAF[leaf]), "none"
        if leaf == "W":
            return (*flax_prefix, block, mod, "kernel"), "none"
        return None

    return rule


def chain(*rules: Rule) -> Rule:
    """The first rule that maps a name."""

    def rule(name: str):
        for r in rules:
            out = r(name)
            if out is not None:
                return out
        return None

    return rule


def table_rule(table: dict) -> Rule:
    """Exact-name table: {tf_name: (flax_path, transform)} or
    {tf_name: flax_path} (transform "none"). A (path, transform) pair is
    told apart by its first element being a tuple, so a two-part path whose
    leaf is named like a transform is never misread."""

    def rule(name: str):
        v = table.get(name)
        if v is None:
            return None
        if isinstance(v, tuple) and len(v) == 2 and isinstance(v[0], tuple) and isinstance(v[1], str):
            return v
        return v, "none"

    return rule


def state_with(module: torch.nn.Module, converted: dict, require: tuple = (), layout=None) -> dict:
    """`module`'s state dict as float32 CPU tensors with `converted` laid
    over it, for `module.load_state_dict`: {flax path: (source name,
    value)}, each value put into the port's layout by `layout(layer, leaf,
    value)` (taken as it is when None). Raises if a path names no parameter
    of the module, if a value does not fit its parameter's shape, and if a
    parameter under a flax path prefix in `require` is not converted (the
    prefix () is the whole module). Every other entry keeps the module's
    own value."""
    targets = flax_targets(module)
    out = {k: v.detach().to("cpu", torch.float32, copy=True) for k, v in module.state_dict().items()}
    for path, (source, w) in converted.items():
        if path not in targets:
            raise ValueError(f"{source} → {'/'.join(path)}: no such param in the module")
        layer, leaf, key = targets[path]
        w = np.asarray(w)
        want = tuple(out[key].shape)
        if layout is not None and w.ndim == len(want):
            w = layout(layer, leaf, w)
        if tuple(w.shape) != want:
            raise ValueError(f"{source} → {'/'.join(path)}: shape {w.shape} does not fit {key} {want}")
        out[key] = torch.from_numpy(np.array(w, dtype=np.float32))
    for prefix in require:
        missing = [p for p in targets if p[:len(prefix)] == prefix and p not in converted]
        if missing:
            raise ValueError(
                f"checkpoint missing {len(missing)} params under {'/'.join(prefix) or 'the module'}, "
                f"e.g. {missing[:5]}"
            )
    return out


def convert_tf_dict(
    tf_vars: dict,
    rule: Rule,
    module: torch.nn.Module,
    require: tuple = (),
    extra_transforms: dict | None = None,
) -> dict:
    """Map a TF checkpoint dict into `module`'s state dict.

    Names the rule does not map are skipped (TF checkpoints carry optimizer
    slots, global_step, ...). A mapped name must land on a parameter of the
    module, with its shape, or this raises. Every parameter under a flax
    path prefix listed in `require` must come from the checkpoint, or this
    raises; every other entry keeps the module's own value. Returns
    {name: float32 CPU tensor} for every entry of `module.state_dict()`,
    for `module.load_state_dict`.
    """
    transforms = dict(_TRANSFORMS)
    if extra_transforms:
        transforms.update(extra_transforms)
    converted = {}
    for name, w in tf_vars.items():
        mapped = rule(name)
        if mapped is None:
            continue
        path, transform = mapped
        fn = transform if callable(transform) else transforms[transform]
        converted[path] = (name, fn(np.asarray(w)))
    return state_with(module, converted, require, port_layout)


def load_tf_checkpoint_vars(path: str) -> dict:
    """`{name: array}` from a TF checkpoint re-export: `.npz` (np.savez of
    name → array) or a pickled dict. A native TF checkpoint needs
    TensorFlow, which the port does not use; it raises."""
    import pickle

    path = str(path)
    if path.endswith(".npz"):
        with np.load(path) as z:
            return {k: z[k] for k in z.files}
    if path.endswith((".pkl", ".pickle")):
        with open(path, "rb") as f:
            return pickle.load(f)
    raise ValueError(
        f"{path}: not an .npz/.pkl re-export, and reading a native TF checkpoint "
        "needs TensorFlow; re-export it as np.savez(name → array) where TF runs"
    )
