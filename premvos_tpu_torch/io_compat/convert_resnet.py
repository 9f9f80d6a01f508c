"""torchvision ResNet state dict → a port backbone's parameters (port of
premvos_tpu/io_compat/convert_resnet.py).

torchvision's ResNet v1.5 names, mapped to the backbone's flax paths as in
the JAX package:

  conv1            → stem_conv/kernel
  bn1              → FrozenBatchNorm_0/{scale,bias,mean,var}
  layerL.i.convN   → stage{L+1}_block{i}/Conv_{N−1}/kernel
  layerL.i.bnN     → stage{L+1}_block{i}/FrozenBatchNorm_{N−1}/…
  layerL.i.downsample.0 / .1 → …/proj/kernel, …/FrozenBatchNorm_3/…

A torch Conv2d weight is OIHW, which is already the port's layout: the JAX
converter's OIHW → HWIO and bridge.py's HWIO → OIHW cancel, so weights are
copied as they are. `prefix` targets a nested backbone: ("backbone",) in a
MaskRCNN or ReIDNet, ("encoder",) in a DeepLabV3Plus.
"""

from __future__ import annotations

import re

from premvos_tpu_torch.io_compat.convert_tf import state_with

_BN_LEAF = {
    "weight": "scale",
    "bias": "bias",
    "running_mean": "mean",
    "running_var": "var",
}


def _map_key(key: str) -> list[str] | None:
    parts = key.split(".")
    if parts[0] == "conv1" and parts[-1] == "weight":
        return ["stem_conv", "kernel"]
    if parts[0] == "bn1" and parts[-1] in _BN_LEAF:
        return ["FrozenBatchNorm_0", _BN_LEAF[parts[-1]]]
    m = re.fullmatch(r"layer(\d)", parts[0])
    if not m:
        return None
    block = f"stage{int(m.group(1)) + 1}_block{parts[1]}"
    sub, leaf = parts[2], parts[-1]
    cm = re.fullmatch(r"conv(\d)", sub)
    bm = re.fullmatch(r"bn(\d)", sub)
    if cm and leaf == "weight":
        return [block, f"Conv_{int(cm.group(1)) - 1}", "kernel"]
    if bm and leaf in _BN_LEAF:
        return [block, f"FrozenBatchNorm_{int(bm.group(1)) - 1}", _BN_LEAF[leaf]]
    if sub == "downsample":
        if parts[3] == "0" and leaf == "weight":
            return [block, "proj", "kernel"]
        if parts[3] == "1" and leaf in _BN_LEAF:
            return [block, "FrozenBatchNorm_3", _BN_LEAF[leaf]]
    return None


def convert_resnet_state_dict(state_dict: dict, module, prefix: tuple = ()) -> dict:
    """`module`'s state dict with every parameter under `prefix` taken from
    a torchvision ResNet state dict; the rest keeps the module's values
    (heads stay as drawn). Raises on a key that maps to no parameter, on a
    shape mismatch, and if any parameter under `prefix` is missing."""
    converted = {}
    for key, w in state_dict.items():
        mapped = _map_key(key)
        if mapped is not None:
            converted[(*prefix, *mapped)] = (key, w)
    return state_with(module, converted, (prefix,))
