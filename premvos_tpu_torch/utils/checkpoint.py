"""Checkpoints of the four networks (port of premvos_tpu/utils/checkpoint.py).

`save_params(path, models)` writes the pipeline's four nets: to a path
ending in `.pt`, one `torch.save` file of their state_dicts under
"maskrcnn", "refine", "flow" and "reid"; to any other path, an orbax
directory as the JAX package's `save_params` writes it ({net: {"params":
...}} in flax's paths and layouts, through io_compat/orbax_write.py, which
needs neither JAX nor orbax), so the JAX CLIs' `--checkpoint` and its
`load_params` take it. `save_net` does the same for one net (a trainer's
`--out`: a state_dict, or {"params": ...}). `load_params` reads a
`save_params` file or an orbax directory of either package (decided by its
content: `_METADATA` or `manifest.ocdbt`) through io_compat/orbax_ckpt.py.
"""

from __future__ import annotations

import torch

from premvos_tpu_torch import bridge
from premvos_tpu_torch.io_compat.orbax_ckpt import is_orbax_dir, load_bundle
from premvos_tpu_torch.io_compat.orbax_write import write_orbax

NETS = ("maskrcnn", "refine", "flow", "reid")


def _torch_file(path) -> bool:
    return str(path).endswith(".pt")


def save_params(path, models) -> None:
    """Write the four nets (from the CPU) to `path`: a torch.save file if it
    ends in `.pt`, else an orbax directory the JAX package restores."""
    if _torch_file(path):
        torch.save(
            {name: {k: v.detach().cpu() for k, v in getattr(models, name).state_dict().items()}
             for name in NETS},
            path,
        )
    else:
        write_orbax(path, {name: bridge.flax_tree(getattr(models, name)) for name in NETS})


def save_net(path, module) -> None:
    """Write one net, as a trainer's `--out`: its state_dict to a `.pt`
    path, else an orbax directory of {"params": ...} as the JAX trainers'
    `--out` writes it."""
    if _torch_file(path):
        torch.save(module.state_dict(), path)
    else:
        write_orbax(path, bridge.flax_tree(module))


def load_params(path, models):
    """Load a checkpoint strictly into `models` (build_models' modules),
    each tensor cast to its module tensor's dtype and device: a
    `save_params` file, or an orbax directory (decided by its content:
    `_METADATA` or `manifest.ocdbt`), whose flax trees go through
    `bridge.params_from_jax`. Either way every net must be present and
    match its module. Returns models."""
    if is_orbax_dir(path):
        load_bundle(path, models, NETS)
        return models
    state = torch.load(path, map_location="cpu", weights_only=True)
    missing = set(NETS) - set(state)
    if missing:
        raise KeyError(f"{path}: no state for {sorted(missing)}")
    for name in NETS:
        getattr(models, name).load_state_dict(state[name], strict=True)
    return models
