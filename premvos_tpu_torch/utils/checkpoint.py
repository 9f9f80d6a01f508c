"""Checkpoints of the four networks (port of premvos_tpu/utils/checkpoint.py).

One `torch.save` file holds the state_dicts of the pipeline's four nets
under "maskrcnn", "refine", "flow" and "reid". The JAX package's orbax
checkpoints are not read here (the card's machine has no orbax); its
parameters reach the port through `bridge.params_from_jax`.
"""

from __future__ import annotations

import torch

NETS = ("maskrcnn", "refine", "flow", "reid")


def save_params(path, models) -> None:
    """Write the four nets' state_dicts (on the CPU) to `path`."""
    torch.save(
        {name: {k: v.detach().cpu() for k, v in getattr(models, name).state_dict().items()}
         for name in NETS},
        path,
    )


def load_params(path, models):
    """Load a `save_params` file strictly into `models` (build_models'
    modules), each tensor mapped to its module's device. Returns models."""
    state = torch.load(path, map_location="cpu", weights_only=True)
    missing = set(NETS) - set(state)
    if missing:
        raise KeyError(f"{path}: no state for {sorted(missing)}")
    for name in NETS:
        getattr(models, name).load_state_dict(state[name], strict=True)
    return models
