"""Checkpoints of the four networks (port of premvos_tpu/utils/checkpoint.py).

One `torch.save` file holds the state_dicts of the pipeline's four nets
under "maskrcnn", "refine", "flow" and "reid". `load_params` also reads the
JAX package's own checkpoints: an orbax directory written by its
`save_params` (the four-net bundle its CLIs read with `--checkpoint`),
through io_compat/orbax_ckpt.py, which needs neither JAX nor orbax.
"""

from __future__ import annotations

import torch

from premvos_tpu_torch.io_compat.orbax_ckpt import is_orbax_dir, load_bundle

NETS = ("maskrcnn", "refine", "flow", "reid")


def save_params(path, models) -> None:
    """Write the four nets' state_dicts (on the CPU) to `path`."""
    torch.save(
        {name: {k: v.detach().cpu() for k, v in getattr(models, name).state_dict().items()}
         for name in NETS},
        path,
    )


def load_params(path, models):
    """Load a checkpoint strictly into `models` (build_models' modules),
    each tensor cast to its module tensor's dtype and device: a
    `save_params` file, or an orbax directory of the JAX package's
    (decided by its content: `_METADATA` or `manifest.ocdbt`), whose flax
    trees go through `bridge.params_from_jax`. Either way every net must be
    present and match its module. Returns models."""
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
