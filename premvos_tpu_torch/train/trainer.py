"""Training step on one device (port of premvos_tpu/train/trainer.py).

The JAX package's step is `value_and_grad` + `pmean` over a mesh + an optax
update, jitted. Here the parameters live in the model, the loss closure reads
them, and the step is loss → backward → Adam → zero_grad on one device.
Data parallelism over several cards (DDP) and the device-resident pool step
of the per-video fine-tune (`make_pool_train_step`) are still to port.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from premvos_tpu_torch.pipeline.runner import float32_precision


class TrainState(NamedTuple):
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer


def create_train_state(model: torch.nn.Module, learning_rate: float = 1e-4) -> TrainState:
    """Adam over the model's parameters: the update of `optax.adam(lr)`
    (b1 0.9, b2 0.999, eps 1e-8 added outside the square root). Frozen-BN
    statistics are buffers here, not parameters; in the JAX package they
    are parameters with zero gradients, which Adam leaves unchanged."""
    optimizer = torch.optim.Adam(
        model.parameters(), lr=learning_rate, betas=(0.9, 0.999), eps=1e-8
    )
    return TrainState(model, optimizer)


def make_train_step(loss_fn: Callable, optimizer: torch.optim.Optimizer):
    """step(batch) → loss (a detached 0-dim tensor on the model's device; the
    step does not wait for the device). Float32 work runs without TF32."""

    def step(batch):
        with float32_precision():
            loss = loss_fn(batch)
            loss.backward()
            optimizer.step()
            optimizer.zero_grad(set_to_none=True)
        return loss.detach()

    return step
