"""Training step on one device (port of premvos_tpu/train/trainer.py).

The JAX package's step is `value_and_grad` + `pmean` over a mesh + an optax
update, jitted. Here the parameters live in the model, the loss closure reads
them, and the step is loss → backward → Adam → zero_grad on one device;
`run_steps` is the trainers' loop around it.
Data parallelism over several cards (DDP) and the device-resident pool step
of the per-video fine-tune (`make_pool_train_step`) are still to port.
"""

from __future__ import annotations

import logging
from typing import Callable, NamedTuple

import torch

from premvos_tpu_torch.pipeline.runner import float32_precision

log = logging.getLogger(__name__)


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


def run_steps(model: torch.nn.Module, loss_fn: Callable, next_batch: Callable, steps: int,
              learning_rate: float = 1e-4, log_every: int = 100, name: str = "train") -> float:
    """The trainers' loop: `steps` Adam steps of `loss_fn` on `next_batch()`
    each, the loss logged every `log_every` steps (0: never). Returns the
    last loss (NaN without steps)."""
    state = create_train_state(model, learning_rate)
    step = make_train_step(loss_fn, state.optimizer)
    loss = torch.tensor(float("nan"))
    for it in range(steps):
        loss = step(next_batch())
        if log_every and (it + 1) % log_every == 0:
            log.info("%s step %d/%d loss %.4f", name, it + 1, steps, float(loss))
    return float(loss)
