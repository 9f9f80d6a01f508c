"""Training step on one device (port of premvos_tpu/train/trainer.py).

The JAX package's step is `value_and_grad` + `pmean` over a mesh + an optax
update, jitted. Here the parameters live in the model, the loss closure reads
them, and the step is loss → backward → Adam → zero_grad on one device;
`run_steps` is the trainers' loop around it. `make_pool_train_step` is the
host-pool fine-tune's step: its pool is uploaded once and each step
gathers its batch on the device. Data parallelism over several cards (DDP)
is still to port.
"""

from __future__ import annotations

import copy
import logging
from typing import Callable, NamedTuple

import numpy as np
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


def fresh_train_state(model: torch.nn.Module, learning_rate: float) -> TrainState:
    """A copy of `model` to train (the caller's stays as it is) and a fresh
    Adam over it."""
    return create_train_state(copy.deepcopy(model), learning_rate)


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


class PoolDraws(NamedTuple):
    """Every random draw of a pool fine-tune's steps, made on the host:
    `idx` [steps, batch] int64, the pool rows of each step's batch, and
    `salt` [steps] int64 in [0, 2³¹ − 1), each step's salt for per-item
    seeds (the JAX package's `batch_transform` key)."""

    idx: torch.Tensor
    salt: torch.Tensor


def sample_pool_draws(gen: torch.Generator, steps: int, pool_n: int,
                      batch_size: int) -> PoolDraws:
    """`steps` batches of `batch_size` rows of a pool of `pool_n`, and a
    salt a step, from the host generator `gen` (the JAX package draws them
    from PRNGKey(seed) folded with the step)."""
    idx = torch.randint(0, pool_n, (steps, batch_size), generator=gen)
    salt = torch.randint(0, 2**31 - 1, (steps,), generator=gen)
    return PoolDraws(idx, salt)


def make_pool_train_step(loss_fn: Callable, optimizer: torch.optim.Optimizer, pool,
                         draws: PoolDraws, device, batch_transform: Callable | None = None):
    """The train step over a pool held on the device (port of the JAX
    package's `make_pool_train_step`): `pool`, a tuple of [N, ...] arrays,
    is uploaded once, with `draws.idx`; step(i) gathers batch i with
    `index_select` on the device, applies `batch_transform(batch, rows,
    salt)` where given (rows: the batch's pool rows as a host array, salt:
    step i's salt as a host int), and runs make_train_step's loss →
    backward → Adam. Returns step; step(i) returns the loss as
    make_train_step does, without waiting for the device."""
    pool_d = tuple(torch.as_tensor(np.asarray(x)).to(device) for x in pool)
    idx_d = draws.idx.to(device)
    idx_host = draws.idx.numpy()
    salts = draws.salt.tolist()
    train = make_train_step(loss_fn, optimizer)

    def step(i: int):
        batch = tuple(x.index_select(0, idx_d[i]) for x in pool_d)
        if batch_transform is not None:
            batch = batch_transform(batch, idx_host[i], salts[i])
        return train(batch)

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
