"""Training steps (port of premvos_tpu/train/trainer.py).

The JAX package's step is `value_and_grad` + `pmean` over a mesh + an optax
update, jitted. Here the parameters live in the model, the loss closure reads
them, and the step is loss → backward → Adam → zero_grad (`make_train_step`);
`run_steps` is the trainers' loop around it. `make_pool_train_step` is the
host-pool fine-tune's step: its pool is uploaded once and each step
gathers its batch on the device.

Data parallelism (`make_dp_train_step`, parallel/mesh.py): each rank runs
the loss on its shard of the batch and its backward, then ONE all_reduce of
a flat bucket averages the gradients and the loss over the mesh (JAX's
`pmean`), and every rank takes the same Adam step. The reduce is explicit,
after backward(), and not DistributedDataParallel's: DDP hooks only the
gradients that flow through its wrapper's forward, and the port's loss
closures call the module and its submodules directly (maskrcnn_loss_fn
calls `features`, `rpn_outputs`, the heads), so under DDP some gradients
would go unreduced. The bucket is allocated once, when the step is made:
every trainable parameter's `.grad` is a view of its slice (with the
parameter's strides; DDP's `gradient_as_bucket_view`), so backward
accumulates straight into the bucket (an in-place add a parameter, where
a plain backward hands its gradient over), and the step copies no
gradient and allocates no bucket. It holds every trainable parameter of the optimizer in
its order on every rank, so every rank reduces the same list; a parameter
that gets no gradient on a rank keeps its zeros, and Adam steps the same
parameters everywhere (as in the JAX package, where every parameter has a
gradient). Nothing in the step reads back to the host.
"""

from __future__ import annotations

import copy
import logging
from typing import Callable, NamedTuple

import numpy as np
import torch

from premvos_tpu_torch.parallel.mesh import Mesh, replicate, shard_batch
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


def dp_batch_size(batch_size: int, n: int) -> int:
    """The global batch of a data-parallel trainer on n ranks (the JAX
    package's `max(batch_size - batch_size % n, n)`)."""
    return max(batch_size - batch_size % n, n)


def trainable_params(optimizer: torch.optim.Optimizer) -> list:
    return [p for g in optimizer.param_groups for p in g["params"] if p.requires_grad]


def grad_bucket(params: list) -> torch.Tensor:
    """One zeroed float32 buffer with a slot for each parameter of
    `params`, in order, and one more at the end (the loss); each
    parameter's `.grad` becomes a view of its slot with the parameter's
    strides. Returns the buffer."""
    if any(p.dtype != torch.float32 for p in params):
        raise TypeError("the gradient bucket holds float32 parameters only")
    dense = (torch.contiguous_format, torch.channels_last)
    if not all(any(p.is_contiguous(memory_format=f) for f in dense) for p in params):
        raise ValueError("the gradient bucket takes contiguous or channels-last parameters")
    flat = torch.zeros(sum(p.numel() for p in params) + 1, device=params[0].device)
    at = 0
    for p in params:
        p.grad = flat.as_strided(p.shape, p.stride(), at)
        at += p.numel()
    return flat


def make_dp_train_step(loss_fn: Callable, optimizer: torch.optim.Optimizer, mesh: Mesh):
    """step(local_batch) → loss averaged over the mesh (a detached 0-dim
    tensor): loss of this rank's shard (`shard_train_batch`) → backward
    into the gradient bucket (grad_bucket) → one all_reduce of gradients
    and loss → Adam → the bucket zeroed, float32 without TF32. The step
    owns the parameters' `.grad` from here on (they are the bucket's
    views). The optimizer's parameters must be equal on every rank
    (`replicate_state`); the same Adam step then keeps them so. On a mesh
    without a process group (one rank, no collectives) this is
    make_train_step itself."""
    if mesh.group is None:
        return make_train_step(loss_fn, optimizer)
    flat = grad_bucket(trainable_params(optimizer))

    def step(batch):
        with float32_precision():
            loss = loss_fn(batch)
            loss.backward()
            flat[-1] = loss.detach()
            mesh.all_reduce_(flat).div_(mesh.size)
            optimizer.step()
        loss = flat[-1].clone()
        flat.zero_()
        return loss

    return step


def replicate_state(state: TrainState, mesh: Mesh) -> TrainState:
    """Rank 0's model on every rank (parameters and buffers broadcast in
    place); the optimizer's state must still be empty (a fresh Adam)."""
    if any(state.optimizer.state.values()):
        raise ValueError("replicate_state takes a fresh optimizer")
    replicate(state.model, mesh)
    return state


def shard_train_batch(batch, mesh: Mesh):
    """This rank's block of a [B, ...] batch (parallel/mesh.py::shard_batch)."""
    return shard_batch(batch, mesh)


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
                         draws: PoolDraws, mesh: Mesh, batch_transform: Callable | None = None):
    """The train step over a pool held on the device (port of the JAX
    package's `make_pool_train_step`): `pool`, a tuple of [N, ...] arrays,
    is uploaded once to the mesh's device, with `draws.idx`; step(i)
    gathers batch i with `index_select` on the device, applies
    `batch_transform(batch, rows, salt)` where given (rows: the batch's
    pool rows as a host array, salt: step i's salt as a host int), and
    runs make_dp_train_step's loss → backward → (all_reduce) → Adam.
    Returns step; step(i) returns the loss without waiting for the device.

    Every rank holds the same pool and the same draws of the global batch
    and gathers its block of each step's rows (the mesh size must divide
    the batch)."""
    draws = PoolDraws(shard_batch(draws.idx.T, mesh).T.contiguous(), draws.salt)
    pool_d = tuple(torch.as_tensor(np.asarray(x)).to(mesh.device) for x in pool)
    idx_d = draws.idx.to(mesh.device)
    idx_host = draws.idx.numpy()
    salts = draws.salt.tolist()
    train = make_dp_train_step(loss_fn, optimizer, mesh)

    def step(i: int):
        batch = tuple(x.index_select(0, idx_d[i]) for x in pool_d)
        if batch_transform is not None:
            batch = batch_transform(batch, idx_host[i], salts[i])
        return train(batch)

    return step


def run_steps(model: torch.nn.Module, loss_fn: Callable, next_batch: Callable, steps: int,
              mesh: Mesh, learning_rate: float = 1e-4, log_every: int = 100,
              name: str = "train") -> float:
    """The trainers' loop: the model replicated from rank 0, then `steps`
    make_dp_train_step steps of `loss_fn` on `next_batch()` each (this
    rank's shard; the loss is the mesh's mean), the loss logged by rank 0
    every `log_every` steps (0: never). Returns the last loss (NaN without
    steps)."""
    state = replicate_state(create_train_state(model, learning_rate), mesh)
    step = make_dp_train_step(loss_fn, state.optimizer, mesh)
    loss = torch.tensor(float("nan"))
    for it in range(steps):
        loss = step(next_batch())
        if log_every and (it + 1) % log_every == 0 and mesh.rank == 0:
            log.info("%s step %d/%d loss %.4f", name, it + 1, steps, float(loss))
    return float(loss)
