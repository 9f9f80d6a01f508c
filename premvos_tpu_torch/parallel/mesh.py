"""Data parallelism over processes, one card each (port of
premvos_tpu/parallel/mesh.py).

The JAX package scales out along one axis, `data`, of a 1-D device mesh:
parameters are replicated, batches sharded, and a step's gradients and
loss `pmean`-averaged over the axis. DAVIS sequences, training batches and
videos are independent, so nothing else is sharded (no layer exceeds one
chip). Here the mesh is a `torch.distributed` process group, one process
per card: NCCL between cards, gloo between CPU processes.

`Mesh` is what every data-parallel entry point takes as `mesh=`. Its
collectives:
  * with no process group (`make_mesh()` in a plain process) there is one
    rank and every collective is the identity: nothing is called;
  * with a group they run on it, even at one rank (an NCCL group of one
    card runs NCCL);
  * gloo's CUDA support is partial (no all_gather of CUDA tensors), so on
    a gloo group a CUDA tensor goes through the host: copied to the CPU,
    reduced or gathered there, copied back. Two processes sharing one card
    use that route; it is not NVLink and says nothing of scaling.

`spawn` (parallel/dryrun.py) starts local ranks for tests and the dry
run; `torchrun --nproc_per_node N` starts them on N cards.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch
import torch.distributed as dist

from premvos_tpu_torch.pipeline.runner import resolve_device, run_sequence


@dataclasses.dataclass(frozen=True)
class Mesh:
    """One rank's view of a 1-D data mesh: its process group (None: one
    rank, no collectives), its rank and the mesh size, the device its work
    runs on, and the axis name (the JAX package's `"data"`)."""

    group: object
    rank: int
    size: int
    device: torch.device
    axis: str = "data"

    def _via_host(self, t: torch.Tensor) -> bool:
        return t.is_cuda and dist.get_backend(self.group) == dist.Backend.GLOO

    def all_reduce_(self, t: torch.Tensor) -> torch.Tensor:
        """Sum `t` over the mesh, in place; returns `t`."""
        if self.group is None:
            return t
        if self._via_host(t):
            host = t.cpu()
            dist.all_reduce(host, group=self.group)
            return t.copy_(host)
        dist.all_reduce(t, group=self.group)
        return t

    def broadcast_(self, t: torch.Tensor, src: int = 0) -> torch.Tensor:
        """Overwrite `t` on every rank with rank `src`'s, in place."""
        if self.group is None:
            return t
        if self._via_host(t):
            host = t.cpu()
            dist.broadcast(host, src, group=self.group)
            return t.copy_(host)
        dist.broadcast(t, src, group=self.group)
        return t

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's `t` (same shape on each), concatenated along the
        first axis in rank order, on `t`'s device."""
        if self.group is None:
            return t
        src = t.cpu() if self._via_host(t) else t.contiguous()
        parts = [torch.empty_like(src) for _ in range(self.size)]
        dist.all_gather(parts, src, group=self.group)
        return torch.cat(parts).to(t.device)


def _local_rank(rank: int) -> int:
    return int(os.environ.get("LOCAL_RANK", rank))


def make_mesh(n_devices: int | None = None, device=None, backend: str | None = None) -> Mesh:
    """This process's mesh.

    Without an initialised process group: one rank (n_devices None or 1) on
    `resolve_device(device)`, CUDA unless the caller names another device
    (no card and no device: raises). With a group (torchrun, or
    parallel/dryrun.py::spawn): the whole world, on `device` if given, else
    cuda:LOCAL_RANK on NCCL or the CPU on gloo. Raises when n_devices is not
    the world size, when `backend` is not the group's, and when NCCL has
    more local ranks than visible cards; it never changes the backend or
    the device without being asked.
    """
    if not dist.is_initialized():
        if n_devices not in (None, 1):
            raise ValueError(
                f"a {n_devices}-rank mesh needs a process group: start the ranks with "
                "torchrun or premvos_tpu_torch.parallel.dryrun.spawn")
        if backend is not None:
            raise ValueError(f"backend {backend!r} given, but no process group is initialised")
        return Mesh(None, 0, 1, resolve_device(device))
    size, rank = dist.get_world_size(), dist.get_rank()
    have = dist.get_backend()
    if backend is not None and backend != have:
        raise ValueError(f"the process group runs {have}, not {backend}")
    if n_devices is not None and n_devices != size:
        raise ValueError(f"n_devices {n_devices} differs from the world size {size}")
    if device is not None:
        dev = torch.device(device)
        if have == dist.Backend.NCCL and dev.type != "cuda":
            raise ValueError(f"NCCL runs on CUDA devices, not {dev}")
    elif have == dist.Backend.NCCL:
        local = _local_rank(rank)
        if local >= torch.cuda.device_count():
            raise RuntimeError(
                f"NCCL local rank {local} but {torch.cuda.device_count()} visible CUDA cards")
        dev = torch.device("cuda", local)
    else:
        dev = torch.device("cpu")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    return Mesh(dist.group.WORLD, rank, size, dev)


def _map(fn, tree):
    if isinstance(tree, (tuple, list)):
        out = [_map(fn, x) for x in tree]
        return type(tree)(*out) if hasattr(tree, "_fields") else type(tree)(out)
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def shard_batch(tree, mesh: Mesh):
    """This rank's block of every [B, ...] array (tensor or numpy) of
    `tree` (tuples, lists, dicts): rows r·B/n … (r+1)·B/n, the order of the
    JAX package's P("data"). Raises when n does not divide B."""

    def take(x):
        b = x.shape[0]
        if b % mesh.size:
            raise ValueError(f"batch of {b} does not divide over {mesh.size} ranks")
        m = b // mesh.size
        return x[mesh.rank * m:(mesh.rank + 1) * m]

    return _map(take, tree)


def replicate(module: torch.nn.Module, mesh: Mesh) -> torch.nn.Module:
    """Rank 0's parameters and buffers on every rank (in place, in the
    module's order); returns `module`."""
    with torch.no_grad():
        for t in [*module.parameters(), *module.buffers()]:
            mesh.broadcast_(t.data)
    return module


def run_sequences_sharded(models, cfg, frames, gt_masks, num_objects, mesh: Mesh) -> torch.Tensor:
    """Track a batch of sequences over the mesh: frames [B, T, H, W, 3],
    gt_masks [B, K, H, W], num_objects [B] (numpy or tensors); the mesh size
    must divide B. The models are replicated from rank 0, each rank runs
    `run_sequence` on its own B/n sequences one after another (the JAX
    package's `lax.map`), and every rank returns all labels [B, T, H, W]
    int32 on its device (an all_gather)."""
    for m in models:
        replicate(m, mesh)
    frames, gt_masks, num_objects = shard_batch(
        (frames, gt_masks, np.asarray(num_objects)), mesh)
    local = torch.stack([
        run_sequence(models, cfg, f, g, int(n), device=mesh.device)
        for f, g, n in zip(frames, gt_masks, num_objects)
    ])
    return mesh.all_gather(local)


def as_mesh(mesh: Mesh | None, device=None) -> Mesh:
    """The mesh an entry point with `mesh=` and `device=` runs on: `mesh`
    itself (a `device` other than its own raises), else one rank without
    collectives on resolve_device(device), CUDA unless the caller names
    another device. An initialised process group is not consulted: without
    a mesh, an entry point runs on its own device alone."""
    if mesh is None:
        return Mesh(None, 0, 1, resolve_device(device))
    d, own = None if device is None else torch.device(device), mesh.device
    if d is not None and (d.type != own.type
                          or None not in (d.index, own.index) and d.index != own.index):
        raise ValueError(f"device {device} is not the mesh's {mesh.device}")
    return mesh


def init_from_env(device=None) -> Mesh:
    """The mesh of a command line's process. Under an initialised group:
    make_mesh(device=device). In a process a launcher started (torchrun
    sets WORLD_SIZE, RANK, LOCAL_RANK, MASTER_ADDR, MASTER_PORT): the
    default group from those variables, NCCL unless `device` names the CPU
    (then gloo), and its mesh. Otherwise one rank on resolve_device(device):
    the command runs on one device as it does without a launcher."""
    if not dist.is_initialized():
        if "WORLD_SIZE" not in os.environ:
            return as_mesh(None, device)
        cpu = device is not None and torch.device(device).type == "cpu"
        dist.init_process_group("gloo" if cpu else "nccl")
    return make_mesh(device=device)
