"""Data parallelism over processes, one card each: the mesh, batch
sharding, replication, sequence-sharded inference (mesh.py), and local
ranks for tests and the multi-rank dry run (dryrun.py)."""

from premvos_tpu_torch.parallel.mesh import (
    Mesh,
    make_mesh,
    replicate,
    run_sequences_sharded,
    shard_batch,
)

__all__ = ["Mesh", "make_mesh", "replicate", "run_sequences_sharded", "shard_batch"]
