"""Orbax checkpoints that the JAX package restores, written without JAX,
orbax or tensorstore.

`write_orbax(path, tree)` writes a tree of nested dicts of arrays (numpy
arrays; a `torch.bfloat16` tensor for a bfloat16 leaf, as `read_orbax`
returns one) in the smallest layout that orbax's StandardCheckpointer
restores (`premvos_tpu/utils/checkpoint.py::load_params`, with or without
`like=`):

  _METADATA              JSON as `save_params` writes it: "tree_metadata"
                         keyed by each leaf's path as a tuple's repr, its
                         "key_metadata" (dict keys, key_type 2) and
                         "value_metadata" (value_type "np.ndarray", as
                         save_params writes a tree of host arrays, and
                         write_shape); "use_ocdbt": false, "use_zarr3":
                         false, "store_array_data_equal_to_fill_value",
                         "custom_metadata"
  _CHECKPOINT_METADATA   the handler's name and the timestamps
  <a.b.c>/.zarray        zarr v2: one chunk ("chunks" = "shape"), no
                         compressor, no filters, order C, separator "."
  <a.b.c>/0.0.0          the chunk: the array's bytes in C order ("0" for
                         a scalar)

The value type "np.ndarray" needs no `_sharding` file: orbax restores such
a leaf with any `like=` (numpy arrays, jax arrays, `jax.eval_shape`'s
structs) or none, where a "jax.Array" leaf without `_sharding` fails with
a `like=` that carries no sharding.

The checkpoint is written into a temporary directory beside `path` and
renamed onto it once whole, as orbax finalizes a save; a checkpoint already
at `path` is replaced then, as `save(..., force=True)` replaces it. A write
that fails part way removes its temporary directory and leaves `path` as it
was. A leaf of another dtype than read_orbax reads, or a key that is not a
string, raises ValueError naming the leaf.
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ZARR_DTYPES = {np.dtype(np.float32): "<f4", np.dtype(np.float16): "<f2",
               np.dtype(np.float64): "<f8", np.dtype(np.int32): "<i4",
               np.dtype(np.int64): "<i8", np.dtype(np.uint8): "|u1",
               np.dtype(np.bool_): "|b1"}
HANDLER = "orbax.checkpoint._src.handlers.standard_checkpoint_handler.StandardCheckpointHandler"


def _leaves(node: dict, prefix=()):
    for k, v in node.items():
        if not isinstance(k, str):
            raise ValueError(f"key {k!r} under {list(prefix)} is not a string")
        if isinstance(v, dict):
            yield from _leaves(v, (*prefix, k))
        else:
            yield (*prefix, k), v


def _bytes_and_dtype(value, where: str) -> tuple[np.ndarray, str]:
    """The leaf as a C-order numpy array of its bytes' dtype, and its zarr
    dtype name."""
    if isinstance(value, torch.Tensor):
        value = value.detach().cpu().contiguous()
        if value.dtype == torch.bfloat16:
            return value.view(torch.int16).numpy(), "bfloat16"
        value = value.numpy()
    a = np.ascontiguousarray(np.asarray(value))
    if a.dtype not in ZARR_DTYPES:
        raise ValueError(f"{where}: dtype {a.dtype} is not one read_orbax reads")
    return a, ZARR_DTYPES[a.dtype]


def _write_leaf(root: Path, keys: tuple, value) -> dict:
    name = ".".join(keys)
    a, dtype = _bytes_and_dtype(value, name)
    shape = list(a.shape)
    d = root / name
    d.mkdir()
    zarray = {"chunks": shape, "compressor": None, "dimension_separator": ".", "dtype": dtype,
              "fill_value": None, "filters": None, "order": "C", "shape": shape,
              "zarr_format": 2}
    (d / ".zarray").write_text(json.dumps(zarray))
    (d / (".".join("0" * a.ndim) or "0")).write_bytes(a.tobytes())
    return {"key_metadata": [{"key": k, "key_type": 2} for k in keys],
            "value_metadata": {"value_type": "np.ndarray", "skip_deserialize": False,
                               "write_shape": shape}}


def write_orbax(path, tree: dict) -> None:
    """Write `tree` as an orbax checkpoint directory at `path`."""
    path = Path(path).absolute()
    path.parent.mkdir(parents=True, exist_ok=True)
    start = time.time_ns()
    tmp = Path(tempfile.mkdtemp(prefix=f".{path.name}.orbax-tmp-", dir=path.parent))
    tmp.chmod(0o755)  # mkdtemp's 0700, widened as a directory orbax makes
    old = None
    try:
        meta = {str(keys): _write_leaf(tmp, keys, value) for keys, value in _leaves(tree)}
        (tmp / "_METADATA").write_text(json.dumps({
            "tree_metadata": meta, "use_ocdbt": False, "use_zarr3": False,
            "store_array_data_equal_to_fill_value": True, "custom_metadata": None}))
        (tmp / "_CHECKPOINT_METADATA").write_text(json.dumps({
            "item_handlers": HANDLER, "metrics": {}, "performance_metrics": {},
            "init_timestamp_nsecs": start, "commit_timestamp_nsecs": time.time_ns(),
            "custom_metadata": {}}))
        if path.exists() or path.is_symlink():
            old = Path(tempfile.mkdtemp(prefix=f".{path.name}.orbax-old-", dir=path.parent))
            os.replace(path, old / "ckpt")
        os.replace(tmp, path)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        if old is not None and not (path.exists() or path.is_symlink()):
            os.replace(old / "ckpt", path)
        raise
    finally:
        if old is not None:
            shutil.rmtree(old, ignore_errors=True)
