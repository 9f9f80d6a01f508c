"""The JAX package's orbax checkpoints, read without JAX, orbax or tensorstore.

`premvos_tpu/utils/checkpoint.py::save_params` writes a parameter tree with
orbax's StandardCheckpointer: every JAX trainer's `--out` (one net) and the
four-net bundle that the JAX CLIs read with `--checkpoint`. On disk:

  _METADATA              JSON: "use_ocdbt", "use_zarr3", and "tree_metadata",
                         whose entries give each leaf's path as a list of
                         keys ("key_metadata") and its "value_type"
  manifest.ocdbt, d/,    an OCDBT key-value store (io_compat/ocdbt.py) over
  ocdbt.process_<i>/     the processes' data files; with use_ocdbt=False the
                         same keys are plain files under the directory
  <a.b.c>/.zarray        zarr v2 metadata of the leaf at path (a, b, c):
                         shape, chunks, dtype, order, dimension_separator,
                         compressor (zstd or null), filters (null)
  <a.b.c>/0.0.0          its chunks, one per grid cell ("0" for a scalar)

`read_orbax(path)` returns the tree as nested dicts of numpy arrays, bit
for bit what orbax's restore returns: float32, float16, float64, int32,
int64, uint8 and bool as numpy dtypes; bfloat16 (which numpy lacks) as a
`torch.bfloat16` tensor, or with `bfloat16="float32"` widened to float32
(exact). `iter_arrays(path)` yields the leaves one at a time.
`orbax_state_dict(path, module)` maps one net's tree (a trainer's `--out`)
onto a port module through `bridge.flax_tensors`, in the module's dtypes;
`load_bundle` does so for the four nets of a `--checkpoint` bundle.

Refused, each with its name in an `OrbaxFormatError`: a zarr v3 checkpoint
(use_zarr3), a compressor other than zstd, a zarr filter, a dtype outside
the list above, a leaf that is not an array (a Python scalar or string),
a key that is not a dict key, a chunk that is missing; a tree that does
not match the module raises ValueError listing the missing and extra
paths, as orbax's restore with `like=` refuses.
"""

from __future__ import annotations

import json
import math
from pathlib import Path

import numpy as np
import torch

from premvos_tpu_torch import bridge
from premvos_tpu_torch.io_compat import zstd
from premvos_tpu_torch.io_compat.ocdbt import OcdbtStore

ARRAY_TYPES = ("np.ndarray", "jax.Array")
DICT_KEY = 2  # orbax's KeyType.DICT
DTYPES = {"<f4": np.float32, "<f2": np.float16, "<f8": np.float64, "<i4": np.int32,
          "<i8": np.int64, "|u1": np.uint8, "|b1": np.bool_, "bfloat16": np.uint16}
BF16_MODES = ("torch", "float32")


class OrbaxFormatError(ValueError):
    """A checkpoint feature this reader does not read."""


def is_orbax_dir(path) -> bool:
    """Whether `path` is a directory holding an orbax checkpoint."""
    path = Path(path)
    return path.is_dir() and any((path / f).is_file() for f in ("_METADATA", "manifest.ocdbt"))


class _FileStore:
    """The keys of a checkpoint written with use_ocdbt=False: plain files."""

    def __init__(self, root: Path):
        self.root = root

    def read(self, key: str) -> bytes:
        try:
            return (self.root / key).read_bytes()
        except FileNotFoundError:
            raise KeyError(key) from None


class OrbaxCheckpoint:
    """One orbax checkpoint directory: its leaves' paths, and each leaf's
    array on request."""

    def __init__(self, path):
        self.path = Path(path)
        meta_path = self.path / "_METADATA"
        if not meta_path.is_file():
            raise FileNotFoundError(f"{self.path}: no orbax _METADATA")
        meta = json.loads(meta_path.read_text())
        if meta.get("use_zarr3"):
            raise OrbaxFormatError(
                f"{self.path}: a use_zarr3 checkpoint (zarr v3 arrays); only zarr v2 is read")
        self.leaves = []
        for entry in meta["tree_metadata"].values():
            keys = []
            for k in entry["key_metadata"]:
                if k["key_type"] != DICT_KEY:
                    raise OrbaxFormatError(
                        f"{self.path}: leaf under {keys} has a key of type {k['key_type']}; "
                        "only dict keys are read")
                keys.append(str(k["key"]))
            kind = entry["value_metadata"]["value_type"]
            if kind not in ARRAY_TYPES:
                raise OrbaxFormatError(
                    f"{self.path}: leaf {'.'.join(keys)} is a {kind!r}, not an array")
            self.leaves.append(tuple(keys))
        self.store = OcdbtStore(self.path) if meta.get("use_ocdbt") else _FileStore(self.path)

    def array(self, keys: tuple, bfloat16: str = "torch"):
        """The leaf at `keys`: a numpy array (bfloat16 as `bfloat16` says)."""
        if bfloat16 not in BF16_MODES:
            raise ValueError(f"bfloat16 must be one of {BF16_MODES}, not {bfloat16!r}")
        name = ".".join(keys)
        where = f"{self.path}: array {name}"
        try:
            z = json.loads(self.store.read(f"{name}/.zarray"))
        except KeyError:
            raise OrbaxFormatError(f"{where}: no .zarray") from None
        if z.get("zarr_format") != 2:
            raise OrbaxFormatError(f"{where}: zarr_format {z.get('zarr_format')}, only 2 is read")
        comp = z.get("compressor")
        if comp is not None and comp.get("id") != "zstd":
            raise OrbaxFormatError(f"{where}: compressor {comp.get('id')!r}; only zstd and none are read")
        if z.get("filters"):
            raise OrbaxFormatError(f"{where}: zarr filters {z['filters']} are not read")
        if z["dtype"] not in DTYPES:
            raise OrbaxFormatError(f"{where}: dtype {z['dtype']!r} is not read")
        order = z.get("order", "C")
        if order not in ("C", "F"):
            raise OrbaxFormatError(f"{where}: order {order!r}")
        sep = z.get("dimension_separator", ".")
        if sep not in (".", "/"):
            raise OrbaxFormatError(f"{where}: dimension_separator {sep!r}")
        dtype = np.dtype(DTYPES[z["dtype"]])
        shape, chunks = tuple(z["shape"]), tuple(z["chunks"])
        if len(chunks) != len(shape) or any(c <= 0 for c in chunks):
            raise OrbaxFormatError(f"{where}: chunks {list(chunks)} for shape {list(shape)}")
        out = np.empty(shape, dtype)
        chunk_bytes = math.prod(chunks) * dtype.itemsize
        grid = [-(-s // c) for s, c in zip(shape, chunks)]
        for cell in np.ndindex(*grid):
            key = f"{name}/{sep.join(map(str, cell))}" if shape else f"{name}/0"
            try:
                raw = self.store.read(key)
            except KeyError:
                raise OrbaxFormatError(f"{where}: chunk {key} is missing") from None
            if chunks == shape and order == "C":  # one chunk: decode into the array
                flat = out.reshape(-1).view(np.uint8)
                if comp:
                    n = zstd.decompress_into(raw, flat, key)
                else:
                    n = len(raw)
                    if n == flat.size:
                        flat[:] = np.frombuffer(raw, np.uint8)
            else:
                data = zstd.decompress(raw, size=chunk_bytes, name=key) if comp else raw
                n = len(data)
            if n != chunk_bytes:
                raise OrbaxFormatError(f"{where}: chunk {key} holds {n} bytes, not {chunk_bytes}")
            if chunks != shape or order != "C":
                block = np.frombuffer(data, dtype).reshape(chunks, order=order)
                region = tuple(slice(i * c, min((i + 1) * c, s))
                               for i, c, s in zip(cell, chunks, shape))
                out[region] = block[tuple(slice(0, r.stop - r.start) for r in region)]
        if z["dtype"] != "bfloat16":
            return out
        if bfloat16 == "float32":
            return (out.astype(np.uint32) << 16).view(np.float32)
        return torch.from_numpy(out.view(np.int16)).view(torch.bfloat16)


def iter_arrays(path, bfloat16: str = "torch"):
    """Yield (keys, array) for every leaf of the checkpoint at `path`, one
    array in memory at a time."""
    ck = OrbaxCheckpoint(path)
    for keys in ck.leaves:
        yield keys, ck.array(keys, bfloat16)


def read_orbax(path, bfloat16: str = "torch") -> dict:
    """The checkpoint's tree as nested dicts of arrays."""
    tree: dict = {}
    for keys, value in iter_arrays(path, bfloat16):
        node = tree
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = value
    return tree


def _leaf_paths(node: dict, prefix=()):
    for k, v in node.items():
        if isinstance(v, dict):
            yield from _leaf_paths(v, (*prefix, k))
        else:
            yield (*prefix, k)


def check_tree(module: torch.nn.Module, tree: dict, where: str) -> None:
    """Raise ValueError if the flax tree's leaves are not exactly the
    module's (both lists given, as orbax's restore with like= refuses); a
    collection beside "params" counts as extra."""
    want = set(bridge.flax_targets(module))
    inner = tree.get("params", tree)
    got = set(_leaf_paths(inner))
    beside = [p for p in _leaf_paths(tree) if p[0] != "params"] if inner is not tree else []
    missing = [".".join(p) for p in sorted(want - got)]
    extra = [".".join(p) for p in sorted(got - want) + beside]
    if missing or extra:
        raise ValueError(f"{where}: the checkpoint's tree does not match the module: "
                         f"missing {missing}; extra {extra}")


def orbax_state_dict(path, module: torch.nn.Module) -> dict:
    """One net's checkpoint (a JAX trainer's `--out`, {"params": ...}) as
    tensors in `module`'s state-dict names, layouts and dtypes."""
    tree = read_orbax(path, bfloat16="float32")
    check_tree(module, tree, str(path))
    have = module.state_dict()
    return {k: v.to(have[k].dtype) for k, v in bridge.flax_tensors(module, tree).items()}


def load_bundle(path, models, nets) -> None:
    """Load the four-net bundle at `path` ({net: {"params": ...}}) into
    `models` strictly: every net present, every tree matching its module."""
    tree = read_orbax(path, bfloat16="float32")
    missing = [n for n in nets if n not in tree]
    if missing:
        raise KeyError(f"{path}: no state for {missing}")
    extra = sorted(set(tree) - set(nets))
    if extra:
        raise ValueError(f"{path}: the checkpoint holds trees no net takes: {extra}")
    for net in nets:
        check_tree(getattr(models, net), tree[net], f"{path} [{net}]")
    bridge.params_from_jax(models, tree)
