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
  <a.b.c>/zarr.json      with use_zarr3: zarr v3 metadata (shape,
                         data_type, a regular chunk grid, the "default"
                         or "v2" chunk key encoding, the codecs)
  <a.b.c>/c/0/0          its chunks ("c" for a scalar; "0.0" under "v2"):
                         bytes (little-endian), then zstd and crc32c, or
                         sharding_indexed (inner chunks through their own
                         codecs; an index of (offset, nbytes) pairs at the
                         end or the start, bytes then crc32c, verified)

`read_orbax(path)` returns the tree as nested dicts of numpy arrays, bit
for bit what orbax's restore returns: float32, float16, float64, int32,
int64, uint8 and bool as numpy dtypes; bfloat16 (which numpy lacks) as a
`torch.bfloat16` tensor, or with `bfloat16="float32"` widened to float32
(exact). `iter_arrays(path)` yields the leaves one at a time.
`orbax_state_dict(path, module)` maps one net's tree (a trainer's `--out`)
onto a port module through `bridge.flax_tensors`, in the module's dtypes;
`load_bundle` does so for the four nets of a `--checkpoint` bundle.

Refused, each with its name in an `OrbaxFormatError`: a compressor other
than zstd, a zarr filter, a zarr v3 codec other than bytes,
sharding_indexed, zstd and crc32c (transpose, gzip, blosc, ...), a
big-endian bytes codec, a CRC-32C mismatch, a dtype outside the list
above, a leaf that is not an array (a Python scalar or string), a key that
is not a dict key, a chunk or inner chunk that is missing (which orbax's
restore refuses too: it reads with fill_missing_data_reads off); a tree
that does not match the module raises ValueError listing the missing and
extra paths, as orbax's restore with `like=` refuses.
"""

from __future__ import annotations

import json
import math
import struct
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
ZARR3_DTYPES = {"float32": np.float32, "float16": np.float16, "float64": np.float64,
                "int32": np.int32, "int64": np.int64, "uint8": np.uint8, "bool": np.bool_,
                "bfloat16": np.uint16}
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
        self.zarr3 = bool(meta.get("use_zarr3"))
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
        if self.zarr3:
            out, is_bf16 = _read_zarr3(self.store, name, where)
        else:
            out, is_bf16 = _read_zarr2(self.store, name, where)
        if not is_bf16:
            return out
        if bfloat16 == "float32":
            return (out.astype(np.uint32) << 16).view(np.float32)
        return torch.from_numpy(out.view(np.int16)).view(torch.bfloat16)


def _read_zarr2(store, name: str, where: str):
    """A zarr v2 array (.zarray and its chunks) → (array, whether bfloat16:
    then its bits as uint16)."""
    try:
        z = json.loads(store.read(f"{name}/.zarray"))
    except KeyError:
        raise OrbaxFormatError(f"{where}: no .zarray") from None
    if z.get("zarr_format") != 2:
        raise OrbaxFormatError(f"{where}: zarr_format {z.get('zarr_format')}, only 2 is read")
    comp = z.get("compressor")
    if comp is not None and comp.get("id") != "zstd":
        raise OrbaxFormatError(f"{where}: compressor {comp.get('id')!r}; "
                               "only zstd and none are read")
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
            raw = store.read(key)
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
            _place(out, cell, chunks, block)
    return out, z["dtype"] == "bfloat16"


def _place(out: np.ndarray, cell: tuple, chunks: tuple, block: np.ndarray) -> None:
    """Chunk `cell` of a regular grid of `chunks` into `out`, its part past
    the array's edge dropped."""
    region = tuple(slice(i * c, min((i + 1) * c, s)) for i, c, s in zip(cell, chunks, out.shape))
    out[region] = block[tuple(slice(0, r.stop - r.start) for r in region)]


def _crc32c_checked(data: bytes, where: str) -> bytes:
    """The bytes before a crc32c codec's 4-byte checksum, the checksum
    verified."""
    if len(data) < 4:
        raise OrbaxFormatError(f"{where}: {len(data)} bytes cannot hold a CRC-32C")
    body, crc = data[:-4], struct.unpack("<I", data[-4:])[0]
    if zstd.crc32c(body) != crc:
        raise OrbaxFormatError(f"{where}: CRC-32C mismatch")
    return body


def _decode_chunk(raw: bytes, codecs: list, shape: tuple, dtype: np.dtype, where: str,
                  key: str) -> np.ndarray:
    """One zarr v3 chunk of `shape` through its codec chain: bytes-to-bytes
    codecs (zstd, crc32c) undone last to first, then the array-to-bytes
    codec (bytes, little-endian; or sharding_indexed, whose inner chunks go
    through their own chain). Any other codec is refused by name."""
    names = [c.get("name") for c in codecs]
    if not codecs or names[0] not in ("bytes", "sharding_indexed"):
        raise OrbaxFormatError(f"{where}: codec {names[0] if codecs else None!r} before the "
                               "array-to-bytes codec is not read (only bytes and "
                               "sharding_indexed, then zstd and crc32c)")
    for codec in reversed(codecs[1:]):
        cname = codec.get("name")
        if cname == "zstd":
            raw = zstd.decompress(raw, size=math.prod(shape) * dtype.itemsize, name=key)
        elif cname == "crc32c":
            raw = _crc32c_checked(raw, f"{where}: chunk {key}")
        else:
            raise OrbaxFormatError(f"{where}: codec {cname!r} is not read "
                                   "(only bytes, sharding_indexed, zstd and crc32c)")
    head, config = codecs[0], codecs[0].get("configuration") or {}
    if head["name"] == "bytes":
        endian = config.get("endian", "little")
        if endian != "little" and dtype.itemsize > 1:
            raise OrbaxFormatError(f"{where}: bytes codec with endian {endian!r}; "
                                   "only little-endian is read")
        n = math.prod(shape) * dtype.itemsize
        if len(raw) != n:
            raise OrbaxFormatError(f"{where}: chunk {key} holds {len(raw)} bytes, not {n}")
        return np.frombuffer(raw, dtype).reshape(shape)
    return _decode_shard(raw, config, shape, dtype, where, key)


def _decode_shard(raw: bytes, config: dict, shape: tuple, dtype: np.dtype, where: str,
                  key: str) -> np.ndarray:
    """A sharding_indexed shard: its index of (offset, nbytes) uint64 pairs,
    one per inner chunk in C order, at the end (or the start). A pair of
    2^64 - 1 marks an inner chunk never written, which zarr reads as
    fill_value and orbax's restore (fill_missing_data_reads false) refuses:
    so does this reader."""
    inner = tuple(config["chunk_shape"])
    if len(inner) != len(shape) or any(c <= 0 or s % c for s, c in zip(shape, inner)):
        raise OrbaxFormatError(f"{where}: inner chunks {list(inner)} for shards {list(shape)}")
    grid = tuple(s // c for s, c in zip(shape, inner))
    n_index = math.prod(grid) * 16
    index_codecs = config.get("index_codecs", [{"name": "bytes"}, {"name": "crc32c"}])
    index_names = [c.get("name") for c in index_codecs]
    if index_names not in (["bytes"], ["bytes", "crc32c"]):
        raise OrbaxFormatError(f"{where}: index codecs {index_names} are not read "
                               "(only bytes, then crc32c)")
    if (index_codecs[0].get("configuration") or {}).get("endian", "little") != "little":
        raise OrbaxFormatError(f"{where}: a big-endian shard index is not read")
    size = n_index + 4 * (len(index_codecs) == 2)
    location = config.get("index_location", "end")
    if location not in ("start", "end") or len(raw) < size:
        raise OrbaxFormatError(f"{where}: shard {key}: index_location {location!r}, "
                               f"{len(raw)} bytes")
    index = raw[:size] if location == "start" else raw[len(raw) - size:]
    if len(index_codecs) == 2:
        index = _crc32c_checked(index, f"{where}: shard {key} index")
    pairs = np.frombuffer(index, "<u8").reshape(-1, 2)
    out = np.empty(shape, dtype)
    empty = np.uint64(2**64 - 1)
    for i, cell in enumerate(np.ndindex(*grid)):
        offset, nbytes = pairs[i]
        region = tuple(slice(j * c, (j + 1) * c) for j, c in zip(cell, inner))
        if offset == empty and nbytes == empty:
            raise OrbaxFormatError(f"{where}: shard {key}: inner chunk {cell} is missing")
        if int(offset) + int(nbytes) > len(raw):
            raise OrbaxFormatError(f"{where}: shard {key}: inner chunk {cell} runs past "
                                   "the shard's end")
        out[region] = _decode_chunk(raw[int(offset):int(offset) + int(nbytes)],
                                    config.get("codecs", [{"name": "bytes"}]), inner, dtype,
                                    where, f"{key}[{','.join(map(str, cell))}]")
    return out


def _read_zarr3(store, name: str, where: str):
    """A zarr v3 array (zarr.json and its chunks or shards) → (array,
    whether bfloat16: then its bits as uint16)."""
    try:
        z = json.loads(store.read(f"{name}/zarr.json"))
    except KeyError:
        raise OrbaxFormatError(f"{where}: no zarr.json") from None
    if z.get("zarr_format") != 3 or z.get("node_type") != "array":
        raise OrbaxFormatError(f"{where}: zarr_format {z.get('zarr_format')} "
                               f"node_type {z.get('node_type')!r}, not a zarr v3 array")
    if z.get("data_type") not in ZARR3_DTYPES:
        raise OrbaxFormatError(f"{where}: data_type {z.get('data_type')!r} is not read")
    is_bf16 = z["data_type"] == "bfloat16"
    dtype = np.dtype(ZARR3_DTYPES[z["data_type"]])
    shape = tuple(z["shape"])
    grid_spec = z.get("chunk_grid", {})
    if grid_spec.get("name") != "regular":
        raise OrbaxFormatError(f"{where}: chunk grid {grid_spec.get('name')!r}; only regular")
    chunks = tuple(grid_spec["configuration"]["chunk_shape"])
    if len(chunks) != len(shape) or any(c <= 0 for c in chunks):
        raise OrbaxFormatError(f"{where}: chunks {list(chunks)} for shape {list(shape)}")
    encoding = z.get("chunk_key_encoding", {"name": "default"})
    kind = encoding.get("name")
    if kind not in ("default", "v2"):
        raise OrbaxFormatError(f"{where}: chunk key encoding {kind!r}; only default and v2")
    sep = (encoding.get("configuration") or {}).get("separator",
                                                    "/" if kind == "default" else ".")
    out = np.empty(shape, dtype)
    grid = [-(-s // c) for s, c in zip(shape, chunks)]
    for cell in np.ndindex(*grid):
        parts = [str(i) for i in cell]
        if kind == "default":
            key = f"{name}/" + sep.join(["c", *parts])
        else:
            key = f"{name}/" + (sep.join(parts) if parts else "0")
        try:
            raw = store.read(key)
        except KeyError:  # never written: orbax's restore refuses it too
            raise OrbaxFormatError(f"{where}: chunk {key} is missing") from None
        _place(out, cell, chunks, _decode_chunk(raw, z.get("codecs", []), chunks, dtype, where,
                                                key))
    return out, is_bf16


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
