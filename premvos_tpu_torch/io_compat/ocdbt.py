"""A read-only OCDBT key-value store over a directory, without tensorstore.

Orbax writes a checkpoint's arrays into tensorstore's OCDBT format (an
"optionally-cooperative distributed B+tree"): a manifest names the latest
version of a B+tree whose leaves hold each key's value, inline or as a
(data file, offset, length) reference. `OcdbtStore(path)` reads the latest
version as tensorstore reads it; `list()` gives the keys and `read(key)`
a value's bytes.

The format, as tensorstore writes it (every integer a LEB128 varint unless
said otherwise; arrays are stored column by column):

  manifest.ocdbt   magic 0x0cdb3a2a (u32 big-endian), the file's length
                   (u64), version 0, compression (0 none, 1 zstd), then the
                   (compressed) body and a CRC-32C footer (u32) of all
                   that precedes it. Body: the config (uuid[16],
                   manifest_kind, max_inline_value_bytes,
                   max_decoded_node_bytes, version_tree_arity_log2 (u8),
                   compression method, and for zstd its level as i32), then
                   a data-file table, the newest versions (generation,
                   root height (u8), root reference, key/byte statistics,
                   commit time (u64)) and references to version-tree nodes
                   holding older ones. With manifest_kind 1 ("numbered")
                   manifest.ocdbt holds the config alone and the versions
                   are in manifest.<16 hex digits>, the highest the newest.
  data-file table  num_files, the length each path shares with the one
                   before, each path's suffix length and base-path length,
                   then the suffixes; a path names a file under the store's
                   directory (a checkpoint's root manifest points into
                   ocdbt.process_<i>/d/, so several processes' trees read as
                   one).
  version-tree node  magic 0x0cdb1234: arity (u8), height (u8), a data-file
                   table, then versions (height 0) or child references.
  B+tree node      magic 0x0cdb20de: height (u8), a data-file table,
                   num_entries, prefix-compressed keys (the length each
                   shares with the key before, suffix lengths, then the
                   suffixes); a leaf then holds value lengths, value kinds
                   (0 inline, 1 indirect), the indirect values' file ids and
                   offsets, and the inline values; an interior node holds,
                   after the key lengths, each child's common-prefix length
                   (that prefix is stripped from the child's keys), then the
                   children's references and statistics.

Every node and manifest is checked: magic, length, version and CRC-32C; a
node's decoded size is bounded by the config's max_decoded_node_bytes. A
file that breaks the format raises `OcdbtError` naming the file.
"""

from __future__ import annotations

import os
import re
import struct
from pathlib import Path

from premvos_tpu_torch.io_compat import zstd

MANIFEST_MAGIC = 0x0CDB3A2A
VERSION_NODE_MAGIC = 0x0CDB1234
BTREE_NODE_MAGIC = 0x0CDB20DE


class OcdbtError(ValueError):
    """A file of the store that breaks the OCDBT format."""


class _Reader:
    """A cursor over one decoded body."""

    def __init__(self, data: bytes, name: str):
        self.data, self.pos, self.name = data, 0, name

    def fail(self, what: str):
        raise OcdbtError(f"{self.name}: {what} (at byte {self.pos} of {len(self.data)})")

    def bytes(self, n: int) -> bytes:
        if n < 0 or self.pos + n > len(self.data):
            self.fail("truncated body")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def u8(self) -> int:
        return self.bytes(1)[0]

    def u64(self) -> int:
        return struct.unpack("<Q", self.bytes(8))[0]

    def varint(self) -> int:
        value = shift = 0
        while True:
            b = self.u8()
            value |= (b & 0x7F) << shift
            if not b & 0x80:
                return value
            shift += 7
            if shift > 63:
                self.fail("varint longer than 64 bits")

    def varints(self, n: int) -> list:
        return [self.varint() for _ in range(n)]

    def done(self):
        if self.pos != len(self.data):
            self.fail(f"{len(self.data) - self.pos} bytes left over")


def _unwrap(raw: bytes, magic: int, name: str, max_bytes: int | None = None) -> bytes:
    """The body of a manifest or node: header, CRC-32C footer, zstd."""
    if len(raw) < 18:
        raise OcdbtError(f"{name}: {len(raw)} bytes, too short for a header and footer")
    got_magic, length = struct.unpack(">I", raw[:4])[0], struct.unpack("<Q", raw[4:12])[0]
    if got_magic != magic:
        raise OcdbtError(f"{name}: magic {got_magic:#010x}, expected {magic:#010x}")
    if length != len(raw):
        raise OcdbtError(f"{name}: header states {length} bytes, the file holds {len(raw)}")
    if struct.unpack("<I", raw[-4:])[0] != zstd.crc32c(raw[:-4]):
        raise OcdbtError(f"{name}: CRC-32C mismatch")
    head = _Reader(raw[:-4], name)
    head.pos = 12
    version, compression = head.varint(), head.varint()
    if version != 0:
        raise OcdbtError(f"{name}: format version {version}, only 0 is known")
    body = raw[head.pos:-4]
    if compression == 0:
        return body
    if compression != 1:
        raise OcdbtError(f"{name}: compression format {compression}, only 0 and 1 (zstd) are known")
    return zstd.decompress(body, size=max_bytes, name=name)


def _file_table(r: _Reader) -> list:
    """A data-file table: each file's path under the store's directory."""
    n = r.varint()
    shared = [0] + r.varints(max(n - 1, 0))
    suffix = r.varints(n)
    base = r.varints(n)
    paths, prev = [], ""
    for i in range(n):
        if shared[i] > len(prev):
            r.fail("data-file path shares more than the path before")
        path = prev[:shared[i]] + r.bytes(suffix[i]).decode()
        if base[i] > len(path):
            r.fail("base path longer than its path")
        paths.append(path)
        prev = path
    return paths


def _refs(r: _Reader, files: list, n: int, with_length: bool = True) -> list:
    """n data references (file, offset[, length]), column by column."""
    ids = r.varints(n)
    offsets = r.varints(n)
    lengths = r.varints(n) if with_length else [None] * n
    for i in ids:
        if i >= len(files):
            r.fail(f"data file {i} past the table of {len(files)}")
    return [(files[i], o, ln) for i, o, ln in zip(ids, offsets, lengths)]


def _versions(r: _Reader, files: list) -> list:
    """Version-tree leaf entries: [(generation, root height, root ref, num_keys)]."""
    n = r.varint()
    gens = r.varints(n)
    heights = [r.u8() for _ in range(n)]
    roots = _refs(r, files, n)
    num_keys = r.varints(n)
    r.varints(n)  # num_tree_bytes
    r.varints(n)  # num_indirect_value_bytes
    for _ in range(n):
        r.u64()  # commit_time
    return list(zip(gens, heights, roots, num_keys))


def _version_children(r: _Reader, files: list, with_height: bool) -> list:
    """Version-tree interior entries: [(newest generation, generations,
    ref, height or None)]; a child holds generations
    (newest - generations, newest]."""
    n = r.varint()
    gens = r.varints(n)
    refs = _refs(r, files, n)
    counts = r.varints(n)
    for _ in range(n):
        r.u64()  # commit_time
    heights = [r.u8() for _ in range(n)] if with_height else [None] * n
    return list(zip(gens, counts, refs, heights))


def _pick(versions: list, children: list, generation: int | None, r: _Reader):
    """The version asked for (the newest for None) among a manifest's or
    node's versions, or else the child that holds it."""
    if generation is None:
        if versions:
            return max(versions, key=lambda v: v[0]), None
        if children:
            return None, max(children, key=lambda c: c[0])
    else:
        for v in versions:
            if v[0] == generation:
                return v, None
        for c in children:
            if c[0] - c[1] < generation <= c[0]:
                return None, c
    r.fail("no version" if generation is None else f"no generation {generation}")


class OcdbtStore:
    """One version of the OCDBT store in directory `path`: the latest, or
    `generation` (as tensorstore's `"version"` option), which may lie in
    the version tree's nodes."""

    def __init__(self, path, generation: int | None = None):
        self.root = Path(path)
        name, raw = self._manifest()
        r = _Reader(_unwrap(raw, MANIFEST_MAGIC, name), name)
        self.config = self._config(r)
        if self.config["manifest_kind"] == 1:  # the versions are in manifest.<n>
            r.done()
            name, raw = self._numbered()
            r = _Reader(_unwrap(raw, MANIFEST_MAGIC, name), name)
            numbered = self._config(r)  # states manifest_kind 0
            if {**numbered, "manifest_kind": 1} != self.config:
                r.fail("config differs from manifest.ocdbt's")
        files = _file_table(r)
        versions = _versions(r, files)
        children = _version_children(r, files, with_height=True)
        r.done()
        version, child = _pick(versions, children, generation, r)
        if version is None:
            version = self._descend_versions(child, generation)
        self.generation, height, ref, num_keys = version
        self._index = {}
        if num_keys:
            self._walk(ref, height, b"")
        if len(self._index) != num_keys:
            raise OcdbtError(
                f"{self.root}: version {self.generation} states {num_keys} keys, its tree holds "
                f"{len(self._index)}")

    # -- manifest and version tree

    def _manifest(self):
        path = self.root / "manifest.ocdbt"
        if not path.is_file():
            raise FileNotFoundError(f"{self.root}: no OCDBT manifest (manifest.ocdbt)")
        return str(path), path.read_bytes()

    def _numbered(self):
        numbered = sorted(p for p in os.listdir(self.root)
                          if re.fullmatch(r"manifest\.[0-9a-f]{16}", p))
        if not numbered:
            raise OcdbtError(f"{self.root}: numbered manifests announced, none found")
        path = self.root / numbered[-1]
        return str(path), path.read_bytes()

    def _config(self, r: _Reader) -> dict:
        config = {"uuid": r.bytes(16).hex(), "manifest_kind": r.varint(),
                  "max_inline_value_bytes": r.varint(), "max_decoded_node_bytes": r.varint(),
                  "version_tree_arity_log2": r.u8(), "compression": r.varint()}
        if config["manifest_kind"] not in (0, 1):
            r.fail(f"manifest kind {config['manifest_kind']}")
        if config["compression"] == 1:
            config["zstd_level"] = struct.unpack("<i", r.bytes(4))[0]
        elif config["compression"] != 0:
            r.fail(f"compression method {config['compression']}")
        return config

    def _region(self, ref, magic: int) -> bytes:
        path, offset, length = ref
        full = self.root / path
        try:
            with open(full, "rb") as f:
                f.seek(offset)
                raw = f.read(length)
        except OSError as e:
            raise OcdbtError(f"{self.root}: cannot read data file {path}: {e}") from e
        if len(raw) != length:
            raise OcdbtError(f"{full}: {length} bytes at {offset} asked for, {len(raw)} there")
        name = f"{full}@{offset}"
        return name, _unwrap(raw, magic, name, self.config["max_decoded_node_bytes"])

    def _descend_versions(self, child, generation: int | None):
        """The version asked for under a version-tree node reference."""
        _, _, ref, height = child
        while True:
            name, body = self._region(ref, VERSION_NODE_MAGIC)
            r = _Reader(body, name)
            r.u8()  # version_tree_arity_log2
            node_height = r.u8()
            if height is not None and node_height != height:
                r.fail(f"height {node_height}, its parent states {height}")
            files = _file_table(r)
            if node_height == 0:
                versions = _versions(r, files)
                r.done()
                return _pick(versions, [], generation, r)[0]
            children = _version_children(r, files, with_height=False)
            r.done()
            _, _, ref, _ = _pick([], children, generation, r)[1]
            height = node_height - 1

    # -- B+tree

    def _walk(self, ref, height: int, prefix: bytes) -> None:
        name, body = self._region(ref, BTREE_NODE_MAGIC)
        r = _Reader(body, name)
        if r.u8() != height:
            r.fail(f"B+tree node height differs from its parent's {height}")
        files = _file_table(r)
        n = r.varint()
        if n == 0:
            r.fail("B+tree node holds no entry")
        shared = [0] + r.varints(n - 1)
        suffix = r.varints(n)
        common = r.varints(n) if height else None
        keys, prev = [], b""
        for i in range(n):
            if shared[i] > len(prev):
                r.fail("key shares more than the key before")
            key = prev[:shared[i]] + r.bytes(suffix[i])
            keys.append(key)
            prev = key
        if height == 0:
            lengths = r.varints(n)
            kinds = [r.u8() for _ in range(n)]
            if any(k > 1 for k in kinds):
                r.fail(f"value kind {max(kinds)}")
            indirect = iter(_refs(r, files, kinds.count(1), with_length=False))
            for key, length, kind in zip(keys, lengths, kinds):
                if kind == 0:
                    value = r.bytes(length)
                else:
                    path, offset, _ = next(indirect)
                    value = (path, offset, length)
                self._index[(prefix + key).decode()] = value
            r.done()
            return
        children = _refs(r, files, n)
        r.varints(3 * n)  # num_keys, num_tree_bytes, num_indirect_value_bytes
        r.done()
        for key, keep, child in zip(keys, common, children):
            if keep > len(key):
                r.fail("common prefix longer than its key")
            self._walk(child, height - 1, prefix + key[:keep])

    # -- reading

    def list(self) -> list:
        """Every key, sorted."""
        return sorted(self._index)

    def read(self, key: str) -> bytes:
        """The value of `key`; KeyError if the store has none."""
        value = self._index[key]
        if isinstance(value, bytes):
            return value
        path, offset, length = value
        full = self.root / path
        with open(full, "rb") as f:
            f.seek(offset)
            data = f.read(length)
        if len(data) != length:
            raise OcdbtError(f"{full}: value of {key!r} cut short ({len(data)} of {length} bytes)")
        return data
