"""The port's reader of the JAX package's orbax checkpoints (io_compat/
orbax_ckpt.py over io_compat/ocdbt.py and the zstd decoder) against orbax
and tensorstore themselves.

The checkpoints under tests/data/orbax are written by
scripts/make_orbax_fixtures.py with the JAX package's `save_params` and
orbax's handlers: every leaf of every small fixture reads bit for bit as
`premvos_tpu.utils.checkpoint.load_params` restores it (dtype, shape,
bytes); the full-width davis2017_val tree matches its record's sha256s,
read one array at a time; one net's tree (a JAX trainer's --out) and the
four-net bundle load into the port's modules as `bridge.params_from_jax`
loads orbax's restore; the OCDBT store reads as tensorstore reads it, older
generations too; and the port's `run_davis --checkpoint` tracks as the JAX
CLI's does on the same orbax directory. Refusals name what they refuse.
"""

import dataclasses
import functools
import hashlib
import json
import os
import re
import shutil
import struct
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import tensorstore as ts
import torch
from PIL import Image

from premvos_tpu import config as jc
from premvos_tpu.data.davis import make_synthetic_davis
from premvos_tpu.pipeline import run_davis as jrun_davis
from premvos_tpu.utils.checkpoint import load_params as orbax_load
from premvos_tpu_torch import bridge
from premvos_tpu_torch import config as tc
from premvos_tpu_torch.io_compat import zstd
from premvos_tpu_torch.io_compat.ocdbt import OcdbtError, OcdbtStore
from premvos_tpu_torch.io_compat.orbax_ckpt import (
    OrbaxFormatError, check_tree, is_orbax_dir, iter_arrays, orbax_state_dict, read_orbax,
)
from premvos_tpu_torch.pipeline import run_davis
from premvos_tpu_torch.pipeline import runner as tr
from premvos_tpu_torch.utils.checkpoint import NETS, load_params
from tests._jax_block_warp import jax_tpu_block_warp  # noqa: F401 (autouse)
from tests.test_pipeline import TINY
from tests._threads import few_threads  # noqa: F401

DATA = Path(__file__).parent / "data" / "orbax"
SMALL = ("tiny_f32", "tiny_bf16", "tiny_maskrcnn", "tiny_refine", "tiny_flow", "tiny_reid",
         "sharded", "dtypes", "no_ocdbt", "no_compression", "layouts",
         "zarr3", "zarr3_no_ocdbt", "zarr3_no_compression", "zarr3_inner_chunks",
         "zarr3_layouts", "tiny_f32_zarr3")


def tiny_cfg():
    return tc._from_dict(tc.PremvosConfig, dataclasses.asdict(TINY))


def leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from leaves(v, (*prefix, k))
        else:
            yield (*prefix, k), v


def as_bytes(value):
    """(dtype name, shape, C-order bytes) of a numpy, jax or torch leaf."""
    if isinstance(value, torch.Tensor):
        return str(value.dtype).removeprefix("torch."), tuple(value.shape), \
            value.contiguous().view(torch.int16).numpy().tobytes()
    a = np.ascontiguousarray(np.asarray(value))
    return str(a.dtype), a.shape, a.tobytes()


def numpy_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.mark.parametrize("name", SMALL)
def test_reads_as_orbax_restores(name):
    got = dict(leaves(read_orbax(DATA / name)))
    want = dict(leaves(orbax_load(DATA / name)))
    assert got.keys() == want.keys()
    for path, value in want.items():
        assert as_bytes(got[path]) == as_bytes(value), path
    assert is_orbax_dir(DATA / name)


def test_bf16_bundle_equals_a_float32_restore_after_the_cast():
    """Read widened to float32, the bf16 bundle equals orbax's restore with
    a float32 `like=` tree (orbax casts to the like= dtype); and the
    torch.bfloat16 read widens to the same values."""
    like = read_orbax(DATA / "tiny_f32")  # shapes and dtypes only
    want = dict(leaves(numpy_tree(orbax_load(DATA / "tiny_bf16", like=like))))
    got = dict(leaves(read_orbax(DATA / "tiny_bf16", bfloat16="float32")))
    as_torch = dict(leaves(read_orbax(DATA / "tiny_bf16")))
    assert got.keys() == want.keys() == as_torch.keys()
    for path, value in want.items():
        assert value.dtype == np.float32 and got[path].dtype == np.float32
        np.testing.assert_array_equal(got[path], value)
        np.testing.assert_array_equal(as_torch[path].float().numpy(), value)


def test_full_width_fixture_matches_its_record():
    """davis2017_val's 1359 leaves (1.14 GB), one array at a time: each
    path, dtype, shape and sha256 as orbax restored them when written."""
    record = json.loads((DATA / "davis2017_val_tiled.json").read_text())
    want = {leaf["path"]: leaf for leaf in record["leaves"]}
    seen, params = set(), 0
    for keys, a in iter_arrays(DATA / "davis2017_val_tiled"):
        leaf = want[".".join(keys)]
        assert (str(a.dtype), list(a.shape)) == (leaf["dtype"], leaf["shape"]), keys
        assert hashlib.sha256(a.tobytes()).hexdigest() == leaf["sha256"], keys
        seen.add(".".join(keys))
        params += a.size
    assert seen == set(want) and len(seen) == 1359
    assert params == record["parameters"] == 284_696_994


def test_full_width_zarr3_fixture_matches_the_record():
    """The same davis2017_val tree saved with use_zarr3 (one shard an
    array): each leaf's sha256 as the zarr v2 fixture's record holds it."""
    record = json.loads((DATA / "davis2017_val_tiled.json").read_text())
    want = {leaf["path"]: leaf for leaf in record["leaves"]}
    seen = set()
    for keys, a in iter_arrays(DATA / "davis2017_val_tiled_zarr3"):
        leaf = want[".".join(keys)]
        assert (str(a.dtype), list(a.shape)) == (leaf["dtype"], leaf["shape"]), keys
        assert hashlib.sha256(a.tobytes()).hexdigest() == leaf["sha256"], keys
        seen.add(".".join(keys))
    assert seen == set(want) and len(seen) == 1359


@pytest.fixture(scope="module")
def tiny_models():
    return tr.build_models(tiny_cfg(), device="cpu")


@pytest.mark.parametrize("net", NETS)
def test_one_nets_tree_loads_as_the_bridge_loads_orbaxs_restore(tiny_models, net):
    """A JAX trainer's --out ({"params": ...}, one net): orbax_state_dict
    gives every tensor of the module's state dict, equal to
    bridge.flax_tensors of orbax's own restore."""
    module = getattr(tiny_models, net)
    got = orbax_state_dict(DATA / f"tiny_{net}", module)
    want = bridge.flax_tensors(module, numpy_tree(orbax_load(DATA / f"tiny_{net}")))
    assert set(got) == set(want) == set(module.state_dict())
    for k, v in want.items():
        assert got[k].dtype == module.state_dict()[k].dtype
        assert torch.equal(got[k], v), k
    module.load_state_dict(got, strict=True)


@pytest.mark.parametrize("name", ("tiny_f32", "tiny_bf16", "tiny_f32_zarr3"))
def test_load_params_takes_the_orbax_bundle(name):
    """utils/checkpoint.load_params on the orbax directory: every net's
    tensors equal params_from_jax of orbax's restore, cast to the modules'
    dtypes (float32; the bf16 bundle widened exactly)."""
    got = load_params(DATA / name, tr.build_models(tiny_cfg(), device="cpu"))
    restored = numpy_tree(orbax_load(DATA / name))
    want = bridge.params_from_jax(
        tr.build_models(tiny_cfg(), device="cpu"),
        jax.tree.map(lambda a: np.asarray(a, np.float32), restored))
    for net in NETS:
        g, w = getattr(got, net).state_dict(), getattr(want, net).state_dict()
        assert g.keys() == w.keys()
        for k, v in w.items():
            assert g[k].dtype == torch.float32 and torch.equal(g[k], v), (net, k)


def test_refusals_name_what_they_refuse(tmp_path, tiny_models):
    zarr3 = tmp_path / "zarr3"
    shutil.copytree(DATA / "zarr3_no_ocdbt", zarr3)
    meta = json.loads((zarr3 / "f4" / "zarr.json").read_text())
    meta["codecs"].insert(0, {"name": "transpose", "configuration": {"order": [1, 0]}})
    (zarr3 / "f4" / "zarr.json").write_text(json.dumps(meta))
    with pytest.raises(OrbaxFormatError, match="array f4: codec 'transpose'"):
        read_orbax(zarr3)
    # A net's tree on another net's module: both lists given.
    with pytest.raises(ValueError, match=r"does not match the module: missing \[.*\]; extra \["):
        orbax_state_dict(DATA / "tiny_flow", tiny_models.refine)
    # A collection beside "params" is extra too.
    flow = read_orbax(DATA / "tiny_flow")
    with pytest.raises(ValueError, match=r"missing \[\]; extra \['batch_stats\.a'\]"):
        check_tree(tiny_models.flow, {**flow, "batch_stats": {"a": np.zeros(1)}}, "flow")
    check_tree(tiny_models.flow, flow, "flow")
    # One net alone is no bundle.
    with pytest.raises(KeyError, match="no state for"):
        load_params(DATA / "tiny_maskrcnn", tr.build_models(tiny_cfg(), device="cpu"))
    # A bundle with a leaf gone: the missing path is named.
    bundle = tmp_path / "bundle"
    shutil.copytree(DATA / "tiny_f32", bundle)
    meta = json.loads((bundle / "_METADATA").read_text())
    gone = "('flow', 'params', 'flownetc', 'conv4', 'Conv_0', 'bias')"
    assert meta["tree_metadata"].pop(gone)
    (bundle / "_METADATA").write_text(json.dumps(meta))
    with pytest.raises(ValueError, match=r"missing \['flownetc\.conv4\.Conv_0\.bias'\]"):
        load_params(bundle, tr.build_models(tiny_cfg(), device="cpu"))

    def edited(name, edit):
        d = tmp_path / f"{name}_{len(list(tmp_path.iterdir()))}"
        shutil.copytree(DATA / "no_ocdbt", d)
        edit(d)
        return d

    def set_json(path, **kw):
        path.write_text(json.dumps({**json.loads(path.read_text()), **kw}))

    def scalar(d):
        meta = json.loads((d / "_METADATA").read_text())
        meta["tree_metadata"]["('f4',)"]["value_metadata"]["value_type"] = "scalar"
        (d / "_METADATA").write_text(json.dumps(meta))

    cases = (
        (lambda d: set_json(d / "f4" / ".zarray", compressor={"id": "blosc"}), "compressor 'blosc'"),
        (lambda d: set_json(d / "f4" / ".zarray", filters=[{"id": "delta"}]), "filters"),
        (lambda d: set_json(d / "f4" / ".zarray", dtype=">f4"), "dtype '>f4'"),
        (lambda d: (d / "i4" / "0.0").unlink(), r"array i4: chunk i4/0\.0 is missing"),
        (scalar, "f4 is a 'scalar', not an array"),
    )
    for edit, message in cases:
        with pytest.raises(OrbaxFormatError, match=message):
            read_orbax(edited("case", edit))
    # A chunk cut short (tensorstore's frames carry no checksum, so a
    # flipped byte in a raw block would go unseen; a cut cannot).
    cut = edited("cut", lambda d: None)
    chunk = cut / "f8" / "0.0.0"
    chunk.write_bytes(chunk.read_bytes()[:-5])
    with pytest.raises(zstd.ZstdTruncated, match="f8/0.0.0"):
        read_orbax(cut)


def _zarr3_copy(tmp_path, edit):
    d = tmp_path / f"z{len(list(tmp_path.iterdir()))}"
    shutil.copytree(DATA / "zarr3_no_ocdbt", d)
    edit(d)
    return d


def _zarr3_json(d, name, edit):
    path = d / name / "zarr.json"
    meta = json.loads(path.read_text())
    edit(meta)
    path.write_text(json.dumps(meta))


def _shard_codec(meta):
    return meta["codecs"][0]["configuration"]


def _flip_index_byte(d):
    shard = d / "f4" / "c" / "0" / "0"
    raw = bytearray(shard.read_bytes())
    raw[-10] ^= 1  # inside the index, before its CRC-32C
    shard.write_bytes(bytes(raw))


def _empty_inner_chunk(d):
    """The index pair of f4's one inner chunk set to 2^64 - 1 (never
    written), its CRC-32C recomputed."""
    shard = d / "f4" / "c" / "0" / "0"
    raw = shard.read_bytes()
    index = b"\xff" * 16
    shard.write_bytes(raw[:-20] + index + struct.pack("<I", zstd.crc32c(index)))


ZARR3_REFUSALS = {
    "crc_mismatch": (_flip_index_byte, r"shard f4/c/0/0 index: CRC-32C mismatch", True),
    "gzip": (lambda d: _zarr3_json(d, "f4", lambda m: _shard_codec(m)["codecs"].__setitem__(
        1, {"name": "gzip", "configuration": {"level": 5}})), "codec 'gzip'", False),
    "blosc": (lambda d: _zarr3_json(d, "i4", lambda m: m["codecs"].append(
        {"name": "blosc", "configuration": {}})), "codec 'blosc'", False),
    "big_endian": (lambda d: _zarr3_json(d, "f8", lambda m: _shard_codec(m)["codecs"][0]
                                         .__setitem__("configuration", {"endian": "big"})),
                   "endian 'big'", False),
    "missing_chunk": (lambda d: (d / "f4" / "c" / "0" / "0").unlink(),
                      r"array f4: chunk f4/c/0/0 is missing", True),
    "empty_inner_chunk": (_empty_inner_chunk, r"inner chunk \(0, 0\) is missing", True),
}


@pytest.mark.parametrize("case", list(ZARR3_REFUSALS))
def test_zarr3_refusals_name_what_they_refuse(case, tmp_path):
    """zarr v3 features the reader does not read, each refused by name: a
    codec other than bytes, sharding_indexed, zstd and crc32c, a big-endian
    bytes codec, a shard index whose CRC-32C does not match. A chunk never
    written (a missing key, an inner chunk whose index pair is 2^64 - 1)
    is refused too, as orbax's restore refuses it (`orbax_refuses`): it
    reads with tensorstore's fill_missing_data_reads off."""
    edit, message, orbax_refuses = ZARR3_REFUSALS[case]
    d = _zarr3_copy(tmp_path, edit)
    with pytest.raises(OrbaxFormatError, match=message):
        read_orbax(d)
    if orbax_refuses:
        with pytest.raises(Exception):
            orbax_load(d)


def _ts_store(path, **config):
    return ts.KvStore.open({"driver": "ocdbt", "base": f"file://{path}/",
                            "config": config}).result()


def _same_as_tensorstore(path, generation=None):
    spec = {"driver": "ocdbt", "base": f"file://{path}/"}
    if generation is not None:
        spec["version"] = generation
    kv = ts.KvStore.open(spec).result()
    want = sorted(k.decode() for k in kv.list().result())
    store = OcdbtStore(path, generation=generation)
    assert store.list() == want
    for key in want:
        assert store.read(key) == kv.read(key).result().value, key
    return store


@pytest.mark.parametrize("config", (
    dict(max_decoded_node_bytes=300, version_tree_arity_log2=1, max_inline_value_bytes=16),
    dict(manifest_kind="numbered", compression={"id": "zstd", "level": 5}),
    dict(compression=None, max_inline_value_bytes=0),
), ids=("small_nodes", "numbered", "uncompressed"))
def test_ocdbt_store_reads_as_tensorstore(tmp_path, config):
    """Stores written by tensorstore: interior B+tree nodes (height > 0),
    inline and indirect values, version-tree nodes (every generation read
    back), numbered manifests, uncompressed nodes."""
    kv = _ts_store(tmp_path, **config)
    rng = np.random.default_rng(1)
    for i in range(9):
        kv.write(f"key{i:03d}/.zarray", rng.bytes(int(rng.integers(0, 40)))).result()
    with ts.Transaction() as txn:
        for i in range(9, 60):
            kv.with_transaction(txn).write(f"key{i:03d}/{i}.{i}", rng.bytes(i * 3)).result()
    kv.delete_range(ts.KvStore.KeyRange("key004/", "key005")).result()
    latest = _same_as_tensorstore(tmp_path)
    assert len(latest.list()) == 59
    for generation in range(1, latest.generation):
        _same_as_tensorstore(tmp_path, generation)


def test_ocdbt_refuses_a_corrupt_node(tmp_path):
    store = tmp_path / "s"
    shutil.copytree(DATA / "dtypes", store)
    nodes = sorted((store / "ocdbt.process_0" / "d").iterdir(), key=lambda p: p.stat().st_size)
    raw = bytearray(nodes[0].read_bytes())
    raw[len(raw) // 2] ^= 1
    nodes[0].write_bytes(bytes(raw))
    with pytest.raises(OcdbtError, match="CRC-32C mismatch"):
        OcdbtStore(store / "ocdbt.process_0", generation=1)
    shutil.copytree(DATA / "dtypes", tmp_path / "m")
    (tmp_path / "m" / "manifest.ocdbt").write_bytes(b"\x0c\xdb\x3a\x2b" + bytes(20))
    with pytest.raises(OcdbtError, match="magic"):
        read_orbax(tmp_path / "m")


def test_run_davis_checkpoint_matches_the_jax_cli(tmp_path, monkeypatch):
    """The slice as a whole: the JAX package's run_davis and the port's
    (--device cpu) with --checkpoint on the same orbax directory (tiny_f32:
    the TINY config's tree, its RPN and box-head delta layers zeroed, see
    tests/test_torch_cli.py), 3 frames of 64×64: the labels agree on ≥ 99 %
    of pixels and frame 0 is the annotation. The JAX CLI's random init only
    shapes its `like=` tree, so it is replaced by its shapes (jax.eval_shape)
    to save its compile."""
    from premvos_tpu.pipeline import runner as jr

    root = make_synthetic_davis(tmp_path / "davis", t=3, hw=(64, 64))
    cfg = tmp_path / "tiny.json"
    jc.save_config(cfg, TINY)
    monkeypatch.setattr(jrun_davis, "init_params", lambda m, c, k: jax.eval_shape(
        functools.partial(jr.init_params, m, c), k))
    common = ["--davis_root", str(root), "--config", str(cfg),
              "--checkpoint", str(DATA / "tiny_f32")]
    want = jrun_davis.main(common + ["--output", str(tmp_path / "jax")])
    got = run_davis.main(common + ["--output", str(tmp_path / "port"), "--device", "cpu"])
    assert got["frames"] == want["frames"] == 2

    def pngs(d):
        return np.stack([np.asarray(Image.open(p)) for p in sorted(d.glob("*.png"))])

    a, b = pngs(tmp_path / "port" / "seq_a"), pngs(tmp_path / "jax" / "seq_a")
    assert a.shape == b.shape == (3, 64, 64)
    ann = np.asarray(Image.open(root / "Annotations" / "480p" / "seq_a" / "00000.png"))
    np.testing.assert_array_equal(a[0], ann)
    np.testing.assert_array_equal(b[0], ann)
    assert (a == b).mean() >= 0.99


def test_the_reader_loads_no_jax_orbax_or_tensorstore(tmp_path):
    """Reading every fixture (zarr v2 and v3), writing each back with the
    port's writer, reading every PNM fixture and loading the bundle into
    the port's modules, in a fresh interpreter, loads none of jax, orbax,
    tensorstore, ml_dtypes, zstandard, premvos_tpu or PIL (the card's
    machine has none), and no module of the port or chip_smoke.py imports
    them."""
    repo = Path(__file__).parent.parent
    code = (
        "import sys, dataclasses\n"
        "from premvos_tpu_torch.io_compat.orbax_ckpt import read_orbax\n"
        "from premvos_tpu_torch.pipeline.runner import build_models\n"
        "from premvos_tpu_torch.utils.checkpoint import load_params\n"
        "from premvos_tpu_torch.config import load_config\n"
        "from premvos_tpu_torch.io_compat.orbax_write import write_orbax\n"
        "from premvos_tpu_torch.io_compat.ppm import read_ppm\n"
        "import glob\n"
        f"for name in {SMALL!r}:\n"
        f"    tree = read_orbax({str(DATA)!r} + '/' + name)\n"
        "    if not name.startswith('tiny'):  # the tiny bundles are 345 MB unpacked\n"
        "        write_orbax(sys.argv[2] + '/' + name, tree)\n"
        f"for p in glob.glob({str(DATA.parent / 'pnm')!r} + '/*.ppm'):\n"
        "    read_ppm(p)\n"
        f"cfg = load_config(sys.argv[1])\n"
        f"load_params({str(DATA / 'tiny_f32')!r}, build_models(cfg, device='cpu'))\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in ('jax', 'jaxlib', 'orbax',\n"
        "             'tensorstore', 'ml_dtypes', 'zstandard', 'premvos_tpu', 'PIL'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    cfg = tmp_path / "tiny.json"
    tc.save_config(cfg, tiny_cfg())
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    env["PYTHONPATH"] = str(repo)
    proc = subprocess.run([sys.executable, "-c", code, str(cfg), str(tmp_path)], cwd=repo,
                          env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    pattern = re.compile(
        r"^\s*(import|from)\s+(jax|orbax|tensorstore|ml_dtypes|zstandard|premvos_tpu)\b")
    sources = [*sorted((repo / "premvos_tpu_torch").rglob("*.py")), repo / "chip_smoke.py"]
    bad = [f"{p}:{i}" for p in sources
           for i, line in enumerate(p.read_text().splitlines(), 1) if pattern.match(line)]
    assert not bad, bad
