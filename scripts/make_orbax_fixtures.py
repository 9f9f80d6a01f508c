#!/usr/bin/env python3
"""Write the orbax checkpoints that the port's reader is tested on, with the
JAX package's own writer (premvos_tpu.utils.checkpoint.save_params, orbax's
StandardCheckpointer) and orbax's other handlers:

    python scripts/make_orbax_fixtures.py [--out tests/data/orbax]

  davis2017_val_tiled/      the JAX `init_params` tree at
                            configs/davis2017_val.json (1359 float32 leaves,
                            284,696,994 parameters, 1.14 GB), its values
                            drawn by `tiled_values`, saved by save_params
  davis2017_val_tiled.json  each leaf's dotted path, dtype, shape and the
                            sha256 of its bytes (C order) as orbax's
                            load_params restores it
  tiny_f32/                 the same at tests/test_pipeline.py's TINY config
                            (64×64, FlowNetC), with the RPN's and the box
                            head's delta layers zeroed (tests/test_torch_cli.py
                            says why)
  tiny_bf16/                tiny_f32's tree cast to bfloat16
  tiny_<net>/               one net of it, {"params": ...}, as each JAX
                            trainer's --out writes it (maskrcnn, refine,
                            flow, reid)
  sharded/                  a [8, 6] array sharded over a mesh of 4 virtual
                            CPU devices (chunk keys x/0.0 ... x/3.0) and a
                            replicated one
  dtypes/                   one leaf of each dtype the reader maps (float32,
                            float16, float64, int32, int64, uint8, bool,
                            bfloat16), numpy and jax arrays, a 0-d array
  no_ocdbt/                 that tree through StandardCheckpointHandler(
                            use_ocdbt=False): plain files x/.zarray, x/0, ...
  no_compression/           through PyTreeCheckpointHandler(
                            use_compression=False): "compressor": null
  layouts/                  dtypes/ with three arrays rewritten through
                            tensorstore's zarr driver into the checkpoint's
                            OCDBT store, as a later version: Fortran order,
                            dimension_separator "/", several chunks per
                            array (edge chunks partly outside the array)
  zarr3/                    PyTreeCheckpointHandler(use_zarr3=True): zarr v3
                            arrays, each one shard (sharding_indexed: inner
                            bytes + zstd, index bytes + crc32c)
  tiny_f32_zarr3/           tiny_f32's tree so, a bundle load_params takes
  zarr3_no_ocdbt/           the same with use_ocdbt=False (plain files)
  zarr3_no_compression/     the same with use_compression=False
  zarr3_inner_chunks/       the same with SaveArgs(chunk_byte_size=64):
                            several inner chunks a shard
  zarr3_layouts/            zarr3/ with four arrays rewritten through
                            tensorstore's zarr3 driver, as a later OCDBT
                            version: the "v2" chunk key encoding over plain
                            bytes + zstd chunks (edge chunks partly outside
                            the array), the shard index at the start, an
                            inner chunk and chunks equal to fill_value
                            ("NaN" for one; stored, as orbax's restore
                            refuses a chunk that is not)
  davis2017_val_tiled_zarr3/
                            davis2017_val_tiled's tree saved with
                            PyTreeCheckpointHandler(use_zarr3=True); its
                            record is davis2017_val_tiled.json

`tiled_values` keeps the checkpoints small: every array of 4096 elements
or more is a block of 1021 values from
np.random.default_rng([seed, crc32(dotted path)]), tiled; kernels at a
He-like scale (sqrt(2 / fan_in)), frozen-BN scale and var within 5 % of 1,
BN bias and mean and layer biases within 5 % of 0 (chip_smoke.py phase
7d's rule: further from them, davis2017_val tracks nothing after frame 0),
these on a grid of 2^-8 so that their many small arrays compress too.
Run it on a machine with JAX, orbax and tensorstore, not on the card's;
the outputs are committed, so rerun only to change them (`--only zarr3`
writes the zarr3 fixtures alone). JAX's init at
davis2017_val is not run: the tree's shapes come from `jax.eval_shape`.
"""

from __future__ import annotations

import os

# Four virtual CPU devices for the sharded fixture, before JAX starts.
os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=4").strip()

import argparse  # noqa: E402
import functools  # noqa: E402
import hashlib  # noqa: E402
import json  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import zlib  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

jax.config.update("jax_platforms", "cpu")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import orbax.checkpoint as ocp  # noqa: E402
import tensorstore as ts  # noqa: E402

from premvos_tpu.config import load_config  # noqa: E402
from premvos_tpu.pipeline.runner import build_models, init_params  # noqa: E402
from premvos_tpu.utils.checkpoint import load_params, save_params  # noqa: E402
from tests.test_pipeline import TINY  # noqa: E402

SEED = 15
BLOCK = 1021
TILE_FROM = 4096
GRID = 256
NETS = ("maskrcnn", "refine", "flow", "reid")


def dotted(path) -> str:
    return ".".join(str(getattr(k, "key", k)) for k in path)


def tiled_values(path: str, shape: tuple) -> np.ndarray:
    """The float32 value of the leaf at dotted `path` (the rule above)."""
    rng = np.random.default_rng([SEED, zlib.crc32(path.encode())])
    leaf = path.rsplit(".", 1)[-1]
    size = int(np.prod(shape))
    n = BLOCK if size >= TILE_FROM else size
    if leaf == "kernel":
        fan_in = int(np.prod(shape[:-1])) or 1
        block = rng.standard_normal(n) * np.sqrt(2.0 / fan_in)
    elif leaf in ("scale", "var", "bias", "mean"):
        # On a grid of 2^-8, so that the many small such arrays compress.
        block = np.round(rng.uniform(-0.05, 0.05, n) * GRID) / GRID
        if leaf in ("scale", "var"):
            block += 1.0
    else:
        raise ValueError(f"{path}: no rule for a leaf named {leaf!r}")
    return np.resize(block.astype(np.float32), shape)


def tiled_bundle(cfg) -> dict:
    """{net: {"params": ...}} of jax arrays shaped as init_params(cfg)."""
    models = build_models(cfg)
    shapes = jax.eval_shape(functools.partial(init_params, models, cfg), jax.random.PRNGKey(0))
    return jax.tree_util.tree_map_with_path(
        lambda p, s: jnp.asarray(tiled_values(dotted(p), s.shape)), shapes)


def fresh(path: str) -> str:
    shutil.rmtree(path, ignore_errors=True)
    return path


def write_full(out: str) -> None:
    cfg = load_config(os.path.join(REPO, "configs", "davis2017_val.json"))
    tree = tiled_bundle(cfg)
    ckpt = fresh(os.path.join(out, "davis2017_val_tiled"))
    save_params(ckpt, tree)
    del tree
    restored = load_params(ckpt)
    leaves = []
    for path, value in jax.tree_util.tree_flatten_with_path(restored)[0]:
        a = np.ascontiguousarray(np.asarray(value))
        leaves.append({"path": dotted(path), "dtype": str(a.dtype), "shape": list(a.shape),
                       "sha256": hashlib.sha256(a.tobytes()).hexdigest()})
    record = {
        "config": "configs/davis2017_val.json",
        "writer": "premvos_tpu.utils.checkpoint.save_params",
        "leaves": leaves,
        "parameters": int(sum(np.prod(x["shape"]) for x in leaves)),
    }
    with open(os.path.join(out, "davis2017_val_tiled.json"), "w") as f:
        json.dump(record, f, indent=0)
        f.write("\n")
    print(f"davis2017_val_tiled: {len(leaves)} leaves, {record['parameters']} parameters")


def tiny_tree() -> dict:
    tree = tiled_bundle(TINY)
    heads = tree["maskrcnn"]["params"]
    for head, layer in (("rpn", "Conv_2"), ("box_head", "Dense_3")):
        heads[head][layer] = jax.tree.map(jnp.zeros_like, heads[head][layer])
    return tree


def write_tiny(out: str) -> None:
    tree = tiny_tree()
    save_params(fresh(os.path.join(out, "tiny_f32")), tree)
    save_params(fresh(os.path.join(out, "tiny_bf16")),
                jax.tree.map(lambda x: x.astype(jnp.bfloat16), tree))
    for net in NETS:
        save_params(fresh(os.path.join(out, f"tiny_{net}")), tree[net])


def dtypes_tree() -> dict:
    rng = np.random.default_rng(SEED)
    return {
        "f4": rng.standard_normal((3, 5)).astype(np.float32),
        "f2": rng.standard_normal((4, 3)).astype(np.float16),
        "f8": rng.standard_normal((2, 3, 2)),
        "i4": rng.integers(-2**31, 2**31, (5, 2), dtype=np.int32),
        "i8": rng.integers(-2**62, 2**62, (3,), dtype=np.int64),
        "u1": rng.integers(0, 256, (2, 2, 3), dtype=np.uint8),
        "b1": rng.random((7,)) < 0.5,
        "scalar": np.asarray(np.float32(2.5)),
        "nested": {
            "bf16": jnp.asarray(rng.standard_normal((6, 4)), jnp.bfloat16),
            "f4": jnp.asarray(rng.standard_normal((2, 9)), jnp.float32),
        },
    }


def write_options(out: str) -> None:
    tree = dtypes_tree()
    save_params(fresh(os.path.join(out, "dtypes")), tree)
    ocp.Checkpointer(ocp.StandardCheckpointHandler(use_ocdbt=False)).save(
        fresh(os.path.join(out, "no_ocdbt")), args=ocp.args.StandardSave(tree))
    ocp.Checkpointer(ocp.PyTreeCheckpointHandler(use_compression=False)).save(
        fresh(os.path.join(out, "no_compression")), args=ocp.args.PyTreeSave(tree))

    mesh = jax.sharding.Mesh(np.array(jax.devices()[:4]), ("d",))
    x = jax.device_put(jnp.arange(48, dtype=jnp.float32).reshape(8, 6),
                       jax.sharding.NamedSharding(mesh, jax.sharding.PartitionSpec("d")))
    save_params(fresh(os.path.join(out, "sharded")),
                {"x": x, "y": jnp.full((3,), 7, jnp.int32)})

    # layouts/: dtypes/ with three arrays rewritten as a later OCDBT version.
    path = fresh(os.path.join(out, "layouts"))
    save_params(path, tree)
    for name, order, sep, chunks in (("f4", "F", ".", [2, 2]), ("u1", "C", "/", [1, 2, 2]),
                                     ("nested.bf16", "F", "/", [4, 3])):
        value = np.asarray(tree[name] if "." not in name else tree["nested"]["bf16"])
        spec = {
            "driver": "zarr",
            "kvstore": {"driver": "ocdbt", "base": f"file://{os.path.abspath(path)}/",
                        "path": f"{name}/"},
            "metadata": {"shape": list(value.shape), "chunks": chunks, "order": order,
                         "dimension_separator": sep,
                         "dtype": "bfloat16" if value.dtype.name == "bfloat16" else value.dtype.str,
                         "compressor": {"id": "zstd", "level": 1}, "fill_value": None},
            "create": True, "delete_existing": True,
        }
        ts.open(spec).result().write(value).result()


def zarr3_save(path: str, tree, **handler) -> None:
    ocp.Checkpointer(ocp.PyTreeCheckpointHandler(use_zarr3=True, **handler)).save(
        fresh(path), args=ocp.args.PyTreeSave(tree))


def write_zarr3(out: str) -> None:
    tree = dtypes_tree()
    zarr3_save(os.path.join(out, "zarr3"), tree)
    zarr3_save(os.path.join(out, "zarr3_no_ocdbt"), tree, use_ocdbt=False)
    zarr3_save(os.path.join(out, "zarr3_no_compression"), tree, use_compression=False)
    zarr3_save(os.path.join(out, "tiny_f32_zarr3"), tiny_tree())
    small = jax.tree.map(lambda _: ocp.SaveArgs(chunk_byte_size=64), tree)
    ocp.Checkpointer(ocp.PyTreeCheckpointHandler(use_zarr3=True)).save(
        fresh(os.path.join(out, "zarr3_inner_chunks")),
        args=ocp.args.PyTreeSave(tree, save_args=small))

    # zarr3_layouts/: zarr3/ with four arrays rewritten as a later version.
    path = os.path.join(out, "zarr3_layouts")
    zarr3_save(path, tree)
    f8 = np.asarray(tree["f8"]).copy()
    f8[0] = np.nan  # a whole inner chunk equal to fill_value "NaN"
    i8 = np.asarray(tree["i8"]).copy()
    i8[[0, 2]] = 0  # chunks equal to fill_value 0
    zstd_codec = {"name": "zstd", "configuration": {"level": 1, "checksum": False}}
    layouts = (
        ("f4", np.asarray(tree["f4"]), [2, 2], "v2", [{"name": "bytes",
                                                       "configuration": {"endian": "little"}},
                                                      zstd_codec], None),
        ("u1", np.asarray(tree["u1"]), [2, 2, 3], "default",
         [{"name": "sharding_indexed", "configuration": {
             "chunk_shape": [1, 1, 3], "index_location": "start",
             "codecs": [{"name": "bytes"}, zstd_codec],
             "index_codecs": [{"name": "bytes", "configuration": {"endian": "little"}},
                              {"name": "crc32c"}]}}], None),
        ("f8", f8, [2, 3, 2], "default",
         [{"name": "sharding_indexed", "configuration": {
             "chunk_shape": [1, 3, 2], "codecs": [{"name": "bytes"}, zstd_codec],
             "index_codecs": [{"name": "bytes", "configuration": {"endian": "little"}},
                              {"name": "crc32c"}]}}], "NaN"),
        ("i8", i8, [1], "default", [{"name": "bytes", "configuration": {"endian": "little"}}],
         0),
    )
    for name, value, chunks, encoding, codecs, fill in layouts:
        spec = {
            "driver": "zarr3",
            "kvstore": {"driver": "ocdbt", "base": f"file://{os.path.abspath(path)}/",
                        "path": f"{name}/"},
            "metadata": {"shape": list(value.shape), "data_type": value.dtype.name,
                         "chunk_grid": {"name": "regular",
                                        "configuration": {"chunk_shape": chunks}},
                         "chunk_key_encoding": {"name": encoding},
                         "codecs": codecs,
                         "fill_value": fill if fill is not None else 0},
            "store_data_equal_to_fill_value": True,
            "create": True, "delete_existing": True,
        }
        ts.open(spec).result().write(value).result()


def write_full_zarr3(out: str) -> None:
    cfg = load_config(os.path.join(REPO, "configs", "davis2017_val.json"))
    path = os.path.join(out, "davis2017_val_tiled_zarr3")
    zarr3_save(path, tiled_bundle(cfg))
    size = sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(path) for f in fs)
    print(f"davis2017_val_tiled_zarr3: {size} bytes")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=os.path.join(REPO, "tests", "data", "orbax"))
    ap.add_argument("--only", choices=("all", "zarr3"), default="all")
    args = ap.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    if args.only == "all":
        write_options(args.out)
        write_tiny(args.out)
        write_full(args.out)
    write_zarr3(args.out)
    write_full_zarr3(args.out)


if __name__ == "__main__":
    main()
