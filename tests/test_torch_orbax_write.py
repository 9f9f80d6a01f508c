"""The port's orbax writer (io_compat/orbax_write.py, through
utils/checkpoint.py's save_params and save_net and the trainers' --out)
against the JAX package, which must restore what the port writes.

The port's nets carry the tiny fixture's weights (tests/data/orbax/tiny_f32,
so every leaf holds distinct values); `premvos_tpu.utils.checkpoint.
load_params` restores the port-written bundle and each net's tree, with and
without `like=`, each leaf equal to the port's bit for bit in flax's paths,
layouts and dtypes; the JAX `run_davis --checkpoint` on a port-written
bundle tracks as the port's does; a write that fails part way leaves no
checkpoint behind.
"""

import dataclasses
import functools
import os
import shutil

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from premvos_tpu import config as jc
from premvos_tpu.data.davis import make_synthetic_davis
from premvos_tpu.pipeline import run_davis as jrun_davis
from premvos_tpu.pipeline import runner as jr
from premvos_tpu.utils.checkpoint import load_params as orbax_load
from premvos_tpu_torch import bridge
from premvos_tpu_torch import config as tc
from premvos_tpu_torch.io_compat import orbax_write
from premvos_tpu_torch.io_compat.orbax_ckpt import is_orbax_dir, read_orbax
from premvos_tpu_torch.io_compat.orbax_write import write_orbax
from premvos_tpu_torch.models.layers import Conv, Dense
from premvos_tpu_torch.pipeline import run_davis
from premvos_tpu_torch.pipeline import runner as tr
from premvos_tpu_torch.train import train_flow, train_maskrcnn, train_refine, train_reid
from premvos_tpu_torch.utils.checkpoint import NETS, load_params, save_net, save_params
from tests._jax_block_warp import jax_tpu_block_warp  # noqa: F401 (autouse)
from tests.test_pipeline import TINY
from tests._threads import few_threads  # noqa: F401

DATA = os.path.join(os.path.dirname(__file__), "data", "orbax")


def tiny_cfg(**pipeline):
    cfg = tc._from_dict(tc.PremvosConfig, dataclasses.asdict(TINY))
    return dataclasses.replace(cfg, pipeline=dataclasses.replace(cfg.pipeline, **pipeline))


@pytest.fixture(scope="module")
def models():
    return load_params(os.path.join(DATA, "tiny_f32"), tr.build_models(tiny_cfg(), device="cpu"))


# The TINY bundle is 345 MB uncompressed, and the suite runs several
# workers on one disk: each bundle and net is written once for the module
# and removed after it.
@pytest.fixture(scope="module")
def written(models, tmp_path_factory):
    """The bundle (save_params) and each net alone (save_net) as the port
    writes them: {"bundle": path, net: path}."""
    root = tmp_path_factory.mktemp("written")
    paths = {"bundle": root / "bundle"}
    save_params(paths["bundle"], models)
    for net in NETS:
        paths[net] = root / net
        save_net(paths[net], getattr(models, net))
    yield paths
    shutil.rmtree(root)


class Small(torch.nn.Module):
    """A net of the port's layer types, a few kB: what the trainers' --out
    wiring is tested on."""

    def __init__(self, seed=0):
        super().__init__()
        self.Conv_0 = Conv(3, 4, 3)
        self.head = Dense(4, 2)
        gen = torch.Generator().manual_seed(seed)
        with torch.no_grad():
            for p in self.parameters():
                p.copy_(torch.randn(p.shape, generator=gen))


def leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from leaves(v, (*prefix, k))
        else:
            yield (*prefix, k), v


def as_bytes(value):
    if isinstance(value, torch.Tensor):
        return str(value.dtype).removeprefix("torch."), tuple(value.shape), \
            value.contiguous().view(torch.int16).numpy().tobytes()
    a = np.ascontiguousarray(np.asarray(value))
    return str(a.dtype), a.shape, a.tobytes()


def assert_same_tree(got, want):
    got, want = dict(leaves(got)), dict(leaves(want))
    assert got.keys() == want.keys()
    for path, value in want.items():
        assert as_bytes(got[path]) == as_bytes(value), path


@functools.lru_cache(maxsize=None)
def jax_shapes(dtype="float32"):
    """The JAX package's init_params tree at the TINY config with
    pipeline.dtype `dtype`, as zeros of its shapes and dtypes
    (jax.eval_shape: no init is run; traced once a dtype)."""
    jcfg = jc._from_dict(jc.PremvosConfig, dataclasses.asdict(tiny_cfg(dtype=dtype)))
    shapes = jax.eval_shape(functools.partial(jr.init_params, jr.build_models(jcfg), jcfg),
                            jax.random.PRNGKey(0))
    return jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes)


@pytest.mark.parametrize("like", (False, True), ids=("plain", "like"))
def test_jax_restores_the_port_written_bundle(models, written, like):
    """save_params to a directory: orbax's restore (the JAX load_params)
    gives every net's flax tree, leaf for leaf equal to bridge.flax_tree of
    the port's modules; with like= the JAX init_params tree's shapes."""
    path = written["bundle"]
    assert is_orbax_dir(path)
    restored = orbax_load(path, like=jax_shapes() if like else None)
    assert_same_tree(jax.tree.map(np.asarray, restored),
                     {net: bridge.flax_tree(getattr(models, net)) for net in NETS})


@pytest.mark.parametrize("like", (False, True), ids=("plain", "like"))
@pytest.mark.parametrize("net", NETS)
def test_jax_restores_one_nets_out(models, written, net, like):
    """save_net (a trainer's --out) to a directory: {"params": ...}, as
    the JAX trainers' --out writes it, restored bit for bit."""
    path = written[net]
    like_tree = jax_shapes()[net] if like else None
    restored = jax.tree.map(np.asarray, orbax_load(path, like=like_tree))
    assert_same_tree(restored, bridge.flax_tree(getattr(models, net)))
    # and the port reads its own --out back into the module
    assert_same_tree(read_orbax(path), bridge.flax_tree(getattr(models, net)))


def test_leaves_keep_the_jax_packages_dtypes_at_a_bf16_config():
    """At pipeline.dtype bfloat16 the JAX package's init_params holds
    float32 parameters, and so do the port's modules and their trees."""
    want = {p: (v.dtype, v.shape) for p, v in leaves(jax_shapes("bfloat16"))}
    ported = tr.build_models(tiny_cfg(dtype="bfloat16"), device="cpu")
    got = {(net, *p): (v.dtype, v.shape)
           for net in NETS for p, v in leaves(bridge.flax_tree(getattr(ported, net)))}
    assert got == want
    assert {d for d, _ in want.values()} == {np.dtype(np.float32)}


@pytest.mark.parametrize("name", ("dtypes", "sharded"))
def test_every_dtype_round_trips(name, tmp_path):
    """The fixtures' trees (float32, float16, float64, int32, int64, uint8,
    bool, bfloat16, a 0-d array; an array orbax wrote in four chunks)
    written by the port: orbax restores them as it restores the originals,
    and the port reads them back."""
    write_orbax(tmp_path / "c", read_orbax(os.path.join(DATA, name)))
    want = jax.tree.map(np.asarray, orbax_load(os.path.join(DATA, name)))
    assert_same_tree(jax.tree.map(np.asarray, orbax_load(tmp_path / "c")), want)
    assert_same_tree(read_orbax(tmp_path / "c"), read_orbax(os.path.join(DATA, name)))


def test_pt_paths_keep_torch_save(tmp_path):
    """A path ending in .pt is a torch.save file, as before
    (tests/test_torch_cli.py round-trips save_params' .pt file)."""
    net = Small()
    save_net(tmp_path / "net.pt", net)
    got = torch.load(tmp_path / "net.pt", weights_only=True)
    assert got.keys() == net.state_dict().keys()
    assert all(torch.equal(got[k], v) for k, v in net.state_dict().items())
    assert not is_orbax_dir(tmp_path / "net.pt")


def test_a_write_that_fails_leaves_no_checkpoint(models, tmp_path, monkeypatch):
    """A writer made to fail after some leaves: nothing at the path that
    is_orbax_dir accepts, no temporary directory left beside it; over an
    existing checkpoint, that checkpoint stays whole. Then a good write
    replaces it, as save(..., force=True) does."""
    written, real = [], orbax_write._write_leaf

    def failing(root, keys, value):
        if len(written) == 20:
            raise OSError("disk full")
        written.append(keys)
        return real(root, keys, value)

    monkeypatch.setattr(orbax_write, "_write_leaf", failing)
    with pytest.raises(OSError, match="disk full"):
        save_params(tmp_path / "new", models)
    assert not (tmp_path / "new").exists() and not is_orbax_dir(tmp_path / "new")
    assert os.listdir(tmp_path) == []

    old = tmp_path / "old"
    monkeypatch.setattr(orbax_write, "_write_leaf", real)
    save_net(old, Small(seed=1))
    before = read_orbax(old)
    written.clear()
    monkeypatch.setattr(orbax_write, "_write_leaf", failing)
    with pytest.raises(OSError, match="disk full"):
        save_params(old, models)
    assert sorted(os.listdir(tmp_path)) == ["old"]
    assert_same_tree(read_orbax(old), before)
    monkeypatch.undo()
    save_net(old, Small(seed=2))
    assert_same_tree(read_orbax(old), bridge.flax_tree(Small(seed=2)))
    assert sorted(os.listdir(tmp_path)) == ["old"]


# (module, its train function, the dataset class its main builds, argv)
CLIS = {
    "maskrcnn": (train_maskrcnn, "train_maskrcnn", "DavisDataset", ["--davis_root", "x"]),
    "refine": (train_refine, "train_refine", "DavisDataset", ["--davis_root", "x"]),
    "flow": (train_flow, "train_flownet_c", "FlowPairDataset", ["--data", "x"]),
    "reid": (train_reid, "train_reid", "InstanceCropDataset",
             ["--images", "x", "--annotations", "y"]),
}


@pytest.mark.parametrize("net", NETS)
def test_trainer_out_writes_what_jax_restores(net, tmp_path, monkeypatch):
    """Each trainer's main(argv) with --out: a directory gets the orbax
    tree the JAX trainer's --out writes, a .pt path the state_dict. The
    training itself is replaced by a small net of the port's layers (the
    trainers are held against JAX in their own tests, and the nets' trees
    in test_jax_restores_one_nets_out)."""
    module, fn, dataset, argv = CLIS[net]
    model = Small(seed=len(net))
    monkeypatch.setattr(module, fn, lambda *a, **k: (model, 0.5))
    monkeypatch.setattr(module, dataset, lambda *a, **k: None)
    module.main(argv + ["--device", "cpu", "--out", str(tmp_path / "out")])
    restored = jax.tree.map(np.asarray, orbax_load(tmp_path / "out"))
    assert_same_tree(restored, bridge.flax_tree(model))
    module.main(argv + ["--device", "cpu", "--out", str(tmp_path / "out.pt")])
    got = torch.load(tmp_path / "out.pt", weights_only=True)
    assert got.keys() == model.state_dict().keys()
    assert all(torch.equal(got[k], v) for k, v in model.state_dict().items())


def test_jax_run_davis_on_a_port_written_bundle(written, tmp_path, monkeypatch):
    """The slice as a whole: the port writes the bundle (save_params to a
    directory), and the JAX package's run_davis --checkpoint on it tracks
    as the port's run_davis --checkpoint does (TINY config, 3 frames of
    64×64: labels agree on ≥ 99 % of pixels, frame 0 the annotation; the
    tolerance of tests/test_torch_orbax.py's CLI test). The JAX CLI's
    random init only shapes its like= tree, so it is replaced by its
    shapes."""
    bundle = written["bundle"]
    root = make_synthetic_davis(tmp_path / "davis", t=3, hw=(64, 64))
    cfg = tmp_path / "tiny.json"
    jc.save_config(cfg, TINY)
    monkeypatch.setattr(jrun_davis, "init_params", lambda m, c, k: jax.eval_shape(
        functools.partial(jr.init_params, m, c), k))
    common = ["--davis_root", str(root), "--config", str(cfg), "--checkpoint", str(bundle)]
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
