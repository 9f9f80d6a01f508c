"""Package rules of the PyTorch port: it imports neither JAX nor the JAX
package, its entry points refuse to fall back to the CPU silently, and the
weight bridge rejects trees that do not fit."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_port_imports_no_jax():
    """Import every module of premvos_tpu_torch (and chip_smoke.py) in a
    fresh interpreter: no jax* and no premvos_tpu(.*) may be loaded, and no
    PIL (the card's machine has no Pillow; the image readers import it
    inside their functions)."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import premvos_tpu_torch\n"
        "for m in pkgutil.walk_packages(premvos_tpu_torch.__path__, 'premvos_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = sorted(n for n in sys.modules if n == 'jax' or n.startswith('jax.')\n"
        "             or n.startswith('jaxlib') or n == 'premvos_tpu'\n"
        "             or n.startswith('premvos_tpu.') or n == 'PIL'\n"
        "             or n.startswith('PIL.'))\n"
        "n = sum(1 for m in sys.modules if m.startswith('premvos_tpu_torch'))\n"
        "print(n, bad)\n"
        "sys.exit(1 if bad or n < 20 else 0)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    env["PYTHONPATH"] = REPO
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.mark.parametrize("entry", ["build_models", "init_params", "run_sequence"])
def test_entry_points_need_cuda_or_explicit_cpu(entry, monkeypatch):
    from premvos_tpu_torch.config import PremvosConfig
    from premvos_tpu_torch.pipeline import runner

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = PremvosConfig()
    args = {
        "build_models": (cfg,),
        "init_params": (None, cfg),
        "run_sequence": (None, cfg, np.zeros((1, 8, 8, 3), np.uint8),
                         np.zeros((1, 8, 8), np.float32), 1),
    }[entry]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        getattr(runner, entry)(*args)


def test_cpu_tensors_take_the_plain_versions():
    """On CPU tensors the kernel wrappers are never reached."""
    from premvos_tpu_torch.ops import correlation, nms, resample2d, roi_align

    def counts():
        return (nms.nms_cuda.launches, correlation.correlation_cuda.launches,
                resample2d.resample2d_cuda.launches,
                roi_align.multilevel_roi_align_cuda.launches,
                roi_align.roi_align_cuda.launches,
                roi_align.roi_align_backward_cuda.launches)

    before = counts()
    boxes = torch.tensor([[[0.0, 0.0, 4.0, 4.0], [1.0, 1.0, 5.0, 5.0]]])
    nms.nms(boxes, torch.tensor([[0.9, 0.8]]), 2)
    f = torch.zeros(1, 4, 6, 6)
    correlation.correlation(f, f, 2, 1)
    resample2d.resample2d(f, torch.zeros(1, 2, 6, 6))
    roi_align.multilevel_roi_align(
        [torch.zeros(1, 8, 8, 4)] * 4, boxes, torch.full((1, 2), 2)
    )
    feats = [torch.zeros(1, 8, 8, 4, requires_grad=True) for _ in range(4)]
    roi_align.roi_align_levels(feats, boxes, torch.full((1, 2), 3)).sum().backward()
    roi_align.roi_align(feats[0], boxes).sum().backward()
    assert counts() == before


def test_kernel_wrappers_reject_cpu_tensors():
    """A wrapper called on CPU tensors raises instead of running anything."""
    from premvos_tpu_torch.ops.resample2d import resample2d_cuda

    with pytest.raises(ValueError, match="CUDA"):
        resample2d_cuda(torch.zeros(1, 1, 4, 4), torch.zeros(1, 2, 4, 4))


def test_kernel_header_matches_the_sources():
    """The ctypes argument types come from premvos_kernels.h; every exported
    definition in the .cu sources has the header's parameter types, in its
    order (nvcc also refuses a mismatch, on the card)."""
    import ctypes
    import re

    from premvos_tpu_torch import kernels

    sigs = kernels.signatures()
    kdir = os.path.dirname(kernels.__file__)
    defined = {}
    for src in kernels.SOURCES:
        with open(os.path.join(kdir, src)) as f:
            text = f.read()
        for name, params in re.findall(
            r'extern "C" int (premvos_\w+)\(([^)]*)\)\s*\{', text
        ):
            defined[name] = [" ".join(p.split()[:-1]) for p in params.split(",")]
    with open(os.path.join(kdir, kernels.HEADER)) as f:
        header = re.sub(r"//[^\n]*", "", f.read())
    declared = {
        name: [" ".join(p.split()[:-1]) for p in params.split(",")]
        for name, params in re.findall(r"\bint\s+(premvos_\w+)\s*\(([^)]*)\)\s*;", header)
    }
    assert set(sigs) == set(defined) == set(declared) == {
        "premvos_nms", "premvos_multilevel_roi_align", "premvos_roi_align",
        "premvos_roi_align_backward", "premvos_correlation", "premvos_resample2d",
    }
    for name, types in declared.items():
        assert defined[name] == types, name
        assert len(sigs[name]) == len(types), name
        assert types[-1] == "cudaStream_t" and sigs[name][-1] is ctypes.c_void_p
        for t, ct in zip(types, sigs[name]):
            assert (ct is ctypes.c_void_p) == ("*" in t or t == "cudaStream_t"), (name, t)


def test_launch_checks_arguments_and_errors(monkeypatch):
    """kernels.launch refuses a wrong argument count (ctypes would pass the
    extra ones on) and raises on a refused launch."""
    from premvos_tpu_torch import kernels

    calls = []

    def fn(*args):
        calls.append(args)
        return 0 if args[0] else 9

    monkeypatch.setattr(kernels, "_FNS", {"x": (fn, 2)})
    kernels.launch("x", 1, 0)
    with pytest.raises(TypeError, match="takes 2 arguments, got 3"):
        kernels.launch("x", 1, 0, 0)
    with pytest.raises(RuntimeError, match="error 9"):
        kernels.launch("x", 0, 0)
    assert calls == [(1, 0), (0, 0)]


def test_load_binds_every_function_once(monkeypatch):
    """load() opens the library once and binds every function of the header
    with its ctypes types and argument count; a launch then goes straight
    to the bound function, without loading again."""
    import ctypes
    import types

    from premvos_tpu_torch import kernels

    opened = []

    def cdll(path):
        opened.append(path)
        return types.SimpleNamespace(**{
            name: types.SimpleNamespace(argtypes=None, restype=None)
            for name in kernels.signatures()
        })

    monkeypatch.setattr(kernels, "build", lambda: "libfake.so")
    monkeypatch.setattr(kernels.ctypes, "CDLL", cdll)
    monkeypatch.setattr(kernels, "_lib", None)
    monkeypatch.setattr(kernels, "_FNS", {})
    lib = kernels.load()
    assert kernels.load() is lib and opened == ["libfake.so"]
    sigs = kernels.signatures()
    assert set(kernels._FNS) == {n[len("premvos_"):] for n in sigs}
    for short, (fn, nargs) in kernels._FNS.items():
        assert fn is getattr(lib, "premvos_" + short)
        assert fn.argtypes == sigs["premvos_" + short] and nargs == len(fn.argtypes)
        assert fn.restype is ctypes.c_int
    monkeypatch.setattr(kernels, "load", lambda: pytest.fail("loaded again"))
    kernels._FNS["correlation"] = (lambda *a: 0, 11)
    kernels.launch("correlation", *range(11))


def test_float32_precision_turns_tf32_off_and_restores():
    """The runner's float32 work runs without TF32 whatever the caller set,
    and the caller's settings come back (also after an error)."""
    from premvos_tpu_torch.pipeline.runner import float32_precision

    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    prev = (cudnn.allow_tf32, matmul.allow_tf32)
    try:
        cudnn.allow_tf32 = matmul.allow_tf32 = True
        with float32_precision():
            assert (cudnn.allow_tf32, matmul.allow_tf32) == (False, False)
        assert (cudnn.allow_tf32, matmul.allow_tf32) == (True, True)
        with pytest.raises(ZeroDivisionError), float32_precision():
            1 / 0
        assert (cudnn.allow_tf32, matmul.allow_tf32) == (True, True)
    finally:
        cudnn.allow_tf32, matmul.allow_tf32 = prev


def _bad_corr():
    from premvos_tpu_torch.ops.correlation import correlation_cuda

    correlation_cuda(torch.zeros(1, 4, 6, 6), torch.zeros(1, 4, 6, 8))


def _bad_roi_levels():
    from premvos_tpu_torch.ops.roi_align import multilevel_roi_align_cuda

    feats = [torch.zeros(1, 8, 8, 4)] * 3 + [torch.zeros(1, 8, 8, 5)]
    multilevel_roi_align_cuda(feats, torch.zeros(1, 2, 4), torch.full((1, 2), 2))


def _bad_roi_boxes():
    from premvos_tpu_torch.ops.roi_align import multilevel_roi_align_cuda

    feats = [torch.zeros(1, 8, 8, 4)] * 4
    multilevel_roi_align_cuda(feats, torch.zeros(1, 2, 4), torch.full((1, 3), 2))


def _bad_single_boxes():
    from premvos_tpu_torch.ops.roi_align import roi_align_cuda

    roi_align_cuda(torch.zeros(2, 8, 8, 4), torch.zeros(1, 3, 4))


def _bad_single_levels():
    from premvos_tpu_torch.ops.roi_align import roi_align_cuda

    roi_align_cuda(torch.zeros(1, 8, 8, 4), torch.zeros(1, 3, 4),
                   levels=torch.full((1, 2), 2), level=2, out=torch.zeros(1, 3, 7, 7, 4))


def _bad_backward_boxes():
    from premvos_tpu_torch.ops.roi_align import roi_align_backward_cuda

    roi_align_backward_cuda(torch.zeros(1, 3, 7, 7, 4), torch.zeros(1, 2, 4), (8, 8))


@pytest.mark.parametrize("call", [
    _bad_corr, _bad_roi_levels, _bad_roi_boxes, _bad_single_boxes,
    _bad_single_levels, _bad_backward_boxes,
])
def test_kernel_wrappers_reject_bad_shapes(call):
    """Shapes the kernels cannot take are refused before any pointer is
    passed (they would read out of bounds)."""
    with pytest.raises(ValueError, match="must be one|need 4 levels|boxes"):
        call()


def test_unported_norm_is_refused():
    from premvos_tpu_torch.config import ReIDConfig
    from premvos_tpu_torch.models.reid import ReIDNet

    with pytest.raises(NotImplementedError, match="group_norm"):
        ReIDNet(ReIDConfig(backbone_depth=26, norm="group_norm"))


def test_bridge_rejects_mismatched_trees():
    from premvos_tpu_torch.bridge import load_flax_tree
    from premvos_tpu_torch.models.reid import ReIDNet
    from premvos_tpu_torch.config import ReIDConfig

    net = ReIDNet(ReIDConfig(backbone_depth=26, embedding_dim=8))
    with pytest.raises(KeyError):
        load_flax_tree(net, {"params": {}})
    tree = {
        name: (
            {"kernel": np.zeros((3, 3), np.float32), "bias": np.zeros(3, np.float32)}
        )
        for name in ("fc1", "emb")
    }
    with pytest.raises((KeyError, ValueError)):
        load_flax_tree(net, {"params": tree})


def test_random_init_ignores_memory_format():
    """Seeded init gives the same weights to a channels-last module (as on
    CUDA) and a contiguous one (as on the CPU)."""
    from premvos_tpu_torch.models.layers import init_module
    from premvos_tpu_torch.models.reid import ReIDNet
    from premvos_tpu_torch.config import ReIDConfig

    cfg = ReIDConfig(backbone_depth=26, embedding_dim=8)
    a = ReIDNet(cfg)
    b = ReIDNet(cfg).to(memory_format=torch.channels_last)
    init_module(a, torch.Generator().manual_seed(3))
    init_module(b, torch.Generator().manual_seed(3))
    for (name, pa), pb in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(pa, pb), name
    assert b.backbone.stem_conv.weight.is_contiguous(memory_format=torch.channels_last)


def test_bridge_rejects_unconsumed_leaves():
    from premvos_tpu_torch.bridge import load_flax_tree
    from premvos_tpu_torch.models.layers import Dense

    net = torch.nn.Module()
    net.fc = Dense(3, 2)
    ok = {"fc": {"kernel": np.ones((3, 2), np.float32), "bias": np.zeros(2, np.float32)}}
    load_flax_tree(net, {"params": ok})
    assert torch.equal(net.fc.weight, torch.ones(2, 3))
    with pytest.raises(ValueError, match="not consumed"):
        load_flax_tree(net, {"params": {**ok, "extra": {"kernel": np.ones(1, np.float32)}}})
