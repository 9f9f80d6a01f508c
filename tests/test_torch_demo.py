"""The trained-accuracy demonstration in the port (eval/synthetic_demo.py)
against scripts/train_synthetic_demo.py, on the CPU.

`SyntheticObjectCrops` is held against the JAX class on one synthetic
DAVIS tree (the two packages write the same files). The demo runs through
`main(argv)` at 2 steps a net and saves its nets as an orbax directory;
the JAX script's `main(["--load-params", ...])` restores that directory
and tracks with it, and its J&F and `[diag]` lines must be the port's
`--load-params` ones.

Two steps leave the nets at random weights, where two things decide by
float rounding rather than by the nets (`pin_for_parity` sets them, the
same way in both packages since both read the same checkpoint):
- the RPN's and the box head's delta layers push every box into one
  zero-area corner box (ROADMAP's trap; tests/test_torch_cli.py zeroes
  them too), so they are zeroed and the proposals are clipped anchors;
- the untrained box classifier scores every RoI near 1e-7 and the
  refinement net's masks stay below 0.5, so no proposal would pass the
  score threshold nor label a pixel, and a J&F of 0 would hold nothing:
  the classifier is scaled to 1 % with a +2 object bias, the refinement
  classifier to 10 % with a +1 object bias.
FlowNetC's rough random flow (up to 16 px) stays: both packages warp it
with the block warp at the TPU kernel's blocks (tests/_jax_block_warp.py
pins the JAX side to them).
"""

import contextlib
import io
import json
import sys
from pathlib import Path

import numpy as np
import pytest

from premvos_tpu.data.davis import DavisDataset as JaxDavisDataset
from premvos_tpu.data.davis import make_synthetic_davis as jax_make_synthetic_davis
from premvos_tpu_torch import bridge
from premvos_tpu_torch.data.davis import DavisDataset, make_synthetic_davis
from premvos_tpu_torch.eval import synthetic_demo as tdemo
from premvos_tpu_torch.eval.synthetic_benchmark import demo_config
from premvos_tpu_torch.pipeline.runner import build_models
from premvos_tpu_torch.utils.checkpoint import load_params, save_params
from tests._jax_block_warp import jax_tpu_block_warp  # noqa: F401 (autouse)

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "scripts"))
import train_synthetic_demo as jdemo  # noqa: E402
from tests._threads import few_threads  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
STEPS = ["--steps-det", "2", "--steps-refine", "2", "--steps-reid", "2", "--steps-flow", "2"]


def pin_for_parity(models):
    """Set the layers that decide by float rounding at random weights (see
    the module docstring), in place, through the flax trees both packages
    read. Returns models."""
    tree = bridge.flax_tree(models.maskrcnn)
    heads = tree["params"]
    for head, layer in (("rpn", "Conv_2"), ("box_head", "Dense_3")):
        heads[head][layer] = {k: np.zeros_like(v) for k, v in heads[head][layer].items()}
    cls = heads["box_head"]["Dense_2"]
    heads["box_head"]["Dense_2"] = {"kernel": cls["kernel"] * np.float32(0.01),
                                    "bias": np.array([0.0, 2.0], np.float32)}
    bridge.load_flax_tree(models.maskrcnn, tree)
    tree = bridge.flax_tree(models.refine)
    cls = tree["params"]["cls"]
    tree["params"]["cls"] = {"kernel": cls["kernel"] * np.float32(0.1),
                             "bias": np.array([0.0, 1.0], np.float32)}
    bridge.load_flax_tree(models.refine, tree)
    return models


def _captured(fn, *args):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*args)
    return out, [line for line in buf.getvalue().splitlines() if line.startswith("[diag]")]


@pytest.fixture(scope="module")
def demo(tmp_path_factory):
    """The port's demo at 2 steps a net (its record and orbax directory),
    the directory pinned (pin_for_parity) and written again, and both
    packages' --load-params --diagnose runs on that one."""
    d = tmp_path_factory.mktemp("demo")
    record = tdemo.main(["--device", "cpu", *STEPS, "--threshold", "0",
                         "--save-params", str(d / "trained"), "--out", str(d / "record.json")])
    pinned = pin_for_parity(load_params(d / "trained", build_models(demo_config(), "cpu")))
    save_params(d / "pinned", pinned)
    args = ["--load-params", str(d / "pinned"), "--threshold", "0", "--diagnose"]
    port, port_lines = _captured(tdemo.main, ["--device", "cpu", "--out", str(d / "port.json"),
                                              *args])
    _, jax_lines = _captured(jdemo.main, ["--cpu", "--out", str(d / "jax.json"), *args])
    return dict(d=d, record=record, port=port, port_lines=port_lines,
                jax=json.loads((d / "jax.json").read_text()), jax_lines=jax_lines)


def test_object_crops_match_jax(tmp_path):
    """by_id within 1e-5 (crops in [0, 1]; OpenCV's INTER_LINEAR against
    resize_linear) and pk_batch from equal seeds: the same ids and crops."""
    root = jax_make_synthetic_davis(tmp_path / "tree", sequences=("demo", "b"), t=10,
                                    hw=(64, 96), num_objects=2)
    want = jdemo.SyntheticObjectCrops(JaxDavisDataset(root), 32, 2)
    got = tdemo.SyntheticObjectCrops(DavisDataset(root), 32, 2)
    assert got.ids == want.ids == [0, 1]
    for k in want.ids:
        assert len(got.by_id[k]) == len(want.by_id[k]) == 20
        for a, b in zip(got.by_id[k], want.by_id[k]):
            assert a.shape == b.shape == (32, 32, 3) and a.dtype == np.float32
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-5)
    ra, rb = np.random.default_rng(4), np.random.default_rng(4)
    for p, k in ((2, 4), (1, 3), (5, 2)):
        (gc, gi), (wc, wi) = got.pk_batch(rb, p, k), want.pk_batch(ra, p, k)
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_allclose(gc, wc, rtol=0, atol=1e-5)
    assert ra.uniform() == rb.uniform()


def test_demo_main_record_and_jax_restores_its_checkpoint(demo):
    """The record's keys are the JAX record's (docs/SYNTHETIC_ACCURACY.json)
    and the card's and seconds; the JAX script, on the port-written orbax
    directory, scores the port's J&F (a J&F above 0: labels were made)."""
    want = json.loads((REPO / "docs" / "SYNTHETIC_ACCURACY.json").read_text())
    record = demo["record"]
    assert set(record) == set(want) | {"card", "seconds"}
    assert json.loads((demo["d"] / "record.json").read_text()) == json.loads(json.dumps(record))
    assert record["config"] == want["config"] and record["card"] == {"name": "cpu",
                                                                     "power_limit": None}
    assert {"det", "refine", "reid", "flow", "eval", "total"} == set(record["seconds"])
    assert 0.0 <= record["J&F"] <= 1.0 and record["passed"] and record["threshold"] == 0.0
    jax, port = demo["jax"], demo["port"]
    assert set(jax) == set(want)
    assert port["J&F"] > 0.0
    for key in ("J", "F", "J&F"):
        assert port[key] == pytest.approx(jax[key], abs=1e-12), key
    assert "det" not in port["seconds"]  # loaded, not trained


def test_diagnose_lines_match_jax(demo):
    """The port's [diag] lines equal the JAX script's character for
    character, with valid proposals on every frame, and `diagnose`
    returns what it prints."""
    lines = demo["port_lines"]
    assert lines == demo["jax_lines"]
    assert len(lines) == 9 and all("n_valid=0 " not in ln for ln in lines)
    cfg = demo_config()
    models = load_params(demo["d"] / "pinned", build_models(cfg, "cpu"))
    root = make_synthetic_davis(demo["d"] / "tree", sequences=("demo",), t=10, hw=(64, 96),
                                num_objects=2)
    seq = DavisDataset(root).load_sequence("demo", 64, 96, 2)
    returned, printed = _captured(tdemo.diagnose, cfg, models, seq, "cpu")
    assert returned == printed == lines


def test_diagnose_main_on_the_cpu(demo):
    """The selection-loss diagnosis through main(argv) with --device cpu on
    a 6-frame DAVIS-layout tree and the pinned demo checkpoint (bench_config
    with 4 proposals builds the demo's nets): the report's keys, counts
    that add up, the JSON file."""
    from premvos_tpu_torch.eval import diagnose

    root = make_synthetic_davis(demo["d"] / "diag_tree", sequences=("a",), t=6, hw=(64, 96))
    out = demo["d"] / "diagnosis.json"
    report = diagnose.main(["--load-params", str(demo["d"] / "pinned"), "--data-root", str(root),
                            "--max-proposals", "4", "--device", "cpu", "--out", str(out)])
    assert json.loads(out.read_text()) == report
    assert set(report) == {"weights", "counts", "selection_error_term_blame", "events"}
    counts = report["counts"]
    assert counts["frames_objects"] == sum(counts[c] for c in diagnose.CLASSES) > 0
    assert sum(report["selection_error_term_blame"].values()) == counts["selection_error"]
