"""The port's counterparts of three JAX scripts on the CPU:
scripts/check_tpu_consistency_torch.py, scripts/probe_merge_knobs_torch.py
and scripts/reid_sphere_ab_torch.py.

- The merge-knob probe: each candidate's J&F over one hand-made
  precompute (tests/test_torch_diagnose.py's, two sequences) against the
  JAX package's `evaluate_weights` on the same precompute, within 1e-9
  (as tests/test_torch_synthetic.py holds the search), and the oracle's.
  The JAX block warp is the TPU kernel's (tests/_jax_block_warp.py).
- The ReID A/B: `retrieval` on bridged ReID weights (drawn in numpy) over
  a small synthetic val split against the JAX script's own computation
  (its `retrieval`, which runs at import and so is written out here with
  the JAX package's functions), top-1 and both margins within 1e-5; then
  `main` at 2 steps an arm, whose losses must be finite.
- The consistency check: without a card it exits non-zero before running
  anything; its `check` on the CPU against the CPU agrees on every pixel.
- None of the three imports JAX or the JAX package.
"""

import dataclasses
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import premvos_tpu.config as jc
from premvos_tpu.data.davis import DavisDataset as JaxDavisDataset
from premvos_tpu.data.preprocess import IMAGENET_MEAN, IMAGENET_STD
from premvos_tpu.eval import harness as jharness
from premvos_tpu.models.reid import ReIDNet as JaxReIDNet
from premvos_tpu.stages.reid import reid_similarity as jax_reid_similarity
from premvos_tpu.stages.reid import run_reid as jax_run_reid
from premvos_tpu_torch.bridge import flax_tree, load_flax_tree
from premvos_tpu_torch.data.davis import DavisDataset
from premvos_tpu_torch.data.synthetic_vos import make_synthetic_vos
from premvos_tpu_torch.eval.synthetic_benchmark import bench_config, oracle_jf
from premvos_tpu_torch.models.reid import ReIDNet
from tests._jax_block_warp import jax_tpu_block_warp  # noqa: F401 (autouse)
from tests._threads import few_threads  # noqa: F401
from tests.test_torch_diagnose import hand_precompute, port_entry
from tests.test_torch_flow_variants import _draw

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "scripts"))
import check_tpu_consistency_torch as consistency  # noqa: E402
import probe_merge_knobs_torch as probe  # noqa: E402
import reid_sphere_ab_torch as ab  # noqa: E402
import run_synthetic_benchmark as jbench  # noqa: E402


def test_probe_candidates_match_jax():
    """Every candidate's J&F, and the oracle's, against the JAX package's
    on the same two hand-made sequences, within 1e-9."""
    jax_pre, port_pre = [], []
    for seed in (0, 1):
        pre, gt, k, labels = hand_precompute(seed)
        jax_pre.append(({key: jnp.asarray(v) for key, v in pre.items()}, jnp.asarray(gt), k,
                        labels))
        port_pre.append((*port_entry(pre, gt), k, labels))
    got = probe.probe(port_pre)
    assert list(got) == list(probe.CANDIDATES)
    for name, w in probe.CANDIDATES.items():
        want, _ = jharness.evaluate_weights(jax_pre, np.asarray(w, np.float32), 1)
        assert got[name] == pytest.approx(float(want), abs=1e-9), name
    assert len(set(got.values())) > 1, got
    assert oracle_jf(port_pre) == pytest.approx(jbench.oracle_jf(jax_pre), abs=1e-9)


@pytest.fixture(scope="module")
def vos_root(tmp_path_factory):
    """A small benchmark world: two train sequences and one val sequence
    of 24 frames (the A/B samples frames up to 23) at 64×96."""
    return make_synthetic_vos(tmp_path_factory.mktemp("vos"), n_train=2, n_tune=0, n_val=1,
                              t=24, hw=(64, 96), flow_pairs=False)


def _jax_retrieval(model, params, ds_val, cfg):
    """scripts/reid_sphere_ab.py's `retrieval`, line for line."""
    rcfg = cfg.reid
    hits = tot = 0
    margins = []
    for seq in ds_val.sequences:
        d = ds_val.load_sequence(seq, 128, 192, cfg.pipeline.max_objects)

        def embed(fidx):
            img = (np.asarray(d["frames"][fidx], np.float32) / 255.0 - IMAGENET_MEAN) / IMAGENET_STD
            lab = np.asarray(d["gt_labels"][fidx])
            bs, vs = [], []
            for k2 in (1, 2):
                ys, xs = np.nonzero(lab == k2)
                if len(ys) == 0:
                    bs.append([0, 0, 1, 1])
                    vs.append(False)
                    continue
                bs.append([xs.min(), ys.min(), xs.max() + 1, ys.max() + 1])
                vs.append(True)
            b = np.pad(np.asarray(bs, np.float32), ((0, 6), (0, 0)))
            v = np.asarray(vs + [False] * 6)
            e = np.asarray(jax_run_reid(model, params, jnp.asarray(img), jnp.asarray(b),
                                        jnp.asarray(v), rcfg.crop_size))
            return e[:2], np.asarray(vs)

        ref, vref = embed(0)
        for t in range(2, 24, 3):
            et, vt = embed(t)
            if not (vref.all() and vt.all()):
                continue
            sim = np.asarray(jax_reid_similarity(jnp.asarray(ref), jnp.asarray(et), 1.0))
            for k2 in range(2):
                tot += 1
                if sim[k2].argmax() == k2:
                    hits += 1
                margins.append(sim[k2, k2] - sim[k2, 1 - k2])
    return hits / max(tot, 1), float(np.mean(margins)), float(np.min(margins))


@pytest.mark.parametrize("l2", [False, True], ids=["raw", "l2norm"])
def test_ab_retrieval_matches_jax(vos_root, l2):
    """The A/B's retrieval on the same bridged weights in both packages:
    top-1 and the mean and least margins within 1e-5, over at least one
    scored pair."""
    cfg = bench_config(canvas=ab.CANVAS)
    cfg = dataclasses.replace(cfg, reid=dataclasses.replace(cfg.reid, l2_normalize=l2))
    model = ReIDNet(cfg.reid)
    rng = np.random.default_rng(4)
    tree = jax.tree_util.tree_map_with_path(lambda p, x: _draw(rng, p, x), flax_tree(model))
    load_flax_tree(model, tree)
    model.eval()
    got = ab.retrieval(model, DavisDataset(vos_root, split="val"), cfg, torch.device("cpu"))
    jcfg = jc.PremvosConfig(
        reid=jc.ReIDConfig(**dataclasses.asdict(cfg.reid)),
        pipeline=jc.PipelineConfig(**dataclasses.asdict(cfg.pipeline)))
    want = _jax_retrieval(JaxReIDNet(cfg=jcfg.reid), tree, JaxDavisDataset(vos_root, split="val"),
                          jcfg)
    assert np.isfinite(want[1])
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_ab_main_two_steps_an_arm(vos_root, capsys):
    """`main` at 2 steps an arm on the CPU: both arms train to finite
    losses and score retrieval."""
    out = ab.main(["--data_root", str(vos_root), "--steps", "2", "--device", "cpu"])
    assert list(out) == ["raw", "l2norm"]
    for arm in out.values():
        assert np.isfinite(arm["loss"]) and 0.0 <= arm["top1"] <= 1.0
        assert np.isfinite(arm["margin_mean"]) and np.isfinite(arm["margin_min"])
    assert "identities:" in capsys.readouterr().out


def test_scripts_refuse_without_a_card(monkeypatch, capsys, tmp_path):
    """Without a card the consistency check exits non-zero with a message
    and runs nothing (the JAX script's SKIP and exit 0 would hide the
    device); the probe and the A/B raise unless given --device cpu."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ran = []
    monkeypatch.setattr(consistency, "check", lambda *a, **k: ran.append(a))
    assert consistency.main([]) != 0
    assert not ran and "no CUDA device" in capsys.readouterr().err
    with pytest.raises(RuntimeError, match="CUDA"):
        probe.main(["--checkpoint", str(tmp_path / "none.pt"), "--data_root", str(tmp_path)])
    with pytest.raises(RuntimeError, match="CUDA"):
        ab.main(["--data_root", str(tmp_path)])


def test_consistency_check_runs_on_the_cpu():
    """`check` end to end with the CPU in the card's place: the same labels
    (a rehearsal of chip_smoke.py's phase 4 call), at the JAX script's
    tiny FlowNetC configuration."""
    cfg = consistency.tiny_config()
    assert cfg.flow.variant == "flownetc" and cfg.merge.warp_stride == 1
    result = consistency.check("cpu")
    assert result["ok"] and result["agreement"] == 1.0 and result["frame0_equal"]
    assert result["min_object_iou"] == 1.0 and result["object_iou"]


SCRIPTS = ("check_tpu_consistency_torch", "probe_merge_knobs_torch", "reid_sphere_ab_torch")


def test_scripts_import_no_jax():
    """No import statement of the three scripts names jax, flax or the JAX
    package, and importing them with every port module they import inside
    their functions loads none of those in a fresh interpreter."""
    import ast
    import subprocess

    root = Path(__file__).resolve().parents[1]
    lazy = set()
    for name in SCRIPTS:
        tree = ast.parse((root / "scripts" / f"{name}.py").read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                mods = [node.module]
            else:
                continue
            for m in mods:
                assert m.split(".")[0] not in ("jax", "jaxlib", "flax", "premvos_tpu"), (name, m)
                if m.startswith("premvos_tpu_torch"):
                    lazy.add(m)
    code = "\n".join(["import sys", f"sys.path[:0] = [{str(root)!r}, {str(root / 'scripts')!r}]",
                      *(f"import {m}" for m in (*SCRIPTS, *sorted(lazy))),
                      "bad = sorted(n for n in sys.modules if n.split('.')[0] in",
                      "             ('jax', 'jaxlib', 'flax', 'premvos_tpu'))",
                      "sys.exit(1 if bad else 0)"])
    proc = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert len(lazy) >= 8, lazy


def test_consistency_bounds_objects_of_16_pixels_or_more(monkeypatch):
    """`check`'s verdict on hand-made label stacks: a one-pixel object on
    one device alone is reported and passes; an object of 16 pixels or more
    below 0.97 IoU fails, and so does frame 0 differing."""
    base = np.zeros((3, 64, 64), np.int32)
    base[:2, 10:20, 10:20] = 1  # object 1 gone on frame 2, as on the card's run
    base[:, 40:50, 40:50] = 2

    def verdict(card):
        labels = {"cuda": card, "cpu": base}
        monkeypatch.setattr(consistency, "run_on", lambda device: labels[device])
        return consistency.check("cuda")

    card = base.copy()
    card[2, 0, 0] = 1
    r = verdict(card)
    assert r["ok"] and r["min_object_iou"] == 1.0
    assert (2, 1, 0.0, 1) in r["object_iou"]
    card = base.copy()
    card[2, 40:50, 40:44] = 0
    r = verdict(card)
    assert not r["ok"] and r["min_object_iou"] == 0.6 and r["agreement"] >= 0.97
    card = base.copy()
    card[0, 0, 0] = 2
    assert not verdict(card)["ok"]
