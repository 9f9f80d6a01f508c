"""The selection-loss diagnosis (eval/diagnose.py) and the merge-tuning
command (eval/tune.py::main) in the port against scripts/diagnose_benchmark.py
and scripts/tune_merge.py, on the CPU.

The diagnosis runs both packages' `diagnose_sequence` and `term_matrices`
on one hand-made precompute (numpy, seeded; the port's as tensors) that
reaches every class: the counts, the blame and the events equal, the
score terms within 1e-6. The tuning command runs both `main`s on
--synthetic with one port-written orbax checkpoint (pinned as
tests/test_torch_demo.py pins the demo's nets: random weights decide by
float rounding otherwise). The JAX block warp is the TPU kernel's on both
(tests/_jax_block_warp.py).
"""

import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from premvos_tpu.config import MergeConfig as JaxMergeConfig
from premvos_tpu.stages import merge as jmerge
from premvos_tpu.stages.flow import warp_masks_coarse as jax_warp_masks_coarse
from premvos_tpu_torch.config import MergeConfig
from premvos_tpu_torch.eval import diagnose as tdiag
from premvos_tpu_torch.eval import tune as ttune
from premvos_tpu_torch.pipeline.runner import build_models, init_params
from premvos_tpu_torch.stages import merge as tmerge
from premvos_tpu_torch.stages.flow import warp_masks_coarse
from premvos_tpu_torch.utils.checkpoint import save_params
from tests._jax_block_warp import jax_tpu_block_warp  # noqa: F401 (autouse)
from tests.test_torch_demo import pin_for_parity

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "scripts"))
import diagnose_benchmark as jdiag  # noqa: E402
import tune_merge as jtune  # noqa: E402
from tests._threads import few_threads  # noqa: F401

CLASSES = tdiag.CLASSES
# A score floor that rejects weak assignments, so objects go absent too.
WEIGHTS = dict(w_objectness=1.0, w_reid=0.8, w_warp=1.2, w_overlap=0.7, reid_sigma=1.0,
               new_object_score_floor=1.0, warp_decay=0.8, reid_ema=0.0, reid_reacquire=2.0)


def hand_precompute(seed, t=16, k=3, n=6, h=24, w=32):
    """One sequence's stage outputs, made in numpy: k rectangles drifting
    over t frames, each hidden on some frames; per frame each visible
    object's proposal is its rectangle, or it shifted by up to 5 pixels
    along an axis or a diagonal (IoU from 1 down to near 0), with a soft
    value, among distractor rectangles; random
    scores and validity; embeddings near the object's reference or not;
    a constant subpixel flow. Returns (pre as numpy, gt_masks, k,
    gt_labels [t, h, w])."""
    rng = np.random.default_rng(seed)
    labels = np.zeros((t, h, w), np.int32)
    corner = rng.integers(0, [h - 8, w - 10], size=(k, 2))
    hidden = rng.uniform(size=(t, k)) < 0.2
    hidden[0] = False
    for ti in range(t):
        for o in range(k):
            if hidden[ti, o]:
                continue
            y, x = corner[o] + [ti % 3, ti // 4]
            y, x = min(y, h - 7), min(x, w - 9)
            labels[ti, y:y + 7, x:x + 9] = o + 1
    gt = np.stack([labels[0] == o + 1 for o in range(k)]).astype(np.float32)
    gt_emb = rng.standard_normal((k, 8)).astype(np.float32)
    masks = np.zeros((t - 1, n, h, w), np.float32)
    emb = rng.standard_normal((t - 1, n, 8)).astype(np.float32)
    for ti in range(1, t):
        for o, j in enumerate(rng.permutation(n)[:k]):
            if not (labels[ti] == o + 1).any():
                continue
            dy, dx = rng.integers(-1, 2, size=2) * rng.integers(0, 6)
            m = np.roll(np.roll(labels[ti] == o + 1, dy, axis=0), dx, axis=1)
            masks[ti - 1, j] = m * rng.uniform(0.6, 1.0)
            emb[ti - 1, j] = gt_emb[o] + rng.uniform(0.1, 1.5) * rng.standard_normal(8)
        for j in range(n):
            if not masks[ti - 1, j].any():
                y, x = rng.integers(0, h - 6), rng.integers(0, w - 6)
                masks[ti - 1, j, y:y + 6, x:x + 6] = rng.uniform(0.3, 1.0)
    flow = np.zeros((t - 1, h, w, 2), np.float32)
    flow[..., 0], flow[..., 1] = 0.4, -0.3
    pre = {
        "prop_masks": masks, "scores": rng.uniform(0.05, 1.0, (t - 1, n)).astype(np.float32),
        "emb": emb, "valid": rng.uniform(size=(t - 1, n)) > 0.2, "flow": flow,
        "gt_emb": gt_emb, "gt_valid": np.ones(k, bool),
    }
    return pre, gt, k, labels


def port_entry(pre, gt):
    out = {key: torch.from_numpy(np.array(v)) for key, v in pre.items()}
    out["flow"] = out["flow"].permute(0, 3, 1, 2).contiguous()
    return out, torch.from_numpy(gt)


def test_diagnose_sequence_matches_jax_and_reaches_every_class():
    """Two hand-made sequences: counts, blame and events equal to the JAX
    script's; every class and at least two blamed terms reached; every
    counted object-frame in exactly one class."""
    jcfg, tcfg = JaxMergeConfig(**WEIGHTS), MergeConfig(**WEIGHTS)
    seen = dict.fromkeys(CLASSES, 0)
    blamed = dict.fromkeys(("objectness", "reid", "warp", "overlap"), 0)
    for seed in (0, 1):
        pre, gt, k, labels = hand_precompute(seed)
        jpre = {key: jnp.asarray(v) for key, v in pre.items()}
        want = jdiag.diagnose_sequence(jpre, jnp.asarray(gt), k, labels, jcfg, f"s{seed}")
        tpre, tgt = port_entry(pre, gt)
        got = tdiag.diagnose_sequence(tpre, tgt, k, labels, tcfg, f"s{seed}")
        assert got[0] == want[0]
        assert got[1] == want[1]
        assert got[2] == want[2]
        counts, blame, _ = got
        assert counts["frames_objects"] == sum(counts[c] for c in CLASSES)
        for c in CLASSES:
            seen[c] += counts[c]
        for b, v in blame.items():
            blamed[b] += v
    assert all(seen[c] > 0 for c in CLASSES), seen
    assert sum(v > 0 for v in blamed.values()) >= 2, blamed


def test_term_matrices_match_jax():
    """The four [K, N] terms frame by frame along both packages' merges
    (the first 6 frames; the JAX merge and warp jitted, as the JAX
    script's diagnose_sequence runs them), within 1e-6."""
    jcfg, tcfg = JaxMergeConfig(**WEIGHTS), MergeConfig(**WEIGHTS)
    jstep = jax.jit(lambda st, *xs: jmerge.merge_frame(st, *xs, jcfg)[0])
    jwarp = jax.jit(lambda m, f: jax_warp_masks_coarse(m, f, 1, jcfg.warp_impl))
    pre, gt, k, _ = hand_precompute(0)
    tpre, tgt = port_entry(pre, gt)
    jstate = jmerge.init_state(jnp.asarray(gt), jnp.asarray(pre["gt_emb"]), jnp.int32(k))
    tstate = tmerge.init_state(tgt, tpre["gt_emb"], k)
    keys = ("prop_masks", "scores", "emb", "valid", "flow")
    for t in range(6):
        jt = {key: jnp.asarray(pre[key][t]) for key in keys}
        tt = {key: tpre[key][t] for key in keys}
        jwarped = jwarp(jstate.prev_masks, jt["flow"])
        twarped = warp_masks_coarse(tstate.prev_masks, tt["flow"], 1, tcfg.warp_impl)
        want = jdiag.term_matrices(jstate, jwarped, jt, jcfg)
        got = tdiag.term_matrices(tstate, twarped, tt, tcfg)
        assert set(got) == set(want)
        for name in want:
            assert got[name].shape == (k, 6) and got[name].dtype == np.float32
            np.testing.assert_allclose(got[name], np.asarray(want[name]), rtol=0, atol=1e-6,
                                       err_msg=f"{name} at t={t}")
        jstate = jstep(jstate, *(jt[key] for key in keys))
        tstate = tmerge.merge_frame(tstate, *(tt[key] for key in keys), tcfg)[0]
    assert int(tstate.staleness.max()) > 0  # the decay term saw a stale object


def test_merge_weights_fall_back_to_defaults(tmp_path):
    """--weights reads a tuned record's "weights"; names it lacks take
    MergeConfig's defaults, as the JAX script's."""
    path = tmp_path / "tuned.json"
    path.write_text(json.dumps({"weights": {"w_reid": 0.5, "new_object_score_floor": 1.1}}))
    w = tdiag.merge_weights(str(path))
    assert w.dtype == np.float32
    np.testing.assert_array_equal(w, np.float32([1.0, 0.5, 1.0, 1.0, 1.0, 1.1, 1.0, 0.0, 2.0]))
    np.testing.assert_array_equal(tdiag.merge_weights(None), ttune.DEFAULT_WEIGHTS)


def test_tune_main_matches_jax(tmp_path, monkeypatch):
    """--synthetic --trials 4 --max-seqs 1 on one port-written orbax
    checkpoint: the JAX command's file and the port's hold the same best
    weights, J&F and baseline (1e-9), and the same trials, split and
    sequences."""
    cfg = ttune.synthetic_config()
    ckpt = tmp_path / "synthetic"
    save_params(ckpt, pin_for_parity(init_params(build_models(cfg, "cpu"), cfg, 0, "cpu")))
    args = ["--synthetic", "--trials", "4", "--max-seqs", "1", "--checkpoint", str(ckpt)]
    monkeypatch.setattr(sys, "argv", ["tune_merge.py", *args, "--cpu",
                                      "--out", str(tmp_path / "jax.json")])
    jtune.main()
    want = json.loads((tmp_path / "jax.json").read_text())
    got = ttune.main([*args, "--device", "cpu", "--out", str(tmp_path / "port.json")])
    assert json.loads((tmp_path / "port.json").read_text()) == got
    assert got["merge"] == want["merge"]
    for key in ("J&F", "baseline_J&F"):
        assert got["_tuning"][key] == pytest.approx(want["_tuning"][key], abs=1e-9), key
    assert {k: v for k, v in got["_tuning"].items() if "J&F" not in k} == {
        k: v for k, v in want["_tuning"].items() if "J&F" not in k}
    assert got["_tuning"]["sequences"] == ["seq_a"] and got["_tuning"]["J&F"] > 0.0
