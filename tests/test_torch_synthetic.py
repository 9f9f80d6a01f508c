"""The held-out synthetic protocol in the port vs the JAX package, on the
CPU: the generator (data/synthetic_vos.py and cv_compat.resize_cubic), the
merge-weight search (eval/tune.py) and the protocol's entry point
(eval/synthetic_benchmark.py).

The generator is compared with OpenCV's Intel IPP paths off
(cv2.ipp.setUseIPP(False)), where OpenCV runs its own arithmetic, which
the port copies: every file of the tree equal byte for byte, the JPEG
frames too (the port's encoder writes Pillow's bytes). With IPP on (the
wheel's default) the background's cubic resize is a few float32 ulp apart
(held here), which can move a rendered uint8 value by one level.

The search runs both packages' `tune_weights` and `oracle_jf` on one
synthetic precompute (the same arrays on both sides, the port's as
tensors): every trial's J&F within 1e-9, the same chosen vector.
"""

import argparse
import glob
import json
import sys
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch
from PIL import Image

from premvos_tpu.data import synthetic_vos as jvos
from premvos_tpu.eval import harness as jharness
from premvos_tpu.io_compat.flo import read_flo as jax_read_flo
from premvos_tpu_torch.data import synthetic_vos as tvos
from premvos_tpu_torch.data.cv_compat import resize_cubic
from premvos_tpu_torch.eval import synthetic_benchmark as tbench
from premvos_tpu_torch.eval import tune as ttune
from premvos_tpu_torch.io_compat.flo import read_flo
from premvos_tpu_torch.io_compat.png import read_png
from premvos_tpu_torch.io_compat.ppm import read_ppm
from tests._threads import few_threads  # noqa: F401

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "scripts"))
import run_synthetic_benchmark as jbench  # noqa: E402
import tune_merge as jtune  # noqa: E402

HW = (64, 96)


@pytest.fixture
def no_ipp():
    was = cv2.ipp.useIPP()
    cv2.ipp.setUseIPP(False)
    yield
    cv2.ipp.setUseIPP(was)


# ------------------------------------------------------------ resize_cubic


@pytest.mark.parametrize("shape,hw", [((6, 9, 3), (64, 96)), ((6, 9, 3), (128, 192)),
                                      ((5, 7), (33, 17)), ((6, 9, 3), (3, 5)),
                                      ((4, 6, 2), (13, 11))])
def test_resize_cubic_matches_cv2(shape, hw):
    """Bit for bit against OpenCV's own code (the vector loop and its
    scalar tail: widths × channels of 17·1, 11·2 and 5·3 leave one); with
    IPP, within 1e-4 of values of ±45 (IPP's cubic rounds differently: up
    to 9e-5, 24 float32 ulp at 45, on a 480×864 output)."""
    g = np.random.default_rng(hw[0]).uniform(-45, 45, shape).astype(np.float32)
    got = resize_cubic(g, hw)
    was = cv2.ipp.useIPP()
    try:
        cv2.ipp.setUseIPP(False)
        want = cv2.resize(g, (hw[1], hw[0]), interpolation=cv2.INTER_CUBIC)
        cv2.ipp.setUseIPP(True)
        want_ipp = cv2.resize(g, (hw[1], hw[0]), interpolation=cv2.INTER_CUBIC)
    finally:
        cv2.ipp.setUseIPP(was)
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    assert float(np.abs(got - want_ipp).max()) <= 1e-4


# --------------------------------------------------------------- generator


@pytest.mark.parametrize("size_scale", [1.0, 2.0])
def test_sequence_spec_background_and_contrast_match_jax(size_scale, no_ipp):
    """The same rng stream gives the same entities, background and
    contrast-floor colors, and leaves the stream at the same place."""
    hw = (int(HW[0] * size_scale), int(HW[1] * size_scale))
    for seed in range(3):
        ra, rb = np.random.default_rng(seed), np.random.default_rng(seed)
        want = jvos.build_sequence_spec(ra, t=20, hw=hw, size_scale=size_scale)
        got = tvos.build_sequence_spec(rb, t=20, hw=hw, size_scale=size_scale)
        bg_want, bg_got = jvos._smooth_background(ra, *hw), tvos._smooth_background(rb, *hw)
        np.testing.assert_array_equal(bg_got, bg_want)
        want = jvos._ensure_contrast(want, bg_want, ra)
        got = tvos._ensure_contrast(got, bg_got, rb)
        assert len(got) == len(want) == 3
        for e, f in zip(got, want):
            for field in ("shape", "s0", "scale_amp", "scale_period", "scale_phase", "tex",
                          "depth", "tracked"):
                assert getattr(e, field) == getattr(f, field), field
            np.testing.assert_array_equal(e.color, f.color)
            np.testing.assert_array_equal(e.positions, f.positions)
        assert ra.uniform() == rb.uniform()


def test_render_and_backward_flow_match_jax():
    """render_frame and backward_flow on JAX's entities and background
    (with IPP on): every frame, label map and flow equal."""
    rng = np.random.default_rng(5)
    ents = jvos.build_sequence_spec(rng, t=20, hw=HW, n_tracked=3, n_distractors=2)
    bg = jvos._smooth_background(rng, *HW)
    ids = {i: i + 1 for i, e in enumerate(ents) if e.tracked}
    for fi in range(20):
        (img, lab), (wimg, wlab) = (m.render_frame(ents, fi, HW, bg, ids) for m in (tvos, jvos))
        np.testing.assert_array_equal(img, wimg)
        np.testing.assert_array_equal(lab, wlab)
        if fi:
            np.testing.assert_array_equal(tvos.backward_flow(ents, fi, HW),
                                          jvos.backward_flow(ents, fi, HW))
    assert lab.max() == 3 and (wimg != bg.astype(np.uint8)).any()


@pytest.mark.parametrize("pairs_hw", [(64, 128), None], ids=["pairs_resized", "pairs_at_canvas"])
def test_make_synthetic_vos_matches_jax(tmp_path, pairs_hw, no_ipp):
    """The whole tree at 64×96, 20 frames: the same split files, every
    annotation and .flo file equal, the pair images equal (at 64×128 the
    INTER_LINEAR resizes against cv2's), and every JPEG frame equal to the
    JAX generator's byte for byte."""
    kw = dict(n_train=2, n_tune=1, n_val=1, t=20, hw=HW, seed=3, pairs_hw=pairs_hw)
    jroot = jvos.make_synthetic_vos(tmp_path / "jax", **kw)
    troot = tvos.make_synthetic_vos(tmp_path / "port", **kw)
    for split in ("train", "tune", "val"):
        name = f"ImageSets/2017/{split}.txt"
        assert (troot / name).read_text() == (jroot / name).read_text()
    anns = sorted(glob.glob(str(jroot / "Annotations/480p/*/*.png")))
    frames = sorted(glob.glob(str(jroot / "JPEGImages/480p/*/*")))
    assert len(anns) == 4 * 20
    assert [Path(f).relative_to(jroot) for f in frames] == [
        Path(f).relative_to(troot) for f in sorted(glob.glob(str(troot / "JPEGImages/480p/*/*")))]
    assert [f[:-4] for f in frames] == [a[:-4].replace("Annotations", "JPEGImages") for a in anns]
    for ann in anns:
        rel = Path(ann).relative_to(jroot)
        np.testing.assert_array_equal(read_png(troot / rel)[0], np.asarray(Image.open(ann)))
    for frame in frames:
        rel = Path(frame).relative_to(jroot)
        assert (troot / rel).read_bytes() == Path(frame).read_bytes(), rel
    flos = sorted(glob.glob(str(jroot / "flow_pairs/*.flo")))
    assert len(flos) == 2 * 19
    for f in flos:
        rel = Path(f).relative_to(jroot)
        np.testing.assert_array_equal(read_flo(troot / rel), jax_read_flo(f))
        for k in ("img1", "img2"):
            ppm = str(rel).replace("flow.flo", f"{k}.ppm")
            got = read_ppm(troot / ppm)
            assert got.shape[:2] == (pairs_hw or HW)
            np.testing.assert_array_equal(got, np.asarray(Image.open(jroot / ppm)))


def test_make_shift_pairs_matches_jax(tmp_path):
    """The constant-shift pairs from one PNG tree: the same frames drawn,
    the same shifts, the same files."""
    import train_synthetic_demo as jdemo

    root = tvos.make_synthetic_vos(tmp_path / "vos", n_train=0, n_tune=0, n_val=2, t=20,
                                   hw=HW, flow_pairs=False)
    jdemo.make_shift_pairs(root, tmp_path / "jax", n_pairs=6)
    tbench.make_shift_pairs(root, tmp_path / "port", n_pairs=6)
    for i in range(6):
        np.testing.assert_array_equal(read_flo(tmp_path / f"port/{i:05d}_flow.flo"),
                                      jax_read_flo(tmp_path / f"jax/{i:05d}_flow.flo"))
        for k in ("img1", "img2"):
            np.testing.assert_array_equal(read_ppm(tmp_path / f"port/{i:05d}_{k}.ppm"),
                                          np.asarray(Image.open(tmp_path / f"jax/{i:05d}_{k}.ppm")))


# ------------------------------------------------------------------ search


def _precompute(rng, t=6, n=5, h=24, w=32, k=2):
    """A synthetic stage-1-4 output for one sequence: each object has a
    proposal that follows it (shifted a pixel or two, so several weight
    vectors pick differently) among distractors, embeddings near its
    reference, and a one-pixel flow. Returns (pre as numpy, gt_masks,
    k, gt_labels)."""
    labels = np.zeros((t, h, w), np.int32)
    for ti in range(t):
        labels[ti, 3 + ti:11 + ti, 4:12] = 1
        labels[ti, 12:20, 14 + ti:24 + ti] = 2
    gt = np.stack([(labels[0] == o + 1) for o in range(k)]).astype(np.float32)
    gt_emb = rng.standard_normal((k, 8)).astype(np.float32)
    masks = np.zeros((t - 1, n, h, w), np.float32)
    emb = rng.standard_normal((t - 1, n, 8)).astype(np.float32)
    for ti in range(1, t):
        for o in range(k):
            shift = int(rng.integers(-2, 3))
            masks[ti - 1, o] = np.roll(labels[ti] == o + 1, shift, axis=1)
            emb[ti - 1, o] = gt_emb[o] + 0.5 * rng.standard_normal(8)
        for j in range(k, n):
            y, x = rng.integers(0, h - 8), rng.integers(0, w - 8)
            masks[ti - 1, j, y:y + 8, x:x + 8] = rng.uniform(0.3, 1.0)
    flow = np.zeros((t - 1, h, w, 2), np.float32)
    flow[..., 0] = -1.0
    pre = {
        "prop_masks": masks, "scores": rng.uniform(0.2, 1.0, (t - 1, n)).astype(np.float32),
        "emb": emb, "valid": rng.uniform(0, 1, (t - 1, n)) > 0.15, "flow": flow,
        "gt_emb": gt_emb, "gt_valid": np.ones(k, bool),
    }
    return pre, gt, k, labels


def _port_entry(entry):
    pre, gt, k, labels = entry
    pre = {key: torch.from_numpy(np.array(v)) for key, v in pre.items()}
    pre["flow"] = pre["flow"].permute(0, 3, 1, 2).contiguous()
    return pre, torch.from_numpy(gt), k, labels


def _recording(monkeypatch, module, name, log):
    real = getattr(module, name)

    def wrapped(*a, **k):
        out = real(*a, **k)
        log.append(float(out[0]))
        return out

    monkeypatch.setattr(module, name, wrapped)


def test_sample_weights_match_jax():
    a, b = np.random.default_rng(11), np.random.default_rng(11)
    for _ in range(50):
        np.testing.assert_array_equal(ttune.sample_weights(b), jtune.sample_weights(a))
    assert a.uniform() == b.uniform()
    w = ttune.ablation_weights(np.arange(9, dtype=np.float32), {"w_reid": 0.0,
                                                                "reid_reacquire": 2.0})
    np.testing.assert_array_equal(w, jbench.ablation_weights(
        np.arange(9, dtype=np.float32), {"w_reid": 0.0, "reid_reacquire": 2.0}))


@pytest.mark.parametrize("objective", ["min", "mean"])
def test_tune_weights_and_oracle_match_jax(monkeypatch, objective):
    """Two generator-seed groups of precomputed sequences: both searches
    score every trial alike (1e-9), log the same trials and pick the same
    vector; the oracle J&F alike."""
    rng = np.random.default_rng(2)
    groups = [[_precompute(rng) for _ in range(2)], [_precompute(rng)]]
    args = argparse.Namespace(seed=0, tune_objective=objective, warp_stride=1,
                              tune_trials=6, tune_local=4)
    jlog, tlog = [], []
    _recording(monkeypatch, jharness, "evaluate_weights", jlog)
    _recording(monkeypatch, ttune, "evaluate_weights", tlog)
    pooled = [e for g in groups for e in g]
    jw, jt, jtrials = jbench.tune_weights(pooled, args, groups=groups)
    tgroups = [[_port_entry(e) for e in g] for g in groups]
    tw, tt, ttrials = ttune.tune_weights([e for g in tgroups for e in g], args, groups=tgroups)
    assert len(tlog) == len(jlog) > 30
    np.testing.assert_allclose(tlog, jlog, rtol=0, atol=1e-9)
    assert len({round(x, 6) for x in jlog}) > 3  # the trials differ
    np.testing.assert_array_equal(tw, jw)
    assert tt == pytest.approx(jt, abs=1e-9) and ttrials == jtrials
    assert tbench.oracle_jf([_port_entry(e) for e in pooled]) == pytest.approx(
        jbench.oracle_jf(pooled), abs=1e-9)


def test_bench_config_matches_jax():
    """bench_config's fields, the record's (depth 26, 128×192) and the
    defaults, against the JAX script's."""
    import dataclasses

    for kw in ({}, {"canvas": (128, 192), "depth": 26}):
        want = dataclasses.asdict(jbench.bench_config(0.01, 16, **kw))
        assert dataclasses.asdict(tbench.bench_config(0.01, 16, **kw)) == want
    with pytest.raises(ValueError, match="32-multiples"):
        tbench.bench_config(canvas=(100, 150))
    assert [n for n, _ in tbench.ABLATIONS] == [n for n, _ in jbench.ABLATIONS]


# ----------------------------------------------------------------- protocol


def test_protocol_main_writes_the_record(tmp_path, monkeypatch):
    """The whole protocol on the CPU at 2 steps per net, one sequence per
    split, two proposals a frame (the refine stage dominates a CPU
    precompute) and a short search: the record has the JAX record's keys,
    J&F in [0, 1], and the tuned weights' file; nothing lands in the
    repo. Its gather_warp row is computed as the JAX script computes it: a
    precompute with the exact warp in FlowNet2 and the merge config, scored
    at "gather"; every other precompute and score runs the block warp."""
    want = json.loads((Path(__file__).resolve().parents[1]
                       / "docs/SYNTHETIC_BENCHMARK.json").read_text())
    out, tuned = tmp_path / "record.json", tmp_path / "tuned.json"
    warps = []
    precompute_split, evaluate_weights = tbench.precompute_split, tbench.evaluate_weights

    def precompute_spy(models, cfg, *args, **kwargs):
        warps.append(("precompute", models.flow.warp_impl, cfg.flow.warp_impl,
                      cfg.merge.warp_impl))
        return precompute_split(models, cfg, *args, **kwargs)

    def evaluate_spy(pre, weights, warp_stride=1, warp_impl="block"):
        warps.append(("evaluate", warp_impl))
        return evaluate_weights(pre, weights, warp_stride, warp_impl)

    monkeypatch.setattr(tbench, "precompute_split", precompute_spy)
    monkeypatch.setattr(tbench, "evaluate_weights", evaluate_spy)
    report = tbench.main([
        "--device", "cpu", "--steps-det", "2", "--steps-refine", "2", "--steps-reid", "2",
        "--steps-flow", "2", "--n-train", "1", "--n-tune", "1", "--n-val", "1",
        "--frames", "20", "--tune-trials", "1", "--tune-local", "1", "--max-proposals", "2",
        "--data-root", str(tmp_path / "data"), "--out", str(out), "--tuned-out", str(tuned),
    ])
    record = json.loads(out.read_text())
    assert record == json.loads(json.dumps(report))
    assert set(want) - {"finetune"} <= set(record)
    assert set(want["held_out"]) == set(record["held_out"])
    assert set(want["held_out"]["draws"]["0"]) == set(record["held_out"]["draws"]["0"])
    assert [r["name"] for r in record["ablation"]] == [r["name"] for r in want["ablation"][:-1]] + [
        "flow_half_res_64x64"]
    assert 0.0 <= record["held_out"]["J&F"] <= 1.0
    assert record["steps"] == {"det": 2, "refine": 2, "reid": 2, "flow": 2}
    assert record["detector"] == {"score_threshold": 0.01, "max_proposals": 2}
    assert record["platform"] == "cpu" and set(record["seconds"]["train"]) == {
        "det", "refine", "reid", "flow"}
    assert json.loads(tuned.read_text())["trials"][0]["kind"] == "baseline"
    row = {r["name"]: r for r in record["ablation"]}["gather_warp"]
    assert set(row) == {"name", "J&F"} and 0.0 <= row["J&F"] <= 1.0
    assert warps.count(("precompute", "gather", "gather", "gather")) == 1
    assert warps.count(("evaluate", "gather")) == 1
    assert {w for w in warps if "gather" not in w} == {
        ("precompute", "block", "block", "block"), ("evaluate", "block")}
