"""The port's command lines on the CPU, against the JAX package on bridged
weights: `run_davis` (its PNGs against JAX `run_sequence`, `--resume`,
`--finetune`), the five `run_stages` stages (their file contracts; the
proposals JSON and the merge's PNGs against the JAX stage functions on the
same files) and the checkpoint they load.

A synthetic DAVIS tree of two sequences of 4 frames at 90×120 (PNG, written
by the port's codec), so the frames are padded to the tiny configuration's
96×128 canvas and the labels cropped back. The weights are JAX's
`init_params(PRNGKey(0))` with the RPN's and the box head's delta layers
zeroed, so the proposals are the clipped anchors: random deltas push every
box into one zero-area corner box, whose identical crops give each object
the same merge score to the last float bit, and which object takes a pixel
would hinge on the order of float sums. The port's CLIs get the weights
through `--checkpoint`; the JAX stage functions run in-process with their
set-up replaced by the same models (their own CLIs build and compile
everything anew and are too slow here).
"""

import argparse
import dataclasses
import json
import shutil
import types

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from premvos_tpu.data import davis as jdavis
from premvos_tpu.io_compat import proposals_json as jprops
from premvos_tpu.pipeline import run_stages as jrs
from premvos_tpu.pipeline import runner as jr
from premvos_tpu_torch import config as tc
from premvos_tpu_torch.bridge import params_from_jax
from premvos_tpu_torch.data.palette import save_indexed_png
from premvos_tpu_torch.finetune import fused as tfused
from premvos_tpu_torch.io_compat.flo import read_flo
from premvos_tpu_torch.io_compat.png import write_png
from premvos_tpu_torch.pipeline import run_davis, run_stages
from premvos_tpu_torch.pipeline import runner as tr
from premvos_tpu_torch.utils.checkpoint import load_params, save_params
from tests.test_torch_pipeline import JCFG, TCFG, H, W

T, HW = 4, (90, 120)


def _davis_tree(root):
    """DAVIS layout, sequences "a" and "b": a 20×24 and a 36×44 rectangle
    drifting over a noise background, PNG frames."""
    rng = np.random.default_rng(0)
    (root / "ImageSets" / "2017").mkdir(parents=True)
    (root / "ImageSets" / "2017" / "val.txt").write_text("a\nb")
    for s, seq in enumerate("ab"):
        jd, ad = (root / kind / "480p" / seq for kind in ("JPEGImages", "Annotations"))
        jd.mkdir(parents=True)
        ad.mkdir(parents=True)
        bg = rng.integers(0, 255, (*HW, 3)).astype(np.uint8)
        for t in range(T):
            img, lab = bg.copy(), np.zeros(HW, np.uint8)
            for obj, (y, x, h, w, color) in enumerate(
                    [(8 + 3 * s + t, 6 + 2 * t, 20, 24, (220, 60, 40)),
                     (40 - 4 * s + t, 60 - 2 * t, 36, 44, (40, 90, 210))], 1):
                img[y:y + h, x:x + w] = color
                lab[y:y + h, x:x + w] = obj
            write_png(jd / f"{t:05d}.png", img)
            save_indexed_png(ad / f"{t:05d}.png", lab)
    return root


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two intra-op threads for this module: the suite runs several pytest
    workers on the machine's cores, and at these tiny shapes more threads
    only contend with them."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli")
    jm = jr.build_models(JCFG)
    jp = flax.core.unfreeze(jax.tree.map(np.asarray, jr.init_params(
        jm, JCFG, jax.random.PRNGKey(0))))
    raw = jax.tree.map(np.copy, jp)  # the delta layers left in
    heads = jp["maskrcnn"]["params"]
    for head, layer in (("rpn", "Conv_2"), ("box_head", "Dense_3")):
        heads[head][layer] = jax.tree.map(np.zeros_like, heads[head][layer])
    tm = params_from_jax(tr.build_models(TCFG, device="cpu"), jp)
    save_params(d / "params.pt", tm)
    tc.save_config(d / "tiny.json", TCFG)
    root = _davis_tree(d / "davis")
    return types.SimpleNamespace(d=d, jm=jm, jp=jp, raw=raw, tm=tm, root=root,
                                 ckpt=str(d / "params.pt"), cfg=str(d / "tiny.json"))


def _common(env, cfg=None):
    return ["--davis_root", str(env.root), "--config", cfg or env.cfg,
            "--checkpoint", env.ckpt, "--device", "cpu"]


def _pngs(d):
    return np.stack([np.asarray(Image.open(p)) for p in sorted(d.glob("*.png"))])


def test_checkpoint_round_trip(env, tmp_path):
    """load_params puts every tensor of save_params' file back, strictly."""
    fresh = load_params(env.ckpt, tr.build_models(TCFG, device="cpu"))
    for name in ("maskrcnn", "refine", "flow", "reid"):
        want = getattr(env.tm, name).state_dict()
        got = getattr(fresh, name).state_dict()
        assert got.keys() == want.keys()
        assert all(torch.equal(got[k], v) for k, v in want.items()), name
    state = torch.load(env.ckpt, weights_only=True)
    del state["flow"]
    torch.save(state, tmp_path / "partial.pt")
    with pytest.raises(KeyError, match="flow"):
        load_params(tmp_path / "partial.pt", tr.build_models(TCFG, device="cpu"))
    state = torch.load(env.ckpt, weights_only=True)
    state["reid"]["extra"] = torch.zeros(1)
    torch.save(state, tmp_path / "extra.pt")
    with pytest.raises(RuntimeError, match="extra"):
        load_params(tmp_path / "extra.pt", tr.build_models(TCFG, device="cpu"))


def test_run_davis_matches_jax_run_sequence(env, tmp_path):
    """Each sequence's PNGs against JAX run_sequence on the same frames,
    cropped to 90×120: ≥ 99 % of pixels agree and frame 0 is the
    annotation; the summary has the JAX CLI's keys."""
    out = tmp_path / "out"
    summary = run_davis.main(_common(env) + ["--output", str(out)])
    assert set(summary) == {"frames", "seconds", "fps", "J", "F", "J&F"}
    assert summary["frames"] == 2 * (T - 1) and summary["fps"] > 0
    jds = jdavis.DavisDataset(env.root)
    for name in ("a", "b"):
        seq = jds.load_sequence(name, H, W, 2)
        want = np.asarray(jr.run_sequence(
            env.jm, env.jp, JCFG, jnp.asarray(seq["frames"]), jnp.asarray(seq["gt_masks"]),
            jnp.int32(seq["num_objects"])))
        want = jdavis.crop_result(want, seq["orig_hw"])
        got = _pngs(out / name)
        assert got.shape == (T, *HW)
        assert sorted(p.name for p in (out / name).glob("*.png")) == [
            f"{i:05d}.png" for i in range(T)]
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[0], seq["gt_labels"][0][: HW[0], : HW[1]])
        assert (got == want).mean() >= 0.99


def test_run_davis_resume_skips_finished_sequences(env, tmp_path):
    args = _common(env) + ["--output", str(tmp_path / "out"), "--sequences", "a"]
    assert run_davis.main(args)["frames"] == T - 1
    again = run_davis.main(args + ["--resume"])
    assert again["frames"] == 0 and "J" not in again
    assert run_davis.main(args + ["--resume", "--max_frames", "3"])["frames"] == 0


def test_run_davis_finetune_starts_each_sequence_from_the_base(env, tmp_path, monkeypatch):
    """--finetune with 2 steps on two sequences: both fine-tunes start from
    the checkpoint's weights (the second not from the first's result), and
    each sequence is tracked with its own fine-tuned nets."""
    cfg = dataclasses.replace(
        TCFG, finetune=tc.FinetuneConfig(steps=2, chunk=2, batch_size=2, aug_patch=32))
    tc.save_config(tmp_path / "ft.json", cfg)
    calls, tracked = [], []
    real_finetune, real_run = tfused.finetune_video, run_davis.run_sequence

    def finetune(models, *a, **k):
        calls.append({n: {k_: v.clone() for k_, v in getattr(models, n).state_dict().items()}
                      for n in ("refine", "maskrcnn")})
        new, losses = real_finetune(models, *a, **k)
        calls[-1]["new"] = new
        return new, losses

    def run(models, *a, **k):
        tracked.append(models)
        return real_run(models, *a, **k)

    monkeypatch.setattr(tfused, "finetune_video", finetune)
    monkeypatch.setattr(run_davis, "run_sequence", run)
    summary = run_davis.main(_common(env, str(tmp_path / "ft.json"))
                             + ["--output", str(tmp_path / "out"), "--finetune"])
    assert summary["frames"] == 2 * (T - 1) and len(calls) == 2
    for call, models in zip(calls, tracked):
        for n in ("refine", "maskrcnn"):
            base = getattr(env.tm, n).state_dict()
            assert all(torch.equal(call[n][k], v) for k, v in base.items()), n
        assert models is call["new"]
        tuned = models.refine.state_dict()
        assert any(not torch.equal(tuned[k], v) for k, v in env.tm.refine.state_dict().items())
    assert len(list((tmp_path / "out" / "b").glob("*.png"))) == T


@pytest.mark.parametrize("cli", ["run_davis", "run_stages"])
def test_clis_need_cuda_or_explicit_cpu(env, cli, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = ["--davis_root", str(env.root), "--config", env.cfg]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        if cli == "run_davis":
            run_davis.main(args + ["--output", str(tmp_path)])
        else:
            run_stages.main(["proposals", "--seq", "a", "--work", str(tmp_path)] + args)


def _jax_setup(env, monkeypatch, seq="a"):
    """The JAX stages' set-up, replaced by the fixture's JAX models."""
    ds = jdavis.DavisDataset(env.root)
    loaded = ds.load_sequence(seq, H, W, 2)
    monkeypatch.setattr(jrs, "_setup", lambda args: (JCFG, env.jm, env.jp, ds, loaded))


def _stage(env, stage, work, seq="a"):
    run_stages.main([stage, "--seq", seq, "--work", str(work)] + _common(env))


def test_run_stages_proposals_match_jax(env, tmp_path, monkeypatch):
    """The proposals stage's JSON against the JAX stage's: the same count
    per frame, boxes and scores within 1e-4 relative, masks ≥ 99 %."""
    _stage(env, "proposals", tmp_path / "port")
    _jax_setup(env, monkeypatch)
    jrs.stage_proposals(argparse.Namespace(seq="a", work=str(tmp_path / "jax")))
    for t in range(T):
        name = f"frame_{t:05d}.json"
        got = jprops.load_proposals(tmp_path / "port" / "proposals" / "a" / name, 4, (H, W))
        want = jprops.load_proposals(tmp_path / "jax" / "proposals" / "a" / name, 4, (H, W))
        assert got.count == want.count > 0
        for f in ("boxes", "scores"):
            g, w_ = getattr(got, f), getattr(want, f)
            assert np.abs(g - w_).max() <= 1e-4 * max(np.abs(w_).max(), 1e-6), f
        assert (got.masks == want.masks).mean() >= 0.99


def test_run_stages_file_contracts_and_merge_match_jax(env, tmp_path, monkeypatch):
    """The five stages on one sequence: the JSON schema (ReID appended by
    the reid stage; the merge refuses to run before it), the .flo names and
    their [96, 128, 2] fields, the result PNGs; and the merge stage's PNGs
    against the JAX stage_merge's on the same work directory: ≥ 99 % of
    pixels agree, frame 0 exact (each side embeds the annotation with its
    own ReID net, so a near tie may fall the other way)."""
    work = tmp_path / "work"
    for stage in ("proposals", "refine", "flow"):
        _stage(env, stage, work)
    with pytest.raises(SystemExit, match="reid stage"):
        _stage(env, "merge", work)
    _stage(env, "reid", work)
    _stage(env, "merge", work)

    props = sorted((work / "proposals" / "a").glob("*.json"))
    assert [p.name for p in props] == [f"frame_{t:05d}.json" for t in range(T)]
    for p in props:
        raw = json.loads(p.read_text())
        assert 0 < len(raw) <= 4
        for d in raw:
            assert set(d) == {"bbox", "score", "segmentation", "ReID"}
            assert len(d["bbox"]) == 4 and isinstance(d["score"], float)
            assert d["segmentation"]["size"] == [H, W]
            assert isinstance(d["segmentation"]["counts"], str) and len(d["ReID"]) == 8
    flos = sorted((work / "flow" / "a").glob("*.flo"))
    assert [p.name for p in flos] == [f"{t:05d}.flo" for t in range(1, T)]
    for p in flos:
        f = read_flo(p)
        assert f.shape == (H, W, 2) and np.isfinite(f).all()
    got = _pngs(work / "results" / "a")
    assert got.shape == (T, *HW)

    shutil.move(work / "results", tmp_path / "port_results")
    _jax_setup(env, monkeypatch)
    jrs.stage_merge(argparse.Namespace(seq="a", work=str(work)))
    want = _pngs(work / "results" / "a")
    np.testing.assert_array_equal(got[0], want[0])
    assert (got == want).mean() >= 0.99
    assert (got[1:] > 0).any()


def _merge_loops(env, jm, jp, work, seq):
    """Both packages' merge, frame by frame, on the stage files in `work`
    (as their stage_merge runs it, each embedding the annotation with its
    own ReID net): per package, [(labels [H, W], each object's assignment
    score [K])] for frames 1..T−1."""
    from premvos_tpu.data.preprocess import normalize as jnormalize, to_unit as jto_unit
    from premvos_tpu.io_compat.flo import read_flo as jread_flo
    from premvos_tpu.stages import merge as jmerge
    from premvos_tpu.stages.reid import run_reid as jrun_reid
    from premvos_tpu_torch.data.davis import DavisDataset
    from premvos_tpu_torch.io_compat.proposals_json import load_proposals
    from premvos_tpu_torch.stages import merge as tmerge
    from premvos_tpu_torch.stages.reid import run_reid

    loaded = DavisDataset(env.root).load_sequence(seq, H, W, 2)
    n, k = JCFG.pipeline.max_proposals, 2
    gt = torch.from_numpy(loaded["gt_masks"])
    valid = torch.arange(k) < loaded["num_objects"]
    with torch.inference_mode():
        emb = run_reid(env.tm_raw.reid, run_stages._image(loaded["frames"][0], "cpu"),
                       tr.boxes_from_masks(gt)[None], valid[None], TCFG.reid.crop_size)[0]
    tstate = tmerge.init_state(gt, emb, loaded["num_objects"])
    jgt = jnp.asarray(loaded["gt_masks"])
    jemb = jrun_reid(jm.reid, jp["reid"], jnormalize(jto_unit(jnp.asarray(loaded["frames"][0]))),
                     jr.boxes_from_masks(jgt), jnp.asarray(valid.numpy()), JCFG.reid.crop_size)
    jstate = jmerge.init_state(jgt, jemb, loaded["num_objects"])
    step = jax.jit(lambda st, *a: jmerge.merge_frame(st, *a, JCFG.merge))
    port, jax_ = [], []
    for t in range(1, T):
        props = load_proposals(work / "proposals" / seq / f"frame_{t:05d}.json", n, (H, W))
        flow = read_flo(work / "flow" / seq / f"{t:05d}.flo")
        args = (props.masks.astype(np.float32), props.scores, props.embeddings, props.valid)
        with torch.inference_mode():
            tstate, lab, info = tmerge.merge_frame(
                tstate, *(torch.from_numpy(a) for a in args),
                torch.from_numpy(flow).permute(2, 0, 1), TCFG.merge)
        port.append((lab.numpy(), info["score"].numpy()))
        jstate, jlab, jinfo = step(jstate, *(jnp.asarray(a) for a in args),
                                   jnp.asarray(jread_flo(work / "flow" / seq / f"{t:05d}.flo")))
        jax_.append((np.asarray(jlab), np.asarray(jinfo["score"])))
    return port, jax_


def _ulps(a, b) -> int:
    return abs(int(np.float32(a).view(np.int32)) - int(np.float32(b).view(np.int32)))


def test_staged_merge_disagreement_is_a_last_bit_tie(env, tmp_path, monkeypatch):
    """The staged merge at the weights the other tests start from, with the
    RPN's and box head's delta layers left in: every box falls into one
    zero-area corner, each object's proposals are the same crop, and the
    two objects' merge scores tie. Each package's merge PNGs (its
    stage_merge on the port's stage files) are reproduced in process; at
    every pixel where the two disagree, both label an object (never
    background against an object), and in each package the two competing
    objects' assignment scores differ by at most 2 float32 ulp: the order
    of two float sums picks the winner, not a fault of the port. (At these
    weights sequence "a" agrees on 87 % of pixels: 1-ulp ties won the
    other way.)"""
    jm, jp = env.jm, env.raw
    env = types.SimpleNamespace(**vars(env), tm_raw=params_from_jax(
        tr.build_models(TCFG, device="cpu"), jp))
    save_params(tmp_path / "raw.pt", env.tm_raw)
    env.ckpt = str(tmp_path / "raw.pt")
    seq, work = "a", tmp_path / "work"
    for stage in ("proposals", "refine", "flow", "reid", "merge"):
        _stage(env, stage, work, seq)
    got = _pngs(work / "results" / seq)
    shutil.move(work / "results", tmp_path / "port_results")
    monkeypatch.setattr(jrs, "_setup", lambda args: (
        JCFG, jm, jp, jdavis.DavisDataset(env.root),
        jdavis.DavisDataset(env.root).load_sequence(seq, H, W, 2)))
    jrs.stage_merge(argparse.Namespace(seq=seq, work=str(work)))
    want = _pngs(work / "results" / seq)
    port, jax_ = _merge_loops(env, jm, jp, work, seq)
    for t, ((tl, ts), (jl, js)) in enumerate(zip(port, jax_), 1):
        np.testing.assert_array_equal(tl[: HW[0], : HW[1]], got[t])
        np.testing.assert_array_equal(jl[: HW[0], : HW[1]], want[t])
        differ = tl != jl
        pairs = set(zip(tl[differ].tolist(), jl[differ].tolist()))
        print(f"frame {t}: {int(differ.sum())} pixels differ, (port, JAX) labels {sorted(pairs)}, "
              f"scores port {ts.tolist()} JAX {js.tolist()}")  # pytest -s shows them
        for a, b in pairs:
            assert a > 0 and b > 0, (t, a, b)
            assert _ulps(ts[a - 1], ts[b - 1]) <= 2, (t, ts)
            assert _ulps(js[a - 1], js[b - 1]) <= 2, (t, js)
    np.testing.assert_array_equal(got[0], want[0])
    print(f"agreement of the merge PNGs: {float((got == want).mean()):.4f}")
