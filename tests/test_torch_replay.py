"""The merge-tuning replay, port vs JAX on bridged weights: stages 1–4 of a
whole sequence precomputed once (`precompute_sequence`), the merge replayed
from them per weight vector (`merge_labels_from_precomputed`), and the
harness's J&F (`eval/harness.py`).

The tiny configuration of tests/test_torch_pipeline.py (T = 5 frames with
scan_chunk 2, so the last chunk is padded), whose warps are the exact
("gather") ones on both sides; tests/test_torch_block_warp.py replays at
"block".
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from premvos_tpu.eval import harness as jh
from premvos_tpu.pipeline import runner as jr
from premvos_tpu_torch import config as tc
from premvos_tpu_torch.bridge import params_from_jax
from premvos_tpu_torch.eval import harness as th
from premvos_tpu_torch.pipeline import runner as tr
from tests.test_torch_pipeline import JCFG, TCFG, H, W, _close
from tests._threads import few_threads  # noqa: F401

T = 5


def _video():
    """Two objects drifting over a textured background (frame 0's masks
    are the annotation), and the label maps of every frame for J&F."""
    rng = np.random.default_rng(0)
    bg = rng.integers(0, 255, (H, W, 3)).astype(np.uint8)
    frames = np.repeat(bg[None], T, axis=0)
    labels = np.zeros((T, H, W), np.int32)
    for t in range(T):
        frames[t, 10 + t:40 + t, 10 + 2 * t:50 + 2 * t] = (200, 40, 40)
        frames[t, 50:90, 60 + t:120 + t] = (40, 200, 60)
        labels[t, 10 + t:40 + t, 10 + 2 * t:50 + 2 * t] = 1
        labels[t, 50:90, 60 + t:120 + t] = 2
    gt = np.stack([(labels[0] == 1), (labels[0] == 2)]).astype(np.float32)
    return frames, gt, labels


@pytest.fixture(scope="module")
def setup():
    jm = jr.build_models(JCFG)
    jp = jr.init_params(jm, JCFG, jax.random.PRNGKey(0))
    tm = tr.build_models(TCFG, device="cpu")
    params_from_jax(tm, jax.tree.map(np.asarray, jp))
    frames, gt, labels = _video()
    want = jr.precompute_sequence(jm, jp, JCFG, jnp.asarray(frames), jnp.asarray(gt), jnp.int32(2))
    want = jax.tree.map(np.asarray, want)
    got = tr.precompute_sequence(tm, TCFG, frames, gt, 2, device="cpu")
    return tm, frames, gt, labels, want, got


def _port_pre(jax_pre):
    """The JAX precompute's arrays as the port's tensors (flow [T−1, 2, H, W])."""
    pre = {k: torch.from_numpy(np.array(v)) for k, v in jax_pre.items()}
    pre["flow"] = pre["flow"].permute(0, 3, 1, 2).contiguous()
    return pre


def test_precompute_sequence_matches_jax(setup):
    _, _, _, _, want, got = setup
    assert set(got) == set(want)
    np.testing.assert_array_equal(got["valid"].numpy(), want["valid"])
    np.testing.assert_array_equal(got["gt_valid"].numpy(), want["gt_valid"])
    assert got["prop_masks"].shape == (T - 1, 4, H, W)
    for k in ("prop_masks", "scores", "emb", "gt_emb"):
        _close(got[k], want[k])
    _close(got["flow"].permute(0, 2, 3, 1), want["flow"])


# (label, weight vector): 6, 8 and 9 entries, and the configuration's vector
# with the score floor lowered to 0, which changes the labels.
_VECTORS = {
    "six": [1.0, 0.5, 1.5, 0.7, 0.8, 0.2],
    "eight": [0.6, 1.2, 1.0, 1.3, 1.1, 0.4, 0.8, 0.3],
    "nine": [1.0, 1.0, 1.0, 1.0, 1.0, 0.9, 0.7, 0.2, 0.5],
    "floor": [1.0, 1.0, 1.0, 1.0, 1.0, 0.0, 1.0, 0.0, 2.0],
}


@pytest.mark.parametrize("name", list(_VECTORS))
def test_replay_matches_jax_exactly(setup, name):
    """On JAX's own precomputed arrays the port's replay gives JAX's labels
    (JAX with the exact warp), pixel for pixel."""
    _, _, gt, _, want_pre, _ = setup
    w = np.asarray(_VECTORS[name], np.float32)
    want = np.asarray(jr.merge_labels_from_precomputed(
        want_pre, jnp.asarray(gt), jnp.int32(2), jnp.asarray(w), warp_stride=2,
        warp_impl="gather"))
    got = tr.merge_labels_from_precomputed(_port_pre(want_pre), torch.from_numpy(gt), 2, w,
                                           warp_stride=2, warp_impl="gather")
    assert got.dtype == torch.int32 and got.shape == (T, H, W)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got[1:] == 1).any() and (got[1:] == 2).any()  # both objects tracked
    if name == "floor":
        base = tr.merge_labels_from_precomputed(
            _port_pre(want_pre), torch.from_numpy(gt), 2,
            th.weights_from_merge_cfg(TCFG.merge), warp_stride=2, warp_impl="gather")
        assert (base.numpy() != got.numpy()).any(), "the floor did not change the labels"


def test_replay_equals_run_sequence(setup):
    """At the configuration's own weights and warp stride the replay of the
    port's precompute is the port's run_sequence, pixel for pixel."""
    tm, frames, gt, _, _, got_pre = setup
    w = th.weights_from_merge_cfg(TCFG.merge)
    assert not np.array_equal(w, th.DEFAULT_WEIGHTS)  # TCFG's score floor is 0.9
    replay = tr.merge_labels_from_precomputed(got_pre, gt, 2, w, warp_stride=2,
                                              warp_impl=TCFG.merge.warp_impl)
    labels = tr.run_sequence(tm, TCFG, frames, gt, 2, device="cpu")
    np.testing.assert_array_equal(replay.numpy(), labels.numpy())


def test_replay_ignores_the_configs_other_merge_fields(setup):
    """The replay builds its MergeConfig from the vector and MergeConfig's
    defaults (mask_threshold 0.5 among them), never from a config file."""
    cfg_m = tr.merge_config_from_weights(np.arange(9, dtype=np.float32) / 10, warp_stride=2)
    assert cfg_m == dataclasses.replace(
        tc.MergeConfig(), **dict(zip(th.WEIGHT_NAMES, (np.arange(9) / 10).astype(np.float32)
                                     .tolist())), warp_stride=2)
    assert cfg_m.mask_threshold == 0.5
    assert tr.merge_config_from_weights([1.0] * 6).reid_reacquire == 2.0
    with pytest.raises(ValueError, match="6, 8 or 9"):
        tr.merge_config_from_weights([1.0] * 7)


def test_harness_constants_match_jax():
    np.testing.assert_array_equal(th.DEFAULT_WEIGHTS, jh.DEFAULT_WEIGHTS)
    assert th.WEIGHT_NAMES == jh.WEIGHT_NAMES
    for cfg in (TCFG.merge, tc.MergeConfig(), tc.load_config("configs/davis2017_val.json").merge):
        jcfg = type(JCFG.merge)(**dataclasses.asdict(cfg))
        np.testing.assert_array_equal(th.weights_from_merge_cfg(cfg), jh.weights_from_merge_cfg(jcfg))
    np.testing.assert_array_equal(
        th.weights_from_merge_cfg(tc.load_config("configs/davis2017_val.json").merge),
        th.DEFAULT_WEIGHTS)


@pytest.mark.parametrize("name", ["six", "floor"])
def test_evaluate_weights_matches_jax(setup, name):
    """The harness's J&F on the same precomputed arrays: within 1e-9."""
    _, _, gt, labels, want_pre, _ = setup
    w = np.asarray(_VECTORS[name], np.float32)
    # Label maps cropped to a smaller "original" size, as precompute_split does.
    gt_labels = labels[:, : H - 6, : W - 8]
    want, want_seq = jh.evaluate_weights(
        [(want_pre, jnp.asarray(gt), jnp.int32(2), gt_labels)], w, warp_stride=2,
        warp_impl="gather")
    got, got_seq = th.evaluate_weights(
        [(_port_pre(want_pre), torch.from_numpy(gt), 2, gt_labels)], w, warp_stride=2,
        warp_impl="gather")
    assert abs(got - want) <= 1e-9
    assert abs(got_seq[0]["J"] - want_seq[0]["J"]) <= 1e-9


def test_precompute_split_reads_the_tree(setup, tmp_path):
    """precompute_split over a DAVIS tree of 90×120 frames: each sequence's
    arrays are precompute_sequence's on its padded frames, its label maps
    cropped back to 90×120."""
    from premvos_tpu_torch.data.davis import DavisDataset, make_synthetic_davis

    tm = setup[0]
    root = make_synthetic_davis(tmp_path / "davis", sequences=("a", "b"), t=3, hw=(90, 120))
    ds = DavisDataset(root)
    out = th.precompute_split(tm, TCFG, ds, verbose=False, device="cpu")
    assert len(out) == 2
    seq = ds.load_sequence("b", H, W, 2)
    pre, gt_masks, n_obj, gt_labels = out[1]
    assert n_obj == 2 and gt_labels.shape == (3, 90, 120)
    np.testing.assert_array_equal(gt_labels, seq["gt_labels"][:, :90, :120])
    want = tr.precompute_sequence(tm, TCFG, seq["frames"], seq["gt_masks"], 2, device="cpu")
    for k in want:
        assert torch.equal(pre[k], want[k]), k
    score, per_seq = th.evaluate_weights(out, th.weights_from_merge_cfg(TCFG.merge), 2)
    assert 0.0 <= score <= 1.0 and len(per_seq) == 2
