"""The PyTorch port vs the JAX package on bridged weights: the four networks,
the merge step, stages 1–4 and `run_sequence` end to end.

One tiny configuration serves every test: depth-26 backbones, 32 FPN
channels, a 96×128 canvas with FlowNet2 at 64×64 (so the frame and mask
resizes downsample), the exact ("gather") warps on both sides (the block
warp has tests/test_torch_block_warp.py), merge warp stride 2, and T=4 with scan_chunk 2 (so the last chunk is padded). The JAX
parameters are initialised once per module and bridged into the port.
Everything runs in float32 on the CPU.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import premvos_tpu.config as jc
from premvos_tpu.pipeline import runner as jr
from premvos_tpu.stages import merge as jmerge
from premvos_tpu_torch import config as tc
from premvos_tpu_torch.bridge import params_from_jax
from premvos_tpu_torch.pipeline import runner as tr
from premvos_tpu_torch.stages import merge as tmerge
from tests._threads import few_threads  # noqa: F401

H, W, T = 96, 128, 4

JCFG = jc.PremvosConfig(
    proposal=jc.ProposalConfig(
        backbone_depth=26, fpn_channels=32, rpn_pre_nms_topk=32,
        rpn_post_nms_topk=8, detections_per_frame=4,
    ),
    refine=jc.RefineConfig(crop_size=33, backbone_depth=26),
    flow=jc.FlowConfig(
        variant="flownet2", max_displacement=4, infer_height=64,
        infer_width=64, warp_impl="gather",
    ),
    reid=jc.ReIDConfig(backbone_depth=26, embedding_dim=8, crop_size=32),
    # The score floor keeps random-weight tracking decisive: without it the
    # two objects end up holding the same (duplicate) proposal and their
    # scores tie to the last bit, so labels hinge on float rounding.
    merge=jc.MergeConfig(warp_stride=2, warp_impl="gather", new_object_score_floor=0.9),
    pipeline=jc.PipelineConfig(
        image_height=H, image_width=W, max_objects=2, max_proposals=4,
        dtype="float32", scan_chunk=2,
    ),
)
TCFG = tc._from_dict(tc.PremvosConfig, dataclasses.asdict(JCFG))


def _video():
    rng = np.random.default_rng(0)
    frames = rng.integers(0, 255, (T, H, W, 3)).astype(np.uint8)
    gt = np.zeros((2, H, W), np.float32)
    gt[0, 10:40, 10:50] = 1.0
    gt[1, 50:90, 60:120] = 1.0
    return frames, gt


@pytest.fixture(scope="module")
def bridged():
    jm = jr.build_models(JCFG)
    jp = jr.init_params(jm, JCFG, jax.random.PRNGKey(0))
    tm = tr.build_models(TCFG, device="cpu")
    params_from_jax(tm, jax.tree.map(np.asarray, jp))
    return jm, jp, tm


def _nchw(x):
    return torch.from_numpy(np.array(x)).permute(0, 3, 1, 2)


def _close(got, want, rel=1e-4):
    """|got − want| ≤ rel · max|want| (float32 reassociation between XLA and
    PyTorch convolutions; random weights give large activations)."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-6)
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, f"max |diff| {err} > {rel} * {scale}"


def test_config_presets_load_identically():
    import glob

    for path in glob.glob("configs/*.json"):
        assert dataclasses.asdict(tc.load_config(path)) == dataclasses.asdict(
            jc.load_config(path)
        ), path


def test_reid_and_deeplab_match_jax(bridged):
    jm, jp, tm = bridged
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, 32, 32, 3)).astype(np.float32)
    with torch.no_grad():
        _close(tm.reid(_nchw(x)), jm.reid.apply(jp["reid"], x))
        x = rng.standard_normal((2, 33, 33, 4)).astype(np.float32)
        _close(tm.refine(_nchw(x)), jm.refine.apply(jp["refine"], x))


def test_flownet2_matches_jax(bridged):
    jm, jp, tm = bridged
    rng = np.random.default_rng(2)
    x1 = rng.uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)
    x2 = rng.uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)
    want = jax.jit(jm.flow.apply)(jp["flow"], x1, x2)
    with torch.no_grad():
        got = tm.flow(_nchw(x1), _nchw(x2)).permute(0, 2, 3, 1)
    _close(got, want)


def test_maskrcnn_matches_jax(bridged):
    jm, jp, tm = bridged
    rng = np.random.default_rng(3)
    img = rng.standard_normal((2, H, W, 3)).astype(np.float32)
    want = jax.jit(jm.maskrcnn.apply)(jp["maskrcnn"], img, jr.get_anchors(JCFG))
    with torch.no_grad():
        got = tm.maskrcnn(_nchw(img), tr.get_anchors(TCFG, "cpu"))
    np.testing.assert_array_equal(got["valid"].numpy(), np.asarray(want["valid"]))
    for k in ("boxes", "scores", "mask_logits"):
        _close(got[k], want[k])


def test_merge_frame_matches_jax_exactly():
    """Three merge steps on the same inputs give identical labels, including
    an object introduced mid-sequence (the intro path)."""
    rng = np.random.default_rng(4)
    k, n, e = 3, 6, 8
    gt = np.zeros((k, H, W), np.float32)
    gt[0, 10:40, 10:50] = 1.0
    gt[1, 50:90, 60:120] = 1.0
    gt[2, 20:60, 70:100] = 1.0
    emb0 = rng.standard_normal((k, e)).astype(np.float32)
    cfg_j = jc.MergeConfig(warp_stride=2, warp_impl="gather", reid_ema=0.3)
    cfg_t = tc.MergeConfig(warp_stride=2, warp_impl="gather", reid_ema=0.3)
    js = jmerge.init_state(jnp.asarray(gt * [[[1]], [[1]], [[0]]]), jnp.asarray(emb0), 3)
    js = js._replace(active=jnp.asarray([True, True, False]))
    ts = tmerge.init_state(torch.from_numpy(gt * [[[1]], [[1]], [[0]]]).float(),
                           torch.from_numpy(emb0), 3)
    ts = ts._replace(active=torch.tensor([True, True, False]))
    for step in range(3):
        masks = np.zeros((n, H, W), np.float32)
        for i in range(n):
            y, x = rng.integers(0, H - 30), rng.integers(0, W - 40)
            masks[i, y:y + 30, x:x + 40] = rng.uniform(0.6, 1.0)
        scores = rng.uniform(0, 1, n).astype(np.float32)
        emb = rng.standard_normal((n, e)).astype(np.float32)
        valid = rng.uniform(0, 1, n) > 0.2
        flow = rng.uniform(-3, 3, (H, W, 2)).astype(np.float32)
        new_active = np.array([False, False, step == 1])
        js, lj, ij = jmerge.merge_frame(
            js, jnp.asarray(masks), jnp.asarray(scores), jnp.asarray(emb),
            jnp.asarray(valid), jnp.asarray(flow), cfg_j,
            intro=(jnp.asarray(new_active), jnp.asarray(gt)),
        )
        ts, lt, it = tmerge.merge_frame(
            ts, torch.from_numpy(masks), torch.from_numpy(scores),
            torch.from_numpy(emb), torch.from_numpy(valid),
            torch.from_numpy(flow).permute(2, 0, 1), cfg_t,
            intro=(torch.from_numpy(new_active), torch.from_numpy(gt)),
        )
        np.testing.assert_array_equal(lt.numpy(), np.asarray(lj))
        np.testing.assert_array_equal(it["assign"].numpy(), np.asarray(ij["assign"]))
        np.testing.assert_allclose(
            ts.prev_masks.numpy(), np.asarray(js.prev_masks), atol=1e-5
        )


def test_stages_batch_matches_jax(bridged):
    """Stages 1–4 on one chunk: masks, scores, embeddings, validity, flow."""
    jm, jp, tm = bridged
    frames, _ = _video()
    fu = frames.astype(np.float32) / 255.0
    anchors = jr.get_anchors(JCFG)
    want = jax.jit(lambda p, a, b: jr.stages_batch(jm, p, anchors, JCFG, a, b))(
        jp, fu[1:3], fu[0:2]
    )
    with torch.inference_mode():
        got = tr.stages_batch(
            tm, TCFG, tr.get_anchors(TCFG, "cpu"),
            torch.from_numpy(fu[1:3]), torch.from_numpy(fu[0:2]),
        )
    pm, sc, em, va, fl = got
    np.testing.assert_array_equal(va.numpy(), np.asarray(want[3]))
    _close(pm, want[0])
    _close(sc, want[1])
    _close(em, want[2])
    _close(fl.permute(0, 2, 3, 1), want[4])


def test_run_sequence_matches_jax(bridged):
    """The slice end to end: ≥ 99 % of label pixels agree, frame 0 exactly."""
    jm, jp, tm = bridged
    frames, gt = _video()
    want = np.asarray(
        jr.run_sequence(jm, jp, JCFG, jnp.asarray(frames), jnp.asarray(gt), 2)
    )
    got = tr.run_sequence(tm, TCFG, frames, gt, 2, device="cpu")
    assert got.dtype == torch.int32 and got.shape == (T, H, W)
    got = got.numpy()
    np.testing.assert_array_equal(got[0], want[0])
    assert (got == want).mean() >= 0.99
    assert set(np.unique(got)) <= {0, 1, 2}


def test_run_sequence_intro_frames_matches_jax(bridged):
    """YouTube-VOS style: object 2 is introduced at frame 2 (its reference
    embedding comes from that frame, and the frame emits its annotation).
    ≥ 99 % of label pixels agree, frame 0 exactly."""
    jm, jp, tm = bridged
    frames, gt = _video()
    intro = np.array([0, 2], np.int32)
    want = np.asarray(jr.run_sequence(
        jm, jp, JCFG, jnp.asarray(frames), jnp.asarray(gt), 2, jnp.asarray(intro)))
    got = tr.run_sequence(tm, TCFG, frames, gt, 2, intro_frames=intro, device="cpu").numpy()
    np.testing.assert_array_equal(got[0], want[0])
    assert (got == want).mean() >= 0.99
    assert not (got[:2] == 2).any() and (got[2] == 2).any()


def test_run_sequence_bf16_default_precision_matches_jax(bridged):
    """The production preset's numerics on the tiny configuration: bf16
    compute over float32 weights and bf16 interpolation matmuls
    (RefineConfig.interp_precision "default"), port against JAX on the same
    weights: ≥ 99 % of label pixels agree, frame 0 exactly."""
    _, jp, _ = bridged
    jcfg = dataclasses.replace(
        JCFG, pipeline=dataclasses.replace(JCFG.pipeline, dtype="bfloat16"),
        refine=dataclasses.replace(JCFG.refine, interp_precision="default"),
    )
    tcfg = tc._from_dict(tc.PremvosConfig, dataclasses.asdict(jcfg))
    jm = jr.build_models(jcfg)
    tm = params_from_jax(tr.build_models(tcfg, device="cpu"), jax.tree.map(np.asarray, jp))
    frames, gt = _video()
    want = np.asarray(jr.run_sequence(jm, jp, jcfg, jnp.asarray(frames), jnp.asarray(gt), 2))
    got = tr.run_sequence(tm, tcfg, frames, gt, 2, device="cpu").numpy()
    np.testing.assert_array_equal(got[0], want[0])
    assert (got == want).mean() >= 0.99
