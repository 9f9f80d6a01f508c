"""The port's data parallelism over videos on the CPU: the multi-video
refine fine-tune and sharded inference on two gloo ranks against the JAX
package at `make_mesh(2)`, `run_davis --finetune` under a process group,
and the CPU dry run. tests/test_torch_parallel.py holds the DP train steps
and the fused fine-tune; the two files build their JAX references and
spawn their ranks apart, so two pytest workers share the work.

The port's two ranks run in ONE spawn (premvos_tpu_torch.parallel.dryrun.
spawn) that runs every case of this file (tests/_parallel_ranks.py).

Bounds (those of the single-device parity tests): the multi-video losses
1e-4 relative (each package builds its own lucid pools,
tests/test_torch_pool_finetune.py); sharded inference ≥ 99 % of pixels and
frame 0 exact (tests/test_torch_pipeline.py).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import premvos_tpu.config as jc
from premvos_tpu.finetune import multi_video as jmv
from premvos_tpu.parallel import mesh as jmesh
from premvos_tpu.pipeline import runner as jr
from premvos_tpu_torch import config as tc
from premvos_tpu_torch.bridge import params_from_jax
from premvos_tpu_torch.parallel import dryrun
from premvos_tpu_torch.pipeline import runner as tr
from tests import _parallel_ranks
from tests._threads import few_threads  # noqa: F401
from tests.test_torch_cli import _davis_tree
from tests.test_torch_finetune import JREFINE, TREFINE
from tests.test_torch_parallel import _np_tree, _refine_case
from tests.test_torch_pipeline import JCFG as PIPE_JCFG
from tests.test_torch_pipeline import TCFG as PIPE_TCFG
from tests.test_torch_pipeline import _video
from tests.test_torch_pool_finetune import _frame_and_labels

FT_VIDEOS = dict(steps=2, batch_size=4, num_augmentations=4)


def _videos():
    videos = [_frame_and_labels(64, 64, seed=s) for s in (11, 12, 13)]
    for _, lab in videos:
        lab[lab == 2] = 0
    return videos


def _multi_video_case(refine):
    """JAX's finetune_refine_videos of 3 videos at make_mesh(2): padded to
    4, two a device."""
    ft = jc.FinetuneConfig(**FT_VIDEOS)
    _, jlosses = jmv.finetune_refine_videos(refine["jm"], refine["jp"], _videos(),
                                            jmesh.make_mesh(2), JREFINE, ft)
    return dict(jlosses=np.asarray(jlosses))


def _sharded_inputs():
    """Two 3-frame sequences of tests/test_torch_pipeline.py's canvas: its
    video and its mirror image."""
    frames, gt = _video()
    frames, gt = frames[:3], gt
    return (np.stack([frames, frames[:, :, ::-1]]), np.stack([gt, gt[:, :, ::-1]]),
            np.array([2, 2], np.int32))


def _sharded_case():
    jm = jr.build_models(PIPE_JCFG)
    jp = jr.init_params(jm, PIPE_JCFG, jax.random.PRNGKey(0))
    tm = params_from_jax(tr.build_models(PIPE_TCFG, device="cpu"), _np_tree(jp))
    frames, gt, nobj = _sharded_inputs()
    want = jmesh.run_sequences_sharded(jm, jp, PIPE_JCFG, jnp.asarray(frames), jnp.asarray(gt),
                                       nobj, jmesh.make_mesh(2))
    return dict(tm=tm, want=np.asarray(want))


@pytest.fixture(scope="module")
def jax_refs():
    refine = _refine_case()
    return dict(refine=refine, multi_video=_multi_video_case(refine), sharded=_sharded_case())


@pytest.fixture(scope="module")
def cli_tree(tmp_path_factory):
    """tests/test_torch_cli.py's DAVIS tree and tiny configuration, with a
    2-step fine-tune at batch 2 (one example a rank)."""
    d = tmp_path_factory.mktemp("dp_cli")
    cfg = dataclasses.replace(PIPE_TCFG, finetune=tc.FinetuneConfig(
        steps=2, chunk=2, batch_size=2, aug_patch=32))
    tc.save_config(d / "tiny.json", cfg)
    return dict(root=_davis_tree(d / "davis"), config=d / "tiny.json", out=d / "out")


@pytest.fixture(scope="module")
def ranks(jax_refs, cli_tree):
    """Every case of this file on two gloo ranks in one spawn."""
    r = jax_refs
    sd = lambda m: {k: v.clone() for k, v in m.state_dict().items()}  # noqa: E731
    cases = {
        "multi_video": ("multi_video", dict(cfg=TREFINE, ft=tc.FinetuneConfig(**FT_VIDEOS),
                                            state_dict=sd(r["refine"]["tm"]),
                                            videos=_videos())),
        "sharded": ("sharded", dict(
            cfg=PIPE_TCFG, state_dicts={n: sd(getattr(r["sharded"]["tm"], n))
                                        for n in ("maskrcnn", "refine", "flow", "reid")},
            frames=_sharded_inputs()[0], gt=_sharded_inputs()[1], num_objects=np.array([2, 2]))),
        "run_davis": ("run_davis", dict(argv=[
            "--davis_root", str(cli_tree["root"]), "--output", str(cli_tree["out"]),
            "--config", str(cli_tree["config"]), "--device", "cpu", "--finetune",
            "--sequences", "a"])),
    }
    return dryrun.spawn(_parallel_ranks.parity_rank, 2, "gloo", cases, device="cpu")


def test_multi_video_finetune_pads_as_jax(jax_refs, ranks):
    """3 videos over 2 ranks, padded to 4: every rank returns the 3 videos'
    losses (JAX's, 1e-4) and the same 3 tuned nets."""
    want = jax_refs["multi_video"]["jlosses"]
    assert want.shape == (3,)
    for r in ranks:
        np.testing.assert_allclose(r["multi_video"]["losses"], want, rtol=1e-4, atol=0)
    assert ranks[0]["multi_video"]["digests"] == ranks[1]["multi_video"]["digests"]
    assert len(set(ranks[0]["multi_video"]["digests"])) == 3


def test_run_sequences_sharded_matches_jax(jax_refs, ranks):
    """Two sequences, one a rank, gathered on both: each ≥ 99 % of JAX's
    labels, frame 0 exact, and equal to the port's own run_sequence."""
    want = jax_refs["sharded"]["want"]
    frames, gt, nobj = _sharded_inputs()
    for r in ranks:
        got = r["sharded"]["labels"]
        assert got.shape == want.shape == (2, 3, *frames.shape[2:4])
        for s in range(2):
            np.testing.assert_array_equal(got[s, 0], want[s, 0])
            assert (got[s] == want[s]).mean() >= 0.99
    alone = tr.run_sequence(jax_refs["sharded"]["tm"], PIPE_TCFG, frames[1], gt[1], 2,
                            device="cpu").numpy()
    np.testing.assert_array_equal(ranks[0]["sharded"]["labels"][1], alone)
    np.testing.assert_array_equal(ranks[0]["sharded"]["labels"], ranks[1]["sharded"]["labels"])


def test_run_davis_finetune_under_a_process_group(ranks, cli_tree):
    """`run_davis --finetune` started on two gloo ranks: both fine-tune
    over the mesh, rank 0 alone tracks, writes the PNGs and returns the
    summary."""
    summary = ranks[0]["run_davis"]["summary"]
    assert ranks[1]["run_davis"]["summary"] is None
    assert summary["frames"] == 3 and np.isfinite(summary["fps"])
    assert len(list((cli_tree["out"] / "a").glob("*.png"))) == 4


def test_dryrun_multichip_two_cpu_ranks(capfd):
    """dryrun_multichip(2, device="cpu") end to end: every part on both
    ranks, finite, the same on both."""
    out = dryrun.dryrun_multichip(2, device="cpu")
    assert len(out) == 2
    for r in out:
        assert all(np.isfinite(r[k]) for k in ("refine_loss", "maskrcnn_loss", "fused_loss"))
        assert r["video_losses"].shape == (2,) and np.isfinite(r["video_losses"]).all()
        assert r["labels_shape"] == (2, 2, 64, 64)
    assert out[0]["maskrcnn_loss"] == out[1]["maskrcnn_loss"]
    text = capfd.readouterr().out
    assert "sharded inference on 2 ranks" in text and "fused finetune" in text
