"""The frozen reference against the program on the CPU at the tiny
configuration: the same labels and the same net outputs, at each of the
departures the benchmark's configurations take (FlowNetC alone, the merge
warp at stride 1, bf16 crops and pastes)."""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from portbench.frames import make_sequence
from portbench.reference import pipeline as ref
from portbench.tests.tiny import DATA
from portbench.weights import load, make_weights

VARIANTS = {
    "flownet2": {},
    "flownetc_stride1": {"flow": {"variant": "flownetc"}, "merge": {"warp_stride": 1}},
    "bf16_interp": {"refine": {"interp_precision": "default"}},
}


def rel_err(got, want) -> float:
    return (torch.linalg.vector_norm((got - want).double())
            / torch.linalg.vector_norm(want.double())).item()


def _tiny(overrides: dict) -> dict:
    tree = json.loads((DATA / "tiny.json").read_text())
    for group, values in overrides.items():
        tree[group] = {**tree[group], **values}
    return tree


@pytest.fixture(autouse=True)
def few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_reference_tracks_as_the_program(variant, tmp_path):
    from premvos_tpu_torch.config import load_config
    from premvos_tpu_torch.pipeline import runner

    tree = _tiny(VARIANTS[variant])
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps(tree))
    cfg_r = ref.load_config(path)
    cfg_p = load_config(path)
    weights = make_weights(cfg_r, 11, "cpu")
    ours = ref.build_models(cfg_r, torch.float32, "cpu")
    load(ours, weights)
    theirs = runner.build_models(cfg_p, device="cpu")
    load(theirs, weights)
    p = cfg_r.pipeline
    seq = make_sequence({"name": "s", "frames": 7, "objects": 2, "intro_frames": [0, 3]},
                        p.image_height, p.image_width, p.max_objects, 5, 0, "cpu")
    outs = {"ours": {}, "theirs": {}}
    for side, models in (("ours", ours), ("theirs", theirs)):
        for name in ref.Models._fields:
            getattr(models, name).register_forward_hook(
                lambda m, a, o, side=side, name=name: outs[side].setdefault(name, []).append(o))
    want = ref.Pipeline(cfg_r, ours, "cpu").run_sequence(seq.frames, seq.gt_masks,
                                                         seq.num_objects, seq.intro_frames)
    got = runner.run_sequence(theirs, cfg_p, seq.frames, seq.gt_masks, seq.num_objects,
                              seq.intro_frames, device="cpu")
    assert (got[1:] > 0).any(), "nothing tracked after frame 0: the comparison would hold nothing"
    # Frame 0 is the annotation; after it, independent runs may part on a
    # pixel whose mask lies within a rounding of the threshold (at bf16
    # pastes, one bf16 step), as the repository's own CPU tests allow.
    assert np.array_equal(got[0].numpy(), want[0].numpy())
    assert (got.numpy() != want.numpy()).mean() <= 0.01
    # Float32 nets on both sides: their outputs part by reordered sums
    # (1e-6 of their norm); bf16 crops round a few inputs the other way.
    tol = 1e-2 if variant == "bf16_interp" else 1e-4
    for name in ref.Models._fields:
        a, b = outs["theirs"][name], outs["ours"][name]
        assert len(a) == len(b)
        for x, y in zip(a, b):
            if isinstance(x, dict):
                assert torch.equal(x["valid"], y["valid"])
                x, y = x["mask_logits"], y["mask_logits"]
            assert rel_err(x, y) <= tol, (name, rel_err(x, y))
