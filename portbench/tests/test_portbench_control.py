"""The comparison that decides `correct` fails what it must: the control
(the reference put in the program's place one precision below the
configuration's: fp8 for bf16, TF32 for float32) and the program with its
timed path broken underneath: a step that returns its state unchanged, half
of the batch left out (the mean of the rest in its place), an answer
altered where it is produced, and an NMS that suppresses nothing. (One
chip: no exchange between chips to leave out.) The tiny configuration, on
the CPU, in both its variants (davis2017_val's departures and
fast_flownetc's); the run's look for a chip is skipped, the rest of it
runs."""

from __future__ import annotations

import pytest
import torch

from portbench import harness
from portbench.tests.tiny import CELL, VARIANTS, tiny_root


@pytest.fixture(params=sorted(VARIANTS))
def root(tmp_path, request):
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield tiny_root(tmp_path, request.param)
    torch.set_num_threads(prev)


def _run(root, system=None, seed=2 ** 33 + 7):
    return harness.run_cell(CELL, seed, 0.1, False, device="cpu", root=root, system=system)


def _failed(res) -> list:
    return [k for k, c in res["checks"].items() if c["value"] > c["limit"]]


def test_the_sound_program_passes(root):
    res = _run(root)
    assert res["correct"] and not _failed(res), res["checks"]


def test_the_control_fails(root):
    res = _run(root, harness.ReferenceSystem)
    assert not res["correct"]
    assert {"maskrcnn", "refine", "flow", "reid"} <= set(_failed(res)), res["checks"]


@pytest.mark.parametrize("which", ["proposals", "detections"])
def test_an_nms_that_suppresses_nothing_fails(root, monkeypatch, which):
    from premvos_tpu_torch.models import maskrcnn, rpn

    def top_scores(boxes, scores, max_outputs, iou_threshold=0.5, score_threshold=-1e10,
                   valid=None):
        if valid is not None:
            scores = torch.where(valid, scores, torch.full_like(scores, -1e10))
        order = torch.sort(-scores, dim=-1, stable=True).indices[:, :max_outputs]
        keep = torch.gather(scores, -1, order) > score_threshold
        return torch.where(keep, order, -1).to(torch.int32), keep

    monkeypatch.setattr({"proposals": rpn, "detections": maskrcnn}[which], "nms", top_scores)
    res = _run(root)
    assert not res["correct"], res["checks"]
    assert ("maskrcnn" if which == "proposals" else "detections") in _failed(res), res["checks"]


def test_a_merge_that_returns_its_state_unchanged_fails(root, monkeypatch):
    from premvos_tpu_torch.pipeline import runner

    real = runner.merge_frame

    def stuck(state, *args, **kwargs):
        _, labels, info = real(state, *args, **kwargs)
        return state, labels, info

    monkeypatch.setattr(runner, "merge_frame", stuck)
    res = _run(root)
    assert not res["correct"] and "labels" in _failed(res), res["checks"]


@pytest.mark.parametrize("net", ["refine", "flow"])
def test_half_the_batch_left_out_fails(root, monkeypatch, net):
    from premvos_tpu_torch.models import deeplab, flownet

    cls = {"refine": deeplab.DeepLabV3Plus, "flow": flownet.FlowNet2}[net]
    real = cls.forward

    def half(self, *xs):
        n = xs[0].shape[0] // 2
        out = real(self, *(x[:n] for x in xs))
        return torch.cat([out, out.mean(0, keepdim=True).expand(xs[0].shape[0] - n,
                                                                 *out.shape[1:])])

    monkeypatch.setattr(cls, "forward", half)
    res = _run(root)
    assert not res["correct"] and net in _failed(res), res["checks"]


def test_an_answer_altered_where_it_is_produced_fails(root, monkeypatch):
    from premvos_tpu_torch.pipeline import runner

    real = runner.merge_frame

    def altered(*args, **kwargs):
        state, labels, info = real(*args, **kwargs)
        return state, torch.where(labels == 0, 0, labels % 2 + 1), info

    monkeypatch.setattr(runner, "merge_frame", altered)
    res = _run(root)
    assert not res["correct"] and "labels" in _failed(res), res["checks"]
