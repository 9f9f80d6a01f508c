"""The harness is driven by data: a cell added as files runs without a code
change; BENCHMARK.json keeps to its contract; the metric readers compute
what their files say; the FLOP counts kept as data are the reference's."""

from __future__ import annotations

import json
import re

import pytest
import torch

from portbench import harness, roofline, trace as tr
from portbench.flops import flops_per_tracked_frame
from portbench.harness import ROOT
from portbench.reference import pipeline as ref
from portbench.tests.tiny import CELL, tiny_root

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


@pytest.fixture
def few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def test_a_cell_added_as_files_runs(tmp_path, few_threads):
    root = tiny_root(tmp_path)
    res = harness.run_cell(CELL, 2 ** 31 + 12345, 0.1, False, device="cpu", root=root)
    assert res["correct"], res["checks"]
    assert res["attempted"] >= 2 and res["tracked_frames"] >= 11
    assert set(res["checks"]) == {"labels", "detections", "maskrcnn", "refine", "flow", "reid"}
    assert all(v > 0 for v in res["labelled_share"]), "the checked clips track nothing"


def test_benchmark_json_keeps_to_its_contract():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"] and 1 <= BENCH["run_seconds"] <= 51
    configs = {c["name"]: c for c in BENCH["configs"]}
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and NAME.match(c["name"])
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert set(cfg["limits"]) == {"labels", "detections", "maskrcnn", "refine", "flow",
                                      "reid"}
    cells = [w["name"] for w in BENCH["workloads"]]
    assert len(set(cells)) == len(cells)
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and w["config"] in configs and w["chips"] == 1
        assert len(w["why"]) <= 200 and (ROOT / "portbench" / "traffic" /
                                         f"{w['traffic']}.json").exists()
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(set(names)) == len(names) and "setup_s" in names
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower",
                                                                                  "higher")
    for m in BENCH["per_layer"]:
        assert (ROOT / "portbench" / "metrics" / f"{m['name']}.py").exists()
        assert m["moves"] == "tracked_fps" and set(m["workloads"]) <= set(cells)


def _op(name, start, dur, owner=None, kind="kernel"):
    return tr.Op(name, start, start + dur, kind, owner)


def test_metric_readers_compute_what_they_say():
    cfg = json.loads((ROOT / "portbench" / "configs" / "davis2017_val.json").read_text())
    flow_warps = roofline.flow_block_warps(cfg)
    merge = roofline.merge_block_warp(cfg)
    corr = roofline.flownetc_correlation(cfg)
    assert len(flow_warps) == 4 and merge is not None
    ms = 1_000_000
    ops = [_op("conv_refine", 0, 10 * ms, "refine"), _op("conv_flow", 10 * ms, 2 * ms, "flow")]
    ops += [_op(f"resample_block_staged<{i}>", (12 + i) * ms, ms, "flow") for i in range(4)]
    ops += [_op("corr_kernel<bf16>", 16 * ms, ms, "flow")]
    ops += [_op("resample_block_direct", 18 * ms, ms // 10), _op("Memcpy HtoD", 19 * ms, ms,
                                                                 kind="memcpy")]
    t = tr.Trace(window_s=0.040, tracked_frames=2, ops=ops, host_run_s=0.010, launches={},
                 cfg=cfg, ranges=[("portbench.loop", 0, 40 * ms)])
    read = {m["name"]: harness.metric_reader(m["name"]).read(t) for m in BENCH["per_layer"]}
    assert read["nets.refine_ms"] == pytest.approx(5.0)
    assert read["nets.flow_ms"] == pytest.approx(3.5)
    assert read["stages.outside_nets_ms"] == pytest.approx(0.05)
    assert read["runner.enqueue_share"] == pytest.approx(25.0)
    assert read["kernels.block_warp_roofline"] == pytest.approx(
        100 * (sum(flow_warps) + merge) / 0.0041)
    assert read["kernels.correlation_roofline"] == pytest.approx(100 * corr / 0.001)
    assert read["device.idle_share"] == pytest.approx(100 * (1 - 0.0181 / 0.040))
    assert read["mfu.track"] == pytest.approx(
        100 * 2 * cfg["flops_per_tracked_frame"] / 0.040 / 989e12)
    assert tr.idle_gaps(t, 2) == [["loop", pytest.approx(0.001)],
                                  ["upload", pytest.approx(0.0009)]]
    empty = tr.Trace(0.040, 2, [], 0.0, {}, cfg)
    for name in ("nets.refine_ms", "kernels.block_warp_roofline",
                 "kernels.correlation_roofline"):
        assert harness.metric_reader(name).read(empty) is None


@pytest.mark.parametrize("name", sorted(c["name"] for c in BENCH["configs"]))
def test_flops_kept_as_data_are_the_references(name):
    path = ROOT / "portbench" / "configs" / f"{name}.json"
    assert flops_per_tracked_frame(ref.load_config(path)) == json.loads(
        path.read_text())["flops_per_tracked_frame"]
