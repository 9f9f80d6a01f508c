"""One run of one cell: set-up, the measured window, the traced reading and
the comparison that decides `correct`.

Everything a cell needs is found by name: the cell in BENCHMARK.json, its
configuration in portbench/configs/<config>.json, its traffic in
portbench/traffic/<traffic>.json and each per-layer metric's reader in
portbench/metrics/<metric>.py. A new cell, configuration or metric is a new
file and a new entry, with no code changed here.

The window is a closed loop with one client, as an offline tracker works
through a dataset: the traffic's sequences in their order, cycling, each
handed to the program's `run_sequence` as host uint8 frames and its labels
read back to the host before the next begins. The window closes on the
clock at whole sequences: a sequence starts while less than `seconds` have
passed (and until those drawn for the check have run), and every sequence
started is finished and counted. Every sequence's frames are made in set-up.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import importlib.util
import json
import math
import time
from pathlib import Path

import numpy as np
import torch

from portbench import check, trace as tr
from portbench.frames import make_traffic
from portbench.reference import pipeline as ref
from portbench.weights import load, make_weights, sub_seed

ROOT = Path(__file__).resolve().parent.parent


def load_bench(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def cell_files(bench: dict, workload: str, root: Path = ROOT):
    """(cell entry, configuration path, traffic dict) of a cell name."""
    cells = {c["name"]: c for c in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no cell {workload!r} in BENCHMARK.json; cells: {sorted(cells)}")
    cell = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    cfg_path = root / configs[cell["config"]]["file"]
    with open(root / "portbench" / "traffic" / f"{cell['traffic']}.json") as f:
        traffic = json.load(f)
    return cell, cfg_path, traffic


def metric_reader(name: str, root: Path = ROOT):
    """The `read(trace)` of portbench/metrics/<name>.py."""
    path = root / "portbench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class PortSystem:
    """The system under test: premvos_tpu_torch's nets and `run_sequence`."""

    def __init__(self, cfg_path, weights: dict, device):
        from premvos_tpu_torch.config import load_config
        from premvos_tpu_torch.pipeline import runner

        self.runner, self.device = runner, torch.device(device)
        self.cfg = load_config(cfg_path)
        self.models = runner.build_models(self.cfg, device=self.device)
        load(self.models, weights)

    def run_sequence(self, seq):
        return self.runner.run_sequence(self.models, self.cfg, seq.frames, seq.gt_masks,
                                        seq.num_objects, seq.intro_frames, device=self.device)

    def launches(self) -> dict:
        """The kernel wrappers' launch counters (the program's own)."""
        from premvos_tpu_torch.ops import correlation, nms, resample2d, roi_align

        return {"nms": nms.nms_cuda.launches,
                "multilevel_roi_align": roi_align.multilevel_roi_align_cuda.launches,
                "correlation": correlation.correlation_cuda.launches,
                "resample2d_block": resample2d.resample2d_block_cuda.launches,
                "resample2d": resample2d.resample2d_cuda.launches}

    def close(self):
        self.models = None


class ReferenceSystem:
    """The control that the comparison must fail: the reference pipeline put
    in the program's place one precision below the configuration's (fp8
    nets; fp8 or TF32 crops, pastes and soft IoUs)."""

    def __init__(self, cfg_path, weights: dict, device):
        self.cfg = ref.load_config(cfg_path)
        self.models = ref.build_models(self.cfg, "fp8", device)
        load(self.models, weights)
        self.pipe = ref.Pipeline(self.cfg, self.models, device, control=True)

    def run_sequence(self, seq):
        return self.pipe.run_sequence(seq.frames, seq.gt_masks, seq.num_objects,
                                      seq.intro_frames)

    def launches(self) -> dict:
        return {}

    def close(self):
        self.models = self.pipe = None


class _Ranges:
    """Profiler ranges around each net's forward (traced runs only)."""

    def __init__(self, models):
        self.handles, self.open = [], {}
        for name in ref.Models._fields:
            net = getattr(models, name)
            self.handles.append(net.register_forward_pre_hook(self._enter(name)))
            self.handles.append(net.register_forward_hook(self._exit(name)))

    def _enter(self, name):
        def hook(module, args):
            rf = torch.autograd.profiler.record_function(tr.NET_RANGE + name)
            rf.__enter__()
            self.open[name] = rf
        return hook

    def _exit(self, name):
        def hook(module, args, out):
            self.open.pop(name).__exit__(None, None, None)
        return hook

    def remove(self):
        for h in self.handles:
            h.remove()


def _range(name, on):
    """A profiler range named for the benchmark, in traced runs only."""
    if on:
        return torch.autograd.profiler.record_function(tr.RANGE_PREFIX + name)
    return contextlib.nullcontext()


def _tracked(spec: dict) -> int:
    """A traffic file's sequence's tracked frames: those after the first."""
    return int(spec["frames"]) - 1


def checked_plan(traffic: dict, seed: int, chunk: int) -> dict:
    """{position in the window: chunks whose nets to check}: `sequences`
    positions drawn from the seed among the first `among_first`, and for each
    `net_chunks` of its chunks."""
    spec, specs = traffic["check"], traffic["sequences"]
    rng = np.random.default_rng(sub_seed(seed, 3))
    among = min(spec["among_first"], len(specs))
    plan = {}
    for pos in sorted(rng.choice(among, size=min(spec["sequences"], among), replace=False)):
        n_chunks = math.ceil(_tracked(specs[pos]) / chunk)
        k = min(spec["net_chunks"], n_chunks)
        plan[int(pos)] = sorted(int(c) for c in rng.choice(n_chunks, size=k, replace=False))
    return plan


def run_cell(workload: str, seed: int, seconds: float, trace: bool, device="cuda",
             t_process=None, system=None, root: Path = ROOT) -> dict:
    """One run of `workload`; returns the result's fields and the compared
    numbers. `system(cfg_path, weights, device)` builds the system under
    test (default: the program)."""
    t0 = time.perf_counter() if t_process is None else t_process
    device = torch.device(device)
    bench = load_bench(root)
    _, cfg_path, traffic = cell_files(bench, workload, root)
    with open(cfg_path) as f:
        cfg_file = json.load(f)
    cfg = ref.config_from_dict(cfg_file)
    system = system or PortSystem

    marks = [("start", time.perf_counter())]
    weights = make_weights(cfg, seed, device)
    marks.append(("weights", time.perf_counter()))
    sut = system(cfg_path, weights, device)
    del weights
    marks.append(("system", time.perf_counter()))
    plan = checked_plan(traffic, seed, cfg.pipeline.scan_chunk)
    seqs = make_traffic(traffic, cfg, seed, device)
    marks.append(("frames", time.perf_counter()))
    cap = check.Capture(sut.models)
    # Warm-up: one chunk of frames (the one shape the stages run at), the
    # merge and the read-back.
    warm = dataclasses.replace(seqs[0], frames=seqs[0].frames[:cfg.pipeline.scan_chunk + 1],
                               intro_frames=np.zeros_like(seqs[0].intro_frames))
    sut.run_sequence(warm).cpu()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    setup_s = time.perf_counter() - t0
    marks.append(("warm-up", time.perf_counter()))
    setup_parts = {"before": marks[0][1] - t0}
    setup_parts.update({name: t - marks[i][1] for i, (name, t) in enumerate(marks[1:])})

    ranges = _Ranges(sut.models) if trace else None
    prof = None
    if trace:
        from torch.profiler import ProfilerActivity, profile

        prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        prof.__enter__()
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    launches0 = sut.launches()
    kept, done, per_seq, host_run = {}, [], [], 0.0
    start = end = time.perf_counter()
    pos = 0
    with _range("loop", trace):
        while pos <= max(plan) or end - start < seconds:
            seq = seqs[pos % len(seqs)]
            if pos in plan:
                cap.start(plan[pos])
            with _range("run_sequence", trace):
                a = time.perf_counter()
                out = sut.run_sequence(seq)
                b = time.perf_counter()
            with _range("readback", trace):
                labels = out.cpu().numpy()
            end = time.perf_counter()
            host_run += b - a
            done.append(seq.tracked)
            per_seq.append((seq.tracked, b - a, end - a))
            if pos in plan:
                kept[pos] = (seq, labels, cap.stop(), plan[pos])
            pos += 1
    window_s = end - start
    launches = {k: v - launches0[k] for k, v in sut.launches().items()}
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    result = {
        "attempted": len(done),
        "window_s": window_s,
        "tracked_frames": sum(done),
        "setup_s": setup_s,
        "setup_parts": setup_parts,
        "tracked_fps": sum(done) / window_s,
        "memory_peak_bytes": peak,
        "launches": launches,
        "per_sequence": per_seq,
    }
    if trace:
        prof.__exit__(None, None, None)
        ranges.remove()
        ops, host_ranges = tr.read_profile(prof)
        del prof
        t = tr.Trace(window_s=window_s, tracked_frames=sum(done), ops=ops, host_run_s=host_run,
                     launches=launches, cfg=cfg_file, ranges=host_ranges)
        result["busy_s"] = t.busy_s()
        result["per_layer"] = {}
        for m in bench["per_layer"]:
            if workload not in m.get("workloads", [workload]):
                continue
            value = metric_reader(m["name"], root).read(t)
            if value is not None:
                result["per_layer"][m["name"]] = {"value": value, "unit": m["unit"]}
        result["breakdown"] = {"device_ops": tr.top_ops(t), "idle_gaps": tr.idle_gaps(t)}
        del t, ops
    cap.remove()
    sut.close()
    del sut
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    numbers = check.judge(cfg_path, seed, device, list(kept.values()))
    result["check_s"] = time.perf_counter() - t_check
    result["labelled_share"] = [float((lab[1:] > 0).mean()) for _, lab, _, _ in kept.values()]
    # A configuration compares the numbers its file gives a limit.
    limits = cfg_file["limits"]
    result["checks"] = {k: {"value": numbers[k], "limit": limits[k]}
                        for k in check.NUMBERS if k in limits}
    result["correct"] = all(c["value"] <= c["limit"] for c in result["checks"].values())
    result["failed"] = 0 if result["correct"] else 1
    return result
