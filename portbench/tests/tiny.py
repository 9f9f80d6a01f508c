"""A benchmark root with one more cell, added as files only: the tiny
configuration and two short clips (tests/data), copied beside the
benchmark's own files, and their entries in a copy of BENCHMARK.json.

The tiny configuration comes in two variants: as tests/data has it
(FlowNet2, the merge warp at stride 2), and with fast_flownetc's departures
(FlowNetC alone, the merge warp at stride 1; crops and pastes at "highest"
in both)."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

from portbench.harness import ROOT

DATA = Path(__file__).resolve().parent / "data"
CELL = "tiny.tiny_clips"
VARIANTS = {"tiny": {},
            "tiny_fast": {"flow": {"variant": "flownetc"}, "merge": {"warp_stride": 1},
                          "refine": {"interp_precision": "highest"}}}


def tiny_root(tmp: Path, variant: str = "tiny") -> Path:
    """A root at `tmp` holding BENCHMARK.json and portbench/'s data and
    metric files, with the cell CELL added at the tiny configuration's
    `variant`."""
    shutil.copytree(ROOT / "portbench", tmp / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    tree = json.loads((DATA / "tiny.json").read_text())
    for group, values in VARIANTS[variant].items():
        tree[group] = {**tree[group], **values}
    (tmp / "portbench" / "configs" / "tiny.json").write_text(json.dumps(tree, indent=1))
    shutil.copy(DATA / "tiny_clips.json", tmp / "portbench" / "traffic" / "tiny_clips.json")
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiny", "source": "https://arxiv.org/abs/1807.09190",
                             "file": "portbench/configs/tiny.json", "reduced": [],
                             "why": "the CPU tests' toy widths"})
    bench["workloads"].append({"name": CELL, "config": "tiny", "traffic": "tiny_clips",
                               "chips": 1, "why": "the CPU tests' cell"})
    for m in bench["per_layer"]:
        m["workloads"].append(CELL)
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return tmp
