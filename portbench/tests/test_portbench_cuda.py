"""On the card: one short run of each cell through the benchmark's command,
and the control on one seed, at the cells' own sizes. Marked `cuda`; each
test decides inside itself whether there is a card.

    python3 -m pytest -q -m cuda portbench/tests
"""

from __future__ import annotations

import json
import subprocess
import sys

import pytest
import torch

from portbench import harness
from portbench.harness import ROOT

CELLS = [w["name"] for w in harness.load_bench()["workloads"]]


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the port's kernels have no CPU mode")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_a_short_run_is_correct(cell):
    _need_card()
    out = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", cell,
                          "--seed", str(2 ** 31 + 99), "--seconds", "3", "--trace", "0"],
                         cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"], res["checks"]
    assert res["device"]["platform"] == "gpu" and res["metrics"]["tracked_fps"]["value"] > 0


@pytest.mark.cuda
def test_the_control_fails_on_the_card():
    _need_card()
    res = harness.run_cell(CELLS[0], 2 ** 31 + 98, 1.0, False, system=harness.ReferenceSystem)
    assert not res["correct"], res["checks"]
