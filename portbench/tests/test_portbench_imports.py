"""What a benchmark run imports: no module whose top-level name (before the
first dot), compared whole, is jax, jaxlib, flax or premvos_tpu (the JAX
package; the port's name only begins with it), and the reference nothing of
the program."""

from __future__ import annotations

import json
import subprocess
import sys

from portbench.harness import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "premvos_tpu"}
HARNESS = ("portbench.run", "portbench.harness", "portbench.check", "portbench.control",
           "portbench.trace", "portbench.roofline", "portbench.frames", "portbench.weights",
           "portbench.flops")
REFERENCE = ("portbench.reference.ops", "portbench.reference.nets",
             "portbench.reference.pipeline", "portbench.check", "portbench.weights",
             "portbench.frames")


def _loaded(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys, json\n"
                          "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
                         cwd=ROOT, capture_output=True, text=True, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_harness_and_readers_import_no_jax():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    code = "\n".join([f"import {m}" for m in HARNESS] + [
        "import premvos_tpu_torch.pipeline.runner",
        "from portbench.harness import metric_reader",
        *(f"metric_reader({m['name']!r})" for m in bench["per_layer"]),
    ])
    found = _loaded(code)
    assert "premvos_tpu_torch" in found  # the program is what the harness runs
    assert not found & FORBIDDEN, found & FORBIDDEN


def test_reference_imports_nothing_of_the_program():
    found = _loaded("\n".join(f"import {m}" for m in REFERENCE))
    assert not found & (FORBIDDEN | {"premvos_tpu_torch"}), found


def test_the_run_refuses_a_process_that_loaded_jax(monkeypatch):
    from portbench import run

    monkeypatch.setitem(sys.modules, "jaxlib.xla_client", object())
    assert run.forbidden_modules() == ["jaxlib"]
    monkeypatch.delitem(sys.modules, "jaxlib.xla_client")
    monkeypatch.setitem(sys.modules, "premvos_tpu_torch_like", object())
    assert run.forbidden_modules() == []
