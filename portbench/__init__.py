"""The benchmark of premvos_tpu_torch (BENCHMARK.json): run.py runs one
cell; harness.py holds the window; frames.py and weights.py make the
inputs from the seed; check.py and reference/ decide `correct`; trace.py,
roofline.py and metrics/ read the per-layer metrics."""
