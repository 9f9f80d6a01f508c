"""Run one cell of the port's benchmark once and print its result.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The last line of standard output is one JSON
object: correct, attempted, failed, metrics (the cell's end-to-end metrics,
or with --trace 1 its per-layer metrics), device, with --trace 1 a
breakdown, and last `checks`, each compared number beside its limit (also
the last lines of standard error). It exits non-zero, printing no result,
without a CUDA card (or with fewer than the cell asks for), when
premvos_tpu_torch is not the checkout's own, or when the process has
loaded JAX or the JAX package.
"""

from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "premvos_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name (before the first dot), compared
    whole, is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def _refuse(msg: str, code: int = 2):
    print(f"portbench: {msg}", file=sys.stderr, flush=True)
    sys.exit(code)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from portbench import harness

    bench = harness.load_bench(ROOT)
    cell, _, _ = harness.cell_files(bench, args.workload, ROOT)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        _refuse(f"{args.workload} needs {cell['chips']} CUDA card(s); this process sees "
                f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
    try:
        import premvos_tpu_torch
    except ImportError as e:
        _refuse(f"the program is not in this checkout: {e}")
    if ROOT not in Path(premvos_tpu_torch.__file__).resolve().parents:
        _refuse(f"premvos_tpu_torch is loaded from {premvos_tpu_torch.__file__}, not from {ROOT}")
    torch.set_num_threads(2)
    res = harness.run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                           t_process=T_PROCESS)
    found = forbidden_modules()
    if found:
        _refuse(f"the process loaded {found}", 3)
    if args.trace:
        metrics = res["per_layer"]
    else:
        metrics = {"tracked_fps": {"value": res["tracked_fps"], "unit": "frames/s"},
                   "setup_s": {"value": res["setup_s"], "unit": "s"}}
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": cell["chips"],
              "memory_peak_bytes": res["memory_peak_bytes"]}
    if args.trace:
        device.update(busy_s=res["busy_s"], window_s=res["window_s"])
    out = {"correct": res["correct"], "attempted": res["attempted"], "failed": res["failed"],
           "metrics": metrics, "device": device}
    if args.trace:
        out["breakdown"] = res["breakdown"]
    out["checks"] = res["checks"]
    print(f"portbench: {args.workload} seed {args.seed}: window {res['window_s']:.3f} s, "
          f"{res['attempted']} sequences, {res['tracked_frames']} tracked frames, "
          f"peak {res['memory_peak_bytes']} bytes, launches {res['launches']}, set-up "
          f"{res['setup_s']:.3f} s {res['setup_parts']}, "
          f"check {res['check_s']:.1f} s, checked sequences' share of pixels labelled after "
          f"frame 0 {res['labelled_share']}", file=sys.stderr)
    print("portbench: per sequence (tracked frames, s in run_sequence, s to labels on the "
          f"host): {[(t, round(a, 4), round(b, 4)) for t, a, b in res['per_sequence']]}",
          file=sys.stderr)
    for name, c in res["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
