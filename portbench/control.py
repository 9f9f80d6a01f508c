"""The control of `correct`: the reference pipeline put in the program's
place and computed in fp8 (every operand that the configuration computes in
bfloat16 rounded to float8 e4m3: the nets' convolutions and matmuls, the
cost volume's features, the crop and paste matmuls), run through the same
window and comparison as the program. Every seed must come out not correct.

    python3 -m portbench.control --workload <cell> --seconds <s> --seeds <n> [<n> ...]

prints one JSON line a seed: the compared numbers and `correct`.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from portbench import harness


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("portbench.control: no CUDA card")
    for seed in args.seeds:
        res = harness.run_cell(args.workload, seed, args.seconds, False,
                               system=harness.ReferenceSystem)
        print(json.dumps({"workload": args.workload, "seed": seed, "correct": res["correct"],
                          "checks": res["checks"], "labelled_share": res["labelled_share"],
                          "attempted": res["attempted"], "window_s": res["window_s"],
                          "check_s": res["check_s"]}), flush=True)


if __name__ == "__main__":
    main()
