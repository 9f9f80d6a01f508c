"""bfloat16 against float32 on the trained-accuracy demo's nets, in the JAX
package and in the port, on the CPU.

    JAX_PLATFORMS=cpu python -m tests._bf16_gap --checkpoint DIR [--json PATH]

DIR is `python -m premvos_tpu_torch.eval.synthetic_demo --save-params DIR`'s
orbax directory (both packages read it). The demo sequence is tracked four
ways: each package in float32 and in bfloat16 (pipeline.dtype "bfloat16",
refine.interp_precision "default", as chip_smoke.py phase 7i runs it),
the JAX merge on its exact ("gather") warp, which is the port's one warp.
Prints, object by object over the pixels either side labels (chip_smoke.py's
`object_ious`, with each object's pixel counts), each package's bfloat16
against its float32 labels and each dtype's port against JAX labels, and
each run's J&F: whether bfloat16 moves the JAX package's labels where it
moves the port's, which tells a fault of the port from bfloat16 itself.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import tempfile
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np

jax.config.update("jax_platforms", "cpu")

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "scripts"))

import chip_smoke  # noqa: E402
import train_synthetic_demo as jdemo  # noqa: E402
from premvos_tpu.pipeline import runner as jr  # noqa: E402
from premvos_tpu.utils.checkpoint import load_params as jax_load_params  # noqa: E402
from premvos_tpu_torch.data.davis import DavisDataset, make_synthetic_davis  # noqa: E402
from premvos_tpu_torch.eval.davis_eval import evaluate_sequence  # noqa: E402
from premvos_tpu_torch.eval.synthetic_demo import demo_config  # noqa: E402
from premvos_tpu_torch.pipeline import runner as tr  # noqa: E402
from premvos_tpu_torch.utils.checkpoint import load_params  # noqa: E402


def bf16(cfg):
    return dataclasses.replace(
        cfg, pipeline=dataclasses.replace(cfg.pipeline, dtype="bfloat16"),
        refine=dataclasses.replace(cfg.refine, interp_precision="default"))


def object_rows(a, b, k):
    """chip_smoke.object_ious per frame, with each object's pixels on
    both sides."""
    rows = chip_smoke.object_ious(np, a, b, k)
    for row, la, lb in zip(rows, a, b):
        row["pixels"] = {i: (int((la == i).sum()), int((lb == i).sum())) for i in row["iou"]}
    return rows


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--checkpoint", required=True)
    ap.add_argument("--json", default=None)
    args = ap.parse_args(argv)

    with tempfile.TemporaryDirectory() as tmp:
        root = make_synthetic_davis(Path(tmp) / "tree", sequences=("demo",), t=10,
                                    hw=(64, 96), num_objects=2)
        data = DavisDataset(root).load_sequence("demo", 64, 96, 2)
    n = int(data["num_objects"])
    labels = {}
    jcfg = jdemo.demo_config()
    jcfg = dataclasses.replace(jcfg, merge=dataclasses.replace(jcfg.merge, warp_impl="gather"))
    for dtype, jc, tc in (("float32", jcfg, demo_config()),
                          ("bfloat16", bf16(jcfg), bf16(demo_config()))):
        models = jr.build_models(jc)
        params = jax_load_params(args.checkpoint,
                                 like=dict(jr.init_params(models, jc, jax.random.PRNGKey(0))))
        labels["jax", dtype] = np.asarray(jr.run_sequence(
            models, params, jc, jnp.asarray(data["frames"]), jnp.asarray(data["gt_masks"]),
            jnp.int32(n)))
        port = load_params(args.checkpoint, tr.build_models(tc, device="cpu"))
        labels["port", dtype] = tr.run_sequence(port, tc, data["frames"], data["gt_masks"], n,
                                                device="cpu").numpy()
    gt = np.asarray(data["gt_labels"])
    report = {
        "J&F": {f"{pk}_{dt}": evaluate_sequence(lab, gt, n)["J&F"]
                for (pk, dt), lab in labels.items()},
        "jax_bfloat16_vs_float32": object_rows(labels["jax", "bfloat16"],
                                               labels["jax", "float32"], n),
        "port_bfloat16_vs_float32": object_rows(labels["port", "bfloat16"],
                                                labels["port", "float32"], n),
        "port_vs_jax_float32": object_rows(labels["port", "float32"], labels["jax", "float32"], n),
        "port_vs_jax_bfloat16": object_rows(labels["port", "bfloat16"],
                                            labels["jax", "bfloat16"], n),
    }
    text = json.dumps(report)
    print(text)
    if args.json:
        Path(args.json).write_text(text)
    return report


if __name__ == "__main__":
    main()
