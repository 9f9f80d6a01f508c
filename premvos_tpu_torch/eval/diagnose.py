"""Selection-loss diagnosis for the held-out synthetic benchmark (port of
scripts/diagnose_benchmark.py).

Replays the merge frame by frame over precomputed stage outputs and puts
each object-frame into one class, which says where J&F is lost:

  detector_miss    the best valid proposal's IoU with the ground truth is
                   below 0.3: stages 1-2 made no usable mask
  refine_quality   that oracle IoU is in [0.3, 0.7): a proposal exists but
                   its mask is poor
  selection_error  the merge picked a proposal at least 0.1 IoU worse than
                   the oracle pick; the term (objectness, reid, warp,
                   overlap) that most favoured the picked proposal over
                   the oracle one is blamed
  false_absent_no_proposal    visible, declared absent, and no proposal
                              reached 0.3 IoU (the detector's fault)
  false_absent_with_proposal  declared absent despite a proposal of 0.3
                              IoU or more (the merge's fault)
  false_present    absent in the ground truth, but the tracker emitted it
  ok               otherwise

It runs on the card (`--device`, CUDA by default: it raises without one)
through the port's `precompute_split` and `merge_frame`.

  python -m premvos_tpu_torch.eval.diagnose --load-params CKPT \\
      --data-root DIR --canvas 128 192 [--weights configs/merge_tuned_torch.json]
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from premvos_tpu_torch.config import MergeConfig
from premvos_tpu_torch.data.davis import DavisDataset
from premvos_tpu_torch.eval.harness import DEFAULT_WEIGHTS, WEIGHT_NAMES, precompute_split
from premvos_tpu_torch.eval.synthetic_benchmark import bench_config
from premvos_tpu_torch.ops.masks import soft_mask_iou
from premvos_tpu_torch.pipeline.runner import (
    build_models,
    float32_precision,
    resolve_device,
)
from premvos_tpu_torch.stages.flow import warp_masks_coarse
from premvos_tpu_torch.stages.merge import init_state, merge_frame
from premvos_tpu_torch.stages.reid import reid_similarity
from premvos_tpu_torch.utils.checkpoint import load_params

PRE_KEYS = ("prop_masks", "scores", "emb", "valid", "flow")
# Each scored object-frame falls in exactly one class.
CLASSES = ("ok", "detector_miss", "refine_quality", "selection_error",
           "false_absent_no_proposal", "false_absent_with_proposal", "false_present")


def term_matrices(state, warped, pre_t, cfg_m) -> dict:
    """The four score terms [K, N] of one frame as float32 numpy arrays:
    objectness, ReID similarity, the staleness-decayed warp IoU and the
    (negated) overlap with the other objects' warped masks."""
    pm, sc, em = pre_t["prop_masks"], pre_t["scores"], pre_t["emb"]
    warp_iou = soft_mask_iou(warped, pm).cpu().numpy()
    sim = reid_similarity(state.ref_emb, em, cfg_m.reid_sigma).cpu().numpy()
    total = torch.sum(warped, dim=0, keepdim=True)
    other = torch.clamp(total - warped, 0.0, 1.0)
    overlap = soft_mask_iou(other, pm).cpu().numpy()
    decay = torch.pow(
        torch.tensor(cfg_m.warp_decay, dtype=torch.float32, device=warped.device),
        state.staleness.to(torch.float32),
    ).cpu().numpy()
    obj = np.broadcast_to(sc.cpu().numpy()[None, :], warp_iou.shape)
    return {
        "objectness": cfg_m.w_objectness * obj,
        "reid": cfg_m.w_reid * sim,
        "warp": cfg_m.w_warp * decay[:, None] * warp_iou,
        "overlap": -cfg_m.w_overlap * overlap,
    }


@float32_precision()
def diagnose_sequence(pre, gt_masks, n_obj, gt_labels, cfg_m, seq_name):
    """One precomputed sequence (`precompute_split`'s entry: pre and
    gt_masks on one device, gt_labels [T, h, w] numpy at the sequence's own
    size). Returns (counts, term_blame, events)."""
    k = int(n_obj)
    t_steps = int(pre["scores"].shape[0])
    h, w = gt_labels.shape[1], gt_labels.shape[2]
    counts = {"frames_objects": 0, **dict.fromkeys(CLASSES, 0)}
    term_blame = {"objectness": 0, "reid": 0, "warp": 0, "overlap": 0}
    events = []
    with torch.inference_mode():
        gt_masks = torch.as_tensor(gt_masks, device=pre["scores"].device).to(torch.float32)
        state = init_state(gt_masks, pre["gt_emb"], k)
        for t in range(t_steps):
            pre_t = {kk: pre[kk][t] for kk in PRE_KEYS}
            warped = warp_masks_coarse(state.prev_masks, pre_t["flow"], cfg_m.warp_stride,
                                       cfg_m.warp_impl)
            terms = term_matrices(state, warped, pre_t, cfg_m)
            new_state, _, info = merge_frame(
                state, pre_t["prop_masks"], pre_t["scores"], pre_t["emb"],
                pre_t["valid"], pre_t["flow"], cfg_m,
            )
            assign = info["assign"].cpu().numpy()
            present = info["present"].cpu().numpy()

            pm = pre_t["prop_masks"].float().cpu().numpy()[:, :h, :w]
            va = pre_t["valid"].cpu().numpy()
            gt_t = gt_labels[t + 1]

            for ki in range(k):
                g = (gt_t == ki + 1).astype(np.float32)
                gt_vis = g.sum() > 0
                if not gt_vis and not present[ki]:
                    continue  # correctly absent: not a scored opportunity
                counts["frames_objects"] += 1
                if not gt_vis and present[ki]:
                    counts["false_present"] += 1
                    events.append({"seq": seq_name, "t": t + 1, "obj": ki + 1,
                                   "kind": "false_present"})
                    continue
                inter = np.minimum(pm, g[None]).sum((1, 2))
                union = np.maximum(pm, g[None]).sum((1, 2))
                ious = np.where(va, inter / np.maximum(union, 1e-6), 0.0)
                ob = int(np.argmax(ious))
                oracle_iou = float(ious[ob])
                if not present[ki]:
                    kind = ("false_absent_no_proposal" if oracle_iou < 0.3
                            else "false_absent_with_proposal")
                    counts[kind] += 1
                    events.append({"seq": seq_name, "t": t + 1, "obj": ki + 1,
                                   "kind": kind, "oracle_iou": round(oracle_iou, 3)})
                    continue
                sel = int(assign[ki])
                sel_iou = float(ious[sel]) if sel >= 0 else 0.0
                if oracle_iou < 0.3:
                    counts["detector_miss"] += 1
                    events.append({"seq": seq_name, "t": t + 1, "obj": ki + 1,
                                   "kind": "detector_miss", "oracle_iou": round(oracle_iou, 3)})
                elif sel_iou + 0.1 < oracle_iou:
                    counts["selection_error"] += 1
                    # the term that pushed the picked proposal above the oracle one
                    diffs = {name: float(m[ki, sel] - m[ki, ob]) for name, m in terms.items()}
                    blame = max(diffs, key=lambda n: diffs[n])
                    term_blame[blame] += 1
                    events.append({
                        "seq": seq_name, "t": t + 1, "obj": ki + 1,
                        "kind": "selection_error",
                        "oracle_iou": round(oracle_iou, 3),
                        "picked_iou": round(sel_iou, 3),
                        "term_diff_picked_minus_oracle":
                            {n: round(v, 3) for n, v in diffs.items()},
                        "blame": blame,
                    })
                elif oracle_iou < 0.7:
                    counts["refine_quality"] += 1
                else:
                    counts["ok"] += 1
            state = new_state
    return counts, term_blame, events


def merge_weights(path) -> np.ndarray:
    """The [9] weight vector of a tuned record's "weights" (the protocol's
    --tuned-out file), MergeConfig's default for any name it lacks; the
    defaults without a file."""
    if not path:
        return np.asarray(DEFAULT_WEIGHTS)
    with open(path) as f:
        wd = json.load(f)["weights"]
    return np.array([wd.get(n, d) for n, d in zip(WEIGHT_NAMES, DEFAULT_WEIGHTS)], np.float32)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--load-params", required=True,
                    help="the protocol's --save-params checkpoint (orbax directory or .pt)")
    ap.add_argument("--data-root", required=True)
    ap.add_argument("--split", default="val")
    ap.add_argument("--canvas", type=int, nargs=2, default=None)
    ap.add_argument("--weights", default=None,
                    help="a tuned record ({\"weights\": {...}}); the defaults otherwise")
    ap.add_argument("--score-threshold", type=float, default=None)
    ap.add_argument("--max-proposals", type=int, default=None)
    ap.add_argument("--warp-stride", type=int, default=1)
    ap.add_argument("--device", default=None,
                    help="default: cuda (raises without a card); cpu runs the plain versions")
    ap.add_argument("--out", default=None)
    ap.add_argument("--max-events", type=int, default=40)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    cfg = bench_config(args.score_threshold, args.max_proposals,
                       tuple(args.canvas) if args.canvas else None)
    models = load_params(args.load_params, build_models(cfg, device))
    wvec = merge_weights(args.weights)
    cfg_m = MergeConfig(**dict(zip(WEIGHT_NAMES, [float(x) for x in wvec])),
                        warp_stride=args.warp_stride)

    ds = DavisDataset(args.data_root, split=args.split)
    pre = precompute_split(models, cfg, ds, device=device)

    total, blame_total, all_events = {}, {}, []
    for (p_, gm, no, gl), seq in zip(pre, ds.sequences):
        counts, blame, events = diagnose_sequence(p_, gm, no, gl, cfg_m, seq)
        print(f"[diagnose] {seq}: {counts}", flush=True)
        for kk, v in counts.items():
            total[kk] = total.get(kk, 0) + v
        for kk, v in blame.items():
            blame_total[kk] = blame_total.get(kk, 0) + v
        all_events.extend(events)

    report = {
        "weights": dict(zip(WEIGHT_NAMES, [float(x) for x in wvec])),
        "counts": total,
        "selection_error_term_blame": blame_total,
        "events": all_events[: args.max_events],
    }
    print(json.dumps({kk: report[kk] for kk in ("counts", "selection_error_term_blame")},
                     indent=2))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=2)
        print(f"[diagnose] report → {args.out}")
    return report


if __name__ == "__main__":
    main()
