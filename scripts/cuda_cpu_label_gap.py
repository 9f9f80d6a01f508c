#!/usr/bin/env python3
"""Where the card's and the CPU's labels part at davis2017_val, on one CUDA
card.

    python3 scripts/cuda_cpu_label_gap.py [--frames 3] [--json PATH]

Takes chip_smoke.py phase 7d's converted nets (seeded random source nets,
written in each source format and converted back) and its synthetic
480×864 frames, and for pipeline.dtype float32 and the preset's bfloat16:

- runs stages 1-4 (`precompute_sequence`) on the card and on the CPU;
- replays the merge with the preset's MergeConfig (`merge_frame`, as
  `run_sequence` does, and checked equal to the card's `run_sequence`)
  three ways: the card's stages merged on the card, the CPU's on the CPU,
  and the card's stages merged on the CPU — so a merge that differs by
  device shows apart from stages that differ;
- per step: whether the valid proposals match, the largest score, flow
  and embedding differences, the merge's picks and scores on both, and the
  selected masks' threshold flips with their distance to the threshold;
- object by object, over the pixels either labels: IoU of card against
  CPU, and of each device's bfloat16 labels against its float32 ones.

Prints one JSON object, and with --json writes it to PATH. Imports nothing
of JAX.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def replay(pre, gt, num_objects, device, merge_cfg):
    """run_sequence's merge loop over precomputed stages: labels [T, H, W]
    (numpy) and each step's merge info."""
    import torch

    from premvos_tpu_torch.pipeline.runner import _first_labels
    from premvos_tpu_torch.stages.merge import init_state, merge_frame

    with torch.inference_mode():
        gm = torch.as_tensor(gt, device=device).float()
        state = init_state(gm, pre["gt_emb"], num_objects)
        labels, infos = [_first_labels(gm, pre["gt_valid"])], []
        for t in range(pre["scores"].shape[0]):
            state, lab, info = merge_frame(
                state, pre["prop_masks"][t], pre["scores"][t], pre["emb"][t],
                pre["valid"][t], pre["flow"][t], merge_cfg)
            labels.append(lab)
            infos.append({k: v.cpu() for k, v in info.items()})
        return torch.stack(labels).cpu().numpy(), infos


def stage_gaps(pa, pb, ia, ib, threshold):
    """Per step, the card's stages (pa, merged into ia) against the CPU's
    (pb, ib)."""
    import torch

    rows = []
    for t in range(pa["scores"].shape[0]):
        va, vb = pa["valid"][t], pb["valid"][t]
        both = va & vb
        ma, mb = pa["prop_masks"][t].float(), pb["prop_masks"][t].float()
        row = dict(
            step=t + 1, valid_equal=bool(torch.equal(va, vb)), valid=int(va.sum()),
            score_max_abs=float((pa["scores"][t] - pb["scores"][t])[both].abs().max()),
            flow_max_abs=float((pa["flow"][t] - pb["flow"][t]).abs().max()),
            flow_max=float(pa["flow"][t].abs().max()),
            emb_max_abs=float((pa["emb"][t] - pb["emb"][t])[both].abs().max()),
            mask_max_abs=float((ma - mb).abs().max()),
            assign=([int(x) for x in ia[t]["assign"]], [int(x) for x in ib[t]["assign"]]),
            present=([bool(x) for x in ia[t]["present"]], [bool(x) for x in ib[t]["present"]]),
            merge_score=([float(x) for x in ia[t]["score"]], [float(x) for x in ib[t]["score"]]),
        )
        selected = []
        for k, j in enumerate(ia[t]["assign"].tolist()):
            if j < 0:
                continue
            a, b = ma[j], mb[j]
            flips = (a > threshold) != (b > threshold)
            near = torch.minimum((a - threshold).abs(), (b - threshold).abs())
            selected.append(dict(
                object=k + 1, proposal=j, area=(int((a > threshold).sum()), int((b > threshold).sum())),
                peak=(float(a.max()), float(b.max())), flips=int(flips.sum()),
                flip_distance_to_threshold_max=float(near[flips].max()) if flips.any() else None,
                within_2e_7_of_threshold=int(((a - threshold).abs() <= 2.0 ** -7).sum())))
        row["selected"] = selected
        rows.append(row)
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=3)
    ap.add_argument("--json", help="also write the result here")
    args = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("cuda_cpu_label_gap: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import chip_smoke as cs
    from premvos_tpu_torch import kernels
    from premvos_tpu_torch.config import load_config
    from premvos_tpu_torch.pipeline.runner import build_models, precompute_sequence, run_sequence

    kernels.build()
    kernels.load()
    cfg = load_config(os.path.join(REPO, "configs", "davis2017_val.json"))
    src, dst, _ = cs.converted_nets(np, torch, cfg)
    del src
    p = cfg.pipeline
    frames, gt = cs.synthetic_video(np, args.frames, p.image_height, p.image_width,
                                    p.max_objects, seed=2)
    out = dict(card=torch.cuda.get_device_name(0), frames=args.frames)
    labels = {}
    for dtype in ("float32", p.dtype):
        cfg_x = dataclasses.replace(cfg, pipeline=dataclasses.replace(p, dtype=dtype))
        on = {"cuda": build_models(cfg_x), "cpu": build_models(cfg_x, device="cpu")}
        for dev, models in on.items():
            for net in cs.NETS:
                getattr(models, net).load_state_dict(
                    {k: v.to(dev) for k, v in getattr(dst, net).state_dict().items()}, strict=True)
        pre = {dev: precompute_sequence(on[dev], cfg_x, frames, gt, 2, device=dev) for dev in on}
        pre_g_on_cpu = {k: v.cpu() for k, v in pre["cuda"].items()}
        l_gg, _ = replay(pre["cuda"], gt, 2, "cuda", cfg_x.merge)
        l_cc, i_cc = replay(pre["cpu"], gt, 2, "cpu", cfg_x.merge)
        l_gc, i_gc = replay(pre_g_on_cpu, gt, 2, "cpu", cfg_x.merge)
        run = run_sequence(on["cuda"], cfg_x, frames, gt, 2).cpu().numpy()
        labels["cuda", dtype], labels["cpu", dtype] = l_gg, l_cc
        k = p.max_objects
        out[dtype] = dict(
            replay_equals_run_sequence=bool(np.array_equal(l_gg, run)),
            card_merge_vs_cpu_merge_of_card_stages=cs.object_ious(np, l_gg, l_gc, k),
            cuda_vs_cpu=cs.object_ious(np, l_gg, l_cc, k),
            stages=stage_gaps(pre_g_on_cpu, pre["cpu"], i_gc, i_cc, cfg_x.merge.mask_threshold),
        )
        del on, pre
        torch.cuda.empty_cache()
    for dev in ("cuda", "cpu"):
        out[f"{dev}_{p.dtype}_vs_float32"] = cs.object_ious(
            np, labels[dev, p.dtype], labels[dev, "float32"], p.max_objects)
    text = json.dumps(out)
    print(text)
    if args.json:
        with open(args.json, "w") as f:
            f.write(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
