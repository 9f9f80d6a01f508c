"""Staged mode: the five-stage file-passing pipeline, one command per stage
(port of premvos_tpu/pipeline/run_stages.py, with its file contracts).

  proposals : frames → WORK/proposals/<seq>/frame_%05d.json (bbox, score,
              RLE mask)
  refine    : proposals JSON → the same JSON with refined RLE masks
  flow      : frame pairs → WORK/flow/<seq>/%05d.flo (the flow of frame t
              sampled back into frame t−1, [H, W, 2] at the canvas)
  reid      : proposals JSON → the same JSON with "ReID" embeddings
  merge     : JSONs + .flo + the first frame's annotation →
              WORK/results/<seq>/*.png (+ J&F where the annotations cover
              every frame)

  python -m premvos_tpu_torch.pipeline.run_stages <stage> --davis_root D \
      --seq NAME --work WORKDIR [--config cfg.json] [--checkpoint params.pt] \
      [--device cpu]

`--checkpoint` takes a utils/checkpoint.py save_params file or the JAX
package's orbax directory. The fused runner (pipeline/runner.py) is the
production path; the stages binarise masks into RLE between them, so their
labels differ from it.
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np
import torch

from premvos_tpu_torch.config import PremvosConfig, load_config
from premvos_tpu_torch.data.davis import DavisDataset, crop_result, save_results
from premvos_tpu_torch.data.preprocess import normalize, to_unit
from premvos_tpu_torch.io_compat.flo import read_flo, write_flo
from premvos_tpu_torch.io_compat.proposals_json import (
    FrameProposals,
    load_proposals,
    save_proposals,
)
from premvos_tpu_torch.pipeline.runner import (
    build_models,
    float32_precision,
    init_params,
    resolve_device,
)
from premvos_tpu_torch.utils.logging import get_logger


def _setup(args):
    device = resolve_device(args.device)
    cfg = load_config(args.config) if args.config else PremvosConfig()
    models = build_models(cfg, device)
    if args.checkpoint:  # every weight comes from the file: no random draw
        from premvos_tpu_torch.utils.checkpoint import load_params

        load_params(args.checkpoint, models)
    else:
        init_params(models, cfg, seed=0, device=device)
    ds = DavisDataset(args.davis_root)
    p = cfg.pipeline
    seq = ds.load_sequence(
        args.seq, p.image_height, p.image_width, p.max_objects, args.max_frames
    )
    return cfg, models, ds, seq, device


def _image(frame: np.ndarray, device) -> torch.Tensor:
    """[H, W, 3] uint8 frame → [1, 3, H, W] normalized on device."""
    return normalize(to_unit(torch.from_numpy(frame).to(device)))[None].permute(0, 3, 1, 2)


def stage_proposals(args):
    """Stage 1 → WORK/proposals/<seq>/frame_%05d.json, one frame at a time."""
    cfg, models, ds, seq, device = _setup(args)
    from premvos_tpu_torch.pipeline.runner import get_anchors
    from premvos_tpu_torch.stages.proposals import proposal_masks_fullres, run_proposals

    out = Path(args.work) / "proposals" / args.seq
    out.mkdir(parents=True, exist_ok=True)
    anchors = get_anchors(cfg, device)
    h, w = cfg.pipeline.image_height, cfg.pipeline.image_width
    for t, frame in enumerate(seq["frames"]):
        det = run_proposals(models.maskrcnn, torch.from_numpy(frame).to(device)[None], anchors)
        with torch.inference_mode(), float32_precision():
            masks = proposal_masks_fullres(
                det["boxes"][0], det["mask_logits"][0], det["valid"][0], h, w
            ) > 0.5
        props = FrameProposals(
            boxes=det["boxes"][0].cpu().numpy(),
            scores=det["scores"][0].cpu().numpy(),
            masks=masks.cpu().numpy().astype(np.uint8),
            valid=det["valid"][0].cpu().numpy(),
        )
        save_proposals(out / f"frame_{t:05d}.json", props)
    get_logger().info("proposals: wrote %d frames to %s", len(seq["frames"]), out)


def stage_refine(args):
    """Stage 2: rewrite the proposals JSON with refined masks. The crops
    and pastes run in float32 whatever refine.interp_precision says (as the
    JAX stage)."""
    cfg, models, ds, seq, device = _setup(args)
    from premvos_tpu_torch.ops.roi_align import crop_and_resize
    from premvos_tpu_torch.stages.refine import expand_boxes, refined_fullres

    props_dir = Path(args.work) / "proposals" / args.seq
    h, w = cfg.pipeline.image_height, cfg.pipeline.image_width
    s = cfg.refine.crop_size
    n = cfg.pipeline.max_proposals
    fmt = torch.channels_last if device.type == "cuda" else torch.contiguous_format
    for t in range(len(seq["frames"])):
        path = props_dir / f"frame_{t:05d}.json"
        props = load_proposals(path, n, (h, w))
        with torch.inference_mode(), float32_precision():
            img = _image(seq["frames"][t], device)
            boxes = torch.from_numpy(props.boxes).to(device)
            masks = torch.from_numpy(props.masks).to(device, torch.float32)
            valid = torch.from_numpy(props.valid).to(device)
            crop_boxes = expand_boxes(boxes, cfg.refine.box_margin, h, w)
            nrm = torch.stack(
                [crop_boxes[:, 1] / (h - 1), crop_boxes[:, 0] / (w - 1),
                 crop_boxes[:, 3] / (h - 1), crop_boxes[:, 2] / (w - 1)], -1)
            rgb = crop_and_resize(img, nrm[None], s)[0]  # [N, 3, S, S]
            # Each proposal's own mask, cropped at its own box.
            mask_ch = crop_and_resize(masks[:, None], nrm[:, None], s)[:, 0]  # [N, 1, S, S]
            crops = torch.cat([rgb, mask_ch], dim=1).contiguous(memory_format=fmt)
            logits = models.refine(crops)
            refined = refined_fullres(logits, crop_boxes, valid, h, w) > 0.5
        props.masks = refined.cpu().numpy().astype(np.uint8)
        save_proposals(path, props)
    get_logger().info("refine: rewrote %d frames in %s", len(seq["frames"]), props_dir)


def stage_flow(args):
    """Stage 3 → WORK/flow/<seq>/%05d.flo (flow of frame t → frame t−1)."""
    cfg, models, ds, seq, device = _setup(args)
    from premvos_tpu_torch.stages.flow import run_flow_pairs

    out = Path(args.work) / "flow" / args.seq
    out.mkdir(parents=True, exist_ok=True)
    frames = to_unit(torch.from_numpy(seq["frames"]).to(device))
    flow = run_flow_pairs(
        models.flow, frames, infer_hw=(cfg.flow.infer_height, cfg.flow.infer_width),
        chunk=cfg.pipeline.scan_chunk,
    )
    flow = flow.permute(0, 2, 3, 1).cpu().numpy()  # the file's [H, W, 2]
    for t in range(flow.shape[0]):
        write_flo(out / f"{t + 1:05d}.flo", flow[t])
    get_logger().info("flow: wrote %d fields to %s", flow.shape[0], out)


def stage_reid(args):
    """Stage 4: append "ReID" embeddings to the proposals JSON."""
    cfg, models, ds, seq, device = _setup(args)
    from premvos_tpu_torch.stages.reid import run_reid

    props_dir = Path(args.work) / "proposals" / args.seq
    h, w = cfg.pipeline.image_height, cfg.pipeline.image_width
    n = cfg.pipeline.max_proposals
    for t in range(len(seq["frames"])):
        path = props_dir / f"frame_{t:05d}.json"
        props = load_proposals(path, n, (h, w))
        with torch.inference_mode(), float32_precision():
            emb = run_reid(
                models.reid, _image(seq["frames"][t], device),
                torch.from_numpy(props.boxes).to(device)[None],
                torch.from_numpy(props.valid).to(device)[None], cfg.reid.crop_size,
            )[0]
        props.embeddings = emb.float().cpu().numpy()
        save_proposals(path, props)
    get_logger().info("reid: embedded %d frames in %s", len(seq["frames"]), props_dir)


def stage_merge(args):
    """Stage 5: JSONs + .flo + the annotation → indexed PNGs (+ J&F)."""
    cfg, models, ds, seq, device = _setup(args)
    from premvos_tpu_torch.pipeline.runner import boxes_from_masks
    from premvos_tpu_torch.stages.merge import init_state, merge_frame
    from premvos_tpu_torch.stages.reid import run_reid

    props_dir = Path(args.work) / "proposals" / args.seq
    flow_dir = Path(args.work) / "flow" / args.seq
    h, w = cfg.pipeline.image_height, cfg.pipeline.image_width
    n = cfg.pipeline.max_proposals

    labels = []
    with torch.inference_mode(), float32_precision():
        gt_masks = torch.from_numpy(seq["gt_masks"]).to(device)
        k = gt_masks.shape[0]
        gt_valid = torch.arange(k, device=device) < seq["num_objects"]
        gt_emb = run_reid(
            models.reid, _image(seq["frames"][0], device), boxes_from_masks(gt_masks)[None],
            gt_valid[None], cfg.reid.crop_size,
        )[0]
        state = init_state(gt_masks, gt_emb, seq["num_objects"])
        ids = np.arange(1, k + 1)[:, None, None]
        lab0 = (seq["gt_masks"] > 0.5) * ids * gt_valid.cpu().numpy()[:, None, None]
        labels.append(lab0.max(0).astype(np.uint8))
        for t in range(1, len(seq["frames"])):
            props = load_proposals(props_dir / f"frame_{t:05d}.json", n, (h, w))
            if props.embeddings is None:
                raise SystemExit("run the reid stage first (no ReID in JSON)")
            flow = read_flo(flow_dir / f"{t:05d}.flo")
            state, lab, _ = merge_frame(
                state,
                torch.from_numpy(props.masks).to(device, torch.float32),
                torch.from_numpy(props.scores).to(device),
                torch.from_numpy(props.embeddings).to(device),
                torch.from_numpy(props.valid).to(device),
                torch.from_numpy(flow).to(device).permute(2, 0, 1),
                cfg.merge,
            )
            labels.append(lab.cpu().numpy().astype(np.uint8))

    labels = np.stack(labels)
    out = Path(args.work) / "results"
    save_results(out, args.seq, crop_result(labels, seq["orig_hw"]))
    get_logger().info("merge: wrote %d PNGs to %s", len(labels), out / args.seq)

    if len(seq["gt_labels"]) == len(labels):
        from premvos_tpu_torch.eval.davis_eval import evaluate_sequence

        r = evaluate_sequence(labels, seq["gt_labels"], seq["num_objects"])
        print({"J": r["J"], "F": r["F"], "J&F": r["J&F"]})


STAGES = {
    "proposals": stage_proposals,
    "refine": stage_refine,
    "flow": stage_flow,
    "reid": stage_reid,
    "merge": stage_merge,
}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("stage", choices=sorted(STAGES))
    ap.add_argument("--davis_root", required=True)
    ap.add_argument("--seq", required=True)
    ap.add_argument("--work", required=True)
    ap.add_argument("--config", default=None)
    ap.add_argument("--checkpoint", default=None,
                    help="utils/checkpoint.py save_params file, or the JAX package's orbax directory")
    ap.add_argument("--max_frames", type=int, default=None)
    ap.add_argument(
        "--device", default=None,
        help="torch device (default: cuda, which must exist; cpu runs the "
        "kernels' plain PyTorch versions)",
    )
    args = ap.parse_args(argv)
    STAGES[args.stage](args)


if __name__ == "__main__":
    main()
