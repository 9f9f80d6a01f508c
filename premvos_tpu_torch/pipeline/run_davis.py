"""CLI: track every sequence of a DAVIS dataset (port of
premvos_tpu/pipeline/run_davis.py).

One command tracks each sequence (optionally fine-tuning the proposal and
refinement nets on its first frame before), writes DAVIS-palette PNGs and
reports J&F (where the annotations cover every frame) and throughput:

  python -m premvos_tpu_torch.pipeline.run_davis --davis_root /data/DAVIS \
      --output /tmp/results [--sequences dog cows] [--finetune] \
      [--checkpoint params.pt] [--max_frames N] [--config cfg.json] \
      [--device cpu]

It runs on the CUDA card unless `--device` names another device, and
raises without a card. Started by a launcher (`torchrun --nproc_per_node N
-m premvos_tpu_torch.pipeline.run_davis ...`), as the JAX CLI with its
`make_mesh()`: every rank reads each sequence and `--finetune` fine-tunes
data-parallel over the N ranks (parallel/mesh.py; NCCL, one card a rank,
or gloo with `--device cpu`), and rank 0 alone tracks, writes the PNGs and
reports J&F; the sequences are not sharded. PNG and JPEG frames are read
without Pillow (data/davis.py::read_frame). `--checkpoint` takes a
`utils/checkpoint.py::save_params` file, e.g. of nets loaded from the
reference's checkpoints through io_compat's converters, or the JAX
package's own orbax directory, as its `--checkpoint` takes it
(io_compat/orbax_ckpt.py; no JAX or orbax needed).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import time
from pathlib import Path

import numpy as np
import torch

from premvos_tpu_torch.config import PremvosConfig, load_config
from premvos_tpu_torch.data.davis import DavisDataset, crop_result, save_results
from premvos_tpu_torch.data.prefetch import prefetch_sequences
from premvos_tpu_torch.eval.davis_eval import evaluate_dataset, evaluate_sequence
from premvos_tpu_torch.parallel.mesh import init_from_env
from premvos_tpu_torch.pipeline.runner import (
    build_models,
    init_params,
    run_sequence,
)
from premvos_tpu_torch.utils.logging import get_logger


def _profiler(device: torch.device):
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=acts)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--davis_root", required=True)
    ap.add_argument("--output", required=True)
    ap.add_argument("--split", default="val")
    ap.add_argument("--sequences", nargs="*", default=None)
    ap.add_argument("--checkpoint", default=None,
                    help="utils/checkpoint.py save_params file, or the JAX package's orbax directory")
    ap.add_argument("--finetune", action="store_true")
    ap.add_argument("--max_frames", type=int, default=None)
    ap.add_argument("--config", default=None, help="JSON config preset")
    ap.add_argument(
        "--profile_dir", default=None,
        help="write a torch.profiler trace of the first tracked sequence "
        "(trace.json, for chrome://tracing or Perfetto)",
    )
    ap.add_argument(
        "--resume", action="store_true",
        help="skip sequences whose output dir already has every frame",
    )
    ap.add_argument(
        "--device", default=None,
        help="torch device (default: cuda, which must exist; cpu runs the "
        "kernels' plain PyTorch versions)",
    )
    args = ap.parse_args(argv)

    log = get_logger()
    mesh = init_from_env(args.device)
    device, tracks = mesh.device, mesh.rank == 0
    if not (tracks or args.finetune):
        return None  # a rank with neither fine-tune steps nor tracking
    cfg = load_config(args.config) if args.config else PremvosConfig()
    p = cfg.pipeline
    models = build_models(cfg, device)
    if args.checkpoint:  # every weight comes from the file: no random draw
        from premvos_tpu_torch.utils.checkpoint import load_params

        load_params(args.checkpoint, models)
        log.info("loaded checkpoint %s", args.checkpoint)
    else:
        init_params(models, cfg, seed=0, device=device)

    ds = DavisDataset(args.davis_root, split=args.split)
    seqs = args.sequences or ds.sequences

    if args.resume:
        remaining = []
        for name in seqs:
            done = Path(args.output) / name
            n_frames = len(ds.frame_paths(name))
            if args.max_frames:
                n_frames = min(n_frames, args.max_frames)
            if done.exists() and len(list(done.glob("*.png"))) >= n_frames:
                log.info("resume: skipping completed %s", name)
            else:
                remaining.append(name)
        seqs = remaining

    # One fused fine-tune build serves every sequence (all at the pipeline
    # canvas); each sequence fine-tunes copies of the base models.
    ft_built = None
    if args.finetune:
        from premvos_tpu_torch.finetune.fused import build_fused_runner, finetune_video

        if cfg.finetune.method == "fused":
            ft_built = build_fused_runner(models, cfg, device=device, mesh=mesh)

    results, total_frames, total_time = [], 0, 0.0
    for name, seq in prefetch_sequences(
        ds, seqs, p.image_height, p.image_width, p.max_objects, args.max_frames,
        device=device,
    ):
        seq_models = models
        if args.finetune:
            first_lab = (
                seq["gt_labels"][0]
                if len(seq["gt_labels"])
                else np.zeros(seq["frames"].shape[1:3], np.int32)
            )
            frame0 = seq["frames"][0].cpu().numpy()
            t0 = time.perf_counter()
            seq_models, losses = finetune_video(
                models, frame0, first_lab, cfg, built=ft_built, device=device, mesh=mesh
            )
            if not tracks:
                continue
            log.info(
                "finetuned %s in %.1fs (refine %.4f, proposal %.4f)",
                name, time.perf_counter() - t0, losses["refine"], losses["proposal"],
            )

        profiling = args.profile_dir and not results and total_frames == 0
        prof = _profiler(device) if profiling else contextlib.nullcontext()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        with prof:
            t0 = time.perf_counter()
            labels = run_sequence(
                seq_models, cfg, seq["frames"], seq["gt_masks"], seq["num_objects"],
                seq["intro_frames"], device=device,
            ).cpu().numpy()
            dt = time.perf_counter() - t0
        if profiling:
            os.makedirs(args.profile_dir, exist_ok=True)
            trace = os.path.join(args.profile_dir, "trace.json")
            prof.export_chrome_trace(trace)
            log.info("profiler trace written to %s", trace)
        total_frames += labels.shape[0] - 1
        total_time += dt
        log.info("%s: %d frames in %.2fs (%.2f fps)",
                 name, labels.shape[0], dt, (labels.shape[0] - 1) / dt)

        out = crop_result(labels, seq["orig_hw"])
        frame_names = [f.stem + ".png" for f in ds.frame_paths(name)]
        save_results(args.output, name, out, frame_names[: len(out)])

        if len(seq["gt_labels"]) == len(labels):
            r = evaluate_sequence(labels, seq["gt_labels"], seq["num_objects"])
            r["name"] = name
            results.append(r)
            log.info("%s: J=%.3f F=%.3f", name, r["J"], r["F"])

    if not tracks:
        return None
    summary = {"frames": total_frames, "seconds": total_time,
               "fps": total_frames / max(total_time, 1e-9)}
    if results:
        summary.update(evaluate_dataset(results))
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
