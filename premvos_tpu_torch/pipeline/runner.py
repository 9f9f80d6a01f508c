"""The VOS pipeline: proposal → refine → flow → ReID → merge (port of
premvos_tpu/pipeline/runner.py).

The JAX package runs a sequence as one jitted two-level `lax.scan`; here it
is a Python loop over chunks of `pipeline.scan_chunk` frames. Stages 1–4
have no frame-to-frame dependency and run batched over the chunk
(`stages_batch`); the merge carries the tracking state and runs frame by
frame. Nothing in the loop reads a value back to the host, so the device
works through a whole sequence without waiting on Python; the labels come
back when the caller reads them. `precompute_sequence` keeps stages 1–4's
outputs of a sequence so that `merge_labels_from_precomputed` can replay
only the merge for each candidate of a merge-weight search
(eval/harness.py).

Layouts follow the JAX package at the public functions (frames
[T, H, W, 3], masks [K, H, W], labels [T, H, W]) except flow, which is
[C, 2, H, W] (channel-first, as the port's convolutions produce it).
"""

from __future__ import annotations

import contextlib
from typing import NamedTuple

import numpy as np
import torch

from premvos_tpu_torch.config import MergeConfig, PremvosConfig
from premvos_tpu_torch.data.preprocess import normalize, to_unit
from premvos_tpu_torch.models.anchors import pyramid_anchors
from premvos_tpu_torch.models.deeplab import DeepLabV3Plus
from premvos_tpu_torch.models.flownet import FlowNet2
from premvos_tpu_torch.models.layers import init_module
from premvos_tpu_torch.models.maskrcnn import MaskRCNN
from premvos_tpu_torch.models.reid import ReIDNet
from premvos_tpu_torch.stages.flow import flow_pairs
from premvos_tpu_torch.stages.merge import init_state, merge_frame
from premvos_tpu_torch.stages.refine import make_refine_crops, refined_fullres
from premvos_tpu_torch.stages.reid import run_reid

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@contextlib.contextmanager
def float32_precision():
    """Float32 convolutions and matmuls in full float32 (TF32 off, which
    cuDNN otherwise uses for convolutions), as pipeline.dtype "float32" and
    interp_precision "highest" state. The caller's settings come back
    after."""
    prev = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = prev


class Models(NamedTuple):
    maskrcnn: torch.nn.Module
    refine: torch.nn.Module
    flow: torch.nn.Module
    reid: torch.nn.Module


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names one.
    With no device given and no CUDA card this raises: the port never drops
    to the CPU without being asked."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: pass device='cpu' to run the plain PyTorch path"
        )
    return torch.device("cuda")


def check_on(module: torch.nn.Module, device: torch.device, who: str) -> None:
    """Raise unless `module`'s parameters lie on `device`'s kind of device:
    an entry point never moves the caller's module for it."""
    on = next(module.parameters()).device
    if on.type != device.type:
        raise ValueError(f"{who}: the module is on {on}, not {device}")


def place(module: torch.nn.Module, device: torch.device) -> torch.nn.Module:
    """Move `module` to `device`, with channels-last convolution weights on
    CUDA (so activations are channels-last and kernels read NHWC)."""
    if device.type == "cuda":
        return module.to(device=device, memory_format=torch.channels_last)
    return module.to(device)


def build_models(cfg: PremvosConfig, device=None) -> Models:
    """The four networks in eval mode on `device` (CUDA unless the caller
    passes one), computing in pipeline.dtype over float32 parameters. On
    CUDA the convolution weights are channels-last, so the activations are
    too and the kernels read NHWC without copies."""
    device = resolve_device(device)
    dtype = _DTYPES[cfg.pipeline.dtype]
    models = Models(
        maskrcnn=MaskRCNN(cfg.proposal, dtype),
        refine=DeepLabV3Plus(cfg.refine, dtype),
        flow=FlowNet2(
            variant=cfg.flow.variant,
            max_displacement=cfg.flow.max_displacement,
            corr_stride=cfg.flow.corr_stride,
            div_flow=cfg.flow.div_flow,
            dtype=dtype,
        ),
        reid=ReIDNet(cfg.reid, dtype),
    )
    for m in models:
        place(m, device).eval()
    return models


def init_params(models: Models, cfg: PremvosConfig, seed: int = 0, device=None) -> Models:
    """Draw random parameters (flax's default initializers) from a CPU
    torch.Generator seeded with `seed`, so CPU and CUDA runs get the same
    weights; returns the models, moved to `device`."""
    device = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    for m in models:
        init_module(m, gen)
        place(m, device)
    return models


def get_anchors(cfg: PremvosConfig, device) -> dict:
    p = cfg.pipeline
    return {
        k: torch.from_numpy(v).to(device)
        for k, v in pyramid_anchors(
            p.image_height, p.image_width,
            cfg.proposal.anchor_scales, cfg.proposal.anchor_ratios,
        ).items()
    }


def boxes_from_masks(masks: torch.Tensor) -> torch.Tensor:
    """[K, H, W] masks → [K, 4] tight xyxy boxes (zeros for empty masks)."""
    k, h, w = masks.shape
    on = masks > 0.5
    cols = on.any(dim=1)  # [K, W]
    rows = on.any(dim=2)  # [K, H]
    xi = torch.arange(w, device=masks.device)
    yi = torch.arange(h, device=masks.device)
    big = 1 << 20
    x1 = torch.where(cols, xi, big).amin(dim=1)
    x2 = torch.where(cols, xi, -1).amax(dim=1) + 1
    y1 = torch.where(rows, yi, big).amin(dim=1)
    y2 = torch.where(rows, yi, -1).amax(dim=1) + 1
    empty = ~cols.any(dim=1)
    boxes = torch.stack([x1, y1, x2, y2], dim=-1).to(torch.float32)
    return torch.where(empty[:, None], 0.0, boxes)


@float32_precision()
def stages_batch(models: Models, cfg: PremvosConfig, anchors, frames_chunk, prev_chunk):
    """Stages 1–4 for a chunk of C frames, batched over the frame axis.

    frames_chunk / prev_chunk: [C, H, W, 3] float32 in [0, 1].
    Returns (prop_masks [C, N, H, W] in pipeline.dtype, scores [C, N],
    emb [C, N, E], valid [C, N], flow [C, 2, H, W]).
    """
    p = cfg.pipeline
    h, w = p.image_height, p.image_width
    c = frames_chunk.shape[0]
    dtype = _DTYPES[p.dtype]
    fmt = torch.channels_last if frames_chunk.is_cuda else torch.contiguous_format

    # Stage 1 — proposals, batch C.
    imgs = normalize(frames_chunk).permute(0, 3, 1, 2).contiguous(memory_format=fmt)
    det = models.maskrcnn(imgs, anchors)
    boxes, scores = det["boxes"], det["scores"]
    valid, mask_logits = det["valid"], det["mask_logits"]
    n = boxes.shape[1]

    # Stage 2 — refinement on all C·N crops in one batch.
    prec = cfg.refine.interp_precision
    s = cfg.refine.crop_size
    crops, crop_boxes = make_refine_crops(
        imgs, boxes, mask_logits, s, cfg.refine.box_margin, prec
    )
    crops = crops.reshape(c * n, crops.shape[2], s, s).contiguous(memory_format=fmt)
    ref_logits = models.refine(crops).reshape(c, n, s, s)
    ref_logits = ref_logits * valid[..., None, None].to(ref_logits.dtype)
    prop_masks = refined_fullres(ref_logits, crop_boxes, valid, h, w, prec).to(dtype)

    # Stage 3 — backward flow (current → previous) for all C pairs.
    flow = flow_pairs(
        models.flow, frames_chunk, prev_chunk, (cfg.flow.infer_height, cfg.flow.infer_width)
    )

    # Stage 4 — ReID embeddings of all C·N crops.
    emb = run_reid(models.reid, imgs, boxes, valid, cfg.reid.crop_size)
    return prop_masks, scores, emb, valid, flow


def _sequence_inputs(frames, gt_masks, num_objects, intro_frames, device):
    """The tensors run_sequence and precompute_sequence start from: frames
    in [0, 1], float32 masks, gt_valid [K] and intro_frames [K] on device."""
    frames = to_unit(torch.as_tensor(frames, device=device))
    gt_masks = torch.as_tensor(gt_masks, device=device).to(torch.float32)
    k = gt_masks.shape[0]
    gt_valid = torch.arange(k, device=device) < num_objects
    if intro_frames is None:
        intro_frames = torch.zeros((k,), dtype=torch.int64, device=device)
    intro_frames = torch.as_tensor(intro_frames, device=device).to(torch.int64)
    return frames, gt_masks, gt_valid, intro_frames


def _reference_embeddings(models, cfg, frames, gt_masks, gt_valid, intro_frames):
    """[K, E]: each object's ReID embedding from its crop in its own intro
    frame."""
    intro_imgs = normalize(frames[intro_frames]).permute(0, 3, 1, 2)
    return run_reid(
        models.reid, intro_imgs, boxes_from_masks(gt_masks)[:, None],
        gt_valid[:, None], cfg.reid.crop_size,
    )[:, 0]


def _stage_chunks(models, cfg, frames):
    """Stages 1–4 over steps 1..T−1 in chunks of pipeline.scan_chunk: yield
    (ts, stages_batch outputs) per chunk, ts the chunk's frame indices. The
    last chunk is padded by repeating the last frame with t = −1 (matches
    no intro frame; padded outputs are dropped by the callers)."""
    device = frames.device
    anchors = get_anchors(cfg, device)
    t_total = frames.shape[0]
    steps = t_total - 1
    chunk = max(1, min(int(cfg.pipeline.scan_chunk), max(steps, 1)))
    for c0 in range(0, steps, chunk):
        ts = list(range(c0 + 1, min(c0 + 1 + chunk, t_total)))
        pad = chunk - len(ts)
        idx = torch.tensor(ts + [t_total - 1] * pad, device=device)
        cur = frames[idx]
        prev = frames[torch.clamp(idx - 1, min=0)]
        if pad:
            prev[len(ts):] = frames[-1]
        yield ts + [-1] * pad, stages_batch(models, cfg, anchors, cur, prev)


def _first_labels(gt_masks, present):
    """[H, W] int32 labels of the objects `present` [K] (ids 1..K)."""
    k = gt_masks.shape[0]
    ids = torch.arange(1, k + 1, dtype=torch.int32, device=gt_masks.device)[:, None, None]
    return torch.where((gt_masks > 0.5) & present[:, None, None], ids, 0).amax(dim=0)


@float32_precision()
def run_sequence(
    models: Models,
    cfg: PremvosConfig,
    frames,
    gt_masks,
    num_objects: int,
    intro_frames=None,
    device=None,
) -> torch.Tensor:
    """Track a whole sequence.

    frames [T, H, W, 3] raw RGB (uint8 or [0, 255]); gt_masks [K, H, W]
    per-object annotations (padded to max_objects); num_objects real
    objects; intro_frames optional [K] frame index where each object is
    annotated (None: all at frame 0). Inputs may be numpy arrays or tensors.
    Returns labels [T, H, W] int32 on `device` (CUDA unless given).
    """
    device = resolve_device(device)
    with torch.inference_mode():
        frames, gt_masks, gt_valid, intro_frames = _sequence_inputs(
            frames, gt_masks, num_objects, intro_frames, device
        )
        gt_emb = _reference_embeddings(models, cfg, frames, gt_masks, gt_valid, intro_frames)
        at0 = intro_frames == 0
        state = init_state(gt_masks * at0[:, None, None], gt_emb, num_objects)
        state = state._replace(active=state.active & at0)

        # Stages 1–4 batched per chunk; the merge frame by frame (state past
        # the last real frame is never read).
        labels = []
        for ts, outs in _stage_chunks(models, cfg, frames):
            for i, t in enumerate(ts):
                pm, sc, em, va, fl = (x[i] for x in outs)
                new_active = (intro_frames == t) & gt_valid
                state, lab, _ = merge_frame(
                    state, pm, sc, em, va, fl, cfg.merge,
                    intro=(new_active, gt_masks),
                )
                if t > 0:
                    labels.append(lab)
        return torch.stack([_first_labels(gt_masks, gt_valid & at0), *labels])


@float32_precision()
def precompute_sequence(
    models: Models,
    cfg: PremvosConfig,
    frames,
    gt_masks,
    num_objects: int,
    intro_frames=None,
    device=None,
) -> dict:
    """Stages 1–4 of a whole sequence and the objects' reference
    embeddings, for replaying only the merge (merge_labels_from_precomputed;
    eval/harness.py): nothing here depends on MergeConfig.

    Inputs as run_sequence's; the same chunk loop. Returns a dict of
    tensors on `device`: prop_masks [T−1, N, H, W] (pipeline.dtype),
    scores [T−1, N], emb [T−1, N, E], valid [T−1, N], flow [T−1, 2, H, W]
    (steps 1..T−1), gt_emb [K, E], gt_valid [K].
    """
    device = resolve_device(device)
    with torch.inference_mode():
        frames, gt_masks, gt_valid, intro_frames = _sequence_inputs(
            frames, gt_masks, num_objects, intro_frames, device
        )
        gt_emb = _reference_embeddings(models, cfg, frames, gt_masks, gt_valid, intro_frames)
        parts = [[] for _ in range(5)]
        for ts, outs in _stage_chunks(models, cfg, frames):
            n = sum(t > 0 for t in ts)
            for part, x in zip(parts, outs):
                part.append(x[:n])
        keys = ("prop_masks", "scores", "emb", "valid", "flow")
        pre = {k: torch.cat(part) for k, part in zip(keys, parts)}
    return {**pre, "gt_emb": gt_emb, "gt_valid": gt_valid}


def merge_config_from_weights(weights, warp_stride: int = 1) -> MergeConfig:
    """The replay's MergeConfig: a weight vector of length 6, 8 or 9
    (w_objectness, w_reid, w_warp, w_overlap, reid_sigma,
    new_object_score_floor[, warp_decay, reid_ema[, reid_reacquire]]), each
    rounded to float32, and MergeConfig's defaults for every other field
    (mask_threshold among them), as the JAX replay builds it."""
    if isinstance(weights, torch.Tensor):
        weights = weights.detach().cpu().numpy()
    w = np.asarray(weights, np.float32).reshape(-1).tolist()
    if len(w) not in (6, 8, 9):
        raise ValueError(f"merge weights must have 6, 8 or 9 entries, got {len(w)}")
    return MergeConfig(
        w_objectness=w[0], w_reid=w[1], w_warp=w[2], w_overlap=w[3], reid_sigma=w[4],
        new_object_score_floor=w[5],
        warp_decay=w[6] if len(w) > 6 else 1.0,
        reid_ema=w[7] if len(w) > 7 else 0.0,
        reid_reacquire=w[8] if len(w) > 8 else 2.0,
        warp_stride=warp_stride,
    )


@float32_precision()
def merge_labels_from_precomputed(
    pre: dict,
    gt_masks,
    num_objects: int,
    weights,
    warp_stride: int = 1,
    warp_impl: str = "block",
) -> torch.Tensor:
    """Replay only the merge over precompute_sequence's outputs with the
    MergeConfig of `weights` (merge_config_from_weights). `warp_impl` is
    accepted for the JAX signature and ignored: the port's warp is the
    exact one. Returns labels [T, H, W] int32 on pre's device (frame 0 the
    annotation, every object introduced at frame 0)."""
    cfg_m = merge_config_from_weights(weights, warp_stride)
    device = pre["scores"].device
    with torch.inference_mode():
        gt_masks = torch.as_tensor(gt_masks, device=device).to(torch.float32)
        state = init_state(gt_masks, pre["gt_emb"], num_objects)
        labels = []
        for t in range(pre["scores"].shape[0]):
            state, lab, _ = merge_frame(
                state, pre["prop_masks"][t], pre["scores"][t], pre["emb"][t],
                pre["valid"][t], pre["flow"][t], cfg_m,
            )
            labels.append(lab)
        return torch.stack([_first_labels(gt_masks, pre["gt_valid"]), *labels])
