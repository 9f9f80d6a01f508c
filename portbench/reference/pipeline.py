"""The reference tracking pipeline in plain PyTorch: the configuration tree,
stages 1-4 batched over a chunk of frames, the merge frame by frame, and
`run_sequence`, with the measured program's signature and semantics.

Sequence: frames [T, H, W, 3] uint8, gt_masks [K, H, W], num_objects,
intro_frames [K] (the frame each object is annotated in). Frames 1..T−1
run through the stages in chunks of `pipeline.scan_chunk`, the last chunk
padded with the last frame; the merge carries each object's mask, reference
embedding, presence and staleness from frame to frame and labels every pixel
with the best-scoring object covering it. Returns labels [T, H, W] int32.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
from dataclasses import dataclass, field
from typing import NamedTuple

import torch

from portbench.reference import nets, ops

# ------------------------------------------------------------------ config


@dataclass(frozen=True)
class ProposalConfig:
    backbone_depth: int = 101
    fpn_channels: int = 256
    anchor_scales: tuple = (32.0, 64.0, 128.0, 256.0, 512.0)
    anchor_ratios: tuple = (0.5, 1.0, 2.0)
    rpn_pre_nms_topk: int = 512
    rpn_post_nms_topk: int = 256
    rpn_nms_threshold: float = 0.7
    detections_per_frame: int = 32
    detection_nms_threshold: float = 0.5
    detection_score_threshold: float = 0.05
    roi_align_size: int = 7
    mask_roi_align_size: int = 14
    mask_resolution: int = 28
    num_classes: int = 2
    norm: str = "frozen_bn"


@dataclass(frozen=True)
class RefineConfig:
    crop_size: int = 385
    box_margin: float = 50.0
    backbone: str = "resnet"
    backbone_depth: int = 50
    norm: str = "frozen_bn"
    output_stride: int = 16
    aspp_rates: tuple = (6, 12, 18)
    aspp_channels: int = 256
    decoder_channels: int = 256
    low_level_channels: int = 48
    in_channels: int = 4
    interp_precision: str = "highest"


@dataclass(frozen=True)
class FlowConfig:
    variant: str = "flownet2"
    max_displacement: int = 20
    corr_stride: int = 2
    infer_height: int = 448
    infer_width: int = 832
    div_flow: float = 20.0
    warp_impl: str = "block"


@dataclass(frozen=True)
class ReIDConfig:
    backbone_depth: int = 50
    embedding_dim: int = 128
    crop_size: int = 128
    norm: str = "frozen_bn"
    l2_normalize: bool = True


@dataclass(frozen=True)
class MergeConfig:
    w_objectness: float = 1.0
    w_reid: float = 1.0
    w_warp: float = 1.0
    w_overlap: float = 1.0
    mask_threshold: float = 0.5
    reid_sigma: float = 1.0
    new_object_score_floor: float = 0.0
    warp_stride: int = 1
    warp_impl: str = "block"
    warp_decay: float = 1.0
    reid_ema: float = 0.0
    reid_reacquire: float = 2.0


@dataclass(frozen=True)
class PipelineConfig:
    image_height: int = 480
    image_width: int = 864
    max_objects: int = 8
    max_proposals: int = 32
    dtype: str = "bfloat16"
    scan_chunk: int = 8


@dataclass(frozen=True)
class Config:
    proposal: ProposalConfig = field(default_factory=ProposalConfig)
    refine: RefineConfig = field(default_factory=RefineConfig)
    flow: FlowConfig = field(default_factory=FlowConfig)
    reid: ReIDConfig = field(default_factory=ReIDConfig)
    merge: MergeConfig = field(default_factory=MergeConfig)
    pipeline: PipelineConfig = field(default_factory=PipelineConfig)


def config_from_dict(d: dict) -> Config:
    """The tree of a configuration file; keys the tree does not name (the
    benchmark's own, and settings the inference path never reads) are
    ignored, absent ones take the defaults above."""
    groups = {}
    for f in dataclasses.fields(Config):
        cls = type(f.default_factory())
        sub = d.get(f.name, {})
        groups[f.name] = cls(**{k.name: tuple(sub[k.name]) if isinstance(sub[k.name], list)
                                else sub[k.name]
                                for k in dataclasses.fields(cls) if k.name in sub})
    return Config(**groups)


def load_config(path) -> Config:
    with open(path) as f:
        return config_from_dict(json.load(f))


DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@contextlib.contextmanager
def float32_matmuls():
    """Float32 matmuls and convolutions in full float32 (TF32 off)."""
    prev = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = prev


# ------------------------------------------------------------------- nets

class Models(NamedTuple):
    maskrcnn: torch.nn.Module
    refine: torch.nn.Module
    flow: torch.nn.Module
    reid: torch.nn.Module


def build_models(cfg: Config, dtype=torch.float32, device="cpu") -> Models:
    """The four nets in eval mode computing in `dtype` (a torch dtype, or
    "fp8" for the control), parameters uninitialised on `device` ("meta"
    gives the shapes alone)."""
    f = cfg.flow
    with torch.device(device):
        models = Models(
            maskrcnn=nets.MaskRCNN(cfg.proposal, dtype),
            refine=nets.DeepLabV3Plus(cfg.refine, dtype),
            flow=nets.FlowNet2(f.variant, f.max_displacement, f.corr_stride, f.div_flow, dtype,
                               f.warp_impl),
            reid=nets.ReIDNet(cfg.reid, dtype),
        )
    for m in models:
        m.eval()
    return models


# ----------------------------------------------------------------- stages

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def normalize(image):
    """RGB [..., 3] in [0, 255] or [0, 1] (one test over the whole tensor) →
    ImageNet-normalised float32."""
    x = image.to(torch.float32)
    x = torch.where(x.amax() > 2.0, x / 255.0, x)
    mean = torch.tensor(IMAGENET_MEAN, dtype=torch.float32, device=x.device)
    std = torch.tensor(IMAGENET_STD, dtype=torch.float32, device=x.device)
    return (x - mean) / std


def expand_boxes(boxes, margin, height, width):
    return torch.stack([
        torch.clamp(boxes[..., 0] - margin, 0, width), torch.clamp(boxes[..., 1] - margin, 0, height),
        torch.clamp(boxes[..., 2] + margin, 0, width), torch.clamp(boxes[..., 3] + margin, 0, height),
    ], dim=-1)


def make_refine_crops(image, boxes, mask_logits, crop_size, margin, precision):
    """[B, N, 4, S, S] crops: the margin-expanded box's RGB and the coarse
    mask pasted in crop coordinates; and the crop boxes [B, N, 4]."""
    h, w = image.shape[-2:]
    crop_boxes = expand_boxes(boxes, margin, h, w)
    norm = torch.stack([crop_boxes[..., 1] / (h - 1), crop_boxes[..., 0] / (w - 1),
                        crop_boxes[..., 3] / (h - 1), crop_boxes[..., 2] / (w - 1)], dim=-1)
    rgb = ops.crop_and_resize(image, norm, crop_size, precision)
    sx = crop_size / torch.clamp(crop_boxes[..., 2] - crop_boxes[..., 0], min=1e-6)
    sy = crop_size / torch.clamp(crop_boxes[..., 3] - crop_boxes[..., 1], min=1e-6)
    box_in_crop = torch.stack([
        (boxes[..., 0] - crop_boxes[..., 0]) * sx, (boxes[..., 1] - crop_boxes[..., 1]) * sy,
        (boxes[..., 2] - crop_boxes[..., 0]) * sx, (boxes[..., 3] - crop_boxes[..., 1]) * sy,
    ], dim=-1)
    mask_ch = ops.paste_mask(torch.sigmoid(mask_logits.to(torch.float32)), box_in_crop,
                             crop_size, crop_size, precision)
    return torch.cat([rgb, mask_ch[:, :, None]], dim=2), crop_boxes


def refined_fullres(logits, crop_boxes, valid, height, width, precision):
    pasted = ops.paste_mask(torch.sigmoid(logits.to(torch.float32)), crop_boxes, height, width,
                            precision)
    return pasted * valid[..., None, None].to(pasted.dtype)


def reid_crops(image, boxes, crop_size, precision=None):
    h, w = image.shape[-2:]
    norm = torch.stack([boxes[..., 1] / (h - 1), boxes[..., 0] / (w - 1),
                        boxes[..., 3] / (h - 1), boxes[..., 2] / (w - 1)], dim=-1)
    return ops.crop_and_resize(image, norm, crop_size, precision)


def run_reid(model, image, boxes, valid, crop_size, precision=None):
    crops = reid_crops(image, boxes, crop_size, precision)
    b, n = crops.shape[:2]
    emb = model(crops.reshape(b * n, *crops.shape[2:])).reshape(b, n, -1)
    return emb * valid[..., None].to(emb.dtype)


def flow_inputs(cur, prev, infer_hw):
    """The flow net's two inputs: cur, prev [C, H, W, 3] in [0, 1] → [C, 3, h, w]."""
    cur, prev = cur.permute(0, 3, 1, 2), prev.permute(0, 3, 1, 2)
    return ops.resize_bilinear(cur, infer_hw), ops.resize_bilinear(prev, infer_hw)


def flow_pairs(model, cur, prev, infer_hw):
    """Backward flow (cur → prev) [C, 2, H, W] in pixels, the net run at infer_hw."""
    c, h, w, _ = cur.shape
    fh, fw = infer_hw
    if (fh, fw) == (h, w):
        return model(cur.permute(0, 3, 1, 2), prev.permute(0, 3, 1, 2))
    flow = ops.resize_bilinear(model(*flow_inputs(cur, prev, infer_hw)), (h, w))
    scale = torch.tensor([w / fw, h / fh], dtype=flow.dtype, device=flow.device)
    return flow * scale[:, None, None]


def stages_batch(models, cfg, anchors, frames_chunk, prev_chunk, interp, reid_interp=None):
    """Stages 1-4 of C frames ([C, H, W, 3] in [0, 1]): (prop_masks [C, N, H, W]
    in pipeline.dtype, scores [C, N], emb [C, N, E], valid [C, N], flow
    [C, 2, H, W]). `interp` and `reid_interp` are the operand precisions of
    the refine crops and pastes and of the ReID crops."""
    p = cfg.pipeline
    h, w = p.image_height, p.image_width
    c = frames_chunk.shape[0]
    imgs = normalize(frames_chunk).permute(0, 3, 1, 2)
    det = models.maskrcnn(imgs, anchors)
    boxes, scores, valid = det["boxes"], det["scores"], det["valid"]
    n = boxes.shape[1]
    s = cfg.refine.crop_size
    crops, crop_boxes = make_refine_crops(imgs, boxes, det["mask_logits"], s,
                                          cfg.refine.box_margin, interp)
    logits = models.refine(crops.reshape(c * n, crops.shape[2], s, s)).reshape(c, n, s, s)
    logits = logits * valid[..., None, None].to(logits.dtype)
    prop_masks = refined_fullres(logits, crop_boxes, valid, h, w, interp).to(DTYPES[p.dtype])
    flow = flow_pairs(models.flow, frames_chunk, prev_chunk,
                      (cfg.flow.infer_height, cfg.flow.infer_width))
    emb = run_reid(models.reid, imgs, boxes, valid, cfg.reid.crop_size, reid_interp)
    return prop_masks, scores, emb, valid, flow


def chunk_indices(t_total, chunk):
    """[(ts, idx)]: each chunk's frame indices (−1 for padding) and the
    frames it runs (the last frame repeated as padding)."""
    steps = t_total - 1
    chunk = max(1, min(int(chunk), max(steps, 1)))
    out = []
    for c0 in range(0, steps, chunk):
        ts = list(range(c0 + 1, min(c0 + 1 + chunk, t_total)))
        pad = chunk - len(ts)
        out.append((ts + [-1] * pad, ts + [t_total - 1] * pad))
    return out


def chunk_frames(frames, ts, idx):
    """The chunk's current frames and the frames before them; a padding
    slot's previous frame is the last frame itself."""
    cur = frames[torch.tensor(idx, device=frames.device)]
    prev = frames[torch.tensor([max(i - 1, 0) if t > 0 else i for t, i in zip(ts, idx)],
                               device=frames.device)]
    return cur, prev


def boxes_from_masks(masks):
    """[K, H, W] masks → [K, 4] tight xyxy boxes, zeros for an empty mask."""
    k, h, w = masks.shape
    on = masks > 0.5
    cols, rows = on.any(dim=1), on.any(dim=2)
    xi = torch.arange(w, device=masks.device)
    yi = torch.arange(h, device=masks.device)
    big = 1 << 20
    x1 = torch.where(cols, xi, big).amin(dim=1)
    x2 = torch.where(cols, xi, -1).amax(dim=1) + 1
    y1 = torch.where(rows, yi, big).amin(dim=1)
    y2 = torch.where(rows, yi, -1).amax(dim=1) + 1
    boxes = torch.stack([x1, y1, x2, y2], dim=-1).to(torch.float32)
    return torch.where(~cols.any(dim=1)[:, None], 0.0, boxes)


# ------------------------------------------------------------------- merge

NEG = -1e9


class TrackState(NamedTuple):
    prev_masks: torch.Tensor
    ref_emb: torch.Tensor
    active: torch.Tensor
    staleness: torch.Tensor


def warp_masks_coarse(masks, flow, stride, impl):
    """Warp [K, H, W] masks by flow [2, H, W] at 1/stride resolution and
    resize back (stride 1: at full resolution)."""
    if stride <= 1:
        return ops.warp(masks[None], flow[None], impl)[0]
    h, w = masks.shape[-2:]
    hs, ws = h // stride, w // stride
    flow_s = ops.resize_bilinear(flow[None], (hs, ws))[0] / float(stride)
    masks_s = ops.resize_bilinear(masks[None], (hs, ws))[0]
    warped = ops.warp(masks_s[None], flow_s[None], impl)[0]
    return ops.resize_bilinear(warped[None], (h, w))[0]


def reid_similarity(ref_emb, prop_emb, sigma):
    def unit(x):
        return x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True), min=1e-6)

    a, b = unit(ref_emb), unit(prop_emb)
    d2 = torch.clamp(torch.sum(a * a, -1)[:, None] + torch.sum(b * b, -1)[None, :]
                     - 2.0 * (a @ b.T), min=0.0)
    return torch.exp(-d2 / (sigma * sigma))


def merge_frame(state, prop_masks, prop_scores, prop_emb, prop_valid, flow, cfg, new_active,
                intro_masks, iou_precision=None):
    """One tracking step: warp the objects' masks, score every (object,
    proposal) pair (objectness + ReID similarity + warp IoU − overlap with
    the other objects), assign greedily, label the pixels; objects that
    enter this frame emit their annotation instead. (state, labels)."""
    k = state.prev_masks.shape[0]
    dev = prop_masks.device
    warped = warp_masks_coarse(state.prev_masks, flow, cfg.warp_stride, cfg.warp_impl)
    warp_iou = ops.soft_mask_iou(warped, prop_masks, iou_precision)
    sim = reid_similarity(state.ref_emb, prop_emb, cfg.reid_sigma)
    decay = torch.pow(torch.tensor(cfg.warp_decay, dtype=torch.float32, device=dev),
                      state.staleness.to(torch.float32))
    w_dec = warped * decay[:, None, None]
    other = torch.clamp(torch.sum(w_dec, dim=0, keepdim=True) - w_dec, 0.0, 1.0)
    overlap = ops.soft_mask_iou(other, prop_masks, iou_precision)
    s = (cfg.w_objectness * prop_scores[None, :] + cfg.w_reid * sim
         + cfg.w_warp * decay[:, None] * warp_iou - cfg.w_overlap * overlap)
    ok = state.active[:, None] & prop_valid[None, :]
    s = torch.where(ok, s, torch.full_like(s, NEG))
    sim = torch.where(ok, sim, torch.zeros_like(sim))

    n = s.shape[1]
    rows, cols = torch.arange(k, device=dev), torch.arange(n, device=dev)
    assign = torch.full((k,), -1, dtype=torch.int64, device=dev)
    a_score = torch.full((k,), NEG, dtype=torch.float32, device=dev)
    for _ in range(k):
        flat = torch.argmax(s)
        ki, ni = flat // n, flat % n
        val = torch.take(s, flat)
        do = val > NEG / 2
        hit = do & (rows == ki)
        assign = torch.where(hit, ni, assign)
        a_score = torch.where(hit, val.to(torch.float32), a_score)
        s = torch.where(do & ((rows[:, None] == ki) | (cols[None, :] == ni)),
                        torch.full_like(s, NEG), s)

    picked = torch.clamp(assign, min=0)
    sel = prop_masks[picked]
    sim_picked = torch.gather(sim, 1, picked[:, None])[:, 0]
    accept = (a_score > cfg.new_object_score_floor) | (sim_picked >= cfg.reid_reacquire)
    present = (assign >= 0) & accept & state.active
    sel = sel * present[:, None, None].to(sel.dtype)
    cover = (sel > cfg.mask_threshold) & present[:, None, None]
    pix = torch.where(cover, a_score[:, None, None],
                      torch.tensor(NEG, dtype=torch.float32, device=dev))
    labels = torch.where(cover.any(dim=0), torch.argmax(pix, dim=0) + 1, 0).to(torch.int32)

    new_prev = torch.where(present[:, None, None], sel.to(torch.float32), warped)
    staleness = torch.where(present, 0, state.staleness + 1).to(torch.int32)
    ref_emb = state.ref_emb
    if float(cfg.reid_ema) > 0.0:
        a = cfg.reid_ema * present.to(torch.float32)[:, None]
        ref_emb = (1.0 - a) * ref_emb + a * prop_emb[picked].to(torch.float32)

    ids = torch.arange(1, k + 1, dtype=torch.int32, device=dev)[:, None, None]
    intro_cover = (intro_masks > cfg.mask_threshold) & new_active[:, None, None]
    intro_lab = torch.amax(torch.where(intro_cover, ids, 0), dim=0)
    labels = torch.where(intro_lab > 0, intro_lab, labels)
    new_prev = torch.where(new_active[:, None, None], intro_masks.to(torch.float32), new_prev)
    staleness = torch.where(new_active, 0, staleness).to(torch.int32)
    return TrackState(new_prev, ref_emb, state.active | new_active, staleness), labels


def first_labels(gt_masks, present):
    k = gt_masks.shape[0]
    ids = torch.arange(1, k + 1, dtype=torch.int32, device=gt_masks.device)[:, None, None]
    return torch.where((gt_masks > 0.5) & present[:, None, None], ids, 0).amax(dim=0)


class Pipeline:
    """The reference pipeline at `cfg` over `models` (a Models of nets or of
    anything with the nets' call signatures). `control=True` computes every
    matmul outside the nets one precision below the configuration's: fp8
    where it states bfloat16 operands, TF32 where it states float32."""

    def __init__(self, cfg: Config, models: Models, device, control: bool = False):
        self.cfg, self.models, self.device = cfg, models, torch.device(device)
        p = cfg.pipeline
        self.anchors = nets.pyramid_anchors(p.image_height, p.image_width,
                                            cfg.proposal.anchor_scales,
                                            cfg.proposal.anchor_ratios, self.device)
        interp = cfg.refine.interp_precision
        below = {torch.bfloat16: "fp8", torch.float32: "tf32"}
        self.interp = below[ops.interp_dtype(interp)] if control else interp
        self.f32_mm = "tf32" if control else None

    def run_sequence(self, frames, gt_masks, num_objects, intro_frames=None):
        """Labels [T, H, W] int32 on the pipeline's device."""
        cfg, models, dev = self.cfg, self.models, self.device
        with torch.inference_mode(), float32_matmuls():
            frames = torch.as_tensor(frames, device=dev).to(torch.float32) / 255.0
            gt_masks = torch.as_tensor(gt_masks, device=dev).to(torch.float32)
            k = gt_masks.shape[0]
            gt_valid = torch.arange(k, device=dev) < num_objects
            intro = (torch.zeros((k,), dtype=torch.int64, device=dev) if intro_frames is None
                     else torch.as_tensor(intro_frames, device=dev).to(torch.int64))
            intro_imgs = normalize(frames[intro]).permute(0, 3, 1, 2)
            gt_emb = run_reid(models.reid, intro_imgs, boxes_from_masks(gt_masks)[:, None],
                              gt_valid[:, None], cfg.reid.crop_size, self.f32_mm)[:, 0]
            at0 = intro == 0
            state = TrackState(gt_masks * at0[:, None, None], gt_emb,
                               (torch.arange(k, device=dev) < num_objects) & at0,
                               torch.zeros((k,), dtype=torch.int32, device=dev))
            labels = [first_labels(gt_masks, gt_valid & at0)]
            for ts, idx in chunk_indices(frames.shape[0], cfg.pipeline.scan_chunk):
                cur, prev = chunk_frames(frames, ts, idx)
                outs = stages_batch(models, cfg, self.anchors, cur, prev, self.interp,
                                    self.f32_mm)
                for i, t in enumerate(ts):
                    pm, sc, em, va, fl = (x[i] for x in outs)
                    state, lab = merge_frame(state, pm, sc, em, va, fl, cfg.merge,
                                             (intro == t) & gt_valid, gt_masks, self.f32_mm)
                    if t > 0:
                        labels.append(lab)
            return torch.stack(labels)
