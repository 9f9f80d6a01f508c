"""Single dataclass config tree for the whole pipeline (PyTorch port).

The port keeps its own copy of the JAX package's config tree so that it
imports nothing from that package; both load the same JSON presets
(configs/*.json), and field names and defaults are identical. Fields the
port does not read yet (`mesh_axis`, the loss settings) stay so that every
preset parses. The `warp_impl` switches are
read by the JAX package only: the port's warp is always the exact bilinear
warp (ops/resample2d.py).
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field


@dataclass(frozen=True)
class ProposalConfig:
    """Mask R-CNN-style category-agnostic proposal generator."""

    backbone_depth: int = 101
    fpn_channels: int = 256
    # Anchors: one scale per FPN level P2..P6, 3 aspect ratios.
    anchor_scales: tuple = (32.0, 64.0, 128.0, 256.0, 512.0)
    anchor_ratios: tuple = (0.5, 1.0, 2.0)
    rpn_pre_nms_topk: int = 512  # static top-k per level
    rpn_post_nms_topk: int = 256
    rpn_nms_threshold: float = 0.7
    detections_per_frame: int = 32
    detection_nms_threshold: float = 0.5
    detection_score_threshold: float = 0.05
    roi_align_size: int = 7
    mask_roi_align_size: int = 14
    mask_resolution: int = 28
    num_classes: int = 2  # category-agnostic: object vs background
    norm: str = "frozen_bn"  # the port implements frozen_bn only
    rpn_loss: str = "dense"
    focal_alpha: float = 0.25
    focal_gamma: float = 2.0


@dataclass(frozen=True)
class RefineConfig:
    """DeepLabv3+-style proposal refinement net."""

    crop_size: int = 385
    box_margin: float = 50.0
    backbone: str = "resnet"  # the port implements "resnet" only
    backbone_depth: int = 50
    norm: str = "frozen_bn"
    output_stride: int = 16
    aspp_rates: tuple = (6, 12, 18)
    aspp_channels: int = 256
    decoder_channels: int = 256
    low_level_channels: int = 48
    in_channels: int = 4  # RGB + coarse mask prior
    # Operand precision of the crop/paste interpolation matmuls:
    # "highest"/"high" = float32 (TF32 off), "default" = bfloat16 operands
    # with float32 accumulation.
    interp_precision: str = "highest"


@dataclass(frozen=True)
class FlowConfig:
    """FlowNet2-style optical flow."""

    variant: str = "flownet2"  # flownetc | flownet2cs | flownet2css | flownet2
    max_displacement: int = 20
    corr_stride: int = 2
    # Inference resolution must be a multiple of 64 (6 stride-2 stages).
    infer_height: int = 448
    infer_width: int = 832
    div_flow: float = 20.0
    warp_impl: str = "block"  # JAX package only (see module docstring)


@dataclass(frozen=True)
class ReIDConfig:
    """Triplet-loss embedding net."""

    backbone_depth: int = 50
    embedding_dim: int = 128
    crop_size: int = 128
    triplet_margin: float = 0.2
    norm: str = "frozen_bn"
    l2_normalize: bool = True  # embed on the unit sphere


@dataclass(frozen=True)
class MergeConfig:
    """Greedy merge/track scoring.

    score = w_objectness·score + w_reid·reid_sim + w_warp·warp_iou
            − w_overlap·inter-object-overlap
    """

    w_objectness: float = 1.0
    w_reid: float = 1.0
    w_warp: float = 1.0
    w_overlap: float = 1.0
    mask_threshold: float = 0.5
    reid_sigma: float = 1.0  # reid_sim = exp(−dist²/σ²)
    new_object_score_floor: float = 0.0
    # Warp resolution divisor: 1 = per-pixel warp at full resolution; s>1
    # warps on a 1/s grid and upsamples bilinearly.
    warp_stride: int = 1
    warp_impl: str = "block"  # JAX package only (see module docstring)
    # Per-frame decay of the warp term while a track is coasting.
    warp_decay: float = 1.0
    # EMA rate folding the assigned proposal's embedding into the track's
    # reference embedding (0 = fixed frame-0 anchor).
    reid_ema: float = 0.0
    # A pick below the score floor is still accepted when its ReID
    # similarity is at least this (>1 disables the relief).
    reid_reacquire: float = 2.0


@dataclass(frozen=True)
class PipelineConfig:
    """Whole-sequence pipeline."""

    image_height: int = 480
    image_width: int = 864  # 854 padded to a 32-multiple for the backbone
    max_objects: int = 8
    max_proposals: int = 32  # = ProposalConfig.detections_per_frame
    dtype: str = "bfloat16"  # compute dtype; parameters stay float32
    mesh_axis: str = "data"
    # Frames per batched dispatch of stages 1-4 (only the merge carries
    # state from frame to frame).
    scan_chunk: int = 8


@dataclass(frozen=True)
class FinetuneConfig:
    """Per-video lucid-dream fine-tuning (finetune/fused.py).

    method "fused" (default): every step draws its augmentations on the
    device. method "pool" (the host-pool oracle, finetune/finetune.py):
    both nets train on one pool of augmentations built on the host.
    """

    num_augmentations: int = 2500  # pool method only; fused draws per step
    steps: int = 500
    learning_rate: float = 1e-4
    batch_size: int = 8  # refine batch; the proposal batch is half
    method: str = "fused"  # "fused" | "pool"
    chunk: int = 16  # steps between two host reads of the loss
    aug_patch: int = 256  # object patch side of the lucid warps
    proposal_scale: float = 0.5  # proposal fine-tune size / frame size


@dataclass(frozen=True)
class PremvosConfig:
    proposal: ProposalConfig = field(default_factory=ProposalConfig)
    refine: RefineConfig = field(default_factory=RefineConfig)
    flow: FlowConfig = field(default_factory=FlowConfig)
    reid: ReIDConfig = field(default_factory=ReIDConfig)
    merge: MergeConfig = field(default_factory=MergeConfig)
    pipeline: PipelineConfig = field(default_factory=PipelineConfig)
    finetune: FinetuneConfig = field(default_factory=FinetuneConfig)


def _from_dict(cls, d: dict):
    kwargs = {}
    for f in dataclasses.fields(cls):
        if f.name not in d:
            continue
        v = d[f.name]
        if dataclasses.is_dataclass(f.type) or (
            isinstance(f.type, str) and f.type.endswith("Config")
        ):
            sub = f.default_factory()  # type: ignore[misc]
            kwargs[f.name] = _from_dict(type(sub), v)
        elif isinstance(v, list):
            kwargs[f.name] = tuple(v)
        else:
            kwargs[f.name] = v
    return cls(**kwargs)


def load_config(path) -> PremvosConfig:
    """Load a JSON preset (partial trees allowed; defaults fill the rest)."""
    with open(path) as f:
        return _from_dict(PremvosConfig, json.load(f))


def save_config(path, cfg: PremvosConfig) -> None:
    """Write the config tree as JSON (the JAX package's format, byte for
    byte: either package loads the other's file)."""
    with open(path, "w") as f:
        json.dump(dataclasses.asdict(cfg), f, indent=2)
