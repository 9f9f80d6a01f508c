"""Stage 5: merging & tracking (port of premvos_tpu/stages/merge.py).

One frame's merge is fixed-shape tensor work on the device — warp, the
[K objects × N proposals] score matrix, a K-step greedy assignment and a
per-pixel argmax — with no host round trip (no `.item()`), so a sequence's
frames queue back to back.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from premvos_tpu_torch.config import MergeConfig
from premvos_tpu_torch.ops.masks import soft_mask_iou
from premvos_tpu_torch.stages.flow import warp_masks_coarse
from premvos_tpu_torch.stages.reid import reid_similarity

NEG = -1e9


class TrackState(NamedTuple):
    prev_masks: torch.Tensor  # [K, H, W] float32 soft masks in the current frame
    ref_emb: torch.Tensor  # [K, E] reference embeddings
    active: torch.Tensor  # [K] bool — object exists in this sequence
    staleness: torch.Tensor  # [K] int32 — frames since last selected


def init_state(gt_masks, gt_emb, num_objects) -> TrackState:
    """First-frame masks [K, H, W] + embeddings [K, E] → initial state."""
    k = gt_masks.shape[0]
    dev = gt_masks.device
    return TrackState(
        prev_masks=gt_masks.to(torch.float32),
        ref_emb=gt_emb.to(torch.float32),
        active=torch.arange(k, device=dev) < num_objects,
        staleness=torch.zeros((k,), dtype=torch.int32, device=dev),
    )


def score_matrix(state, warped, prop_masks, prop_scores, prop_emb, prop_valid,
                 cfg: MergeConfig):
    """([K, N] merge scores with NEG where invalid, [K, N] ReID similarities)."""
    warp_iou = soft_mask_iou(warped, prop_masks)
    sim = reid_similarity(state.ref_emb, prop_emb, cfg.reid_sigma)
    decay = torch.pow(
        torch.tensor(cfg.warp_decay, dtype=torch.float32, device=warped.device),
        state.staleness.to(torch.float32),
    )
    w_dec = warped * decay[:, None, None]
    total = torch.sum(w_dec, dim=0, keepdim=True)
    other_union = torch.clamp(total - w_dec, 0.0, 1.0)
    overlap = soft_mask_iou(other_union, prop_masks)
    s = (
        cfg.w_objectness * prop_scores[None, :]
        + cfg.w_reid * sim
        + cfg.w_warp * decay[:, None] * warp_iou
        - cfg.w_overlap * overlap
    )
    ok = state.active[:, None] & prop_valid[None, :]
    return (
        torch.where(ok, s, torch.full_like(s, NEG)),
        torch.where(ok, sim, torch.zeros_like(sim)),
    )


def greedy_assign(scores: torch.Tensor):
    """Greedy bipartite assignment on [K, N]: repeatedly take the global best
    (object, proposal) pair (first maximum on ties) and remove both.
    Returns (assign [K] int64 proposal index or −1, assign_score [K])."""
    k, n = scores.shape
    dev = scores.device
    rows = torch.arange(k, device=dev)
    cols = torch.arange(n, device=dev)
    s = scores
    assign = torch.full((k,), -1, dtype=torch.int64, device=dev)
    a_score = torch.full((k,), NEG, dtype=torch.float32, device=dev)
    for _ in range(k):
        flat = torch.argmax(s)
        ki, ni = flat // n, flat % n
        val = s.reshape(-1)[flat]
        do = val > NEG / 2
        hit = do & (rows == ki)
        assign = torch.where(hit, ni, assign)
        a_score = torch.where(hit, val.to(torch.float32), a_score)
        drop = do & ((rows[:, None] == ki) | (cols[None, :] == ni))
        s = torch.where(drop, torch.full_like(s, NEG), s)
    return assign, a_score


def resolve_pixels(sel_masks, sel_scores, present, threshold: float = 0.5):
    """[K, H, W] selected masks → [H, W] int32 labels (0 = background): each
    pixel goes to the highest-scoring present object covering it."""
    cover = (sel_masks > threshold) & present[:, None, None]
    pix = torch.where(
        cover, sel_scores[:, None, None].to(torch.float32),
        torch.tensor(NEG, dtype=torch.float32, device=cover.device),
    )
    best = torch.argmax(pix, dim=0)
    return torch.where(cover.any(dim=0), best + 1, 0).to(torch.int32)


def merge_frame(state, prop_masks, prop_scores, prop_emb, prop_valid, flow_back,
                cfg: MergeConfig = MergeConfig(), intro=None):
    """One tracking step.

    prop_masks [N, H, W], prop_scores [N], prop_emb [N, E], prop_valid [N],
    flow_back [2, H, W] (current → previous). intro: optional
    (new_active [K] bool, intro_masks [K, H, W]) — objects introduced this
    frame emit their annotation and join assignment from the next frame.
    Returns (new_state, labels [H, W] int32, info dict).
    """
    warped = warp_masks_coarse(state.prev_masks, flow_back, cfg.warp_stride)
    s, sim = score_matrix(
        state, warped, prop_masks, prop_scores, prop_emb, prop_valid, cfg
    )
    assign, a_score = greedy_assign(s)

    picked = torch.clamp(assign, min=0)
    sel = prop_masks[picked]
    sim_picked = torch.gather(sim, 1, picked[:, None])[:, 0]
    accept = (a_score > cfg.new_object_score_floor) | (sim_picked >= cfg.reid_reacquire)
    present = (assign >= 0) & accept & state.active
    sel = sel * present[:, None, None].to(sel.dtype)

    labels = resolve_pixels(sel, a_score, present, cfg.mask_threshold)

    new_prev = torch.where(present[:, None, None], sel.to(torch.float32), warped)
    staleness = torch.where(present, 0, state.staleness + 1).to(torch.int32)

    ref_emb = state.ref_emb
    if float(cfg.reid_ema) > 0.0:
        a = cfg.reid_ema * present.to(torch.float32)[:, None]
        ref_emb = (1.0 - a) * ref_emb + a * prop_emb[picked].to(torch.float32)
    active = state.active

    if intro is not None:
        new_active, intro_masks = intro
        k = new_prev.shape[0]
        ids = torch.arange(1, k + 1, dtype=torch.int32, device=labels.device)[:, None, None]
        cover = (intro_masks > cfg.mask_threshold) & new_active[:, None, None]
        intro_lab = torch.amax(torch.where(cover, ids, 0), dim=0)
        labels = torch.where(intro_lab > 0, intro_lab, labels)
        new_prev = torch.where(
            new_active[:, None, None], intro_masks.to(torch.float32), new_prev
        )
        staleness = torch.where(new_active, 0, staleness).to(torch.int32)
        active = active | new_active

    new_state = TrackState(new_prev, ref_emb, active, staleness)
    info = {"assign": assign, "score": a_score, "present": present}
    return new_state, labels, info
