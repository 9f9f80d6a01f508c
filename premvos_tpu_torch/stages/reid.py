"""Stage 4: ReID embeddings (port of premvos_tpu/stages/reid.py)."""

from __future__ import annotations

import torch

from premvos_tpu_torch.ops.roi_align import crop_and_resize


def make_reid_crops(image, boxes, crop_size: int = 128):
    """[B, 3, H, W] images + [B, N, 4] xyxy → [B, N, 3, S, S] crops."""
    h, w = image.shape[-2:]
    norm = torch.stack(
        [
            boxes[..., 1] / (h - 1),
            boxes[..., 0] / (w - 1),
            boxes[..., 3] / (h - 1),
            boxes[..., 2] / (w - 1),
        ],
        dim=-1,
    )
    return crop_and_resize(image, norm, crop_size)


def run_reid(model, image, boxes, valid, crop_size: int = 128):
    """Embed each image's box crops → [B, N, E] (zero rows where invalid)."""
    crops = make_reid_crops(image, boxes, crop_size)
    b, n = crops.shape[:2]
    emb = model(crops.reshape(b * n, *crops.shape[2:])).reshape(b, n, -1)
    return emb * valid[..., None].to(emb.dtype)


def pairwise_sq_distances(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Squared Euclidean distances [K, E] × [N, E] → [K, N]."""
    aa = torch.sum(a * a, dim=-1)[:, None]
    bb = torch.sum(b * b, dim=-1)[None, :]
    return torch.clamp(aa + bb - 2.0 * (a @ b.T), min=0.0)


def reid_similarity(ref_emb, prop_emb, sigma: float = 1.0) -> torch.Tensor:
    """exp(−d²/σ²) in [0, 1], [K, N], on L2-normalized embeddings."""

    def _norm(x):
        return x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True), min=1e-6)

    d2 = pairwise_sq_distances(_norm(ref_emb), _norm(prop_emb))
    return torch.exp(-d2 / (sigma * sigma))
