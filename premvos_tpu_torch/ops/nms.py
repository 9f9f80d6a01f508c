"""Fixed-shape greedy non-maximum suppression (port of premvos_tpu/ops/nms.py
and of the Pallas kernel premvos_tpu/ops/pallas/nms_pallas.py).

Always returns `max_outputs` indices (−1-padded) plus a validity mask,
batched over images: boxes [B, N, 4] / scores [B, N] → ([B, max_outputs],
[B, max_outputs]).

`nms` dispatches on the tensors' device: CUDA tensors go to the CUDA kernel
(kernels/nms.cu, through `nms_cuda`, which also compacts the kept indices),
CPU tensors to `nms_reference`.
"""

from __future__ import annotations

import torch

from premvos_tpu_torch import kernels
from premvos_tpu_torch.ops.boxes import box_iou

NEG_INF = -1e10


def _sort(boxes, scores, score_threshold, valid):
    """Stable descending score order (NaN scores last, as jnp.argsort(-s)),
    the boxes in that order, and which of them clear the score threshold."""
    if valid is not None:
        scores = torch.where(valid, scores, torch.full_like(scores, NEG_INF))
    # Ascending sort of −scores, not descending=True: NaN then sorts last.
    order = torch.sort(-scores, dim=-1, stable=True).indices
    boxes_s = torch.gather(
        boxes.to(torch.float32), -2, order[..., None].expand(*order.shape, 4)
    )
    alive = torch.gather(scores, -1, order) > score_threshold
    return order, boxes_s, alive


def _compact(order, kept, max_outputs):
    """Kept indices, in score order, into the first of max_outputs slots."""
    b = order.shape[0]
    rank = torch.cumsum(kept.to(torch.int64), dim=-1) - 1
    slot = torch.where(
        kept & (rank < max_outputs), rank, torch.full_like(rank, max_outputs)
    )
    indices = torch.full(
        (b, max_outputs + 1), -1, dtype=torch.int32, device=order.device
    )
    indices.scatter_(-1, slot, order.to(torch.int32))
    indices = indices[:, :max_outputs]
    return indices, indices >= 0


def nms_reference(
    boxes: torch.Tensor,
    scores: torch.Tensor,
    max_outputs: int,
    iou_threshold: float = 0.5,
    score_threshold: float = NEG_INF,
    valid: torch.Tensor | None = None,
):
    """Plain PyTorch greedy NMS: the dense IoU matrix and a sequential sweep.

    boxes xyxy; a box with IoU > iou_threshold against an earlier kept box is
    suppressed; scores at or below score_threshold (and invalid rows) are
    dropped. Returns (indices int32, keep bool).
    """
    order, boxes_s, alive = _sort(boxes, scores, score_threshold, valid)
    n = boxes.shape[-2]
    iou = box_iou(boxes_s, boxes_s)  # [B, N, N]
    col = torch.arange(n, device=boxes.device)
    suppressed = torch.zeros_like(alive)
    for i in range(n):
        keep_i = ~suppressed[:, i] & alive[:, i]
        new_sup = keep_i[:, None] & (iou[:, i] > iou_threshold) & (col > i)
        suppressed = suppressed | new_sup
    kept = ~suppressed & alive
    return _compact(order, kept, max_outputs)


def nms_cuda(
    boxes: torch.Tensor,
    scores: torch.Tensor,
    max_outputs: int,
    iou_threshold: float = 0.5,
    score_threshold: float = NEG_INF,
    valid: torch.Tensor | None = None,
):
    """The CUDA kernel (kernels/nms.cu); same contract as nms_reference,
    for float32 scores (another dtype raises: the kernel compares scores in
    float32, the plain version in their own dtype).

    Invalid rows are scored NEG_INF and the stable sort runs in PyTorch, as
    in nms_reference; one C call launches the mask pass and the sweep, which
    gathers the boxes through the sort's order, decides which boxes survive
    and writes the indices and the validity mask itself.
    `nms_cuda.launches` counts the calls that launch them.
    """
    b, n = scores.shape
    if boxes.shape != (b, n, 4) or (valid is not None and valid.shape != (b, n)):
        raise ValueError(
            f"nms: boxes {tuple(boxes.shape)}, scores {tuple(scores.shape)}"
            + ("" if valid is None else f", valid {tuple(valid.shape)}")
        )
    if scores.dtype != torch.float32:
        raise TypeError(f"nms_cuda: scores must be float32, got {scores.dtype}")
    if valid is not None:
        scores = torch.where(valid, scores, NEG_INF)
    # Ascending sort of −scores, not descending=True: NaN then sorts last.
    neg_sorted, order = torch.sort(-scores, dim=-1, stable=True)
    boxes = boxes.to(torch.float32).contiguous()
    kernels.require_cuda("nms", boxes, order)
    dev = boxes.device
    indices = torch.empty((b, max_outputs), dtype=torch.int32, device=dev)
    keep = torch.empty((b, max_outputs), dtype=torch.bool, device=dev)
    if n == 0:
        return indices.fill_(-1), keep.fill_(False)
    words = (n + 63) // 64
    mask = torch.empty((b, n, 2 * (words // 2 + 1)), dtype=torch.int64, device=dev)
    kernels.launch(
        "nms", boxes.data_ptr(), order.data_ptr(), neg_sorted.data_ptr(), b, n,
        float(iou_threshold), float(score_threshold), int(max_outputs), mask.data_ptr(),
        indices.data_ptr(), keep.data_ptr(), kernels.stream_of(boxes),
    )
    nms_cuda.launches += 1
    return indices, keep


nms_cuda.launches = 0


def nms(
    boxes: torch.Tensor,
    scores: torch.Tensor,
    max_outputs: int,
    iou_threshold: float = 0.5,
    score_threshold: float = NEG_INF,
    valid: torch.Tensor | None = None,
):
    """Dispatching entry point: the kernel for CUDA tensors, the plain
    version for CPU tensors."""
    fn = nms_cuda if boxes.is_cuda else nms_reference
    return fn(boxes, scores, max_outputs, iou_threshold, score_threshold, valid)
