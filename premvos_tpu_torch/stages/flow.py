"""Stage 3: optical flow and backward mask warping (port of
premvos_tpu/stages/flow.py). Flow is [2, H, W] (u, v), current → previous
frame; warping pulls each current pixel's value from the previous frame."""

from __future__ import annotations

import torch

from premvos_tpu_torch.ops.resample2d import warp
from premvos_tpu_torch.ops.resize import resize_bilinear


def flow_pairs(model, cur, prev, infer_hw=None) -> torch.Tensor:
    """Backward flow of C frame pairs: cur, prev [C, H, W, 3] in [0, 1] →
    [C, 2, H, W], flow(cur → prev). With `infer_hw` (64-multiples) other
    than (H, W) the frames are resized for the net and the flow is resized
    and rescaled back."""
    c, h, w, _ = cur.shape
    fmt = torch.channels_last if cur.is_cuda else torch.contiguous_format
    cur, prev = cur.permute(0, 3, 1, 2), prev.permute(0, 3, 1, 2)
    if infer_hw is None or tuple(infer_hw) == (h, w):
        return model(cur.contiguous(memory_format=fmt), prev.contiguous(memory_format=fmt))
    fh, fw = infer_hw
    cur, prev = resize_bilinear(cur, (fh, fw)), resize_bilinear(prev, (fh, fw))
    flow = model(cur.contiguous(memory_format=fmt), prev.contiguous(memory_format=fmt))
    flow = resize_bilinear(flow, (h, w))
    scale = torch.tensor([w / fw, h / fh], dtype=flow.dtype, device=flow.device)
    return (flow * scale[:, None, None]).contiguous()


def run_flow_pairs(model, frames, infer_hw=None, chunk=None) -> torch.Tensor:
    """frames [T, H, W, 3] in [0, 1] → backward flow [T−1, 2, H, W], entry t
    the flow of frame t+1 → frame t.

    The pairs are independent: they run `chunk` at a time (all at once when
    None), the last chunk padded with the last frame as run_sequence pads
    its chunks, so the networks see the pipeline's batch shapes and a
    sequence of any length fits the card.
    """
    from premvos_tpu_torch.pipeline.runner import float32_precision

    t, h, w, _ = frames.shape
    steps = t - 1
    if steps < 1:
        return torch.zeros((0, 2, h, w), dtype=torch.float32, device=frames.device)
    chunk = steps if chunk is None else max(1, min(int(chunk), steps))
    out = []
    with torch.inference_mode(), float32_precision():
        for c0 in range(0, steps, chunk):
            n = min(chunk, steps - c0)
            idx = torch.arange(c0 + 1, c0 + 1 + chunk, device=frames.device).clamp(max=t - 1)
            cur, prev = frames[idx], frames[idx - 1]
            prev[n:] = frames[-1]
            out.append(flow_pairs(model, cur, prev, infer_hw)[:n])
    return torch.cat(out)


def warp_masks(masks: torch.Tensor, flow: torch.Tensor, impl: str = "block") -> torch.Tensor:
    """Backward-warp [K, H, W] masks by one [2, H, W] flow: the K masks are
    the channels of one warp, the block warp or ("gather") the exact one."""
    return warp(masks[None], flow[None], impl)[0]


def warp_masks_coarse(masks: torch.Tensor, flow: torch.Tensor, stride: int,
                      impl: str = "block") -> torch.Tensor:
    """Warp at 1/stride resolution, then upsample bilinearly (stride 1 is the
    full-resolution warp). Downsampling antialiases, as jax.image.resize."""
    if stride <= 1:
        return warp_masks(masks, flow, impl)
    h, w = masks.shape[-2:]
    hs, ws = h // stride, w // stride
    flow_s = resize_bilinear(flow[None], (hs, ws))[0] / float(stride)
    masks_s = resize_bilinear(masks[None], (hs, ws))[0]
    warped_s = warp_masks(masks_s, flow_s, impl)
    return resize_bilinear(warped_s[None], (h, w))[0]
