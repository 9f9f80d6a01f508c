"""Synthetic video sequences, drawn on the device from the seed and kept on
the host as the program's users hold decoded frames.

A sequence of a traffic file (frames, objects, the frame each object enters)
becomes textured rectangles drifting over a smooth background, with a
little noise: frames [T, H, W, 3] uint8, the annotation gt_masks [K, H, W]
float32 (object k's visible pixels in its entry frame, later objects drawn
over earlier ones) and intro_frames [K]. Sizes, positions, speeds, textures
and colours come from the seed; the list of sequences, their lengths and
object counts come from the traffic file alone.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from portbench.weights import sub_seed


@dataclass
class Sequence:
    name: str
    frames: np.ndarray  # [T, H, W, 3] uint8
    gt_masks: np.ndarray  # [K, H, W] float32
    num_objects: int
    intro_frames: np.ndarray  # [K] int64

    @property
    def tracked(self) -> int:
        """Frames after the first: the frames the tracker labels."""
        return self.frames.shape[0] - 1


def _uniform(gen, lo, hi, device, n=()):
    return lo + (hi - lo) * torch.rand(n, generator=gen, device=device)


def _bounce(p0, v, t, span):
    """Positions p0 + v·t reflected into [0, span]."""
    if span <= 0:
        return torch.zeros_like(t)
    x = torch.remainder(p0 + v * t, 2 * span)
    return torch.where(x > span, 2 * span - x, x)


def make_sequence(spec: dict, height: int, width: int, max_objects: int, seed: int, index: int,
                  device) -> Sequence:
    """One sequence of a traffic file: spec {"name", "frames", "objects",
    optionally "intro_frames"} at height × width, from (seed, index)."""
    t_len, k = int(spec["frames"]), int(spec["objects"])
    if not 1 <= k <= max_objects:
        raise ValueError(f"{spec['name']}: {k} objects, the configuration holds 1..{max_objects}")
    intro = [int(v) for v in spec.get("intro_frames", [0] * k)]
    if len(intro) != k or intro[0] != 0 or not all(0 <= v < t_len for v in intro):
        raise ValueError(f"{spec['name']}: intro_frames {intro} for {k} objects in {t_len} frames "
                         "(the first object is annotated at frame 0)")
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, 2, index))
    h, w = height, width
    yy = torch.arange(h, device=device, dtype=torch.float32)[:, None]
    xx = torch.arange(w, device=device, dtype=torch.float32)[None, :]
    freq = _uniform(gen, 20.0, 60.0, device, (3, 2))
    phase = _uniform(gen, 0.0, 6.2832, device, (3,))
    base = torch.stack([128 + 60 * torch.sin(xx / freq[c, 0] + yy / freq[c, 1] + phase[c])
                        for c in range(3)], -1)  # [H, W, 3]
    t = torch.arange(t_len, device=device, dtype=torch.float32)
    objs = []
    for i in range(k):
        oh = int(_uniform(gen, h / 6, h / 3, device).item())
        ow = int(_uniform(gen, w / 8, w / 4, device).item())
        y0, x0 = _uniform(gen, 0, h - oh, device), _uniform(gen, 0, w - ow, device)
        vy, vx = _uniform(gen, -4.0, 4.0, device), _uniform(gen, -4.0, 4.0, device)
        ys = _bounce(y0, vy, t, h - oh).round().to(torch.int64).tolist()
        xs = _bounce(x0, vx, t, w - ow).round().to(torch.int64).tolist()
        colour = _uniform(gen, 30.0, 225.0, device, (3,))
        tex = colour + 40.0 * (torch.rand((oh, ow, 3), generator=gen, device=device) - 0.5)
        objs.append((oh, ow, ys, xs, tex))
    frames = torch.empty((t_len, h, w, 3), dtype=torch.uint8, device=device)
    label_at = {}
    for f in range(t_len):
        img = base.clone()
        lab = torch.zeros((h, w), dtype=torch.int64, device=device) if f in intro else None
        for i, (oh, ow, ys, xs, tex) in enumerate(objs):
            if f < intro[i]:
                continue
            y, x = ys[f], xs[f]
            img[y:y + oh, x:x + ow] = tex
            if lab is not None:
                lab[y:y + oh, x:x + ow] = i + 1
        img += 4.0 * torch.randn((h, w, 3), generator=gen, device=device)
        frames[f] = img.clamp(0, 255).round().to(torch.uint8)
        if lab is not None:
            label_at[f] = lab
    gt = torch.zeros((max_objects, h, w), dtype=torch.float32, device=device)
    for i in range(k):
        gt[i] = (label_at[intro[i]] == i + 1).to(torch.float32)
    intro_frames = np.zeros((max_objects,), np.int64)
    intro_frames[:k] = intro
    return Sequence(spec["name"], frames.cpu().numpy(), gt.cpu().numpy(), k, intro_frames)


def make_traffic(traffic: dict, cfg, seed: int, device) -> list:
    """Every sequence of a traffic file, in its order."""
    p = cfg.pipeline
    specs = traffic["sequences"]
    return [make_sequence(spec, p.image_height, p.image_width, p.max_objects, seed, i, device)
            for i, spec in enumerate(specs)]
