"""Image preprocessing (port of premvos_tpu/data/preprocess.py)."""

from __future__ import annotations

import torch

# ImageNet statistics (the backbones' pretraining convention).
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def normalize(image: torch.Tensor) -> torch.Tensor:
    """uint8/float [0,255] or [0,1] RGB [..., 3] → ImageNet-normalized float32.

    The range test takes ONE max over the whole tensor (a batch of frames is
    scaled together), as the JAX version does.
    """
    x = image.to(torch.float32)
    x = torch.where(x.amax() > 2.0, x / 255.0, x)
    mean = torch.tensor(IMAGENET_MEAN, dtype=torch.float32, device=x.device)
    std = torch.tensor(IMAGENET_STD, dtype=torch.float32, device=x.device)
    return (x - mean) / std


def to_unit(image: torch.Tensor) -> torch.Tensor:
    """uint8 RGB → [0,1] float32 (flow net convention)."""
    return image.to(torch.float32) / 255.0
