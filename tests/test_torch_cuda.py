"""The port's CUDA kernels vs their plain PyTorch versions, on the card.

Marked `cuda`: each test skips without a CUDA device (the kernels have no CPU
mode). This file imports neither JAX nor the JAX package, so it also runs on
a machine without them:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

(--noconftest: tests/conftest.py configures JAX). chip_smoke.py repeats these
comparisons at the production shapes.
"""

import numpy as np
import pytest
import torch

from premvos_tpu_torch.models.maskrcnn import multilevel_roi_align
from premvos_tpu_torch.ops import nms as tnms
from premvos_tpu_torch.ops.correlation import correlation_cuda, correlation_reference
from premvos_tpu_torch.ops.resample2d import resample2d_cuda, resample2d_reference

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _boxes(gen, b, n, size):
    xy = torch.rand(b, n, 2, generator=gen) * size
    wh = torch.rand(b, n, 2, generator=gen) * size / 2 + 1
    return torch.cat([xy, xy + wh], -1)


def test_nms_kernel(dev):
    gen = torch.Generator().manual_seed(0)
    boxes = _boxes(gen, 3, 300, 200.0).to(dev)
    scores = torch.rand(3, 300, generator=gen).to(dev)
    scores[0, :40] = 0.5  # ties
    scores[1, 5] = float("nan")
    for k, thr, sthr in ((64, 0.5, -1e10), (300, 0.7, 0.0), (8, 0.3, 0.4)):
        a = tnms.nms_cuda(boxes, scores, k, thr, sthr)
        b = tnms.nms_reference(boxes, scores, k, thr, sthr)
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_correlation_kernel(dev):
    gen = torch.Generator().manual_seed(1)
    for stride in (2, 1):
        f1 = torch.randn(2, 16, 20, 40, generator=gen).to(dev)
        f2 = torch.randn(2, 16, 20, 40, generator=gen).to(dev)
        torch.testing.assert_close(
            correlation_cuda(f1, f2, 4, stride), correlation_reference(f1, f2, 4, stride),
            rtol=0, atol=1e-5,
        )


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_resample2d_kernel(dev, dtype):
    gen = torch.Generator().manual_seed(2)
    src = torch.randn(2, 5, 30, 40, generator=gen).to(dev, dtype)
    flow = (torch.rand(2, 2, 30, 40, generator=gen) * 80 - 40).to(dev)
    torch.testing.assert_close(
        resample2d_cuda(src, flow), resample2d_reference(src, flow), rtol=0, atol=1e-5
    )


@pytest.mark.parametrize("p", [7, 14])
def test_multilevel_roi_align_kernel(dev, p):
    gen = torch.Generator().manual_seed(3)
    shapes = [(32, 48), (16, 24), (8, 12), (4, 6)]
    feats = {
        f"P{i + 2}": torch.randn(2, 32, h, w, generator=gen).to(dev)
        for i, (h, w) in enumerate(shapes)
    }
    size = torch.rand(2, 9, 1, generator=gen) * 390 + 8
    ctr = torch.rand(2, 9, 2, generator=gen) * torch.tensor([190.0, 120.0])
    rois = torch.cat([ctr - size / 2, ctr + size / 2], -1).to(dev)
    got = multilevel_roi_align(feats, rois, p, 2)
    want = multilevel_roi_align({k: v.cpu() for k, v in feats.items()}, rois.cpu(), p, 2)
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=1e-5)
