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

from premvos_tpu_torch.models.maskrcnn import multilevel_roi_align_auto
from premvos_tpu_torch.ops import nms as tnms
from premvos_tpu_torch.ops.correlation import correlation_cuda, correlation_reference
from premvos_tpu_torch.ops.resample2d import resample2d_cuda, resample2d_reference
from premvos_tpu_torch.ops.roi_align import (
    multilevel_roi_align_reference,
    roi_align_backward_cuda,
    roi_align_cuda,
    roi_align_levels,
    roi_align_reference,
)

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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize(
    "case",
    [
        (1, 12, 9, 37, 4, 2),  # C not a multiple of 16, W not of the tile
        (3, 40, 12, 50, 6, 2),  # B = 3, C = 40
        (1, 256, 10, 23, 20, 2),  # FlowNetC's C and displacement
        (2, 16, 8, 45, 20, 1),  # stride 1 at max displacement 20: D = 41
        (1, 8, 7, 20, 9, 2),  # max displacement not a multiple of the stride
    ],
    ids=["c12", "b3_c40", "c256", "d41", "md9"],
)
def test_correlation_kernel_cases(dev, dtype, case):
    """The tensor-core kernel vs correlation_reference on the float32 values
    of its inputs, atol 1e-5: bf16 inputs as they are (exact products),
    float32 inputs through the three-product split."""
    b, c, h, w, md, stride = case
    gen = torch.Generator().manual_seed(7)
    f1 = torch.randn(b, h, w, c, generator=gen).to(dev, dtype).permute(0, 3, 1, 2)
    f2 = torch.randn(b, h, w, c, generator=gen).to(dev, dtype).permute(0, 3, 1, 2)
    before = correlation_cuda.launches
    got = correlation_cuda(f1, f2, md, stride)
    torch.cuda.synchronize()
    d = 2 * (md // stride) + 1
    assert got.shape == (b, d * d, h, w) and got.dtype == torch.float32
    assert correlation_cuda.launches == before + 1
    want = correlation_reference(f1.float(), f2.float(), md, stride)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)


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
    got = multilevel_roi_align_auto(feats, rois, p, 2)
    want = multilevel_roi_align_auto({k: v.cpu() for k, v in feats.items()}, rois.cpu(), p, 2)
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=1e-5)


def _single_level_case(gen, dev, dtype):
    """Features [2, 24, 32, 16] at scale 1/4, and boxes (image coordinates)
    that include a degenerate one, one off the image, ones past the right
    and bottom edges (samples clamp: both taps on the last row or column)
    and tiny ones (many samples on one pixel: atomics collide)."""
    feats = torch.randn(2, 24, 32, 16, generator=gen).to(dev, dtype)
    fixed = torch.tensor([
        [40.0, 40.0, 40.0, 40.0], [-240.0, -200.0, -80.0, -48.0],
        [80.0, 56.0, 134.8, 101.2], [-13.2, -10.4, 32.0, 24.0],
        [60.0, 60.0, 61.0, 61.5], [0.0, 0.0, 128.0, 96.0],
    ])
    xy = torch.rand(2, 10, 2, generator=gen) * torch.tensor([128.0, 96.0])
    wh = torch.rand(2, 10, 2, generator=gen) * 60 + 1
    boxes = torch.cat([torch.cat([xy, xy + wh], -1), fixed.expand(2, -1, -1)], 1)
    levels = torch.randint(2, 6, boxes.shape[:2], generator=gen, dtype=torch.int32)
    return feats, boxes.to(dev), levels.to(dev)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("filtered", [False, True], ids=["all", "level_filter"])
def test_roi_align_kernel(dev, dtype, filtered):
    """The single-level forward vs roi_align_reference: float32 1e-5; bf16
    2 ulp of the largest value. With the level filter, only the RoIs of
    that level are written and the other rows keep what `out` held."""
    gen = torch.Generator().manual_seed(4)
    feats, boxes, levels = _single_level_case(gen, dev, dtype)
    p = 7
    want = roi_align_reference(feats, boxes, p, 2, 0.25)
    tol = 1e-5 if dtype == torch.float32 else 2.0 ** -7 * float(want.abs().max())
    if filtered:
        out = torch.full((*boxes.shape[:2], p, p, 16), 3.0, dtype=dtype, device=dev)
        got = roi_align_cuda(feats, boxes, p, 2, 0.25, levels, 4, out)
        on = (levels == 4)[..., None, None, None]
        want = torch.where(on, want, torch.full_like(want, 3.0))
        assert got is out and 0 < int((levels == 4).sum()) < levels.numel()
    else:
        got = roi_align_cuda(feats, boxes, p, 2, 0.25)
    torch.cuda.synchronize()
    assert got.dtype == dtype
    torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=tol)


@pytest.mark.parametrize("filtered", [False, True], ids=["all", "level_filter"])
def test_roi_align_backward_kernel(dev, filtered):
    """The backward kernel vs autograd of roi_align_reference, within 1e-4
    of the largest |grad| (float32 atomics add in a varying order)."""
    gen = torch.Generator().manual_seed(5)
    feats, boxes, levels = _single_level_case(gen, dev, torch.float32)
    p = 14
    cot = torch.randn(*boxes.shape[:2], p, p, 16, generator=gen).to(dev)
    if filtered:
        cot_ref = cot * (levels == 3)[..., None, None, None]
        got = roi_align_backward_cuda(cot, boxes, (24, 32), 2, 0.25, levels, 3)
    else:
        cot_ref = cot
        got = roi_align_backward_cuda(cot, boxes, (24, 32), 2, 0.25)
    f = feats.clone().requires_grad_(True)
    (want,) = torch.autograd.grad(roi_align_reference(f, boxes, p, 2, 0.25), f, cot_ref)
    torch.cuda.synchronize()
    assert got.shape == feats.shape and got.dtype == torch.float32
    torch.testing.assert_close(got, want, rtol=0, atol=1e-4 * float(want.abs().max()))


def test_roi_align_levels_trains_through_the_kernels(dev):
    """The training align on CUDA (four filtered forward launches, four
    backward launches) vs the plain version on the CPU: forward 1e-5, each
    level's gradient 1e-4 of its largest |grad|."""
    gen = torch.Generator().manual_seed(6)
    shapes = [(32, 48), (16, 24), (8, 12), (4, 6)]
    feats = [torch.randn(2, h, w, 8, generator=gen) for h, w in shapes]
    size = torch.rand(2, 30, 1, generator=gen) * 390 + 2
    ctr = torch.rand(2, 30, 2, generator=gen) * torch.tensor([190.0, 120.0])
    boxes = torch.cat([ctr - size / 2, ctr + size / 2], -1)
    levels = torch.clamp(
        torch.floor(4 + torch.log2(size[..., 0] / 224.0)), 2, 5
    ).to(torch.int32)
    cot = torch.randn(2, 30, 14, 14, 8, generator=gen)
    grads = {}
    for d in ("cpu", "cuda"):
        fs = [f.to(d, copy=True).requires_grad_(True) for f in feats]
        before = (roi_align_cuda.launches, roi_align_backward_cuda.launches)
        out = roi_align_levels(fs, boxes.to(d), levels.to(d), 14, 2)
        (out * cot.to(d)).sum().backward()
        grads[d] = (out.detach().cpu(), [f.grad.cpu() for f in fs])
        after = (roi_align_cuda.launches, roi_align_backward_cuda.launches)
        assert after == (before if d == "cpu" else (before[0] + 4, before[1] + 4))
    torch.testing.assert_close(grads["cuda"][0], grads["cpu"][0], rtol=0, atol=1e-5)
    want_fwd = multilevel_roi_align_reference(feats, boxes, levels, 14, 2)
    torch.testing.assert_close(grads["cpu"][0], want_fwd, rtol=0, atol=0)
    for level, (g, w) in enumerate(zip(grads["cuda"][1], grads["cpu"][1])):
        torch.testing.assert_close(
            g, w, rtol=0, atol=1e-4 * float(w.abs().max()), msg=f"P{level + 2}"
        )


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("c", [1, 3, 8, 64])
@pytest.mark.parametrize("hw", [(30, 40), (29, 37)], ids=["w4", "ragged"])
def test_resample2d_kernel_cases(dev, dtype, c, hw):
    """The warp vs resample2d_reference, atol 1e-5, on noise flow, flow far
    out of the image (edge clamp) and zero flow, for rows of a multiple of
    4 pixels (four pixels per thread) and ragged ones (one)."""
    h, w = hw
    gen = torch.Generator().manual_seed(8)
    src = torch.randn(2, c, h, w, generator=gen).to(dev, dtype)
    flows = [
        torch.rand(2, 2, h, w, generator=gen) * 80 - 40,
        torch.full((2, 2, h, w), 500.0),
        torch.full((2, 2, h, w), -41.3),
        torch.zeros(2, 2, h, w),
    ]
    for flow in flows:
        flow = flow.to(dev)
        got = resample2d_cuda(src, flow)
        torch.cuda.synchronize()
        assert got.dtype == torch.float32 and got.shape == src.shape
        torch.testing.assert_close(got, resample2d_reference(src, flow), rtol=0, atol=1e-5)
