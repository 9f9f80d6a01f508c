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


def _clustered(gen, b, n, clusters, jitter):
    """Boxes jittered around `clusters` boxes per image (neighbouring
    anchors on one object): heavy suppression, so the sweep visits every
    box unless max_outputs stops it."""
    ctr = torch.rand(b, clusters, 2, generator=gen) * torch.tensor([864.0, 480.0])
    side = torch.rand(b, clusters, 2, generator=gen) * 160 + 40
    which = torch.randint(0, clusters, (b, n, 1), generator=gen).expand(b, n, 2)
    ctr, side = torch.gather(ctr, 1, which), torch.gather(side, 1, which)
    wh = side * (1 + jitter * torch.randn(b, n, 2, generator=gen))
    xy = ctr - wh / 2 + jitter * side * torch.randn(b, n, 2, generator=gen)
    return torch.cat([xy, xy + wh], -1)


def _nms_equal(boxes, scores, k, thr, sthr, valid=None):
    before = tnms.nms_cuda.launches
    got = tnms.nms_cuda(boxes, scores, k, thr, sthr, valid)
    torch.cuda.synchronize()
    want = tnms.nms_reference(boxes, scores, k, thr, sthr, valid)
    assert tnms.nms_cuda.launches == before + 1
    assert got[0].dtype == torch.int32 and got[1].dtype == torch.bool
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    return want


@pytest.mark.parametrize("b", [1, 8])
@pytest.mark.parametrize("n", [1, 63, 64, 65, 2384])
def test_nms_kernel_sizes(dev, n, b):
    """Exact vs nms_reference at tile edges (N = 63, 64, 65: one tile, one
    full tile, a second tile of one box) and the RPN's N, on spread-out
    boxes (the RPN's keep and IoU) and on clustered boxes (the sweep runs
    through every tile; with max_outputs 4 it stops early), with NaN and
    tied scores and padding rows."""
    gen = torch.Generator().manual_seed(11 + n + b)
    boxes = _boxes(gen, b, n, 600.0).to(dev)
    scores = torch.rand(b, n, generator=gen)
    scores[:, : n // 3] = 0.5  # ties
    scores[:, n // 2] = float("nan")
    valid = torch.rand(b, n, generator=gen) > 0.1
    scores, valid = scores.to(dev), valid.to(dev)
    _nms_equal(boxes, scores, min(n, 256), 0.7, 0.0)
    _nms_equal(boxes, scores, min(n, 32), 0.5, 0.05, valid)
    clustered = _clustered(gen, b, n, 8, 0.03).to(dev)
    kept = _nms_equal(clustered, scores, 256, 0.7, 0.0)[1]
    if n >= 64:
        assert int(kept.sum(1).max()) < 256  # every box visited
    if n > 4:
        assert bool(_nms_equal(clustered, scores, 4, 0.7, -1.0)[1].all())  # early stop


def test_nms_kernel_large_n(dev):
    """N = 10,000 (157 mask words, 165 KB of sweep shared memory): exact on
    clustered boxes, which the sweep visits to the end; past the shared
    memory (N = 16,000) the launch is refused and raises."""
    gen = torch.Generator().manual_seed(15)
    n = 10_000
    boxes = _clustered(gen, 1, n, 200, 0.03).to(dev)
    scores = torch.rand(1, n, generator=gen).to(dev)
    kept = _nms_equal(boxes, scores, 1000, 0.7, 0.0)[1]
    assert int(kept.sum()) < 1000  # no early stop: every tile swept
    big = _clustered(gen, 1, 16_000, 8, 0.03).to(dev)
    with pytest.raises(RuntimeError, match="failed to launch"):
        tnms.nms_cuda(big, torch.rand(1, 16_000, generator=gen).to(dev), 10, 0.7, 0.0)


def test_nms_kernel_dead_and_identical(dev):
    """No box alive (every slot -1), invalid rows alive under a threshold
    below NEG_INF, and identical boxes (one survives per image), over three
    tiles."""
    gen = torch.Generator().manual_seed(12)
    boxes = _boxes(gen, 2, 150, 300.0).to(dev)
    scores = torch.rand(2, 150, generator=gen).to(dev)
    idx, keep = _nms_equal(boxes, scores, 20, 0.5, 2.0)
    assert not bool(keep.any()) and bool((idx == -1).all())
    idx, keep = _nms_equal(boxes, scores, 20, 0.5, 0.0, torch.zeros_like(scores, dtype=torch.bool))
    assert not bool(keep.any())
    # Below NEG_INF, invalid rows (scored NEG_INF) are alive and sort last.
    part = torch.rand(2, 150, generator=gen).to(dev) > 0.3
    idx, keep = _nms_equal(boxes, scores, 150, 0.5, -2e10, part)
    assert bool((keep & ~torch.gather(part, 1, idx.clamp(min=0).long())).any())
    # A negative IoU threshold (the division path): every later box goes.
    idx, keep = _nms_equal(boxes, scores, 20, -0.1, 0.0)
    assert keep.sum(1).tolist() == [1, 1]
    same = torch.tensor([10.0, 20.0, 50.0, 80.0], device=dev).expand(2, 150, 4)
    idx, keep = _nms_equal(same, scores, 20, 0.5, 0.0)
    assert keep.sum(1).tolist() == [1, 1]


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


def _ml_case(gen, dev, c, dtype, n=40, levels_on=None, b=2):
    """P2..P5 [b, H, W, c] of a 128x192 image and n RoIs per image: random
    sizes (every level), plus a degenerate box, one past the right and
    bottom edges and one off the image. With `levels_on`, every RoI is put
    on that level (the other levels get none)."""
    from premvos_tpu_torch.models.maskrcnn import roi_levels

    shapes = [(32, 48), (16, 24), (8, 12), (4, 6)]
    feats = [torch.randn(b, h, w, c, generator=gen).to(dev, dtype) for h, w in shapes]
    size = torch.exp(torch.rand(b, n - 3, 1, generator=gen) * 4.6) * 6
    ctr = torch.rand(b, n - 3, 2, generator=gen) * torch.tensor([192.0, 128.0])
    fixed = torch.tensor([[30.0, 30.0, 30.0, 30.0], [150.0, 100.0, 200.5, 131.0],
                          [300.0, 200.0, 340.0, 240.0]])
    boxes = torch.cat([torch.cat([ctr - size / 2, ctr + size / 2], -1),
                       fixed.expand(b, -1, -1)], 1)
    levels = roi_levels(boxes).to(torch.int32)
    if levels_on is not None:
        levels = torch.full_like(levels, levels_on)
    return feats, boxes.to(dev), levels.to(dev)


@pytest.mark.parametrize(
    "c,dtype,p,levels_on,s",
    [
        (256, torch.bfloat16, 7, None, 2),  # the box head's C and type
        (256, torch.bfloat16, 14, None, 2),  # the mask head's
        (32, torch.float32, 7, None, 2),  # the tiny configuration's
        (20, torch.float32, 14, None, 2),  # C * 4 bytes not a multiple of 16: one channel a lane
        (20, torch.bfloat16, 7, None, 2),
        (24, torch.bfloat16, 7, 3, 2),  # every RoI on P3, none on P2, P4, P5
        (256, torch.float32, 7, 5, 2),
        # Sampling ratios other than 2 take the kernel's run-time tap loops.
        (256, torch.bfloat16, 7, None, 1),
        (256, torch.bfloat16, 14, None, 3),
        (20, torch.float32, 7, None, 1),
        (20, torch.float32, 14, None, 3),
    ],
    ids=["bf16_c256_p7", "bf16_c256_p14", "f32_c32", "f32_c20", "bf16_c20", "one_level_p3",
         "f32_c256_p5", "bf16_c256_s1", "bf16_c256_s3", "f32_c20_s1", "f32_c20_s3"],
)
def test_multilevel_roi_align_kernel_cases(dev, c, dtype, p, levels_on, s):
    """The multilevel kernel vs multilevel_roi_align_reference on the card:
    float32 1e-5, bf16 2 ulp of the largest value (chip_smoke.py phase 3's
    tolerances)."""
    from premvos_tpu_torch.ops.roi_align import multilevel_roi_align_cuda

    gen = torch.Generator().manual_seed(13 + c + p + 100 * (s - 2))  # s = 2 keeps 13 + c + p
    feats, boxes, levels = _ml_case(gen, dev, c, dtype, levels_on=levels_on)
    if levels_on is None:
        assert sorted(set(levels.flatten().tolist())) == [2, 3, 4, 5]
    before = multilevel_roi_align_cuda.launches
    got = multilevel_roi_align_cuda(feats, boxes, levels, p, s)
    torch.cuda.synchronize()
    assert multilevel_roi_align_cuda.launches == before + 1
    assert got.dtype == dtype and got.shape == (2, boxes.shape[1], p, p, c)
    want = multilevel_roi_align_reference(feats, boxes, levels, p, s)
    tol = 1e-5 if dtype == torch.float32 else 2.0 ** -7 * float(want.float().abs().max())
    torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_multilevel_roi_align_kernel_unaligned(dev, dtype):
    """Levels that are contiguous views at an odd element offset (base
    pointers not 16-byte aligned) take the one-channel-a-lane path and agree
    as well."""
    from premvos_tpu_torch.ops.roi_align import multilevel_roi_align_cuda

    gen = torch.Generator().manual_seed(14)
    feats, boxes, levels = _ml_case(gen, dev, 32, dtype)
    got = multilevel_roi_align_cuda([_odd_view(f) for f in feats], boxes, levels, 7, 2)
    want = multilevel_roi_align_reference(feats, boxes, levels, 7, 2)
    tol = 1e-5 if dtype == torch.float32 else 2.0 ** -7 * float(want.float().abs().max())
    torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=tol)


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


LEVEL_STRIDES = (4, 8, 16, 32)


def _odd_view(f):
    """A contiguous copy of f at an odd element offset (base pointer not
    16-byte aligned)."""
    flat = torch.empty(f.numel() + 1, dtype=f.dtype, device=f.device)
    view = flat[1:].view(f.shape)
    view.copy_(f)
    assert view.is_contiguous() and view.data_ptr() % 16 != 0
    return view


def _second_path(boxes, p, s, scale, hw):
    """Per RoI, whether the backward kernel takes its second path: the
    rectangle of level pixels its sample taps span (fh x fw) is too large
    for its shared-memory tables: P * max(fh, fw) > kWRows = 2048 or
    max(fh, fw) > kMaxSpan = 512 (kernels/roi_align.cu)."""
    bx = boxes.double() * scale - 0.5
    g = (torch.arange(p * s, dtype=torch.float64, device=boxes.device) + 0.5) / (p * s)
    sides = []
    for lo, hi, size in ((1, 3, hw[0]), (0, 2, hw[1])):
        c = (bx[..., lo:lo + 1] + g * (bx[..., hi:hi + 1] - bx[..., lo:lo + 1]).clamp(min=1e-6))
        c = c.clamp(0, size - 1)
        sides.append((c.max(-1).values.floor() + 1).clamp(max=size - 1)
                     - c.min(-1).values.floor() + 1)
    fh, fw = sides
    return (p * torch.maximum(fh, fw) > 2048) | (torch.maximum(fh, fw) > 512)


# (C, dtype, P, s, boxes, B, N): "mixed" is _ml_case's boxes on their own
# levels, "p3" every RoI on P3 (P2, P4 and P5 hold none), "contention" 64
# overlapping boxes of about 8 px on P2 (hundreds of taps per pixel),
# "unaligned" the mixed case on odd-offset views of the levels, "whole" an
# unfiltered single-level call on a 120 x 160 level (a 480 x 640 image at
# scale 1/4) with the mixed boxes tripled and one box spanning the whole
# level (the backward's second path; the others take the first).
TRAIN_ALIGN_CASES = {
    "f32_c256_p7": (256, torch.float32, 7, 2, "mixed", 2, 40),
    "f32_c256_p14": (256, torch.float32, 14, 2, "mixed", 2, 40),
    "bf16_c256_p7": (256, torch.bfloat16, 7, 2, "mixed", 2, 40),
    "bf16_c20_p14": (20, torch.bfloat16, 14, 2, "mixed", 2, 40),  # forward one channel a lane
    "f32_c18_p7": (18, torch.float32, 7, 2, "mixed", 2, 40),  # both kernels' scalar paths
    "f32_c256_unaligned": (256, torch.float32, 7, 2, "unaligned", 2, 40),
    "f32_c256_p7_s1": (256, torch.float32, 7, 1, "mixed", 2, 40),
    "bf16_c256_p14_s1": (256, torch.bfloat16, 14, 1, "mixed", 2, 40),
    "f32_c20_p14_s3": (20, torch.float32, 14, 3, "mixed", 2, 40),
    "f32_c256_p7_s3": (256, torch.float32, 7, 3, "mixed", 2, 40),
    "one_level_p3": (64, torch.float32, 14, 2, "p3", 2, 40),
    "contention": (256, torch.float32, 14, 2, "contention", 2, 64),
    "b3_n37": (32, torch.float32, 7, 2, "mixed", 3, 37),
    "n600": (16, torch.float32, 7, 2, "mixed", 2, 600),  # compaction in several rounds
    "whole_level_f32_c256": (256, torch.float32, 14, 2, "whole", 2, 40),
    "whole_level_f32_c18": (18, torch.float32, 14, 3, "whole", 2, 40),
}


@pytest.mark.parametrize("case", list(TRAIN_ALIGN_CASES), ids=list(TRAIN_ALIGN_CASES))
def test_roi_align_train_kernels_cases(dev, case):
    """The single-level forward and backward kernels, launched once per
    level with the level filter as training launches them (or once,
    unfiltered, on P2 for "whole"), vs the plain version and its autograd:
    forward float32 1e-5, bf16 2 ulp of the largest value; each level's
    gradient 1e-4 of its largest |grad| (float32 atomics add in a varying
    order)."""
    c, dtype, p, s, kind, b, n = TRAIN_ALIGN_CASES[case]
    gen = torch.Generator().manual_seed(21 + c + p + n + 10 * s)
    feats, boxes, levels = _ml_case(gen, dev, c, dtype, n=n, b=b,
                                    levels_on=3 if kind == "p3" else None)
    if kind == "contention":
        ctr = torch.tensor([40.0, 30.0]) + torch.rand(b, n, 2, generator=gen) * 3
        half = 4.0 + torch.rand(b, n, 1, generator=gen)
        boxes = torch.cat([ctr - half, ctr + half], -1).to(dev)
        levels = torch.full((b, n), 2, dtype=torch.int32, device=dev)
    if kind == "unaligned":
        feats = [_odd_view(f) for f in feats]
    cot = torch.randn(b, n, p, p, c, generator=gen).to(dev)
    before = (roi_align_cuda.launches, roi_align_backward_cuda.launches)
    leaves = [f.float().clone().requires_grad_(True) for f in feats]
    if kind == "whole":
        hw = (120, 160)
        feats = [torch.randn(b, *hw, c, generator=gen).to(dev, dtype)]
        leaves = [feats[0].float().clone().requires_grad_(True)]
        boxes = boxes * 3.0
        boxes[:, -1] = torch.tensor([0.0, 0.0, 640.0, 480.0], device=dev)
        second = _second_path(boxes, p, s, 0.25, hw)
        assert bool(second[:, -1].all()) and not bool(second[:, :-1].all())
        got = roi_align_cuda(feats[0], boxes, p, s, 0.25)
        grads = [roi_align_backward_cuda(cot, boxes, hw, s, 0.25)]
        want = roi_align_reference(feats[0], boxes, p, s, 0.25)
        want_g = torch.autograd.grad(roi_align_reference(leaves[0], boxes, p, s, 0.25),
                                     leaves[0], cot)
        launches = 1
    else:
        got = torch.full((b, n, p, p, c), 7.0, dtype=dtype, device=dev)
        grads = []
        for li, (f, st) in enumerate(zip(feats, LEVEL_STRIDES)):
            assert roi_align_cuda(f, boxes, p, s, 1.0 / st, levels, li + 2, got) is got
            grads.append(roi_align_backward_cuda(cot, boxes, tuple(f.shape[1:3]), s,
                                                 1.0 / st, levels, li + 2))
        want = multilevel_roi_align_reference(feats, boxes, levels, p, s)
        want_g = torch.autograd.grad(multilevel_roi_align_reference(leaves, boxes, levels, p, s),
                                     leaves, cot)
        launches = 4
    torch.cuda.synchronize()
    assert (roi_align_cuda.launches, roi_align_backward_cuda.launches) == (
        before[0] + launches, before[1] + launches)
    assert got.dtype == dtype and got.shape == (b, n, p, p, c)
    tol = 1e-5 if dtype == torch.float32 else 2.0 ** -7 * float(want.float().abs().max())
    torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=tol)
    for li, (g, w) in enumerate(zip(grads, want_g)):
        assert g.dtype == torch.float32 and g.shape == w.shape
        # Every level that holds a RoI gets a gradient; the others none.
        held = kind == "whole" or bool((levels == li + 2).any())
        assert (float(w.abs().max()) > 0) == held
        torch.testing.assert_close(g, w, rtol=0, atol=1e-4 * float(w.abs().max()),
                                   msg=f"P{li + 2}")


def test_roi_align_kernels_compaction_limit(dev):
    """With a level filter, n = 4096 RoIs per image (the compacted list's
    limit) agree with the plain version; n = 4097 is refused by both
    kernels and raises."""
    gen = torch.Generator().manual_seed(22)
    feats, boxes, levels = _ml_case(gen, dev, 8, torch.float32, n=4097)
    f, scale, hw = feats[0], 0.25, tuple(feats[0].shape[1:3])
    cot = torch.randn(2, 4097, 7, 7, 8, generator=gen).to(dev)
    out = torch.zeros(2, 4096, 7, 7, 8, device=dev)
    got = roi_align_cuda(f, boxes[:, :4096], 7, 2, scale, levels[:, :4096], 2, out)
    got_g = roi_align_backward_cuda(cot[:, :4096], boxes[:, :4096], hw, 2, scale,
                                    levels[:, :4096], 2)
    torch.cuda.synchronize()
    on = (levels[:, :4096] == 2)[..., None, None, None]
    want = torch.where(on, roi_align_reference(f, boxes[:, :4096], 7, 2, scale), 0.0)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
    leaf = f.clone().requires_grad_(True)
    (want_g,) = torch.autograd.grad(roi_align_reference(leaf, boxes[:, :4096], 7, 2, scale),
                                    leaf, cot[:, :4096] * on)
    torch.testing.assert_close(got_g, want_g, rtol=0, atol=1e-4 * float(want_g.abs().max()))
    out = torch.zeros(2, 4097, 7, 7, 8, device=dev)
    with pytest.raises(RuntimeError, match="failed to launch"):
        roi_align_cuda(f, boxes, 7, 2, scale, levels, 2, out)
    with pytest.raises(RuntimeError, match="failed to launch"):
        roi_align_backward_cuda(cot, boxes, hw, 2, scale, levels, 2)


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
