"""On-device Lucid-Data-Dreaming augmentation (port of
premvos_tpu/finetune/lucid_device.py), batched over examples.

Each draw re-composites the first frame: the inpainted background under a
small affine warp and a photometric jitter, then every valid object slot,
in ascending order (a later slot overwrites an earlier one), cut from a
P×P patch around the object, warped by a rotation, a scale and (with
probability `elastic_prob`) a smooth elastic field, jittered photometrically
and pasted back at a shifted centre. The parameter ranges are the JAX
package's (background: rotation ±5°, scale 0.9-1.1, shift ±5 %; objects:
rotation ±15°, scale 0.9-1.1, shift ±10 %, elastic alpha 8 / sigma 12 drawn
at 1/8 resolution; photometric contrast 0.8-1.2, brightness ±20, channel
gain 0.9-1.1).

Random draws are split from the work. `sample_lucid_draws` draws every
value the JAX `lucid_frame` draws, from an explicit `torch.Generator`, and
`lucid_frames` is a deterministic function of those draws; the example
draws of the refine batch (`sample_refine_draws`) and the proposal batch
(`sample_proposal_draws`) follow the same split. JAX folds PRNG keys, which
torch cannot reproduce; with the split, a test re-derives JAX's draws from
its key and feeds them to the port. Invalid slots get their draws too, so
that the draws keep their positions, but no work: the host knows which
slots are valid.

Warps. Both of JAX's `resample2d_block` calls (the background, `:206`, and
the object patches, `:255`) are the port's `ops.resample2d.resample2d_block`
with JAX's explicit parameters, whatever the config's `warp_impl` says: the
background with 16×16 blocks, residual 4 and `max_flow` 160 (exact at these
ranges), the patches with 8×8 blocks, residual 6 and `max_flow` 64, which
clamps the rare pixels of the elastic field that leave a block's window to
its edge, as JAX does. One launch each per batch (the block kernel on the
card): [B, 3, H, W] for the backgrounds and [B·K, 4, P, P] for the patches
of the K valid slots.

Crop and paste are `ops.roi_align.crop_and_resize` and
`ops.masks.paste_mask` at `precision` (RefineConfig.interp_precision:
"default" = bf16 operands; None = float32, what the proposal batch uses).
An object's patch depends on the first frame and its mask only, so it is
cut once per call and shared by the batch.

Layouts are channels first: images [3, H, W] (0..255 float32), masks
[K, H, W], batches [B, ...], flows [.., 2, H, W] (dx, dy), the resample2d
convention (JAX: [H, W, 3] and [H, W, 2]).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from premvos_tpu_torch.data.preprocess import IMAGENET_MEAN, IMAGENET_STD
from premvos_tpu_torch.ops.masks import paste_mask
from premvos_tpu_torch.ops.resample2d import resample2d_block
from premvos_tpu_torch.ops.resize import resize_bilinear
from premvos_tpu_torch.ops.roi_align import crop_and_resize
from premvos_tpu_torch.pipeline.runner import boxes_from_masks
from premvos_tpu_torch.stages.refine import expand_boxes


class LucidDraws(NamedTuple):
    """Every random value of B lucid draws with K slots.

    bg_affine [B, 4] and affine [B, K, 4]: (angle in radians, scale, shift
    x, shift y in pixels); bg_photo [B, 5] and photo [B, K, 5]: (contrast,
    brightness, gain r, g, b); noise [B, K, 2, P//8, P//8] uniform in
    [-1, 1) (at least 4×4); elastic [B, K] bool: whether a slot's elastic
    field is applied.
    """

    bg_affine: torch.Tensor
    bg_photo: torch.Tensor
    affine: torch.Tensor
    noise: torch.Tensor
    elastic: torch.Tensor
    photo: torch.Tensor


def _uniform(gen, shape, lo, hi):
    return torch.rand(shape, generator=gen, device=gen.device) * (hi - lo) + lo


def _affine(gen, shape, max_rot, scale_lo, scale_hi, max_shift_x, max_shift_y):
    """[..., 4] (angle rad, scale, tx, ty), JAX's sample_affine ranges."""
    ang = _uniform(gen, shape, -max_rot, max_rot) * (math.pi / 180.0)
    sc = _uniform(gen, shape, scale_lo, scale_hi)
    tx = _uniform(gen, shape, -max_shift_x, max_shift_x)
    ty = _uniform(gen, shape, -max_shift_y, max_shift_y)
    return torch.stack([ang, sc, tx, ty], -1)


def _photo(gen, shape):
    """[..., 5] (contrast, brightness, gain × 3), JAX's photometric ranges."""
    c = _uniform(gen, (*shape, 1), 0.8, 1.2)
    b = _uniform(gen, (*shape, 1), -20.0, 20.0)
    g = _uniform(gen, (*shape, 3), 0.9, 1.1)
    return torch.cat([c, b, g], -1)


def noise_hw(patch: int, ds: int = 8) -> tuple:
    """The elastic noise's [h, w] for a P×P patch (smooth_field's)."""
    return max(patch // ds, 4), max(patch // ds, 4)


def sample_lucid_draws(gen: torch.Generator, n: int, k: int, h: int, w: int, patch: int,
                       elastic_prob: float = 0.8) -> LucidDraws:
    """Every value n lucid draws of an [h, w] frame with k slots need, on
    `gen`'s device."""
    return LucidDraws(
        bg_affine=_affine(gen, (n,), 5.0, 0.9, 1.1, 0.05 * w, 0.05 * h),
        bg_photo=_photo(gen, (n,)),
        affine=_affine(gen, (n, k), 15.0, 0.9, 1.1, 0.1 * w, 0.1 * h),
        noise=_uniform(gen, (n, k, 2, *noise_hw(patch)), -1.0, 1.0),
        elastic=torch.rand((n, k), generator=gen, device=gen.device) < elastic_prob,
        photo=_photo(gen, (n, k)),
    )


def _gauss_kernel(sigma: float, radius: int) -> torch.Tensor:
    x = torch.arange(-radius, radius + 1, dtype=torch.float32)
    k = torch.exp(-0.5 * (x / sigma) ** 2)
    return k / torch.sum(k)


def smooth_field(noise: torch.Tensor, h: int, w: int, alpha: float = 8.0,
                 sigma: float = 12.0, ds: int = 8) -> torch.Tensor:
    """Smooth random displacement fields [..., 2, h, w] (dx, dy) from white
    noise [..., 2, h/ds, w/ds]: a separable Gaussian blur at sigma/ds (zero
    padding), scaled by alpha and upsampled bilinearly (the LDD elastic
    recipe at 1/ds resolution, as the JAX package draws it)."""
    s = sigma / ds
    r = max(int(3 * s + 0.5), 1)
    k = _gauss_kernel(s, r).to(noise.device)
    lead = noise.shape[:-2]
    x = noise.reshape(-1, 1, *noise.shape[-2:])
    x = F.conv2d(x, k.reshape(1, 1, -1, 1), padding=(r, 0))
    x = F.conv2d(x, k.reshape(1, 1, 1, -1), padding=(0, r))
    field = resize_bilinear(x * alpha, (h, w))
    return field.reshape(*lead, h, w)


def photometric(photo: torch.Tensor, img255: torch.Tensor) -> torch.Tensor:
    """Contrast, brightness and channel gain on [..., 3, H, W] 0..255
    images; photo [..., 5]."""
    c = photo[..., 0, None, None, None]
    b = photo[..., 1, None, None, None]
    g = photo[..., 2:, None, None]
    return torch.clamp((img255 * c + b) * g, 0.0, 255.0)


def rot_scale_flow(p: int, ang: torch.Tensor, scale: torch.Tensor,
                   elastic: torch.Tensor | None = None) -> torch.Tensor:
    """Inverse-map flow [..., 2, p, p] of a rotation by `ang` and a scale
    about the patch centre, plus an elastic displacement: flow = source −
    target, the resample2d convention. ang, scale [...]."""
    c = (p - 1) / 2.0
    t = torch.arange(p, dtype=torch.float32, device=ang.device) - c
    yy, xx = t[:, None], t[None, :]
    cos = (torch.cos(ang) / scale)[..., None, None]
    sin = (torch.sin(ang) / scale)[..., None, None]
    sx = cos * xx + sin * yy - xx
    sy = -sin * xx + cos * yy - yy
    flow = torch.stack([sx, sy], -3)
    return flow if elastic is None else flow + elastic


def mask_center_size(mask: torch.Tensor):
    """[..., H, W] soft masks → (cy, cx, size, any) [...], size the longer
    side of the tight box (the frame's centre and 1 for an empty mask)."""
    h, w = mask.shape[-2:]
    on = mask > 0.5
    cols, rows = on.any(-2), on.any(-1)
    xi = torch.arange(w, dtype=torch.float32, device=mask.device)
    yi = torch.arange(h, dtype=torch.float32, device=mask.device)
    big = 1e9
    x1 = torch.where(cols, xi, big).amin(-1)
    x2 = torch.where(cols, xi, -big).amax(-1)
    y1 = torch.where(rows, yi, big).amin(-1)
    y2 = torch.where(rows, yi, -big).amax(-1)
    any_on = on.flatten(-2).any(-1)
    cy = torch.where(any_on, (y1 + y2) / 2, h / 2.0)
    cx = torch.where(any_on, (x1 + x2) / 2, w / 2.0)
    size = torch.where(any_on, torch.maximum(x2 - x1, y2 - y1) + 1.0, 1.0)
    return cy, cx, size, any_on


def lucid_frames(draws: LucidDraws, image255: torch.Tensor, masks: torch.Tensor, valid,
                 background255: torch.Tensor, patch: int = 256,
                 precision: str | None = None):
    """B lucid draws from `draws` (sample_lucid_draws), deterministic.

    image255, background255: [3, H, W] float32 0..255 (the first frame and
    its inpainted background); masks [K, H, W] binary first-frame masks;
    valid: K host booleans. Returns (canvas255 [B, 3, H, W], masks
    [B, K, H, W] float 0/1 after compositing).
    """
    _, h, w = image255.shape
    n, k = draws.elastic.shape
    dev = image255.device

    # Background: a full-frame affine (inverse map, translation undone).
    ang, sc, tx, ty = (draws.bg_affine[:, i, None, None] for i in range(4))
    yy = torch.arange(h, dtype=torch.float32, device=dev)[:, None] - (h - 1) / 2.0
    xx = torch.arange(w, dtype=torch.float32, device=dev)[None, :] - (w - 1) / 2.0
    cos, sin = torch.cos(ang) / sc, torch.sin(ang) / sc
    fx = cos * (xx - tx) + sin * (yy - ty) - xx
    fy = -sin * (xx - tx) + cos * (yy - ty) - yy
    canvas = resample2d_block(background255.expand(n, 3, h, w).contiguous(),
                              torch.stack([fx, fy], 1).contiguous(), (16, 16), 4, 160)
    canvas = photometric(draws.bg_photo, canvas)
    label = torch.zeros((n, h, w), dtype=torch.int64, device=dev)

    slots = [j for j in range(k) if bool(valid[j])]
    if slots:
        rgb, m, dst, on = object_patches(draws, image255, masks, slots, patch, precision)
        for i, slot in enumerate(slots):
            # Ascending: a later slot overwrites an earlier one.
            sel = paste_mask(m[:, i], dst[:, i], h, w, precision) * on[i] > 0.5
            rgb_full = paste_mask(rgb[:, i], dst[:, i, None], h, w, precision)
            canvas = torch.where(sel[:, None], rgb_full, canvas)
            label = torch.where(sel, slot + 1, label)
    ids = torch.arange(1, k + 1, device=dev)[None, :, None, None]
    return canvas, (label[:, None] == ids).to(torch.float32)


def object_patches(draws: LucidDraws, image255, masks, slots: list, patch: int,
                   precision: str | None = None):
    """The warped object patches of `slots` (host indices of the valid
    ones, ascending): a P×P patch around each object (native resolution
    when the object fits, scaled to fit above), cut once for the batch,
    warped by each draw's rotation, scale and elastic field (one block-warp
    launch for all) and jittered photometrically. Returns (rgb [B, Kv, 3,
    P, P], mask [B, Kv, P, P] in 0..1, destination boxes [B, Kv, 4] xyxy
    (a same-size box at the shifted centre), whether each object's mask is
    nonempty [Kv] float)."""
    _, h, w = image255.shape
    n, kv = draws.elastic.shape[0], len(slots)
    ms = masks[slots]
    cy, cx, size, any_on = mask_center_size(ms)
    src_half = torch.clamp(size * 0.75, min=patch / 2.0)
    box = torch.stack([(cy - src_half) / (h - 1), (cx - src_half) / (w - 1),
                       (cy + src_half - 1) / (h - 1), (cx + src_half - 1) / (w - 1)], -1)
    packed = torch.cat([image255.expand(kv, 3, h, w), ms[:, None] * 255.0], 1)
    pat = crop_and_resize(packed, box[:, None], patch, precision)[:, 0]  # [Kv, 4, P, P]

    aff = draws.affine[:, slots]  # [B, Kv, 4]
    elastic = smooth_field(draws.noise[:, slots], patch, patch)
    # Elastic units are native pixels: rescale into the patch's.
    gain = torch.where(draws.elastic[:, slots], patch / (2.0 * src_half), 0.0)
    flow = rot_scale_flow(patch, aff[..., 0], aff[..., 1], elastic * gain[..., None, None, None])
    warped = resample2d_block(pat.expand(n, kv, 4, patch, patch).reshape(n * kv, 4, patch, patch),
                              flow.reshape(n * kv, 2, patch, patch).contiguous(), (8, 8), 6, 64)
    warped = warped.reshape(n, kv, 4, patch, patch)
    rgb = photometric(draws.photo[:, slots], warped[:, :, :3])
    dx, dy = cx + aff[..., 2], cy + aff[..., 3]
    dst = torch.stack([dx - src_half, dy - src_half, dx + src_half - 1, dy + src_half - 1], -1)
    return rgb, warped[:, :, 3] / 255.0, dst, any_on.to(torch.float32)


def lucid_batch_device(gen: torch.Generator, image255, masks, valid, background255, n: int,
                       patch: int = 256, precision: str | None = None):
    """n independent draws from `gen`: (canvas [n, 3, H, W], masks
    [n, K, H, W])."""
    _, h, w = image255.shape
    draws = sample_lucid_draws(gen, n, masks.shape[0], h, w, patch)
    return lucid_frames(draws, image255, masks, valid, background255, patch, precision)


# ---------------------------------------------------------------------------
# coarse-mask perturbation (device twin of finetune.perturb_mask)
# ---------------------------------------------------------------------------

def _pool(m: torch.Tensor, k: int, op: str) -> torch.Tensor:
    """k×k max or min filter of [B, H, W], stride 1, the border ignored."""
    x = m[:, None] if op == "max" else -m[:, None]
    y = F.max_pool2d(x, k, stride=1, padding=k // 2)[:, 0]
    return y if op == "max" else -y


def perturb_mask_device(mask: torch.Tensor, branch: torch.Tensor, shift: torch.Tensor):
    """Per example of [B, H, W] masks: branch (0..4) identity, 3×3 or 5×5
    dilation, 3×3 or 5×5 erosion; then a cyclic shift by (dy, dx) =
    shift [B, 2] (jnp.roll along rows, then columns)."""
    b, h, w = mask.shape
    options = torch.stack([mask, _pool(mask, 3, "max"), _pool(mask, 5, "max"),
                           _pool(mask, 3, "min"), _pool(mask, 5, "min")])
    m = options[branch, torch.arange(b, device=mask.device)]
    ys = (torch.arange(h, device=mask.device)[None] - shift[:, :1]) % h  # [B, H]
    xs = (torch.arange(w, device=mask.device)[None] - shift[:, 1:]) % w
    return m[torch.arange(b, device=mask.device)[:, None, None], ys[:, :, None], xs[:, None, :]]


# ---------------------------------------------------------------------------
# the refine and proposal batches of the fused fine-tune
# ---------------------------------------------------------------------------

class RefineDraws(NamedTuple):
    """One refine batch's draws: the lucid draws, each slot's priority
    [B, K] in [0, 1) (the example's object is the valid one of highest),
    the box jitter [B, 2] (x, y) in -8..8, the perturbation branch [B] in
    0..4 and its shift [B, 2] in -4..4."""

    lucid: LucidDraws
    priority: torch.Tensor
    jitter: torch.Tensor
    branch: torch.Tensor
    shift: torch.Tensor


def sample_refine_draws(gen, n, k, h, w, patch, elastic_prob: float = 0.8) -> RefineDraws:
    dev = gen.device
    return RefineDraws(
        lucid=sample_lucid_draws(gen, n, k, h, w, patch, elastic_prob),
        priority=torch.rand((n, k), generator=gen, device=dev),
        jitter=torch.randint(-8, 9, (n, 2), generator=gen, device=dev),
        branch=torch.randint(0, 5, (n,), generator=gen, device=dev),
        shift=torch.randint(-4, 5, (n, 2), generator=gen, device=dev),
    )


def single_box(mask: torch.Tensor) -> torch.Tensor:
    """[..., H, W] masks → tight xyxy boxes [..., 4] (whole image if empty)."""
    h, w = mask.shape[-2:]
    on = mask > 0.5
    cols, rows = on.any(-2), on.any(-1)
    xi = torch.arange(w, dtype=torch.float32, device=mask.device)
    yi = torch.arange(h, dtype=torch.float32, device=mask.device)
    big = 1e9
    x1 = torch.clamp(torch.where(cols, xi, big).amin(-1), max=w - 2.0)
    x2 = torch.where(cols, xi, -1.0).amax(-1) + 1.0
    y1 = torch.clamp(torch.where(rows, yi, big).amin(-1), max=h - 2.0)
    y2 = torch.where(rows, yi, -1.0).amax(-1) + 1.0
    return torch.stack([x1, y1, torch.maximum(x2, x1 + 1), torch.maximum(y2, y1 + 1)], -1)


def _normalize(img255: torch.Tensor) -> torch.Tensor:
    """[B, 3, H, W] 0..255 → ImageNet-normalized."""
    mean = torch.tensor(IMAGENET_MEAN, dtype=torch.float32, device=img255.device)[:, None, None]
    std = torch.tensor(IMAGENET_STD, dtype=torch.float32, device=img255.device)[:, None, None]
    return (img255 / 255.0 - mean) / std


def refine_examples(draws: RefineDraws, consts, patch: int, crop_size: int,
                    box_margin: float, precision: str | None):
    """The refine batch (JAX fused.py `one_example`, batched): per example
    a lucid draw, its highest-priority object with more than 16 pixels,
    that object's box jittered and margin-expanded, the RGB crop with the
    object mask's crop as target, and the target perturbed as the coarse
    channel. consts = (image255, masks, valid, background255). Returns
    (x [B, 4, S, S], target [B, S, S], ok [B]: whether an object was
    there)."""
    image255, masks, valid, bg255 = consts
    _, h, w = image255.shape
    img, ms = lucid_frames(draws.lucid, image255, masks, valid, bg255, patch, precision)
    b = img.shape[0]
    rows = torch.arange(b, device=img.device)
    has = ms.sum((2, 3)) > 16.0
    j = torch.argmax(torch.where(has, draws.priority, -1.0), 1)
    m, ok = ms[rows, j], has[rows, j]
    jx, jy = draws.jitter[:, 0].to(torch.float32), draws.jitter[:, 1].to(torch.float32)
    box = single_box(m) + torch.stack([jx, jy, jx, jy], -1)
    box = expand_boxes(box, box_margin, h, w)
    norm = torch.stack([box[:, 1] / (h - 1), box[:, 0] / (w - 1),
                        box[:, 3] / (h - 1), box[:, 2] / (w - 1)], -1)
    packed = torch.cat([_normalize(img), m[:, None]], 1)
    crop = crop_and_resize(packed, norm[:, None], crop_size, precision)[:, 0]
    tgt = (crop[:, 3] > 0.5).to(torch.float32)
    coarse = perturb_mask_device(tgt, draws.branch, draws.shift)
    return torch.cat([crop[:, :3], coarse[:, None]], 1), tgt, ok


class ProposalDraws(NamedTuple):
    """One proposal batch's draws: the lucid draws and the per-image RPN
    sampling seeds [B] (int64 on the host: the loss reads them there)."""

    lucid: LucidDraws
    seeds: torch.Tensor


def sample_proposal_draws(gen, host_gen, n, k, h, w, patch,
                          elastic_prob: float = 0.8) -> ProposalDraws:
    return ProposalDraws(
        lucid=sample_lucid_draws(gen, n, k, h, w, patch, elastic_prob),
        seeds=torch.randint(0, 2**31 - 1, (n,), generator=host_gen),
    )


def proposal_batch(draws: ProposalDraws, consts, patch: int):
    """The proposal batch (JAX fused.py's proposal `batch_loss` before the
    loss): lucid draws cropped and pasted in float32, each slot's tight box
    and mask, a slot valid where its mask holds more than 4 pixels.
    Returns (images [B, H, W, 3] normalized, boxes [B, K, 4], masks
    [B, K, H, W], valid [B, K], seeds [B]): maskrcnn_loss_fn's batch."""
    image255, masks, valid, bg255 = consts
    img, ms = lucid_frames(draws.lucid, image255, masks, valid, bg255, patch)
    b, k, h, w = ms.shape
    boxes = boxes_from_masks(ms.reshape(b * k, h, w)).reshape(b, k, 4)
    return (_normalize(img).permute(0, 2, 3, 1), boxes, ms, ms.sum((2, 3)) > 4.0, draws.seeds)
