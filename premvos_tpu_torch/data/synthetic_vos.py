"""Procedural synthetic VOS benchmark (port of
premvos_tpu/data/synthetic_vos.py): DAVIS-layout sequences with object
crossing and occlusion, full disappearance and re-appearance, look-alike
distractors and scale change, in disjoint train / tune / val splits, plus
FlyingChairs-layout flow pairs with ground-truth backward flow.

Every draw comes from the same `np.random.default_rng` streams in the same
order as the JAX package's generator, so a seed gives the same world: the
same entities, paths, labels, flows and rendered frames, and the same
files: frames are JPEG at quality 96 (`JPEGImages/480p/<seq>/00000.jpg`),
written by io_compat/jpeg.py with Pillow's bytes; PPM and `.flo` files go
through io_compat/ppm.py and io_compat/flo.py. One thing differs, because
the card's machine has no OpenCV: the smooth background's INTER_CUBIC
resize is `cv_compat.resize_cubic` (OpenCV's own arithmetic; OpenCV's
wheels run Intel IPP's, a few float32 ulp apart, which can move a rendered
value by one level), and the flow pairs' INTER_LINEAR resizes are
`cv_compat.resize_linear_u8` and `preprocess.resize_linear`. With IPP off
the JAX generator writes the same tree byte for byte.

World model (per sequence, every parameter drawn per sequence): a static
low-frequency background; `n_tracked` annotated entities (square, disk or
triangle, a saturated color, an entity-local texture, sinusoidal scale
change), of which tracked 0 and 1 cross near mid-sequence and tracked 1
leaves the canvas for a few frames and comes back; `n_distractors`
look-alikes of tracked entities. The train split annotates every entity;
tune and val annotate the tracked ones only.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np

from premvos_tpu_torch.data.cv_compat import resize_cubic, resize_linear_u8
from premvos_tpu_torch.data.palette import save_indexed_png
from premvos_tpu_torch.data.preprocess import resize_linear
from premvos_tpu_torch.io_compat.flo import write_flo
from premvos_tpu_torch.io_compat.jpeg import write_jpeg
from premvos_tpu_torch.io_compat.ppm import write_ppm

SHAPES = ("square", "disk", "triangle")


@dataclasses.dataclass
class EntitySpec:
    shape: str
    color: np.ndarray  # [3] float in [0, 255]
    s0: float  # base half-size in pixels
    scale_amp: float
    scale_period: float
    scale_phase: float
    tex: tuple  # (fy, fx, amp, phase) entity-local texture params
    depth: int  # higher draws on top
    positions: np.ndarray  # [T, 2] float (cy, cx) — may leave the canvas
    tracked: bool


def _size_at(e: EntitySpec, fi: int) -> float:
    return e.s0 * (
        1.0
        + e.scale_amp
        * np.sin(2 * np.pi * fi / e.scale_period + e.scale_phase)
    )


def _shape_mask(shape: str, cy, cx, s, h, w) -> np.ndarray:
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    dy, dx = yy - cy, xx - cx
    if shape == "square":
        return (np.abs(dy) <= s) & (np.abs(dx) <= s)
    if shape == "disk":
        return dy * dy + dx * dx <= s * s
    # upward triangle: apex at cy − s, base at cy + s
    return (dy >= -s) & (dy <= s) & (np.abs(dx) <= (dy + s) * 0.6)


def _entity_texture(e: EntitySpec, cy, cx, s, h, w) -> np.ndarray:
    """Multiplicative brightness pattern in ENTITY-LOCAL coordinates
    (normalized by current size, so it rides along and rescales with the
    entity — a stable appearance signature for ReID)."""
    fy, fx, amp, phase = e.tex
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    u, v = (yy - cy) / max(s, 1e-3), (xx - cx) / max(s, 1e-3)
    return 1.0 + amp * np.sin(fy * u + fx * v + phase)


def _smooth_background(rng: np.random.Generator, h: int, w: int) -> np.ndarray:
    base = rng.uniform(40, 200, size=3)
    grid = rng.uniform(-45, 45, (6, 9, 3)).astype(np.float32)
    tex = resize_cubic(grid, (h, w))
    return np.clip(base[None, None] + tex, 0, 255).astype(np.float32)


def _simulate_path(
    rng, t, hw, start, vel, margin=6.0,
    exit_at: int | None = None, return_at: int | None = None,
) -> np.ndarray:
    """Bouncing linear motion; optional scripted full exit + re-entry."""
    h, w = hw
    pos = np.empty((t, 2), np.float32)
    p = np.array(start, np.float32)
    v = np.array(vel, np.float32)
    mode = "roam"
    off = 30.0  # how far outside the canvas the exited entity parks
    for fi in range(t):
        pos[fi] = p
        if exit_at is not None and fi == exit_at:
            # head straight out the nearest edge, fast enough to be FULLY
            # off-canvas (incl. entity size) within ~2 frames
            edges = np.array(
                [p[0], h - p[0], p[1], w - p[1]], np.float32
            )  # top, bottom, left, right
            e = int(np.argmin(edges))
            sp = float(edges[e]) / 2.0 + 14.0
            v = {
                0: np.array([-sp, 0.0]),
                1: np.array([sp, 0.0]),
                2: np.array([0.0, -sp]),
                3: np.array([0.0, sp]),
            }[e].astype(np.float32)
            mode = "exiting"
        if return_at is not None and fi == return_at:
            target = np.array(
                [rng.uniform(12, h - 12), rng.uniform(12, w - 12)], np.float32
            )
            v = (target - p) / 2.5
            n = float(np.linalg.norm(v))
            if n > 14.0:
                v *= 14.0 / n
            mode = "returning"
        p = p + v
        if mode == "exiting" and (
            p[0] < -off or p[0] > h + off or p[1] < -off or p[1] > w + off
        ):
            v = np.zeros(2, np.float32)  # park outside
        if mode in ("roam", "returning"):
            inside = margin <= p[0] <= h - margin and margin <= p[1] <= w - margin
            if mode == "returning" and inside:
                mode = "roam"
                v = v * (2.0 / max(float(np.linalg.norm(v)), 1e-3))
            if mode == "roam":
                if not margin <= p[0] <= h - margin:
                    v[0] = -v[0]
                    p[0] = np.clip(p[0], margin, h - margin)
                if not margin <= p[1] <= w - margin:
                    v[1] = -v[1]
                    p[1] = np.clip(p[1], margin, w - margin)
    return pos


def _rand_color(rng) -> np.ndarray:
    import colorsys

    hue = rng.uniform(0, 1)
    sat = rng.uniform(0.6, 1.0)
    val = rng.uniform(0.65, 1.0)
    return np.array(colorsys.hsv_to_rgb(hue, sat, val), np.float32) * 255.0


def _rand_tex(rng) -> tuple:
    return (
        float(rng.uniform(1.0, 4.0)),
        float(rng.uniform(1.0, 4.0)),
        float(rng.uniform(0.12, 0.3)),
        float(rng.uniform(0, 2 * np.pi)),
    )


def build_sequence_spec(
    rng: np.random.Generator,
    t: int = 24,
    hw: tuple = (64, 96),
    n_tracked: int = 2,
    n_distractors: int = 1,
    size_scale: float = 1.0,
) -> list[EntitySpec]:
    """Sample one sequence's entities (tracked first, then distractors).

    size_scale k > 1 renders the SAME procedural world at k× resolution:
    entities are sampled in the (hw/k) world and every position/size is
    scaled by k, so difficulty (crossing geometry, occlusion timing,
    relative speeds) is resolution-invariant while masks/boundaries gain
    pixels — mirroring how DAVIS objects occupy a large pixel footprint at
    480p."""
    if size_scale != 1.0:
        h, w = hw
        world = (h / size_scale, w / size_scale)
        ents = build_sequence_spec(rng, t, world, n_tracked, n_distractors)
        return [
            dataclasses.replace(
                e,
                positions=e.positions * float(size_scale),
                s0=e.s0 * float(size_scale),
            )
            for e in ents
        ]
    if t < 20:
        raise ValueError(
            f"sequence length t={t} too short for the event timeline "
            "(crossing ~t/3, exit, parked frames, re-entry, settled tail) — "
            "use t >= 20"
        )
    h, w = hw
    entities: list[EntitySpec] = []

    # --- crossing construction: tracked 0 and 1 pass through a common point
    # near mid-sequence, from roughly opposite directions.
    tc = int(rng.integers(6, min(11, t - 12)))  # exit window needs tc ≤ t−13
    c = np.array(
        [rng.uniform(0.35 * h, 0.65 * h), rng.uniform(0.35 * w, 0.65 * w)],
        np.float32,
    )
    th0 = rng.uniform(0, 2 * np.pi)
    speeds = rng.uniform(2.0, 3.2, size=2)
    starts, vels = [], []
    for i, (th, dt_off) in enumerate(
        [(th0, 0.0), (th0 + np.pi + rng.uniform(-0.5, 0.5), rng.uniform(-1, 1))]
    ):
        v = speeds[i] * np.array([np.sin(th), np.cos(th)], np.float32)
        start = c - v * (tc + dt_off)
        # keep the pre-crossing path inside the canvas: damp speed if the
        # start would fall outside
        for _ in range(8):
            if 8 <= start[0] <= h - 8 and 8 <= start[1] <= w - 8:
                break
            v *= 0.8
            start = c - v * (tc + dt_off)
        starts.append(start)
        vels.append(v)

    # --- disappearance: tracked entity 1 exits shortly after the crossing
    # and re-appears a few frames later (must be back, visible, and settled
    # well before the sequence ends so re-acquisition is scored).
    exit_at = int(rng.integers(tc + 2, min(tc + 5, t - 10)))
    return_at = exit_at + int(rng.integers(3, 5))

    for i in range(n_tracked):
        if i < 2:
            pos = _simulate_path(
                rng, t, hw, starts[i], vels[i],
                exit_at=exit_at if i == 1 else None,
                return_at=return_at if i == 1 else None,
            )
        else:
            th = rng.uniform(0, 2 * np.pi)
            sp = rng.uniform(1.2, 2.8)
            pos = _simulate_path(
                rng, t, hw,
                (rng.uniform(12, h - 12), rng.uniform(12, w - 12)),
                sp * np.array([np.sin(th), np.cos(th)]),
            )
        entities.append(
            EntitySpec(
                shape=SHAPES[int(rng.integers(len(SHAPES)))],
                color=_rand_color(rng),
                s0=float(rng.uniform(5.0, 8.0)),
                scale_amp=float(rng.uniform(0.08, 0.3)),
                scale_period=float(rng.uniform(10, 22)),
                scale_phase=float(rng.uniform(0, 2 * np.pi)),
                tex=_rand_tex(rng),
                depth=0,  # filled below
                positions=pos,
                tracked=True,
            )
        )

    # --- look-alike distractors: clone a tracked entity's appearance with
    # small jitter; start well away from their look-alike twin.
    for d in range(n_distractors):
        twin = entities[d % n_tracked]
        th = rng.uniform(0, 2 * np.pi)
        sp = rng.uniform(1.2, 2.6)
        p0 = twin.positions[0]
        for _ in range(32):
            start = np.array(
                [rng.uniform(10, h - 10), rng.uniform(10, w - 10)], np.float32
            )
            if np.linalg.norm(start - p0) >= 28:
                break
        pos = _simulate_path(
            rng, t, hw, start, sp * np.array([np.sin(th), np.cos(th)])
        )
        entities.append(
            EntitySpec(
                shape=twin.shape,
                color=np.clip(
                    twin.color + rng.uniform(-12, 12, size=3), 0, 255
                ).astype(np.float32),
                s0=float(np.clip(twin.s0 + rng.uniform(-1, 1), 4.5, 9.0)),
                scale_amp=twin.scale_amp,
                scale_period=twin.scale_period,
                scale_phase=float(rng.uniform(0, 2 * np.pi)),
                tex=twin.tex,
                depth=0,
                positions=pos,
                tracked=False,
            )
        )

    # ensure tracked entities start separated from each other (annotation
    # frame must show each object clearly)
    for perm_try in range(64):
        d01 = np.linalg.norm(entities[0].positions[0] - entities[1].positions[0])
        if d01 >= 26:
            break
        # re-aim entity 1's start by re-sampling its crossing offset
        th = th0 + np.pi + rng.uniform(-0.5, 0.5)
        v = speeds[1] * np.array([np.sin(th), np.cos(th)], np.float32)
        start = c - v * tc
        entities[1] = dataclasses.replace(
            entities[1],
            positions=_simulate_path(
                rng, t, hw, start, v, exit_at=exit_at, return_at=return_at
            ),
        )

    order = rng.permutation(len(entities))
    for i, e in enumerate(entities):
        e.depth = int(order[i])
    return entities


def render_frame(
    entities: list[EntitySpec],
    fi: int,
    hw: tuple,
    bg: np.ndarray,
    label_ids: dict,
) -> tuple[np.ndarray, np.ndarray]:
    """Render frame `fi` → (img [H, W, 3] uint8, lab [H, W] uint8).

    label_ids: {entity_index: annotation id}; entities not in the dict are
    drawn but labeled 0 (distractors in tune/val splits). Draw order is by
    depth, so an unannotated entity on top of an annotated one correctly
    erases the covered pixels from the label map (occlusion semantics).
    """
    h, w = hw
    img = bg.copy()
    lab = np.zeros((h, w), np.uint8)
    for idx in sorted(range(len(entities)), key=lambda i: entities[i].depth):
        e = entities[idx]
        cy, cx = e.positions[fi]
        s = _size_at(e, fi)
        if cy < -2 * s or cy > h + 2 * s or cx < -2 * s or cx > w + 2 * s:
            continue
        m = _shape_mask(e.shape, cy, cx, s, h, w)
        if not m.any():
            continue
        tex = _entity_texture(e, cy, cx, s, h, w)
        img[m] = np.clip(e.color[None, :] * tex[m, None], 0, 255)
        lab[m] = label_ids.get(idx, 0)
    return img.astype(np.uint8), lab


def backward_flow(
    entities: list[EntitySpec], fi: int, hw: tuple
) -> np.ndarray:
    """GROUND-TRUTH backward flow for frame fi → fi−1 ([H, W, 2], (u, v) =
    x/y displacement — Middlebury convention, matching ops.resample2d).

    Each pixel takes the motion of its TOPMOST entity at frame fi;
    background pixels are 0 (static camera). Scale change makes per-pixel
    flow not exactly uniform per entity; the center displacement is the
    training approximation."""
    h, w = hw
    flow = np.zeros((h, w, 2), np.float32)
    for idx in sorted(range(len(entities)), key=lambda i: entities[i].depth):
        e = entities[idx]
        cy, cx = e.positions[fi]
        s = _size_at(e, fi)
        m = _shape_mask(e.shape, cy, cx, s, h, w)
        if not m.any():
            continue
        d = e.positions[fi - 1] - e.positions[fi]  # (dy, dx) to PREVIOUS
        flow[m, 0] = d[1]
        flow[m, 1] = d[0]
    return flow


def _ensure_contrast(
    entities: list[EntitySpec],
    bg: np.ndarray,
    rng: np.random.Generator,
    min_dist: float = 110.0,
    tries: int = 48,
) -> list[EntitySpec]:
    """Resample tracked-entity colors until each clears a contrast floor
    against the background everywhere along its path.

    DAVIS objects are human-annotatable by construction — a tracked object
    whose color coincides with the local background measures detector noise,
    not tracking (round-3 finding: a camouflaged val object was undetectable
    at any training length and capped the oracle ceiling). Distractors then
    re-inherit their twin's jittered color so they stay look-alikes.
    """
    h, w = bg.shape[:2]

    def path_dist(e: EntitySpec, color: np.ndarray) -> float:
        ys = np.clip(e.positions[:, 0].astype(int), 0, h - 1)
        xs = np.clip(e.positions[:, 1].astype(int), 0, w - 1)
        on = (
            (e.positions[:, 0] >= -2) & (e.positions[:, 0] <= h + 2)
            & (e.positions[:, 1] >= -2) & (e.positions[:, 1] <= w + 2)
        )
        if not on.any():
            return np.inf
        bgc = bg[ys[on], xs[on]]  # [F, 3]
        # texture modulates the entity color by (1 ± amp); require the floor
        # at the darker end too so shading can't re-camouflage it
        lo = float(1.0 - e.tex[2])
        d_mid = np.linalg.norm(bgc - color[None], axis=-1).min()
        d_lo = np.linalg.norm(bgc - lo * color[None], axis=-1).min()
        return float(min(d_mid, d_lo))

    out = list(entities)
    n_tracked = sum(1 for e in entities if e.tracked)
    for i, e in enumerate(out):
        if not e.tracked:
            continue
        color, best_d = e.color, path_dist(e, e.color)
        for _ in range(tries):
            if best_d >= min_dist:
                break
            cand = _rand_color(rng)
            d = path_dist(e, cand)
            if d > best_d:
                color, best_d = cand, d
        out[i] = dataclasses.replace(e, color=color)
    # distractor d (index n_tracked + d) twins entities[d % n_tracked]
    # (build_sequence_spec's mapping) — refresh its look-alike color
    for j, e in enumerate(out):
        if e.tracked:
            continue
        twin = out[(j - n_tracked) % max(n_tracked, 1)]
        out[j] = dataclasses.replace(
            e,
            color=np.clip(
                twin.color + rng.uniform(-12, 12, size=3), 0, 255
            ).astype(np.float32),
        )
    return out


def make_synthetic_vos(
    root,
    n_train: int = 6,
    n_tune: int = 2,
    n_val: int = 4,
    t: int = 24,
    hw: tuple = (64, 96),
    n_tracked: int = 2,
    n_distractors: int = 1,
    seed: int = 0,
    flow_pairs: bool = True,
    pairs_hw: tuple | None = None,
    size_scale: float = 1.0,
    min_contrast: float = 110.0,
) -> Path:
    """Write the benchmark as a DAVIS-layout tree.

    Splits are disjoint samples of the same procedural distribution:
      ImageSets/2017/{train,tune,val}.txt. Train sequences annotate all
    entities; tune/val annotate only the tracked subset. Frames are JPEG
    at quality 96. If
    `flow_pairs`, also writes `root/flow_pairs/` (FlyingChairs layout, GT
    backward flow) from the train sequences, at `pairs_hw` when given.

    Returns the root path. Generation is deterministic in `seed`.
    """
    root = Path(root)
    (root / "ImageSets" / "2017").mkdir(parents=True, exist_ok=True)
    splits = {
        "train": [f"train_{i:02d}" for i in range(n_train)],
        "tune": [f"tune_{i:02d}" for i in range(n_tune)],
        "val": [f"val_{i:02d}" for i in range(n_val)],
    }
    for split, seqs in splits.items():
        (root / "ImageSets" / "2017" / f"{split}.txt").write_text(
            "\n".join(seqs)
        )

    pairs_dir = root / "flow_pairs"
    if flow_pairs:
        pairs_dir.mkdir(exist_ok=True)
    pair_i = 0

    master = np.random.default_rng(seed)
    for split, seqs in splits.items():
        for seq in seqs:
            rng = np.random.default_rng(master.integers(0, 2**63))
            entities = build_sequence_spec(
                rng, t=t, hw=hw, n_tracked=n_tracked,
                n_distractors=n_distractors, size_scale=size_scale,
            )
            bg = _smooth_background(rng, *hw)
            if min_contrast > 0:
                entities = _ensure_contrast(
                    entities, bg, rng, min_dist=min_contrast
                )
            if split == "train":
                label_ids = {i: i + 1 for i in range(len(entities))}
            else:
                label_ids = {
                    i: i + 1 for i, e in enumerate(entities) if e.tracked
                }
            jd = root / "JPEGImages" / "480p" / seq
            ad = root / "Annotations" / "480p" / seq
            jd.mkdir(parents=True, exist_ok=True)
            ad.mkdir(parents=True, exist_ok=True)
            prev_img = None
            for fi in range(t):
                img, lab = render_frame(entities, fi, hw, bg, label_ids)
                write_jpeg(jd / f"{fi:05d}.jpg", img, 96)
                save_indexed_png(ad / f"{fi:05d}.png", lab)
                if flow_pairs and split == "train" and fi > 0:
                    write_flow_pair(pairs_dir, pair_i, img, prev_img,
                                    backward_flow(entities, fi, hw), hw, pairs_hw)
                    pair_i += 1
                prev_img = img
    return root


def write_flow_pair(pairs_dir, i: int, cur, prev, flow, hw, pairs_hw=None) -> None:
    """Write pair `i`: img1 = the current frame, img2 = the previous one
    (backward flow, matching the pipeline's (cur, prev) call order), and
    the flow. With `pairs_hw` off the canvas, all three at the flow net's
    inference grid (INTER_LINEAR, the flow scaled with the grid), as the
    pipeline resizes canvas → inference size."""
    if pairs_hw is not None and tuple(pairs_hw) != tuple(hw):
        ph, pw = pairs_hw
        cur = resize_linear_u8(cur, (ph, pw))
        prev = resize_linear_u8(prev, (ph, pw))
        flow = resize_linear(flow, (ph, pw)) * np.array(
            [pw / hw[1], ph / hw[0]], np.float32
        )
    write_ppm(Path(pairs_dir) / f"{i:05d}_img1.ppm", cur)
    write_ppm(Path(pairs_dir) / f"{i:05d}_img2.ppm", prev)
    write_flo(Path(pairs_dir) / f"{i:05d}_flow.flo", flow)
