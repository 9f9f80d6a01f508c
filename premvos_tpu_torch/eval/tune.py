"""Merge-weight search on a tune split (port of `sample_weights` in
scripts/tune_merge.py and `tune_weights` / `ablation_weights` in
scripts/run_synthetic_benchmark.py).

Stages 1-4 are precomputed once per sequence (eval/harness.py); every
candidate weight vector replays only the merge. The search draws from a
seeded `np.random.Generator` in the JAX scripts' order, so the same
precompute gives the same trials and the same chosen vector.
"""

from __future__ import annotations

import numpy as np

from premvos_tpu_torch.eval.harness import DEFAULT_WEIGHTS, WEIGHT_NAMES, evaluate_weights


def sample_weights(rng: np.random.Generator) -> np.ndarray:
    """Log-uniform weights, a uniform score floor; warp_decay, reid_ema and
    reid_reacquire mix the reference value (1.0 / 0.0 / disabled, half the
    mass) with a search range. Returns a [9] float32 vector."""
    w = np.exp(rng.uniform(np.log(0.2), np.log(3.0), size=4))
    sigma = np.exp(rng.uniform(np.log(0.3), np.log(3.0)))
    floor = rng.uniform(0.0, 1.5)
    decay = 1.0 if rng.random() < 0.5 else rng.uniform(0.4, 1.0)
    ema = 0.0 if rng.random() < 0.5 else rng.uniform(0.0, 0.5)
    # ReID-gated floor relief (similarity in (0, 1]; 2.0 = disabled)
    reacq = 2.0 if rng.random() < 0.5 else rng.uniform(0.4, 0.98)
    return np.array([*w, sigma, floor, decay, ema, reacq], np.float32)


def ablation_weights(base: np.ndarray, overrides: dict) -> np.ndarray:
    """`base` with the named entries replaced."""
    w = np.asarray(base, np.float32).copy()
    for k, v in overrides.items():
        w[WEIGHT_NAMES.index(k)] = v
    return w


def _entry(w, t, kind):
    return {"w": [float(x) for x in w], "tune_JF": round(float(t), 4), "kind": kind}


def tune_weights(pre_tune, args, rng=None, groups=None):
    """Random search, local refinement and term dropout on the tune split.

    args: `seed`, `tune_objective` ("min" or "mean"), `warp_stride`,
    `tune_trials`, `tune_local` (the benchmark's flags). With `groups` (one
    precompute list per generator seed) and objective "min", a trial scores
    the smallest per-seed J&F, the proxy for a gate every held-out draw
    must pass. Returns (best weights, best tune J&F, trial log).
    """
    rng = rng or np.random.default_rng(args.seed)

    if groups and len(groups) > 1 and args.tune_objective == "min":
        def score(w):
            return min(float(evaluate_weights(g, w, args.warp_stride)[0]) for g in groups)
    else:
        def score(w):
            return float(evaluate_weights(pre_tune, w, args.warp_stride)[0])

    best_w = np.asarray(DEFAULT_WEIGHTS, np.float32)
    best_t = score(best_w)
    log = [_entry(best_w, best_t, "baseline")]
    print(f"[tune] baseline (reference defaults) J&F = {best_t:.4f}", flush=True)
    # Structured seeds around the anti-identity-swap score floor, so the
    # search visits that region even at small trial budgets.
    seeds = [
        [1, 1, 1, 1, 1.0, f, d, 0.0, r]
        for f in (0.5, 1.0, 1.5)
        for d in (1.0, 0.6)
        for r in (2.0, 0.7)  # floor relief off / ReID-confident band
    ]
    for w in seeds:
        w = np.asarray(w, np.float32)
        t = score(w)
        log.append(_entry(w, t, "seed"))
        if t > best_t:
            best_t, best_w = t, w
            print(f"[tune] seed floor={w[5]} decay={w[6]} J&F={t:.4f}", flush=True)
    for i in range(args.tune_trials):
        w = sample_weights(rng)
        t = score(w)
        log.append(_entry(w, t, "random"))
        if t > best_t:
            best_t, best_w = t, w
            print(f"[tune] {i + 1}/{args.tune_trials} J&F={t:.4f} "
                  f"w={np.round(w, 3).tolist()}", flush=True)
    for i in range(args.tune_local):
        w = (best_w * np.exp(rng.normal(0, 0.22, size=9))).astype(np.float32)
        w[5] = max(0.0, float(best_w[5] + rng.normal(0, 0.2)))
        w[6] = float(np.clip(best_w[6] * np.exp(rng.normal(0, 0.1)), 0.3, 1.0))
        w[7] = float(np.clip(best_w[7] + rng.normal(0, 0.08), 0.0, 0.7))
        # jitter the relief when it is on; when it is off (≥ 1), half the
        # trials try turning it on
        if best_w[8] < 1.0:
            w[8] = float(np.clip(best_w[8] + rng.normal(0, 0.08), 0.3, 0.99))
        else:
            w[8] = 2.0 if rng.random() < 0.5 else float(rng.uniform(0.5, 0.95))
        t = score(w)
        log.append(_entry(w, t, "local"))
        if t > best_t:
            best_t, best_w = t, w
            print(f"[tune] local {i + 1}/{args.tune_local} J&F={t:.4f}", flush=True)
    # Term dropout: every subset of {objectness, reid, overlap} zeroed (and
    # the relief off) around the incumbent, then one more local pass around
    # a new winner (zeros stay zero under the multiplicative jitter).
    drop_sets = [[0], [1], [3], [0, 1], [0, 3], [1, 3], [0, 1, 3]]
    pre_drop_w = best_w.copy()
    for idxs in drop_sets:
        for reacq_off in (False, True):
            w = pre_drop_w.copy()
            for j in idxs:
                w[j] = 0.0
            if reacq_off:
                w[8] = 2.0
            t = score(w)
            log.append(_entry(w, t, "drop"))
            if t > best_t:
                best_t, best_w = t, w
                print(f"[tune] drop {idxs} reacq_off={reacq_off} J&F={t:.4f}", flush=True)
    if not np.array_equal(best_w, pre_drop_w):
        for i in range(max(args.tune_local // 2, 1)):
            w = (best_w * np.exp(rng.normal(0, 0.15, size=9))).astype(np.float32)
            w[5] = max(0.0, float(best_w[5] + rng.normal(0, 0.15)))
            w[6] = float(np.clip(best_w[6] * np.exp(rng.normal(0, 0.08)), 0.3, 1.0))
            w[7] = float(np.clip(best_w[7] + rng.normal(0, 0.05), 0.0, 0.7))
            if best_w[8] < 1.0:
                w[8] = float(np.clip(best_w[8] + rng.normal(0, 0.05), 0.3, 0.99))
            t = score(w)
            log.append(_entry(w, t, "drop-local"))
            if t > best_t:
                best_t, best_w = t, w
                print(f"[tune] drop-local {i + 1} J&F={t:.4f}", flush=True)
    return best_w, float(best_t), log
