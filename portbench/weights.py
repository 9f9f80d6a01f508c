"""Seeded random weights of the four nets, drawn on the device.

The benchmark makes the weights and hands the same state dicts to the
program and to the reference. Shapes come from the reference's nets (built
on the meta device), whose names and layouts are the program's. Kernels
take flax's default initialiser, a normal truncated to ±2σ with variance
1/fan-in; layer biases are drawn N(0, 0.01²) and frozen batch-norm scale
and variance from [0.95, 1.05), bias and mean from [−0.05, 0.05): at 1 and
0 the random nets of davis2017_val label nothing after frame 0, and the
merge would track nothing. Each net takes three draws of a generator on
the device seeded from (seed, net): one for all kernels, one for all
biases, one for all batch-norm statistics.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from portbench.reference import nets
from portbench.reference.pipeline import Models, build_models

_TRUNC_STD = 0.87962566103423978  # std of a unit normal truncated to ±2
_PHI_LO = 0.5 * (1.0 + math.erf(-2.0 / math.sqrt(2.0)))  # Φ(−2)


def sub_seed(seed: int, *keys: int) -> int:
    """A 63-bit seed for (seed, keys), any whole seed."""
    return int(np.random.SeedSequence([int(seed) % 2 ** 64, *keys]).generate_state(
        2, np.uint32).astype(np.uint64).dot(np.array([1, 2 ** 32], np.uint64)) >> np.uint64(1))


def _fan_in(module, w):
    if isinstance(module, nets.ConvTranspose):
        return w.shape[0] * w.shape[2] * w.shape[3]
    return math.prod(w.shape[1:])


def net_state(net: torch.nn.Module, gen: torch.Generator, device) -> dict:
    """{name: tensor} for every parameter and buffer of `net` (a meta-device
    reference net), drawn from `gen` on `device`."""
    kernels, biases, norms = [], [], []
    for mname, m in net.named_modules():
        rule = nets.PARAM_RULES.get(type(m))
        if rule is None:
            continue
        prefix = f"{mname}." if mname else ""
        if rule == "frozen_bn":
            norms += [(prefix + k, getattr(m, k).shape, k) for k in ("scale", "bias", "mean", "var")]
            continue
        kernels.append((prefix + "weight", m.weight.shape, _fan_in(m, m.weight)))
        if m.bias is not None:
            biases.append((prefix + "bias", m.bias.shape))
    state = {}
    total = sum(math.prod(s) for _, s, _ in kernels)
    u = torch.empty(total, device=device).uniform_(_PHI_LO, 1.0 - _PHI_LO, generator=gen)
    z = torch.erfinv(2.0 * u - 1.0) * math.sqrt(2.0)
    o = 0
    for name, shape, fan_in in kernels:
        n = math.prod(shape)
        state[name] = (z[o:o + n] * (math.sqrt(1.0 / fan_in) / _TRUNC_STD)).view(shape).clone()
        o += n
    del u, z
    total = sum(math.prod(s) for _, s in biases)
    b = torch.randn(total, device=device, generator=gen) * 0.01
    o = 0
    for name, shape in biases:
        n = math.prod(shape)
        state[name] = b[o:o + n].view(shape).clone()
        o += n
    total = sum(math.prod(s) for _, s, _ in norms)
    r = 0.1 * (torch.rand(total, device=device, generator=gen) - 0.5)
    o = 0
    for name, shape, kind in norms:
        n = math.prod(shape)
        state[name] = r[o:o + n].view(shape) + (1.0 if kind in ("scale", "var") else 0.0)
        o += n
    return state


def make_weights(cfg, seed: int, device) -> dict:
    """{net: state dict} of the four nets at `cfg`, from `seed`, on `device`.

    The refinement net's classifier kernel is centred over its inputs (each
    output's weights sum to zero, the spread as drawn): on the decoder's
    non-negative features an uncentred random kernel gives every pixel of
    every crop one sign, so on about half the seeds the masks are empty and
    the merge tracks nothing; centred, each crop's mask is a blob."""
    shapes = build_models(cfg, device="meta")
    out = {}
    for i, name in enumerate(Models._fields):
        gen = torch.Generator(device=device).manual_seed(sub_seed(seed, 1, i))
        out[name] = net_state(getattr(shapes, name), gen, device)
    w = out["refine"]["cls.weight"]
    out["refine"]["cls.weight"] = w - w.mean(dim=(1, 2, 3), keepdim=True)
    return out


def load(models, weights: dict) -> None:
    """Copy `weights` into `models` (the program's or the reference's), every
    parameter and buffer named, no other."""
    for name in Models._fields:
        getattr(models, name).load_state_dict(weights[name], strict=True)
