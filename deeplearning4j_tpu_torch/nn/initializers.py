"""Weight-initialization schemes (counterpart of
``deeplearning4j_tpu/nn/initializers.py``), drawn from an explicit
``torch.Generator``. The formulas are the JAX package's; the numbers are
not, since the two generators differ: carry weights across with
:mod:`deeplearning4j_tpu_torch.interop.jax_params` to compare the packages.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch


def _normal(gen, shape, std, dtype):
    return std * torch.randn(shape, generator=gen, dtype=dtype)


def _uniform(gen, shape, lo, hi, dtype):
    return lo + (hi - lo) * torch.rand(shape, generator=gen, dtype=dtype)


def init_weights(gen: torch.Generator, shape: Sequence[int], fan_in: float,
                 fan_out: float, scheme: str = "xavier",
                 distribution: Optional[dict] = None,
                 dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """A weight tensor on the generator's device per the named scheme."""
    scheme = scheme.lower()
    fan_in, fan_out = max(fan_in, 1.0), max(fan_out, 1.0)
    shape = tuple(int(s) for s in shape)
    if scheme == "zero":
        return torch.zeros(shape, dtype=dtype)
    if scheme == "ones":
        return torch.ones(shape, dtype=dtype)
    if scheme == "xavier":
        return _normal(gen, shape, math.sqrt(2.0 / (fan_in + fan_out)), dtype)
    if scheme == "xavier_uniform":
        s = math.sqrt(6.0 / (fan_in + fan_out))
        return _uniform(gen, shape, -s, s, dtype)
    if scheme in ("xavier_fan_in", "lecun_normal", "normal"):
        return _normal(gen, shape, math.sqrt(1.0 / fan_in), dtype)
    if scheme == "xavier_legacy":
        return _normal(gen, shape, math.sqrt(1.0 / (fan_in + fan_out)), dtype)
    if scheme == "relu":
        return _normal(gen, shape, math.sqrt(2.0 / fan_in), dtype)
    if scheme == "relu_uniform":
        s = math.sqrt(6.0 / fan_in)
        return _uniform(gen, shape, -s, s, dtype)
    if scheme == "lecun_uniform":
        s = math.sqrt(3.0 / fan_in)
        return _uniform(gen, shape, -s, s, dtype)
    if scheme == "sigmoid_uniform":
        s = 4.0 * math.sqrt(6.0 / (fan_in + fan_out))
        return _uniform(gen, shape, -s, s, dtype)
    if scheme == "uniform":
        s = 1.0 / math.sqrt(fan_in)
        return _uniform(gen, shape, -s, s, dtype)
    if scheme == "distribution":
        return _from_distribution(gen, shape, distribution or {}, dtype)
    raise ValueError(f"Unknown weight init scheme '{scheme}'")


def _from_distribution(gen, shape, dist: dict, dtype):
    kind = dist.get("type", "normal").lower()
    if kind in ("normal", "gaussian"):
        return float(dist.get("mean", 0.0)) + _normal(
            gen, shape, float(dist.get("std", 1.0)), dtype)
    if kind == "uniform":
        return _uniform(gen, shape, float(dist.get("lower", -1.0)),
                        float(dist.get("upper", 1.0)), dtype)
    if kind == "binomial":  # successes of n trials at p, as floats
        n, p = float(dist.get("n", 1)), float(dist.get("p", 0.5))
        return torch.binomial(torch.full(shape, n), torch.full(shape, p),
                              generator=gen).to(dtype)
    if kind == "constant":
        return torch.full(shape, float(dist.get("value", 0.0)), dtype=dtype)
    raise ValueError(f"Unknown distribution '{kind}'")
