"""Activation-function catalog of the port (counterpart of
``deeplearning4j_tpu/nn/activations.py``), by the same names.

Every name of the JAX catalog, each with its formula there: gelu is the
tanh approximation (``jax.nn.gelu``'s default, not ``F.gelu``'s), leakyrelu
a slope of 0.01 and rrelu a fixed slope of 0.125, hardtanh and
rationaltanh the JAX package's own; relu6 takes the gradient 0 at its
corners, as ``jax.nn.relu6`` does.
"""

from __future__ import annotations

from typing import Callable, Dict

import math

import torch

Activation = Callable[[torch.Tensor], torch.Tensor]

_REGISTRY: Dict[str, Activation] = {}


def register_activation(name: str, fn: Activation) -> None:
    """Register a custom activation; it then no longer counts as builtin."""
    _REGISTRY[name.lower()] = fn


def get_activation(name: str) -> Activation:
    try:
        return _REGISTRY[name.lower()]
    except KeyError:
        raise ValueError(
            f"Unknown activation '{name}'. Known: {sorted(_REGISTRY)}"
        ) from None


def _identity(x):
    return x


def _hard_sigmoid(x):
    return torch.clamp(0.2 * x + 0.5, 0.0, 1.0)


def _softmax(x):
    return torch.softmax(x, dim=-1)


def _rational_tanh(x):
    # the reference's ActivationRationalTanh: 1.7159 * tanh(2x/3),
    # approximated by a rational function
    a = torch.abs(2.0 * x / 3.0)
    approx = 1.0 - 1.0 / (1.0 + a + a * a + 1.41645 * a ** 4)
    return 1.7159 * torch.sign(x) * approx


def _hard_tanh(x):
    # min(max(x, -1), 1) as jnp.clip: the gradient 0.5 at the corners
    one = x.new_ones(())
    return torch.minimum(torch.maximum(x, -one), one)


def _leaky(slope: float) -> Activation:
    return lambda x: torch.where(x >= 0, x, slope * x)


def _elu(x):
    return torch.where(x > 0, x, torch.expm1(torch.where(x > 0, 0.0, x)))


_SELU_ALPHA, _SELU_SCALE = 1.6732632423543772, 1.0507009873554805


def _selu(x):
    return _SELU_SCALE * torch.where(x > 0, x, _SELU_ALPHA * torch.expm1(
        torch.where(x > 0, 0.0, x)))


def _gelu(x):
    # jax.nn.gelu(approximate=True)
    cdf = 0.5 * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi) * (x + 0.044715 * x ** 3)))
    return x * cdf


def _silu(x):
    return x * torch.sigmoid(x)


_REGISTRY.update(
    {
        "identity": _identity,
        "linear": _identity,
        "relu": torch.relu,
        "relu6": torch.nn.functional.relu6,
        "leakyrelu": _leaky(0.01),
        "rrelu": _leaky(0.125),
        "elu": _elu,
        "selu": _selu,
        "gelu": _gelu,
        "silu": _silu,
        "swish": _silu,
        "sigmoid": torch.sigmoid,
        "hardsigmoid": _hard_sigmoid,
        "tanh": torch.tanh,
        "hardtanh": _hard_tanh,
        "rationaltanh": _rational_tanh,
        "softmax": _softmax,
        "logsoftmax": lambda x: torch.log_softmax(x, dim=-1),
        "softplus": lambda x: torch.logaddexp(x, torch.zeros_like(x)),
        "softsign": lambda x: x / (torch.abs(x) + 1.0),
        "cube": lambda x: x ** 3,
        "exp": torch.exp,
    }
)

# snapshot so the ops tier can tell a user override from a builtin
_BUILTINS = dict(_REGISTRY)


def is_builtin(name: str) -> bool:
    """True when ``name`` still resolves to the stock implementation."""
    key = name.lower()
    return key in _BUILTINS and _REGISTRY.get(key) is _BUILTINS[key]
