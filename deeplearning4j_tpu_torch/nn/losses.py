"""Loss-function catalog (counterpart of ``deeplearning4j_tpu/nn/losses.py``),
by the same names and with the same semantics.

Each loss is ``(labels, preout, activation_name, mask) -> scalar``: the mean
over examples (rows), or with ``mask`` [N] the masked sum over
``max(sum(mask), 1)``. ``mcxent`` with softmax on 2D logits and labels of
the same shape goes through ``ops.softmax_xent_rows`` (the softmax-xent
kernels on the card); every other form is plain PyTorch, as the JAX package
gives it no kernel either. Log-probabilities are taken in at least f32.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from .. import ops
from .activations import get_activation

EPS = 1e-7

LossFn = Callable[..., torch.Tensor]

_REGISTRY: Dict[str, LossFn] = {}


def register_loss(name: str, fn: LossFn) -> None:
    _REGISTRY[name.lower()] = fn


def get_loss(name: str) -> LossFn:
    try:
        return _REGISTRY[name.lower()]
    except KeyError:
        raise ValueError(f"Unknown loss '{name}'. Known: {sorted(_REGISTRY)}") from None


def _per_example(scores: torch.Tensor) -> torch.Tensor:
    """Sum all trailing dims -> one score per example (row)."""
    return scores.reshape(scores.shape[0], -1).sum(-1)


def _apply_mask(per_ex: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
    if mask is None:
        return per_ex.mean()
    mask = mask.reshape(per_ex.shape).to(per_ex.dtype)
    return (per_ex * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def _activated(preout: torch.Tensor, activation: str) -> torch.Tensor:
    return get_activation(activation)(preout)


def _at_least_f32(dt: torch.dtype) -> torch.dtype:
    return torch.promote_types(dt, torch.float32)


def mcxent(labels, preout, activation="softmax", mask=None):
    """Multi-class cross entropy (reference: LossMCXENT), fused with softmax;
    2D logits go through the softmax-xent kernels."""
    if activation == "softmax":
        if preout.dim() == 2 and labels.shape == preout.shape:
            return _apply_mask(ops.softmax_xent_rows(labels, preout), mask)
        logp = torch.log_softmax(preout.to(_at_least_f32(preout.dtype)), dim=-1)
    else:
        act = _activated(preout, activation)
        logp = torch.log(torch.clamp(act.to(_at_least_f32(act.dtype)), EPS, 1.0))
    scores = -(labels.to(logp.dtype) * logp)
    return _apply_mask(_per_example(scores), mask)


def _softplus(x):
    # log(1 + exp(x)) exactly as jax.nn.softplus computes it (logaddexp(x, 0))
    return torch.logaddexp(x, torch.zeros_like(x))


def xent(labels, preout, activation="sigmoid", mask=None):
    """Binary cross entropy (reference: LossBinaryXENT), fused with sigmoid."""
    if activation == "sigmoid":
        scores = labels * _softplus(-preout) + (1.0 - labels) * _softplus(preout)
    else:
        p = torch.clamp(_activated(preout, activation), EPS, 1.0 - EPS)
        scores = -(labels * torch.log(p) + (1.0 - labels) * torch.log(1.0 - p))
    return _apply_mask(_per_example(scores), mask)


def negativeloglikelihood(labels, preout, activation="softmax", mask=None):
    """Reference: LossNegativeLogLikelihood == MCXENT for one-hot labels."""
    return mcxent(labels, preout, activation, mask)


def mse(labels, preout, activation="identity", mask=None):
    out = _activated(preout, activation)
    # averaged over output dims (score normalized by label width)
    return _apply_mask(_per_example((out - labels) ** 2) / labels.shape[-1], mask)


def l2(labels, preout, activation="identity", mask=None):
    out = _activated(preout, activation)
    return _apply_mask(_per_example((out - labels) ** 2), mask)


def mae(labels, preout, activation="identity", mask=None):
    out = _activated(preout, activation)
    return _apply_mask(_per_example(torch.abs(out - labels)) / labels.shape[-1], mask)


def l1(labels, preout, activation="identity", mask=None):
    out = _activated(preout, activation)
    return _apply_mask(_per_example(torch.abs(out - labels)), mask)


def _signed_labels(labels):
    # {0,1} one-hot or {-1,+1}: > 0.5 -> +1, else -1
    return (labels > 0.5).to(labels.dtype) * 2.0 - 1.0


def hinge(labels, preout, activation="identity", mask=None):
    """labels in {-1, +1} or one-hot; reference: LossHinge."""
    out = _activated(preout, activation)
    scores = torch.clamp(1.0 - _signed_labels(labels) * out, min=0.0)
    return _apply_mask(_per_example(scores), mask)


def squared_hinge(labels, preout, activation="identity", mask=None):
    out = _activated(preout, activation)
    scores = torch.clamp(1.0 - _signed_labels(labels) * out, min=0.0) ** 2
    return _apply_mask(_per_example(scores), mask)


def kl_divergence(labels, preout, activation="softmax", mask=None):
    out = torch.clamp(_activated(preout, activation), EPS, 1.0)
    lab = torch.clamp(labels, EPS, 1.0)
    scores = lab * (torch.log(lab) - torch.log(out))
    return _apply_mask(_per_example(scores), mask)


def cosine_proximity(labels, preout, activation="identity", mask=None):
    out = _activated(preout, activation)
    ln = torch.linalg.vector_norm(labels, dim=-1)
    on = torch.linalg.vector_norm(out, dim=-1)
    cos = (labels * out).sum(-1) / torch.clamp(ln * on, min=EPS)
    return _apply_mask(-cos.reshape(cos.shape[0], -1).sum(-1), mask)


def poisson(labels, preout, activation="identity", mask=None):
    out = _activated(preout, activation)
    scores = out - labels * torch.log(torch.clamp(out, min=EPS))
    return _apply_mask(_per_example(scores), mask)


def mape(labels, preout, activation="identity", mask=None):
    out = _activated(preout, activation)
    scores = 100.0 * torch.abs((labels - out) / torch.clamp(torch.abs(labels), min=EPS))
    return _apply_mask(_per_example(scores) / labels.shape[-1], mask)


def msle(labels, preout, activation="identity", mask=None):
    out = _activated(preout, activation)
    # labels are clamped like predictions: log1p(x) for x <= -1 is -inf/nan
    scores = (torch.log1p(torch.clamp(out, min=-1 + EPS))
              - torch.log1p(torch.clamp(labels, min=-1 + EPS))) ** 2
    return _apply_mask(_per_example(scores) / labels.shape[-1], mask)


_REGISTRY.update(
    {
        "mcxent": mcxent,
        "xent": xent,
        "negativeloglikelihood": negativeloglikelihood,
        "mse": mse,
        "l2": l2,
        "mae": mae,
        "l1": l1,
        "hinge": hinge,
        "squared_hinge": squared_hinge,
        "kl_divergence": kl_divergence,
        "reconstruction_crossentropy": xent,
        "cosine_proximity": cosine_proximity,
        "poisson": poisson,
        "mape": mape,
        "msle": msle,
    }
)
