"""Normalization layers (counterpart of
``deeplearning4j_tpu/nn/layers/normalization.py``).

``BatchNormalization`` is plain tensor ops that follow the JAX package's
arithmetic step by step, its running mean and variance in the layer state
(f32, threaded through the network's forward; nothing of them enters
autograd). It is not ``F.batch_norm``: torch keeps an unbiased running
variance, counts momentum the other way round and normalizes in one fused
step, which rounds bf16 once where the JAX package rounds twice.

``LocalResponseNormalization`` normalizes over the trailing (NHWC channel)
axis through ``ops.lrn``: the hand-written kernels of ``ops/csrc/lrn.cu`` on
the card, their plain versions on the CPU.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ... import ops
from ..conf.inputs import InputType
from .base import BaseLayer, Params, State, register_layer

# inputs whose batch stats take one pass in f32, E[x^2] - E[x]^2
_ONE_PASS = (torch.bfloat16, torch.float16)


@register_layer
@dataclass
class BatchNormalization(BaseLayer):
    """Per-channel batch norm over NHWC images or [B, F] rows (reference:
    BatchNormalization.java): moving = decay*moving + (1-decay)*batch with
    the biased batch variance, eps 1e-5, optional lockGammaBeta (gamma and
    beta fixed at ``gamma_init`` and ``beta_init``, no params). Params
    "gamma", "beta"; state "mean", "var"."""

    decay: float = 0.9
    eps: float = 1e-5
    lock_gamma_beta: bool = False
    gamma_init: float = 1.0
    beta_init: float = 0.0

    def _n_feat(self, it: InputType) -> int:
        return it.channels if it.kind == "cnn" else it.flat_size()

    def init_params(self, gen, it: InputType) -> Params:
        if self.lock_gamma_beta:
            return {}
        n = self._n_feat(it)
        return {"gamma": torch.full((n,), float(self.gamma_init)),
                "beta": torch.full((n,), float(self.beta_init))}

    def init_state(self, it: InputType) -> State:
        n = self._n_feat(it)
        return {"mean": torch.zeros(n), "var": torch.ones(n)}

    def apply(self, params, x, state, *, mask=None, train=False, generator=None):
        dims = tuple(range(x.dim() - 1))  # all but the channel/feature axis
        stat_dt = torch.promote_types(x.dtype, torch.float32)
        if train:
            xf = x.to(stat_dt)
            mean = torch.mean(xf, dim=dims)
            if x.dtype in _ONE_PASS:
                var = torch.clamp(torch.mean(torch.square(xf), dim=dims)
                                  - torch.square(mean), min=0.0)
            else:  # two passes: E[x^2] - E[x]^2 cancels where |mean| >> std
                var = torch.mean(torch.square(xf - mean), dim=dims)
            new_state = {
                "mean": self.decay * state["mean"] + (1 - self.decay) * mean.detach(),
                "var": self.decay * state["var"] + (1 - self.decay) * var.detach(),
            }
        else:
            mean, var = state["mean"].to(stat_dt), state["var"].to(stat_dt)
            new_state = state
        # scale and offset at the stats' precision, then one multiply and
        # one add in x's dtype
        scale = torch.rsqrt(var + self.eps)
        if self.lock_gamma_beta:
            scale = scale * self.gamma_init
            offset = self.beta_init - mean * scale
        else:
            scale = scale * params["gamma"].to(stat_dt)
            offset = params["beta"].to(stat_dt) - mean * scale
        return self._activate(x * scale.to(x.dtype) + offset.to(x.dtype)), new_state


@register_layer
@dataclass
class LocalResponseNormalization(BaseLayer):
    """Cross-channel LRN (reference: LocalResponseNormalization.java defaults
    k=2, n=5, alpha=1e-4, beta=0.75): y = x / (k + alpha*sum_n x^2)^beta.
    No params."""

    k: float = 2.0
    n: int = 5
    alpha: float = 1e-4
    beta: float = 0.75

    def apply(self, params, x, state, *, mask=None, train=False, generator=None):
        y = ops.lrn(x, k=self.k, n=self.n, alpha=self.alpha, beta=self.beta)
        return self._activate(y), state
