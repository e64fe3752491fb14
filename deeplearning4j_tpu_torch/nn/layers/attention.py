"""Attention layers: LayerNorm and multi-head self-attention (counterpart of
``deeplearning4j_tpu/nn/layers/attention.py``), with its fields, JSON and
param keys.

The projections ``x @ W`` are ``torch.matmul`` under autograd, as the JAX
package leaves them to XLA; the attention itself is ``ops.flash_attention``
(the CUDA kernels on the card, their plain versions on the CPU). The layer
has no recurrent state: under ``rnn_time_step`` and TBPTT it attends within
the chunk or segment it is given, as in the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ... import ops
from ..conf.inputs import InputType
from .base import BaseLayer, Params, maybe_dropout, register_layer


@register_layer
@dataclass
class LayerNormLayer(BaseLayer):
    """Per-feature LayerNorm over the trailing axis: the population variance
    (``jnp.var``'s ddof 0), ``rsqrt(var + eps)``, then the activation."""

    eps: float = 1e-5

    def get_output_type(self, input_type: InputType) -> InputType:
        return input_type

    def init_params(self, gen, input_type: InputType) -> Params:
        n = input_type.flat_size()  # the trailing axis of ff and rnn activations
        return {"gamma": torch.ones(n), "beta": torch.zeros(n)}

    def apply(self, params, x, state, *, mask=None, train=False, generator=None):
        mean = x.mean(-1, keepdim=True)
        var = x.var(-1, keepdim=True, unbiased=False)
        xhat = (x - mean) * torch.rsqrt(var + self.eps)
        return self._activate(xhat * params["gamma"] + params["beta"]), state


@register_layer
@dataclass
class SelfAttentionLayer(BaseLayer):
    """Multi-head self-attention over [B, T, F] sequences; the features mask
    [B, T] is the key mask.

    ``attention_impl`` ("auto", "flash" or "xla") and ``sequence_parallel``
    are kept for the JSON. Every ``attention_impl`` runs the flash kernels on
    the card and their plain version on the CPU: the JAX package's choices
    compute the same function, and the port picks no variant. The mesh
    execution (``sequence_parallel``, ``set_attention_mesh``) is not ported.
    """

    n_out: int = 0
    n_heads: int = 4
    causal: bool = False
    sequence_parallel: str = "ring"  # ring | all_to_all
    attention_impl: str = "auto"

    @property
    def is_recurrent(self) -> bool:
        return True

    def get_output_type(self, input_type: InputType) -> InputType:
        return InputType.recurrent(self.n_out, input_type.timesteps)

    def init_params(self, gen, input_type: InputType) -> Params:
        n_in, d = input_type.size, self.n_out
        if d % self.n_heads:
            raise ValueError(f"n_out {d} not divisible by n_heads {self.n_heads}")
        return {
            "Wq": self._init_weight(gen, (n_in, d), n_in, d),
            "Wk": self._init_weight(gen, (n_in, d), n_in, d),
            "Wv": self._init_weight(gen, (n_in, d), n_in, d),
            "Wo": self._init_weight(gen, (d, d), d, d),
            "bo": self._init_bias((d,)),
        }

    def apply(self, params, x, state, *, mask=None, train=False, generator=None):
        B, T, _ = x.shape
        H = self.n_heads
        D = self.n_out // H

        def split(w):
            return torch.matmul(x, w).reshape(B, T, H, D).transpose(1, 2)

        q, k, v = split(params["Wq"]), split(params["Wk"]), split(params["Wv"])
        key_mask = None if mask is None else mask.to(x.dtype)
        out = ops.flash_attention(q, k, v, causal=self.causal, key_mask=key_mask)
        out = out.transpose(1, 2).reshape(B, T, self.n_out)
        out = torch.matmul(out, params["Wo"]) + params["bo"]
        out = maybe_dropout(out, self.dropout, train, generator)
        return self._activate(out), state
