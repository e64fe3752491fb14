"""Dense, output, loss, activation, dropout and embedding layers
(counterpart of ``deeplearning4j_tpu/nn/layers/dense.py``)."""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..conf.inputs import InputType
from ..losses import get_loss
from .base import BaseLayer, Params, register_layer, maybe_dropout


@register_layer
@dataclass
class DenseLayer(BaseLayer):
    """Fully connected: y = act(xW + b)."""

    n_in: int = 0  # inferred from input type when 0
    n_out: int = 0
    has_bias: bool = True

    def get_output_type(self, input_type: InputType) -> InputType:
        return InputType.feed_forward(self.n_out)

    def infer_n_in(self, input_type: InputType) -> int:
        return self.n_in or input_type.flat_size()

    def init_params(self, gen, input_type: InputType) -> Params:
        n_in = self.infer_n_in(input_type)
        p = {"W": self._init_weight(gen, (n_in, self.n_out), n_in, self.n_out)}
        if self.has_bias:
            p["b"] = self._init_bias((self.n_out,))
        return p

    def pre_output(self, params: Params, x):
        if x.dim() > 2:
            x = x.reshape(x.shape[0], -1)
        z = x @ params["W"]
        if self.has_bias:
            z = z + params["b"]
        return z

    def apply(self, params, x, state, *, mask=None, train=False, generator=None):
        x = maybe_dropout(x, self.dropout, train, generator)
        return self._activate(self.pre_output(params, x)), state


@register_layer
@dataclass
class OutputLayer(DenseLayer):
    """Dense + loss head (reference: OutputLayer)."""

    loss: str = "mcxent"

    def compute_loss(self, params, x, labels, mask=None, *, train=False,
                     generator=None):
        """The mean loss of ``labels`` against this layer's pre-output on
        ``x`` (``mask`` [N] weights the rows)."""
        x = maybe_dropout(x, self.dropout, train, generator)
        return get_loss(self.loss)(labels, self.pre_output(params, x),
                                   self.activation, mask)


@register_layer
@dataclass
class LossLayer(BaseLayer):
    """Loss head without params (reference: conf/layers/LossLayer.java): its
    input is the pre-output."""

    loss: str = "mcxent"

    def apply(self, params, x, state, *, mask=None, train=False, generator=None):
        return self._activate(x), state

    def compute_loss(self, params, x, labels, mask=None, *, train=False,
                     generator=None):
        return get_loss(self.loss)(labels, x, self.activation, mask)


@register_layer
@dataclass
class ActivationLayer(BaseLayer):
    """The activation alone, no params (reference:
    conf/layers/ActivationLayer.java)."""

    def apply(self, params, x, state, *, mask=None, train=False, generator=None):
        return self._activate(x), state


@register_layer
@dataclass
class DropoutLayer(BaseLayer):
    """Dropout alone, no params (reference: conf/layers/DropoutLayer.java):
    ``maybe_dropout`` of its input at rate ``dropout`` in training, the
    input itself otherwise."""

    def apply(self, params, x, state, *, mask=None, train=False, generator=None):
        return maybe_dropout(x, self.dropout, train, generator), state


@register_layer
@dataclass
class EmbeddingLayer(BaseLayer):
    """Index -> row lookup (reference: EmbeddingLayer.java): integer indices
    [batch] or [batch, 1] (floating indices are truncated) to rows [batch,
    n_out] of W [n_in, n_out], plus b; dropout acts on the looked-up rows."""

    n_in: int = 0  # vocab size
    n_out: int = 0
    has_bias: bool = True

    def get_output_type(self, input_type: InputType) -> InputType:
        return InputType.feed_forward(self.n_out)

    def init_params(self, gen, input_type: InputType) -> Params:
        n_in = self.n_in or input_type.flat_size()
        p = {"W": self._init_weight(gen, (n_in, self.n_out), n_in, self.n_out)}
        if self.has_bias:
            p["b"] = self._init_bias((self.n_out,))
        return p

    def apply(self, params, x, state, *, mask=None, train=False, generator=None):
        idx = x.to(torch.int64)
        if idx.dim() == 2 and idx.shape[-1] == 1:
            idx = idx[:, 0]
        z = params["W"][idx]
        if self.has_bias:
            z = z + params["b"]
        z = maybe_dropout(z, self.dropout, train, generator)
        return self._activate(z), state
