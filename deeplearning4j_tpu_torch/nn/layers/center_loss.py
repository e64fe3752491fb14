"""CenterLossOutputLayer (counterpart of
``deeplearning4j_tpu/nn/layers/center_loss.py``).

Loss = the primary loss + (lambda/2) * mean ||f - c_y||^2, where f is the
layer's input and c_y the center of the example's class. The centers are a
trained param ("centers", [n_out, n_in]), as in the JAX package: autograd
gives them lambda * (c_y - f), and the updater's step plays the part of the
reference's alpha. The primary loss goes through ``get_loss(self.loss)``,
so an ``mcxent`` head with softmax runs the softmax-xent kernels. The
centers start at zero in the network's param dtype (the JAX package makes
them in ``jnp.result_type(float)``, float64 under x64).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..conf.inputs import InputType
from ..losses import get_loss
from .base import Params, maybe_dropout, register_layer
from .dense import OutputLayer


@register_layer
@dataclass
class CenterLossOutputLayer(OutputLayer):
    """Reference: conf/layers/CenterLossOutputLayer.java (alpha, lambda)."""

    alpha: float = 0.05  # kept for config parity: the updater takes its part
    lambda_: float = 2e-4

    def init_params(self, gen, input_type: InputType) -> Params:
        p = super().init_params(gen, input_type)
        p["centers"] = torch.zeros((self.n_out, input_type.flat_size()))
        return p

    def compute_loss(self, params, x, labels, mask=None, *, train=False, generator=None):
        x = maybe_dropout(x, self.dropout, train, generator)
        preout = self.pre_output({k: v for k, v in params.items() if k != "centers"}, x)
        primary = get_loss(self.loss)(labels, preout, self.activation, mask)
        centers_y = labels.to(params["centers"].dtype) @ params["centers"]  # one-hot pick
        dist = torch.sum((x - centers_y) ** 2, dim=-1)
        if mask is not None:
            m = mask if mask.dim() == dist.dim() else mask[..., 0]
            dist = dist * m
            denom = torch.clamp(m.sum(), min=1.0)
        else:
            denom = dist.shape[0]
        return primary + 0.5 * self.lambda_ * torch.sum(dist) / denom
