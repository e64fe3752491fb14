"""FrozenLayer (counterpart of ``deeplearning4j_tpu/nn/layers/frozen.py``): a
wrapper whose layer's params are held constant in training.

The wrapped layer runs on detached params, so autograd never reaches them
and the network's gradient for them is zeros (``BaseNetwork._grads``
materializes an unreached leaf's gradient). With zero gradients every
updater of the port moves them by exactly 0: SGD by -lr*0, Adam from zero
moments to zero moments. The inner layer always runs with ``train=False``,
as the reference's FrozenLayer does: dropout is off, and BatchNormalization
normalizes with its running statistics and returns its state unchanged.
Frozen params carry no regularization term.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

import torch

from ..conf.inputs import InputType
from .base import BaseLayer, Params, layer_from_dict, register_layer


def _detached(params: Params) -> Params:
    return {k: v.detach() for k, v in params.items()}


@register_layer
@dataclass
class FrozenLayer(BaseLayer):
    """Wraps any layer (a layer or its ``to_dict()`` form); its params stay
    as they are in training."""

    layer: Optional[Any] = None

    def __post_init__(self):
        if isinstance(self.layer, dict):
            self.layer = layer_from_dict(self.layer)

    def to_dict(self) -> dict:
        return {"@type": "FrozenLayer", "layer": self.layer.to_dict(), "name": self.name}

    def get_output_type(self, input_type: InputType) -> InputType:
        return self.layer.get_output_type(input_type)

    def init_params(self, gen, input_type: InputType) -> Params:
        return self.layer.init_params(gen, input_type)

    def init_state(self, input_type: InputType):
        return self.layer.init_state(input_type)

    @property
    def is_output_layer(self) -> bool:
        return self.layer.is_output_layer

    @property
    def is_recurrent(self) -> bool:
        return self.layer.is_recurrent

    def init_recurrent_state(self, batch: int, dtype: torch.dtype, device: torch.device):
        return self.layer.init_recurrent_state(batch, dtype, device)

    def regularization_loss(self, params: Params) -> torch.Tensor:
        return torch.zeros((), dtype=torch.float32)

    def apply(self, params, x, state, *, mask=None, train=False, generator=None, **kw):
        return self.layer.apply(_detached(params), x, state, mask=mask, train=False,
                                generator=generator, **kw)

    def apply_seq(self, params, x, rstate, *, mask=None, train=False, generator=None, **kw):
        return self.layer.apply_seq(_detached(params), x, rstate, mask=mask, train=False,
                                    generator=generator, **kw)

    def compute_loss(self, params, x, labels, mask=None, *, train=False, generator=None):
        return self.layer.compute_loss(_detached(params), x, labels, mask, train=False,
                                       generator=generator)
