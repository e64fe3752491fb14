"""Layer SPI + registry (counterpart of ``deeplearning4j_tpu/nn/layers/base.py``).

One dataclass per layer is its config, with the JAX package's fields, so the
same JSON configures both packages. It carries plain tensor functions:

- ``get_output_type(input_type)`` — static shape inference
- ``init_params(gen, input_type)`` — dict of CPU tensors from a ``torch.Generator``
- ``init_state(input_type)`` — dict of CPU f32 tensors that are not trained
  (BatchNormalization's running mean and variance), {} for most layers
- ``apply(params, x, state, mask, train, generator)`` — forward, returning
  (output, new state); ``train`` turns dropout on, drawn from
  ``generator``, and has BatchNormalization use and update batch stats
- ``regularization_loss(params)`` — the l1/l2 terms of the training loss
- ``is_output_layer`` / ``is_pretrain_layer`` — a loss head (it has
  ``compute_loss``), and a layer ``MultiLayerNetwork.pretrain`` trains
  alone (it has ``pretrain_loss``)

Params for layer i are a dict keyed "W"/"b"/... as in the JAX package; the
network (``nn/multilayer.py``) holds them as an ``nn.ParameterDict`` per layer.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple, Type

import torch

from ..activations import get_activation
from ..conf.inputs import InputType
from ..initializers import init_weights

LAYER_REGISTRY: Dict[str, Type["BaseLayer"]] = {}

Params = Dict[str, torch.Tensor]
State = Dict[str, Any]


def register_layer(cls):
    """Class decorator: register a layer for JSON round-trip by class name."""
    LAYER_REGISTRY[cls.__name__] = cls
    return cls


def layer_from_dict(d: dict) -> "BaseLayer":
    d = dict(d)
    type_name = d.pop("@type")
    cls = LAYER_REGISTRY.get(type_name)
    if cls is None:
        raise ValueError(
            f"Layer type '{type_name}' is not ported. Known: {sorted(LAYER_REGISTRY)}")
    fields = {f.name for f in dataclasses.fields(cls)}
    return cls(**{k: v for k, v in d.items() if k in fields})


@dataclass
class BaseLayer:
    """Common hyperparameters. ``l1``/``l2`` enter the training loss through
    :meth:`regularization_loss`; ``dropout`` acts only in training."""

    name: str = ""
    activation: str = "identity"
    weight_init: str = "xavier"
    distribution: Optional[dict] = None
    bias_init: float = 0.0
    l1: float = 0.0
    l2: float = 0.0
    l1_bias: float = 0.0
    l2_bias: float = 0.0
    dropout: float = 0.0

    def to_dict(self) -> dict:
        d = {"@type": type(self).__name__}
        for f in dataclasses.fields(self):
            d[f.name] = getattr(self, f.name)
        return d

    def get_output_type(self, input_type: InputType) -> InputType:
        return input_type

    def init_params(self, gen: torch.Generator, input_type: InputType) -> Params:
        return {}

    def init_state(self, input_type: InputType) -> State:
        return {}

    def apply(self, params: Params, x: torch.Tensor, state: State, *,
              mask: Optional[torch.Tensor] = None, train: bool = False,
              generator: Optional[torch.Generator] = None,
              ) -> Tuple[torch.Tensor, State]:
        raise NotImplementedError

    def regularization_loss(self, params: Params) -> torch.Tensor:
        """0.5*l2*||W||^2 + l1*|W| (+ the bias coefficients for every key that
        starts with "b" or names a bias) — reference BaseLayer.calcL2/calcL1,
        key rule of the JAX package as it is."""
        total = torch.zeros((), dtype=torch.float32)
        for k, v in params.items():
            if k.startswith("b") or "bias" in k.lower():
                l1c, l2c = self.l1_bias, self.l2_bias
            elif k in ("gamma", "beta", "mean", "var"):
                continue  # BN params not regularized (reference parity)
            else:
                l1c, l2c = self.l1, self.l2
            if l2c:
                total = total + 0.5 * l2c * torch.sum(v * v)
            if l1c:
                # |v| with the JAX package's subgradient at 0 (+1, where
                # torch.abs gives 0): peepholes start at exactly 0
                total = total + l1c * torch.sum(torch.where(v >= 0, v, -v))
        return total

    @property
    def is_recurrent(self) -> bool:
        return False

    @property
    def is_output_layer(self) -> bool:
        """A loss head: the layer computes the training loss."""
        return hasattr(self, "compute_loss")

    @property
    def is_pretrain_layer(self) -> bool:
        """Layerwise-pretrainable (reference: Layer.isPretrainLayer): the
        layer has a ``pretrain_loss`` that ``MultiLayerNetwork.pretrain``
        trains."""
        return False

    def _init_weight(self, gen, shape, fan_in, fan_out) -> torch.Tensor:
        return init_weights(gen, shape, fan_in, fan_out, scheme=self.weight_init,
                            distribution=self.distribution)

    def _init_bias(self, shape) -> torch.Tensor:
        return torch.full(shape, float(self.bias_init))

    def _activate(self, preout: torch.Tensor) -> torch.Tensor:
        return get_activation(self.activation)(preout)


def maybe_dropout(x: torch.Tensor, rate: float, train: bool = False,
                  generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Inverted dropout on a layer's input (reference: util/Dropout.java):
    in training, each unit is dropped with probability ``rate`` and the rest
    scaled by 1/(1 - rate), from ``generator`` (on x's device). It does not
    draw the JAX package's random bits. Outside training ``x`` passes."""
    if not train or rate <= 0.0 or generator is None:
        return x
    keep = 1.0 - rate
    kept = torch.rand(x.shape, generator=generator, device=x.device) < keep
    return torch.where(kept, x / keep, torch.zeros_like(x))
