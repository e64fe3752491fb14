"""Input preprocessors: shape adapters between layer families (counterpart of
``deeplearning4j_tpu/nn/conf/preprocessors.py``), with the same JSON.

All are reshapes of the layouts of ``conf/inputs.py`` (NHWC images,
[batch, time, features] sequences); autograd takes their gradients.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, Type

import torch

from .inputs import InputType

PREPROCESSOR_REGISTRY: Dict[str, Type["InputPreProcessor"]] = {}


def register_preprocessor(cls):
    """Class decorator: register a preprocessor for JSON round-trip by class
    name."""
    PREPROCESSOR_REGISTRY[cls.__name__] = cls
    return cls


def preprocessor_from_dict(d: dict) -> "InputPreProcessor":
    d = dict(d)
    name = d.pop("@type")
    cls = PREPROCESSOR_REGISTRY.get(name)
    if cls is None:
        raise ValueError(f"Unknown preprocessor '{name}'")
    fields = {f.name for f in dataclasses.fields(cls)}
    return cls(**{k: v for k, v in d.items() if k in fields})


@dataclass
class InputPreProcessor:
    """SPI (reference: nn/conf/InputPreProcessor.java)."""

    def to_dict(self) -> dict:
        d = {"@type": type(self).__name__}
        for f in dataclasses.fields(self):
            d[f.name] = getattr(self, f.name)
        return d

    def get_output_type(self, input_type: InputType) -> InputType:
        raise NotImplementedError

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError


@register_preprocessor
@dataclass
class CnnToFeedForwardPreProcessor(InputPreProcessor):
    """[B,H,W,C] -> [B, H*W*C] (reference: CnnToFeedForwardPreProcessor.java)."""

    height: int = 0
    width: int = 0
    channels: int = 0

    def get_output_type(self, it: InputType) -> InputType:
        return InputType.feed_forward(it.flat_size())

    def apply(self, x):
        return x.reshape(x.shape[0], -1)


@register_preprocessor
@dataclass
class FeedForwardToCnnPreProcessor(InputPreProcessor):
    """[B, H*W*C] -> [B,H,W,C] (reference: FeedForwardToCnnPreProcessor.java)."""

    height: int = 0
    width: int = 0
    channels: int = 1

    def get_output_type(self, it: InputType) -> InputType:
        return InputType.convolutional(self.height, self.width, self.channels)

    def apply(self, x):
        return x.reshape(x.shape[0], self.height, self.width, self.channels)


@register_preprocessor
@dataclass
class RnnToFeedForwardPreProcessor(InputPreProcessor):
    """[B,T,F] -> [B*T, F] (reference: RnnToFeedForwardPreProcessor.java):
    time folds into the batch, so feed-forward layers apply per step."""

    def get_output_type(self, it: InputType) -> InputType:
        return InputType.feed_forward(it.size)

    def apply(self, x):
        return x.reshape(-1, x.shape[-1])


@register_preprocessor
@dataclass
class FeedForwardToRnnPreProcessor(InputPreProcessor):
    """[B*T, F] -> [B,T,F]; needs the timestep count."""

    timesteps: int = 0

    def get_output_type(self, it: InputType) -> InputType:
        return InputType.recurrent(it.flat_size(), self.timesteps or None)

    def apply(self, x):
        if self.timesteps <= 0:
            raise ValueError("FeedForwardToRnnPreProcessor requires timesteps > 0")
        return x.reshape(-1, self.timesteps, x.shape[-1])


@register_preprocessor
@dataclass
class CnnToRnnPreProcessor(InputPreProcessor):
    """[B,H,W,C] -> [B, H, W*C]: each image a sequence of its H rows
    (reference: CnnToRnnPreProcessor.java flattens depth*width a step)."""

    height: int = 0
    width: int = 0
    channels: int = 0

    def get_output_type(self, it: InputType) -> InputType:
        h = self.height or it.height
        w = self.width or it.width
        c = self.channels or it.channels
        return InputType.recurrent(w * c, h)

    def apply(self, x):
        b, h, w, c = x.shape
        return x.reshape(b, h, w * c)


@register_preprocessor
@dataclass
class RnnToCnnPreProcessor(InputPreProcessor):
    """[B,T,F] -> [B*T,H,W,C] (reference: RnnToCnnPreProcessor.java)."""

    height: int = 0
    width: int = 0
    channels: int = 1

    def get_output_type(self, it: InputType) -> InputType:
        return InputType.convolutional(self.height, self.width, self.channels)

    def apply(self, x):
        return x.reshape(-1, self.height, self.width, self.channels)


@register_preprocessor
@dataclass
class ComposableInputPreProcessor(InputPreProcessor):
    """Chain of preprocessors (reference: ComposableInputPreProcessor.java)."""

    children: list = dataclasses.field(default_factory=list)

    def to_dict(self) -> dict:
        return {"@type": type(self).__name__,
                "children": [c.to_dict() for c in self.children]}

    def __post_init__(self):
        self.children = [preprocessor_from_dict(c) if isinstance(c, dict) else c
                         for c in self.children]

    def get_output_type(self, it: InputType) -> InputType:
        for c in self.children:
            it = c.get_output_type(it)
        return it

    def apply(self, x):
        for c in self.children:
            x = c.apply(x)
        return x
