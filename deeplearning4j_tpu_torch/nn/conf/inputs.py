"""Input typing for shape inference (counterpart of
``deeplearning4j_tpu/nn/conf/inputs.py``), with the same JSON form.

As in the JAX package, CNN activations are NHWC at the API boundary
([batch, height, width, channels]) and recurrent activations [batch, time,
features].
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass(frozen=True)
class InputType:
    """Shape of one example (no batch dim)."""

    kind: str  # "ff" | "rnn" | "cnn" | "cnn_flat"
    size: int = 0  # ff, rnn: feature count; cnn_flat: height*width*channels
    timesteps: Optional[int] = None  # rnn: None for variable length
    height: int = 0
    width: int = 0
    channels: int = 0

    def __str__(self) -> str:  # compact form for summary() tables
        if self.kind == "ff":
            return f"ff({self.size})"
        if self.kind == "rnn":
            t = "?" if self.timesteps is None else self.timesteps
            return f"rnn({self.size}, T={t})"
        if self.kind in ("cnn", "cnn_flat"):
            return f"{self.kind}({self.height}x{self.width}x{self.channels})"
        return self.kind

    @staticmethod
    def feed_forward(size: int) -> "InputType":
        return InputType(kind="ff", size=int(size))

    @staticmethod
    def recurrent(size: int, timesteps: Optional[int] = None) -> "InputType":
        return InputType(kind="rnn", size=int(size), timesteps=timesteps)

    @staticmethod
    def convolutional(height: int, width: int, channels: int) -> "InputType":
        return InputType(kind="cnn", height=int(height), width=int(width),
                         channels=int(channels))

    @staticmethod
    def convolutional_flat(height: int, width: int, channels: int) -> "InputType":
        """A flattened image vector (reference: InputType.convolutionalFlat)."""
        return InputType(kind="cnn_flat", height=int(height), width=int(width),
                         channels=int(channels),
                         size=int(height) * int(width) * int(channels))

    def flat_size(self) -> int:
        if self.kind in ("ff", "rnn"):
            return self.size
        return self.height * self.width * self.channels

    def example_shape(self) -> Tuple[int, ...]:
        """Per-example array shape (batch dim excluded)."""
        if self.kind == "ff":
            return (self.size,)
        if self.kind == "rnn":
            return (self.timesteps if self.timesteps is not None else 1, self.size)
        if self.kind == "cnn":
            return (self.height, self.width, self.channels)
        return (self.size,)

    def batch_shape(self, batch: int) -> Tuple[int, ...]:
        return (batch,) + self.example_shape()

    def to_dict(self) -> dict:
        d = {"kind": self.kind}
        if self.kind in ("ff", "rnn"):
            d["size"] = self.size
        if self.kind == "rnn":
            d["timesteps"] = self.timesteps
        if self.kind in ("cnn", "cnn_flat"):
            d.update(height=self.height, width=self.width, channels=self.channels)
        return d

    @staticmethod
    def from_dict(d: dict) -> "InputType":
        kind = d["kind"]
        if kind == "ff":
            return InputType.feed_forward(d["size"])
        if kind == "rnn":
            return InputType.recurrent(d["size"], d.get("timesteps"))
        if kind == "cnn":
            return InputType.convolutional(d["height"], d["width"], d["channels"])
        if kind == "cnn_flat":
            return InputType.convolutional_flat(d["height"], d["width"], d["channels"])
        raise ValueError(f"Unknown InputType kind '{kind}'")
