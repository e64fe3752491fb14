"""Graph vertices, the DAG's building blocks beyond layers (counterpart of
``deeplearning4j_tpu/nn/graph/vertices.py``), with the same JSON.

One dataclass per vertex is both its config and a plain function on
tensors; autograd takes every backward. The SPI:

- ``get_output_type(*input_types)``: static shape inference;
- ``init_params(gen, *input_types)``: a dict of CPU tensors ({} but for
  layers);
- ``init_state(*input_types)``: the layer state ({} but for layers that
  keep one, such as BatchNormalization);
- ``apply(params, inputs, state, *, train, generator, masks)``: (the
  output tensor, the new state), as the JAX package's. ``inputs`` are the
  activations of the vertex's inputs in their declared order; ``state`` is
  the vertex's layer state, passed through by vertices that keep none;
  ``masks`` maps network-input names (and "features", the single mask of
  the graph's one-mask convenience) to [batch, time] masks.

A ``LayerVertex`` over a recurrent layer with streaming state (GravesLSTM)
also has ``is_recurrent``, ``init_recurrent_state`` and ``apply_seq``, which
TBPTT and ``rnn_time_step`` thread h/c through.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple, Type

import torch

from ..conf.inputs import InputType
from ..conf.preprocessors import preprocessor_from_dict
from ..layers.base import BaseLayer, Params, State, layer_from_dict

VERTEX_REGISTRY: Dict[str, Type["BaseVertex"]] = {}

Masks = Optional[Dict[str, Optional[torch.Tensor]]]


def register_vertex(cls):
    """Class decorator: register a vertex for JSON round-trip by class name."""
    VERTEX_REGISTRY[cls.__name__] = cls
    return cls


def vertex_from_dict(d: dict) -> "BaseVertex":
    d = dict(d)
    type_name = d.pop("@type")
    cls = VERTEX_REGISTRY.get(type_name)
    if cls is None:
        raise ValueError(f"Unknown vertex type '{type_name}'. Known: {sorted(VERTEX_REGISTRY)}")
    return cls._from_dict_fields(d)


def _jsonify(v):
    if isinstance(v, tuple):
        return [_jsonify(x) for x in v]
    if isinstance(v, dict):
        return {k: _jsonify(x) for k, x in v.items()}
    return v


@dataclass
class BaseVertex:
    """Vertex SPI (reference: nn/graph/vertex/GraphVertex.java)."""

    def to_dict(self) -> dict:
        d = {"@type": type(self).__name__}
        for f in dataclasses.fields(self):
            d[f.name] = _jsonify(getattr(self, f.name))
        return d

    @classmethod
    def _from_dict_fields(cls, d: dict) -> "BaseVertex":
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in names})

    @property
    def is_output_layer(self) -> bool:
        return False

    def get_output_type(self, *input_types: InputType) -> InputType:
        return input_types[0]

    def init_params(self, gen: torch.Generator, *input_types: InputType) -> Params:
        return {}

    def init_state(self, *input_types: InputType) -> State:
        return {}

    def regularization_loss(self, params: Params) -> torch.Tensor:
        return torch.zeros((), dtype=torch.float32)

    def apply(self, params: Params, inputs: Sequence[torch.Tensor], state: State, *,
              train: bool = False, generator: Optional[torch.Generator] = None,
              masks: Masks = None) -> Tuple[torch.Tensor, State]:
        raise NotImplementedError


@register_vertex
@dataclass
class LayerVertex(BaseVertex):
    """A layer as a graph vertex (reference: nn/conf/graph/LayerVertex.java):
    one input, through the optional input preprocessor first. The layer gets
    the graph's "features" mask."""

    layer: Optional[BaseLayer] = None
    preprocessor: Optional[object] = None

    def to_dict(self) -> dict:
        return {"@type": "LayerVertex", "layer": self.layer.to_dict(),
                "preprocessor": self.preprocessor.to_dict() if self.preprocessor else None}

    @classmethod
    def _from_dict_fields(cls, d: dict) -> "LayerVertex":
        pre = d.get("preprocessor")
        return cls(layer=layer_from_dict(d["layer"]),
                   preprocessor=preprocessor_from_dict(pre) if pre else None)

    @property
    def is_output_layer(self) -> bool:
        return self.layer.is_output_layer

    def _preprocessed_type(self, input_type: InputType) -> InputType:
        if self.preprocessor is not None:
            return self.preprocessor.get_output_type(input_type)
        return input_type

    def get_output_type(self, *input_types: InputType) -> InputType:
        if len(input_types) != 1:
            raise ValueError(f"LayerVertex takes exactly one input, got {len(input_types)}")
        return self.layer.get_output_type(self._preprocessed_type(input_types[0]))

    def init_params(self, gen, *input_types) -> Params:
        return self.layer.init_params(gen, self._preprocessed_type(input_types[0]))

    def init_state(self, *input_types) -> State:
        return self.layer.init_state(self._preprocessed_type(input_types[0]))

    def regularization_loss(self, params: Params) -> torch.Tensor:
        return self.layer.regularization_loss(params)

    def layer_input(self, inputs: Sequence[torch.Tensor]) -> torch.Tensor:
        """The layer's input: the vertex's one input, preprocessed."""
        x = inputs[0]
        return self.preprocessor.apply(x) if self.preprocessor is not None else x

    def apply(self, params, inputs, state, *, train=False, generator=None, masks=None):
        mask = None if masks is None else masks.get("features")
        return self.layer.apply(params, self.layer_input(inputs), state, mask=mask,
                                train=train, generator=generator)

    # the recurrent face (reference: ComputationGraph.rnnTimeStep routes
    # through each vertex's rnnTimeStep): only layer vertices carry h/c
    @property
    def is_recurrent(self) -> bool:
        return self.layer.is_recurrent and hasattr(self.layer, "init_recurrent_state")

    def init_recurrent_state(self, batch: int, dtype: torch.dtype, device: torch.device):
        return self.layer.init_recurrent_state(batch, dtype, device)

    def apply_seq(self, params, inputs, rstate, *, train=False, generator=None, masks=None):
        """``apply`` from the recurrent state ``rstate``: (the output, the
        new recurrent state). A bidirectional LSTM raises."""
        mask = None if masks is None else masks.get("features")
        return self.layer.apply_seq(params, self.layer_input(inputs), rstate, mask=mask,
                                    train=train, generator=generator)


@register_vertex
@dataclass
class ElementWiseVertex(BaseVertex):
    """Pointwise combine (reference: nn/conf/graph/ElementWiseVertex.java):
    add | subtract (2 inputs) | product | average | max."""

    op: str = "add"

    def get_output_type(self, *input_types: InputType) -> InputType:
        first = input_types[0]
        if any(t.example_shape() != first.example_shape() for t in input_types[1:]):
            raise ValueError("ElementWiseVertex inputs must have identical shapes, got "
                             f"{[it.example_shape() for it in input_types]}")
        if self.op.lower() == "subtract" and len(input_types) != 2:
            raise ValueError("ElementWise subtract requires exactly 2 inputs")
        return first

    def apply(self, params, inputs, state, *, train=False, generator=None, masks=None):
        op = self.op.lower()
        if op in ("add", "average"):
            out = inputs[0]
            for x in inputs[1:]:
                out = out + x
            return (out / len(inputs) if op == "average" else out), state
        if op == "subtract":
            if len(inputs) != 2:
                raise ValueError("subtract requires exactly 2 inputs")
            return inputs[0] - inputs[1], state
        if op == "product":
            out = inputs[0]
            for x in inputs[1:]:
                out = out * x
            return out, state
        if op == "max":
            out = inputs[0]
            for x in inputs[1:]:
                out = torch.maximum(out, x)
            return out, state
        raise ValueError(f"Unknown ElementWise op '{self.op}'")


@register_vertex
@dataclass
class MergeVertex(BaseVertex):
    """Concatenation on the last axis (reference: nn/conf/graph/MergeVertex.java):
    features of [b, f] and [b, t, f], channels of NHWC [b, h, w, c]."""

    def get_output_type(self, *input_types: InputType) -> InputType:
        first = input_types[0]
        if first.kind == "ff":
            return InputType.feed_forward(sum(t.size for t in input_types))
        if first.kind == "rnn":
            return InputType.recurrent(sum(t.size for t in input_types), first.timesteps)
        if first.kind == "cnn":
            return InputType.convolutional(first.height, first.width,
                                           sum(t.channels for t in input_types))
        if first.kind == "cnn_flat":
            # a flat concat is not a channel concat: an opaque feature vector
            return InputType.feed_forward(sum(t.flat_size() for t in input_types))
        raise ValueError(f"MergeVertex: unsupported input kind {first.kind}")

    def apply(self, params, inputs, state, *, train=False, generator=None, masks=None):
        return torch.cat(list(inputs), dim=-1), state


@register_vertex
@dataclass
class SubsetVertex(BaseVertex):
    """Feature range [from, to], inclusive, of the last axis (reference:
    nn/conf/graph/SubsetVertex.java)."""

    from_idx: int = 0
    to_idx: int = 0

    def get_output_type(self, *input_types: InputType) -> InputType:
        n = self.to_idx - self.from_idx + 1
        t = input_types[0]
        if t.kind in ("ff", "cnn_flat"):
            return InputType.feed_forward(n)
        if t.kind == "rnn":
            return InputType.recurrent(n, t.timesteps)
        if t.kind == "cnn":
            return InputType.convolutional(t.height, t.width, n)
        raise ValueError(f"SubsetVertex: unsupported input kind {t.kind}")

    def apply(self, params, inputs, state, *, train=False, generator=None, masks=None):
        return inputs[0][..., self.from_idx:self.to_idx + 1], state


@register_vertex
@dataclass
class StackVertex(BaseVertex):
    """Concatenation on the batch axis (reference: nn/conf/graph/StackVertex.java)."""

    def apply(self, params, inputs, state, *, train=False, generator=None, masks=None):
        return torch.cat(list(inputs), dim=0), state


@register_vertex
@dataclass
class UnstackVertex(BaseVertex):
    """Batch slice ``from_idx`` of ``stack_size`` equal slices (reference:
    nn/conf/graph/UnstackVertex.java), the inverse of StackVertex."""

    from_idx: int = 0
    stack_size: int = 1

    def apply(self, params, inputs, state, *, train=False, generator=None, masks=None):
        x = inputs[0]
        step = x.shape[0] // self.stack_size
        return x[self.from_idx * step:(self.from_idx + 1) * step], state


@register_vertex
@dataclass
class ScaleVertex(BaseVertex):
    """Times a fixed scalar (reference: nn/conf/graph/ScaleVertex.java)."""

    scale_factor: float = 1.0

    def apply(self, params, inputs, state, *, train=False, generator=None, masks=None):
        return inputs[0] * self.scale_factor, state


@register_vertex
@dataclass
class ShiftVertex(BaseVertex):
    """Plus a fixed scalar (reference: nn/conf/graph/ShiftVertex.java)."""

    shift: float = 0.0

    def apply(self, params, inputs, state, *, train=False, generator=None, masks=None):
        return inputs[0] + self.shift, state


@register_vertex
@dataclass
class L2Vertex(BaseVertex):
    """L2 distance of two inputs per example, [batch, 1] (reference:
    nn/conf/graph/L2Vertex.java); ``eps`` keeps the sqrt's gradient finite
    at distance 0."""

    eps: float = 1e-8

    def get_output_type(self, *input_types: InputType) -> InputType:
        return InputType.feed_forward(1)

    def apply(self, params, inputs, state, *, train=False, generator=None, masks=None):
        a, b = inputs
        d = (a - b).reshape(a.shape[0], -1)
        return torch.sqrt(torch.sum(d * d, dim=1, keepdim=True) + self.eps), state


@register_vertex
@dataclass
class L2NormalizeVertex(BaseVertex):
    """x / sqrt(||x||^2 + eps) over the non-batch axes (reference:
    nn/conf/graph/L2NormalizeVertex.java)."""

    eps: float = 1e-8

    def apply(self, params, inputs, state, *, train=False, generator=None, masks=None):
        x = inputs[0]
        flat = x.reshape(x.shape[0], -1)
        norm = torch.sqrt(torch.sum(flat * flat, dim=1) + self.eps)
        return x / norm.reshape((-1,) + (1,) * (x.dim() - 1)), state


@register_vertex
@dataclass
class PreprocessorVertex(BaseVertex):
    """An InputPreProcessor as a vertex (reference:
    nn/conf/graph/PreprocessorVertex.java)."""

    preprocessor: Optional[object] = None

    def to_dict(self) -> dict:
        return {"@type": "PreprocessorVertex", "preprocessor": self.preprocessor.to_dict()}

    @classmethod
    def _from_dict_fields(cls, d: dict) -> "PreprocessorVertex":
        return cls(preprocessor=preprocessor_from_dict(d["preprocessor"]))

    def get_output_type(self, *input_types: InputType) -> InputType:
        return self.preprocessor.get_output_type(input_types[0])

    def apply(self, params, inputs, state, *, train=False, generator=None, masks=None):
        return self.preprocessor.apply(inputs[0]), state


@register_vertex
@dataclass
class LastTimeStepVertex(BaseVertex):
    """[b, t, f] -> [b, f]: each example's last unmasked step (reference:
    nn/conf/graph/rnn/LastTimeStepVertex.java). ``mask_input`` names the
    network input whose [b, t] mask decides; without a mask the last step
    is taken, and a row with no live step takes the last step too."""

    mask_input: Optional[str] = None

    def get_output_type(self, *input_types: InputType) -> InputType:
        return InputType.feed_forward(input_types[0].size)

    def apply(self, params, inputs, state, *, train=False, generator=None, masks=None):
        x = inputs[0]
        mask = None
        if masks is not None and self.mask_input is not None:
            mask = masks.get(self.mask_input)
        if mask is None:
            return x[:, -1, :], state
        # the index of the last 1 of each row: argmax takes the first largest
        idx = x.shape[1] - 1 - torch.argmax(torch.flip(mask, dims=(1,)), dim=1)
        return x[torch.arange(x.shape[0], device=x.device), idx], state


@register_vertex
@dataclass
class DuplicateToTimeSeriesVertex(BaseVertex):
    """[b, f] -> [b, t, f], repeated over the time length of the network
    input ``ts_input`` (reference:
    nn/conf/graph/rnn/DuplicateToTimeSeriesVertex.java); the builder wires
    that input in as the vertex's second input."""

    ts_input: str = ""

    def get_output_type(self, *input_types: InputType) -> InputType:
        t = input_types[1].timesteps if len(input_types) > 1 else None
        return InputType.recurrent(input_types[0].size, t)

    def apply(self, params, inputs, state, *, train=False, generator=None, masks=None):
        x = inputs[0]
        return x[:, None, :].expand(x.shape[0], inputs[1].shape[1], x.shape[1]), state


@register_vertex
@dataclass
class ReshapeVertex(BaseVertex):
    """Reshape of the non-batch axes (reference: nn/conf/graph/ReshapeVertex.java)."""

    shape: Tuple[int, ...] = ()

    def get_output_type(self, *input_types: InputType) -> InputType:
        s = tuple(self.shape)
        if len(s) == 1:
            return InputType.feed_forward(s[0])
        if len(s) == 2:
            return InputType.recurrent(s[1], s[0])
        if len(s) == 3:
            return InputType.convolutional(s[0], s[1], s[2])
        raise ValueError(f"ReshapeVertex: unsupported target shape {s}")

    def apply(self, params, inputs, state, *, train=False, generator=None, masks=None):
        x = inputs[0]
        return x.reshape((x.shape[0],) + tuple(self.shape)), state
