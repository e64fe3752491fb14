"""Network configuration with JSON round-trip (counterpart of
``deeplearning4j_tpu/nn/conf/multi_layer.py``): the same JSON string
configures both packages.

``updater``, ``backprop_type``, ``tbptt_*`` and ``loss_scale`` are the
training settings ``MultiLayerNetwork.fit`` acts on; ``updater`` is kept
as the plain dict of the JSON, and an ``UpdaterConfig`` given in its place
(the JAX package's field) becomes its full dict. ``preprocessors`` maps a layer's index to the input
preprocessor that reshapes its input (``conf/preprocessors.py``). ``remat``
is kept as it is, not acted on.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from ..layers.base import BaseLayer, layer_from_dict
from ..updaters import UpdaterConfig
from .inputs import InputType
from .preprocessors import InputPreProcessor, preprocessor_from_dict


@dataclass
class MultiLayerConfiguration:
    """Sequential network config."""

    layers: List[BaseLayer] = field(default_factory=list)
    input_type: Optional[InputType] = None
    updater: dict = field(default_factory=dict)
    seed: int = 12345
    dtype: str = "float32"  # compute dtype: "float32" or "bfloat16"
    backprop_type: str = "standard"
    tbptt_fwd_length: int = 20
    tbptt_back_length: int = 20
    remat: bool = False
    params_dtype: Optional[str] = None  # "bfloat16" stores the params in bf16
    loss_scale: Optional[float] = None
    # per-layer-index input preprocessors (reference: nn/conf/preprocessor/*);
    # stored as {"idx": {"@type": ...}} in JSON
    preprocessors: Dict[int, InputPreProcessor] = field(default_factory=dict)

    def __post_init__(self):
        if isinstance(self.updater, UpdaterConfig):
            self.updater = self.updater.to_dict()

    def layer_input_types(self) -> List[InputType]:
        """InputType seen by each layer (preprocessors applied)."""
        if self.input_type is None:
            raise ValueError("input_type must be set for shape inference")
        its: List[InputType] = []
        cur = self.input_type
        for i, layer in enumerate(self.layers):
            pre = self.preprocessors.get(i)
            if pre is not None:
                cur = pre.get_output_type(cur)
            its.append(cur)
            cur = layer.get_output_type(cur)
        return its

    def output_type(self) -> InputType:
        """InputType the last layer produces."""
        its = self.layer_input_types()
        return self.layers[-1].get_output_type(its[-1])

    def to_dict(self) -> dict:
        return {
            "layers": [l.to_dict() for l in self.layers],
            "input_type": self.input_type.to_dict() if self.input_type else None,
            "updater": dict(self.updater),
            "seed": self.seed,
            "dtype": self.dtype,
            "backprop_type": self.backprop_type,
            "tbptt_fwd_length": self.tbptt_fwd_length,
            "tbptt_back_length": self.tbptt_back_length,
            "remat": self.remat,
            "params_dtype": self.params_dtype,
            "loss_scale": self.loss_scale,
            "preprocessors": {str(k): v.to_dict() for k, v in self.preprocessors.items()},
        }

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=2)

    @staticmethod
    def from_dict(d: dict) -> "MultiLayerConfiguration":
        return MultiLayerConfiguration(
            layers=[layer_from_dict(ld) for ld in d["layers"]],
            input_type=InputType.from_dict(d["input_type"]) if d.get("input_type") else None,
            updater=dict(d.get("updater") or {}),
            seed=d.get("seed", 12345),
            dtype=d.get("dtype", "float32"),
            backprop_type=d.get("backprop_type", "standard"),
            tbptt_fwd_length=d.get("tbptt_fwd_length", 20),
            tbptt_back_length=d.get("tbptt_back_length", 20),
            remat=d.get("remat", False),
            params_dtype=d.get("params_dtype"),
            loss_scale=d.get("loss_scale"),
            preprocessors={int(k): preprocessor_from_dict(v)
                           for k, v in (d.get("preprocessors") or {}).items()},
        )

    @staticmethod
    def from_json(s: str) -> "MultiLayerConfiguration":
        return MultiLayerConfiguration.from_dict(json.loads(s))
