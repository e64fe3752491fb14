"""ComputationGraph configuration: a DAG as data, with JSON round-trip
(counterpart of ``deeplearning4j_tpu/nn/conf/computation_graph.py``): the
same JSON string configures both packages.

The graph is named vertices, their input lists and the network's named
inputs and outputs. ``topological_order`` (Kahn's algorithm, by insertion
order) drives shape inference, the order in which ``ComputationGraph``
draws each vertex's initial params, and the forward. ``updater`` is kept as
the plain dict of the JSON, as ``MultiLayerConfiguration`` keeps it;
``remat`` is kept as it is, not acted on.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from ..graph.vertices import BaseVertex, DuplicateToTimeSeriesVertex, LayerVertex, vertex_from_dict
from ..layers.base import BaseLayer
from ..updaters import UpdaterConfig
from .inputs import InputType


def _updater_dict(updater) -> dict:
    """An updater (an ``UpdaterConfig`` or its dict) as the full JSON dict."""
    if isinstance(updater, UpdaterConfig):
        return updater.to_dict()
    return UpdaterConfig.from_dict(updater or {}).to_dict()


@dataclass
class ComputationGraphConfiguration:
    """DAG network config (reference: ComputationGraphConfiguration.java)."""

    network_inputs: List[str] = field(default_factory=list)
    network_outputs: List[str] = field(default_factory=list)
    input_types: List[InputType] = field(default_factory=list)
    # insertion-ordered: name -> vertex; name -> list of input names
    vertices: Dict[str, BaseVertex] = field(default_factory=dict)
    vertex_inputs: Dict[str, List[str]] = field(default_factory=dict)
    updater: dict = field(default_factory=lambda: UpdaterConfig().to_dict())
    seed: int = 12345
    dtype: str = "float32"  # compute dtype: "float32" or "bfloat16"
    backprop_type: str = "standard"
    tbptt_fwd_length: int = 20
    tbptt_back_length: int = 20
    remat: bool = False
    params_dtype: Optional[str] = None  # "bfloat16" stores the params in bf16
    loss_scale: Optional[float] = None

    # ------------------------------------------------------------- topo order
    def topological_order(self) -> List[str]:
        """Kahn's algorithm, deterministic by insertion order (reference:
        ComputationGraph.topologicalSortOrder()). Raises on an input that
        is neither a vertex nor a network input, and on a cycle."""
        in_deg = {name: 0 for name in self.vertices}
        dependents: Dict[str, List[str]] = {name: [] for name in self.vertices}
        for name, ins in self.vertex_inputs.items():
            for src in ins:
                if src in self.vertices:
                    in_deg[name] += 1
                    dependents[src].append(name)
                elif src not in self.network_inputs:
                    raise ValueError(
                        f"Vertex '{name}' input '{src}' is neither a vertex nor a network input")
        ready = [n for n in self.vertices if in_deg[n] == 0]
        order: List[str] = []
        while ready:
            n = ready.pop(0)
            order.append(n)
            for dep in dependents[n]:
                in_deg[dep] -= 1
                if in_deg[dep] == 0:
                    ready.append(dep)
        if len(order) != len(self.vertices):
            cyc = sorted(set(self.vertices) - set(order))
            raise ValueError(f"Graph has a cycle involving: {cyc}")
        return order

    # -------------------------------------------------------- shape inference
    def _propagate(self):
        """(InputTypes each vertex sees, the output type of every vertex and
        network input), in topological order."""
        if len(self.input_types) != len(self.network_inputs):
            raise ValueError(
                f"{len(self.network_inputs)} network inputs but {len(self.input_types)} "
                "input types; call set_input_types")
        known: Dict[str, InputType] = dict(zip(self.network_inputs, self.input_types))
        seen: Dict[str, List[InputType]] = {}
        for name in self.topological_order():
            ins = [known[src] for src in self.vertex_inputs[name]]
            seen[name] = ins
            known[name] = self.vertices[name].get_output_type(*ins)
        return seen, known

    def vertex_input_types(self) -> Dict[str, List[InputType]]:
        """InputTypes seen by each vertex, propagated in topological order."""
        return self._propagate()[0]

    def output_types(self) -> List[InputType]:
        known = self._propagate()[1]
        return [known[o] for o in self.network_outputs]

    # ------------------------------------------------------------------- JSON
    def to_dict(self) -> dict:
        return {
            "network_inputs": list(self.network_inputs),
            "network_outputs": list(self.network_outputs),
            "input_types": [t.to_dict() for t in self.input_types],
            "vertices": {k: v.to_dict() for k, v in self.vertices.items()},
            "vertex_inputs": {k: list(v) for k, v in self.vertex_inputs.items()},
            "updater": dict(self.updater),
            "seed": self.seed,
            "dtype": self.dtype,
            "backprop_type": self.backprop_type,
            "tbptt_fwd_length": self.tbptt_fwd_length,
            "tbptt_back_length": self.tbptt_back_length,
            "remat": self.remat,
            "params_dtype": self.params_dtype,
            "loss_scale": self.loss_scale,
        }

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=2)

    @staticmethod
    def from_dict(d: dict) -> "ComputationGraphConfiguration":
        return ComputationGraphConfiguration(
            network_inputs=list(d["network_inputs"]),
            network_outputs=list(d["network_outputs"]),
            input_types=[InputType.from_dict(t) for t in d.get("input_types", [])],
            vertices={k: vertex_from_dict(v) for k, v in d["vertices"].items()},
            vertex_inputs={k: list(v) for k, v in d["vertex_inputs"].items()},
            updater=_updater_dict(d.get("updater")),
            seed=d.get("seed", 12345),
            dtype=d.get("dtype", "float32"),
            backprop_type=d.get("backprop_type", "standard"),
            tbptt_fwd_length=d.get("tbptt_fwd_length", 20),
            tbptt_back_length=d.get("tbptt_back_length", 20),
            remat=d.get("remat", False),
            params_dtype=d.get("params_dtype"),
            loss_scale=d.get("loss_scale"),
        )

    @staticmethod
    def from_json(s: str) -> "ComputationGraphConfiguration":
        return ComputationGraphConfiguration.from_dict(json.loads(s))

    @staticmethod
    def builder() -> "GraphBuilder":
        return GraphBuilder()


class GraphBuilder:
    """Fluent DAG builder (reference: ComputationGraphConfiguration.GraphBuilder)."""

    def __init__(self):
        self._conf = ComputationGraphConfiguration()

    def add_inputs(self, *names: str) -> "GraphBuilder":
        self._conf.network_inputs.extend(names)
        return self

    def set_input_types(self, *types: InputType) -> "GraphBuilder":
        self._conf.input_types = list(types)
        return self

    def add_layer(self, name: str, layer: BaseLayer, *inputs: str,
                  preprocessor=None) -> "GraphBuilder":
        """reference: GraphBuilder.addLayer(name, layer, preprocessor, inputs)"""
        return self.add_vertex(name, LayerVertex(layer=layer, preprocessor=preprocessor),
                               *inputs)

    def add_vertex(self, name: str, vertex: BaseVertex, *inputs: str) -> "GraphBuilder":
        if name in self._conf.vertices or name in self._conf.network_inputs:
            raise ValueError(f"Duplicate vertex/input name '{name}'")
        ins = list(inputs)
        # DuplicateToTimeSeries reads its time length from the named input's
        # activation: wired in as a real edge
        if (isinstance(vertex, DuplicateToTimeSeriesVertex) and vertex.ts_input
                and vertex.ts_input not in ins):
            ins.append(vertex.ts_input)
        self._conf.vertices[name] = vertex
        self._conf.vertex_inputs[name] = ins
        return self

    def set_outputs(self, *names: str) -> "GraphBuilder":
        self._conf.network_outputs = list(names)
        return self

    def updater(self, updater) -> "GraphBuilder":
        """An ``UpdaterConfig`` or its JSON dict."""
        self._conf.updater = _updater_dict(updater)
        return self

    def seed(self, seed: int) -> "GraphBuilder":
        self._conf.seed = seed
        return self

    def dtype(self, dtype: str) -> "GraphBuilder":
        self._conf.dtype = dtype
        return self

    def remat(self, enabled: bool = True) -> "GraphBuilder":
        self._conf.remat = enabled
        return self

    def params_dtype(self, dtype: Optional[str]) -> "GraphBuilder":
        self._conf.params_dtype = dtype
        return self

    def tbptt(self, fwd_length: int, back_length: Optional[int] = None) -> "GraphBuilder":
        self._conf.backprop_type = "tbptt"
        self._conf.tbptt_fwd_length = fwd_length
        self._conf.tbptt_back_length = back_length or fwd_length
        return self

    def build(self) -> ComputationGraphConfiguration:
        """The config, validated: inputs and outputs named, every output a
        vertex, every edge known, no cycle, and shapes that propagate."""
        conf = self._conf
        if not conf.network_inputs:
            raise ValueError("Graph has no network inputs (add_inputs)")
        if not conf.network_outputs:
            raise ValueError("Graph has no network outputs (set_outputs)")
        for o in conf.network_outputs:
            if o not in conf.vertices:
                raise ValueError(f"Output '{o}' is not a vertex")
        conf.topological_order()
        if conf.input_types:
            conf.vertex_input_types()
        return conf
