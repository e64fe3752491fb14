"""Transfer learning: surgery on trained networks (counterpart of
``deeplearning4j_tpu/nn/transferlearning.py``; reference:
nn/transferlearning/TransferLearning.java, FineTuneConfiguration.java).

A builder copies a trained network's configuration, params and layer state;
its operations freeze a feature-extractor prefix (``FrozenLayer``
wrappers), remove or add layers and change a layer's ``n_out``; ``build()``
gives a new network on the same device with a fresh updater state and no
captured steps, whose frozen params training leaves bit for bit as they
are. Params are carried over except where the surgery makes them stale:
new layers, and a layer whose ``n_out`` changed together with the layers
that read it, are initialized from a generator seeded by the configuration's
seed, in layer (or topological) order. Layer state (BatchNormalization's
running mean and variance) is carried with the params.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

import torch

from .conf.computation_graph import ComputationGraphConfiguration
from .conf.multi_layer import MultiLayerConfiguration
from .graph.computation_graph import ComputationGraph
from .graph.vertices import LayerVertex
from .layers.base import BaseLayer
from .layers.frozen import FrozenLayer
from .multilayer import MultiLayerNetwork
from .updaters import UpdaterConfig


def _copies(tensors: dict) -> dict:
    return {k: v.detach().clone() for k, v in tensors.items()}


def _updater_dict(updater) -> dict:
    """An ``UpdaterConfig``, its dict or an updater's name as the full JSON
    dict that configurations hold."""
    if isinstance(updater, UpdaterConfig):
        return updater.to_dict()
    if isinstance(updater, str):
        return UpdaterConfig(updater=updater).to_dict()
    return UpdaterConfig.from_dict(updater).to_dict()


@dataclass
class FineTuneConfiguration:
    """Training settings that replace the copied configuration's
    (reference: FineTuneConfiguration.java). ``updater`` is an
    ``UpdaterConfig``, its dict or an updater's name."""

    updater: Optional[Any] = None
    seed: Optional[int] = None
    dtype: Optional[str] = None

    def apply(self, conf) -> None:
        if self.updater is not None:
            conf.updater = _updater_dict(self.updater)
        if self.seed is not None:
            conf.seed = self.seed
        if self.dtype is not None:
            conf.dtype = self.dtype


class TransferLearningBuilder:
    """Reference: TransferLearning.Builder. Operations apply at ``build()``;
    ``n_out_replace`` re-initializes the changed layer and the next one,
    whose input weights it makes stale."""

    def __init__(self, net: MultiLayerNetwork):
        net.init()
        self._net = net
        self._conf = MultiLayerConfiguration.from_dict(net.conf.to_dict())
        self._params = [_copies(p) for p in net._leaves()]
        self._states = [_copies(s) for s in net.state]
        self._fine_tune: Optional[FineTuneConfiguration] = None
        self._freeze_until: Optional[int] = None
        self._reinit: set = set()

    def fine_tune_configuration(self, cfg: FineTuneConfiguration) -> "TransferLearningBuilder":
        self._fine_tune = cfg
        return self

    def set_feature_extractor(self, layer_idx: int) -> "TransferLearningBuilder":
        """Freeze layers [0, layer_idx] (reference: setFeatureExtractor)."""
        self._freeze_until = layer_idx
        return self

    def remove_output_layer(self) -> "TransferLearningBuilder":
        return self.remove_layers_from_output(1)

    def remove_layers_from_output(self, n: int) -> "TransferLearningBuilder":
        for _ in range(n):
            self._conf.layers.pop()
            self._params.pop()
            self._states.pop()
        return self

    def add_layer(self, layer: BaseLayer) -> "TransferLearningBuilder":
        self._conf.layers.append(layer)
        self._params.append(None)  # initialized at build
        self._states.append(None)
        return self

    def n_out_replace(self, layer_idx: int, n_out: int,
                      weight_init: Optional[str] = None) -> "TransferLearningBuilder":
        """Change layer ``layer_idx``'s n_out, re-initializing it and the
        next layer (reference: nOutReplace)."""
        layer = self._conf.layers[layer_idx]
        layer.n_out = int(n_out)
        if weight_init is not None:
            layer.weight_init = weight_init
        self._reinit.add(layer_idx)
        if layer_idx + 1 < len(self._conf.layers):
            nxt = self._conf.layers[layer_idx + 1]
            if hasattr(nxt, "n_in"):
                nxt.n_in = int(n_out)
            self._reinit.add(layer_idx + 1)
        return self

    def _kept(self, i: int, carried: list):
        ok = i < len(carried) and carried[i] is not None and i not in self._reinit
        return carried[i] if ok else None

    def build(self) -> MultiLayerNetwork:
        conf = self._conf
        if self._fine_tune is not None:
            self._fine_tune.apply(conf)
        if self._freeze_until is not None:
            for i in range(min(self._freeze_until + 1, len(conf.layers))):
                if not isinstance(conf.layers[i], FrozenLayer):
                    conf.layers[i] = FrozenLayer(layer=conf.layers[i])
        gen = torch.Generator().manual_seed(conf.seed)
        params = []
        for i, (layer, it) in enumerate(zip(conf.layers, conf.layer_input_types())):
            kept = self._kept(i, self._params)
            params.append(_copies(kept) if kept is not None else layer.init_params(gen, it))
        net = MultiLayerNetwork(conf, device=self._net.device,
                                lstm_variant=self._net.lstm_variant).init(params=params)
        states = [self._kept(i, self._states) for i in range(len(conf.layers))]
        net.state = tuple(fresh if kept is None else net._device_state(kept)
                          for fresh, kept in zip(net.state, states))
        return net


class TransferLearningGraphBuilder:
    """Vertex surgery on a trained ComputationGraph (reference:
    TransferLearning.GraphBuilder): ``fine_tune_configuration``,
    ``set_feature_extractor(*names)`` (freezes the named vertices and every
    vertex on a path from an input to them), ``remove_vertex_and_connections``,
    ``remove_vertex_keep_connections``, ``add_layer``/``add_vertex``,
    ``n_out_replace`` (re-initializes the changed layer and the layers that
    read it) and ``set_outputs``."""

    def __init__(self, net: ComputationGraph):
        net.init()
        self._net = net
        self._conf = ComputationGraphConfiguration.from_dict(net.conf.to_dict())
        self._params = {k: _copies(v) for k, v in net.vertex_params.items()}
        # layer state (BN running mean/var) survives the surgery: a frozen
        # extractor run with fresh 0/1 statistics would change its outputs
        self._state = {k: _copies(v) for k, v in net.state.items()}
        self._fine_tune: Optional[FineTuneConfiguration] = None
        self._freeze: set = set()
        self._reinit: set = set()
        self._kept_connections: dict = {}

    def fine_tune_configuration(self, cfg: FineTuneConfiguration
                                ) -> "TransferLearningGraphBuilder":
        self._fine_tune = cfg
        return self

    def set_feature_extractor(self, *vertex_names: str) -> "TransferLearningGraphBuilder":
        """Freeze the named vertices and everything between them and the
        network's inputs (reference: GraphBuilder.setFeatureExtractor)."""
        missing = [n for n in vertex_names if n not in self._conf.vertices]
        if missing:
            raise ValueError(f"Unknown vertices: {missing}")
        self._freeze.update(vertex_names)
        return self

    def remove_vertex_and_connections(self, name: str) -> "TransferLearningGraphBuilder":
        """Remove the vertex and every edge touching it (reference:
        removeVertexAndConnections); the vertices that read it must be
        re-wired before ``build()``."""
        self._drop_vertex(name)
        for ins in self._conf.vertex_inputs.values():
            while name in ins:
                ins.remove(name)
        return self

    def remove_vertex_keep_connections(self, name: str) -> "TransferLearningGraphBuilder":
        """Remove the vertex but remember its edges: a vertex added again
        under the same name without inputs takes them (reference:
        removeVertexKeepConnections)."""
        self._kept_connections[name] = (list(self._conf.vertex_inputs.get(name, [])),
                                        name in self._conf.network_outputs)
        self._drop_vertex(name)
        return self

    def _drop_vertex(self, name: str) -> None:
        if name not in self._conf.vertices:
            raise ValueError(f"Unknown vertex '{name}'")
        del self._conf.vertices[name]
        self._conf.vertex_inputs.pop(name, None)
        self._params.pop(name, None)
        self._reinit.discard(name)
        if name in self._conf.network_outputs:
            self._conf.network_outputs.remove(name)

    def add_layer(self, name: str, layer: BaseLayer, *inputs: str
                  ) -> "TransferLearningGraphBuilder":
        return self.add_vertex(name, LayerVertex(layer=layer), *inputs)

    def add_vertex(self, name: str, vertex, *inputs: str) -> "TransferLearningGraphBuilder":
        if not inputs and name in self._kept_connections:
            kept_inputs, was_output = self._kept_connections.pop(name)
            inputs = tuple(kept_inputs)
            if was_output and name not in self._conf.network_outputs:
                self._conf.network_outputs.append(name)
        if not inputs:
            raise ValueError(
                f"Vertex '{name}' needs inputs (none given and no kept connections)")
        self._conf.vertices[name] = vertex
        self._conf.vertex_inputs[name] = list(inputs)
        self._reinit.add(name)
        return self

    def n_out_replace(self, name: str, n_out: int, weight_init: Optional[str] = None
                      ) -> "TransferLearningGraphBuilder":
        """Change a layer vertex's n_out, re-initializing it and the layers
        that read it (reference: GraphBuilder.nOutReplace)."""
        layer = getattr(self._conf.vertices.get(name), "layer", None)
        if layer is None:
            raise ValueError(f"'{name}' is not a layer vertex")
        layer.n_out = int(n_out)
        if weight_init is not None:
            layer.weight_init = weight_init
        self._reinit.add(name)
        for cname, ins in self._conf.vertex_inputs.items():
            if name in ins:
                consumer = getattr(self._conf.vertices[cname], "layer", None)
                if consumer is None:
                    raise ValueError(
                        f"n_out_replace('{name}'): consumer '{cname}' is not a "
                        "layer vertex; its downstream widths cannot be fixed up "
                        "automatically - remove and re-add that subgraph instead")
                if hasattr(consumer, "n_in"):
                    consumer.n_in = int(n_out)
                self._reinit.add(cname)
        return self

    def set_outputs(self, *names: str) -> "TransferLearningGraphBuilder":
        self._conf.network_outputs = list(names)
        return self

    def _frozen_closure(self) -> set:
        """The freeze set and all its ancestors (the paths back to the
        inputs)."""
        closure, stack = set(), list(self._freeze)
        while stack:
            n = stack.pop()
            if n in closure or n not in self._conf.vertices:
                continue
            closure.add(n)
            stack.extend(self._conf.vertex_inputs.get(n, []))
        return closure

    def build(self) -> ComputationGraph:
        conf = self._conf
        if self._fine_tune is not None:
            self._fine_tune.apply(conf)
        for name in self._frozen_closure():
            v = conf.vertices[name]
            if isinstance(v, LayerVertex) and not isinstance(v.layer, FrozenLayer):
                v.layer = FrozenLayer(layer=v.layer)
        dangling = {}
        for name, ins in conf.vertex_inputs.items():
            missing = [s for s in ins
                       if s not in conf.vertices and s not in conf.network_inputs]
            if missing or not ins:
                dangling[name] = missing or ["<no inputs>"]
        if dangling:
            raise ValueError(f"Vertices with removed inputs not re-wired: {dangling}")
        unknown_outputs = [o for o in conf.network_outputs if o not in conf.vertices]
        if unknown_outputs:
            raise ValueError(f"set_outputs names are not vertices: {unknown_outputs}")
        vit = conf.vertex_input_types()
        gen = torch.Generator().manual_seed(conf.seed)
        params = {}
        for name in conf.topological_order():
            if name in self._params and name not in self._reinit:
                params[name] = _copies(self._params[name])
            else:
                params[name] = conf.vertices[name].init_params(gen, *vit[name])
        net = ComputationGraph(conf, device=self._net.device).init(params=params)
        # the carried layer state (BN running stats) over the fresh one
        net.state = {name: (net._device_state(self._state[name])
                            if name in self._state and name not in self._reinit
                            else net.state[name])
                     for name in net.state}
        return net


class TransferLearning:
    """The reference's entry point: ``TransferLearning.Builder(net)`` and
    ``TransferLearning.GraphBuilder(graph)``."""

    Builder = TransferLearningBuilder
    GraphBuilder = TransferLearningGraphBuilder
