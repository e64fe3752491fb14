"""Carry weights over from the JAX package.

:func:`load_jax_params` fills a port net from the JAX net's ``params``: for
a ``MultiLayerNetwork`` a tuple of per-layer dicts of arrays (e.g.
``jax_net.params``), for a ``ComputationGraph`` a dict of vertex name to
dict of arrays; and, given the JAX net's ``state`` in the same layout, its
layer state (BatchNormalization's running mean and variance), which
:func:`load_jax_state` sets alone. :func:`params_to_numpy` and
:func:`state_to_numpy` are the way back, for comparing trained nets.
:func:`load_jax_model_zip` reads a zip written by the JAX package's
``utils/serialization.write_model``, of either network, through the port's
one zip reader, ``utils.serialization.restore_model``. Every array is
carried as float32 (the JAX package's are float64 under x64).
"""

from __future__ import annotations

from typing import Dict, List, Union

import numpy as np

from ..nn.graph.computation_graph import ComputationGraph
from ..nn.multilayer import BaseNetwork

HostParams = Dict[str, np.ndarray]


def _host_f32(a) -> np.ndarray:
    """A host array as float32: f64 (x64 mode) and bf16 both convert."""
    return np.asarray(a).astype(np.float32)


def _checked(where: str, mine, theirs) -> HostParams:
    """``theirs`` as host f32 arrays, with the keys and shapes of ``mine``."""
    if set(mine) != set(theirs):
        raise ValueError(f"{where}: keys {sorted(theirs)}, expected {sorted(mine)}")
    out = {}
    for k, v in theirs.items():
        a = _host_f32(v)
        if tuple(a.shape) != tuple(mine[k].shape):
            raise ValueError(f"{where} {k}: shape {a.shape}, expected {tuple(mine[k].shape)}")
        out[k] = a
    return out


def _checked_tree(net: BaseNetwork, mine, theirs, what: str):
    """``theirs`` (the JAX layout of ``what``: one dict per layer, or vertex
    name to dict) checked against ``mine`` (the port's, in the same
    layout), as host f32 arrays in that layout."""
    if isinstance(net, ComputationGraph):
        unknown = sorted(set(theirs) - set(mine))
        if unknown:
            raise ValueError(f"{what} for vertices the graph does not have: {unknown}")
        return {name: _checked(f"vertex {name}", m, theirs.get(name, {}))
                for name, m in mine.items()}
    if len(theirs) != len(mine):
        raise ValueError(f"{len(theirs)} {what} dicts for {len(mine)} layers")
    return [_checked(f"layer {i}", m, t) for i, (m, t) in enumerate(zip(mine, theirs))]


def _state_tree(net: BaseNetwork):
    return dict(net.state) if isinstance(net, ComputationGraph) else list(net.state)


def load_jax_params(net: BaseNetwork, params, state=None) -> BaseNetwork:
    """Fill ``net``'s params (and, given ``state``, its layer state) from
    the JAX layout (same keys, same shapes per layer or vertex) and return
    ``net``. Shapes are checked against the port's own init, so a config
    mismatch raises instead of loading. Without ``state`` the layer state
    is the initial one."""
    net.init()
    mine = (net.vertex_params if isinstance(net, ComputationGraph)
            else list(net.layer_params))
    net.init(params=_checked_tree(net, mine, params, "params"))
    if state is not None:
        load_jax_state(net, state)
    return net


def load_jax_state(net: BaseNetwork, state) -> BaseNetwork:
    """Set ``net``'s layer state from the JAX net's ``state`` (a tuple of
    per-layer dicts, or vertex name to dict; vertices without state may be
    left out) and return ``net``."""
    net.init()
    tree = _checked_tree(net, _state_tree(net), state, "state")
    dicts = [tree[n] for n in net._names] if isinstance(net, ComputationGraph) else tree
    net.set_state_leaves([d[k] for d in dicts for k in sorted(d)])
    return net


def _to_numpy(p) -> HostParams:
    return {k: np.array(v.detach().float().cpu().numpy()) for k, v in p.items()}


def params_to_numpy(net: BaseNetwork) -> Union[List[HostParams], Dict[str, HostParams]]:
    """The net's params as host float32 arrays in the JAX layout (what
    :func:`load_jax_params` takes): one dict per layer, or vertex name to
    dict for a graph. Copies, which later updates of the net leave as they
    are."""
    if isinstance(net, ComputationGraph):
        return {name: _to_numpy(p) for name, p in net.vertex_params.items()}
    return [_to_numpy(p) for p in net.layer_params]


def state_to_numpy(net: BaseNetwork) -> Union[List[HostParams], Dict[str, HostParams]]:
    """The net's layer state as host float32 arrays in the JAX layout (what
    :func:`load_jax_state` takes): one dict per layer, or vertex name to
    dict for a graph, {} for layers without state. Copies."""
    net.init()
    tree = _state_tree(net)
    if isinstance(net, ComputationGraph):
        return {name: _to_numpy(d) for name, d in tree.items()}
    return [_to_numpy(d) for d in tree]


def load_jax_model_zip(path: str, device="cuda") -> BaseNetwork:
    """A port net from a JAX ``write_model`` zip of a MultiLayerNetwork or a
    ComputationGraph, its updater state, layer state, iteration and epoch
    included."""
    from ..utils.serialization import restore_model  # noqa: PLC0415 - it imports this module

    return restore_model(path, device=device)
