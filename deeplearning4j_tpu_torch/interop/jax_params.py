"""Carry weights over from the JAX package.

:func:`load_jax_params` fills a port net from the JAX net's ``params``: for
a ``MultiLayerNetwork`` a tuple of per-layer dicts of arrays (e.g.
``jax_net.params``), for a ``ComputationGraph`` a dict of vertex name to
dict of arrays. :func:`params_to_numpy` is the way back, for comparing
trained params. :func:`load_jax_model_zip` reads a zip written by the JAX
package's ``utils/serialization.write_model``, of either network, through
the port's one zip reader, ``utils.serialization.restore_model``.
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


def load_jax_params(net: BaseNetwork, params) -> BaseNetwork:
    """Fill ``net``'s params from the JAX layout (same keys, same shapes per
    layer or vertex) and return ``net``. Shapes are checked against the
    port's own init, so a config mismatch raises instead of loading."""
    net.init()
    if isinstance(net, ComputationGraph):
        unknown = sorted(set(params) - set(net.vertex_params))
        if unknown:
            raise ValueError(f"params for vertices the graph does not have: {unknown}")
        return net.init(params={
            name: _checked(f"vertex {name}", mine, params.get(name, {}))
            for name, mine in net.vertex_params.items()})
    if len(params) != len(net.layer_params):
        raise ValueError(f"{len(params)} param dicts for {len(net.layer_params)} layers")
    return net.init(params=[_checked(f"layer {i}", mine, theirs)
                            for i, (mine, theirs) in enumerate(zip(net.layer_params, params))])


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


def load_jax_model_zip(path: str, device="cuda") -> BaseNetwork:
    """A port net from a JAX ``write_model`` zip of a MultiLayerNetwork or a
    ComputationGraph, its updater state, iteration and epoch included."""
    from ..utils.serialization import restore_model  # noqa: PLC0415 - it imports this module

    return restore_model(path, device=device)
