"""Carry weights over from the JAX package.

:func:`load_jax_params` fills a port net from the JAX net's ``params`` (a
tuple of per-layer dicts of arrays, e.g. ``jax_net.params``);
:func:`params_to_numpy` is the way back, for comparing trained params.
:func:`load_jax_model_zip` reads a zip written by the JAX package's
``utils/serialization.write_model`` through the port's one zip reader,
``utils.serialization.restore_model``.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

from ..nn.multilayer import MultiLayerNetwork


def _host_f32(a) -> np.ndarray:
    """A host array as float32: f64 (x64 mode) and bf16 both convert."""
    return np.asarray(a).astype(np.float32)


def load_jax_params(net: MultiLayerNetwork,
                    params: Sequence[dict]) -> MultiLayerNetwork:
    """Fill ``net``'s params from the JAX layout (same keys, same shapes per
    layer) and return ``net``. Shapes are checked against the port's own
    init, so a config mismatch raises instead of loading."""
    net.init()
    if len(params) != len(net.layer_params):
        raise ValueError(f"{len(params)} param dicts for {len(net.layer_params)} layers")
    host = []
    for i, (mine, theirs) in enumerate(zip(net.layer_params, params)):
        if set(mine) != set(theirs):
            raise ValueError(f"layer {i}: keys {sorted(theirs)}, expected {sorted(mine)}")
        layer = {}
        for k, v in theirs.items():
            a = _host_f32(v)
            if tuple(a.shape) != tuple(mine[k].shape):
                raise ValueError(f"layer {i} {k}: shape {a.shape}, "
                                 f"expected {tuple(mine[k].shape)}")
            layer[k] = a
        host.append(layer)
    return net.init(params=host)


def params_to_numpy(net: MultiLayerNetwork) -> List[Dict[str, np.ndarray]]:
    """The net's params as one dict of host float32 arrays per layer, in the
    JAX layout (what :func:`load_jax_params` takes): copies, which later
    updates of the net leave as they are."""
    return [{k: np.array(v.detach().float().cpu().numpy()) for k, v in p.items()}
            for p in net.layer_params]


def load_jax_model_zip(path: str, device="cuda") -> MultiLayerNetwork:
    """A port net from a JAX ``write_model`` zip of a MultiLayerNetwork, its
    updater state, iteration and epoch included."""
    from ..utils.serialization import restore_model  # noqa: PLC0415 - it imports this module

    return restore_model(path, device=device)
