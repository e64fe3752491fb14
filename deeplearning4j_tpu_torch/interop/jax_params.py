"""Carry weights over from the JAX package.

:func:`load_jax_params` fills a port net from the JAX net's ``params`` (a
tuple of per-layer dicts of arrays, e.g. ``jax_net.params``);
:func:`params_to_numpy` is the way back, for comparing trained params.
:func:`load_jax_model_zip` reads a zip written by the JAX package's
``utils/serialization.write_model`` (``configuration.json`` and
``coefficients.npz``) with zipfile and numpy only.
"""

from __future__ import annotations

import io
import json
import zipfile
from typing import Dict, List, Sequence

import numpy as np

from ..nn.conf.multi_layer import MultiLayerConfiguration
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
    JAX layout (what :func:`load_jax_params` takes)."""
    return [{k: v.detach().float().cpu().numpy() for k, v in p.items()}
            for p in net.layer_params]


def load_jax_model_zip(path: str, device="cuda") -> MultiLayerNetwork:
    """A port net from a JAX ``write_model`` zip of a MultiLayerNetwork."""
    with zipfile.ZipFile(path, "r") as zf:
        meta = json.loads(zf.read("meta.json"))
        if meta.get("model_class") != "MultiLayerNetwork":
            raise ValueError(f"{path}: model class {meta.get('model_class')!r} is "
                             "not ported (MultiLayerNetwork only)")
        conf = MultiLayerConfiguration.from_json(zf.read("configuration.json").decode())
        with zf.open("coefficients.npz") as f:
            data = np.load(io.BytesIO(f.read()))
            leaves = [data[f"leaf_{i}"] for i in range(len(data.files))]
    net = MultiLayerNetwork(conf, device=device).init()
    # the JAX leaves are tree_leaves of a tuple of dicts: layer by layer,
    # each dict in sorted key order
    keys = [sorted(p) for p in net.layer_params]
    if len(leaves) != sum(len(k) for k in keys):
        raise ValueError(f"{path}: {len(leaves)} leaves, the config expects "
                         f"{sum(len(k) for k in keys)}")
    it = iter(leaves)
    params = [{k: next(it) for k in layer_keys} for layer_keys in keys]
    return load_jax_params(net, params)
