"""Checkpoints in the JAX package's zip layout (counterpart of
``deeplearning4j_tpu/utils/serialization.py``).

The zip holds ``configuration.json`` (the config's JSON), ``coefficients.npz``
(the param leaves), ``updaterState.npz`` (the leaves of the optax updater
state), ``state.npz`` (the layer state: BatchNormalization's running mean
and variance) and ``meta.json`` (model class, iteration, epoch). Leaves are
stored as ``leaf_i`` in ``jax.tree_util.tree_leaves`` order: layer by
layer, each layer's dict in sorted key order; for a ``ComputationGraph``,
vertex by vertex in sorted name order, each in sorted key order ("mean"
before "var"). bf16 leaves are widened to f32, which is
lossless, and cast back to the model's dtype on restore; the Adam and
schedule counts are int32. A zip written by either package restores in the
other, and training resumes from it with the updater and layer state it
had.
"""

from __future__ import annotations

import io
import json
import zipfile
from typing import List

import numpy as np
import torch

from ..interop.jax_params import load_jax_params
from ..nn.conf.computation_graph import ComputationGraphConfiguration
from ..nn.conf.multi_layer import MultiLayerConfiguration
from ..nn.graph.computation_graph import ComputationGraph
from ..nn.multilayer import BaseNetwork, MultiLayerNetwork

# model class (meta.json's model_class) -> (network, its configuration)
_MODELS = {"MultiLayerNetwork": (MultiLayerNetwork, MultiLayerConfiguration),
           "ComputationGraph": (ComputationGraph, ComputationGraphConfiguration)}


def _storable(leaf) -> np.ndarray:
    """A leaf as a host array np.savez round-trips: bf16 widened to f32."""
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach().cpu()
        return (leaf.float() if leaf.dtype == torch.bfloat16 else leaf).numpy()
    return np.asarray(leaf)


def _save_leaves(zf: zipfile.ZipFile, name: str, leaves) -> None:
    buf = io.BytesIO()
    np.savez(buf, **{f"leaf_{i}": _storable(l) for i, l in enumerate(leaves)})
    zf.writestr(name, buf.getvalue())


def _load_leaves(zf: zipfile.ZipFile, name: str) -> List[np.ndarray]:
    with zf.open(name) as f:
        data = np.load(io.BytesIO(f.read()))
        return [data[f"leaf_{i}"] for i in range(len(data.files))]


def write_model(net: BaseNetwork, path: str) -> None:
    """Save a MultiLayerNetwork or ComputationGraph with its updater state,
    layer state, iteration and epoch (reference: ModelSerializer.writeModel).
    ``net`` may also be a snapshot proxy (``runtime.checkpoint``'s): anything
    with ``init``, ``conf``, ``_leaves``, ``updater_state_leaves``,
    ``state_leaves``, ``iteration``, ``epoch`` and a ``model_class`` naming
    the real class."""
    net.init()
    with zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED) as zf:
        zf.writestr("configuration.json", net.conf.to_json())
        _save_leaves(zf, "coefficients.npz",
                     [layer[k] for layer in net._leaves() for k in sorted(layer)])
        _save_leaves(zf, "updaterState.npz", net.updater_state_leaves())
        _save_leaves(zf, "state.npz", net.state_leaves())
        zf.writestr("meta.json", json.dumps({
            "model_class": getattr(net, "model_class", type(net).__name__),
            "iteration": net.iteration,
            "epoch": net.epoch}))


def restore_model(path: str, device="cuda") -> BaseNetwork:
    """A MultiLayerNetwork or ComputationGraph from a zip of
    :func:`write_model` or of the JAX package's ``write_model`` (reference:
    ModelSerializer.restoreMultiLayerNetwork/restoreComputationGraph):
    params, updater state, layer state, iteration and epoch, on
    ``device``."""
    with zipfile.ZipFile(path, "r") as zf:
        meta = json.loads(zf.read("meta.json"))
        model_class = meta.get("model_class")
        if model_class not in _MODELS:
            raise ValueError(f"{path}: model class {model_class!r} is not ported "
                             f"(known: {', '.join(_MODELS)})")
        cls, conf_cls = _MODELS[model_class]
        conf = conf_cls.from_json(zf.read("configuration.json").decode())
        leaves = _load_leaves(zf, "coefficients.npz")
        updater_leaves = _load_leaves(zf, "updaterState.npz")
        state_leaves = _load_leaves(zf, "state.npz")
    net = cls(conf, device=device).init()
    keys = [sorted(p) for p in net._leaves()]
    if len(leaves) != sum(len(k) for k in keys):
        raise ValueError(f"{path}: {len(leaves)} param leaves, the config expects "
                         f"{sum(len(k) for k in keys)}")
    it = iter(leaves)
    load_jax_params(net, net._params_from_leaves(
        [{k: next(it) for k in layer_keys} for layer_keys in keys]))
    net.set_state_leaves(state_leaves)
    net.set_updater_state_leaves(updater_leaves)
    net.iteration = int(meta.get("iteration", 0))
    net.epoch = int(meta.get("epoch", 0))
    return net
