"""Checkpoints in the JAX package's zip layout (counterpart of
``deeplearning4j_tpu/utils/serialization.py``).

The zip holds ``configuration.json`` (the config's JSON), ``coefficients.npz``
(the param leaves), ``updaterState.npz`` (the leaves of the optax updater
state), ``state.npz`` (layer state; the port's layers have none) and
``meta.json`` (model class, iteration, epoch). Leaves are stored as
``leaf_i`` in ``jax.tree_util.tree_leaves`` order: layer by layer, each
layer's dict in sorted key order. bf16 leaves are widened to f32, which is
lossless, and cast back to the model's dtype on restore; the Adam and
schedule counts are int32. A zip written by either package restores in the
other, and training resumes from it with the updater state it had.
"""

from __future__ import annotations

import io
import json
import zipfile
from typing import List

import numpy as np
import torch

from ..interop.jax_params import load_jax_params
from ..nn.conf.multi_layer import MultiLayerConfiguration
from ..nn.multilayer import MultiLayerNetwork


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


def write_model(net: MultiLayerNetwork, path: str) -> None:
    """Save ``net`` with its updater state, iteration and epoch (reference:
    ModelSerializer.writeModel)."""
    net.init()
    with zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED) as zf:
        zf.writestr("configuration.json", net.conf.to_json())
        _save_leaves(zf, "coefficients.npz",
                     [layer[k] for layer in net.layer_params for k in sorted(layer)])
        _save_leaves(zf, "updaterState.npz", net.updater_state_leaves())
        _save_leaves(zf, "state.npz", [])
        zf.writestr("meta.json", json.dumps({
            "model_class": "MultiLayerNetwork", "iteration": net.iteration,
            "epoch": net.epoch}))


def restore_model(path: str, device="cuda") -> MultiLayerNetwork:
    """A MultiLayerNetwork from a zip of :func:`write_model` or of the JAX
    package's ``write_model`` (reference:
    ModelSerializer.restoreMultiLayerNetwork): params, updater state,
    iteration and epoch, on ``device``."""
    with zipfile.ZipFile(path, "r") as zf:
        meta = json.loads(zf.read("meta.json"))
        if meta.get("model_class") != "MultiLayerNetwork":
            raise ValueError(f"{path}: model class {meta.get('model_class')!r} is "
                             "not ported (MultiLayerNetwork only)")
        conf = MultiLayerConfiguration.from_json(zf.read("configuration.json").decode())
        leaves = _load_leaves(zf, "coefficients.npz")
        updater_leaves = _load_leaves(zf, "updaterState.npz")
        if _load_leaves(zf, "state.npz"):
            raise ValueError(f"{path}: holds layer state, which no ported layer has")
    net = MultiLayerNetwork(conf, device=device).init()
    keys = [sorted(p) for p in net.layer_params]
    if len(leaves) != sum(len(k) for k in keys):
        raise ValueError(f"{path}: {len(leaves)} param leaves, the config expects "
                         f"{sum(len(k) for k in keys)}")
    it = iter(leaves)
    load_jax_params(net, [{k: next(it) for k in layer_keys} for layer_keys in keys])
    net.set_updater_state_leaves(updater_leaves)
    net.iteration = int(meta.get("iteration", 0))
    net.epoch = int(meta.get("epoch", 0))
    return net
