"""Era model zoo (counterpart of ``deeplearning4j_tpu/modelimport/
trained_models.py``; reference: trainedmodels/TrainedModels.java +
TrainedModelHelper.java).

The reference downloads pretrained VGG16 weights in Keras HDF5 form and
imports them; labels come from ImageNetLabels (Utils/ImageNetLabels.java).
This build has zero network egress, so the zoo exposes (a) the exact VGG16
architecture as a config factory and (b) loaders that take a *local* Keras
HDF5 weight archive / labels file supplied by the user.
"""

from __future__ import annotations

import json
import os
from typing import List, Optional

from ..nn.conf.inputs import InputType
from ..nn.conf.multi_layer import MultiLayerConfiguration
from ..nn.conf.preprocessors import CnnToFeedForwardPreProcessor
from ..nn.layers.convolution import ConvolutionLayer
from ..nn.layers.dense import DenseLayer, OutputLayer
from ..nn.layers.pooling import SubsamplingLayer
from ..nn.updaters import UpdaterConfig


def vgg16_configuration(
    n_classes: int = 1000, height: int = 224, width: int = 224, channels: int = 3
) -> MultiLayerConfiguration:
    """VGG-16 (Simonyan & Zisserman 2014) exactly as the reference's
    TrainedModels.VGG16 lays it out: 13 same-padded 3x3 convs in 5 blocks with
    2x2 max-pools, then 4096-4096-softmax."""

    def conv(n: int) -> ConvolutionLayer:
        return ConvolutionLayer(
            n_out=n, kernel=(3, 3), stride=(1, 1), convolution_mode="same",
            activation="relu",
        )

    def pool() -> SubsamplingLayer:
        return SubsamplingLayer(pooling_type="max", kernel=(2, 2), stride=(2, 2))

    layers: List[object] = [
        conv(64), conv(64), pool(),
        conv(128), conv(128), pool(),
        conv(256), conv(256), conv(256), pool(),
        conv(512), conv(512), conv(512), pool(),
        conv(512), conv(512), conv(512), pool(),
        DenseLayer(n_out=4096, activation="relu"),
        DenseLayer(n_out=4096, activation="relu"),
        OutputLayer(n_out=n_classes, activation="softmax", loss="mcxent"),
    ]
    # flatten between last pool and first dense
    preprocessors = {len(layers) - 3: CnnToFeedForwardPreProcessor()}
    return MultiLayerConfiguration(
        layers=layers,
        input_type=InputType.convolutional(height, width, channels),
        preprocessors=preprocessors,
        updater=UpdaterConfig(updater="nesterovs", learning_rate=0.01),
    )


class TrainedModels:
    """Facade matching the reference's TrainedModels enum surface."""

    VGG16 = "VGG16"

    @staticmethod
    def configuration(name: str) -> MultiLayerConfiguration:
        if name == TrainedModels.VGG16:
            return vgg16_configuration()
        raise ValueError(f"Unknown trained model '{name}' (available: VGG16)")

    @staticmethod
    def load(name: str, weights_path: str, device="cuda"):
        """Build the model on ``device`` and load pretrained weights from a
        *local* Keras HDF5 archive (reference: TrainedModelHelper downloads
        then imports; here the file must already be on disk — no egress).

        Handles both full-model saves (``model_config`` present) and the
        canonical weights-only VGG16 archive, whose layers carry 'th'-ordered
        ``param_0``/``param_1`` datasets and no config: those are paired
        positionally with this zoo's architecture."""
        from ..nn.multilayer import resolve_device  # noqa: PLC0415

        resolve_device(device)
        if name != TrainedModels.VGG16:
            raise ValueError(f"Unknown trained model '{name}'")
        if not os.path.exists(weights_path):
            raise FileNotFoundError(
                f"VGG16 weights archive not found at {weights_path}; download "
                "the Keras VGG16 HDF5 weights on a connected machine first"
            )
        from . import hdf5  # noqa: PLC0415
        from .keras import import_keras_sequential_model_and_weights  # noqa: PLC0415

        if hdf5.read_model_config(weights_path) is not None:
            return import_keras_sequential_model_and_weights(
                weights_path, enforce_training_config=False, device=device
            )
        return _load_vgg16_weights_only(weights_path, device)


def _load_vgg16_weights_only(weights_path: str, device="cuda"):
    """Pair the archive's weight-bearing layers, in file order, with the
    VGG16 architecture's weight-bearing layers (convs are 'th' OIHW)."""
    import numpy as np  # noqa: PLC0415

    from ..interop.jax_params import load_jax_params  # noqa: PLC0415
    from ..nn.multilayer import MultiLayerNetwork  # noqa: PLC0415
    from . import hdf5  # noqa: PLC0415
    from .keras import KerasImportError  # noqa: PLC0415

    conf = vgg16_configuration()
    net = MultiLayerNetwork(conf, device=device).init()
    archive = hdf5.read_layer_weights(weights_path)
    weighted = [(ln, w) for ln, w in archive.items() if w]

    # every weighted layer's W and b are replaced below by host arrays
    new_params = [dict(p.items()) for p in net.layer_params]
    targets = [
        i for i, l in enumerate(conf.layers)
        if isinstance(l, (ConvolutionLayer, DenseLayer))
    ]
    if len(weighted) != len(targets):
        raise KerasImportError(
            f"Archive has {len(weighted)} weighted layers; VGG16 expects "
            f"{len(targets)}"
        )
    from .keras import _cnn_flatten_dense_indices, _permute_th_flatten_dense_kernel  # noqa: PLC0415

    flatten_dense = _cnn_flatten_dense_indices(conf)
    for idx, (lname, wdict) in zip(targets, weighted):
        arrs = [wdict[k] for k in sorted(wdict)]  # param_0, param_1
        if len(arrs) != 2:
            raise KerasImportError(
                f"Layer '{lname}' has {len(arrs)} arrays; expected W and b"
            )
        w, b = (arrs if arrs[0].ndim > arrs[1].ndim else (arrs[1], arrs[0]))
        if w.ndim == 4:  # 'th' OIHW → HWIO
            w = np.transpose(w, (2, 3, 1, 0))
        elif idx in flatten_dense:
            # The canonical 'th' archive's first FC kernel has rows in C,H,W
            # flatten order; our flatten is H,W,C (ADVICE round 1, high).
            h, wd, c = flatten_dense[idx]
            w = _permute_th_flatten_dense_kernel(w, h, wd, c)
        expect = tuple(new_params[idx]["W"].shape)
        if tuple(w.shape) != expect:
            raise KerasImportError(
                f"Layer '{lname}': weight shape {w.shape} != model {expect}"
            )
        new_params[idx] = {**new_params[idx], "W": w, "b": b}
    return load_jax_params(net, new_params)


def imagenet_labels(path: Optional[str] = None) -> List[str]:
    """1000 ImageNet class labels (reference: Utils/ImageNetLabels.java reads a
    downloaded JSON). Reads a local JSON file: either a list of labels or the
    keras-style {"0": ["n01440764", "tench"], ...} mapping."""
    if path is None or not os.path.exists(path):
        raise FileNotFoundError(
            "ImageNet labels file required (no network egress); pass the path "
            "to a local imagenet_class_index.json"
        )
    with open(path) as f:
        data = json.load(f)
    if isinstance(data, list):
        return [str(x) for x in data]
    return [data[str(i)][1] for i in range(len(data))]
