#!/usr/bin/env python3
"""Draw the JAX package's initial params of the two real-data accuracy pins
of ``tests/test_accuracy_parity.py`` and write them as float32 to
``tests/data/jax_init_real_data.npz``.

    python3 scripts/make_real_data_init.py [--out PATH]

The pins are LeNet on the handwritten digits (``digits``, 12,068 floats)
and an MLP on Iris (``iris``, 131 floats). The params are drawn on the CPU
as the test suite draws them (x64 on, so in float64, then cast to float32),
from each conf's seed. Keys are ``<model>/<layer>/<param>``. The port loads
the file with ``load_jax_params`` (``tests/test_torch_accuracy_parity.py``
and ``chip_smoke.py``'s ``train_digits`` and ``train_iris``), so it trains
from JAX's weights where JAX is not installed;
``tests/test_torch_accuracy_parity.py`` checks that the file still equals a
fresh draw.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "tests", "data", "jax_init_real_data.npz")


def jax_confs() -> dict:
    """model -> the JAX package's conf of that pin
    (tests/test_accuracy_parity.py:50-66 and :75-81)."""
    from deeplearning4j_tpu import (DenseLayer, InputType, MultiLayerConfiguration,
                                    OutputLayer, UpdaterConfig)
    from deeplearning4j_tpu.nn.layers.convolution import ConvolutionLayer
    from deeplearning4j_tpu.nn.layers.pooling import SubsamplingLayer

    digits = MultiLayerConfiguration(
        layers=[
            ConvolutionLayer(n_out=20, kernel=(3, 3), activation="identity"),
            SubsamplingLayer(pooling_type="max", kernel=(2, 2), stride=(2, 2)),
            ConvolutionLayer(n_out=50, kernel=(2, 2), activation="identity"),
            SubsamplingLayer(pooling_type="max", kernel=(2, 2), stride=(2, 2)),
            DenseLayer(n_out=128, activation="relu"),
            OutputLayer(n_out=10, activation="softmax", loss="mcxent"),
        ],
        input_type=InputType.convolutional(8, 8, 1),
        updater=UpdaterConfig(updater="adam", learning_rate=2e-3),
        seed=5,
    )
    iris = MultiLayerConfiguration(
        layers=[DenseLayer(n_out=16, activation="tanh"),
                OutputLayer(n_out=3, activation="softmax", loss="mcxent")],
        input_type=InputType.feed_forward(4),
        updater=UpdaterConfig(updater="adam", learning_rate=5e-3),
        seed=6,
    )
    return {"digits": digits, "iris": iris}


def draw() -> dict:
    """key -> float32 array of each pin's initial params, as JAX draws them
    under x64 (the caller's JAX must run on the CPU with x64 on)."""
    from deeplearning4j_tpu import MultiLayerNetwork

    out = {}
    for model, conf in jax_confs().items():
        net = MultiLayerNetwork(conf).init()
        for i, layer in enumerate(net.params):
            for k, v in layer.items():
                out[f"{model}/{i}/{k}"] = np.asarray(v).astype(np.float32)
    return out


def as_layers(arrays, model: str) -> list:
    """The ``model`` part of the file as one dict per layer, the layout
    ``load_jax_params`` takes."""
    layers: dict = {}
    for key in arrays:
        m, i, k = key.split("/")
        if m == model:
            layers.setdefault(int(i), {})[k] = np.asarray(arrays[key])
    return [layers.get(i, {}) for i in range(max(layers) + 1)]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=OUT)
    args = ap.parse_args()
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    sys.path.insert(0, ROOT)
    import jax

    jax.config.update("jax_enable_x64", True)
    arrays = draw()
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    np.savez(args.out, **arrays)
    for model in jax_confs():
        n = sum(a.size for k, a in arrays.items() if k.startswith(model + "/"))
        print(f"{model}: {n} floats")
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
