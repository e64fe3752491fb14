"""AlexNet (one-tower variant), the reference era's flagship ImageNet CNN
(counterpart of ``deeplearning4j_tpu/models/alexnet.py``): the same layers,
defaults and JSON config. Its two LRN layers run the hand-written kernels of
``ops/csrc/lrn.cu`` on the card; the convolutions, pooling and dense layers
are PyTorch calls, as the JAX package left them to XLA."""

from __future__ import annotations

from ..nn.conf.inputs import InputType
from ..nn.conf.multi_layer import MultiLayerConfiguration
from ..nn.layers.convolution import ConvolutionLayer
from ..nn.layers.dense import DenseLayer, OutputLayer
from ..nn.layers.normalization import LocalResponseNormalization
from ..nn.layers.pooling import SubsamplingLayer
from ..nn.updaters import UpdaterConfig


def alexnet_conf(
    height: int = 224,
    width: int = 224,
    channels: int = 3,
    n_classes: int = 1000,
    learning_rate: float = 1e-2,
    updater: str = "nesterovs",
    dropout: float = 0.5,
    dtype: str = "float32",
    seed: int = 12345,
) -> MultiLayerConfiguration:
    """Krizhevsky-2012 single-tower AlexNet: 5 conv (2 LRN'd) + 3 dense,
    over NHWC images [B, height, width, channels]."""
    def conv(n_out, k, s=1):
        return ConvolutionLayer(n_out=n_out, kernel=(k, k), stride=(s, s),
                                convolution_mode="same", activation="relu")

    def pool():
        return SubsamplingLayer(pooling_type="max", kernel=(3, 3), stride=(2, 2))

    return MultiLayerConfiguration(
        layers=[
            conv(96, 11, 4), LocalResponseNormalization(), pool(),
            conv(256, 5), LocalResponseNormalization(), pool(),
            conv(384, 3), conv(384, 3), conv(256, 3), pool(),
            DenseLayer(n_out=4096, activation="relu", dropout=dropout),
            DenseLayer(n_out=4096, activation="relu", dropout=dropout),
            OutputLayer(n_out=n_classes, activation="softmax", loss="mcxent"),
        ],
        input_type=InputType.convolutional(height, width, channels),
        updater=UpdaterConfig(updater=updater, learning_rate=learning_rate).to_dict(),
        dtype=dtype,
        seed=seed,
    )
