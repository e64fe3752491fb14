"""LeNet-5-style MNIST model (counterpart of
``deeplearning4j_tpu/models/lenet.py``, BASELINE config #1, dl4j-examples'
LenetMnistExample shape): the same layers, defaults and JSON config. Its
loss head runs the softmax-xent kernels of ``ops/csrc/softmax_xent.cu`` in
training and its Adam update ``ops/csrc/adam.cu``; the convolutions,
pooling and dense layers are PyTorch calls, as the JAX package left them
to XLA."""

from __future__ import annotations

from ..nn.conf.inputs import InputType
from ..nn.conf.multi_layer import MultiLayerConfiguration
from ..nn.layers.convolution import ConvolutionLayer
from ..nn.layers.dense import DenseLayer, OutputLayer
from ..nn.layers.pooling import SubsamplingLayer
from ..nn.updaters import UpdaterConfig


def lenet_mnist_conf(
    height: int = 28,
    width: int = 28,
    channels: int = 1,
    n_classes: int = 10,
    learning_rate: float = 1e-3,
    updater: str = "adam",
    dtype: str = "float32",
    seed: int = 12345,
) -> MultiLayerConfiguration:
    """conv 5x5x20, max pool 2x2, conv 5x5x50, max pool 2x2, dense 500 relu,
    softmax output, over NHWC images [B, height, width, channels]."""
    return MultiLayerConfiguration(
        layers=[
            ConvolutionLayer(n_out=20, kernel=(5, 5), stride=(1, 1), activation="identity"),
            SubsamplingLayer(pooling_type="max", kernel=(2, 2), stride=(2, 2)),
            ConvolutionLayer(n_out=50, kernel=(5, 5), stride=(1, 1), activation="identity"),
            SubsamplingLayer(pooling_type="max", kernel=(2, 2), stride=(2, 2)),
            DenseLayer(n_out=500, activation="relu"),
            OutputLayer(n_out=n_classes, activation="softmax", loss="mcxent"),
        ],
        input_type=InputType.convolutional(height, width, channels),
        updater=UpdaterConfig(updater=updater, learning_rate=learning_rate).to_dict(),
        dtype=dtype,
        seed=seed,
    )
