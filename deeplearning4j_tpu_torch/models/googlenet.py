"""GoogLeNet (Inception-v1), the reference era's deep multi-branch CNN
(counterpart of ``deeplearning4j_tpu/models/googlenet.py``): the same
vertices, defaults and JSON config. Nine inception modules concatenate
their four branches in ``MergeVertex``es on the channel axis; the two LRN
layers of the stem run the hand-written kernels of ``ops/csrc/lrn.cu`` on
the card, and each output head the softmax-xent kernels of
``ops/csrc/softmax_xent.cu`` in training. The convolutions, pools and
concatenations are PyTorch calls, as the JAX package left them to XLA.
With ``aux_heads`` the two auxiliary classifiers (Szegedy et al. 2014) are
outputs too, and their losses add to the main head's."""

from __future__ import annotations

from ..nn.conf.computation_graph import ComputationGraphConfiguration, GraphBuilder
from ..nn.conf.inputs import InputType
from ..nn.graph.vertices import MergeVertex
from ..nn.layers.convolution import ConvolutionLayer
from ..nn.layers.dense import DenseLayer, DropoutLayer, OutputLayer
from ..nn.layers.normalization import LocalResponseNormalization
from ..nn.layers.pooling import GlobalPoolingLayer, SubsamplingLayer
from ..nn.updaters import UpdaterConfig


def _conv(b: GraphBuilder, name: str, inp: str, n_out: int, kernel, stride=(1, 1)) -> str:
    b.add_layer(name, ConvolutionLayer(n_out=n_out, kernel=kernel, stride=stride,
                                       convolution_mode="same", activation="relu"), inp)
    return name


def _max_pool(stride: int) -> SubsamplingLayer:
    return SubsamplingLayer(pooling_type="max", kernel=(3, 3), stride=(stride, stride),
                            convolution_mode="same")


def _inception(b: GraphBuilder, name: str, inp: str,
               ch1: int, ch3r: int, ch3: int, ch5r: int, ch5: int, pool: int) -> str:
    """One inception module: 1x1 | 1x1 -> 3x3 | 1x1 -> 5x5 | pool -> 1x1,
    concatenated."""
    b1 = _conv(b, f"{name}_1x1", inp, ch1, (1, 1))
    r3 = _conv(b, f"{name}_3x3r", inp, ch3r, (1, 1))
    b3 = _conv(b, f"{name}_3x3", r3, ch3, (3, 3))
    r5 = _conv(b, f"{name}_5x5r", inp, ch5r, (1, 1))
    b5 = _conv(b, f"{name}_5x5", r5, ch5, (5, 5))
    b.add_layer(f"{name}_pool", _max_pool(1), inp)
    bp = _conv(b, f"{name}_poolproj", f"{name}_pool", pool, (1, 1))
    b.add_vertex(name, MergeVertex(), b1, b3, b5, bp)
    return name


def _aux_head(b: GraphBuilder, name: str, inp: str, n_classes: int, dropout: float) -> str:
    """Auxiliary classifier: avgpool 5x5/3 -> 1x1 conv -> dense 1024 ->
    softmax."""
    b.add_layer(f"{name}_pool",
                SubsamplingLayer(pooling_type="avg", kernel=(5, 5), stride=(3, 3)), inp)
    _conv(b, f"{name}_proj", f"{name}_pool", 128, (1, 1))
    b.add_layer(f"{name}_fc", DenseLayer(n_out=1024, activation="relu", dropout=dropout),
                f"{name}_proj")
    b.add_layer(name, OutputLayer(n_out=n_classes, activation="softmax", loss="mcxent"),
                f"{name}_fc")
    return name


def googlenet_conf(
    height: int = 224,
    width: int = 224,
    channels: int = 3,
    n_classes: int = 1000,
    learning_rate: float = 1e-2,
    updater: str = "nesterovs",
    dropout: float = 0.4,
    aux_heads: bool = False,
    dtype: str = "float32",
    seed: int = 12345,
) -> ComputationGraphConfiguration:
    """GoogLeNet over NHWC images [B, height, width, channels]: the stem
    (7x7/2 conv, pool, LRN, 1x1 and 3x3 convs, LRN, pool), inception
    modules 3a-5b with pools between, global average pooling, dropout and a
    softmax head; the two auxiliary heads (off 4a and 4d) with
    ``aux_heads``."""
    b = (ComputationGraphConfiguration.builder()
         .add_inputs("in")
         .set_input_types(InputType.convolutional(height, width, channels))
         .seed(seed)
         .dtype(dtype)
         .updater(UpdaterConfig(updater=updater, learning_rate=learning_rate)))
    _conv(b, "stem_conv1", "in", 64, (7, 7), (2, 2))
    b.add_layer("stem_pool1", _max_pool(2), "stem_conv1")
    b.add_layer("stem_lrn1", LocalResponseNormalization(), "stem_pool1")
    _conv(b, "stem_conv2r", "stem_lrn1", 64, (1, 1))
    _conv(b, "stem_conv2", "stem_conv2r", 192, (3, 3))
    b.add_layer("stem_lrn2", LocalResponseNormalization(), "stem_conv2")
    b.add_layer("stem_pool2", _max_pool(2), "stem_lrn2")

    t = _inception(b, "i3a", "stem_pool2", 64, 96, 128, 16, 32, 32)
    t = _inception(b, "i3b", t, 128, 128, 192, 32, 96, 64)
    b.add_layer("pool3", _max_pool(2), t)
    t = _inception(b, "i4a", "pool3", 192, 96, 208, 16, 48, 64)
    aux1_src = t
    t = _inception(b, "i4b", t, 160, 112, 224, 24, 64, 64)
    t = _inception(b, "i4c", t, 128, 128, 256, 24, 64, 64)
    t = _inception(b, "i4d", t, 112, 144, 288, 32, 64, 64)
    aux2_src = t
    t = _inception(b, "i4e", t, 256, 160, 320, 32, 128, 128)
    b.add_layer("pool4", _max_pool(2), t)
    t = _inception(b, "i5a", "pool4", 256, 160, 320, 32, 128, 128)
    t = _inception(b, "i5b", t, 384, 192, 384, 48, 128, 128)

    # the paper's head: global average pool -> dropout -> softmax
    b.add_layer("avgpool", GlobalPoolingLayer(pooling_type="avg"), t)
    b.add_layer("drop", DropoutLayer(dropout=dropout), "avgpool")
    b.add_layer("out", OutputLayer(n_out=n_classes, activation="softmax", loss="mcxent"),
                "drop")
    outputs = ["out"]
    if aux_heads:
        outputs.append(_aux_head(b, "aux1", aux1_src, n_classes, dropout))
        outputs.append(_aux_head(b, "aux2", aux2_src, n_classes, dropout))
    b.set_outputs(*outputs)
    return b.build()
