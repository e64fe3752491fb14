"""ResNet-v1 family as ComputationGraph configs (counterpart of
``deeplearning4j_tpu/models/resnet.py``): the same vertex names, defaults
and JSON config. ResNet-50 is the repo's flagship bench model (BASELINE
config #2). Each convolution (no bias, He init, Same mode) is followed by
a ``BatchNormalization`` and, but for a block's last, a relu
``ActivationLayer``; ``ElementWiseVertex(op="add")`` sums a block's branch
and its shortcut. The loss head runs the softmax-xent kernels of
``ops/csrc/softmax_xent.cu`` in training; the convolutions, batch norms
(plain tensor ops), pools and adds are PyTorch calls, as the JAX package
left them to XLA."""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

from ..nn.conf.computation_graph import ComputationGraphConfiguration, GraphBuilder
from ..nn.conf.inputs import InputType
from ..nn.graph.vertices import ElementWiseVertex
from ..nn.layers.convolution import ConvolutionLayer
from ..nn.layers.dense import ActivationLayer, OutputLayer
from ..nn.layers.normalization import BatchNormalization
from ..nn.layers.pooling import GlobalPoolingLayer, SubsamplingLayer
from ..nn.updaters import UpdaterConfig


def _conv_bn(b: GraphBuilder, name: str, inp: str, n_out: int, kernel: Tuple[int, int],
             stride: Tuple[int, int] = (1, 1), relu: bool = True) -> str:
    """conv -> BN [-> relu]; returns the last vertex's name."""
    b.add_layer(f"{name}_conv",
                ConvolutionLayer(n_out=n_out, kernel=kernel, stride=stride,
                                 convolution_mode="same", has_bias=False, weight_init="relu"),
                inp)
    b.add_layer(f"{name}_bn", BatchNormalization(), f"{name}_conv")
    if relu:
        b.add_layer(f"{name}_relu", ActivationLayer(activation="relu"), f"{name}_bn")
        return f"{name}_relu"
    return f"{name}_bn"


def _shortcut_add(b: GraphBuilder, name: str, inp: str, t: str, out_ch: int,
                  stride: Tuple[int, int], project: bool) -> str:
    """The block's sum with its shortcut (a 1x1 conv -> BN projection where
    ``project``), then relu."""
    shortcut = (_conv_bn(b, f"{name}_proj", inp, out_ch, (1, 1), stride, relu=False)
                if project else inp)
    b.add_vertex(f"{name}_add", ElementWiseVertex(op="add"), t, shortcut)
    b.add_layer(f"{name}_out", ActivationLayer(activation="relu"), f"{name}_add")
    return f"{name}_out"


def _bottleneck(b: GraphBuilder, name: str, inp: str, mid: int, stride: Tuple[int, int],
                project: bool) -> str:
    """ResNet-v1 bottleneck: 1x1(mid) -> 3x3(mid) -> 1x1(4*mid), the stride
    on the first 1x1, + shortcut."""
    t = _conv_bn(b, f"{name}_a", inp, mid, (1, 1), stride)
    t = _conv_bn(b, f"{name}_b", t, mid, (3, 3))
    t = _conv_bn(b, f"{name}_c", t, 4 * mid, (1, 1), relu=False)
    return _shortcut_add(b, name, inp, t, 4 * mid, stride, project)


def _basic_block(b: GraphBuilder, name: str, inp: str, ch: int, stride: Tuple[int, int],
                 project: bool) -> str:
    """ResNet-v1 basic block (ResNet-18/34): 3x3 -> 3x3, + shortcut."""
    t = _conv_bn(b, f"{name}_a", inp, ch, (3, 3), stride)
    t = _conv_bn(b, f"{name}_b", t, ch, (3, 3), relu=False)
    return _shortcut_add(b, name, inp, t, ch, stride, project)


def resnet_conf(
    blocks: Sequence[int],
    *,
    bottleneck: bool = True,
    num_classes: int = 1000,
    image_size: Tuple[int, int] = (224, 224),
    channels: int = 3,
    dtype: str = "float32",
    updater: Optional[UpdaterConfig] = None,
    seed: int = 12345,
) -> ComputationGraphConfiguration:
    """Generic ResNet-v1 graph over NHWC images; ``blocks``: residual blocks
    per stage. The stem is a 7x7/2 conv -> BN -> relu and a 3x3/2 Same max
    pool; stages double the width from 64 and halve the size from the
    second; global average pooling and a softmax head. SGD at lr 0.1 unless
    ``updater`` says otherwise."""
    b = (ComputationGraphConfiguration.builder()
         .add_inputs("in")
         .set_input_types(InputType.convolutional(image_size[0], image_size[1], channels))
         .seed(seed)
         .dtype(dtype)
         .updater(updater or UpdaterConfig(updater="sgd", learning_rate=0.1)))
    stem = _conv_bn(b, "stem", "in", 64, (7, 7), (2, 2))
    b.add_layer("stem_pool",
                SubsamplingLayer(pooling_type="max", kernel=(3, 3), stride=(2, 2),
                                 convolution_mode="same"),
                stem)
    t = "stem_pool"
    block_fn = _bottleneck if bottleneck else _basic_block
    width, cur_ch = 64, 64  # channels out of the stem
    for stage, n_blocks in enumerate(blocks):
        out_ch = 4 * width if bottleneck else width
        for i in range(n_blocks):
            stride = (2, 2) if (stage > 0 and i == 0) else (1, 1)
            # a projection only where the identity cannot carry the residual
            project = i == 0 and (stride != (1, 1) or cur_ch != out_ch)
            t = block_fn(b, f"s{stage}_b{i}", t, width, stride, project)
            cur_ch = out_ch
        width *= 2
    b.add_layer("avgpool", GlobalPoolingLayer(pooling_type="avg"), t)
    b.add_layer("out", OutputLayer(n_out=num_classes, activation="softmax", loss="mcxent"),
                "avgpool")
    b.set_outputs("out")
    return b.build()


def resnet50_conf(**kw) -> ComputationGraphConfiguration:
    """ResNet-50: [3, 4, 6, 3] bottleneck stages."""
    return resnet_conf([3, 4, 6, 3], bottleneck=True, **kw)


def resnet18_conf(**kw) -> ComputationGraphConfiguration:
    return resnet_conf([2, 2, 2, 2], bottleneck=False, **kw)


def resnet34_conf(**kw) -> ComputationGraphConfiguration:
    return resnet_conf([3, 4, 6, 3], bottleneck=False, **kw)


def resnet101_conf(**kw) -> ComputationGraphConfiguration:
    return resnet_conf([3, 4, 23, 3], bottleneck=True, **kw)


def resnet152_conf(**kw) -> ComputationGraphConfiguration:
    return resnet_conf([3, 8, 36, 3], bottleneck=True, **kw)
