"""Deep Belief Network: stacked RBMs with layerwise pretraining (counterpart
of ``deeplearning4j_tpu/models/dbn.py``).

The architecture the reference project was founded on
(DeepBeliefNetworkExample / MnistDBNExample): RBM layers pretrained by CD-k,
then fine-tuned with a softmax head. ``MultiLayerNetwork.pretrain(data)``
runs the layerwise schedule, then ``fit`` backpropagates end to end.
"""

from __future__ import annotations

from typing import Sequence

from ..nn.conf.inputs import InputType
from ..nn.conf.multi_layer import MultiLayerConfiguration
from ..nn.layers.dense import OutputLayer
from ..nn.layers.pretrain import RBM
from ..nn.updaters import UpdaterConfig


def dbn_conf(
    n_in: int = 784,
    layer_sizes: Sequence[int] = (500, 250, 100),
    n_classes: int = 10,
    k: int = 1,
    visible_unit: str = "binary",
    learning_rate: float = 1e-2,
    updater: str = "sgd",
    dtype: str = "float32",
    seed: int = 12345,
) -> MultiLayerConfiguration:
    """The RBM stack (the first layer's visible units match the data:
    "gaussian" for real-valued inputs, binary hidden units throughout) and a
    softmax classifier head. Train as the reference did: ``net.pretrain(it)``
    (greedy layerwise CD-k), then ``net.fit(it)``."""
    layers = [RBM(n_out=int(size), k=k, visible_unit=visible_unit if i == 0 else "binary",
                  hidden_unit="binary")
              for i, size in enumerate(layer_sizes)]
    layers.append(OutputLayer(n_out=n_classes, activation="softmax", loss="mcxent"))
    return MultiLayerConfiguration(
        layers=layers,
        input_type=InputType.feed_forward(n_in),
        updater=UpdaterConfig(updater=updater, learning_rate=learning_rate),
        dtype=dtype,
        seed=seed,
    )
