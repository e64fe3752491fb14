"""PyTorch and CUDA port of deeplearning4j_tpu, for NVIDIA Hopper (H100).

It grows beside the JAX package, slice by slice, and imports nothing of it
and no JAX. It serves the char-RNN (``MultiLayerNetwork.output``, ``predict``
and ``rnn_time_step``, ``serving.decode.DecodeServer``) and trains it
(``MultiLayerNetwork.fit``, standard backprop and TBPTT, with SGD, momentum
or Nesterov), with the LSTM recurrence, its backward and the softmax
cross-entropy in hand-written CUDA kernels (``ops/csrc/``). Entry points run
on the card unless the caller passes ``device="cpu"``.
"""

from .datasets.iterators import DataSet
from .interop.jax_params import load_jax_model_zip, load_jax_params, params_to_numpy
from .models.char_rnn import char_rnn
from .nn.conf.inputs import InputType
from .nn.conf.multi_layer import MultiLayerConfiguration
from .nn.layers.dense import DenseLayer, OutputLayer
from .nn.layers.recurrent import GravesBidirectionalLSTM, GravesLSTM, RnnOutputLayer
from .nn.multilayer import MultiLayerNetwork
from .nn.updaters import UpdaterConfig
from .serving.decode import DecodeServer

__all__ = [
    "DataSet",
    "DecodeServer",
    "DenseLayer",
    "GravesBidirectionalLSTM",
    "GravesLSTM",
    "InputType",
    "MultiLayerConfiguration",
    "MultiLayerNetwork",
    "OutputLayer",
    "RnnOutputLayer",
    "UpdaterConfig",
    "char_rnn",
    "load_jax_model_zip",
    "load_jax_params",
    "params_to_numpy",
]
