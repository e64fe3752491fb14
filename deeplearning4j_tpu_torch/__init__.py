"""PyTorch and CUDA port of deeplearning4j_tpu, for NVIDIA Hopper (H100).

It grows beside the JAX package, slice by slice, and imports nothing of it
and no JAX. It serves the char-RNN (``MultiLayerNetwork.output``, ``predict``
and ``rnn_time_step``, ``serving.decode.DecodeServer``) and trains it
(``MultiLayerNetwork.fit``, standard backprop and TBPTT, with Adam, SGD,
momentum or Nesterov, on padded variable-length batches of
``BucketingSequenceIterator`` as on fixed-length ones), evaluates it
(``evaluate``) and checkpoints it in the JAX package's zip layout
(``write_model``, ``restore_model``). It serves and trains causal
self-attention networks the same ways (``SelfAttentionLayer``,
``LayerNormLayer``), and AlexNet (``alexnet_conf``: ``ConvolutionLayer``,
``LocalResponseNormalization``, ``SubsamplingLayer`` over NHWC images). It
builds DAG networks (``ComputationGraphConfiguration``, its vertices and the
input preprocessors, which ``MultiLayerConfiguration`` takes too) and
serves, trains, evaluates and checkpoints them as ``ComputationGraph``,
GoogLeNet among them (``googlenet_conf``: ``MergeVertex``,
``GlobalPoolingLayer``, ``DropoutLayer``, multi-output training over
``MultiDataSet``). Layers keep state (``init_state``; the networks'
``state``, threaded through every forward, saved in the zips and carried
from the JAX package by ``load_jax_params``/``load_jax_state``): with
``BatchNormalization``, ``ActivationLayer`` and ``ElementWiseVertex`` it
serves and trains ResNet (``resnet_conf``, ``resnet50_conf`` and the rest
of the family) as a ``ComputationGraph``. It trains LeNet
(``lenet_mnist_conf``) and MLPs with Adam on ``MultiLayerNetwork`` over
``NumpyDataSetIterator`` and ``MnistDataSetIterator`` (local IDX files or
the JAX package's synthetic stand-in), and trains and evaluates both
networks over the whole ``datasets`` tier: the ``DataSetIterator`` family,
record readers and their iterators (CSV, sequences with alignment masks,
images; ``collect_metadata`` carries each record's provenance into
``Evaluation``'s ``Prediction``s), normalizers, ``.npz`` export, and the
fetchers, with the real handwritten digits and Iris bundled
(``DigitsDataSetIterator``, ``IrisDataSetIterator``). ``RegressionEvaluation``
and ``ROC`` are there too. ``LossLayer``, ``EmbeddingLayer``
and the JAX package's whole activation catalog are there too. The
``ComputationGraph`` trains with TBPTT and streams (``rnn_time_step``,
behind ``DecodeServer`` too), and the sequence layers
``RnnEmbeddingLayer``, ``LastTimeStepLayer``, ``Convolution1DLayer``,
``ZeroPaddingLayer`` and ``MixtureOfExpertsLayer`` run in both networks.
It pretrains layer by layer (``MultiLayerNetwork.pretrain`` over
``AutoEncoder``, ``RBM`` and ``VariationalAutoencoder`` with its five
reconstruction distributions; ``dbn_conf``, the stacked-RBM DBN), transfers
trained networks of both kinds (``TransferLearning.Builder`` and
``GraphBuilder``, ``FineTuneConfiguration``, ``FrozenLayer``), trains
``CenterLossOutputLayer`` heads, stops early (``earlystopping``) and checks
gradients against finite differences (``utils.gradcheck``).
The LSTM recurrence, masked or not, its backward, flash attention and its
backward, LRN and its backward, the softmax cross-entropy and the Adam update
run in hand-written CUDA kernels (``ops/csrc/``); the LSTM layers run either
the whole-sequence kernels (the default) or, with
``MultiLayerNetwork(..., lstm_variant="fusedcell")``, one per-step cell
kernel launch per step. It trains online from record streams
(``runtime.OnlineTrainer`` over the ``streaming`` sources, with the
versioned ``runtime.CheckpointStore``, in-place rollback and a live hot
swap into an ``InferenceService``; ``runtime.resilience`` policies,
``testing.chaos`` fault plans, ``telemetry.history``). It feeds ``fit``
from the C++ batch loader (``runtime.NativeDataSetIterator``, built with
g++ at first use), profiles (``profiler``: traces, step timers, FLOP
counts), serves the training dashboard and the HTTP service
(``ui.UIServer`` over ``ui.StatsListener``'s storage, ``POST
/serving/predict``), and embeds and clusters features on the card
(``plot.Tsne``, ``clustering.KMeansClustering``). It trains word and graph
embeddings (``nlp``: ``Word2Vec``, ``ParagraphVectors``, ``Glove``,
``DistributedWord2Vec`` over ``SequenceVectors``, the word-vector formats,
and ``Word2VecDataSetIterator``, which feeds trained vectors to a network;
``graph_embeddings``: ``DeepWalk``). Entry points run on the card unless
the caller passes ``device="cpu"``.
"""

from .datasets.fetchers import (DigitsDataSetIterator, IrisDataSetIterator,
                                MnistDataSetIterator, load_mnist)
from .datasets.iterators import (BucketingSequenceIterator, DataSet, DataSetIterator,
                                 ListDataSetIterator, MultiDataSet, MultipleEpochsIterator,
                                 NumpyDataSetIterator, pad_to_bucket)
from .eval.evaluation import Evaluation
from .eval.regression import RegressionEvaluation
from .eval.roc import ROC, ROCMultiClass
from .interop.jax_params import (load_jax_model_zip, load_jax_params, load_jax_state,
                                 params_to_numpy, state_to_numpy)
from .models.alexnet import alexnet_conf
from .models.char_rnn import char_rnn
from .models.dbn import dbn_conf
from .models.googlenet import googlenet_conf
from .models.lenet import lenet_mnist_conf
from .models.resnet import (resnet18_conf, resnet34_conf, resnet50_conf, resnet101_conf,
                            resnet152_conf, resnet_conf)
from .nn.conf.computation_graph import ComputationGraphConfiguration, GraphBuilder
from .nn.conf.inputs import InputType
from .nn.conf.multi_layer import MultiLayerConfiguration
from .nn.conf.preprocessors import (
    CnnToFeedForwardPreProcessor,
    CnnToRnnPreProcessor,
    ComposableInputPreProcessor,
    FeedForwardToCnnPreProcessor,
    FeedForwardToRnnPreProcessor,
    RnnToCnnPreProcessor,
    RnnToFeedForwardPreProcessor,
)
from .nn.graph import (
    ComputationGraph,
    DuplicateToTimeSeriesVertex,
    ElementWiseVertex,
    L2NormalizeVertex,
    L2Vertex,
    LastTimeStepVertex,
    LayerVertex,
    MergeVertex,
    PreprocessorVertex,
    ReshapeVertex,
    ScaleVertex,
    ShiftVertex,
    StackVertex,
    SubsetVertex,
    UnstackVertex,
)
from .nn.layers.attention import LayerNormLayer, SelfAttentionLayer
from .nn.layers.center_loss import CenterLossOutputLayer
from .nn.layers.convolution import Convolution1DLayer, ConvolutionLayer, ZeroPaddingLayer
from .nn.layers.dense import (ActivationLayer, DenseLayer, DropoutLayer, EmbeddingLayer,
                              LossLayer, OutputLayer)
from .nn.layers.frozen import FrozenLayer
from .nn.layers.normalization import BatchNormalization, LocalResponseNormalization
from .nn.layers.pooling import GlobalPoolingLayer, SubsamplingLayer
from .nn.layers.pretrain import RBM, AutoEncoder
from .nn.layers.moe import MixtureOfExpertsLayer
from .nn.layers.recurrent import (GravesBidirectionalLSTM, GravesLSTM, LastTimeStepLayer,
                                  RnnEmbeddingLayer, RnnOutputLayer)
from .nn.layers.variational import (BernoulliReconstruction, CompositeReconstruction,
                                    ExponentialReconstruction, GaussianReconstruction,
                                    LossFunctionWrapper, VariationalAutoencoder)
from .nn.multilayer import MultiLayerNetwork
from .nn.transferlearning import (FineTuneConfiguration, TransferLearning,
                                  TransferLearningBuilder, TransferLearningGraphBuilder)
from .nn.updaters import UpdaterConfig
from .runtime.checkpoint import CheckpointStore
from .runtime.online import OnlineTrainer
from .serving import InferenceService, get_service
from .serving.decode import DecodeServer
from .utils.serialization import restore_model, write_model
from .clustering import KMeansClustering
from .plot import BarnesHutTsne, Tsne
from .runtime.native_loader import NativeDataSetIterator
from .ui import StatsListener, UIServer

__all__ = [
    "ActivationLayer",
    "AutoEncoder",
    "BarnesHutTsne",
    "BatchNormalization",
    "BernoulliReconstruction",
    "BucketingSequenceIterator",
    "CenterLossOutputLayer",
    "CheckpointStore",
    "CnnToFeedForwardPreProcessor",
    "CnnToRnnPreProcessor",
    "ComposableInputPreProcessor",
    "CompositeReconstruction",
    "ComputationGraph",
    "ComputationGraphConfiguration",
    "Convolution1DLayer",
    "ConvolutionLayer",
    "DataSet",
    "DataSetIterator",
    "DecodeServer",
    "DenseLayer",
    "DigitsDataSetIterator",
    "DropoutLayer",
    "DuplicateToTimeSeriesVertex",
    "ElementWiseVertex",
    "EmbeddingLayer",
    "Evaluation",
    "ExponentialReconstruction",
    "FeedForwardToCnnPreProcessor",
    "FeedForwardToRnnPreProcessor",
    "FineTuneConfiguration",
    "FrozenLayer",
    "GaussianReconstruction",
    "GlobalPoolingLayer",
    "GraphBuilder",
    "GravesBidirectionalLSTM",
    "GravesLSTM",
    "InferenceService",
    "InputType",
    "IrisDataSetIterator",
    "KMeansClustering",
    "L2NormalizeVertex",
    "L2Vertex",
    "LastTimeStepLayer",
    "LastTimeStepVertex",
    "LayerNormLayer",
    "LayerVertex",
    "ListDataSetIterator",
    "LocalResponseNormalization",
    "LossFunctionWrapper",
    "LossLayer",
    "MergeVertex",
    "MixtureOfExpertsLayer",
    "MnistDataSetIterator",
    "MultiDataSet",
    "MultiLayerConfiguration",
    "MultiLayerNetwork",
    "MultipleEpochsIterator",
    "NativeDataSetIterator",
    "NumpyDataSetIterator",
    "OnlineTrainer",
    "OutputLayer",
    "PreprocessorVertex",
    "RBM",
    "ROC",
    "ROCMultiClass",
    "RegressionEvaluation",
    "ReshapeVertex",
    "RnnEmbeddingLayer",
    "RnnOutputLayer",
    "RnnToCnnPreProcessor",
    "RnnToFeedForwardPreProcessor",
    "ScaleVertex",
    "SelfAttentionLayer",
    "ShiftVertex",
    "StackVertex",
    "StatsListener",
    "SubsamplingLayer",
    "SubsetVertex",
    "TransferLearning",
    "TransferLearningBuilder",
    "TransferLearningGraphBuilder",
    "Tsne",
    "UIServer",
    "UnstackVertex",
    "UpdaterConfig",
    "VariationalAutoencoder",
    "ZeroPaddingLayer",
    "alexnet_conf",
    "char_rnn",
    "dbn_conf",
    "get_service",
    "googlenet_conf",
    "lenet_mnist_conf",
    "load_jax_model_zip",
    "load_jax_params",
    "load_jax_state",
    "load_mnist",
    "pad_to_bucket",
    "params_to_numpy",
    "resnet101_conf",
    "resnet152_conf",
    "resnet18_conf",
    "resnet34_conf",
    "resnet50_conf",
    "resnet_conf",
    "restore_model",
    "state_to_numpy",
    "write_model",
]
