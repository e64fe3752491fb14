"""Keras model import (counterpart of ``deeplearning4j_tpu/modelimport``;
reference: deeplearning4j-modelimport, SURVEY.md §2.7).

Keras 1.x HDF5 archives are read by :mod:`.hdf5`, the port's own reader
(numpy and ``struct``, no h5py), and their layer configs translated into the
port's configs (``keras.py``); weights land in the layers' param dicts in
the JAX package's layout. ``TrainedModels`` builds VGG16 and loads a local
weights archive. Networks are built on the card unless the caller passes
``device="cpu"``.
"""

from .hdf5 import Hdf5Archive
from .keras import (
    KerasImportError,
    import_keras_model_and_weights,
    import_keras_model_config,
    import_keras_sequential_config,
    import_keras_sequential_model_and_weights,
)
from .trained_models import TrainedModels, imagenet_labels, vgg16_configuration

__all__ = [
    "Hdf5Archive",
    "KerasImportError",
    "import_keras_model_and_weights",
    "import_keras_model_config",
    "import_keras_sequential_config",
    "import_keras_sequential_model_and_weights",
    "TrainedModels",
    "vgg16_configuration",
    "imagenet_labels",
]
