"""Keras 1.x model import -> the port's configs and params (counterpart of
``deeplearning4j_tpu/modelimport/keras.py``).

Reference behavior being matched (SURVEY.md §2.7):
- ``KerasModelImport.importKerasModelAndWeights`` (KerasModelImport.java:48)
- ``KerasSequentialModel`` parse → MultiLayerConfiguration
  (KerasSequentialModel.java:138) and weight copy (:214)
- ``KerasModel`` parse → ComputationGraphConfiguration (KerasModel.java:59)
- per-layer translators (keras/layers/Keras*.java): Dense, Convolution2D,
  MaxPooling2D/AveragePooling2D, GlobalPooling, BatchNormalization, LSTM,
  Embedding, Merge, Dropout, Activation, Flatten, ZeroPadding2D, Input, Loss.

Params keep the JAX package's layout, so the weights of an archive land as
they do there:
- weights go straight into each layer's param dict, not a flat vector;
- conv kernels are HWIO, so 'th' (OIHW) kernels are transposed once at
  import, and the first Dense after a channels-first Flatten has its rows
  permuted from C,H,W to H,W,C order;
- LSTM gate blocks are concatenated [c, f, o, i] into ``W``/``RW``/``b``,
  with zero peepholes ``pF``/``pI``/``pO`` (Keras has none);
- batch-norm running stats go to the layer's state (non-trainable).
The archive is read by :mod:`.hdf5` (no h5py); the networks are built on
``device`` (the card unless the caller asks for the CPU).
"""

from __future__ import annotations

import json
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from ..nn.conf.computation_graph import ComputationGraphConfiguration
from ..nn.conf.inputs import InputType
from ..nn.conf.multi_layer import MultiLayerConfiguration
from ..nn.conf.preprocessors import (
    CnnToFeedForwardPreProcessor,
    RnnToFeedForwardPreProcessor,
)
from ..nn.graph.vertices import (
    ElementWiseVertex,
    MergeVertex,
    PreprocessorVertex,
)
from ..nn.layers.convolution import ConvolutionLayer, ZeroPaddingLayer
from ..nn.layers.dense import (
    ActivationLayer,
    DenseLayer,
    DropoutLayer,
    OutputLayer,
)
from ..nn.layers.normalization import BatchNormalization
from ..nn.layers.pooling import GlobalPoolingLayer, SubsamplingLayer
from ..nn.layers.recurrent import (
    GravesLSTM,
    LastTimeStepLayer,
    RnnEmbeddingLayer,
    RnnOutputLayer,
)
from ..interop.jax_params import load_jax_params, params_to_numpy, state_to_numpy
from ..nn.updaters import UpdaterConfig
from . import hdf5


class KerasImportError(Exception):
    """Unsupported Keras config (reference: InvalidKerasConfigurationException /
    UnsupportedKerasConfigurationException)."""


# ---------------------------------------------------------------------------
# name catalogs
# ---------------------------------------------------------------------------

_ACTIVATIONS = {
    "linear": "identity",
    "relu": "relu",
    "tanh": "tanh",
    "sigmoid": "sigmoid",
    "hard_sigmoid": "hardsigmoid",
    "softmax": "softmax",
    "softplus": "softplus",
    "softsign": "softsign",
    "elu": "elu",
    "selu": "selu",
}

_LOSSES = {
    "categorical_crossentropy": "mcxent",
    "sparse_categorical_crossentropy": "mcxent",
    "binary_crossentropy": "xent",
    "mean_squared_error": "mse",
    "mse": "mse",
    "mean_absolute_error": "mae",
    "mae": "mae",
    "mean_absolute_percentage_error": "mape",
    "mape": "mape",
    "mean_squared_logarithmic_error": "msle",
    "msle": "msle",
    "hinge": "hinge",
    "squared_hinge": "squared_hinge",
    "kullback_leibler_divergence": "kl_divergence",
    "kld": "kl_divergence",
    "poisson": "poisson",
    "cosine_proximity": "cosine_proximity",
}

_OPTIMIZERS = {
    "sgd": "sgd",
    "adam": "adam",
    "adamax": "adam",
    "nadam": "adam",
    "rmsprop": "rmsprop",
    "adagrad": "adagrad",
    "adadelta": "adadelta",
}


def _map_activation(name: Optional[str]) -> str:
    if not name:
        return "identity"
    try:
        return _ACTIVATIONS[name]
    except KeyError:
        raise KerasImportError(f"Unsupported Keras activation '{name}'") from None


def _map_loss(name: str) -> str:
    try:
        return _LOSSES[name]
    except KeyError:
        raise KerasImportError(f"Unsupported Keras loss '{name}'") from None


def _updater_from_training_config(tc: Optional[dict]) -> UpdaterConfig:
    if not tc or "optimizer_config" not in tc:
        return UpdaterConfig()
    oc = tc["optimizer_config"]
    name = oc.get("class_name", "SGD").lower()
    cfg = oc.get("config", {})
    updater = _OPTIMIZERS.get(name, "sgd")
    kw: Dict[str, Any] = {"updater": updater}
    if "lr" in cfg:
        kw["learning_rate"] = float(cfg["lr"])
    if "momentum" in cfg:
        kw["momentum"] = float(cfg["momentum"])
    if "beta_1" in cfg:
        kw["beta1"] = float(cfg["beta_1"])
    if "beta_2" in cfg:
        kw["beta2"] = float(cfg["beta_2"])
    if "epsilon" in cfg and updater in ("adam", "rmsprop", "adadelta"):
        kw["epsilon"] = float(cfg["epsilon"])
    if "rho" in cfg:
        kw["rho"] = float(cfg["rho"])
        kw["rms_decay"] = float(cfg["rho"])
    return UpdaterConfig(**kw)


# ---------------------------------------------------------------------------
# shape helpers
# ---------------------------------------------------------------------------


def _input_type_from_shape(shape: List[Optional[int]], dim_ordering: str) -> InputType:
    """batch_input_shape (leading None = batch) → InputType."""
    dims = [int(d) for d in shape[1:] if d is not None] if shape else []
    n = len([d for d in shape[1:]])
    if n == 1:
        return InputType.feed_forward(dims[0])
    if n == 2:
        # [time, features] — time may be None (variable length)
        t = shape[1]
        return InputType.recurrent(int(shape[2]), None if t is None else int(t))
    if n == 3:
        if dim_ordering == "tf":
            h, w, c = shape[1], shape[2], shape[3]
        else:  # 'th' = channels first
            c, h, w = shape[1], shape[2], shape[3]
        return InputType.convolutional(int(h), int(w), int(c))
    raise KerasImportError(f"Unsupported input shape {shape}")


def _pair(v, default=None) -> Tuple[int, int]:
    if v is None:
        return default
    if isinstance(v, (list, tuple)):
        return (int(v[0]), int(v[1]))
    return (int(v), int(v))


_BORDER_MODES = {"valid": "truncate", "same": "same", "full": None}


def _conv_mode(border_mode: str) -> str:
    mode = _BORDER_MODES.get(border_mode, "unknown")
    if mode is None or mode == "unknown":
        raise KerasImportError(f"Unsupported Keras border_mode '{border_mode}'")
    return mode


# ---------------------------------------------------------------------------
# per-layer translators (reference: keras/layers/Keras*.java)
# ---------------------------------------------------------------------------


def _translate_layer(class_name: str, cfg: dict):
    """Return a layer/pseudo-layer for one Keras layer config.

    Returns one of: BaseLayer instance, ("flatten",), ("input",), ("merge", mode),
    ("reshape", target) — pseudo-entries are resolved by the callers.
    """
    name = cfg.get("name", "")
    act = _map_activation(cfg.get("activation")) if "activation" in cfg else None

    if class_name == "Dense":
        return DenseLayer(
            name=name,
            # keras 1: output_dim/bias; keras 2: units/use_bias
            n_out=int(cfg["output_dim"] if "output_dim" in cfg else cfg["units"]),
            activation=act or "identity",
            has_bias=bool(cfg.get("bias", cfg.get("use_bias", True))),
        )
    if class_name in ("Convolution2D", "Conv2D"):
        n_out = cfg["nb_filter"] if "nb_filter" in cfg else cfg["filters"]
        kernel = (
            (int(cfg["nb_row"]), int(cfg["nb_col"]))
            if "nb_row" in cfg
            else _pair(cfg["kernel_size"])
        )
        return ConvolutionLayer(
            name=name,
            n_out=int(n_out),
            kernel=kernel,
            stride=_pair(cfg.get("subsample") or cfg.get("strides"), (1, 1)),
            convolution_mode=_conv_mode(cfg.get("border_mode", cfg.get("padding", "valid"))),
            activation=act or "identity",
            has_bias=bool(cfg.get("bias", cfg.get("use_bias", True))),
        )
    if class_name in ("MaxPooling2D", "AveragePooling2D"):
        return SubsamplingLayer(
            name=name,
            pooling_type="max" if class_name.startswith("Max") else "avg",
            kernel=_pair(cfg.get("pool_size"), (2, 2)),
            stride=_pair(cfg.get("strides") or cfg.get("pool_size"), (2, 2)),
            convolution_mode=_conv_mode(cfg.get("border_mode", cfg.get("padding", "valid"))),
        )
    if class_name in ("GlobalMaxPooling2D", "GlobalAveragePooling2D",
                      "GlobalMaxPooling1D", "GlobalAveragePooling1D"):
        return GlobalPoolingLayer(
            name=name,
            pooling_type="max" if "Max" in class_name else "avg",
        )
    if class_name == "BatchNormalization":
        if int(cfg.get("mode", 0)) != 0:
            raise KerasImportError(
                "Only BatchNormalization mode=0 is importable (feature-wise)"
            )
        return BatchNormalization(
            name=name,
            eps=float(cfg.get("epsilon", 1e-5)),
            decay=float(cfg.get("momentum", 0.99)),
        )
    if class_name == "LSTM":
        layer = GravesLSTM(
            name=name,
            n_out=int(cfg["output_dim"]),
            activation=_map_activation(cfg.get("activation", "tanh")),
            gate_activation=_map_activation(cfg.get("inner_activation", "hard_sigmoid")),
            forget_gate_bias_init=1.0 if cfg.get("unit_forget_bias", True) else 0.0,
        )
        return (layer, bool(cfg.get("return_sequences", False)))
    if class_name == "Embedding":
        return RnnEmbeddingLayer(
            name=name,
            n_in=int(cfg["input_dim"]),
            n_out=int(cfg["output_dim"]),
        )
    if class_name == "Dropout":
        # keras 'p' and our 'dropout' are both drop probabilities
        return DropoutLayer(name=name, dropout=float(cfg.get("p", 0.5)))
    if class_name == "Activation":
        return ActivationLayer(name=name, activation=act or "identity")
    if class_name == "ZeroPadding2D":
        pad = cfg.get("padding", (1, 1))
        if isinstance(pad, (list, tuple)) and len(pad) == 2:
            return ZeroPaddingLayer(
                name=name,
                pad_top=int(pad[0]), pad_bottom=int(pad[0]),
                pad_left=int(pad[1]), pad_right=int(pad[1]),
            )
        if isinstance(pad, (list, tuple)) and len(pad) == 4:
            return ZeroPaddingLayer(
                name=name,
                pad_top=int(pad[0]), pad_bottom=int(pad[1]),
                pad_left=int(pad[2]), pad_right=int(pad[3]),
            )
        raise KerasImportError(f"Unsupported ZeroPadding2D padding {pad!r}")
    if class_name == "Flatten":
        return ("flatten",)
    if class_name == "InputLayer":
        return ("input",)
    if class_name == "Merge":
        return ("merge", cfg.get("mode", "concat"))
    if class_name in ("TimeDistributedDense", "TimeDistributed"):
        raise KerasImportError(f"Unsupported Keras layer '{class_name}'")
    raise KerasImportError(f"Unsupported Keras layer '{class_name}'")


# ---------------------------------------------------------------------------
# sequential path
# ---------------------------------------------------------------------------


def import_keras_sequential_config(
    model_config: Any,
    training_config: Optional[dict] = None,
) -> Tuple[MultiLayerConfiguration, List[Optional[str]]]:
    """Keras Sequential JSON → MultiLayerConfiguration.

    Returns (config, keras_name_per_layer) where the second list maps each of
    our layer indices to the Keras layer name whose weights feed it (None for
    importer-inserted layers like LastTimeStep).
    """
    if isinstance(model_config, str):
        model_config = json.loads(model_config)
    if isinstance(model_config, dict):
        if model_config.get("class_name") != "Sequential":
            raise KerasImportError(
                f"Not a Sequential model: {model_config.get('class_name')}"
            )
        layer_dicts = model_config["config"]
        if isinstance(layer_dicts, dict):  # keras2: {"layers": [...]}
            layer_dicts = layer_dicts["layers"]
    else:
        layer_dicts = model_config

    layers: List[Any] = []
    keras_names: List[Optional[str]] = []
    preprocessors: Dict[int, Any] = {}
    input_type: Optional[InputType] = None
    pending_flatten = False
    current_kind: Optional[str] = None  # "cnn" | "ff" | "rnn"

    input_ordering = (
        "th" if _model_channels_first(layer_dicts, _dim_orderings(layer_dicts)) else "tf"
    )
    for ld in layer_dicts:
        class_name = ld["class_name"]
        cfg = ld.get("config", ld)
        if input_type is None:
            shape = cfg.get("batch_input_shape")
            if shape is not None:
                input_type = _input_type_from_shape(shape, input_ordering)
            elif "input_dim" in cfg:
                input_type = InputType.feed_forward(int(cfg["input_dim"]))
        translated = _translate_layer(class_name, cfg)
        if translated == ("input",):
            continue
        if translated == ("flatten",):
            pending_flatten = True
            continue
        return_sequences = True
        if isinstance(translated, tuple) and isinstance(translated[0], GravesLSTM):
            translated, return_sequences = translated

        idx = len(layers)
        if pending_flatten:
            if current_kind == "cnn" or (current_kind is None and input_type and input_type.kind == "cnn"):
                preprocessors[idx] = CnnToFeedForwardPreProcessor()
            elif current_kind == "rnn":
                preprocessors[idx] = RnnToFeedForwardPreProcessor()
            pending_flatten = False
        layers.append(translated)
        keras_names.append(cfg.get("name") or None)
        if isinstance(translated, ConvolutionLayer) or isinstance(translated, SubsamplingLayer):
            current_kind = "cnn"
        elif isinstance(translated, (GravesLSTM, RnnEmbeddingLayer)):
            current_kind = "rnn"
        elif isinstance(translated, (DenseLayer, GlobalPoolingLayer)):
            current_kind = "ff"

        if isinstance(translated, GravesLSTM) and not return_sequences:
            layers.append(LastTimeStepLayer())
            keras_names.append(None)
            current_kind = "ff"

    if input_type is None:
        raise KerasImportError(
            "Model config declares no input shape (batch_input_shape/input_dim)"
        )

    # fold trailing loss into an OutputLayer (reference: enforceTrainingConfig path)
    if training_config and "loss" in training_config:
        loss = _map_loss(
            training_config["loss"]
            if isinstance(training_config["loss"], str)
            else list(training_config["loss"].values())[0]
        )
        _fold_output_layer(layers, keras_names, loss)

    updater = _updater_from_training_config(training_config)
    return (
        MultiLayerConfiguration(
            layers=layers,
            input_type=input_type,
            updater=updater,
            preprocessors=preprocessors,
        ),
        keras_names,
    )


def _fold_output_layer(layers: List[Any], keras_names: List[Optional[str]], loss: str) -> None:
    """Turn the trailing Dense(+Activation) into an OutputLayer with the loss."""
    if not layers:
        return
    last = layers[-1]
    if isinstance(last, ActivationLayer) and len(layers) >= 2 and type(layers[-2]) is DenseLayer:
        dense = layers[-2]
        out = OutputLayer(
            name=dense.name, n_out=dense.n_out, activation=last.activation,
            has_bias=dense.has_bias, loss=loss,
        )
        name = keras_names[-2]
        del layers[-2:], keras_names[-2:]
        layers.append(out)
        keras_names.append(name)
    elif type(last) is DenseLayer:
        out = OutputLayer(
            name=last.name, n_out=last.n_out, activation=last.activation,
            has_bias=last.has_bias, loss=loss,
        )
        name = keras_names[-1]
        del layers[-1:], keras_names[-1:]
        layers.append(out)
        keras_names.append(name)
    elif isinstance(last, GravesLSTM):
        layers.append(RnnOutputLayer(n_out=last.n_out, activation="identity", loss=loss))
        keras_names.append(None)


# ---------------------------------------------------------------------------
# functional (graph) path
# ---------------------------------------------------------------------------

_MERGE_MODES = {"sum": "add", "mul": "product", "max": "max", "ave": "average"}


def import_keras_model_config(
    model_config: Any,
    training_config: Optional[dict] = None,
) -> Tuple[ComputationGraphConfiguration, Dict[str, str]]:
    """Keras functional-Model JSON → ComputationGraphConfiguration.

    Returns (config, {vertex_name: keras_layer_name}) for weight transfer.
    """
    if isinstance(model_config, str):
        model_config = json.loads(model_config)
    if model_config.get("class_name") == "Sequential":
        raise KerasImportError("Use import_keras_sequential_config for Sequential models")
    cfg = model_config["config"]
    layer_dicts = cfg["layers"]
    input_layers = [x[0] for x in cfg["input_layers"]]
    output_layers = [x[0] for x in cfg["output_layers"]]

    builder = ComputationGraphConfiguration.builder()
    builder.add_inputs(*input_layers)
    name_map: Dict[str, str] = {}
    input_types: Dict[str, InputType] = {}
    # kind of each vertex's output, for Flatten/preprocessor decisions
    kind: Dict[str, str] = {}
    input_ordering = (
        "th" if _model_channels_first(layer_dicts, _dim_orderings(layer_dicts)) else "tf"
    )

    for ld in layer_dicts:
        class_name = ld["class_name"]
        lcfg = ld.get("config", ld)
        lname = ld.get("name") or lcfg.get("name")
        inbound = [n[0] for n in (ld.get("inbound_nodes") or [[]])[0]]

        if class_name == "InputLayer":
            shape = lcfg.get("batch_input_shape")
            input_types[lname] = _input_type_from_shape(shape, input_ordering)
            kind[lname] = input_types[lname].kind
            continue

        translated = _translate_layer(class_name, lcfg)
        if translated == ("flatten",):
            src = inbound[0]
            preproc = (
                RnnToFeedForwardPreProcessor()
                if kind.get(src) == "rnn"
                else CnnToFeedForwardPreProcessor()
            )
            builder.add_vertex(
                lname, PreprocessorVertex(preprocessor=preproc), src
            )
            kind[lname] = "ff"
            continue
        if isinstance(translated, tuple) and translated[0] == "merge":
            mode = translated[1]
            if mode in ("concat", "concat_along_depth"):
                builder.add_vertex(lname, MergeVertex(), *inbound)
            elif mode in _MERGE_MODES:
                builder.add_vertex(lname, ElementWiseVertex(op=_MERGE_MODES[mode]), *inbound)
            else:
                raise KerasImportError(f"Unsupported Merge mode '{mode}'")
            kind[lname] = kind.get(inbound[0], "ff")
            continue
        return_sequences = True
        if isinstance(translated, tuple) and isinstance(translated[0], GravesLSTM):
            translated, return_sequences = translated
        builder.add_layer(lname, translated, *inbound)
        name_map[lname] = lname
        kind[lname] = (
            "cnn" if isinstance(translated, (ConvolutionLayer, SubsamplingLayer, ZeroPaddingLayer))
            else "rnn" if isinstance(translated, (GravesLSTM, RnnEmbeddingLayer))
            else kind.get(inbound[0] if inbound else "", "ff")
        )
        if isinstance(translated, GravesLSTM) and not return_sequences:
            post = f"{lname}__last"
            builder.add_layer(post, LastTimeStepLayer(), lname)
            # downstream layers consume the inserted vertex
            _rename_downstream(layer_dicts, lname, post)
            kind[post] = "ff"

    builder.set_outputs(*[_resolve_output(n, layer_dicts) for n in output_layers])
    if input_types:
        builder.set_input_types(*[input_types[n] for n in input_layers])
    if training_config:
        builder.updater(_updater_from_training_config(training_config))
    return builder.build(), name_map


def _rename_downstream(layer_dicts, old: str, new: str) -> None:
    for ld in layer_dicts:
        for node in ld.get("inbound_nodes") or []:
            for ref in node:
                if ref[0] == old:
                    ref[0] = new


def _resolve_output(name: str, layer_dicts) -> str:
    for ld in layer_dicts:
        lname = ld.get("name") or ld.get("config", {}).get("name")
        if lname == name and ld["class_name"] == "LSTM" and not ld.get(
            "config", {}
        ).get("return_sequences", False):
            return f"{name}__last"
    return name


# ---------------------------------------------------------------------------
# weight transfer
# ---------------------------------------------------------------------------


def _weight_suffix(weight_name: str, layer_name: str) -> str:
    """'dense_1_W' → 'W'; 'dense_1/kernel:0' → 'kernel'."""
    n = weight_name.split("/")[-1]
    if n.endswith(":0"):
        n = n[:-2]
    prefix = layer_name + "_"
    if n.startswith(prefix):
        n = n[len(prefix):]
    return n


def _find(weights: Dict[str, np.ndarray], layer_name: str, *suffixes: str):
    for k, v in weights.items():
        if _weight_suffix(k, layer_name) in suffixes:
            return v
    return None


# Keras 2 renamed the conv classes; their kernels are always stored HWIO
# regardless of data_format (only Keras 1 'th' kernels are OIHW).
_KERAS2_CONV_CLASSES = {"Conv1D", "Conv2D", "Conv3D", "SeparableConv2D", "Conv2DTranspose"}
_CONV_CLASSES = _KERAS2_CONV_CLASSES | {"Convolution1D", "Convolution2D", "Convolution3D", "AtrousConvolution2D"}


def _layer_dicts_of(model_config: Any) -> list:
    if isinstance(model_config, str):
        model_config = json.loads(model_config)
    if isinstance(model_config, dict):
        cfgs = model_config.get("config")
        if isinstance(cfgs, dict):
            cfgs = cfgs.get("layers", [])
        return cfgs or []
    return model_config or []


def _dim_orderings(model_config: Any) -> Dict[str, str]:
    """{keras layer name: layout tag}.

    - ``'th'``    Keras 1 channels-first: OIHW conv kernels AND channels-first
      activations (this is the only tag that triggers a kernel transpose).
    - ``'th-k2'`` Keras 2 ``data_format=channels_first``: kernels already HWIO,
      activations channels-first (flatten order still needs permuting).
    - ``'tf'``    channels-last throughout.

    Keras 1 layers (``dim_ordering`` key, or no marker at all) default to
    'th'; Keras 2 layers (``data_format`` key or Keras-2 conv class names)
    default to 'tf' — a channels-last Conv2D kernel must NOT be transposed.
    """
    out: Dict[str, str] = {}
    for ld in _layer_dicts_of(model_config):
        c = ld.get("config", ld)
        name = ld.get("name") or c.get("name")
        if not name:
            continue
        cls = ld.get("class_name", "")
        if "dim_ordering" in c:
            out[name] = "th" if c["dim_ordering"] == "th" else "tf"
        elif c.get("data_format") == "channels_first":
            out[name] = "th-k2"
        elif "data_format" in c or cls in _KERAS2_CONV_CLASSES:
            out[name] = "tf"
        else:
            out[name] = "th"
    return out


def _model_channels_first(model_config: Any, orderings: Dict[str, str]) -> bool:
    """Are this model's image activations channels-first? Decided by the conv
    stack when one exists; a conv-free model is channels-first only when it
    carries no Keras 2 markers at all (Keras 1 'th' default)."""
    lds = _layer_dicts_of(model_config)
    if any(ld.get("class_name") in _CONV_CLASSES for ld in lds):
        return _channels_first_flatten(model_config, orderings)
    for ld in lds:
        c = ld.get("config", ld)
        if "data_format" in c or ld.get("class_name") in _KERAS2_CONV_CLASSES:
            return False
    return True


def _channels_first_flatten(model_config: Any, orderings: Dict[str, str]) -> bool:
    """True if the model's conv stack is channels-first, i.e. a Keras Flatten
    emitted rows in C,H,W order while our CnnToFeedForwardPreProcessor flattens
    NHWC (H,W,C) — the following Dense kernel's rows must be permuted."""
    for ld in _layer_dicts_of(model_config):
        if ld.get("class_name") in _CONV_CLASSES:
            c = ld.get("config", ld)
            name = ld.get("name") or c.get("name")
            if orderings.get(name, "th") in ("th", "th-k2"):
                return True
    return False


def _permute_th_flatten_dense_kernel(w: np.ndarray, h: int, wd: int, c: int) -> np.ndarray:
    """Reorder Dense kernel rows from channels-first flatten order (C,H,W) to
    our NHWC flatten order (H,W,C). Shapes coincide (C*H*W == H*W*C) so this
    corruption is silent without the permutation (ADVICE round 1, high)."""
    n_out = w.shape[-1]
    return np.ascontiguousarray(
        w.reshape(c, h, wd, n_out).transpose(1, 2, 0, 3).reshape(h * wd * c, n_out)
    )


def _cnn_flatten_dense_indices(conf) -> Dict[int, Tuple[int, int, int]]:
    """{layer idx: (h, w, c)} for Dense-family layers that consume a
    CnnToFeedForwardPreProcessor flatten of a CNN activation."""
    out: Dict[int, Tuple[int, int, int]] = {}
    cur = conf.input_type
    for i, layer in enumerate(conf.layers):
        pre = conf.preprocessors.get(i)
        if (
            isinstance(pre, CnnToFeedForwardPreProcessor)
            and cur.kind == "cnn"
            and isinstance(layer, DenseLayer)
        ):
            out[i] = (cur.height, cur.width, cur.channels)
        if pre is not None:
            cur = pre.get_output_type(cur)
        cur = layer.get_output_type(cur)
    return out


def _convert_layer_weights(
    layer, weights: Dict[str, np.ndarray], layer_name: str, dim_ordering: str = "th"
):
    """Keras arrays → (params_update, state_update) for one of our layers."""
    params: Dict[str, np.ndarray] = {}
    state: Dict[str, np.ndarray] = {}
    if isinstance(layer, ConvolutionLayer):
        w = _find(weights, layer_name, "W", "kernel")
        if w is not None:
            if w.ndim != 4:
                raise KerasImportError(f"Conv weight rank {w.ndim} != 4")
            if dim_ordering == "th":  # OIHW → HWIO
                w = np.transpose(w, (2, 3, 1, 0))
            params["W"] = w
        b = _find(weights, layer_name, "b", "bias")
        if b is not None and layer.has_bias:
            params["b"] = b
    elif isinstance(layer, BatchNormalization):
        for src, dst in (("gamma", "gamma"), ("beta", "beta")):
            v = _find(weights, layer_name, src)
            if v is not None:
                params[dst] = v
        mean = _find(weights, layer_name, "running_mean", "moving_mean")
        # keras 1.x 'running_std' actually holds the variance
        var = _find(weights, layer_name, "running_std", "running_var", "moving_variance")
        if mean is not None:
            state["mean"] = mean
        if var is not None:
            state["var"] = var
    elif isinstance(layer, GravesLSTM):
        H = layer.n_out
        # our gate column order is [a(candidate), f, o, i] (LSTMHelpers parity)
        order = ("c", "f", "o", "i")
        Ws = [_find(weights, layer_name, f"W_{g}") for g in order]
        Us = [_find(weights, layer_name, f"U_{g}") for g in order]
        bs = [_find(weights, layer_name, f"b_{g}") for g in order]
        if any(w is not None for w in Ws + Us + bs) and not all(
            w is not None for w in Ws + Us + bs
        ):
            missing = [
                f"{kind}_{g}"
                for kind, arrs in (("W", Ws), ("U", Us), ("b", bs))
                for g, a in zip(order, arrs)
                if a is None
            ]
            raise KerasImportError(
                f"LSTM layer '{layer_name}' is missing weight arrays: {missing}"
            )
        if all(w is not None for w in Ws):
            params["W"] = np.concatenate(Ws, axis=1)
            params["RW"] = np.concatenate(Us, axis=1)
            params["b"] = np.concatenate(bs, axis=0)
            # keras has no peepholes → zeros
            params["pF"] = np.zeros(H, dtype=params["W"].dtype)
            params["pI"] = np.zeros(H, dtype=params["W"].dtype)
            params["pO"] = np.zeros(H, dtype=params["W"].dtype)
    elif isinstance(layer, (DenseLayer, RnnEmbeddingLayer)):  # incl. OutputLayer
        w = _find(weights, layer_name, "W", "kernel", "embeddings")
        if w is not None:
            params["W"] = w
        b = _find(weights, layer_name, "b", "bias")
        if b is not None and getattr(layer, "has_bias", True):
            params["b"] = b
    return params, state


def _apply_updates(orig_params, orig_state, updates, state_updates):
    """One layer's host params and state with the archive's arrays put in,
    shapes checked against the model's."""
    new_params = dict(orig_params)
    for k, v in updates.items():
        if k in orig_params:
            expect = tuple(orig_params[k].shape)
            if tuple(v.shape) != expect:
                raise KerasImportError(
                    f"Weight shape mismatch for '{k}': keras {v.shape} vs model {expect}"
                )
        new_params[k] = np.asarray(v, dtype=orig_params[k].dtype if k in orig_params else None)
    new_state = dict(orig_state) if isinstance(orig_state, dict) else orig_state
    for k, v in state_updates.items():
        new_state[k] = np.asarray(v)
    return new_params, new_state


# ---------------------------------------------------------------------------
# public facade (reference: KerasModelImport.java)
# ---------------------------------------------------------------------------


def import_keras_sequential_model_and_weights(
    path: str, enforce_training_config: bool = True, device="cuda"
):
    """HDF5 full-model archive → initialized MultiLayerNetwork on ``device``.

    Reference: KerasModelImport.importKerasSequentialModelAndWeights.
    """
    from ..nn.multilayer import MultiLayerNetwork, resolve_device  # noqa: PLC0415

    resolve_device(device)
    model_config = hdf5.read_model_config(path)
    if model_config is None:
        raise KerasImportError(f"No model_config attribute in {path}")
    training_config = hdf5.read_training_config(path) if enforce_training_config else None
    conf, keras_names = import_keras_sequential_config(model_config, training_config)
    net = MultiLayerNetwork(conf, device=device).init()

    all_weights = hdf5.read_layer_weights(path)
    orderings = _dim_orderings(model_config)
    flatten_dense = _cnn_flatten_dense_indices(conf)
    th_flatten = _channels_first_flatten(model_config, orderings)
    new_params = params_to_numpy(net)
    new_state = state_to_numpy(net)
    for i, (layer, kname) in enumerate(zip(conf.layers, keras_names)):
        if not kname or kname not in all_weights:
            continue
        p_upd, s_upd = _convert_layer_weights(
            layer, all_weights[kname], kname, orderings.get(kname, "th")
        )
        if th_flatten and i in flatten_dense and p_upd.get("W") is not None:
            h, wd, c = flatten_dense[i]
            p_upd["W"] = _permute_th_flatten_dense_kernel(np.asarray(p_upd["W"]), h, wd, c)
        new_params[i], new_state[i] = _apply_updates(
            new_params[i], new_state[i], p_upd, s_upd
        )
    return load_jax_params(net, new_params, new_state)


def import_keras_model_and_weights(path: str, enforce_training_config: bool = True,
                                   device="cuda"):
    """HDF5 full-model archive → initialized ComputationGraph on ``device``
    (a MultiLayerNetwork for a Sequential model).

    Reference: KerasModelImport.importKerasModelAndWeights (KerasModelImport.java:48).
    """
    from ..nn.graph.computation_graph import ComputationGraph  # noqa: PLC0415
    from ..nn.multilayer import resolve_device  # noqa: PLC0415

    resolve_device(device)
    model_config = hdf5.read_model_config(path)
    if model_config is None:
        raise KerasImportError(f"No model_config attribute in {path}")
    if model_config.get("class_name") == "Sequential":
        return import_keras_sequential_model_and_weights(path, enforce_training_config,
                                                         device=device)
    training_config = hdf5.read_training_config(path) if enforce_training_config else None
    conf, name_map = import_keras_model_config(model_config, training_config)
    net = ComputationGraph(conf, device=device).init()

    all_weights = hdf5.read_layer_weights(path)
    orderings = _dim_orderings(model_config)
    th_flatten = _channels_first_flatten(model_config, orderings)
    try:
        vtypes = conf.vertex_input_types() if conf.input_types else {}
    except ValueError:
        vtypes = {}
    new_params = params_to_numpy(net)
    new_state = state_to_numpy(net)
    for vname, kname in name_map.items():
        if kname not in all_weights:
            continue
        vertex = conf.vertices[vname]
        layer = getattr(vertex, "layer", None)
        if layer is None:
            continue
        p_upd, s_upd = _convert_layer_weights(
            layer, all_weights[kname], kname, orderings.get(kname, "th")
        )
        if th_flatten and isinstance(layer, DenseLayer) and p_upd.get("W") is not None:
            srcs = conf.vertex_inputs.get(vname, [])
            sv = conf.vertices.get(srcs[0]) if len(srcs) == 1 else None
            if isinstance(sv, PreprocessorVertex) and isinstance(
                getattr(sv, "preprocessor", None), CnnToFeedForwardPreProcessor
            ):
                it = (vtypes.get(srcs[0]) or [None])[0]
                if it is not None and it.kind == "cnn":
                    p_upd["W"] = _permute_th_flatten_dense_kernel(
                        np.asarray(p_upd["W"]), it.height, it.width, it.channels
                    )
        new_params[vname], new_state[vname] = _apply_updates(
            new_params[vname], new_state[vname], p_upd, s_upd
        )
    return load_jax_params(net, new_params, new_state)
