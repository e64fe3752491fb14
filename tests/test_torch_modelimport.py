"""Keras import in the port (``deeplearning4j_tpu_torch/modelimport``,
``utils/model_guesser.py``) against the JAX package's on the same archives,
on ``device="cpu"``.

Archives are written here with h5py, in the Keras 1.x layout of
``tests/test_modelimport.py``, and again with the port's numpy writer
(``scripts/torch_write_keras_h5.py``); both packages import each. The confs
are equal (their JSON), the params bit for bit (JAX's are the archive's f32
values widened to f64 under x64) and the outputs within ``OUT_ATOL``. The
port reads the files with its own reader (``modelimport/hdf5.py``, no h5py),
which is held against h5py attribute by attribute and array by array, and
h5py reads every file the writer makes. The Keras LSTM text generator at
width 128 is served and takes two RMSprop updates in both packages (JAX with
x64 off and f32 params, as ``tests/test_torch_updaters.py`` explains).
"""

import ast
import importlib.util
import json
import zipfile
from pathlib import Path

import h5py
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import deeplearning4j_tpu.modelimport as jm  # noqa: E402
from deeplearning4j_tpu.datasets.iterators import DataSet as JaxDataSet  # noqa: E402
from deeplearning4j_tpu.modelimport import hdf5 as jax_hdf5  # noqa: E402
from deeplearning4j_tpu.modelimport import trained_models as jax_trained  # noqa: E402
from deeplearning4j_tpu.ops import kernel_select  # noqa: E402
from deeplearning4j_tpu.runtime import inference as jax_inference  # noqa: E402
from deeplearning4j_tpu.utils.model_guesser import guess_model as jax_guess  # noqa: E402

import deeplearning4j_tpu_torch as pt  # noqa: E402
import deeplearning4j_tpu_torch.modelimport as pm  # noqa: E402
from deeplearning4j_tpu_torch.modelimport import hdf5  # noqa: E402
from deeplearning4j_tpu_torch.modelimport import trained_models as port_trained  # noqa: E402
from deeplearning4j_tpu_torch.utils.model_guesser import guess_model  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "deeplearning4j_tpu_torch"
OUT_ATOL = 1e-5
TRAIN_TOL = 1e-5  # params and losses after the RMSprop updates (both f32)


def _load_writer():
    spec = importlib.util.spec_from_file_location(
        "torch_write_keras_h5", ROOT / "scripts" / "torch_write_keras_h5.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


W = _load_writer()


@pytest.fixture(autouse=True)
def jax_env(monkeypatch, tmp_path):
    monkeypatch.setattr(jax_inference, "fast_path_enabled", lambda: False)
    monkeypatch.setenv("DL4JTPU_KERNEL_CALIBRATION", str(tmp_path / "calibration.json"))
    kernel_select.reset()
    yield
    kernel_select.reset()


# ---------------------------------------------------------------------------
# archives
# ---------------------------------------------------------------------------


def write_h5py(path, model_config, training_config, layer_weights):
    """layer_weights: {layer_name: [(weight_name, array), ...]} (the JAX
    test's writer)."""
    with h5py.File(path, "w") as f:
        f.attrs["model_config"] = json.dumps(model_config).encode()
        if training_config is not None:
            f.attrs["training_config"] = json.dumps(training_config).encode()
        g = f.create_group("model_weights")
        g.attrs["layer_names"] = np.array([n.encode() for n in layer_weights], dtype="S64")
        for lname, weights in layer_weights.items():
            lg = g.create_group(lname)
            lg.attrs["weight_names"] = np.array([wn.encode() for wn, _ in weights],
                                                dtype="S64")
            for wn, arr in weights:
                lg.create_dataset(wn, data=arr)


def write_numpy(path, model_config, training_config, layer_weights):
    W.write_h5(path, W.keras_model_archive(model_config, training_config, layer_weights))


WRITERS = {"h5py": write_h5py, "numpy_writer": write_numpy}


def _dense_cfg(name, n_out, activation, input_shape=None):
    cfg = {"name": name, "output_dim": n_out, "activation": activation, "bias": True}
    if input_shape is not None:
        cfg["batch_input_shape"] = input_shape
    return {"class_name": "Dense", "config": cfg}


ADAM_TC = {
    "optimizer_config": {"class_name": "Adam", "config": {"lr": 0.002, "beta_1": 0.9}},
    "loss": "categorical_crossentropy",
}


def case_mlp(rng):
    mc = {"class_name": "Sequential", "config": [
        _dense_cfg("dense_1", 8, "relu", input_shape=[None, 5]),
        _dense_cfg("dense_2", 3, "softmax")]}
    lw = {"dense_1": [("dense_1_W", rng.normal(size=(5, 8))), ("dense_1_b", rng.normal(size=8))],
          "dense_2": [("dense_2_W", rng.normal(size=(8, 3))), ("dense_2_b", rng.normal(size=3))]}
    return mc, ADAM_TC, lw, rng.normal(size=(4, 5))


def case_th_cnn(rng):
    mc = {"class_name": "Sequential", "config": [
        {"class_name": "Convolution2D", "config": {
            "name": "conv1", "nb_filter": 2, "nb_row": 3, "nb_col": 3, "subsample": [1, 1],
            "border_mode": "valid", "dim_ordering": "th", "activation": "relu",
            "batch_input_shape": [None, 1, 8, 8], "bias": True}},
        {"class_name": "MaxPooling2D", "config": {
            "name": "pool1", "pool_size": [2, 2], "strides": [2, 2], "border_mode": "valid",
            "dim_ordering": "th"}},
        {"class_name": "Flatten", "config": {"name": "flatten_1"}},
        _dense_cfg("dense_1", 4, "softmax")]}
    lw = {"conv1": [("conv1_W", rng.normal(size=(2, 1, 3, 3))), ("conv1_b", rng.normal(size=2))],
          "pool1": [], "flatten_1": [],
          "dense_1": [("dense_1_W", rng.normal(size=(18, 4))), ("dense_1_b", np.zeros(4))]}
    return mc, ADAM_TC, lw, rng.normal(size=(2, 8, 8, 1))


def case_lstm(rng):
    n_in, H = 4, 3
    gates = [(f"lstm_1_{k}_{g}", rng.normal(size=shape))
             for g in ("i", "c", "f", "o")
             for k, shape in (("W", (n_in, H)), ("U", (H, H)), ("b", (H,)))]
    mc = {"class_name": "Sequential", "config": [
        {"class_name": "LSTM", "config": {
            "name": "lstm_1", "output_dim": H, "activation": "tanh",
            "inner_activation": "hard_sigmoid", "return_sequences": False,
            "batch_input_shape": [None, 6, n_in]}},
        _dense_cfg("dense_1", 2, "softmax")]}
    lw = {"lstm_1": gates,
          "dense_1": [("dense_1_W", rng.normal(size=(H, 2))), ("dense_1_b", np.zeros(2))]}
    return mc, ADAM_TC, lw, rng.normal(size=(2, 6, n_in))


def case_batchnorm(rng):
    n = 5
    mc = {"class_name": "Sequential", "config": [
        _dense_cfg("dense_1", n, "linear", input_shape=[None, n]),
        {"class_name": "BatchNormalization", "config": {
            "name": "bn_1", "epsilon": 1e-3, "mode": 0, "momentum": 0.9}}]}
    lw = {"dense_1": [("dense_1_W", np.eye(n)), ("dense_1_b", np.zeros(n))],
          "bn_1": [("bn_1_gamma", np.full(n, 2.0)), ("bn_1_beta", np.full(n, -1.0)),
                   ("bn_1_running_mean", np.arange(n, dtype=float)),
                   ("bn_1_running_std", np.full(n, 4.0))]}
    return mc, None, lw, np.tile(np.arange(n, dtype=float), (3, 1))


def case_merge(rng):
    def layer(cls, name, cfg, inbound):
        return {"class_name": cls, "name": name, "config": {"name": name, **cfg},
                "inbound_nodes": [[[n, 0, 0] for n in inbound]] if inbound else []}
    dense = {"activation": "relu", "bias": True}
    mc = {"class_name": "Model", "config": {
        "layers": [layer("InputLayer", "input_1", {"batch_input_shape": [None, 4]}, []),
                   layer("Dense", "branch_a", {"output_dim": 6, **dense}, ["input_1"]),
                   layer("Dense", "branch_b", {"output_dim": 6, **dense}, ["input_1"]),
                   layer("Merge", "merge_1", {"mode": "sum"}, ["branch_a", "branch_b"]),
                   layer("Dense", "out", {"output_dim": 2, "activation": "softmax",
                                          "bias": True}, ["merge_1"])],
        "input_layers": [["input_1", 0, 0]], "output_layers": [["out", 0, 0]]}}
    lw = {"branch_a": [("branch_a_W", rng.normal(size=(4, 6))), ("branch_a_b", np.zeros(6))],
          "branch_b": [("branch_b_W", rng.normal(size=(4, 6))), ("branch_b_b", np.zeros(6))],
          "out": [("out_W", rng.normal(size=(6, 2))), ("out_b", np.zeros(2))]}
    return mc, None, lw, rng.normal(size=(3, 4))


def case_th_flatten(rng):
    C, H, Wd, O = 2, 5, 5, 3
    mc = {"class_name": "Sequential", "config": [
        {"class_name": "Convolution2D", "config": {
            "name": "conv_1", "nb_filter": O, "nb_row": 2, "nb_col": 2, "subsample": [1, 1],
            "border_mode": "valid", "dim_ordering": "th", "activation": "relu", "bias": True,
            "batch_input_shape": [None, C, H, Wd]}},
        {"class_name": "Flatten", "config": {"name": "flatten_1"}},
        _dense_cfg("dense_1", 4, "linear")]}
    lw = {"conv_1": [("conv_1_W", rng.normal(size=(O, C, 2, 2))), ("conv_1_b", rng.normal(size=O))],
          "flatten_1": [],
          "dense_1": [("dense_1_W", rng.normal(size=(O * 16, 4))), ("dense_1_b", rng.normal(size=4))]}
    return mc, None, lw, rng.normal(size=(2, H, Wd, C))


def case_keras2(rng):
    C, H, Wd, O = 2, 5, 5, 3
    mc = {"class_name": "Sequential", "config": {"layers": [
        {"class_name": "Conv2D", "config": {
            "name": "conv_1", "filters": O, "kernel_size": [2, 2], "strides": [1, 1],
            "padding": "valid", "data_format": "channels_last", "activation": "relu",
            "use_bias": True, "batch_input_shape": [None, H, Wd, C]}},
        {"class_name": "Flatten", "config": {"name": "flatten_1"}},
        {"class_name": "Dense", "config": {"name": "dense_1", "units": 4,
                                           "activation": "linear", "use_bias": True}}]}}
    lw = {"conv_1": [("conv_1/kernel:0", rng.normal(size=(2, 2, C, O))),
                     ("conv_1/bias:0", rng.normal(size=O))],
          "flatten_1": [],
          "dense_1": [("dense_1/kernel:0", rng.normal(size=(16 * O, 4))),
                      ("dense_1/bias:0", rng.normal(size=4))]}
    return mc, None, lw, rng.normal(size=(2, H, Wd, C))


CASES = {"mlp": case_mlp, "th_cnn_transpose": case_th_cnn, "lstm_gates": case_lstm,
         "batchnorm_state": case_batchnorm, "functional_merge": case_merge,
         "th_flatten_parity": case_th_flatten, "keras2_channels_last": case_keras2}


def _f32_arrays(case, seed):
    mc, tc, lw, x = case(np.random.default_rng(seed))
    lw = {ln: [(wn, np.asarray(a, np.float32)) for wn, a in ws] for ln, ws in lw.items()}
    return mc, tc, lw, np.asarray(x, np.float32)


def _port_leaves(net):
    return [layer[k].detach().numpy() for layer in net._leaves() for k in sorted(layer)]


def assert_same_import(jnet, pnet, x):
    """Equal conf JSON, params and layer state bit for bit, outputs close."""
    assert pnet.conf.to_json() == jnet.conf.to_json()
    jp = jax.tree_util.tree_leaves(jnet.params)
    pp = _port_leaves(pnet)
    assert len(jp) == len(pp)
    for j, p in zip(jp, pp):
        np.testing.assert_array_equal(p, np.asarray(j, np.float32))
    js = [np.asarray(a, np.float32) for a in jax.tree_util.tree_leaves(jnet.state)]
    ps = [t.detach().numpy() for t in pnet.state_leaves()]
    assert len(js) == len(ps)
    for j, p in zip(js, ps):
        np.testing.assert_array_equal(p, j)
    np.testing.assert_allclose(pnet.output(x), np.asarray(jnet.output(x)), atol=OUT_ATOL,
                               rtol=OUT_ATOL)


@pytest.mark.parametrize("writer", WRITERS)
@pytest.mark.parametrize("name", CASES)
def test_import_matches_jax(name, writer, tmp_path):
    mc, tc, lw, x = _f32_arrays(CASES[name], seed=sorted(CASES).index(name))
    path = str(tmp_path / f"{name}.h5")
    WRITERS[writer](path, mc, tc, lw)
    jnet = jm.import_keras_model_and_weights(path)
    pnet = pm.import_keras_model_and_weights(path, device="cpu")
    assert type(pnet).__name__ == type(jnet).__name__
    assert_same_import(jnet, pnet, x)
    if name == "th_flatten_parity":  # the Keras/Theano math, not only JAX's
        (_, wc), (_, bc) = lw["conv_1"]
        (_, wd), (_, bd) = lw["dense_1"]
        xc = x.transpose(0, 3, 1, 2).astype(np.float64)
        conv = torch.nn.functional.conv2d(torch.from_numpy(xc), torch.from_numpy(
            wc.astype(np.float64)), torch.from_numpy(bc.astype(np.float64))).relu()
        ref = conv.reshape(len(x), -1).numpy() @ wd + bd
        np.testing.assert_allclose(pnet.output(x), ref, rtol=2e-5, atol=2e-5)
    if name == "lstm_gates":
        H = 3
        W = pnet.layer_params[0]["W"].detach().numpy()
        for i, g in enumerate(("c", "f", "o", "i")):  # the port's gate blocks
            np.testing.assert_array_equal(W[:, i * H:(i + 1) * H], dict(lw["lstm_1"])[f"lstm_1_W_{g}"])
        assert pnet.conf.layers[0].gate_activation == "hardsigmoid"


@pytest.mark.parametrize("name", ["mlp", "lstm_gates", "functional_merge"])
def test_config_paths_match_jax(name):
    """The config-only functions (no archive, no device) give JAX's confs
    and the same Keras name maps."""
    mc, tc, _, _ = _f32_arrays(CASES[name], seed=0)
    fn = "import_keras_model_config" if name == "functional_merge" else (
        "import_keras_sequential_config")
    jconf, jnames = getattr(jm, fn)(json.loads(json.dumps(mc)), tc)
    pconf, pnames = getattr(pm, fn)(json.loads(json.dumps(mc)), tc)
    assert pconf.to_json() == jconf.to_json()
    assert pnames == jnames


def test_config_only_dropout_and_output_fold():
    mc = {"class_name": "Sequential", "config": [
        _dense_cfg("d1", 16, "relu", input_shape=[None, 10]),
        {"class_name": "Dropout", "config": {"name": "do", "p": 0.25}},
        _dense_cfg("d2", 2, "softmax")]}
    jconf, jnames = jm.import_keras_sequential_config(mc, ADAM_TC)
    pconf, pnames = pm.import_keras_sequential_config(mc, ADAM_TC)
    assert pconf.to_json() == jconf.to_json() and pnames == jnames == ["d1", "do", "d2"]
    assert pconf.layers[1].dropout == pytest.approx(0.25)
    assert type(pconf.layers[-1]).__name__ == "OutputLayer"


@pytest.mark.parametrize("config", [
    {"class_name": "Sequential", "config": [{"class_name": "Lambda", "config": {"name": "l"}}]},
    {"class_name": "Sequential", "config": [
        {"class_name": "Dense", "config": {"name": "d", "output_dim": 2, "activation": "swish",
                                           "batch_input_shape": [None, 3]}}]},
    {"class_name": "Sequential", "config": [
        {"class_name": "BatchNormalization", "config": {"name": "b", "mode": 1}}]},
], ids=["unsupported_layer", "unsupported_activation", "bn_mode_1"])
def test_unsupported_raises_as_jax(config):
    with pytest.raises(jm.KerasImportError) as je:
        jm.import_keras_sequential_config(config)
    with pytest.raises(pm.KerasImportError) as pe:
        pm.import_keras_sequential_config(config)
    assert str(pe.value) == str(je.value)


def test_lstm_missing_gate_array_raises(tmp_path):
    mc, tc, lw, _ = _f32_arrays(case_lstm, seed=0)
    lw["lstm_1"] = [p for p in lw["lstm_1"] if p[0] != "lstm_1_U_f"]
    path = str(tmp_path / "partial.h5")
    write_numpy(path, mc, tc, lw)
    with pytest.raises(pm.KerasImportError, match="U_f"):
        pm.import_keras_sequential_model_and_weights(path, device="cpu")


def test_model_guesser_matches_jax(tmp_path):
    conf = pt.MultiLayerConfiguration(
        layers=[pt.OutputLayer(n_out=3, activation="softmax", loss="mcxent")],
        input_type=pt.InputType.feed_forward(4), updater=pt.UpdaterConfig().to_dict())
    net = pt.MultiLayerNetwork(conf, device="cpu").init()
    zpath = str(tmp_path / "model.zip")
    pt.write_model(net, zpath)
    assert zipfile.is_zipfile(zpath)
    for path in (zpath,):
        got, want = guess_model(path, device="cpu"), jax_guess(path)
        assert type(got).__name__ == type(want).__name__ == "MultiLayerNetwork"
        np.testing.assert_array_equal(_port_leaves(got)[0],
                                      np.asarray(jax.tree_util.tree_leaves(want.params)[0],
                                                 np.float32))
    jpath = str(tmp_path / "conf.json")
    Path(jpath).write_text(conf.to_json())
    got, want = guess_model(jpath, device="cpu"), jax_guess(jpath)
    assert type(got).__name__ == type(want).__name__ == "MultiLayerConfiguration"
    assert got.to_json() == want.to_json()
    mc, tc, lw, x = _f32_arrays(case_merge, seed=3)
    hpath = str(tmp_path / "graph.h5")
    write_numpy(hpath, mc, tc, lw)
    got, want = guess_model(hpath, device="cpu"), jax_guess(hpath)
    assert type(got).__name__ == type(want).__name__ == "ComputationGraph"
    assert_same_import(want, got, x)


def test_entry_points_default_to_the_card(tmp_path):
    """Without CUDA the defaults raise; device="cpu" runs."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs there")
    mc, tc, lw, _ = _f32_arrays(case_mlp, seed=0)
    path = str(tmp_path / "mlp.h5")
    write_numpy(path, mc, tc, lw)
    for call in (lambda: pm.import_keras_sequential_model_and_weights(path),
                 lambda: pm.import_keras_model_and_weights(path),
                 lambda: pm.TrainedModels.load("VGG16", path),
                 lambda: guess_model(path),
                 lambda: pt.interop.GatewayServer()):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    assert type(guess_model(path, device="cpu")).__name__ == "MultiLayerNetwork"


# ---------------------------------------------------------------------------
# the Keras LSTM text generator (examples/lstm_text_generation.py, Keras 1.2)
# ---------------------------------------------------------------------------

CHARS, MAXLEN, UNITS = 57, 40, 128
RMSPROP_TC = {"optimizer_config": {"class_name": "RMSprop", "config": {
    "lr": 0.01, "rho": 0.9, "epsilon": 1e-08, "decay": 0.0}},
    "loss": "categorical_crossentropy", "metrics": [], "sample_weight_mode": None,
    "loss_weights": None}


def text_generator_archive(rng, units=UNITS):
    """The example's model: LSTM(units, input_shape=(40, 57)), Dense(57),
    Activation('softmax'), its weights as Keras 1 saves them
    (consume_less='cpu': W_i, U_i, b_i, ... per gate)."""
    mc = {"class_name": "Sequential", "config": [
        {"class_name": "LSTM", "config": {
            "name": "lstm_1", "trainable": True, "batch_input_shape": [None, MAXLEN, CHARS],
            "input_dtype": "float32", "return_sequences": False, "go_backwards": False,
            "stateful": False, "unroll": False, "consume_less": "cpu", "input_dim": CHARS,
            "input_length": None, "output_dim": units, "init": "glorot_uniform",
            "inner_init": "orthogonal", "forget_bias_init": "one", "activation": "tanh",
            "inner_activation": "hard_sigmoid", "W_regularizer": None, "U_regularizer": None,
            "b_regularizer": None, "dropout_W": 0.0, "dropout_U": 0.0}},
        {"class_name": "Dense", "config": {
            "name": "dense_1", "trainable": True, "output_dim": CHARS, "init": "glorot_uniform",
            "activation": "linear", "bias": True, "input_dim": units}},
        {"class_name": "Activation", "config": {"name": "activation_1", "trainable": True,
                                                "activation": "softmax"}}]}
    s = 1.0 / np.sqrt(units)
    lstm = [(f"lstm_1_{k}_{g}", rng.uniform(-s, s, shape).astype(np.float32))
            for g in ("i", "c", "f", "o")
            for k, shape in (("W", (CHARS, units)), ("U", (units, units)), ("b", (units,)))]
    lw = {"lstm_1": lstm,
          "dense_1": [("dense_1_W", rng.uniform(-s, s, (units, CHARS)).astype(np.float32)),
                      ("dense_1_b", np.zeros(CHARS, np.float32))],
          "activation_1": []}
    return mc, RMSPROP_TC, lw


def one_hot_windows(rng, n):
    idx = rng.integers(0, CHARS, (n, MAXLEN + 1))
    eye = np.eye(CHARS, dtype=np.float32)
    return eye[idx[:, :MAXLEN]], eye[idx[:, MAXLEN]]


def keras1_lstm_forward(lw, x):
    """Keras 1's LSTM and the Dense + softmax head in float64 from the
    archive's arrays (gates i, f, c, o; hard_sigmoid; no peepholes)."""
    w = {k.split("lstm_1_")[-1]: a.astype(np.float64) for k, a in lw["lstm_1"]}
    hs = lambda z: np.clip(0.2 * z + 0.5, 0.0, 1.0)  # noqa: E731
    h = np.zeros((len(x), w["U_i"].shape[0]))
    c = np.zeros_like(h)
    for t in range(x.shape[1]):
        xt = x[:, t].astype(np.float64)
        i = hs(xt @ w["W_i"] + h @ w["U_i"] + w["b_i"])
        f = hs(xt @ w["W_f"] + h @ w["U_f"] + w["b_f"])
        c = f * c + i * np.tanh(xt @ w["W_c"] + h @ w["U_c"] + w["b_c"])
        o = hs(xt @ w["W_o"] + h @ w["U_o"] + w["b_o"])
        h = o * np.tanh(c)
    (_, dw), (_, db) = lw["dense_1"]
    z = h @ dw.astype(np.float64) + db
    e = np.exp(z - z.max(-1, keepdims=True))
    return e / e.sum(-1, keepdims=True)


def _f32(tree):
    return jax.tree_util.tree_map(
        lambda a: a.astype(jnp.float32) if jnp.issubdtype(a.dtype, jnp.floating) else a, tree)


def test_text_generator_serves_and_trains_as_jax(tmp_path):
    rng = np.random.default_rng(25)
    mc, tc, lw = text_generator_archive(rng)
    path = str(tmp_path / "lstm_text_generation.h5")
    write_numpy(path, mc, tc, lw)
    # served as guess_model gives it (no training config: Dense + softmax)
    x, _ = one_hot_windows(rng, 4)
    served = guess_model(path, device="cpu")
    np.testing.assert_allclose(served.output(x), keras1_lstm_forward(lw, x), atol=OUT_ATOL)
    np.testing.assert_allclose(served.output(x), np.asarray(jax_guess(path).output(x)),
                               atol=OUT_ATOL)
    # trained as imported with its training config: RMSprop, mcxent head
    jnet = jm.import_keras_sequential_model_and_weights(path)
    pnet = pm.import_keras_sequential_model_and_weights(path, device="cpu")
    assert_same_import(jnet, pnet, x)
    assert pnet.conf.updater["updater"] == "rmsprop"
    assert pnet.conf.updater["rms_decay"] == pytest.approx(0.9)
    jnet.init(params=_f32(jnet.params), force=True)
    losses = []
    with jax.enable_x64(False):
        for _ in range(2):
            bx, by = one_hot_windows(rng, 8)
            jnet.fit(JaxDataSet(bx, by))
            pnet.fit((bx, by))
            losses.append((pnet.score(), float(jnet.score())))
    p, j = np.array(losses).T
    np.testing.assert_allclose(p, j, rtol=TRAIN_TOL)
    for jl, pl in zip(jax.tree_util.tree_leaves(jnet.params), _port_leaves(pnet)):
        np.testing.assert_allclose(pl, np.asarray(jl), atol=TRAIN_TOL, rtol=TRAIN_TOL)


# ---------------------------------------------------------------------------
# TrainedModels: VGG16 from a weights-only 'th' archive
# ---------------------------------------------------------------------------

VGG_SIDE, VGG_CLASSES = 32, 10


def vgg16_th_layers(rng, side=VGG_SIDE, classes=VGG_CLASSES):
    """The canonical archive's 37 layers (ZeroPadding2D before each conv,
    pools, Flatten, Dense and Dropout): conv kernels OIHW, the first Dense
    rows in C,H,W order; weightless layers empty."""
    def normal(std, shape):
        return np.float32(std) * rng.standard_normal(shape, dtype=np.float32)

    layers, c_in = [], 3
    for block in ((64, 64), (128, 128), (256, 256, 256), (512, 512, 512), (512, 512, 512)):
        for c_out in block:
            layers += [[], [normal(np.sqrt(2.0 / (9 * c_in)), (c_out, c_in, 3, 3)),
                            normal(0.01, c_out)]]
            c_in = c_out
        layers.append([])
    flat = 512 * (side // 32) ** 2
    layers.append([])
    for n_in, n_out in ((flat, 4096), (4096, 4096)):
        layers += [[normal(np.sqrt(2.0 / n_in), (n_in, n_out)), np.zeros(n_out, np.float32)],
                   []]
    layers.append([normal(0.01, (4096, classes)), np.zeros(classes, np.float32)])
    return layers


def test_trained_models_vgg16_weights_only_matches_jax(tmp_path, monkeypatch):
    for mod in (jax_trained, port_trained):
        orig = mod.vgg16_configuration
        monkeypatch.setattr(mod, "vgg16_configuration",
                            lambda orig=orig: orig(n_classes=VGG_CLASSES, height=VGG_SIDE,
                                                   width=VGG_SIDE))
    rng = np.random.default_rng(16)
    layers = vgg16_th_layers(rng)
    assert len(layers) == 37
    path = str(tmp_path / "vgg16_weights_th.h5")
    W.write_h5(path, W.keras_weights_archive(layers))
    jnet = jm.TrainedModels.load("VGG16", path)
    pnet = pm.TrainedModels.load("VGG16", path, device="cpu")
    x = rng.uniform(0, 1, (2, VGG_SIDE, VGG_SIDE, 3)).astype(np.float32)
    assert_same_import(jnet, pnet, x)
    np.testing.assert_array_equal(pnet.layer_params[0]["W"].detach().numpy(),
                                  layers[1][0].transpose(2, 3, 1, 0))
    with pytest.raises(pm.KerasImportError, match="weighted layers"):
        bad = str(tmp_path / "short.h5")
        W.write_h5(bad, W.keras_weights_archive(layers[:-1]))
        pm.TrainedModels.load("VGG16", bad, device="cpu")
    with pytest.raises(FileNotFoundError):
        pm.TrainedModels.load("VGG16", str(tmp_path / "missing.h5"), device="cpu")
    with pytest.raises(ValueError, match="Unknown trained model"):
        pm.TrainedModels.load("VGG19", path, device="cpu")


def test_vgg16_configuration_and_labels_match_jax(tmp_path):
    assert pm.vgg16_configuration().to_json() == jm.vgg16_configuration().to_json()
    types = pm.vgg16_configuration().layer_input_types()
    assert types[-3].size == 7 * 7 * 512
    labels = {str(i): [f"n{i:08d}", f"class_{i}"] for i in range(5)}
    p = tmp_path / "imagenet_class_index.json"
    p.write_text(json.dumps(labels))
    assert pm.imagenet_labels(str(p)) == jm.imagenet_labels(str(p)) == [
        f"class_{i}" for i in range(5)]
    with pytest.raises(FileNotFoundError):
        pm.imagenet_labels(None)


# ---------------------------------------------------------------------------
# the HDF5 reader against h5py, and the writer
# ---------------------------------------------------------------------------


def assert_same_value(got, want, where):
    assert type(got) is type(want), (where, type(got), type(want))
    if isinstance(want, np.ndarray):
        assert got.dtype == want.dtype and got.shape == want.shape, where
        assert got.tolist() == want.tolist(), where
    else:
        assert got == want, where


def assert_reads_as_h5py(path):
    """Every attribute, group listing and dataset of ``path`` as h5py reads
    them (a null dataspace: h5py's ``Empty``, the port's empty array)."""
    with h5py.File(path, "r") as ref, hdf5.File(path) as mine:
        def walk(r, m):
            assert list(m.attrs) == list(r.attrs), r.name
            for k in r.attrs:
                assert_same_value(m.attrs[k], r.attrs[k], f"{r.name} attr {k}")
            if isinstance(r, h5py.Dataset):
                want = r[()]
                if isinstance(want, h5py.Empty):
                    assert m.shape is None and m.read().size == 0
                    return
                got = m.read()
                want = np.asarray(r)
                assert got.dtype == want.dtype and got.shape == want.shape, r.name
                assert got.tolist() == want.tolist(), r.name
                return
            assert m.keys() == list(r.keys()), r.name
            for k in r.keys():
                walk(r[k], m[k])
        walk(ref, mine)


def test_reader_matches_h5py(tmp_path):
    rng = np.random.default_rng(7)
    path = str(tmp_path / "mixed.h5")
    with h5py.File(path, "w") as f:
        f.attrs["model_config"] = json.dumps({"class_name": "Sequential"}).encode()
        f.attrs["keras_version"] = "2.0.8"  # a variable-length str
        f.attrs["vlen_list"] = ["alpha", "βeta", ""]
        f.attrs["fixed"] = np.bytes_(b"fixed")
        f.attrs["names"] = np.array([b"a", b"bb", b"ccc"], dtype="S64")
        f.attrs["int"] = np.int32(-3)
        f.attrs["uint"] = np.uint16(7)
        f.attrs["f64"] = 2.5
        f.attrs["matrix"] = rng.normal(size=(2, 3)).astype(np.float32)
        f.attrs["be"] = np.arange(3, dtype=">i4")
        many = f.create_group("many_attrs")  # past the first header block
        for i in range(48):
            many.attrs[f"a{i:02d}"] = np.arange(i + 1, dtype=np.float64)
        g = f.create_group("model_weights")
        g.attrs["layer_names"] = np.array([b"dense_1"], dtype="S64")
        d = g.create_group("dense_1")
        d.attrs["weight_names"] = np.array([b"dense_1/kernel:0", b"dense_1/bias:0"],
                                           dtype="S64")
        d.create_dataset("dense_1/kernel:0", data=rng.normal(size=(4, 3)).astype(np.float32))
        d.create_dataset("dense_1/bias:0", data=np.zeros(3, np.float32))
        big = f.create_group("wide")  # a group B-tree over many symbol nodes
        for i in range(300):
            big.create_dataset(f"w{i:03d}", data=np.full(2, i, np.int16))
        f.create_dataset("scalar", data=np.float64(3.25))
        f.create_dataset("empty", data=np.zeros((0, 4), np.float32))
        f.create_dataset("null", data=h5py.Empty("f4"))
        f.create_dataset("unallocated", shape=(3, 2), dtype=np.int32, fillvalue=7)
        f.create_dataset("unallocated_zero", shape=(2,), dtype=np.float32)
        f.create_dataset("strings", data=np.array(["x", "yz"], dtype=h5py.string_dtype()))
        f.create_dataset("f16", data=np.arange(5, dtype=np.float16))
        f.create_dataset("u8", data=np.arange(256, dtype=np.uint8).reshape(16, 16))
        dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
        dcpl.set_layout(h5py.h5d.COMPACT)
        compact = h5py.h5d.create(f.id, b"compact", h5py.h5t.NATIVE_INT16,
                                  h5py.h5s.create_simple((4,)), dcpl=dcpl)
        compact.write(h5py.h5s.ALL, h5py.h5s.ALL, np.arange(4, dtype=np.int16))
    assert_reads_as_h5py(path)
    with hdf5.File(path) as f:
        assert f["model_weights/dense_1"]["dense_1/kernel:0"].shape == (4, 3)
        assert "wide/w299" in f and "wide/w300" not in f


def test_archive_surface_matches_jax(tmp_path):
    """Every Hdf5Archive query and the three readers, port against JAX."""
    mc, tc, lw, _ = _f32_arrays(case_keras2, seed=1)
    path = str(tmp_path / "k2.h5")
    write_h5py(path, mc, tc or ADAM_TC, lw)
    with jm.Hdf5Archive(path) as ja, pm.Hdf5Archive(path) as pa:
        for a in (pa, ja):
            assert a.has_attribute("model_config") and not a.has_attribute("nope")
        assert pa.read_attribute_as_string("model_config") == ja.read_attribute_as_string(
            "model_config")
        assert pa.read_attribute_as_json("training_config") == ja.read_attribute_as_json(
            "training_config")
        assert pa.read_string_list_attribute("layer_names", "model_weights") == (
            ja.read_string_list_attribute("layer_names", "model_weights"))
        assert pa.get_groups("model_weights") == ja.get_groups("model_weights")
        assert pa.get_groups("model_weights", "conv_1") == ja.get_groups(
            "model_weights", "conv_1") == ["conv_1"]
        assert pa.get_data_sets("model_weights", "conv_1", "conv_1") == ja.get_data_sets(
            "model_weights", "conv_1", "conv_1")
        got = pa.read_data_set("kernel:0", "model_weights", "conv_1", "conv_1")
        np.testing.assert_array_equal(got, ja.read_data_set("kernel:0", "model_weights",
                                                            "conv_1", "conv_1"))
    pw, jw = hdf5.read_layer_weights(path), jax_hdf5.read_layer_weights(path)
    assert list(pw) == list(jw)
    for ln in jw:
        assert list(pw[ln]) == list(jw[ln])
        for wn in jw[ln]:
            np.testing.assert_array_equal(pw[ln][wn], jw[ln][wn])
    assert hdf5.read_model_config(path) == jax_hdf5.read_model_config(path)
    assert hdf5.read_training_config(path) == jax_hdf5.read_training_config(path)


@pytest.mark.parametrize("how", ["chunked", "gzip", "libver_latest", "not_hdf5"])
def test_reader_refuses_what_it_does_not_read(how, tmp_path):
    path = str(tmp_path / f"{how}.h5")
    if how == "not_hdf5":
        Path(path).write_bytes(b"PK\x03\x04 not an archive")
    else:
        kw = {"libver": "latest"} if how == "libver_latest" else {}
        with h5py.File(path, "w", **kw) as f:
            f.create_dataset("d", data=np.ones((8, 8), np.float32),
                             **({"chunks": (4, 4)} if how == "chunked" else
                                {"compression": "gzip"} if how == "gzip" else {}))
    match = {"chunked": "chunked dataset", "gzip": "filtered", "libver_latest":
             "superblock version", "not_hdf5": "not an HDF5 file"}[how]
    with pytest.raises(OSError, match=match):
        with hdf5.File(path) as f:
            f["d"].read()


def test_writer_files_read_by_h5py(tmp_path):
    """h5py reads every attribute and array the numpy writer was given, and
    so does the port's reader; a group wider than the default leaf K too."""
    rng = np.random.default_rng(3)
    arrays = {f"{k}{n}": (rng.normal(size=(3, 2)) * 100).astype(f"{k}{n}")
              for k, ns in (("f", (2, 4, 8)), ("i", (1, 2, 4, 8)), ("u", (1, 2, 4, 8)))
              for n in ns}
    arrays.update(scalar=np.float32(1.5), empty=np.zeros((0, 3), np.float32),
                  big=rng.normal(size=(64, 64, 3)).astype(np.float32))
    attrs = {"text": "héllo", "raw": b"bytes", "int": 3, "float": np.float32(0.5),
             "list": ["a", "bcd"], "names": np.array([b"x", b"yy"], dtype="S64"),
             "empty_names": np.array([], dtype="S64"), "vec": np.arange(4.0)}
    root = W.Group({"data": W.Group(arrays, attrs=attrs),
                    "wide": W.Group({f"g{i:02d}": W.Group(attrs={"i": i}) for i in range(40)}),
                    "nested": W.Group({"a": W.Group({"b": W.Group({"c": np.arange(3)})})})},
                   attrs={"top": "level"})
    path = str(tmp_path / "written.h5")
    size = W.write_h5(path, root)
    assert Path(path).stat().st_size == size
    with h5py.File(path, "r") as f:
        for name, want in arrays.items():
            got = f["data"][name][()]
            assert np.asarray(got).dtype == np.asarray(want).dtype
            np.testing.assert_array_equal(got, want)
        expect = {"text": np.bytes_("héllo".encode()), "raw": np.bytes_(b"bytes"),
                  "int": np.int64(3), "float": np.float32(0.5),
                  "list": np.array([b"a", b"bcd"], dtype="S3"),
                  "names": attrs["names"], "empty_names": attrs["empty_names"],
                  "vec": np.arange(4.0)}
        assert list(f["data"].attrs) == sorted(attrs)
        for k, want in expect.items():
            assert_same_value(f["data"].attrs[k], want, k)
        assert sorted(f["wide"].keys()) == [f"g{i:02d}" for i in range(40)]
        assert int(f["wide/g39"].attrs["i"]) == 39
        np.testing.assert_array_equal(f["nested/a/b/c"][()], np.arange(3))
        assert f.attrs["top"] == b"level"
    assert_reads_as_h5py(path)


def test_writer_keras_archive_reads_in_both_packages(tmp_path):
    mc, tc, lw = text_generator_archive(np.random.default_rng(1), units=8)
    path = str(tmp_path / "gen.h5")
    write_numpy(path, mc, tc, lw)
    with h5py.File(path, "r") as f:
        assert json.loads(f.attrs["model_config"]) == mc
        assert f.attrs["keras_version"] == b"1.2.2"
        names = [n.decode() for n in f["model_weights"].attrs["layer_names"]]
        assert names == ["lstm_1", "dense_1", "activation_1"]
        for ln, ws in lw.items():
            for wn, a in ws:
                np.testing.assert_array_equal(f["model_weights"][ln][wn][()], a)
    assert hdf5.read_layer_weights(path).keys() == jax_hdf5.read_layer_weights(path).keys()


# ---------------------------------------------------------------------------
# the modules import no h5py, no JAX and nothing of the JAX package
# ---------------------------------------------------------------------------

NEW_MODULES = [PORT / "modelimport" / f"{m}.py" for m in (
    "__init__", "hdf5", "keras", "trained_models")] + [
    PORT / "utils" / "model_guesser.py", PORT / "interop" / "gateway.py",
    PORT / "interop" / "__init__.py", ROOT / "scripts" / "torch_write_keras_h5.py"] + [
    PORT / "nlp" / f"{m}.py" for m in ("tokenization_plugins", "japanese", "korean",
                                       "uima_analyzers")]


@pytest.mark.parametrize("path", NEW_MODULES, ids=lambda p: str(p.relative_to(ROOT)))
def test_new_modules_import_no_h5py_or_jax(path):
    roots = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    assert not roots & {"h5py", "jax", "jaxlib", "deeplearning4j_tpu"}, path
