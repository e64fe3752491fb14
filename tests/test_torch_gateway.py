"""The port's Keras gateway (``deeplearning4j_tpu_torch/interop/gateway.py``)
against the JAX package's, on ``device="cpu"``.

Both servers run on 127.0.0.1 (port 0) in this process. A client creates a
model from a Keras 1 JSON, fits, predicts, evaluates and closes it; two
sessions use one model at once (the per-model lock serializes them); an
error comes back to the client as the JAX server words it. After the JAX
server's model params are loaded into the port server's model
(``load_jax_params``), both servers predict and score the same batch within
``ATOL``, and one SGD update through each leaves them within ``ATOL`` (JAX
with x64 off and f32 params).
"""

import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from deeplearning4j_tpu.interop import GatewayClient as JaxClient  # noqa: E402
from deeplearning4j_tpu.interop import GatewayServer as JaxServer  # noqa: E402
from deeplearning4j_tpu.ops import kernel_select  # noqa: E402
from deeplearning4j_tpu.runtime import inference as jax_inference  # noqa: E402

import deeplearning4j_tpu_torch as pt  # noqa: E402
from deeplearning4j_tpu_torch.interop import GatewayClient, GatewayServer  # noqa: E402
from deeplearning4j_tpu_torch.interop import gateway  # noqa: E402

ATOL = 1e-5
THREAD_TIMEOUT_S = 60.0

MODEL = {"class_name": "Sequential", "config": [
    {"class_name": "Dense", "config": {"name": "d1", "output_dim": 16, "activation": "relu",
                                       "bias": True, "batch_input_shape": [None, 8]}},
    {"class_name": "Dense", "config": {"name": "d2", "output_dim": 3,
                                       "activation": "softmax", "bias": True}}]}
SGD_TC = {"loss": "categorical_crossentropy",
          "optimizer_config": {"class_name": "SGD", "config": {"lr": 0.1}}}


@pytest.fixture(autouse=True)
def jax_env(monkeypatch, tmp_path):
    monkeypatch.setattr(jax_inference, "fast_path_enabled", lambda: False)
    monkeypatch.setenv("DL4JTPU_KERNEL_CALIBRATION", str(tmp_path / "calibration.json"))
    kernel_select.reset()
    yield
    kernel_select.reset()


def toy_data(n=64, n_in=8, n_classes=3, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, n_in)).astype(np.float32)
    w = rng.normal(size=(n_in, n_classes))
    return x, np.eye(n_classes, dtype=np.float32)[(x @ w).argmax(-1)]


def test_round_trip_learns():
    feats, labels = toy_data()
    with GatewayServer(device="cpu") as srv:
        client = GatewayClient(srv.host, srv.port)
        assert client.create_model("m1", MODEL, SGD_TC) == 8 * 16 + 16 + 16 * 3 + 3
        s0 = client.evaluate("m1", feats, labels)
        losses = [client.fit("m1", feats, labels) for _ in range(15)]
        assert all(np.isfinite(losses))
        assert client.evaluate("m1", feats, labels) < s0
        out = client.predict("m1", feats[:10])
        assert out.shape == (10, 3) and out.dtype == np.float32
        np.testing.assert_allclose(out.sum(-1), 1.0, rtol=1e-5)
        client._call(op="close", model_id="m1")
        with pytest.raises(RuntimeError, match="unknown model_id"):
            client.predict("m1", feats[:2])
        client.close()
    assert srv.device == torch.device("cpu")


def test_two_sessions_share_a_model():
    model = {"class_name": "Sequential", "config": [
        {"class_name": "Dense", "config": {"name": "d1", "output_dim": 4,
                                           "activation": "softmax", "bias": True,
                                           "batch_input_shape": [None, 6]}}]}
    tc = {"loss": "categorical_crossentropy",
          "optimizer_config": {"class_name": "SGD", "config": {"lr": 0.05}}}
    feats, labels = toy_data(n=64, n_in=6, n_classes=4)
    with GatewayServer(device="cpu") as srv:
        c0 = GatewayClient(srv.host, srv.port)
        c0.create_model("m", model, tc)
        errors, fits = [], []

        def session():
            c = GatewayClient(srv.host, srv.port)
            try:
                for _ in range(5):
                    fits.append(c.fit("m", feats, labels))
                    assert c.predict("m", feats[:4]).shape == (4, 4)
            except Exception as e:  # noqa: BLE001 - reported below
                errors.append(e)
            finally:
                c.close()

        threads = [threading.Thread(target=session) for _ in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(THREAD_TIMEOUT_S)
        assert not any(t.is_alive() for t in threads)
        assert not errors and len(fits) == 10
        assert srv._models["m"].iteration == 10  # every fit ran, one at a time
        assert np.isfinite(c0.evaluate("m", feats, labels))
        c0.close()


@pytest.mark.parametrize("request_", [
    {"op": "predict", "model_id": "nope", "features": gateway._encode_array(np.zeros((2, 8)))},
    {"op": "dance", "model_id": "m"},
    {"op": "sequential_to_multilayernetwork", "model_id": "x",
     "model_config": {"class_name": "Sequential", "config": [
         {"class_name": "Lambda", "config": {"name": "l"}}]}},
    {"op": "fit", "model_id": "m", "features": "not base64 npy", "labels": ""},
], ids=["unknown_model", "unknown_op", "unsupported_layer", "bad_array"])
def test_errors_come_back_as_jax_words_them(request_):
    answers = []
    for server, client in ((GatewayServer(device="cpu"), GatewayClient),
                           (JaxServer(), JaxClient)):
        with server as srv:
            c = client(srv.host, srv.port)
            c.create_model("m", MODEL, SGD_TC)
            with pytest.raises(RuntimeError) as e:
                c._call(**request_)
            answers.append(str(e.value))
            assert c.evaluate("m", *toy_data(n=8)) > 0  # the session goes on
            c.close()
    assert answers[0].split(":")[0] == answers[1].split(":")[0]
    if request_["op"] != "fit":  # the array decoder's own message differs
        assert answers[0] == answers[1]


def _f32(tree):
    return jax.tree_util.tree_map(lambda a: a.astype(jnp.float32), tree)


def test_predictions_match_jax_gateway():
    feats, labels = toy_data(n=32, seed=3)
    with GatewayServer(device="cpu") as psrv, JaxServer() as jsrv:
        pc, jc = GatewayClient(psrv.host, psrv.port), JaxClient(jsrv.host, jsrv.port)
        assert pc.create_model("m", MODEL, SGD_TC) == jc.create_model("m", MODEL, SGD_TC)
        jnet, pnet = jsrv._models["m"], psrv._models["m"]
        assert pnet.conf.to_json() == jnet.conf.to_json()
        jnet.init(params=_f32(jnet.params), force=True)
        pt.load_jax_params(pnet, jax.tree_util.tree_map(np.asarray, jnet.params))
        np.testing.assert_allclose(pc.predict("m", feats), jc.predict("m", feats), atol=ATOL)
        assert pc.evaluate("m", feats, labels) == pytest.approx(
            jc.evaluate("m", feats, labels), abs=ATOL)
        with jax.enable_x64(False):
            jl = jc.fit("m", feats, labels)
        assert pc.fit("m", feats, labels) == pytest.approx(jl, abs=ATOL)
        for j, p in zip(jax.tree_util.tree_leaves(jnet.params),
                        [l[k].detach().numpy() for l in pnet._leaves() for k in sorted(l)]):
            np.testing.assert_allclose(p, np.asarray(j), atol=ATOL)
        np.testing.assert_allclose(pc.predict("m", feats), jc.predict("m", feats), atol=ATOL)
        pc.close()
        jc.close()
