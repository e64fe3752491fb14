"""The rest of the JAX package's dense-layer module and activation catalog in
the PyTorch port, against the JAX package.

Every activation of ``nn/activations.py`` by name: the values and the
gradient of a seeded cotangent (``jax.vjp`` against ``backward``) on
inputs away from the corners of relu6, hardtanh and the like, f32 at 1e-5
(1e-6 relative on the values). The traps are held by their own checks:
gelu is the tanh approximation, leakyrelu and rrelu slopes of 0.01 and
0.125, hardtanh's gradient is 0.5 at its corners as ``jnp.clip``'s, relu6's
0. ``ActivationLayer``, ``LossLayer`` and ``EmbeddingLayer`` are built from
the JAX JSON inside small networks that serve and train two SGD updates in
both packages (losses, params and outputs at 1e-5). The ``binomial``
weight-init distribution draws counts of n trials at p.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import deeplearning4j_tpu as dj  # noqa: E402
from deeplearning4j_tpu.runtime import inference as jax_inference  # noqa: E402
from deeplearning4j_tpu.nn import activations as jact  # noqa: E402
from deeplearning4j_tpu.ops import kernel_select  # noqa: E402

import deeplearning4j_tpu_torch as pt  # noqa: E402
from deeplearning4j_tpu_torch.nn import activations as pact  # noqa: E402
from deeplearning4j_tpu_torch.nn.initializers import init_weights  # noqa: E402

ATOL = RTOL = 1e-5


@pytest.fixture(autouse=True)
def jax_env(monkeypatch, tmp_path):
    monkeypatch.setattr(jax_inference, "fast_path_enabled", lambda: False)
    monkeypatch.setenv("DL4JTPU_KERNEL_CALIBRATION", str(tmp_path / "calibration.json"))
    kernel_select.reset()
    yield
    kernel_select.reset()


def test_the_catalogs_hold_the_same_names():
    assert sorted(pact._REGISTRY) == sorted(jact._REGISTRY)
    assert all(pact.is_builtin(n) for n in jact._REGISTRY)


@pytest.mark.parametrize("name", sorted(jact._REGISTRY))
def test_activation_matches_jax(name):
    rng = np.random.default_rng(sorted(jact._REGISTRY).index(name))
    x = (3.0 * rng.normal(size=(5, 7))).astype(np.float32)
    x[np.abs(np.abs(x) - 1.0) < 1e-3] += 0.01  # off hardtanh's corners
    x[np.abs(x - 6.0) < 1e-3] += 0.01  # and relu6's
    g = rng.normal(size=x.shape).astype(np.float32)
    jy, vjp = jax.vjp(jact.get_activation(name), jnp.asarray(x))
    (jdx,) = vjp(jnp.asarray(g))
    tx = torch.tensor(x, requires_grad=True)
    py = pact.get_activation(name)(tx)
    py.backward(torch.tensor(g))
    assert py.dtype == torch.float32
    np.testing.assert_allclose(py.detach().numpy(), np.asarray(jy), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jdx), rtol=RTOL, atol=ATOL)


def test_activation_traps():
    x = torch.tensor([-2.0, -1.0, 0.5, 1.0, 6.0, 7.0], requires_grad=True)
    gelu = pact.get_activation("gelu")(x).detach()
    assert not torch.allclose(gelu, torch.nn.functional.gelu(x.detach()), atol=1e-5)
    torch.testing.assert_close(gelu, torch.nn.functional.gelu(x.detach(), approximate="tanh"))
    assert pact.get_activation("leakyrelu")(x)[0].item() == pytest.approx(-0.02)
    assert pact.get_activation("rrelu")(x)[0].item() == pytest.approx(-0.25)
    pact.get_activation("hardtanh")(x).sum().backward()
    assert x.grad.tolist() == [0.0, 0.5, 1.0, 0.5, 0.0, 0.0]
    x.grad = None
    pact.get_activation("relu6")(x).sum().backward()
    assert x.grad.tolist() == [0.0, 0.0, 1.0, 1.0, 0.0, 0.0]


# --------------------------------------------------------------- layers
def _sgd(pkg):
    u = pkg.UpdaterConfig(updater="sgd", learning_rate=0.1)
    return u if pkg is dj else u.to_dict()


def _activation_net(pkg):
    return pkg.MultiLayerConfiguration(
        layers=[pkg.DenseLayer(n_out=6, activation="identity"),
                pkg.ActivationLayer(activation="elu"),
                pkg.DenseLayer(n_out=5, activation="identity"),
                pkg.ActivationLayer(activation="softsign"),
                pkg.OutputLayer(n_out=3, activation="softmax", loss="mcxent")],
        input_type=pkg.InputType.feed_forward(4), updater=_sgd(pkg), seed=3)


def _loss_net(pkg):
    return pkg.MultiLayerConfiguration(
        layers=[pkg.DenseLayer(n_out=6, activation="tanh"),
                pkg.DenseLayer(n_out=3, activation="identity"),
                pkg.LossLayer(loss="mcxent", activation="softmax")],
        input_type=pkg.InputType.feed_forward(4), updater=_sgd(pkg), seed=3)


def _mse_loss_net(pkg):
    return pkg.MultiLayerConfiguration(
        layers=[pkg.DenseLayer(n_out=3, activation="tanh"),
                pkg.LossLayer(loss="mse", activation="identity")],
        input_type=pkg.InputType.feed_forward(4), updater=_sgd(pkg), seed=3)


def _embedding_net(pkg, has_bias=True):
    return pkg.MultiLayerConfiguration(
        layers=[pkg.EmbeddingLayer(n_in=11, n_out=5, has_bias=has_bias, activation="relu"),
                pkg.OutputLayer(n_out=3, activation="softmax", loss="mcxent")],
        input_type=pkg.InputType.feed_forward(1), updater=_sgd(pkg), seed=3)


NETS = {"activation": _activation_net, "loss": _loss_net, "loss_mse": _mse_loss_net,
        "embedding": _embedding_net,
        "embedding_no_bias": lambda pkg: _embedding_net(pkg, has_bias=False)}


def _data(name, seed):
    rng = np.random.default_rng(seed)
    if name.startswith("embedding"):
        x = rng.integers(0, 11, (9, 1)).astype(np.int32)
    else:
        x = rng.normal(size=(9, 4)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 9)]
    if name == "loss_mse":
        y = rng.normal(size=(9, 3)).astype(np.float32)
    return x, y


@pytest.mark.parametrize("name", sorted(NETS))
def test_layers_serve_and_train_as_in_jax(name):
    jnet = dj.MultiLayerNetwork(NETS[name](dj)).init()
    jnet.init(params=jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float32),
                                            jnet.params), force=True)
    pnet = pt.MultiLayerNetwork(NETS[name](pt), device="cpu")
    assert pnet.conf.to_json() == jnet.conf.to_json()
    pt.load_jax_params(pnet, jnet.params)
    x, y = _data(name, 1)
    np.testing.assert_allclose(pnet.output(x), np.asarray(jnet.output(x)), rtol=RTOL,
                               atol=ATOL)
    for _ in range(2):
        jnet.fit((x, y))
        pnet.fit((x, y))
        assert pnet.score() == pytest.approx(float(jnet.score()), rel=RTOL)
    for jp, pp in zip(jnet.params, pt.params_to_numpy(pnet)):
        assert set(jp) == set(pp)
        for k, v in jp.items():
            np.testing.assert_allclose(pp[k], np.asarray(v), rtol=RTOL, atol=ATOL, err_msg=k)
    np.testing.assert_allclose(pnet.output(x), np.asarray(jnet.output(x)), rtol=RTOL,
                               atol=ATOL)
    if name.startswith("embedding"):  # [B] indices as [B, 1]
        np.testing.assert_array_equal(pnet.output(x[:, 0]), pnet.output(x))


# ----------------------------------------------------------------- init
def test_binomial_distribution_draws_counts_of_n_trials():
    dist = {"type": "binomial", "n": 4, "p": 0.25}
    w = init_weights(torch.Generator().manual_seed(0), (200, 50), 1, 1, "distribution", dist)
    again = init_weights(torch.Generator().manual_seed(0), (200, 50), 1, 1, "distribution",
                         dist)
    assert w.dtype == torch.float32 and w.shape == (200, 50)
    torch.testing.assert_close(w, again)
    assert set(torch.unique(w).tolist()) <= {0.0, 1.0, 2.0, 3.0, 4.0}
    assert float(w.mean()) == pytest.approx(1.0, abs=0.05)  # n p
    assert float(w.var()) == pytest.approx(0.75, abs=0.05)  # n p (1 - p)
    layer = pt.DenseLayer(n_out=3, weight_init="distribution",
                          distribution={"type": "binomial", "n": 1, "p": 0.5})
    assert set(torch.unique(layer.init_params(torch.Generator().manual_seed(1),
                                              pt.InputType.feed_forward(40))["W"]).tolist()) \
        == {0.0, 1.0}
    with pytest.raises(ValueError, match="Unknown distribution"):
        init_weights(torch.Generator(), (2,), 1, 1, "distribution", {"type": "poisson"})
