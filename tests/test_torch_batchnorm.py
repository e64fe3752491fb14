"""The PyTorch port's BatchNormalization against the JAX package.

The layer is built from the JAX layer's JSON and given the same numpy
params, state and input, NHWC images and [B, F] rows, in training (batch
stats, new running stats) and in eval (the running stats), with and
without ``lock_gamma_beta``, defaults and not. f32 outputs, new state and
gradients (x, gamma, beta through the batch stats: a seeded cotangent
through ``jax.vjp`` and ``backward``) at 1e-5 (sums in another order); one
channel sits at |mean| = 10 std. A channel at |mean| = 6000 std holds the
running variance against JAX's at 1e-5 and float64's at 1e-4: there the
one-pass variance E[x^2] - E[x]^2 of f32 loses every digit, so a port that
took one pass in f32 fails (the normalized output itself is then a
difference of two numbers near 6000 in f32, so it is not held there). bf16
holds bit for bit: one pass in f32 clamped at 0, scale and offset folded in
f32, then one multiply and one add, each rounded to bf16, as the JAX
package computes it.

Networks with BN layers (a MultiLayerNetwork of dense rows and one of NHWC
images, with the bias coefficients l1_bias/l2_bias that the "b" key rule
applies to beta) train three SGD updates in both packages: losses, params
and the running stats after each, and the eval-mode output and score that
read them, at 1e-5. The three wrong BN versions of chip_smoke.py's
``train_resnet50`` phase (running variance unbiased, the decay the wrong
way round, eval mode on the batch's stats) each fail the same comparison.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import chip_smoke  # noqa: E402
import deeplearning4j_tpu as dj  # noqa: E402
from deeplearning4j_tpu.runtime import inference as jax_inference  # noqa: E402
from deeplearning4j_tpu.nn.layers import normalization as jnorm  # noqa: E402
from deeplearning4j_tpu.ops import kernel_select  # noqa: E402

import deeplearning4j_tpu_torch as pt  # noqa: E402
from deeplearning4j_tpu_torch.nn.layers.base import layer_from_dict  # noqa: E402

ATOL = RTOL = 1e-5
BN_FAULTS = ("bn_running_var_unbiased", "bn_decay_swapped", "bn_eval_on_batch_stats")


@pytest.fixture(autouse=True)
def jax_env(monkeypatch, tmp_path):
    monkeypatch.setattr(jax_inference, "fast_path_enabled", lambda: False)
    monkeypatch.setenv("DL4JTPU_KERNEL_CALIBRATION", str(tmp_path / "calibration.json"))
    kernel_select.reset()
    yield
    kernel_select.reset()


def _f32(tree):
    # conftest enables x64: params and state come as float64; cast for f32
    return jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float32), tree)


def _inputs(kind, seed, ratio=10.0):
    """x (NHWC [4, 5, 3, C] or rows [16, C], C = 6; channel 0 at mean
    ``ratio`` times its std), gamma, beta and a non-initial state, all f32
    numpy."""
    rng = np.random.default_rng(seed)
    shape = (4, 5, 3, 6) if kind == "nhwc" else (16, 6)
    x = rng.normal(size=shape) * rng.uniform(0.5, 3.0, 6) + rng.normal(0.0, 2.0, 6)
    x[..., 0] = 0.05 * ratio + 0.05 * rng.normal(size=shape[:-1])
    params = {"gamma": rng.uniform(0.5, 1.5, 6), "beta": rng.normal(0.0, 0.5, 6)}
    state = {"mean": rng.normal(0.0, 1.0, 6), "var": rng.uniform(0.5, 2.0, 6)}
    f32 = lambda d: {k: v.astype(np.float32) for k, v in d.items()}  # noqa: E731
    return x.astype(np.float32), f32(params), f32(state)


LAYERS = {
    "defaults": {},
    "locked": {"lock_gamma_beta": True, "gamma_init": 1.5, "beta_init": -0.25},
    "decay_eps": {"decay": 0.7, "eps": 1e-3, "gamma_init": 2.0, "beta_init": 0.5},
}


def _pair(opts):
    jlayer = jnorm.BatchNormalization(**opts)
    return jlayer, layer_from_dict(jlayer.to_dict())


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("kind", ["nhwc", "rows"])
@pytest.mark.parametrize("opts", sorted(LAYERS))
def test_forward_state_and_gradients_match_jax(opts, kind, train):
    jlayer, player = _pair(LAYERS[opts])
    x, params, state = _inputs(kind, 1)
    if jlayer.lock_gamma_beta:
        params = {}
    it = dj.InputType.convolutional(5, 3, 6) if kind == "nhwc" else dj.InputType.feed_forward(6)
    assert set(player.init_params(torch.Generator(), it)) == set(params)
    assert {k: v.tolist() for k, v in player.init_state(it).items()} == \
        {k: np.asarray(v).tolist() for k, v in jlayer.init_state(it).items()}
    g = np.random.default_rng(2).normal(size=x.shape).astype(np.float32)

    def jfn(x_, p_):
        return jlayer.apply(p_, x_, {k: jnp.asarray(v) for k, v in state.items()},
                            train=train)

    (jy, jst), vjp = jax.vjp(jfn, jnp.asarray(x), {k: jnp.asarray(v) for k, v in params.items()})
    jdx, jdp = vjp((jnp.asarray(g), jax.tree_util.tree_map(jnp.zeros_like, jst)))
    tx = torch.tensor(x, requires_grad=True)
    tp = {k: torch.tensor(v, requires_grad=True) for k, v in params.items()}
    py, pst = player.apply(tp, tx, {k: torch.tensor(v) for k, v in state.items()}, train=train)
    assert not any(v.requires_grad for v in pst.values())  # no autograd in the running stats
    py.backward(torch.tensor(g))
    np.testing.assert_allclose(py.detach().numpy(), np.asarray(jy), rtol=RTOL, atol=ATOL)
    for k in ("mean", "var"):
        np.testing.assert_allclose(pst[k].numpy(), np.asarray(jst[k]), rtol=RTOL, atol=ATOL,
                                   err_msg=k)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jdx), rtol=RTOL, atol=ATOL)
    for k in params:
        np.testing.assert_allclose(tp[k].grad.numpy(), np.asarray(jdp[k]), rtol=RTOL,
                                   atol=ATOL, err_msg=k)


def test_large_mean_channel_needs_two_passes_in_f32():
    """Channel 0 (mean 300, std 0.05): the port's running variance agrees
    with JAX's two passes, and its f32 batch variance with float64, where
    one pass in f32 is off by more than the variance itself."""
    jlayer, player = _pair({})
    x, params, state = _inputs("rows", 3, ratio=6000.0)
    _, new = player.apply({k: torch.tensor(v) for k, v in params.items()}, torch.tensor(x),
                          {k: torch.tensor(v) for k, v in state.items()}, train=True)
    _, jst = jlayer.apply({k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(x),
                          {k: jnp.asarray(v) for k, v in state.items()}, train=True)
    for k in ("mean", "var"):
        np.testing.assert_allclose(new[k].numpy(), np.asarray(jst[k]), rtol=RTOL, err_msg=k)
    var64 = x.astype(np.float64).var(axis=0)
    got = (new["var"].numpy() - 0.9 * state["var"]) / 0.1
    np.testing.assert_allclose(got, var64, rtol=1e-4)
    xf = torch.tensor(x)
    one_pass = ((xf * xf).mean(0) - xf.mean(0) ** 2).numpy()
    assert abs(one_pass[0] - var64[0]) > var64[0]


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_bf16_rounds_where_jax_does(train):
    """bf16 NHWC: the output bit for bit and the f32 running stats, against
    the JAX layer on the same bf16 input and params."""
    jlayer, player = _pair({})
    x, params, state = _inputs("nhwc", 4)
    jy, jst = jax.jit(lambda x_, p_, s_: jlayer.apply(p_, x_, s_, train=train))(
        jnp.asarray(x, jnp.bfloat16), {k: jnp.asarray(v, jnp.bfloat16) for k, v in params.items()},
        {k: jnp.asarray(v) for k, v in state.items()})
    py, pst = player.apply({k: torch.tensor(v).bfloat16() for k, v in params.items()},
                           torch.tensor(x).bfloat16(),
                           {k: torch.tensor(v) for k, v in state.items()}, train=train)
    assert py.dtype == torch.bfloat16 and pst["mean"].dtype == torch.float32
    np.testing.assert_array_equal(py.float().numpy(), np.asarray(jy.astype(jnp.float32)))
    for k in ("mean", "var"):
        np.testing.assert_allclose(pst[k].numpy(), np.asarray(jst[k]), rtol=1e-6, atol=1e-6)


# --------------------------------------------------------------- networks
def _rows_conf(pkg):
    return pkg.MultiLayerConfiguration(
        layers=[pkg.DenseLayer(n_out=7, activation="identity"),
                pkg.BatchNormalization(l1_bias=0.05, l2_bias=0.1, l2=0.01),
                pkg.ActivationLayer(activation="relu"),
                pkg.OutputLayer(n_out=3, activation="softmax", loss="mcxent")],
        input_type=pkg.InputType.feed_forward(5),
        updater=_updater(pkg), seed=7)


def _cnn_conf(pkg):
    return pkg.MultiLayerConfiguration(
        layers=[pkg.ConvolutionLayer(n_out=4, kernel=(3, 3), convolution_mode="same",
                                     has_bias=False),
                pkg.BatchNormalization(decay=0.8),
                pkg.ActivationLayer(activation="relu"),
                pkg.GlobalPoolingLayer(pooling_type="avg"),
                pkg.OutputLayer(n_out=3, activation="softmax", loss="mcxent")],
        input_type=pkg.InputType.convolutional(6, 6, 2),
        updater=_updater(pkg), seed=7)


def _updater(pkg):
    u = pkg.UpdaterConfig(updater="sgd", learning_rate=0.1)
    return u if pkg is dj else u.to_dict()


def _data(conf_name, seed):
    rng = np.random.default_rng(seed)
    shape = (8, 5) if conf_name == "rows" else (8, 6, 6, 2)
    x = (rng.normal(size=shape) * 2.0 + 1.0).astype(np.float32)
    return x, np.eye(3, dtype=np.float32)[rng.integers(0, 3, 8)]


CONFS = {"rows": _rows_conf, "cnn": _cnn_conf}


def _net_pair(conf_name):
    jnet = dj.MultiLayerNetwork(CONFS[conf_name](dj)).init()
    jnet.init(params=_f32(jnet.params), force=True)
    jnet.state = _f32(jnet.state)
    pnet = pt.MultiLayerNetwork(CONFS[conf_name](pt), device="cpu")
    assert pnet.conf.to_json() == jnet.conf.to_json()
    pt.load_jax_params(pnet, jnet.params)
    return jnet, pnet


def _train_and_compare(jnet, pnet, conf_name):
    """Three SGD updates of one batch in each package; the first reading
    that differs from JAX beyond the tolerance, or None."""
    x, y = _data(conf_name, 5)
    for _ in range(3):
        jnet.fit((x, y))
        pnet.fit((x, y))
        checks = [("loss", pnet.score(), float(jnet.score()))]
        for i, (js, ps) in enumerate(zip(jnet.state, pt.state_to_numpy(pnet))):
            checks += [(f"layer {i} {k}", ps[k], np.asarray(v)) for k, v in js.items()]
        for i, (jp, pp) in enumerate(zip(jnet.params, pt.params_to_numpy(pnet))):
            checks += [(f"layer {i} {k}", pp[k], np.asarray(v)) for k, v in jp.items()]
        checks += [("output", pnet.output(x), np.asarray(jnet.output(x))),
                   ("eval score", pnet.score(pt.DataSet(x, y)),
                    float(jnet.score(dj.DataSet(x, y))))]
        for what, got, want in checks:
            if not np.allclose(got, want, rtol=RTOL, atol=ATOL):
                return what
    return None


@pytest.mark.parametrize("conf_name", sorted(CONFS))
def test_training_and_running_stats_match_jax(conf_name):
    """Losses, params, the running stats after each update, and the
    eval-mode output and score that read them (beta regularized by the bias
    coefficients, gamma not)."""
    jnet, pnet = _net_pair(conf_name)
    x, y = _data(conf_name, 5)
    assert float(pnet.loss_fn(x, y).detach()) == pytest.approx(
        float(jnet.loss_fn(jnet.params, jnp.asarray(x), jnp.asarray(y))), rel=RTOL)
    assert _train_and_compare(jnet, pnet, conf_name) is None
    state = pt.state_to_numpy(pnet)
    assert not np.allclose(state[1]["mean"], 0.0) and not np.allclose(state[1]["var"], 1.0)


@pytest.mark.parametrize("fault", BN_FAULTS)
@pytest.mark.parametrize("conf_name", sorted(CONFS))
def test_wrong_batchnorm_versions_are_caught(conf_name, fault):
    jnet, pnet = _net_pair(conf_name)
    undo = chip_smoke.resnet_fault(fault)
    try:
        caught = _train_and_compare(jnet, pnet, conf_name)
    finally:
        undo()
    want = "output" if fault == "bn_eval_on_batch_stats" else "layer 1"
    assert caught is not None and caught.startswith(want), caught


def test_feed_forward_trains_bn_on_the_batch_without_storing_state():
    jnet, pnet = _net_pair("rows")
    x, _ = _data("rows", 6)
    before = [dict(s) for s in pt.state_to_numpy(pnet)]
    for train in (False, True):
        got = pnet.feed_forward(x, train=train)
        want = jnet.feed_forward(jnp.asarray(x), train=train)
        assert len(got) == len(want) == 4
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, np.asarray(w), rtol=RTOL, atol=ATOL)
    for b, a in zip(before, pt.state_to_numpy(pnet)):
        for k in b:
            np.testing.assert_array_equal(a[k], b[k])


def test_multilayer_zips_carry_the_running_stats_both_ways(tmp_path):
    """A JAX zip of a trained BN MultiLayerNetwork restores in the port
    with its running stats (state.npz, layer by layer); the port's zip
    restores in the JAX package; the next update agrees, and the port's
    own restore resumes exactly."""
    from deeplearning4j_tpu.utils import serialization as jax_serialization

    jnet, _ = _net_pair("cnn")
    x, y = _data("cnn", 7)
    jnet.fit((x, y))
    path = str(tmp_path / "jax.zip")
    jax_serialization.write_model(jnet, path)
    pnet = pt.load_jax_model_zip(path, device="cpu")
    for js, ps in zip(jnet.state, pt.state_to_numpy(pnet)):
        assert set(js) == set(ps)
        for k, v in js.items():
            np.testing.assert_array_equal(ps[k], np.asarray(v, np.float32))
    path = str(tmp_path / "port.zip")
    pt.write_model(pnet, path)
    jback = jax_serialization.restore_model(path)
    again = pt.restore_model(path, device="cpu")
    for net in (jback, pnet, again):
        net.fit((x, y))
    assert pnet.score() == pytest.approx(float(jback.score()), rel=RTOL)
    for js, ps, qs in zip(jback.state, pt.state_to_numpy(pnet), pt.state_to_numpy(again)):
        for k, v in js.items():
            np.testing.assert_allclose(ps[k], np.asarray(v), rtol=RTOL, atol=ATOL)
            np.testing.assert_array_equal(qs[k], ps[k])
