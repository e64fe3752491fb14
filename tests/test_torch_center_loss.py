"""The PyTorch port's CenterLossOutputLayer against the JAX package.

JAX makes the centers in ``jnp.result_type(float)``, float64 under x64
(``tests/conftest.py``); the port keeps them in the network's param dtype.
So the JAX side runs with x64 off, where both are f32. The layer's loss and
gradients (x, W, b, centers), with and without a labels mask, are held at
1e-6 relative to their largest element; a net with a center-loss head is
held to JAX over three Adam updates as ``test_torch_lenet_mlp.py`` holds
Adam (1e-5, one element in 10,000 within a tenth of the lr). The primary
loss runs the softmax-xent path (``ops.softmax_xent_rows``, the kernels on
the card), which a spy counts.
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import deeplearning4j_tpu as dj  # noqa: E402

import deeplearning4j_tpu_torch as pt  # noqa: E402
from deeplearning4j_tpu_torch import ops  # noqa: E402

REL = 1e-6
ATOL = 1e-5
LR = 1e-2


def _f32(tree):
    return jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float32), tree)


def _inputs(n=16, d=6, c=4, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    y = np.eye(c, dtype=np.float32)[rng.integers(0, c, size=n)]
    mask = (rng.uniform(size=n) > 0.3).astype(np.float32)
    return x, y, mask


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("lam", [2e-4, 0.5])
def test_loss_and_gradients_match_jax(masked, lam):
    x, y, mask = _inputs()
    m = mask if masked else None
    with jax.enable_x64(False):
        jl = dj.CenterLossOutputLayer(n_out=4, activation="softmax", loss="mcxent", lambda_=lam)
        jp = jl.init_params(jax.random.PRNGKey(0), dj.InputType.feed_forward(6))
        assert jp["centers"].dtype == jnp.float32
        jp = dict(jp, centers=jnp.asarray(
            np.random.default_rng(1).normal(size=(4, 6)).astype(np.float32)))

        def jloss(p, xx):
            return jl.compute_loss(p, xx, jnp.asarray(y), None if m is None else jnp.asarray(m))

        want, (jg, jgx) = jax.value_and_grad(jloss, argnums=(0, 1))(jp, jnp.asarray(x))
    pl = pt.CenterLossOutputLayer(n_out=4, activation="softmax", loss="mcxent", lambda_=lam)
    tp = {k: torch.tensor(np.asarray(v), requires_grad=True) for k, v in jp.items()}
    tx = torch.tensor(x, requires_grad=True)
    got = pl.compute_loss(tp, tx, torch.tensor(y), None if m is None else torch.tensor(m))
    grads = torch.autograd.grad(got, [*tp.values(), tx])
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=REL)
    for g, w in zip(grads, [*(jg[k] for k in tp), jgx]):
        w = np.asarray(w)
        assert np.abs(g.numpy() - w).max() <= REL * max(np.abs(w).max(), 1e-30)


def _conf(pkg, params_dtype=None):
    u = pkg.UpdaterConfig(updater="adam", learning_rate=LR)
    return pkg.MultiLayerConfiguration(
        layers=[pkg.DenseLayer(n_out=6, activation="tanh"),
                pkg.CenterLossOutputLayer(n_out=4, activation="softmax", loss="mcxent",
                                          lambda_=0.5)],
        input_type=pkg.InputType.feed_forward(5), updater=u if pkg is dj else u.to_dict(),
        seed=2, params_dtype=params_dtype)


def test_center_loss_net_trains_as_jax_through_the_softmax_xent_path(monkeypatch):
    x, y, _ = _inputs(n=32, d=5)
    with jax.enable_x64(False):
        jnet = dj.MultiLayerNetwork(_conf(dj)).init()
        pnet = pt.load_jax_params(pt.MultiLayerNetwork(_conf(pt), device="cpu"), jnet.params)
        assert pnet.conf.to_json() == jnet.conf.to_json()
        calls = []
        real = ops.softmax_xent_rows
        monkeypatch.setattr(ops, "softmax_xent_rows",
                            lambda *a: calls.append(a[1].shape) or real(*a))
        for _ in range(3):
            jnet.fit((x, y))
            pnet.fit((x, y))
            np.testing.assert_allclose(float(pnet.score()), float(jnet.score()), rtol=ATOL)
    assert calls == [(32, 4)] * 3
    got = pt.params_to_numpy(pnet)
    total = outliers = 0
    for g, j in zip(got, jnet.params):
        for k in j:
            diff = np.abs(g[k] - np.asarray(j[k]))
            assert diff.max() <= LR / 10, (k, diff.max())
            outliers += int((diff > ATOL + ATOL * np.abs(np.asarray(j[k]))).sum())
            total += diff.size
    assert outliers <= 1e-4 * total
    assert np.abs(got[1]["centers"]).max() > 0  # the centers are trained


def test_json_round_trip_and_centers_in_the_param_dtype():
    pc, jc = _conf(pt), _conf(dj)
    assert json.loads(pc.to_json()) == json.loads(jc.to_json())
    back = pt.MultiLayerConfiguration.from_json(jc.to_json())
    assert isinstance(back.layers[1], pt.CenterLossOutputLayer)
    assert back.layers[1].lambda_ == 0.5 and back.layers[1].alpha == 0.05
    net = pt.MultiLayerNetwork(_conf(pt, "bfloat16"), device="cpu").init()
    centers = net._leaves()[1]["centers"]
    assert centers.dtype == torch.bfloat16 and tuple(centers.shape) == (4, 6)
    assert float(centers.detach().abs().max()) == 0.0
