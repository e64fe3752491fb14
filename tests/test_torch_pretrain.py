"""The PyTorch port's pretrain layers (AutoEncoder, RBM, VariationalAutoencoder
and its five reconstruction distributions), ``MultiLayerNetwork.pretrain``
and ``dbn_conf`` against the JAX package.

The JAX package draws its noise with ``jax.random``: ``bernoulli(key, p)``
is ``uniform(key, shape, p.dtype) < p`` (checked here), and the VAE's
``normal(key, mean.shape, mean.dtype)``. The port's functions take their
uniforms (``uniforms``) and normals (``eps``) through a seam, so each test
regenerates JAX's draws from JAX's keys, by JAX's key schedule, and passes
them in: RBM ``split(rng, k)`` then ``kh, kv = split(key)`` each Gibbs step;
AutoEncoder one ``bernoulli(rng, 1 - c, x.shape)``; VAE ``split(rng,
num_samples)``; ``pretrain`` one ``self._rng, k = split(self._rng)`` per
batch. The layer functions run in float64 on both sides (x64, as
``tests/conftest.py`` sets it) and are held at 1e-9 relative; ``pretrain``
runs in f32 with x64 off on the JAX side (Adam's bias corrections, as
``test_torch_adam.py`` explains) and holds every batch's last loss and every
param at 1e-5, but for at most one element in 10,000 within a tenth of an
Adam step, as ``test_torch_lenet_mlp.py`` holds Adam.
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import deeplearning4j_tpu as dj  # noqa: E402
from deeplearning4j_tpu.datasets.iterators import DataSet as JDataSet  # noqa: E402
from deeplearning4j_tpu.models import dbn_conf as jax_dbn_conf  # noqa: E402

import deeplearning4j_tpu_torch as pt  # noqa: E402
from deeplearning4j_tpu_torch.datasets.iterators import DataSet  # noqa: E402

REL64 = 1e-9
ATOL = 1e-5
ADAM_OUTLIERS = 1e-4


def _binary_data(n=64, d=12, seed=0):
    """tests/test_pretrain.py's data: two prototype patterns with 5% of the
    bits flipped."""
    rng = np.random.default_rng(seed)
    protos = rng.integers(0, 2, size=(2, d)).astype(np.float64)
    idx = rng.integers(0, 2, size=n)
    flip = rng.uniform(size=(n, d)) < 0.05
    return np.abs(protos[idx] - flip), idx


def _f64(params):
    return {k: np.asarray(v, np.float64) for k, v in params.items()}


def _t(params):
    return {k: torch.tensor(v, requires_grad=True) for k, v in params.items()}


def _close(got, want, rel=REL64):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(float(np.abs(want).max()), 1e-30)
    assert float(np.abs(got - want).max()) <= rel * scale, (got, want)


def _loss_and_grads_match(jloss, jparams, ploss_of, *args):
    """JAX's loss and gradients of ``jloss(params, *args)`` against the
    port's ``ploss_of(params)`` from the same float64 params."""
    want, jgrads = jax.value_and_grad(jloss)({k: jnp.asarray(v) for k, v in jparams.items()},
                                            *args)
    tp = _t(jparams)
    got = ploss_of(tp)
    grads = torch.autograd.grad(got, list(tp.values()))
    _close(got.detach().numpy(), want)
    for k, g in zip(tp, grads):
        _close(g.numpy(), jgrads[k])


def rbm_uniforms(key, k, batch, n_in, n_out, dtype):
    """The uniforms behind RBM.pretrain_loss's Bernoulli draws from ``key``:
    ``split(key, k)``, then ``kh, kv = split(step_key)`` each step."""
    out = []
    for step_key in jax.random.split(key, k):
        kh, kv = jax.random.split(step_key)
        out.append((torch.tensor(np.asarray(jax.random.uniform(kh, (batch, n_out), dtype))),
                    torch.tensor(np.asarray(jax.random.uniform(kv, (batch, n_in), dtype)))))
    return out


def vae_eps(key, n, shape, dtype):
    """The normals of VariationalAutoencoder's draws from ``key``."""
    return torch.tensor(np.stack([np.asarray(jax.random.normal(k, shape, dtype))
                                  for k in jax.random.split(key, n)]))


def test_bernoulli_is_uniform_below_p():
    """The seam's premise, for an array p and a scalar p with a shape."""
    key = jax.random.PRNGKey(3)
    p = jnp.asarray(np.random.default_rng(0).uniform(size=(5, 7)))
    assert bool(jnp.all(jax.random.bernoulli(key, p)
                        == (jax.random.uniform(key, p.shape, p.dtype) < p)))
    dt = jnp.asarray(0.7).dtype
    assert bool(jnp.all(jax.random.bernoulli(key, 0.7, (5, 7))
                        == (jax.random.uniform(key, (5, 7), dt) < 0.7)))


# --------------------------------------------------------------- AutoEncoder
@pytest.mark.parametrize("corruption,sparsity,act", [(0.0, 0.0, "sigmoid"), (0.3, 0.0, "sigmoid"),
                                                     (0.3, 0.05, "sigmoid"), (0.2, 0.1, "tanh")])
def test_autoencoder_loss_and_grads_match_jax(corruption, sparsity, act):
    kw = dict(n_in=12, n_out=6, activation=act, corruption_level=corruption, sparsity=sparsity)
    jae, pae = dj.AutoEncoder(**kw), pt.AutoEncoder(**kw)
    jp = _f64(jae.init_params(jax.random.PRNGKey(0), dj.InputType.feed_forward(12)))
    x, _ = _binary_data()
    rng = jax.random.PRNGKey(11)
    u = torch.tensor(np.asarray(jax.random.uniform(rng, x.shape, jnp.asarray(0.5).dtype)))
    _loss_and_grads_match(lambda p, xx: jae.pretrain_loss(p, xx, rng), jp,
                          lambda p: pae.pretrain_loss(p, torch.tensor(x), uniforms=u),
                          jnp.asarray(x))
    # without noise neither package corrupts
    _loss_and_grads_match(lambda p, xx: jae.pretrain_loss(p, xx), jp,
                          lambda p: pae.pretrain_loss(p, torch.tensor(x)), jnp.asarray(x))
    _close(pae.encode(_t(jp), torch.tensor(x)).detach().numpy(),
           jae.encode({k: jnp.asarray(v) for k, v in jp.items()}, jnp.asarray(x)))


def test_autoencoder_sparsity_penalty_raises_the_loss():
    x = torch.tensor(np.random.default_rng(0).uniform(size=(4, 5)))
    p = _t(_f64(dj.AutoEncoder(n_in=5, n_out=3).init_params(
        jax.random.PRNGKey(0), dj.InputType.feed_forward(5))))
    sparse = pt.AutoEncoder(n_in=5, n_out=3, activation="sigmoid", sparsity=0.05,
                            corruption_level=0.0)
    plain = pt.AutoEncoder(n_in=5, n_out=3, activation="sigmoid", corruption_level=0.0)
    with torch.no_grad():
        assert float(sparse.pretrain_loss(p, x)) > float(plain.pretrain_loss(p, x))


# ----------------------------------------------------------------------- RBM
@pytest.mark.parametrize("visible", ["binary", "gaussian"])
@pytest.mark.parametrize("hidden", ["binary", "gaussian"])
@pytest.mark.parametrize("k", [1, 2])
def test_rbm_cd_loss_and_grads_match_jax(visible, hidden, k):
    kw = dict(n_in=12, n_out=8, k=k, visible_unit=visible, hidden_unit=hidden)
    jr, pr = dj.RBM(**kw), pt.RBM(**kw)
    jp = _f64(jr.init_params(jax.random.PRNGKey(1), dj.InputType.feed_forward(12)))
    x, _ = _binary_data()
    if visible == "gaussian":
        x = np.random.default_rng(5).normal(size=x.shape)
    rng = jax.random.PRNGKey(7)
    u = rbm_uniforms(rng, k, 64, 12, 8, jnp.float64)
    _loss_and_grads_match(lambda p, xx: jr.pretrain_loss(p, xx, rng), jp,
                          lambda p: pr.pretrain_loss(p, torch.tensor(x), uniforms=u),
                          jnp.asarray(x))
    jpa = {k_: jnp.asarray(v) for k_, v in jp.items()}
    tp = _t(jp)
    _close(pr.prop_up(tp, torch.tensor(x)).detach().numpy(), jr.prop_up(jpa, jnp.asarray(x)))
    _close(pr.reconstruction_error(tp, torch.tensor(x)).detach().numpy(),
           jr.reconstruction_error(jpa, jnp.asarray(x)))
    h = np.random.default_rng(2).uniform(size=(64, 8))
    _close(pr.prop_down(tp, torch.tensor(h)).detach().numpy(), jr.prop_down(jpa, jnp.asarray(h)))


def test_rbm_noise_from_a_generator_is_repeatable():
    pr = pt.RBM(n_in=12, n_out=8, k=2)
    p = _t(_f64(dj.RBM(n_in=12, n_out=8).init_params(jax.random.PRNGKey(1),
                                                     dj.InputType.feed_forward(12))))
    x = torch.tensor(_binary_data()[0])
    with torch.no_grad():
        a = pr.pretrain_loss(p, x, generator=torch.Generator().manual_seed(4))
        b = pr.pretrain_loss(p, x, generator=torch.Generator().manual_seed(4))
        c = pr.pretrain_loss(p, x)  # fixed noise (a generator seeded 0)
        assert float(a) == float(b) and float(c) == float(pr.pretrain_loss(p, x))


# ----------------------------------------------------------------------- VAE
DISTS = {
    "bernoulli": (lambda pkg: pkg.BernoulliReconstruction(), "binary"),
    "gaussian": (lambda pkg: pkg.GaussianReconstruction(), "real"),
    "exponential": (lambda pkg: pkg.ExponentialReconstruction(), "positive"),
    "loss_wrapper": (lambda pkg: pkg.LossFunctionWrapper(loss="mse"), "real"),
    "composite": (lambda pkg: pkg.CompositeReconstruction(
        parts=[(4, pkg.BernoulliReconstruction()), (4, pkg.GaussianReconstruction())]),
        "binary"),
}


def _vae(pkg, dist, num_samples, pzx="identity"):
    return pkg.VariationalAutoencoder(
        n_in=8, n_out=3, encoder_layer_sizes=(16, 12), decoder_layer_sizes=(16,),
        activation="tanh", pzx_activation=pzx, num_samples=num_samples,
        reconstruction=DISTS[dist][0](pkg))


def _vae_data(kind):
    rng = np.random.default_rng(0)
    if kind == "binary":
        return (rng.uniform(size=(6, 8)) > 0.5).astype(np.float64)
    if kind == "positive":
        return rng.exponential(size=(6, 8))
    return rng.normal(size=(6, 8))


@pytest.mark.parametrize("num_samples", [1, 3])
@pytest.mark.parametrize("dist", sorted(DISTS))
def test_vae_elbo_log_probability_and_mean_match_jax(dist, num_samples):
    jv, pv = _vae(dj, dist, num_samples), _vae(pt, dist, num_samples)
    jp = _f64(jv.init_params(jax.random.PRNGKey(0), dj.InputType.feed_forward(8)))
    assert set(jp) == set(pv.init_params(torch.Generator().manual_seed(0),
                                         pt.InputType.feed_forward(8)))
    x = _vae_data(DISTS[dist][1])
    rng = jax.random.PRNGKey(1)
    eps = vae_eps(rng, num_samples, (6, 3), jnp.float64)
    _loss_and_grads_match(lambda p, xx: jv.pretrain_loss(p, xx, rng), jp,
                          lambda p: pv.pretrain_loss(p, torch.tensor(x), eps=eps),
                          jnp.asarray(x))
    jpa, tp = {k: jnp.asarray(v) for k, v in jp.items()}, _t(jp)
    for n in (None, 5):
        k = n or max(num_samples, 8)
        want = jv.reconstruction_log_probability(jpa, jnp.asarray(x), rng, num_samples=n)
        got = pv.reconstruction_log_probability(tp, torch.tensor(x), num_samples=n,
                                                eps=vae_eps(rng, k, (6, 3), jnp.float64))
        assert got.shape == (6,)
        _close(got.detach().numpy(), want)
    z = np.random.default_rng(3).normal(size=(6, 3))
    _close(pv.generate_at_mean_given_z(tp, torch.tensor(z)).detach().numpy(),
           jv.generate_at_mean_given_z(jpa, jnp.asarray(z)))
    out, _ = pv.apply(tp, torch.tensor(x), {})
    _close(out.detach().numpy(), jv.apply(jpa, jnp.asarray(x), {})[0])


def test_vae_pzx_activation_maps_mean_and_log_variance_as_jax():
    jv, pv = _vae(dj, "bernoulli", 2, pzx="tanh"), _vae(pt, "bernoulli", 2, pzx="tanh")
    jp = _f64(jv.init_params(jax.random.PRNGKey(4), dj.InputType.feed_forward(8)))
    x = _vae_data("binary")
    rng = jax.random.PRNGKey(2)
    _loss_and_grads_match(lambda p, xx: jv.pretrain_loss(p, xx, rng), jp,
                          lambda p: pv.pretrain_loss(p, torch.tensor(x),
                                                     eps=vae_eps(rng, 2, (6, 3), jnp.float64)),
                          jnp.asarray(x))


# ---------------------------------------------------------------------- JSON
def _layer_confs(pkg):
    return {
        "autoencoder": pkg.AutoEncoder(n_out=6, activation="sigmoid", corruption_level=0.2,
                                       sparsity=0.05),
        "rbm": pkg.RBM(n_out=6, k=3, visible_unit="gaussian"),
        "vae": _vae(pkg, "composite", 2, pzx="tanh"),
        "vae_exponential": _vae(pkg, "exponential", 1),
        "vae_loss_wrapper": _vae(pkg, "loss_wrapper", 1),
    }


@pytest.mark.parametrize("name", sorted(_layer_confs(pt)))
def test_layer_json_matches_jax_both_ways(name):
    def conf(pkg):
        return pkg.MultiLayerConfiguration(
            layers=[_layer_confs(pkg)[name], pkg.OutputLayer(n_out=2, activation="softmax")],
            input_type=pkg.InputType.feed_forward(8), updater=pkg.UpdaterConfig())

    jc, pc = conf(dj), conf(pt)
    assert json.loads(pc.to_json()) == json.loads(jc.to_json())
    back = pt.MultiLayerConfiguration.from_json(jc.to_json())
    assert back.to_json() == pc.to_json()
    assert type(back.layers[0]) is type(pc.layers[0])
    assert dj.MultiLayerConfiguration.from_json(pc.to_json()).to_json() == jc.to_json()


def test_dbn_conf_json_matches_jax():
    for kw in ({}, dict(n_in=64, layer_sizes=(96, 48), visible_unit="gaussian",
                        updater="adam", learning_rate=2e-3, seed=5)):
        assert pt.dbn_conf(**kw).to_json() == jax_dbn_conf(**kw).to_json()
    kinds = [type(l).__name__ for l in pt.dbn_conf().layers]
    assert kinds == ["RBM", "RBM", "RBM", "OutputLayer"]


# ------------------------------------------------------------------ pretrain
class JaxNoise:
    """The port's ``pretrain(noise=...)`` seam fed with the JAX network's
    draws: one ``rng, k = split(rng)`` per batch from the JAX net's starting
    ``_rng``, then each layer's own schedule from k (f32, x64 off)."""

    def __init__(self, rng):
        self.rng = rng

    def __call__(self, idx, layer, h):
        self.rng, k = jax.random.split(self.rng)
        b = h.shape[0]
        if isinstance(layer, pt.RBM):
            return {"uniforms": rbm_uniforms(k, layer.k, b, h.shape[1], layer.n_out,
                                             jnp.float32)}
        if isinstance(layer, pt.AutoEncoder):
            return {"uniforms": torch.tensor(np.asarray(
                jax.random.uniform(k, tuple(h.shape), jnp.float32)))}
        return {"eps": vae_eps(k, layer.num_samples, (b, layer.n_out), jnp.float32)}


def _pretrain_conf(pkg, kind):
    u = pkg.UpdaterConfig(updater="adam", learning_rate=1e-2)
    if kind.startswith("dbn"):
        return (jax_dbn_conf if pkg is dj else pt.dbn_conf)(
            n_in=12, layer_sizes=(10, 6), n_classes=2, k=2 if kind == "dbn" else 1,
            visible_unit="binary" if kind == "dbn" else "gaussian", updater="adam",
            learning_rate=1e-2, seed=3)
    first = (pkg.AutoEncoder(n_out=6, activation="sigmoid", corruption_level=0.3,
                             sparsity=0.05) if kind == "autoencoder"
             else pkg.VariationalAutoencoder(n_out=3, encoder_layer_sizes=(10,),
                                             decoder_layer_sizes=(10,), num_samples=2))
    return pkg.MultiLayerConfiguration(
        layers=[first, pkg.OutputLayer(n_out=2, activation="softmax", loss="mcxent")],
        input_type=pkg.InputType.feed_forward(12), updater=u if pkg is dj else u.to_dict(),
        seed=3)


def _f32(tree):
    return jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float32), tree)


@pytest.mark.parametrize("kind", ["dbn", "dbn_gaussian", "autoencoder", "vae"])
def test_pretrain_matches_jax_batch_by_batch(kind):
    """``pretrain`` over 2 epochs of 2 batches, every pretrainable layer in
    turn with a fresh Adam, against JAX's with its key sequence replayed;
    then one fine-tune update of the whole stack."""
    x, idx = _binary_data(n=64, d=12, seed=1)
    if kind == "dbn_gaussian":
        x = np.random.default_rng(2).normal(size=x.shape)
    x = x.astype(np.float32)
    y = np.eye(2, dtype=np.float32)[idx]
    batches = [(x[:32], y[:32]), (x[32:], y[32:])]
    with jax.enable_x64(False):
        jnet = dj.MultiLayerNetwork(_pretrain_conf(dj, kind)).init()
        jnet.init(params=_f32(jnet.params), force=True)
        pnet = pt.load_jax_params(pt.MultiLayerNetwork(_pretrain_conf(pt, kind), device="cpu"),
                                  jnet.params)
        assert pnet.conf.to_json() == jnet.conf.to_json()
        noise = JaxNoise(jnet._rng)
        jnet.pretrain([JDataSet(a, b) for a, b in batches], epochs=2)
        pnet.pretrain([DataSet(a, b) for a, b in batches], epochs=2, noise=noise)
        assert np.asarray(noise.rng).tolist() == np.asarray(jnet._rng).tolist()
        np.testing.assert_allclose(float(pnet._last_loss), float(jnet._last_loss),
                                   rtol=ATOL, atol=ATOL)
        _params_match(pnet, jnet)
        jnet.fit(JDataSet(x, y))
        pnet.fit(DataSet(x, y))
        _params_match(pnet, jnet)


def _params_match(pnet, jnet, lr=1e-2):
    got = pt.params_to_numpy(pnet)
    total = outliers = 0
    for i, (g, j) in enumerate(zip(got, jnet.params)):
        for k in j:
            diff = np.abs(g[k] - np.asarray(j[k], np.float32))
            assert diff.max() <= lr / 10, (i, k, diff.max())
            total += diff.size
            outliers += int((diff > ATOL + ATOL * np.abs(np.asarray(j[k]))).sum())
    assert outliers <= ADAM_OUTLIERS * total, (outliers, total)


def test_pretrain_draws_from_the_network_generator_and_drops_captured_steps():
    conf = _pretrain_conf(pt, "dbn")
    x = _binary_data(n=32, d=12)[0].astype(np.float32)

    def run():
        net = pt.MultiLayerNetwork(conf, device="cpu").init()
        net._step_graphs.put("k", object())
        net.pretrain(DataSet(x, None), epochs=2)
        return net

    a, b = run(), run()
    assert len(a._step_graphs) == 0
    for pa, pb in zip(pt.params_to_numpy(a), pt.params_to_numpy(b)):
        for k in pa:
            np.testing.assert_array_equal(pa[k], pb[k])
    fresh = pt.params_to_numpy(pt.MultiLayerNetwork(conf, device="cpu").init())
    assert not np.array_equal(fresh[0]["W"], pt.params_to_numpy(a)[0]["W"])
    np.testing.assert_array_equal(fresh[2]["W"], pt.params_to_numpy(a)[2]["W"])  # the head
    with pytest.raises(ValueError, match="not pretrainable"):
        a.pretrain_layer(2, DataSet(x, None))


# --------------------------------------------------------------------- pins
def test_autoencoder_pretrain_then_finetune_pin():
    """tests/test_pretrain.py's pin on the port: AutoEncoder pretrain (30
    epochs), then 30 fine-tune epochs, above 0.95 on its data."""
    x, idx = _binary_data(n=128, d=12)
    y = np.eye(2)[idx]
    conf = pt.MultiLayerConfiguration(
        layers=[pt.AutoEncoder(n_in=12, n_out=6, activation="sigmoid", corruption_level=0.1),
                pt.OutputLayer(n_in=6, n_out=2, activation="softmax", loss="mcxent")],
        input_type=pt.InputType.feed_forward(12),
        updater=pt.UpdaterConfig(updater="adam", learning_rate=0.01), seed=1)
    net = pt.MultiLayerNetwork(conf, device="cpu").init()
    net.pretrain(DataSet(x, None), epochs=30)
    net.fit(DataSet(x, y), epochs=30)
    assert net.evaluate([DataSet(x, y)]).accuracy() > 0.95


@pytest.mark.parametrize("kind", ["rbm", "vae"])
def test_pretrain_improves_its_objective(kind):
    """tests/test_pretrain.py's RBM and VAE pins on the port: CD-k lowers
    the reconstruction error below 0.7 of its start; the ELBO falls."""
    x, _ = _binary_data(n=128, d=12 if kind == "rbm" else 8)
    x = x.astype(np.float32)
    layer = (pt.RBM(n_in=12, n_out=8, k=1) if kind == "rbm" else
             pt.VariationalAutoencoder(n_in=8, n_out=3, encoder_layer_sizes=(16,),
                                       decoder_layer_sizes=(16,)))
    conf = pt.MultiLayerConfiguration(
        layers=[layer, pt.OutputLayer(n_out=2, activation="softmax")],
        input_type=pt.InputType.feed_forward(x.shape[1]),
        updater=pt.UpdaterConfig(updater="sgd" if kind == "rbm" else "adam",
                                 learning_rate=0.1 if kind == "rbm" else 0.01), seed=1)
    net = pt.MultiLayerNetwork(conf, device="cpu").init()
    xt = torch.tensor(x)

    def objective():
        p = net._leaves()[0]
        with torch.no_grad():
            if kind == "rbm":
                return float(layer.reconstruction_error(p, xt))
            return float(layer.pretrain_loss(p, xt, generator=torch.Generator().manual_seed(5)))

    before = objective()
    net.pretrain(DataSet(x, None), epochs=100 if kind == "rbm" else 80)
    assert objective() < (0.7 if kind == "rbm" else 1.0) * before


def test_dbn_digits_pin():
    """examples/dbn_pretrain.py's quick run on the port (CPU): the DBN
    64-96-48-10 with Gaussian visible units, Adam at 2e-3, seed 5, 2
    pretrain and 12 fine-tune epochs over the bundled digits, above
    tests/test_examples.py's 0.7 on the 360 held out."""
    conf = pt.dbn_conf(n_in=64, layer_sizes=(96, 48), n_classes=10, visible_unit="gaussian",
                       updater="adam", learning_rate=2e-3, seed=5)
    assert conf.to_json() == jax_dbn_conf(n_in=64, layer_sizes=(96, 48), n_classes=10,
                                           visible_unit="gaussian", updater="adam",
                                           learning_rate=2e-3, seed=5).to_json()
    net = pt.MultiLayerNetwork(conf, device="cpu").init()
    it = pt.DigitsDataSetIterator(batch=128, train=True, flat=True)
    net.pretrain(it, epochs=2)
    net.fit(it, epochs=12)
    ev = net.evaluate(pt.DigitsDataSetIterator(batch=120, train=False, shuffle=False, flat=True))
    assert ev.accuracy() > 0.7
