"""The PyTorch port's ``utils.gradcheck.gradient_check`` in float64 on the
CPU (the kernels' plain versions) over the losses of the pretraining and
transfer layers: AutoEncoder, RBM (the free-energy difference its CD
gradient is taken from, the chain's sample held fixed: the surrogate's
gradient is not the derivative of its value, since the chain moves with
the params under a stop-gradient, so autograd of ``pretrain_loss`` is held
equal to that difference's), the VAE's
ELBO under each reconstruction distribution (fixed eps), CenterLoss's
head, a frozen layer (zero gradient) and a network's loss through them. It
must catch a deliberately wrong gradient, and it checks the same elements
as the JAX package's ``gradient_check`` for the same seed: with a gradient
wrong on every odd element only, both count the same failures.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from deeplearning4j_tpu.utils.gradcheck import gradient_check as jax_gradient_check  # noqa: E402

import deeplearning4j_tpu_torch as pt  # noqa: E402
from deeplearning4j_tpu_torch.utils.gradcheck import gradient_check  # noqa: E402


def _params(layer, n_in, seed=0):
    gen = torch.Generator().manual_seed(seed)
    p = layer.init_params(gen, pt.InputType.feed_forward(n_in))
    # away from zero and from the init's symmetric draws
    return {k: (v + 0.1 * torch.randn(v.shape, generator=gen)).double() for k, v in p.items()}


def _x(shape, seed=0, kind="real"):
    rng = np.random.default_rng(seed)
    if kind == "binary":
        return torch.tensor((rng.uniform(size=shape) > 0.5).astype(np.float64))
    if kind == "positive":
        return torch.tensor(rng.exponential(size=shape))
    return torch.tensor(rng.normal(size=shape))


def _vae(dist, n_samples=2):
    recon = {"bernoulli": pt.BernoulliReconstruction(),
             "gaussian": pt.GaussianReconstruction(),
             "exponential": pt.ExponentialReconstruction(),
             "loss_wrapper": pt.LossFunctionWrapper(loss="mse"),
             "composite": pt.CompositeReconstruction(
                 parts=[(3, pt.BernoulliReconstruction()), (3, pt.GaussianReconstruction())])}
    return pt.VariationalAutoencoder(n_in=6, n_out=2, encoder_layer_sizes=(5,),
                                     decoder_layer_sizes=(4,), num_samples=n_samples,
                                     reconstruction=recon[dist])


VAE_DATA = {"bernoulli": "binary", "gaussian": "real", "exponential": "positive",
            "loss_wrapper": "real", "composite": "binary"}


def _rbm_surrogate(rbm):
    """(the free-energy difference with v_model fixed at the chain's output
    from the first params it sees, and pretrain_loss with the same noise)."""
    g = torch.Generator().manual_seed(4)
    u = [(torch.rand(6, 4, generator=g, dtype=torch.float64),
          torch.rand(6, 5, generator=g, dtype=torch.float64)) for _ in range(2)]
    fixed = {}

    def v_model(p, x):
        if "v" not in fixed:
            with torch.no_grad():
                v = x
                for u_h, u_v in u:
                    h = (u_h < rbm.prop_up(p, v)).double()
                    v_prob = rbm.prop_down(p, h)
                    v = (u_v < v_prob).double() if rbm.visible_unit == "binary" else v_prob
                fixed["v"] = v_prob
        return fixed["v"]

    def difference(p, x):
        return (torch.mean(rbm.free_energy(p, x))
                - torch.mean(rbm.free_energy(p, v_model(p, x))))

    return difference, lambda p, x: rbm.pretrain_loss(p, x, uniforms=u)


def _cases():
    ae = pt.AutoEncoder(n_in=5, n_out=3, activation="sigmoid", corruption_level=0.3,
                        sparsity=0.1)
    u_ae = torch.rand(4, 5, generator=torch.Generator().manual_seed(3), dtype=torch.float64)
    cases = {"autoencoder": (lambda p, x: ae.pretrain_loss(p, x, uniforms=u_ae),
                             _params(ae, 5), _x((4, 5)))}
    for visible in ("binary", "gaussian"):
        rbm = pt.RBM(n_in=5, n_out=4, k=2, visible_unit=visible)
        cases[f"rbm_{visible}"] = (*_rbm_surrogate(rbm), _params(rbm, 5),
                                   _x((6, 5), kind="binary" if visible == "binary" else "real"))
    for dist, kind in VAE_DATA.items():
        vae = _vae(dist)
        eps = torch.randn(2, 4, 2, generator=torch.Generator().manual_seed(5),
                          dtype=torch.float64)
        cases[f"vae_{dist}"] = (lambda p, x, vae=vae, eps=eps: vae.pretrain_loss(p, x, eps=eps),
                                _params(vae, 6), _x((4, 6), kind=kind))
    head = pt.CenterLossOutputLayer(n_in=5, n_out=3, activation="softmax", lambda_=0.5)
    y = torch.eye(3, dtype=torch.float64)[torch.tensor([0, 2, 1, 2])]
    cases["center_loss"] = (lambda p, x: head.compute_loss(p, x, y), _params(head, 5),
                            _x((4, 5)))
    return cases


CASES = _cases()


@pytest.mark.parametrize("name", sorted(CASES))
def test_gradient_check_passes_on_the_new_layers(name):
    loss, *rest, params, x = CASES[name]
    passed, failures, max_rel = gradient_check(loss, params, x)
    assert passed, (failures, max_rel)
    assert max_rel < 1e-3
    if rest:  # the RBM: pretrain_loss's gradient is the difference's
        live = {k: v.clone().requires_grad_(True) for k, v in params.items()}
        want = torch.autograd.grad(loss(live, x), list(live.values()))
        got = torch.autograd.grad(rest[0](live, x), list(live.values()))
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, rtol=1e-12, atol=1e-12)


def test_gradient_check_over_a_network_loss_with_a_frozen_layer():
    """The network's forward through a frozen RBM, a dense layer and a
    center-loss head, as a function of per-layer param dicts: the unfrozen
    layers check; the frozen layer's gradient is zero (autograd never
    reaches it), which the check reports as wrong, since its true
    derivative is not zero."""
    conf = pt.MultiLayerConfiguration(
        layers=[pt.FrozenLayer(layer=pt.RBM(n_out=4)), pt.DenseLayer(n_out=3, activation="tanh"),
                pt.CenterLossOutputLayer(n_out=2, activation="softmax", lambda_=0.5)],
        input_type=pt.InputType.feed_forward(5), updater=pt.UpdaterConfig().to_dict())
    net = pt.MultiLayerNetwork(conf, device="cpu").init()
    x = torch.tensor(np.random.default_rng(0).normal(size=(6, 5)))
    y = torch.eye(2, dtype=torch.float64)[torch.tensor([0, 1, 1, 0, 1, 0])]
    params = [{k: v.detach().double() for k, v in p.items()} for p in net._leaves()]

    def loss(ps, x):
        h, _, _ = net._forward(ps, x, net.state, upto=2)
        return conf.layers[2].compute_loss(ps[2], h, y)

    passed, failures, _ = gradient_check(lambda ps, x: loss([params[0], *ps], x),
                                         params[1:], x)
    assert passed, failures
    live = {k: v.clone().requires_grad_(True) for k, v in params[0].items()}
    assert not loss([live, *params[1:]], x).requires_grad  # autograd never reaches it
    wrong, n_fail, _ = gradient_check(lambda p0, x: loss([p0, *params[1:]], x), params[0], x)
    assert not wrong and n_fail > 0  # the frozen leaves' true derivative is not zero


class _OddWrong(torch.autograd.Function):
    """x * w with the gradient for w doubled on odd elements."""

    @staticmethod
    def forward(ctx, w, x):
        ctx.save_for_backward(x)
        return w * x

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        scale = torch.ones_like(x)
        scale.view(-1)[1::2] = 2.0
        return g * x * scale, None


@jax.custom_vjp
def _jax_odd_wrong(w, x):
    return w * x


_jax_odd_wrong.defvjp(
    lambda w, x: (w * x, x),
    lambda x, g: (g * x * jnp.where(jnp.arange(x.size).reshape(x.shape) % 2 == 1, 2.0, 1.0),
                  None))


@pytest.mark.parametrize("n,budget", [(10, 256), (1000, 256), (1000, 40)])
def test_catches_a_wrong_gradient_on_the_same_elements_as_jax(n, budget):
    rng = np.random.default_rng(1)
    w = {"a": rng.normal(size=(n,)), "b": rng.normal(size=(7,))}
    x = rng.normal(size=(n,))

    def ploss(p, x):
        return torch.sum(torch.sin(_OddWrong.apply(p["a"], x))) + torch.sum(p["b"] ** 2)

    def jloss(p, x):
        return jnp.sum(jnp.sin(_jax_odd_wrong(p["a"], x))) + jnp.sum(p["b"] ** 2)

    got = gradient_check(ploss, {k: torch.tensor(v) for k, v in w.items()}, torch.tensor(x),
                         max_params_to_check=budget, seed=3)
    want = jax_gradient_check(jloss, {k: jnp.asarray(v) for k, v in w.items()},
                              jnp.asarray(x), max_params_to_check=budget, seed=3)
    assert not got[0] and not want[0]
    assert got[1] == want[1] > 0
    np.testing.assert_allclose(got[2], float(want[2]), rtol=1e-6)
    right = gradient_check(lambda p, x: torch.sum(torch.sin(p["a"] * x)) + torch.sum(p["b"] ** 2),
                           {k: torch.tensor(v) for k, v in w.items()}, torch.tensor(x),
                           max_params_to_check=budget, seed=3)
    assert right[0] and right[1] == 0
