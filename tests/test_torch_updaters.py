"""The seven optax updaters the port runs as plain tensor ops (adamw,
adamax, adadelta, adagrad, rmsprop, lamb, lion) against the JAX package's
``UpdaterConfig.build()``.

The same conf JSON, the JAX net's params (``load_jax_params``) and numpy
batches from a seed go through five per-batch updates of a small
MultiLayerNetwork and a small ComputationGraph in both packages; the JAX
side runs with x64 off and f32 params, as ``tests/test_torch_staged_fit.py``
explains. Params, losses and the updater's leaves (counts included) are held
at 1e-5 absolute and relative (both round in f32; XLA and torch order the
trust ratio's sums otherwise and may round ``rsqrt`` a unit apart). The
state leaves go both ways: JAX's leaves into the port
(``set_updater_state_leaves``, what ``load_jax_params``' callers and the
zips use) and the port's zip into JAX, each followed by an update on both
sides. On the CPU the staged loop's in-place form (scalars from the table,
through device memory on the card) equals the per-batch form bit for bit.
adadelta ignores the conf's learning rate and keeps no count.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import deeplearning4j_tpu as dj  # noqa: E402
from deeplearning4j_tpu.runtime import inference as jax_inference  # noqa: E402
from deeplearning4j_tpu.datasets.iterators import DataSet as JaxDataSet  # noqa: E402
from deeplearning4j_tpu.ops import kernel_select  # noqa: E402
from deeplearning4j_tpu.utils import serialization as jax_serialization  # noqa: E402

import deeplearning4j_tpu_torch as pt  # noqa: E402
from deeplearning4j_tpu_torch.nn import updaters  # noqa: E402

ATOL = RTOL = 1e-5
LR = 1e-2
SEVEN = ("adamw", "adamax", "adadelta", "adagrad", "rmsprop", "lamb", "lion")
UPDATES = 5


@pytest.fixture(autouse=True)
def jax_env(monkeypatch, tmp_path):
    monkeypatch.setattr(jax_inference, "fast_path_enabled", lambda: False)
    monkeypatch.setenv("DL4JTPU_KERNEL_CALIBRATION", str(tmp_path / "calibration.json"))
    kernel_select.reset()
    yield
    kernel_select.reset()


def _f32(tree):
    return jax.tree_util.tree_map(
        lambda a: a.astype(jnp.float32) if jnp.issubdtype(a.dtype, jnp.floating) else a,
        tree)


def _upd(pkg, name, **kw):
    u = pkg.UpdaterConfig(updater=name, learning_rate=LR, **kw)
    return u if pkg is dj else u.to_dict()


def _mlp(pkg, name, **kw):
    return pkg.MultiLayerConfiguration(
        layers=[pkg.DenseLayer(n_out=12, activation="tanh"),
                pkg.OutputLayer(n_out=3, activation="softmax", loss="mcxent")],
        input_type=pkg.InputType.feed_forward(5), updater=_upd(pkg, name, **kw), seed=3)


def _graph(pkg, name, **kw):
    return (pkg.ComputationGraphConfiguration.builder().seed(4)
            .updater(_upd(pkg, name, **kw)).add_inputs("in")
            .add_layer("h", pkg.DenseLayer(n_out=10, activation="relu"), "in")
            .add_layer("out", pkg.OutputLayer(n_out=3, activation="softmax", loss="mcxent"),
                       "h")
            .set_outputs("out").set_input_types(pkg.InputType.feed_forward(5)).build())


def _pair(make, graph):
    cls_j = dj.ComputationGraph if graph else dj.MultiLayerNetwork
    cls_p = pt.ComputationGraph if graph else pt.MultiLayerNetwork
    jnet = cls_j(make(dj)).init()
    jnet.init(params=_f32(jnet.params), force=True)
    pconf = make(pt)
    assert pconf.to_json() == jnet.conf.to_json()
    host = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), jnet.params)
    return jnet, pt.load_jax_params(cls_p(pconf, device="cpu"), host)


def _batches(n, b=8, seed=0):
    rng = np.random.default_rng(seed)
    return [(rng.normal(size=(b, 5)).astype(np.float32),
             np.eye(3, dtype=np.float32)[rng.integers(0, 3, b)]) for _ in range(n)]


def _close(got, want, what=""):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               atol=ATOL, rtol=RTOL, err_msg=what)


def _assert_matches(pnet, jnet):
    jp = jax.tree_util.tree_leaves(jnet.params)
    pp = [layer[k] for layer in pnet._leaves() for k in sorted(layer)]
    assert len(jp) == len(pp)
    for i, (j, p) in enumerate(zip(jp, pp)):
        _close(p.detach(), j, f"param leaf {i}")
    jo = jax.tree_util.tree_leaves(jnet.opt_state)
    po = pnet.updater_state_leaves()
    assert len(jo) == len(po)
    for i, (j, p) in enumerate(zip(jo, po)):
        if np.asarray(j).dtype.kind in "iu":
            assert int(p) == int(j), f"updater count leaf {i}"
        else:
            _close(p, j, f"updater leaf {i}")


def _fit_both(jnet, pnet, batches):
    jl, pl = [], []
    with jax.enable_x64(False):
        for x, y in batches:
            jnet.fit(JaxDataSet(x, y))
            jl.append(float(jnet.score()))
            pnet.fit((x, y))
            pl.append(pnet.score())
    _close(pl, jl, "losses")


@pytest.mark.parametrize("graph", [False, True], ids=["mln", "graph"])
@pytest.mark.parametrize("name", SEVEN)
def test_updater_follows_jax_build_over_five_updates(name, graph):
    make = (lambda pkg: _graph(pkg, name)) if graph else (lambda pkg: _mlp(pkg, name))
    jnet, pnet = _pair(make, graph)
    _fit_both(jnet, pnet, _batches(UPDATES, seed=11))
    assert pnet.iteration == jnet.iteration == UPDATES
    _assert_matches(pnet, jnet)


@pytest.mark.parametrize("name", SEVEN)
def test_updater_with_schedule_and_conf_hyperparams_follows_jax(name):
    """An inverse schedule over the five updates and the conf's betas,
    epsilon, rho and rms_decay set away from their defaults: adamw, adamax,
    adagrad and rmsprop read them; lamb and lion keep optax's defaults;
    adadelta keeps learning rate 1.0."""
    kw = dict(beta1=0.8, beta2=0.99, epsilon=1e-6, rho=0.9, rms_decay=0.9,
              lr_policy="inverse", lr_policy_decay_rate=0.3, lr_policy_power=0.75)
    jnet, pnet = _pair(lambda pkg: _mlp(pkg, name, **kw), False)
    _fit_both(jnet, pnet, _batches(UPDATES, seed=12))
    _assert_matches(pnet, jnet)


@pytest.mark.parametrize("name", SEVEN)
def test_state_leaves_follow_optax_chain_order(name):
    """The port's leaves have the shapes, dtypes and count of JAX's
    ``tree_leaves(opt_state)`` (the chain's leading normalization state and
    the cores' EmptyStates hold none), and JAX's leaves set into the port
    continue training as JAX's net does."""
    jnet, pnet = _pair(lambda pkg: _mlp(pkg, name), False)
    batches = _batches(3, seed=13)
    with jax.enable_x64(False):
        for x, y in batches[:2]:
            jnet.fit(JaxDataSet(x, y))
    jleaves = jax.tree_util.tree_leaves(jnet.opt_state)
    pleaves = pnet.updater_state_leaves()
    assert [tuple(np.shape(a)) for a in jleaves] == [tuple(t.shape) for t in pleaves]
    assert [np.asarray(a).dtype.kind for a in jleaves] == [
        "i" if t.dtype == torch.int32 else "f" for t in pleaves]
    pnet.init(params=jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), jnet.params))
    pnet.set_updater_state_leaves(jleaves)
    for jl, pl in zip(jleaves, pnet.updater_state_leaves()):
        np.testing.assert_array_equal(pl.numpy(), np.asarray(jl))
    _fit_both(jnet, pnet, batches[2:])
    _assert_matches(pnet, jnet)


@pytest.mark.parametrize("name", SEVEN)
def test_zips_carry_the_state_both_ways(name, tmp_path):
    """The port's zip restores in JAX and JAX's in the port, updater state
    included; the next update agrees."""
    batches = _batches(4, seed=14)
    pnet = pt.MultiLayerNetwork(_mlp(pt, name), device="cpu").init()
    for b in batches[:2]:
        pnet.fit(b)
    path = str(tmp_path / "port.zip")
    pt.write_model(pnet, path)
    jnet = jax_serialization.restore_model(path)
    jnet.params, jnet.opt_state = _f32(jnet.params), _f32(jnet.opt_state)
    for jl, pl in zip(jax.tree_util.tree_leaves(jnet.opt_state), pnet.updater_state_leaves()):
        np.testing.assert_array_equal(np.asarray(jl), pl.numpy())
    _fit_both(jnet, pnet, batches[2:3])
    _assert_matches(pnet, jnet)
    back = str(tmp_path / "jax.zip")
    jax_serialization.write_model(jnet, back)
    restored = pt.restore_model(back, device="cpu")
    for jl, pl in zip(jax.tree_util.tree_leaves(jnet.opt_state),
                      restored.updater_state_leaves()):
        np.testing.assert_array_equal(pl.numpy(), np.asarray(jl))
    _fit_both(jnet, restored, batches[3:])
    _assert_matches(restored, jnet)


@pytest.mark.parametrize("graph", [False, True], ids=["mln", "graph"])
@pytest.mark.parametrize("name", SEVEN)
def test_in_place_captured_form_is_the_per_batch_form(name, graph):
    """The staged loop's step on the CPU (scalars from ``step_scalars``,
    new params and state written in place) against per-batch ``fit`` on
    the same batches: bit for bit."""
    cls = pt.ComputationGraph if graph else pt.MultiLayerNetwork
    conf = (_graph if graph else _mlp)(pt, name)
    staged = cls(conf, device="cpu").init()
    plain = cls(type(conf).from_json(conf.to_json()), device="cpu").init()
    plain.init(params=pt.params_to_numpy(staged))
    batches = _batches(3, seed=15)
    xs = np.stack([x for x, _ in batches])
    ys = np.stack([y for _, y in batches])
    losses = staged.fit_on_device(xs, ys, steps=5)
    want = []
    for i in range(5):
        plain.fit(batches[i % 3])
        want.append(plain.score())
    np.testing.assert_array_equal(losses, np.float32(want))
    for p, q in zip(staged.parameters(), plain.parameters()):
        assert torch.equal(p, q)
    for p, q in zip(staged.updater_state_leaves(), plain.updater_state_leaves()):
        assert torch.equal(p, q)


@pytest.mark.parametrize("name", SEVEN)
def test_step_scalar_rows(name):
    """Column 0 the learning rate of each count (1.0 for adadelta, which
    has no count), columns 1-2 the bias corrections: bc1 and bc2 for adamw
    and lamb, bc1 alone for adamax, 1 elsewhere."""
    tx = pt.UpdaterConfig(updater=name, learning_rate=0.3, lr_policy="step",
                          lr_policy_decay_rate=0.5, lr_policy_steps=2).build()
    state = tx.init([{"W": torch.zeros(2, 2)}])
    for _ in range(3):
        state = updaters.advance_counts(state, 1)
    rows = updaters.step_scalars(tx, state, 4)
    if name == "adadelta":
        assert "count" not in state and (rows[:, 0] == 1.0).all()
    else:
        assert rows[:, 0].tolist() == np.float32([tx.schedule(3 + i) for i in range(4)]).tolist()
    b1, b2 = (tx.hyper.get("b1"), tx.hyper.get("b2"))
    for i in range(4):
        bc = updaters.bias_corrections(3 + i + 1, b1, b2, torch.float32) if b1 else (1.0, 1.0)
        want = {"adamw": bc, "lamb": bc, "adamax": (bc[0], 1.0)}.get(name, (1.0, 1.0))
        assert rows[i, 1:].tolist() == np.float32(want).tolist()


def test_adadelta_ignores_the_learning_rate_and_its_schedule():
    """optax.adadelta(learning_rate=1.0) whatever the conf's rate and
    schedule: two confs with other rates train to the same bits, and
    JAX's does the same."""
    batches = _batches(4, seed=16)
    nets = []
    for lr, policy in ((1e-3, "none"), (5.0, "exponential")):
        conf = _mlp(pt, "adadelta")
        conf.updater = dict(conf.updater, learning_rate=lr, lr_policy=policy,
                            lr_policy_decay_rate=0.5)
        net = pt.MultiLayerNetwork(conf, device="cpu").init()
        for b in batches:
            net.fit(b)
        nets.append(net)
    for p, q in zip(nets[0].parameters(), nets[1].parameters()):
        assert torch.equal(p, q)
    assert "count" not in nets[0]._opt_state
    jnet, pnet = _pair(lambda pkg: _mlp(pkg, "adadelta"), False)
    jnet.conf.updater.learning_rate = 7.0
    jnet._tx = jnet.conf.updater.build()
    _fit_both(jnet, pnet, batches)
    _assert_matches(pnet, jnet)


def test_lamb_trust_ratio_is_per_leaf():
    """lamb's update of each leaf has the norm lr * ||p|| (the trust ratio
    scales Adam's update to the param's own norm), leaf by leaf."""
    tx = pt.UpdaterConfig(updater="lamb", learning_rate=0.1).build()
    rng = np.random.default_rng(17)
    params = [{"W": torch.tensor(rng.normal(size=(4, 3)).astype(np.float32)),
               "b": torch.tensor(rng.normal(size=(3,)).astype(np.float32) * 5)}]
    grads = [{k: torch.tensor(rng.normal(size=tuple(v.shape)).astype(np.float32))
              for k, v in params[0].items()}]
    updates, _ = tx.update(grads, tx.init(params), None, params)
    for k in ("W", "b"):
        np.testing.assert_allclose(float(torch.linalg.vector_norm(updates[0][k])),
                                   0.1 * float(torch.linalg.vector_norm(params[0][k])),
                                   rtol=1e-5)
    with pytest.raises(ValueError, match="needs the params"):
        tx.update(grads, tx.init(params))


def test_bf16_params_update_in_an_f32_island():
    """bf16 storage: each of the seven updates in f32 and casts back, as
    JAX's ``optimizer_update`` does (one bf16 rounding apart at most)."""
    rng = np.random.default_rng(18)
    p0 = rng.normal(size=(5, 4))
    g0 = rng.normal(size=(5, 4)) * 1e-2
    for name in SEVEN:
        cfg = {"updater": name, "learning_rate": 0.01}
        jtx = dj.UpdaterConfig.from_dict(cfg).build()
        ptx = pt.UpdaterConfig.from_dict(cfg).build()
        with jax.enable_x64(False):
            jp = [{"W": jnp.asarray(p0, jnp.bfloat16)}]
            _, jopt, jnew = dj.nn.updaters.optimizer_update(
                jtx, [{"W": jnp.asarray(g0, jnp.bfloat16)}], jtx.init(jp), jp)
        pp = [{"W": torch.tensor(p0).to(torch.bfloat16)}]
        _, popt, pnew = updaters.optimizer_update(
            ptx, [{"W": torch.tensor(g0).to(torch.bfloat16)}], ptx.init(pp), pp)
        assert pnew[0]["W"].dtype == torch.bfloat16
        assert all(t.dtype in (torch.bfloat16, torch.int32)
                   for t in updaters.opt_state_leaves(popt))
        np.testing.assert_allclose(pnew[0]["W"].float().numpy(),
                                   np.asarray(jnew[0]["W"], np.float32), atol=2 ** -7 * 4,
                                   err_msg=name)
