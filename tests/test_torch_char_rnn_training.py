"""The PyTorch port's char-RNN training against the JAX package.

The same JSON conf builds a net in each package, the JAX net's params go to
the port through ``load_jax_params``, and the same numpy batches go through
``fit`` of both. Each update's loss (from a listener on both nets) and the
final params are compared at 1e-5 (f32). The JAX side runs either its Pallas
kernels in interpret mode (``DL4J_TPU_PALLAS=seq`` with
``DL4JTPU_KERNELS=fused``) or its scan and reference paths
(``DL4J_TPU_PALLAS=0``, ``DL4JTPU_KERNELS=reference``); the port runs its
plain versions on the CPU. Tests marked ``cuda`` train on the card and skip
where there is none.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import deeplearning4j_tpu as dj  # noqa: E402
import deeplearning4j_tpu.ops as jax_ops  # noqa: E402
from deeplearning4j_tpu.datasets.iterators import (  # noqa: E402
    BucketingSequenceIterator as JaxBucketingIterator,
    DataSet as JaxDataSet,
)
from deeplearning4j_tpu.nn import updaters as jax_updaters  # noqa: E402
from deeplearning4j_tpu.ops import kernel_select  # noqa: E402

import deeplearning4j_tpu_torch as pt  # noqa: E402
from deeplearning4j_tpu_torch.nn import updaters  # noqa: E402
from deeplearning4j_tpu_torch.nn.layers.base import maybe_dropout  # noqa: E402
from deeplearning4j_tpu_torch.ops.adam import MAX_LEAVES  # noqa: E402

V, H, B, T, TBPTT = 11, 8, 3, 7, 3
ATOL = RTOL = 1e-5  # f32 on both sides; sums in another order
SGD = {"updater": "sgd", "learning_rate": 0.1}
JAX_PATHS = {"seq_fused": ("seq", "fused"), "scan_reference": ("0", "reference")}


@pytest.fixture(autouse=True, scope="module")
def _one_thread_module():
    """torch's intra-op threads capped at one for this module: its tensors
    are small, and under several test workers the threads only contend."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def jax_path(monkeypatch, tmp_path):
    """Select the JAX package's kernels by its own knobs; clear its cached
    selections around the test."""
    monkeypatch.setenv("DL4JTPU_KERNEL_CALIBRATION", str(tmp_path / "calibration.json"))

    def select(name):
        pallas, kernels = JAX_PATHS[name]
        monkeypatch.setenv("DL4J_TPU_PALLAS", pallas)
        monkeypatch.setenv("DL4JTPU_KERNELS", kernels)
        kernel_select.reset()

    yield select
    kernel_select.reset()


def _conf(mode="standard", updater=None, back=None, dtype="float32", **layer_kw):
    conf = pt.char_rnn(V, H, 2, tbptt_length=TBPTT, dtype=dtype)
    conf.updater = dict(updater or SGD)
    conf.backprop_type = mode
    if back is not None:
        conf.tbptt_back_length = back
    for layer in conf.layers:
        for k, v in layer_kw.items():
            setattr(layer, k, v)
    return conf


def _batches(n=3, seed=0, masks=False):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        seq = rng.integers(0, V, (B, T + 1))
        x = np.eye(V, dtype=np.float32)[seq[:, :-1]]
        y = np.eye(V, dtype=np.float32)[seq[:, 1:]]
        fm = lm = None
        if masks:
            lengths = rng.integers(2, T + 1, B)
            fm = (np.arange(T)[None, :] < lengths[:, None]).astype(np.float32)
            lm = fm.copy()
            lm[0, 0] = 0.0  # a label mask that differs from the features mask
        out.append((x, y, fm, lm))
    return out


class Recorder:
    """Listener on either package's net: each update's loss."""

    def __init__(self):
        self.losses = []

    def iteration_done(self, model, iteration, loss):
        self.losses.append(float(loss))


def _pair(conf, seed=3):
    """(JAX net, port net on the CPU): the same conf JSON, the JAX net's
    params (as f32) in both, a loss recorder on each."""
    jnet = dj.MultiLayerNetwork(dj.MultiLayerConfiguration.from_json(conf.to_json()))
    jnet.conf.seed = seed
    jnet.init()
    jnet.init(params=jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float32),
                                            jnet.params), force=True)
    pnet = pt.MultiLayerNetwork(conf, device="cpu")
    pt.load_jax_params(pnet, [{k: np.asarray(v) for k, v in p.items()}
                              for p in jnet.params])
    for net in (jnet, pnet):
        net.set_listeners(Recorder())
    return jnet, pnet


def _fit_both(jnet, pnet, batches):
    for x, y, fm, lm in batches:
        jnet.fit(JaxDataSet(x, y, fm, lm))
        pnet.fit(pt.DataSet(x, y, fm, lm))


def _assert_same_training(jnet, pnet, atol=ATOL, rtol=RTOL):
    jl, pl = jnet.listeners[0].losses, pnet.listeners[0].losses
    assert len(jl) == len(pl) == jnet.iteration == pnet.iteration
    np.testing.assert_allclose(pl, jl, atol=atol, rtol=rtol, err_msg="losses")
    for i, (jp, pp) in enumerate(zip(jnet.params, pt.params_to_numpy(pnet))):
        assert set(jp) == set(pp)
        for k in jp:
            np.testing.assert_allclose(pp[k], np.asarray(jp[k], np.float32), atol=atol,
                                       rtol=rtol, err_msg=f"layer {i} {k}")


# ------------------------------------------------------------ trajectories
MODES = {"standard": {"mode": "standard"}, "tbptt": {"mode": "tbptt"},
         "tbptt_short_back": {"mode": "tbptt", "back": 2}}


@pytest.mark.parametrize("path", sorted(JAX_PATHS))
@pytest.mark.parametrize("mode", sorted(MODES))
def test_fit_trajectory_matches_jax(mode, path, jax_path):
    jax_path(path)
    jnet, pnet = _pair(_conf(**MODES[mode]))
    _fit_both(jnet, pnet, _batches())
    updates = {"standard": 3, "tbptt": 9, "tbptt_short_back": 9}[mode]
    assert pnet.iteration == updates  # T=7 in segments of 3: 3, 3 and a tail of 1
    _assert_same_training(jnet, pnet)


@pytest.mark.parametrize("updater", [
    {"updater": "sgd", "learning_rate": 0.2},
    {"updater": "momentum", "learning_rate": 0.1, "momentum": 0.9},
    {"updater": "nesterovs", "learning_rate": 0.1, "momentum": 0.8},
    {"updater": "none"},
    {"updater": "noop"},
], ids=lambda u: u["updater"])
def test_updaters_match_jax(updater, jax_path):
    jax_path("scan_reference")
    jnet, pnet = _pair(_conf("tbptt", updater))
    _fit_both(jnet, pnet, _batches(2))
    _assert_same_training(jnet, pnet)


@pytest.mark.parametrize("policy", [
    {"lr_policy": "exponential", "lr_policy_decay_rate": 0.8},
    {"lr_policy": "inverse", "lr_policy_decay_rate": 0.5, "lr_policy_power": 0.75},
    {"lr_policy": "poly", "lr_policy_power": 2.0, "max_iterations": 6},
    {"lr_policy": "sigmoid", "lr_policy_gamma": 0.7, "lr_policy_steps": 2.0},
    {"lr_policy": "step", "lr_policy_decay_rate": 0.5, "lr_policy_steps": 2.0},
    {"lr_policy": "torch_step", "lr_policy_decay_rate": 0.3, "lr_policy_steps": 3.0},
    {"lr_policy": "schedule", "learning_rate_schedule": {"2": 0.05, "5": 0.01}},
], ids=lambda p: p["lr_policy"])
def test_schedules_match_jax(policy, jax_path):
    jax_path("scan_reference")
    jnet, pnet = _pair(_conf("tbptt", {"updater": "momentum", "learning_rate": 0.3,
                                       "momentum": 0.5, **policy}))
    _fit_both(jnet, pnet, _batches(1))
    assert pnet.iteration == 3
    _assert_same_training(jnet, pnet)


@pytest.mark.parametrize("norm", [
    "renormalizel2perlayer", "renormalizel2perparamtype", "clipelementwiseabsolutevalue",
    "clipl2perlayer", "clipl2perparamtype"])
def test_gradient_normalization_matches_jax(norm, jax_path):
    jax_path("scan_reference")
    jnet, pnet = _pair(_conf("standard", {
        "updater": "sgd", "learning_rate": 0.5, "gradient_normalization": norm,
        "gradient_normalization_threshold": 0.02}))
    _fit_both(jnet, pnet, _batches(2))
    _assert_same_training(jnet, pnet)


@pytest.mark.parametrize("reg", [{"l2": 0.01},
                                 {"l1": 0.005, "l2_bias": 0.02, "l1_bias": 0.01}],
                         ids=["l2", "l1_and_bias"])
def test_regularization_matches_jax(reg, jax_path):
    jax_path("seq_fused")
    jnet, pnet = _pair(_conf("standard", **reg))
    _fit_both(jnet, pnet, _batches(2))
    _assert_same_training(jnet, pnet)


def test_bidirectional_training_matches_jax(jax_path):
    """The reverse direction trains through the same Function on flipped
    input."""
    jax_path("seq_fused")
    conf = pt.MultiLayerConfiguration.from_json(dj.MultiLayerConfiguration(
        layers=[dj.GravesBidirectionalLSTM(n_in=V, n_out=H),
                dj.RnnOutputLayer(n_in=H, n_out=V, activation="softmax")],
        input_type=dj.InputType.recurrent(V),
        updater=dj.UpdaterConfig(updater="nesterovs", learning_rate=0.1)).to_json())
    jnet, pnet = _pair(conf)
    _fit_both(jnet, pnet, _batches(2))
    _assert_same_training(jnet, pnet)


@pytest.mark.parametrize("mode", ["standard", "tbptt"])
def test_masked_training_on_cpu_matches_jax(mode, jax_path):
    """Masked SGD training: the masked sequence op under grad (the JAX scan
    path here; its masked Pallas kernels in the bucketed Adam tests)."""
    jax_path("scan_reference")
    jnet, pnet = _pair(_conf(mode))
    _fit_both(jnet, pnet, _batches(2, seed=5, masks=True))
    _assert_same_training(jnet, pnet)


def _sequences(n=8, seed=20):
    """Next-char (features [L, V], labels [L, V]) pairs of lengths 2 to T+2."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        seq = rng.integers(0, V, int(rng.integers(3, T + 4)))
        out.append((np.eye(V, dtype=np.float32)[seq[:-1]],
                    np.eye(V, dtype=np.float32)[seq[1:]]))
    return out


BUCKETS = (4, T + 2)  # padded batches of T=4 and T=9, each with both masks


@pytest.fixture
def adam_calls(monkeypatch):
    """Counts the JAX package's calls of its fused Adam update (at trace
    time: the train step is jitted)."""
    calls = []
    real = jax_ops.fused_adam_update

    def spy(*args, **kwargs):
        calls.append(1)
        return real(*args, **kwargs)

    monkeypatch.setattr(jax_ops, "fused_adam_update", spy)
    return calls


@pytest.mark.parametrize("path", sorted(JAX_PATHS))
@pytest.mark.parametrize("mode", ["standard", "tbptt"])
def test_bucketed_adam_training_matches_jax(mode, path, jax_path, adam_calls):
    """The char-RNN's recipe: Adam over padded variable-length batches of
    the bucketing iterator (features and labels masks), two epochs. On the
    JAX side the fused path runs the masked sequence kernels (rows 8-9) and
    the fused Adam update (the spy sees it), the reference path the scan and
    optax.adam."""
    jax_path(path)
    seqs = _sequences()
    pit = pt.BucketingSequenceIterator(seqs, batch=B, boundaries=BUCKETS)
    jit = JaxBucketingIterator(seqs, batch=B, boundaries=BUCKETS)
    batches = list(pit)
    assert {ds.features.shape[1] for ds in batches} == set(BUCKETS)
    for mine, theirs in zip(batches, jit):
        for field in ("features", "labels", "features_mask", "labels_mask"):
            np.testing.assert_array_equal(getattr(mine, field), getattr(theirs, field))
    jnet, pnet = _pair(_conf(mode, {"updater": "adam", "learning_rate": 0.01}))
    jnet.fit(jit, epochs=2)
    pnet.fit(pit, epochs=2)
    assert pnet.epoch == 2
    _assert_same_training(jnet, pnet)
    assert bool(adam_calls) == (path == "seq_fused")


def test_evaluate_matches_jax(jax_path):
    """evaluate() over the padded batches: the same confusion matrix as the
    JAX package's Evaluation (padded steps counted too, no labels mask, as
    there)."""
    jax_path("scan_reference")
    seqs = _sequences(seed=21)
    jnet, pnet = _pair(_conf("tbptt", {"updater": "adam", "learning_rate": 0.05}))
    _fit_both(jnet, pnet, [(ds.features, ds.labels, ds.features_mask, ds.labels_mask)
                           for ds in pt.BucketingSequenceIterator(seqs, B, BUCKETS)])
    mine = pnet.evaluate(pt.BucketingSequenceIterator(seqs, B, BUCKETS), top_n=3)
    theirs = jnet.evaluate(JaxBucketingIterator(seqs, B, BUCKETS), top_n=3)
    assert isinstance(mine, pt.Evaluation)
    np.testing.assert_array_equal(mine.confusion.matrix, theirs.confusion.matrix)
    assert mine.examples == theirs.examples == sum(
        ds.features.shape[0] * ds.features.shape[1]
        for ds in pt.BucketingSequenceIterator(seqs, B, BUCKETS))
    for metric in ("accuracy", "top_n_accuracy", "precision", "recall", "f1"):
        assert getattr(mine, metric)() == pytest.approx(getattr(theirs, metric)(), abs=1e-12)
    assert mine.false_positive_rate(0) == pytest.approx(theirs.false_positive_rate(0))
    assert mine.stats() == theirs.stats()
    x, y, _, _ = _batches(1, seed=22)[0]
    ev = pnet.evaluate((x, y))
    assert ev.examples == B * T


def test_pad_to_bucket_matches_jax():
    from deeplearning4j_tpu.datasets.iterators import pad_to_bucket as jax_pad

    x = np.random.default_rng(0).normal(size=(2, 5, 3)).astype(np.float32)
    for got, want in zip(pt.pad_to_bucket(x, (4, 8, 16)), jax_pad(x, (4, 8, 16))):
        np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="exceeds"):
        pt.pad_to_bucket(x, (2, 4))


def test_bf16_compute_trains_close_to_jax(jax_path):
    """bf16 compute with f32 master params: the two packages round bf16 at
    other places, so the losses agree to bf16's precision, not f32's."""
    jax_path("seq_fused")
    jnet, pnet = _pair(_conf("standard", dtype="bfloat16"))
    _fit_both(jnet, pnet, _batches(2))
    np.testing.assert_allclose(pnet.listeners[0].losses, jnet.listeners[0].losses,
                               rtol=2e-2)
    for jp, pp in zip(jnet.params, pnet.layer_params):
        for k in jp:
            assert pp[k].dtype == torch.float32
            np.testing.assert_allclose(pp[k].detach().numpy(), np.asarray(jp[k]), atol=2e-3)


def test_score_matches_jax(jax_path):
    jax_path("scan_reference")
    jnet, pnet = _pair(_conf("standard", l2=0.01))
    x, y, _, _ = _batches(1, seed=8)[0]
    assert np.isnan(pnet.score())
    _fit_both(jnet, pnet, _batches(1))
    assert pnet.score() == pytest.approx(jnet.score(), rel=RTOL)
    np.testing.assert_allclose(pnet.score(pt.DataSet(x, y)), jnet.score(JaxDataSet(x, y)),
                               rtol=RTOL)


# ------------------------------------------------------------ entry points
def test_fit_inputs_and_counters():
    batches = [(x, y) for x, y, _, _ in _batches(2, seed=9)]
    net = pt.MultiLayerNetwork(_conf("tbptt"), device="cpu").init()
    net.fit(batches[0])  # an (x, y) pair
    assert (net.iteration, net.epoch) == (3, 1)
    net.fit(pt.DataSet(*batches[1]))
    assert (net.iteration, net.epoch) == (6, 2)
    net.fit(batches, epochs=2)  # a list of pairs, twice
    assert (net.iteration, net.epoch) == (18, 4)

    class Resettable:
        def __init__(self):
            self.resets = 0

        def reset(self):
            self.resets += 1

        def __iter__(self):
            return iter([pt.DataSet(*batches[0])])

    it = Resettable()
    net.fit(it, epochs=3)
    assert it.resets == 3 and net.iteration == 27
    assert np.isfinite(net.score())


def test_output_after_fit_serves_the_trained_params():
    """The compute-dtype params are cast again after every update (a stale
    cast would serve the params of init)."""
    x, y, _, _ = _batches(1, seed=10)[0]
    for dtype in ("float32", "bfloat16"):
        net = pt.MultiLayerNetwork(_conf("standard", dtype=dtype), device="cpu").init()
        before = net.output(x)
        net.fit((x, y))
        after = net.output(x)
        assert np.abs(after - before).max() > 1e-4
        fresh = pt.MultiLayerNetwork(_conf("standard", dtype=dtype), device="cpu")
        fresh.init(params=pt.params_to_numpy(net))
        np.testing.assert_array_equal(fresh.output(x), after)


def test_inference_keeps_the_lean_primal():
    """output/predict/rnn_time_step run under no_grad: no autograd graph and
    no residuals, even though the params are trainable leaves."""
    net = pt.MultiLayerNetwork(_conf(), device="cpu").init()
    assert all(p.requires_grad for p in net.parameters())
    x, _, _, _ = _batches(1)[0]
    assert net.forward(x).grad_fn is None
    net.rnn_time_step(x[:, 0])
    assert all(t.grad_fn is None for st in net._rnn_state for t in st.values())


def test_adam_fits_and_later_updaters_raise():
    """The char-RNN's own updater, Adam, trains; the optax updaters that
    came later (adamw, rmsprop, adagrad among them) build and follow JAX's
    ``build()`` over two updates (f32, x64 off, 1e-6 relative); an unknown
    name still raises."""
    x, y, _, _ = _batches(1)[0]
    net = pt.MultiLayerNetwork(pt.char_rnn(V, H), device="cpu").init()  # the adam default
    before = pt.params_to_numpy(net)
    net.fit((x, y))
    assert net.iteration == -(-T // 50) and np.isfinite(net.score())
    after = pt.params_to_numpy(net)
    # the first Adam step moves a param by at most lr (1e-3), plus the f32
    # rounding of the param itself
    step = max(float(np.abs(a[k] - b[k]).max()) for a, b in zip(after, before) for k in a)
    assert 5e-4 < step <= 1.001e-3
    rng = np.random.default_rng(3)
    params = [{"W": rng.normal(size=(5, 4)).astype(np.float32)}]
    grads = [[{"W": rng.normal(size=(5, 4)).astype(np.float32)}] for _ in range(2)]
    for name in ("adamw", "rmsprop", "adagrad"):
        cfg = {"updater": name, "learning_rate": 0.01}
        jtx = jax_updaters.UpdaterConfig.from_dict(cfg).build()
        ptx = pt.UpdaterConfig.from_dict(cfg).build()
        with jax.enable_x64(False):
            jp = [{"W": jnp.asarray(params[0]["W"])}]
            jopt = jtx.init(jp)
            for g in grads:
                _, jopt, jp = jax_updaters.optimizer_update(
                    jtx, [{"W": jnp.asarray(g[0]["W"])}], jopt, jp)
        pp = [{"W": torch.tensor(params[0]["W"])}]
        popt = ptx.init(pp)
        for g in grads:
            _, popt, pp = updaters.optimizer_update(ptx, [{"W": torch.tensor(g[0]["W"])}],
                                                    popt, pp)
        np.testing.assert_allclose(pp[0]["W"].numpy(), np.asarray(jp[0]["W"]), rtol=1e-6)
    with pytest.raises(ValueError, match="Unknown updater"):
        pt.UpdaterConfig(updater="bogus").build()


def test_updater_config_json_matches_jax():
    jcfg = jax_updaters.UpdaterConfig(updater="nesterovs", learning_rate=0.3,
                                      lr_policy="schedule",
                                      learning_rate_schedule={2: 0.1})
    pcfg = pt.UpdaterConfig.from_dict(jcfg.to_dict())
    assert pcfg.to_dict() == jcfg.to_dict()
    conf = _conf(updater=jcfg.to_dict())
    assert dj.MultiLayerConfiguration.from_json(conf.to_json()).updater == jcfg


def test_regularization_key_rule_matches_jax():
    """Every key that starts with "b" takes the bias coefficients, the
    bidirectional layer's bwd_W and bwd_RW included (the JAX rule as it is)."""
    jlayer = dj.GravesBidirectionalLSTM(n_in=V, n_out=H, l1=0.1, l2=0.2, l1_bias=0.03,
                                        l2_bias=0.05)
    player = pt.MultiLayerConfiguration.from_json(dj.MultiLayerConfiguration(
        layers=[jlayer], input_type=dj.InputType.recurrent(V)).to_json()).layers[0]
    params = {k: np.asarray(v, np.float64) + 0.3 for k, v in
              jlayer.init_params(jax.random.PRNGKey(0), dj.InputType.recurrent(V)).items()}
    want = jlayer.regularization_loss({k: jnp.asarray(v) for k, v in params.items()})
    got = player.regularization_loss({k: torch.from_numpy(v) for k, v in params.items()})
    assert float(got) == pytest.approx(float(want), rel=1e-12)
    only_bwd = player.regularization_loss({"bwd_W": torch.ones(2, 2)})
    assert float(only_bwd) == pytest.approx(0.5 * 0.05 * 4 + 0.03 * 4)


def test_optimizer_update_runs_bf16_in_an_f32_island():
    rng = np.random.default_rng(11)
    params = [{"W": rng.normal(size=(5, 4))}]
    grads = [{"W": rng.normal(size=(5, 4)) * 1e-3}]
    cfg = {"updater": "momentum", "learning_rate": 0.01, "momentum": 0.9}
    jtx = jax_updaters.UpdaterConfig.from_dict(cfg).build()
    jp = [{"W": jnp.asarray(params[0]["W"], jnp.bfloat16)}]
    jg = [{"W": jnp.asarray(grads[0]["W"], jnp.bfloat16)}]
    _, jopt, jnew = jax_updaters.optimizer_update(jtx, jg, jtx.init(jp), jp)
    ptx = pt.UpdaterConfig.from_dict(cfg).build()
    pp = [{"W": torch.tensor(params[0]["W"]).to(torch.bfloat16)}]
    pg = [{"W": torch.tensor(grads[0]["W"]).to(torch.bfloat16)}]
    _, popt, pnew = updaters.optimizer_update(ptx, pg, ptx.init(pp), pp)
    assert pnew[0]["W"].dtype == torch.bfloat16
    assert popt["trace"][0]["W"].dtype == torch.bfloat16
    np.testing.assert_array_equal(pnew[0]["W"].float().numpy(),
                                  np.asarray(jnew[0]["W"], np.float32))
    np.testing.assert_array_equal(popt["trace"][0]["W"].float().numpy(),
                                  np.asarray(jopt[1][0].trace[0]["W"], np.float32))


def test_loss_scaling_matches_jax():
    g = [{"W": torch.tensor([[1.5, -3.0]], dtype=torch.bfloat16)}]
    out = updaters.unscale_grads(g, 4096.0)
    want = jax_updaters.unscale_grads(
        [{"W": jnp.asarray([[1.5, -3.0]], jnp.bfloat16)}], 4096.0)
    assert out[0]["W"].dtype == torch.float32
    np.testing.assert_array_equal(out[0]["W"].numpy(), np.asarray(want[0]["W"]))
    assert updaters.unscale_grads(g, None) is g
    loss = torch.tensor(2.0)
    assert float(updaters.unscale_loss(updaters.scaled_loss(loss, 8.0), 8.0)) == 2.0


def test_loss_scale_leaves_the_f32_trajectory_unchanged():
    """A power-of-two loss scale shifts exponents only: the same updates."""
    batches = _batches(2, seed=12)
    nets = []
    for scale in (None, 1024.0):
        conf = _conf("standard")
        conf.loss_scale = scale
        net = pt.MultiLayerNetwork(conf, device="cpu").init()
        for x, y, _, _ in batches:
            net.fit((x, y))
        nets.append(pt.params_to_numpy(net))
    for a, b in zip(*nets):
        for k in a:
            np.testing.assert_allclose(a[k], b[k], rtol=1e-6, atol=1e-7)


def test_dropout_draws_from_the_generator_in_training_only():
    x = torch.ones(2000)
    gen = torch.Generator().manual_seed(0)
    assert maybe_dropout(x, 0.25, train=False, generator=gen) is x
    assert maybe_dropout(x, 0.0, train=True, generator=gen) is x
    y = maybe_dropout(x, 0.25, train=True, generator=gen)
    kept = y != 0
    assert 0.7 < float(kept.float().mean()) < 0.8
    torch.testing.assert_close(y[kept], torch.full_like(y[kept], 1 / 0.75))
    again = maybe_dropout(x, 0.25, train=True, generator=torch.Generator().manual_seed(0))
    torch.testing.assert_close(again, y)


def test_dropout_nets_train_and_serve_deterministically():
    x, y, _, _ = _batches(1, seed=13)[0]
    outs = []
    for _ in range(2):
        net = pt.MultiLayerNetwork(_conf("standard", dropout=0.3), device="cpu").init()
        net.fit((x, y))
        outs.append(net.output(x))
        assert np.array_equal(net.output(x), outs[-1])  # no dropout at inference
    np.testing.assert_array_equal(*outs)  # the generator is seeded by conf.seed


# ------------------------------------------------------------------- card
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["standard", "tbptt"])
def test_cuda_fit_launches_the_kernels_and_matches_cpu(cuda_device, mode):
    batches = _batches(2, seed=14)
    host = pt.params_to_numpy(pt.MultiLayerNetwork(_conf(mode), device="cpu").init())
    nets = {}
    for dev in ("cpu", cuda_device):
        net = pt.MultiLayerNetwork(_conf(mode), device=dev).init(params=host)
        net.set_listeners(Recorder())
        before = pt.ops.counters()
        for x, y, _, _ in batches:
            net.fit((x, y))
        nets[str(dev)] = (net, {k: v - before[k] for k, v in pt.ops.counters().items()})
    (cpu, _), (gpu, launched) = nets["cpu"], nets[str(cuda_device)]
    u = gpu.iteration
    assert launched == {"lstm_seq_lean": 0, "lstm_seq_lean_masked": 0,
                        "lstm_seq_train_fwd": 2 * u, "lstm_seq_bwd": 2 * u,
                        "softmax_xent_fwd": u, "softmax_xent_bwd": u}
    np.testing.assert_allclose(gpu.listeners[0].losses, cpu.listeners[0].losses, rtol=1e-4)
    for a, b in zip(pt.params_to_numpy(gpu), pt.params_to_numpy(cpu)):
        for k in a:
            np.testing.assert_allclose(a[k], b[k], atol=1e-4)


@pytest.mark.cuda
def test_cuda_adam_launches_the_kernel(cuda_device):
    """The default char-RNN trains with Adam on the card: one Adam launch per
    update (every leaf in one multi-tensor launch), and the card's steps
    match the CPU's."""
    batches = _batches(2, seed=15)
    host = pt.params_to_numpy(pt.MultiLayerNetwork(pt.char_rnn(V, H), device="cpu").init())
    nets = {}
    for dev in ("cpu", cuda_device):
        net = pt.MultiLayerNetwork(pt.char_rnn(V, H), device=dev).init(params=host)
        net.set_listeners(Recorder())
        before = pt.ops.counters()["adam_update"]
        for x, y, _, _ in batches:
            net.fit((x, y))
        nets[str(dev)] = (net, pt.ops.counters()["adam_update"] - before)
    (cpu, _), (gpu, adam_launches) = nets["cpu"], nets[str(cuda_device)]
    leaves = sum(len(p) for p in gpu.layer_params)
    assert adam_launches == gpu.iteration * -(-leaves // MAX_LEAVES)
    np.testing.assert_allclose(gpu.listeners[0].losses, cpu.listeners[0].losses, rtol=1e-4)
