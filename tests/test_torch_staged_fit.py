"""The PyTorch port's staged training loop against the JAX package
(``tests/test_fit_on_device.py`` for the port, without its three
``ParallelWrapper`` tests).

The same conf JSON, the JAX net's params (``load_jax_params``) and numpy
batches from a seed go into both packages' ``fit_on_device`` and staged
``fit``; the JAX side runs with x64 off and f32 params and state, as
``tests/test_torch_lenet_mlp.py`` explains. Losses, params, layer state and
the updater's leaves (counts included) are held at 1e-5 absolute and
relative: both sides round in f32 and sum in other orders, over a few
updates of small nets. On the CPU the port's staged loop runs the same
step as its per-batch ``fit`` through the scalar table and the in-place
update, so the two are held bit for bit (dropout and BatchNormalization
included). Dropout draws differ between the packages, so dropout is held
within the port only. The step-scalar table is held bit for bit against
``schedule`` and ``bias_corrections`` for every schedule kind, and the
device-scalar Adam's plain version against ``adam_update_reference``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import deeplearning4j_tpu as dj  # noqa: E402
from deeplearning4j_tpu.runtime import inference as jax_inference  # noqa: E402
from deeplearning4j_tpu.datasets import iterators as jit_  # noqa: E402
from deeplearning4j_tpu.models import resnet as jres  # noqa: E402
from deeplearning4j_tpu.ops import kernel_select  # noqa: E402

import deeplearning4j_tpu_torch as pt  # noqa: E402
from deeplearning4j_tpu_torch.datasets import ListDataSetIterator  # noqa: E402
from deeplearning4j_tpu_torch.nn import updaters  # noqa: E402
from deeplearning4j_tpu_torch.ops import adam  # noqa: E402

ATOL = RTOL = 1e-5
LR = 1e-2

# updater settings held against JAX: each kind, a schedule, a normalization
UPDATERS = {
    "sgd": {"updater": "sgd"},
    "momentum": {"updater": "momentum", "momentum": 0.9},
    "nesterovs": {"updater": "nesterovs", "momentum": 0.9},
    "adam": {"updater": "adam"},
    "adam_inverse_schedule": {"updater": "adam", "lr_policy": "inverse",
                              "lr_policy_decay_rate": 0.3, "lr_policy_power": 0.75},
    "sgd_step_schedule": {"updater": "sgd", "lr_policy": "step",
                          "lr_policy_decay_rate": 0.5, "lr_policy_steps": 2},
    "adam_clip_l2_per_layer": {"updater": "adam", "gradient_normalization": "clipl2perlayer",
                               "gradient_normalization_threshold": 0.05},
    "nesterovs_renorm_per_param": {"updater": "nesterovs",
                                   "gradient_normalization": "renormalizel2perparamtype"},
}


@pytest.fixture(autouse=True)
def jax_env(monkeypatch, tmp_path):
    monkeypatch.setattr(jax_inference, "fast_path_enabled", lambda: False)
    monkeypatch.setenv("DL4JTPU_KERNEL_CALIBRATION", str(tmp_path / "calibration.json"))
    kernel_select.reset()
    yield
    kernel_select.reset()


def _f32(tree):
    return jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float32), tree)


def _updater(pkg, name="adam"):
    u = pkg.UpdaterConfig(learning_rate=LR, **UPDATERS[name])
    return u if pkg is dj else u.to_dict()


def _mlp_conf(pkg, updater="adam", dropout=0.0, seed=7, bn=False):
    layers = [pkg.DenseLayer(n_out=16, activation="relu", dropout=dropout)]
    if bn:
        layers.append(pkg.BatchNormalization())
    layers.append(pkg.OutputLayer(n_out=3, activation="softmax", loss="mcxent"))
    return pkg.MultiLayerConfiguration(layers=layers, input_type=pkg.InputType.feed_forward(5),
                                       updater=_updater(pkg, updater), seed=seed)


def _lstm_conf(pkg, seed=11):
    """Two GravesLSTM layers of 16 units and a per-step softmax head."""
    return pkg.MultiLayerConfiguration(
        layers=[pkg.GravesLSTM(n_out=16), pkg.GravesLSTM(n_out=16),
                pkg.RnnOutputLayer(n_out=3, activation="softmax", loss="mcxent")],
        input_type=pkg.InputType.recurrent(4), updater=_updater(pkg), seed=seed)


def _graph_conf(pkg, seed=9, two_heads=False):
    b = (pkg.ComputationGraphConfiguration.builder().seed(seed)
         .updater(_updater(pkg)).add_inputs("in")
         .add_layer("h", pkg.DenseLayer(n_out=12, activation="tanh"), "in"))
    if two_heads:
        b = (b.add_layer("out0", pkg.OutputLayer(n_out=3, activation="softmax", loss="mcxent"),
                         "h")
             .add_layer("out1", pkg.OutputLayer(n_out=2, activation="softmax", loss="mcxent"),
                        "h")
             .set_outputs("out0", "out1"))
    else:
        b = (b.add_layer("out", pkg.OutputLayer(n_out=3, activation="softmax", loss="mcxent"),
                         "h")
             .set_outputs("out"))
    return b.set_input_types(pkg.InputType.feed_forward(5)).build()


def _mln_pair(make):
    jnet = dj.MultiLayerNetwork(make(dj)).init()
    jnet.init(params=_f32(jnet.params), force=True)
    jnet.state = _f32(jnet.state)
    pconf = make(pt)
    assert pconf.to_json() == jnet.conf.to_json()
    return jnet, pt.load_jax_params(pt.MultiLayerNetwork(pconf, device="cpu"), jnet.params,
                                    state=jnet.state)


def _graph_pair(make):
    jnet = dj.ComputationGraph(make(dj)).init()
    jnet.init(params=_f32(jnet.params), force=True)
    jnet.state = _f32(jnet.state)
    pconf = make(pt)
    assert pconf.to_json() == jnet.conf.to_json()
    host = {n: {k: np.asarray(v, np.float32) for k, v in p.items()}
            for n, p in jnet.params.items()}
    return jnet, pt.load_jax_params(pt.ComputationGraph(pconf, device="cpu"), host,
                                    state=jnet.state)


def _port_twin(make, graph=False):
    """Two port nets with the same params: one for the staged loop, one for
    the per-batch path."""
    cls = pt.ComputationGraph if graph else pt.MultiLayerNetwork
    a = cls(make(pt), device="cpu").init()
    b = cls(make(pt), device="cpu").init()
    b.init(params=pt.params_to_numpy(a))
    return a, b


def _batches(k, b=8, f=5, c=3, seed=0):
    rng = np.random.default_rng(seed)
    xs = rng.normal(size=(k, b, f)).astype(np.float32)
    ys = np.eye(c, dtype=np.float32)[rng.integers(0, c, size=(k, b))]
    return xs, ys


def _close(got, want, what=""):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               atol=ATOL, rtol=RTOL, err_msg=what)


def _assert_matches_jax(pnet, jnet, losses=None, jlosses=None):
    """Losses, every param, the layer state and the updater's leaves (counts
    too) at 1e-5."""
    if losses is not None:
        _close(losses, jlosses, "losses")
    jp = jax.tree_util.tree_leaves(jnet.params)
    pp = [layer[k] for layer in pnet._leaves() for k in sorted(layer)]
    assert len(jp) == len(pp)
    for i, (j, p) in enumerate(zip(jp, pp)):
        _close(p.detach(), j, f"param leaf {i}")
    js = jax.tree_util.tree_leaves(jnet.state)
    ps = pnet.state_leaves()
    assert len(js) == len(ps)
    for i, (j, p) in enumerate(zip(js, ps)):
        _close(p, j, f"state leaf {i}")
    jo = jax.tree_util.tree_leaves(jnet.opt_state)
    po = pnet.updater_state_leaves()
    assert len(jo) == len(po)
    for i, (j, p) in enumerate(zip(jo, po)):
        if np.asarray(j).dtype.kind in "iu":
            assert int(p) == int(j), f"updater count leaf {i}"
        else:
            _close(p, j, f"updater leaf {i}")


def _assert_same(a, b):
    """Bit for bit: params, layer state, updater leaves, iteration."""
    for p, q in zip(a.parameters(), b.parameters()):
        assert torch.equal(p, q)
    for p, q in zip(a.state_leaves(), b.state_leaves()):
        assert torch.equal(p, q)
    pa, pb = a.updater_state_leaves(), b.updater_state_leaves()
    assert len(pa) == len(pb)
    for p, q in zip(pa, pb):
        assert torch.equal(torch.as_tensor(p), torch.as_tensor(q))
    assert a.iteration == b.iteration


# ------------------------------------------------------------ against JAX
@pytest.mark.parametrize("steps", [2, 5])
def test_mln_fit_on_device_matches_jax(steps):
    xs, ys = _batches(k=2)
    with jax.enable_x64(False):
        jnet, pnet = _mln_pair(_mlp_conf)
        jlosses = jnet.fit_on_device(xs, ys, steps=steps)
        losses = pnet.fit_on_device(xs, ys, steps=steps)
    assert losses.shape == (steps,)
    assert pnet.iteration == jnet.iteration == steps
    assert pnet.staged_steps_total == steps and pnet.last_batch_size == 8
    _assert_matches_jax(pnet, jnet, losses, jlosses)


@pytest.mark.parametrize("updater", sorted(UPDATERS))
def test_mln_fit_on_device_matches_jax_per_updater(updater):
    """Every updater kind, a schedule across the window and gradient
    normalization: 6 steps cycling over 3 staged batches."""
    xs, ys = _batches(k=3, seed=2)
    with jax.enable_x64(False):
        jnet, pnet = _mln_pair(lambda pkg: _mlp_conf(pkg, updater))
        jlosses = jnet.fit_on_device(xs, ys, steps=6)
        losses = pnet.fit_on_device(xs, ys, steps=6)
    _assert_matches_jax(pnet, jnet, losses, jlosses)


def test_mln_real_batches_and_cycling_match_jax():
    """4 staged slots of which 3 are real: 7 steps cycle over the real ones
    (the dummy slot holds garbage that must never train), then a second
    window continues the counts."""
    xs, ys = _batches(k=4, seed=3)
    xs[3] = 1e6
    with jax.enable_x64(False):
        jnet, pnet = _mln_pair(_mlp_conf)
        jl = [jnet.fit_on_device(xs, ys, steps=7, real_batches=3),
              jnet.fit_on_device(xs[:2], ys[:2])]
        pl = [pnet.fit_on_device(xs, ys, steps=7, real_batches=3),
              pnet.fit_on_device(xs[:2], ys[:2])]
    assert [len(x) for x in pl] == [7, 2]
    assert pnet.iteration == 9
    _assert_matches_jax(pnet, jnet, np.concatenate(pl), np.concatenate(jl))


def test_mln_masked_sequences_match_jax():
    """Two LSTM layers (H=16) on masked sequences, masks on features and
    labels."""
    rng = np.random.default_rng(3)
    k, b, t, f, c = 2, 4, 6, 4, 3
    xs = rng.normal(size=(k, b, t, f)).astype(np.float32)
    ys = np.eye(c, dtype=np.float32)[rng.integers(0, c, size=(k, b, t))]
    fmask = (rng.random((k, b, t)) > 0.3).astype(np.float32)
    fmask[:, :, 0] = 1.0
    with jax.enable_x64(False):
        jnet, pnet = _mln_pair(_lstm_conf)
        jlosses = jnet.fit_on_device(xs, ys, steps=3, features_masks=fmask,
                                     labels_masks=fmask)
        losses = pnet.fit_on_device(xs, ys, steps=3, features_masks=fmask,
                                    labels_masks=fmask)
    _assert_matches_jax(pnet, jnet, losses, jlosses)


def test_graph_fit_on_device_matches_jax():
    xs, ys = _batches(k=2, seed=5)
    with jax.enable_x64(False):
        jnet, pnet = _graph_pair(_graph_conf)
        jlosses = jnet.fit_on_device(xs, ys, steps=4)
        losses = pnet.fit_on_device(xs, ys, steps=4)
    assert losses.shape == (4,)
    _assert_matches_jax(pnet, jnet, losses, jlosses)


def test_graph_resnet_with_batchnorm_matches_jax():
    """``resnet_conf([1, 1])`` at 32x32 (BatchNormalization's running stats
    written by every step), SGD at the conf's lr 0.1: 3 steps on one batch
    of 4 images, as ``tests/test_torch_resnet.py`` trains it (alternating
    two random batches at that lr diverges, and the rounding with it), from
    a window of 2 slots whose second is a dummy."""
    rng = np.random.default_rng(6)
    xs = rng.normal(size=(2, 4, 32, 32, 3)).astype(np.float32)
    xs[1] = 1e6
    ys = np.eye(10, dtype=np.float32)[rng.integers(0, 10, size=(2, 4))]

    def make(pkg):
        mod = jres if pkg is dj else pt
        return mod.resnet_conf([1, 1], image_size=(32, 32), num_classes=10)

    with jax.enable_x64(False):
        jnet, pnet = _graph_pair(make)
        jlosses = jnet.fit_on_device(xs, ys, steps=3, real_batches=1)
        losses = pnet.fit_on_device(xs, ys, steps=3, real_batches=1)
    _assert_matches_jax(pnet, jnet, losses, jlosses)


def _ragged(n_full=7, b=8, tail=4, seed=8):
    rng = np.random.default_rng(seed)

    def mk(rows):
        return (rng.normal(size=(rows, 5)).astype(np.float32),
                np.eye(3, dtype=np.float32)[rng.integers(0, 3, rows)])

    batches = [mk(b) for _ in range(n_full)]
    batches.insert(4, mk(tail))  # a shape change mid-stream
    return batches


@pytest.mark.parametrize("bucketing", [True, False])
def test_mln_staged_fit_matches_jax_and_plain_fit(bucketing):
    """``fit(stage_on_device=3)`` over 8 batches (one of 4 rows) for two
    epochs: against JAX's staged fit at 1e-5, and bit for bit against the
    port's own plain ``fit``."""
    batches = _ragged()
    with jax.enable_x64(False):
        jnet, pnet = _mln_pair(lambda pkg: _mlp_conf(pkg, seed=41))
        start = pt.params_to_numpy(pnet)
        jnet.fit(jit_.ListDataSetIterator([jit_.DataSet(x, y) for x, y in batches]),
                 epochs=2, stage_on_device=3, bucketing=bucketing)
        pnet.fit(ListDataSetIterator([pt.DataSet(x, y) for x, y in batches]), epochs=2,
                 stage_on_device=3, bucketing=bucketing)
    assert pnet.iteration == jnet.iteration == 16
    assert pnet.staged_steps_total == jnet.staged_steps_total == (16 if bucketing else 12)
    _assert_matches_jax(pnet, jnet)
    plain = pt.MultiLayerNetwork(_mlp_conf(pt, seed=41), device="cpu").init(params=start)
    plain.fit(ListDataSetIterator([pt.DataSet(x, y) for x, y in batches]), epochs=2)
    if bucketing:  # the 4-row batch trains padded to 8 rows, with a mask
        for p, q in zip(plain.parameters(), pnet.parameters()):
            torch.testing.assert_close(p, q, atol=ATOL, rtol=RTOL)
    else:
        _assert_same(plain, pnet)


def test_graph_staged_fit_matches_jax_and_plain_fit():
    batches = _ragged(n_full=5, tail=8, seed=9)[:5]
    with jax.enable_x64(False):
        jnet, pnet = _graph_pair(lambda pkg: _graph_conf(pkg, seed=43))
        jnet.fit(jit_.ListDataSetIterator([jit_.DataSet(x, y) for x, y in batches]),
                 epochs=2, stage_on_device=2)
        pnet.fit(ListDataSetIterator([pt.DataSet(x, y) for x, y in batches]), epochs=2,
                 stage_on_device=2)
    assert pnet.iteration == jnet.iteration == 10
    assert pnet.staged_steps_total == 10
    _assert_matches_jax(pnet, jnet)
    staged, plain = _port_twin(lambda pkg: _graph_conf(pkg, seed=43), graph=True)
    staged.fit(ListDataSetIterator([pt.DataSet(x, y) for x, y in batches]), epochs=2,
               stage_on_device=2)
    plain.fit(ListDataSetIterator([pt.DataSet(x, y) for x, y in batches]), epochs=2)
    _assert_same(staged, plain)


# ------------------------------------------------- the port against itself
@pytest.mark.parametrize("updater", ["sgd", "nesterovs", "adam", "adam_inverse_schedule"])
@pytest.mark.parametrize("dropout,bn", [(0.0, False), (0.5, False), (0.0, True), (0.5, True)])
def test_cpu_staged_loop_is_the_per_batch_fit_bit_for_bit(updater, dropout, bn):
    """The plain version of the capture: the same step through the scalar
    table and the in-place update, dropout drawn from the same generator,
    BatchNormalization's running stats written in place."""
    xs, ys = _batches(k=3, seed=1)
    staged, plain = _port_twin(lambda pkg: _mlp_conf(pkg, updater, dropout=dropout, bn=bn))
    losses = staged.fit_on_device(xs, ys, steps=5)
    want = []
    for i in range(5):
        plain.fit((xs[i % 3], ys[i % 3]))
        want.append(float(plain.score()))
    np.testing.assert_array_equal(losses, np.float32(want))
    _assert_same(staged, plain)


def test_warmup_then_fit_on_device_equals_fit_on_device_alone():
    """``warmup`` trains nothing (params, state, updater, generator and
    iteration as before), and a window after it is the window alone's."""
    xs, ys = _batches(k=3, seed=4)
    make = lambda pkg: _mlp_conf(pkg, dropout=0.5, bn=True)  # noqa: E731
    warm, alone = _port_twin(make)
    before = [p.detach().clone() for p in warm.parameters()]
    gen = warm._generator.get_state()
    assert warm.warmup(xs, ys, steps=4) is warm
    assert warm.iteration == 0
    assert all(torch.equal(p, q) for p, q in zip(before, warm.parameters()))
    assert torch.equal(gen, warm._generator.get_state())
    np.testing.assert_array_equal(warm.fit_on_device(xs, ys, steps=4),
                                  alone.fit_on_device(xs, ys, steps=4))
    _assert_same(warm, alone)


def test_warmup_takes_meta_tensors():
    net = pt.MultiLayerNetwork(_mlp_conf(pt), device="cpu").init()
    net.warmup(torch.empty(2, 8, 5, device="meta"), torch.empty(2, 8, 3, device="meta"))
    assert len(net._step_graphs) == 1 and net.iteration == 0


def test_per_batch_updates_between_windows_carry_over():
    """Windows, per-batch updates and a setter between them: the staged
    loop's tensors take the state each time."""
    xs, ys = _batches(k=2, seed=12)
    a, b = _port_twin(lambda pkg: _mlp_conf(pkg, bn=True))
    a.fit_on_device(xs, ys, steps=2)
    a.fit((xs[0], ys[0]))
    a.set_updater_state_leaves([t.clone() for t in a.updater_state_leaves()])
    a.fit_on_device(xs, ys, steps=3)
    for i in (0, 1):
        b.fit((xs[i], ys[i]))
    b.fit((xs[0], ys[0]))
    for i in range(3):
        b.fit((xs[i % 2], ys[i % 2]))
    _assert_same(a, b)
    assert len(a._step_graphs) == 1


def test_mln_dropout_masks_differ_between_steps():
    """Dropout draws anew at each step of a window (the generator moves on),
    as the per-batch path's."""
    xs, ys = _batches(k=1, seed=2)
    xs = np.repeat(xs, 3, axis=0)
    ys = np.repeat(ys, 3, axis=0)
    net = pt.MultiLayerNetwork(_mlp_conf(pt, updater="sgd", dropout=0.5), device="cpu").init()
    net.conf.updater["learning_rate"] = 0.0
    losses = net.fit_on_device(xs, ys, steps=3)
    assert len(set(losses.tolist())) == 3


def test_mln_listener_sees_every_step():
    xs, ys = _batches(k=1)
    net = pt.MultiLayerNetwork(_mlp_conf(pt), device="cpu").init()
    seen = []

    class L:
        def iteration_done(self, model, iteration, score):
            seen.append((iteration, float(score), model.staged_step_time))

    net.set_listeners(L())
    losses = net.fit_on_device(xs, ys, steps=3)
    assert [i for i, _, _ in seen] == [1, 2, 3]
    np.testing.assert_array_equal([s for _, s, _ in seen], losses)
    assert all(t is not None and t >= 0 for _, _, t in seen)
    assert net.staged_step_time is None
    assert float(net.score()) == float(losses[-1])


def test_fit_stage_on_device_listener_contract():
    """Listeners that opt in with ``supports_staged`` see every step of a
    staged fit, and the epoch hooks; a listener without it turns staging
    off, and sees the params move at every step."""
    xs, ys = _batches(k=4)
    data = [pt.DataSet(xs[i], ys[i]) for i in range(4)]

    class Collect:
        supports_staged = True

        def __init__(self):
            self.events = []

        def iteration_done(self, model, iteration, score):
            self.events.append(("it", iteration))

        def on_epoch_start(self, model, epoch):
            self.events.append(("start", epoch))

        def on_epoch_end(self, model, epoch):
            self.events.append(("end", epoch))

    net = pt.MultiLayerNetwork(_mlp_conf(pt), device="cpu").init()
    collect = Collect()
    net.set_listeners(collect)
    net.fit(ListDataSetIterator(list(data)), stage_on_device=2)
    assert collect.events == [("start", 0), ("it", 1), ("it", 2), ("it", 3), ("it", 4),
                              ("end", 1)]
    assert net.staged_steps_total == 4

    snapshots = []

    class ParamReader:
        def iteration_done(self, model, iteration, score):
            snapshots.append(float(next(model.parameters()).detach().sum()))

    net2 = pt.MultiLayerNetwork(_mlp_conf(pt), device="cpu").init()
    net2.set_listeners(ParamReader())
    net2.fit(ListDataSetIterator(list(data)), stage_on_device=2)
    assert len(snapshots) == 4 and len(set(snapshots)) == 4
    assert net2.staged_steps_total == 0


def test_tbptt_rejected_and_not_staged():
    conf = _mlp_conf(pt)
    conf.backprop_type = "tbptt"
    net = pt.MultiLayerNetwork(conf, device="cpu").init()
    xs, ys = _batches(k=1)
    with pytest.raises(ValueError, match="TBPTT"):
        net.fit_on_device(xs, ys)
    with pytest.raises(ValueError, match="TBPTT"):
        net.warmup(xs, ys)
    net.fit(ListDataSetIterator([pt.DataSet(xs[0], ys[0])]), stage_on_device=2)
    assert net.staged_steps_total == 0 and net.iteration == 1


def test_mln_staged_count_mismatch_names_the_array():
    net = pt.MultiLayerNetwork(_lstm_conf(pt), device="cpu").init()
    rng = np.random.default_rng(0)
    xs = rng.normal(size=(2, 3, 5, 4)).astype(np.float32)
    ys = np.zeros((2, 3, 5, 3), np.float32)
    with pytest.raises(ValueError, match=r"ys stages 1 batches, expected 2"):
        net.fit_on_device(xs, ys[:1])
    with pytest.raises(ValueError, match=r"labels_masks stages 3 batches, expected 2"):
        net.fit_on_device(xs, ys, labels_masks=np.ones((3, 3, 5), np.float32))
    with pytest.raises(ValueError, match=r"real_batches=3 outside \[1, 2\]"):
        net.fit_on_device(xs, ys, real_batches=3)


def test_graph_staged_count_mismatch_names_right_array():
    """A multi-output graph with a bad label 1 names label array 1."""
    net = pt.ComputationGraph(_graph_conf(pt, seed=1, two_heads=True), device="cpu").init()
    rng = np.random.default_rng(0)
    xs = [rng.normal(size=(2, 4, 5)).astype(np.float32)]
    ys = [np.eye(3, dtype=np.float32)[rng.integers(0, 3, (2, 4))],
          np.eye(2, dtype=np.float32)[rng.integers(0, 2, (3, 4))]]
    with pytest.raises(ValueError, match=r"label array 1 stages 3 batches, expected 2"):
        net.fit_on_device(xs, ys)
    with pytest.raises(ValueError, match=r"labels_masks has 1 entries, expected 2"):
        net.fit_on_device(xs, ys[:1] + [ys[1][:2]], labels_masks=[None])


def test_graph_two_heads_staged_equals_per_batch():
    rng = np.random.default_rng(3)
    xs = rng.normal(size=(2, 4, 5)).astype(np.float32)
    y0 = np.eye(3, dtype=np.float32)[rng.integers(0, 3, (2, 4))]
    y1 = np.eye(2, dtype=np.float32)[rng.integers(0, 2, (2, 4))]
    lm = np.ones((2, 4), np.float32)
    lm[1, 3] = 0.0
    staged, plain = _port_twin(lambda pkg: _graph_conf(pkg, two_heads=True), graph=True)
    staged.fit_on_device([xs], [y0, y1], steps=3, labels_masks=[None, lm])
    for i in range(3):
        s = i % 2
        plain.fit(pt.MultiDataSet([xs[s]], [y0[s], y1[s]], labels_masks=[None, lm[s]]))
    _assert_same(staged, plain)


# ------------------------------------------------------- step scalar table
SCHEDULES = {
    "none": {},
    "exponential": {"lr_policy": "exponential", "lr_policy_decay_rate": 0.97},
    "inverse": {"lr_policy": "inverse", "lr_policy_decay_rate": 0.1, "lr_policy_power": 0.75},
    "poly": {"lr_policy": "poly", "lr_policy_power": 2.0, "max_iterations": 15},
    "sigmoid": {"lr_policy": "sigmoid", "lr_policy_gamma": 0.3, "lr_policy_steps": 9},
    "step": {"lr_policy": "step", "lr_policy_decay_rate": 0.5, "lr_policy_steps": 4},
    "torch_step": {"lr_policy": "torch_step", "lr_policy_decay_rate": 0.9,
                   "lr_policy_steps": 3},
    "schedule": {"lr_policy": "schedule", "learning_rate_schedule": {"5": 0.05, "12": 0.001}},
}


@pytest.mark.parametrize("schedule", sorted(SCHEDULES))
@pytest.mark.parametrize("betas", [(0.9, 0.999), (0.5, 0.9)])
@pytest.mark.parametrize("count", [0, 7])
def test_step_scalar_table_rows_are_the_per_batch_scalars(schedule, betas, count):
    """20 rows from count ``count``: row i is ``schedule(count + i)`` and
    ``bias_corrections(count + i + 1)``, bit for bit in f32 (the floats the
    by-value kernel receives)."""
    b1, b2 = betas
    tx = updaters.UpdaterConfig.from_dict(dict(
        updater="adam", learning_rate=0.1, beta1=b1, beta2=b2,
        **SCHEDULES[schedule])).build()
    state = {"count": count, "adam": {"count": count}}
    table = updaters.step_scalars(tx, state, 20)
    assert table.dtype == np.float32 and table.shape == (20, 3)
    for i in range(20):
        want = [tx.schedule(count + i),
                *updaters.bias_corrections(count + i + 1, b1, b2, torch.float32)]
        assert table[i].tolist() == np.float32(want).tolist()
    sgd = updaters.UpdaterConfig.from_dict(dict(updater="sgd", learning_rate=0.1,
                                                **SCHEDULES[schedule])).build()
    rows = updaters.step_scalars(sgd, {"count": count}, 20)
    assert rows[:, 0].tolist() == np.float32([sgd.schedule(count + i)
                                              for i in range(20)]).tolist()
    assert (rows[:, 1:] == 1.0).all()


@pytest.mark.parametrize("count", [0, 3, 19])
def test_device_scalar_adam_plain_version_is_adam_update_reference(count):
    """The device-scalar entry's plain version, fed a table row, against
    ``adam_update_reference`` with the per-batch path's floats: bit for
    bit, over a 3-leaf update."""
    b1, b2, eps = 0.9, 0.999, 1e-8
    tx = updaters.UpdaterConfig(updater="adam", learning_rate=3e-3).build()
    row = updaters.step_scalars(tx, {"count": count, "adam": {"count": count}}, 1)[0]
    rng = np.random.default_rng(count)
    leaves = [[torch.from_numpy(rng.normal(size=s).astype(np.float32)) for _ in range(3)]
              for s in ((5,), (3, 7), (130,))]
    for leaf in leaves:
        leaf[2] = leaf[2].abs()
    gs, ms, vs = (list(x) for x in zip(*leaves))
    got = adam.fused_adam_update_leaves_dev(gs, ms, vs, torch.from_numpy(row), b1, b2, eps)
    lr = tx.schedule(count)
    bc1, bc2 = updaters.bias_corrections(count + 1, b1, b2, torch.float32)
    for i, (g, m, v) in enumerate(leaves):
        want = adam.adam_update_reference(g, m, v, lr, bc1, bc2, b1, b2, eps)
        for out, w in zip((got[0][i], got[1][i], got[2][i]), want):
            assert torch.equal(out, w)
    with pytest.raises(ValueError, match="3 contiguous float32"):
        adam.fused_adam_update_leaves_dev(gs, ms, vs, torch.ones(2), b1, b2, eps)
