"""The port's listener catalog (``deeplearning4j_tpu_torch/optimize/
listeners.py``) against the JAX package's.

A recording listener, attached to both packages' nets of the same conf and
weights, sees the same hooks (epoch start and end, ``iteration_done``), the
same iterations and the same scores (1e-5; the JAX side with x64 off), and
the same model views: ``_last_input`` only with ``needs_input``,
``_last_grads``/``_last_updates`` only with ``needs_gradients`` and only on
the iterations its ``frequency`` selects, none once the listeners have run.
The stock listeners keep their flags and registry metrics;
``ParamAndGradientIterationListener`` writes JAX's header and, within
1e-5, its numbers. Staging runs only when every listener supports it.
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import deeplearning4j_tpu as dj  # noqa: E402
from deeplearning4j_tpu.runtime import inference as jax_inference  # noqa: E402
from deeplearning4j_tpu.datasets.iterators import DataSet as JaxDataSet  # noqa: E402
from deeplearning4j_tpu.ops import kernel_select  # noqa: E402
from deeplearning4j_tpu.optimize import listeners as jlis  # noqa: E402
from deeplearning4j_tpu.telemetry import registry as jreg  # noqa: E402

import deeplearning4j_tpu_torch as pt  # noqa: E402
from deeplearning4j_tpu_torch.optimize import listeners as plis  # noqa: E402
from deeplearning4j_tpu_torch.telemetry import registry as preg  # noqa: E402

TOL = 1e-5


@pytest.fixture(autouse=True)
def jax_env(monkeypatch, tmp_path):
    monkeypatch.setattr(jax_inference, "fast_path_enabled", lambda: False)
    monkeypatch.setenv("DL4JTPU_KERNEL_CALIBRATION", str(tmp_path / "calibration.json"))
    kernel_select.reset()
    yield
    kernel_select.reset()


def _f32(tree):
    return jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float32), tree)


def _mlp(pkg):
    u = pkg.UpdaterConfig(updater="adam", learning_rate=1e-2)
    return pkg.MultiLayerConfiguration(
        layers=[pkg.DenseLayer(n_out=8, activation="tanh"),
                pkg.OutputLayer(n_out=3, activation="softmax", loss="mcxent")],
        input_type=pkg.InputType.feed_forward(5), updater=u if pkg is dj else u.to_dict(),
        seed=21)


def _graph(pkg):
    u = pkg.UpdaterConfig(updater="sgd", learning_rate=1e-1)
    return (pkg.ComputationGraphConfiguration.builder().seed(22)
            .updater(u if pkg is dj else u.to_dict()).add_inputs("in")
            .add_layer("h", pkg.DenseLayer(n_out=6, activation="relu"), "in")
            .add_layer("out", pkg.OutputLayer(n_out=3, activation="softmax", loss="mcxent"),
                       "h")
            .set_outputs("out").set_input_types(pkg.InputType.feed_forward(5)).build())


def _pair(graph=False):
    cls_j = dj.ComputationGraph if graph else dj.MultiLayerNetwork
    cls_p = pt.ComputationGraph if graph else pt.MultiLayerNetwork
    make = _graph if graph else _mlp
    with jax.enable_x64(False):
        jnet = cls_j(make(dj)).init()
        jnet.init(params=_f32(jnet.params), force=True)
    host = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), jnet.params)
    return jnet, pt.load_jax_params(cls_p(make(pt), device="cpu"), host)


def _data(n=6, b=4, seed=0):
    rng = np.random.default_rng(seed)
    return [(rng.normal(size=(b, 5)).astype(np.float32),
             np.eye(3, dtype=np.float32)[rng.integers(0, 3, b)]) for _ in range(n)]


def _recorder(base, **flags):
    """A listener class on ``base`` (either package's TrainingListener)
    that records every hook and what the model holds for it."""

    class Recorder(base):
        def __init__(self):
            self.log = []

        def on_epoch_start(self, model, epoch):
            self.log.append(("epoch_start", epoch))

        def on_epoch_end(self, model, epoch):
            self.log.append(("epoch_end", epoch))

        def iteration_done(self, model, iteration, score):
            grads = getattr(model, "_last_grads", None)
            self.log.append(("iteration", iteration, float(score),
                             getattr(model, "_last_input", None) is not None,
                             grads is not None,
                             getattr(model, "_last_updates", None) is not None))

    for k, v in flags.items():
        setattr(Recorder, k, v)
    return Recorder()


def _same_logs(plog, jlog):
    assert [e[:2] for e in plog] == [e[:2] for e in jlog]
    for p, j in zip(plog, jlog):
        if p[0] == "iteration":
            assert math.isclose(p[2], j[2], rel_tol=TOL, abs_tol=TOL)
            assert p[3:] == j[3:], (p, j)


def _fit_both(jnet, pnet, data, epochs=2, **kw):
    with jax.enable_x64(False):
        jnet.fit([JaxDataSet(x, y) for x, y in data], epochs=epochs, **kw)
    pnet.fit([pt.DataSet(x, y) for x, y in data], epochs=epochs, **kw)


@pytest.mark.parametrize("flags", [
    {}, {"needs_input": True}, {"needs_gradients": True, "frequency": 2},
    {"needs_gradients": True, "frequency": 3, "needs_input": True}],
    ids=["plain", "needs_input", "grads_every_2", "grads_every_3_and_input"])
def test_recording_listener_sees_what_jax_shows(flags):
    jnet, pnet = _pair()
    jrec, prec = _recorder(jlis.TrainingListener, **flags), _recorder(plis.TrainingListener,
                                                                      **flags)
    jnet.set_listeners(jrec)
    pnet.set_listeners(prec)
    _fit_both(jnet, pnet, _data())
    _same_logs(prec.log, jrec.log)
    its = [e for e in prec.log if e[0] == "iteration"]
    assert len(its) == 12
    freq = flags.get("frequency")
    assert [e[4] for e in its] == [bool(freq) and e[1] % freq == 0 for e in its]
    assert [e[3] for e in its] == [flags.get("needs_input", False)] * 12
    assert pnet._last_grads is None and pnet._last_updates is None


def test_graph_listener_sees_gradients_on_its_frequency():
    jnet, pnet = _pair(graph=True)
    flags = {"needs_gradients": True, "frequency": 2}
    jrec, prec = _recorder(jlis.TrainingListener, **flags), _recorder(plis.TrainingListener,
                                                                      **flags)
    jnet.set_listeners(jrec)
    pnet.set_listeners(prec)
    _fit_both(jnet, pnet, _data(seed=1), epochs=1)
    _same_logs(prec.log, jrec.log)


def test_grads_the_listener_sees_are_the_update_s():
    """``_last_grads`` are the update's gradients (JAX's within 1e-5) and
    ``_last_updates`` its updates (params after minus before)."""
    jnet, pnet = _pair()
    seen = {}

    class Grab(plis.TrainingListener):
        needs_gradients = True

        def iteration_done(self, model, iteration, score):
            seen["g"] = [{k: v.clone() for k, v in d.items()} for d in model._last_grads]
            seen["u"] = [{k: v.clone() for k, v in d.items()} for d in model._last_updates]

    class JGrab(jlis.TrainingListener):
        needs_gradients = True

        def iteration_done(self, model, iteration, score):
            seen["jg"] = jax.tree_util.tree_map(np.asarray, model._last_grads)

    before = pt.params_to_numpy(pnet)
    pnet.set_listeners(Grab())
    jnet.set_listeners(JGrab())
    _fit_both(jnet, pnet, _data(n=1, seed=2), epochs=1)
    after = pt.params_to_numpy(pnet)
    for i, layer in enumerate(seen["g"]):
        for k in layer:
            np.testing.assert_allclose(layer[k].numpy(), seen["jg"][i][k], rtol=TOL, atol=TOL)
            np.testing.assert_allclose(seen["u"][i][k].numpy(), after[i][k] - before[i][k],
                                       rtol=1e-5, atol=1e-7)


def test_stock_listeners_flags_and_metrics():
    for name in ("ScoreIterationListener", "CollectScoresIterationListener",
                 "PerformanceListener", "ParamAndGradientIterationListener"):
        p, j = getattr(plis, name), getattr(jlis, name)
        for flag in ("supports_staged", "needs_gradients", "needs_input"):
            assert getattr(p, flag, False) == getattr(j, flag, False), (name, flag)
    jr, pr = jreg.MetricsRegistry(), preg.MetricsRegistry()
    jnet, pnet = _pair()
    jl = [jlis.ScoreIterationListener(print_every=2, registry=jr),
          jlis.CollectScoresIterationListener(frequency=3)]
    pl = [plis.ScoreIterationListener(print_every=2, registry=pr),
          plis.CollectScoresIterationListener(frequency=3)]
    jnet.set_listeners(*jl)
    pnet.set_listeners(*pl)
    _fit_both(jnet, pnet, _data(seed=3))
    assert [i for i, _ in pl[1].scores] == [i for i, _ in jl[1].scores] == [3, 6, 9, 12]
    np.testing.assert_allclose([s for _, s in pl[1].scores], [s for _, s in jl[1].scores],
                               rtol=TOL)
    ps, js = pr.snapshot(), jr.snapshot()
    assert ps["dl4jtpu_score_reports_total"] == js["dl4jtpu_score_reports_total"]
    assert ps["dl4jtpu_score_reports_total"]["values"][0]["value"] == 6
    assert ps["dl4jtpu_score"]["values"][0]["value"] == pytest.approx(
        js["dl4jtpu_score"]["values"][0]["value"], rel=TOL)


def test_performance_listener_reports_like_jax():
    reg = preg.MetricsRegistry()
    perf = plis.PerformanceListener(frequency=2, report_score=True, registry=reg)
    net = pt.MultiLayerNetwork(_mlp(pt), device="cpu").init()
    net.set_listeners(perf)
    net.fit([pt.DataSet(x, y) for x, y in _data(n=8)])
    assert [r["iteration"] for r in perf.history] == [4, 6, 8]
    assert all(r["samples_per_sec"] == pytest.approx(4 * r["batches_per_sec"])
               and "score" in r for r in perf.history)
    assert reg.get("dl4jtpu_throughput_batches_per_sec").value == perf.history[-1][
        "batches_per_sec"]
    staged = pt.MultiLayerNetwork(_mlp(pt), device="cpu").init()
    sperf = plis.PerformanceListener(frequency=4, registry=preg.MetricsRegistry())
    staged.set_listeners(sperf)
    staged.fit([pt.DataSet(x, y) for x, y in _data(n=8)], stage_on_device=4)
    assert staged.staged_steps_total == 8 and [r["iteration"] for r in sperf.history] == [8]


def test_composable_listener_aggregates_flags_and_forwards():
    a = plis.CollectScoresIterationListener()
    g2 = plis.ParamAndGradientIterationListener(iterations=4)
    g3 = _recorder(plis.TrainingListener, needs_gradients=True, frequency=6)
    comp = plis.ComposableIterationListener(a, g2, g3)
    jcomp = jlis.ComposableIterationListener(
        jlis.CollectScoresIterationListener(), jlis.ParamAndGradientIterationListener(iterations=4),
        _recorder(jlis.TrainingListener, needs_gradients=True, frequency=6))
    assert (comp.supports_staged, comp.needs_gradients, comp.needs_input, comp.frequency) == (
        jcomp.supports_staged, jcomp.needs_gradients, jcomp.needs_input, jcomp.frequency) == (
        False, True, False, 2)
    assert plis.ComposableIterationListener([a]).supports_staged
    net = pt.MultiLayerNetwork(_mlp(pt), device="cpu").init()
    net.set_listeners(comp)
    net.fit([pt.DataSet(x, y) for x, y in _data(n=6)], stage_on_device=3)
    assert net.staged_steps_total == 0  # a child without supports_staged
    assert [i for i, _ in a.scores] == list(range(1, 7))
    its = [e for e in g3.log if e[0] == "iteration"]
    # the composite asks for gradients at the gcd of its children's cadences
    assert [e[1] for e in its if e[4]] == [2, 4, 6]
    assert ("epoch_start", 0) in g3.log and ("epoch_end", 1) in g3.log


@pytest.mark.parametrize("graph", [False, True], ids=["mln", "graph"])
def test_param_and_gradient_listener_lines_match_jax(graph, tmp_path):
    jnet, pnet = _pair(graph)
    jl = jlis.ParamAndGradientIterationListener(iterations=2)
    pl = plis.ParamAndGradientIterationListener(iterations=2)
    jnet.set_listeners(jl)
    pnet.set_listeners(pl)
    _fit_both(jnet, pnet, _data(n=4, seed=4), epochs=1)
    assert len(pl.lines) == len(jl.lines) == 3
    assert pl.lines[0] == jl.lines[0]  # the header: keystr names
    for p, j in zip(pl.lines[1:], jl.lines[1:]):
        pf, jf = p.split("\t"), j.split("\t")
        assert pf[0] == jf[0] and len(pf) == len(jf)
        np.testing.assert_allclose([float(v) for v in pf[1:]], [float(v) for v in jf[1:]],
                                   rtol=1e-4, atol=TOL)
    out = tmp_path / "stats.tsv"
    fl = plis.ParamAndGradientIterationListener(iterations=1, output_to_file=True,
                                                file=str(out), print_min_max=False)
    pnet.set_listeners(fl)
    pnet.fit(_data(n=1, seed=5)[0])
    lines = out.read_text().splitlines()
    assert len(lines) == 2 and fl.lines == [] and "min" not in lines[0]
