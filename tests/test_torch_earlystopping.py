"""The PyTorch port's early stopping against the JAX package: each
termination condition, both model savers, and trainer runs (on
``MultiLayerNetwork`` and ``ComputationGraph``) whose termination reason,
details, best epoch, epoch count and per-epoch scores equal JAX's from the
same weights (the JAX side in f32 with x64 off; scores at 1e-5 relative).
The MLP and its data are examples/early_stopping.py's.
"""

import math
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import deeplearning4j_tpu as dj  # noqa: E402
from deeplearning4j_tpu import earlystopping as jes  # noqa: E402
from deeplearning4j_tpu.datasets import iterators as jit_  # noqa: E402
from deeplearning4j_tpu.utils import serialization as jser  # noqa: E402

import deeplearning4j_tpu_torch as pt  # noqa: E402
from deeplearning4j_tpu_torch import earlystopping as pes  # noqa: E402
from deeplearning4j_tpu_torch.datasets import iterators as pit  # noqa: E402

RTOL = 1e-5
PKGS = {"jax": (dj, jes, jit_), "port": (pt, pes, pit)}


def _f32(tree):
    return jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float32), tree)


def _example_batches(n, seed):
    """examples/early_stopping.py's batches of 32 rows, 6 features, 3 classes."""
    w = np.random.default_rng(3).normal(size=(6, 3))
    r = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        x = r.normal(size=(32, 6)).astype(np.float32)
        out.append((x, np.eye(3, dtype=np.float32)[(x @ w).argmax(-1)]))
    return out


def _mlp(pkg, lr):
    u = pkg.UpdaterConfig(updater="adam", learning_rate=lr)
    return pkg.MultiLayerConfiguration(
        layers=[pkg.DenseLayer(n_out=24, activation="tanh"),
                pkg.OutputLayer(n_out=3, activation="softmax", loss="mcxent")],
        input_type=pkg.InputType.feed_forward(6), updater=u if pkg is dj else u.to_dict())


def _graph(pkg, lr):
    return (pkg.ComputationGraphConfiguration.builder().add_inputs("in")
            .set_input_types(pkg.InputType.feed_forward(6))
            .add_layer("h", pkg.DenseLayer(n_out=24, activation="tanh"), "in")
            .add_layer("out", pkg.OutputLayer(n_out=3, activation="softmax", loss="mcxent"), "h")
            .set_outputs("out").updater(pkg.UpdaterConfig(updater="adam", learning_rate=lr))
            .build())


def _nets(kind, lr):
    make = _mlp if kind == "mln" else _graph
    cls = "MultiLayerNetwork" if kind == "mln" else "ComputationGraph"
    jnet = getattr(dj, cls)(make(dj, lr)).init()
    jnet.init(params=_f32(jnet.params), force=True)
    pnet = pt.load_jax_params(getattr(pt, cls)(make(pt, lr), device="cpu"), jnet.params)
    return {"jax": jnet, "port": pnet}


def _run(pkg_name, net, conditions, it_conditions, saver, train, score, **cfg_kw):
    pkg, es, its = PKGS[pkg_name]
    cfg = es.EarlyStoppingConfiguration(
        epoch_termination_conditions=conditions(es),
        iteration_termination_conditions=it_conditions(es),
        score_calculator=es.DataSetLossCalculator(
            its.ListDataSetIterator([its.DataSet(x, y) for x, y in score])),
        model_saver=saver(es), **cfg_kw)
    trainer = (es.EarlyStoppingTrainer
               if isinstance(net, (dj.MultiLayerNetwork, pt.MultiLayerNetwork))
               else getattr(es, "EarlyStoppingGraphTrainer", es.EarlyStoppingTrainer))
    return trainer(cfg, net, its.ListDataSetIterator([its.DataSet(x, y) for x, y in train])
                   ).fit()


def _same_result(got, want):
    assert got.termination_reason.value == want.termination_reason.value
    assert got.termination_details == want.termination_details
    assert got.best_model_epoch == want.best_model_epoch
    assert got.total_epochs == want.total_epochs
    assert sorted(got.score_vs_epoch) == sorted(want.score_vs_epoch)
    for e, s in want.score_vs_epoch.items():
        np.testing.assert_allclose(got.score_vs_epoch[e], s, rtol=RTOL)
    np.testing.assert_allclose(got.best_model_score, want.best_model_score, rtol=RTOL)


CASES = {
    # examples/early_stopping.py's own run (quick: 4 epochs)
    "example": (5e-3, lambda es: [es.MaxEpochsTerminationCondition(4),
                                  es.ScoreImprovementEpochTerminationCondition(patience=5)],
                lambda es: []),
    # lr 0: the score never improves after epoch 0
    "patience": (0.0, lambda es: [es.MaxEpochsTerminationCondition(50),
                                  es.ScoreImprovementEpochTerminationCondition(patience=3)],
                 lambda es: []),
    # a diverging lr: the iteration conditions stop it
    "diverge": (1e4, lambda es: [es.MaxEpochsTerminationCondition(100)],
                lambda es: [es.MaxScoreIterationTerminationCondition(50.0),
                            es.InvalidScoreIterationTerminationCondition()]),
    # a best-score target reached after a few epochs
    "target": (5e-2, lambda es: [es.MaxEpochsTerminationCondition(30),
                                 es.BestScoreEpochTerminationCondition(0.5)],
               lambda es: []),
}


@pytest.mark.parametrize("kind", ["mln", "graph"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_trainer_run_equals_jax(case, kind, tmp_path):
    lr, conditions, it_conditions = CASES[case]
    train, score = _example_batches(8, 0), _example_batches(4, 99)
    with jax.enable_x64(False):
        nets = _nets(kind, lr)
        results = {}
        for name, net in nets.items():
            results[name] = _run(name, net, conditions, it_conditions,
                                 lambda es: es.InMemoryModelSaver(), train, score)
    _same_result(results["port"], results["jax"])
    best = results["port"].best_model
    if best is not None:
        assert best is not nets["port"]
        x = np.concatenate([x for x, _ in score])
        np.testing.assert_allclose(best.output(x), np.asarray(results["jax"].best_model.output(x)),
                                   rtol=1e-4, atol=1e-5)


def test_local_file_saver_round_trips_the_best_model(tmp_path):
    train, score = _example_batches(8, 0), _example_batches(4, 99)
    with jax.enable_x64(False):
        nets = _nets("mln", 5e-3)
        saver = pes.LocalFileModelSaver(str(tmp_path / "port"), device="cpu")
        got = _run("port", nets["port"], CASES["example"][1], lambda es: [],
                   lambda es: saver, train, score, save_last_model=True)
        want = _run("jax", nets["jax"], CASES["example"][1], lambda es: [],
                    lambda es: es.LocalFileModelSaver(str(tmp_path / "jax")), train, score,
                    save_last_model=True)
    _same_result(got, want)
    best, latest = saver.get_best_model(), saver.get_latest_model()
    assert (tmp_path / "port" / "bestModel.zip").exists() and latest is not None
    np.testing.assert_allclose(best.score(pit.DataSet(*score[0])),
                               nets["port"].score(pit.DataSet(*score[0])), rtol=1e-6)
    # the saved zip is the JAX package's layout, and the restored net
    # serves bit for bit what the saved one did
    x = np.concatenate([x for x, _ in score])
    saved = pt.restore_model(str(tmp_path / "port" / "bestModel.zip"), device="cpu")
    np.testing.assert_array_equal(best.output(x), saved.output(x))
    jbest = jser.restore_model(str(tmp_path / "port" / "bestModel.zip"))
    np.testing.assert_allclose(np.asarray(jbest.output(x)), best.output(x), atol=1e-6)
    assert pes.LocalFileModelSaver(str(tmp_path / "empty")).get_best_model() is None


def test_in_memory_saver_keeps_clones():
    net = _nets("mln", 5e-3)["port"]
    saver = pes.InMemoryModelSaver()
    assert saver.get_best_model() is None and saver.get_latest_model() is None
    saver.save_best_model(net, 1.0)
    saver.save_latest_model(net, 1.0)
    x, y = _example_batches(1, 0)[0]
    net.fit((x, y))
    for kept in (saver.get_best_model(), saver.get_latest_model()):
        assert kept is not net
        assert not np.array_equal(kept.output(x), net.output(x))


@pytest.mark.parametrize("cond,calls,stops_at", [
    (lambda es: es.MaxEpochsTerminationCondition(3), [(0, 1.0), (1, 1.0), (2, 1.0)], 2),
    (lambda es: es.ScoreImprovementEpochTerminationCondition(2),
     [(0, 1.0), (1, 0.9), (2, 0.95), (3, 0.9), (4, 0.99)], 3),
    (lambda es: es.ScoreImprovementEpochTerminationCondition(1, min_improvement=0.2),
     [(0, 1.0), (1, 0.9)], 1),
    (lambda es: es.BestScoreEpochTerminationCondition(0.5), [(0, 0.7), (1, 0.5), (2, 0.4)], 2),
])
def test_epoch_conditions_as_jax(cond, calls, stops_at):
    for es in (jes, pes):
        c = cond(es)
        c.initialize()
        fired = [c.terminate(e, s) for e, s in calls]
        assert fired.index(True) == stops_at
    assert str(cond(pes)) == str(cond(jes))


@pytest.mark.parametrize("cond,scores,fires", [
    (lambda es: es.MaxScoreIterationTerminationCondition(50.0), [1.0, 50.0, 50.5], [0, 0, 1]),
    (lambda es: es.InvalidScoreIterationTerminationCondition(), [1.0, math.inf, math.nan],
     [0, 1, 1]),
])
def test_iteration_conditions_as_jax(cond, scores, fires):
    for es in (jes, pes):
        c = cond(es)
        c.initialize()
        assert [int(c.terminate(s)) for s in scores] == fires
    assert str(cond(pes)) == str(cond(jes))


def test_max_time_condition():
    c = pes.MaxTimeIterationTerminationCondition(0.05)
    c.initialize()
    assert not c.terminate(1.0)
    time.sleep(0.06)
    assert c.terminate(1.0)
    zero = pes.MaxTimeIterationTerminationCondition(0.0)
    zero.initialize()
    time.sleep(0.001)
    assert zero.terminate(1.0)
    assert str(c) == str(jes.MaxTimeIterationTerminationCondition(0.05))


def test_iteration_listener_only_with_iteration_conditions():
    """The listener reads each update's loss on the host (a wait for the
    card), so it is added only where iteration conditions exist, and taken
    off after the run."""
    train, score = _example_batches(2, 0), _example_batches(1, 99)
    net = _nets("mln", 5e-3)["port"]
    added = []
    real = net.add_listener
    net.add_listener = lambda lst: added.append(lst) or real(lst)
    _run("port", net, lambda es: [es.MaxEpochsTerminationCondition(2)], lambda es: [],
         lambda es: es.InMemoryModelSaver(), train, score)
    assert added == []
    res = _run("port", net, lambda es: [es.MaxEpochsTerminationCondition(2)],
               lambda es: [es.MaxScoreIterationTerminationCondition(1e9)],
               lambda es: es.InMemoryModelSaver(), train, score)
    assert len(added) == 1 and net.listeners == []
    assert res.termination_reason == pes.TerminationReason.EPOCH_TERMINATION_CONDITION


def test_exports():
    assert set(pes.__all__) == (set(jes.__all__) - {"EarlyStoppingParallelTrainer"}) | {
        "EarlyStoppingGraphTrainer", "TerminationReason"}
    assert pes.EarlyStoppingGraphTrainer is pes.EarlyStoppingTrainer


def test_no_fallback_to_the_cpu(tmp_path):
    """Without a card, what is asked for the card raises: a saver's restore
    (its default device) and a transfer or pretrain of a net made for it."""
    if torch.cuda.is_available():
        pytest.skip("holds only where no CUDA device is present")
    net = _nets("mln", 5e-3)["port"]
    saver = pes.LocalFileModelSaver(str(tmp_path))
    saver.save_best_model(net, 1.0)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        saver.get_best_model()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pt.MultiLayerNetwork(pt.dbn_conf())
    assert pt.TransferLearning.Builder(net).build().device.type == "cpu"
