"""The PyTorch port's evaluation tier against the JAX package:
``Evaluation`` with record metadata (``eval/meta.py``'s ``Prediction`` and
the queries over it), ``RegressionEvaluation``, ``ROC`` and
``ROCMultiClass`` on the same predictions (drawn from a seed), to 1e-6;
and both networks trained and evaluated over the record iterators.

The networks start from JAX's params (``load_jax_params``) on a CSV
written to ``tmp_path``. ``evaluate`` with ``collect_metadata`` must name
the same misclassified records as JAX's, also behind a
``NormalizingIterator`` (the JAX package's
``test_metadata_survives_normalizer``), and a ``ComputationGraph`` over a
``RecordReaderMultiDataSetIterator`` alike. ``fit`` over a record iterator
resets it each epoch: the params after two epochs of Adam are held against
JAX's (x64 off) at 1e-5.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import deeplearning4j_tpu as dj  # noqa: E402
from deeplearning4j_tpu.runtime import inference as jax_inference  # noqa: E402
from deeplearning4j_tpu.datasets import normalizers as jnorm  # noqa: E402
from deeplearning4j_tpu.datasets import record_iterators as jri  # noqa: E402
from deeplearning4j_tpu.datasets import records as jrec  # noqa: E402
from deeplearning4j_tpu.eval import evaluation as jev  # noqa: E402
from deeplearning4j_tpu.eval import meta as jmeta_mod  # noqa: E402
from deeplearning4j_tpu.eval import regression as jreg  # noqa: E402
from deeplearning4j_tpu.eval import roc as jroc  # noqa: E402
from deeplearning4j_tpu.ops import kernel_select  # noqa: E402

import deeplearning4j_tpu_torch as pt  # noqa: E402
from deeplearning4j_tpu_torch.datasets import normalizers as pnorm  # noqa: E402
from deeplearning4j_tpu_torch.datasets import record_iterators as pri  # noqa: E402
from deeplearning4j_tpu_torch.datasets import records as prec  # noqa: E402
from deeplearning4j_tpu_torch.eval import evaluation as pev  # noqa: E402
from deeplearning4j_tpu_torch.eval import meta as pmeta  # noqa: E402
from deeplearning4j_tpu_torch.eval import regression as preg  # noqa: E402
from deeplearning4j_tpu_torch.eval import roc as proc  # noqa: E402

REL = 1e-6
RTOL = ATOL = 1e-5


@pytest.fixture(autouse=True)
def jax_env(monkeypatch, tmp_path):
    monkeypatch.setattr(jax_inference, "fast_path_enabled", lambda: False)
    monkeypatch.setenv("DL4JTPU_KERNEL_CALIBRATION", str(tmp_path / "calibration.json"))
    kernel_select.reset()
    yield
    kernel_select.reset()


def _preds(seed, n=40, c=4, t=None):
    rng = np.random.default_rng(seed)
    shape = (n, c) if t is None else (n, t, c)
    logits = rng.normal(size=shape)
    p = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    y = np.eye(c)[rng.integers(0, c, shape[:-1])]
    return y.astype(np.float32), p.astype(np.float32)


def _pred_keys(preds):
    return [(p.actual_class, p.predicted_class,
             getattr(p.record_metadata, "index", p.record_metadata)) for p in preds]


# ------------------------------------------------------------- Evaluation
@pytest.mark.parametrize("top_n", [1, 3])
def test_evaluation_with_metadata_matches_jax(top_n):
    pe, je = pev.Evaluation(top_n=top_n), jev.Evaluation(top_n=top_n)
    for seed in range(3):
        y, p = _preds(seed)
        meta = [f"batch{seed}-row{i}" for i in range(40)]
        pe.eval(y, p, record_metadata=meta)
        je.eval(y, p, record_metadata=meta)
    y, p = _preds(7)
    pe.eval(y.argmax(-1), p)  # int labels, no metadata: counted, no Prediction
    je.eval(y.argmax(-1), p)
    np.testing.assert_array_equal(pe.confusion.matrix, je.confusion.matrix)
    for f in ("accuracy", "precision", "recall", "f1", "top_n_accuracy"):
        assert getattr(pe, f)() == pytest.approx(getattr(je, f)(), rel=REL), f
    assert pe.false_positive_rate(2) == pytest.approx(je.false_positive_rate(2), rel=REL)
    assert pe.stats() == je.stats()
    assert len(pe.predictions) == 120
    assert _pred_keys(pe.prediction_errors()) == _pred_keys(je.prediction_errors())
    for c in range(4):
        assert _pred_keys(pe.predictions_by_actual_class(c)) == \
            _pred_keys(je.predictions_by_actual_class(c))
        assert _pred_keys(pe.predictions_by_predicted_class(c)) == \
            _pred_keys(je.predictions_by_predicted_class(c))


def test_evaluation_rejects_a_metadata_count_before_counting():
    pe = pev.Evaluation()
    y, p = _preds(1)
    with pytest.raises(ValueError, match="record_metadata has 3 entries for 40 examples"):
        pe.eval(y, p, record_metadata=["a", "b", "c"])
    pe.eval(y, p)
    assert pe.examples == 40 and pe.confusion.matrix.sum() == 40 and pe.predictions == []


def test_prediction_reloads_its_record(tmp_path):
    path = _csv(tmp_path)
    reader = prec.CSVRecordReader(path, skip_lines=1)
    rec, meta = list(reader.iter_with_metadata())[5]
    pred = pmeta.Prediction(np.int64(2), 1, meta)
    assert not pred.is_correct() and pred.actual_class == 2
    assert pred.get_record() == rec
    jmeta = list(jrec.CSVRecordReader(path, skip_lines=1).iter_with_metadata())[5][1]
    assert repr(pred) == repr(jmeta_mod.Prediction(2, 1, jmeta))
    with pytest.raises(ValueError, match="no record metadata"):
        pmeta.Prediction(0, 0).get_record()


# ------------------------------------------------- regression and ROC
@pytest.mark.parametrize("case", ["2d", "1d", "3d_masked"])
def test_regression_evaluation_matches_jax(case):
    rng = np.random.default_rng(3)
    shape = {"2d": (30, 3), "1d": (30,), "3d_masked": (6, 5, 2)}[case]
    pe, je = preg.RegressionEvaluation(precision=6), jreg.RegressionEvaluation(precision=6)
    for _ in range(2):
        y = rng.normal(size=shape)
        p = y + 0.3 * rng.normal(size=shape)
        mask = (rng.random((6, 5)) > 0.3).astype(np.float32) if case == "3d_masked" else None
        pe.eval(y, p, mask=mask)
        je.eval(y, p, mask=mask)
    assert pe.num_columns() == je.num_columns() > 0
    for f in ("mean_squared_error", "mean_absolute_error", "root_mean_squared_error",
              "relative_squared_error", "correlation_r2"):
        for c in range(pe.num_columns()):
            assert getattr(pe, f)(c) == pytest.approx(getattr(je, f)(c), rel=REL), f
    assert pe.average_mean_squared_error() == pytest.approx(je.average_mean_squared_error(),
                                                            rel=REL)
    assert pe.average_mean_absolute_error() == pytest.approx(
        je.average_mean_absolute_error(), rel=REL)
    assert pe.stats() == je.stats()
    named = preg.RegressionEvaluation(column_names=["a"])
    named.eval(np.ones(3), np.zeros(3))
    assert named.column_names == ["a"] and np.isnan(named.relative_squared_error(0))


@pytest.mark.parametrize("form", ["probability", "two_columns"])
def test_roc_matches_jax(form):
    rng = np.random.default_rng(4)
    pr, jr = proc.ROC(threshold_steps=20), jroc.ROC(threshold_steps=20)
    for _ in range(3):
        y = (rng.random(50) > 0.6).astype(np.float32)
        p = np.clip(0.35 * y + rng.random(50) * 0.65, 0, 1)
        if form == "two_columns":
            y, p = np.stack([1 - y, y], 1), np.stack([1 - p, p], 1)
        pr.eval(y, p)
        jr.eval(y, p)
    assert pr.count == jr.count == 150
    np.testing.assert_allclose(pr.get_results(), jr.get_results(), rtol=REL)
    assert pr.calculate_auc() == pytest.approx(jr.calculate_auc(), rel=REL)
    assert 0.5 < pr.calculate_auc() <= 1.0
    with pytest.raises(ValueError, match="binary"):
        pr.eval(np.zeros((3, 3)), np.zeros((3, 3)))


def test_roc_multiclass_matches_jax():
    pr, jr = proc.ROCMultiClass(threshold_steps=10), jroc.ROCMultiClass(threshold_steps=10)
    assert np.isnan(pr.calculate_average_auc())
    for seed in range(2):
        y, p = _preds(seed, c=3)
        pr.eval(y, p)
        jr.eval(y, p)
    for c in range(3):
        assert pr.calculate_auc(c) == pytest.approx(jr.calculate_auc(c), rel=REL)
        np.testing.assert_allclose(pr.get_results(c), jr.get_results(c), rtol=REL)
    assert pr.calculate_average_auc() == pytest.approx(jr.calculate_average_auc(), rel=REL)
    with pytest.raises(ValueError, match="one-hot"):
        pr.eval(np.zeros(3), np.zeros(3))


# ------------------------------------- the networks over record iterators
def _csv(tmp_path, n=37, seed=0):
    """4 features that separate 3 classes only in part, and a header."""
    rng = np.random.default_rng(seed)
    y = rng.integers(0, 3, n)
    x = rng.normal(size=(n, 4)) + 0.8 * np.eye(3, 4)[y]
    path = tmp_path / "data.csv"
    path.write_text("a,b,c,d,label\n" + "".join(
        ",".join(f"{v:.4f}" for v in row) + f",{c}\n" for row, c in zip(x, y)))
    return str(path)


def _mln_pair(lr=0.05):
    def conf(pkg):
        u = pkg.UpdaterConfig(updater="adam", learning_rate=lr)
        return pkg.MultiLayerConfiguration(
            layers=[pkg.DenseLayer(n_out=8, activation="tanh"),
                    pkg.OutputLayer(n_out=3, activation="softmax", loss="mcxent")],
            input_type=pkg.InputType.feed_forward(4), updater=u, seed=11)

    jnet = dj.MultiLayerNetwork(conf(dj)).init()
    jnet.init(params=jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float32),
                                            jnet.params), force=True)
    pnet = pt.MultiLayerNetwork(conf(pt), device="cpu")
    assert pnet.conf.to_json() == jnet.conf.to_json()
    return jnet, pt.load_jax_params(pnet, jnet.params)


def _records_iter(mod, rmod, path, batch=8, **kw):
    return mod.RecordReaderDataSetIterator(rmod.CSVRecordReader(path, skip_lines=1), batch,
                                           label_index=4, num_classes=3, **kw)


def _errors(ev):
    return [(p.actual_class, p.predicted_class, p.record_metadata.index,
             p.record_metadata.source) for p in ev.prediction_errors()]


def test_multilayer_fit_over_records_resets_and_matches_jax(tmp_path):
    """Two epochs of Adam over a RecordReaderDataSetIterator (5 batches,
    the last of 5 rows), each epoch reset; then ``evaluate`` with the
    records' metadata and ``score``."""
    path = _csv(tmp_path)
    with jax.enable_x64(False):
        jnet, pnet = _mln_pair()
        jnet.fit(_records_iter(jri, jrec, path), epochs=2)
        pnet.fit(_records_iter(pri, prec, path), epochs=2)
        for jp, pp in zip(jnet.params, pt.params_to_numpy(pnet)):
            for k, v in jp.items():
                np.testing.assert_allclose(pp[k], np.asarray(v), rtol=RTOL, atol=ATOL)
        assert pnet.epoch == 2
        pe = pnet.evaluate(_records_iter(pri, prec, path, collect_metadata=True))
        je = jnet.evaluate(_records_iter(jri, jrec, path, collect_metadata=True))
    np.testing.assert_array_equal(pe.confusion.matrix, je.confusion.matrix)
    assert len(pe.predictions) == 37
    assert _errors(pe) == _errors(je) and _errors(pe)
    first = pe.prediction_errors()[0]
    assert first.get_record()[-1] == first.actual_class
    ds = next(iter(_records_iter(pri, prec, path, batch=37)))
    assert pnet.score(ds) == pytest.approx(float(jnet.score(dj.DataSet(ds.features,
                                                                       ds.labels))), rel=RTOL)


def test_metadata_survives_a_normalizing_iterator(tmp_path):
    path = _csv(tmp_path, seed=1)
    jnet, pnet = _mln_pair()
    pn = pnorm.NormalizerStandardize().fit(_records_iter(pri, prec, path))
    jn = jnorm.NormalizerStandardize().fit(_records_iter(jri, jrec, path))
    pe = pnet.evaluate(pnorm.NormalizingIterator(
        _records_iter(pri, prec, path, collect_metadata=True), pn))
    je = jnet.evaluate(jnorm.NormalizingIterator(
        _records_iter(jri, jrec, path, collect_metadata=True), jn))
    assert len(pe.predictions) == 37
    assert all(p.record_metadata is not None for p in pe.predictions)
    assert _errors(pe) == _errors(je)
    np.testing.assert_array_equal(pe.confusion.matrix, je.confusion.matrix)


def test_time_series_output_drops_metadata_as_jax():
    """A [B, T, C] output flattens to B*T rows, which per-example metadata
    no longer matches: no Prediction is kept."""
    conf = pt.MultiLayerConfiguration(
        layers=[pt.RnnOutputLayer(n_out=3, activation="softmax", loss="mcxent")],
        input_type=pt.InputType.recurrent(2, 5), seed=1)
    net = pt.MultiLayerNetwork(conf, device="cpu").init()
    rng = np.random.default_rng(0)
    ds = pt.DataSet(rng.normal(size=(4, 5, 2)).astype(np.float32),
                    np.eye(3, dtype=np.float32)[rng.integers(0, 3, (4, 5))],
                    example_metadata=["a", "b", "c", "d"])
    ev = net.evaluate(ds)
    assert ev.examples == 20 and ev.predictions == []


def _graph_conf(pkg):
    return (pkg.ComputationGraphConfiguration.builder()
            .add_inputs("x", "z")
            .set_input_types(pkg.InputType.feed_forward(3), pkg.InputType.feed_forward(1))
            .add_layer("dx", pkg.DenseLayer(n_out=6, activation="tanh"), "x")
            .add_layer("dz", pkg.DenseLayer(n_out=2, activation="tanh"), "z")
            .add_vertex("m", pkg.MergeVertex(), "dx", "dz")
            .add_layer("cls", pkg.OutputLayer(n_out=3, activation="softmax", loss="mcxent"), "m")
            .add_layer("reg", pkg.OutputLayer(n_out=1, activation="identity", loss="mse"), "m")
            .set_outputs("cls", "reg")
            .updater(pkg.UpdaterConfig(updater="adam", learning_rate=0.05))
            .seed(4)
            .build())


def _multi_iter(mod, rmod, path):
    return (mod.RecordReaderMultiDataSetIterator(8)
            .add_reader("csv", rmod.CSVRecordReader(path, skip_lines=1))
            .add_input("csv", 0, 2).add_input("csv", 3)
            .add_output_one_hot("csv", 4, 3).add_output("csv", 3))


def test_graph_fit_and_evaluate_over_a_multi_record_iterator(tmp_path):
    """Two epochs of Adam over a RecordReaderMultiDataSetIterator (two
    inputs, a classification and a regression head), reset each epoch, then
    ``evaluate`` (the classification head) and, with metadata, over a
    DataSet iterator of one input."""
    path = _csv(tmp_path, seed=2)
    with jax.enable_x64(False):
        jnet = dj.ComputationGraph(_graph_conf(dj)).init()
        jnet.init(params=jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float32),
                                                jnet.params), force=True)
        pnet = pt.load_jax_params(pt.ComputationGraph(_graph_conf(pt), device="cpu"),
                                  {n: {k: np.asarray(v) for k, v in p.items()}
                                   for n, p in jnet.params.items()})
        jnet.fit(_multi_iter(jri, jrec, path), epochs=2)
        pnet.fit(_multi_iter(pri, prec, path), epochs=2)
        mine = pt.params_to_numpy(pnet)
        for n, p in jnet.params.items():
            for k, v in p.items():
                np.testing.assert_allclose(mine[n][k], np.asarray(v), rtol=RTOL, atol=ATOL)
        pe, je = pnet.evaluate(_multi_iter(pri, prec, path)), jnet.evaluate(
            _multi_iter(jri, jrec, path))
    assert set(pe) == set(je) == {"cls"}
    np.testing.assert_array_equal(pe["cls"].confusion.matrix, je["cls"].confusion.matrix)

    def one_input(pkg):
        return (pkg.ComputationGraphConfiguration.builder().add_inputs("x")
                .set_input_types(pkg.InputType.feed_forward(4))
                .add_layer("out", pkg.OutputLayer(n_out=3, activation="softmax"), "x")
                .set_outputs("out").seed(9).build())

    jg = dj.ComputationGraph(one_input(dj)).init()
    pg = pt.load_jax_params(pt.ComputationGraph(one_input(pt), device="cpu"),
                            {n: {k: np.asarray(v) for k, v in p.items()}
                             for n, p in jg.params.items()})
    pe = pg.evaluate(_records_iter(pri, prec, path, collect_metadata=True))
    je = jg.evaluate(_records_iter(jri, jrec, path, collect_metadata=True))
    assert len(pe.predictions) == 37 and _errors(pe) == _errors(je)
