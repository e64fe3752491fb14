"""The small names of the port's ported modules against the JAX package's
(after ``tests/test_utils_misc.py``): ``MultiLayerConfiguration.
output_type``, ``BucketingSequenceIterator.num_programs``, the collections
(``Counter``, ``CounterMap``, ``DiskBasedQueue``, ``MagicQueue``) and
``utils/mathutil.py`` (MathUtils, SloppyMath's log-add, Viterbi,
TimeSeriesUtils). All host code: the same inputs give the same results,
floats equal to the last bit (the same numpy operations in the same order).
"""

import math

import numpy as np
import pytest

pytest.importorskip("torch")

import deeplearning4j_tpu as dj  # noqa: E402
from deeplearning4j_tpu.datasets.iterators import BucketingSequenceIterator as JBucketing  # noqa: E402
from deeplearning4j_tpu.utils import collections as jcol  # noqa: E402
from deeplearning4j_tpu.utils import mathutil as jmath  # noqa: E402

import deeplearning4j_tpu_torch as pt  # noqa: E402
from deeplearning4j_tpu_torch.utils import collections as pcol  # noqa: E402
from deeplearning4j_tpu_torch.utils import mathutil as pmath  # noqa: E402


# ------------------------------------------------------------ small names
def _confs():
    return {
        "dense": lambda pkg: pkg.MultiLayerConfiguration(
            layers=[pkg.DenseLayer(n_out=7), pkg.OutputLayer(n_out=3)],
            input_type=pkg.InputType.feed_forward(5)),
        "rnn": lambda pkg: pkg.MultiLayerConfiguration(
            layers=[pkg.GravesLSTM(n_out=9), pkg.RnnOutputLayer(n_out=4)],
            input_type=pkg.InputType.recurrent(6)),
        "cnn": lambda pkg: pkg.MultiLayerConfiguration(
            layers=[pkg.ConvolutionLayer(n_out=4, kernel=(3, 3)),
                    pkg.SubsamplingLayer(kernel=(2, 2), stride=(2, 2))],
            input_type=pkg.InputType.convolutional(10, 10, 2)),
    }


@pytest.mark.parametrize("name", ["dense", "rnn", "cnn"])
def test_output_type_matches_jax(name):
    jconf = _confs()[name](dj)
    pconf = pt.MultiLayerConfiguration.from_json(jconf.to_json())
    assert pconf.output_type().to_dict() == jconf.output_type().to_dict()


def _sequences(lengths, seed=0):
    rng = np.random.default_rng(seed)
    return [(rng.normal(size=(n, 3)).astype(np.float32),
             np.eye(2, dtype=np.float32)[rng.integers(0, 2, n)]) for n in lengths]


@pytest.mark.parametrize("lengths,batch,drop", [
    ((5, 9, 30, 31, 32, 70), 2, False),
    ((5, 9, 30, 31, 32, 70), 2, True),
    ((3, 3, 3, 40), 4, False),
    ((300, 1), 1, False),
])
def test_num_programs_matches_jax_and_bounds_the_shapes(lengths, batch, drop):
    seqs = _sequences(lengths)
    mine = pt.BucketingSequenceIterator(seqs, batch, drop_remainder=drop)
    theirs = JBucketing(seqs, batch, drop_remainder=drop)
    assert mine.num_programs() == theirs.num_programs()
    shapes = {(ds.features.shape, ds.labels.shape) for ds in mine}
    assert len(shapes) <= mine.num_programs()


# ------------------------------------------------------------ collections
def test_counter_and_counter_map_match_jax():
    for mod in (pcol, jcol):
        c = mod.Counter("aabbbc")
        assert c.arg_max() == "b" and c.total_count() == 6
    mine, theirs = pcol.Counter("aabbbcdd"), jcol.Counter("aabbbcdd")
    assert dict(mine.normalize()) == dict(theirs.normalize())
    assert dict(mine.keep_top_n(2)) == dict(theirs.keep_top_n(2))
    assert pcol.Counter().arg_max() is None
    maps = []
    for mod in (pcol, jcol):
        cm = mod.CounterMap()
        cm.increment_count("x", "y", 2.0)
        cm.increment_count("x", "z")
        cm.increment_count("w", "y", 0.5)
        assert cm.get_count("x", "y") == 2.0 and cm.get_count("q", "y") == 0.0
        assert cm.total_count() == 3.5
        cm.normalize()
        maps.append({k: dict(cm.get_counter(k)) for k in sorted(cm.keys())})
    assert maps[0] == maps[1]


def test_disk_based_queue_spills_and_keeps_order(tmp_path):
    q = pcol.DiskBasedQueue(memory_items=3, dir=str(tmp_path))
    for i in range(10):
        q.add({"i": i})
    assert len(q) == 10 and any(p.suffix == ".pkl" for p in tmp_path.iterdir())
    assert [q.poll()["i"] for _ in range(10)] == list(range(10))
    assert q.is_empty() and not list(tmp_path.iterdir())
    with pytest.raises(IndexError):
        q.poll()


def test_magic_queue_round_robin_as_jax():
    got = []
    for mod in (pcol, jcol):
        q = mod.MagicQueue(n_lanes=3)
        for i in range(7):
            q.add(i)
        got.append(([q.poll(lane) for lane in (0, 0, 1, 2, 2)], q.size(), q.n_lanes,
                    q.poll(2, timeout=0.01)))
    assert got[0] == got[1] == ([0, 3, 1, 2, 5], 2, 3, None)


# -------------------------------------------------------------- mathutil
def test_math_utils_match_jax():
    rng = np.random.default_rng(3)
    p = rng.dirichlet(np.ones(5)).tolist()
    x = rng.normal(size=17).tolist()
    for fn, args in [("sigmoid", (0.3,)), ("entropy", (p,)), ("ssum", (x,)),
                     ("sum_of_squares", (x,)), ("euclidean_distance", (x[:8], x[8:16])),
                     ("manhattan_distance", (x[:8], x[8:16])),
                     ("information_gain", (p, [(0.5, p[:2]), (0.5, p[2:])])),
                     ("log_add", (math.log(0.3), math.log(0.2))),
                     ("log_add", (-math.inf, -1.0)), ("log_add_all", ([-1.0, -2.0, -3.0],))]:
        assert getattr(pmath, fn)(*args) == getattr(jmath, fn)(*args), fn
    for n in (0, 1, 2, 3, 17, 64, 65):
        assert pmath.next_power_of_2(n) == jmath.next_power_of_2(n)
    np.testing.assert_array_equal(pmath.normalize(x, -1, 1), jmath.normalize(x, -1, 1))
    np.testing.assert_array_equal(pmath.normalize([2, 2]), jmath.normalize([2, 2]))


def test_viterbi_matches_jax():
    rng = np.random.default_rng(5)
    S, T = 4, 12
    ls = np.log(rng.dirichlet(np.ones(S)))
    lt = np.log(rng.dirichlet(np.ones(S), size=S))
    le = np.log(rng.dirichlet(np.ones(S), size=T))
    assert pmath.viterbi(ls, lt, le) == jmath.viterbi(ls, lt, le)
    path, score = pmath.viterbi(np.log([0.9, 0.1]), np.log([[0.9, 0.1], [0.1, 0.9]]),
                                np.log([[0.9, 0.1], [0.9, 0.1], [0.1, 0.9], [0.1, 0.9]]))
    assert path == [0, 0, 1, 1] and score < 0


@pytest.mark.parametrize("align_end", [False, True])
def test_time_series_utils_match_jax(align_end):
    x = np.arange(24, dtype=np.float32).reshape(2, 4, 3)
    mine, theirs = pmath.pad_time_series(x, 6, align_end=align_end), \
        jmath.pad_time_series(x, 6, align_end=align_end)
    for a, b in zip(mine, theirs):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(pmath.last_time_step(*mine), jmath.last_time_step(*theirs))
    np.testing.assert_array_equal(pmath.last_time_step(*mine), x[:, -1])
    np.testing.assert_array_equal(pmath.moving_average(np.arange(7.0), 3),
                                  jmath.moving_average(np.arange(7.0), 3))
    m = mine[1]
    np.testing.assert_array_equal(pmath.reshape_time_series_mask_to_vector(m),
                                  jmath.reshape_time_series_mask_to_vector(m))
    np.testing.assert_array_equal(
        pmath.reshape_vector_to_time_series_mask(m.reshape(-1, 1), 2),
        jmath.reshape_vector_to_time_series_mask(m.reshape(-1, 1), 2))
    with pytest.raises(ValueError):
        pmath.pad_time_series(x, 3)
