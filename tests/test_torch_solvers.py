"""The port's batch solvers (``deeplearning4j_tpu_torch/optimize/
solvers.py``) against the JAX package's on the Iris MLP.

The Iris pin's MLP (``chip_smoke.real_data_models()["iris"]``) starts from
JAX's params (x64 off, f32) in both packages, and ``Solver("lbfgs")``,
``"conjugate_gradient"`` and ``"line_gradient_descent"`` each run on the
full set of 150 (the port's bundled ``iris.csv``). Value and gradient come
from one f32 forward and backward in each package, summed in other orders,
and the host logic runs in float64 in both. Over the first 10 iterations
the two paths agree within 2e-6 relative (LBFGS's curvature pairs amplify
a rounding apart later: by iteration 25 its scores drift 4% apart, both
right), so the comparison runs 10 iterations: the final score and the
score history at 1e-4 relative, the params at 1e-3 absolute. A longer run
is held by its score falling.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import chip_smoke  # noqa: E402
import deeplearning4j_tpu as dj  # noqa: E402
from deeplearning4j_tpu.runtime import inference as jax_inference  # noqa: E402
from deeplearning4j_tpu.datasets.iterators import DataSet as JaxDataSet  # noqa: E402
from deeplearning4j_tpu.ops import kernel_select  # noqa: E402
from deeplearning4j_tpu.optimize import solvers as jsol  # noqa: E402

import deeplearning4j_tpu_torch as pt  # noqa: E402
from deeplearning4j_tpu_torch.datasets.fetchers import load_iris  # noqa: E402
from deeplearning4j_tpu_torch.optimize import solvers as psol  # noqa: E402

SCORE_REL, HISTORY_REL, PARAM_ATOL = 1e-4, 1e-4, 1e-3
ITERATIONS = 10


@pytest.fixture(autouse=True)
def jax_env(monkeypatch, tmp_path):
    monkeypatch.setattr(jax_inference, "fast_path_enabled", lambda: False)
    monkeypatch.setenv("DL4JTPU_KERNEL_CALIBRATION", str(tmp_path / "calibration.json"))
    kernel_select.reset()
    yield
    kernel_select.reset()


def _iris():
    x, y = load_iris()
    return x, np.eye(3, dtype=np.float32)[y]


def _pair():
    conf = chip_smoke.real_data_models()["iris"][1]
    with jax.enable_x64(False):
        jnet = dj.MultiLayerNetwork(dj.MultiLayerConfiguration.from_json(conf.to_json())).init()
        jnet.init(params=jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float32),
                                                jnet.params), force=True)
    host = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), jnet.params)
    return jnet, pt.load_jax_params(pt.MultiLayerNetwork(conf, device="cpu"), host)


@pytest.mark.parametrize("algorithm", ["lbfgs", "conjugate_gradient", "line_gradient_descent"])
def test_solver_follows_jax_on_iris(algorithm):
    x, y = _iris()
    jnet, pnet = _pair()
    start = pnet.score(pt.DataSet(x, y))
    with jax.enable_x64(False):
        js = jsol.Solver(algorithm, max_iterations=ITERATIONS)
        jscore = js.optimize(jnet, JaxDataSet(x, y))
    ps = psol.Solver(algorithm, max_iterations=ITERATIONS)
    pscore = ps.optimize(pnet, (x, y))
    assert pscore < start
    np.testing.assert_allclose(pscore, jscore, rtol=SCORE_REL)
    assert len(ps.score_history) == len(js.score_history)
    np.testing.assert_allclose(ps.score_history, js.score_history, rtol=HISTORY_REL)
    for jp, pp in zip(jnet.params, pt.params_to_numpy(pnet)):
        for k in jp:
            np.testing.assert_allclose(pp[k], np.asarray(jp[k]), atol=PARAM_ATOL, err_msg=k)
    # the net holds the solution: its score is the solver's
    assert pnet.score(pt.DataSet(x, y)) == pytest.approx(pscore, rel=1e-6)
    assert pnet.iteration == 0  # re-initialized from the solution, as JAX's init(force)


def test_solver_raises_on_an_unknown_algorithm():
    with pytest.raises(ValueError, match="Unknown algorithm 'sgd'"):
        psol.Solver("sgd")


def test_back_track_line_search_matches_jax():
    """The Armijo search is numpy on the host in both packages: the same
    steps and values on a quadratic, a non-descent direction and a
    function that is never lower."""
    a = np.diag([1.0, 10.0])
    f = lambda v: float(0.5 * v @ a @ v)  # noqa: E731
    x = np.array([1.0, 1.0])
    g = a @ x
    for d in (-g, g, -g * 1e-14):
        assert psol.back_track_line_search(f, x, f(x), g, d) == jsol.back_track_line_search(
            f, x, f(x), g, d)
    assert psol.back_track_line_search(lambda v: np.inf, x, 1.0, g, -g) == (0.0, 1.0)


def test_lbfgs_beats_steepest_descent_and_keeps_falling():
    """From the same weights, LBFGS with m=2 reaches a lower score than
    steepest descent in 10 iterations; run to 40, its score history never
    rises (the line search accepts only a decrease)."""
    x, y = _iris()
    scores = {}
    for algorithm in ("lbfgs", "line_gradient_descent"):
        _, pnet = _pair()
        s = psol.Solver(algorithm, max_iterations=10, m=2) if algorithm == "lbfgs" else \
            psol.Solver(algorithm, max_iterations=10)
        scores[algorithm] = s.optimize(pnet, pt.DataSet(x, y))
    assert scores["lbfgs"] < scores["line_gradient_descent"]
    _, pnet = _pair()
    long = psol.Solver("lbfgs", max_iterations=40)
    final = long.optimize(pnet, pt.DataSet(x, y))
    hist = long.score_history
    assert all(b <= a for a, b in zip(hist, hist[1:])) and final <= hist[-1]
