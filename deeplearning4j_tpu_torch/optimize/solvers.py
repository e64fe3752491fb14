"""Batch optimizers: Solver facade, line search, LBFGS, conjugate gradient
(counterpart of ``deeplearning4j_tpu/optimize/solvers.py``).

Reference (SURVEY.md §2.1 "Training loop (Solver)"): optimize/Solver.java
builds a ConvexOptimizer — StochasticGradientDescent.java:51-72 (the default,
covered by the networks' per-batch ``fit``), plus the line-search family:
LBFGS.java, ConjugateGradient.java, LineGradientDescent.java, all stepping
through BackTrackLineSearch.java (Armijo backtracking).

The objective is the net's loss on a fixed batch at ``train=False``; the
parameters flatten once into one f32 vector in ``jax.tree_util.tree_leaves``
order (the JAX package's ``ravel_pytree``); value and gradient are one
forward and backward on the net's device, with the vector written into the
params first; the optimizer logic (two-loop recursion, beta_PR, the Armijo
loop) runs on the host in numpy between device calls, as in the JAX
package.
"""

from __future__ import annotations

from typing import Callable, List, Tuple

import numpy as np
import torch


def back_track_line_search(
    f: Callable[[np.ndarray], float],
    x: np.ndarray,
    fx: float,
    grad: np.ndarray,
    direction: np.ndarray,
    initial_step: float = 1.0,
    c1: float = 1e-4,
    rho: float = 0.5,
    max_iterations: int = 20,
    min_step: float = 1e-12,
) -> Tuple[float, float]:
    """Armijo backtracking (reference: BackTrackLineSearch.optimize).

    Returns (step, f(x + step·direction)); step 0.0 when no decrease found.
    """
    slope = float(np.dot(grad, direction))
    if slope >= 0:
        return 0.0, fx  # not a descent direction
    step = initial_step
    for _ in range(max_iterations):
        fnew = f(x + step * direction)
        if np.isfinite(fnew) and fnew <= fx + c1 * step * slope:
            return step, float(fnew)
        step *= rho
        if step < min_step:
            break
    return 0.0, fx


class _BatchOptimizer:
    """Shared machinery: flatten params, value and gradient on a batch."""

    def __init__(self, max_iterations: int = 100, tolerance: float = 1e-5):
        self.max_iterations = int(max_iterations)
        self.tolerance = float(tolerance)
        self.score_history: List[float] = []

    @staticmethod
    def _flat_leaves(net) -> List[torch.Tensor]:
        return [layer[k] for layer in net._leaves() for k in sorted(layer)]

    def _setup(self, net, x, y):
        net.init()
        leaves = self._flat_leaves(net)
        sizes = [t.numel() for t in leaves]
        if hasattr(net.conf, "vertices"):
            xs = [net._input(a) for a in (x if isinstance(x, (list, tuple)) else [x])]
            ys = [net._labels(a) for a in (y if isinstance(y, (list, tuple)) else [y])]
            loss_of = lambda: net.loss_fn(xs, ys, train=False)  # noqa: E731
        else:
            xd, yd = net._input(x), net._labels(y)
            loss_of = lambda: net.loss_fn(xd, yd, train=False)  # noqa: E731

        def load(flat_np):
            flat = torch.from_numpy(np.asarray(flat_np, np.float32)).to(net.device)
            with torch.no_grad():
                for t, piece in zip(leaves, torch.split(flat, sizes)):
                    t.copy_(piece.reshape(t.shape))
            net._compute_params = None

        def value(flat_np):
            load(flat_np)
            with torch.no_grad():
                return float(loss_of())

        def value_grad(flat_np):
            load(flat_np)
            loss = loss_of()
            grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                        materialize_grads=True)
            gflat = torch.cat([g.reshape(-1).float() for g in grads])
            return float(loss.detach()), gflat.cpu().numpy().astype(np.float64)

        flat0 = torch.cat([t.detach().reshape(-1).float() for t in leaves])
        return flat0.cpu().numpy().astype(np.float64), sizes, value, value_grad

    def _finish(self, net, flat, sizes):
        """The net re-initialized from ``flat`` (as the JAX package's
        ``init(params=..., force=True)``: fresh updater and layer state)."""
        pieces = iter(np.split(np.asarray(flat, np.float32), np.cumsum(sizes)[:-1]))
        dicts = [{k: next(pieces).reshape(tuple(layer[k].shape)) for k in sorted(layer)}
                 for layer in net._leaves()]
        net.init(params=net._params_from_leaves(
            [{k: torch.from_numpy(d[k]) for k in layer} for d, layer in
             zip(dicts, net._leaves())]), force=True)

    def optimize(self, net, x, y) -> float:
        raise NotImplementedError


class LineGradientDescent(_BatchOptimizer):
    """Steepest descent + Armijo line search (reference: LineGradientDescent.java)."""

    def optimize(self, net, x, y) -> float:
        flat, sizes, value, value_grad = self._setup(net, x, y)
        fx, g = value_grad(flat)
        for _ in range(self.max_iterations):
            self.score_history.append(fx)
            step, fnew = back_track_line_search(value, flat, fx, g, -g)
            if step > 0.0 and fnew < fx:  # apply the final accepted step too
                flat = flat + step * (-g)
            if step == 0.0 or fx - fnew < self.tolerance:
                fx = min(fx, fnew)
                break
            fx, g = value_grad(flat)
        self._finish(net, flat, sizes)
        return fx


class ConjugateGradient(_BatchOptimizer):
    """Nonlinear CG, Polak-Ribière with automatic restart (reference:
    ConjugateGradient.java)."""

    def optimize(self, net, x, y) -> float:
        flat, sizes, value, value_grad = self._setup(net, x, y)
        fx, g = value_grad(flat)
        d = -g
        for _ in range(self.max_iterations):
            self.score_history.append(fx)
            step, fnew = back_track_line_search(value, flat, fx, g, d)
            if step > 0.0 and fnew < fx:  # apply the final accepted step too
                flat = flat + step * d
            if step == 0.0 or fx - fnew < self.tolerance:
                fx = min(fx, fnew)
                break
            fx, g_new = value_grad(flat)
            beta = float(np.dot(g_new, g_new - g) / max(np.dot(g, g), 1e-30))
            beta = max(beta, 0.0)  # PR+ restart
            d = -g_new + beta * d
            g = g_new
        self._finish(net, flat, sizes)
        return fx


class LBFGS(_BatchOptimizer):
    """Limited-memory BFGS, two-loop recursion (reference: LBFGS.java,
    default history m=4)."""

    def __init__(self, max_iterations: int = 100, tolerance: float = 1e-5,
                 m: int = 4):
        super().__init__(max_iterations, tolerance)
        self.m = int(m)

    def optimize(self, net, x, y) -> float:
        flat, sizes, value, value_grad = self._setup(net, x, y)
        fx, g = value_grad(flat)
        s_hist: List[np.ndarray] = []
        y_hist: List[np.ndarray] = []
        for it in range(self.max_iterations):
            self.score_history.append(fx)
            # two-loop recursion
            q = g.copy()
            alphas = []
            for s, yv in zip(reversed(s_hist), reversed(y_hist)):
                rho = 1.0 / max(np.dot(yv, s), 1e-30)
                a = rho * np.dot(s, q)
                alphas.append((a, rho, s, yv))
                q -= a * yv
            if y_hist:
                gamma = np.dot(s_hist[-1], y_hist[-1]) / max(
                    np.dot(y_hist[-1], y_hist[-1]), 1e-30
                )
                q *= gamma
            for a, rho, s, yv in reversed(alphas):
                b = rho * np.dot(yv, q)
                q += (a - b) * s
            d = -q
            step, fnew = back_track_line_search(
                value, flat, fx, g, d, initial_step=1.0 if it > 0 else min(
                    1.0, 1.0 / max(np.linalg.norm(g), 1e-30)
                ),
            )
            flat_new = flat + step * d
            if step == 0.0 or fx - fnew < self.tolerance:
                if step > 0.0 and fnew < fx:
                    flat = flat_new
                fx = min(fx, fnew)
                break
            fx, g_new = value_grad(flat_new)
            s_hist.append(flat_new - flat)
            y_hist.append(g_new - g)
            if len(s_hist) > self.m:
                s_hist.pop(0)
                y_hist.pop(0)
            flat, g = flat_new, g_new
        self._finish(net, flat, sizes)
        return fx


_OPTIMIZERS = {
    "lbfgs": LBFGS,
    "conjugate_gradient": ConjugateGradient,
    "line_gradient_descent": LineGradientDescent,
}


class Solver:
    """Facade (reference: optimize/Solver.java Builder): picks the
    ConvexOptimizer by algorithm name and runs it on a batch. The
    "stochastic_gradient_descent" algorithm is the networks' own per-batch
    optax path (fit()); this class covers the batch/line-search family."""

    def __init__(self, algorithm: str = "lbfgs", max_iterations: int = 100,
                 tolerance: float = 1e-5, **kwargs):
        if algorithm not in _OPTIMIZERS:
            raise ValueError(
                f"Unknown algorithm '{algorithm}'; available: "
                f"{sorted(_OPTIMIZERS)} (stochastic gradient descent = net.fit)"
            )
        self.optimizer = _OPTIMIZERS[algorithm](
            max_iterations=max_iterations, tolerance=tolerance, **kwargs
        )

    def optimize(self, net, data) -> float:
        from ..datasets.iterators import DataSet  # noqa: PLC0415

        if isinstance(data, tuple):
            data = DataSet(np.asarray(data[0]), np.asarray(data[1]))
        return self.optimizer.optimize(net, data.features, data.labels)

    @property
    def score_history(self) -> List[float]:
        return self.optimizer.score_history
