"""t-SNE: exact (on the card) and Barnes-Hut (SPTree on the host)
(counterpart of ``deeplearning4j_tpu/plot/tsne.py``).

Reference: deeplearning4j-core plot/Tsne.java (exact) and
plot/BarnesHutTsne.java:64 (theta approximation). The exact variant runs on
the card as plain torch: the input affinities (squared distances, then
the perplexity search vectorized over all rows, in float64
whatever the step's dtype, as the JAX package's numpy does) and every
iteration's step (the [N, N] Student-t kernel, the gradient as one matmul,
gains and momentum). It keeps the JAX package's numpy-seeded start, its
momentum switch, early-exaggeration schedule and gains rule (``sign(0)`` is
0 in both). The step's dtype is explicit: ``dtype=torch.float32`` by
default (the JAX package computes in f32 outside its tests, where x64 is
off) or ``torch.float64`` (what its tests compute under x64). The JAX
package forms all [N, N, D] differences at once on the host (25 GB at
N=2,500 and D=500); here the squared distances come from one matmul
(:func:`squared_distances`). Barnes-Hut keeps the reference's
O(N log N) host tree walk over the port's ``SPTree`` and the JAX package's
numpy throughout.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..nn.multilayer import resolve_device


def _binary_search_perplexity(d2: np.ndarray, perplexity: float,
                              tol: float = 1e-5, max_iter: int = 50) -> np.ndarray:
    """Row-wise beta search so each row's entropy == log(perplexity).
    d2: [N, M] squared distances (self excluded / inf). Returns P [N, M].
    The JAX package's numpy, kept for Barnes-Hut's host path, whose answers
    it keeps bit for bit (the t-SNE step is chaotic: a rounding apart
    parts the embeddings within 25 iterations)."""
    n = d2.shape[0]
    beta = np.ones(n)
    beta_min = np.full(n, -np.inf)
    beta_max = np.full(n, np.inf)
    log_u = np.log(perplexity)
    p = np.zeros_like(d2)
    finite = np.isfinite(d2)
    d2f = np.where(finite, d2, 0.0)  # excluded entries get p=0 via the mask
    for _ in range(max_iter):
        p = np.exp(-d2f * beta[:, None]) * finite
        sum_p = np.maximum(p.sum(1), 1e-12)
        h = np.log(sum_p) + beta * (d2f * p).sum(1) / sum_p
        diff = h - log_u
        done = np.abs(diff) < tol
        if done.all():
            break
        hi = diff > 0  # entropy too high -> increase beta
        beta_min = np.where(hi, beta, beta_min)
        beta_max = np.where(~hi, beta, beta_max)
        beta = np.where(
            hi,
            np.where(np.isinf(beta_max), beta * 2, (beta + beta_max) / 2),
            np.where(np.isinf(beta_min), beta / 2, (beta + beta_min) / 2),
        )
    return p / np.maximum(p.sum(1, keepdims=True), 1e-12)


def _binary_search_perplexity_torch(d2: torch.Tensor, perplexity: float,
                                    tol: float = 1e-5, max_iter: int = 50) -> torch.Tensor:
    """:func:`_binary_search_perplexity` in torch, on ``d2``'s device and
    dtype (one host read an iteration: whether every row is done)."""
    n = d2.shape[0]
    beta = torch.ones(n, dtype=d2.dtype, device=d2.device)
    beta_min = torch.full_like(beta, -np.inf)
    beta_max = torch.full_like(beta, np.inf)
    log_u = float(np.log(perplexity))
    finite = torch.isfinite(d2)
    d2f = torch.where(finite, d2, torch.zeros((), dtype=d2.dtype, device=d2.device))
    p = torch.zeros_like(d2)
    for _ in range(max_iter):
        p = torch.exp(-d2f * beta[:, None]) * finite
        sum_p = p.sum(1).clamp_min(1e-12)
        h = torch.log(sum_p) + beta * (d2f * p).sum(1) / sum_p
        diff = h - log_u
        if bool((diff.abs() < tol).all()):
            break
        hi = diff > 0  # entropy too high -> increase beta
        beta_min = torch.where(hi, beta, beta_min)
        beta_max = torch.where(~hi, beta, beta_max)
        beta = torch.where(
            hi,
            torch.where(torch.isinf(beta_max), beta * 2, (beta + beta_max) / 2),
            torch.where(torch.isinf(beta_min), beta / 2, (beta + beta_min) / 2),
        )
    return p / p.sum(1, keepdim=True).clamp_min(1e-12)


def squared_distances(x: torch.Tensor) -> torch.Tensor:
    """[N, N] squared distances of the rows of ``x`` (float64), as
    |a|^2 + |b|^2 - 2 a.b over the rows centered on their mean (one matmul;
    the centering keeps the cancellation at rounding level, 1e-15 relative
    in float64 where the JAX package sums the differences' squares), exact
    zeros on the diagonal."""
    xc = x - x.mean(0)
    sq = (xc * xc).sum(1)
    d2 = (sq[:, None] + sq[None] - 2.0 * (xc @ xc.T)).clamp_min(0.0)
    d2.fill_diagonal_(0.0)
    return d2


class Tsne:
    """Exact t-SNE (reference: plot/Tsne.java — maxIter, perplexity,
    learningRate, momentum switch at iteration 250, early exaggeration).
    ``device`` defaults to the card (without CUDA it raises unless
    ``device="cpu"``); ``dtype`` is the step's."""

    def __init__(self, n_components: int = 2, perplexity: float = 30.0,
                 max_iter: int = 500, learning_rate: float = 200.0,
                 initial_momentum: float = 0.5, final_momentum: float = 0.8,
                 momentum_switch: int = 250, early_exaggeration: float = 12.0,
                 stop_lying_iteration: int = 100, seed: int = 0, device="cuda",
                 dtype: torch.dtype = torch.float32):
        self.n_components = n_components
        self.perplexity = perplexity
        self.max_iter = max_iter
        self.learning_rate = learning_rate
        self.initial_momentum = initial_momentum
        self.final_momentum = final_momentum
        self.momentum_switch = momentum_switch
        self.early_exaggeration = early_exaggeration
        self.stop_lying_iteration = stop_lying_iteration
        self.seed = seed
        self.device = resolve_device(device)
        self.dtype = dtype
        self.embedding_: Optional[np.ndarray] = None

    def _joint_p(self, x: torch.Tensor) -> torch.Tensor:
        """Symmetric joint affinities [N, N] of float64 rows ``x``."""
        d2 = squared_distances(x)
        d2.fill_diagonal_(np.inf)
        p = _binary_search_perplexity_torch(d2, self.perplexity)
        p = (p + p.T) / (2 * p.shape[0])
        return p.clamp_min(1e-12)

    def _step(self, y, vel, gains, p, momentum: float):
        """One iteration: (new y centered, velocity, gains)."""
        d2 = ((y[:, None, :] - y[None]) ** 2).sum(-1)
        num = 1.0 / (1.0 + d2)
        num.fill_diagonal_(0.0)
        q = (num / num.sum()).clamp_min(1e-12)
        pq = (p - q) * num  # [N, N]
        grad = 4.0 * (torch.diag(pq.sum(1)) - pq) @ y
        gains = torch.where(torch.sign(grad) != torch.sign(vel), gains + 0.2, gains * 0.8)
        gains = gains.clamp_min(0.01)
        vel = momentum * vel - self.learning_rate * gains * grad
        y = y + vel
        return y - y.mean(0), vel, gains

    def fit_transform(self, x) -> np.ndarray:
        x = torch.as_tensor(np.asarray(x, np.float64), device=self.device)
        n = x.shape[0]
        p = self._joint_p(x).to(self.dtype)
        rng = np.random.default_rng(self.seed)
        y = torch.as_tensor(rng.normal(scale=1e-4, size=(n, self.n_components)),
                            device=self.device).to(self.dtype)
        vel = torch.zeros_like(y)
        gains = torch.ones_like(y)
        p_lying = p * self.early_exaggeration
        for it in range(self.max_iter):
            momentum = (self.initial_momentum if it < self.momentum_switch
                        else self.final_momentum)
            y, vel, gains = self._step(y, vel, gains,
                                       p_lying if it < self.stop_lying_iteration else p,
                                       momentum)
        self.embedding_ = y.cpu().numpy()
        return self.embedding_


class BarnesHutTsne(Tsne):
    """Barnes-Hut t-SNE (reference: plot/BarnesHutTsne.java — theta-approx,
    VPTree kNN input similarities, SPTree repulsive forces), on the host;
    inputs too small for the sparse approximation take the exact path on
    ``device``."""

    def __init__(self, theta: float = 0.5, **kwargs):
        kwargs.setdefault("max_iter", 300)
        super().__init__(**kwargs)
        self.theta = theta

    def _knn_p(self, x: np.ndarray) -> tuple:
        from ..clustering.trees import VPTree  # noqa: PLC0415

        n = x.shape[0]
        k = min(int(3 * self.perplexity) + 1, n - 1)
        tree = VPTree(x)
        d2 = np.zeros((n, k))
        neighbor_idx = np.zeros((n, k), int)
        for i in range(n):
            nbrs = [t for t in tree.knn(x[i], k + 1) if t[0] != i][:k]
            neighbor_idx[i] = [t[0] for t in nbrs]
            d2[i] = [t[1] ** 2 for t in nbrs]
        p = _binary_search_perplexity(d2, self.perplexity)
        return neighbor_idx, p

    def fit_transform(self, x) -> np.ndarray:
        x = np.asarray(x, np.float64)
        n = x.shape[0]
        if n - 1 <= int(3 * self.perplexity):
            # too small for the sparse approximation; exact is cheap here
            return super().fit_transform(x)
        from ..clustering.trees import SPTree  # noqa: PLC0415

        neighbor_idx, p_cond = self._knn_p(x)
        # symmetrize the sparse P
        p_sym: dict = {}
        for i in range(n):
            for jpos, j in enumerate(neighbor_idx[i]):
                key = (min(i, j), max(i, j))
                p_sym[key] = p_sym.get(key, 0.0) + p_cond[i, jpos]
        pairs = np.array(list(p_sym.keys()), int)
        pvals = np.array(list(p_sym.values())) / (2 * n)
        pvals = np.maximum(pvals, 1e-12)

        rng = np.random.default_rng(self.seed)
        y = rng.normal(scale=1e-4, size=(n, self.n_components))
        vel = np.zeros_like(y)
        gains = np.ones_like(y)

        for it in range(self.max_iter):
            exag = self.early_exaggeration if it < self.stop_lying_iteration else 1.0
            momentum = (
                self.initial_momentum if it < self.momentum_switch
                else self.final_momentum
            )
            # attractive (sparse, vectorized over edges)
            diff = y[pairs[:, 0]] - y[pairs[:, 1]]
            w = 1.0 / (1.0 + (diff**2).sum(1))
            f = (exag * pvals * w)[:, None] * diff
            attr = np.zeros_like(y)
            np.add.at(attr, pairs[:, 0], f)
            np.add.at(attr, pairs[:, 1], -f)
            # repulsive via SPTree
            tree = SPTree(y)
            rep = np.zeros_like(y)
            z_total = 0.0
            for i in range(n):
                neg, z = tree.compute_non_edge_forces(i, self.theta)
                rep[i] = neg
                z_total += z
            grad = attr - rep / max(z_total, 1e-12)
            gains = np.where(np.sign(grad) != np.sign(vel), gains + 0.2, gains * 0.8)
            gains = np.maximum(gains, 0.01)
            vel = momentum * vel - self.learning_rate * gains * grad
            y = y + vel
            y -= y.mean(0)
        self.embedding_ = y
        return y
