"""KMeans clustering (counterpart of ``deeplearning4j_tpu/clustering/
kmeans.py``).

Reference: deeplearning4j-core clustering/kmeans/KMeansClustering.java.
kmeans++ seeding on the host in numpy (the JAX package's code, so the
starting centers are JAX's for the same seed), then Lloyd iterations on the
card as plain torch: the [N, K] distances (one matmul for the cross term),
the assignment (``torch.argmin`` takes the first minimum, as
``jnp.argmin`` does) and the one-hot centroid update (a second matmul). One
host read per iteration: the inertia, for the convergence test.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..nn.multilayer import resolve_device


class KMeansClustering:
    """``device`` defaults to the card; without CUDA it raises unless
    ``device="cpu"``."""

    def __init__(self, k: int, max_iterations: int = 100, tol: float = 1e-6,
                 seed: int = 0, distance: str = "euclidean", device="cuda"):
        if distance not in ("euclidean", "cosine"):
            raise ValueError(f"unsupported distance '{distance}'")
        self.k = int(k)
        self.max_iterations = max_iterations
        self.tol = tol
        self.seed = seed
        self.distance = distance
        self.device = resolve_device(device)
        self.cluster_centers_: Optional[np.ndarray] = None
        self.labels_: Optional[np.ndarray] = None
        self.inertia_: float = float("nan")
        self.n_iter_ = 0

    def _init_centers(self, x: np.ndarray) -> np.ndarray:
        """kmeans++ seeding."""
        rng = np.random.default_rng(self.seed)
        n = x.shape[0]
        centers = [x[rng.integers(n)]]
        for _ in range(1, self.k):
            d2 = np.min(
                ((x[:, None, :] - np.asarray(centers)[None]) ** 2).sum(-1), axis=1
            )
            probs = d2 / max(d2.sum(), 1e-12)
            centers.append(x[rng.choice(n, p=probs)])
        return np.asarray(centers)

    def _step(self, xd: torch.Tensor, xn: Optional[torch.Tensor],
              centers: torch.Tensor):
        """(new centers, assignments, inertia) of one Lloyd iteration."""
        if self.distance == "euclidean":
            # ||x-c||^2 expanded: the cross term is one [N, K] matmul
            d = ((xd * xd).sum(1)[:, None] - 2.0 * xd @ centers.T
                 + (centers * centers).sum(1)[None])
        else:
            cn = centers / torch.linalg.norm(centers, dim=1, keepdim=True).clamp_min(1e-12)
            d = 1.0 - xn @ cn.T
        assign = torch.argmin(d, dim=1)
        onehot = torch.nn.functional.one_hot(assign, self.k).to(xd.dtype)  # [N, K]
        sums = onehot.T @ xd  # [K, D]
        counts = onehot.sum(0)[:, None]
        new_centers = torch.where(counts > 0, sums / counts.clamp_min(1.0), centers)
        inertia = d.min(dim=1).values.sum()
        return new_centers, assign, inertia

    def fit(self, points) -> "KMeansClustering":
        x = np.asarray(points, np.float32)
        if x.shape[0] < self.k:
            raise ValueError(f"need >= k={self.k} points, got {x.shape[0]}")
        centers = torch.as_tensor(self._init_centers(x), dtype=torch.float32,
                                  device=self.device)
        xd = torch.as_tensor(x, device=self.device)
        xn = None
        if self.distance == "cosine":
            xn = xd / torch.linalg.norm(xd, dim=1, keepdim=True).clamp_min(1e-12)
        prev_inertia = np.inf
        self.n_iter_ = 0
        for _ in range(self.max_iterations):
            centers, assign, inertia = self._step(xd, xn, centers)
            self.n_iter_ += 1
            inertia = float(inertia)
            if abs(prev_inertia - inertia) < self.tol * max(abs(prev_inertia), 1.0):
                break
            prev_inertia = inertia
        self.cluster_centers_ = centers.cpu().numpy()
        self.labels_ = assign.cpu().numpy()
        self.inertia_ = inertia
        return self

    def predict(self, points) -> np.ndarray:
        x = np.asarray(points, np.float32)
        if self.distance == "euclidean":
            d = ((x[:, None, :] - self.cluster_centers_[None]) ** 2).sum(-1)
        else:
            xn = x / np.maximum(np.linalg.norm(x, axis=1, keepdims=True), 1e-12)
            cn = self.cluster_centers_ / np.maximum(
                np.linalg.norm(self.cluster_centers_, axis=1, keepdims=True), 1e-12
            )
            d = 1.0 - xn @ cn.T
        return d.argmin(1)
