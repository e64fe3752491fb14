"""Regression metrics per output column (counterpart of
``deeplearning4j_tpu/eval/regression.py``; reference:
eval/RegressionEvaluation.java): MSE, MAE, RMSE, relative squared error and
Pearson's R, accumulated over batches as running sums in float64.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np


class RegressionEvaluation:
    """Per-column metrics accumulated over batches (reference:
    RegressionEvaluation.java); ``eval`` takes [N], [N, C] or [B, T, C]
    labels and predictions, the last with an optional [B, T] mask."""

    def __init__(self, column_names: Optional[Sequence[str]] = None, precision: int = 5):
        self.column_names = list(column_names) if column_names else None
        self.precision = precision
        self._n = 0
        self._sum_err_sq = None  # Σ(y-ŷ)²  per column
        self._sum_abs_err = None  # Σ|y-ŷ|
        self._sum_y = None
        self._sum_y_sq = None
        self._sum_p = None
        self._sum_p_sq = None
        self._sum_yp = None

    def _ensure(self, cols: int):
        if self._sum_err_sq is None:
            z = lambda: np.zeros(cols, dtype=np.float64)
            self._sum_err_sq, self._sum_abs_err = z(), z()
            self._sum_y, self._sum_y_sq = z(), z()
            self._sum_p, self._sum_p_sq, self._sum_yp = z(), z(), z()
            if self.column_names is None:
                self.column_names = [f"col_{i}" for i in range(cols)]

    def eval(self, labels, predictions, mask=None) -> None:
        y = np.asarray(labels, dtype=np.float64)
        p = np.asarray(predictions, dtype=np.float64)
        if y.ndim == 1:
            y, p = y[:, None], p[:, None]
        if y.ndim == 3:  # [B, T, C] time series -> flatten time into batch
            y, p = y.reshape(-1, y.shape[-1]), p.reshape(-1, p.shape[-1])
            if mask is not None:
                mask = np.asarray(mask).reshape(-1)
        if mask is not None:
            keep = np.asarray(mask).astype(bool)
            y, p = y[keep], p[keep]
        self._ensure(y.shape[1])
        err = y - p
        self._n += y.shape[0]
        self._sum_err_sq += (err**2).sum(axis=0)
        self._sum_abs_err += np.abs(err).sum(axis=0)
        self._sum_y += y.sum(axis=0)
        self._sum_y_sq += (y**2).sum(axis=0)
        self._sum_p += p.sum(axis=0)
        self._sum_p_sq += (p**2).sum(axis=0)
        self._sum_yp += (y * p).sum(axis=0)

    def num_columns(self) -> int:
        return 0 if self._sum_err_sq is None else len(self._sum_err_sq)

    def mean_squared_error(self, col: int) -> float:
        return float(self._sum_err_sq[col] / self._n)

    def mean_absolute_error(self, col: int) -> float:
        return float(self._sum_abs_err[col] / self._n)

    def root_mean_squared_error(self, col: int) -> float:
        return float(np.sqrt(self.mean_squared_error(col)))

    def relative_squared_error(self, col: int) -> float:
        """Σ(y-ŷ)² / Σ(y-ȳ)² (reference: RegressionEvaluation.relativeSquaredError)."""
        mean_y = self._sum_y[col] / self._n
        denom = self._sum_y_sq[col] - self._n * mean_y**2
        return float(self._sum_err_sq[col] / denom) if denom != 0 else float("nan")

    def correlation_r2(self, col: int) -> float:
        """Pearson correlation coefficient (reference: correlationR2)."""
        n = self._n
        num = n * self._sum_yp[col] - self._sum_y[col] * self._sum_p[col]
        den_y = n * self._sum_y_sq[col] - self._sum_y[col] ** 2
        den_p = n * self._sum_p_sq[col] - self._sum_p[col] ** 2
        den = np.sqrt(den_y * den_p)
        return float(num / den) if den != 0 else float("nan")

    def average_mean_squared_error(self) -> float:
        return float(np.mean([self.mean_squared_error(i) for i in range(self.num_columns())]))

    def average_mean_absolute_error(self) -> float:
        return float(np.mean([self.mean_absolute_error(i) for i in range(self.num_columns())]))

    def stats(self) -> str:
        lines = [
            f"{'Column':<16}{'MSE':>12}{'MAE':>12}{'RMSE':>12}{'RSE':>12}{'R':>12}"
        ]
        for i, name in enumerate(self.column_names or []):
            lines.append(
                f"{name:<16}{self.mean_squared_error(i):>12.{self.precision}f}"
                f"{self.mean_absolute_error(i):>12.{self.precision}f}"
                f"{self.root_mean_squared_error(i):>12.{self.precision}f}"
                f"{self.relative_squared_error(i):>12.{self.precision}f}"
                f"{self.correlation_r2(i):>12.{self.precision}f}"
            )
        return "\n".join(lines)
