"""Thresholded ROC and AUC, binary and one-vs-all multi-class (counterpart
of ``deeplearning4j_tpu/eval/roc.py``; reference: eval/ROC.java,
eval/ROCMultiClass.java): ``threshold_steps + 1`` thresholds from 0 to 1,
TP/FP/TN/FN counted at all of them at once, trapezoidal AUC.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np


class ROC:
    """Binary ROC. ``eval`` accepts labels/probabilities as [N] (probability of
    class 1) or [N, 2] one-hot/softmax (reference ROC.eval handles both)."""

    def __init__(self, threshold_steps: int = 30):
        self.threshold_steps = int(threshold_steps)
        # thresholds 0, 1/steps, ..., 1 inclusive (reference: ROC.java init)
        self.thresholds = np.linspace(0.0, 1.0, self.threshold_steps + 1)
        self.tp = np.zeros_like(self.thresholds, dtype=np.int64)
        self.fp = np.zeros_like(self.tp)
        self.tn = np.zeros_like(self.tp)
        self.fn = np.zeros_like(self.tp)
        self.count = 0

    @staticmethod
    def _to_binary(arr) -> np.ndarray:
        arr = np.asarray(arr, dtype=np.float64)
        if arr.ndim == 2 and arr.shape[1] == 2:
            return arr[:, 1]
        if arr.ndim == 2 and arr.shape[1] == 1:
            return arr[:, 0]
        if arr.ndim == 1:
            return arr
        raise ValueError(f"ROC needs binary labels/probs; got shape {arr.shape}")

    def eval(self, labels, probabilities) -> None:
        y = self._to_binary(labels) > 0.5
        p = self._to_binary(probabilities)
        self.count += y.size
        # predicted positive at threshold t: p >= t  ([N, T] comparison)
        pred_pos = p[:, None] >= self.thresholds[None, :]
        pos = y[:, None]
        self.tp += (pred_pos & pos).sum(axis=0)
        self.fp += (pred_pos & ~pos).sum(axis=0)
        self.fn += (~pred_pos & pos).sum(axis=0)
        self.tn += (~pred_pos & ~pos).sum(axis=0)

    def get_results(self) -> List[Tuple[float, float, float]]:
        """[(threshold, fpr, tpr)] (reference: ROC.getResults)."""
        with np.errstate(invalid="ignore", divide="ignore"):
            tpr = np.where(self.tp + self.fn > 0, self.tp / np.maximum(self.tp + self.fn, 1), 0.0)
            fpr = np.where(self.fp + self.tn > 0, self.fp / np.maximum(self.fp + self.tn, 1), 0.0)
        return list(zip(self.thresholds.tolist(), fpr.tolist(), tpr.tolist()))

    def calculate_auc(self) -> float:
        """Trapezoidal AUC over the ROC points (reference: ROC.calculateAUC)."""
        pts = self.get_results()
        # sort by fpr ascending (thresholds descending ≈ fpr ascending)
        curve = sorted([(f, t) for _, f, t in pts] + [(0.0, 0.0), (1.0, 1.0)])
        auc = 0.0
        for (x0, y0), (x1, y1) in zip(curve[:-1], curve[1:]):
            auc += (x1 - x0) * (y0 + y1) / 2.0
        return float(auc)


class ROCMultiClass:
    """One-vs-all ROC per class (reference: eval/ROCMultiClass.java)."""

    def __init__(self, threshold_steps: int = 30):
        self.threshold_steps = threshold_steps
        self._per_class: Dict[int, ROC] = {}

    def eval(self, labels, probabilities) -> None:
        labels = np.asarray(labels)
        probabilities = np.asarray(probabilities)
        if labels.ndim != 2:
            raise ValueError("ROCMultiClass needs one-hot [N, C] labels")
        for c in range(labels.shape[1]):
            roc = self._per_class.setdefault(c, ROC(self.threshold_steps))
            roc.eval(labels[:, c], probabilities[:, c])

    def calculate_auc(self, cls: int) -> float:
        return self._per_class[cls].calculate_auc()

    def calculate_average_auc(self) -> float:
        if not self._per_class:
            return float("nan")
        return float(np.mean([r.calculate_auc() for r in self._per_class.values()]))

    def get_results(self, cls: int):
        return self._per_class[cls].get_results()
