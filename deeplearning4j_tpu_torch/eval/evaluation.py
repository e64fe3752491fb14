"""Classification evaluation: accuracy, precision, recall, F1 and the
confusion matrix (counterpart of ``deeplearning4j_tpu/eval/evaluation.py``).

A numpy copy of the JAX package's classes, its record-metadata attribution
included: ``eval`` given one ``RecordMetaData`` per example keeps a
``meta.Prediction`` for each, which ``prediction_errors`` and the
by-class queries return. Counts accumulate on the host over batches.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from .meta import Prediction


class ConfusionMatrix:
    """Counts[actual][predicted] (reference: eval/ConfusionMatrix.java)."""

    def __init__(self, n_classes: int):
        self.matrix = np.zeros((n_classes, n_classes), dtype=np.int64)

    def add(self, actual: np.ndarray, predicted: np.ndarray):
        np.add.at(self.matrix, (actual, predicted), 1)

    def get_count(self, actual: int, predicted: int) -> int:
        return int(self.matrix[actual, predicted])


class Evaluation:
    """Accumulating classification metrics (reference: eval/Evaluation.java)."""

    def __init__(self, n_classes: Optional[int] = None,
                 labels: Optional[List[str]] = None, top_n: int = 1):
        self.n_classes = n_classes
        self.label_names = labels
        self.confusion: Optional[ConfusionMatrix] = None
        self.examples = 0
        self.top_n = max(1, top_n)
        self.top_n_correct = 0
        self.predictions: List[Prediction] = []  # only where eval() had metadata

    def _ensure(self, n: int):
        if self.confusion is None:
            self.n_classes = self.n_classes or n
            self.confusion = ConfusionMatrix(self.n_classes)

    def eval(self, labels, predictions, record_metadata=None) -> None:
        """labels: one-hot [B, C] (or int [B]); predictions: probabilities or
        scores [B, C]. Row-argmax both into the confusion matrix; time-series
        [B, T, C] inputs are flattened over time. ``record_metadata``, one
        entry per example row, also records a ``Prediction`` each; a count
        that does not match raises before anything is counted."""
        labels = np.asarray(labels)
        predictions = np.asarray(predictions)
        if predictions.ndim == 3:
            predictions = predictions.reshape(-1, predictions.shape[-1])
            labels = labels.reshape(-1, labels.shape[-1]) if labels.ndim == 3 else labels
        self._ensure(predictions.shape[-1])
        pred_idx = predictions.argmax(-1)
        act_idx = labels.argmax(-1) if labels.ndim == 2 else labels.astype(np.int64)
        if record_metadata is not None and len(record_metadata) != len(pred_idx):
            raise ValueError(f"record_metadata has {len(record_metadata)} entries for "
                             f"{len(pred_idx)} examples")
        self.confusion.add(act_idx, pred_idx)
        self.examples += len(pred_idx)
        if record_metadata is not None:
            self.predictions.extend(Prediction(a, p, m) for a, p, m in
                                    zip(act_idx, pred_idx, record_metadata))
        if self.top_n > 1:
            k = min(self.top_n, predictions.shape[-1])
            topk = np.argpartition(predictions, -k, axis=-1)[:, -k:]
            self.top_n_correct += int((topk == act_idx[:, None]).any(-1).sum())

    def prediction_errors(self) -> List[Prediction]:
        """The misclassified examples with their provenance (reference:
        Evaluation.getPredictionErrors)."""
        return [p for p in self.predictions if not p.is_correct()]

    def predictions_by_actual_class(self, cls: int) -> List[Prediction]:
        return [p for p in self.predictions if p.actual_class == cls]

    def predictions_by_predicted_class(self, cls: int) -> List[Prediction]:
        return [p for p in self.predictions if p.predicted_class == cls]

    def _tp(self) -> np.ndarray:
        return np.diag(self.confusion.matrix)

    def accuracy(self) -> float:
        m = self.confusion.matrix
        return float(self._tp().sum() / max(m.sum(), 1))

    def top_n_accuracy(self) -> float:
        """Top-N accuracy; top-1 is :meth:`accuracy`."""
        if self.top_n <= 1:
            return self.accuracy()
        return self.top_n_correct / max(self.examples, 1)

    def precision(self, cls: Optional[int] = None) -> float:
        col = self.confusion.matrix.sum(axis=0)
        per = np.where(col > 0, self._tp() / np.maximum(col, 1), 0.0)
        if cls is not None:
            return float(per[cls])
        return float(per[col > 0].mean()) if (col > 0).any() else 0.0

    def recall(self, cls: Optional[int] = None) -> float:
        row = self.confusion.matrix.sum(axis=1)
        per = np.where(row > 0, self._tp() / np.maximum(row, 1), 0.0)
        if cls is not None:
            return float(per[cls])
        return float(per[row > 0].mean()) if (row > 0).any() else 0.0

    def f1(self, cls: Optional[int] = None) -> float:
        p = self.precision(cls)
        r = self.recall(cls)
        return 2 * p * r / (p + r) if (p + r) > 0 else 0.0

    def false_positive_rate(self, cls: int) -> float:
        m = self.confusion.matrix
        fp = m[:, cls].sum() - m[cls, cls]
        tn = m.sum() - m[cls, :].sum() - m[:, cls].sum() + m[cls, cls]
        return float(fp / max(fp + tn, 1))

    def _label(self, cls: int) -> str:
        if self.label_names and cls < len(self.label_names):
            return self.label_names[cls]
        return str(cls)

    def stats(self) -> str:
        """Printable summary with the per-class breakdown (reference:
        Evaluation.stats)."""
        lines = [
            "========================Evaluation Metrics========================",
            f" # of classes:    {self.n_classes}",
            f" Examples:        {self.examples}",
            f" Accuracy:        {self.accuracy():.4f}",
            f" Precision:       {self.precision():.4f}",
            f" Recall:          {self.recall():.4f}",
            f" F1 Score:        {self.f1():.4f}",
            "",
            "Per-class:  label          precision  recall   f1      count",
        ]
        m = self.confusion.matrix
        tp = np.diag(m).astype(np.float64)
        col = m.sum(axis=0)
        row = m.sum(axis=1)
        prec = np.where(col > 0, tp / np.maximum(col, 1), 0.0)
        rec = np.where(row > 0, tp / np.maximum(row, 1), 0.0)
        denom = prec + rec
        f1s = np.where(denom > 0, 2 * prec * rec / np.maximum(denom, 1e-300), 0.0)
        for c in range(self.n_classes or 0):
            lines.append(f"            {self._label(c):<14} {prec[c]:<9.4f} "
                         f"{rec[c]:<8.4f} {f1s[c]:<7.4f} {int(row[c])}")
        lines += [
            "",
            "=========================Confusion Matrix=========================",
            str(self.confusion.matrix),
            "==================================================================",
        ]
        return "\n".join(lines)
