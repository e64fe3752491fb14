"""Minibatches for ``fit`` (counterpart of
``deeplearning4j_tpu/datasets/iterators.py``, its ``DataSet`` and
``as_iterator`` only).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable, Optional

import numpy as np


@dataclass
class DataSet:
    """Features + labels (+ masks) minibatch (reference: ND4J DataSet)."""

    features: np.ndarray
    labels: np.ndarray
    features_mask: Optional[np.ndarray] = None
    labels_mask: Optional[np.ndarray] = None

    def num_examples(self) -> int:
        return int(self.features.shape[0])


def as_iterator(data) -> Iterable[DataSet]:
    """Normalize fit() input: an (x, y) tuple or a DataSet becomes a
    one-batch list; anything else is taken as an iterable of DataSets or of
    (x, y) tuples."""
    if isinstance(data, DataSet):
        return [data]
    if isinstance(data, tuple) and len(data) == 2:
        return [DataSet(data[0], data[1])]
    return data
