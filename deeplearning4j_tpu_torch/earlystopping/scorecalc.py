"""Score calculators (counterpart of
``deeplearning4j_tpu/earlystopping/scorecalc.py``; reference:
earlystopping/scorecalc/DataSetLossCalculator.java)."""

from __future__ import annotations

from ..datasets.iterators import as_iterator


class ScoreCalculator:
    def calculate_score(self, net) -> float:
        raise NotImplementedError


class DataSetLossCalculator(ScoreCalculator):
    """Average loss over a dataset/iterator (reference:
    DataSetLossCalculator.java — average=true weights by examples)."""

    def __init__(self, data, average: bool = True):
        self.data = data
        self.average = average

    def calculate_score(self, net) -> float:
        total, n = 0.0, 0
        it = as_iterator(self.data)
        if hasattr(it, "reset"):
            it.reset()
        for ds in it:
            b = int(ds.features.shape[0]) if hasattr(ds, "features") else 1
            total += net.score(ds) * b
            n += b
        if n == 0:
            return float("nan")
        return total / n if self.average else total
