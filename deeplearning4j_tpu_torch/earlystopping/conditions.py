"""Termination conditions (counterpart of
``deeplearning4j_tpu/earlystopping/conditions.py``; reference:
earlystopping/termination/*.java)."""

from __future__ import annotations

import math
import time


class EpochTerminationCondition:
    """Checked after each epoch's score evaluation
    (reference: EpochTerminationCondition.java)."""

    def initialize(self) -> None:
        pass

    def terminate(self, epoch: int, score: float) -> bool:
        raise NotImplementedError


class IterationTerminationCondition:
    """Checked after every iteration (reference: IterationTerminationCondition.java)."""

    def initialize(self) -> None:
        pass

    def terminate(self, score: float) -> bool:
        raise NotImplementedError


class MaxEpochsTerminationCondition(EpochTerminationCondition):
    """Reference: MaxEpochsTerminationCondition.java."""

    def __init__(self, max_epochs: int):
        self.max_epochs = int(max_epochs)

    def terminate(self, epoch: int, score: float) -> bool:
        return epoch + 1 >= self.max_epochs

    def __str__(self):
        return f"MaxEpochsTerminationCondition({self.max_epochs})"


class ScoreImprovementEpochTerminationCondition(EpochTerminationCondition):
    """Stop when score hasn't improved in ``patience`` epochs (reference:
    ScoreImprovementEpochTerminationCondition.java; minImprovement added for
    tolerance)."""

    def __init__(self, patience: int, min_improvement: float = 0.0):
        self.patience = int(patience)
        self.min_improvement = float(min_improvement)
        self.best_score: float = math.inf
        self.best_epoch = -1

    def initialize(self) -> None:
        self.best_score = math.inf
        self.best_epoch = -1

    def terminate(self, epoch: int, score: float) -> bool:
        if score < self.best_score - self.min_improvement:
            self.best_score = score
            self.best_epoch = epoch
            return False
        return epoch - self.best_epoch >= self.patience

    def __str__(self):
        return f"ScoreImprovementEpochTerminationCondition(patience={self.patience})"


class BestScoreEpochTerminationCondition(EpochTerminationCondition):
    """Stop once score reaches a target value (reference:
    BestScoreEpochTerminationCondition.java)."""

    def __init__(self, best_expected_score: float):
        self.best_expected_score = float(best_expected_score)

    def terminate(self, epoch: int, score: float) -> bool:
        return score < self.best_expected_score

    def __str__(self):
        return f"BestScoreEpochTerminationCondition({self.best_expected_score})"


class MaxTimeIterationTerminationCondition(IterationTerminationCondition):
    """Wall-clock budget (reference: MaxTimeIterationTerminationCondition.java)."""

    def __init__(self, max_seconds: float):
        self.max_seconds = float(max_seconds)
        self._start = None

    def initialize(self) -> None:
        self._start = time.monotonic()

    def terminate(self, score: float) -> bool:
        if self._start is None:
            self._start = time.monotonic()
        return time.monotonic() - self._start > self.max_seconds

    def __str__(self):
        return f"MaxTimeIterationTerminationCondition({self.max_seconds}s)"


class MaxScoreIterationTerminationCondition(IterationTerminationCondition):
    """Stop if score exceeds a ceiling — divergence guard (reference:
    MaxScoreIterationTerminationCondition.java)."""

    def __init__(self, max_score: float):
        self.max_score = float(max_score)

    def terminate(self, score: float) -> bool:
        return score > self.max_score

    def __str__(self):
        return f"MaxScoreIterationTerminationCondition({self.max_score})"


class InvalidScoreIterationTerminationCondition(IterationTerminationCondition):
    """Stop on NaN/Inf score (reference:
    InvalidScoreIterationTerminationCondition.java — the reference's only
    failure-detection mechanism, SURVEY.md §5.3)."""

    def terminate(self, score: float) -> bool:
        return math.isnan(score) or math.isinf(score)

    def __str__(self):
        return "InvalidScoreIterationTerminationCondition()"
