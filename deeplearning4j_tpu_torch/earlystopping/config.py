"""EarlyStoppingConfiguration and its result (counterpart of
``deeplearning4j_tpu/earlystopping/config.py``; reference:
earlystopping/EarlyStoppingConfiguration.java, EarlyStoppingResult.java)."""

from __future__ import annotations

from dataclasses import dataclass, field
from enum import Enum
from typing import Any, List, Optional

from .conditions import EpochTerminationCondition, IterationTerminationCondition
from .saver import EarlyStoppingModelSaver, InMemoryModelSaver
from .scorecalc import ScoreCalculator


class TerminationReason(Enum):
    """Reference: EarlyStoppingResult.TerminationReason."""

    ERROR = "Error"
    ITERATION_TERMINATION_CONDITION = "IterationTerminationCondition"
    EPOCH_TERMINATION_CONDITION = "EpochTerminationCondition"


@dataclass
class EarlyStoppingConfiguration:
    epoch_termination_conditions: List[EpochTerminationCondition] = field(default_factory=list)
    iteration_termination_conditions: List[IterationTerminationCondition] = field(
        default_factory=list
    )
    score_calculator: Optional[ScoreCalculator] = None
    model_saver: EarlyStoppingModelSaver = field(default_factory=InMemoryModelSaver)
    evaluate_every_n_epochs: int = 1
    save_last_model: bool = False


@dataclass
class EarlyStoppingResult:
    termination_reason: TerminationReason
    termination_details: str
    score_vs_epoch: dict
    best_model_epoch: int
    best_model_score: float
    total_epochs: int
    best_model: Any = None

    def __str__(self):
        return (
            f"EarlyStoppingResult(reason={self.termination_reason.value}, "
            f"details={self.termination_details}, bestEpoch={self.best_model_epoch}, "
            f"bestScore={self.best_model_score}, totalEpochs={self.total_epochs})"
        )
