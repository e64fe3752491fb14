"""Early stopping (counterpart of ``deeplearning4j_tpu/earlystopping/``;
reference: deeplearning4j-nn earlystopping/).

EarlyStoppingConfiguration, the termination conditions, score calculators,
model savers and the trainer, as the reference's fit loop
(trainer/BaseEarlyStoppingTrainer.java:76): per epoch fit, then every
``evaluate_every_n_epochs`` the score, the best model saved and the epoch
conditions checked; iteration conditions after every update.
"""

from .conditions import (
    BestScoreEpochTerminationCondition,
    InvalidScoreIterationTerminationCondition,
    MaxEpochsTerminationCondition,
    MaxScoreIterationTerminationCondition,
    MaxTimeIterationTerminationCondition,
    ScoreImprovementEpochTerminationCondition,
)
from .config import EarlyStoppingConfiguration, EarlyStoppingResult, TerminationReason
from .saver import InMemoryModelSaver, LocalFileModelSaver
from .scorecalc import DataSetLossCalculator
from .trainer import EarlyStoppingGraphTrainer, EarlyStoppingTrainer

__all__ = [
    "EarlyStoppingConfiguration",
    "EarlyStoppingResult",
    "TerminationReason",
    "MaxEpochsTerminationCondition",
    "ScoreImprovementEpochTerminationCondition",
    "BestScoreEpochTerminationCondition",
    "MaxTimeIterationTerminationCondition",
    "MaxScoreIterationTerminationCondition",
    "InvalidScoreIterationTerminationCondition",
    "DataSetLossCalculator",
    "InMemoryModelSaver",
    "LocalFileModelSaver",
    "EarlyStoppingTrainer",
    "EarlyStoppingGraphTrainer",
]
