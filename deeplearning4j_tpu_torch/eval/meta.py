"""Prediction records that link an evaluation back to its source records
(counterpart of ``deeplearning4j_tpu/eval/meta.py``; reference:
eval/meta/Prediction.java)."""

from __future__ import annotations

from typing import Any


class Prediction:
    """One example's actual class, predicted class and provenance (a
    ``datasets.records.RecordMetaData``, or None)."""

    __slots__ = ("actual_class", "predicted_class", "record_metadata")

    def __init__(self, actual_class: int, predicted_class: int, record_metadata: Any = None):
        self.actual_class = int(actual_class)
        self.predicted_class = int(predicted_class)
        self.record_metadata = record_metadata

    def is_correct(self) -> bool:
        return self.actual_class == self.predicted_class

    def get_record(self):
        """Reload the originating record (reference: Prediction.getRecord);
        the metadata must carry its restartable reader."""
        if self.record_metadata is None:
            raise ValueError("prediction carries no record metadata")
        return self.record_metadata.load()

    def __repr__(self):
        return (f"Prediction(actual={self.actual_class}, predicted={self.predicted_class}, "
                f"meta={self.record_metadata!r})")
