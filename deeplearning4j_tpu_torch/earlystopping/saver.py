"""Model savers (counterpart of ``deeplearning4j_tpu/earlystopping/saver.py``;
reference: earlystopping/saver/InMemoryModelSaver.java,
LocalFileModelSaver.java)."""

from __future__ import annotations

import os

from ..utils.serialization import restore_model, write_model


class EarlyStoppingModelSaver:
    def save_best_model(self, net, score: float) -> None:
        raise NotImplementedError

    def save_latest_model(self, net, score: float) -> None:
        raise NotImplementedError

    def get_best_model(self):
        raise NotImplementedError

    def get_latest_model(self):
        raise NotImplementedError


class InMemoryModelSaver(EarlyStoppingModelSaver):
    """Reference: InMemoryModelSaver.java: clones (``net.clone()``) on the
    network's device."""

    def __init__(self):
        self._best = None
        self._latest = None

    def save_best_model(self, net, score: float) -> None:
        self._best = net.clone()

    def save_latest_model(self, net, score: float) -> None:
        self._latest = net.clone()

    def get_best_model(self):
        return self._best

    def get_latest_model(self):
        return self._latest


class LocalFileModelSaver(EarlyStoppingModelSaver):
    """Reference: LocalFileModelSaver.java: bestModel.zip and latestModel.zip
    under ``directory``, in the zip layout of ``utils.serialization``
    (which the JAX package reads too); restored on ``device``."""

    def __init__(self, directory: str, device="cuda"):
        self.directory = directory
        self.device = device
        os.makedirs(directory, exist_ok=True)

    @property
    def _best_path(self):
        return os.path.join(self.directory, "bestModel.zip")

    @property
    def _latest_path(self):
        return os.path.join(self.directory, "latestModel.zip")

    def save_best_model(self, net, score: float) -> None:
        write_model(net, self._best_path)

    def save_latest_model(self, net, score: float) -> None:
        write_model(net, self._latest_path)

    def get_best_model(self):
        if not os.path.exists(self._best_path):
            return None
        return restore_model(self._best_path, self.device)

    def get_latest_model(self):
        if not os.path.exists(self._latest_path):
            return None
        return restore_model(self._latest_path, self.device)
