"""The early-stopping trainer (counterpart of
``deeplearning4j_tpu/earlystopping/trainer.py``; reference:
earlystopping/trainer/BaseEarlyStoppingTrainer.java:76, EarlyStoppingTrainer
and EarlyStoppingGraphTrainer).

One trainer serves ``MultiLayerNetwork`` and ``ComputationGraph`` alike
(``fit``, ``score``, ``clone``). Each epoch is one ``net.fit(train_data)``;
every ``evaluate_every_n_epochs`` epochs the score is computed, the best
model saved and the epoch conditions checked. The iteration conditions are
checked after every update, by a listener that reads the update's loss on
the host; it is added only where iteration conditions exist, since that
read waits for the device on every update. The mesh-parallel trainer of the
JAX package waits for the port's parallel package.
"""

from __future__ import annotations

import math

from .config import EarlyStoppingConfiguration, EarlyStoppingResult, TerminationReason


class _IterationConditions:
    """The listener that checks the iteration conditions after each update;
    ``stop`` and ``details`` say whether and which one fired."""

    def __init__(self, conditions):
        self.conditions = conditions
        self.stop = False
        self.details = ""

    def iteration_done(self, model, iteration, loss):
        score = float(loss)
        for c in self.conditions:
            if c.terminate(score):
                self.stop = True
                self.details = str(c)


class EarlyStoppingTrainer:
    def __init__(self, config: EarlyStoppingConfiguration, net, train_data):
        self.config = config
        self.net = net
        self.train_data = train_data

    def _fit_epoch(self):
        self.net.fit(self.train_data, epochs=1)

    def fit(self) -> EarlyStoppingResult:
        cfg = self.config
        for c in cfg.epoch_termination_conditions:
            c.initialize()
        for c in cfg.iteration_termination_conditions:
            c.initialize()

        best_score = math.inf
        best_epoch = -1
        score_vs_epoch = {}
        epoch = 0
        listener = None
        if cfg.iteration_termination_conditions:
            listener = _IterationConditions(cfg.iteration_termination_conditions)
            self.net.add_listener(listener)
        try:
            while True:
                try:
                    self._fit_epoch()
                except FloatingPointError as e:
                    return EarlyStoppingResult(
                        TerminationReason.ERROR, str(e), score_vs_epoch,
                        best_epoch, best_score, epoch, cfg.model_saver.get_best_model())
                if listener is not None and listener.stop:
                    return EarlyStoppingResult(
                        TerminationReason.ITERATION_TERMINATION_CONDITION,
                        listener.details, score_vs_epoch, best_epoch,
                        best_score, epoch + 1, cfg.model_saver.get_best_model())

                if (epoch + 1) % cfg.evaluate_every_n_epochs == 0:
                    score = (cfg.score_calculator.calculate_score(self.net)
                             if cfg.score_calculator is not None else self.net.score())
                    score_vs_epoch[epoch] = score
                    if score < best_score:
                        best_score = score
                        best_epoch = epoch
                        cfg.model_saver.save_best_model(self.net, score)
                    if cfg.save_last_model:
                        cfg.model_saver.save_latest_model(self.net, score)
                    for c in cfg.epoch_termination_conditions:
                        if c.terminate(epoch, score):
                            return EarlyStoppingResult(
                                TerminationReason.EPOCH_TERMINATION_CONDITION,
                                str(c), score_vs_epoch, best_epoch, best_score,
                                epoch + 1, cfg.model_saver.get_best_model())
                epoch += 1
        finally:
            if listener is not None and listener in self.net.listeners:
                self.net.listeners.remove(listener)


# the reference's ComputationGraph trainer, by its name
EarlyStoppingGraphTrainer = EarlyStoppingTrainer
