"""Training listener SPI (counterpart of
``deeplearning4j_tpu/optimize/listeners.py``).

Reference: optimize/api/IterationListener.java + TrainingListener.java and the
stock listeners in optimize/listeners/ (ScoreIterationListener,
CollectScoresIterationListener, PerformanceListener,
ComposableIterationListener, ParamAndGradientIterationListener).

``iteration_done(model, iteration, score)`` receives the score as a 0-d
tensor (on the device for a per-batch update, on the host after a staged
window); listeners that need the float call ``float(score)`` (the sync is
theirs to pay, keeping the train loop's async dispatch intact when no
listener syncs).

A listener's flags say what the fit paths keep for it: ``supports_staged``
(it reads only (iteration, score), so ``fit(stage_on_device=K)`` may run),
``needs_gradients`` (the network keeps ``_last_grads`` and
``_last_updates`` on the iterations its ``frequency`` selects) and
``needs_input`` (the network keeps ``_last_input``, the batch's features).
"""

from __future__ import annotations

import logging
import time
from typing import List, Optional, Tuple

logger = logging.getLogger(__name__)


class IterationListener:
    """SPI (reference: optimize/api/IterationListener.java).

    ``supports_staged``: True when the listener consumes only the
    (iteration, score) arguments — such listeners work under the staged
    fit path (``fit(stage_on_device=K)``), where ``iteration_done`` replays
    AFTER a whole scanned dispatch and ``model``'s params/state already
    hold end-of-window values. Listeners that read per-iteration model
    state (params, gradients, inputs) must leave this False so staging
    auto-disables and they keep observing true per-step state."""

    supports_staged = False

    def iteration_done(self, model, iteration: int, score) -> None:
        pass


class TrainingListener(IterationListener):
    """Adds epoch hooks (reference: optimize/api/TrainingListener.java)."""

    def on_epoch_start(self, model, epoch: int) -> None:
        pass

    def on_epoch_end(self, model, epoch: int) -> None:
        pass


class ScoreIterationListener(TrainingListener):
    """Log score every N iterations (reference: ScoreIterationListener).

    Scores land in the telemetry registry (``dl4jtpu_score`` gauge +
    ``dl4jtpu_score_reports_total`` counter) rather than listener-private
    state, so the logged number is also the scraped number. The ``float()``
    host sync stays on the print cadence, exactly as before."""

    supports_staged = True  # consumes only (iteration, score)

    def __init__(self, print_every: int = 10, registry=None):
        from ..telemetry.registry import get_registry  # noqa: PLC0415

        self.print_every = max(1, print_every)
        reg = registry if registry is not None else get_registry()
        self._score_gauge = reg.gauge(
            "dl4jtpu_score", "last reported training score")
        self._reports = reg.counter(
            "dl4jtpu_score_reports_total", "score reports emitted")

    def iteration_done(self, model, iteration, score):
        if iteration % self.print_every == 0:
            value = float(score)
            self._score_gauge.set(value)
            self._reports.inc()
            logger.info("Score at iteration %d is %s", iteration, value)


class CollectScoresIterationListener(TrainingListener):
    """Accumulate (iteration, score) pairs (reference: CollectScoresIterationListener)."""

    supports_staged = True  # consumes only (iteration, score)

    def __init__(self, frequency: int = 1):
        self.frequency = max(1, frequency)
        self.scores: List[Tuple[int, float]] = []

    def iteration_done(self, model, iteration, score):
        if iteration % self.frequency == 0:
            self.scores.append((iteration, float(score)))


class PerformanceListener(TrainingListener):
    """Throughput: samples/sec + batches/sec (reference: PerformanceListener.java —
    the in-tree measurement hook called out in SURVEY.md §6)."""

    supports_staged = True  # wall-clock + score only; staged throughput is
    #                           attributed to the window's steps evenly via
    #                           the model's staged_step_time hint (set by
    #                           fit_on_device during the replay loop, where
    #                           wall-clock deltas between callbacks are ~0).
    #                           Per-step time is ACCUMULATED per callback
    #                           (hint when staged, wall-clock delta when not)
    #                           so a frequency window spanning a staged/
    #                           per-batch boundary still sums real time. The
    #                           first dispatch of a program includes its JIT
    #                           compile, same as any cold-start interval.

    def __init__(self, frequency: int = 1, report_score: bool = False,
                 registry=None):
        from ..telemetry.registry import get_registry  # noqa: PLC0415

        self.frequency = max(1, frequency)
        self.report_score = report_score
        self._last_time: Optional[float] = None
        self._last_iter = 0
        self._accum = 0.0  # time attributed to steps since the last record
        self.history: List[dict] = []
        reg = registry if registry is not None else get_registry()
        self._batches_gauge = reg.gauge(
            "dl4jtpu_throughput_batches_per_sec",
            "training throughput over the last report window")
        self._samples_gauge = reg.gauge(
            "dl4jtpu_throughput_samples_per_sec",
            "training sample throughput over the last report window")

    def iteration_done(self, model, iteration, score):
        now = time.perf_counter()
        staged_dt = getattr(model, "staged_step_time", None)
        if self._last_time is not None:
            self._accum += staged_dt if staged_dt is not None \
                else now - self._last_time
        self._last_time = now
        if iteration % self.frequency:
            return
        iters = iteration - self._last_iter
        if self._last_iter:  # the first qualifying callback only seeds
            dt = self._accum
            batch = getattr(model, "last_batch_size", None)
            rec = {
                "iteration": iteration,
                "batches_per_sec": iters / dt if dt > 0 else float("inf"),
            }
            if batch:
                rec["samples_per_sec"] = (
                    iters * batch / dt if dt > 0 else float("inf")
                )
            if self.report_score:
                rec["score"] = float(score)
            if dt > 0:  # scraped gauges mirror the appended record
                self._batches_gauge.set(rec["batches_per_sec"])
                if "samples_per_sec" in rec:
                    self._samples_gauge.set(rec["samples_per_sec"])
            self.history.append(rec)
            logger.info("perf: %s", rec)
        self._last_iter = iteration
        self._accum = 0.0


class ComposableIterationListener(TrainingListener):
    """Forward every callback to a group of listeners as one attachment
    (reference: optimize/listeners/ComposableIterationListener.java).

    Capability flags aggregate conservatively: staged fit stays available
    only if EVERY child supports it, and gradient instrumentation turns on
    if ANY child needs it (at frequency 1, since children may disagree on
    cadence)."""

    def __init__(self, *listeners):
        if len(listeners) == 1 and isinstance(listeners[0], (list, tuple)):
            listeners = tuple(listeners[0])
        self.listeners: List[TrainingListener] = list(listeners)

    @property
    def supports_staged(self) -> bool:  # type: ignore[override]
        return all(getattr(l, "supports_staged", False) for l in self.listeners)

    @property
    def needs_gradients(self) -> bool:
        return any(getattr(l, "needs_gradients", False) for l in self.listeners)

    @property
    def needs_input(self) -> bool:
        return any(getattr(l, "needs_input", False) for l in self.listeners)

    @property
    def frequency(self) -> int:
        """gcd of the instrumentation-needing children's frequencies: the
        composite fires the instrumented step on a superset of every
        child's cadence WITHOUT forcing it every iteration (a child at
        frequency=50 keeps the donated fast path 49 of 50 steps)."""
        import math

        freqs = [max(1, int(getattr(l, "frequency", 1)))
                 for l in self.listeners
                 if getattr(l, "needs_gradients", False)
                 or getattr(l, "needs_input", False)]
        return math.gcd(*freqs) if freqs else 1

    def iteration_done(self, model, iteration, score):
        for l in self.listeners:
            l.iteration_done(model, iteration, score)

    def on_epoch_start(self, model, epoch):
        for l in self.listeners:
            if isinstance(l, TrainingListener):
                l.on_epoch_start(model, epoch)

    def on_epoch_end(self, model, epoch):
        for l in self.listeners:
            if isinstance(l, TrainingListener):
                l.on_epoch_end(model, epoch)


class ParamAndGradientIterationListener(TrainingListener):
    """Text/file dump of per-parameter and per-gradient statistics —
    "much of the same information as the UI histogram listener, but in a
    text-based format (for example, when learning on a system accessed via
    SSH)" (reference: optimize/listeners/
    ParamAndGradientIterationListener.java: mean / min / max / meanAbs per
    parameter tensor and its gradient, tab-delimited, header row,
    optionally appended to a file).

    Reads the model's params (``model._leaves()``) and ``model._last_grads``
    — the update keeps the latter when ``needs_gradients`` listeners are
    attached, on exactly the iterations this listener's frequency selects.
    Columns are named as the JAX package names them
    (``jax.tree_util.keystr``: ``[0]['W']`` for a MultiLayerNetwork,
    ``['vertex']['W']`` for a ComputationGraph)."""

    supports_staged = False   # reads per-iteration model state
    needs_gradients = True

    def __init__(self, iterations: int = 1, print_header: bool = True,
                 print_mean: bool = True, print_min_max: bool = True,
                 print_mean_abs_value: bool = True,
                 output_to_file: bool = False, file: Optional[str] = None,
                 delimiter: str = "\t"):
        self.frequency = max(1, iterations)
        self.print_header = print_header
        self.print_mean = print_mean
        self.print_min_max = print_min_max
        self.print_mean_abs_value = print_mean_abs_value
        self.output_to_file = output_to_file
        self.file = file
        self.delimiter = delimiter
        self._header_written = False
        self.lines: List[str] = []  # also kept in memory (test/REPL use)

    @staticmethod
    def _named_leaves(model, tree) -> List[Tuple[str, object]]:
        """(keystr, tensor) of a param-shaped list, in jax.tree_util order:
        entry by entry (layer index, or sorted vertex name), each in sorted
        key order."""
        names = getattr(model, "_names", None)
        out = []
        for i, layer in enumerate(tree or []):
            head = f"[{i}]" if names is None else f"[{names[i]!r}]"
            out.extend((f"{head}[{k!r}]", layer[k]) for k in sorted(layer))
        return out

    def _stats(self, arr) -> List[str]:
        import numpy as np

        if hasattr(arr, "detach"):
            arr = arr.detach().float().cpu().numpy()
        a = np.asarray(arr, dtype=np.float64)
        out = []
        if self.print_mean:
            out.append(repr(float(a.mean())))
        if self.print_min_max:
            out.extend((repr(float(a.min())), repr(float(a.max()))))
        if self.print_mean_abs_value:
            out.append(repr(float(np.abs(a).mean())))
        return out

    def _emit(self, line: str) -> None:
        if not (self.output_to_file and self.file):
            self.lines.append(line)  # in-memory only when not file-backed
        if self.output_to_file and self.file:
            try:
                with open(self.file, "a") as f:
                    f.write(line + "\n")
            except OSError as e:  # reference logs and keeps training
                logger.warning("ParamAndGradientIterationListener: %s", e)
        else:
            logger.info("%s", line)

    def iteration_done(self, model, iteration, score):
        if iteration % self.frequency:
            return
        params = self._named_leaves(model, model._leaves())
        grads = getattr(model, "_last_grads", None)
        g_leaves = [t for _, t in self._named_leaves(model, grads)] if grads is not None else []
        if self.print_header and not self._header_written:
            cols = ["iteration", "score"]
            stat_names = ([ "mean"] if self.print_mean else []) + \
                (["min", "max"] if self.print_min_max else []) + \
                (["meanAbs"] if self.print_mean_abs_value else [])
            for n, _ in params:
                cols.extend(f"param{n}.{s}" for s in stat_names)
                cols.extend(f"grad{n}.{s}" for s in stat_names)
            self._emit(self.delimiter.join(cols))
            self._header_written = True
        fields = [str(iteration), repr(float(score))]
        for i, (_, p) in enumerate(params):
            fields.extend(self._stats(p))
            if i < len(g_leaves):
                fields.extend(self._stats(g_leaves[i]))
            else:  # gradients unavailable this step: blank columns
                n_stats = (int(self.print_mean) + 2 * int(self.print_min_max)
                           + int(self.print_mean_abs_value))
                fields.extend([""] * n_stats)
        self._emit(self.delimiter.join(fields))
