"""Profiling: torch.profiler traces, step-time breakdown, MFU estimation
(counterpart of ``deeplearning4j_tpu/profiler.py``).

The reference has three narrow measurement mechanisms (SURVEY.md §5.1):
PerformanceListener samples/sec, Spark per-phase timing events and the
StatsListener memory sections. This module is their superset for the card:

- :func:`trace` — a ``torch.profiler`` trace (CPU and CUDA activities)
  around any block, written as a Chrome trace that
  ``scripts/torch_analyze_trace.py`` buckets by kernel.
- :class:`StepTimer` — named-phase wall-clock accounting (data / step /
  sync), the JAX package's phases and ``breakdown()`` keys.
- :func:`compiled_flops` / :func:`mfu` — FLOPs counted by
  ``torch.utils.flop_counter.FlopCounterMode`` and the resulting share of
  the card's dense bf16 peak.
- :class:`ProfilingListener` — a trace of a window of training updates.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, List, Optional

from .optimize.listeners import TrainingListener

# the environment override of the peak (TFLOP/s), the JAX package's name
PEAK_ENV = "DL4J_TPU_PEAK_BF16_TFLOPS"
# dense bf16 tensor-core peak, TFLOP/s without sparsity, by the name that
# torch.cuda.get_device_name() gives: NVIDIA's H100 SXM5 data sheet, a rate
# that assumes the card's full power limit of 700 W (nvidia-smi's
# power.limit says when a card is set lower)
DENSE_BF16_TFLOPS = {"NVIDIA H100 80GB HBM3": 989.0}


def peak_bf16_tflops(device: int = 0) -> float:
    """The peak that :func:`mfu` divides by: ``$DL4J_TPU_PEAK_BF16_TFLOPS``
    if set, else the dense bf16 peak of the card ``device`` names. Raises
    where there is no card or its peak is not in :data:`DENSE_BF16_TFLOPS`
    (set the variable then)."""
    env = os.environ.get(PEAK_ENV)
    if env:
        return float(env)
    import torch  # noqa: PLC0415

    if not torch.cuda.is_available():
        raise RuntimeError(f"no CUDA device to take a peak from; set ${PEAK_ENV}")
    name = torch.cuda.get_device_name(device)
    if name not in DENSE_BF16_TFLOPS:
        raise RuntimeError(f"no dense bf16 peak known for {name!r}; set ${PEAK_ENV}")
    return DENSE_BF16_TFLOPS[name]


def _activities():
    import torch  # noqa: PLC0415
    from torch.profiler import ProfilerActivity  # noqa: PLC0415

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    return acts


def _sync() -> None:
    import torch  # noqa: PLC0415

    if torch.cuda.is_available():
        torch.cuda.synchronize()


def _trace_path(logdir: str) -> str:
    os.makedirs(logdir, exist_ok=True)
    return os.path.join(logdir, f"trace-{os.getpid()}-{time.time_ns()}.json")


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the block with CPU and (where there is a card) CUDA
    activities and write a Chrome trace into ``logdir``; yields the
    ``torch.profiler.profile``. The card is synchronized before the
    profiler stops, so kernels the block queued are in the trace::

        with profiler.trace("/tmp/trace"):
            net.fit(batch)
    """
    import torch  # noqa: PLC0415

    path = _trace_path(logdir)
    with torch.profiler.profile(activities=_activities()) as prof:
        try:
            yield prof
        finally:
            _sync()
    prof.export_chrome_trace(path)


class StepTimer:
    """Named-phase wall-clock accounting for a training loop.

    The conventional phases mirror what the reference's Spark stats tracked
    per worker: ``"data"`` (host-side batch fetch), ``"step"`` (the update's
    dispatch, asynchronous on the card) and ``"sync"`` (waiting for the
    card). ``with timer.phase("data"): ...`` or ``timer.tick("data")`` /
    ``timer.tock()``.

    ``registry``: a ``telemetry.MetricsRegistry`` — every recorded phase
    duration is also observed into ``dl4jtpu_phase_seconds{phase=...,
    component=...}``.
    """

    def __init__(self, registry=None, component: str = "") -> None:
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}
        self._open: Optional[tuple] = None
        self._component = component
        self._phase_hist = None
        if registry is not None:
            self._phase_hist = registry.histogram(
                "dl4jtpu_phase_seconds",
                "per-phase wall time (data/step/sync/average)",
                labelnames=("component", "phase"),
            )

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.add(name, time.perf_counter() - t0)

    def tick(self, name: str) -> None:
        self.tock()
        self._open = (name, time.perf_counter())

    def tock(self) -> None:
        if self._open is not None:
            name, t0 = self._open
            self.add(name, time.perf_counter() - t0)
            self._open = None

    def add(self, name: str, seconds: float) -> None:
        self.totals[name] = self.totals.get(name, 0.0) + seconds
        self.counts[name] = self.counts.get(name, 0) + 1
        if self._phase_hist is not None:
            self._phase_hist.labels(component=self._component, phase=name).observe(seconds)

    def breakdown(self) -> Dict[str, dict]:
        """{phase: {total_s, count, mean_ms}} — JSON-ready."""
        out = {}
        for name, total in self.totals.items():
            n = self.counts.get(name, 1)
            out[name] = {
                "total_s": round(total, 4),
                "count": n,
                "mean_ms": round(1000.0 * total / n, 3),
            }
        return out

    def reset(self) -> None:
        self.totals.clear()
        self.counts.clear()
        self._open = None


def compiled_flops(fn, *args, **kwargs) -> Optional[float]:
    """FLOPs of one call of ``fn(*args, **kwargs)``, counted by
    ``torch.utils.flop_counter.FlopCounterMode`` over the ATen operators
    the call runs (it runs the call once); None where it counts none.

    Neither this count nor the JAX package's (XLA's cost analysis of the
    compiled program) is the whole model's: the hand-written kernels are
    invisible to both. FlopCounterMode does not see the port's ctypes
    launches (LSTM, LRN, softmax cross-entropy, Adam, attention), and no
    ``pallas_call`` of the JAX package passes a ``cost_estimate``, so XLA
    counts none of the Pallas kernels' work. Read either as the FLOPs of
    the library operators (matmuls, convolutions) alone.
    """
    from torch.utils.flop_counter import FlopCounterMode  # noqa: PLC0415

    counter = FlopCounterMode(display=False)
    with counter:
        fn(*args, **kwargs)
    flops = counter.get_total_flops()
    return float(flops) if flops else None


def mfu(flops_per_step: float, step_time_s: float,
        peak_tflops: Optional[float] = None) -> float:
    """Model FLOPs utilisation in percent of ``peak_tflops`` (default
    :func:`peak_bf16_tflops`, the card's)."""
    if step_time_s <= 0:
        return 0.0
    peak = peak_bf16_tflops() if peak_tflops is None else peak_tflops
    if peak <= 0:
        return 0.0
    return 100.0 * (flops_per_step / step_time_s) / (peak * 1e12)


class ProfilingListener(TrainingListener):
    """A ``torch.profiler`` trace of the updates after iteration ``start``:
    the profiler starts when ``iteration_done`` first sees ``iteration >=
    start`` and stops ``duration`` iterations later (after synchronizing
    the card), so the trace holds ``duration`` whole updates; the Chrome
    trace goes into ``logdir`` (its path in :attr:`trace_path`). Training
    that ends first is finalized by ``on_epoch_end`` or :meth:`stop`."""

    def __init__(self, logdir: str, start: int = 3, duration: int = 5):
        self.logdir = logdir
        self.start = start
        self.duration = max(1, duration)
        self.trace_path: Optional[str] = None
        self._prof = None
        self._stop_at = None

    @property
    def _active(self) -> bool:
        return self._prof is not None

    def iteration_done(self, model, iteration, score):
        import torch  # noqa: PLC0415

        if self._prof is None and self._stop_at is None and iteration >= self.start:
            self.trace_path = _trace_path(self.logdir)
            _sync()
            self._prof = torch.profiler.profile(activities=_activities())
            self._prof.start()
            self._stop_at = iteration + self.duration
        elif self._prof is not None and iteration >= self._stop_at:
            self.stop()

    def stop(self) -> None:
        """Finalize an in-flight trace (synchronize, stop, write); safe to
        call repeatedly."""
        prof, self._prof = self._prof, None
        if prof is not None:
            _sync()
            prof.stop()
            prof.export_chrome_trace(self.trace_path)

    def on_epoch_end(self, model, epoch: int) -> None:
        self.stop()

    def __del__(self):  # pragma: no cover - last resort
        try:
            self.stop()
        except Exception:  # noqa: BLE001 - nothing to report to at teardown
            pass


def device_memory_stats() -> List[dict]:
    """Per-card allocator stats; the one implementation is
    :func:`telemetry.memory.device_memory_stats`."""
    from .telemetry.memory import device_memory_stats as _impl  # noqa: PLC0415

    return _impl()


class SystemInfoSampler:
    """Host memory / device memory snapshots for the UI system page
    (reference: BaseStatsListener's memory sections, SURVEY.md §5.5); the
    JAX package's keys. The platform is ``gpu`` where CUDA is available
    (the cards counted by ``torch.cuda.device_count``), else ``cpu`` (one
    device, the host)."""

    @staticmethod
    def sample() -> dict:
        import torch  # noqa: PLC0415

        info: dict = {"timestamp": time.time()}
        try:
            with open("/proc/self/status") as f:
                for line in f:
                    if line.startswith("VmRSS:"):
                        info["host_rss_mb"] = round(int(line.split()[1]) / 1024.0, 1)
                    elif line.startswith("VmHWM:"):
                        info["host_peak_rss_mb"] = round(int(line.split()[1]) / 1024.0, 1)
        except OSError:
            pass
        if torch.cuda.is_available():
            info["device_count"] = torch.cuda.device_count()
            info["device_platform"] = "gpu"
        else:
            info["device_count"] = 1
            info["device_platform"] = "cpu"
        stats = device_memory_stats()
        if stats:
            info["device_memory"] = stats
        return info
