"""Training telemetry: metrics, spans, watchdog, flight recorder, device
memory (counterpart of ``deeplearning4j_tpu/telemetry/``, the training
side).

- :mod:`registry` — process-wide counters/gauges/histograms with Prometheus
  text exposition and JSON snapshots.
- :mod:`spans` — host spans exporting Chrome/Perfetto trace JSON, wrapped in
  ``torch.profiler.record_function`` so they line up with CUDA kernels in a
  torch profiler trace.
- :mod:`device` — the per-step metrics vector (loss, grad norm,
  non-finite flag) computed on the device beside the step.
- :mod:`session` — :class:`Telemetry`, the K-step-fetch glue the fit paths
  call.
- :mod:`watchdog` — structured anomaly events (nan-loss,
  exploding-grad-norm, stalled-step-time) with pluggable sinks.
- :mod:`memory` — device-memory accounting: the per-layer
  :func:`memory_report`, the :func:`preflight` will-it-fit check and the
  live ``device_memory_stats``.
- :mod:`flight_recorder` — bounded event ring + post-mortem JSON dump
  bundles, auto-triggered by watchdog anomalies.

- :mod:`tracing` — distributed request tracing: the trace context and its
  header, head sampling, the trace ring, spans.
- :mod:`slo` — declared serving objectives and multi-window burn rates.

The JAX package's metric history (``history``) comes in a later slice.
"""

from .device import GRAD_NORM, LOSS, NONFINITE, NUM_SLOTS, step_stats
from .flight_recorder import (
    FlightRecorder,
    get_flight_recorder,
    install_crash_hook,
    register_event_kind,
    set_flight_recorder,
)
from .memory import (
    MemoryPreflightError,
    device_memory_stats,
    executable_memory,
    memory_report,
    preflight,
    sample_device_memory,
)
from .registry import (
    DEFAULT_BUCKETS,
    MetricFamily,
    MetricsRegistry,
    get_registry,
)
from .session import Telemetry
from .slo import SLOMonitor, get_slo_monitor, set_slo_monitor
from .tracing import (
    TRACE_HEADER,
    TraceContext,
    TraceRing,
    TraceSpan,
    current_trace,
    get_trace_ring,
    record_trace_event,
    trace_span,
    use_trace,
)
from .spans import Span, SpanRecorder, get_recorder, span
from .watchdog import (
    EXPLODING_GRAD_NORM,
    INPUT_SHIFT,
    LOSS_DRIFT,
    NAN_LOSS,
    SLO_BURN,
    STALLED_STEP_TIME,
    AnomalyEvent,
    Watchdog,
    logging_sink,
)

__all__ = [
    "DEFAULT_BUCKETS",
    "MetricFamily",
    "MetricsRegistry",
    "get_registry",
    "Telemetry",
    "Span",
    "SpanRecorder",
    "get_recorder",
    "span",
    "AnomalyEvent",
    "Watchdog",
    "logging_sink",
    "NAN_LOSS",
    "EXPLODING_GRAD_NORM",
    "STALLED_STEP_TIME",
    "LOSS_DRIFT",
    "INPUT_SHIFT",
    "SLO_BURN",
    "FlightRecorder",
    "get_flight_recorder",
    "install_crash_hook",
    "register_event_kind",
    "set_flight_recorder",
    "MemoryPreflightError",
    "device_memory_stats",
    "executable_memory",
    "memory_report",
    "preflight",
    "sample_device_memory",
    "GRAD_NORM",
    "LOSS",
    "NONFINITE",
    "NUM_SLOTS",
    "step_stats",
    "SLOMonitor",
    "get_slo_monitor",
    "set_slo_monitor",
    "TRACE_HEADER",
    "TraceContext",
    "TraceRing",
    "TraceSpan",
    "current_trace",
    "get_trace_ring",
    "record_trace_event",
    "trace_span",
    "use_trace",
]
