"""Process-wide metrics registry: counters, gauges, histograms (counterpart
of ``deeplearning4j_tpu/telemetry/registry.py``, host code, kept as a copy).

The single store the training paths write to: the fit loops (through
:class:`~.session.Telemetry`), the listeners, the watchdog and the flight
recorder record named metrics, and two exposition formats read them back —
Prometheus text (``prometheus_text()``) and a JSON snapshot
(``snapshot()``). After the same operations both equal the JAX package's.

Design constraints:

- Recording is host-side arithmetic under a lock — no device interaction.
  Device-side values reach the registry only through the K-step fetch in
  :mod:`telemetry.session`, never per step.
- Families are idempotent: ``registry.counter(name, ...)`` returns the
  existing family when one is already registered (re-registration with a
  different type or label set is a hard error, not silent aliasing).
- Labels follow the Prometheus model: a family declares label names once;
  ``family.labels(phase="data")`` returns the child series. Label-less
  families proxy the child API directly (``counter.inc()``).
"""

from __future__ import annotations

import math
import re
import threading
from typing import Dict, Iterable, Optional, Tuple

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")

# Default histogram buckets in seconds — spans train steps from sub-ms
# (char-rnn scan body) to multi-second (cold ResNet dispatch).
DEFAULT_BUCKETS = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
    0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0,
)


def _fmt(v: float) -> str:
    """Prometheus sample value: integral floats render without the dot."""
    if v == math.inf:
        return "+Inf"
    if v == -math.inf:
        return "-Inf"
    if isinstance(v, float) and v.is_integer() and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


def _escape_label(v: str) -> str:
    return str(v).replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _render_labels(names: Tuple[str, ...], values: Tuple[str, ...],
                   extra: Optional[Tuple[str, str]] = None) -> str:
    pairs = [f'{n}="{_escape_label(v)}"' for n, v in zip(names, values)]
    if extra is not None:
        pairs.append(f'{extra[0]}="{_escape_label(extra[1])}"')
    return "{" + ",".join(pairs) + "}" if pairs else ""


class _Counter:
    """Monotone child series."""

    def __init__(self):
        self._lock = threading.Lock()
        self._value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError(f"counter increment must be >= 0, got {amount}")
        with self._lock:
            self._value += amount

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class _Gauge:
    """Set/inc/dec child series."""

    def __init__(self):
        self._lock = threading.Lock()
        self._value = 0.0

    def set(self, value: float) -> None:
        with self._lock:
            self._value = float(value)

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value += amount

    def dec(self, amount: float = 1.0) -> None:
        self.inc(-amount)

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class _Histogram:
    """Fixed-bucket child series with sum/count/min/max."""

    def __init__(self, buckets: Tuple[float, ...]):
        self.buckets = tuple(sorted(float(b) for b in buckets))
        if not self.buckets:
            raise ValueError("histogram needs at least one bucket bound")
        self._lock = threading.Lock()
        self._counts = [0] * (len(self.buckets) + 1)  # +1 = +Inf
        self._sum = 0.0
        self._count = 0
        self._min: Optional[float] = None
        self._max: Optional[float] = None
        # last exemplar per bucket index ((trace_id, value) or None) —
        # lets prometheus_text() point tail buckets at concrete sampled
        # traces (OpenMetrics exemplar syntax)
        self._exemplars = [None] * (len(self.buckets) + 1)

    def observe(self, value: float, exemplar: Optional[str] = None) -> None:
        v = float(value)
        with self._lock:
            i = 0
            while i < len(self.buckets) and v > self.buckets[i]:
                i += 1
            self._counts[i] += 1
            self._sum += v
            self._count += 1
            self._min = v if self._min is None else min(self._min, v)
            self._max = v if self._max is None else max(self._max, v)
            if exemplar is not None:
                self._exemplars[i] = (str(exemplar), v)

    def summary(self) -> dict:
        """JSON-ready summary: the shape bench artifacts embed."""
        with self._lock:
            cum = 0
            buckets = {}
            for bound, c in zip(self.buckets, self._counts):
                cum += c
                buckets[_fmt(bound)] = cum
            buckets["+Inf"] = self._count
            return {
                "count": self._count,
                "sum": round(self._sum, 9),
                "mean": round(self._sum / self._count, 9) if self._count else 0.0,
                "min": self._min,
                "max": self._max,
                "buckets": buckets,
            }

    @property
    def count(self) -> int:
        with self._lock:
            return self._count


_KINDS = {"counter": _Counter, "gauge": _Gauge, "histogram": _Histogram}


class MetricFamily:
    """One named metric with zero or more labelled child series."""

    def __init__(self, name: str, help: str, kind: str,
                 labelnames: Tuple[str, ...] = (),
                 buckets: Optional[Tuple[float, ...]] = None):
        if not _NAME_RE.match(name):
            raise ValueError(f"invalid metric name {name!r}")
        for ln in labelnames:
            if not _LABEL_RE.match(ln) or ln == "le":
                raise ValueError(f"invalid label name {ln!r}")
        self.name = name
        self.help = help
        self.kind = kind
        self.labelnames = tuple(labelnames)
        self._buckets = tuple(buckets) if buckets is not None else DEFAULT_BUCKETS
        self._lock = threading.Lock()
        self._children: Dict[Tuple[str, ...], object] = {}

    def _make_child(self):
        if self.kind == "histogram":
            return _Histogram(self._buckets)
        return _KINDS[self.kind]()

    def labels(self, **labelvalues):
        if set(labelvalues) != set(self.labelnames):
            raise ValueError(
                f"{self.name}: expected labels {self.labelnames}, "
                f"got {tuple(sorted(labelvalues))}"
            )
        key = tuple(str(labelvalues[n]) for n in self.labelnames)
        with self._lock:
            child = self._children.get(key)
            if child is None:
                child = self._make_child()
                self._children[key] = child
            return child

    def _default_child(self):
        if self.labelnames:
            raise ValueError(
                f"{self.name} declares labels {self.labelnames}; "
                "use .labels(...) to select a series"
            )
        return self.labels()

    # label-less convenience proxies
    def inc(self, amount: float = 1.0) -> None:
        self._default_child().inc(amount)

    def dec(self, amount: float = 1.0) -> None:
        self._default_child().dec(amount)

    def set(self, value: float) -> None:
        self._default_child().set(value)

    def observe(self, value: float, exemplar: Optional[str] = None) -> None:
        self._default_child().observe(value, exemplar=exemplar)

    @property
    def value(self) -> float:
        return self._default_child().value

    def summary(self) -> dict:
        return self._default_child().summary()

    def _items(self):
        with self._lock:
            return sorted(self._children.items())


class MetricsRegistry:
    """Named-metric store with Prometheus and JSON exposition."""

    def __init__(self):
        self._lock = threading.Lock()
        self._families: Dict[str, MetricFamily] = {}

    def _register(self, name: str, help: str, kind: str,
                  labelnames: Tuple[str, ...],
                  buckets: Optional[Tuple[float, ...]] = None) -> MetricFamily:
        labelnames = tuple(labelnames)
        with self._lock:
            fam = self._families.get(name)
            if fam is not None:
                if fam.kind != kind or fam.labelnames != labelnames:
                    raise ValueError(
                        f"metric {name!r} already registered as {fam.kind}"
                        f"{fam.labelnames}; cannot re-register as {kind}"
                        f"{labelnames}"
                    )
                return fam
            fam = MetricFamily(name, help, kind, labelnames, buckets)
            self._families[name] = fam
            return fam

    def counter(self, name: str, help: str = "",
                labelnames: Iterable[str] = ()) -> MetricFamily:
        return self._register(name, help, "counter", tuple(labelnames))

    def gauge(self, name: str, help: str = "",
              labelnames: Iterable[str] = ()) -> MetricFamily:
        return self._register(name, help, "gauge", tuple(labelnames))

    def histogram(self, name: str, help: str = "",
                  labelnames: Iterable[str] = (),
                  buckets: Optional[Iterable[float]] = None) -> MetricFamily:
        return self._register(
            name, help, "histogram", tuple(labelnames),
            tuple(buckets) if buckets is not None else None,
        )

    def get(self, name: str) -> Optional[MetricFamily]:
        with self._lock:
            return self._families.get(name)

    def unregister(self, name: str) -> None:
        with self._lock:
            self._families.pop(name, None)

    def clear(self) -> None:
        with self._lock:
            self._families.clear()

    def _sorted_families(self):
        with self._lock:
            return [self._families[k] for k in sorted(self._families)]

    # ------------------------------------------------------------ exposition
    def prometheus_text(self) -> str:
        """Prometheus text exposition format 0.0.4."""
        lines = []
        for fam in self._sorted_families():
            items = fam._items()
            if not items:
                continue
            if fam.help:
                lines.append(f"# HELP {fam.name} {fam.help}")
            lines.append(f"# TYPE {fam.name} {fam.kind}")
            for key, child in items:
                base = _render_labels(fam.labelnames, key)
                if fam.kind == "histogram":
                    cum = 0
                    with child._lock:
                        counts = list(child._counts)
                        total, s = child._count, child._sum
                        exemplars = list(child._exemplars)
                    for i, (bound, c) in enumerate(
                            zip(child.buckets, counts)):
                        cum += c
                        line = (
                            f"{fam.name}_bucket"
                            f"{_render_labels(fam.labelnames, key, ('le', _fmt(bound)))}"
                            f" {cum}"
                        )
                        ex = exemplars[i]
                        if ex is not None:
                            # OpenMetrics exemplar: the sampled trace whose
                            # observation last landed in this bucket
                            line += (f' # {{trace_id="{_escape_label(ex[0])}"'
                                     f"}} {_fmt(ex[1])}")
                        lines.append(line)
                    inf_line = (
                        f"{fam.name}_bucket"
                        f"{_render_labels(fam.labelnames, key, ('le', '+Inf'))}"
                        f" {total}"
                    )
                    ex = exemplars[len(child.buckets)]
                    if ex is not None:
                        inf_line += (f' # {{trace_id="{_escape_label(ex[0])}"'
                                     f"}} {_fmt(ex[1])}")
                    lines.append(inf_line)
                    lines.append(f"{fam.name}_sum{base} {_fmt(s)}")
                    lines.append(f"{fam.name}_count{base} {total}")
                else:
                    lines.append(f"{fam.name}{base} {_fmt(child.value)}")
        return "\n".join(lines) + ("\n" if lines else "")

    def snapshot(self) -> dict:
        """JSON-ready snapshot: {name: {type, help, values: [...]}}."""
        out: dict = {}
        for fam in self._sorted_families():
            values = []
            for key, child in fam._items():
                labels = dict(zip(fam.labelnames, key))
                if fam.kind == "histogram":
                    row = {"labels": labels, **child.summary()}
                else:
                    row = {"labels": labels, "value": child.value}
                values.append(row)
            out[fam.name] = {"type": fam.kind, "help": fam.help,
                             "values": values}
        return out


_GLOBAL_REGISTRY = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    """The process-wide default registry (served at ``/metrics``)."""
    return _GLOBAL_REGISTRY
