"""Typed failure-handling policies: retry, deadline, circuit breaker
(counterpart of ``deeplearning4j_tpu/runtime/resilience.py``, with the same
names, defaults, env knobs and metric names; host-only).

Every subsystem that talks to something that can fail — the checkpoint
store's filesystem, a fleet worker's HTTP port, a streaming source's
broker — used to carry its own ad-hoc ``try/except + time.sleep`` loop.
This module replaces them with three typed primitives that every site
shares:

- :class:`RetryPolicy` — bounded attempts, exponential backoff with a
  cap, a retryable-exception predicate, and **deterministic jitter**:
  the jitter fraction is derived from ``sha256(site, key, attempt)``, so
  two workers keyed by id back off at *different* times (no thundering
  herd) yet the schedule is bit-reproducible run to run.
- :class:`Deadline` / :class:`DeadlinePolicy` — a monotonic budget with
  ``pace()``/``wait_event()`` helpers so polling loops sleep without raw
  ``time.sleep`` and stop exactly at expiry.
- :class:`CircuitBreaker` — closed/open/half-open with a cooldown;
  state is exported as the ``dl4jtpu_circuit_state{site}`` gauge
  (0=closed, 1=open, 2=half-open) and each transition lands in the
  flight recorder.

Sites register under a stable name; :func:`resilience_stats` snapshots
all of them (the JAX package serves it as ``/api/resilience``; the port's
HTTP endpoints wait for ``ui/``). Policy defaults read the ``DL4JTPU_RETRY_*`` /
``DL4JTPU_CIRCUIT_*`` env knobs at construction time (see
docs/robustness.md for the knob table).

This module is the port's one home for backoff sleeps: pacing loops wait
on a ``Deadline`` or an event, never on ``time.sleep``.
"""

from __future__ import annotations

import hashlib
import os
import threading
import time
from typing import Any, Callable, Dict, Optional, Tuple, Type

__all__ = [
    "CircuitBreaker",
    "Deadline",
    "DeadlinePolicy",
    "RetryError",
    "RetryPolicy",
    "clear_sites",
    "get_site",
    "register_site",
    "resilience_stats",
]

RETRY_MAX_ENV = "DL4JTPU_RETRY_MAX"
RETRY_BASE_ENV = "DL4JTPU_RETRY_BASE_S"
RETRY_CAP_ENV = "DL4JTPU_RETRY_CAP_S"
RETRY_JITTER_ENV = "DL4JTPU_RETRY_JITTER"
CIRCUIT_FAILURES_ENV = "DL4JTPU_CIRCUIT_FAILURES"
CIRCUIT_COOLDOWN_ENV = "DL4JTPU_CIRCUIT_COOLDOWN_S"


def _env_float(name: str, default: float) -> float:
    raw = os.environ.get(name)
    if raw is None or raw == "":
        return default
    try:
        return float(raw)
    except ValueError:
        return default


def _env_int(name: str, default: Optional[int]) -> Optional[int]:
    raw = os.environ.get(name)
    if raw is None or raw == "":
        return default
    try:
        return int(raw)
    except ValueError:
        return default


def _flight(kind: str, **payload) -> None:
    """Best-effort flight-recorder event — never raises."""
    try:
        from ..telemetry.flight_recorder import get_flight_recorder  # noqa: PLC0415
        get_flight_recorder().record(kind, **payload)
    except Exception:
        pass


def _current_trace():
    """Best-effort read of the thread's trace context — never raises."""
    try:
        from ..telemetry.tracing import current_trace  # noqa: PLC0415
        return current_trace()
    except Exception:
        return None


# --------------------------------------------------------------- site registry

_SITES: Dict[str, Any] = {}
_SITES_LOCK = threading.Lock()


def register_site(site: Any) -> None:
    """Register a policy object under its ``name`` (last wins)."""
    with _SITES_LOCK:
        _SITES[site.name] = site


def get_site(name: str) -> Optional[Any]:
    with _SITES_LOCK:
        return _SITES.get(name)


def clear_sites() -> None:
    """Drop all registered sites (test isolation)."""
    with _SITES_LOCK:
        _SITES.clear()


def resilience_stats() -> dict:
    """Snapshot of every registered site — the ``/api/resilience`` payload."""
    with _SITES_LOCK:
        sites = dict(_SITES)
    out = {}
    for name, site in sorted(sites.items()):
        try:
            out[name] = site.stats()
        except Exception as e:  # pragma: no cover - defensive
            out[name] = {"error": str(e)}
    return {"sites": out}


# ----------------------------------------------------------------- retry policy

class RetryError(RuntimeError):
    """A :meth:`RetryPolicy.run` exhausted its attempts."""

    def __init__(self, site: str, attempts: int, last: BaseException):
        super().__init__(f"{site}: gave up after {attempts} attempt(s): {last!r}")
        self.site = site
        self.attempts = attempts
        self.last = last


class RetryPolicy:
    """Exponential backoff with cap, deterministic jitter and typed retries.

    ``backoff_s(attempt, key=...)`` is pure: the jitter fraction comes
    from ``sha256(name | key | attempt)``, so a given (site, key,
    attempt) always backs off the same amount while distinct keys (e.g.
    fleet worker ids) are staggered. ``run(fn)`` drives a full retry
    loop; event-loop style sites call ``record_failure()`` /
    ``record_success()`` and pace themselves.
    """

    def __init__(self, name: str, *,
                 max_attempts: Optional[int] = None,
                 base_s: Optional[float] = None,
                 cap_s: Optional[float] = None,
                 factor: float = 2.0,
                 jitter: Optional[float] = None,
                 retry_on: Tuple[Type[BaseException], ...] = (Exception,),
                 registry=None,
                 register: bool = True):
        self.name = str(name)
        self.max_attempts = _env_int(RETRY_MAX_ENV, None) if max_attempts is None \
            else int(max_attempts)
        self.base_s = _env_float(RETRY_BASE_ENV, 0.1) if base_s is None else float(base_s)
        self.cap_s = _env_float(RETRY_CAP_ENV, 30.0) if cap_s is None else float(cap_s)
        self.factor = float(factor)
        self.jitter = _env_float(RETRY_JITTER_ENV, 0.5) if jitter is None else float(jitter)
        self.retry_on = retry_on
        self._lock = threading.Lock()
        self.attempts_total = 0
        self.retries_total = 0
        self.giveups_total = 0
        self.successes_total = 0
        self.consecutive_failures = 0
        self.last_error: Optional[str] = None
        self.last_backoff_s = 0.0
        if registry is None:
            from ..telemetry.registry import get_registry  # noqa: PLC0415
            registry = get_registry()
        self._m_retries = registry.counter(
            "dl4jtpu_resilience_retries_total",
            "retries issued by a resilience policy", labelnames=("site",),
        ).labels(site=self.name)
        self._m_giveups = registry.counter(
            "dl4jtpu_resilience_giveups_total",
            "retry policies that exhausted their attempts", labelnames=("site",),
        ).labels(site=self.name)
        if register:
            register_site(self)

    # -- backoff math ------------------------------------------------------
    def backoff_s(self, attempt: int, key: Optional[str] = None) -> float:
        """Backoff before retrying after the ``attempt``-th failure (1-based)."""
        attempt = max(1, int(attempt))
        raw = min(self.cap_s, self.base_s * (self.factor ** (attempt - 1)))
        if self.jitter <= 0 or raw <= 0:
            return raw
        seed = f"{self.name}|{'' if key is None else key}|{attempt}".encode()
        frac = int.from_bytes(hashlib.sha256(seed).digest()[:8], "big") / 2.0 ** 64
        return raw * (1.0 + self.jitter * frac)

    # -- event-loop style --------------------------------------------------
    def record_failure(self, error: Optional[BaseException] = None,
                       key: Optional[str] = None,
                       attempt: Optional[int] = None) -> float:
        """Count a failure; return the deterministic backoff to wait."""
        with self._lock:
            self.consecutive_failures += 1
            self.attempts_total += 1
            self.retries_total += 1
            if error is not None:
                self.last_error = repr(error)
            n = self.consecutive_failures if attempt is None else int(attempt)
            self.last_backoff_s = self.backoff_s(n, key=key)
        self._m_retries.inc()
        return self.last_backoff_s

    def record_success(self) -> None:
        with self._lock:
            self.attempts_total += 1
            self.successes_total += 1
            self.consecutive_failures = 0
            self.last_backoff_s = 0.0

    # -- full retry loop ---------------------------------------------------
    def run(self, fn: Callable[..., Any], *args,
            stop: Optional[threading.Event] = None,
            key: Optional[str] = None,
            deadline: Optional["Deadline"] = None, **kwargs) -> Any:
        """Call ``fn`` until it succeeds, backing off between attempts.

        Retries only exceptions matching ``retry_on``; raises
        :class:`RetryError` on exhaustion (or immediately when ``stop``
        is set / ``deadline`` expires between attempts).
        """
        waiter = stop if stop is not None else threading.Event()
        # read the caller's trace ONCE: re-executions of the body (possibly
        # after another thread mutated thread-local state) must all parent
        # under the SAME span, each attempt a child — a retry storm reads
        # as N sibling resilience.attempt spans, not a lost parent
        parent = _current_trace()
        attempt = 0
        while True:
            attempt += 1
            t0 = time.perf_counter()
            try:
                result = fn(*args, **kwargs)
            except self.retry_on as e:
                exhausted = (self.max_attempts is not None
                             and attempt >= self.max_attempts)
                expired = deadline is not None and deadline.expired
                stopped = stop is not None and stop.is_set()
                if exhausted or expired or stopped:
                    with self._lock:
                        self.attempts_total += 1
                        self.giveups_total += 1
                        self.last_error = repr(e)
                    self._m_giveups.inc()
                    _flight("resilience_giveup", site=self.name,
                            attempts=attempt, error=repr(e))
                    self._attempt_span(parent, attempt, t0, backoff_s=0.0,
                                       error=repr(e), giveup=True)
                    raise RetryError(self.name, attempt, e) from e
                pause = self.record_failure(error=e, key=key, attempt=attempt)
                if deadline is not None:
                    pause = min(pause, max(0.0, deadline.remaining()))
                _flight("resilience_retry", site=self.name, attempt=attempt,
                        backoff_s=round(pause, 4), error=repr(e))
                self._attempt_span(parent, attempt, t0,
                                   backoff_s=round(pause, 4), error=repr(e))
                waiter.wait(pause)
            else:
                self.record_success()
                self._attempt_span(parent, attempt, t0, backoff_s=0.0)
                return result

    def _attempt_span(self, parent, attempt: int, t0: float,
                      backoff_s: float, error: Optional[str] = None,
                      giveup: bool = False) -> None:
        """Record one ``resilience.attempt`` child span (sampled traces
        only; never raises — observability must not fail the retry loop)."""
        if parent is None or not getattr(parent, "sampled", False):
            return
        try:
            from ..telemetry.tracing import record_trace_event  # noqa: PLC0415

            args = {"site": self.name, "attempt": int(attempt),
                    "backoff_s": float(backoff_s)}
            if error is not None:
                args["error"] = error[:200]
            if giveup:
                args["giveup"] = True
            record_trace_event(parent.child(), "resilience.attempt",
                               duration_s=time.perf_counter() - t0, **args)
        except Exception:  # pragma: no cover - defensive
            pass

    def stats(self) -> dict:
        with self._lock:
            return {
                "kind": "retry",
                "max_attempts": self.max_attempts,
                "base_s": self.base_s,
                "cap_s": self.cap_s,
                "factor": self.factor,
                "jitter": self.jitter,
                "attempts_total": self.attempts_total,
                "retries_total": self.retries_total,
                "giveups_total": self.giveups_total,
                "successes_total": self.successes_total,
                "consecutive_failures": self.consecutive_failures,
                "last_backoff_s": round(self.last_backoff_s, 4),
                "last_error": self.last_error,
            }


# -------------------------------------------------------------------- deadline

class Deadline:
    """A monotonic time budget. Cheap, transient; see :class:`DeadlinePolicy`
    for the named/registered variant that counts expiries."""

    __slots__ = ("seconds", "_t0", "_clock", "_policy", "_event")

    def __init__(self, seconds: float, *, clock=time.monotonic, policy=None):
        self.seconds = float(seconds)
        self._clock = clock
        self._t0 = clock()
        self._policy = policy
        self._event = threading.Event()

    def remaining(self) -> float:
        return self.seconds - (self._clock() - self._t0)

    @property
    def expired(self) -> bool:
        return self.remaining() <= 0

    def pace(self, interval: float, stop: Optional[threading.Event] = None) -> bool:
        """Sleep ``min(interval, remaining)``; return False once expired
        (or ``stop`` set). The polling-loop idiom::

            while not done() and deadline.pace(0.05):
                ...
        """
        rem = self.remaining()
        if rem <= 0:
            self._note_expired()
            return False
        waiter = stop if stop is not None else self._event
        waiter.wait(min(float(interval), rem))
        if stop is not None and stop.is_set():
            return False
        if self.remaining() <= 0:
            self._note_expired()
            return False
        return True

    def wait_event(self, event: threading.Event) -> bool:
        """Wait for ``event`` up to the remaining budget; True if it fired."""
        ok = event.wait(max(0.0, self.remaining()))
        if not ok:
            self._note_expired()
        return ok

    def note_expired(self) -> None:
        """Explicitly mark this deadline as blown (e.g. the probe it was
        timing raised a socket timeout) — counts on the owning policy."""
        self._note_expired()

    def _note_expired(self) -> None:
        if self._policy is not None:
            self._policy._on_expired()
            self._policy = None  # count each deadline at most once


class DeadlinePolicy:
    """A named deadline site: manufactures :class:`Deadline` instances and
    counts how many of them expired (``/api/resilience`` visibility)."""

    def __init__(self, name: str, seconds: float, *, register: bool = True):
        self.name = str(name)
        self.seconds = float(seconds)
        self._lock = threading.Lock()
        self.started_total = 0
        self.expired_total = 0
        if register:
            register_site(self)

    def start(self, seconds: Optional[float] = None) -> Deadline:
        with self._lock:
            self.started_total += 1
        return Deadline(self.seconds if seconds is None else float(seconds),
                        policy=self)

    def _on_expired(self) -> None:
        with self._lock:
            self.expired_total += 1
        _flight("deadline_expired", site=self.name, seconds=self.seconds)

    def stats(self) -> dict:
        with self._lock:
            return {
                "kind": "deadline",
                "seconds": self.seconds,
                "started_total": self.started_total,
                "expired_total": self.expired_total,
            }


# -------------------------------------------------------------- circuit breaker

CLOSED, OPEN, HALF_OPEN = "closed", "open", "half-open"
_STATE_CODE = {CLOSED: 0, OPEN: 1, HALF_OPEN: 2}


class CircuitBreaker:
    """Closed/open/half-open breaker with cooldown.

    ``allow()`` gates the protected call: closed → always; open → only
    after ``cooldown_s``, transitioning to half-open for a single probe;
    half-open → probe outcome closes or re-opens. State is exported as
    ``dl4jtpu_circuit_state{site}`` (0/1/2) and every transition lands
    in the flight recorder.
    """

    def __init__(self, name: str, *,
                 failure_threshold: Optional[int] = None,
                 cooldown_s: Optional[float] = None,
                 registry=None,
                 register: bool = True,
                 clock=time.monotonic):
        self.name = str(name)
        thr = _env_int(CIRCUIT_FAILURES_ENV, 8) if failure_threshold is None \
            else int(failure_threshold)
        self.failure_threshold = max(1, int(thr or 8))
        self.cooldown_s = _env_float(CIRCUIT_COOLDOWN_ENV, 5.0) if cooldown_s is None \
            else float(cooldown_s)
        self._clock = clock
        self._lock = threading.Lock()
        self.state = CLOSED
        self.failures = 0
        self.opens_total = 0
        self._opened_at = 0.0
        if registry is None:
            from ..telemetry.registry import get_registry  # noqa: PLC0415
            registry = get_registry()
        self._m_state = registry.gauge(
            "dl4jtpu_circuit_state",
            "circuit breaker state (0=closed, 1=open, 2=half-open)",
            labelnames=("site",),
        ).labels(site=self.name)
        self._m_state.set(0)
        if register:
            register_site(self)

    def _transition(self, state: str) -> None:
        self.state = state
        self._m_state.set(_STATE_CODE[state])
        _flight(f"circuit_{state.replace('-', '_')}", site=self.name,
                failures=self.failures)

    def allow(self) -> bool:
        with self._lock:
            if self.state == CLOSED:
                return True
            if self.state == OPEN:
                if self._clock() - self._opened_at >= self.cooldown_s:
                    self._transition(HALF_OPEN)
                    return True
                return False
            return True  # half-open: let the probe through

    def record_success(self) -> None:
        with self._lock:
            self.failures = 0
            if self.state != CLOSED:
                self._transition(CLOSED)

    def record_failure(self) -> None:
        with self._lock:
            self.failures += 1
            if self.state == HALF_OPEN or (
                    self.state == CLOSED and self.failures >= self.failure_threshold):
                self._opened_at = self._clock()
                self.opens_total += 1
                self._transition(OPEN)

    def cooldown_remaining(self) -> float:
        with self._lock:
            if self.state != OPEN:
                return 0.0
            return max(0.0, self.cooldown_s - (self._clock() - self._opened_at))

    def stats(self) -> dict:
        with self._lock:
            return {
                "kind": "circuit",
                "state": self.state,
                "failure_threshold": self.failure_threshold,
                "cooldown_s": self.cooldown_s,
                "failures": self.failures,
                "opens_total": self.opens_total,
                "cooldown_remaining_s": round(max(
                    0.0, self.cooldown_s - (self._clock() - self._opened_at))
                    if self.state == OPEN else 0.0, 4),
            }
