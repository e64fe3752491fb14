"""Deterministic fault injection: seeded schedules of named faults
(counterpart of ``deeplearning4j_tpu/testing/chaos.py``: the same schedules,
firing order, env transport and corruption offsets for a seed).

A :class:`FaultPlan` is a seed plus a list of fault specs. Production
code exposes explicit hooks — ``store.chaos.fire("checkpoint.write",
path=...)``, ``worker.chaos.fire("worker.healthz")``, a
:class:`ChaosSource` wrapped around any ``RecordSource`` — and the plan
decides, purely from per-site occurrence counters and the seed, which
calls actually fault. No monkeypatching: a site that isn't instrumented
can't fault, and the same seed always yields the same fault sequence
(``plan.fired``), which is what lets ``scripts/torch_chaos_soak.py`` replay an exact failure
scenario and compare recovery event trails run to run.

Fault kinds (``spec["fault"]``):

- ``corrupt-checkpoint`` — flip bytes of the just-written version file
  (offsets drawn from ``Random((seed, site, n))``).
- ``torn-tmp``           — drop a stale ``.tmp-v*`` file in the store
  directory, as a killed writer would.
- ``hang-worker``        — the worker's ``/healthz`` handler sleeps past
  the router's health deadline (params: ``seconds``).
- ``partial-http``       — ``/healthz`` declares a Content-Length but
  sends only half the body.
- ``source-error``       — the wrapped source raises ``ConnectionError``
  for ``params["polls"]`` consecutive polls.
- ``source-slow``        — delay one poll by ``params["seconds"]``.
- ``nan-burst``          — the next ``params["records"]`` records get
  their features replaced with NaN.
- ``kill-worker``        — descriptive only: the plan records it and the
  harness (soak script / self-scan) delivers the actual SIGKILL.

A spec triggers by occurrence index at its site: ``{"at": [3, 9]}``
fires on the 3rd and 9th call, ``{"every": 300}`` fires on every 300th.
An optional ``{"marker": path}`` makes a fault at-most-once *across
processes* (first process to atomically create the marker file wins) —
used so a respawned worker doesn't re-hang forever. Plans round-trip
through the ``DL4JTPU_CHAOS_PLAN`` env var (JSON) so subprocess fleet
workers join the same plan. See docs/robustness.md for the schema.
"""

from __future__ import annotations

import json
import os
import random
import threading
import time
from typing import Any, Dict, Iterable, List, Optional

__all__ = ["CHAOS_PLAN_ENV", "ChaosSource", "FaultPlan", "corrupt_file",
           "truncate_file"]

CHAOS_PLAN_ENV = "DL4JTPU_CHAOS_PLAN"

FAULT_KINDS = ("corrupt-checkpoint", "torn-tmp", "kill-worker", "hang-worker",
               "partial-http", "source-error", "source-slow", "nan-burst")


def corrupt_file(path: str, seed: int, n_bytes: int = 64) -> List[int]:
    """Flip ``n_bytes`` bytes of ``path`` at seed-deterministic offsets."""
    rng = random.Random(seed)
    size = os.path.getsize(path)
    if size == 0:
        return []
    offsets = sorted({rng.randrange(size) for _ in range(max(1, n_bytes))})
    with open(path, "r+b") as fh:
        for off in offsets:
            fh.seek(off)
            b = fh.read(1)
            fh.seek(off)
            fh.write(bytes([b[0] ^ 0xFF]))
    return offsets


def truncate_file(path: str, keep_frac: float = 0.5) -> int:
    """Truncate ``path`` to ``keep_frac`` of its size; return the new size."""
    size = os.path.getsize(path)
    keep = max(0, int(size * float(keep_frac)))
    with open(path, "r+b") as fh:
        fh.truncate(keep)
    return keep


class FaultPlan:
    """A seeded, data-driven schedule of faults over named sites."""

    def __init__(self, seed: int, faults: Optional[Iterable[Dict[str, Any]]] = None):
        self.seed = int(seed)
        self.faults: List[Dict[str, Any]] = [dict(f) for f in (faults or [])]
        for spec in self.faults:
            if spec.get("fault") not in FAULT_KINDS:
                raise ValueError(f"unknown fault kind: {spec.get('fault')!r}")
            if "at" not in spec and "every" not in spec:
                raise ValueError(f"fault spec needs 'at' or 'every': {spec!r}")
        self._lock = threading.Lock()
        self._counts: Dict[str, int] = {}
        self.fired: List[Dict[str, Any]] = []

    # ------------------------------------------------------------- scheduling
    def _matches(self, spec: Dict[str, Any], n: int) -> bool:
        if "at" in spec:
            return n in spec["at"]
        every = int(spec["every"])
        return every > 0 and n % every == 0

    def _claim_marker(self, spec: Dict[str, Any]) -> bool:
        marker = spec.get("marker")
        if not marker:
            return True
        try:
            fd = os.open(marker, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
            os.close(fd)
            return True
        except FileExistsError:
            return False
        except OSError:
            return False

    def fire(self, site: str, **ctx) -> Optional[Dict[str, Any]]:
        """One instrumented call at ``site``; returns the fault fired (if any).

        File-level faults (corrupt/torn-tmp) execute here against the
        paths in ``ctx``; behavioral faults (hang, partial-http, slow,
        error, nan-burst) are returned for the caller to interpret.
        """
        with self._lock:
            n = self._counts.get(site, 0) + 1
            self._counts[site] = n
            hit = None
            for spec in self.faults:
                if spec.get("site") == site and self._matches(spec, n):
                    hit = spec
                    break
            if hit is None or not self._claim_marker(hit):
                return None
            fault = {"site": site, "n": n, "fault": hit["fault"],
                     **dict(hit.get("params") or {})}
            self.fired.append({k: v for k, v in fault.items()})
        self._execute(fault, ctx)
        return fault

    def _execute(self, fault: Dict[str, Any], ctx: Dict[str, Any]) -> None:
        kind = fault["fault"]
        if kind == "corrupt-checkpoint" and ctx.get("path"):
            sub = hash((self.seed, fault["site"], fault["n"])) & 0x7FFFFFFF
            fault["offsets"] = len(corrupt_file(
                ctx["path"], sub, n_bytes=int(fault.get("bytes", 64))))
        elif kind == "torn-tmp" and ctx.get("directory"):
            version = int(ctx.get("version", 0)) + 1
            # A pid that cannot be alive: linux pid_max caps at 2**22.
            name = f".tmp-v{version:08d}-{2**22 + 1}"
            path = os.path.join(ctx["directory"], name)
            with open(path, "wb") as fh:
                fh.write(b"torn write, never completed")
            fault["tmp"] = name

    # ------------------------------------------------------------ inspection
    def schedule(self) -> List[Dict[str, Any]]:
        """The static trigger table (for docs / debugging)."""
        return [dict(spec) for spec in self.faults]

    def summary(self) -> dict:
        with self._lock:
            return {"seed": self.seed, "fired": [dict(f) for f in self.fired],
                    "counts": dict(self._counts)}

    # ---------------------------------------------------------- env transport
    def to_env(self) -> str:
        return json.dumps({"seed": self.seed, "faults": self.faults},
                          sort_keys=True)

    @classmethod
    def from_json(cls, raw: str) -> "FaultPlan":
        data = json.loads(raw)
        return cls(int(data.get("seed", 0)), data.get("faults") or [])

    @classmethod
    def from_env(cls, env=None) -> Optional["FaultPlan"]:
        raw = (env if env is not None else os.environ).get(CHAOS_PLAN_ENV)
        if not raw:
            return None
        try:
            return cls.from_json(raw)
        except Exception:
            return None


class ChaosSource:
    """RecordSource wrapper that injects plan-scheduled source faults.

    Sites: ``source.poll`` fires per poll call (``source-error`` /
    ``source-slow``), ``source.record`` fires per delivered record
    (``nan-burst``). Replay passes straight through to the inner source
    so a wrapped :class:`~..streaming.pipeline.ReplayBufferSource` (or
    any replayable inner) keeps working — wrap the buffer *around* this
    source when the replayed records must include the injected NaNs.
    """

    def __init__(self, inner, plan: FaultPlan):
        self.inner = inner
        self.plan = plan
        self._down_left = 0
        self._nan_left = 0
        self.outages = 0
        self.nan_records = 0

    def poll(self, timeout: float = 0.1):
        fault = self.plan.fire("source.poll")
        if fault is not None:
            if fault["fault"] == "source-error":
                self._down_left = max(self._down_left, int(fault.get("polls", 1)))
                self.outages += 1
            elif fault["fault"] == "source-slow":
                from ..runtime.resilience import Deadline  # noqa: PLC0415
                seconds = float(fault.get("seconds", 0.05))
                Deadline(seconds).pace(seconds)
        if self._down_left > 0:
            self._down_left -= 1
            raise ConnectionError("chaos: source outage")
        rec = self.inner.poll(timeout=timeout)
        if rec is None:
            return None
        fault = self.plan.fire("source.record")
        if fault is not None and fault["fault"] == "nan-burst":
            self._nan_left = max(self._nan_left, int(fault.get("records", 1)))
        if self._nan_left > 0:
            self._nan_left -= 1
            rec = self._poison(rec)
        return rec

    def _poison(self, rec):
        """Replace a record's features with NaN (tuple and dict shapes)."""
        import numpy as np  # noqa: PLC0415
        try:
            if isinstance(rec, (tuple, list)) and len(rec) >= 2:
                f = np.full_like(np.asarray(rec[0], np.float32), np.nan)
                self.nan_records += 1
                return (f,) + tuple(rec[1:])
            if isinstance(rec, dict) and "features" in rec:
                rec = dict(rec)
                rec["features"] = np.full_like(
                    np.asarray(rec["features"], np.float32), np.nan)
                self.nan_records += 1
                return rec
        except Exception:
            pass
        return rec

    def close(self) -> None:
        self.inner.close()

    def __getattr__(self, name):
        # Forward replay_cursor/replay/etc. to the wrapped source.
        return getattr(self.inner, name)
