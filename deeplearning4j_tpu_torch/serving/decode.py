"""Continuous batching for stateful RNN decode (counterpart of
``deeplearning4j_tpu/serving/decode.py``).

Every client of a streaming decode holds private recurrent state and sends
one token at a time. The server keeps ONE slot-batched stream per net
instead: each session owns a row of the net's streaming ``rnn_time_step``
state, and a ticker coalesces the sessions that have a token pending
(within the latency budget) into a single masked step over all slots.

Exactness rides on the ``rnn_time_step`` mask contract: a slot whose mask is
0 this tick holds its LSTM h/c exactly, so a session's output trajectory is
the one it would have alone.

It serves a ``MultiLayerNetwork`` (streaming state: a tuple of per-layer
dicts) or a ``ComputationGraph`` of one network input (a dict of
per-vertex dicts); the slot reset and the capacity check walk the state's
tensors whatever its nesting, as the JAX package's ``tree_map`` does.

Slot lifecycle: ``open()`` claims a free slot and zeroes its state rows in
place on the device, ``step()`` submits one frame, ``close()`` frees the
slot, ``stop()`` ends the ticker.
"""

from __future__ import annotations

import os
import threading
import time
import uuid
from concurrent.futures import Future
from typing import Dict, Optional

import numpy as np
import torch

from ..nn.graph.computation_graph import ComputationGraph

__all__ = ["DecodeServer", "DECODE_SLOTS_ENV", "MAX_DELAY_ENV"]

# env knobs shared with the JAX package: the slot count (the decode batch)
# and how long a step may wait for company
DECODE_SLOTS_ENV = "DL4JTPU_SERVE_DECODE_SLOTS"
MAX_DELAY_ENV = "DL4JTPU_SERVE_MAX_DELAY_MS"
_DEFAULT_SLOTS = 8
_DEFAULT_DELAY_MS = 2.0


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, default))
    except ValueError:
        return default


def _state_tensors(state) -> list:
    """The tensors of a streaming state, whatever its nesting (dicts, lists,
    tuples), in order."""
    if isinstance(state, torch.Tensor):
        return [state]
    parts = state.values() if isinstance(state, dict) else state
    return [t for part in parts for t in _state_tensors(part)]


def _next_pow2(n: int) -> int:
    return 1 if n <= 1 else 1 << (int(n) - 1).bit_length()


class _Pending:
    __slots__ = ("features", "future", "enqueued")

    def __init__(self, features: np.ndarray):
        self.features = features
        self.future: "Future[np.ndarray]" = Future()
        self.enqueued = time.perf_counter()


class DecodeServer:
    """Slot-batched streaming decode over one recurrent net."""

    def __init__(self, net, *, capacity: Optional[int] = None,
                 max_delay_ms: Optional[float] = None):
        self.net = net
        cap = (int(_env_float(DECODE_SLOTS_ENV, _DEFAULT_SLOTS))
               if capacity is None else int(capacity))
        self.capacity = max(1, _next_pow2(cap))
        self.max_delay_s = (
            _env_float(MAX_DELAY_ENV, _DEFAULT_DELAY_MS)
            if max_delay_ms is None else float(max_delay_ms)) / 1000.0
        self.ticks = 0  # coalesced steps run
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        # serializes the net's streaming state: the ticker's step vs open()'s
        # slot reset
        self._net_lock = threading.Lock()
        self._sessions: Dict[str, int] = {}      # session id -> slot
        self._pending: Dict[int, _Pending] = {}  # slot -> request
        self._closed = False
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()

    # ------------------------------------------------------------ sessions
    def open(self) -> str:
        """Claim a free slot; returns the session id."""
        with self._lock:
            used = set(self._sessions.values())
            free = next((i for i in range(self.capacity) if i not in used), None)
            if free is None:
                raise RuntimeError(
                    f"all {self.capacity} decode slots are in use "
                    f"(raise {DECODE_SLOTS_ENV})")
            sid = uuid.uuid4().hex[:12]
            self._sessions[sid] = free
            self._reset_slot(free)
            return sid

    def close(self, session_id: str) -> None:
        with self._cv:
            slot = self._sessions.pop(session_id, None)
            pend = self._pending.pop(slot, None) if slot is not None else None
        if pend is not None:
            pend.future.set_exception(RuntimeError("session closed"))

    def sessions(self) -> int:
        with self._lock:
            return len(self._sessions)

    def _reset_slot(self, slot: int) -> None:
        """Zero one slot's rows of the streaming state, in place on the
        device (a fresh session)."""
        with self._net_lock:
            if self.net._rnn_state is None:
                return  # the first tick starts from a zero state anyway
            tensors = _state_tensors(self.net._rnn_state)
            if any(t.shape[0] != self.capacity for t in tensors):
                # another batch's state (the net streamed elsewhere): the
                # first tick restarts every slot from zeros
                self.net._rnn_state = None
                return
            for t in tensors:
                t[slot].zero_()

    # ---------------------------------------------------------------- step
    def step(self, session_id: str, features, timeout_s: float = 30.0):
        """One decode step for a session: ``features`` is a single frame.
        Returns the net's output row for it once the tick it joined ran."""
        features = np.asarray(features)
        with self._cv:
            slot = self._sessions.get(session_id)
            if slot is None:
                raise KeyError(f"unknown decode session {session_id!r}")
            if slot in self._pending:
                raise RuntimeError(
                    f"session {session_id!r} already has a step in flight")
            pend = _Pending(features)
            self._pending[slot] = pend
            self._cv.notify()
        return pend.future.result(timeout=timeout_s)

    # --------------------------------------------------------------- ticker
    def _collect(self) -> Dict[int, _Pending]:
        with self._cv:
            while not self._pending and not self._closed:
                self._cv.wait(timeout=0.1)
            if self._closed:
                return {}
            first_t = min(p.enqueued for p in self._pending.values())
            deadline = first_t + self.max_delay_s
            # wait out the budget so concurrent sessions join this tick; a
            # full set of sessions dispatches at once
            while len(self._pending) < len(self._sessions) and not self._closed:
                remaining = deadline - time.perf_counter()
                if remaining <= 0:
                    break
                self._cv.wait(timeout=remaining)
            batch = dict(self._pending)
            self._pending.clear()
            return batch

    def _run(self) -> None:
        while True:
            batch = self._collect()
            if not batch:
                if self._closed:
                    return
                continue
            try:
                feat_shape = next(iter(batch.values())).features.shape
                x = np.zeros((self.capacity, 1) + tuple(feat_shape), np.float32)
                mask = np.zeros((self.capacity, 1), np.float32)
                for slot, pend in batch.items():
                    x[slot, 0] = pend.features
                    mask[slot, 0] = 1.0
                with self._net_lock:
                    out = self._tick(x, mask)
                    self.ticks += 1
                if out.ndim == 3:  # [slots, 1, C] -> [slots, C]
                    out = out[:, 0]
            except Exception as e:  # noqa: BLE001 - fail THIS tick only
                for pend in batch.values():
                    pend.future.set_exception(e)
                continue
            for slot, pend in batch.items():
                pend.future.set_result(out[slot])

    def _tick(self, x: np.ndarray, mask: np.ndarray) -> np.ndarray:
        """One masked step of every slot: a graph takes its masks per
        network input."""
        if isinstance(self.net, ComputationGraph):
            return self.net.rnn_time_step(x, features_masks=mask)
        return self.net.rnn_time_step(x, features_mask=mask)

    def stop(self) -> None:
        with self._cv:
            self._closed = True
            pend = list(self._pending.values())
            self._pending.clear()
            self._cv.notify_all()
        for p in pend:
            p.future.set_exception(RuntimeError("decode server stopped"))
        self._worker.join(timeout=5)
