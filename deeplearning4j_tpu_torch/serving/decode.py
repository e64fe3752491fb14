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

On the bucketed path (``runtime.inference``, the default) a tick is one
replay of the net's captured single-step graph, and the streaming state
lives in that graph's buffers: the slot reset writes zeros into them in
place, and a tick does not take over a state that other code bound to the
net in their stead (the net's own ``rnn_time_step`` does).

Slot lifecycle: ``open()`` claims a free slot and zeroes its state rows in
place on the device, ``step()`` submits one frame, ``close()`` frees the
slot, ``stop()`` ends the ticker. As in the JAX package, ``on_batch`` is
called after each tick (rows, requests, seconds, queue depth, bucket rows)
and ``on_request`` after each step with its latency and trace context; a
session opened under a sampled trace records ``decode.open`` and a
``decode.tick`` span per step under one lineage.
"""

from __future__ import annotations

import threading
import time
import uuid
from concurrent.futures import Future
from typing import Dict, Optional

import numpy as np
import torch

from ..nn.graph.computation_graph import ComputationGraph
from ..runtime import inference as _inf
from ..runtime.compile_manager import next_pow2
from ..telemetry.tracing import current_trace, record_trace_event
from .batcher import MAX_DELAY_ENV, _env_float

__all__ = ["DecodeServer", "DECODE_SLOTS_ENV", "MAX_DELAY_ENV"]

# env knob shared with the JAX package: the slot count (the decode batch;
# the step's latency budget is the batcher's MAX_DELAY_ENV)
DECODE_SLOTS_ENV = "DL4JTPU_SERVE_DECODE_SLOTS"
_DEFAULT_SLOTS = 8
_DEFAULT_DELAY_MS = 2.0


def _state_tensors(state) -> list:
    """The tensors of a streaming state, whatever its nesting (dicts, lists,
    tuples), in order."""
    if isinstance(state, torch.Tensor):
        return [state]
    parts = state.values() if isinstance(state, dict) else state
    return [t for part in parts for t in _state_tensors(part)]


class _Pending:
    __slots__ = ("features", "future", "enqueued", "trace")

    def __init__(self, features: np.ndarray, trace=None):
        self.features = features
        self.future: "Future[np.ndarray]" = Future()
        self.enqueued = time.perf_counter()
        self.trace = trace  # the session's lineage (TraceContext) for this tick


class DecodeServer:
    """Slot-batched streaming decode over one recurrent net."""

    def __init__(self, net, *, capacity: Optional[int] = None,
                 max_delay_ms: Optional[float] = None,
                 on_batch=None, on_request=None):
        self.net = net
        cap = (int(_env_float(DECODE_SLOTS_ENV, _DEFAULT_SLOTS))
               if capacity is None else int(capacity))
        self.capacity = max(1, next_pow2(cap))
        self.max_delay_s = (
            _env_float(MAX_DELAY_ENV, _DEFAULT_DELAY_MS)
            if max_delay_ms is None else float(max_delay_ms)) / 1000.0
        self.ticks = 0  # coalesced steps run
        self._on_batch = on_batch
        self._on_request = on_request
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        # serializes the net's streaming state: the ticker's step vs open()'s
        # slot reset
        self._net_lock = threading.Lock()
        self._sessions: Dict[str, int] = {}      # session id -> slot
        self._pending: Dict[int, _Pending] = {}  # slot -> request
        # session id -> sampled TraceContext: every tick of a session
        # parents under the same context (one lineage across ticks)
        self._traces: Dict[str, object] = {}
        self._closed = False
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()

    # ------------------------------------------------------------ sessions
    def open(self, trace=None) -> str:
        """Claim a free slot; returns the session id. A sampled ``trace``
        (or the thread's current context) becomes the session's lineage:
        each later tick's span parents under it."""
        ctx = trace if trace is not None else current_trace()
        with self._lock:
            used = set(self._sessions.values())
            free = next((i for i in range(self.capacity) if i not in used), None)
            if free is None:
                raise RuntimeError(
                    f"all {self.capacity} decode slots are in use "
                    f"(raise {DECODE_SLOTS_ENV})")
            sid = uuid.uuid4().hex[:12]
            self._sessions[sid] = free
            if ctx is not None and ctx.sampled:
                session_ctx = ctx.child()
                self._traces[sid] = session_ctx
                record_trace_event(session_ctx, "decode.open", session=sid, slot=free)
            self._reset_slot(free)
            return sid

    def close(self, session_id: str) -> None:
        with self._cv:
            slot = self._sessions.pop(session_id, None)
            self._traces.pop(session_id, None)
            pend = self._pending.pop(slot, None) if slot is not None else None
        if pend is not None:
            pend.future.set_exception(RuntimeError("session closed"))

    def sessions(self) -> int:
        with self._lock:
            return len(self._sessions)

    def _reset_slot(self, slot: int) -> None:
        """Zero one slot's rows of the streaming state, in place on the
        device (a fresh session): on the bucketed path these are the rows of
        the buffers the tick's graph reads."""
        with self._net_lock, self.net._infer_lock:
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
            pend = _Pending(features, trace=self._traces.get(session_id))
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
            t0 = time.perf_counter()
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
            done = time.perf_counter()
            for slot, pend in batch.items():
                pend.future.set_result(out[slot])
                if pend.trace is not None and pend.trace.sampled:
                    record_trace_event(pend.trace.child(), "decode.tick", slot=slot,
                                       duration_s=done - pend.enqueued, tick_rows=len(batch))
                if self._on_request is not None:
                    self._on_request(done - pend.enqueued, pend.trace)
            if self._on_batch is not None:
                self._on_batch(rows=len(batch), requests=len(batch), seconds=done - t0,
                               queue_depth=0, bucket_rows=self.capacity)

    def _tick(self, x: np.ndarray, mask: np.ndarray) -> np.ndarray:
        """One masked step of every slot (a graph takes its masks per
        network input): on the bucketed path straight through the inference
        step, which goes on from the state buffers as the slot resets left
        them."""
        graph = isinstance(self.net, ComputationGraph)
        if _inf.fast_path_enabled():
            if graph:
                return _inf.graph_rnn_step(self.net, [x], [mask], adopt=False)[0]
            return _inf.mln_rnn_step(self.net, x, mask, adopt=False)
        if graph:
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
