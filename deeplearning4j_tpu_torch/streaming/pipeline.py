"""Streaming pipelines: records → DataSet → online fit / serving routes
(counterpart of ``deeplearning4j_tpu/streaming/pipeline.py``).

Reference: dl4j-streaming (SURVEY.md §2.4) wires Kafka + Camel + Spark
Streaming: ``BaseKafkaPipeline`` turns a record stream into ``DataSet``s,
``DL4jServeRouteBuilder`` routes them into online ``fit`` or inference with
results published back. Here: a ``RecordSource`` SPI feeding a background
pipeline thread that micro-batches records and hands them to pluggable
routes — ``TrainRoute`` (online fit; one update per micro-batch) and ``ServeRoute`` (predictions to a sink callback/queue). A
Kafka source is provided behind a gated import (kafka-python is not in the
image; any broker client can implement ``RecordSource.poll``).
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np


def _to_device(a: np.ndarray, device):
    """``a`` on ``device``: on the card a non-blocking copy from pinned
    memory, on the CPU a tensor over the array."""
    import torch  # noqa: PLC0415

    t = torch.from_numpy(np.ascontiguousarray(a))
    dev = torch.device(device)
    if dev.type != "cuda":
        return t.to(dev)
    return t.pin_memory().to(dev, non_blocking=True)


class RecordSource:
    """SPI: poll() returns a record (features[, label]) or None when idle."""

    def poll(self, timeout: float = 0.1):
        raise NotImplementedError

    def close(self) -> None:
        pass


class ReplayableSource(RecordSource):
    """Optional replay contract on top of :class:`RecordSource`.

    A replayable source exposes a monotonically increasing **cursor** —
    the count of records it has delivered — and can re-yield any recent
    span ``(start, end]`` of them. The OnlineTrainer uses this after a
    drift rollback: the poisoned span ``[last_good_cursor,
    rollback_cursor]`` is re-ingested through a validation-only pass
    (loss-band gate, no optimizer updates) before normal ingestion
    resumes; sources without the contract keep today's behavior and the
    rollback records an explicit ``replay: unsupported`` event. See
    docs/robustness.md for the full contract.
    """

    def replay_cursor(self) -> int:
        """Records delivered so far (0 before the first poll)."""
        raise NotImplementedError

    def replay(self, start: int, end: int):
        """Iterable of the records delivered in cursor span (start, end].
        Records that have aged out of the source's retention are simply
        absent — replay is best-effort over what is still held."""
        raise NotImplementedError


class ReplayBufferSource(ReplayableSource):
    """Make ANY source replayable by remembering its last ``capacity``
    delivered records (the in-process analogue of broker retention —
    a Kafka-backed source would instead seek on stored offsets)."""

    def __init__(self, inner: RecordSource, capacity: int = 65536):
        import collections  # noqa: PLC0415
        self.inner = inner
        self._buf = collections.deque(maxlen=int(capacity))
        self._n = 0
        self._lock = threading.Lock()

    def poll(self, timeout: float = 0.1):
        rec = self.inner.poll(timeout=timeout)
        if rec is not None:
            with self._lock:
                self._n += 1
                self._buf.append((self._n, rec))
        return rec

    def replay_cursor(self) -> int:
        with self._lock:
            return self._n

    def replay(self, start: int, end: int):
        with self._lock:
            return [rec for i, rec in self._buf if start < i <= end]

    def close(self) -> None:
        self.inner.close()


class QueueSource(RecordSource):
    """In-process source (tests / direct feeding; the 'direct:' Camel route)."""

    def __init__(self, maxsize: int = 1024):
        self._q: "queue.Queue" = queue.Queue(maxsize=maxsize)

    def put(self, features, label=None, timeout: float = 30.0) -> None:
        """Bounded put: raises rather than blocking forever when the consumer
        (pipeline pump) has died — see StreamingPipeline.alive."""
        try:
            self._q.put(
                (np.asarray(features, np.float32),
                 None if label is None else np.asarray(label, np.float32)),
                timeout=timeout,
            )
        except queue.Full:
            raise RuntimeError(
                "QueueSource full after "
                f"{timeout}s — is the StreamingPipeline stopped or dead? "
                "(check pipeline.alive / pipeline.raise_if_failed())"
            ) from None

    def poll(self, timeout: float = 0.1):
        try:
            return self._q.get(timeout=timeout)
        except queue.Empty:
            return None


class KafkaSource(RecordSource):
    """Kafka consumer source (reference: kafka/NDArrayKafkaClient.java).

    Gated: requires the ``kafka`` package (absent in this image — the SPI
    keeps the seam; deserializer maps message bytes → (features, label)).
    """

    def __init__(self, topic: str, deserializer: Callable,
                 consumer_factory: Optional[Callable] = None, **consumer_kwargs):
        # consumer_factory injects any kafka-python-shaped consumer (tests,
        # alternative broker clients); only the default transport is gated.
        if consumer_factory is not None:
            self._consumer = consumer_factory(topic, **consumer_kwargs)
        else:
            try:
                from kafka import KafkaConsumer  # noqa: PLC0415
            except ImportError as e:
                raise ImportError(
                    "kafka-python is required for KafkaSource; implement "
                    "RecordSource.poll over your broker client instead, or "
                    "pass consumer_factory"
                ) from e
            self._consumer = KafkaConsumer(topic, **consumer_kwargs)
        self._deserializer = deserializer

    def poll(self, timeout: float = 0.1):
        polled = self._consumer.poll(timeout_ms=int(timeout * 1000), max_records=1)
        for records in polled.values():
            for rec in records:
                return self._deserializer(rec.value)
        return None

    def close(self) -> None:
        self._consumer.close()


class Route:
    """SPI: receives assembled micro-batches."""

    def on_batch(self, features: np.ndarray, labels: Optional[np.ndarray]) -> None:
        raise NotImplementedError


class TrainRoute(Route):
    """Online learning: one fit step per micro-batch (reference:
    DL4jServeRouteBuilder's fit path)."""

    def __init__(self, net):
        self.net = net
        self.batches_seen = 0

    def on_batch(self, features, labels):
        if labels is None:
            raise ValueError("TrainRoute needs labelled records")
        from ..datasets.iterators import DataSet  # noqa: PLC0415

        self.net.fit(DataSet(features, labels))
        self.batches_seen += 1


class ServeRoute(Route):
    """Inference: predictions go to the sink callback (reference: serving
    route publishing results back to the transport)."""

    def __init__(self, net, sink: Callable[[np.ndarray, np.ndarray], None]):
        self.net = net
        self.sink = sink

    def on_batch(self, features, labels):
        out = np.asarray(self.net.output(features))
        self.sink(features, out)


class StreamingPipeline:
    """Micro-batching pump: source → (batch assembly) → routes.

    ``batch`` records are grouped (padding is NOT applied — records must be
    homogeneous) and every route sees each micro-batch. ``linger`` bounds the
    wait before a short batch is flushed, keeping latency bounded like the
    reference's Camel aggregator timeouts.

    ``device_prefetch``: copy each assembled micro-batch to ``device`` (the
    card unless the caller passes ``device="cpu"``) the moment it is built,
    BEFORE the routes run: through pinned host memory with
    ``non_blocking``, so the copy of batch i overlaps the routes' device
    work still queued for batch i-1. Routes then receive device tensors
    (the networks' ``fit``/``output`` take them as they are).
    """

    def __init__(self, source: RecordSource, routes: Sequence[Route],
                 batch: int = 32, linger: float = 0.5, registry=None,
                 device_prefetch: bool = False, device="cuda"):
        from ..telemetry import get_registry  # noqa: PLC0415

        self.source = source
        self.device = device
        self.routes = list(routes)
        self.batch = int(batch)
        self.linger = float(linger)
        self.device_prefetch = bool(device_prefetch)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        reg = registry if registry is not None else get_registry()
        self._m_staged = reg.counter(
            "dl4jtpu_streaming_device_staged_total",
            "micro-batches device_put ahead of route dispatch")
        self._m_records = reg.counter(
            "dl4jtpu_streaming_records_total",
            "records consumed from the source")
        self._m_batches = reg.counter(
            "dl4jtpu_streaming_batches_total",
            "micro-batches delivered to routes")
        self._m_batch_size = reg.histogram(
            "dl4jtpu_streaming_batch_size",
            "assembled micro-batch sizes",
            buckets=(1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024))
        self._m_errors = reg.counter(
            "dl4jtpu_streaming_pump_failures_total",
            "pump-thread deaths from a route/source error")

    # -- lifecycle ------------------------------------------------------
    def start(self) -> "StreamingPipeline":
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="dl4j-streaming-pipeline")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10)
        self.source.close()
        self.raise_if_failed()

    @property
    def alive(self) -> bool:
        """False once the pump thread exited (route error or stop())."""
        return self._thread is not None and self._thread.is_alive()

    def raise_if_failed(self) -> None:
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()

    # -- pump -----------------------------------------------------------
    def _run(self) -> None:
        buf: List[Tuple[np.ndarray, Optional[np.ndarray]]] = []
        deadline = None
        try:
            while not self._stop.is_set():
                rec = self.source.poll(timeout=0.05)
                now = time.monotonic()
                if rec is not None:
                    # labelled/unlabelled records never share a micro-batch:
                    # flush the current one at a label-presence boundary
                    if buf and (rec[1] is None) != (buf[0][1] is None):
                        self._flush(buf)
                        buf, deadline = [], None
                    buf.append(rec)
                    if deadline is None:
                        deadline = now + self.linger
                if buf and (len(buf) >= self.batch or now >= (deadline or now)):
                    self._flush(buf)
                    buf, deadline = [], None
            # stop() drains: records the source already buffered but the
            # pump never polled were silently dropped before — a producer
            # that put N records and called stop() lost the tail whenever
            # the pump was behind. Poll the source dry (bounded, in case a
            # producer is still live), flushing through the same batch and
            # label-boundary rules, THEN flush the residual partial buffer.
            drain_deadline = time.monotonic() + 5.0
            while time.monotonic() < drain_deadline:
                rec = self.source.poll(timeout=0)
                if rec is None:
                    break
                if buf and (rec[1] is None) != (buf[0][1] is None):
                    self._flush(buf)
                    buf = []
                buf.append(rec)
                if len(buf) >= self.batch:
                    self._flush(buf)
                    buf = []
            if buf:
                self._flush(buf)
        except BaseException as e:  # surfaced on stop()/raise_if_failed()
            self._m_errors.inc()
            self._error = e

    def _flush(self, buf) -> None:
        feats = np.stack([f for f, _ in buf])
        labels = None
        if buf[0][1] is not None:
            labels = np.stack([l for _, l in buf])
        if self.device_prefetch:
            # async H2D from pinned memory: overlaps the previous batch's
            # still-queued route work; routes receive device tensors
            feats = _to_device(feats, self.device)
            if labels is not None:
                labels = _to_device(labels, self.device)
            self._m_staged.inc()
        for route in self.routes:
            route.on_batch(feats, labels)
        self._m_records.inc(len(buf))
        self._m_batches.inc()
        self._m_batch_size.observe(len(buf))
