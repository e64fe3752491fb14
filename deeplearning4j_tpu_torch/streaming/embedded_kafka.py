"""In-process Kafka analog: a protocol-faithful broker + consumer/producer
implementing the kafka-python client surface, with no external dependency
(counterpart of ``deeplearning4j_tpu/streaming/embedded_kafka.py``).

Reference: dl4j-streaming's tests stand up a real embedded broker
(``dl4j-streaming/src/test/java/org/deeplearning4j/streaming/embedded/
EmbeddedKafkaCluster.java``) so ``NDArrayKafkaClient``/``BaseKafkaPipeline``
exercise true topic/partition/offset semantics rather than a stub. This
module is the equivalent: ``EmbeddedKafkaBroker`` keeps
partitioned, offset-addressed logs per topic; ``EmbeddedKafkaConsumer``
implements the ``kafka.KafkaConsumer`` surface that
``pipeline.KafkaSource`` consumes (``poll(timeout_ms, max_records) ->
{TopicPartition: [ConsumerRecord]}``, ``subscribe``, ``seek``,
``position``, ``commit``/``committed``, ``close``), and
``EmbeddedKafkaProducer`` mirrors ``KafkaProducer.send(topic, value,
key=...)`` with keyed or round-robin partitioning (the reference publishes
NDArray messages through ``NDArrayPublisher``).

Because the surface is faithful, code written against this module runs
unchanged against kafka-python by swapping the factory — which is exactly
the ``KafkaSource(consumer_factory=...)`` seam.
"""

from __future__ import annotations

import threading
import time
import zlib
from collections import namedtuple
from typing import Dict, Iterable, List, Optional, Tuple

# kafka-python's public record types, shape-for-shape.
TopicPartition = namedtuple("TopicPartition", ["topic", "partition"])
ConsumerRecord = namedtuple(
    "ConsumerRecord",
    ["topic", "partition", "offset", "timestamp", "key", "value"],
)
OffsetAndMetadata = namedtuple("OffsetAndMetadata", ["offset", "metadata"])


class EmbeddedKafkaBroker:
    """Partitioned, offset-addressed in-memory log store.

    One broker can back many consumers/producers across threads; every log
    append and fetch is under one lock (the embedded cluster the reference
    tests use is likewise a single local broker, EmbeddedKafkaCluster.java).
    """

    def __init__(self, num_partitions: int = 2):
        if num_partitions < 1:
            raise ValueError("num_partitions must be >= 1")
        self.num_partitions = int(num_partitions)
        self._logs: Dict[TopicPartition, List[ConsumerRecord]] = {}
        self._lock = threading.Lock()
        self._clock = 0  # deterministic timestamps (no wall clock in tests)
        self._rr: Dict[str, int] = {}  # per-topic round-robin for unkeyed sends

    def _ensure_topic(self, topic: str) -> None:
        # owns the lock itself; topics are never deleted, so callers may
        # ensure first and re-acquire for their own critical section
        with self._lock:
            for p in range(self.num_partitions):
                self._logs.setdefault(TopicPartition(topic, p), [])

    def create_topic(self, topic: str) -> None:
        self._ensure_topic(topic)

    def partitions_for(self, topic: str) -> List[TopicPartition]:
        self._ensure_topic(topic)
        with self._lock:
            return [tp for tp in self._logs if tp.topic == topic]

    def append(self, topic: str, value: bytes,
               key: Optional[bytes] = None) -> ConsumerRecord:
        """Produce one message; returns the committed record (with offset).

        Keyed messages hash to a stable partition (ordering per key);
        unkeyed messages round-robin — kafka's default partitioner contract.
        """
        self._ensure_topic(topic)
        with self._lock:
            if key is not None:
                # deterministic across processes (hash() is seed-randomized)
                part = zlib.crc32(bytes(key)) % self.num_partitions
            else:
                part = self._rr.get(topic, 0) % self.num_partitions
                self._rr[topic] = part + 1
            tp = TopicPartition(topic, part)
            log = self._logs[tp]
            self._clock += 1
            rec = ConsumerRecord(topic, part, len(log), self._clock, key, value)
            log.append(rec)
            return rec

    def fetch(self, tp: TopicPartition, offset: int,
              max_records: int) -> List[ConsumerRecord]:
        with self._lock:
            log = self._logs.get(tp, [])
            return list(log[offset:offset + max_records])

    def end_offset(self, tp: TopicPartition) -> int:
        with self._lock:
            return len(self._logs.get(tp, []))


class EmbeddedKafkaProducer:
    """``KafkaProducer.send`` against the embedded broker (NDArrayPublisher
    role — dl4j-streaming/kafka/NDArrayPublisher.java)."""

    def __init__(self, broker: EmbeddedKafkaBroker):
        self._broker = broker
        self.closed = False

    def send(self, topic: str, value: bytes,
             key: Optional[bytes] = None) -> ConsumerRecord:
        if self.closed:
            raise RuntimeError("producer is closed")
        return self._broker.append(topic, value, key=key)

    def flush(self) -> None:  # in-memory appends are already durable
        pass

    def close(self) -> None:
        self.closed = True


class EmbeddedKafkaConsumer:
    """kafka-python ``KafkaConsumer`` surface over an ``EmbeddedKafkaBroker``.

    Implements the exact subset ``pipeline.KafkaSource`` (and typical user
    code) touches: construction with topics, ``subscribe``, ``poll`` with
    ``timeout_ms``/``max_records`` returning ``{TopicPartition:
    [ConsumerRecord]}``, ``position``/``seek``/``seek_to_beginning``,
    ``commit``/``committed``, ``close``. Offsets advance per partition as
    records are handed out, like a real consumer's fetch position.
    """

    def __init__(self, *topics: str, broker: EmbeddedKafkaBroker,
                 group_id: Optional[str] = None,
                 auto_offset_reset: str = "earliest", **_ignored):
        self._broker = broker
        self.group_id = group_id
        if auto_offset_reset not in ("earliest", "latest"):
            raise ValueError(f"bad auto_offset_reset: {auto_offset_reset!r}")
        self._reset = auto_offset_reset
        self._positions: Dict[TopicPartition, int] = {}
        self._committed: Dict[TopicPartition, OffsetAndMetadata] = {}
        self._rr = 0  # fairness cursor across partitions
        self.closed = False
        self._assignment: List[TopicPartition] = []
        if topics:
            self.subscribe(list(topics))

    # -- assignment ----------------------------------------------------
    def subscribe(self, topics: Iterable[str]) -> None:
        self._check_open()
        self._assignment = []
        for t in topics:
            self._assignment.extend(sorted(self._broker.partitions_for(t)))
        for tp in self._assignment:
            if tp not in self._positions:
                self._positions[tp] = (0 if self._reset == "earliest"
                                       else self._broker.end_offset(tp))

    def assignment(self) -> List[TopicPartition]:
        return list(self._assignment)

    # -- positions -----------------------------------------------------
    def position(self, tp: TopicPartition) -> int:
        self._check_open()
        return self._positions[tp]

    def seek(self, tp: TopicPartition, offset: int) -> None:
        self._check_open()
        if tp not in self._positions:
            raise ValueError(f"{tp} is not assigned")
        if int(offset) < 0:
            raise ValueError(f"offset must be >= 0, got {offset}")
        self._positions[tp] = int(offset)

    def seek_to_beginning(self, *tps: TopicPartition) -> None:
        for tp in tps or self._assignment:
            self.seek(tp, 0)

    def commit(self) -> None:
        self._check_open()
        for tp, pos in self._positions.items():
            self._committed[tp] = OffsetAndMetadata(pos, "")

    def committed(self, tp: TopicPartition) -> Optional[OffsetAndMetadata]:
        return self._committed.get(tp)

    # -- fetch ---------------------------------------------------------
    def poll(self, timeout_ms: int = 100, max_records: int = 500
             ) -> Dict[TopicPartition, List[ConsumerRecord]]:
        """Fetch up to ``max_records`` across assigned partitions.

        Partitions are drained fairly (rotating start), each batch keyed by
        TopicPartition exactly as kafka-python returns it. Like the real
        client, an empty topic BLOCKS up to ``timeout_ms`` before returning
        {} — without that, a pipeline polling in a loop busy-spins at 100%
        CPU whenever the topic is drained.
        """
        from ..runtime.resilience import Deadline
        self._check_open()
        deadline = Deadline(max(0, timeout_ms) / 1000.0)
        while True:
            out: Dict[TopicPartition, List[ConsumerRecord]] = {}
            remaining = int(max_records)
            n = len(self._assignment)
            for i in range(n):
                if remaining <= 0:
                    break
                tp = self._assignment[(self._rr + i) % n]
                recs = self._broker.fetch(tp, self._positions[tp], remaining)
                if recs:
                    out[tp] = recs
                    self._positions[tp] += len(recs)
                    remaining -= len(recs)
            self._rr += 1
            if out or deadline.expired:
                return out
            deadline.pace(min(0.005, max(0.0005, timeout_ms / 1000.0 / 4)))

    def close(self) -> None:
        self.closed = True

    def _check_open(self) -> None:
        if self.closed:
            raise RuntimeError("consumer is closed")
