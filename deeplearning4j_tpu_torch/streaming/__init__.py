"""Streaming tier (reference: dl4j-streaming Kafka+Camel pipelines;
counterpart of ``deeplearning4j_tpu/streaming/``): record sources, the
micro-batching pipeline and its routes, the embedded broker and the loopback
socket transport."""

from .embedded_kafka import (
    EmbeddedKafkaBroker,
    EmbeddedKafkaConsumer,
    EmbeddedKafkaProducer,
)
from .pipeline import (
    KafkaSource,
    Route,
    QueueSource,
    RecordSource,
    ReplayableSource,
    ReplayBufferSource,
    ServeRoute,
    StreamingPipeline,
    TrainRoute,
)
from .socket_transport import SocketRecordSink, SocketRecordSource, serve_records

__all__ = [
    "EmbeddedKafkaBroker",
    "EmbeddedKafkaConsumer",
    "EmbeddedKafkaProducer",
    "KafkaSource",
    "Route",
    "QueueSource",
    "RecordSource",
    "ReplayBufferSource",
    "ReplayableSource",
    "ServeRoute",
    "SocketRecordSink",
    "SocketRecordSource",
    "StreamingPipeline",
    "TrainRoute",
    "serve_records",
]
