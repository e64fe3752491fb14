"""Serving front end (counterpart of ``deeplearning4j_tpu/serving``).

Layers (bottom up):

- :mod:`runtime.inference` — the bucketed path every entry point here
  dispatches through (the boundary cast, power-of-two buckets with masked
  padding, one CUDA graph a bucket in the process-wide compile manager,
  fused argmax).
- :mod:`serving.batcher` — dynamic micro-batching: concurrent requests
  coalesce under a latency budget (``DL4JTPU_SERVE_MAX_DELAY_MS``,
  ``DL4JTPU_SERVE_MAX_BATCH``) into one padded dispatch.
- :mod:`serving.decode` — continuous batching for stateful RNN decode:
  sessions own slots of one shared streaming state; masked ticks step only
  the sessions with a pending token.
- :mod:`serving.service` — the multi-model registry, admission control and
  the serving metrics (``dl4jtpu_serve_*``).
"""

from .batcher import MAX_BATCH_ENV, MAX_DELAY_ENV, MicroBatcher
from .decode import DECODE_SLOTS_ENV, DecodeServer
from .service import (LATENCY_BUDGET_ENV, MAX_QUEUE_ENV, AdmissionError,
                      InferenceService, ServiceDraining, get_service,
                      reset_services, service_names, set_service)

__all__ = [
    "AdmissionError",
    "DECODE_SLOTS_ENV",
    "DecodeServer",
    "InferenceService",
    "LATENCY_BUDGET_ENV",
    "MAX_BATCH_ENV",
    "MAX_DELAY_ENV",
    "MAX_QUEUE_ENV",
    "MicroBatcher",
    "ServiceDraining",
    "get_service",
    "reset_services",
    "service_names",
    "set_service",
]
