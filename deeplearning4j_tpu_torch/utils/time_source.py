"""Cross-node time sources (counterpart of
``deeplearning4j_tpu/utils/time_source.py``; reference:
spark/time/TimeSource.java + NTPTimeSource.java — NTP-synced timestamps so
master/worker phase stats line up across machines, SURVEY.md §2.4 "Spark
stats/instrumentation").

Hosts of one cluster share NTP-disciplined clocks, so the default
SystemTimeSource suffices; OffsetTimeSource reproduces the reference's explicit-offset
behavior for environments that need correction without an NTP daemon."""

from __future__ import annotations

import time


class TimeSource:
    """SPI: current time in milliseconds since epoch."""

    def current_time_millis(self) -> int:
        raise NotImplementedError


class SystemTimeSource(TimeSource):
    """reference: SystemClockTimeSource."""

    def current_time_millis(self) -> int:
        return int(time.time() * 1000)


class OffsetTimeSource(TimeSource):
    """Fixed-offset corrected clock (reference: NTPTimeSource caches the
    NTP-derived offset and applies it to the local clock)."""

    def __init__(self, offset_millis: int = 0):
        self.offset_millis = int(offset_millis)

    def current_time_millis(self) -> int:
        return int(time.time() * 1000) + self.offset_millis

    @staticmethod
    def from_reference(reference_millis: int) -> "OffsetTimeSource":
        """Offset from a trusted reference timestamp (e.g. the coordinator's
        clock at connection time)."""
        return OffsetTimeSource(reference_millis - int(time.time() * 1000))
