"""Observability tier (counterpart of ``deeplearning4j_tpu/ui``): stats
storage, StatsListener, ConvolutionalIterationListener and the browser UI
with its JSON API and serving endpoints (reference:
deeplearning4j-ui-parent — SURVEY.md §2.8, §5.5)."""

from .storage import (
    StatsStorage,
    StatsStorageRouter,
    InMemoryStatsStorage,
    FileStatsStorage,
    SqliteStatsStorage,
    RemoteStatsStorageRouter,
)
from .stats_listener import StatsListener
from .conv_listener import ConvolutionalIterationListener, post_tsne
from .server import UIServer

__all__ = [
    "ConvolutionalIterationListener",
    "post_tsne",
    "StatsStorage",
    "StatsStorageRouter",
    "InMemoryStatsStorage",
    "FileStatsStorage",
    "SqliteStatsStorage",
    "RemoteStatsStorageRouter",
    "StatsListener",
    "UIServer",
]
