"""Model configuration factories."""

from .dbn import dbn_conf

__all__ = ["dbn_conf"]
