"""Interop: the JAX package's weights and checkpoints (``jax_params``) and
the Keras-backend gateway (reference: deeplearning4j-keras Py4J
GatewayServer, SURVEY.md §2.7)."""

from .gateway import GatewayClient, GatewayServer

__all__ = ["GatewayClient", "GatewayServer"]
