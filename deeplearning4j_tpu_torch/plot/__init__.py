"""Visualization models (counterpart of ``deeplearning4j_tpu/plot``;
reference: deeplearning4j-core plot/ — Tsne.java, BarnesHutTsne.java)."""

from .tsne import BarnesHutTsne, Tsne

__all__ = ["Tsne", "BarnesHutTsne"]
