"""Clustering and spatial indexes (counterpart of
``deeplearning4j_tpu/clustering``; reference: deeplearning4j-core
clustering/ — SURVEY.md §2.2)."""

from .kmeans import KMeansClustering
from .trees import KDTree, QuadTree, SPTree, VPTree

__all__ = ["KMeansClustering", "KDTree", "VPTree", "QuadTree", "SPTree"]
