"""DAG networks: graph vertices and ``ComputationGraph`` (counterpart of
``deeplearning4j_tpu/nn/graph``)."""

from .computation_graph import ComputationGraph
from .vertices import (
    BaseVertex,
    DuplicateToTimeSeriesVertex,
    ElementWiseVertex,
    L2NormalizeVertex,
    L2Vertex,
    LastTimeStepVertex,
    LayerVertex,
    MergeVertex,
    PreprocessorVertex,
    ReshapeVertex,
    ScaleVertex,
    ShiftVertex,
    StackVertex,
    SubsetVertex,
    UnstackVertex,
)

__all__ = [
    "BaseVertex",
    "ComputationGraph",
    "DuplicateToTimeSeriesVertex",
    "ElementWiseVertex",
    "L2NormalizeVertex",
    "L2Vertex",
    "LastTimeStepVertex",
    "LayerVertex",
    "MergeVertex",
    "PreprocessorVertex",
    "ReshapeVertex",
    "ScaleVertex",
    "ShiftVertex",
    "StackVertex",
    "SubsetVertex",
    "UnstackVertex",
]
