"""Datasets of the port (counterpart of ``deeplearning4j_tpu/datasets``):
``DataSet`` and the iterators, record readers and their iterators, fetchers
with the bundled digits and Iris, normalizers, and ``.npz`` export. The JAX
package's asynchronous and device-prefetching iterators and its
``bucketing`` helpers are not ported."""

from .iterators import (
    BucketingSequenceIterator,
    DataSet,
    DataSetIterator,
    ExistingDataSetIterator,
    IteratorDataSetIterator,
    IteratorMultiDataSetIterator,
    ListDataSetIterator,
    MultiDataSet,
    MultipleEpochsIterator,
    NumpyDataSetIterator,
    ReconstructionDataSetIterator,
    SamplingDataSetIterator,
    pad_to_bucket,
)
from .records import (
    CollectionRecordReader,
    CollectionSequenceRecordReader,
    CSVRecordReader,
    CSVSequenceRecordReader,
    ImageRecordReader,
    LineRecordReader,
    RecordReader,
    SequenceRecordReader,
)
from .record_iterators import (
    ALIGN_END,
    ALIGN_START,
    EQUAL_LENGTH,
    RecordReaderDataSetIterator,
    RecordReaderMultiDataSetIterator,
    SequenceRecordReaderDataSetIterator,
)
from .fetchers import (
    CifarDataSetIterator,
    CurvesDataSetIterator,
    IrisDataSetIterator,
    LFWDataSetIterator,
    MnistDataSetIterator,
    load_cifar10,
    load_iris,
    load_mnist,
    read_idx,
)
from .normalizers import (
    CombinedPreProcessor,
    DataNormalization,
    ImagePreProcessingScaler,
    NormalizerMinMaxScaler,
    NormalizerStandardize,
    NormalizingIterator,
)

__all__ = [
    "BucketingSequenceIterator", "CombinedPreProcessor", "DataSet", "pad_to_bucket",
    "DataSetIterator", "ExistingDataSetIterator", "IteratorDataSetIterator",
    "IteratorMultiDataSetIterator",
    "ListDataSetIterator", "MultiDataSet", "MultipleEpochsIterator",
    "NumpyDataSetIterator", "ReconstructionDataSetIterator",
    "SamplingDataSetIterator",
    "CollectionRecordReader", "CollectionSequenceRecordReader",
    "CSVRecordReader", "CSVSequenceRecordReader", "ImageRecordReader",
    "LineRecordReader", "RecordReader", "SequenceRecordReader",
    "ALIGN_END", "ALIGN_START", "EQUAL_LENGTH",
    "RecordReaderDataSetIterator", "RecordReaderMultiDataSetIterator",
    "SequenceRecordReaderDataSetIterator",
    "CifarDataSetIterator", "CurvesDataSetIterator", "IrisDataSetIterator",
    "LFWDataSetIterator", "MnistDataSetIterator",
    "load_cifar10", "load_iris", "load_mnist", "read_idx",
    "DataNormalization", "ImagePreProcessingScaler",
    "NormalizerMinMaxScaler", "NormalizerStandardize", "NormalizingIterator",
]
