"""Datasets of the port (counterpart of ``deeplearning4j_tpu/datasets``):
``DataSet`` and the iterators (the prefetching ones among them), the
bucketed stager of ``fit(stage_on_device=K)``, record readers and their
iterators, fetchers with the bundled digits and Iris, normalizers, and
``.npz`` export."""

from .bucketing import (
    BucketedStager,
    PaddedWindow,
    bucket_length,
    pad_batch_arrays,
)
from .iterators import (
    AsyncDataSetIterator,
    AsyncMultiDataSetIterator,
    BucketingSequenceIterator,
    DevicePrefetchIterator,
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
    "AsyncDataSetIterator", "AsyncMultiDataSetIterator", "DevicePrefetchIterator",
    "BucketedStager", "PaddedWindow", "bucket_length", "pad_batch_arrays",
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
