"""Data containers, iterators, normalizers and the device input pipeline of
the port: DataSet, MultiDataSet, the DataSetIterator family, DataVec's
record readers, Schema / TransformProcess and LocalTransformExecutor, the
record-reader and built-in dataset iterators, the fitted normalizers and
DevicePrefetchIterator / DeviceNormalizer / device_blocks."""
from deeplearning4j_tpu_torch.data.dataset import DataSet, MultiDataSet  # noqa: F401
from deeplearning4j_tpu_torch.data.iterators import (  # noqa: F401
    ArrayDataSetIterator, AsyncDataSetIterator, DataSetIterator,
    ListDataSetIterator)
from deeplearning4j_tpu_torch.data.records import (  # noqa: F401
    CollectionRecordReader, CSVRecordReader, CSVSequenceRecordReader,
    ImageRecordReader, JacksonLineRecordReader, LibSvmRecordReader,
    LineRecordReader, RecordReader, RegexLineRecordReader,
    RegexSequenceRecordReader, SVMLightRecordReader,
    TransformProcessRecordReader, TransformProcessSequenceRecordReader,
    VideoRecordReader)
from deeplearning4j_tpu_torch.data.local_execution import (  # noqa: F401
    LocalTransformExecutor)
from deeplearning4j_tpu_torch.data.transform import (  # noqa: F401
    ColumnMeta, Schema, TransformProcess)
from deeplearning4j_tpu_torch.data.normalizers import (  # noqa: F401
    ImagePreProcessingScaler, MultiNormalizer, Normalizer,
    NormalizerMinMaxScaler, NormalizerStandardize)
from deeplearning4j_tpu_torch.data.pipeline import (  # noqa: F401
    DeviceNormalizer, DevicePrefetchIterator, ProducerError, device_blocks)
from deeplearning4j_tpu_torch.data.rr_iterator import (  # noqa: F401
    RecordReaderDataSetIterator, SequenceRecordReaderDataSetIterator)
from deeplearning4j_tpu_torch.data.datasets import (  # noqa: F401
    Cifar10DataSetIterator, EmnistDataSetIterator, ImdbReviewIterator,
    IrisDataSetIterator, MnistDataSetIterator, SyntheticCifar10,
    SyntheticImdb, SyntheticMnist, read_idx)
