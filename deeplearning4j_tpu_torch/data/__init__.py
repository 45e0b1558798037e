"""Data containers, iterators, normalizers and the device input pipeline of
the port: DataSet, MultiDataSet, the DataSetIterator family, the fitted
normalizers and DevicePrefetchIterator / DeviceNormalizer /
device_blocks."""
from deeplearning4j_tpu_torch.data.dataset import DataSet, MultiDataSet  # noqa: F401
from deeplearning4j_tpu_torch.data.iterators import (  # noqa: F401
    ArrayDataSetIterator, AsyncDataSetIterator, DataSetIterator,
    ListDataSetIterator)
from deeplearning4j_tpu_torch.data.normalizers import (  # noqa: F401
    ImagePreProcessingScaler, MultiNormalizer, Normalizer,
    NormalizerMinMaxScaler, NormalizerStandardize)
from deeplearning4j_tpu_torch.data.pipeline import (  # noqa: F401
    DeviceNormalizer, DevicePrefetchIterator, ProducerError, device_blocks)
