"""Data containers and iterators of the port: DataSet, MultiDataSet and the
DataSetIterator family."""
from deeplearning4j_tpu_torch.data.dataset import DataSet, MultiDataSet  # noqa: F401
from deeplearning4j_tpu_torch.data.iterators import (  # noqa: F401
    ArrayDataSetIterator, AsyncDataSetIterator, DataSetIterator,
    ListDataSetIterator)
