"""Data containers of the port: DataSet and MultiDataSet."""
from deeplearning4j_tpu_torch.data.dataset import DataSet, MultiDataSet  # noqa: F401
