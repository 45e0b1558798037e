"""SameDiff-style graphs on PyTorch (the port of ``autodiff/``)."""
from deeplearning4j_tpu_torch.autodiff.ops import OP_TABLE, register_op  # noqa: F401
from deeplearning4j_tpu_torch.autodiff.samediff import (  # noqa: F401
    NotPortedError, SameDiff, SDVariable, TrainingConfig)
