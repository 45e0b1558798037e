"""Training configuration (the update math comes with the training slice)."""
from deeplearning4j_tpu_torch.train.updaters import (  # noqa: F401
    Adam, IUpdater, Nesterovs, Sgd, UPDATERS)
