"""Training: updaters (Sgd, NoOp, Nesterovs, Adam), gradient normalization
and learning-rate schedules."""
from deeplearning4j_tpu_torch.train.schedules import (  # noqa: F401
    CycleSchedule, ExponentialSchedule, FixedSchedule, InverseSchedule,
    ISchedule, MapSchedule, PolySchedule, RampSchedule, SigmoidSchedule,
    StepSchedule, WarmupLinearDecaySchedule, resolve_schedule)
from deeplearning4j_tpu_torch.train.updaters import (  # noqa: F401
    Adam, IUpdater, Nesterovs, NoOp, Sgd, UPDATERS,
    apply_gradient_normalization)
