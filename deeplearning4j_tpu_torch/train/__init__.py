"""Training: the eleven updaters, gradient normalization, learning-rate
schedules, listeners and evaluation."""
from deeplearning4j_tpu_torch.train.evaluation import (  # noqa: F401
    ROC, Evaluation, EvaluationBinary, EvaluationCalibration, ROCBinary,
    ROCMultiClass, RegressionEvaluation)
from deeplearning4j_tpu_torch.train.listeners import (  # noqa: F401
    CheckpointListener, CollectScoresListener, EvaluativeListener,
    PerformanceListener, ScoreIterationListener, TimeIterationListener,
    TrainingListener)
from deeplearning4j_tpu_torch.train.schedules import (  # noqa: F401
    CycleSchedule, ExponentialSchedule, FixedSchedule, InverseSchedule,
    ISchedule, MapSchedule, PolySchedule, RampSchedule, SigmoidSchedule,
    StepSchedule, WarmupLinearDecaySchedule, resolve_schedule)
from deeplearning4j_tpu_torch.train.updaters import (  # noqa: F401
    AdaDelta, AdaGrad, AdaMax, Adam, AdamW, AMSGrad, IUpdater, Nadam,
    Nesterovs, NoOp, RmsProp, Sgd, UPDATERS, apply_gradient_normalization)
