"""Early stopping (the port of ``train/earlystopping.py``; reference
``deeplearning4j-core/.../earlystopping/**``: `EarlyStoppingConfiguration`,
the termination conditions, `DataSetLossCalculator`, the in-memory and
local-file model savers, `EarlyStoppingTrainer`, `EarlyStoppingResult`).

The same conditions, scores and trainer loop as the JAX package, over a
MultiLayerNetwork or ComputationGraph of the port.  The in-memory saver
keeps clones of the best epoch's tensors and writes them back into the
live network's tensors (in place, so a captured fused block keeps
replaying them); the local-file saver writes the ModelSerializer zip both
packages read."""
from __future__ import annotations

import dataclasses
import logging
import os
import time
from typing import Any, List, Optional

import torch

log = logging.getLogger("deeplearning4j_tpu_torch")


# ---- epoch termination conditions ----

class EpochTerminationCondition:
    """`score` is None on epochs where no evaluation ran
    (evaluate_every_n_epochs > 1); score-based conditions skip those."""

    def initialize(self):
        pass

    def terminate(self, epoch: int, score: Optional[float],
                  best_score: float, best_epoch: int) -> bool:
        raise NotImplementedError


class MaxEpochsTerminationCondition(EpochTerminationCondition):
    def __init__(self, max_epochs: int):
        self.max_epochs = max_epochs

    def terminate(self, epoch, score, best_score, best_epoch):
        return epoch + 1 >= self.max_epochs


class ScoreImprovementEpochTerminationCondition(EpochTerminationCondition):
    """Stop after `patience` epochs without at least `min_improvement` of
    improvement.  Tracks its own best (the trainer's best-model tracking
    uses strict improvement, which would defeat min_improvement)."""

    def __init__(self, patience: int, min_improvement: float = 0.0):
        self.patience = patience
        self.min_improvement = min_improvement
        self._best: Optional[float] = None
        self._epochs_since = 0

    def initialize(self):
        self._best = None
        self._epochs_since = 0

    def terminate(self, epoch, score, best_score, best_epoch):
        if score is None:
            return False
        if self._best is None or score < self._best - self.min_improvement:
            self._best = score
            self._epochs_since = 0
            return False
        self._epochs_since += 1
        return self._epochs_since > self.patience


class BestScoreEpochTerminationCondition(EpochTerminationCondition):
    """Stop once score <= target (loss-style scores)."""

    def __init__(self, target: float):
        self.target = target

    def terminate(self, epoch, score, best_score, best_epoch):
        return score is not None and score <= self.target


# ---- iteration termination conditions ----

class IterationTerminationCondition:
    def initialize(self):
        pass

    def terminate(self, score: float) -> bool:
        raise NotImplementedError


class MaxScoreIterationTerminationCondition(IterationTerminationCondition):
    """Abort mid-epoch on divergence (score explodes / NaN)."""

    def __init__(self, max_score: float):
        self.max_score = max_score

    def terminate(self, score):
        return not (score == score) or score > self.max_score  # NaN or >


class MaxTimeIterationTerminationCondition(IterationTerminationCondition):
    """Clock starts when training starts (initialize()), not at config
    construction: setup and capture time must not count."""

    def __init__(self, max_seconds: float):
        self.max_seconds = max_seconds
        self._start: Optional[float] = None

    def initialize(self):
        self._start = time.perf_counter()

    def terminate(self, score):
        if self._start is None:
            self._start = time.perf_counter()
        return time.perf_counter() - self._start > self.max_seconds


# ---- score calculators ----

class DataSetLossCalculator:
    """Validation loss (reference `DataSetLossCalculator`): average
    score_for over an iterator; lower is better."""

    def __init__(self, iterator, average: bool = True):
        self.iterator = iterator
        self.average = average

    def calculate_score(self, model) -> float:
        total, n = 0.0, 0
        if hasattr(self.iterator, "reset"):
            self.iterator.reset()
        for ds in self.iterator:
            total += model.score_for(ds.features, ds.labels)
            n += 1
        return total / max(n, 1) if self.average else total


class ClassificationScoreCalculator:
    """1 - accuracy as a minimizable score (reference
    `ClassificationScoreCalculator` with Metric.ACCURACY)."""

    def __init__(self, iterator):
        self.iterator = iterator

    def calculate_score(self, model) -> float:
        return 1.0 - model.evaluate(self.iterator).accuracy()


# ---- model savers ----

def _clone_tree(tree):
    if isinstance(tree, dict):
        return {k: _clone_tree(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().clone()
    return tree


@torch.no_grad()
def _copy_tree(dst, src) -> None:
    if isinstance(dst, dict):
        for k, d in dst.items():
            _copy_tree(d, src[k])
    elif isinstance(dst, torch.Tensor):
        dst.copy_(src)


class InMemoryModelSaver:
    """Keeps clones of the best epoch's parameters, layer state and
    updater state; `get_best_model` writes them back into the model's own
    tensors and returns the model."""

    def __init__(self):
        self._best = None
        self._best_model_ref = None

    def save_best_model(self, model):
        self._best = _clone_tree({"params": model.params_, "state": model.state_,
                                  "opt": model.opt_state_})
        self._best_model_ref = model

    def save_latest_model(self, model):
        pass                       # latest == the live model object

    def get_best_model(self):
        if self._best is None:
            return None
        model = self._best_model_ref
        _copy_tree({"params": model.params_, "state": model.state_,
                    "opt": model.opt_state_}, self._best)
        return model


class LocalFileModelSaver:
    """``bestModel.zip`` / ``latestModel.zip`` under `directory`, in the
    ModelSerializer format both packages read."""

    def __init__(self, directory: str):
        self.directory = directory
        os.makedirs(directory, exist_ok=True)
        self._model_cls = None     # set on first save THIS run: a stale
        self._device = None        # bestModel.zip of an earlier run is never returned

    def save_best_model(self, model):
        model.save(os.path.join(self.directory, "bestModel.zip"))
        self._model_cls = type(model)
        self._device = model.device

    def save_latest_model(self, model):
        model.save(os.path.join(self.directory, "latestModel.zip"))
        self._model_cls = type(model)
        self._device = model.device

    def get_best_model(self):
        if self._model_cls is None:
            return None
        path = os.path.join(self.directory, "bestModel.zip")
        if not os.path.exists(path):
            return None
        return self._model_cls.load(path, device=self._device)


# ---- configuration + trainer ----

@dataclasses.dataclass
class EarlyStoppingConfiguration:
    score_calculator: Any
    epoch_termination_conditions: List[EpochTerminationCondition]
    iteration_termination_conditions: List[IterationTerminationCondition] = \
        dataclasses.field(default_factory=list)
    model_saver: Any = dataclasses.field(default_factory=InMemoryModelSaver)
    evaluate_every_n_epochs: int = 1
    save_last_model: bool = False


@dataclasses.dataclass
class EarlyStoppingResult:
    termination_reason: str            # EpochTerminationCondition | ...
    termination_details: str
    score_vs_epoch: dict
    best_model_epoch: int
    best_model_score: float
    total_epochs: int
    best_model: Any


class EarlyStoppingTrainer:
    """Reference `EarlyStoppingTrainer`/`BaseEarlyStoppingTrainer.fit()`."""

    def __init__(self, config: EarlyStoppingConfiguration, model, train_iterator):
        self.config = config
        self.model = model
        self.train_iterator = train_iterator

    def fit(self) -> EarlyStoppingResult:
        cfg = self.config
        for c in (list(cfg.epoch_termination_conditions)
                  + list(cfg.iteration_termination_conditions)):
            c.initialize()
        best_score = float("inf")
        best_epoch = -1
        scores = {}
        epoch = 0
        reason, details = "unknown", ""
        done = False
        while not done:
            # one training epoch, with divergence checks per iteration
            if hasattr(self.train_iterator, "reset"):
                self.train_iterator.reset()
            for ds in self.train_iterator:
                self.model.fit(ds.features, ds.labels)
                s = self.model.score()
                for itc in cfg.iteration_termination_conditions:
                    if itc.terminate(s):
                        reason = "IterationTerminationCondition"
                        details = f"{type(itc).__name__} at score {s}"
                        done = True
                        break
                if done:
                    break
            if done:
                break
            # evaluate on schedule; epoch conditions run EVERY epoch
            # (score=None on non-eval epochs: max-epochs etc. must not
            # overshoot when evaluate_every_n_epochs > 1)
            score = None
            if (epoch + 1) % cfg.evaluate_every_n_epochs == 0:
                score = cfg.score_calculator.calculate_score(self.model)
                scores[epoch] = score
                if score < best_score:
                    best_score, best_epoch = score, epoch
                    cfg.model_saver.save_best_model(self.model)
                    log.info("New best model at epoch %d, score %.6f", epoch, score)
            for etc in cfg.epoch_termination_conditions:
                if etc.terminate(epoch, score, best_score, best_epoch):
                    reason = "EpochTerminationCondition"
                    details = type(etc).__name__
                    done = True
                    break
            epoch += 1
        if cfg.save_last_model and hasattr(cfg.model_saver, "save_latest_model"):
            cfg.model_saver.save_latest_model(self.model)
        return EarlyStoppingResult(
            termination_reason=reason, termination_details=details,
            score_vs_epoch=scores, best_model_epoch=best_epoch,
            best_model_score=best_score, total_epochs=epoch,
            best_model=cfg.model_saver.get_best_model() or self.model)
