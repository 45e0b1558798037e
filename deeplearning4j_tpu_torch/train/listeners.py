"""Training listeners (the port of ``train/listeners.py``):
``TrainingListener``, ``ScoreIterationListener``, ``PerformanceListener``,
``EvaluativeListener``, ``CheckpointListener``, ``TimeIterationListener``
and ``CollectScoresListener``.

A network calls ``iteration_done(model, iteration, epoch)`` after each
``fit`` step and ``on_epoch_end(model)`` after each epoch of
``fit(iterator, epochs)``.  Listeners run on the host and never wait for
the card by themselves: ``model.score()`` (which reads the loss back) is
called only when a log line is emitted, so a muted logger costs no
synchronization, and ``CollectScoresListener`` keeps the loss tensors of
``model.score_array()`` until ``scores`` is read.  ``CheckpointListener``
writes the ModelSerializer zip (``model.save``), which copies the
parameters to the host.
"""
from __future__ import annotations

import logging
import os
import time
from typing import Any, List, Optional

log = logging.getLogger("deeplearning4j_tpu_torch")


class TrainingListener:
    def iteration_done(self, model, iteration: int, epoch: int):
        pass

    def on_epoch_end(self, model):
        pass


class ScoreIterationListener(TrainingListener):
    """Log score every N iterations (reference `ScoreIterationListener`)."""

    def __init__(self, print_every: int = 10):
        self.print_every = max(1, print_every)

    def iteration_done(self, model, iteration, epoch):
        # model.score() is the blocking read — only pay it when the record
        # will actually be emitted (level check first), so a muted logger
        # costs zero device syncs per iteration
        if iteration % self.print_every == 0 \
                and log.isEnabledFor(logging.INFO):
            log.info("Score at iteration %d is %.6f", iteration,
                     model.score())


class PerformanceListener(TrainingListener):
    """Throughput tracking (reference `PerformanceListener`): samples/sec
    and iterations/sec over a reporting window."""

    def __init__(self, frequency: int = 10, report_samples: bool = True):
        self.frequency = max(1, frequency)
        self.report_samples = report_samples
        self._t0: Optional[float] = None
        self._iters = 0
        self._samples = 0
        self.last_samples_per_sec: Optional[float] = None
        self.last_iters_per_sec: Optional[float] = None

    def iteration_done(self, model, iteration, epoch):
        now = time.perf_counter()
        if self._t0 is None:
            self._t0 = now
            return
        self._iters += 1
        batch = getattr(model, "_last_batch_size", None)
        if batch:
            self._samples += batch
        if self._iters % self.frequency == 0:
            dt = now - self._t0
            self.last_iters_per_sec = self._iters / dt
            if self._samples:
                self.last_samples_per_sec = self._samples / dt
            log.info("iteration %d: %.1f iters/sec%s", iteration,
                     self.last_iters_per_sec,
                     f", {self.last_samples_per_sec:.1f} samples/sec"
                     if self._samples else "")
            self._t0 = now
            self._iters = 0
            self._samples = 0


class EvaluativeListener(TrainingListener):
    """Periodic evaluation on a held-out iterator (reference
    `EvaluativeListener`)."""

    def __init__(self, iterator, frequency: int = 100,
                 invoke_on: str = "iteration"):
        self.iterator = iterator
        self.frequency = max(1, frequency)
        self.invoke_on = invoke_on            # "iteration" | "epoch"
        self.history: List[float] = []

    def _evaluate(self, model):
        ev = model.evaluate(self.iterator)
        acc = ev.accuracy()
        self.history.append(acc)
        log.info("Evaluation accuracy: %.4f", acc)

    def iteration_done(self, model, iteration, epoch):
        if self.invoke_on == "iteration" and iteration % self.frequency == 0:
            self._evaluate(model)

    def on_epoch_end(self, model):
        if self.invoke_on == "epoch":
            self._evaluate(model)


class CheckpointListener(TrainingListener):
    """Periodic model checkpoints with keep-last-K rotation (reference
    `CheckpointListener.Builder`: everyNIterations / everyNEpochs /
    keepLast / deleteExisting)."""

    def __init__(self, save_dir: str, every_n_iterations: Optional[int] = None,
                 every_n_epochs: Optional[int] = None, keep_last: int = 3,
                 delete_existing: bool = False):
        if (every_n_iterations is None) == (every_n_epochs is None):
            raise ValueError("Exactly one of every_n_iterations/"
                             "every_n_epochs required")
        self.save_dir = save_dir
        self.every_n_iterations = every_n_iterations
        self.every_n_epochs = every_n_epochs
        self.keep_last = keep_last
        os.makedirs(save_dir, exist_ok=True)
        if delete_existing:
            for f in os.listdir(save_dir):
                if f.startswith("checkpoint_") and f.endswith(".zip"):
                    os.remove(os.path.join(save_dir, f))
        self._saved: List[str] = []

    def _save(self, model, tag: str):
        path = os.path.join(self.save_dir, f"checkpoint_{tag}.zip")
        model.save(path)
        self._saved.append(path)
        while len(self._saved) > self.keep_last:
            old = self._saved.pop(0)
            if os.path.exists(old):
                os.remove(old)
        log.info("Checkpoint saved: %s", path)

    def iteration_done(self, model, iteration, epoch):
        if (self.every_n_iterations
                and iteration % self.every_n_iterations == 0):
            self._save(model, f"iter_{iteration}")

    def on_epoch_end(self, model):
        # model.epoch is already the count of completed epochs here (fit()
        # increments it before firing on_epoch_end)
        if self.every_n_epochs and model.epoch % self.every_n_epochs == 0:
            self._save(model, f"epoch_{model.epoch}")

    def last_checkpoint(self) -> Optional[str]:
        return self._saved[-1] if self._saved else None


class TimeIterationListener(TrainingListener):
    """ETA logging (reference `TimeIterationListener`)."""

    def __init__(self, total_iterations: int, frequency: int = 50):
        self.total = total_iterations
        self.frequency = max(1, frequency)
        self._start = time.perf_counter()

    def iteration_done(self, model, iteration, epoch):
        if iteration % self.frequency == 0 and iteration > 0:
            elapsed = time.perf_counter() - self._start
            rate = iteration / elapsed
            remaining = (self.total - iteration) / max(rate, 1e-9)
            log.info("iteration %d/%d, ETA %.0fs", iteration, self.total,
                     remaining)


class CollectScoresListener(TrainingListener):
    """Score history collector (reference `CollectScoresIterationListener`),
    the metrics-storage hook the training UI consumes.

    Collection is sync-free: each callback appends the model's lazy score
    tensor (`score_array()`, a device tensor that may still be in flight) and
    the `scores` property coerces to floats only when the history is read —
    so collecting every iteration does not drain the dispatch pipeline."""

    def __init__(self, frequency: int = 1):
        self.frequency = max(1, frequency)
        self._raw: List[Any] = []          # device tensors until read
        self.iterations: List[int] = []

    def iteration_done(self, model, iteration, epoch):
        if iteration % self.frequency == 0:
            raw = getattr(model, "score_array", None)
            self._raw.append(raw() if raw is not None else model.score())
            self.iterations.append(iteration)

    @property
    def scores(self) -> List[float]:
        """Collected scores as floats (the read is the sync point)."""
        return [float(s) if s is not None else float("nan")
                for s in self._raw]
