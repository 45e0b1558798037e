"""Deterministic fault injection for resilience testing (the port of
``utils/chaos.py``, its training half).

Every injector here is reproducible (fires at a fixed step or batch, flips
a byte at a deterministic offset) and counts itself in the metrics
registry (``chaos_faults_injected_total{kind=...}``), so a chaos run's
blast radius is observable next to the recovery counters it should
trigger.

    KillSwitch           kill-at-step-N hook for FaultTolerantTrainer
                         (SIGTERM / hard-kill / in-process exception)
    PeerKiller           kill/hang/partition/slow ONE gang rank at step N
                         (elastic-gang detection/reformation scenarios)
    corrupt_checkpoint   flip payload bytes, tear or truncate the manifest
    FlakyIterator        data producer that raises at batch K (N times)
    SlowIterator         data producer with a fixed per-batch stall

``"kill"`` is ``os._exit(9)`` with the CUDA context live: no cleanup runs,
and the gang's survivors see the socket close.  The serving half
(``FlakyDispatch``, ``ReplicaChaos``, ``HostChaos``, ``HandoffChaos``) is
not ported: it waits for the serving fleet.  None of this is imported by
the training code: tests and game days compose it in.
"""
from __future__ import annotations

import os
import signal
import time
from typing import Optional

from deeplearning4j_tpu_torch.data.iterators import DataSetIterator
from deeplearning4j_tpu_torch.monitor.registry import registry


class ChaosError(RuntimeError):
    """The injected failure (so tests can distinguish chaos from real
    bugs)."""


def _count(kind: str) -> None:
    registry().counter(
        "chaos_faults_injected_total",
        help="faults injected by utils.chaos, by kind",
        labels={"kind": kind}).inc()


class KillSwitch:
    """Step hook: kill the process (or raise) once `model.iteration`
    reaches `at_step`.

    `mode`:
      * ``"sigterm"`` — `os.kill(os.getpid(), SIGTERM)`: exercises the
        trainer's preemption checkpoint-and-exit path;
      * ``"kill"``    — `os._exit(9)`: a hard kill, no cleanup, no final
        checkpoint — resume must come from the last *committed* save;
      * ``"exception"`` — raise :class:`ChaosError` in-process.

    `marker` (a file path) makes the switch one-shot across relaunches:
    the first firing writes the marker, later runs see it and stay
    disarmed — the standard shape for kill-and-resume tests."""

    def __init__(self, at_step: int, mode: str = "sigterm",
                 marker: Optional[str] = None):
        if mode not in ("sigterm", "kill", "exception"):
            raise ValueError(f"unknown KillSwitch mode {mode!r}")
        self.at_step = int(at_step)
        self.mode = mode
        self.marker = marker
        self.fired = False

    def armed(self) -> bool:
        if self.fired:
            return False
        return self.marker is None or not os.path.exists(self.marker)

    def __call__(self, trainer) -> None:
        model = getattr(trainer, "model", trainer)
        if not self.armed() or int(model.iteration) < self.at_step:
            return
        self.fired = True
        if self.marker is not None:
            with open(self.marker, "w") as f:
                f.write(str(int(model.iteration)))
        _count(self.mode)
        if self.mode == "sigterm":
            os.kill(os.getpid(), signal.SIGTERM)
        elif self.mode == "kill":
            os._exit(9)
        else:
            raise ChaosError(
                f"KillSwitch fired at iteration {model.iteration}")


class PeerKiller:
    """Step hook that injects a GANG-LEVEL fault into one chosen rank.

    Runs as an `ElasticTrainer` hook on EVERY worker; only the worker
    whose elastic mesh currently holds `rank` fires (the rank is read
    live from the model's gradient sharing, so reformations that remap
    ranks are honored).  `mode`:

      * ``"kill"``      — `os._exit(9)`: the coordinator sees EOF and
        reforms with cause ``crash``;
      * ``"hang"``      — sleep `duration_s` WITHOUT heartbeating pause
        (the HB thread keeps running): the peer stays live but ships no
        data, so the coordinator reforms with cause ``straggler``;
      * ``"partition"`` — pause the mesh's heartbeat thread and sleep
        `duration_s`: full silence on a healthy socket, the coordinator
        reforms with cause ``partition`` and the victim — if it wakes —
        finds itself evicted (:class:`GangEvictedError`);
      * ``"slow"``      — sleep `delay_s` once (bounded, below the
        failure deadline): NO reformation may occur — the
        detection-threshold negative control.

    `marker` (file path) makes it one-shot across relaunches, exactly
    like :class:`KillSwitch` — a relaunched replacement of the killed
    rank must not re-fire."""

    def __init__(self, rank: int, at_step: int, mode: str = "kill",
                 duration_s: float = 5.0, delay_s: float = 0.2,
                 marker: Optional[str] = None):
        if mode not in ("kill", "hang", "partition", "slow"):
            raise ValueError(f"unknown PeerKiller mode {mode!r}")
        self.rank = int(rank)
        self.at_step = int(at_step)
        self.mode = mode
        self.duration_s = float(duration_s)
        self.delay_s = float(delay_s)
        self.marker = marker
        self.fired = False

    def armed(self) -> bool:
        if self.fired:
            return False
        return self.marker is None or not os.path.exists(self.marker)

    @staticmethod
    def _mesh_of(trainer):
        model = getattr(trainer, "model", trainer)
        sharing = getattr(model, "_grad_sharing", None)
        return getattr(sharing, "mesh", None) if sharing is not None \
            else None

    def __call__(self, trainer) -> None:
        model = getattr(trainer, "model", trainer)
        mesh = self._mesh_of(trainer)
        rank = mesh.rank if mesh is not None else 0
        if not self.armed() or rank != self.rank \
                or int(model.iteration) < self.at_step:
            return
        self.fired = True
        if self.marker is not None:
            with open(self.marker, "w") as f:
                f.write(str(int(model.iteration)))
        _count(f"peer-{self.mode}")
        if self.mode == "kill":
            os._exit(9)
        elif self.mode == "hang":
            time.sleep(self.duration_s)
        elif self.mode == "partition":
            if mesh is not None and hasattr(mesh, "pause_heartbeats"):
                mesh.pause_heartbeats(True)
            time.sleep(self.duration_s)
            if mesh is not None and hasattr(mesh, "pause_heartbeats"):
                mesh.pause_heartbeats(False)
        else:                       # "slow": bounded, below the deadline
            time.sleep(self.delay_s)


def corrupt_checkpoint(directory: str, what: str = "payload") -> str:
    """Deterministically damage a committed checkpoint directory.

    `what`:
      * ``"payload"``       — flip one byte in the middle of the first
        ``shards-*.npz`` (caught by the per-chunk crc32 on restore);
      * ``"manifest"``      — overwrite ``manifest.json`` with truncated
        (torn-write) JSON;
      * ``"uncommit"``      — delete the manifest, turning the checkpoint
        back into an uncommitted torn directory.

    Returns the path of the file damaged."""
    if what == "uncommit":
        target = os.path.join(directory, "manifest.json")
        os.remove(target)
        _count("uncommit")
        return target
    if what == "manifest":
        target = os.path.join(directory, "manifest.json")
        with open(target) as f:
            text = f.read()
        with open(target, "w") as f:
            f.write(text[: max(1, len(text) // 2)])
        _count("manifest")
        return target
    if what != "payload":
        raise ValueError(f"unknown corruption kind {what!r}")
    shards = sorted(n for n in os.listdir(directory)
                    if n.startswith("shards-") and n.endswith(".npz"))
    if not shards:
        raise FileNotFoundError(f"{directory}: no shards-*.npz to corrupt")
    target = os.path.join(directory, shards[0])
    with open(target, "rb") as f:
        data = bytearray(f.read())
    data[len(data) // 2] ^= 0xFF
    with open(target, "wb") as f:
        f.write(bytes(data))
    _count("payload")
    return target


class FlakyIterator(DataSetIterator):
    """Wraps a DataSetIterator; raises `exc_type` when batch `fail_at`
    would be produced, `times` times total (across epochs/resets), then
    behaves normally — the transient-producer-failure shape the
    pipeline's `retries=` recovers from."""

    def __init__(self, underlying: DataSetIterator, fail_at: int = 0,
                 times: int = 1, exc_type=ChaosError):
        self.underlying = underlying
        self.fail_at = int(fail_at)
        self.failures_left = int(times)
        self.exc_type = exc_type

    def __iter__(self):
        for i, ds in enumerate(self.underlying):
            if i == self.fail_at and self.failures_left > 0:
                self.failures_left -= 1
                _count("producer")
                raise self.exc_type(
                    f"injected producer failure at batch {i}")
            yield ds

    def reset(self):
        self.underlying.reset()

    def batch_size(self) -> int:
        return self.underlying.batch_size()

    def __len__(self):
        return len(self.underlying)


class SlowIterator(DataSetIterator):
    """Wraps a DataSetIterator with a fixed `delay_s` sleep per batch —
    for backpressure / stuck-pipeline readiness scenarios."""

    def __init__(self, underlying: DataSetIterator, delay_s: float = 0.05):
        self.underlying = underlying
        self.delay_s = float(delay_s)

    def __iter__(self):
        for ds in self.underlying:
            time.sleep(self.delay_s)
            yield ds

    def reset(self):
        self.underlying.reset()

    def batch_size(self) -> int:
        return self.underlying.batch_size()

    def __len__(self):
        return len(self.underlying)
