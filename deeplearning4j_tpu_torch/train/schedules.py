"""Learning-rate (and generic hyperparameter) schedules (the port of
``train/schedules.py``).

Each schedule is a pure function of the iteration and epoch counters, which
the port keeps as Python ints, so ``value_at`` returns a Python float.  The
classes, fields and JSON form are the JAX package's, so an updater's
configuration reads and writes the same JSON in both packages.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional


class ISchedule:
    """value_at(iteration, epoch) -> float."""

    def value_at(self, iteration, epoch=0) -> float:
        raise NotImplementedError

    def to_json(self) -> dict:
        d = dataclasses.asdict(self)
        d["@schedule"] = type(self).__name__
        return d

    @staticmethod
    def from_json(d: dict) -> "ISchedule":
        d = dict(d)
        return _SCHEDULES[d.pop("@schedule")](**d)


def _clip(v, lo, hi):
    return min(max(v, lo), hi)


@dataclasses.dataclass
class FixedSchedule(ISchedule):
    value: float

    def value_at(self, iteration, epoch=0):
        return float(self.value)


@dataclasses.dataclass
class StepSchedule(ISchedule):
    """value * decay_rate ^ floor(iter / step)"""
    initial_value: float
    decay_rate: float
    step: float
    schedule_type: str = "ITERATION"  # or EPOCH

    def value_at(self, iteration, epoch=0):
        t = iteration if self.schedule_type == "ITERATION" else epoch
        return self.initial_value * self.decay_rate ** math.floor(t / self.step)


@dataclasses.dataclass
class ExponentialSchedule(ISchedule):
    """value * gamma ^ iter"""
    initial_value: float
    gamma: float
    schedule_type: str = "ITERATION"

    def value_at(self, iteration, epoch=0):
        t = iteration if self.schedule_type == "ITERATION" else epoch
        return self.initial_value * self.gamma ** t


@dataclasses.dataclass
class InverseSchedule(ISchedule):
    """value / (1 + gamma * iter) ^ power"""
    initial_value: float
    gamma: float
    power: float
    schedule_type: str = "ITERATION"

    def value_at(self, iteration, epoch=0):
        t = iteration if self.schedule_type == "ITERATION" else epoch
        return self.initial_value / (1.0 + self.gamma * t) ** self.power


@dataclasses.dataclass
class PolySchedule(ISchedule):
    """value * (1 - iter/maxIter) ^ power"""
    initial_value: float
    power: float
    max_iter: int
    schedule_type: str = "ITERATION"

    def value_at(self, iteration, epoch=0):
        t = iteration if self.schedule_type == "ITERATION" else epoch
        return self.initial_value * (1.0 - _clip(t / self.max_iter, 0.0, 1.0)) ** self.power


@dataclasses.dataclass
class SigmoidSchedule(ISchedule):
    """value / (1 + exp(-gamma * (iter - stepSize)))"""
    initial_value: float
    gamma: float
    step_size: int
    schedule_type: str = "ITERATION"

    def value_at(self, iteration, epoch=0):
        t = iteration if self.schedule_type == "ITERATION" else epoch
        return self.initial_value / (1.0 + math.exp(-self.gamma * (t - self.step_size)))


@dataclasses.dataclass
class RampSchedule(ISchedule):
    """Linear warmup from ~0 to initial_value over num_iter steps."""
    initial_value: float
    num_iter: int

    def value_at(self, iteration, epoch=0):
        return _clip((iteration + 1.0) / self.num_iter, 0.0, 1.0) * self.initial_value


@dataclasses.dataclass
class CycleSchedule(ISchedule):
    """1cycle-style schedule: ramp up then down, then an annealing phase."""
    initial_value: float
    max_value: float
    cycle_length: int
    annealing_length: int = 0
    initial_annealing_value: Optional[float] = None

    def value_at(self, iteration, epoch=0):
        up = self.cycle_length / 2.0
        t = float(iteration)
        in_cycle = min(t, float(self.cycle_length))
        if in_cycle <= up:
            tri = self.initial_value + (self.max_value - self.initial_value) * (in_cycle / up)
        else:
            tri = self.max_value - (self.max_value - self.initial_value) * ((in_cycle - up) / up)
        if self.annealing_length > 0 and t >= self.cycle_length:
            frac = _clip((t - self.cycle_length) / self.annealing_length, 0.0, 1.0)
            init = (self.initial_annealing_value
                    if self.initial_annealing_value is not None
                    else self.initial_value)
            return init * (1.0 - frac)
        return tri


@dataclasses.dataclass
class MapSchedule(ISchedule):
    """Explicit {iteration: value} breakpoints."""
    values: Dict[int, float]
    schedule_type: str = "ITERATION"

    def __post_init__(self):
        # JSON round-trip stringifies int keys — normalize back.
        self.values = {int(k): float(v) for k, v in self.values.items()}

    def value_at(self, iteration, epoch=0):
        t = iteration if self.schedule_type == "ITERATION" else epoch
        keys = sorted(self.values)
        out = self.values[keys[0]]
        for k in keys:
            if t >= k:
                out = self.values[k]
        return out


@dataclasses.dataclass
class WarmupLinearDecaySchedule(ISchedule):
    """Linear warmup then linear decay to zero."""
    peak_value: float
    warmup_iters: int
    total_iters: int

    def value_at(self, iteration, epoch=0):
        t = float(iteration)
        if t < self.warmup_iters:
            return self.peak_value * (t + 1.0) / max(self.warmup_iters, 1)
        return self.peak_value * _clip(
            (self.total_iters - t) / max(self.total_iters - self.warmup_iters, 1),
            0.0, 1.0)


_SCHEDULES = {
    c.__name__: c
    for c in [
        FixedSchedule, StepSchedule, ExponentialSchedule, InverseSchedule,
        PolySchedule, SigmoidSchedule, RampSchedule, CycleSchedule, MapSchedule,
        WarmupLinearDecaySchedule,
    ]
}


def resolve_schedule(lr) -> ISchedule:
    """Accept a float (fixed LR) or an ISchedule."""
    if isinstance(lr, ISchedule):
        return lr
    return FixedSchedule(float(lr))
