"""Updater configs (the config half of ``train/updaters.py``).

Zoo models and the configuration builder name an updater, and the
configuration JSON carries it, so the serving slice ports the config
dataclasses with their fields and JSON form.  Their update math
(``init_state``/``apply``) comes with the training slice.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict


@dataclasses.dataclass
class IUpdater:
    """Base updater config."""

    learning_rate: Any = 1e-3  # float (schedules come with training)

    def to_json(self) -> dict:
        d = {f.name: getattr(self, f.name) for f in dataclasses.fields(self)}
        d["@updater"] = type(self).__name__
        return d

    @staticmethod
    def from_json(d: dict) -> "IUpdater":
        d = dict(d)
        kind = d.pop("@updater")
        if kind not in UPDATERS:
            raise ValueError(f"updater {kind!r} is not ported yet; have "
                             f"{sorted(UPDATERS)}")
        if isinstance(d.get("learning_rate"), dict):
            raise ValueError("learning-rate schedules are not ported yet")
        return UPDATERS[kind](**d)


@dataclasses.dataclass
class Sgd(IUpdater):
    pass


@dataclasses.dataclass
class Nesterovs(IUpdater):
    """Nesterov momentum (cs231n formulation, as the JAX package)."""

    learning_rate: Any = 0.1
    momentum: float = 0.9


@dataclasses.dataclass
class Adam(IUpdater):
    """Adam with epsilon outside the sqrt, as the JAX package."""

    learning_rate: Any = 1e-3
    beta1: float = 0.9
    beta2: float = 0.999
    epsilon: float = 1e-8


UPDATERS: Dict[str, type] = {c.__name__: c for c in [Sgd, Nesterovs, Adam]}
