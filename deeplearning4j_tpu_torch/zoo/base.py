"""ZooModel base + registry (the port of ``zoo/base.py``)."""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

from deeplearning4j_tpu_torch.train.updaters import Adam, IUpdater

ZOO_REGISTRY: Dict[str, type] = {}


def zoo_model(cls):
    ZOO_REGISTRY[cls.__name__] = cls
    return cls


@dataclasses.dataclass
class ZooModel:
    """Common zoo config: class count, input shape (H, W, C), seed, updater.
    `init_model(device)` returns the initialized network on `device`
    (``"cuda"`` by default)."""

    n_classes: int = 1000
    input_shape: Tuple[int, ...] = (224, 224, 3)
    seed: int = 123
    updater: Optional[IUpdater] = None
    compute_dtype: Optional[str] = None   # "bfloat16" for tensor-core throughput

    def _updater(self) -> IUpdater:
        return self.updater if self.updater is not None else Adam(1e-3)

    def _net(self, net_cls, conf, device):
        if self.compute_dtype:
            conf.compute_dtype = self.compute_dtype
        return net_cls(conf, device=device).init()

    def conf(self):
        raise NotImplementedError

    def init_model(self, device=None):
        raise NotImplementedError
