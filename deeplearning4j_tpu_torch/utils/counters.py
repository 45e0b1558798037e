"""Device-resident step counters and paired hit/miss counters (the port of
``utils/counters.py``).

A network's training step reads its iteration and epoch as int32 tensors
on the network's device: the schedules and the updaters' bias corrections
compute from them there (``train/schedules.py``, ``train/updaters.py``),
so no per-step host value reaches the step and a captured CUDA graph
replays with the current counts.  The step adds one to the iteration
tensor in place; the host keeps a shadow int (``model.iteration``) that
:func:`advance` moves in lockstep.  :func:`device_counters` writes the
tensors again (in place, so their addresses stay) only when the host value
was changed from outside, by ``load`` or a manual reset; each such write is
counted in ``counter_uploads``.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from deeplearning4j_tpu_torch.monitor.registry import Counter, registry

#: fresh writes of the host counters into the device tensors: a steady
#: training loop writes once per model (and once per epoch) and then stays
#: flat
counter_uploads = registry().counter(
    "device_counter_uploads_total",
    help="fresh H2D schedule-counter uploads (sync-free loops stay flat)")


def device_counters(model) -> Tuple[torch.Tensor, torch.Tensor]:
    """(iteration, epoch) as int32 0-dim tensors on `model.device`, kept on
    the model.  A tensor is written (``fill_``, no copy from host memory)
    only when the host shadow differs from the value last written."""
    it = getattr(model, "_iter_dev", None)
    if it is None:
        it = model._iter_dev = torch.zeros((), dtype=torch.int32, device=model.device)
        model._iter_sync = None
        model._epoch_dev = torch.zeros((), dtype=torch.int32, device=model.device)
        model._epoch_sync = None
    if model._iter_sync != model.iteration:
        it.fill_(int(model.iteration))
        model._iter_sync = model.iteration
        counter_uploads.inc()
    if model._epoch_sync != model.epoch:
        model._epoch_dev.fill_(int(model.epoch))
        model._epoch_sync = model.epoch
        counter_uploads.inc()
    return it, model._epoch_dev


def advance(model, steps: int = 1) -> None:
    """Record `steps` completed steps: the step added them to the device
    iteration in place; the host shadow follows without reading it."""
    model.iteration += steps
    model._iter_sync = model.iteration


class HitMissCounters:
    """Paired hit/miss counters.  Pass pre-built counters (e.g. registry
    children with a `server` label) to make the pair a view over the shared
    MetricsRegistry."""

    def __init__(self, name: str = "cache", hits: Optional[Counter] = None,
                 misses: Optional[Counter] = None):
        self.name = name
        self.hits = hits if hits is not None else Counter(f"{name}.hits")
        self.misses = misses if misses is not None \
            else Counter(f"{name}.misses")

    def hit(self) -> None:
        self.hits.inc()

    def miss(self) -> None:
        self.misses.inc()

    def snapshot(self) -> Dict[str, float]:
        h, m = self.hits.value, self.misses.value
        return {"hits": h, "misses": m,
                "hit_rate": h / (h + m) if h + m else 0.0}
