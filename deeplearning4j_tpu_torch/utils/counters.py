"""Paired hit/miss counters for a cache (the serving compile cache)."""
from __future__ import annotations

from typing import Dict, Optional

from deeplearning4j_tpu_torch.monitor.registry import Counter


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
