"""SLO metrics for the serving runtime — a view over the shared registry.

The port of ``serving/metrics.py``.  What an operator needs to hold a
latency SLO on a batched-inference service: end-to-end request latency
percentiles (p50/p95/p99, enqueue→result, queue wait included), queue
depth, batch occupancy (requests per device dispatch), padding overhead
(bucket waste), and bucket-cache hit/miss (a miss is a bucket's first run:
kernel-library load and cuDNN's algorithm choice, which is why the
registry warms buckets up front).

Every counter/gauge/histogram is a child of the process-wide
`monitor.MetricsRegistry`, labeled `server="<instance>"` so concurrent
ModelServers stay distinct; recording is O(1) per event so the batcher's
dispatch loop never blocks on metrics.
"""
from __future__ import annotations

import itertools
from typing import Dict, Optional

from deeplearning4j_tpu_torch.monitor.registry import (Histogram,
                                                       MetricsRegistry,
                                                       registry)
from deeplearning4j_tpu_torch.utils.counters import HitMissCounters


class LatencyWindow:
    """Sliding-window latency sample (last `maxlen` requests) plus
    lifetime count/total — now a thin view over a registry
    `monitor.Histogram` (same nearest-rank percentiles, same bounded
    memory), kept for its serving-flavored API."""

    def __init__(self, maxlen: int = 4096,
                 histogram: Optional[Histogram] = None):
        self._h = histogram if histogram is not None \
            else Histogram("latency_ms", maxlen=maxlen)

    def record(self, ms: float) -> None:
        self._h.observe(ms)

    @property
    def count(self) -> int:
        return self._h.count

    @property
    def total_ms(self) -> float:
        return self._h.sum

    @property
    def max_ms(self) -> float:
        return self._h.max

    def percentiles(self, ps=(50, 95, 99)) -> Dict[str, float]:
        return self._h.percentiles(ps)

    def snapshot(self) -> Dict[str, float]:
        out = self.percentiles()
        n = self._h.count
        out["count"] = n
        out["mean"] = self._h.sum / n if n else 0.0
        out["max"] = self._h.max
        return out


class ServingMetrics:
    """One metrics hub shared by batcher + compile cache + server.

    Exposed through `snapshot()` (a plain JSON-able dict), the UI server's
    `/serving` endpoint, `ui.stats.render_serving_html`, and — as labeled
    series in the shared registry — the Prometheus `/metrics` endpoint.

    Label hygiene: pass an explicit `server_label` (replica identity) and
    `model_label` (the model the replica serves) so a fleet of servers
    lands on aggregatable `{server=, model=}` series instead of minting a
    fresh process-local `server=sN` per instance.  Because the registry's
    get-or-create returns the same child for the same (name, labels), a
    re-registration under the same label pair (a warm re-admission
    rebuilding a ModelServer) reuses the existing series — counters keep
    accumulating, no duplicate family members appear.
    """

    _ids = itertools.count()

    def __init__(self, window: int = 4096,
                 registry_: Optional[MetricsRegistry] = None,
                 server_label: Optional[str] = None,
                 model_label: Optional[str] = None):
        reg = registry_ if registry_ is not None else registry()
        self.registry = reg
        self.server_label = server_label if server_label is not None \
            else f"s{next(ServingMetrics._ids)}"
        self.model_label = model_label
        lbl = {"server": self.server_label}
        if model_label is not None:
            lbl["model"] = model_label
        self._base_labels = dict(lbl)
        self.latency = LatencyWindow(histogram=reg.histogram(
            "serving_latency_ms",
            help="end-to-end request latency, enqueue->result (ms)",
            labels=lbl, maxlen=window))          # enqueue -> result, ms
        self.dispatch_latency = LatencyWindow(histogram=reg.histogram(
            "serving_dispatch_ms", help="device dispatch wall time (ms)",
            labels=lbl, maxlen=window))           # device dispatch, ms
        self.cache = HitMissCounters(
            "compile_cache",
            hits=reg.counter("serving_compile_cache_hits_total",
                             help="bucket-cache hits", labels=lbl),
            misses=reg.counter("serving_compile_cache_misses_total",
                               help="bucket-cache misses (a bucket's "
                               "first run each)", labels=lbl))
        c = reg.counter
        self.submitted = c("serving_submitted_total",
                           help="requests admitted to the queue", labels=lbl)
        self.rejected = c("serving_rejected_total",
                          help="requests shed at admission (queue full / "
                          "shutdown)", labels=lbl)
        self.expired = c("serving_expired_total",
                         help="requests whose deadline passed in queue",
                         labels=lbl)
        self.failed = c("serving_failed_total",
                        help="requests failed in dispatch", labels=lbl)
        self.dispatch_retries = c(
            "serving_dispatch_retries_total",
            help="dispatch attempts retried after a transient error",
            labels=lbl)
        self.completed = c("serving_completed_total",
                           help="requests completed", labels=lbl)
        self.dispatches = c("serving_dispatches_total",
                            help="device dispatches", labels=lbl)
        # dispatch-shape aggregates (occupancy / padding accounting)
        self._requests_dispatched = c(
            "serving_requests_dispatched_total",
            help="requests that reached a device dispatch", labels=lbl)
        self._rows_dispatched = c(
            "serving_rows_dispatched_total",
            help="real rows dispatched", labels=lbl)
        self._rows_padded = c(
            "serving_rows_padded_total",
            help="bucket padding rows dispatched", labels=lbl)
        self._queue_depth = reg.gauge(
            "serving_queue_depth", help="requests waiting in the batcher "
            "queue", labels=lbl)
        self._queue_depth_peak = reg.gauge(
            "serving_queue_depth_peak", help="high-water mark of the "
            "batcher queue", labels=lbl)
        self._sheds: Dict[tuple, object] = {}   # (priority, reason) children

    # ---- recording hooks (called by batcher / cache / server) ----
    def record_submit(self, queue_depth: int) -> None:
        self.submitted.inc()
        self._queue_depth.set(queue_depth)
        self._queue_depth_peak.set_max(queue_depth)

    def record_queue_depth(self, queue_depth: int) -> None:
        self._queue_depth.set(queue_depth)

    def record_dispatch(self, n_requests: int, rows: int,
                        padded_rows: int = 0,
                        dispatch_ms: Optional[float] = None) -> None:
        self.dispatches.inc()
        self.completed.inc(n_requests)
        self._requests_dispatched.inc(n_requests)
        self._rows_dispatched.inc(rows)
        if padded_rows:
            self._rows_padded.inc(padded_rows)
        if dispatch_ms is not None:
            self.dispatch_latency.record(dispatch_ms)

    def record_latency(self, ms: float) -> None:
        self.latency.record(ms)

    def record_padding(self, rows: int) -> None:
        if rows:
            self._rows_padded.inc(rows)

    def record_shed(self, priority: int, reason: str) -> None:
        """One shed decision for a request of `priority` class:
        `reason="rejected"` (refused at admission) or `"expired"`
        (deadline passed in queue).  Lands on the labeled family
        `serving_sheds_total{priority=,reason=}` so shed ordering across
        priority classes is observable per server AND aggregatable per
        model across a fleet."""
        key = (int(priority), str(reason))
        c = self._sheds.get(key)
        if c is None:
            c = self.registry.counter(
                "serving_sheds_total",
                help="requests shed (admission reject / deadline expiry) "
                "by priority class",
                labels=dict(self._base_labels, priority=str(key[0]),
                            reason=key[1]))
            self._sheds[key] = c
        c.inc()

    def sheds_by_priority(self) -> Dict[str, int]:
        """{"<reason>:p<priority>": count} over this server's shed
        decisions (snapshot view of the labeled family)."""
        return {f"{reason}:p{prio}": c.value
                for (prio, reason), c in sorted(self._sheds.items())}

    # ---- derived views ----
    @property
    def mean_batch_occupancy(self) -> float:
        """Requests per device dispatch — > 1 means batching is working."""
        d = self.dispatches.value
        return self._requests_dispatched.value / d if d else 0.0

    @property
    def padding_fraction(self) -> float:
        """Fraction of dispatched rows that were bucket padding."""
        total = self._rows_dispatched.value + self._rows_padded.value
        return self._rows_padded.value / total if total else 0.0

    def snapshot(self) -> Dict[str, object]:
        requests_dispatched = self._requests_dispatched.value
        rows = self._rows_dispatched.value
        padded = self._rows_padded.value
        d = self.dispatches.value
        return {
            "latency_ms": self.latency.snapshot(),
            "dispatch_ms": self.dispatch_latency.snapshot(),
            "queue_depth": int(self._queue_depth.value),
            "queue_depth_peak": int(self._queue_depth_peak.value),
            "submitted": self.submitted.value,
            "completed": self.completed.value,
            "rejected": self.rejected.value,
            "expired": self.expired.value,
            "failed": self.failed.value,
            "dispatches": d,
            "batch_occupancy": requests_dispatched / d if d else 0.0,
            "rows_dispatched": rows,
            "padding_fraction": (padded / (rows + padded)
                                 if rows + padded else 0.0),
            "compile_cache": self.cache.snapshot(),
            "sheds": self.sheds_by_priority(),
        }
