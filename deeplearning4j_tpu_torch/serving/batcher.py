"""Continuous request batcher with deadlines, priority and admission
control.

The port of ``serving/batcher.py`` (host code, unchanged in behaviour).
Many small concurrent client requests are aggregated into few large device
dispatches because per-dispatch overhead (host→device hop, kernel launch)
dominates at small batch.

* **Heterogeneous shapes** — requests are grouped by a `group` key
  (model, trailing dims, dtype); only compatible requests are concatenated
  into one dispatch, so mixed-shape traffic no longer crashes the
  concatenate.  The compile cache then pads each dispatch up to a
  power-of-two bucket.
* **Deadlines** — `deadline_ms` per request; a request still queued when
  its deadline passes fails fast with `DeadlineExceededError`
  (a `TimeoutError`) instead of occupying a batch slot for an answer the
  client has already abandoned.
* **Priority with aging** — higher-priority requests seed dispatch groups
  first.  A queued request whose deadline is approaching gets an aging
  bump (`aging_bump`, applied once less than `aging_fraction` of its
  deadline budget remains) so a continuous stream of high-priority
  traffic cannot starve low-priority entries straight past their
  deadline: near-deadline requests escalate above fresh arrivals and
  either dispatch or are shed *deliberately*, with every shed decision
  counted per priority class (`serving_sheds_total{priority=,reason=}`).
* **Admission control / backpressure** — the queue is bounded
  (`max_queue` requests); submits beyond it shed load with
  `RejectedError` immediately, keeping tail latency bounded for admitted
  traffic instead of letting the queue grow without limit.
* **Graceful shutdown** — `shutdown(drain=True)` stops admission, lets
  queued requests dispatch, joins the worker, then fails anything left.
  Idempotent.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from concurrent.futures import Future
from typing import Callable, List, Optional, Tuple

import numpy as np

from deeplearning4j_tpu_torch.serving.metrics import ServingMetrics


class RejectedError(RuntimeError):
    """Request refused at admission: queue full (load shed) or server
    shutting down.  Clients should back off / retry elsewhere."""


class DeadlineExceededError(TimeoutError):
    """The request's deadline passed before it could be dispatched."""


@dataclasses.dataclass(eq=False)      # identity eq: list.remove() must not
class _Request:                        # compare the numpy payloads
    x: np.ndarray
    future: Future
    group: Tuple
    priority: int
    enqueued: float                  # time.monotonic()
    deadline: Optional[float]        # absolute monotonic, or None


class ContinuousBatcher:
    """Aggregates concurrent `submit()`s into batched dispatches.

    `dispatch_fn(group, xs)` receives the group key and the list of
    per-request arrays (all same trailing dims) and returns the list of
    per-request outputs.  One daemon worker thread runs the collect →
    dispatch loop; futures resolve on that thread.
    """

    def __init__(self, dispatch_fn: Callable[[Tuple, List[np.ndarray]],
                                             List[np.ndarray]],
                 max_batch: int = 32, batch_timeout_ms: float = 5.0,
                 max_queue: int = 256,
                 metrics: Optional[ServingMetrics] = None,
                 aging_fraction: float = 0.5,
                 aging_bump: int = 1 << 20):
        self.dispatch_fn = dispatch_fn
        self.max_batch = int(max_batch)
        self.batch_timeout = float(batch_timeout_ms) / 1000.0
        self.max_queue = int(max_queue)
        # deadline aging: once less than `aging_fraction` of a request's
        # deadline budget remains, its effective priority jumps by
        # `aging_bump` (default: above any sane client priority) so it
        # seeds the next dispatch instead of starving behind a continuous
        # high-priority stream
        self.aging_fraction = float(aging_fraction)
        self.aging_bump = int(aging_bump)
        self.metrics = metrics if metrics is not None else ServingMetrics()
        self._pending: List[_Request] = []
        self._cond = threading.Condition()
        self._stop = False
        self._draining = False
        self._inflight_since: Optional[float] = None   # monotonic
        self._worker = threading.Thread(target=self._loop, daemon=True,
                                        name="serving-batcher")
        self._worker.start()

    # ---- client side ----
    def submit(self, x: np.ndarray, group: Tuple = ("default",),
               priority: int = 0,
               deadline_ms: Optional[float] = None) -> Future:
        """Enqueue one request; returns a Future resolving to its output
        rows.  Raises `RejectedError` when the queue is full or the
        batcher is shutting down."""
        x = np.asarray(x)
        now = time.monotonic()
        req = _Request(
            x=x, future=Future(), group=tuple(group), priority=int(priority),
            enqueued=now,
            deadline=None if deadline_ms is None
            else now + float(deadline_ms) / 1000.0)
        with self._cond:
            if self._stop or self._draining:
                self.metrics.rejected.inc()
                self.metrics.record_shed(req.priority, "rejected")
                raise RejectedError(
                    "batcher is shut down; no new requests accepted")
            if len(self._pending) >= self.max_queue:
                self.metrics.rejected.inc()
                self.metrics.record_shed(req.priority, "rejected")
                raise RejectedError(
                    f"request queue full ({self.max_queue} pending); "
                    "load shed — back off and retry")
            self._pending.append(req)
            self.metrics.record_submit(len(self._pending))
            self._cond.notify_all()
        return req.future

    def cancel(self, fut: Future) -> bool:
        """Retire one queued request NOW: remove it from the queue, cancel
        its future, and release its admission slot immediately (waking
        anything waiting on queue capacity).  Before this, retirement
        accounting only settled at group boundaries — a request abandoned
        mid-group kept occupying a `max_queue` slot until the worker's
        next `_collect` pass got around to expiry.  Returns False when the
        future is unknown or already dispatched (a dispatched request
        cannot be recalled from the device)."""
        with self._cond:
            for r in self._pending:
                if r.future is fut:
                    self._pending.remove(r)
                    self.metrics.record_queue_depth(len(self._pending))
                    self._cond.notify_all()
                    fut.cancel()
                    return True
        return False

    @property
    def queue_depth(self) -> int:
        with self._cond:
            return len(self._pending)

    @property
    def accepting(self) -> bool:
        """Whether a `submit()` right now would be admitted (ignoring
        queue pressure) — the readiness-probe signal."""
        with self._cond:
            return not (self._stop or self._draining)

    @property
    def inflight_age_s(self) -> Optional[float]:
        """Seconds the worker has been inside the CURRENT dispatch_fn
        call, or None when no dispatch is running — a large value means
        the device path is stuck and the server should stop advertising
        ready."""
        since = self._inflight_since
        return None if since is None else time.monotonic() - since

    # ---- worker side ----
    def _effective_priority(self, r: _Request, now: float) -> int:
        """Client priority plus the deadline-aging bump: once less than
        `aging_fraction` of the request's deadline budget remains, it
        escalates above normal traffic so it dispatches (or expires with
        a counted shed) instead of starving in place."""
        if r.deadline is None:
            return r.priority
        budget = max(r.deadline - r.enqueued, 1e-9)
        if (r.deadline - now) <= self.aging_fraction * budget:
            return r.priority + self.aging_bump
        return r.priority

    def _expire_locked(self) -> None:
        """Fail and drop past-deadline requests (caller holds the lock).
        Requests whose future was cancelled out from under us (client-side
        `Future.cancel` instead of `ContinuousBatcher.cancel`) are dropped
        too — never dispatched, never `set_result` on a cancelled future."""
        now = time.monotonic()
        alive = []
        for r in self._pending:
            if r.future.cancelled():
                continue
            if r.deadline is not None and now > r.deadline:
                self.metrics.expired.inc()
                self.metrics.record_shed(r.priority, "expired")
                r.future.set_exception(DeadlineExceededError(
                    f"deadline passed after "
                    f"{(now - r.enqueued) * 1000:.1f} ms in queue"))
            else:
                alive.append(r)
        self._pending = alive

    def _collect(self) -> Optional[List[_Request]]:
        """Block for a seed request, then aggregate same-group requests
        until the row budget is met or the batching window closes.
        Returns None when stopped and drained; [] to re-loop."""
        with self._cond:
            while not self._pending:
                if self._stop:
                    return None
                self._cond.wait(timeout=0.1)
            self._expire_locked()
            if not self._pending:
                return []
            # highest effective priority first (client priority + aging
            # bump near deadline), FIFO within a level
            now = time.monotonic()
            self._pending.sort(
                key=lambda r: (-self._effective_priority(r, now),
                               r.enqueued))
            group = self._pending[0].group
            window_end = time.monotonic() + self.batch_timeout
            while True:
                matching = [r for r in self._pending if r.group == group]
                rows = sum(r.x.shape[0] for r in matching)
                now = time.monotonic()
                if (rows >= self.max_batch or now >= window_end
                        or self._stop or self._draining):
                    take, total = [], 0
                    for r in matching:
                        if take and total + r.x.shape[0] > self.max_batch:
                            break     # would overflow the row budget
                        take.append(r)
                        total += r.x.shape[0]
                        if total >= self.max_batch:
                            break
                    for r in take:
                        self._pending.remove(r)
                    self.metrics.record_queue_depth(len(self._pending))
                    self._cond.notify_all()
                    return take
                self._cond.wait(timeout=max(window_end - now, 1e-4))
                self._expire_locked()
                if not self._pending:
                    return []

    def _dispatch(self, batch: List[_Request]) -> None:
        xs = [r.x for r in batch]
        t0 = time.monotonic()
        self._inflight_since = t0
        try:
            outs = self.dispatch_fn(batch[0].group, xs)
        except Exception as e:         # propagate to every waiter
            self.metrics.failed.inc(len(batch))
            for r in batch:
                if not r.future.cancelled():
                    r.future.set_exception(e)
            return
        finally:
            self._inflight_since = None
        now = time.monotonic()
        if len(outs) != len(batch):
            err = RuntimeError(
                f"dispatch_fn returned {len(outs)} outputs for "
                f"{len(batch)} requests")
            self.metrics.failed.inc(len(batch))
            for r in batch:
                if not r.future.cancelled():
                    r.future.set_exception(err)
            return
        self.metrics.record_dispatch(
            n_requests=len(batch), rows=sum(x.shape[0] for x in xs),
            dispatch_ms=(now - t0) * 1000.0)
        for r, o in zip(batch, outs):
            if r.future.cancelled():
                continue
            self.metrics.record_latency((now - r.enqueued) * 1000.0)
            r.future.set_result(o)

    def _loop(self) -> None:
        while True:
            batch = self._collect()
            if batch is None:
                return
            if batch:
                self._dispatch(batch)

    # ---- lifecycle ----
    def shutdown(self, drain: bool = True, timeout: float = 10.0) -> None:
        """Stop admission, optionally drain queued requests through the
        worker, join it, and fail anything left undispatched.  Safe to
        call any number of times."""
        with self._cond:
            already = self._stop
            self._draining = True
            self._cond.notify_all()
        if already:
            # idempotent re-entry: the first call owns the teardown
            self._worker.join(timeout=timeout)
            return
        if drain:
            end = time.monotonic() + timeout
            with self._cond:
                while self._pending and time.monotonic() < end:
                    self._cond.wait(timeout=0.05)
        with self._cond:
            self._stop = True
            self._cond.notify_all()
        self._worker.join(timeout=timeout)
        with self._cond:
            leftovers, self._pending = self._pending, []
        for r in leftovers:
            r.future.set_exception(RejectedError(
                "batcher shut down before this request was dispatched"))
