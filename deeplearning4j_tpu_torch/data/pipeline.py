"""The training input pipeline on the card (the port of
``data/pipeline.py``).

Three pieces keep the host off the step's path:

1. **Device prefetch**: :class:`DevicePrefetchIterator` keeps up to
   ``depth`` batches staged on the device ahead of the consumer, on top of
   an :class:`~deeplearning4j_tpu_torch.data.iterators.AsyncDataSetIterator`
   whose producer thread runs the host ETL.  Staging (:func:`stage`)
   copies each host array into pinned memory, then to the device with
   ``non_blocking=True`` on a copy stream of its own and records an event;
   when the consumer takes the batch its stream waits on that event and
   ``record_stream`` keeps the staged tensors alive until the work queued
   on it has read them.  No pageable host-to-device copy (which would
   synchronize) is left on the way.
2. **On-device normalization**: :class:`DeviceNormalizer` replays a
   fitted host normalizer as ``(x.float() - shift) / scale`` with f32
   ``shift`` and ``scale`` on the device (``affine_stats()``), bitwise
   equal to the host ``transform``; ``set_normalizer`` folds it into the
   training step, ``output`` and ``score_for``.
3. **Staged fused blocks**: :func:`device_blocks` groups an iterator's
   batches into blocks of k staged batches for ``fit_steps``' list form,
   which copies them into the CUDA graph's input buffers on the device.

On the CPU, where the caller asks for it, staging is ``torch.as_tensor``.
"""
from __future__ import annotations

import collections
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch.data.dataset import DataSet, MultiDataSet
from deeplearning4j_tpu_torch.data.iterators import (AsyncDataSetIterator,
                                                     DataSetIterator)
from deeplearning4j_tpu_torch.data.normalizers import (ImagePreProcessingScaler,
                                                       NormalizerMinMaxScaler,
                                                       NormalizerStandardize)
from deeplearning4j_tpu_torch.utils.devices import resolve_device


class ProducerError(RuntimeError):
    """The ETL producer thread failed.  Re-raised on the CONSUMER side of
    `DevicePrefetchIterator` with batch-position context and the original
    exception chained (`__cause__`): a producer crash must fail the
    training loop loudly, never pass for a clean end of epoch."""


# ---------------------------------------------------------------------------
# On-device normalization
# ---------------------------------------------------------------------------

class _SubDiv:
    """`(x.float() - shift) / scale` with f32 stats kept on the device:
    a subtraction and a division, each rounded once, as the host
    `transform` computes them."""

    def __init__(self, shift, scale, device):
        self._stats: Dict[torch.device, tuple] = {}
        self._host = (np.asarray(shift, np.float32), np.asarray(scale, np.float32))
        self._on(torch.device(device))

    def _on(self, device: torch.device):
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        got = self._stats.get(device)
        if got is None:
            got = self._stats[device] = tuple(
                torch.as_tensor(a).to(device) for a in self._host)
        return got

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        sh, sc = self._on(x.device)
        return (x.to(torch.float32) - sh) / sc


class _Const:
    def __init__(self, value: float):
        self.value = float(value)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return torch.full_like(x, self.value, dtype=torch.float32)


class DeviceNormalizer:
    """A fitted host normalizer as tensor operations on the device.

    The statistics go to the device once, when the normalizer is made; the
    apply runs inside the training step (a captured CUDA graph reads them
    at their addresses).  The operations and dtypes are the host
    `transform`'s, so the result is bitwise equal to it."""

    def __init__(self, apply_features, apply_labels=None):
        self._features = apply_features
        self._labels = apply_labels

    def apply_features(self, x):
        return self._features(x)

    def apply_labels(self, y):
        return y if (self._labels is None or y is None) else self._labels(y)

    @staticmethod
    def from_host(nz, device=None) -> "DeviceNormalizer":
        """Build from a *fitted* host normalizer, with its statistics on
        `device` (``"cuda"`` by default); raises TypeError for kinds with no
        per-batch form (e.g. MultiNormalizer: compose per-input
        DeviceNormalizers instead)."""
        if isinstance(nz, DeviceNormalizer):
            return nz
        device = resolve_device(device)
        if isinstance(nz, NormalizerStandardize):
            if nz.mean is None:
                raise ValueError("normalizer is not fitted (call fit first)")
            feats = _SubDiv(nz.mean, nz.std, device)
            labels = None
            if nz.fit_labels and nz.label_mean is not None:
                labels = _SubDiv(nz.label_mean, nz.label_std, device)
            return DeviceNormalizer(feats, labels)
        if isinstance(nz, NormalizerMinMaxScaler):
            if nz.data_min is None:
                raise ValueError("normalizer is not fitted (call fit first)")
            shift, scale = nz.affine_stats()
            if scale is None:
                return DeviceNormalizer(_Const(nz.min_range))
            return DeviceNormalizer(_SubDiv(shift, scale, device))
        if isinstance(nz, ImagePreProcessingScaler):
            shift, scale = nz.affine_stats()
            if scale is None:
                return DeviceNormalizer(_Const(nz.a))
            return DeviceNormalizer(_SubDiv(shift, scale, device))
        raise TypeError(
            f"no on-device form for {type(nz).__name__}; supported: "
            "NormalizerStandardize, NormalizerMinMaxScaler, "
            "ImagePreProcessingScaler (or pass a DeviceNormalizer)")


# ---------------------------------------------------------------------------
# Device staging
# ---------------------------------------------------------------------------

_copy_streams: Dict[int, "torch.cuda.Stream"] = {}


def _copy_stream(device: torch.device) -> "torch.cuda.Stream":
    idx = device.index if device.index is not None else torch.cuda.current_device()
    if idx not in _copy_streams:
        _copy_streams[idx] = torch.cuda.Stream(device=idx)
    return _copy_streams[idx]


class _Stager:
    """Puts one array on `device`: a tensor already there passes through;
    a host array is copied into pinned memory and then, on the copy
    stream, to the device.  The copies' event is kept in `events` for the
    consumer to wait on.  With a `placement` (``parallel.data_sharding``)
    only this rank's row window of each array is staged."""

    def __init__(self, device: torch.device, counted: Optional[Callable] = None,
                 placement=None):
        self.device = device
        self.counted = counted
        self.placement = placement
        self.events = []

    def __call__(self, a):
        if self.placement is not None:
            a = self.placement.window(a)
        if isinstance(a, torch.Tensor) and a.device.type == self.device.type:
            return a
        host = a.contiguous() if isinstance(a, torch.Tensor) else torch.from_numpy(
            np.ascontiguousarray(a))
        if self.counted is not None:
            self.counted(host.numel() * host.element_size())
        if self.device.type != "cuda":
            return host.to(self.device)
        stream = _copy_stream(self.device)
        with torch.cuda.stream(stream):
            out = host.pin_memory().to(self.device, non_blocking=True)
            ev = torch.cuda.Event()
            ev.record(stream)
        self.events.append(ev)
        return out


def _stage_array(a, put):
    if a is None:
        return None
    if isinstance(a, (list, tuple)):
        return type(a)(_stage_array(e, put) for e in a)
    if isinstance(a, dict):
        return {n: _stage_array(e, put) for n, e in a.items()}
    return put(a)


def _tensors(ds):
    for name in ("features", "labels", "features_mask", "labels_mask",
                 "features_masks", "labels_masks"):
        v = getattr(ds, name, None)
        if isinstance(v, dict):
            v = list(v.values())
        for t in (v if isinstance(v, (list, tuple)) else [v]):
            if isinstance(t, torch.Tensor):
                yield t


def _stager(device, placement, counted=None) -> _Stager:
    """A stager for `placement`'s device (and rows), else for `device`."""
    if placement is not None:
        return _Stager(placement.device, counted, placement)
    return _Stager(resolve_device(device), counted)


def stage(ds, device=None, placement=None):
    """Copy one DataSet/MultiDataSet's arrays onto `device` (``"cuda"`` by
    default): returns as soon as the copies are queued (arrays already on
    the device pass through untouched).  A `placement`
    (``parallel.ParallelWrapper.sharded_placement()``) stages only this
    rank's row window of the global batch, onto the rank's device.  Call
    :func:`ready` on the result before a step reads it."""
    return _stage_with(ds, _stager(device, placement))


def _stage_with(ds, put: _Stager):
    if isinstance(ds, MultiDataSet) or hasattr(ds, "features_masks"):
        out = MultiDataSet(
            features=[_stage_array(f, put) for f in ds.features],
            labels=[_stage_array(l, put) for l in ds.labels],
            features_masks=None if ds.features_masks is None else
            [_stage_array(m, put) for m in ds.features_masks],
            labels_masks=None if ds.labels_masks is None else
            [_stage_array(m, put) for m in ds.labels_masks])
    else:
        out = DataSet(_stage_array(ds.features, put), _stage_array(ds.labels, put),
                      _stage_array(getattr(ds, "features_mask", None), put),
                      _stage_array(getattr(ds, "labels_mask", None), put))
    out._staged_events = list(getattr(put, "events", ()))
    return out


def ready(ds):
    """A staged DataSet, with the current stream ordered after its copies
    and the staged tensors' memory tied to that stream (a no-op for one
    that is ready already or was never staged)."""
    events = getattr(ds, "_staged_events", None)
    if events:
        staged = [t for t in _tensors(ds) if t.device.type == "cuda"]
        cur = torch.cuda.current_stream(staged[0].device)
        for ev in events:
            cur.wait_event(ev)
        for t in staged:
            t.record_stream(cur)
        ds._staged_events = None
    return ds


class DevicePrefetchIterator(DataSetIterator):
    """Prefetch-to-device wrapper: host ETL runs in an
    :class:`AsyncDataSetIterator` producer thread, and this iterator keeps
    up to ``depth`` batches staged on the device (copies queued on the copy
    stream) ahead of the consumer.

    ``depth=2`` double-buffers (the next batch's copy overlaps this step's
    compute); ``depth=3`` adds slack for jittery ETL.  Backpressure is
    structural: at most ``depth`` staged batches + ``queue_size`` host
    batches exist at once.  Early-break consumers shut the producer thread
    down through the async layer's stop event (the generator's
    ``finally``), and :meth:`close` does the same for owners that never
    finished iterating.

    A producer-thread exception re-raises HERE as :class:`ProducerError`
    (original chained) instead of silently ending the epoch.  With
    ``retries=N`` (default 0: fail fast) a failing producer is retried up
    to N times with exponential backoff: the underlying iterator is reset
    and replayed past the batches already delivered, so the consumer sees
    an uninterrupted batch sequence.  Retries assume a deterministic,
    restartable underlying iterator.  A `placement`
    (``parallel.ParallelWrapper.sharded_placement()``) stages only this
    rank's rows of each batch, onto the rank's device.
    """

    def __init__(self, underlying: DataSetIterator, depth: int = 2,
                 queue_size: Optional[int] = None, retries: int = 0,
                 retry_backoff_s: float = 0.05, device=None, placement=None):
        if depth < 1:
            raise ValueError(f"depth must be >= 1, got {depth}")
        self.underlying = underlying
        self.depth = int(depth)
        self.placement = placement
        self.device = placement.device if placement is not None else resolve_device(device)
        self.retries = int(retries)
        self.retry_backoff_s = float(retry_backoff_s)
        self._async = AsyncDataSetIterator(
            underlying, queue_size=queue_size if queue_size is not None
            else self.depth)

    def _recover(self, state: dict, exc: BaseException) -> None:
        """One producer-retry round: restart the underlying iterator and
        replay past the `delivered` batches the consumer already has.
        Failures during the replay consume retry budget too; budget
        exhaustion raises `ProducerError` chained to the original."""
        from deeplearning4j_tpu_torch.monitor.instrument import pipeline_instruments
        attempt = state["attempts"] + 1
        if attempt > self.retries:
            raise ProducerError(
                f"input producer failed at batch {state['delivered']}"
                + (f" (after {state['attempts']} retries)"
                   if state["attempts"] else "")
                + f": {exc!r}") from exc
        state["attempts"] = attempt
        pipeline_instruments().producer_retries.inc()
        try:
            state["it"].close()
        except Exception:
            pass
        time.sleep(self.retry_backoff_s * (2 ** (attempt - 1)))
        self.underlying.reset()
        state["it"] = iter(self._async)
        n = 0
        while n < state["delivered"]:
            try:
                next(state["it"])
            except StopIteration:
                raise ProducerError(
                    f"producer ended after {n} batches during retry "
                    f"replay; consumer already received "
                    f"{state['delivered']}") from exc
            except Exception as again:
                self._recover(state, again)   # fully re-replays
                return
            n += 1

    def __iter__(self):
        from deeplearning4j_tpu_torch.monitor.instrument import pipeline_instruments
        ins = pipeline_instruments()
        buf: collections.deque = collections.deque()
        state = {"it": iter(self._async), "delivered": 0, "attempts": 0}

        def next_batch():
            while True:
                try:
                    return next(state["it"])
                except StopIteration:
                    raise
                except Exception as e:
                    self._recover(state, e)

        try:
            while True:
                t0 = time.perf_counter()
                try:
                    ds = next_batch()
                except StopIteration:
                    break
                state["delivered"] += 1
                wait = time.perf_counter() - t0
                buf.append(_stage_with(ds, _stager(self.device, self.placement,
                                                   ins.h2d_bytes.inc)))
                ins.record_stage(wait, len(buf))
                if len(buf) >= self.depth:
                    out = buf.popleft()
                    ins.prefetch_depth.set(len(buf))
                    yield ready(out)
            while buf:
                out = buf.popleft()
                ins.prefetch_depth.set(len(buf))
                yield ready(out)
        finally:
            state["it"].close()    # releases the producer on early break

    def close(self, timeout: float = 2.0) -> None:
        self._async.close(timeout)

    def active_producers(self) -> int:
        return self._async.active_producers()

    def reset(self):
        self.underlying.reset()

    def batch_size(self) -> int:
        return self.underlying.batch_size()

    def __len__(self):
        return len(self.underlying)


# ---------------------------------------------------------------------------
# Device-staged fused blocks
# ---------------------------------------------------------------------------

def device_blocks(iterator, k: int, device=None, placement=None):
    """Group an iterator's batches into fused blocks staged on `device`.

    Yields ``("block", (xs, ys, fms, lms))``, each a list of `k` staged
    per-step tensors (or None), for full same-shape blocks, and
    ``("single", dataset)`` for tails and shape changes (callers run those
    through the per-step path).  The lists feed `fit_steps`' list form.
    Blocks mixing masked and unmasked batches are never fused: `blocks_of`
    keys on mask shapes, and this function checks again, so a mixed block
    degrades to singles instead of dropping masks.  A `placement` stages
    each rank's rows only, as :func:`stage` does."""
    from deeplearning4j_tpu_torch.utils.scan_fit import blocks_of
    for block in blocks_of(iterator, k):
        if len(block) == 1:
            yield "single", block[0]
            continue
        fms = [getattr(ds, "features_mask", None) for ds in block]
        lms = [getattr(ds, "labels_mask", None) for ds in block]
        if (any(m is None for m in fms) != all(m is None for m in fms)
                or any(m is None for m in lms) != all(m is None for m in lms)):
            for ds in block:
                yield "single", ds
            continue
        staged = [ready(stage(ds, device, placement)) for ds in block]
        yield "block", (
            [ds.features for ds in staged],
            [ds.labels for ds in staged],
            None if fms[0] is None else
            [ds.features_mask for ds in staged],
            None if lms[0] is None else
            [ds.labels_mask for ds in staged])
