"""DataSetIterator implementations (the port of ``data/iterators.py``, the
whole module: numpy and threading, no device code).

Reference: `DataSetIterator`/`MultiDataSetIterator` interfaces and the
stock iterators (`nd4j-api/.../dataset/api/iterator/**`,
`deeplearning4j-core/.../datasets/iterator/**`): ListDataSetIterator,
ExistingDataSetIterator, IteratorDataSetIterator, AsyncDataSetIterator
(background-thread prefetch).

The async iterator reproduces `AsyncDataSetIterator`'s role — overlap host
ETL with device compute — using a daemon thread + bounded queue.  The
port's step queues its kernels without waiting for them, so a queue depth
of 2 keeps the card fed.  A model moves each batch to its device in `fit`.
"""
from __future__ import annotations

import queue
import threading
from typing import Iterator, List, Optional, Sequence

import numpy as np

from deeplearning4j_tpu_torch.data.dataset import DataSet


class DataSetIterator:
    """Iterator protocol (reference `DataSetIterator`): iterable over
    DataSet batches, with `reset()`, `batch_size()`, and
    `set_pre_processor()` (reference `setPreProcessor(DataSetPreProcessor)`
    — normalizers/augmenters applied to every batch on the way out)."""

    def __iter__(self) -> Iterator[DataSet]:
        raise NotImplementedError

    def __init_subclass__(cls, **kw):
        # Aspect-wrap each subclass's __iter__ so an attached pre-processor
        # runs on every yielded batch (the reference applies preProcess in
        # BaseDatasetIterator.next()); subclasses stay oblivious.
        super().__init_subclass__(**kw)
        raw = cls.__dict__.get("__iter__")
        if raw is None:
            return

        def wrapped(self):
            import copy
            pp = getattr(self, "_pre_processor", None)
            for ds in raw(self):
                if pp is not None:
                    # shallow-copy first: normalizers REBIND ds.features on
                    # the copy, so iterators that yield cached DataSet
                    # objects (ListDataSetIterator) don't get re-normalized
                    # on the next epoch
                    ds = copy.copy(ds)
                    out = pp.pre_process(ds) if hasattr(pp, "pre_process") \
                        else pp.transform(ds)
                    ds = out if out is not None else ds
                yield ds

        cls.__iter__ = wrapped

    def set_pre_processor(self, pp) -> "DataSetIterator":
        self._pre_processor = pp
        return self

    def pre_processor(self):
        return getattr(self, "_pre_processor", None)

    def reset(self):
        pass

    def batch_size(self) -> int:
        raise NotImplementedError


class ListDataSetIterator(DataSetIterator):
    """Iterate a pre-built list of DataSets (reference
    `ListDataSetIterator`)."""

    def __init__(self, datasets: Sequence[DataSet], batch_size: Optional[int] = None):
        if batch_size is not None and len(datasets) == 1:
            datasets = datasets[0].batch_by(batch_size)
        self._list: List[DataSet] = list(datasets)
        self._bs = batch_size or (self._list[0].num_examples() if self._list else 0)

    def __iter__(self):
        return iter(self._list)

    def __len__(self):
        return len(self._list)

    def batch_size(self) -> int:
        return self._bs


class ArrayDataSetIterator(DataSetIterator):
    """Batch plain (features, labels) arrays, with optional shuffling per
    epoch (the common `new ListDataSetIterator<>(dataSet.batchBy(n))`
    pattern)."""

    def __init__(self, features: np.ndarray, labels: np.ndarray,
                 batch_size: int, shuffle: bool = False, seed: int = 0,
                 drop_last: bool = False):
        self.features = np.asarray(features)
        self.labels = np.asarray(labels)
        self._bs = int(batch_size)
        self._shuffle = shuffle
        self._rng = np.random.default_rng(seed)
        self._drop_last = drop_last

    def __iter__(self):
        n = self.features.shape[0]
        idx = self._rng.permutation(n) if self._shuffle else np.arange(n)
        end = (n // self._bs) * self._bs if self._drop_last else n
        for i in range(0, end, self._bs):
            sl = idx[i:i + self._bs]
            yield DataSet(self.features[sl], self.labels[sl])

    def __len__(self):
        n = self.features.shape[0]
        return n // self._bs if self._drop_last else -(-n // self._bs)

    def batch_size(self) -> int:
        return self._bs


class AsyncDataSetIterator(DataSetIterator):
    """Background-prefetch wrapper (reference `AsyncDataSetIterator`,
    `deeplearning4j-core/.../datasets/iterator/AsyncDataSetIterator.java`):
    a daemon thread pulls from the underlying iterator into a bounded queue
    so host-side ETL overlaps device compute.

    A consumer that stops early (``break``, exception, GC of the generator)
    must not strand the producer blocked on ``q.put`` forever: every put is
    a bounded-wait retry loop against a per-iteration stop event, set by the
    generator's ``finally`` and by :meth:`close`.
    """

    _END = object()
    _POLL_S = 0.05          # producer stop-event poll while queue is full

    def __init__(self, underlying: DataSetIterator, queue_size: int = 2):
        self.underlying = underlying
        self.queue_size = queue_size
        self._producers: List[tuple] = []    # live (stop_event, thread)

    def _put_or_stop(self, q, stop, item) -> bool:
        """Bounded-wait put honoring `stop`; True if the item was enqueued."""
        while not stop.is_set():
            try:
                q.put(item, timeout=self._POLL_S)
                return True
            except queue.Full:
                continue
        return False

    def __iter__(self):
        q: "queue.Queue" = queue.Queue(maxsize=self.queue_size)
        stop = threading.Event()
        err: List[BaseException] = []

        def producer():
            try:
                for ds in self.underlying:
                    if not self._put_or_stop(q, stop, ds):
                        return               # consumer went away
            except BaseException as e:  # propagate to consumer
                err.append(e)
            finally:
                self._put_or_stop(q, stop, self._END)

        t = threading.Thread(target=producer, daemon=True)
        self._producers.append((stop, t))
        t.start()
        try:
            while True:
                item = q.get()
                if item is self._END:
                    if err:
                        raise err[0]
                    return
                yield item
        finally:
            # early break / exception / GC: release the producer (it may be
            # blocked on a full queue) and let the daemon thread exit
            stop.set()
            self._producers = [(s, th) for s, th in self._producers
                               if th.is_alive() and th is not t]

    def close(self, timeout: float = 2.0) -> None:
        """Stop all live producer threads (idempotent).  Consumers that
        exhaust or break out of the iterator clean up automatically; this
        is for owners that never started / never finished iterating."""
        producers, self._producers = self._producers, []
        for stop, _ in producers:
            stop.set()
        for _, t in producers:
            t.join(timeout)

    def active_producers(self) -> int:
        """Live producer-thread count (diagnostics / leak tests)."""
        self._producers = [(s, t) for s, t in self._producers
                           if t.is_alive()]
        return len(self._producers)

    def reset(self):
        self.underlying.reset()

    def batch_size(self) -> int:
        return self.underlying.batch_size()
