"""ModelServer — the serving front door (the port of ``serving/server.py``).

    registry  (name, version) -> model          [serving.registry]
    batcher   concurrent submits -> dispatches   [serving.batcher]
    cache     dispatch -> bucket forward         [serving.compile_cache]
    metrics   SLO observability                  [serving.metrics]

Request path: `submit(name, x)` resolves the model entry (so a version
roll never reroutes an in-flight request), groups by (model, trailing
dims, dtype) in the continuous batcher, which concatenates compatible
requests and hands the merged batch to the bucket cache; the cache pads to
the power-of-two bucket and runs the model's forward on its device (Dense
layers through the Hopper ``fused_dense`` kernel on CUDA); rows are split
back per request and each Future resolves.

Example:

    srv = ModelServer(max_batch=16, device="cuda")
    srv.deploy("vgg", zoo="VGG16", warmup=True)
    fut = srv.submit("vgg", x, deadline_ms=500.0)    # x: [n, 224, 224, 3]
    y = fut.result()
    srv.shutdown()           # graceful: drains in-flight futures

`deploy(name, onnx=path_or_bytes)` imports an ONNX model on the server's
device; a raw graph serves only once quantized (`deploy(name,
model=quant.quantize_model(graph), input_shape=...)`).

Not ported yet: sharded serving (`mesh=`, which raises
`NotImplementedError`), the persistent executable cache, autotuned
schedules and Keras deployment (`keras=` raises `NotImplementedError`).
"""
from __future__ import annotations

import threading
import time
from concurrent.futures import Future
from typing import List, Optional, Tuple

import numpy as np

from deeplearning4j_tpu_torch.serving.batcher import (ContinuousBatcher,
                                                      RejectedError)
from deeplearning4j_tpu_torch.serving.compile_cache import (
    BucketedCompileCache, bucket_for)
from deeplearning4j_tpu_torch.serving.metrics import ServingMetrics
from deeplearning4j_tpu_torch.serving.registry import ModelEntry, ModelRegistry
from deeplearning4j_tpu_torch.utils.devices import resolve_device


class ModelServer:
    """Multi-model, continuously-batched, bucketed inference server on one
    device (``"cuda"`` by default; ``device="cpu"`` runs the plain
    versions of the kernels on the CPU)."""

    def __init__(self, registry: Optional[ModelRegistry] = None,
                 mesh=None,
                 max_batch: int = 64, batch_timeout_ms: float = 5.0,
                 max_queue: int = 256, min_bucket: int = 1,
                 metrics: Optional[ServingMetrics] = None,
                 dispatch_retries: int = 1,
                 dispatch_retry_backoff_ms: float = 10.0,
                 ready_stuck_threshold_s: float = 30.0,
                 device=None):
        self.device = resolve_device(device)
        self.registry = registry if registry is not None else ModelRegistry()
        self.metrics = metrics if metrics is not None else ServingMetrics()
        self.dispatch_retries = int(dispatch_retries)
        self.dispatch_retry_backoff_ms = float(dispatch_retry_backoff_ms)
        self.ready_stuck_threshold_s = float(ready_stuck_threshold_s)
        self._started = time.monotonic()
        self.cache = BucketedCompileCache(
            max_batch=max_batch, min_bucket=min_bucket, mesh=mesh,
            counters=self.metrics.cache)
        self.batcher = ContinuousBatcher(
            self._dispatch, max_batch=max_batch,
            batch_timeout_ms=batch_timeout_ms, max_queue=max_queue,
            metrics=self.metrics)
        self._entries_lock = threading.Lock()
        self._entries = {}          # key -> ModelEntry (dispatch lookup)
        self._closed = False

    # ---- deployment ----
    def _track(self, entry: ModelEntry, warmup: bool,
               input_shape=None) -> ModelEntry:
        with self._entries_lock:
            self._entries[entry.key] = entry
        if warmup:
            self.registry.warmup(entry.name, self.cache,
                                 version=entry.version,
                                 input_shape=input_shape)
        return entry

    def deploy(self, name: str, model=None, *, zoo: Optional[str] = None,
               keras: Optional[str] = None, onnx=None,
               version: Optional[int] = None, warmup: bool = False,
               input_shape: Optional[Tuple[int, ...]] = None,
               **kwargs) -> ModelEntry:
        """Register a model under `name` from exactly one source (a built
        model instance, which runs on its own device, a `zoo=` catalog
        name, or an `onnx=` path or bytes, either built on the server's
        device) and optionally warm every bucket."""
        sources = [s for s in (model, zoo, keras, onnx) if s is not None]
        if len(sources) != 1:
            raise ValueError(
                "deploy() needs exactly one of: model=, zoo=, keras=, onnx=")
        if keras is not None:
            raise NotImplementedError(
                "deploy(keras=) is not ported to PyTorch yet: Keras import reads "
                "HDF5 through h5py, which the port does not depend on (ROADMAP A9)")
        if model is not None:
            entry = self.registry.register(name, model, version=version,
                                           input_shape=input_shape,
                                           **kwargs)
        elif zoo is not None:
            entry = self.registry.register_zoo(name, zoo, version=version,
                                               device=self.device, **kwargs)
        else:
            entry = self.registry.register_onnx(name, onnx, version=version,
                                                device=self.device)
        return self._track(entry, warmup, input_shape)

    # ---- request path ----
    def submit(self, name: str, x, version: Optional[int] = None,
               priority: int = 0,
               deadline_ms: Optional[float] = None) -> Future:
        """Enqueue one request; returns a Future of the output rows.
        Raises `KeyError` for an unknown model, `UnservableGraphError` for
        a raw ONNX graph, `RejectedError` when load is shed; the Future raises `DeadlineExceededError` if the deadline
        passes in queue."""
        if self._closed:
            raise RejectedError("ModelServer is shut down")
        entry = self.registry.get(name, version)
        entry.require_servable()
        with self._entries_lock:
            self._entries.setdefault(entry.key, entry)
        x = np.asarray(x)
        if x.ndim < 1 or x.shape[0] == 0:
            raise ValueError(
                f"request must have >= 1 rows, got shape {x.shape}")
        if x.shape[0] > self.batcher.max_batch:
            raise ValueError(
                f"request of {x.shape[0]} rows exceeds max_batch="
                f"{self.batcher.max_batch}; split it client-side")
        group = (entry.key, tuple(x.shape[1:]), np.dtype(x.dtype).str)
        return self.batcher.submit(x, group=group, priority=priority,
                                   deadline_ms=deadline_ms)

    def output(self, name: str, x, version: Optional[int] = None,
               priority: int = 0, deadline_ms: Optional[float] = None,
               timeout: Optional[float] = None) -> np.ndarray:
        """Blocking convenience form of `submit`."""
        return self.submit(name, x, version=version, priority=priority,
                           deadline_ms=deadline_ms).result(timeout=timeout)

    def _dispatch(self, group, xs: List[np.ndarray]) -> List[np.ndarray]:
        """Batcher callback: one merged, bucket-padded forward for a group
        of compatible requests.  A transient error gets `dispatch_retries`
        retries with backoff before the whole group's futures fail."""
        key = group[0]
        with self._entries_lock:
            entry = self._entries[key]
        merged = xs[0] if len(xs) == 1 else np.concatenate(xs, axis=0)
        self.metrics.record_padding(
            bucket_for(merged.shape[0], self.cache.max_batch,
                       self.cache.min_bucket) - merged.shape[0])
        attempts = 0
        while True:
            try:
                out = self.cache.run(entry.key, entry.model, merged)
                break
            except Exception:
                if attempts >= self.dispatch_retries:
                    raise
                attempts += 1
                self.metrics.dispatch_retries.inc()
                time.sleep(self.dispatch_retry_backoff_ms
                           * (2 ** (attempts - 1)) / 1000.0)
        res, off = [], 0
        for x in xs:
            res.append(out[off: off + x.shape[0]])
            off += x.shape[0]
        return res

    # ---- health / readiness ----
    def healthz(self) -> dict:
        """Liveness: the process is up and the server object is answering."""
        return {"ok": True, "uptime_s": time.monotonic() - self._started}

    def readyz(self, stuck_threshold_s: Optional[float] = None) -> dict:
        """Readiness: would a request submitted NOW be served?  Requires a
        non-empty model registry, an accepting batcher, and no dispatch
        stuck on the device longer than `stuck_threshold_s`.  Returns
        ``{"ready": bool, "reasons": [...]}``."""
        thr = (self.ready_stuck_threshold_s if stuck_threshold_s is None
               else float(stuck_threshold_s))
        reasons = []
        if not self.registry.names():
            reasons.append("model registry is empty (nothing deployed)")
        if self._closed or not self.batcher.accepting:
            reasons.append("batcher is not accepting (shut down/draining)")
        age = self.batcher.inflight_age_s
        if age is not None and age > thr:
            reasons.append(
                f"dispatch in flight for {age:.1f}s (> {thr:.1f}s) — "
                "device path looks stuck")
        return {"ready": not reasons, "reasons": reasons}

    # ---- lifecycle / observability ----
    def stats(self) -> dict:
        """SLO snapshot: latency percentiles, dispatch and bucket counts."""
        snap = self.metrics.snapshot()
        snap["models"] = {
            n: self.registry.versions(n) for n in self.registry.names()}
        snap["buckets"] = list(self.cache.buckets)
        snap["device"] = str(self.device)
        return snap

    def shutdown(self, drain: bool = True, timeout: float = 10.0) -> None:
        """Graceful stop: refuse new submits, drain queued requests so
        every accepted Future resolves, then stop the worker.  Idempotent."""
        self._closed = True
        self.batcher.shutdown(drain=drain, timeout=timeout)

    def __enter__(self) -> "ModelServer":
        return self

    def __exit__(self, *exc) -> None:
        self.shutdown()
