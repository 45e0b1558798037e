"""Shape-bucketed forward cache for serving (the port of
``serving/compile_cache.py``).

Each dispatch is padded up to a power-of-two **bucket**, so a model sees
only ``log2(max_batch) - log2(min_bucket) + 1`` batch shapes, all of which
the registry warms before traffic.  PyTorch runs eagerly, so a bucket's
"executable" is the model's forward run at that bucket's shape: the first
run of a (model, bucket, trailing dims, dtype) is its miss (it loads the
kernel library and settles cuDNN's algorithm choice for that shape), and
every later run is a hit.
Padding rows are zeros, sliced off after the forward; inference forwards
are row-independent, so padding is transparent to callers.

Not ported yet: the persistent executable tier (``persistent=``) and SPMD
sharded serving (``mesh=``).  Passing either raises.
"""
from __future__ import annotations

import threading
from typing import Dict, List, Optional, Set, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch.utils.counters import HitMissCounters


def bucket_sizes(max_batch: int, min_bucket: int = 1) -> List[int]:
    """The power-of-two bucket ladder [min_bucket, ..., >= max_batch]."""
    if min_bucket < 1 or max_batch < 1:
        raise ValueError("min_bucket and max_batch must be >= 1")
    b, out = 1, []
    while b < min_bucket:
        b *= 2
    while True:
        out.append(b)
        if b >= max_batch:
            return out
        b *= 2


def bucket_for(n: int, max_batch: int, min_bucket: int = 1) -> int:
    """Smallest power-of-two bucket >= n (>= min_bucket)."""
    if n < 1:
        raise ValueError(f"cannot bucket a {n}-row dispatch")
    b = min_bucket if min_bucket >= 1 else 1
    while b & (b - 1):           # round min_bucket itself up to a pow2
        b += 1
    while b < n:
        b *= 2
    return b


class BucketedCompileCache:
    """Counts hits and misses per (model key, bucket, trailing dims,
    dtype); `run(key, model, x)` pads x to its bucket, runs, slices back."""

    def __init__(self, max_batch: int = 64, min_bucket: int = 1,
                 mesh=None,
                 counters: Optional[HitMissCounters] = None,
                 persistent=None):
        if mesh is not None:
            raise NotImplementedError(
                "sharded serving (mesh=) is not ported to PyTorch yet")
        if persistent is not None:
            raise NotImplementedError(
                "the persistent executable cache (persistent=) is not "
                "ported to PyTorch yet")
        self.max_batch = int(max_batch)
        self.min_bucket = int(min_bucket)
        self.buckets = bucket_sizes(self.max_batch, self.min_bucket)
        self.counters = counters if counters is not None \
            else HitMissCounters("compile_cache")
        self._seen: Set[Tuple] = set()
        self._pads: Dict[Tuple, np.ndarray] = {}
        self._lock = threading.Lock()

    @property
    def num_buckets(self) -> int:
        return len(self.buckets)

    def _count(self, key: str, bucket: int, trailing: Tuple[int, ...],
               dtype) -> None:
        """A bucket's first run for a model (its key names model and
        version) is a miss, every later run a hit."""
        ck = (key, int(bucket), tuple(trailing), np.dtype(dtype).str)
        with self._lock:
            first = ck not in self._seen
            self._seen.add(ck)
        if first:
            self.counters.miss()
        else:
            self.counters.hit()

    # ---- execute ----
    def _pad_buffer(self, bucket: int, trailing: Tuple[int, ...],
                    dtype) -> np.ndarray:
        """Cached zero buffer of (bucket,)+trailing for dispatch padding."""
        pk = (int(bucket), tuple(trailing), np.dtype(dtype).str)
        pad = self._pads.get(pk)
        if pad is None:
            pad = np.zeros((bucket,) + tuple(trailing), dtype)
            with self._lock:
                pad = self._pads.setdefault(pk, pad)
        return pad

    def run(self, key: str, model, x: np.ndarray) -> np.ndarray:
        """Pad `x` up to its bucket, run the model's forward at that shape
        on its device, and return the real rows as numpy."""
        x = np.asarray(x)
        n = x.shape[0]
        if n == 0:
            raise ValueError("cannot dispatch an empty batch")
        if n > self.max_batch:
            raise ValueError(
                f"dispatch of {n} rows exceeds max_batch={self.max_batch}")
        bucket = bucket_for(n, self.max_batch, self.min_bucket)
        self._count(key, bucket, x.shape[1:], x.dtype)
        if bucket != n:
            pad = self._pad_buffer(bucket, x.shape[1:], x.dtype)
            x = np.concatenate([x, pad[n:]], axis=0)
        with torch.inference_mode():
            out = model._forward(model.params_, model.state_,
                                 torch.as_tensor(x, device=model.device),
                                 train=False)[0]
        return out[:n].cpu().numpy()

    def warmup(self, key: str, model, trailing: Tuple[int, ...],
               dtype=np.float32,
               buckets: Optional[List[int]] = None) -> List[int]:
        """Run every bucket once for a model, so no request pays a bucket's
        first run.  Returns the warmed buckets, in ladder order."""
        todo = list(buckets if buckets is not None else self.buckets)
        # the ladder top may exceed max_batch (pad-to-pow2); a clamped
        # batch still routes to the same bucket
        sizes = [min(b, self.max_batch) for b in todo]
        for n in sizes:
            self.run(key, model, np.zeros((n,) + tuple(trailing), dtype))
        return todo
