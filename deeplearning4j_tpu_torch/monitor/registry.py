"""Process-wide metrics registry: counters, gauges, ring-buffer histograms.

The port's copy of the JAX package's ``monitor/registry.py``, cut to what
the serving slice records: thread-safe metrics, each guarding its own state
with its own lock; labeled series, where get-or-create returns the same
child for the same (name, labels) so two servers differ by label, not by
store; and bounded histograms (a ring buffer of the last ``maxlen``
observations plus lifetime count/sum/max).  Stdlib only.

``set_enabled``/``enabled`` is the JAX package's process-wide telemetry
switch; here the bundles that record on a per-step host path consult it
(``CommsInstruments.record_exchange``), the primitives do not.
"""
from __future__ import annotations

import threading
from collections import deque
from typing import Dict, Iterable, List, Optional, Tuple

Labels = Tuple[Tuple[str, str], ...]

_ENABLED = True


def set_enabled(on: bool) -> None:
    """Process-wide telemetry switch: off, the recording calls that
    consult it return after the flag check."""
    global _ENABLED
    _ENABLED = bool(on)


def enabled() -> bool:
    return _ENABLED


def _freeze_labels(labels: Optional[Dict[str, str]]) -> Labels:
    if not labels:
        return ()
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


class Counter:
    """Thread-safe monotonically increasing counter."""

    def __init__(self, name: str = "counter",
                 labels: Optional[Dict[str, str]] = None):
        self.name = name
        self.labels = _freeze_labels(labels)
        self._value = 0
        self._lock = threading.Lock()

    def inc(self, n: int = 1) -> int:
        with self._lock:
            self._value += n
            return self._value

    @property
    def value(self) -> int:
        with self._lock:
            return self._value

    def reset(self) -> None:
        with self._lock:
            self._value = 0

    def __repr__(self) -> str:   # pragma: no cover - debug aid
        return f"Counter({self.name}={self.value})"


class Gauge:
    """Thread-safe point-in-time value (queue depth, ...)."""

    def __init__(self, name: str = "gauge",
                 labels: Optional[Dict[str, str]] = None):
        self.name = name
        self.labels = _freeze_labels(labels)
        self._value = 0.0
        self._lock = threading.Lock()

    def set(self, v: float) -> None:
        with self._lock:
            self._value = float(v)

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self._value += float(n)

    def set_max(self, v: float) -> None:
        """Ratchet: keep the running peak (queue-depth high-water marks)."""
        with self._lock:
            if v > self._value:
                self._value = float(v)

    @property
    def value(self) -> float:
        with self._lock:
            return self._value

    def __repr__(self) -> str:   # pragma: no cover - debug aid
        return f"Gauge({self.name}={self.value})"


def _percentile(sorted_vals: List[float], p: float) -> float:
    """Nearest-rank percentile over an already-sorted sample list."""
    if not sorted_vals:
        return float("nan")
    k = max(0, min(len(sorted_vals) - 1,
                   int(round(p / 100.0 * (len(sorted_vals) - 1)))))
    return sorted_vals[k]


class Histogram:
    """Sliding-window distribution: ring buffer of the last `maxlen`
    observations plus lifetime count / sum / max."""

    def __init__(self, name: str = "histogram",
                 labels: Optional[Dict[str, str]] = None,
                 maxlen: int = 2048):
        self.name = name
        self.labels = _freeze_labels(labels)
        self.maxlen = int(maxlen)
        self._samples: deque = deque(maxlen=self.maxlen)
        self._lock = threading.Lock()
        self._count = 0
        self._sum = 0.0
        self._max = 0.0

    def observe(self, v: float) -> None:
        v = float(v)
        with self._lock:
            self._samples.append(v)
            self._count += 1
            self._sum += v
            if v > self._max:
                self._max = v

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    @property
    def sum(self) -> float:
        with self._lock:
            return self._sum

    @property
    def max(self) -> float:
        with self._lock:
            return self._max

    def percentiles(self, ps: Iterable[float] = (50, 95, 99)
                    ) -> Dict[str, float]:
        with self._lock:
            s = sorted(self._samples)
        return {f"p{p:g}": _percentile(s, p) for p in ps}

    def __repr__(self) -> str:   # pragma: no cover - debug aid
        return f"Histogram({self.name}, n={self.count})"


_TYPES = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}


class _Family:
    __slots__ = ("name", "kind", "help", "children")

    def __init__(self, name: str, kind: str, help: str):
        self.name = name
        self.kind = kind
        self.help = help
        self.children: Dict[Labels, object] = {}


class MetricsRegistry:
    """Get-or-create store of metric families.  `counter/gauge/histogram`
    return the live child for (name, labels) — same args, same object."""

    def __init__(self):
        self._lock = threading.Lock()
        self._families: Dict[str, _Family] = {}

    def _child(self, kind: str, name: str, help: str,
               labels: Optional[Dict[str, str]], **kw):
        frozen = _freeze_labels(labels)
        with self._lock:
            fam = self._families.get(name)
            if fam is None:
                fam = self._families[name] = _Family(name, kind, help)
            elif fam.kind != kind:
                raise TypeError(
                    f"metric {name!r} already registered as {fam.kind}, "
                    f"requested {kind}")
            child = fam.children.get(frozen)
            if child is None:
                child = _TYPES[kind](name, dict(frozen), **kw)
                fam.children[frozen] = child
            return child

    def counter(self, name: str, help: str = "",
                labels: Optional[Dict[str, str]] = None) -> Counter:
        return self._child("counter", name, help, labels)

    def gauge(self, name: str, help: str = "",
              labels: Optional[Dict[str, str]] = None) -> Gauge:
        return self._child("gauge", name, help, labels)

    def histogram(self, name: str, help: str = "",
                  labels: Optional[Dict[str, str]] = None,
                  maxlen: int = 2048) -> Histogram:
        return self._child("histogram", name, help, labels, maxlen=maxlen)

    def get(self, name: str, labels: Optional[Dict[str, str]] = None):
        """The live child, or None (never creates)."""
        with self._lock:
            fam = self._families.get(name)
            if fam is None:
                return None
            return fam.children.get(_freeze_labels(labels))


_default = MetricsRegistry()


def registry() -> MetricsRegistry:
    """The process-wide registry every subsystem records into by default."""
    return _default
