"""Host-side span tracing aligned with the device trace (the port of
``monitor/spans.py``).

`span("fit_epoch")` times a host region into the registry's `span_ms`
histogram (one labeled series per span path, nesting encoded as
`"fit_epoch/fit_step"`) and opens a `torch.profiler.record_function` of
the same name, so a `torch.profiler` trace shows the host span as a named
region above the kernels it queued.

Nesting is thread-local: concurrent threads (trainer, prefetch producer,
serving worker) each carry their own span stack, and a child records under
`parent/child`.  The JAX package's process-wide telemetry switch is not
ported, so a span always records.
"""
from __future__ import annotations

import threading
import time
from typing import List, Optional

from torch.profiler import record_function

from deeplearning4j_tpu_torch.monitor.registry import MetricsRegistry, registry

_local = threading.local()


def span_stack() -> List[str]:
    """This thread's active span paths, outermost first."""
    st = getattr(_local, "stack", None)
    if st is None:
        st = _local.stack = []
    return st


def current_span() -> Optional[str]:
    st = getattr(_local, "stack", None)
    return st[-1] if st else None


class span:
    """Context manager: `with span("fit_epoch"):` records the host wall time
    of the region into `span_ms{span="<path>"}` and annotates the profiler
    trace.  Extra labels ride along (`span("dispatch", model="lenet")`).

    Not re-entrant per instance (construct one per use); nesting different
    instances is the point."""

    __slots__ = ("name", "_labels", "_registry", "_t0", "_path", "_ann")

    def __init__(self, name: str, registry_: Optional[MetricsRegistry] = None,
                 **labels):
        self.name = name
        self._labels = labels
        self._registry = registry_
        self._t0 = None
        self._path = None
        self._ann = None

    def __enter__(self) -> "span":
        st = span_stack()
        self._path = f"{st[-1]}/{self.name}" if st else self.name
        st.append(self._path)
        self._ann = record_function(self.name)
        self._ann.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        if self._t0 is None:
            return False
        dt_ms = (time.perf_counter() - self._t0) * 1000.0
        self._ann.__exit__(exc_type, exc, tb)
        self._ann = None
        st = span_stack()
        if st and st[-1] == self._path:
            st.pop()
        reg = self._registry if self._registry is not None else registry()
        labels = {"span": self._path}
        if self._labels:
            labels.update(self._labels)
        reg.histogram("span_ms", help="host wall time of traced spans (ms)",
                      labels=labels).observe(dt_ms)
        self._t0 = None
        return False
