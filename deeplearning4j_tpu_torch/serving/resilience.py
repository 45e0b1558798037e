"""Serving-side fault tolerance (the port of ``serving/resilience.py``, in
part: the error class the decode engine raises).  The circuit breaker,
failover requests, the degraded ladder and fleet snapshots come with the
fleet, which is not ported yet."""
from __future__ import annotations


class FatalReplicaError(RuntimeError):
    """A dispatch error that poisons the replica: the device or server
    behind it is gone (not transient), so a controller tears it down and
    respawns it instead of waiting out a probe cycle."""
