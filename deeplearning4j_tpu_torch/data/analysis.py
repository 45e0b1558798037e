"""Data analysis (the port of ``data/analysis.py``, in part): the
fixed-range accumulating :class:`Histogram` that the percentile calibration
observer (``quant/calibrate.py``) reads.  The rest of the module (column
analysis, joins) is not ported yet."""
from __future__ import annotations

import math

import numpy as np


class Histogram:
    """Fixed-range accumulating histogram with linear-interpolated
    percentiles (within bucket resolution, numpy's 'linear').

    Built once with a [lo, hi] range and fed arrays incrementally: the
    calibration observer sees one activation batch at a time and never
    holds the whole stream.  Counts are those of the JAX package's
    ``np.add.at`` form, taken with ``np.bincount``."""

    def __init__(self, lo: float, hi: float, bins: int = 2048):
        if not (bins >= 1 and math.isfinite(lo) and math.isfinite(hi)):
            raise ValueError(f"bad histogram spec lo={lo} hi={hi} "
                             f"bins={bins}")
        if hi <= lo:                       # degenerate column: widen a hair
            hi = lo + max(abs(lo), 1.0) * 1e-9 + 1e-30
        self.lo = float(lo)
        self.hi = float(hi)
        self.bins = int(bins)
        self.counts = np.zeros(self.bins, np.int64)
        self.total = 0

    def add(self, values) -> "Histogram":
        v = np.asarray(values, np.float64).ravel()
        v = v[np.isfinite(v)]
        if v.size == 0:
            return self
        idx = ((v - self.lo) / (self.hi - self.lo) * self.bins).astype(
            np.int64)
        self.counts += np.bincount(np.clip(idx, 0, self.bins - 1),
                                   minlength=self.bins)
        self.total += int(v.size)
        return self

    @property
    def bin_width(self) -> float:
        return (self.hi - self.lo) / self.bins

    def percentile(self, p: float) -> float:
        """Value at percentile `p` in [0, 100], linearly interpolated
        within the containing bucket."""
        if not 0.0 <= p <= 100.0:
            raise ValueError(f"percentile {p} outside [0, 100]")
        if self.total == 0:
            return float("nan")
        target = p / 100.0 * self.total
        cum = np.cumsum(self.counts)
        i = int(np.searchsorted(cum, target, side="left"))
        i = min(i, self.bins - 1)
        prev = cum[i - 1] if i > 0 else 0
        in_bucket = self.counts[i]
        frac = ((target - prev) / in_bucket) if in_bucket else 0.0
        return float(self.lo +
                     (i + min(max(frac, 0.0), 1.0)) * self.bin_width)
