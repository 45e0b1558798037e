"""Post-training-quantization calibration pass (the port of
``quant/calibrate.py``).

Runs a model over a representative iterator and collects per-layer
activation ranges, the statistics ``ptq.quantize_model`` turns into static
activation scales.  Two observers, both accumulating (they see one batch at
a time, never the full stream):

- :class:`MinMaxObserver`: running (min, max), exact;
- :class:`PercentileObserver`: phase one tracks the raw range, phase two
  re-plays the stream into a fixed-range ``data.analysis.Histogram`` and
  reads the configured percentile (99.9 by default), clipping the outlier
  tail.  The two phases are two passes over a re-playable iterator.

The result is a :class:`CalibrationStats`: {activation name -> (lo, hi)}
plus a crc32 over the packed stats, the same number as the JAX package's
for the same ranges.  Activations are taken on the model's device and
observed on the host in float64, as in the JAX package.
"""
from __future__ import annotations

import zlib
from typing import Any, Dict, Iterable, Optional, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch.data.analysis import Histogram
from deeplearning4j_tpu_torch.monitor.instrument import quant_instruments


class MinMaxObserver:
    """Running min/max over every batch seen."""

    phases = 1

    def __init__(self):
        self.lo = np.inf
        self.hi = -np.inf

    def observe(self, arr, phase: int = 0) -> None:
        a = np.asarray(arr, np.float64).ravel()
        a = a[np.isfinite(a)]
        if a.size == 0:
            return
        self.lo = min(self.lo, float(a.min()))
        self.hi = max(self.hi, float(a.max()))

    def range(self) -> Tuple[float, float]:
        if not np.isfinite(self.lo):
            return (0.0, 0.0)
        return (self.lo, self.hi)


class PercentileObserver:
    """Clipped range at the configured percentile of the activation mass:
    phase 0 learns the raw range (so the histogram grid is well placed),
    phase 1 accumulates a ``Histogram`` and ``range()`` reads the
    (100 - p, p) percentile pair."""

    phases = 2

    def __init__(self, percentile: float = 99.9, bins: int = 2048):
        if not 50.0 < percentile <= 100.0:
            raise ValueError(f"percentile {percentile} outside (50, 100]")
        self.percentile = float(percentile)
        self.bins = int(bins)
        self._minmax = MinMaxObserver()
        self._hist: Optional[Histogram] = None

    def observe(self, arr, phase: int = 0) -> None:
        if phase == 0:
            self._minmax.observe(arr)
            return
        if self._hist is None:
            lo, hi = self._minmax.range()
            self._hist = Histogram(lo, hi, self.bins)
        self._hist.add(np.asarray(arr, np.float64))

    def range(self) -> Tuple[float, float]:
        if self._hist is None or self._hist.total == 0:
            return self._minmax.range()
        lo = self._hist.percentile(100.0 - self.percentile)
        hi = self._hist.percentile(self.percentile)
        rlo, rhi = self._minmax.range()
        # clipping must never *widen* the raw range
        return (max(lo, rlo), min(hi, rhi))


OBSERVERS = {"minmax": MinMaxObserver, "percentile": PercentileObserver}


class CalibrationStats:
    """Per-activation (lo, hi) ranges + a stable crc32 for fingerprints."""

    def __init__(self, ranges: Dict[str, Tuple[float, float]],
                 batches: int = 0, observer: str = "minmax"):
        self.ranges = {str(k): (float(v[0]), float(v[1]))
                       for k, v in ranges.items()}
        self.batches = int(batches)
        self.observer = observer

    def range(self, name: str) -> Tuple[float, float]:
        return self.ranges[name]

    def scale(self, name: str) -> float:
        """Symmetric int8 activation scale for one activation."""
        lo, hi = self.ranges[name]
        amax = max(abs(lo), abs(hi))
        return (amax / 127.0) if amax > 0 else 1.0

    def crc32(self) -> int:
        """crc32 over the packed (name, lo, hi) triples, names sorted."""
        buf = bytearray()
        for name in sorted(self.ranges):
            lo, hi = self.ranges[name]
            buf += name.encode()
            buf += np.asarray([lo, hi], np.float64).tobytes()
        return zlib.crc32(bytes(buf)) & 0xFFFFFFFF

    def to_dict(self) -> Dict[str, Any]:
        return {"observer": self.observer, "batches": self.batches,
                "ranges": {k: list(v) for k, v in self.ranges.items()}}

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "CalibrationStats":
        return cls({k: tuple(v) for k, v in d["ranges"].items()},
                   batches=d.get("batches", 0),
                   observer=d.get("observer", "minmax"))

    def __repr__(self):
        return (f"CalibrationStats(observer={self.observer!r}, "
                f"activations={len(self.ranges)}, batches={self.batches}, "
                f"crc32={self.crc32():#010x})")


def _batches(data) -> Iterable[np.ndarray]:
    """Normalize the calibration source: a DataSet iterator (items with
    `.features`), an iterable of arrays, or one array."""
    if hasattr(data, "reset"):
        data.reset()
    if isinstance(data, (np.ndarray, torch.Tensor)):
        yield data
        return
    for item in data:
        feats = getattr(item, "features", item)
        if isinstance(feats, (list, tuple)):
            feats = feats[0]
        yield feats


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().to(torch.float32).cpu().numpy()


@torch.inference_mode()
def _mln_activations(model, x) -> Dict[str, np.ndarray]:
    """Name -> activation entering each layer (the tensor a static input
    scale must cover), plus the head output."""
    out: Dict[str, np.ndarray] = {}
    params, h = model._cast_compute(model.params_,
                                    torch.as_tensor(x, device=model.device))
    for i, layer in enumerate(model.conf.layers):
        name = model.conf.layer_name(i)
        out[f"{name}:in"] = _host(h)
        h, _ = layer.apply(params[name], model.state_[name], h)
    out["__output__"] = _host(h)
    return out


def is_mln(model) -> bool:
    """A MultiLayerNetwork-like model: per-layer calibration applies."""
    return (hasattr(model, "_cast_compute")
            and getattr(getattr(model, "conf", None), "layers", None) is not None)


def calibrate(model, data, observer: str = "percentile",
              percentile: float = 99.9, max_batches: Optional[int] = 32,
              bins: int = 2048) -> CalibrationStats:
    """Run `model` over `data` collecting activation ranges.

    MultiLayerNetwork models get per-layer input ranges (each name is
    `<layer>:in`), what `quantize_activations=True` needs for static input
    scales.  Graph models get network-level `__input__` / `__output__`
    ranges.  Percentile observers take two passes, so `data` must be
    re-playable; minmax takes one.  Every processed batch bumps
    `quant_calibration_batches_total`."""
    if observer not in OBSERVERS:
        raise ValueError(
            f"unknown observer '{observer}'; have {sorted(OBSERVERS)}")
    make = (lambda: PercentileObserver(percentile, bins)) \
        if observer == "percentile" else MinMaxObserver
    obs: Dict[str, Any] = {}
    per_layer = is_mln(model)
    phases = make().phases
    batches = 0
    qi = quant_instruments()
    for phase in range(phases):
        n = 0
        for x in _batches(data):
            if per_layer:
                acts = _mln_activations(model, x)
            else:
                acts = {"__input__": _host(torch.as_tensor(x))}
                out = _generic_output(model, x)
                if out is not None:
                    acts["__output__"] = out
            for name, a in acts.items():
                o = obs.get(name)
                if o is None:
                    o = obs[name] = make()
                o.observe(a, phase=phase)
            n += 1
            qi.record_calibration_batch()
            if max_batches is not None and n >= max_batches:
                break
        batches = max(batches, n)
    return CalibrationStats({k: o.range() for k, o in obs.items()},
                            batches=batches, observer=observer)


@torch.inference_mode()
def _generic_output(model, x) -> Optional[np.ndarray]:
    """Best-effort forward for graph models (range of the head output);
    None when the model offers no single-input forward."""
    try:
        xt = torch.as_tensor(x, device=model.device)
        if hasattr(model, "_as_input_dict"):        # ComputationGraph
            names = list(model.conf.network_inputs)
            if len(names) != 1:
                return None
            acts, _ = model._forward(model.params_, model.state_,
                                     {names[0]: xt}, train=False, rng=None)
            return _host(acts[model.conf.network_outputs[0]])
        if hasattr(model, "_forward"):              # MLN-like
            return _host(model._forward(model.params_, model.state_, xt,
                                        train=False)[0])
    except Exception:
        return None
    return None
