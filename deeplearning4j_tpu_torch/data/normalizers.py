"""Normalizers (the port of ``data/normalizers.py``, the whole module:
numpy only, the JAX package's code).

Reference `nd4j-api/.../dataset/api/preprocessor/**`:
`NormalizerStandardize`, `NormalizerMinMaxScaler`,
`ImagePreProcessingScaler`, `MultiNormalizer`.  `fit(iterator)`
accumulates statistics host-side (numpy, streaming); `transform` /
`pre_process` applies on DataSet batches; `revert*` undoes (for
interpreting predictions).  `to_bytes`/`from_bytes` write and read the same
bytes as the JAX package (the ModelSerializer zip's NORMALIZER_BIN
member).  `affine_stats()` gives the `(shift, scale)` f32 statistics that
`data/pipeline.py`'s `DeviceNormalizer` applies on the card as
`(x - shift) / scale`, bitwise equal to `transform`.
"""
from __future__ import annotations

import io
import json
from typing import Optional

import numpy as np


class Normalizer:
    def fit(self, iterator) -> "Normalizer":
        raise NotImplementedError

    def transform(self, dataset):
        raise NotImplementedError

    pre_process = transform

    def to_bytes(self) -> bytes:
        raise NotImplementedError


def _flat2(x: np.ndarray) -> np.ndarray:
    """[N, ...] -> [N*, F]: stats are per-feature over all other dims for
    2-D, per-channel (last axis, NHWC) for higher rank."""
    if x.ndim <= 2:
        return x.reshape(len(x), -1)
    return x.reshape(-1, x.shape[-1])


class NormalizerStandardize(Normalizer):
    """Zero-mean unit-variance per feature (reference
    `NormalizerStandardize`), optional label normalization."""

    def __init__(self, fit_labels: bool = False):
        self.fit_labels = fit_labels
        self.mean: Optional[np.ndarray] = None
        self.std: Optional[np.ndarray] = None
        self.label_mean: Optional[np.ndarray] = None
        self.label_std: Optional[np.ndarray] = None

    def fit(self, iterator):
        n = 0
        s = ss = None
        ln = 0
        lsum = lss = None
        if hasattr(iterator, "reset"):
            iterator.reset()
        for ds in iterator:
            f = _flat2(np.asarray(ds.features, np.float64))
            if s is None:
                s = f.sum(0)
                ss = (f * f).sum(0)
            else:
                s += f.sum(0)
                ss += (f * f).sum(0)
            n += len(f)
            if self.fit_labels:
                l = _flat2(np.asarray(ds.labels, np.float64))
                if lsum is None:
                    lsum, lss = l.sum(0), (l * l).sum(0)
                else:
                    lsum += l.sum(0)
                    lss += (l * l).sum(0)
                ln += len(l)
        self.mean = (s / n).astype(np.float32)
        var = ss / n - (s / n) ** 2
        self.std = np.sqrt(np.maximum(var, 1e-12)).astype(np.float32)
        if self.fit_labels:
            self.label_mean = (lsum / ln).astype(np.float32)
            lvar = lss / ln - (lsum / ln) ** 2
            self.label_std = np.sqrt(np.maximum(lvar, 1e-12)).astype(np.float32)
        return self

    def transform(self, ds):
        ds.features = ((np.asarray(ds.features, np.float32) - self.mean)
                       / self.std)
        if (self.fit_labels and self.label_mean is not None
                and ds.labels is not None):
            ds.labels = ((np.asarray(ds.labels, np.float32)
                          - self.label_mean) / self.label_std)
        return ds

    pre_process = transform

    def revert_features(self, f):
        return f * self.std + self.mean

    def revert_labels(self, l):
        if not self.fit_labels:
            return l
        return l * self.label_std + self.label_mean

    def to_bytes(self) -> bytes:
        buf = io.BytesIO()
        np.savez(buf, kind=np.str_("standardize"),
                 fit_labels=np.asarray(self.fit_labels),
                 mean=self.mean, std=self.std,
                 label_mean=(self.label_mean if self.label_mean is not None
                             else np.zeros(0)),
                 label_std=(self.label_std if self.label_std is not None
                            else np.zeros(0)))
        return buf.getvalue()

    @staticmethod
    def from_bytes(data: bytes) -> "NormalizerStandardize":
        with np.load(io.BytesIO(data)) as z:
            n = NormalizerStandardize(bool(z["fit_labels"]))
            n.mean, n.std = z["mean"], z["std"]
            if z["label_mean"].size:
                n.label_mean, n.label_std = z["label_mean"], z["label_std"]
        return n


class NormalizerMinMaxScaler(Normalizer):
    """Scale features into [min, max] (reference
    `NormalizerMinMaxScaler`)."""

    def __init__(self, min_range: float = 0.0, max_range: float = 1.0):
        self.min_range, self.max_range = min_range, max_range
        self.data_min: Optional[np.ndarray] = None
        self.data_max: Optional[np.ndarray] = None

    def fit(self, iterator):
        lo = hi = None
        if hasattr(iterator, "reset"):
            iterator.reset()
        for ds in iterator:
            f = _flat2(np.asarray(ds.features, np.float64))
            bl, bh = f.min(0), f.max(0)
            lo = bl if lo is None else np.minimum(lo, bl)
            hi = bh if hi is None else np.maximum(hi, bh)
        self.data_min = lo.astype(np.float32)
        self.data_max = hi.astype(np.float32)
        return self

    def affine_stats(self):
        """Canonical `(shift, scale)` f32 stats: `transform` is exactly
        `(x - shift) / scale`.  Computed in float64 then rounded once, and
        shared with `DeviceNormalizer` so the on-device prologue is bitwise
        identical to this host path: a subtraction then a division, each
        rounded once, where a multiply-add may be contracted to one FMA and
        a division by a constant turned into a multiplication by its
        reciprocal."""
        span = float(self.max_range) - float(self.min_range)
        rng = np.maximum(self.data_max.astype(np.float64)
                         - self.data_min.astype(np.float64), 1e-12)
        if span == 0.0:                      # degenerate [a, a] range
            return None, None
        scale = rng / span
        shift = self.data_min.astype(np.float64) - float(self.min_range) * scale
        return shift.astype(np.float32), scale.astype(np.float32)

    def transform(self, ds):
        shift, scale = self.affine_stats()
        x = np.asarray(ds.features, np.float32)
        ds.features = np.full_like(x, self.min_range) if scale is None \
            else (x - shift) / scale
        return ds

    pre_process = transform

    def revert_features(self, f):
        shift, scale = self.affine_stats()
        if scale is None:
            raise ValueError("degenerate range: revert is undefined")
        return f * scale + shift

    def to_bytes(self) -> bytes:
        buf = io.BytesIO()
        np.savez(buf, kind=np.str_("minmax"),
                 rng=np.asarray([self.min_range, self.max_range]),
                 data_min=self.data_min, data_max=self.data_max)
        return buf.getvalue()

    @staticmethod
    def from_bytes(data: bytes) -> "NormalizerMinMaxScaler":
        with np.load(io.BytesIO(data)) as z:
            n = NormalizerMinMaxScaler(float(z["rng"][0]), float(z["rng"][1]))
            n.data_min, n.data_max = z["data_min"], z["data_max"]
        return n


class ImagePreProcessingScaler(Normalizer):
    """Pixel [0, max_pixel] -> [a, b], no fitting needed (reference
    `ImagePreProcessingScaler`, default 0-255 -> 0-1)."""

    def __init__(self, a: float = 0.0, b: float = 1.0,
                 max_pixel: float = 255.0):
        self.a, self.b, self.max_pixel = a, b, max_pixel

    def fit(self, iterator):
        return self

    def affine_stats(self):
        """Canonical `(shift, scale)` f32 stats, same contract as
        `NormalizerMinMaxScaler.affine_stats` (shared with the on-device
        prologue for bitwise parity): `transform` is `(x - shift) / scale`.
        For the defaults ([0,255] -> [0,1]) this degenerates to the
        familiar `x / 255`."""
        span = float(self.b) - float(self.a)
        if span == 0.0:
            return None, None
        scale = float(self.max_pixel) / span
        shift = -float(self.a) * scale
        return np.float32(shift), np.float32(scale)

    def transform(self, ds):
        shift, scale = self.affine_stats()
        x = np.asarray(ds.features, np.float32)
        ds.features = np.full_like(x, self.a) if scale is None \
            else (x - shift) / scale
        return ds

    pre_process = transform

    def revert_features(self, f):
        shift, scale = self.affine_stats()
        if scale is None:
            raise ValueError("degenerate range: revert is undefined")
        return f * scale + shift

    def to_bytes(self) -> bytes:
        return json.dumps({"kind": "image", "a": self.a, "b": self.b,
                           "max_pixel": self.max_pixel}).encode()

    @staticmethod
    def from_bytes(data: bytes) -> "ImagePreProcessingScaler":
        d = json.loads(data.decode())
        return ImagePreProcessingScaler(d["a"], d["b"], d["max_pixel"])


class MultiNormalizer(Normalizer):
    """Per-input normalizers for MultiDataSet pipelines (reference
    `MultiNormalizerStandardize` role, simplified: one normalizer per
    features array; FEATURES ONLY — labels pass through untouched)."""

    def __init__(self, normalizers):
        self.normalizers = list(normalizers)

    def fit(self, iterator):
        raise NotImplementedError(
            "Fit each sub-normalizer on its own single-input iterator, then "
            "compose")

    def transform(self, mds):
        feats = mds.features if isinstance(mds.features, (list, tuple)) \
            else [mds.features]
        out = []
        for nz, f in zip(self.normalizers, feats):
            class _Tmp:  # adapt array -> DataSet-shaped for sub-normalizer
                pass
            t = _Tmp()
            t.features = f
            t.labels = None
            nz_ds = nz.transform(t)
            out.append(nz_ds.features)
        mds.features = out if len(out) > 1 else out[0]
        return mds

    pre_process = transform
