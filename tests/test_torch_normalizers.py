"""The port's normalizers (``data/normalizers.py``) against the JAX
package's: the same batches (numpy, from a seed) give bitwise equal
statistics, transforms, ``affine_stats`` and reverts, and the bytes of
``to_bytes`` load in the other package."""
import torch_test_threads  # noqa: F401  (first: one torch thread a worker)
import numpy as np
import pytest

from deeplearning4j_tpu.data import normalizers as jnorm
from deeplearning4j_tpu.data.dataset import DataSet as JDataSet
from deeplearning4j_tpu.data.iterators import ListDataSetIterator as JList
from deeplearning4j_tpu_torch.data import normalizers as tnorm
from deeplearning4j_tpu_torch.data import DataSet, ListDataSetIterator

KINDS = {
    "standardize": lambda m: m.NormalizerStandardize(),
    "standardize+labels": lambda m: m.NormalizerStandardize(fit_labels=True),
    "minmax01": lambda m: m.NormalizerMinMaxScaler(),
    "minmax-12": lambda m: m.NormalizerMinMaxScaler(-1.0, 2.0),
    "image01": lambda m: m.ImagePreProcessingScaler(),
    "image-11": lambda m: m.ImagePreProcessingScaler(-1.0, 1.0, 200.0),
}
SHAPES = {"2d": (7,), "nhwc": (5, 4, 3)}


def _arrays(shape, seed, n=3, batch=6):
    rs = np.random.RandomState(seed)
    return [((rs.rand(batch, *shape) * 255.0).astype(np.float32),
             (rs.randn(batch, 2) * 3.0 + 1.0).astype(np.float32)) for _ in range(n)]


def _bitwise(a, b):
    a, b = np.atleast_1d(a), np.atleast_1d(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert np.array_equal(a.view(np.uint8), b.view(np.uint8))


def _fitted(kind, shape, seed=0):
    data = _arrays(shape, seed)
    j = KINDS[kind](jnorm).fit(JList([JDataSet(x, y) for x, y in data]))
    t = KINDS[kind](tnorm).fit(ListDataSetIterator([DataSet(x, y) for x, y in data]))
    return j, t, data


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_fit_transform_stats_and_revert_are_the_jax_package_bitwise(kind, shape):
    j, t, data = _fitted(kind, SHAPES[shape])
    for name in ("mean", "std", "label_mean", "label_std", "data_min", "data_max"):
        if getattr(j, name, None) is not None:
            _bitwise(getattr(t, name), getattr(j, name))
    if hasattr(j, "affine_stats"):
        for a, b in zip(t.affine_stats(), j.affine_stats()):
            _bitwise(a, b)
    x, y = data[1]
    jd = j.transform(JDataSet(x.copy(), y.copy()))
    td = t.transform(DataSet(x.copy(), y.copy()))
    _bitwise(td.features, jd.features)
    _bitwise(td.labels, jd.labels)
    _bitwise(t.revert_features(td.features), j.revert_features(jd.features))
    if hasattr(j, "revert_labels"):
        _bitwise(t.revert_labels(td.labels), j.revert_labels(jd.labels))


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_to_bytes_loads_in_the_other_package(kind):
    j, t, data = _fitted(kind, SHAPES["nhwc"], seed=4)
    cls = type(t).__name__
    from_port = getattr(jnorm, cls).from_bytes(t.to_bytes())
    from_jax = getattr(tnorm, cls).from_bytes(j.to_bytes())
    x, y = data[0]
    want = j.transform(JDataSet(x.copy(), y.copy())).features
    _bitwise(from_port.transform(JDataSet(x.copy(), y.copy())).features, want)
    _bitwise(from_jax.transform(DataSet(x.copy(), y.copy())).features, want)


def test_degenerate_ranges_and_multi_normalizer():
    x = np.full((4, 3), 7.0, np.float32)
    for m, ds in ((jnorm, JDataSet), (tnorm, DataSet)):
        nz = m.NormalizerMinMaxScaler(0.5, 0.5).fit(
            (JList if m is jnorm else ListDataSetIterator)([ds(x, x)]))
        assert nz.affine_stats() == (None, None)
        np.testing.assert_array_equal(nz.transform(ds(x.copy(), x)).features, 0.5)
        with pytest.raises(ValueError, match="degenerate"):
            nz.revert_features(x)
    j, t, data = _fitted("standardize", SHAPES["2d"], seed=2)
    jm = jnorm.MultiNormalizer([j, jnorm.ImagePreProcessingScaler()])
    tm = tnorm.MultiNormalizer([t, tnorm.ImagePreProcessingScaler()])
    (x1, _), (x2, _) = data[0], data[1]

    class MDS:
        pass

    a, b = MDS(), MDS()
    a.features, b.features = [x1.copy(), x2.copy()], [x1.copy(), x2.copy()]
    for got, want in zip(tm.transform(b).features, jm.transform(a).features):
        _bitwise(got, want)
    with pytest.raises(NotImplementedError):
        tm.fit(None)
