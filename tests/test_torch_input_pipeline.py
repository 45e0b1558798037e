"""The port's input pipeline (``data/pipeline.py``) on the CPU: the
counterparts of the CPU cases of ``tests/test_input_pipeline.py``.

DevicePrefetchIterator stages every batch, bounds the producer's run-ahead
(depth + queue + 1), stops the producer on an early break and raises a
producer failure as ProducerError, or replays past it with ``retries``.
DeviceNormalizer equals the host transform and the JAX package's
DeviceNormalizer bitwise.  ``blocks_of`` and ``device_blocks`` key blocks
on mask shapes (ndarray masks included) and never fuse mixed masks;
``set_normalizer`` equals host pre-processing; the pipeline counters count
the batches and bytes staged; the device counters are not written again in
a steady fused loop.
"""
import torch_test_threads  # noqa: F401  (first: one torch thread a worker)
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.data import DeviceNormalizer as JDeviceNormalizer
from deeplearning4j_tpu.data import ListDataSetIterator as JList
from deeplearning4j_tpu.data import NormalizerStandardize as JStandardize
from deeplearning4j_tpu.data.dataset import DataSet as JDataSet
from deeplearning4j_tpu_torch import nn as tnn
from deeplearning4j_tpu_torch.data import (DataSet, DeviceNormalizer,
                                           DevicePrefetchIterator,
                                           ImagePreProcessingScaler,
                                           ListDataSetIterator,
                                           NormalizerMinMaxScaler,
                                           NormalizerStandardize, ProducerError,
                                           device_blocks)
from deeplearning4j_tpu_torch.data.iterators import DataSetIterator
from deeplearning4j_tpu_torch.monitor.instrument import pipeline_instruments
from deeplearning4j_tpu_torch.train import Adam
from deeplearning4j_tpu_torch.utils import counters
from deeplearning4j_tpu_torch.utils.scan_fit import blocks_of


def _batches(n, batch=8, n_in=6, n_out=3, seed=0):
    rng = np.random.RandomState(seed)
    return [DataSet((rng.rand(batch, n_in) * 10.0).astype(np.float32),
                    np.eye(n_out, dtype=np.float32)[rng.randint(0, n_out, batch)])
            for _ in range(n)]


def _mlp(seed=7):
    conf = (tnn.NeuralNetConfiguration.builder().seed(seed).updater(Adam(1e-2))
            .list([tnn.DenseLayer(n_out=12, activation="relu"),
                   tnn.OutputLayer(n_out=3, loss="mcxent", activation="softmax")])
            .set_input_type(tnn.InputType.feed_forward(6)).build())
    return tnn.MultiLayerNetwork(conf, device="cpu").init()


class CountingIterator(DataSetIterator):
    """Counts how many batches the producer has pulled; fails once at
    `fail_at` if given."""

    def __init__(self, batches, fail_at=None):
        self.batches = batches
        self.produced = 0
        self.fail_at = fail_at

    def __iter__(self):
        for i, ds in enumerate(self.batches):
            if i == self.fail_at:
                self.fail_at = None
                raise IOError("flaky source")
            self.produced += 1
            yield ds

    def batch_size(self):
        return int(self.batches[0].features.shape[0])

    def __len__(self):
        return len(self.batches)


def test_prefetch_yields_all_batches_staged_and_counts_them():
    batches = _batches(7)
    ins = pipeline_instruments()
    n0, b0 = ins.batches.value, ins.h2d_bytes.value
    pf = DevicePrefetchIterator(ListDataSetIterator(list(batches)), depth=3, device="cpu")
    out = list(pf)
    pf.close()
    assert len(out) == len(batches)
    for got, want in zip(out, batches):
        assert isinstance(got.features, torch.Tensor)
        np.testing.assert_array_equal(got.features.numpy(), want.features)
        np.testing.assert_array_equal(got.labels.numpy(), want.labels)
    assert ins.batches.value - n0 == 7
    assert ins.h2d_bytes.value - b0 == sum(d.features.nbytes + d.labels.nbytes
                                           for d in batches)


def test_prefetch_depth_backpressure():
    depth, qsize = 2, 2
    src = CountingIterator(_batches(16))
    pf = DevicePrefetchIterator(src, depth=depth, queue_size=qsize, device="cpu")
    it = iter(pf)
    consumed = 3
    for _ in range(consumed):
        next(it)
    deadline = time.time() + 1.0
    while src.produced < len(src.batches) and time.time() < deadline:
        time.sleep(0.02)
    assert src.produced <= consumed + depth + qsize + 1
    assert src.produced < len(src.batches)
    it.close()
    pf.close()


def test_prefetch_early_break_stops_producer():
    src = CountingIterator(_batches(32))
    pf = DevicePrefetchIterator(src, depth=2, device="cpu")
    for i, _ in enumerate(pf):
        if i == 1:
            break
    deadline = time.time() + 2.0
    while pf.active_producers() and time.time() < deadline:
        time.sleep(0.02)
    assert pf.active_producers() == 0
    pf.close()
    assert not [t for t in threading.enumerate() if not t.daemon and t.name == "producer"]
    with pytest.raises(ValueError):
        DevicePrefetchIterator(ListDataSetIterator(_batches(2)), depth=0, device="cpu")


def test_producer_error_without_and_with_retries():
    batches = _batches(6)
    pf = DevicePrefetchIterator(CountingIterator(batches, fail_at=3), depth=2, device="cpu")
    with pytest.raises(ProducerError, match="failed at batch 3") as err:
        list(pf)
    assert isinstance(err.value.__cause__, IOError)
    retries0 = pipeline_instruments().producer_retries.value
    pf = DevicePrefetchIterator(CountingIterator(batches, fail_at=3), depth=2,
                                retries=2, retry_backoff_s=0.0, device="cpu")
    out = list(pf)
    assert len(out) == 6
    for got, want in zip(out, batches):
        np.testing.assert_array_equal(got.features.numpy(), want.features)
    assert pipeline_instruments().producer_retries.value == retries0 + 1


def _fitted(nz, batches):
    return nz.fit(ListDataSetIterator(list(batches)))


@pytest.mark.parametrize("make_nz", [
    lambda b: _fitted(NormalizerStandardize(), b),
    lambda b: _fitted(NormalizerStandardize(fit_labels=True), b),
    lambda b: _fitted(NormalizerMinMaxScaler(), b),
    lambda b: _fitted(NormalizerMinMaxScaler(-1.0, 2.0), b),
    lambda b: ImagePreProcessingScaler(),
    lambda b: ImagePreProcessingScaler(-1.0, 1.0),
], ids=["standardize", "standardize+labels", "minmax01", "minmax-12",
        "image01", "image-11"])
def test_device_normalizer_bitwise(make_nz):
    batches = _batches(3, batch=16, n_in=5, seed=3)
    nz = make_nz(batches)
    x, y = batches[0].features, batches[0].labels
    host = nz.transform(DataSet(x.copy(), y.copy()))
    dn = DeviceNormalizer.from_host(nz, device="cpu")
    got = dn.apply_features(torch.from_numpy(x)).numpy()
    assert got.dtype == np.float32
    assert np.array_equal(got.view(np.uint32), host.features.view(np.uint32))
    got_y = dn.apply_labels(torch.from_numpy(y)).numpy()
    assert np.array_equal(got_y.view(np.uint32), host.labels.view(np.uint32))
    # a f64 batch takes the same f32 path
    got64 = dn.apply_features(torch.from_numpy(x.astype(np.float64))).numpy()
    assert np.array_equal(got64.view(np.uint32), host.features.view(np.uint32))


def test_device_normalizer_matches_the_jax_one_bitwise():
    batches = _batches(3, batch=16, n_in=5, seed=5)
    jnz = JStandardize().fit(JList([JDataSet(d.features, d.labels) for d in batches]))
    tnz = _fitted(NormalizerStandardize(), batches)
    x = batches[1].features
    want = np.asarray(jax.jit(JDeviceNormalizer.from_host(jnz).apply_features)(
        jnp.asarray(x)))
    got = DeviceNormalizer.from_host(tnz, device="cpu").apply_features(
        torch.from_numpy(x)).numpy()
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))


def test_device_normalizer_rejects_unfitted_and_unknown():
    with pytest.raises(ValueError):
        DeviceNormalizer.from_host(NormalizerStandardize(), device="cpu")
    with pytest.raises(ValueError):
        DeviceNormalizer.from_host(NormalizerMinMaxScaler(), device="cpu")
    with pytest.raises(TypeError):
        DeviceNormalizer.from_host(object(), device="cpu")
    dn = DeviceNormalizer.from_host(ImagePreProcessingScaler(), device="cpu")
    assert DeviceNormalizer.from_host(dn) is dn


def test_set_normalizer_matches_host_preprocessing():
    batches = _batches(6, seed=11)
    nz = _fitted(NormalizerStandardize(), batches)
    host_net, dev_net = _mlp(), _mlp()
    for ds in batches:
        d = nz.transform(DataSet(ds.features.copy(), ds.labels))
        host_net.fit(d.features, d.labels)
    dev_net.set_normalizer(nz)
    for ds in batches:
        dev_net.fit(ds.features, ds.labels)
    for (n, a), (_, b) in zip(host_net.state_dict().items(), dev_net.state_dict().items()):
        assert torch.equal(a, b), n
    x = batches[0].features
    hx = nz.transform(DataSet(x.copy(), None)).features
    assert torch.equal(dev_net.output(x), host_net.output(hx))
    assert dev_net.score_for(x, batches[0].labels) == host_net.score_for(hx, batches[0].labels)
    dev_net.set_normalizer(None)
    assert dev_net._device_norm is None


def test_blocks_of_keys_on_ndarray_and_mixed_masks():
    batches = _batches(7, seed=9)
    for i in (0, 1, 2, 3):                 # multi-element ndarray masks
        batches[i].labels_mask = np.ones(8, np.float32)
    batches[5].features_mask = np.ones((8, 6), np.float32)
    sizes = [len(b) for b in blocks_of(ListDataSetIterator(list(batches)), 2)]
    # [0,1] [2,3] masked blocks; 4 unmasked; 5 masked alone; 6 unmasked
    assert sizes == [2, 2, 1, 1, 1]


def test_device_blocks_fuse_masked_blocks_and_degrade_mixed_ones():
    batches = _batches(5, seed=9)
    for ds in batches[:2]:
        ds.labels_mask = np.ones(8, np.float32)
    batches[3].features_mask = np.ones_like(batches[3].features)
    out = list(device_blocks(ListDataSetIterator(list(batches)), 2, device="cpu"))
    kinds = [k for k, _ in out]
    assert kinds == ["block", "single", "single", "single"]
    xs, ys, fms, lms = out[0][1]
    assert fms is None and len(lms) == 2 and isinstance(lms[0], torch.Tensor)
    assert getattr(out[2][1], "features_mask", None) is not None
    assert sum(1 if k == "single" else len(p[0]) for k, p in out) == 5


def test_streaming_fused_epoch_matches_stacked_and_per_step():
    batches = _batches(8, seed=5)
    streaming, stacked, prefetched = _mlp(), _mlp(), _mlp()
    streaming.fit(ListDataSetIterator(list(batches)), fused_steps=4)
    for lo in (0, 4):
        stacked.fit_steps(np.stack([d.features for d in batches[lo:lo + 4]]),
                          np.stack([d.labels for d in batches[lo:lo + 4]]))
    pf = DevicePrefetchIterator(ListDataSetIterator(list(batches)), depth=2, device="cpu")
    prefetched.fit(pf, fused_steps=4)
    pf.close()
    for a, b, c in zip(streaming.parameters(), stacked.parameters(), prefetched.parameters()):
        assert torch.equal(a, b) and torch.equal(a, c)
    assert pf.active_producers() == 0


def test_fit_steps_list_form_validation_and_a_steady_loop_uploads_nothing():
    net = _mlp()
    xs = [np.zeros((4, 6), np.float32)] * 2
    with pytest.raises(ValueError):
        net.fit_steps(xs, np.zeros((2, 4, 3), np.float32))     # ys not a list
    with pytest.raises(ValueError, match="all 2 steps or none"):
        net.fit_steps(xs, [np.zeros((4, 3), np.float32)] * 2, [np.ones((4,)), None])
    batches = _batches(4, seed=13)
    xl = [torch.from_numpy(d.features) for d in batches]
    yl = [torch.from_numpy(d.labels) for d in batches]
    net.fit_steps(xl, yl)
    before = counters.counter_uploads.value
    for _ in range(3):
        net.fit_steps(xl, yl)
    assert counters.counter_uploads.value == before
    assert isinstance(net.score_array(), torch.Tensor) and net.iteration == 16
