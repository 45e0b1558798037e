"""ModelServer of the PyTorch port against the JAX package's ModelServer.

Both servers serve LeNet with the same weights (the JAX-initialized params
carried across); concurrent mixed-size requests must get the same answers
(f32, max|diff| <= 1e-5).  Also: the bucket ladder, hit/miss counts after
warmup, readiness, draining shutdown, and the options not ported yet.
"""
import threading
from concurrent.futures import ThreadPoolExecutor

import jax
import numpy as np
import pytest

from deeplearning4j_tpu import zoo as jzoo
from deeplearning4j_tpu.serving import ModelServer as JaxModelServer
from deeplearning4j_tpu.serving.compile_cache import bucket_for as jax_bucket_for
from deeplearning4j_tpu.serving.compile_cache import bucket_sizes as jax_bucket_sizes
from deeplearning4j_tpu_torch import convert
from deeplearning4j_tpu_torch import zoo as tzoo
from deeplearning4j_tpu_torch.serving import (BucketedCompileCache,
                                              ModelServer, RejectedError,
                                              bucket_for, bucket_sizes)


@pytest.fixture(scope="module")
def lenets():
    jnet = jzoo.LeNet().init_model()
    tnet = tzoo.LeNet().init_model(device="cpu")
    convert.params_from_jax(tnet, jax.tree_util.tree_map(np.asarray,
                                                          jnet.params_))
    return jnet, tnet


def _requests(n=24, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randn(1 + i % 5, 28, 28, 1).astype(np.float32)
            for i in range(n)]


def test_bucket_ladder_matches_jax():
    for mb in (1, 5, 8, 16, 33):
        for lo in (1, 2, 3):
            assert bucket_sizes(mb, lo) == jax_bucket_sizes(mb, lo)
            for n in range(1, mb + 1):
                assert bucket_for(n, mb, lo) == jax_bucket_for(n, mb, lo)


def test_concurrent_answers_equal_jax_server(lenets):
    jnet, tnet = lenets
    reqs = _requests()
    jsrv = JaxModelServer(max_batch=8, batch_timeout_ms=20.0)
    tsrv = ModelServer(max_batch=8, batch_timeout_ms=20.0, device="cpu")
    try:
        jsrv.deploy("lenet", model=jnet)
        tsrv.deploy("lenet", model=tnet)
        with ThreadPoolExecutor(max_workers=8) as ex:
            want = list(ex.map(lambda r: jsrv.output("lenet", r, timeout=120), reqs))
            got = list(ex.map(lambda r: tsrv.output("lenet", r, timeout=120), reqs))
        stats = tsrv.stats()
    finally:
        jsrv.shutdown()
        tsrv.shutdown()
    for g, w, r in zip(got, want, reqs):
        assert g.shape == w.shape == (r.shape[0], 10)
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5)
    assert stats["completed"] == len(reqs)
    assert stats["failed"] == stats["rejected"] == 0
    assert stats["compile_cache"]["misses"] <= tsrv.cache.num_buckets
    assert stats["batch_occupancy"] >= 1.0


def test_warmup_counts_and_readiness(lenets):
    _, tnet = lenets
    srv = ModelServer(max_batch=8, device="cpu")
    try:
        assert not srv.readyz()["ready"]          # nothing deployed
        entry = srv.deploy("lenet", model=tnet, warmup=True)
        assert entry.warmed_buckets == [1, 2, 4, 8]
        assert srv.stats()["compile_cache"] == {
            "hits": 0, "misses": 4, "hit_rate": 0.0}
        assert srv.readyz() == {"ready": True, "reasons": []}
        reqs = _requests(6, seed=1)
        for r in reqs:
            srv.output("lenet", r, timeout=60)
        snap = srv.stats()
        assert snap["compile_cache"]["misses"] == 4   # warm: no new misses
        assert snap["compile_cache"]["hits"] == snap["dispatches"] == 6
        assert snap["device"] == "cpu" and snap["buckets"] == [1, 2, 4, 8]
        assert srv.healthz()["ok"]
    finally:
        srv.shutdown()
    assert not srv.readyz()["ready"]
    with pytest.raises(RejectedError):
        srv.submit("lenet", _requests(1)[0])


def test_shutdown_drains_accepted_requests(lenets):
    _, tnet = lenets
    srv = ModelServer(max_batch=8, batch_timeout_ms=50.0, device="cpu")
    srv.deploy("lenet", model=tnet)
    gate = threading.Event()
    real = srv.cache.run

    def slow_run(*a, **kw):        # hold the first dispatch so a queue forms
        gate.wait(timeout=30)
        return real(*a, **kw)

    srv.cache.run = slow_run
    futs = [srv.submit("lenet", r) for r in _requests(10, seed=2)]
    gate.set()
    srv.shutdown(drain=True, timeout=60)
    outs = [f.result(timeout=0) for f in futs]
    assert all(o.shape[1] == 10 and np.isfinite(o).all() for o in outs)
    assert srv.stats()["completed"] == 10
    assert not srv.batcher._worker.is_alive()


def test_zoo_deploy_builds_on_the_server_device():
    srv = ModelServer(max_batch=2, device="cpu")
    try:
        entry = srv.deploy("lenet", zoo="LeNet", seed=5)
        assert entry.source == "zoo" and entry.model.device.type == "cpu"
        assert entry.input_shape == (28, 28, 1)
        out = srv.output("lenet", _requests(1)[0], timeout=60)
        assert out.shape == (1, 10)
        with pytest.raises(KeyError):
            srv.deploy("x", zoo="NoSuchNet")
    finally:
        srv.shutdown()


@pytest.mark.parametrize("kw", [dict(mesh=object()), dict(cache_dir="c"),
                                dict(schedule=object())])
def test_unported_server_options_raise(kw):
    # mesh= reaches the cache, which raises; the others are not parameters
    exc = NotImplementedError if "mesh" in kw else TypeError
    with pytest.raises(exc):
        ModelServer(device="cpu", **kw)


def test_unported_cache_options_and_sources_raise(lenets):
    with pytest.raises(NotImplementedError):
        BucketedCompileCache(persistent="somewhere")
    with pytest.raises(NotImplementedError):
        BucketedCompileCache(mesh=object())
    srv = ModelServer(device="cpu")
    try:
        with pytest.raises(ValueError, match="exactly one"):
            srv.deploy("k", keras="model.h5")
        with pytest.raises(ValueError):
            srv.deploy("k", model=lenets[1], zoo="LeNet")
    finally:
        srv.shutdown()
