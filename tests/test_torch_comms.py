"""Hierarchical gradient sharing in the PyTorch port
(``parallel/hierarchical.py``, ``compression.py``, ``transport.py``, the
split step of ``nn/multilayer.py`` and ``nn/graph.py``) against the JAX
package.

- Framing: ``pack_streams``/``pack_dense`` write the JAX framers' bytes
  (a 0-d leaf included), and a JAX mesh and a port mesh in two threads
  exchange payloads with the results and byte counts of a JAX-only pair.
- The exchange: the port's and the JAX package's
  ``HierarchicalAllReduce(world=1)`` fed one gradient sequence, dense and
  compressed, give bitwise equal outputs, thresholds, residuals and stats.
- The split step: dense sharing at world 1 equals the plain ``fit`` bit
  for bit (f32: the exchange rounds to f32) on an MLN and a CG, through
  ``fit``, ``fit_steps`` and ``fit(iterator, fused_steps=k)`` (which step
  one by one, listeners hearing every step); compressed sharing converges
  and records the four ``comms_*`` series; a port MLN with sharing tracks
  the JAX one with sharing (1e-5 relative, f32).
- On 2 gloo ranks (the rank pool of ``test_torch_parallel.py``): ZeRO-1
  plus sharing equals plain ZeRO-1 bitwise for Sgd through ``fit_steps``;
  the wrapper's builder and run-time toggle; a 2-rank wrapper (one host)
  under a gang of 2 hosts whose other host never comes: the leader's
  formation timeout raises on both ranks of the host.
- A 2-process port gang (``LocalLauncher(gang=True)``, the TCP mesh only)
  trains dense and compressed with bitwise equal parameters on both
  ranks; dense tracks one process on the global batch (1e-5), compressed
  ships fewer bytes.
"""
import torch_test_threads  # noqa: F401  (first: one torch thread a worker)
import json
import os
import threading
import time

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch import nn as tnn
from deeplearning4j_tpu_torch.data import DataSet, ListDataSetIterator
from deeplearning4j_tpu_torch.monitor.registry import registry, set_enabled
from deeplearning4j_tpu_torch.parallel import (HierarchicalAllReduce,
                                               HierarchicalGradientSharing, ParallelWrapper,
                                               multihost)
from deeplearning4j_tpu_torch.parallel import compression as tcomp
from deeplearning4j_tpu_torch.parallel import transport as ttr
from deeplearning4j_tpu_torch.train import CollectScoresListener, Sgd
from test_torch_parallel import RankPool, equal_trees, port_net, ranks_equal, snapshot

HERE = os.path.dirname(os.path.abspath(__file__))


def _conf(n_in=8, lr=0.1, seed=7, norm=None):
    b = tnn.NeuralNetConfiguration.builder().seed(seed).updater(Sgd(lr))
    if norm is not None:
        b = b.gradient_normalization(*norm)
    return (b.list([tnn.DenseLayer(n_out=16, activation="relu"),
                    tnn.OutputLayer(n_out=3, loss="mcxent", activation="softmax")])
            .set_input_type(tnn.InputType.feed_forward(n_in)).build())


def _net(**kw):
    return tnn.MultiLayerNetwork(_conf(**kw), device="cpu").init()


def _data(n=32, n_in=8, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, n_in).astype(np.float32)
    labels = (x[:, 0] > 0).astype(int) + (x[:, 1] > 0).astype(int)
    return x, np.eye(3, dtype=np.float32)[labels]


def _same_params(a, b):
    sa, sb = a.state_dict(), b.state_dict()
    assert sa.keys() == sb.keys()
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k


def _dense(**kw):
    return HierarchicalGradientSharing(compressed=False, world=1, **kw)


# ---------------------------------------------------------------------------
# codec contracts and framing
# ---------------------------------------------------------------------------

def test_decode_explicit_thresholds_leave_the_codecs_alone():
    ex = tcomp.CompressedGradientExchange({"w": np.zeros((8, 4), np.float32)},
                                          threshold=0.01)
    streams = ex.encode({"w": torch.full((8, 4), 0.05)})
    before = [c.threshold for c in ex.codecs]
    assert float(ex.decode(streams, thresholds=[0.5])["w"][0, 0]) == pytest.approx(0.5)
    assert [c.threshold for c in ex.codecs] == before
    assert float(ex.decode(streams)["w"][0, 0]) == pytest.approx(0.01)
    empty = tcomp.CompressedGradientExchange({}, threshold=0.01)
    assert empty.decode(empty.encode({}), thresholds=[]) == {}


def test_residual_error_feedback_flushes_to_the_true_sum():
    thr = 0.01
    g = {"w": np.random.RandomState(0).randn(64).astype(np.float32) * 0.03}
    ex = tcomp.CompressedGradientExchange(g, threshold=thr)
    total = ex.decode(ex.encode(g))["w"].copy()
    for _ in range(20):
        total += ex.decode(ex.encode({"w": np.zeros(64, np.float32)}))["w"]
    np.testing.assert_allclose(total, g["w"], atol=thr + 1e-7)
    taken = ex.take_residuals()
    assert ex.residual_norm() == 0.0
    ex.flush_into(taken)
    np.testing.assert_array_equal(ex.residuals()[0], taken[0])
    with pytest.raises(ValueError, match="residual shape"):
        ex.flush_into([np.zeros(3, np.float32)])


def test_framing_bytes_equal_the_jax_framers():
    from deeplearning4j_tpu.parallel import transport as jtr
    streams = [np.array([1, -3, 7], np.int32), np.array([], np.int32),
               np.array([-1], np.int32)]
    thrs = [0.01, 0.5, 1e-6]
    assert ttr.pack_streams(streams, thrs) == jtr.pack_streams(streams, thrs)
    back, back_thr = ttr.unpack_streams(jtr.pack_streams(streams, thrs))
    for a, b in zip(back, streams):
        np.testing.assert_array_equal(a, b)
    assert back_thr == jtr.unpack_streams(jtr.pack_streams(streams, thrs))[1]
    leaves = [np.arange(12, dtype=np.float32).reshape(3, 4), np.float32(2.5),
              np.array([], np.float32), np.ones((2, 1, 3), np.float64)]
    assert ttr.pack_dense(leaves) == jtr.pack_dense(leaves)
    got = ttr.unpack_dense(jtr.pack_dense(leaves))
    assert [a.shape for a in got] == [(3, 4), (), (0,), (2, 1, 3)]
    for a, b in zip(got, leaves):
        np.testing.assert_array_equal(a, np.asarray(b, np.float32))


def _mesh_round(make0, make1, port, payloads):
    """Rank 0 and rank 1 meshes in two threads, each all-gathering its
    payloads in turn: (results, byte counts) per rank."""
    out = {}

    def run(rank, make):
        mesh = make(rank=rank, world=2, port=port, timeout=20.0)
        try:
            got = [mesh.allgather(p[rank]) for p in payloads]
            out[rank] = (got, mesh.bytes_sent, mesh.bytes_received)
        finally:
            mesh.close()
    threads = [threading.Thread(target=run, args=(r, m)) for r, m in ((0, make0), (1, make1))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    return out


@pytest.mark.parametrize("port_rank", [0, 1])
def test_a_mixed_jax_and_port_mesh_exchanges_as_a_jax_pair(port_rank):
    from deeplearning4j_tpu.parallel import transport as jtr
    rng = np.random.RandomState(port_rank)
    payloads = [(rng.bytes(n0), rng.bytes(n1)) for n0, n1 in ((5, 900), (0, 3), (4096, 17))]
    mixed = (ttr.TcpGradientMesh, jtr.TcpGradientMesh)[::1 if port_rank == 0 else -1]
    got = _mesh_round(*mixed, multihost.free_port(), payloads)
    want = _mesh_round(jtr.TcpGradientMesh, jtr.TcpGradientMesh, multihost.free_port(),
                       payloads)
    assert got == want
    assert got[0][0] == [list(p) for p in payloads]


# ---------------------------------------------------------------------------
# failure posture: named ranks, fail fast, sockets closed
# ---------------------------------------------------------------------------

def test_dead_coordinator_fails_fast_with_a_named_error():
    port = multihost.free_port()
    t0 = time.monotonic()
    with pytest.raises(ttr.PeerUnreachableError) as ei:
        ttr.TcpGradientMesh(rank=1, world=2, port=port, timeout=1.0)
    assert time.monotonic() - t0 < 5.0
    msg = str(ei.value)
    assert "rank 0" in msg and str(port) in msg and "unreachable" in msg
    assert issubclass(ttr.PeerUnreachableError, ConnectionError)


def test_formation_timeout_names_the_missing_ranks():
    with pytest.raises(ttr.PeerUnreachableError) as ei:
        ttr.TcpGradientMesh(rank=0, world=3, port=multihost.free_port(), timeout=0.5)
    assert "[1, 2]" in str(ei.value) and "never connected" in str(ei.value)


def test_a_peer_dead_mid_exchange_is_named_and_the_sockets_closed():
    port = multihost.free_port()
    peer = {}

    def rank1():
        peer["mesh"] = ttr.TcpGradientMesh(rank=1, world=2, port=port, timeout=5.0)
    t = threading.Thread(target=rank1)
    t.start()
    mesh = ttr.TcpGradientMesh(rank=0, world=2, port=port, timeout=1.0)
    t.join(timeout=10)
    peer["mesh"].close()
    with pytest.raises(ttr.PeerUnreachableError, match="with rank 1"):
        mesh.allgather(b"x")
    assert mesh._closed and mesh._peers == [None, None] and mesh._server is None


def test_config_resolves_from_the_launcher_env(monkeypatch):
    monkeypatch.setenv("DL4J_TPU_PROCESS_ID", "3")
    monkeypatch.setenv("DL4J_TPU_NUM_PROCESSES", "4")
    monkeypatch.setenv(multihost.ENV_GRAD_PORT, "50123")
    cfg = HierarchicalGradientSharing().resolve()
    assert (cfg.rank, cfg.world, cfg.port, cfg.host) == (3, 4, 50123, "127.0.0.1")
    monkeypatch.setenv(multihost.ENV_GRAD_HOST, "10.0.0.2")
    assert HierarchicalGradientSharing(port=7).resolve().host == "10.0.0.2"
    with pytest.raises(ValueError, match="combine"):
        HierarchicalGradientSharing(combine="max")
    # elastic membership is ported: the runtime builds, and without an
    # elastic mesh the joiner and evict pass-throughs are the JAX no-ops
    assert HierarchicalAllReduce(HierarchicalGradientSharing(elastic=True, world=1)) \
        .config.elastic
    rt = HierarchicalAllReduce(_dense())
    rt.set_resume_step_provider(lambda: 0)
    assert (rt.has_pending_joiner(), rt.wait_for_joiner(0.1), rt.admit_joiners(0),
            rt.request_evict(1)) == (False, False, None, None)
    with pytest.raises(TypeError, match="HierarchicalGradientSharing"):
        _net().set_gradient_sharing(True)


# ---------------------------------------------------------------------------
# the exchange against the JAX package's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("compressed", [False, True])
def test_world1_exchange_equals_the_jax_exchange(compressed):
    from deeplearning4j_tpu.parallel.hierarchical import (
        HierarchicalAllReduce as JaxAllReduce, HierarchicalGradientSharing as JaxSharing)
    kw = dict(compressed=compressed, world=1, threshold=2e-3, adaptive_target_density=0.05)
    port, jax_ = HierarchicalAllReduce(HierarchicalGradientSharing(**kw)), \
        JaxAllReduce(JaxSharing(**kw))
    rng = np.random.RandomState(5)
    for step in range(6):
        g = {"layer_10": {"W": rng.randn(3, 3, 2, 4) * 0.01, "b": rng.randn(4) * 0.01},
             "layer_2": {"W": rng.randn(8, 5) * 3e-3, "b": np.float64(rng.randn() * 0.01)},
             "layer_3": {}}
        got = port.exchange({k: {kk: torch.as_tensor(v) for kk, v in sub.items()}
                             for k, sub in g.items()})
        want = jax_.exchange(g)
        equal_trees(got, want, f"step {step}")
        if compressed:
            assert port._exchange.thresholds() == jax_._exchange.thresholds()
            assert [c.threshold for c in port._exchange.codecs] == \
                [c.threshold for c in jax_._exchange.codecs]
            for a, b in zip(port._exchange.residuals(), jax_._exchange.residuals()):
                np.testing.assert_array_equal(a, b)
        assert port.stats() == jax_.stats()
    port.close()
    jax_.close()


# ---------------------------------------------------------------------------
# the split step, one process
# ---------------------------------------------------------------------------

def test_world1_dense_sharing_equals_the_plain_fit_bit_for_bit():
    x, y = _data()
    ref, shared = _net(), _net()
    shared.set_gradient_sharing(_dense())
    for _ in range(5):
        ref.fit(x, y)
        shared.fit(x, y)
    _same_params(ref, shared)
    assert ref.iteration == shared.iteration == 5
    assert shared.score() == ref.score()
    # fit_steps and fit(iterator, fused_steps) run step by step while sharing
    xs, ys = np.stack([x, x[::-1], x]), np.stack([y, y[::-1], y])
    heard = CollectScoresListener(frequency=1)
    shared.set_listeners(heard)
    assert torch.equal(shared.fit_steps(xs, ys), ref.fit_steps(xs, ys))
    assert len(heard.scores) == 3 and shared._scan_step is None
    it = ListDataSetIterator([DataSet(a, b) for a, b in zip(xs, ys)] * 2)
    ref.fit(it, fused_steps=3)
    shared.fit(it, fused_steps=3)
    _same_params(ref, shared)
    assert len(heard.scores) == 9 and shared.iteration == ref.iteration == 14
    shared.set_gradient_sharing(None)
    assert shared.gradient_sharing is None


def _cg():
    conf = (tnn.GraphBuilder().seed(5).updater(Sgd(0.1)).add_inputs("in")
            .set_input_types(tnn.InputType.feed_forward(8))
            .add_layer("d", tnn.DenseLayer(n_out=12, activation="tanh"), "in")
            .add_layer("out", tnn.OutputLayer(n_out=3, loss="mcxent", activation="softmax"),
                       "d")
            .set_outputs("out").build())
    return tnn.ComputationGraph(conf, device="cpu").init()


def test_computation_graph_world1_dense_sharing_equals_the_plain_fit():
    x, y = _data(n=16)
    ref, shared = _cg(), _cg()
    shared.set_gradient_sharing(_dense())
    for _ in range(5):
        ref.fit(x, y)
        shared.fit(x, y)
    _same_params(ref, shared)
    xs, ys = np.stack([x, x]), np.stack([y, y])
    assert torch.equal(shared.fit_steps(xs, ys), ref.fit_steps(xs, ys))
    _same_params(ref, shared)
    it = ListDataSetIterator([DataSet(x, y), DataSet(x[::-1], y[::-1]), DataSet(x, y)])
    ref.fit(it, fused_steps=2)
    shared.fit(it, fused_steps=2)
    _same_params(ref, shared)
    assert shared.gradient_sharing.exchanges == 10 and shared._scan_step is None
    shared.set_gradient_sharing(None)
    assert shared.gradient_sharing is None


def test_world1_compressed_converges_and_records_the_comms_series():
    x, y = _data(n=64)
    net = _net()
    net.set_gradient_sharing(HierarchicalGradientSharing(threshold=5e-3, world=1))
    before = registry().get("comms_exchanges_total", {"codec": "threshold"})
    before = before.value if before is not None else 0
    first = None
    for _ in range(40):
        net.fit(x, y)
        first = net.score() if first is None else first
    assert net.score() < first * 0.8
    st = net.gradient_sharing.stats()
    assert st["exchanges"] == 40 and st["compressed"] and st["world"] == 1
    assert st["last_wire_bytes"] > 0
    assert registry().get("comms_exchanges_total", {"codec": "threshold"}).value \
        == before + 40
    assert registry().get("comms_bytes_on_wire_total", {"codec": "threshold"}).value > 0
    assert registry().get("comms_compression_ratio").value > 1.0
    assert registry().get("comms_exchange_ms").count >= 40
    set_enabled(False)
    try:
        net.fit(x, y)
    finally:
        set_enabled(True)
    assert registry().get("comms_exchanges_total", {"codec": "threshold"}).value \
        == before + 40
    net.set_gradient_sharing(None)


def test_port_sharing_tracks_the_jax_sharing():
    from deeplearning4j_tpu import nn as jnn
    from deeplearning4j_tpu.parallel.hierarchical import HierarchicalGradientSharing as JS
    from deeplearning4j_tpu.train.updaters import Sgd as JSgd
    import jax
    conf = (jnn.NeuralNetConfiguration.builder().seed(7).updater(JSgd(0.1))
            .list([jnn.DenseLayer(n_out=16, activation="relu"),
                   jnn.OutputLayer(n_out=3, loss="mcxent", activation="softmax")])
            .set_input_type(jnn.InputType.feed_forward(8)).build())
    x, y = _data(n=32)
    for kw in (dict(compressed=False), dict(threshold=5e-3)):
        jnet = jnn.MultiLayerNetwork(conf).init()
        params = jax.tree_util.tree_map(np.asarray, jnet.params_)
        net = port_net(conf.to_json(), params)
        jnet.set_gradient_sharing(JS(world=1, **kw))
        net.set_gradient_sharing(HierarchicalGradientSharing(world=1, **kw))
        for _ in range(5):
            jnet.fit(x, y)
            net.fit(x, y)
            assert net.score() == pytest.approx(jnet.score(), rel=1e-5)
        want = jax.tree_util.tree_map(np.asarray, jnet.params_)
        got = snapshot(net, opt=False)["params"]
        for name in want:
            for k in want[name]:
                np.testing.assert_allclose(got[name][k], want[name][k], rtol=1e-5, atol=1e-6)
        jnet.set_gradient_sharing(None)
        net.set_gradient_sharing(None)


# ---------------------------------------------------------------------------
# two gloo ranks: ZeRO-1, the wrapper
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def pool():
    p = RankPool()
    yield p
    p.close()


def _task_zero1_sharing(conf_json, xs, ys):
    """The same fit_steps block under plain ZeRO-1 and ZeRO-1 + dense
    world-1 sharing."""
    out = []
    for sharing in (None, _dense()):
        net = tnn.MultiLayerNetwork(tnn.MultiLayerConfiguration.from_json(conf_json),
                                    device="cpu").init()
        pw = ParallelWrapper(net, optimizer_sharding=True, gradient_sharing=sharing)
        losses = pw.fit_steps(xs, ys)
        from deeplearning4j_tpu_torch.parallel import disable_zero1
        exchanges = net.gradient_sharing.exchanges if sharing is not None else 0
        if sharing is not None:
            pw.gradient_sharing(None)
        disable_zero1(net)
        out.append((snapshot(net), losses.tolist(), exchanges))
    return out


@pytest.mark.parametrize("norm", [None, ("ClipL2PerLayer", 0.05)])
def test_zero1_with_sharing_equals_plain_zero1(pool, norm):
    rng = np.random.RandomState(2)
    xs = rng.randn(4, 32, 8).astype(np.float32)
    ys = np.eye(3, dtype=np.float32)[rng.randint(0, 3, (4, 32))]
    got = pool.run(_task_zero1_sharing, _conf(norm=norm).to_json(), xs, ys)
    for (plain, l_plain, _), (shared, l_shared, n) in got:
        equal_trees(shared, plain)
        assert l_shared == l_plain and n == 4
        assert shared["iteration"] == 4
    ranks_equal([r[1][0] for r in got])


def _task_wrapper(conf_json, x, y, port):
    net = tnn.MultiLayerNetwork(tnn.MultiLayerConfiguration.from_json(conf_json),
                                device="cpu").init()
    pw = ParallelWrapper.builder(net).workers(2).gradient_sharing(_dense()).build()
    pw.fit(x, y)
    on = (net.gradient_sharing is not None, net.gradient_sharing.world)
    pw.gradient_sharing(False)
    pw.fit(x, y)
    off = net.gradient_sharing is None
    pw.gradient_sharing(True)                 # the environment's defaults: world 1
    pw.fit(x, y)
    env = net.gradient_sharing.world
    err = None
    import torch.distributed as dist
    gang = ParallelWrapper.builder(net).gradient_sharing(HierarchicalGradientSharing(
        world=2, rank=dist.get_rank(), port=port, timeout=2.0)).build()
    try:
        gang.fit(x, y)
    except (ConnectionError, RuntimeError) as e:
        err = str(e)
    return on, off, env, net.iteration, err, snapshot(net, opt=False)


def test_wrapper_builder_and_runtime_toggle(pool):
    x, y = _data()
    got = pool.run(_task_wrapper, _conf().to_json(), x, y, multihost.free_port())
    for on, off, env, iteration, err, _ in got:
        assert on == (True, 1) and off and env == 1 and iteration == 3
        assert err is not None and "never connected" in err
    ranks_equal([r[5] for r in got])


# ---------------------------------------------------------------------------
# a two-process port gang on the CPU
# ---------------------------------------------------------------------------

def test_a_two_process_gang_keeps_its_ranks_bitwise_equal(tmp_path):
    """The JAX package's two-process A/B (``tests/test_comms.py``, 40
    steps of 16 rows a rank, its bounds), in the port, from the JAX
    network's initial parameters."""
    from deeplearning4j_tpu import nn as jnn
    from deeplearning4j_tpu.train.updaters import Sgd as JSgd
    steps, rows = 40, 16
    jconf = (jnn.NeuralNetConfiguration.builder().seed(7).updater(JSgd(0.1))
             .list([jnn.DenseLayer(n_out=32, activation="tanh"),
                    jnn.OutputLayer(n_out=3, loss="mcxent", activation="softmax")])
             .set_input_type(jnn.InputType.feed_forward(16)).build())
    init = np.asarray(jnn.MultiLayerNetwork(jconf).init().params(), np.float32)
    np.save(tmp_path / "init.npy", init)
    worker = os.path.join(HERE, "mh_worker_torch_comms.py")
    multihost.LocalLauncher(2, platform="cpu", gang=True).run(
        worker, [str(tmp_path), steps, rows, multihost.free_port()], timeout=120,
        gradient_port=multihost.free_port())
    res = {}
    for mode in ("dense", "compressed"):
        runs = [np.load(tmp_path / f"{mode}_{r}.npz") for r in range(2)]
        stats = [json.loads((tmp_path / f"{mode}_{r}.json").read_text()) for r in range(2)]
        np.testing.assert_array_equal(runs[0]["params"], runs[1]["params"])
        assert [s["world"] for s in stats] == [2, 2]
        assert all(s["exchanges"] == steps for s in stats)
        res[mode] = {"loss": float(np.mean([r["losses"][-1] for r in runs])),
                     "wire": sum(s["bytes_sent_total"] + s["bytes_received_total"]
                                 for s in stats), "params": runs[0]["params"]}
    # dense over the gang is the global-mean gradient: one process on the
    # global batch, within f32 rounding
    import mh_worker_torch_comms as w
    one = w.mlp(init)
    for xg, yg in w.stream(steps, rows):
        one.fit(xg, yg)
    np.testing.assert_allclose(res["dense"]["params"], one.params(), rtol=1e-5, atol=1e-6)
    assert res["dense"]["wire"] > res["compressed"]["wire"] * 2
    rel = abs(res["compressed"]["loss"] - res["dense"]["loss"]) / abs(res["dense"]["loss"])
    assert rel < 0.05, res
