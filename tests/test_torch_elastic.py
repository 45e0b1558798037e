"""Elastic gang membership in the PyTorch port (``parallel/transport.py``'s
``ElasticGradientMesh``, ``parallel/hierarchical.py``'s elastic branch,
``parallel/zero.py``'s resharding, ``parallel/mesh.py`` over part of the
ranks, ``utils/chaos.py``'s ``PeerKiller``, ``train/resilience.py``'s
``ElasticTrainer`` and ``parallel/multihost.py``'s ``run_elastic``).

- The protocol, mesh by mesh in threads over loopback with heartbeats of
  0.05 s (the port of ``tests/test_elastic.py``'s fast cases): frames,
  rounds, crash, stale-generation fencing, partition and eviction,
  straggler, joiner admission.
- A MIXED gang in threads: a port coordinator with JAX peers and a JAX
  coordinator with port peers exchange bitwise equal payloads, and a
  crash re-forms both sides to the same generation, world, rank map, cause
  and resume step.  This pins the frames byte for byte.
- ``reshard_zero1``, ``make_mesh(devices=)`` and ``workers(n)`` below the
  world on the 2-rank gloo pool of ``test_torch_parallel.py``.
- One kill-shrink gang of 3 processes (``tests/mh_worker_torch_elastic_gang.py``,
  bench.py ``--elastic --quick``'s 12 steps, rank 2 killed at step 4):
  one ``crash`` reformation to world 2, and the survivors' parameters
  bitwise those of a clean world-2 gang from the resume checkpoint.
"""
import torch_test_threads  # noqa: F401  (first: one torch thread a worker)
import json
import os
import shutil
import socket
import threading
import time
import types

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch import nn as tnn
from deeplearning4j_tpu_torch.parallel import multihost
from deeplearning4j_tpu_torch.parallel import transport as ttr
from deeplearning4j_tpu_torch.parallel.multihost import free_port
from deeplearning4j_tpu_torch.parallel.transport import (
    KIND_DATA, ElasticGradientMesh, GangEvictedError, GangReformed,
    PeerUnreachableError, TcpGradientMesh, _frame_bytes, _FrameReader)
from test_torch_parallel import RankPool

HERE = os.path.dirname(os.path.abspath(__file__))


# ---------------------------------------------------------------------------
# helpers: a gang on threads, allgathers run asynchronously
# ---------------------------------------------------------------------------

def _spawn_gang(world, port, classes=None, **kw):
    kw.setdefault("timeout", 20.0)
    classes = classes or [ElasticGradientMesh] * world
    meshes = [None] * world
    errors = []

    def make(r):
        try:
            meshes[r] = classes[r](r, world, port, **kw)
        except Exception as e:                      # pragma: no cover
            errors.append((r, e))

    threads = [threading.Thread(target=make, args=(r,), daemon=True) for r in range(world)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not errors, errors
    assert all(m is not None for m in meshes)
    return meshes


def _allgather_async(mesh, payload):
    box = {}

    def run():
        try:
            box["result"] = mesh.allgather(payload)
        except Exception as e:
            box["error"] = e

    t = threading.Thread(target=run, daemon=True)
    t.start()
    return t, box


def _round(meshes, payloads):
    """One full allgather round; every member must see every payload."""
    started = [_allgather_async(m, p) for m, p in zip(meshes, payloads)]
    for t, box in started:
        t.join(timeout=20)
        assert "error" not in box, box.get("error")
        assert box["result"] == list(payloads)


def _wait_until(cond, timeout=8.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(0.01)
    return cond()


def _close_all(*meshes):
    for m in meshes:
        if m is not None:
            m.close()


# ---------------------------------------------------------------------------
# the frame protocol, against the JAX package's
# ---------------------------------------------------------------------------

def test_frame_reader_partial_and_pipelined_feeds():
    frame = _frame_bytes(3, KIND_DATA, b"hello")
    reader = _FrameReader()
    for b in frame[:-1]:                       # byte at a time: nothing early
        assert reader.feed(bytes([b])) == []
    assert reader.feed(frame[-1:]) == [(3, KIND_DATA, b"hello")]
    two = _frame_bytes(7, KIND_DATA, b"a") + _frame_bytes(7, KIND_DATA, b"b")
    assert _FrameReader().feed(two) == [(7, KIND_DATA, b"a"), (7, KIND_DATA, b"b")]


def test_frames_and_kinds_are_the_jax_packages():
    from deeplearning4j_tpu.parallel import transport as jtr
    for name in ("KIND_DATA", "KIND_HB", "KIND_REFORM", "KIND_JOIN", "KIND_WELCOME",
                 "KIND_SNAPSHOT"):
        assert getattr(ttr, name) == getattr(jtr, name), name
    for gen, kind, payload in ((1, 0, b""), (2**31, 2, b'{"a": 1}'), (7, 4, bytes(range(256)))):
        assert _frame_bytes(gen, kind, payload) == jtr._frame_bytes(gen, kind, payload)
        assert jtr._FrameReader().feed(_frame_bytes(gen, kind, payload)) == \
            [(gen, kind, payload)]


# ---------------------------------------------------------------------------
# formation, rounds, close
# ---------------------------------------------------------------------------

def test_elastic_mesh_round_and_idempotent_close():
    meshes = _spawn_gang(3, free_port())
    try:
        _round(meshes, [b"p0", b"p1", b"p2"])
        _round(meshes, [b"q0", b"q1", b"q2"])
        for m in meshes:
            s = m.stats()
            assert s["generation"] == 1 and s["reformations"] == 0
    finally:
        _close_all(*meshes)
        _close_all(*meshes)         # close() is idempotent


def test_tcp_mesh_close_idempotent_and_formation_cleanup():
    meshes = _spawn_gang(2, free_port(), classes=[TcpGradientMesh] * 2, timeout=15.0)
    try:
        t0, b0 = _allgather_async(meshes[0], b"x")
        t1, b1 = _allgather_async(meshes[1], b"y")
        t0.join(10), t1.join(10)
        assert b0["result"] == [b"x", b"y"] == b1["result"]
    finally:
        for m in meshes:
            m.close()
            m.close()
    # a failed formation leaks no socket: the port binds again at once
    dead_port = free_port()
    with pytest.raises(PeerUnreachableError):
        ElasticGradientMesh(1, 2, dead_port, timeout=0.3)
    with socket.create_server(("127.0.0.1", dead_port)):
        pass


def test_rounds_of_frames_larger_than_the_socket_buffers():
    """A ResNet-50 gradient stream outgrows the kernel's socket buffer; the
    coordinator's sockets are non-blocking (its reactor reads them), so a
    plain ``sendall`` fails there and the peer would be taken for dead.
    Rounds of 4 MB payloads complete with no reformation."""
    meshes = _spawn_gang(3, free_port(), heartbeat_interval=0.05, failure_deadline=5.0)
    rng = np.random.RandomState(1)
    try:
        for _ in range(2):
            _round(meshes, [rng.bytes(4 << 20) for _ in range(3)])
        assert all(m.generation == 1 and m.reformations == 0 for m in meshes)
    finally:
        _close_all(*meshes)


# ---------------------------------------------------------------------------
# crash detection and generation fencing
# ---------------------------------------------------------------------------

def test_crash_reformation_fences_inflight_data():
    meshes = _spawn_gang(3, free_port(), heartbeat_interval=0.05, failure_deadline=1.0)
    m0, m1, m2 = meshes
    try:
        _round(meshes, [b"a0", b"a1", b"a2"])
        # rank 2 ships next round's DATA, then crashes: the frame is in
        # flight at the EOF, so the reformation fences it
        m2._peer_send(KIND_DATA, b"doomed")
        m2._sock.close()
        assert _wait_until(lambda: m0.generation == 2)
        assert m0.world == 2 and m0.reformations == 1
        assert m0.stale_frames == 1
        with pytest.raises(GangReformed) as ei:
            m0.allgather(b"x")
        e0 = ei.value
        assert e0.cause == "crash" and e0.generation == 2
        assert e0.world == 2 and e0.lost == [2]
        assert e0.detection_ms is not None
        t1, box1 = _allgather_async(m1, b"y")
        t1.join(10)
        e1 = box1["error"]
        assert isinstance(e1, GangReformed)
        assert e1.cause == "crash" and e1.rank == 1   # relative order kept
        _round([m0, m1], [b"b0", b"b1"])
        assert m0.stats()["generation"] == 2
    finally:
        _close_all(*meshes)


def test_stale_generation_data_is_fenced_never_gathered():
    meshes = _spawn_gang(2, free_port())
    m0, m1 = meshes
    try:
        _round(meshes, [b"a0", b"a1"])
        m1._peer_send(KIND_DATA, b"ghost", generation=0)
        assert _wait_until(lambda: m0.stale_frames == 1)
        assert m0.generation == 1          # fenced, not a reformation
        t0, b0 = _allgather_async(m0, b"c0")
        t1, b1 = _allgather_async(m1, b"c1")
        t0.join(10), t1.join(10)
        assert b0["result"] == [b"c0", b"c1"] == b1["result"]
        assert m0.stats()["stale_frames"] == 1
    finally:
        _close_all(*meshes)


# ---------------------------------------------------------------------------
# partition and straggler detection, eviction
# ---------------------------------------------------------------------------

def test_partition_detection_and_eviction():
    meshes = _spawn_gang(3, free_port(), heartbeat_interval=0.05, failure_deadline=0.5)
    m0, m1, m2 = meshes
    try:
        _round(meshes, [b"a0", b"a1", b"a2"])
        m2.pause_heartbeats(True)          # full silence on a healthy socket
        assert _wait_until(lambda: m0.generation == 2)
        with pytest.raises(GangReformed) as ei:
            m0.allgather(b"x")
        assert ei.value.cause == "partition" and ei.value.world == 2
        assert 500.0 * 0.9 <= ei.value.detection_ms <= 10_000.0
        t1, b1 = _allgather_async(m1, b"y")
        t1.join(10)
        assert isinstance(b1["error"], GangReformed)
        m2.pause_heartbeats(False)         # wakes to its eviction notice
        with pytest.raises(GangEvictedError):
            m2.allgather(b"z")
        _round([m0, m1], [b"b0", b"b1"])
    finally:
        _close_all(*meshes)


def test_eviction_notice_to_a_full_socket_does_not_hold_the_reform():
    """The notice to a lost peer is one non-blocking send: a peer whose
    receive buffer is full must not hold the coordinator's lock (and so
    the survivors' heartbeats) for the send timeout."""
    meshes = _spawn_gang(3, free_port(), heartbeat_interval=0.05, failure_deadline=30.0)
    m0, m1, m2 = meshes
    full, idle = socket.socketpair()
    try:
        _round(meshes, [b"a0", b"a1", b"a2"])
        full.setblocking(False)
        with pytest.raises(BlockingIOError):
            while True:
                full.send(b"\0" * 65536)
        with m0._lock:                     # rank 2 now reads nothing
            live, m0._conns[2] = m0._conns[2], full
        t0 = time.monotonic()
        info = m0._reform({2}, "partition")
        assert time.monotonic() - t0 < 2.0
        assert (info["world"], info["cause"], info["lost"]) == (2, "partition", [2])
        live.close()
        with pytest.raises(GangReformed):
            m0.allgather(b"x")
        t1, b1 = _allgather_async(m1, b"y")
        t1.join(10)
        assert isinstance(b1["error"], GangReformed)
        _round([m0, m1], [b"b0", b"b1"])
    finally:
        idle.close()
        _close_all(*meshes)


def test_straggler_reformed_out_mid_round():
    meshes = _spawn_gang(3, free_port(), heartbeat_interval=0.05, failure_deadline=0.6)
    m0, m1, m2 = meshes
    try:
        _round(meshes, [b"a0", b"a1", b"a2"])
        # rank 2 heartbeats but never ships round data
        t0, b0 = _allgather_async(m0, b"x")
        t1, b1 = _allgather_async(m1, b"y")
        t0.join(15), t1.join(15)
        e0 = b0["error"]
        assert isinstance(e0, GangReformed) and e0.cause == "straggler"
        assert e0.world == 2 and e0.lost == [2]
        assert isinstance(b1["error"], GangReformed)
        with pytest.raises(GangEvictedError):
            m2.allgather(b"late")
        _round([m0, m1], [b"b0", b"b1"])
    finally:
        _close_all(*meshes)


def test_joiner_parked_until_admitted_then_gang_grows():
    port = free_port()
    meshes = _spawn_gang(2, port)
    m0, m1 = meshes
    jbox = {}

    def join():
        try:
            jbox["mesh"] = ElasticGradientMesh(0, 0, port, join=True, join_timeout=20.0)
        except Exception as e:                      # pragma: no cover
            jbox["error"] = e

    jt = threading.Thread(target=join, daemon=True)
    mj = None
    try:
        _round(meshes, [b"a0", b"a1"])
        jt.start()
        assert m0.wait_for_joiner(10.0)
        assert m0.has_pending_joiner()
        info = m0.admit_joiners(resume_step=42)
        assert info["cause"] == "join" and info["world"] == 3
        assert info["generation"] == 2
        jt.join(timeout=10)
        mj = jbox.get("mesh")
        assert mj is not None, jbox.get("error")
        assert (mj.rank, mj.world, mj.generation) == (2, 3, 2)
        assert mj.join_info["resume_step"] == 42
        t1, b1 = _allgather_async(m1, b"x")
        t1.join(10)
        e1 = b1["error"]
        assert isinstance(e1, GangReformed)
        assert e1.cause == "join" and e1.resume_step == 42 and e1.rank == 1
        _round([m0, m1, mj], [b"b0", b"b1", b"b2"])
    finally:
        _close_all(m0, m1, mj)


# ---------------------------------------------------------------------------
# a gang of both packages
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("coordinator", ["port", "jax"])
def test_mixed_gang_allgathers_bitwise_and_reforms_alike(coordinator):
    from deeplearning4j_tpu.parallel import transport as jtr
    port_cls, jax_cls = ElasticGradientMesh, jtr.ElasticGradientMesh
    first, other = (port_cls, jax_cls) if coordinator == "port" else (jax_cls, port_cls)
    meshes = _spawn_gang(3, free_port(), classes=[first, other, other],
                         heartbeat_interval=0.05, failure_deadline=1.0,
                         resume_step_provider=lambda: 17)
    m0, m1, m2 = meshes
    rng = np.random.RandomState(0)
    try:
        for _ in range(3):
            payloads = [rng.randn(64).astype(np.float32).tobytes() for _ in range(3)]
            _round(meshes, payloads)
        m2._sock.close()                  # rank 2 crashes
        assert _wait_until(lambda: m0.generation == 2)
        with pytest.raises((GangReformed, jtr.GangReformed)) as ei:
            m0.allgather(b"x")
        t1, b1 = _allgather_async(m1, b"y")
        t1.join(10)
        infos = []
        for e in (ei.value, b1["error"]):
            assert type(e).__name__ == "GangReformed"
            infos.append((e.generation, e.world, e.rank_map, e.cause, e.resume_step, e.lost))
        assert infos[0] == infos[1] == (2, 2, {0: 0, 1: 1}, "crash", 17, [2])
        _round([m0, m1], [b"b0" * 9, b"b1" * 7])
    finally:
        _close_all(*meshes)


# ---------------------------------------------------------------------------
# codec residuals and the elastic sharing runtime
# ---------------------------------------------------------------------------

def test_hierarchical_rebuild_reset_vs_flush_and_elastic_pass_throughs():
    from deeplearning4j_tpu_torch.parallel import HierarchicalAllReduce, HierarchicalGradientSharing
    h = HierarchicalAllReduce(HierarchicalGradientSharing(threshold=1.0, rank=0, world=1))
    try:
        h.exchange({"w": np.full(8, 0.5, np.float32)})
        norm = h._exchange.residual_norm()
        assert norm > 0
        h.rebuild(flush_residuals=True)       # residual mass carried forward
        assert h._exchange.residual_norm() == pytest.approx(norm)
        h.rebuild(flush_residuals=False)      # a rewind: fresh codecs
        assert h._exchange.residual_norm() == 0.0
        assert not h.has_pending_joiner() and not h.wait_for_joiner(0.01)
        assert h.admit_joiners(3) is None and h.request_evict(1) is None
    finally:
        h.close()
    # elastic at world 1: the mesh forms with no peer and the exchange is
    # the codec round trip; the stats carry the generation
    e = HierarchicalAllReduce(HierarchicalGradientSharing(
        compressed=False, rank=0, world=1, port=free_port(), elastic=True))
    try:
        e.set_resume_step_provider(lambda: 5)
        out = e.exchange({"w": np.arange(4, dtype=np.float32)})
        np.testing.assert_array_equal(out["w"], np.arange(4, dtype=np.float32))
        assert e.mesh.resume_step_provider() == 5
        s = e.stats()
        assert (s["generation"], s["reformations"], s["stale_frames"]) == (1, 0, 0)
        assert not e.has_pending_joiner()
    finally:
        e.close()


def test_elastic_env_knob_resolution(monkeypatch):
    from deeplearning4j_tpu_torch.parallel import HierarchicalGradientSharing
    monkeypatch.setenv("DL4J_TPU_HEARTBEAT_S", "0.125")
    monkeypatch.setenv("DL4J_TPU_FAILURE_DEADLINE_S", "3.5")
    monkeypatch.setenv("DL4J_TPU_JOIN", "1")
    cfg = HierarchicalGradientSharing(elastic=True).resolve()
    assert cfg.heartbeat_interval_s == 0.125
    assert cfg.failure_deadline_s == 3.5
    assert cfg.join is True
    monkeypatch.delenv("DL4J_TPU_JOIN")
    assert HierarchicalGradientSharing(elastic=True).resolve().join is False


# ---------------------------------------------------------------------------
# chaos hook, trainer policy, free_port
# ---------------------------------------------------------------------------

def _fake_trainer(rank, iteration):
    mesh = types.SimpleNamespace(rank=rank)
    sharing = types.SimpleNamespace(mesh=mesh)
    model = types.SimpleNamespace(iteration=iteration, _grad_sharing=sharing)
    return types.SimpleNamespace(model=model)


def test_peer_killer_targets_live_rank_and_marker(tmp_path):
    from deeplearning4j_tpu_torch.utils.chaos import PeerKiller
    with pytest.raises(ValueError, match="mode"):
        PeerKiller(0, 0, mode="nuke")
    marker = str(tmp_path / "fired")
    pk = PeerKiller(rank=1, at_step=6, mode="slow", delay_s=0.0, marker=marker)
    pk(_fake_trainer(rank=1, iteration=5))     # before at_step
    assert not pk.fired
    pk(_fake_trainer(rank=0, iteration=6))     # another live rank
    assert not pk.fired
    pk(_fake_trainer(rank=1, iteration=6))
    assert pk.fired and os.path.exists(marker)
    relaunched = PeerKiller(rank=1, at_step=6, mode="slow", delay_s=0.0, marker=marker)
    assert not relaunched.armed()
    relaunched(_fake_trainer(rank=1, iteration=9))
    assert not relaunched.fired


def test_peer_killer_partition_pauses_and_resumes_heartbeats():
    from deeplearning4j_tpu_torch.utils.chaos import PeerKiller
    calls = []
    mesh = types.SimpleNamespace(rank=1, pause_heartbeats=lambda p: calls.append(p))
    model = types.SimpleNamespace(iteration=3, _grad_sharing=types.SimpleNamespace(mesh=mesh))
    pk = PeerKiller(rank=1, at_step=3, mode="partition", duration_s=0.0)
    pk(types.SimpleNamespace(model=model))
    assert calls == [True, False]


def test_elastic_trainer_policy_validation():
    from deeplearning4j_tpu_torch.train import Sgd
    from deeplearning4j_tpu_torch.train.resilience import ElasticTrainer
    conf = (tnn.NeuralNetConfiguration.builder().seed(7).updater(Sgd(0.1))
            .list([tnn.DenseLayer(n_out=4, activation="tanh"),
                   tnn.OutputLayer(n_out=2, loss="mcxent", activation="softmax")])
            .set_input_type(tnn.InputType.feed_forward(4)).build())
    net = tnn.MultiLayerNetwork(conf, device="cpu").init()
    with pytest.raises(ValueError, match="policy"):
        ElasticTrainer(net, policy="wait")
    t = ElasticTrainer(net, policy="block", rejoin_wait_s=1.5)
    assert t.policy == "block" and t.rejoin_wait_s == 1.5


def test_free_port_survives_probe_vs_bind_race(monkeypatch):
    state = {"raced": False}

    class RacySocket(socket.socket):
        def bind(self, addr):
            if addr[1] != 0 and not state["raced"]:
                state["raced"] = True
                raise OSError(98, "Address already in use")
            return super().bind(addr)

    monkeypatch.setattr(multihost.socket, "socket", RacySocket)
    port = multihost.free_port()
    assert state["raced"] and 0 < port < 65536
    monkeypatch.undo()
    with socket.socket() as s:
        s.bind(("127.0.0.1", port))

    class AlwaysLoses(socket.socket):
        def bind(self, addr):
            if addr[1] != 0:
                raise OSError(98, "Address already in use")
            return super().bind(addr)

    monkeypatch.setattr(multihost.socket, "socket", AlwaysLoses)
    with pytest.raises(OSError, match="no bindable port"):
        multihost.free_port(max_tries=3)


# ---------------------------------------------------------------------------
# the elastic trainer in threads: a requested shrink, a joiner admitted at
# the epoch boundary
# ---------------------------------------------------------------------------

class _Shards:
    """The gang's global stream, each member its live rank's rows."""

    def __init__(self, net, steps):
        self.net, self.steps = net, steps

    def reset(self):
        pass

    def __iter__(self):
        from deeplearning4j_tpu_torch.data import DataSet
        for i in range(self.steps):
            rng = np.random.RandomState(1000 + int(self.net.epoch) * self.steps + i)
            xg = rng.randn(12, 16).astype(np.float32)
            yg = np.eye(3, dtype=np.float32)[(xg[:, 0] > 0).astype(int)
                                             + (xg[:, 1] > 0).astype(int)]
            sh = self.net.gradient_sharing
            yield DataSet(xg[sh.rank::sh.world], yg[sh.rank::sh.world])


def _gang_mlp():
    from deeplearning4j_tpu_torch.train import Sgd
    conf = (tnn.NeuralNetConfiguration.builder().seed(7).updater(Sgd(0.1))
            .list([tnn.DenseLayer(n_out=32, activation="tanh"),
                   tnn.OutputLayer(n_out=3, loss="mcxent", activation="softmax")])
            .set_input_type(tnn.InputType.feed_forward(16)).build())
    return tnn.MultiLayerNetwork(conf, device="cpu").init()


def _member(out, key, rank, world, port, ck, steps, epochs, join=False, hooks=(),
            control_dir=None, leave=None):
    """One gang member on a thread: dense elastic sharing under
    ElasticTrainer; `out[key]` gets (how it ended, net, trainer, worlds
    seen at its step ends).  With a `leave` barrier the member closes its
    sockets only once every member has ended (a peer that leaves first
    reads as a crash to one still in its last step)."""
    from deeplearning4j_tpu_torch.parallel import HierarchicalGradientSharing
    from deeplearning4j_tpu_torch.train.resilience import CheckpointManager, ElasticTrainer
    net = _gang_mlp().set_gradient_sharing(HierarchicalGradientSharing(
        compressed=False, rank=rank, world=world, port=port, elastic=True,
        heartbeat_interval_s=0.05, failure_deadline_s=5.0, join=join, timeout=20.0))
    coordinator = rank == 0 and not join
    worlds = []
    tr = ElasticTrainer(net, CheckpointManager(ck, keep_last=100,
                                               save_every_steps=1 if coordinator else None),
                        save_initial=coordinator, control_dir=control_dir,
                        hooks=[lambda t: worlds.append(t.model.gradient_sharing.world),
                               *hooks])
    try:
        tr.fit(_Shards(net, steps), epochs=epochs)
        out[key] = ("done", net, tr, worlds)
    except GangEvictedError:
        out[key] = ("evicted", net, tr, worlds)
    except Exception as e:                          # pragma: no cover
        out[key] = (repr(e), net, tr, worlds)
    finally:
        if leave is not None:
            try:
                leave.wait(60)
            except threading.BrokenBarrierError:    # pragma: no cover
                pass
        net.set_gradient_sharing(None)


def _run_threads(*targets, timeout=60):
    threads = [threading.Thread(target=t, daemon=True) for t in targets]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout)
    assert not any(t.is_alive() for t in threads)


def test_requested_shrink_evicts_at_a_coordinated_step(tmp_path):
    """``shrink-request.json`` in the control directory: the coordinator
    commits a checkpoint, evicts rank 1 at that step and acknowledges; rank
    1 leaves with ``GangEvictedError``; rank 0 rewinds and trains on alone,
    ending where a plain run resumed from that checkpoint ends."""
    from deeplearning4j_tpu_torch.train.resilience import ElasticTrainer, FaultTolerantTrainer
    from deeplearning4j_tpu_torch.train.resilience import CheckpointManager
    port, ck, ctl = free_port(), str(tmp_path / "ck"), tmp_path / "ctl"
    ctl.mkdir()
    with open(ctl / ElasticTrainer.SHRINK_REQUEST, "w") as f:
        json.dump({"id": "r-1", "rank": 1}, f)
    out = {}
    _run_threads(lambda: _member(out, 0, 0, 2, port, ck, 4, 1, control_dir=str(ctl)),
                 lambda: _member(out, 1, 1, 2, port, ck, 4, 1))
    assert out[1][0] == "evicted" and out[0][0] == "done"
    with open(ctl / ElasticTrainer.SHRINK_ACK) as f:
        ack = json.load(f)
    assert ack == {"request_id": "r-1", "resume_step": 1, "generation": 2, "world": 1,
                   "rank": 1}
    assert not (ctl / ElasticTrainer.SHRINK_REQUEST).exists()
    _, net, tr, worlds = out[0]
    assert [(r["cause"], r["world"], r["resume_step"]) for r in tr.reformations] == \
        [("shrink", 1, 1)]
    assert net.iteration == 4 and worlds[-1] == 1
    # a plain world-1 run from the coordinated checkpoint: the same bits
    ref_ck = str(tmp_path / "ref")
    shutil.copytree(ck, ref_ck)
    _prune_checkpoints_above(ref_ck, 1)
    ref = _gang_mlp()
    from deeplearning4j_tpu_torch.parallel import HierarchicalGradientSharing
    ref.set_gradient_sharing(HierarchicalGradientSharing(compressed=False, rank=0, world=1))
    FaultTolerantTrainer(ref, CheckpointManager(ref_ck)).fit(_Shards(ref, 4), epochs=1)
    np.testing.assert_array_equal(net.params(), ref.params())


def test_joiner_admitted_at_the_epoch_boundary_grows_the_gang(tmp_path):
    """A replacement started mid-epoch (``join=True``) parks; the
    coordinator admits it at the epoch boundary after a blocking
    checkpoint; every member (the joiner too) rewinds to that step and the
    gang of 3 ends with equal parameters."""
    port, ck = free_port(), str(tmp_path / "ck")
    out, leave = {}, threading.Barrier(3)
    joiner = threading.Thread(
        target=lambda: _member(out, "j", 2, 3, port, ck, 3, 2, join=True, leave=leave),
        daemon=True)

    def start_joiner(t):
        if t.model.iteration == 1 and not joiner.is_alive() and "j" not in out:
            joiner.start()
        if t.model.iteration == 2:              # the joiner is parked before the boundary
            assert _wait_until(t.model.gradient_sharing.has_pending_joiner, 10.0)
    _run_threads(lambda: _member(out, 0, 0, 2, port, ck, 3, 2, hooks=[start_joiner],
                                 leave=leave),
                 lambda: _member(out, 1, 1, 2, port, ck, 3, 2, leave=leave))
    joiner.join(60)
    assert not joiner.is_alive()
    assert {k: v[0] for k, v in out.items()} == {0: "done", 1: "done", "j": "done"}
    causes = [(r["cause"], r["world"], r["resume_step"]) for r in out[0][2].reformations]
    assert causes == [("join", 3, 3)]
    assert [(r["cause"], r["resume_step"]) for r in out[1][2].reformations] == [("join", 3)]
    assert [(r["cause"], r["rank"]) for r in out["j"][2].reformations] == [("join", 2)]
    nets = [out[k][1] for k in (0, 1, "j")]
    assert all(n.iteration == 6 and n.epoch == 2 for n in nets)
    assert out[0][3][-1] == 3 and out["j"][3][-1] == 3
    for n in nets[1:]:
        np.testing.assert_array_equal(n.params(), nets[0].params())


# ---------------------------------------------------------------------------
# ZeRO-1 resharding, a mesh over part of the ranks, workers(n) (gloo pool)
# ---------------------------------------------------------------------------

def _adam_mlp():
    from deeplearning4j_tpu_torch.train import Adam
    conf = (tnn.NeuralNetConfiguration.builder().seed(7).updater(Adam(1e-2)).dtype("float64")
            .list([tnn.DenseLayer(n_out=16, activation="relu"),
                   tnn.OutputLayer(n_out=3, loss="mcxent", activation="softmax")])
            .set_input_type(tnn.InputType.feed_forward(8)).build())
    return tnn.MultiLayerNetwork(conf, device="cpu").init()


def _xy(n=32, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, 8)
    return x, np.eye(3)[(x[:, 0] > 0).astype(int) + (x[:, 1] > 0).astype(int)]


def _opt_leaves(net):
    from deeplearning4j_tpu_torch import convert
    from deeplearning4j_tpu_torch.train.updaters import tree_leaves
    return [np.asarray(a) for a in tree_leaves(convert.opt_state_to_jax(net))]


def _task_reshard_and_partial_meshes():
    from deeplearning4j_tpu_torch.parallel import (ParallelWrapper, make_mesh, reshard_zero1,
                                                   reshard_to_devices)
    x, y = _xy()
    out = {}
    # ZeRO-1 over both ranks, against the same step without it
    net, ref = _adam_mlp(), _adam_mlp()
    mesh2 = make_mesh({"data": 2}, device="cpu")
    ParallelWrapper(net, mesh2, optimizer_sharding=True).fit(x, y)
    ParallelWrapper(ref, mesh2).fit(x, y)
    out["t2_world"] = net._step_transform.mesh.shape["data"]
    # the gang shrinks to rank 0: the moments gathered, cut again there
    mesh1 = make_mesh({"data": 1}, devices=[0], device="cpu")
    t1 = reshard_zero1(net, mesh1)
    out["member"] = mesh1.member
    out["t1_world"] = None if t1 is None else t1.mesh.shape["data"]
    out["opt_err"] = max(float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))
                         for a, b in zip(_opt_leaves(net), _opt_leaves(ref)))
    if mesh1.member:
        # training goes on at world 1, the single-device step
        ParallelWrapper(net, mesh1, optimizer_sharding=True).fit(x, y)
        plain = _adam_mlp()
        plain.fit(x, y)
        plain.fit(x, y)
        out["world1_err"] = float(np.abs(net.params() - plain.params()).max()
                                  / np.abs(plain.params()).max())
    # and grows back to both ranks
    t_back = reshard_zero1(net, make_mesh({"data": 2}, device="cpu"))
    out["grown_world"] = t_back.mesh.shape["data"]
    out["to_devices_without_zero1"] = reshard_to_devices(_adam_mlp(), [0]) is None
    # workers(1) below the world of 2: rank 0 trains alone, rank 1 idles
    w = _adam_mlp()
    pw = ParallelWrapper.builder(w).workers(1).build()
    before = w.params().copy()
    pw.fit(x, y)
    plain = _adam_mlp()
    plain.fit(x, y)
    out["workers1_member"] = pw.mesh.member
    out["workers1_trained"] = not np.array_equal(before, w.params())
    out["workers1_bitwise_plain"] = bool(np.array_equal(w.params(), plain.params()))
    out["workers1_steps_none"] = pw.fit_steps(np.stack([x, x]), np.stack([y, y])) is None
    # a mesh over one rank that is not rank 0
    m = make_mesh({"data": 1}, devices=[1], device="cpu")
    out["mesh_on_1"] = (m.member, m.ranks, m.distributed)
    return out


def _task_multihost_inference():
    import torch.distributed as dist
    from deeplearning4j_tpu_torch.parallel import MultiHostParallelInference
    rank = dist.get_rank()
    net = _adam_mlp()
    if rank == 1:                         # replicas start apart: rank 0's wins
        with torch.no_grad():
            for p in net.parameters():
                p.add_(1.0)
    x = np.random.default_rng(3).standard_normal((12, 8))
    out = MultiHostParallelInference(net).output(x[rank * 6:(rank + 1) * 6])
    return out


def test_multihost_parallel_inference_matches_one_process(pool):
    o0, o1 = pool.run(_task_multihost_inference)
    x = np.random.default_rng(3).standard_normal((12, 8))
    want = _adam_mlp().output(x).numpy()
    assert o0.shape == o1.shape == (6, 3)
    np.testing.assert_allclose(np.concatenate([o0, o1]), want, rtol=1e-12, atol=1e-14)


@pytest.fixture(scope="module")
def pool():
    p = RankPool()
    yield p
    p.close()


def test_reshard_zero1_partial_mesh_and_workers_below_world(pool):
    r0, r1 = pool.run(_task_reshard_and_partial_meshes)
    assert r0["t2_world"] == 2 == r1["t2_world"]
    assert (r0["member"], r0["t1_world"]) == (True, 1)
    assert (r1["member"], r1["t1_world"]) == (False, None)
    # after the reshard the moments are the unsharded run's (f64)
    assert r0["opt_err"] <= 1e-10 and r1["opt_err"] <= 1e-10
    assert r0["world1_err"] <= 1e-10
    assert r0["grown_world"] == 2 == r1["grown_world"]
    assert r0["to_devices_without_zero1"] and r1["to_devices_without_zero1"]
    assert (r0["workers1_member"], r1["workers1_member"]) == (True, False)
    assert r0["workers1_trained"] and r0["workers1_bitwise_plain"]
    assert not r1["workers1_trained"] and r1["workers1_steps_none"]
    assert r0["mesh_on_1"] == (False, (1,), False)
    assert r1["mesh_on_1"] == (True, (1,), False)


# ---------------------------------------------------------------------------
# the kill-shrink gang (processes)
# ---------------------------------------------------------------------------

def _prune_checkpoints_above(directory, step):
    from deeplearning4j_tpu_torch.train.resilience import CheckpointManager
    for name in os.listdir(directory):
        path = os.path.join(directory, name)
        if os.path.isdir(path) and name.startswith(CheckpointManager.PREFIX) \
                and int(name[len(CheckpointManager.PREFIX):]) > step:
            shutil.rmtree(path)


def _gang(tmp_path, tag, procs, kill_rank, kill_step, ckpt, steps=12):
    out = tmp_path / tag
    out.mkdir()
    res = multihost.ElasticLocalRunner(procs, platform="cpu", backoff_base_s=0.2).run_elastic(
        os.path.join(HERE, "mh_worker_torch_elastic_gang.py"),
        [str(out), str(steps), "1", str(kill_rank), str(kill_step)],
        timeout=120.0, checkpoint_dir=ckpt, heartbeat_s=0.1, failure_deadline_s=2.0,
        relaunch=False)
    assert res["r0"][0] == 0, res["r0"][1][-2000:]
    with open(out / "elastic_0.json") as f:
        info = json.load(f)
    return res, np.load(out / "final_0.npz"), info


def test_elastic_gang_kill_shrink_and_bitwise_resume_parity(tmp_path):
    """A gang of 3 loses rank 2 at step 4, detects it within the deadline,
    re-forms at world 2 and resumes from the coordinated checkpoint; the
    survivors end bitwise where a clean world-2 gang from that checkpoint
    ends."""
    ck_a = str(tmp_path / "ck_a")
    res, final_a, info = _gang(tmp_path, "a", 3, 2, 4, ck_a)
    assert res["r2"][0] == 9                       # os._exit(9)
    assert res["r1"][0] == 0
    (rf,) = info["reformations"]
    assert rf["cause"] == "crash" and rf["world"] == 2 and rf["generation"] == 2
    assert rf["detection_ms"] <= 2000.0 + 2000.0
    assert info["stats"]["generation"] == 2 and info["stats"]["world"] == 2
    assert int(final_a["iteration"]) == 12
    ck_b = str(tmp_path / "ck_b")
    shutil.copytree(ck_a, ck_b)
    _prune_checkpoints_above(ck_b, rf["resume_step"])
    _, final_b, info_b = _gang(tmp_path, "b", 2, -1, 0, ck_b)
    assert info_b["reformations"] == []
    np.testing.assert_array_equal(final_a["params"], final_b["params"])
    assert float(final_a["score"]) == float(final_b["score"])
