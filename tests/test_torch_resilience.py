"""Fault-tolerant training in the PyTorch port (``train/resilience.py``,
``utils/chaos.py``, ``parallel/multihost.py``'s ``ElasticLocalRunner.run``)
against the JAX package.

- The checkpoint manager, trainer, divergence guard and chaos harness
  (the port of ``tests/test_resilience.py``'s in-process cases, minus the
  serving and UI ones).
- A checkpoint crosses between the packages both ways: every shared leaf
  and metadata field equal, and the ``rng`` leaf by the stated rule (the
  port writes the JAX package's initial key for the seed and never reads
  the leaf).
- A run killed at step 7 and resumed ends within 1e-9 relative of the JAX
  package's uninterrupted run (f64, from the JAX initial parameters).
- A restore writes into the live tensors: every address is kept, and a
  ``fit_steps`` block after it equals a fresh network restored from the
  same checkpoint, bit for bit.
- ``GangReformed`` between the two halves of a split step leaves the step
  uncounted (iteration, device counter, listeners), and the elastic
  trainer's rewind ends bitwise on the uninterrupted run.
- The failure taxonomy and backoff; a corrupt restore is not retried; a
  2-rank gloo job whose rank 1 crashes is relaunched by ``run`` and
  resumes from its sharded checkpoint (``tests/mh_worker_torch_elastic.py``).
"""
import torch_test_threads  # noqa: F401  (first: one torch thread a worker)
import importlib
import os
import signal
import time

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch import convert
from deeplearning4j_tpu_torch import nn as tnn
from deeplearning4j_tpu_torch.data import ArrayDataSetIterator, DevicePrefetchIterator, ProducerError
from deeplearning4j_tpu_torch.data.normalizers import NormalizerStandardize
from deeplearning4j_tpu_torch.monitor.registry import registry
from deeplearning4j_tpu_torch.parallel.checkpoint import verify_checkpoint
from deeplearning4j_tpu_torch.parallel.multihost import ElasticLocalRunner
from deeplearning4j_tpu_torch.train.resilience import (
    CheckpointManager, DivergenceError, DivergenceGuard, ElasticTrainer, FaultTolerantTrainer,
    NoIntactCheckpointError, Preempted, jax_seed_key, normalizer_from_meta)
from deeplearning4j_tpu_torch.utils import chaos

HERE = os.path.dirname(os.path.abspath(__file__))

rng0 = np.random.default_rng(0)
X = rng0.standard_normal((48, 10))
Y = np.eye(3)[rng0.integers(0, 3, 48)]


def _conf(pkg, bn=False, dtype="float32"):
    layers = [pkg.DenseLayer(n_out=16, activation="tanh")]
    if bn:
        layers.append(pkg.BatchNormalizationLayer())
    layers.append(pkg.OutputLayer(n_out=3, loss="mcxent", activation="softmax"))
    updaters = importlib.import_module(pkg.__name__.replace(".nn", ".train"))
    return (pkg.NeuralNetConfiguration.builder().seed(7).updater(updaters.Adam(0.01))
            .dtype(dtype).list(layers)
            .set_input_type(pkg.InputType.feed_forward(10)).build())


def build_net(bn=False, dtype="float32"):
    """The JAX resilience tests' network (f32); f64 where a test holds the
    port to the JAX package."""
    return tnn.MultiLayerNetwork(_conf(tnn, bn, dtype), device="cpu").init()


def data_iter(features=None):
    return ArrayDataSetIterator(X if features is None else features, Y, 8)


def jax_net(bn=False):
    from deeplearning4j_tpu import nn as jnn
    return jnn.MultiLayerNetwork(_conf(jnn, bn, "float64")).init()


def port_from_jax(jnet, bn=False):
    import jax
    net = build_net(bn, "float64")
    convert.params_from_jax(net, jax.tree_util.tree_map(np.asarray, jnet.params_))
    return net


def _equal_leaves(a, b):
    from deeplearning4j_tpu_torch.train.updaters import tree_leaves
    la = [np.asarray(x) for x in tree_leaves(a)]
    lb = [np.asarray(x) for x in tree_leaves(b)]
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        np.testing.assert_array_equal(x, y)


# ---------------------------------------------------------------------------
# CheckpointManager
# ---------------------------------------------------------------------------

def test_manager_save_steps_latest_metadata_and_retention(tmp_path):
    net = build_net()
    mgr = CheckpointManager(str(tmp_path / "ck"), keep_last=10)
    assert mgr.latest_step() is None and mgr.steps() == []
    mgr.save(net, step=3, metadata={"note": "a"})
    mgr.save(net, step=11)
    assert mgr.steps() == [3, 11] and mgr.latest_step() == 11
    meta = mgr.restore(build_net())
    assert meta["step"] == 11
    import json
    with open(os.path.join(mgr.checkpoint_path(11), "index-0.json")) as f:
        assert all("crc32" in e for e in json.load(f))
    gc = CheckpointManager(str(tmp_path / "gc"), keep_last=2)
    for s in (1, 2, 3, 4, 5):
        gc.save(net, step=s)
    assert gc.steps() == [4, 5] and not os.path.exists(gc.checkpoint_path(1))
    head, stale = gc.checkpoint_path(99), gc.checkpoint_path(0)
    os.makedirs(head)                       # a save in flight: kept
    os.makedirs(stale)                      # a torn leftover: removed
    gc.gc()
    assert os.path.isdir(head) and not os.path.exists(stale)


def test_maybe_save_step_and_time_triggers(tmp_path):
    net = build_net()
    mgr = CheckpointManager(str(tmp_path / "a"), save_every_steps=3)
    net.iteration = 2
    assert not mgr.maybe_save(net)
    net.iteration = 3
    assert mgr.maybe_save(net)
    assert not mgr.maybe_save(net)          # the delta resets after a save
    timed = CheckpointManager(str(tmp_path / "b"), save_every_seconds=0.01)
    time.sleep(0.05)
    assert timed.maybe_save(net)


def test_async_save_is_a_copy_the_next_step_cannot_change(tmp_path):
    net = build_net()
    FaultTolerantTrainer(net, None, save_initial=False).fit(data_iter(), epochs=1)
    want = net.params().copy()
    a = CheckpointManager(str(tmp_path / "a"), async_save=True)
    a.save(net, step=6)
    net.fit(X[:8], Y[:8])                   # in place, while the writer runs
    a.wait()
    sync = CheckpointManager(str(tmp_path / "s"))
    n1 = build_net()
    a.restore(n1)
    np.testing.assert_array_equal(n1.params(), want)
    sync.save(net, step=7)
    n2 = build_net()
    sync.restore(n2)
    np.testing.assert_array_equal(n2.params(), net.params())


def test_blocking_save_waits_for_the_write_in_flight(tmp_path, monkeypatch):
    """A blocking save (the preemption path) refills the staging buffer
    that an async write still reads: it must join that write first, or the
    older checkpoint holds the newer step's bytes."""
    import threading
    from deeplearning4j_tpu_torch.train import resilience
    real = resilience.save_sharded
    release = threading.Event()

    def slow_first(target, tree, metadata=None):
        if target.endswith(f"{3:010d}"):
            release.wait(10)                # the write still in flight
        real(target, tree, metadata=metadata)

    monkeypatch.setattr(resilience, "save_sharded", slow_first)
    net = build_net()
    mgr = CheckpointManager(str(tmp_path / "ck"), keep_last=5, async_save=True)
    mgr.save(net, step=3)
    want = net.params().copy()
    net.fit(X[:8], Y[:8])
    threading.Timer(0.3, release.set).start()
    mgr.save(net, step=4, block=True)
    assert release.is_set() and mgr.steps() == [3, 4]
    for step, params in ((3, want), (4, net.params())):
        verify_checkpoint(mgr.checkpoint_path(step))
        back = build_net()
        mgr.restore(back, step=step)
        np.testing.assert_array_equal(back.params(), params)


def test_restore_falls_back_to_newest_intact_and_raises_when_none(tmp_path):
    net = build_net()
    mgr = CheckpointManager(str(tmp_path / "ck"), keep_last=10, save_every_steps=2)
    FaultTolerantTrainer(net, mgr).fit(data_iter(), epochs=1)
    steps = mgr.steps()
    assert len(steps) >= 4
    before = registry().counter("resilience_restore_fallbacks_total").value
    chaos.corrupt_checkpoint(mgr.checkpoint_path(steps[-1]), "payload")
    chaos.corrupt_checkpoint(mgr.checkpoint_path(steps[-2]), "manifest")
    assert mgr.restore(build_net())["step"] == steps[-3]
    assert registry().counter("resilience_restore_fallbacks_total").value >= before + 2
    chaos.corrupt_checkpoint(mgr.checkpoint_path(steps[-3]), "uncommit")
    assert mgr.steps() == steps[:-3] + steps[-2:]
    assert mgr.restore(build_net())["step"] == steps[-4]
    for s in mgr.steps():
        if s not in steps[-2:]:
            chaos.corrupt_checkpoint(mgr.checkpoint_path(s), "payload")
    with pytest.raises(NoIntactCheckpointError):
        mgr.restore(build_net())


def test_verify_checkpoint_checksum_error(tmp_path):
    d = CheckpointManager(str(tmp_path / "ck")).save(build_net(), step=1)
    verify_checkpoint(d)
    chaos.corrupt_checkpoint(d, "payload")
    with pytest.raises(ValueError, match="checksum mismatch|unreadable checkpoint"):
        verify_checkpoint(d)


def test_restore_recovers_full_state(tmp_path):
    nz = NormalizerStandardize()
    nz.fit(data_iter())
    net = build_net(bn=True)
    mgr = CheckpointManager(str(tmp_path / "ck"))
    FaultTolerantTrainer(net, mgr, normalizer=nz).fit(data_iter(), epochs=2)
    net._rng.manual_seed(1234)
    mgr.save(net, normalizer=nz)
    net2 = build_net(bn=True)
    meta = mgr.restore(net2)
    assert net2.iteration == net.iteration == 12 and net2.epoch == net.epoch == 2
    assert torch.equal(net2._rng.get_state(), net._rng.get_state())
    _equal_leaves(convert.opt_state_to_jax(net2), convert.opt_state_to_jax(net))
    _equal_leaves(convert.state_to_jax(net2), convert.state_to_jax(net))
    nz2 = normalizer_from_meta(meta["normalizer"])
    np.testing.assert_array_equal(nz2.mean, nz.mean)
    np.testing.assert_array_equal(nz2.std, nz.std)


# ---------------------------------------------------------------------------
# restore in place
# ---------------------------------------------------------------------------

def _addresses(net):
    from deeplearning4j_tpu_torch.train.updaters import tree_leaves
    return [t.data_ptr() for tree in (net.params_, net.state_, net.opt_state_)
            for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def test_restore_in_place_then_fit_steps_replays_bitwise(tmp_path):
    xs = np.stack([X[i * 8:(i + 1) * 8] for i in range(3)])
    ys = np.stack([Y[i * 8:(i + 1) * 8] for i in range(3)])
    net = build_net(bn=True)
    net.fit_steps(xs, ys)
    mgr = CheckpointManager(str(tmp_path / "ck"))
    mgr.save(net)                           # at step 3
    net.fit_steps(xs, ys)                   # the live network moves on
    ptrs, it_ptr = _addresses(net), net._iter_dev.data_ptr()
    assert mgr.restore(net)["step"] == 3
    assert net.iteration == 3
    assert _addresses(net) == ptrs and net._iter_dev.data_ptr() == it_ptr
    got = net.fit_steps(xs, ys)
    assert int(net._iter_dev) == net.iteration == 6
    fresh = build_net(bn=True)
    mgr.restore(fresh)
    want = fresh.fit_steps(xs, ys)
    assert torch.equal(got, want)
    np.testing.assert_array_equal(net.params(), fresh.params())
    _equal_leaves(convert.state_to_jax(net), convert.state_to_jax(fresh))
    _equal_leaves(convert.opt_state_to_jax(net), convert.opt_state_to_jax(fresh))


# ---------------------------------------------------------------------------
# checkpoints across the packages
# ---------------------------------------------------------------------------

def test_jax_checkpoint_restores_into_the_port_and_back(tmp_path):
    import jax
    from deeplearning4j_tpu.data import ArrayDataSetIterator as JIt
    from deeplearning4j_tpu.data.normalizers import NormalizerStandardize as JNz
    from deeplearning4j_tpu.train.resilience import CheckpointManager as JMgr
    from deeplearning4j_tpu.train.resilience import FaultTolerantTrainer as JFT
    # JAX -> port
    jnz = JNz()
    jnz.fit(JIt(X, Y, 8))
    jnet = jax_net(bn=True)
    JFT(jnet, JMgr(str(tmp_path / "j")), normalizer=jnz).fit(JIt(X, Y, 8), epochs=1)
    jmgr = JMgr(str(tmp_path / "j"))
    jmgr.save(jnet, normalizer=jnz, metadata={"batch_in_epoch": 3})
    net = build_net(bn=True, dtype="float64")
    gen_before = net._rng.get_state().clone()
    meta = CheckpointManager(str(tmp_path / "j")).restore(net)
    assert (net.iteration, net.epoch) == (jnet.iteration, jnet.epoch) == (6, 1)
    assert meta["batch_in_epoch"] == 3
    np.testing.assert_array_equal(net.params(), np.asarray(jnet.params()))
    _equal_leaves(convert.state_to_jax(net), jax.tree_util.tree_map(np.asarray, jnet.state_))
    _equal_leaves(convert.opt_state_to_jax(net),
                  jax.tree_util.tree_map(np.asarray, jnet.opt_state_))
    nz = normalizer_from_meta(meta["normalizer"])
    np.testing.assert_array_equal(nz.mean, np.asarray(jnz.mean))
    assert torch.equal(net._rng.get_state(), gen_before)     # the rng rule
    # port -> JAX: train on, save, restore into a fresh JAX network
    FaultTolerantTrainer(net, None, save_initial=False).fit(data_iter(), epochs=2)
    mgr = CheckpointManager(str(tmp_path / "p"))
    mgr.save(net, metadata={"batch_in_epoch": 5}, normalizer=nz)
    jnet2 = jax_net(bn=True)
    jmeta = JMgr(str(tmp_path / "p")).restore(jnet2)
    assert (jnet2.iteration, jnet2.epoch) == (net.iteration, net.epoch) == (12, 2)
    assert jmeta["batch_in_epoch"] == 5 and jmeta["step"] == 12
    np.testing.assert_array_equal(np.asarray(jnet2.params()), net.params())
    _equal_leaves(jax.tree_util.tree_map(np.asarray, jnet2.state_), convert.state_to_jax(net))
    _equal_leaves(jax.tree_util.tree_map(np.asarray, jnet2.opt_state_),
                  convert.opt_state_to_jax(net))
    np.testing.assert_array_equal(np.asarray(jnet2._rng), np.asarray(jax.random.PRNGKey(7)))
    np.testing.assert_array_equal(jax_seed_key(7), np.asarray(jax.random.PRNGKey(7)))
    from deeplearning4j_tpu.train.resilience import normalizer_from_meta as jnfm
    np.testing.assert_array_equal(np.asarray(jnfm(jmeta["normalizer"]).std), nz.std)


def test_killed_and_resumed_run_matches_the_jax_uninterrupted_run(tmp_path):
    from deeplearning4j_tpu.data import ArrayDataSetIterator as JIt
    from deeplearning4j_tpu.train.resilience import FaultTolerantTrainer as JFT
    import jax
    jref = jax_net()
    init = jax.tree_util.tree_map(np.asarray, jref.params_)
    net = port_from_jax(jref)
    JFT(jref, None, save_initial=False).fit(JIt(X, Y, 8), epochs=3)
    ck = str(tmp_path / "ck")
    ks = chaos.KillSwitch(at_step=7, mode="exception")
    with pytest.raises(chaos.ChaosError):
        FaultTolerantTrainer(net, CheckpointManager(ck, save_every_steps=4),
                             hooks=(ks,)).fit(data_iter(), epochs=3)
    net2 = build_net(dtype="float64")
    convert.params_from_jax(net2, init)
    tr = FaultTolerantTrainer(net2, CheckpointManager(ck, save_every_steps=4))
    tr.fit(data_iter(), epochs=3)
    assert tr.resumed_from["step"] == 4 and net2.iteration == 18
    want = np.asarray(jref.params())
    err = float(np.abs(net2.params() - want).max() / np.abs(want).max())
    assert err <= 1e-9, err


# ---------------------------------------------------------------------------
# FaultTolerantTrainer: preemption and resume
# ---------------------------------------------------------------------------

def test_sigterm_preempts_and_resume_is_bitwise(tmp_path):
    net = build_net()
    mgr = CheckpointManager(str(tmp_path / "ck"), save_every_steps=4)
    ks = chaos.KillSwitch(at_step=7, mode="sigterm", marker=str(tmp_path / "m"))
    old = signal.getsignal(signal.SIGTERM)
    with pytest.raises(Preempted) as ei:
        FaultTolerantTrainer(net, mgr, hooks=(ks,)).fit(data_iter(), epochs=3)
    assert ei.value.exit_code == 128 + signal.SIGTERM
    assert mgr.latest_step() == 7
    assert signal.getsignal(signal.SIGTERM) == old
    net2 = build_net()
    tr = FaultTolerantTrainer(net2, CheckpointManager(str(tmp_path / "ck"), save_every_steps=4))
    tr.fit(data_iter(), epochs=3)
    assert tr.resumed_from["step"] == 7
    ref = build_net()
    FaultTolerantTrainer(ref, None, save_initial=False).fit(data_iter(), epochs=3)
    np.testing.assert_array_equal(net2.params(), ref.params())
    assert net2.iteration == ref.iteration == 18


def test_zero1_wrapper_resume_is_bitwise(tmp_path):
    """ZeRO-1 moments (a one-rank mesh) through the resharding loader: the
    tree walk with `ShardedLeaf` windows."""
    from deeplearning4j_tpu_torch.parallel import ParallelWrapper, make_mesh

    def wrapped():
        net = build_net(bn=True)
        return net, ParallelWrapper(net, make_mesh(device="cpu"), optimizer_sharding=True)
    net, pw = wrapped()
    FaultTolerantTrainer(pw, CheckpointManager(str(tmp_path / "ck"), save_every_steps=4)).fit(
        data_iter(), epochs=1)
    assert net._step_transform is not None
    net2, pw2 = wrapped()
    tr = FaultTolerantTrainer(pw2, CheckpointManager(str(tmp_path / "ck"), save_every_steps=4))
    tr.fit(data_iter(), epochs=2)
    assert tr.resumed_from is not None and tr.resumed_from["step"] == 4
    net3, pw3 = wrapped()
    FaultTolerantTrainer(pw3, None, save_initial=False).fit(data_iter(), epochs=2)
    np.testing.assert_array_equal(net2.params(), net3.params())
    _equal_leaves(convert.state_to_jax(net2), convert.state_to_jax(net3))


def test_fused_steps_resume_is_bitwise_and_rejects_guard(tmp_path):
    net = build_net(bn=True)
    mgr = CheckpointManager(str(tmp_path / "ck"), save_every_steps=4)
    FaultTolerantTrainer(net, mgr).fit(data_iter(), epochs=1, fused_steps=2)
    net2 = build_net(bn=True)
    FaultTolerantTrainer(net2, CheckpointManager(str(tmp_path / "ck"), save_every_steps=4)).fit(
        data_iter(), epochs=2, fused_steps=2)
    net3 = build_net(bn=True)
    FaultTolerantTrainer(net3, None, save_initial=False).fit(data_iter(), epochs=2,
                                                             fused_steps=2)
    np.testing.assert_array_equal(net2.params(), net3.params())
    with pytest.raises(ValueError):
        FaultTolerantTrainer(build_net(), divergence=DivergenceGuard()).fit(
            data_iter(), epochs=1, fused_steps=2)


# ---------------------------------------------------------------------------
# the divergence guard
# ---------------------------------------------------------------------------

def test_divergence_guard_unit():
    g = DivergenceGuard(max_score=10.0, spike_factor=3.0)
    assert g.check(float("nan")) == "nan/inf loss"
    assert g.check(float("inf")) == "nan/inf loss"
    assert "max_score" in g.check(11.0)
    for s in (1.0, 1.1, 0.9, 1.0, 1.05):
        assert g.check(s) is None
    assert "spike" in g.check(5.0)
    assert g.check(1.2) is None
    with pytest.raises(ValueError):
        DivergenceGuard(policy="ignore")


@pytest.mark.parametrize("policy", ["skip", "rollback"])
def test_divergence_policies(tmp_path, policy):
    Xbad = X.copy()
    Xbad[16:24] = np.nan                    # poisons batch 2
    net = build_net()
    g = DivergenceGuard(policy=policy)
    mgr = CheckpointManager(str(tmp_path / "ck"), save_every_steps=1)
    before = registry().counter("resilience_rollbacks_total").value
    FaultTolerantTrainer(net, mgr, divergence=g).fit(data_iter(Xbad), epochs=1)
    assert g.events == 1
    assert np.isfinite(net.score()) and np.isfinite(net.params()).all()
    if policy == "rollback":
        assert registry().counter("resilience_rollbacks_total").value == before + 1
        assert net.iteration == 5           # 6 batches, the poisoned one skipped


def test_divergence_max_events_and_grad_norm_precheck(tmp_path):
    g = DivergenceGuard(policy="skip", max_events=2)
    with pytest.raises(DivergenceError):
        FaultTolerantTrainer(build_net(), None, divergence=g, save_initial=False).fit(
            data_iter(np.full_like(X, np.nan)), epochs=1)
    assert g.events == 3
    net = build_net()
    g = DivergenceGuard(policy="skip", grad_norm_threshold=1e-12)
    FaultTolerantTrainer(net, None, divergence=g, save_initial=False).fit(data_iter(), epochs=1)
    assert g.events == 6 and net.iteration == 0   # flagged BEFORE the step


# ---------------------------------------------------------------------------
# the chaos harness and the input pipeline
# ---------------------------------------------------------------------------

def test_killswitch_exception_mode_is_one_shot(tmp_path):
    marker = str(tmp_path / "m")
    ks = chaos.KillSwitch(at_step=2, mode="exception", marker=marker)
    with pytest.raises(chaos.ChaosError):
        FaultTolerantTrainer(build_net(), None, hooks=(ks,), save_initial=False).fit(
            data_iter(), epochs=1)
    assert os.path.exists(marker) and not ks.armed()
    net2 = build_net()
    FaultTolerantTrainer(net2, None, hooks=(ks,), save_initial=False).fit(data_iter(), epochs=1)
    assert net2.iteration == 6
    with pytest.raises(ValueError):
        chaos.KillSwitch(1, mode="nuke")


def test_flaky_slow_iterators_corruption_counts_and_pipeline_retries(tmp_path):
    flaky = chaos.FlakyIterator(data_iter(), fail_at=2, times=1)
    with pytest.raises(chaos.ChaosError):
        list(flaky)
    flaky.reset()
    assert len(list(flaky)) == 6
    slow = chaos.SlowIterator(data_iter(), delay_s=0.002)
    t0 = time.monotonic()
    assert len(list(slow)) == 6 and time.monotonic() - t0 >= 0.012
    mgr = CheckpointManager(str(tmp_path / "ck"))
    mgr.save(build_net(), step=1)
    c = registry().counter("chaos_faults_injected_total", labels={"kind": "payload"})
    before = c.value
    chaos.corrupt_checkpoint(mgr.checkpoint_path(1), "payload")
    assert c.value == before + 1
    with pytest.raises(ProducerError, match="batch 3"):
        list(DevicePrefetchIterator(chaos.FlakyIterator(data_iter(), fail_at=3, times=1),
                                    device="cpu"))
    got = list(DevicePrefetchIterator(chaos.FlakyIterator(data_iter(), fail_at=3, times=1),
                                      retries=2, retry_backoff_s=0.001, device="cpu"))
    assert len(got) == 6
    np.testing.assert_array_equal(np.asarray(got[3].features), X[24:32])


# ---------------------------------------------------------------------------
# GangReformed between the two halves of a split step
# ---------------------------------------------------------------------------

class _Counting:
    def __init__(self):
        self.calls = 0

    def iteration_done(self, model, iteration, epoch):
        self.calls += 1


def _dense_sharing():
    from deeplearning4j_tpu_torch.parallel import HierarchicalGradientSharing
    return HierarchicalGradientSharing(compressed=False, rank=0, world=1)


def test_gang_reformed_between_halves_leaves_the_step_uncounted_and_rewinds(tmp_path):
    from deeplearning4j_tpu_torch.parallel.transport import GangReformed
    net = build_net(bn=True).set_gradient_sharing(_dense_sharing())
    lst = _Counting()
    net.set_listeners(lst)
    net.fit(X[:8], Y[:8])
    real = net._grad_sharing.exchange

    def reform(grads):
        raise GangReformed({"generation": 2, "world": 1, "rank": 0, "rank_map": {0: 0},
                            "cause": "crash", "resume_step": 1})
    net._grad_sharing.exchange = reform
    with pytest.raises(GangReformed):
        net.fit(X[8:16], Y[8:16])
    assert net.iteration == 1 and int(net._iter_dev) == 1 and lst.calls == 1
    net._grad_sharing.exchange = real
    # the elastic trainer: a reformation at step 3 rewinds every member to
    # the coordinated checkpoint (step 2) and training ends where an
    # uninterrupted run ends
    net = build_net(bn=True).set_gradient_sharing(_dense_sharing())
    sharing = net._grad_sharing
    real = sharing.exchange
    fired = []

    def once(grads):
        if net.iteration == 3 and not fired:
            fired.append(1)
            raise GangReformed({"generation": 2, "world": 1, "rank": 0, "rank_map": {0: 0},
                                "cause": "crash", "resume_step": 2})
        return real(grads)
    sharing.exchange = once
    tr = ElasticTrainer(net, CheckpointManager(str(tmp_path / "ck"), keep_last=20,
                                               save_every_steps=1))
    tr.fit(data_iter(), epochs=2)
    assert fired and [r["resume_step"] for r in tr.reformations] == [2]
    ref = build_net(bn=True).set_gradient_sharing(_dense_sharing())
    FaultTolerantTrainer(ref, None, save_initial=False).fit(data_iter(), epochs=2)
    assert net.iteration == ref.iteration == 12
    np.testing.assert_array_equal(net.params(), ref.params())
    _equal_leaves(convert.state_to_jax(net), convert.state_to_jax(ref))


# ---------------------------------------------------------------------------
# the launcher: taxonomy, backoff, corrupt restores, relaunch and resume
# ---------------------------------------------------------------------------

def test_failure_taxonomy_and_backoff():
    c = ElasticLocalRunner._classify_failure
    assert c("rank 1 failed (rc=-9):\n<rank timed out>") == "hang"
    assert c("rank 0 failed (rc=1):\nRuntimeError: [../gloo/transport/tcp/pair.cc:537] "
             "Read error [127.0.0.1]:8614: Connection reset by peer.") == "peer-loss"
    assert c("rank 1 failed (rc=1):\nPeerUnreachableError: rank 1: gang coordinator at "
             "127.0.0.1:5 closed the connection") == "peer-loss"
    assert c("rank 0 failed (rc=1):\nTraceback ...") == "crash"
    assert c("rank 0 failed (rc=1):\nChecksumError: chunk leaf0_chunk0 checksum "
             "mismatch") == "corrupt"
    r = ElasticLocalRunner(2, backoff_base_s=0.5, backoff_cap_s=4.0, jitter_seed=7)
    seq = [r.backoff_s(a) for a in (1, 2, 3, 4, 5)]
    assert seq[0] == 0.5 and all(0.5 <= v <= 4.0 for v in seq)
    twin = ElasticLocalRunner(2, backoff_base_s=0.5, backoff_cap_s=4.0, jitter_seed=7)
    assert [twin.backoff_s(a) for a in (1, 2, 3, 4, 5)] == seq
    other = ElasticLocalRunner(2, backoff_base_s=0.5, backoff_cap_s=4.0, jitter_seed=8)
    assert [other.backoff_s(a) for a in (1, 2, 3, 4, 5)] != seq


def test_corrupt_restore_is_not_retried(tmp_path):
    script = tmp_path / "bad_restore.py"
    script.write_text("import sys\n"
                      "sys.stderr.write('ChecksumError: shards-0.npz chunk leaf0_chunk0 "
                      "checksum mismatch')\nsys.exit(1)\n")
    runner = ElasticLocalRunner(1, platform="cpu", max_restarts=3, backoff_base_s=0.01)
    with pytest.raises(RuntimeError, match="not retryable"):
        runner.run(str(script), timeout=60)
    assert [k for _, k, _ in runner.failure_history] == ["corrupt"]


def test_relaunch_resumes_from_the_sharded_checkpoint(tmp_path):
    """Rank 1 of a 2-rank gloo job crashes at step 3 on the first launch;
    the launcher stops rank 0, `run` relaunches both on a fresh rendezvous
    port and they resume from the last committed checkpoint and finish."""
    runner = ElasticLocalRunner(2, platform="cpu", max_restarts=2, backoff_base_s=0.05)
    outs = runner.run(os.path.join(HERE, "mh_worker_torch_elastic.py"),
                      [str(tmp_path), "6", "3"], timeout=120,
                      checkpoint_dir=str(tmp_path / "ck"))
    assert runner.restarts == 1
    assert [k for _, k, _ in runner.failure_history] == ["crash"]
    assert (tmp_path / "crashed_once").exists()
    assert any("resumed at iteration 3" in o for o in outs), outs
    final = np.load(tmp_path / "final.npz")
    assert int(final["iteration"]) == 6
    # the same 6 steps in one process on the global batch
    from deeplearning4j_tpu_torch.train import Sgd
    conf = (tnn.NeuralNetConfiguration.builder().seed(7).updater(Sgd(0.1)).dtype("float64")
            .list([tnn.DenseLayer(n_out=16, activation="tanh"),
                   tnn.OutputLayer(n_out=2, loss="mcxent", activation="softmax")])
            .set_input_type(tnn.InputType.feed_forward(10)).build())
    ref = tnn.MultiLayerNetwork(conf, device="cpu").init()
    rng = np.random.default_rng(0)
    x = rng.standard_normal((16, 10))
    y = np.eye(2)[(x.sum(1) > 0).astype(int)]
    for _ in range(6):
        ref.fit(x, y)
    err = float(np.abs(final["params"] - ref.params()).max() / np.abs(ref.params()).max())
    assert err <= 1e-10, err
