"""Data-parallel training of the PyTorch port (``parallel/``) against the
JAX package's ``ParallelWrapper``.

The port runs one process a rank: a module-scoped pool of 2 gloo ranks on
the CPU (spawned once a module, loopback TCP rendezvous) runs each task on
both ranks, and the parent computes the JAX side on a 2-device mesh of the
8 virtual CPU devices ``conftest.py`` gives JAX.  Both start from the JAX
package's initial parameters (carried with ``convert``), take the same
global batches made with numpy from a seed, and run in f64; parameters,
layer state, updater state and losses agree within 1e-10 relative
(max|diff| <= 1e-10 * max|ref| per tensor).  The JAX data-parallel step is
the single-device step on the global batch, so these checks hold the
port's global loss means, gradient sum, BatchNorm statistics and padded
partial batches to it.

The worker functions (``_task_*``) run in the ranks; they import nothing
of JAX, so this module imports JAX only inside the parent-side helpers.
"""
import torch_test_threads  # noqa: F401  (first: one torch thread a worker)
import importlib
import multiprocessing
import socket
import traceback
import warnings
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch import convert
from deeplearning4j_tpu_torch import nn as tnn
from deeplearning4j_tpu_torch.data import DataSet, ListDataSetIterator, MultiDataSet
from deeplearning4j_tpu_torch.parallel import (DynamicBatchingInference, ParallelInference,
                                               ParallelWrapper, make_mesh)
from deeplearning4j_tpu_torch.train import CollectScoresListener

RTOL = 1e-10
WORLD = 2


# ---------------------------------------------------------------------------
# the rank pool
# ---------------------------------------------------------------------------

def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _serve(rank, world, port, tasks, results):
    import datetime
    import torch.distributed as dist
    torch.set_num_threads(1)
    warnings.filterwarnings("ignore", category=FutureWarning)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=60))
    while True:
        item = tasks.get()
        if item is None:
            break
        module, name, args = item
        try:
            fn = getattr(importlib.import_module(module), name)
            results.put((rank, True, fn(*args)))
        except BaseException:
            results.put((rank, False, traceback.format_exc()))
    dist.destroy_process_group()


class RankPool:
    """`WORLD` spawned processes in one gloo group; `run(fn, *args)` runs
    module-level `fn` on every rank and returns the ranks' results."""

    def __init__(self, world=WORLD):
        ctx = multiprocessing.get_context("spawn")
        port = _free_port()
        self.world = world
        self.tasks = [ctx.Queue() for _ in range(world)]
        self.results = ctx.Queue()
        self.procs = [ctx.Process(target=_serve, args=(r, world, port, self.tasks[r],
                                                       self.results), daemon=True)
                      for r in range(world)]
        for p in self.procs:
            p.start()

    def run(self, fn, *args, timeout=150):
        for q in self.tasks:
            q.put((fn.__module__, fn.__name__, args))
        got = {}
        for _ in range(self.world):
            rank, ok, value = self.results.get(timeout=timeout)
            got[rank] = (ok, value)
        bad = [f"rank {r}:\n{v}" for r, (ok, v) in sorted(got.items()) if not ok]
        if bad:
            raise RuntimeError("\n".join(bad))
        return [got[r][1] for r in range(self.world)]

    def close(self):
        for q in self.tasks:
            q.put(None)
        for p in self.procs:
            p.join(timeout=10)
            if p.is_alive():
                p.terminate()


@pytest.fixture(scope="module")
def pool():
    p = RankPool()
    yield p
    p.close()


# ---------------------------------------------------------------------------
# helpers shared by the parent and the ranks
# ---------------------------------------------------------------------------

def close(got, want, rtol=RTOL, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-300) if want.size else 1.0
    err = float(np.abs(got - want).max()) if want.size else 0.0
    assert err <= rtol * scale, f"{what}: max|diff| {err} > {rtol} * {scale}"


def close_trees(got, want, rtol=RTOL, what=""):
    if isinstance(want, dict):
        assert set(got) == set(want), (what, sorted(got), sorted(want))
        for k in want:
            close_trees(got[k], want[k], rtol, f"{what}.{k}")
    elif isinstance(want, (tuple, list)):
        assert len(got) == len(want), what
        for i, (g, w) in enumerate(zip(got, want)):
            close_trees(g, w, rtol, f"{what}[{i}]")
    else:
        close(got, want, rtol, what)


def equal_trees(a, b, what=""):
    if isinstance(b, dict):
        assert set(a) == set(b), what
        for k in b:
            equal_trees(a[k], b[k], f"{what}.{k}")
    elif isinstance(b, (tuple, list)):
        for i, (x, y) in enumerate(zip(a, b)):
            equal_trees(x, y, f"{what}[{i}]")
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=what)


def port_net(conf_json, params, state=None, graph=False):
    """A port network on the CPU from a JAX configuration and initial
    parameters (and layer state)."""
    if graph:
        net = tnn.ComputationGraph(tnn.ComputationGraphConfiguration.from_json(conf_json),
                                   device="cpu").init()
    else:
        net = tnn.MultiLayerNetwork(tnn.MultiLayerConfiguration.from_json(conf_json),
                                    device="cpu").init()
    convert.params_from_jax(net, params)
    if state is not None:
        convert.state_from_jax(net, state)
    return net


def snapshot(net, opt=True):
    out = {"params": convert.params_to_jax(net), "state": convert.state_to_jax(net),
           "iteration": net.iteration, "epoch": net.epoch}
    if opt:
        out["opt"] = convert.opt_state_to_jax(net)
    return out


def jx():
    """The JAX side's modules (imported in the parent only)."""
    import jax
    from deeplearning4j_tpu import nn as jnn
    from deeplearning4j_tpu import parallel as jpar
    from deeplearning4j_tpu.data import dataset as jds
    from deeplearning4j_tpu.data import iterators as jit
    from deeplearning4j_tpu.train import updaters as jupd

    class J:
        pass
    J.jax, J.nn, J.par, J.ds, J.it, J.upd = jax, jnn, jpar, jds, jit, jupd
    J.mesh2 = lambda: jpar.make_mesh({"data": WORLD}, jax.devices()[:WORLD])
    J.np = lambda tree: jax.tree_util.tree_map(np.asarray, tree)
    return J


def jax_snapshot(J, jnet, opt=True):
    out = {"params": J.np(jnet.params_), "state": J.np(jnet.state_),
           "iteration": jnet.iteration, "epoch": jnet.epoch}
    if opt:
        out["opt"] = J.np(jnet.opt_state_)
    return out


def same_as_jax(got, want, rtol=RTOL):
    close_trees(got["params"], want["params"], rtol, "params")
    close_trees(got["state"], want["state"], rtol, "state")
    if "opt" in got and "opt" in want:
        close_trees(got["opt"], want["opt"], rtol, "opt")
    assert (got["iteration"], got["epoch"]) == (want["iteration"], want["epoch"])


def ranks_equal(results):
    """Every rank's snapshot equal to rank 0's, bit for bit."""
    for r in results[1:]:
        equal_trees(r, results[0])


# ---------------------------------------------------------------------------
# configurations (JAX builders; the port reads their JSON)
# ---------------------------------------------------------------------------

def mlp_conf(J, updater, n_in=8, seed=7, dropout=None):
    dense = J.nn.DenseLayer(n_out=16, activation="relu")
    if dropout is not None:
        dense = J.nn.DenseLayer(n_out=16, activation="relu", dropout=dropout)
    return (J.nn.NeuralNetConfiguration.builder().seed(seed).updater(updater)
            .dtype("float64")
            .list([dense, J.nn.OutputLayer(n_out=3, loss="mcxent", activation="softmax")])
            .set_input_type(J.nn.InputType.feed_forward(n_in)).build())


def bn_conf(J, updater):
    return (J.nn.NeuralNetConfiguration.builder().seed(11).updater(updater).dtype("float64")
            # no conv bias: BatchNorm cancels it, so its gradient is rounding noise
            .list([J.nn.ConvolutionLayer(n_out=4, kernel_size=3, activation="identity",
                                         has_bias=False),
                   J.nn.BatchNormalizationLayer(activation="relu"),
                   J.nn.DenseLayer(n_out=8, activation="tanh"),
                   J.nn.OutputLayer(n_out=3, loss="mcxent", activation="softmax")])
            .set_input_type(J.nn.InputType.convolutional(6, 6, 2)).build())


def cg_conf(J, updater):
    return (J.nn.GraphBuilder().seed(5).updater(updater).dtype("float64")
            .add_inputs("a", "b")
            .set_input_types(J.nn.InputType.feed_forward(4), J.nn.InputType.feed_forward(6))
            .add_layer("da", J.nn.DenseLayer(n_out=5, activation="tanh"), "a")
            .add_layer("db", J.nn.DenseLayer(n_out=7, activation="tanh"), "b")
            .add_vertex("m", J.nn.MergeVertex(), "da", "db")
            .add_layer("out", J.nn.OutputLayer(n_out=2, loss="mcxent",
                                               activation="softmax"), "m")
            .add_layer("reg", J.nn.OutputLayer(n_out=3, loss="mse",
                                               activation="identity"), "db")
            .set_outputs("out", "reg").build())


def mlp_data(n, n_in=8, seed=0):
    rs = np.random.RandomState(seed)
    x = rs.randn(n, n_in)
    labels = (x[:, 0] > 0).astype(int) + (x[:, 1] > 0).astype(int)
    return x, np.eye(3)[labels]


def image_data(n, seed=1):
    rs = np.random.RandomState(seed)
    return rs.rand(n, 6, 6, 2), np.eye(3)[rs.randint(0, 3, n)]


def cg_data(n, seed=3):
    rs = np.random.RandomState(seed)
    return ([rs.randn(n, 4), rs.randn(n, 6)],
            [np.eye(2)[rs.randint(0, 2, n)], rs.randn(n, 3)])


def jax_start(J, conf, graph=False):
    net = (J.nn.ComputationGraph(conf) if graph else J.nn.MultiLayerNetwork(conf)).init()
    return net, conf.to_json(), J.np(net.params_), J.np(net.state_)


# ---------------------------------------------------------------------------
# rank tasks
# ---------------------------------------------------------------------------

def _task_mesh():
    from deeplearning4j_tpu_torch.parallel import make_mesh as mk
    mesh = mk()
    out = {"shape": mesh.shape, "size": mesh.size, "rank": mesh.rank,
           "device": str(mesh.device)}
    errors = {}
    for name, fn in (("three", lambda: mk({"data": 3})),
                     ("model", lambda: mk({"data": 1, "model": 2})),
                     ("part", lambda: mk({"data": 1}, devices=[0])),
                     ("cuda", lambda: mk(device="cuda"))):
        try:
            fn()
            errors[name] = None
        except Exception as e:
            errors[name] = type(e).__name__ + ": " + str(e)
    net = tnn.MultiLayerNetwork(tnn.MultiLayerConfiguration.from_json(
        _plain_conf_json()), device="cpu").init()
    for name, n in (("workers3", 3), ("workers1", 1)):
        try:
            ParallelWrapper.builder(net).workers(n).build()
            errors[name] = None
        except Exception as e:
            errors[name] = type(e).__name__ + ": " + str(e)
    out["workers2"] = ParallelWrapper.builder(net).workers(2).build().degree
    out["part_member"] = mk({"data": 1}, devices=[0]).member
    out["workers1_member"] = ParallelWrapper.builder(net).workers(1).build().mesh.member
    out["errors"] = errors
    from deeplearning4j_tpu_torch.parallel import multihost
    out["process"] = (multihost.process_index(), multihost.process_count())
    out["gathered"] = multihost.allgather_params(
        {"w": torch.full((2,), float(mesh.rank))})["w"].tolist()
    return out


def _plain_conf_json():
    conf = (tnn.NeuralNetConfiguration.builder().seed(1)
            .list([tnn.DenseLayer(n_out=4, activation="relu"),
                   tnn.OutputLayer(n_out=2, loss="mcxent", activation="softmax")])
            .set_input_type(tnn.InputType.feed_forward(3)).build())
    return conf.to_json()


def _task_fit(conf_json, params, state, x, y, steps, graph=False, zero1=False):
    """`steps` wrapper fits of the global batch (x, y); a graph gets lists."""
    net = port_net(conf_json, params, state, graph)
    rank0 = CollectScoresListener(frequency=1)
    net.set_listeners(rank0)
    pw = ParallelWrapper.builder(net).optimizer_sharding(zero1).build()
    losses = []
    for _ in range(steps):
        pw.fit(x, y)
        losses.append(net.score())
    skew = pw.measure_replica_skew()
    heard = len(rank0.scores)
    from deeplearning4j_tpu_torch.parallel import disable_zero1
    disable_zero1(net)
    return snapshot(net), losses, heard, skew


def _task_fit_iterator(conf_json, params, state, batches):
    net = port_net(conf_json, params, state)
    pw = ParallelWrapper.builder(net).build()
    it = ListDataSetIterator([DataSet(x, y) for x, y in batches])
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        pw.fit(it)
    dropped = [w for w in rec if "dropping final partial" in str(w.message)]
    return snapshot(net), len(dropped)


def _task_drop_warning():
    net = tnn.MultiLayerNetwork(tnn.MultiLayerConfiguration.from_json(_plain_conf_json()),
                                device="cpu").init()
    pw = ParallelWrapper.builder(net).build()
    ds = DataSet(np.zeros((3, 3)), np.zeros((3, 2, 5)))
    warned = []
    for _ in range(2):
        with warnings.catch_warnings(record=True) as rec:
            warnings.simplefilter("always")
            pw.fit(iter([ds]))
        warned.append(sum("dropping final partial" in str(w.message) for w in rec))
    return warned, net.iteration


def _task_fit_steps(conf_json, params, state, xs, ys):
    """One block of k through `fit_steps` on one net, k wrapper fits on a
    twin; returns both (each bitwise per rank) and the block's losses."""
    fused = port_net(conf_json, params, state)
    stepped = port_net(conf_json, params, state)
    pf, ps = ParallelWrapper.builder(fused).build(), ParallelWrapper.builder(stepped).build()
    losses = pf.fit_steps(xs, ys).tolist()
    singles = []
    for x, y in zip(xs, ys):
        ps.fit(x, y)
        singles.append(stepped.score())
    return snapshot(fused), snapshot(stepped), losses, singles


def _task_fit_mds(conf_json, params, state, feats, labels, steps):
    net = port_net(conf_json, params, state, graph=True)
    pw = ParallelWrapper.builder(net).build()
    losses = []
    for _ in range(steps):
        pw.fit(MultiDataSet(feats, labels))
        losses.append(net.score())
    return snapshot(net), losses


def _task_staging(conf_json, params, state, batches):
    """`fit_prefetched` (each rank staging its rows through
    `DevicePrefetchIterator(placement=...)`, blocks of 2) and
    `fit_host_local` (each rank passing its rows) against `fit(iterator)`
    on twins; and the rows `stage` puts on a rank."""
    from deeplearning4j_tpu_torch.data.pipeline import stage
    nets = [port_net(conf_json, params, state) for _ in range(3)]
    pws = [ParallelWrapper.builder(n).build() for n in nets]
    it = ListDataSetIterator([DataSet(x, y) for x, y in batches])
    pws[0].fit(it)
    pws[1].fit_prefetched(it, fused_steps=2)
    r, n = pws[2].mesh.rank, pws[2].degree
    for x, y in batches:
        b = x.shape[0] // n
        pws[2].fit_host_local(x[r * b:(r + 1) * b], y[r * b:(r + 1) * b])
    staged = stage(DataSet(*batches[0]), placement=pws[0].sharded_placement())
    return [snapshot(net) for net in nets], staged.features.numpy()


def _task_inference(conf_json, params, x):
    net = port_net(conf_json, params)
    pi = ParallelInference(net)
    whole = pi.output(x)
    parts = pi.output([x[:3], x[3:7], x[7:7], x[7:]])
    return whole, parts, net.output(x).numpy()


# ---------------------------------------------------------------------------
# tests
# ---------------------------------------------------------------------------

def test_mesh_construction_and_its_errors(pool):
    mesh = make_mesh(device="cpu")
    assert (mesh.shape, mesh.size, mesh.rank, mesh.distributed) == ({"data": 1}, 1, 0, False)
    with pytest.raises(ValueError, match="require"):
        make_mesh({"data": 3}, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make_mesh()
    got = pool.run(_task_mesh)
    for r, out in enumerate(got):
        assert out["shape"] == {"data": 2} and out["size"] == 2 and out["rank"] == r
        assert out["device"] == "cpu" and out["workers2"] == 2
        e = out["errors"]
        assert e["three"].startswith("ValueError") and "require" in e["three"]
        assert e["model"] is None       # the model axis is ported, and a mesh over
        assert e["part"] is None        # part of the ranks (rank 0 its member)
        assert e["cuda"] is not None
        assert e["workers3"].startswith("ValueError") and "exceeds" in e["workers3"]
        assert e["workers1"] is None
        assert out["part_member"] == out["workers1_member"] == (r == 0)
        assert out["process"] == (r, 2) and out["gathered"] == [[0.0, 0.0], [1.0, 1.0]]


def test_one_rank_wrapper_is_plain_training_bit_for_bit():
    """A wrapper over a one-rank mesh (no process group) takes the plain
    step: fit, fit_steps and fit(iterator) give the same bits as the bare
    network, ZeRO-1 on or off."""
    conf = (tnn.NeuralNetConfiguration.builder().seed(3).updater(tnn_adam()).dtype("float64")
            .list([tnn.DenseLayer(n_out=16, activation="relu"),
                   tnn.BatchNormalizationLayer(),
                   tnn.OutputLayer(n_out=3, loss="mcxent", activation="softmax")])
            .set_input_type(tnn.InputType.feed_forward(8)).build())

    def make():
        return tnn.MultiLayerNetwork(tnn.MultiLayerConfiguration.from_json(conf.to_json()),
                                     device="cpu").init()
    x, y = mlp_data(16)
    plain, wrapped, zeroed = make(), make(), make()
    pw = ParallelWrapper.builder(wrapped).build()
    pz = ParallelWrapper.builder(zeroed).optimizer_sharding(True).build()
    assert pw.mesh.shape == {"data": 1} and not pw.mesh.distributed
    for _ in range(3):
        plain.fit(x, y)
        pw.fit(x, y)
        pz.fit(x, y)
    xs, ys = np.broadcast_to(x, (3,) + x.shape), np.broadcast_to(y, (3,) + y.shape)
    want = plain.fit_steps(xs, ys)
    assert torch.equal(pw.fit_steps(xs, ys), want) and torch.equal(pz.fit_steps(xs, ys), want)
    it = ListDataSetIterator([DataSet(x[:8], y[:8]), DataSet(x[8:], y[8:])])
    plain.fit(it)
    pw.fit(it)
    pz.fit(it)
    for other in (wrapped, zeroed):
        assert plain.score() == other.score()
        equal_trees(snapshot(other, opt=False), snapshot(plain, opt=False))
    equal_trees(convert.opt_state_to_jax(wrapped), convert.opt_state_to_jax(plain))


def tnn_adam():
    from deeplearning4j_tpu_torch.train import Adam
    return Adam(1e-2)


@pytest.mark.parametrize("updater", ["Sgd", "Adam"])
def test_data_parallel_mln_matches_jax_on_two_devices(pool, updater):
    """5 wrapper steps of a global batch of 16 over 2 ranks equal the JAX
    wrapper's over 2 devices; the ranks agree bit for bit; listeners hear
    of steps on rank 0 only."""
    J = jx()
    upd = J.upd.Sgd(1e-1) if updater == "Sgd" else J.upd.Adam(1e-2)
    jnet, conf, params, state = jax_start(J, mlp_conf(J, upd))
    x, y = mlp_data(16)
    pw = J.par.ParallelWrapper(jnet, J.mesh2())
    jl = []
    for _ in range(5):
        pw.fit(x, y)
        jl.append(jnet.score())
    got = pool.run(_task_fit, conf, params, state, x, y, 5)
    ranks_equal([g[0] for g in got])
    same_as_jax(got[0][0], jax_snapshot(J, jnet))
    close(got[0][1], jl, what="losses")
    assert [g[2] for g in got] == [5, 0]
    assert all(g[3] >= 0.0 for g in got)


def test_batchnorm_takes_global_statistics(pool):
    """Conv + BatchNorm + Dense, 3 Adam steps on 2 ranks: parameters and
    the running mean and variance equal the JAX wrapper's (the global
    batch's statistics), which the ranks' own halves would not give."""
    J = jx()
    jnet, conf, params, state = jax_start(J, bn_conf(J, J.upd.Adam(1e-2)))
    x, y = image_data(8)
    x[4:] += 3.0                      # the two ranks' rows differ in mean
    pw = J.par.ParallelWrapper(jnet, J.mesh2())
    for _ in range(3):
        pw.fit(x, y)
    got = pool.run(_task_fit, conf, params, state, x, y, 3)
    ranks_equal([g[0] for g in got])
    want = jax_snapshot(J, jnet)
    same_as_jax(got[0][0], want)
    local = port_net(conf, params, state)
    for _ in range(3):
        local.fit(x[:4], y[:4])
    run_mean = convert.state_to_jax(local)["layer_1"]["mean"]
    assert np.abs(run_mean - want["state"]["layer_1"]["mean"]).max() > 1e-3


def test_computation_graph_two_inputs_two_heads_on_multidatasets(pool):
    J = jx()
    jnet, conf, params, state = jax_start(J, cg_conf(J, J.upd.Adam(1e-2)), graph=True)
    feats, labels = cg_data(12)
    pw = J.par.ParallelWrapper(jnet, J.mesh2())
    jl = []
    for _ in range(4):
        pw.fit(J.ds.MultiDataSet(feats, labels))
        jl.append(jnet.score())
    got = pool.run(_task_fit_mds, conf, params, state, feats, labels, 4)
    ranks_equal([g[0] for g in got])
    same_as_jax(got[0][0], jax_snapshot(J, jnet))
    close(got[0][1], jl, what="losses")


def test_fit_iterator_pads_a_partial_final_batch_exactly(pool):
    """Batches of 16, 16 and 11 rows: the last pads to 12 with a zero
    labels-mask row on rank 1 only; the global mask sum keeps the JAX
    wrapper's loss, which is the single-device step on the 11 rows."""
    J = jx()
    jnet, conf, params, state = jax_start(J, mlp_conf(J, J.upd.Adam(1e-2)))
    x, y = mlp_data(43, seed=2)
    cuts = [(0, 16), (16, 32), (32, 43)]
    batches = [(x[a:b], y[a:b]) for a, b in cuts]
    pw = J.par.ParallelWrapper(jnet, J.mesh2())
    pw.fit(J.it.ListDataSetIterator([J.ds.DataSet(a, b) for a, b in batches]))
    single = port_net(conf, params, state)
    for a, b in batches:
        single.fit(a, b)
    got = pool.run(_task_fit_iterator, conf, params, state, batches)
    assert [g[1] for g in got] == [0, 0]
    ranks_equal([g[0] for g in got])
    want = jax_snapshot(J, jnet)
    assert got[0][0]["iteration"] == 3
    same_as_jax(got[0][0], want)
    close_trees(snapshot(single)["params"], got[0][0]["params"], what="single-device")


def test_unmaskable_partial_batch_is_dropped_with_one_warning(pool):
    for warned, iteration in pool.run(_task_drop_warning):
        assert warned == [1, 0] and iteration == 0


def test_fit_steps_block_of_three_matches_per_step_fits(pool):
    J = jx()
    jnet, conf, params, state = jax_start(J, bn_conf(J, J.upd.Adam(1e-2)))
    batches = [image_data(8, seed=s) for s in (4, 5, 6)]
    xs, ys = np.stack([b[0] for b in batches]), np.stack([b[1] for b in batches])
    jl = np.asarray(J.par.ParallelWrapper(jnet, J.mesh2()).fit_steps(xs, ys))
    got = pool.run(_task_fit_steps, conf, params, state, xs, ys)
    for fused, stepped, losses, singles in got:
        equal_trees(fused, stepped)
        assert losses == singles
    ranks_equal([g[0] for g in got])
    same_as_jax(got[0][0], jax_snapshot(J, jnet))
    close(got[0][2], jl, what="block losses")


def test_ranks_keep_equal_parameters_with_their_own_dropout_masks(pool):
    """Dropout 0.5: each rank draws its own masks (its generator is seeded
    from the seed and the rank), and the summed gradient keeps every
    parameter bitwise equal on both ranks."""
    J = jx()
    jnet, conf, params, state = jax_start(J, mlp_conf(J, J.upd.Adam(1e-2), dropout=0.5))
    x, y = mlp_data(16, seed=5)
    got = pool.run(_task_fit, conf, params, state, x, y, 4)
    ranks_equal([g[0] for g in got])
    assert got[0][1] == got[1][1]
    assert not np.array_equal(got[0][0]["params"]["layer_0"]["W"], params["layer_0"]["W"])


def test_parallel_inference_pads_and_gathers(pool):
    J = jx()
    _, conf, params, _ = jax_start(J, mlp_conf(J, J.upd.Sgd(0.1)))
    x, _ = mlp_data(11, seed=6)
    for whole, parts, plain in pool.run(_task_inference, conf, params, x):
        np.testing.assert_array_equal(whole, plain)
        assert [p.shape[0] for p in parts] == [3, 4, 0, 4]
        np.testing.assert_array_equal(np.concatenate(parts), plain)


def test_dynamic_batching_inference_with_concurrent_clients():
    net = tnn.MultiLayerNetwork(tnn.MultiLayerConfiguration.from_json(_plain_conf_json()),
                                device="cpu").init()
    pi = ParallelInference(net, mesh=make_mesh(device="cpu"))
    with pytest.warns(DeprecationWarning):
        dyn = DynamicBatchingInference(pi, max_batch=16, timeout_ms=400.0)
    rs = np.random.RandomState(0)
    reqs = [rs.rand(n, 3) for n in (1, 3, 2, 4, 1, 5)]
    want = [pi.output(r) for r in reqs]
    calls = []
    run = pi._run
    pi._run = lambda x: calls.append(x.shape[0]) or run(x)
    with ThreadPoolExecutor(max_workers=6) as ex:
        got = [f.result(timeout=30) for f in [ex.submit(dyn.output, r) for r in reqs]]
    dyn.shutdown()
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert len(calls) < len(reqs), calls


def test_staging_places_each_ranks_rows(pool):
    """`fit_prefetched` and `fit_host_local` train as `fit(iterator)`
    does, bit for bit; `stage` with the wrapper's placement puts rank r's
    rows of the global batch on its device."""
    J = jx()
    _, conf, params, state = jax_start(J, mlp_conf(J, J.upd.Adam(1e-2)))
    batches = [mlp_data(8, seed=s) for s in (11, 12, 13, 14)]
    got = pool.run(_task_staging, conf, params, state, batches)
    for r, (snaps, rows) in enumerate(got):
        equal_trees(snaps[1], snaps[0])
        assert snaps[2].pop("epoch") == 0           # fit_host_local is one step
        equal_trees(snaps[2], {k: v for k, v in snaps[0].items() if k != "epoch"})
        np.testing.assert_array_equal(rows, batches[0][0][4 * r:4 * (r + 1)])
    ranks_equal([g[0][0] for g in got])
