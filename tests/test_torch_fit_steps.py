"""The fused training loop of the PyTorch port against the JAX package.

`fit_steps` (k steps as one block: a CUDA-graph replay on the card, the
same step body k times on the CPU), `fit(iterator, fused_steps=k)` and the
ComputationGraph's training API, each started from parameters the JAX
package initialized (carried over with `convert`) and fed the same numpy
batches from a seed.  In f64 losses, parameters, layer state and updater
state agree within 1e-10 relative (max|diff| <= 1e-10 * max|ref| per
tensor); in f32 within 1e-5.  The port's `fit_steps` equals k of its own
`fit` calls bitwise, keeps the address of every tensor it carries, and
reads its learning rate and bias corrections from the device counters.
"""
import torch_test_threads  # noqa: F401  (first: one torch thread a worker)
import jax
import numpy as np
import pytest
import torch

from deeplearning4j_tpu import nn as jnn
from deeplearning4j_tpu.data.dataset import DataSet as JDataSet
from deeplearning4j_tpu.data.iterators import ListDataSetIterator as JList
from deeplearning4j_tpu.train import schedules as jsched
from deeplearning4j_tpu.train import updaters as jupd
from deeplearning4j_tpu_torch import convert
from deeplearning4j_tpu_torch import nn as tnn
from deeplearning4j_tpu_torch.data import DataSet, ListDataSetIterator
from deeplearning4j_tpu_torch.nn.multilayer import block_tensor
from deeplearning4j_tpu_torch.train import schedules as tsched
from deeplearning4j_tpu_torch.train import updaters as tupd
from deeplearning4j_tpu_torch.utils import counters

RTOL = {"float64": 1e-10, "float32": 1e-5}


def _close(got, want, rtol, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    scale = max(float(np.abs(want).max()), 1e-300) if want.size else 1.0
    err = float(np.abs(got - want).max()) if want.size else 0.0
    assert err <= rtol * scale, f"{what}: max|diff| {err} > {rtol} * {scale}"


def _same_nets(jnet, tnet, rtol):
    jp = jax.tree_util.tree_map(np.asarray, jnet.params_)
    tp = convert.params_to_jax(tnet)
    for n in jp:
        for k in jp[n]:
            _close(tp[n][k], jp[n][k], rtol, f"params {n}.{k}")
    js = jax.tree_util.tree_map(np.asarray, jnet.state_)
    ts = convert.state_to_jax(tnet)
    for n in js:
        for k in js[n]:
            _close(ts[n][k], js[n][k], rtol, f"state {n}.{k}")
    jo = jax.tree_util.tree_map(np.asarray, jnet.opt_state_)
    to = convert.opt_state_to_jax(tnet)
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(jo),
                            jax.tree_util.tree_leaves(to)):
        _close(b, a, rtol, f"updater {jax.tree_util.keystr(path)}")
    assert (tnet.iteration, tnet.epoch) == (jnet.iteration, jnet.epoch)


def _carried(net):
    return net._carry()


def _all_equal(a, b):
    for (n, x), (_, y) in zip(a.state_dict().items(), b.state_dict().items()):
        assert torch.equal(x, y), n
    for x, y in zip(tupd.tree_leaves(a.opt_state_), tupd.tree_leaves(b.opt_state_)):
        if isinstance(x, torch.Tensor):
            assert torch.equal(x, y)


# ---------------------------------------------------------------------------
# a narrow LeNet (MultiLayerNetwork)
# ---------------------------------------------------------------------------

UPDATERS = {
    # the learning rate halves every 2 steps: inside each block of 3
    "Adam": lambda: jupd.Adam(jsched.StepSchedule(1e-2, 0.5, 2)),
    "Nesterovs": lambda: jupd.Nesterovs(jsched.StepSchedule(5e-2, 0.5, 2), 0.9),
}


def _lenet_conf(updater, dtype):
    return (jnn.NeuralNetConfiguration.builder().seed(5).updater(updater).dtype(dtype)
            .list([jnn.ConvolutionLayer(n_out=4, kernel_size=5, activation="identity"),
                   jnn.SubsamplingLayer(kernel_size=2, stride=2, pooling_type="max"),
                   jnn.ConvolutionLayer(n_out=6, kernel_size=3, activation="identity"),
                   jnn.SubsamplingLayer(kernel_size=2, stride=2, pooling_type="max"),
                   jnn.DenseLayer(n_out=16, activation="relu"),
                   jnn.OutputLayer(n_out=10, loss="mcxent", activation="softmax")])
            .set_input_type(jnn.InputType.convolutional(14, 14, 1)).build())


def _mln_twin(jconf):
    jnet = jnn.MultiLayerNetwork(jconf).init()
    tnet = tnn.MultiLayerNetwork(tnn.MultiLayerConfiguration.from_json(jconf.to_json()),
                                 device="cpu").init()
    convert.params_from_jax(tnet, jax.tree_util.tree_map(np.asarray, jnet.params_))
    convert.state_from_jax(tnet, jax.tree_util.tree_map(np.asarray, jnet.state_))
    return jnet, tnet


def _port_copy(tnet):
    other = tnn.MultiLayerNetwork(
        tnn.MultiLayerConfiguration.from_json(tnet.conf.to_json()), device="cpu").init()
    other.load_state_dict(tnet.state_dict())
    return other


def _images(n, dtype, seed, batch=4):
    rs = np.random.RandomState(seed)
    return [(rs.rand(batch, 14, 14, 1).astype(dtype),
             np.eye(10, dtype=dtype)[rs.randint(0, 10, batch)]) for _ in range(n)]


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("upd", sorted(UPDATERS))
def test_fit_steps_both_forms_match_jax_with_a_schedule_boundary_in_the_block(upd, dtype):
    rtol = RTOL[dtype]
    jnet, tnet = _mln_twin(_lenet_conf(UPDATERS[upd](), dtype))
    listed = _port_copy(tnet)
    for lo in (0, 3):                     # two blocks of 3: iterations 0..5
        batch = _images(3, dtype, seed=10 + lo)
        xs = np.stack([x for x, _ in batch])
        ys = np.stack([y for _, y in batch])
        jl = np.asarray(jnet.fit_steps(xs, ys))
        tl = tnet.fit_steps(xs, ys)
        ll = listed.fit_steps([x for x, _ in batch], [y for _, y in batch])
        _close(tl.numpy(), jl, rtol, "block losses")
        assert torch.equal(tl, ll)
        assert tnet.score() == float(tl[-1])
    _same_nets(jnet, tnet, rtol)
    _all_equal(tnet, listed)


def test_fit_steps_equals_k_fit_calls_bitwise_and_keeps_every_address():
    conf = _lenet_conf(UPDATERS["Adam"](), "float64")
    _, fused = _mln_twin(conf)
    stepped = _port_copy(fused)
    carried = [(t, t.data_ptr()) for t in _carried(fused)]
    batch = _images(3, "float64", seed=3)
    losses = fused.fit_steps(np.stack([x for x, _ in batch]), np.stack([y for _, y in batch]))
    singles = []
    for x, y in batch:
        stepped.fit(x, y)
        singles.append(stepped.score_array())
    assert torch.equal(losses, torch.stack(singles))
    _all_equal(fused, stepped)
    assert fused.iteration == stepped.iteration == 3
    now = _carried(fused)
    assert len(now) == len(carried)
    for (t, ptr), u in zip(carried, now):
        assert u is t and u.data_ptr() == ptr
    assert int(fused._iter_dev) == 3


@pytest.mark.parametrize("name", sorted(tupd.UPDATERS))
def test_updater_writes_its_state_in_place_and_leaves_the_gradients(name):
    """A carried updater state keeps its addresses and is written once a
    step: `apply` returns the tree it was given, new values written in."""
    rs = np.random.RandomState(2)
    params = {"W": torch.from_numpy(rs.randn(4, 3)), "b": torch.from_numpy(rs.randn(3))}
    u = tupd.UPDATERS[name]()
    state = u.init_state(params)
    leaves = [(t, t.data_ptr()) for t in tupd.tree_leaves(state)
              if isinstance(t, torch.Tensor)]
    for it in range(3):
        grads = {k: torch.from_numpy(rs.randn(*p.shape)) for k, p in params.items()}
        kept = {k: g.clone() for k, g in grads.items()}
        before = [t.clone() for t, _ in leaves]
        _, out = u.apply(state, grads, it, params=params)
        assert out is state
        for k in grads:
            assert torch.equal(grads[k], kept[k]), k
        if leaves:
            assert any(not torch.equal(b, t) for b, (t, _) in zip(before, leaves))
    for t, ptr in leaves:
        assert t.data_ptr() == ptr


def test_stride_zero_block_equals_a_materialized_one():
    """bench.py's `broadcast_to` block crosses as one step; the CPU conv
    backward may round differently at another buffer offset, so the
    parameters agree within 1e-12 rather than bitwise."""
    conf = _lenet_conf(UPDATERS["Nesterovs"](), "float64")
    _, a = _mln_twin(conf)
    b = _port_copy(a)
    (x, y), = _images(1, "float64", seed=4)
    xs = np.broadcast_to(x, (3,) + x.shape)
    assert block_tensor(xs, a.device).stride()[0] == 0
    la = a.fit_steps(xs, np.broadcast_to(y, (3,) + y.shape))
    lb = b.fit_steps(np.stack([x] * 3), np.stack([y] * 3))
    _close(la.numpy(), lb.numpy(), 1e-12, "losses")
    for (n, p), (_, q) in zip(a.state_dict().items(), b.state_dict().items()):
        _close(p.numpy(), q.numpy(), 1e-12, n)


def test_fused_fit_over_an_iterator_with_a_tail_matches_jax():
    jnet, tnet = _mln_twin(_lenet_conf(UPDATERS["Adam"](), "float64"))
    batches = _images(7, "float64", seed=21)
    seen = []

    class Once:
        def iteration_done(self, model, iteration, epoch):
            seen.append(iteration)

    tnet.set_listeners(Once())
    jnet.fit(JList([JDataSet(x, y) for x, y in batches]), fused_steps=3)
    tnet.fit(ListDataSetIterator([DataSet(x, y) for x, y in batches]), fused_steps=3)
    assert seen == [3, 6, 7]              # once a block, then the tail step
    _close(tnet.score(), jnet.score(), RTOL["float64"], "last loss")
    _same_nets(jnet, tnet, RTOL["float64"])


def test_masked_blocks_fuse_and_mixed_ones_step_alone():
    conf = (jnn.NeuralNetConfiguration.builder().seed(2).updater(jupd.Adam(1e-2))
            .dtype("float64")
            .list([jnn.DenseLayer(n_out=6, activation="tanh"),
                   jnn.OutputLayer(n_out=3, loss="mcxent", activation="softmax")])
            .set_input_type(jnn.InputType.feed_forward(5)).build())
    jnet, tnet = _mln_twin(conf)
    rs = np.random.RandomState(8)
    data = []
    for i in range(7):
        x, y = rs.randn(4, 5), np.eye(3)[rs.randint(0, 3, 4)]
        m = (rs.rand(4) > 0.3).astype(np.float64) if i != 5 else None
        data.append((x, y, m))
    jnet.fit(JList([JDataSet(x, y, labels_mask=m) for x, y, m in data]), fused_steps=3)
    tnet.fit(ListDataSetIterator([DataSet(x, y, labels_mask=m) for x, y, m in data]),
             fused_steps=3)
    _same_nets(jnet, tnet, RTOL["float64"])


def test_step_scalars_come_from_the_counters_once_per_updater(monkeypatch):
    conf = _lenet_conf(UPDATERS["Adam"](), "float32")
    _, tnet = _mln_twin(conf)
    calls = []
    real = tupd.Adam.scalars

    def counting(self, iteration, epoch=0, dtype=torch.float32):
        calls.append((iteration, epoch))
        return real(self, iteration, epoch, dtype)

    monkeypatch.setattr(tupd.Adam, "scalars", counting)
    (x, y), = _images(1, "float32", seed=6)
    tnet.fit_steps(x[None].repeat(2, 0), y[None].repeat(2, 0))
    assert len(calls) == 2                  # one a step, not one a layer
    it, ep = calls[0]
    assert it is tnet._iter_dev and ep is tnet._epoch_dev
    s = tupd.Adam(tsched.StepSchedule(1e-2, 0.5, 2)).scalars(
        torch.tensor(3, dtype=torch.int32), torch.tensor(0, dtype=torch.int32))
    assert all(isinstance(v, torch.Tensor) and v.dtype == torch.float32 for v in s.values())
    assert float(s["lr"]) == pytest.approx(5e-3)


def test_counters_upload_only_when_the_host_value_moves():
    _, tnet = _mln_twin(_lenet_conf(UPDATERS["Adam"](), "float32"))
    (x, y), = _images(1, "float32", seed=7)
    tnet.fit(x, y)
    before = counters.counter_uploads.value
    it = tnet._iter_dev
    for _ in range(3):
        tnet.fit_steps(x[None].repeat(2, 0), y[None].repeat(2, 0))
    assert counters.counter_uploads.value == before
    assert tnet._iter_dev is it and int(it) == tnet.iteration == 7
    tnet.iteration = 0                       # a manual reset
    tnet.fit(x, y)
    assert counters.counter_uploads.value == before + 1
    assert int(it) == tnet.iteration == 1


# ---------------------------------------------------------------------------
# a small ComputationGraph: residual add, BatchNorm, two heads, one masked
# ---------------------------------------------------------------------------

def _cg_conf(mod, updater, dtype):
    b = (mod.GraphBuilder().seed(4).updater(updater).dtype(dtype).add_inputs("in")
         .set_input_types(mod.InputType.feed_forward(6)))
    b.add_layer("a", mod.DenseLayer(n_out=8, activation="tanh"), "in")
    b.add_layer("bn", mod.BatchNormalizationLayer(), "a")
    b.add_layer("b", mod.DenseLayer(n_out=8, activation="identity"), "bn")
    b.add_vertex("res", mod.ElementWiseVertex(op="Add"), "a", "b")
    b.add_layer("cls", mod.OutputLayer(n_out=3, loss="mcxent", activation="softmax"), "res")
    b.add_layer("reg", mod.OutputLayer(n_out=2, loss="mse", activation="identity"), "res")
    return b.set_outputs("cls", "reg").build()


def _cg_twin(updater, dtype="float64"):
    jconf = _cg_conf(jnn, updater, dtype)
    jnet = jnn.ComputationGraph(jconf).init()
    tnet = tnn.ComputationGraph(tnn.ComputationGraphConfiguration.from_json(jconf.to_json()),
                                device="cpu").init()
    assert tnet.conf.to_json() == jconf.to_json()
    convert.params_from_jax(tnet, jax.tree_util.tree_map(np.asarray, jnet.params_))
    convert.state_from_jax(tnet, jax.tree_util.tree_map(np.asarray, jnet.state_))
    return jnet, tnet


def _cg_batches(n, seed, batch=5, dtype="float64"):
    rs = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        x = rs.randn(batch, 6).astype(dtype)
        y1 = np.eye(3, dtype=dtype)[rs.randint(0, 3, batch)]
        y2 = rs.randn(batch, 2).astype(dtype)
        m = (rs.rand(batch) > 0.4).astype(dtype)
        out.append((x, [y1, y2], [np.ones(batch, dtype), m]))
    return out


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_graph_fit_steps_with_a_masked_head_matches_jax(dtype):
    rtol = RTOL[dtype]
    jnet, tnet = _cg_twin(jupd.Adam(jsched.StepSchedule(1e-2, 0.5, 2)), dtype)
    carried = [t.data_ptr() for t in tnet._carry()]
    for seed in (1, 2):
        batch = _cg_batches(3, seed, dtype=dtype)
        xs = np.stack([x for x, _, _ in batch])
        ys = [np.stack([l[i] for _, l, _ in batch]) for i in range(2)]
        ms = [np.stack([m[i] for _, _, m in batch]) for i in range(2)]
        jl = np.asarray(jnet.fit_steps(xs, ys, ms))
        tl = tnet.fit_steps(xs, ys, ms)
        _close(tl.numpy(), jl, rtol, "block losses")
    _same_nets(jnet, tnet, rtol)
    assert [t.data_ptr() for t in tnet._carry()] == carried


def test_graph_fit_over_an_iterator_two_epochs_matches_jax():
    jnet, tnet = _cg_twin(jupd.Nesterovs(0.05, 0.9))
    batches = _cg_batches(4, seed=5)
    seen, ends = [], []

    class Listen:
        def iteration_done(self, model, iteration, epoch):
            seen.append((iteration, epoch))

        def on_epoch_end(self, model):
            ends.append(model.epoch)

    tnet.set_listeners(Listen())
    jnet.fit(JList([JDataSet(x, y, labels_mask=m) for x, y, m in batches]), epochs=2)
    tnet.fit(ListDataSetIterator([DataSet(x, y, labels_mask=m) for x, y, m in batches]),
             epochs=2)
    assert (tnet.iteration, tnet.epoch) == (8, 2)
    assert seen == [(i + 1, i // 4) for i in range(8)] and ends == [1, 2]
    _close(tnet.score(), jnet.score(), RTOL["float64"], "last loss")
    assert isinstance(tnet.score_array(), torch.Tensor)
    _same_nets(jnet, tnet, RTOL["float64"])
    x = batches[0][0]
    jacts = jnet.feed_forward(x)
    tacts = tnet.feed_forward(x)
    assert set(tacts) == set(jacts)
    for n in jacts:
        _close(tacts[n].numpy(), np.asarray(jacts[n]), RTOL["float64"], f"feed_forward {n}")


def test_graph_fused_fit_with_a_tail_matches_jax():
    jnet, tnet = _cg_twin(jupd.Adam(jsched.StepSchedule(1e-2, 0.5, 2)))
    batches = _cg_batches(7, seed=9)
    jnet.fit(JList([JDataSet(x, y, labels_mask=m) for x, y, m in batches]), fused_steps=3)
    tnet.fit(ListDataSetIterator([DataSet(x, y, labels_mask=m) for x, y, m in batches]),
             fused_steps=3)
    _close(tnet.score(), jnet.score(), RTOL["float64"], "last loss")
    _same_nets(jnet, tnet, RTOL["float64"])
    ins = tnet._instruments()
    assert ins.compiles.value == 0           # no CUDA graph on the CPU


def test_graph_normalizer_folds_into_step_and_output():
    from deeplearning4j_tpu_torch.data import NormalizerStandardize
    _, a = _cg_twin(jupd.Adam(1e-2))
    b = tnn.ComputationGraph(tnn.ComputationGraphConfiguration.from_json(a.conf.to_json()),
                             device="cpu").init()
    b.load_state_dict(a.state_dict())
    batches = _cg_batches(3, seed=3)
    nz = NormalizerStandardize().fit(ListDataSetIterator(
        [DataSet(x, y[0]) for x, y, _ in batches]))
    a.set_normalizer(nz)
    for x, y, m in batches:
        a.fit(x, y)
        host = nz.transform(DataSet(x.copy(), y[0])).features
        b.fit(host.astype(np.float64), y)
    for (n, p), (_, q) in zip(a.state_dict().items(), b.state_dict().items()):
        assert torch.equal(p, q), n
    x = batches[0][0]
    host = nz.transform(DataSet(x.copy(), None)).features.astype(np.float64)
    assert torch.equal(a.output(x)[0], b.output(host)[0])
    with pytest.raises(ValueError, match="unknown network inputs"):
        a.set_normalizer({"nope": nz})


def test_a_dropout_generator_that_cannot_be_registered_raises():
    """A graph without `register_generator_state` would replay the masks
    drawn at capture: the graph path raises instead."""
    from deeplearning4j_tpu_torch.utils.scan_fit import register_generator
    gen = torch.Generator()
    with pytest.raises(RuntimeError, match="register_generator_state"):
        register_generator(object(), gen)
    seen = []

    class Graph:
        def register_generator_state(self, g):
            seen.append(g)

    register_generator(Graph(), gen)
    assert seen == [gen]
