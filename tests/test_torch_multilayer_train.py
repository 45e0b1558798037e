"""MultiLayerNetwork training in the PyTorch port against the JAX package.

Every check starts from parameters the JAX package initialized, carried
over with `convert.params_from_jax`, and feeds both packages the same numpy
inputs made from a seed.  Unless a test says otherwise it runs in f64 on
the CPU, and losses, parameters, BatchNorm running statistics and updater
state must agree within 1e-10 relative (max|diff| <= 1e-10 * max|ref| per
tensor).  The networks are configured once, in the JAX package, and cross
to the port as their JSON.  The first Dense layer before a BatchNorm has
no bias: its gradient is zero by construction, and Adam-like updaters
would turn the rounding noise in it into full steps.
"""
import torch_test_threads  # noqa: F401  (first: one torch thread a worker)
import jax
import numpy as np
import pytest
import torch

from deeplearning4j_tpu import nn as jnn
from deeplearning4j_tpu import zoo as jzoo
from deeplearning4j_tpu.data.dataset import DataSet as JDataSet
from deeplearning4j_tpu.data.iterators import ListDataSetIterator as JList
from deeplearning4j_tpu.train import schedules as jsched
from deeplearning4j_tpu.train import updaters as jupd
from deeplearning4j_tpu_torch import convert
from deeplearning4j_tpu_torch import zoo as tzoo
from deeplearning4j_tpu_torch.data import DataSet, ListDataSetIterator
from deeplearning4j_tpu_torch.nn import (MultiLayerConfiguration,
                                         MultiLayerNetwork)
from deeplearning4j_tpu_torch.ops.kernels import dispatch, matmul

RTOL = 1e-10


def _close(got, want, rtol=RTOL, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    scale = max(float(np.abs(want).max()), 1e-300) if want.size else 1.0
    err = float(np.abs(got - want).max()) if want.size else 0.0
    assert err <= rtol * scale, f"{what}: max|diff| {err} > {rtol} * {scale}"


def _twin(jconf):
    """The JAX network for `jconf` and the port's, from the JAX one's
    JSON, carrying the JAX parameters and state over."""
    jnet = jnn.MultiLayerNetwork(jconf).init()
    tnet = MultiLayerNetwork(MultiLayerConfiguration.from_json(jconf.to_json()),
                             device="cpu").init()
    convert.params_from_jax(tnet, jax.tree_util.tree_map(np.asarray, jnet.params_))
    convert.state_from_jax(tnet, jax.tree_util.tree_map(np.asarray, jnet.state_))
    return jnet, tnet


def _same_nets(jnet, tnet, rtol=RTOL):
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
    assert jax.tree_util.tree_structure(to) == jax.tree_util.tree_structure(jo)
    for path_a, b in zip(jax.tree_util.tree_leaves_with_path(jo),
                         jax.tree_util.tree_leaves(to)):
        _close(b, path_a[1], rtol, f"updater {jax.tree_util.keystr(path_a[0])}")
    assert tnet.iteration == jnet.iteration and tnet.epoch == jnet.epoch


def _batches(shape, classes, n, seed, batch=6):
    rs = np.random.RandomState(seed)
    return [(rs.randn(batch, *shape), np.eye(classes)[rs.randint(0, classes, batch)])
            for _ in range(n)]


def _fit_both(jnet, tnet, batches, rtol=RTOL, **masks):
    for x, y in batches:
        jnet.fit(x, y, **masks)
        tnet.fit(x, y, **masks)
        _close(tnet.score(), jnet.score(), rtol, "loss")


# ---------------------------------------------------------------------------
# LeNet at full width
# ---------------------------------------------------------------------------

def _lenet_conf():
    conf = jzoo.LeNet().conf()
    conf.dtype = "float64"
    return conf


@pytest.fixture(scope="module")
def lenet_trained():
    jnet, tnet = _twin(_lenet_conf())
    rs = np.random.RandomState(0)
    batches = [(rs.rand(4, 28, 28, 1), np.eye(10)[rs.randint(0, 10, 4)])
               for _ in range(3)]
    losses = []
    for x, y in batches:
        jnet.fit(x, y)
        tnet.fit(x, y)
        losses.append((tnet.score(), jnet.score()))
    return jnet, tnet, losses


def test_lenet_three_adam_steps_match_jax(lenet_trained):
    jnet, tnet, losses = lenet_trained
    assert tnet.num_params() == 431_080
    for got, want in losses:
        _close(got, want, what="loss")
    _same_nets(jnet, tnet)
    conv_m = convert.opt_state_to_jax(tnet)["layer_0"]["m"]["W"]
    assert conv_m.shape == (5, 5, 1, 20)                    # HWIO in the JAX tree
    assert tuple(tnet.opt_state_["layer_0"]["m"]["W"].shape) == (20, 1, 5, 5)


def test_lenet_eval_reads_match_jax(lenet_trained):
    jnet, tnet, _ = lenet_trained
    rs = np.random.RandomState(5)
    x, y = rs.rand(3, 28, 28, 1), np.eye(10)[rs.randint(0, 10, 3)]
    _close(tnet.score_for(x, y), jnet.score_for(x, y), what="score_for")
    jg = jnet.gradient_for(x, y)
    tg = tnet.gradient_for(x, y)
    for n in jg:
        for k in jg[n]:
            got = convert.to_jax_layout(tnet.layer_by_name(n), k, tg[n][k])
            _close(got, jg[n][k], what=f"gradient {n}.{k}")
    for got, want in zip(tnet.feed_forward(x), jnet.feed_forward(x)):
        _close(got.numpy(), want, what="feed_forward")
    _close(tnet.output(x).numpy(), jnet.output(x), what="output")


def test_fit_sends_the_dense_layer_through_the_kernel_route(monkeypatch):
    """With dispatch answering "kernel", LeNet's 500-wide relu Dense runs
    through `FusedDense` (its launcher patched to the plain version):
    once per fit step, score_for, output and gradient_for.  The result is
    bitwise the plain route's."""
    conf = jzoo.LeNet().conf()
    rs = np.random.RandomState(1)
    x = rs.rand(4, 28, 28, 1).astype(np.float32)
    y = np.eye(10, dtype=np.float32)[rs.randint(0, 10, 4)]

    def build():
        return MultiLayerNetwork(MultiLayerConfiguration.from_json(conf.to_json()),
                                 device="cpu").init()

    plain = build()
    for _ in range(2):
        plain.fit(x, y)
    calls = []

    def launch(x_, w, bias, activation):
        calls.append((tuple(x_.shape), tuple(w.shape), activation))
        return matmul.fused_dense_reference(x_, w, bias, activation)

    monkeypatch.setattr(dispatch, "resolve", lambda name, *a, **kw: "kernel")
    monkeypatch.setattr(matmul, "_launch", launch)
    net = build()
    for _ in range(2):
        net.fit(x, y)
    assert calls == [((4, 800), (800, 500), "relu")] * 2
    net.score_for(x, y)
    net.output(x)
    net.gradient_for(x, y)
    assert len(calls) == 5
    np.testing.assert_array_equal(net.params(), plain.params())
    assert net.score() == plain.score()


# ---------------------------------------------------------------------------
# a small MLN: Dense tanh (no bias), BatchNorm, Dense relu, Output
# ---------------------------------------------------------------------------

UPDATERS = {
    "Sgd": jupd.Sgd(0.1),
    "NoOp": jupd.NoOp(),
    "Nesterovs": jupd.Nesterovs(0.1, 0.9),
    "Adam": jupd.Adam(1e-2),
    "AdamW": jupd.AdamW(1e-2, weight_decay=0.05),
    "AMSGrad": jupd.AMSGrad(1e-2),
    "Nadam": jupd.Nadam(1e-2),
    "AdaMax": jupd.AdaMax(1e-2),
    "AdaGrad": jupd.AdaGrad(0.1),
    "RmsProp": jupd.RmsProp(0.05),
    "AdaDelta": jupd.AdaDelta(rho=0.9),
    "Adam_on_StepSchedule": jupd.Adam(jsched.StepSchedule(1e-2, 0.5, 2)),
}
OPTIONS = {
    "l1_l2_weight_decay": dict(conf=dict(l1=1e-3, l2=2e-3, weight_decay=5e-3),
                               layer2=dict(l2=1e-2)),
    "frozen_layer": dict(layer2=dict(frozen=True)),
    "per_layer_updater": dict(layer0=dict(updater=jupd.Nesterovs(0.05, 0.8))),
    "per_layer_gradient_normalization": dict(
        layer2=dict(gradient_normalization="ClipElementWiseAbsoluteValue",
                    gradient_normalization_threshold=0.05)),
}
for _mode in ("RenormalizeL2PerLayer", "RenormalizeL2PerParamType",
              "ClipElementWiseAbsoluteValue", "ClipL2PerLayer", "ClipL2PerParamType"):
    OPTIONS[_mode] = dict(conf=dict(gradient_normalization=(_mode, 0.3)))
CASES = [(name, {}) for name in UPDATERS] + [("Adam", o) for o in OPTIONS.values()]
IDS = list(UPDATERS) + [f"Adam-{o}" for o in OPTIONS]


def _small_conf(updater, conf=(), layer0=(), layer2=(), dtype="float64",
                compute_dtype=None, dropout=None, remat=False):
    conf, layer0, layer2 = dict(conf), dict(layer0), dict(layer2)
    b = jnn.NeuralNetConfiguration.builder().seed(3).updater(updater).dtype(dtype)
    for k in ("l1", "l2", "weight_decay"):
        if k in conf:
            getattr(b, k)(conf[k])
    if "gradient_normalization" in conf:
        b.gradient_normalization(*conf["gradient_normalization"])
    if compute_dtype:
        b.compute_dtype(compute_dtype)
    if remat:
        b.gradient_checkpointing(True)
    return b.list([
        jnn.DenseLayer(n_out=8, activation="tanh", has_bias=False, **layer0),
        jnn.BatchNormalizationLayer(),
        jnn.DenseLayer(n_out=6, activation="relu", dropout=dropout, **layer2),
        jnn.OutputLayer(n_out=3, loss="mcxent", activation="softmax"),
    ]).set_input_type(jnn.InputType.feed_forward(5)).build()


@pytest.mark.parametrize("upd,opts", CASES, ids=IDS)
def test_small_mln_four_steps_match_jax(upd, opts):
    jnet, tnet = _twin(_small_conf(UPDATERS[upd], **opts))
    assert tnet.conf.to_json() == jnet.conf.to_json()
    _fit_both(jnet, tnet, _batches((5,), 3, 4, seed=11))
    _same_nets(jnet, tnet)
    # the BatchNorm running statistics moved off their initial values
    assert np.abs(convert.state_to_jax(tnet)["layer_1"]["mean"]).max() > 0
    if opts.get("layer2", {}).get("frozen"):
        fresh = _twin(_small_conf(UPDATERS[upd], **opts))[1]
        for k, v in tnet.params_["layer_2"].items():
            assert torch.equal(v, fresh.params_["layer_2"][k])


def test_bf16_compute_keeps_f32_master_params_within_a_bf16_budget():
    """bf16 compute rounds activations and parameters to 8 bits of
    mantissa; over four steps the losses stay within 2e-2 relative of the
    JAX package's bf16 run, and the master parameters stay f32."""
    jnet, tnet = _twin(_small_conf(jupd.Adam(1e-2), dtype="float32",
                                   compute_dtype="bfloat16"))
    batches = [(x.astype(np.float32), y.astype(np.float32))
               for x, y in _batches((5,), 3, 4, seed=12)]
    _fit_both(jnet, tnet, batches, rtol=2e-2)
    assert all(p.dtype == torch.float32 for p in tnet.parameters())
    assert tnet.output(batches[0][0]).dtype == torch.bfloat16


def test_dropout_retain_one_equals_no_dropout_and_matches_jax():
    batches = _batches((5,), 3, 3, seed=13)
    jnet, tnet = _twin(_small_conf(jupd.Adam(1e-2), dropout=1.0))
    _, plain = _twin(_small_conf(jupd.Adam(1e-2)))
    for x, y in batches:
        tnet.fit(x, y)
        plain.fit(x, y)
        jnet.fit(x, y)
        assert tnet.score() == plain.score()
        _close(tnet.score(), jnet.score(), what="loss")
    np.testing.assert_array_equal(tnet.params(), plain.params())


def test_dropout_keeps_half_and_scales_kept_values_by_two():
    conf = (jnn.NeuralNetConfiguration.builder().seed(4).dtype("float64")
            .list([jnn.DropoutLayer(dropout=0.5),
                   jnn.OutputLayer(n_out=3, loss="mcxent", activation="softmax")])
            .set_input_type(jnn.InputType.feed_forward(400)).build())
    tnet = MultiLayerNetwork(MultiLayerConfiguration.from_json(conf.to_json()),
                             device="cpu").init()
    x = torch.rand(50, 400, dtype=torch.float64) + 0.5
    y, _ = tnet._forward(tnet.params_, tnet.state_, x, train=True, rng=tnet._rng,
                         upto=1)
    kept = y != 0
    n = kept.numel()
    share = kept.double().mean().item()
    assert abs(share - 0.5) <= 3 * (0.25 / n) ** 0.5
    assert torch.equal(y[kept], x[kept] * 2)
    again, _ = tnet._forward(tnet.params_, tnet.state_, x, train=True,
                             rng=tnet._rng, upto=1)
    assert not torch.equal(again, y)                        # a new mask each draw
    assert torch.equal(tnet.output(x), tnet.output(x))     # none at inference


def test_remat_equals_no_remat_bitwise():
    """Gradient checkpointing recomputes each layer in the backward with
    the same dropout masks: the run is bitwise the one without it."""
    batches = _batches((5,), 3, 3, seed=14)
    nets = [_twin(_small_conf(jupd.Adam(1e-2), dropout=0.7, remat=r))[1]
            for r in (False, True)]
    for x, y in batches:
        for net in nets:
            net.fit(x, y)
        assert nets[0].score() == nets[1].score()
    np.testing.assert_array_equal(nets[0].params(), nets[1].params())
    for k in ("mean", "var"):
        assert torch.equal(nets[0].state_["layer_1"][k], nets[1].state_["layer_1"][k])


# ---------------------------------------------------------------------------
# masks
# ---------------------------------------------------------------------------

def _seq_conf(pool):
    layers = [jnn.DenseLayer(n_out=7, activation="tanh")]
    if pool:
        layers.append(jnn.GlobalPoolingLayer(pooling_type="AVG"))
    layers.append(jnn.OutputLayer(n_out=3, loss="mcxent", activation="softmax"))
    return (jnn.NeuralNetConfiguration.builder().seed(5).updater(jupd.Adam(1e-2))
            .dtype("float64").list(layers)
            .set_input_type(jnn.InputType.recurrent(4, 6)).build())


def _seq_data(seed, pool):
    rs = np.random.RandomState(seed)
    x = rs.randn(5, 6, 4)
    mask = (np.arange(6)[None, :] < rs.randint(2, 7, (5, 1))).astype(np.float64)
    y = np.eye(3)[rs.randint(0, 3, 5 if pool else (5, 6))]
    return x, y, mask


@pytest.mark.parametrize("pool", [True, False], ids=["features_mask", "labels_mask"])
def test_masks_through_fit_and_score_for_match_jax(pool):
    """features_mask reaches the time pooling (and stops there);
    labels_mask weights a per-step loss."""
    jnet, tnet = _twin(_seq_conf(pool))
    key = "features_mask" if pool else "labels_mask"
    for step in range(3):
        x, y, mask = _seq_data(20 + step, pool)
        jnet.fit(x, y, **{key: mask})
        tnet.fit(x, y, **{key: mask})
        _close(tnet.score(), jnet.score(), what="loss")
    _same_nets(jnet, tnet)
    x, y, mask = _seq_data(30, pool)
    want = jnet.score_for(x, y, **{key: mask})
    _close(tnet.score_for(x, y, **{key: mask}), want, what="score_for")
    assert abs(tnet.score_for(x, y) - want) > 1e-6        # the mask mattered


# ---------------------------------------------------------------------------
# fit over an iterator, listeners
# ---------------------------------------------------------------------------

class _Recorder:
    def __init__(self):
        self.calls = []

    def iteration_done(self, model, iteration, epoch):
        self.calls.append(("iteration", iteration, epoch, round(model.score(), 9)))

    def on_epoch_end(self, model):
        self.calls.append(("epoch_end", model.iteration, model.epoch))


def test_fit_iterator_two_epochs_matches_jax_losses_counters_and_listeners():
    jnet, tnet = _twin(_small_conf(jupd.Adam(1e-2)))
    data = _batches((5,), 3, 3, seed=15)
    jrec, trec = _Recorder(), _Recorder()
    jnet.set_listeners(jrec)
    tnet.set_listeners(trec)
    jlosses, tlosses = [], []
    jnet.add_listeners(type("L", (), {"iteration_done": lambda s, m, i, e:
                                      jlosses.append(m.score())})())
    tnet.add_listeners(type("L", (), {"iteration_done": lambda s, m, i, e:
                                      tlosses.append(m.score())})())
    jnet.fit(JList([JDataSet(x, y) for x, y in data]), epochs=2)
    tnet.fit(ListDataSetIterator([DataSet(x, y) for x, y in data]), epochs=2)
    assert (tnet.iteration, tnet.epoch) == (jnet.iteration, jnet.epoch) == (6, 2)
    assert len(tlosses) == len(jlosses) == 6
    for a, b in zip(tlosses, jlosses):
        _close(a, b, what="loss")
    assert [c[:3] for c in trec.calls] == [c[:3] for c in jrec.calls]
    assert [c[0] for c in trec.calls].count("epoch_end") == 2
    _same_nets(jnet, tnet)


def test_iterators_yield_the_jax_packages_batches():
    from deeplearning4j_tpu.data import iterators as jit_
    from deeplearning4j_tpu_torch.data import iterators as tit
    rs = np.random.RandomState(17)
    x, y = rs.randn(10, 3), rs.randn(10, 2)
    for kw in (dict(batch_size=4), dict(batch_size=3, shuffle=True, seed=5),
               dict(batch_size=4, drop_last=True)):
        j, t = jit_.ArrayDataSetIterator(x, y, **kw), tit.ArrayDataSetIterator(x, y, **kw)
        assert len(t) == len(j) and t.batch_size() == j.batch_size()
        for _ in range(2):                                   # a new order each epoch
            got, want = list(t), list(j)
            assert len(got) == len(want)
            for a, b in zip(got, want):
                np.testing.assert_array_equal(a.features, b.features)
                np.testing.assert_array_equal(a.labels, b.labels)
    lst = tit.ListDataSetIterator([DataSet(x, y)], batch_size=4)
    assert [d.num_examples() for d in lst] == [4, 4, 2] and lst.batch_size() == 4

    class Scale:
        def pre_process(self, ds):
            ds.features = ds.features * 2

    lst.set_pre_processor(Scale())
    np.testing.assert_array_equal(next(iter(lst)).features, x[:4] * 2)
    np.testing.assert_array_equal(next(iter(lst)).features, x[:4] * 2)   # not twice
    async_it = tit.AsyncDataSetIterator(tit.ArrayDataSetIterator(x, y, 3), queue_size=1)
    assert [d.num_examples() for d in async_it] == [3, 3, 3, 1]
    for _ in async_it:                                       # an early break
        break
    async_it.close()
    assert async_it.active_producers() == 0


def test_fit_on_cuda_tensors_the_kernel_refuses_raises(monkeypatch):
    """No fallback: where the Dense layer's inputs are CUDA tensors the
    kernel does not take (f64), fit raises and nothing is updated.  The
    device lookup is patched so the rule is checked without a card."""
    _, tnet = _twin(_small_conf(jupd.Adam(1e-2)))
    before = tnet.params()
    monkeypatch.setattr(dispatch, "_devices",
                        lambda args, kwargs: {torch.device("cuda", 0)})
    x, y = _batches((5,), 3, 1, seed=18)[0]
    with pytest.raises(ValueError, match="does not take these inputs"):
        tnet.fit(x, y)
    assert tnet.iteration == 0
    np.testing.assert_array_equal(tnet.params(), before)


def test_left_out_entry_points_raise_not_implemented():
    net = MultiLayerNetwork(MultiLayerConfiguration.from_json(
        _small_conf(jupd.Adam()).to_json()), device="cpu").init()
    x, y = _batches((5,), 3, 1, seed=16)[0]
    calls = [lambda: net.set_executable_cache(None),
             lambda: net.apply_schedule(None)]
    for call in calls:
        with pytest.raises(NotImplementedError, match="not ported yet"):
            call()
    # gradient sharing is ported (tests/test_torch_comms.py): None clears it
    assert net.set_gradient_sharing(None) is net and net.gradient_sharing is None
    assert net.iteration == 0


def test_entry_points_need_cuda_unless_asked_for_the_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tzoo.LeNet().init_model()
    net = tzoo.LeNet().init_model(device="cpu")
    net.save(str(tmp_path / "m.zip"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        MultiLayerNetwork.load(str(tmp_path / "m.zip"))


def test_verify_drive_script_on_the_cpu(tmp_path):
    """The end-to-end drive: Dense 10->32 relu, Output 2, Adam(1e-2),
    50 fits, save/load."""
    from deeplearning4j_tpu_torch.nn import (DenseLayer, InputType,
                                             NeuralNetConfiguration, OutputLayer)
    from deeplearning4j_tpu_torch.train import Adam
    x = np.random.randn(256, 10).astype(np.float32)
    y = np.eye(2, dtype=np.float32)[(x.sum(1) > 0).astype(int)]
    conf = (NeuralNetConfiguration.builder().seed(1).updater(Adam(1e-2))
            .list([DenseLayer(n_out=32, activation="relu"),
                   OutputLayer(n_out=2, loss="mcxent", activation="softmax")])
            .set_input_type(InputType.feed_forward(10)).build())
    net = MultiLayerNetwork(conf, device="cpu").init()
    before = net.score_for(x, y)
    for _ in range(50):
        net.fit(x, y)
    after = net.score_for(x, y)
    assert after < 0.5 * before
    net.save(str(tmp_path / "m.zip"))
    net2 = MultiLayerNetwork.load(str(tmp_path / "m.zip"), device="cpu")
    np.testing.assert_array_equal(net.params(), net2.params())
    assert net2.iteration == 50
    assert torch.equal(net.output(x), net2.output(x))
