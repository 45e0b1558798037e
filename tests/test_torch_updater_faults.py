"""Two updater faults of the PyTorch port, held against the JAX package.

- Weight decay scales by the updater's learning rate, as the JAX
  package's ``lr_at`` does; AdaDelta's is 0, so its decay adds nothing
  (it used to raise ``KeyError: 'lr'``).  Every updater with weight decay
  on, one `fit` over an iterator, MultiLayerNetwork and ComputationGraph.
- The Adam family's alpha is formed in the dtype the JAX package promotes
  it to: f64 under an ``ExponentialSchedule`` in an f64 network (a
  strongly typed f64 learning rate), f32 otherwise.

Both start from the JAX package's initial parameters, in f64, and agree
within 1e-10 relative per tensor (parameters, layer state, updater state).
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
from deeplearning4j_tpu_torch.train import schedules as tsched
from deeplearning4j_tpu_torch.train import updaters as tupd

RTOL = 1e-10

UPDATERS = {
    "Sgd": lambda lr: jupd.Sgd(lr),
    "NoOp": lambda lr: jupd.NoOp(),
    "Nesterovs": lambda lr: jupd.Nesterovs(lr, 0.9),
    "Adam": lambda lr: jupd.Adam(lr),
    "AdamW": lambda lr: jupd.AdamW(lr, weight_decay=0.05),
    "AMSGrad": lambda lr: jupd.AMSGrad(lr),
    "Nadam": lambda lr: jupd.Nadam(lr),
    "AdaMax": lambda lr: jupd.AdaMax(lr),
    "AdaGrad": lambda lr: jupd.AdaGrad(lr),
    "RmsProp": lambda lr: jupd.RmsProp(lr),
    "AdaDelta": lambda lr: jupd.AdaDelta(rho=0.9),
}


def _close(got, want, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    scale = max(float(np.abs(want).max()), 1e-300) if want.size else 1.0
    err = float(np.abs(got - want).max()) if want.size else 0.0
    assert err <= RTOL * scale, f"{what}: max|diff| {err} > {RTOL} * {scale}"


def _same_nets(jnet, tnet):
    jp = jax.tree_util.tree_map(np.asarray, jnet.params_)
    tp = convert.params_to_jax(tnet)
    for n in jp:
        for k in jp[n]:
            _close(tp[n][k], jp[n][k], f"params {n}.{k}")
    jo = jax.tree_util.tree_map(np.asarray, jnet.opt_state_)
    to = convert.opt_state_to_jax(tnet)
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(jo),
                            jax.tree_util.tree_leaves(to)):
        _close(b, a, f"updater {jax.tree_util.keystr(path)}")
    _close(tnet.score(), jnet.score(), "last loss")
    assert (tnet.iteration, tnet.epoch) == (jnet.iteration, jnet.epoch)


def _probe_layers(mod):
    """The probe net: a 3x3 conv, an average pool, a Dense and a softmax
    output, on 8x8x2 images."""
    return [mod.ConvolutionLayer(n_out=4, kernel_size=3, activation="tanh"),
            mod.SubsamplingLayer(kernel_size=2, stride=2, pooling_type="avg"),
            mod.DenseLayer(n_out=6, activation="tanh"),
            mod.OutputLayer(n_out=3, loss="mcxent", activation="softmax")]


def _mln(mod, updater, weight_decay):
    b = mod.NeuralNetConfiguration.builder().seed(3).updater(updater).dtype("float64")
    if weight_decay:
        b = b.weight_decay(weight_decay)
    return (b.list(_probe_layers(mod))
            .set_input_type(mod.InputType.convolutional(8, 8, 2)).build())


def _cg(mod, updater, weight_decay):
    b = (mod.GraphBuilder().seed(3).updater(updater).dtype("float64")
         .weight_decay(weight_decay).add_inputs("in")
         .set_input_types(mod.InputType.convolutional(8, 8, 2)))
    prev = "in"
    for i, layer in enumerate(_probe_layers(mod)):
        b.add_layer(f"l{i}", layer, prev)
        prev = f"l{i}"
    return b.set_outputs(prev).build()


def _twin(kind, updater, weight_decay):
    if kind == "mln":
        jconf = _mln(jnn, updater, weight_decay)
        jnet = jnn.MultiLayerNetwork(jconf).init()
        tnet = tnn.MultiLayerNetwork(
            tnn.MultiLayerConfiguration.from_json(jconf.to_json()), device="cpu").init()
    else:
        jconf = _cg(jnn, updater, weight_decay)
        jnet = jnn.ComputationGraph(jconf).init()
        tnet = tnn.ComputationGraph(
            tnn.ComputationGraphConfiguration.from_json(jconf.to_json()), device="cpu").init()
    assert tnet.conf.to_json() == jconf.to_json()
    convert.params_from_jax(tnet, jax.tree_util.tree_map(np.asarray, jnet.params_))
    return jnet, tnet


def _batches(n, seed=7, batch=4):
    rs = np.random.RandomState(seed)
    return [(rs.randn(batch, 8, 8, 2), np.eye(3)[rs.randint(0, 3, batch)])
            for _ in range(n)]


def _fit_both(jnet, tnet, batches, epochs=1):
    jnet.fit(JList([JDataSet(x, y) for x, y in batches]), epochs=epochs)
    tnet.fit(ListDataSetIterator([DataSet(x, y) for x, y in batches]), epochs=epochs)


@pytest.mark.parametrize("kind", ["mln", "cg"])
@pytest.mark.parametrize("name", sorted(UPDATERS))
def test_every_updater_with_weight_decay_trains_as_jax(name, kind):
    assert set(UPDATERS) == set(tupd.UPDATERS)
    jnet, tnet = _twin(kind, UPDATERS[name](2e-2), weight_decay=2e-3)
    _fit_both(jnet, tnet, _batches(3))
    _same_nets(jnet, tnet)


def test_adadelta_weight_decay_adds_nothing():
    """AdaDelta's learning rate is 0: with weight decay on, it takes the
    same steps as without it."""
    batches = _batches(3)
    _, with_wd = _twin("mln", jupd.AdaDelta(rho=0.9), weight_decay=5e-2)
    _, without = _twin("mln", jupd.AdaDelta(rho=0.9), weight_decay=0.0)
    for net in (with_wd, without):
        net.fit(ListDataSetIterator([DataSet(x, y) for x, y in batches]))
    for (n, a), (_, b) in zip(with_wd.state_dict().items(), without.state_dict().items()):
        assert np.array_equal(a.numpy(), b.numpy()), n


SCHEDULES = {
    "exp_iteration": lambda: jsched.ExponentialSchedule(1e-2, 0.97),
    "exp_epoch": lambda: jsched.ExponentialSchedule(1e-2, 0.6, "EPOCH"),
}


@pytest.mark.parametrize("sched", sorted(SCHEDULES))
@pytest.mark.parametrize("name", ["Adam", "AdamW", "AMSGrad", "AdaMax"])
def test_adam_family_alpha_follows_a_strong_f64_schedule(name, sched):
    """7 steps over two epochs (4 + 3 batches), so the EPOCH schedule moves."""
    jnet, tnet = _twin("mln", UPDATERS[name](SCHEDULES[sched]()), weight_decay=0.0)
    batches = _batches(4, seed=11)
    _fit_both(jnet, tnet, batches, epochs=1)
    _fit_both(jnet, tnet, batches[:3], epochs=1)
    _same_nets(jnet, tnet)


def test_alpha_dtype_follows_the_schedule():
    c = torch.tensor(3, dtype=torch.int32)
    exp, step = tsched.ExponentialSchedule(1e-2, 0.9), tsched.StepSchedule(1e-2, 0.5, 2)
    for upd in (tupd.Adam, tupd.AdamW, tupd.AMSGrad, tupd.AdaMax):
        assert upd(exp).scalars(c, c, torch.float64)["alpha"].dtype == torch.float64
        assert upd(exp).scalars(c, c, torch.float32)["alpha"].dtype == torch.float32
        assert upd(step).scalars(c, c, torch.float64)["alpha"].dtype == torch.float32
        assert upd(1e-2).scalars(c, c, torch.float64)["alpha"].dtype == torch.float32
