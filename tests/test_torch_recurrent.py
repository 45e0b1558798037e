"""The recurrent layers of the PyTorch port against the JAX package.

Every class of ``nn/recurrent.py`` (SimpleRnn, LSTM, GRU, GravesLSTM,
Bidirectional in its four modes with and without ``return_last``,
LastTimeStep, RnnOutputLayer, RnnLossLayer) starts from parameters the JAX
package initialized, carried over as numpy, and runs on the same numpy
inputs from a seed, with no mask, a tail mask and a mask with a gap in the
middle: the forward and the gradients of a fixed projection of it agree
within 1e-10 * max|ref| in f64, and one ``fit`` step of a network around
the layer leaves the same parameters and updater state.  Also the JSON
before and after ``init()`` (Bidirectional sets its inner layers'
``weight_init``), the nested ``{"fwd", "bwd"}`` parameter tree through
``params()``, ``set_params`` and the shared zip, LastTimeStep on a
non-contiguous mask and an all-padding row, and an RnnOutputLayer head of
a ComputationGraph taking its labels mask.
"""
import torch_test_threads  # noqa: F401  (first: one torch thread a worker)
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu import nn as jnn
from deeplearning4j_tpu.data.dataset import DataSet as JDataSet
from deeplearning4j_tpu.data.iterators import ListDataSetIterator as JList
from deeplearning4j_tpu.nn import recurrent as jrec
from deeplearning4j_tpu.train import updaters as jupd
from deeplearning4j_tpu_torch import convert
from deeplearning4j_tpu_torch import nn as tnn
from deeplearning4j_tpu_torch.data import DataSet, ListDataSetIterator
from deeplearning4j_tpu_torch.nn import recurrent as trec
from deeplearning4j_tpu_torch.train import updaters as tupd

RTOL = 1e-10
B, T, F, H = 3, 6, 4, 5


def _close(got, want, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, f"{what}: {got.shape} vs {want.shape}"
    scale = max(float(np.abs(want).max()), 1e-300) if want.size else 1.0
    err = float(np.abs(got - want).max()) if want.size else 0.0
    assert err <= RTOL * scale, f"{what}: max|diff| {err} > {RTOL} * {scale}"


def _masks():
    tail = np.ones((B, T))
    tail[1, 4:] = 0
    tail[2, 2:] = 0
    gap = np.ones((B, T))
    gap[0, 2:4] = 0
    gap[2, 1] = 0
    gap[2, 4:] = 0
    return {"none": None, "tail": tail, "gap": gap}


MASKS = _masks()


@pytest.fixture(autouse=True)
def numpy_init(monkeypatch):
    """The JAX package's weight initializer replaced, for these tests only,
    by scaled normals from numpy: its threefry draw compiles once per
    weight shape (~0.4 s each), and the parity tests copy the JAX net's
    initial parameters into the port whatever they are."""
    from deeplearning4j_tpu.nn import layers as jlayers
    rs = np.random.RandomState(0)

    def init(key, shape, scheme, dtype=jnp.float32, dist_params=None):
        return jnp.asarray(rs.randn(*shape) / np.sqrt(float(shape[0])), dtype)

    monkeypatch.setattr(jlayers, "init_weights", init)
    monkeypatch.setattr(jrec, "init_weights", init)


def _pair(name, **kw):
    """The same layer config in both packages."""
    jcls, tcls = getattr(jrec, name), getattr(trec, name)
    return jcls(**kw), tcls(**kw)


def _wrapped(kind, mode="CONCAT", return_last=False):
    inner = dict(n_out=H, activation="tanh")
    if kind == "Bidirectional":
        return (jrec.Bidirectional(fwd=jrec.LSTM(**inner), mode=mode, return_last=return_last),
                trec.Bidirectional(fwd=trec.LSTM(**inner), mode=mode, return_last=return_last))
    return (jrec.LastTimeStep(underlying=jrec.GRU(**inner)),
            trec.LastTimeStep(underlying=trec.GRU(**inner)))


LAYERS = {
    "SimpleRnn": lambda: _pair("SimpleRnn", n_out=H, activation="tanh"),
    "LSTM": lambda: _pair("LSTM", n_out=H, activation="tanh", forget_gate_bias_init=0.5),
    "GRU": lambda: _pair("GRU", n_out=H, activation="tanh"),
    "GravesLSTM": lambda: _pair("GravesLSTM", n_out=H, activation="tanh"),
    "LastTimeStep": lambda: _wrapped("LastTimeStep"),
    "RnnOutputLayer": lambda: _pair("RnnOutputLayer", n_out=H, activation="softmax"),
    "RnnLossLayer": lambda: _pair("RnnLossLayer", loss="mse", activation="tanh"),
}
for _mode in ("CONCAT", "ADD", "MUL", "AVERAGE"):
    for _last in (False, True):
        LAYERS[f"Bidirectional-{_mode}{'-last' if _last else ''}"] = (
            lambda m=_mode, r=_last: _wrapped("Bidirectional", m, r))


def _t(a):
    return None if a is None else torch.tensor(np.asarray(a))


def _params(jlayer, seed=0):
    """Parameters of the JAX layer's tree and shapes (``jax.eval_shape`` of
    its ``initialize``, which compiles nothing), drawn with numpy from a
    seed, f64; and its state."""
    p, s = jax.eval_shape(lambda k: jlayer.initialize(k, jnn.InputType.recurrent(F, T),
                                                      jnp.float64)[:2],
                          jax.random.PRNGKey(seed))
    rng = np.random.RandomState(seed + 1)
    p = jax.tree_util.tree_map(lambda a: 0.5 * rng.standard_normal(a.shape), p)
    return p, jax.tree_util.tree_map(lambda a: np.zeros(a.shape, a.dtype), s)


def _torch_tree(p):
    return jax.tree_util.tree_map(lambda a: torch.tensor(a, requires_grad=True), p)


@functools.lru_cache(maxsize=None)
def _jax_forward(kind):
    """(layer pair, numpy params, state, x, {mask: JAX output}): one jitted
    JAX program runs the three masks."""
    jl, tl = LAYERS[kind]()
    p, s = _params(jl)
    x = np.random.RandomState(2).standard_normal((B, T, F))
    run = jax.jit(lambda p_, x_, tail, gap: [jl.apply(p_, s, x_, mask=m)[0]
                                             for m in (None, tail, gap)])
    outs = run(p, x, MASKS["tail"], MASKS["gap"])
    return tl, p, s, x, {k: np.asarray(o) for k, o in zip(MASKS, outs)}


@pytest.mark.parametrize("mask", list(MASKS))
@pytest.mark.parametrize("kind", list(LAYERS))
def test_forward_matches_jax(kind, mask):
    tl, p, s, x, want = _jax_forward(kind)
    tl.initialize(torch.Generator().manual_seed(0), tnn.InputType.recurrent(F, T),
                  torch.float64, "cpu")               # Bidirectional builds its _bwd here
    got, new_state = tl.apply(_torch_tree(p), jax.tree_util.tree_map(np.asarray, s),
                              torch.tensor(x), mask=_t(MASKS[mask]))
    _close(got.detach().numpy(), want[mask], f"{kind} forward")
    assert jax.tree_util.tree_structure(new_state) == jax.tree_util.tree_structure(s)


def _same(jnet, tnet, what):
    jp = jax.tree_util.tree_map(np.asarray, jnet.params_)
    tp = convert.params_to_jax(tnet)
    assert jax.tree_util.tree_structure(tp) == jax.tree_util.tree_structure(jp)
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(jp),
                            jax.tree_util.tree_leaves(tp)):
        _close(b, a, f"{what} params {jax.tree_util.keystr(path)}")
    jo = jax.tree_util.tree_map(np.asarray, jnet.opt_state_)
    to = convert.opt_state_to_jax(tnet)
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(jo),
                            jax.tree_util.tree_leaves(to)):
        _close(b, a, f"{what} updater {jax.tree_util.keystr(path)}")


def _stack(mod, name):
    """Networks that hold every layer of the module, each seeing the mask:
    the sequence stacks end in a per-step head, the others in a
    feed-forward one."""
    rec = jrec if mod is jnn else trec
    seq_head = rec.RnnOutputLayer(n_out=3, loss="mcxent", activation="softmax")
    ff_head = mod.OutputLayer(n_out=3, loss="mcxent", activation="softmax")
    return {
        "recurrent": [rec.SimpleRnn(n_out=4), rec.GRU(n_out=5, activation="tanh"),
                      rec.GravesLSTM(n_out=4, activation="tanh"),
                      rec.LSTM(n_out=5, activation="tanh", forget_gate_bias_init=0.5),
                      seq_head],
        "last_step": [rec.Bidirectional(fwd=rec.LSTM(n_out=3, activation="tanh"),
                                        mode="ADD"),
                      rec.LastTimeStep(underlying=rec.GRU(n_out=4)), ff_head],
        "return_last": [rec.Bidirectional(fwd=rec.SimpleRnn(n_out=4), mode="MUL",
                                          return_last=True), ff_head],
        "loss_layer": [rec.Bidirectional(fwd=rec.SimpleRnn(n_out=3), mode="AVERAGE"),
                       rec.RnnLossLayer(loss="mcxent", activation="softmax")],
    }[name]


def _stack_conf(mod, name, updater):
    return (mod.NeuralNetConfiguration.builder().seed(9).weight_init("XAVIER")
            .dtype("float64").updater(updater).l2(1e-3)
            .list(_stack(mod, name)).set_input_type(mod.InputType.recurrent(F, T)).build())


def _stack_nets(name, jupdater, tupdater):
    jnet = jnn.MultiLayerNetwork(_stack_conf(jnn, name, jupdater)).init()
    tnet = tnn.MultiLayerNetwork(_stack_conf(tnn, name, tupdater), device="cpu").init()
    assert tnet.conf.to_json() == jnet.conf.to_json()
    convert.params_from_jax(tnet, jax.tree_util.tree_map(np.asarray, jnet.params_))
    return jnet, tnet


@pytest.mark.parametrize("name", ["recurrent", "last_step", "return_last", "loss_layer"])
def test_fit_steps_with_each_mask_match_jax(name):
    """One Sgd ``fit`` step without a mask, one with the tail mask and one
    with the gap mask (features and, for a per-step head, labels masks):
    the loss, every parameter (its update is lr times its gradient, l2
    included) and the updater state agree after each.  The JAX network
    takes an all-ones features mask where the port takes none (the same
    numbers: the held state is the new one, the output is multiplied by
    1), so one JAX program serves the three steps; a per-step head's
    labels mask is all ones in both at the first step (without one the
    loss sums over time instead of averaging)."""
    jnet, tnet = _stack_nets(name, jupd.Sgd(0.1), tupd.Sgd(0.1))
    rng = np.random.RandomState(5)
    x = rng.standard_normal((B, T, F))
    seq = name in ("recurrent", "loss_layer")
    y = np.eye(3)[rng.randint(0, 3, (B, T) if seq else (B,))]
    for mask in MASKS:
        m = MASKS[mask]
        jm = np.ones((B, T)) if m is None else m
        jnet.fit(x, y, features_mask=jm, labels_mask=jm if seq else None)
        tnet.fit(x, y, features_mask=m, labels_mask=jm if seq else None)
        _close(tnet.score(), jnet.score(), f"{name} {mask} loss")
        _same(jnet, tnet, f"{name} after the {mask} step")


def test_last_time_step_takes_the_last_nonzero_step():
    """A mask with a gap picks each row's last nonzero step; an all-padding
    row takes step T - 1, which the masked underlying output zeroes (the
    JAX package's semantics); Bidirectional's return_last gives zeros
    there."""
    jl, tl = _wrapped("LastTimeStep")
    p, s = _params(jl)
    x = np.random.RandomState(3).standard_normal((B, T, F))
    m = np.array([[1, 0, 1, 1, 0, 0], [0, 0, 0, 0, 0, 0], [1, 1, 0, 0, 0, 1]], np.float64)
    want = np.asarray(jax.jit(lambda p_, x_, m_: jl.apply(p_, s, x_, mask=m_)[0])(p, x, m))
    got = tl.apply(_torch_tree(p), s, torch.tensor(x), mask=torch.tensor(m))[0]
    _close(got.detach().numpy(), want, "LastTimeStep")
    assert np.all(want[1] == 0)
    full = tl.underlying.apply(_torch_tree(p), s, torch.tensor(x), mask=torch.tensor(m))[0]
    np.testing.assert_array_equal(got.detach().numpy()[[0, 2]],
                                  full.detach().numpy()[[0, 2], [3, 5]])
    # a bool or an int mask picks the same steps
    for dt in (torch.bool, torch.int32):
        again = tl.apply(_torch_tree(p), s, torch.tensor(x), mask=torch.tensor(m).to(dt))[0]
        _close(again.detach().numpy(), want, f"LastTimeStep {dt} mask")
    jb, tb = _wrapped("Bidirectional", "ADD", True)
    p, s = _params(jb)
    tb.initialize(torch.Generator().manual_seed(0), tnn.InputType.recurrent(F, T),
                  torch.float64, "cpu")
    want = np.asarray(jax.jit(lambda p_, x_, m_: jb.apply(p_, s, x_, mask=m_)[0])(p, x, m))
    got = tb.apply(_torch_tree(p), {"fwd": {}, "bwd": {}}, torch.tensor(x),
                   mask=torch.tensor(m))[0].detach().numpy()
    _close(got, want, "Bidirectional return_last")
    assert np.all(got[1] == 0)


def test_json_matches_jax_before_and_after_init():
    """Every stack's configuration, with Bidirectional's and LastTimeStep's
    nested layers: the same string before and after ``init()`` (which sets
    their inner layers' ``weight_init``), and back through ``from_json``."""
    for name in ("recurrent", "last_step", "return_last", "loss_layer"):
        jconf = _stack_conf(jnn, name, jupd.Adam(1e-2))
        tconf = _stack_conf(tnn, name, tupd.Adam(1e-2))
        assert tconf.to_json() == jconf.to_json()
        jnet = jnn.MultiLayerNetwork(jconf).init()
        tnet = tnn.MultiLayerNetwork(tconf, device="cpu").init()
        assert tconf.to_json() == jconf.to_json()
        back = tnn.MultiLayerConfiguration.from_json(jconf.to_json())
        assert back.to_json() == jconf.to_json()
        assert [type(l).__name__ for l in back.layers] == [type(l).__name__
                                                           for l in jconf.layers]
        assert tnet.num_params() == jnet.num_params()
    assert '"PEEPHOLE": true' in _stack_conf(tnn, "recurrent", tupd.Sgd(0.1)).to_json()
    conf = _stack_conf(tnn, "last_step", tupd.Sgd(0.1))
    assert json.loads(conf.to_json())["layers"][0]["fwd"]["weight_init"] is None
    tnn.MultiLayerNetwork(conf, device="cpu").init()
    inner = json.loads(conf.to_json())["layers"][0]["fwd"]
    assert inner["weight_init"] == "XAVIER" and inner["@layer"] == "LSTM"


def test_nested_params_cross_the_flat_vector_and_the_zip(tmp_path):
    """Bidirectional's {"fwd", "bwd"} tree: state_dict keys that follow
    it, ``params()`` in the JAX package's order, ``set_params`` back, an
    Adam step with a mask, and the zip written by either package loaded by
    the other with parameters and Adam state intact."""
    jnet, tnet = _stack_nets("last_step", jupd.Adam(1e-2), tupd.Adam(1e-2))
    np.testing.assert_array_equal(tnet.params(), np.asarray(jnet.params()))
    order = tnet._jax_leaves()
    assert order.index(("layer_0", "bwd.RW")) < order.index(("layer_0", "fwd.W"))
    assert ("layer_1", "RW") in order          # LastTimeStep keeps the inner keys
    assert {f"{n}.{k}" for n, k in order} == set(tnet.state_dict())
    rng = np.random.RandomState(7)
    x = rng.standard_normal((B, T, F))
    y = np.eye(3)[rng.randint(0, 3, B)]
    jnet.fit(x, y, features_mask=MASKS["gap"])
    tnet.fit(x, y, features_mask=MASKS["gap"])
    _close(tnet.score(), jnet.score(), "loss")
    _same(jnet, tnet, "after a masked Adam step")
    flat = tnet.params()
    tnet.set_params(flat[::-1].copy())
    np.testing.assert_array_equal(tnet.params(), flat[::-1])
    tnet.set_params(flat)

    jpath, tpath = str(tmp_path / "j.zip"), str(tmp_path / "t.zip")
    jnet.save(jpath)
    tnet.save(tpath)
    from_j = tnn.MultiLayerNetwork.load(jpath, device="cpu")
    from_t = jnn.MultiLayerNetwork.load(tpath)
    _same(jnet, from_j, "JAX zip in the port")
    _same(from_t, tnet, "port zip in JAX")
    assert from_j.conf.to_json() == jnet.conf.to_json()
    assert (from_j.iteration, from_t.iteration) == (1, 1)


def test_rnn_output_head_of_a_graph_takes_its_labels_mask():
    """A ComputationGraph of LSTM -> RnnOutputLayer: the JAX graph passes
    no features mask to its layers and the port adds none; the head's
    labels mask reaches the loss.  Two fit steps agree."""
    def conf(mod, rec, upd):
        return (mod.GraphBuilder().seed(2).dtype("float64").updater(upd.Adam(1e-2))
                .add_inputs("in")
                .add_layer("lstm", rec.LSTM(n_out=H, activation="tanh"), "in")
                .add_layer("out", rec.RnnOutputLayer(n_out=3, activation="softmax"), "lstm")
                .set_outputs("out")
                .set_input_types(mod.InputType.recurrent(F, T)).build())

    jnet = jnn.ComputationGraph(conf(jnn, jrec, jupd)).init()
    tnet = tnn.ComputationGraph(conf(tnn, trec, tupd), device="cpu").init()
    assert tnet.conf.to_json() == jnet.conf.to_json()
    convert.params_from_jax(tnet, jax.tree_util.tree_map(np.asarray, jnet.params_))
    rng = np.random.RandomState(8)
    x = rng.standard_normal((B, T, F))
    y = np.eye(3)[rng.randint(0, 3, (B, T))]
    lm = MASKS["gap"]
    unmasked = tnet.score_for([x], [y])
    jnet.fit(JList([JDataSet(x, y, labels_mask=lm)]), epochs=2)
    tnet.fit(ListDataSetIterator([DataSet(x, y, labels_mask=lm)]), epochs=2)
    _close(tnet.score(), jnet.score(), "graph loss")
    _same(jnet, tnet, "graph")
    first = tnn.ComputationGraph(conf(tnn, trec, tupd), device="cpu").init()
    convert.params_from_jax(first, jax.tree_util.tree_map(np.asarray, jnn.ComputationGraph(
        conf(jnn, jrec, jupd)).init().params_))
    first.fit(ListDataSetIterator([DataSet(x, y, labels_mask=lm)]))
    assert abs(first.score() - unmasked) > 1e-6          # the mask reached the loss
