"""TextGenLSTM, the char-LM of bench.py's LSTM block, in the PyTorch port
against the JAX package.

At a small width (vocab 11, T = 8, 8 units, f64): the configuration's
JSON, the forward, ``fit`` (with and without features and labels masks),
``fit_steps`` over a block of 3, ``fit(iterator, fused_steps=3)`` over
masked batches (two blocks and a tail step), ``output`` on a window
shorter than the configured T, ``score_for``, ``evaluate`` and the zip
written by either package and loaded by the other, each within 1e-10 *
max|ref|.  At full width the port's configuration is bench.py's
(``bench.py:404-417``): two LSTM(256) and a 77-way RnnOutputLayer, XAVIER
weights (compared with the JAX package's by distribution), forget gate
bias 1, Adam(1e-3).
"""
import torch_test_threads  # noqa: F401  (first: one torch thread a worker)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu import nn as jnn
from deeplearning4j_tpu.data.dataset import DataSet as JDataSet
from deeplearning4j_tpu.data.iterators import ListDataSetIterator as JList
from deeplearning4j_tpu.nn import recurrent as jrec
from deeplearning4j_tpu.ops.initializers import init_weights as j_init
from deeplearning4j_tpu.zoo import TextGenLSTM as JTextGenLSTM
from deeplearning4j_tpu_torch import convert
from deeplearning4j_tpu_torch import nn as tnn
from deeplearning4j_tpu_torch import zoo as tzoo
from deeplearning4j_tpu_torch.data import DataSet, ListDataSetIterator
from deeplearning4j_tpu_torch.ops.initializers import init_weights as t_init
from deeplearning4j_tpu_torch.train import Evaluation

RTOL = 1e-10
V, T, U, B = 11, 8, 8, 4


def _close(got, want, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, f"{what}: {got.shape} vs {want.shape}"
    scale = max(float(np.abs(want).max()), 1e-300)
    err = float(np.abs(got - want).max())
    assert err <= RTOL * scale, f"{what}: max|diff| {err} > {RTOL} * {scale}"


def _confs():
    kw = dict(n_classes=V, input_shape=(T, V), lstm_units=U)
    jconf, tconf = JTextGenLSTM(**kw).conf(), tzoo.TextGenLSTM(**kw).conf()
    jconf.dtype = tconf.dtype = "float64"
    return jconf, tconf


@pytest.fixture
def nets(monkeypatch):
    """A JAX TextGenLSTM and its port twin from the same initial
    parameters.  The JAX initializer draws from numpy for this fixture:
    its threefry draw compiles once per weight shape."""
    from deeplearning4j_tpu.nn import layers as jlayers
    rs = np.random.RandomState(0)

    def init(key, shape, scheme, dtype=jnp.float32, dist_params=None):
        return jnp.asarray(rs.randn(*shape) * np.sqrt(2.0 / sum(shape)), dtype)

    monkeypatch.setattr(jrec, "init_weights", init)
    monkeypatch.setattr(jlayers, "init_weights", init)
    jconf, tconf = _confs()
    jnet = jnn.MultiLayerNetwork(jconf).init()
    tnet = tnn.MultiLayerNetwork(tconf, device="cpu").init()
    convert.params_from_jax(tnet, jax.tree_util.tree_map(np.asarray, jnet.params_))
    return jnet, tnet


def _batch(seed, t=T):
    """bench.py's inputs: random ids, one-hot x, y the ids rolled by one."""
    idx = np.random.RandomState(seed).randint(0, V, (B, t))
    return np.eye(V)[idx], np.eye(V)[np.roll(idx, -1, 1)]


def _mask(seed, t=T):
    """Half the rows cut at a random length, one row with a gap."""
    rs = np.random.RandomState(100 + seed)
    m = np.ones((B, t))
    for b in range(0, B, 2):
        m[b, rs.randint(2, t):] = 0
    m[1, 1:3] = 0
    return m


def _same(jnet, tnet, what):
    jp = jax.tree_util.tree_map(np.asarray, jnet.params_)
    tp = convert.params_to_jax(tnet)
    for n in jp:
        for k in jp[n]:
            _close(tp[n][k], jp[n][k], f"{what} params {n}.{k}")
    jo = jax.tree_util.tree_map(np.asarray, jnet.opt_state_)
    to = convert.opt_state_to_jax(tnet)
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(jo),
                            jax.tree_util.tree_leaves(to)):
        _close(b, a, f"{what} updater {jax.tree_util.keystr(path)}")
    assert (tnet.iteration, tnet.epoch) == (jnet.iteration, jnet.epoch)


def test_config_json_matches_jax_before_and_after_init(nets):
    jconf, tconf = _confs()
    assert tconf.to_json() == jconf.to_json()
    jnet, tnet = nets                  # initialized: weight_init and activations set
    assert tnet.conf.to_json() == jnet.conf.to_json() != jconf.to_json()
    back = tnn.MultiLayerConfiguration.from_json(jnet.conf.to_json())
    assert back.to_json() == jnet.conf.to_json()
    assert "TextGenLSTM" in tzoo.ZOO_REGISTRY


def test_fit_fit_steps_output_and_score_match_jax(nets):
    """Two fit steps (unmasked, then masked), a fit_steps block of 3 with
    per-step masks, output on the full and on a shorter window, and
    score_for with masks."""
    jnet, tnet = nets
    x, y = _batch(0)
    _close(tnet.output(x), jnet.output(x), "output before training")
    jnet.fit(x, y)
    tnet.fit(x, y)
    _close(tnet.score(), jnet.score(), "unmasked loss")
    x, y = _batch(1)
    m = _mask(1)
    jnet.fit(x, y, features_mask=m, labels_mask=m)
    tnet.fit(x, y, features_mask=m, labels_mask=m)
    _close(tnet.score(), jnet.score(), "masked loss")
    _same(jnet, tnet, "after fit")

    blocks = [_batch(s) for s in (2, 3, 4)]
    xs, ys = (np.stack(a) for a in zip(*blocks))
    ms = np.stack([_mask(s) for s in (2, 3, 4)])
    jl = np.asarray(jnet.fit_steps(xs, ys, features_masks=ms, labels_masks=ms))
    tl = tnet.fit_steps(xs, ys, features_masks=ms, labels_masks=ms).numpy()
    _close(tl, jl, "fit_steps losses")
    _same(jnet, tnet, "after fit_steps")

    for t in (T, 5):                   # a window shorter than the configured T
        x, _ = _batch(7, t)
        _close(tnet.output(x), jnet.output(x), f"output at T = {t}")
    x, y = _batch(8)
    m = _mask(8)
    _close(tnet.score_for(x, y, features_mask=m, labels_mask=m),
           jnet.score_for(x, y, features_mask=m, labels_mask=m), "score_for")


def _datasets(cls, n):
    out = []
    for s in range(n):
        x, y = _batch(20 + s)
        m = _mask(20 + s)
        out.append(cls(x, y, features_mask=m, labels_mask=m))
    return out


def test_fused_iterator_fit_and_evaluate_match_jax(nets, tmp_path):
    """``fit(iterator, fused_steps=3)`` over 7 masked batches (two blocks
    and a tail step) for two epochs; then ``evaluate`` over the iterator
    (per-step classes of [B, T, C] outputs); then the zip written by each
    package restores in the other, Adam state included."""
    jnet, tnet = nets
    jnet.fit(JList(_datasets(JDataSet, 7)), epochs=2, fused_steps=3)
    tnet.fit(ListDataSetIterator(_datasets(DataSet, 7)), epochs=2, fused_steps=3)
    _close(tnet.score(), jnet.score(), "last loss")
    _same(jnet, tnet, "after two fused epochs")
    jev = jnet.evaluate(JList(_datasets(JDataSet, 3)))
    tev = tnet.evaluate(ListDataSetIterator(_datasets(DataSet, 3)))
    np.testing.assert_array_equal(tev.confusion, jev.confusion)
    assert tev.total == 3 * B * T
    masked = Evaluation()
    for ds in _datasets(DataSet, 3):
        masked.eval(ds.labels, tnet.output(ds.features), mask=ds.labels_mask)
    assert masked.total == int(sum(_mask(20 + s).sum() for s in range(3)))

    jpath, tpath = str(tmp_path / "j.zip"), str(tmp_path / "t.zip")
    jnet.save(jpath)
    tnet.save(tpath)
    from_j = tnn.MultiLayerNetwork.load(jpath, device="cpu")
    from_t = jnn.MultiLayerNetwork.load(tpath)
    _same(jnet, from_j, "JAX zip in the port")
    _same(from_t, tnet, "port zip in JAX")
    x, y = _batch(30)
    from_j.fit(x, y)
    tnet.fit(x, y)
    assert from_j.score() == tnet.score()         # a restored net resumes exactly


def test_full_width_config_and_initial_distribution():
    """bench.py's TextGenLSTM(n_classes=77, input_shape=(64, 77)): the JAX
    package's parameter shapes (``jax.eval_shape`` of its init, which
    compiles nothing), XAVIER weights whose spread is the Glorot normal's,
    forget bias 1 and the rest of the biases 0; and the peepholes a
    GravesLSTM draws UNIFORM within the JAX package's bound."""
    jconf = JTextGenLSTM(n_classes=77, input_shape=(64, 77)).conf()
    assert tzoo.TextGenLSTM(n_classes=77, input_shape=(64, 77)).conf().to_json() \
        == jconf.to_json()
    tnet = tzoo.TextGenLSTM().init_model(device="cpu")
    shapes = jax.eval_shape(lambda k: [l.initialize(k, it)[0] for l, it in zip(
        jconf.layers, [jnn.InputType.recurrent(77, 64)] + [jnn.InputType.recurrent(256, 64)] * 2)],
        jax.random.PRNGKey(0))
    for i, tree in enumerate(shapes):
        for k, a in tree.items():
            assert tuple(tnet.params_[f"layer_{i}"][k].shape) == a.shape
    assert tnet.num_params() == 77 * 1024 + 256 * 1024 + 1024 + 2 * 256 * 1024 + 1024 \
        + 256 * 77 + 77
    for name in ("layer_0", "layer_1", "layer_2"):
        W = tnet.params_[name]["W"].detach()
        want = np.sqrt(2.0 / sum(W.shape))
        assert abs(float(W.std()) / want - 1) < 0.05, name
    b = tnet.params_["layer_0"]["b"].detach()
    assert torch.equal(b[256:512], torch.ones(256)) and not b[:256].any() and not b[512:].any()
    assert tnet.conf.updater.to_json() == jconf.updater.to_json()       # Adam(1e-3)
    pw = t_init(torch.Generator().manual_seed(0), (3, 256), "UNIFORM", torch.float64, "cpu")
    jpw = np.asarray(j_init(jax.random.PRNGKey(0), (3, 256), "UNIFORM", jnp.float64))
    bound = float(np.abs(jpw).max())
    assert 0.9 * bound < float(pw.abs().max()) <= bound / 0.99
    assert abs(float(pw.std()) / float(jpw.std()) - 1) < 0.1
