"""Evaluation, `evaluate` and the training listeners of the PyTorch port
against the JAX package.

The evaluation classes are numpy in both packages, so their counts,
metrics and `stats()` strings must be equal, not merely close, on the same
seeded inputs (the port's given as tensors too).  `evaluate` on an MLN and
a CG whose parameters the JAX package initialized gives the same confusion
matrix.  The listeners ride the same `fit(iterator, epochs=2)` in both
packages (f64, scores within 1e-10 relative).
"""
import torch_test_threads  # noqa: F401  (first: one torch thread a worker)
import logging
import os

import jax
import numpy as np
import pytest
import torch

from deeplearning4j_tpu import nn as jnn
from deeplearning4j_tpu.data.dataset import DataSet as JDataSet
from deeplearning4j_tpu.data.iterators import ListDataSetIterator as JList
from deeplearning4j_tpu.train import evaluation as jev
from deeplearning4j_tpu.train import listeners as jlis
from deeplearning4j_tpu.train import updaters as jupd
from deeplearning4j_tpu_torch import convert
from deeplearning4j_tpu_torch import nn as tnn
from deeplearning4j_tpu_torch import train as ttrain
from deeplearning4j_tpu_torch.data import DataSet, ListDataSetIterator
from deeplearning4j_tpu_torch.train import evaluation as tev
from deeplearning4j_tpu_torch.train import listeners as tlis


def _softmax(z):
    e = np.exp(z - z.max(-1, keepdims=True))
    return e / e.sum(-1, keepdims=True)


def _class_batches(n_batches=3, n=20, c=5, seed=0, never=None):
    rs = np.random.RandomState(seed)
    out = []
    for _ in range(n_batches):
        labels = np.eye(c)[rs.randint(0, c, n)]
        z = rs.randn(n, c)
        if never is not None:
            z[:, never] = -50.0          # a class never predicted
        out.append((labels, _softmax(z)))
    return out


def _same_attrs(a, b, names):
    for name in names:
        va, vb = getattr(a, name), getattr(b, name)
        if isinstance(va, np.ndarray) or isinstance(vb, np.ndarray):
            np.testing.assert_array_equal(np.asarray(va), np.asarray(vb), err_msg=name)
        else:
            assert va == vb, name


@pytest.mark.parametrize("top_n", [1, 3])
@pytest.mark.parametrize("as_tensor", [False, True])
def test_evaluation_accumulates_like_jax(top_n, as_tensor):
    j, t = jev.Evaluation(top_n=top_n), tev.Evaluation(top_n=top_n)
    for labels, preds in _class_batches(never=4):
        j.eval(labels, preds)
        if as_tensor:
            t.eval(torch.from_numpy(labels), torch.from_numpy(preds))
        else:
            t.eval(labels, preds)
    np.testing.assert_array_equal(t.confusion, j.confusion)
    assert t.confusion.sum(0)[4] == 0
    _same_attrs(t, j, ["num_classes", "top_n_correct", "total"])
    for m in ("accuracy", "top_n_accuracy", "precision", "recall", "f1"):
        assert getattr(t, m)() == getattr(j, m)(), m
    for cls in range(5):
        for m in ("precision", "recall", "f1"):
            assert getattr(t, m)(cls) == getattr(j, m)(cls), (m, cls)
    assert t.stats() == j.stats()


def test_evaluation_sequences_with_masks_and_index_labels():
    rs = np.random.RandomState(1)
    labels = np.eye(4)[rs.randint(0, 4, (3, 6))]
    preds = _softmax(rs.randn(3, 6, 4))
    mask = (rs.rand(3, 6) > 0.3).astype(np.float64)
    j, t = jev.Evaluation(), tev.Evaluation()
    j.eval(labels, preds, mask)
    t.eval(torch.from_numpy(labels), torch.from_numpy(preds), torch.from_numpy(mask))
    np.testing.assert_array_equal(t.confusion, j.confusion)
    assert t.total == j.total == int(mask.sum())
    idx = rs.randint(0, 4, 9)
    p = _softmax(rs.randn(9, 4))
    j2, t2 = jev.Evaluation(num_classes=4), tev.Evaluation(num_classes=4)
    j2.eval(idx, p)
    t2.eval(torch.from_numpy(idx), torch.from_numpy(p).to(torch.bfloat16))
    jb = jev.Evaluation(num_classes=4)
    jb.eval(idx, torch.from_numpy(p).to(torch.bfloat16).float().numpy())
    np.testing.assert_array_equal(t2.confusion, jb.confusion)
    assert t2.stats() == jb.stats()
    assert tev.Evaluation().accuracy() == jev.Evaluation().accuracy() == 0.0


def test_regression_evaluation():
    rs = np.random.RandomState(2)
    j, t = jev.RegressionEvaluation(), tev.RegressionEvaluation()
    for _ in range(3):
        y, p = rs.randn(10, 3), rs.randn(10, 3)
        j.eval(y, p)
        t.eval(torch.from_numpy(y), p)
    for c in range(3):
        for m in ("mean_squared_error", "mean_absolute_error",
                  "root_mean_squared_error", "r_squared", "pearson_correlation"):
            assert getattr(t, m)(c) == getattr(j, m)(c), (m, c)
    assert t.stats() == j.stats()


def test_roc_family():
    rs = np.random.RandomState(3)
    jr, tr = jev.ROC(), tev.ROC()
    jm, tm = jev.ROCMultiClass(), tev.ROCMultiClass()
    jb, tb = jev.ROCBinary(), tev.ROCBinary()
    for _ in range(2):
        y1 = rs.randint(0, 2, 30).astype(np.float64)
        s1 = rs.rand(30)
        s1[:5] = 0.5                                   # ties
        jr.eval(y1, s1)
        tr.eval(torch.from_numpy(y1), torch.from_numpy(s1))
        y2 = np.eye(2)[rs.randint(0, 2, 30)]
        s2 = _softmax(rs.randn(30, 2))
        jr.eval(y2, s2)
        tr.eval(y2, torch.from_numpy(s2))
        yc, sc = np.eye(4)[rs.randint(0, 4, 30)], _softmax(rs.randn(30, 4))
        jm.eval(yc, sc)
        tm.eval(torch.from_numpy(yc), torch.from_numpy(sc))
        yk, sk = rs.randint(0, 2, (30, 3)).astype(np.float64), rs.rand(30, 3)
        jb.eval(yk, sk)
        tb.eval(torch.from_numpy(yk), torch.from_numpy(sk))
    assert tr.calculate_auc() == jr.calculate_auc()
    assert tr.calculate_auprc() == jr.calculate_auprc()
    for c in range(4):
        assert tm.calculate_auc(c) == jm.calculate_auc(c)
    assert tm.calculate_average_auc() == jm.calculate_average_auc()
    assert tb.num_labels() == jb.num_labels() == 3
    for k in range(3):
        assert tb.calculate_auc(k) == jb.calculate_auc(k)
        assert tb.calculate_auprc(k) == jb.calculate_auprc(k)
    assert tb.calculate_average_auc() == jb.calculate_average_auc()
    assert tb.stats() == jb.stats()
    one_j, one_t = jev.ROCBinary(), tev.ROCBinary()
    one_j.eval(np.array([0., 1., 1.]), np.array([0.2, 0.6, 0.9]))
    one_t.eval(torch.tensor([0., 1., 1.]), torch.tensor([0.2, 0.6, 0.9], dtype=torch.float64))
    assert one_t.stats() == one_j.stats()
    empty_j, empty_t = jev.ROC(), tev.ROC()
    empty_j.eval(np.ones(4), np.linspace(0, 1, 4))
    empty_t.eval(np.ones(4), np.linspace(0, 1, 4))
    assert empty_t.calculate_auc() == empty_j.calculate_auc() == 0.0


def test_evaluation_calibration_and_binary():
    rs = np.random.RandomState(4)
    jc, tc = jev.EvaluationCalibration(reliability_bins=5, histogram_bins=7), \
        tev.EvaluationCalibration(reliability_bins=5, histogram_bins=7)
    jb, tb = jev.EvaluationBinary(threshold=0.4), tev.EvaluationBinary(threshold=0.4)
    for _ in range(3):
        y = rs.randint(0, 2, (25, 3)).astype(np.float64)
        p = rs.rand(25, 3)
        p[0] = [0.0, 1.0, 0.4]                         # bin and threshold edges
        jc.eval(y, p)
        tc.eval(torch.from_numpy(y), torch.from_numpy(p))
        jb.eval(y, p)
        tb.eval(torch.from_numpy(y), torch.from_numpy(p))
    for k in range(3):
        for a, b in zip(tc.reliability_diagram(k), jc.reliability_diagram(k)):
            np.testing.assert_array_equal(a, b)
        assert tc.expected_calibration_error(k) == jc.expected_calibration_error(k)
        np.testing.assert_array_equal(tc.get_probability_histogram(k),
                                      jc.get_probability_histogram(k))
        for m in ("accuracy", "precision", "recall", "f1", "true_positives",
                  "false_positives"):
            assert getattr(tb, m)(k) == getattr(jb, m)(k), (m, k)
    np.testing.assert_array_equal(tc.get_residual_plot_all_classes(),
                                  jc.get_residual_plot_all_classes())
    assert tc.stats() == jc.stats()
    assert tb.stats() == jb.stats()
    with pytest.raises(ValueError, match="outputs"):
        tb.eval(np.ones((2, 4)), np.ones((2, 4)))
    nothing = tev.EvaluationBinary()
    assert nothing.num_labels() == 0 and np.isnan(nothing.accuracy(0))
    single_j, single_t = jev.EvaluationCalibration(), tev.EvaluationCalibration()
    single_j.eval(np.array([0., 1.]), np.array([0.3, 0.8]))
    single_t.eval(torch.tensor([0., 1.]), torch.tensor([0.3, 0.8], dtype=torch.float64))
    assert single_t.stats() == single_j.stats()


# ---------------------------------------------------------------------------
# evaluate on the networks
# ---------------------------------------------------------------------------

def _mln_conf():
    return (jnn.NeuralNetConfiguration.builder().seed(5).updater(jupd.Adam(1e-2))
            .dtype("float64")
            .list([jnn.DenseLayer(n_out=16, activation="relu"),
                   jnn.DenseLayer(n_out=12, activation="selu"),
                   jnn.OutputLayer(n_out=4, loss="mcxent", activation="softmax")])
            .set_input_type(jnn.InputType.feed_forward(6)).build())


def _mln_twin():
    jconf = _mln_conf()
    jnet = jnn.MultiLayerNetwork(jconf).init()
    tnet = tnn.MultiLayerNetwork(tnn.MultiLayerConfiguration.from_json(jconf.to_json()),
                                 device="cpu").init()
    convert.params_from_jax(tnet, jax.tree_util.tree_map(np.asarray, jnet.params_))
    return jnet, tnet


def _batches(n=3, seed=0, rows=10):
    rs = np.random.RandomState(seed)
    return [(rs.randn(rows, 6), np.eye(4)[rs.randint(0, 4, rows)]) for _ in range(n)]


def _iters(batches):
    return (JList([JDataSet(x, y) for x, y in batches]),
            ListDataSetIterator([DataSet(x, y) for x, y in batches]))


def test_mln_evaluate_matches_jax():
    jnet, tnet = _mln_twin()
    jit, tit = _iters(_batches(4, seed=1))
    jev_ = jnet.evaluate(jit)
    tev_ = tnet.evaluate(tit)
    assert isinstance(tev_, ttrain.Evaluation)
    np.testing.assert_array_equal(tev_.confusion, jev_.confusion)
    assert tev_.stats() == jev_.stats()
    acc = tev.Evaluation(top_n=2)
    assert tnet.evaluate(tit, acc) is acc and acc.total == 40


def _graph(mod, two_heads=False):
    b = (mod.GraphBuilder().seed(3).dtype("float64").add_inputs("in")
         .set_input_types(mod.InputType.feed_forward(6)))
    b.add_layer("hidden", mod.DenseLayer(n_out=10, activation="tanh"), "in")
    b.add_layer("out", mod.OutputLayer(n_out=4, loss="mcxent", activation="softmax"),
                "hidden")
    if two_heads:
        b.add_layer("out2", mod.OutputLayer(n_out=4, loss="mcxent",
                                            activation="softmax"), "hidden")
        return b.set_outputs("out", "out2").build()
    return b.set_outputs("out").build()


def test_graph_evaluate_matches_jax_and_refuses_two_heads():
    jnet = jnn.ComputationGraph(_graph(jnn)).init()
    tnet = tnn.ComputationGraph(_graph(tnn), device="cpu").init()
    assert tnet.conf.to_json() == jnet.conf.to_json()
    convert.params_from_jax(tnet, jax.tree_util.tree_map(np.asarray, jnet.params_))
    jit, tit = _iters(_batches(3, seed=2))
    np.testing.assert_array_equal(tnet.evaluate(tit).confusion,
                                  jnet.evaluate(jit).confusion)
    two = tnn.ComputationGraph(_graph(tnn, two_heads=True), device="cpu").init()
    with pytest.raises(ValueError, match="single-output"):
        two.evaluate(tit)
    with pytest.raises(ValueError, match="single-output"):
        jnn.ComputationGraph(_graph(jnn, two_heads=True)).init().evaluate(jit)


# ---------------------------------------------------------------------------
# listeners
# ---------------------------------------------------------------------------

def _recorder(base):
    class Recorder(base):
        def __init__(self):
            self.calls = []

        def iteration_done(self, model, iteration, epoch):
            self.calls.append(("it", iteration, epoch, model.iteration))

        def on_epoch_end(self, model):
            self.calls.append(("epoch", model.epoch, model.iteration))
    return Recorder()


def test_listeners_hear_the_same_fit_as_in_jax(tmp_path, monkeypatch):
    jnet, tnet = _mln_twin()
    batches = _batches(3, seed=3)
    held_out = _batches(2, seed=4)
    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    jrec, trec = _recorder(jlis.TrainingListener), _recorder(tlis.TrainingListener)
    jcol, tcol = jlis.CollectScoresListener(2), tlis.CollectScoresListener(2)
    jck = jlis.CheckpointListener(str(jdir), every_n_iterations=2, keep_last=2)
    tck = tlis.CheckpointListener(str(tdir), every_n_iterations=2, keep_last=2)
    jck_e = jlis.CheckpointListener(str(jdir / "e"), every_n_epochs=1, keep_last=1)
    tck_e = tlis.CheckpointListener(str(tdir / "e"), every_n_epochs=1, keep_last=1)
    jevl = jlis.EvaluativeListener(_iters(held_out)[0], frequency=2)
    tevl = tlis.EvaluativeListener(_iters(held_out)[1], frequency=2)
    jevl_e = jlis.EvaluativeListener(_iters(held_out)[0], invoke_on="epoch")
    tevl_e = tlis.EvaluativeListener(_iters(held_out)[1], invoke_on="epoch")
    tperf = tlis.PerformanceListener(frequency=2)
    ttime = tlis.TimeIterationListener(total_iterations=6, frequency=3)
    jnet.set_listeners(jrec, jcol, jck, jck_e, jevl, jevl_e)
    tnet.set_listeners(trec, tcol, tck, tck_e, tevl, tevl_e, tperf, ttime)
    jit, tit = _iters(batches)
    jnet.fit(jit, epochs=2)
    tnet.fit(tit, epochs=2)

    assert trec.calls == jrec.calls
    assert tcol.iterations == jcol.iterations == [2, 4, 6]
    assert all(isinstance(s, torch.Tensor) for s in tcol._raw)
    np.testing.assert_allclose(tcol.scores, jcol.scores, rtol=1e-10)
    assert all(isinstance(s, float) for s in tcol.scores)
    assert sorted(os.listdir(tdir)) == sorted(os.listdir(jdir)) == [
        "checkpoint_iter_4.zip", "checkpoint_iter_6.zip", "e"]
    assert sorted(os.listdir(tdir / "e")) == sorted(os.listdir(jdir / "e")) == [
        "checkpoint_epoch_2.zip"]
    assert tck.last_checkpoint() == str(tdir / "checkpoint_iter_6.zip")
    x = batches[0][0]
    for name in ("checkpoint_iter_4.zip", "checkpoint_iter_6.zip"):
        in_jax = jnn.MultiLayerNetwork.load(str(tdir / name))
        want = np.asarray(jnn.MultiLayerNetwork.load(str(jdir / name)).output(x))
        np.testing.assert_allclose(np.asarray(in_jax.output(x)), want, rtol=1e-10,
                                   atol=1e-12)
    last = tnn.MultiLayerNetwork.load(tck.last_checkpoint(), device="cpu")
    assert last.iteration == 6 and torch.equal(last.output(x), tnet.output(x))
    assert tevl.history == jevl.history and len(tevl.history) == 3
    assert tevl_e.history == jevl_e.history and len(tevl_e.history) == 2
    assert tperf.last_samples_per_sec > 0 and tperf.last_iters_per_sec > 0
    with pytest.raises(ValueError, match="Exactly one"):
        tlis.CheckpointListener(str(tdir), every_n_iterations=1, every_n_epochs=1)
    tlis.CheckpointListener(str(tdir), every_n_epochs=1, delete_existing=True)
    assert os.listdir(tdir) == ["e"]


def test_muted_score_listener_reads_no_score_and_a_loud_one_does(monkeypatch, caplog):
    _, tnet = _mln_twin()
    reads = []
    real = tnet.score
    monkeypatch.setattr(tnet, "score", lambda: reads.append(1) or real())
    tnet.set_listeners(tlis.ScoreIterationListener(1), tlis.CollectScoresListener(1),
                       tlis.PerformanceListener(1))
    x, y = _batches(1)[0]
    logging.getLogger("deeplearning4j_tpu_torch").setLevel(logging.WARNING)
    for _ in range(3):
        tnet.fit(x, y)
    assert reads == []
    assert isinstance(tnet.listeners[1]._raw[0], torch.Tensor)
    with caplog.at_level(logging.INFO, logger="deeplearning4j_tpu_torch"):
        tnet.add_listeners(tlis.ScoreIterationListener(2))
        tnet.fit(x, y)
        tnet.fit(x, y)
    assert len(reads) == 2 + 1      # every step at print_every 1, one at 2
    assert "Score at iteration 4" in caplog.text
