"""Early stopping in the PyTorch port (``train/earlystopping.py``) against
the JAX package's, on the cases of ``tests/test_training_tools.py``.

Each case builds the same network in both packages (f64; the port's from
the JAX package's initial parameters, ``convert``), runs the JAX
``EarlyStoppingTrainer`` and the port's with the same configuration on
the same batches (made with numpy from a seed), and holds the port to the
JAX run: the same per-epoch scores within 1e-9 relative, the same best
epoch, termination reason and details and epoch count.  A
MultiLayerNetwork and a ComputationGraph; the in-memory saver (its best
model written back into the live tensors) and the local-file saver (the
shared zip, which the JAX package loads).
"""
import torch_test_threads  # noqa: F401  (first: one torch thread a worker)
import os

import jax
import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch import convert
from deeplearning4j_tpu_torch import nn as tnn
from deeplearning4j_tpu_torch.data import DataSet, ListDataSetIterator
from deeplearning4j_tpu_torch.train import earlystopping as tes

RTOL = 1e-9


def _mln(pkg, updater):
    return (pkg.NeuralNetConfiguration.builder().seed(0).updater(updater).dtype("float64")
            .list([pkg.DenseLayer(n_out=12, activation="relu"),
                   pkg.DenseLayer(n_out=8, activation="relu"),
                   pkg.OutputLayer(n_out=3, loss="mcxent", activation="softmax")])
            .set_input_type(pkg.InputType.feed_forward(6)).build())


def _cg(pkg, updater):
    b = (pkg.GraphBuilder().seed(3).updater(updater).dtype("float64").add_inputs("in")
         .set_input_types(pkg.InputType.feed_forward(6)))
    b.add_layer("hidden", pkg.DenseLayer(n_out=12, activation="tanh"), "in")
    b.add_layer("out", pkg.OutputLayer(n_out=3, loss="mcxent", activation="softmax"), "hidden")
    return b.set_outputs("out").build()


def _batches(n=96, bs=32, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, 6)
    y = np.eye(3)[(x[:, 0] > 0).astype(int) + (x[:, 1] > 0).astype(int)]
    return [(x[i:i + bs], y[i:i + bs]) for i in range(0, n, bs)]


def _nets(graph, updater_name, lr):
    from deeplearning4j_tpu import nn as jnn
    from deeplearning4j_tpu.train import updaters as jup
    from deeplearning4j_tpu_torch.train import updaters as tup
    build = _cg if graph else _mln
    jcls = jnn.ComputationGraph if graph else jnn.MultiLayerNetwork
    tcls = tnn.ComputationGraph if graph else tnn.MultiLayerNetwork
    jnet = jcls(build(jnn, getattr(jup, updater_name)(lr))).init()
    tnet = tcls(build(tnn, getattr(tup, updater_name)(lr)), device="cpu").init()
    convert.params_from_jax(tnet, jax.tree_util.tree_map(np.asarray, jnet.params_))
    return jnet, tnet


def _config(pkg, case, tmp_path, side):
    from deeplearning4j_tpu.data import DataSet as JDataSet
    from deeplearning4j_tpu.data import ListDataSetIterator as JList
    DS, LI = (JDataSet, JList) if side == "jax" else (DataSet, ListDataSetIterator)
    val = LI([DS(x, y) for x, y in _batches(seed=1)])
    calc = (pkg.ClassificationScoreCalculator(val) if case == "classification"
            else pkg.DataSetLossCalculator(val))
    etc = [pkg.MaxEpochsTerminationCondition(50 if case == "patience" else 4)]
    if case == "patience":
        etc.append(pkg.ScoreImprovementEpochTerminationCondition(patience=2,
                                                                 min_improvement=1e-3))
    if case == "best_score":
        etc.append(pkg.BestScoreEpochTerminationCondition(0.9))
    itc = [pkg.MaxScoreIterationTerminationCondition(1e4)] if case == "divergence" else []
    saver = (pkg.LocalFileModelSaver(str(tmp_path / side)) if case == "local_file"
             else pkg.InMemoryModelSaver())
    cfg = pkg.EarlyStoppingConfiguration(
        score_calculator=calc, epoch_termination_conditions=etc,
        iteration_termination_conditions=itc, model_saver=saver,
        evaluate_every_n_epochs=2 if case == "every_2" else 1,
        save_last_model=case == "local_file")
    train = LI([DS(x, y) for x, y in _batches()])
    return cfg, train


CASES = {  # case: (graph, updater, lr)
    "max_epochs": (False, "Adam", 1e-2),
    "patience": (False, "Sgd", 1e-6),
    "divergence": (False, "Sgd", 1e6),
    "local_file": (False, "Adam", 1e-2),
    "classification": (False, "Adam", 1e-2),
    "best_score": (False, "Adam", 5e-2),
    "every_2": (False, "Sgd", 0.1),
    "graph": (True, "Adam", 1e-2),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_early_stopping_matches_jax(case, tmp_path):
    from deeplearning4j_tpu.train import earlystopping as jes
    graph, upd, lr = CASES[case]
    jnet, tnet = _nets(graph, upd, lr)
    jcfg, jtrain = _config(jes, case, tmp_path, "jax")
    tcfg, ttrain = _config(tes, case, tmp_path, "port")
    jres = jes.EarlyStoppingTrainer(jcfg, jnet, jtrain).fit()
    tres = tes.EarlyStoppingTrainer(tcfg, tnet, ttrain).fit()
    assert tres.termination_reason == jres.termination_reason
    assert tres.total_epochs == jres.total_epochs
    assert tres.best_model_epoch == jres.best_model_epoch
    assert sorted(tres.score_vs_epoch) == sorted(jres.score_vs_epoch)
    for e, want in jres.score_vs_epoch.items():
        got = tres.score_vs_epoch[e]
        assert abs(got - want) <= RTOL * max(abs(want), 1e-300), (e, got, want)
    if case == "patience":
        assert tres.total_epochs < 50
    if case in ("max_epochs", "local_file", "classification", "graph", "every_2"):
        assert tres.total_epochs == 4
    if case == "divergence":
        assert tres.termination_reason == "IterationTerminationCondition"
        assert tres.termination_details.split(" at ")[0] == \
            jres.termination_details.split(" at ")[0]
        return
    assert tres.termination_details == jres.termination_details
    assert abs(tres.best_model_score - jres.best_model_score) <= \
        RTOL * abs(jres.best_model_score)
    # the best model: the best epoch's parameters in both packages
    want = np.asarray(jres.best_model.params())
    got = tres.best_model.params()
    assert np.abs(got - want).max() <= RTOL * np.abs(want).max()
    if case == "local_file":
        assert os.path.exists(tmp_path / "port" / "bestModel.zip")
        assert os.path.exists(tmp_path / "port" / "latestModel.zip")
        from deeplearning4j_tpu import nn as jnn
        back = jnn.MultiLayerNetwork.load(str(tmp_path / "port" / "bestModel.zip"))
        np.testing.assert_array_equal(np.asarray(back.params()), got)


def test_in_memory_saver_writes_the_best_back_in_place():
    from deeplearning4j_tpu_torch.train import Adam
    net = tnn.MultiLayerNetwork(_mln(tnn, Adam(1e-2)), device="cpu").init()
    saver = tes.InMemoryModelSaver()
    assert saver.get_best_model() is None
    saver.save_best_model(net)
    best = net.params().copy()
    ptrs = [p.data_ptr() for p in net.parameters()]
    for x, y in _batches():
        net.fit(x, y)
    assert not np.array_equal(net.params(), best)
    assert saver.get_best_model() is net
    np.testing.assert_array_equal(net.params(), best)
    assert [p.data_ptr() for p in net.parameters()] == ptrs
    assert all(torch.is_tensor(t) for t in net.parameters())
