"""The port's ONNX importer against the JAX package's, on the CPU.

The same ONNX bytes go through ``deeplearning4j_tpu.modelimport.
import_onnx_model`` and the port's (``device="cpu"``):

- all 45 graphs of ``tests/test_onnx_conformance_corpus.py`` (its case
  list): the two outputs within the case's tolerance, and the port's
  within it of the case's torch golden;
- the cases of ``tests/test_onnx_import.py``: LeNet's forward, then three
  ``sd.fit`` steps with Adam whose losses and variables
  (``convert.samediff_to_jax``) follow the JAX package's; the ResNet
  block; the transformer block; the shape ops; the named error of an
  unmapped op; LSTM and GRU with their state outputs and initial states;
- the slice as a whole: a 2-layer, width-32 BERT encoder written as
  ``chip_smoke.bert_onnx_model`` writes BERT-base (opset-17
  LayerNormalization, the Erf GELU, heads by Reshape/Transpose): outputs,
  then the gradients and the loss of one fine-tune step with a head;
- the import reads every shape input from the host copies it keeps (no
  device read-back), and ``trainable=False`` keeps the weights constants.
"""
import torch_test_threads  # noqa: F401  (first: one torch thread a worker)
import numpy as np
import pytest
import torch

import chip_smoke
from deeplearning4j_tpu.autodiff import TrainingConfig as JTrainingConfig
from deeplearning4j_tpu.modelimport.onnx_import import import_onnx_model as jax_import
from deeplearning4j_tpu.modelimport.onnx_proto import attr_f, attr_i, attr_ints
from deeplearning4j_tpu.train.updaters import Adam as JAdam
from deeplearning4j_tpu_torch import convert
from deeplearning4j_tpu_torch.autodiff import SDVariable, TrainingConfig
from deeplearning4j_tpu_torch.modelimport import (OnnxImportRegistry, UnmappedOnnxOpException,
                                                  import_onnx_model)
from deeplearning4j_tpu_torch.train import Adam
from tests.test_onnx_conformance_corpus import CORPUS
from tests.test_onnx_import import (_N, _TorchLeNet, _TorchResBlock, _lenet_onnx, _model,
                                    _vi)


def _np(v):
    return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def _both(model_or_bytes, **kw):
    b = model_or_bytes if isinstance(model_or_bytes, bytes) else model_or_bytes.serialize()
    return import_onnx_model(b, device="cpu", **kw), jax_import(b, **kw)


def _outputs(pair, feeds, *names):
    sd, jsd = pair
    got, want = sd.output(feeds, *names), jsd.output(feeds, *names)
    return {n: _np(got[n]) for n in names}, {n: np.asarray(want[n]) for n in names}


@pytest.mark.parametrize("name,nodes,inputs,inits,golden,tol", CORPUS,
                         ids=[c[0] for c in CORPUS])
def test_corpus_graph_matches_the_jax_import(name, nodes, inputs, inits, golden, tol):
    out = nodes[-1].output[0]
    m = _model(nodes, [_vi(k, v.shape) for k, v in inputs.items()], [_vi(out, ())], inits)
    got, want = _outputs(_both(m), dict(inputs), out)
    np.testing.assert_allclose(got[out], want[out], rtol=tol, atol=tol, err_msg=name)
    np.testing.assert_allclose(got[out], np.asarray(golden(*inputs.values())), rtol=tol,
                               atol=tol, err_msg=name)


def test_corpus_is_whole():
    assert len(CORPUS) == 45


def test_lenet_forward_and_fine_tune_follow_jax():
    torch.manual_seed(0)
    m = _lenet_onnx(_TorchLeNet().eval())
    sd, jsd = _both(m)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((8, 1, 28, 28)).astype(np.float32)
    y = np.eye(10, dtype=np.float32)[rng.integers(0, 10, 8)]
    got, want = _outputs((sd, jsd), {"x": x}, "logits")
    np.testing.assert_allclose(got["logits"], want["logits"], rtol=1e-5, atol=1e-5)
    assert sd.import_inputs == jsd.import_inputs == ["x"]
    assert sd.import_outputs == jsd.import_outputs == ["logits"]
    for g, upd, cfg in ((sd, Adam, TrainingConfig), (jsd, JAdam, JTrainingConfig)):
        lab = g.placeholder("lab", (None, 10))
        g.loss.softmax_cross_entropy(lab, g.get_variable("logits"), name="loss")
        g.set_loss_variables("loss")
        g.set_training_config(cfg(updater=upd(1e-3), data_set_feature_mapping=["x"],
                                  data_set_label_mapping=["lab"]))
    losses, jlosses = [], []
    for _ in range(3):
        sd.fit(x, y)
        jsd.fit(x, y)
        losses.append(sd.score())
        jlosses.append(float(jsd.score()))
    np.testing.assert_allclose(losses, jlosses, rtol=1e-5)
    assert losses[-1] < losses[0]
    # Adam moves an element by up to lr a step whatever its gradient's size,
    # so where a gradient is f32 noise the two packages may step apart: the
    # variables agree within 1% of one step (1e-5 at lr 1e-3)
    tv = convert.samediff_to_jax(sd)["variables"]
    assert set(tv) == set(jsd.variables_)
    for k, v in jsd.variables_.items():
        np.testing.assert_allclose(tv[k], np.asarray(v), rtol=0, atol=1e-5, err_msg=k)


def test_resnet_block_matches_jax_and_torch():
    torch.manual_seed(0)
    net = _TorchResBlock().eval()
    with torch.no_grad():
        for bn in (net.b1, net.b2):
            bn.running_mean.uniform_(-0.5, 0.5)
            bn.running_var.uniform_(0.5, 1.5)
    p = {k: v.detach().numpy() for k, v in net.state_dict().items()
         if not k.endswith("num_batches_tracked")}
    def bn(i, o, b):
        return _N("BatchNormalization", [i] + [f"{b}.{k}" for k in
                                               ("weight", "bias", "running_mean", "running_var")],
                  [o], attr_f("epsilon", 1e-5))
    pads = attr_ints("pads", [1, 1, 1, 1])
    nodes = [_N("Conv", ["x", "c1.weight"], ["h1"], pads), bn("h1", "n1", "b1"),
             _N("Relu", ["n1"], ["r1"]), _N("Conv", ["r1", "c2.weight"], ["h2"], pads),
             bn("h2", "n2", "b2"), _N("Conv", ["x", "proj.weight"], ["skip"]),
             _N("Add", ["n2", "skip"], ["res"]), _N("Relu", ["res"], ["r2"]),
             _N("GlobalAveragePool", ["r2"], ["gap"]),
             _N("Flatten", ["gap"], ["flat"], attr_i("axis", 1)),
             _N("Gemm", ["flat", "fc.weight", "fc.bias"], ["out"], attr_i("transB", 1))]
    m = _model(nodes, [_vi("x", (None, 3, 8, 8))], [_vi("out", (None, 5))], p)
    x = np.random.default_rng(3).standard_normal((2, 3, 8, 8)).astype(np.float32)
    got, want = _outputs(_both(m), {"x": x}, "out")
    np.testing.assert_allclose(got["out"], want["out"], rtol=1e-5, atol=1e-6)
    with torch.no_grad():
        np.testing.assert_allclose(got["out"], net(torch.from_numpy(x)).numpy(), rtol=1e-4,
                                   atol=1e-4)


def test_transformer_block_matches_jax():
    B, T, H, NH = 2, 6, 16, 4
    rng = np.random.default_rng(4)
    p = {k: rng.standard_normal(s).astype(np.float32) * 0.2 for k, s in
         (("wq", (H, H)), ("wk", (H, H)), ("wv", (H, H)), ("wo", (H, H)),
          ("w1", (H, 4 * H)), ("w2", (4 * H, H)))}
    p.update(ln_g=np.abs(rng.standard_normal(H)).astype(np.float32) + 0.5,
             ln_b=rng.standard_normal(H).astype(np.float32) * 0.1,
             scale=np.float32(1.0 / np.sqrt(H // NH)),
             head_shape=np.array([0, T, NH, H // NH], np.int64),
             merge_shape=np.array([0, T, H], np.int64), sqrt2=np.float32(np.sqrt(2.0)),
             one=np.float32(1.0), half=np.float32(0.5))

    def heads(w, out):
        return [_N("MatMul", ["x", w], [f"{out}_p"]),
                _N("Reshape", [f"{out}_p", "head_shape"], [f"{out}_r"]),
                _N("Transpose", [f"{out}_r"], [out], attr_ints("perm", [0, 2, 1, 3]))]
    nodes = heads("wq", "q") + heads("wk", "k") + heads("wv", "v") + [
        _N("Transpose", ["k"], ["kT"], attr_ints("perm", [0, 1, 3, 2])),
        _N("MatMul", ["q", "kT"], ["s0"]), _N("Mul", ["s0", "scale"], ["s"]),
        _N("Softmax", ["s"], ["pr"], attr_i("axis", -1)), _N("MatMul", ["pr", "v"], ["c"]),
        _N("Transpose", ["c"], ["ct"], attr_ints("perm", [0, 2, 1, 3])),
        _N("Reshape", ["ct", "merge_shape"], ["cm"]), _N("MatMul", ["cm", "wo"], ["a"]),
        _N("Add", ["x", "a"], ["r1"]),
        _N("LayerNormalization", ["r1", "ln_g", "ln_b"], ["ln1"], attr_f("epsilon", 1e-5),
           attr_i("axis", -1)),
        _N("MatMul", ["ln1", "w1"], ["f1"]), _N("Div", ["f1", "sqrt2"], ["fd"]),
        _N("Erf", ["fd"], ["fe"]), _N("Add", ["fe", "one"], ["fa"]),
        _N("Mul", ["f1", "fa"], ["fm"]), _N("Mul", ["fm", "half"], ["fg"]),
        _N("MatMul", ["fg", "w2"], ["f2"]), _N("Add", ["ln1", "f2"], ["y"])]
    m = _model(nodes, [_vi("x", (None, T, H))], [_vi("y", (None, T, H))], p)
    x = rng.standard_normal((B, T, H)).astype(np.float32)
    got, want = _outputs(_both(m), {"x": x}, "y")
    np.testing.assert_allclose(got["y"], want["y"], rtol=1e-5, atol=1e-5)


def test_shape_ops_match_jax():
    data = np.random.default_rng(5).standard_normal((2, 6, 4)).astype(np.float32)
    nodes = [_N("Split", ["x"], ["s0", "s1", "s2"], attr_i("axis", 1),
                attr_ints("split", [2, 2, 2])),
             _N("Slice", ["x", "starts", "ends", "axes", "steps"], ["sl"]),
             _N("Gather", ["x", "idx"], ["g"], attr_i("axis", 1)),
             _N("Unsqueeze", ["x", "uax"], ["u"]),
             _N("ReduceMean", ["x"], ["rm"], attr_ints("axes", [2]), attr_i("keepdims", 0)),
             _N("Pad", ["x", "pads"], ["pd"]), _N("Concat", ["s0", "s1"], ["cc"],
                                                  attr_i("axis", 1)),
             _N("Shape", ["cc"], ["shp"]), _N("Expand", ["col", "shp"], ["ex"])]
    consts = {"starts": np.array([1], np.int64), "ends": np.array([5], np.int64),
              "axes": np.array([1], np.int64), "steps": np.array([2], np.int64),
              "idx": np.array([0, 3], np.int64), "uax": np.array([0], np.int64),
              "pads": np.array([0, 1, 0, 0, 1, 0], np.int64),
              "col": np.arange(4, dtype=np.float32).reshape(4, 1)}
    outs = ["s0", "sl", "g", "u", "rm", "pd", "cc", "ex"]
    m = _model(nodes, [_vi("x", (2, 6, 4))], [_vi(o, ()) for o in outs], consts)
    got, want = _outputs(_both(m), {"x": data}, *outs)
    for o in outs:
        np.testing.assert_allclose(got[o], want[o], rtol=1e-6, err_msg=o)
    np.testing.assert_allclose(got["sl"], data[:, 1:5:2])
    np.testing.assert_allclose(got["pd"], np.pad(data, ((0, 0), (1, 1), (0, 0))))


def test_unmapped_op_raises_the_named_error():
    m = _model([_N("FancyNewOp", ["x"], ["y"])], [_vi("x", (2,))], [_vi("y", (2,))], {})
    with pytest.raises(UnmappedOnnxOpException, match="FancyNewOp"):
        import_onnx_model(m.serialize(), device="cpu")
    OnnxImportRegistry.register("FancyNewOp", lambda sd, n, ins: sd.op(
        "neg", ins[0], name=n.output[0]))
    try:
        sd = import_onnx_model(m.serialize(), device="cpu")
        np.testing.assert_array_equal(_np(sd.output({"x": np.ones(2, np.float32)}, "y")["y"]),
                                      -np.ones(2))
    finally:
        del OnnxImportRegistry._MAP["FancyNewOp"]


def _rnn_models():
    rs = np.random.RandomState(23)
    T, B, I, H = 4, 3, 5, 6
    g = lambda *s: rs.uniform(-0.4, 0.4, s).astype(np.float32)   # noqa: E731
    x, h0, c0 = g(T, B, I), g(1, B, H), g(1, B, H)
    lstm = {"W": g(1, 4 * H, I), "R": g(1, 4 * H, H), "Bb": g(1, 8 * H)}
    gru = {"W": g(1, 3 * H, I), "R": g(1, 3 * H, H), "Bb": g(1, 6 * H)}
    yield ("lstm", [_N("LSTM", ["x", "W", "R", "Bb", "", "h0", "c0"], ["y", "yh", "yc"],
                       attr_i("hidden_size", H))],
           {"x": x, "h0": h0, "c0": c0}, lstm, ["y", "yh", "yc"])
    yield ("lstm-c0-only", [_N("LSTM", ["x", "W", "R", "Bb", "", "", "c0"], ["y"],
                               attr_i("hidden_size", H))], {"x": x, "c0": c0}, lstm, ["y"])
    yield ("gru", [_N("GRU", ["x", "W", "R", "Bb", "", "h0"], ["y", "yh"],
                      attr_i("hidden_size", H), attr_i("linear_before_reset", 1))],
           {"x": x, "h0": h0}, gru, ["y", "yh"])


RNN = list(_rnn_models())


@pytest.mark.parametrize("case", RNN, ids=[c[0] for c in RNN])
def test_lstm_gru_state_outputs_match_jax(case):
    _, nodes, feeds, inits, outs = case
    m = _model(nodes, [_vi(k, v.shape) for k, v in feeds.items()],
               [_vi(o, ()) for o in outs], inits)
    got, want = _outputs(_both(m), feeds, *outs)
    for o in outs:
        np.testing.assert_allclose(got[o], want[o], rtol=1e-5, atol=1e-6, err_msg=o)


BERT = (2, 8, 2, 32, 4, 50)          # batch, T, layers, hidden, heads, vocab


@pytest.fixture(scope="module")
def bert():
    b, w, enc = chip_smoke.bert_onnx_model(*BERT)
    rs = np.random.RandomState(0)
    ids = rs.randint(0, BERT[5], BERT[:2]).astype(np.int64)
    lab = rs.randint(0, BERT[5], BERT[:2]).astype(np.int32)
    head = np.random.RandomState(1).randn(BERT[3], BERT[5]).astype(np.float32) * 0.1
    return b, w, enc, ids, lab, head


def _with_head(sd, enc, head, cfg, upd):
    logits = sd.op("matmul", sd.get_variable(enc), sd.var("head_w", head), name="logits")
    sd.loss.sparse_softmax_cross_entropy(sd.placeholder("lab", BERT[:2], dtype="int32"),
                                         logits, name="loss")
    sd.set_loss_variables("loss")
    sd.set_training_config(cfg(updater=upd(1e-4), data_set_feature_mapping=["ids"],
                               data_set_label_mapping=["lab"]))


def test_bert_encoder_slice_matches_jax_and_the_plain_forward(bert):
    b, w, enc, ids, _, _ = bert
    sd, jsd = _both(b)
    got, want = _outputs((sd, jsd), {"ids": ids}, enc)
    np.testing.assert_allclose(got[enc], want[enc], rtol=1e-5, atol=1e-5)
    ref = chip_smoke.bert_plain_forward(w, torch.as_tensor(ids), BERT[2], BERT[4]).numpy()
    np.testing.assert_allclose(got[enc], ref, rtol=1e-5, atol=1e-5)
    assert sum(n.op == "layer_norm" for n in sd._nodes.values() if n.kind == "op") == 4
    assert len(sd.variables_) == len(jsd.variables_) == 2 + 16 * BERT[2]


def test_bert_fine_tune_step_matches_jax(bert):
    b, _, enc, ids, lab, head = bert
    sd, jsd = _both(b)
    _with_head(sd, enc, head, TrainingConfig, Adam)
    _with_head(jsd, enc, head, JTrainingConfig, JAdam)
    feeds = {"ids": ids, "lab": lab}
    got, want = sd.calculate_gradients(feeds), jsd.calculate_gradients(feeds)
    assert set(got) == set(want)
    for k in want:
        scale = max(float(np.abs(np.asarray(want[k])).max()), 1e-3)
        np.testing.assert_allclose(got[k], np.asarray(want[k]), rtol=0, atol=1e-4 * scale,
                                   err_msg=k)
    sd.fit(feeds=feeds)
    jsd.fit(feeds=feeds)
    np.testing.assert_allclose(sd.score(), float(jsd.score()), rtol=1e-6)
    for k, v in jsd.variables_.items():       # Adam's first step: lr a parameter at most
        np.testing.assert_allclose(_np(sd.variables_[k]), np.asarray(v), rtol=0, atol=1e-6,
                                   err_msg=k)


def test_shape_inputs_come_from_host_copies(bert, monkeypatch):
    """No shape input is read back from the graph's stored arrays (on the
    card that would wait for the device once a node)."""
    def refuse(self):
        raise AssertionError(f"read back {self.name}")
    monkeypatch.setattr(SDVariable, "get_arr", refuse)
    sd = import_onnx_model(bert[0], device="cpu")
    reshapes = [n for n in sd._nodes.values() if n.kind == "op" and n.op == "reshape_onnx"]
    assert len(reshapes) == 4 * BERT[2] and all(n.attrs["shape"] for n in reshapes)


def test_trainable_false_keeps_weights_constant(bert):
    sd = import_onnx_model(bert[0], trainable=False, device="cpu")
    assert not sd.variables_
    assert {n.kind for n in sd._nodes.values()} == {"placeholder", "constant", "op"}
