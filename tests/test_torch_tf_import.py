"""The port's TF import and protobuf codec against TensorFlow and the JAX
import (the only port test that imports TensorFlow; it skips without it).

- ``tf_proto`` decodes ``gd.SerializeToString()`` and encodes it back to
  bytes TF parses into an equal GraphDef; its field numbers are those of
  TF's own descriptors; ``make_ndarray`` equals ``tensor_util.MakeNdarray``
  on every Const of the corpus (the short-list fill rule included).
- Every graph of ``tests/test_tf_conformance_corpus.py``'s corpus (its
  control-flow graphs included) and ``tests/test_modelimport.py``'s
  mini-BERT, MLP, conv, depthwise, fused-BN + split, while-loop (TF1
  frames and functional) and cond (functional, Switch/Merge, nested,
  constant branch) graphs, imported by the port from bytes, equal TF's
  frozen function at the JAX tests' tolerances and equal the JAX import.
- The unmapped-op error is named as in the JAX package.
- ``chip_smoke.bert_graph_def`` at two small widths has the op histogram
  of bench.py's ``build_tf_bert_frozen`` at the same arguments, and its
  import equals TF's output within 1e-4; bench.py's head fine-tune over it
  takes 3 port steps equal to the JAX package's 3 (f32, 1e-5).
- The op cases whose golden is TensorFlow's (``test_torch_sd_ops.TF_GOLDEN``)
  pass the port's ``validate_case`` with that golden.
"""
import torch_test_threads  # noqa: F401  (first: one torch thread a worker)
import os

import numpy as np
import pytest
import torch

os.environ.setdefault("CUDA_VISIBLE_DEVICES", "-1")
os.environ.setdefault("TF_CPP_MIN_LOG_LEVEL", "3")
tf = pytest.importorskip("tensorflow")

from tensorflow.python.framework import tensor_util  # noqa: E402
from tensorflow.python.framework.convert_to_constants import (  # noqa: E402
    convert_variables_to_constants_v2)

import chip_smoke  # noqa: E402
from deeplearning4j_tpu.modelimport import import_graph_def as jax_import  # noqa: E402
from deeplearning4j_tpu_torch.autodiff.validation import validate_case  # noqa: E402
from deeplearning4j_tpu_torch.modelimport import import_graph_def, tf_proto  # noqa: E402
from deeplearning4j_tpu_torch.modelimport.tf_import import UnmappedTFOpException  # noqa: E402
from tests.test_modelimport import _tf_mini_bert, _while_fn  # noqa: E402
from tests.test_tf_conformance_corpus import CORPUS  # noqa: E402
from tests.test_torch_sd_ops import CASES, TF_GOLDEN, port_case  # noqa: E402


def _freeze(fn, *specs, lower_control_flow=True):
    frozen = convert_variables_to_constants_v2(
        tf.function(fn).get_concrete_function(*specs), lower_control_flow=lower_control_flow)
    return frozen.graph.as_graph_def(), frozen


def _outputs(frozen):
    return [t.name.split(":")[0] for t in frozen.outputs]


def _hold(gd, frozen, feeds, tol, what):
    """The port's import of `gd`'s bytes against TF's frozen function and
    the JAX import, on `feeds`."""
    sd = import_graph_def(gd.SerializeToString(), device="cpu")
    jsd = jax_import(gd)
    wants = frozen(*[tf.constant(v) for v in feeds.values()])
    wants = wants if isinstance(wants, (list, tuple)) else [wants]
    for name, want in zip(_outputs(frozen), wants):
        got = sd.output(feeds, name)[name].numpy()
        np.testing.assert_allclose(got, np.asarray(want), rtol=tol, atol=tol,
                                   err_msg=f"{what}:{name} against TF")
        np.testing.assert_allclose(got, np.asarray(jsd.output(feeds, name)[name]),
                                   rtol=tol, atol=tol, err_msg=f"{what}:{name} against JAX")
    return sd


# ---------------------------------------------------------------------------
# the codec
# ---------------------------------------------------------------------------

def test_codec_round_trips_tf_graphs():
    gd, _ = _freeze(*_mini_bert_fn())
    gd_while, _ = _freeze(_while_fn().python_function, tf.TensorSpec((3,), tf.float32),
                          lower_control_flow=False)
    from tensorflow.core.framework import graph_pb2
    for g in (gd, gd_while):
        data = g.SerializeToString()
        ours = tf_proto.GraphDef.FromString(data)
        back = graph_pb2.GraphDef()
        back.ParseFromString(ours.SerializeToString())
        assert back == g
        assert [n.name for n in ours.node] == [n.name for n in g.node]
    assert len(ours.library.function) >= 2          # the loop's cond and body
    for n, m in zip(gd.node, tf_proto.GraphDef.FromString(gd.SerializeToString()).node):
        if n.op == "Const":
            want = tensor_util.MakeNdarray(n.attr["value"].tensor)
            got = tf_proto.make_ndarray(m.attr["value"].tensor)
            assert got.dtype == want.dtype and np.array_equal(got, want), n.name


def test_field_numbers_equal_tf_descriptors():
    from tensorflow.core.framework import (attr_value_pb2, function_pb2, graph_pb2,
                                           node_def_pb2, op_def_pb2, tensor_pb2,
                                           tensor_shape_pb2, types_pb2, versions_pb2)
    pools = {m.DESCRIPTOR.full_name: m.DESCRIPTOR for mod in (
        attr_value_pb2, function_pb2, graph_pb2, node_def_pb2, op_def_pb2, tensor_pb2,
        tensor_shape_pb2, versions_pb2) for m in _messages(mod)}
    for cls, full in tf_proto.MESSAGES:
        desc = pools[full]
        theirs = {f.name: f.number for f in desc.fields}
        ours = {f.name: f.number for f in cls.FIELDS}
        assert all(theirs[k] == v for k, v in ours.items()), (full, ours, theirs)
    for name, value in types_pb2.DataType.items():
        if hasattr(tf_proto, name):
            assert getattr(tf_proto, name) == value, name


def _messages(mod):
    out = []

    def walk(desc_cls):
        out.append(desc_cls)
        for nested in desc_cls.DESCRIPTOR.nested_types:
            walk(getattr(desc_cls, nested.name))
    for name in dir(mod):
        obj = getattr(mod, name)
        if isinstance(obj, type) and hasattr(obj, "DESCRIPTOR") and hasattr(
                obj.DESCRIPTOR, "fields"):
            walk(obj)
    return out


def test_short_value_lists_fill_with_their_last_value():
    t = tf_proto.TensorProto(dtype=tf_proto.DT_FLOAT, tensor_shape=tf_proto.make_shape((2, 3)),
                             float_val=[1.5, 2.5])
    theirs = tensor_util.MakeNdarray(tf.make_tensor_proto(0.0).__class__.FromString(
        t.SerializeToString()))
    np.testing.assert_array_equal(tf_proto.make_ndarray(t), theirs)
    assert tf_proto.make_ndarray(t).tolist() == [[1.5, 2.5, 2.5], [2.5, 2.5, 2.5]]
    for value in (np.arange(6, dtype=np.int32).reshape(2, 3), np.float16(3.5),
                  np.array([True, False]), np.arange(4, dtype=np.int64) - 2):
        ours = tf_proto.make_tensor_proto(value)
        theirs = tensor_util.MakeNdarray(tf.make_tensor_proto(value).__class__.FromString(
            ours.SerializeToString()))
        np.testing.assert_array_equal(theirs, np.asarray(value))


# ---------------------------------------------------------------------------
# graphs against TF and the JAX import
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,fn,specs,inputs,tol", CORPUS, ids=[c[0] for c in CORPUS])
def test_corpus_graph_equals_tf_and_jax(name, fn, specs, inputs, tol):
    gd, frozen = _freeze(fn, *specs)
    _hold(gd, frozen, {s.name: a for s, a in zip(specs, inputs)}, tol, name)


def _mini_bert_fn():
    f, (_, T) = _tf_mini_bert()
    return f, tf.TensorSpec((2, T), tf.int32, name="ids")


def _mlp():
    w1 = tf.constant(np.random.RandomState(0).randn(5, 8).astype(np.float32))
    b1 = tf.constant(np.zeros(8, np.float32))
    w2 = tf.constant(np.random.RandomState(1).randn(8, 3).astype(np.float32))
    return (lambda x: tf.nn.softmax(tf.matmul(tf.nn.relu(tf.matmul(x, w1) + b1), w2)),
            tf.TensorSpec((None, 5), tf.float32, name="x"),
            np.random.RandomState(2).randn(4, 5).astype(np.float32), 1e-5)


def _conv():
    k = tf.constant(np.random.RandomState(0).randn(3, 3, 2, 4).astype(np.float32) * 0.1)

    def f(x):
        y = tf.nn.relu(tf.nn.conv2d(x, k, strides=[1, 1, 1, 1], padding="SAME"))
        return tf.reduce_mean(tf.nn.max_pool2d(y, 2, 2, padding="VALID"), axis=[1, 2])
    return (f, tf.TensorSpec((None, 8, 8, 2), tf.float32, name="x"),
            np.random.RandomState(1).rand(2, 8, 8, 2).astype(np.float32), 1e-4)


def _depthwise():
    k = tf.constant(np.random.RandomState(0).randn(3, 3, 2, 2).astype(np.float32) * 0.2)
    return (lambda x: tf.nn.relu(tf.nn.depthwise_conv2d(x, k, strides=[1, 1, 1, 1],
                                                         padding="SAME")),
            tf.TensorSpec((2, 6, 6, 2), tf.float32, name="x"),
            np.random.RandomState(1).randn(2, 6, 6, 2).astype(np.float32), 1e-4)


def _bn_split():
    g1 = tf.constant(np.random.RandomState(0).rand(4).astype(np.float32) + 0.5)
    b1 = tf.constant(np.random.RandomState(1).randn(4).astype(np.float32))
    mean = tf.constant(np.random.RandomState(2).randn(4).astype(np.float32))
    var = tf.constant(np.random.RandomState(3).rand(4).astype(np.float32) + 0.5)

    def f(x):
        y, _, _ = tf.compat.v1.nn.fused_batch_norm(x, g1, b1, mean=mean, variance=var,
                                                   epsilon=1e-3, is_training=False)
        a, b = tf.split(y, 2, axis=-1)
        return tf.concat([tf.nn.relu(a), tf.tanh(b)], axis=-1)
    return (f, tf.TensorSpec((2, 3, 3, 4), tf.float32, name="x"),
            np.random.RandomState(4).randn(2, 3, 3, 4).astype(np.float32), 1e-4)


def _mini_bert():
    f, spec = _mini_bert_fn()
    ids = np.random.RandomState(1).randint(0, 50, (2, spec.shape[1])).astype(np.int32)
    return f, spec, ids, 1e-4


@pytest.mark.parametrize("make", [_mlp, _conv, _depthwise, _bn_split, _mini_bert],
                         ids=["mlp", "conv", "depthwise", "fused-bn-split", "mini-bert"])
def test_modelimport_graph_equals_tf_and_jax(make):
    fn, spec, x, tol = make()
    gd, frozen = _freeze(fn, spec)
    _hold(gd, frozen, {spec.name: x}, tol, make.__name__)


def _cond(x):
    return tf.cond(tf.reduce_sum(x) > 0.0, lambda: x * 2.0, lambda: x - 1.0)


def _nested_cond(x):
    return tf.cond(tf.reduce_sum(x) > 0.0,
                   lambda: tf.cond(tf.reduce_max(x) > 2.0, lambda: x * 10.0, lambda: x * 2.0),
                   lambda: x - 1.0)


def _const_branch(x):
    return tf.cond(tf.reduce_sum(x) > 0.0, lambda: tf.constant([9.0, 9.0, 9.0]),
                   lambda: x - 1.0)


@pytest.mark.parametrize("fn,n,lower,want_op", [
    (_while_fn().python_function, 3, True, "Enter"),
    (_while_fn().python_function, 3, False, "While"),
    (_cond, 4, False, "If"),
    (_cond, 4, True, "Switch"),
    (_nested_cond, 3, True, "Switch"),
    (_const_branch, 3, True, "Switch"),
], ids=["while-v1-frames", "while-functional", "cond-functional", "cond-switch-merge",
        "cond-nested", "cond-constant-branch"])
def test_control_flow_graph_equals_tf_and_jax(fn, n, lower, want_op):
    gd, frozen = _freeze(fn, tf.TensorSpec((n,), tf.float32, name="x"),
                         lower_control_flow=lower)
    assert any(want_op in node.op for node in gd.node), sorted({nd.op for nd in gd.node})
    for x in ([1.0, 2.0, 3.0, 4.0], [-1.0, -2.0, -3.0, -4.0], [1.0, 1.0, 1.0, 1.0],
              [-1.0, -5.0, 2.5, 0.5]):
        _hold(gd, frozen, {"x": np.asarray(x[:n], np.float32)}, 1e-6, want_op)


def test_unmapped_op_error_is_named():
    gd, _ = _freeze(lambda x: tf.nn.depth_to_space(x, 2),
                    tf.TensorSpec((1, 4, 4, 4), tf.float32, name="x"))
    with pytest.raises(UnmappedTFOpException, match="Unmapped TF op 'DepthToSpace'"):
        import_graph_def(gd.SerializeToString(), device="cpu")


# ---------------------------------------------------------------------------
# chip_smoke's TF-free BERT GraphDef and bench.py's fine-tune
# ---------------------------------------------------------------------------

WIDTHS = [dict(batch=2, t=8, layers=2, hidden=32, heads=4, vocab=50),
          dict(batch=2, t=8, layers=3, hidden=48, heads=4, vocab=50)]


def _histogram(nodes):
    hist = {}
    for n in nodes:
        hist[n.op] = hist.get(n.op, 0) + 1
    return hist


@pytest.mark.parametrize("width", WIDTHS, ids=["L2-H32", "L3-H48"])
def test_bert_graph_def_has_tf_histogram_and_outputs(width):
    from bench import build_tf_bert_frozen
    gd, frozen, enc = build_tf_bert_frozen(**width)
    data, w, ours_enc = chip_smoke.bert_graph_def(**width)
    ours = tf_proto.GraphDef.FromString(data)
    assert _histogram(ours.node) == _histogram(gd.node)
    assert len(ours.node) == 7 + 85 * width["layers"]
    ids = np.random.RandomState(1).randint(0, width["vocab"], (2, width["t"])).astype(np.int32)
    want = frozen(tf.constant(ids))[0].numpy()
    sd = import_graph_def(data, device="cpu")
    got = sd.output({"ids": ids}, ours_enc)[ours_enc].numpy()
    np.testing.assert_allclose(got, want, atol=1e-4 * np.abs(want).max(), rtol=0)
    plain = chip_smoke.bert_plain_forward(w, torch.as_tensor(ids), width["layers"],
                                          width["heads"]).numpy()
    np.testing.assert_allclose(plain, want, atol=1e-4 * np.abs(want).max(), rtol=0)


def test_bench_head_fine_tune_equals_the_jax_package():
    """bench.py's head over the imported graph: 3 Adam(1e-4) steps from
    the same head_w in both packages."""
    from deeplearning4j_tpu.autodiff import TrainingConfig as JTrainingConfig
    from deeplearning4j_tpu.train.updaters import Adam as JAdam
    from deeplearning4j_tpu_torch.autodiff import TrainingConfig
    from deeplearning4j_tpu_torch.train import Adam
    width = WIDTHS[0]
    B, T, V, H = width["batch"], width["t"], width["vocab"], width["hidden"]
    data, _, enc = chip_smoke.bert_graph_def(**width)
    head = np.random.RandomState(3).randn(H, V).astype(np.float32) * 0.1
    rs = np.random.RandomState(0)
    ids = rs.randint(0, V, (B, T)).astype(np.int32)
    lab = rs.randint(0, V, (B, T)).astype(np.int32)
    graphs = []
    for imp, tc, adam in ((lambda: import_graph_def(data, device="cpu"), TrainingConfig, Adam),
                          (lambda: jax_import(data_to_tf(data)), JTrainingConfig, JAdam)):
        sd = imp()
        w_head = sd.var("head_w", head)
        logits = sd.op("matmul", sd.get_variable(enc), w_head, name="logits")
        sd.loss.sparse_softmax_cross_entropy(sd.placeholder("lab", (B, T)), logits,
                                             name="loss")
        sd.set_loss_variables("loss")
        sd.set_training_config(tc(updater=adam(1e-4), data_set_feature_mapping=["ids"],
                                  data_set_label_mapping=["lab"]))
        graphs.append(sd)
    port, jsd = graphs
    for _ in range(3):
        port.fit(ids, lab)
        jsd.fit(ids, lab)
        np.testing.assert_allclose(port.score(), jsd.score(), rtol=1e-5)
    np.testing.assert_allclose(port.variables_["head_w"].numpy(),
                               np.asarray(jsd.variables_["head_w"]), rtol=1e-5, atol=1e-7)


def data_to_tf(data):
    from tensorflow.core.framework import graph_pb2
    gd = graph_pb2.GraphDef()
    gd.ParseFromString(data)
    return gd


@pytest.mark.parametrize("case", [c for c in CASES if c.id in TF_GOLDEN],
                         ids=lambda c: c.id)
def test_op_case_against_its_tf_golden(case):
    validate_case(port_case(case, tf_golden=True))
