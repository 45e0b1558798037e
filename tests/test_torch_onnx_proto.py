"""The port's ONNX codec (``modelimport/onnx_proto.py``) against the JAX
package's.

- the writer gives the JAX writer's bytes for the same model, built in
  each package from the same numpy arrays: every message, every attribute
  type, dynamic dims, every dtype of the JAX ``test_tensorproto_dtypes``;
- bytes written by either package parse in the other to the same fields
  and arrays (``load_model`` from bytes and from a path, ``save_model``);
- tensors in the typed fields (``float_data``, ``int32_data``,
  ``int64_data``, ``double_data``), which only a foreign writer produces,
  read alike; bfloat16 reads as its uint16 bits here (numpy has no
  bfloat16), the bits of the JAX package's ``ml_dtypes`` array.
"""
import torch_test_threads  # noqa: F401  (first: one torch thread a worker)
import numpy as np
import pytest

from deeplearning4j_tpu.modelimport import onnx_proto as jp
from deeplearning4j_tpu_torch.modelimport import onnx_proto as tp

DTYPES = [np.arange(6, dtype=np.int64).reshape(2, 3), np.ones((2, 2), np.float32),
          np.array([True, False]), np.arange(4, dtype=np.float16),
          np.arange(-3, 3, dtype=np.int8), np.arange(5, dtype=np.uint8),
          np.arange(4, dtype=np.int32).reshape(2, 2), np.linspace(0, 1, 3),
          np.arange(3, dtype=np.int16), np.arange(3, dtype=np.uint16),
          np.arange(3, dtype=np.uint32), np.arange(3, dtype=np.uint64)]


def _model(p, seed=0):
    """One model through package `p`'s classes: every attribute type, a
    subgraph, dynamic and static dims, initializers of several dtypes."""
    rs = np.random.RandomState(seed)
    w = rs.randn(4, 3).astype(np.float32)
    sub = p.GraphProto(name="body", node=[p.NodeProto(op_type="Relu", input=["a"],
                                                      output=["b"])])
    attrs = [p.attr_f("alpha", 0.25), p.attr_i("transB", 1), p.attr_i("neg", -7),
             p.attr_s("mode", "reflect"), p.attr_ints("pads", [0, 1, -2, 3]),
             p.attr_t("value", rs.randn(2, 2).astype(np.float32)),
             p.AttributeProto(name="scales", type=p.ATTR_FLOATS, floats=[0.5, 2.0]),
             p.AttributeProto(name="names", type=p.ATTR_STRINGS, strings=[b"x", b"yz"]),
             p.AttributeProto(name="body", type=p.ATTR_GRAPH, g=sub)]
    nodes = [p.NodeProto(op_type="Gemm", name="gemm", input=["x", "w", ""], output=["y"],
                         attribute=attrs),
             p.NodeProto(op_type="Identity", input=["y"], output=["z"], domain="")]
    inits = [p.TensorProto.from_array(w, "w")] + [
        p.TensorProto.from_array(a, f"t{i}") for i, a in enumerate(DTYPES)]
    g = p.GraphProto(name="g", node=nodes, initializer=inits,
                     input=[p.ValueInfoProto(name="x", shape=[None, 3]),
                            p.ValueInfoProto(name="ids", elem_type=p.INT64, shape=[2, 8])],
                     output=[p.ValueInfoProto(name="z", shape=[None, 4])])
    return p.ModelProto(ir_version=8, opset_version=17, graph=g)


def test_writer_bytes_equal_the_jax_writers():
    assert _model(tp).serialize() == _model(jp).serialize()
    assert _model(tp, 3).serialize() == _model(jp, 3).serialize()
    for a in DTYPES:
        assert tp.TensorProto.from_array(a, "t").serialize() == \
            jp.TensorProto.from_array(a, "t").serialize()


def _same_model(a, b):
    assert (a.ir_version, a.producer_name, a.opset_version) == \
        (b.ir_version, b.producer_name, b.opset_version)
    ga, gb = a.graph, b.graph
    assert ga.name == gb.name
    assert [(n.op_type, n.name, n.input, n.output, n.domain) for n in ga.node] == \
        [(n.op_type, n.name, n.input, n.output, n.domain) for n in gb.node]
    for na, nb in zip(ga.node, gb.node):
        for x, y in zip(na.attribute, nb.attribute):
            assert (x.name, x.type, x.f, x.i, x.s, x.floats, x.ints, x.strings) == \
                (y.name, y.type, y.f, y.i, y.s, y.floats, y.ints, y.strings)
            assert (x.t is None) == (y.t is None) and (x.g is None) == (y.g is None)
            if x.t is not None:
                np.testing.assert_array_equal(x.t.to_array(), y.t.to_array())
            if x.g is not None:
                assert [n.op_type for n in x.g.node] == [n.op_type for n in y.g.node]
    for ta, tb in zip(ga.initializer, gb.initializer):
        assert (ta.name, ta.dims, ta.data_type) == (tb.name, tb.dims, tb.data_type)
        xa, xb = ta.to_array(), tb.to_array()
        assert xa.dtype == xb.dtype
        np.testing.assert_array_equal(xa, xb)
    for va, vb in zip(ga.input + ga.output, gb.input + gb.output):
        assert (va.name, va.elem_type, va.shape) == (vb.name, vb.elem_type, vb.shape)


@pytest.mark.parametrize("writer,reader", [(tp, jp), (jp, tp), (tp, tp)],
                         ids=["port-to-jax", "jax-to-port", "port-to-port"])
def test_round_trip_across_the_codecs(writer, reader, tmp_path):
    m = _model(writer)
    path = str(tmp_path / "m.onnx")
    writer.save_model(m, path)
    back = reader.load_model(path)
    _same_model(back, jp.load_model(m.serialize()))
    _same_model(reader.load_model(bytearray(m.serialize())), back)
    assert back.graph.input[0].shape == [None, 3]
    assert back.graph.node[0].attribute[2].i == -7
    np.testing.assert_array_equal(back.graph.initializer[0].to_array(),
                                  _model(jp).graph.initializer[0].to_array())


@pytest.mark.parametrize("arr", DTYPES[:4], ids=["int64", "float32", "bool", "float16"])
def test_tensorproto_dtypes(arr):
    """The JAX package's test_tensorproto_dtypes, in the port and across."""
    t = tp.TensorProto.from_array(arr, "t")
    for back in (tp.TensorProto.parse(t.serialize()).to_array(),
                 jp.TensorProto.parse(t.serialize()).to_array(),
                 tp.TensorProto.parse(jp.TensorProto.from_array(arr, "t").serialize()).to_array()):
        np.testing.assert_array_equal(back, arr)
        assert back.dtype == arr.dtype
    assert tp.dt_of_np(arr.dtype) == jp.dt_of_np(arr.dtype)
    assert tp.dtype_name(tp.dt_of_np(arr.dtype)) == arr.dtype.name


def _typed(fn, payload, dims, dt):
    """A TensorProto whose data sits in a typed field (as foreign writers
    put it): dims, data_type, then field `fn` packed."""
    return tp._packed_i64(1, dims) + tp._iv(2, dt) + tp._ld(fn, payload)


@pytest.mark.parametrize("fn,payload,dt,want", [
    (4, np.float32([1.5, -2.0, 3.25]).astype("<f4").tobytes(), tp.FLOAT,
     np.float32([1.5, -2.0, 3.25])),
    (7, b"".join(tp._varint(v) for v in (5, -3, 1 << 40)), tp.INT64,
     np.int64([5, -3, 1 << 40])),
    (5, b"".join(tp._varint(v) for v in (1, 0, 1)), tp.BOOL, np.array([True, False, True])),
    (5, b"".join(tp._varint(v) for v in (-4, 7, 100)), tp.INT8, np.int8([-4, 7, 100])),
    (10, np.float64([0.1, -1e300, 2.5]).astype("<f8").tobytes(), tp.DOUBLE,
     np.float64([0.1, -1e300, 2.5]))], ids=["float_data", "int64_data", "int32_data-bool",
                                            "int32_data-int8", "double_data"])
def test_typed_fields_read_alike(fn, payload, dt, want):
    buf = _typed(fn, payload, [3], dt)
    got, ref = tp.TensorProto.parse(buf).to_array(), jp.TensorProto.parse(buf).to_array()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, ref)
    assert got.dtype == ref.dtype == want.dtype


def test_bfloat16_reads_as_its_bits():
    import ml_dtypes
    a = np.asarray([1.0, -2.5, 3.0e38, 1e-3], ml_dtypes.bfloat16)
    buf = jp.TensorProto.from_array(a, "b").serialize()
    got = tp.TensorProto.parse(buf)
    assert got.data_type == tp.BFLOAT16 and tp.dtype_name(got.data_type) == "bfloat16"
    np.testing.assert_array_equal(got.to_array(), a.view(np.uint16))
    assert tp.ValueInfoProto.parse(tp.ValueInfoProto(
        name="h", elem_type=tp.BFLOAT16, shape=[2]).serialize()).elem_type == tp.BFLOAT16
    with pytest.raises(ValueError, match="data_type 99"):
        tp._np_dtype(99)
