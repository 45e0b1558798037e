"""A protobuf wire-format codec for ONNX models, with no ``onnx`` or
``protobuf`` package (the port of ``modelimport/onnx_proto.py``; the port
keeps its own copy and imports nothing of the JAX package).

It decodes and encodes the subset of the public ``onnx/onnx.proto`` schema
that model import and export need: ModelProto, GraphProto, NodeProto,
TensorProto, AttributeProto and ValueInfoProto, with the published field
numbers (stable since IR v3).  The writer gives the same bytes as the JAX
package's writer for the same model, field for field.

Reference: `nd4j/samediff-import/samediff-import-onnx` reads the same
messages through the official generated bindings.

bfloat16 tensors come back from :meth:`TensorProto.to_array` as their
uint16 bit patterns (numpy has no bfloat16); :func:`dtype_name` names a
``data_type`` as the graph engine does (``"bfloat16"`` included).
"""
from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

# ---------------------------------------------------------------------------
# wire-format primitives
# ---------------------------------------------------------------------------


def _read_varint(buf: bytes, i: int):
    r = 0
    shift = 0
    while True:
        b = buf[i]
        i += 1
        r |= (b & 0x7F) << shift
        if not b & 0x80:
            return r, i
        shift += 7


def _s64(v: int) -> int:
    return v - (1 << 64) if v >= (1 << 63) else v


def _fields(buf: bytes):
    """Yield (field_number, wire_type, value) over one message's bytes."""
    i, n = 0, len(buf)
    while i < n:
        key, i = _read_varint(buf, i)
        fn, wt = key >> 3, key & 7
        if wt == 0:
            v, i = _read_varint(buf, i)
        elif wt == 1:
            v = buf[i:i + 8]
            i += 8
        elif wt == 2:
            ln, i = _read_varint(buf, i)
            v = buf[i:i + ln]
            i += ln
        elif wt == 5:
            v = buf[i:i + 4]
            i += 4
        else:
            raise ValueError(f"unsupported protobuf wire type {wt}")
        yield fn, wt, v


def _rep_f32(wt, v) -> List[float]:
    if wt == 5:
        return [struct.unpack("<f", v)[0]]
    return [x[0] for x in struct.iter_unpack("<f", v)]


def _rep_f64(wt, v) -> List[float]:
    if wt == 1:
        return [struct.unpack("<d", v)[0]]
    return [x[0] for x in struct.iter_unpack("<d", v)]


def _rep_i64(wt, v) -> List[int]:
    if wt == 0:
        return [_s64(v)]
    out, i = [], 0
    while i < len(v):
        x, i = _read_varint(v, i)
        out.append(_s64(x))
    return out


def _varint(v: int) -> bytes:
    if v < 0:
        v += 1 << 64
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        out.append(b | 0x80 if v else b)
        if not v:
            return bytes(out)


def _tag(fn: int, wt: int) -> bytes:
    return _varint((fn << 3) | wt)


def _ld(fn: int, payload: bytes) -> bytes:
    return _tag(fn, 2) + _varint(len(payload)) + payload


def _st(fn: int, s) -> bytes:
    return _ld(fn, s.encode() if isinstance(s, str) else s)


def _iv(fn: int, v: int) -> bytes:
    return _tag(fn, 0) + _varint(v)


def _f32(fn: int, v: float) -> bytes:
    return _tag(fn, 5) + struct.pack("<f", v)


def _packed_i64(fn: int, vals) -> bytes:
    return _ld(fn, b"".join(_varint(v) for v in vals))


def _packed_f32(fn: int, vals) -> bytes:
    return _ld(fn, b"".join(struct.pack("<f", v) for v in vals))


# ---------------------------------------------------------------------------
# messages (field numbers = public onnx.proto)
# ---------------------------------------------------------------------------

# TensorProto.DataType
FLOAT, UINT8, INT8, UINT16, INT16, INT32, INT64 = 1, 2, 3, 4, 5, 6, 7
STRING, BOOL, FLOAT16, DOUBLE, UINT32, UINT64 = 8, 9, 10, 11, 12, 13
BFLOAT16 = 16

_NP_OF_DT = {FLOAT: np.float32, UINT8: np.uint8, INT8: np.int8,
             UINT16: np.uint16, INT16: np.int16, INT32: np.int32,
             INT64: np.int64, BOOL: np.bool_, FLOAT16: np.float16,
             DOUBLE: np.float64, UINT32: np.uint32, UINT64: np.uint64}


def _np_dtype(dt: int):
    """The numpy dtype a tensor of `dt` reads as (bfloat16 as uint16
    bits)."""
    if dt == BFLOAT16:
        return np.dtype(np.uint16)
    if dt not in _NP_OF_DT:
        raise ValueError(f"unsupported ONNX tensor data_type {dt}")
    return np.dtype(_NP_OF_DT[dt])


def dtype_name(dt: int) -> str:
    """The graph engine's dtype name of an ONNX ``data_type``."""
    return "bfloat16" if dt == BFLOAT16 else _np_dtype(dt).name


def dt_of_np(dtype) -> int:
    dtype = np.dtype(dtype)
    for dt, np_t in _NP_OF_DT.items():
        if np.dtype(np_t) == dtype:
            return dt
    if dtype.name == "bfloat16":
        return BFLOAT16
    raise ValueError(f"no ONNX data_type for numpy dtype {dtype}")


@dataclass
class TensorProto:
    name: str = ""
    dims: List[int] = field(default_factory=list)
    data_type: int = FLOAT
    raw_data: bytes = b""
    float_data: List[float] = field(default_factory=list)
    int32_data: List[int] = field(default_factory=list)
    int64_data: List[int] = field(default_factory=list)
    double_data: List[float] = field(default_factory=list)

    @staticmethod
    def parse(buf: bytes) -> "TensorProto":
        t = TensorProto()
        for fn, wt, v in _fields(buf):
            if fn == 1:
                t.dims += _rep_i64(wt, v)
            elif fn == 2:
                t.data_type = v
            elif fn == 4:
                t.float_data += _rep_f32(wt, v)
            elif fn == 5:
                t.int32_data += _rep_i64(wt, v)
            elif fn == 7:
                t.int64_data += _rep_i64(wt, v)
            elif fn == 8:
                t.name = v.decode()
            elif fn == 9:
                t.raw_data = v
            elif fn == 10:
                t.double_data += _rep_f64(wt, v)
        return t

    def to_array(self) -> np.ndarray:
        dt = _np_dtype(self.data_type)
        if self.raw_data:
            a = np.frombuffer(self.raw_data, dtype=dt)
        elif self.float_data:
            a = np.asarray(self.float_data, dt)
        elif self.int64_data:
            a = np.asarray(self.int64_data, dt)
        elif self.double_data:
            a = np.asarray(self.double_data, dt)
        elif self.int32_data:
            # int32_data also carries int8/16/bool/fp16 payloads per spec
            a = np.asarray(self.int32_data).astype(dt)
        else:
            a = np.zeros(0, dt)
        return a.reshape(self.dims)

    @staticmethod
    def from_array(arr: np.ndarray, name: str = "") -> "TensorProto":
        arr = np.ascontiguousarray(arr)
        return TensorProto(name=name, dims=list(arr.shape),
                           data_type=dt_of_np(arr.dtype),
                           raw_data=arr.tobytes())

    def serialize(self) -> bytes:
        out = _packed_i64(1, self.dims) + _iv(2, self.data_type)
        if self.name:
            out += _st(8, self.name)
        out += _ld(9, self.raw_data)
        return out


# AttributeProto.AttributeType
ATTR_FLOAT, ATTR_INT, ATTR_STRING, ATTR_TENSOR, ATTR_GRAPH = 1, 2, 3, 4, 5
ATTR_FLOATS, ATTR_INTS, ATTR_STRINGS = 6, 7, 8


@dataclass
class AttributeProto:
    name: str = ""
    type: int = 0
    f: float = 0.0
    i: int = 0
    s: bytes = b""
    t: Optional[TensorProto] = None
    g: Optional["GraphProto"] = None
    floats: List[float] = field(default_factory=list)
    ints: List[int] = field(default_factory=list)
    strings: List[bytes] = field(default_factory=list)

    @staticmethod
    def parse(buf: bytes) -> "AttributeProto":
        a = AttributeProto()
        for fn, wt, v in _fields(buf):
            if fn == 1:
                a.name = v.decode()
            elif fn == 2:
                a.f = struct.unpack("<f", v)[0]
            elif fn == 3:
                a.i = _s64(v)
            elif fn == 4:
                a.s = v
            elif fn == 5:
                a.t = TensorProto.parse(v)
            elif fn == 6:
                a.g = GraphProto.parse(v)
            elif fn == 7:
                a.floats += _rep_f32(wt, v)
            elif fn == 8:
                a.ints += _rep_i64(wt, v)
            elif fn == 9:
                a.strings.append(v)
            elif fn == 20:
                a.type = v
        return a

    def serialize(self) -> bytes:
        out = _st(1, self.name)
        if self.type == ATTR_FLOAT:
            out += _tag(2, 5) + struct.pack("<f", self.f)
        elif self.type == ATTR_INT:
            out += _iv(3, self.i)
        elif self.type == ATTR_STRING:
            out += _st(4, self.s)
        elif self.type == ATTR_TENSOR:
            out += _ld(5, self.t.serialize())
        elif self.type == ATTR_GRAPH:
            out += _ld(6, self.g.serialize())
        elif self.type == ATTR_FLOATS:
            out += _packed_f32(7, self.floats)
        elif self.type == ATTR_INTS:
            out += _packed_i64(8, self.ints)
        elif self.type == ATTR_STRINGS:
            for s in self.strings:
                out += _st(9, s)
        out += _iv(20, self.type)
        return out


def attr_f(name, v):
    return AttributeProto(name=name, type=ATTR_FLOAT, f=float(v))


def attr_i(name, v):
    return AttributeProto(name=name, type=ATTR_INT, i=int(v))


def attr_s(name, v):
    return AttributeProto(name=name, type=ATTR_STRING,
                          s=v.encode() if isinstance(v, str) else v)


def attr_ints(name, vs):
    return AttributeProto(name=name, type=ATTR_INTS,
                          ints=[int(v) for v in vs])


def attr_t(name, arr):
    return AttributeProto(name=name, type=ATTR_TENSOR,
                          t=TensorProto.from_array(np.asarray(arr)))


@dataclass
class NodeProto:
    op_type: str = ""
    name: str = ""
    input: List[str] = field(default_factory=list)
    output: List[str] = field(default_factory=list)
    attribute: List[AttributeProto] = field(default_factory=list)
    domain: str = ""

    @staticmethod
    def parse(buf: bytes) -> "NodeProto":
        n = NodeProto()
        for fn, _, v in _fields(buf):
            if fn == 1:
                n.input.append(v.decode())
            elif fn == 2:
                n.output.append(v.decode())
            elif fn == 3:
                n.name = v.decode()
            elif fn == 4:
                n.op_type = v.decode()
            elif fn == 5:
                n.attribute.append(AttributeProto.parse(v))
            elif fn == 7:
                n.domain = v.decode()
        return n

    def serialize(self) -> bytes:
        out = b""
        for s in self.input:
            out += _st(1, s)
        for s in self.output:
            out += _st(2, s)
        if self.name:
            out += _st(3, self.name)
        out += _st(4, self.op_type)
        for a in self.attribute:
            out += _ld(5, a.serialize())
        return out


@dataclass
class ValueInfoProto:
    """input/output declaration: name + elem type + shape (None = dynamic)."""
    name: str = ""
    elem_type: int = FLOAT
    shape: Optional[List[Optional[int]]] = None

    @staticmethod
    def parse(buf: bytes) -> "ValueInfoProto":
        vi = ValueInfoProto()
        for fn, _, v in _fields(buf):
            if fn == 1:
                vi.name = v.decode()
            elif fn == 2:                       # TypeProto
                for f2, _, v2 in _fields(v):
                    if f2 == 1:                 # TypeProto.Tensor
                        for f3, _, v3 in _fields(v2):
                            if f3 == 1:
                                vi.elem_type = v3
                            elif f3 == 2:       # TensorShapeProto
                                dims = []
                                for f4, _, v4 in _fields(v3):
                                    if f4 == 1:  # Dimension
                                        dv = None
                                        for f5, _, v5 in _fields(v4):
                                            if f5 == 1:
                                                dv = _s64(v5)
                                        dims.append(dv)
                                vi.shape = dims
        return vi

    def serialize(self) -> bytes:
        shape_pb = b""
        for d in (self.shape or []):
            dim_pb = _iv(1, d) if d is not None else _st(2, "dyn")
            shape_pb += _ld(1, dim_pb)
        tensor_pb = _iv(1, self.elem_type) + _ld(2, shape_pb)
        type_pb = _ld(1, tensor_pb)
        return _st(1, self.name) + _ld(2, type_pb)


@dataclass
class GraphProto:
    name: str = "graph"
    node: List[NodeProto] = field(default_factory=list)
    initializer: List[TensorProto] = field(default_factory=list)
    input: List[ValueInfoProto] = field(default_factory=list)
    output: List[ValueInfoProto] = field(default_factory=list)

    @staticmethod
    def parse(buf: bytes) -> "GraphProto":
        g = GraphProto()
        for fn, _, v in _fields(buf):
            if fn == 1:
                g.node.append(NodeProto.parse(v))
            elif fn == 2:
                g.name = v.decode()
            elif fn == 5:
                g.initializer.append(TensorProto.parse(v))
            elif fn == 11:
                g.input.append(ValueInfoProto.parse(v))
            elif fn == 12:
                g.output.append(ValueInfoProto.parse(v))
        return g

    def serialize(self) -> bytes:
        # one join: appending to a bytes object copies all before it, which
        # a model of 0.4 GB of initializers pays once an initializer
        return b"".join([_ld(1, n.serialize()) for n in self.node] + [_st(2, self.name)]
                        + [_ld(5, t.serialize()) for t in self.initializer]
                        + [_ld(11, vi.serialize()) for vi in self.input]
                        + [_ld(12, vi.serialize()) for vi in self.output])


@dataclass
class ModelProto:
    ir_version: int = 8
    producer_name: str = "deeplearning4j_tpu"
    opset_version: int = 17
    graph: GraphProto = field(default_factory=GraphProto)

    @staticmethod
    def parse(buf: bytes) -> "ModelProto":
        m = ModelProto()
        for fn, _, v in _fields(buf):
            if fn == 1:
                m.ir_version = v
            elif fn == 2:
                m.producer_name = v.decode()
            elif fn == 7:
                m.graph = GraphProto.parse(v)
            elif fn == 8:                       # OperatorSetIdProto
                for f2, _, v2 in _fields(v):
                    if f2 == 2:
                        m.opset_version = _s64(v2)
        return m

    def serialize(self) -> bytes:
        opset = _st(1, "") + _iv(2, self.opset_version)
        return (_iv(1, self.ir_version) + _st(2, self.producer_name)
                + _ld(7, self.graph.serialize()) + _ld(8, opset))


def load_model(path_or_bytes) -> ModelProto:
    if isinstance(path_or_bytes, (bytes, bytearray)):
        return ModelProto.parse(bytes(path_or_bytes))
    with open(path_or_bytes, "rb") as f:
        return ModelProto.parse(f.read())


def save_model(model: ModelProto, path: str):
    with open(path, "wb") as f:
        f.write(model.serialize())
