"""A protobuf wire-format codec for TensorFlow's GraphDef, with no
``tensorflow`` or ``protobuf`` package (the counterpart of TF's generated
bindings, as ``onnx_proto.py`` is of onnx's in the JAX package).

It decodes and encodes the messages a frozen graph is made of, with field
numbers from TF's published ``.proto`` files:

* ``graph.proto``: GraphDef (node, library, versions);
* ``node_def.proto``: NodeDef (name, op, input, device, attr);
* ``attr_value.proto``: AttrValue (s, i, f, b, type, shape, tensor, list,
  func, placeholder), its ListValue and NameAttrList;
* ``tensor.proto``: TensorProto (dtype, tensor_shape, tensor_content and
  the typed ``*_val`` fields);
* ``tensor_shape.proto``: TensorShapeProto and its Dim;
* ``function.proto``: FunctionDefLibrary, FunctionDef (signature, attr,
  node_def, ret, control_ret) and GradientDef; ``op_def.proto``'s OpDef,
  ArgDef and AttrDef for a function's signature;
* ``versions.proto``: VersionDef; ``types.proto``: the DataType enum.

Messages read like the generated Python classes where the importer reads
them: ``node.attr["T"].type``, ``node.attr["shape"].shape.dim[0].size``,
``"epsilon" in node.attr``; an unset singular field reads as its default
(a fresh message for a message field), and a missing map key reads as a
default message without being inserted.  Presence is kept for every
field, so a oneof member set to its default (``b: false``) is written
back.  Fields this module does not model are kept as raw bytes and
written back unchanged, so ``decode`` then ``encode`` keeps a graph whole.

:func:`make_ndarray` turns a TensorProto into a numpy array with TF's
rules (``tensor_content`` first, else the typed list, a short list filled
with its last value); :func:`make_tensor_proto` goes the other way.
bfloat16 values come back as their uint16 bit patterns (numpy has no
bfloat16).
"""
from __future__ import annotations

import os
import struct
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import numpy as np

# ---------------------------------------------------------------------------
# types.proto: DataType
# ---------------------------------------------------------------------------

DT_INVALID = 0
DT_FLOAT = 1
DT_DOUBLE = 2
DT_INT32 = 3
DT_UINT8 = 4
DT_INT16 = 5
DT_INT8 = 6
DT_STRING = 7
DT_COMPLEX64 = 8
DT_INT64 = 9
DT_BOOL = 10
DT_QINT8 = 11
DT_QUINT8 = 12
DT_QINT32 = 13
DT_BFLOAT16 = 14
DT_QINT16 = 15
DT_QUINT16 = 16
DT_UINT16 = 17
DT_COMPLEX128 = 18
DT_HALF = 19
DT_RESOURCE = 20
DT_VARIANT = 21
DT_UINT32 = 22
DT_UINT64 = 23

#: DataType -> numpy dtype name (bfloat16 as its uint16 bits)
NUMPY_DTYPES = {
    DT_FLOAT: "float32", DT_DOUBLE: "float64", DT_INT32: "int32",
    DT_UINT8: "uint8", DT_INT16: "int16", DT_INT8: "int8", DT_INT64: "int64",
    DT_BOOL: "bool", DT_HALF: "float16", DT_BFLOAT16: "uint16",
    DT_UINT16: "uint16", DT_UINT32: "uint32", DT_UINT64: "uint64",
    DT_COMPLEX64: "complex64", DT_COMPLEX128: "complex128", DT_STRING: "object",
}
#: DataType -> the dtype name the graph engine uses
DTYPE_NAMES = {**NUMPY_DTYPES, DT_BFLOAT16: "bfloat16"}
_FROM_NUMPY = {"float32": DT_FLOAT, "float64": DT_DOUBLE, "int32": DT_INT32,
               "uint8": DT_UINT8, "int16": DT_INT16, "int8": DT_INT8,
               "int64": DT_INT64, "bool": DT_BOOL, "float16": DT_HALF,
               "uint16": DT_UINT16, "uint32": DT_UINT32, "uint64": DT_UINT64,
               "complex64": DT_COMPLEX64, "complex128": DT_COMPLEX128}


def dtype_name(dt: int) -> str:
    """The engine's dtype name of a DataType (``"float32"``, ...)."""
    if dt not in DTYPE_NAMES:
        raise ValueError(f"unsupported TF DataType {dt}")
    return DTYPE_NAMES[dt]


def data_type(dtype) -> int:
    """The DataType of a numpy dtype (or dtype name)."""
    return _FROM_NUMPY[np.dtype(dtype).name]


# ---------------------------------------------------------------------------
# wire format
# ---------------------------------------------------------------------------

VARINT, I64, LEN, I32 = 0, 1, 2, 5


def _read_varint(buf, pos: int) -> Tuple[int, int]:
    result = shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _varint(v: int) -> bytes:
    if v < 0:
        v += 1 << 64
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _key(number: int, wire: int) -> bytes:
    return _varint((number << 3) | wire)


def _signed(v: int, bits: int) -> int:
    v &= (1 << bits) - 1
    return v - (1 << bits) if v >> (bits - 1) else v


# scalar kinds: (wire type, decode raw -> value, encode value -> raw bytes)
_SCALAR = {
    "int32": VARINT, "int64": VARINT, "uint32": VARINT, "uint64": VARINT,
    "bool": VARINT, "enum": VARINT, "float": I32, "double": I64,
    "string": LEN, "bytes": LEN,
}


def _from_varint(kind: str, v: int):
    if kind in ("int32", "enum"):
        return _signed(v, 32)
    if kind == "int64":
        return _signed(v, 64)
    if kind == "uint32":
        return v & 0xFFFFFFFF
    if kind == "bool":
        return bool(v)
    return v


def _default(kind: str):
    return {"float": 0.0, "double": 0.0, "string": "", "bytes": b"",
            "bool": False}.get(kind, 0)


class Field(NamedTuple):
    number: int
    name: str
    kind: str                  # a scalar kind, "message" or "map"
    repeated: bool = False
    msg: Any = None            # message class name (resolved lazily)
    key: str = ""              # map key kind
    value: Any = None          # map value kind or message class name


_REGISTRY: Dict[str, type] = {}


def _cls(name):
    return _REGISTRY[name] if isinstance(name, str) else name


class AttrMap(dict):
    """A map<string, Message> field: a missing key reads as a default
    message and is not inserted (the importer probes optional attrs)."""

    def __init__(self, value_cls=None, *a, **kw):
        super().__init__(*a, **kw)
        self._value_cls = value_cls

    def __missing__(self, key):
        if self._value_cls is None:
            raise KeyError(key)
        return _cls(self._value_cls)()


class Message:
    """A protobuf message: FIELDS lists (number, name, kind, ...)."""

    FIELDS: Tuple[Field, ...] = ()
    _by_name: Dict[str, Field]
    _by_number: Dict[int, Field]

    def __init_subclass__(cls, **kw):
        super().__init_subclass__(**kw)
        cls._by_name = {f.name: f for f in cls.FIELDS}
        cls._by_number = {f.number: f for f in cls.FIELDS}
        _REGISTRY[cls.__name__] = cls

    def __init__(self, **values):
        object.__setattr__(self, "_values", {})
        object.__setattr__(self, "_unknown", [])
        for k, v in values.items():
            setattr(self, k, v)

    # ---- field access ----
    def __getattr__(self, name):
        f = type(self)._by_name.get(name)
        if f is None:
            raise AttributeError(f"{type(self).__name__} has no field {name!r}")
        vals = self._values
        if name in vals:
            return vals[name]
        if f.kind == "map":
            m = AttrMap(f.value if _is_msg_kind(f.value) else None)
            vals[name] = m
            return m
        if f.repeated:
            vals[name] = []
            return vals[name]
        if f.kind == "message":
            return _cls(f.msg)()
        return _default(f.kind)

    def __setattr__(self, name, value):
        f = type(self)._by_name.get(name)
        if f is None:
            raise AttributeError(f"{type(self).__name__} has no field {name!r}")
        if f.kind == "map":
            m = AttrMap(f.value if _is_msg_kind(f.value) else None)
            m.update(value)
            value = m
        elif f.repeated:
            value = list(value)
        self._values[name] = value

    def _set_values(self) -> dict:
        return {k: v for k, v in self._values.items()
                if not (isinstance(v, (list, dict)) and not v)}

    def __eq__(self, other):  # for tests: equal set fields and unknown bytes
        return (type(self) is type(other)
                and self._set_values() == other._set_values()
                and self._unknown == other._unknown)

    def __repr__(self):
        body = ", ".join(f"{k}={v!r}" for k, v in self._values.items())
        return f"{type(self).__name__}({body})"

    # ---- decoding ----
    @classmethod
    def FromString(cls, data) -> "Message":
        msg = cls()
        msg._decode(memoryview(data) if not isinstance(data, memoryview) else data)
        return msg

    def _decode(self, buf: memoryview) -> None:
        pos, end = 0, len(buf)
        by_number = type(self)._by_number
        vals = self._values
        while pos < end:
            start = pos
            tag, pos = _read_varint(buf, pos)
            number, wire = tag >> 3, tag & 7
            if wire == VARINT:
                raw, pos = _read_varint(buf, pos)
            elif wire == I64:
                raw, pos = buf[pos:pos + 8], pos + 8
            elif wire == I32:
                raw, pos = buf[pos:pos + 4], pos + 4
            elif wire == LEN:
                n, pos = _read_varint(buf, pos)
                raw, pos = buf[pos:pos + n], pos + n
            else:
                raise ValueError(f"unsupported wire type {wire} in "
                                 f"{type(self).__name__}")
            f = by_number.get(number)
            if f is None:
                self._unknown.append(bytes(buf[start:pos]))
                continue
            if f.kind == "map":
                entry = _MapEntry.parse(f, raw)
                m = getattr(self, f.name)
                m[entry[0]] = entry[1]
            elif f.kind == "message":
                sub = _cls(f.msg)()
                sub._decode(raw)
                if f.repeated:
                    getattr(self, f.name).append(sub)
                else:
                    vals[f.name] = sub
            elif f.repeated and wire == LEN and _SCALAR[f.kind] != LEN:
                getattr(self, f.name).extend(_unpack(f.kind, raw))
            else:
                v = _scalar(f.kind, wire, raw)
                if f.repeated:
                    getattr(self, f.name).append(v)
                else:
                    vals[f.name] = v

    # ---- encoding ----
    def SerializeToString(self) -> bytes:
        out: List[bytes] = []
        vals = self._values
        for f in sorted(type(self).FIELDS, key=lambda f: f.number):
            if f.name not in vals:
                continue
            v = vals[f.name]
            if f.kind == "map":
                for k in v:
                    out.append(_key(f.number, LEN))
                    body = _MapEntry.encode(f, k, v[k])
                    out.append(_varint(len(body)))
                    out.append(body)
            elif f.kind == "message":
                for sub in (v if f.repeated else (v,)):
                    body = sub.SerializeToString()
                    out.append(_key(f.number, LEN))
                    out.append(_varint(len(body)))
                    out.append(body)
            elif f.repeated:
                if not v:
                    continue
                if _SCALAR[f.kind] == LEN:
                    for e in v:
                        out.append(_encode_scalar(f.number, f.kind, e))
                else:
                    body = b"".join(_raw_scalar(f.kind, e) for e in v)
                    out.append(_key(f.number, LEN))
                    out.append(_varint(len(body)))
                    out.append(body)
            else:
                out.append(_encode_scalar(f.number, f.kind, v))
        out.extend(self._unknown)
        return b"".join(out)


def _is_msg_kind(k) -> bool:
    return k not in _SCALAR


def _scalar(kind: str, wire: int, raw):
    if wire == VARINT:
        return _from_varint(kind, raw)
    if wire == I32:
        return struct.unpack("<f", raw)[0] if kind == "float" else \
            _from_varint(kind, struct.unpack("<I", raw)[0])
    if wire == I64:
        return struct.unpack("<d", raw)[0] if kind == "double" else \
            _from_varint(kind, struct.unpack("<Q", raw)[0])
    if kind == "string":
        return bytes(raw).decode("utf-8")
    return bytes(raw)


def _unpack(kind: str, raw) -> list:
    """A packed repeated scalar field."""
    if kind == "float":
        return np.frombuffer(raw, "<f4").tolist()
    if kind == "double":
        return np.frombuffer(raw, "<f8").tolist()
    out, pos, end = [], 0, len(raw)
    while pos < end:
        v, pos = _read_varint(raw, pos)
        out.append(_from_varint(kind, v))
    return out


def _raw_scalar(kind: str, v) -> bytes:
    if kind == "float":
        return struct.pack("<f", v)
    if kind == "double":
        return struct.pack("<d", v)
    if kind == "bool":
        return _varint(1 if v else 0)
    return _varint(int(v))


def _encode_scalar(number: int, kind: str, v) -> bytes:
    wire = _SCALAR[kind]
    if wire == LEN:
        data = v.encode("utf-8") if isinstance(v, str) else bytes(v)
        return _key(number, LEN) + _varint(len(data)) + data
    return _key(number, wire) + _raw_scalar(kind, v)


class _MapEntry:
    """map<K, V> entries: key = field 1, value = field 2."""

    @staticmethod
    def parse(f: Field, raw) -> Tuple[Any, Any]:
        key, value = _default(f.key), None
        pos, end = 0, len(raw)
        while pos < end:
            tag, pos = _read_varint(raw, pos)
            number, wire = tag >> 3, tag & 7
            if wire == VARINT:
                r, pos = _read_varint(raw, pos)
            elif wire == LEN:
                n, pos = _read_varint(raw, pos)
                r, pos = raw[pos:pos + n], pos + n
            elif wire == I32:
                r, pos = raw[pos:pos + 4], pos + 4
            else:
                r, pos = raw[pos:pos + 8], pos + 8
            if number == 1:
                key = _scalar(f.key, wire, r)
            elif number == 2:
                if _is_msg_kind(f.value):
                    value = _cls(f.value)()
                    value._decode(r)
                else:
                    value = _scalar(f.value, wire, r)
        if value is None:
            value = _cls(f.value)() if _is_msg_kind(f.value) else _default(f.value)
        return key, value

    @staticmethod
    def encode(f: Field, k, v) -> bytes:
        body = _encode_scalar(1, f.key, k)
        if _is_msg_kind(f.value):
            sub = v.SerializeToString()
            return body + _key(2, LEN) + _varint(len(sub)) + sub
        return body + _encode_scalar(2, f.value, v)


# ---------------------------------------------------------------------------
# the messages (field numbers from TF's .proto files)
# ---------------------------------------------------------------------------

class TensorShapeProto_Dim(Message):
    FIELDS = (Field(1, "size", "int64"), Field(2, "name", "string"))


class TensorShapeProto(Message):
    FIELDS = (Field(2, "dim", "message", True, "TensorShapeProto_Dim"),
              Field(3, "unknown_rank", "bool"))


class TensorProto(Message):
    FIELDS = (
        Field(1, "dtype", "enum"),
        Field(2, "tensor_shape", "message", msg="TensorShapeProto"),
        Field(3, "version_number", "int32"),
        Field(4, "tensor_content", "bytes"),
        Field(13, "half_val", "int32", True),
        Field(5, "float_val", "float", True),
        Field(6, "double_val", "double", True),
        Field(7, "int_val", "int32", True),
        Field(8, "string_val", "bytes", True),
        Field(9, "scomplex_val", "float", True),
        Field(10, "int64_val", "int64", True),
        Field(11, "bool_val", "bool", True),
        Field(12, "dcomplex_val", "double", True),
        Field(16, "uint32_val", "uint32", True),
        Field(17, "uint64_val", "uint64", True),
    )


class NameAttrList(Message):
    FIELDS = (Field(1, "name", "string"),
              Field(2, "attr", "map", key="string", value="AttrValue"))


class AttrValue_ListValue(Message):
    FIELDS = (
        Field(2, "s", "bytes", True),
        Field(3, "i", "int64", True),
        Field(4, "f", "float", True),
        Field(5, "b", "bool", True),
        Field(6, "type", "enum", True),
        Field(7, "shape", "message", True, "TensorShapeProto"),
        Field(8, "tensor", "message", True, "TensorProto"),
        Field(9, "func", "message", True, "NameAttrList"),
    )


class AttrValue(Message):
    FIELDS = (
        Field(2, "s", "bytes"),
        Field(3, "i", "int64"),
        Field(4, "f", "float"),
        Field(5, "b", "bool"),
        Field(6, "type", "enum"),
        Field(7, "shape", "message", msg="TensorShapeProto"),
        Field(8, "tensor", "message", msg="TensorProto"),
        Field(1, "list", "message", msg="AttrValue_ListValue"),
        Field(10, "func", "message", msg="NameAttrList"),
        Field(9, "placeholder", "string"),
    )
    ONEOFS = {"value": ("s", "i", "f", "b", "type", "shape", "tensor", "list",
                        "func", "placeholder")}

    def __setattr__(self, name, value):
        # setting one member of the oneof clears the others
        if name in AttrValue.ONEOFS["value"]:
            for other in AttrValue.ONEOFS["value"]:
                self._values.pop(other, None)
        super().__setattr__(name, value)


class NodeDef(Message):
    FIELDS = (
        Field(1, "name", "string"),
        Field(2, "op", "string"),
        Field(3, "input", "string", True),
        Field(4, "device", "string"),
        Field(5, "attr", "map", key="string", value="AttrValue"),
    )


class VersionDef(Message):
    FIELDS = (Field(1, "producer", "int32"), Field(2, "min_consumer", "int32"),
              Field(3, "bad_consumers", "int32", True))


class OpDef_ArgDef(Message):
    FIELDS = (
        Field(1, "name", "string"),
        Field(2, "description", "string"),
        Field(3, "type", "enum"),
        Field(4, "type_attr", "string"),
        Field(5, "number_attr", "string"),
        Field(6, "type_list_attr", "string"),
        Field(16, "is_ref", "bool"),
    )


class OpDef_AttrDef(Message):
    FIELDS = (
        Field(1, "name", "string"),
        Field(2, "type", "string"),
        Field(3, "default_value", "message", msg="AttrValue"),
        Field(4, "description", "string"),
        Field(5, "has_minimum", "bool"),
        Field(6, "minimum", "int64"),
        Field(7, "allowed_values", "message", msg="AttrValue"),
    )


class OpDef(Message):
    FIELDS = (
        Field(1, "name", "string"),
        Field(2, "input_arg", "message", True, "OpDef_ArgDef"),
        Field(3, "output_arg", "message", True, "OpDef_ArgDef"),
        Field(20, "control_output", "string", True),
        Field(4, "attr", "message", True, "OpDef_AttrDef"),
        Field(5, "summary", "string"),
        Field(6, "description", "string"),
        Field(18, "is_commutative", "bool"),
        Field(16, "is_aggregate", "bool"),
        Field(17, "is_stateful", "bool"),
        Field(19, "allows_uninitialized_input", "bool"),
        Field(21, "is_distributed_communication", "bool"),
    )


class FunctionDef(Message):
    FIELDS = (
        Field(1, "signature", "message", msg="OpDef"),
        Field(5, "attr", "map", key="string", value="AttrValue"),
        Field(3, "node_def", "message", True, "NodeDef"),
        Field(4, "ret", "map", key="string", value="string"),
        Field(6, "control_ret", "map", key="string", value="string"),
    )


class GradientDef(Message):
    FIELDS = (Field(1, "function_name", "string"),
              Field(2, "gradient_func", "string"))


class FunctionDefLibrary(Message):
    FIELDS = (Field(1, "function", "message", True, "FunctionDef"),
              Field(2, "gradient", "message", True, "GradientDef"))


class GraphDef(Message):
    FIELDS = (
        Field(1, "node", "message", True, "NodeDef"),
        Field(4, "versions", "message", msg="VersionDef"),
        Field(3, "version", "int32"),
        Field(2, "library", "message", msg="FunctionDefLibrary"),
    )


#: (message class, TF's full message name) for each message modelled here
MESSAGES = (
    (GraphDef, "tensorflow.GraphDef"), (NodeDef, "tensorflow.NodeDef"),
    (AttrValue, "tensorflow.AttrValue"),
    (AttrValue_ListValue, "tensorflow.AttrValue.ListValue"),
    (NameAttrList, "tensorflow.NameAttrList"), (TensorProto, "tensorflow.TensorProto"),
    (TensorShapeProto, "tensorflow.TensorShapeProto"),
    (TensorShapeProto_Dim, "tensorflow.TensorShapeProto.Dim"),
    (VersionDef, "tensorflow.VersionDef"),
    (FunctionDefLibrary, "tensorflow.FunctionDefLibrary"),
    (FunctionDef, "tensorflow.FunctionDef"), (GradientDef, "tensorflow.GradientDef"),
    (OpDef, "tensorflow.OpDef"), (OpDef_ArgDef, "tensorflow.OpDef.ArgDef"),
    (OpDef_AttrDef, "tensorflow.OpDef.AttrDef"),
)


# ---------------------------------------------------------------------------
# tensors
# ---------------------------------------------------------------------------

def shape_of(tp: TensorShapeProto) -> Tuple[int, ...]:
    return tuple(int(d.size) for d in tp.dim)


def make_shape(shape) -> TensorShapeProto:
    return TensorShapeProto(dim=[TensorShapeProto_Dim(size=int(s)) for s in shape])


_TYPED_FIELD = {
    DT_FLOAT: "float_val", DT_DOUBLE: "double_val", DT_INT32: "int_val",
    DT_UINT8: "int_val", DT_INT16: "int_val", DT_INT8: "int_val",
    DT_UINT16: "int_val", DT_INT64: "int64_val", DT_BOOL: "bool_val",
    DT_HALF: "half_val", DT_BFLOAT16: "half_val", DT_UINT32: "uint32_val",
    DT_UINT64: "uint64_val",
}


def make_ndarray(tp: TensorProto) -> np.ndarray:
    """TF's ``tensor_util.MakeNdarray``: tensor_content when present, else
    the typed value list, filled to the shape with its last value (no
    values: zeros).  bfloat16 comes back as uint16 bits."""
    dt = tp.dtype
    shape = shape_of(tp.tensor_shape)
    n = int(np.prod(shape)) if shape else 1
    if dt == DT_STRING:
        vals = list(tp.string_val)
        if len(vals) < n:
            vals += [vals[-1] if vals else b""] * (n - len(vals))
        return np.array(vals, dtype=object).reshape(shape)
    npdt = np.dtype(NUMPY_DTYPES[dt])
    if tp.tensor_content:
        return np.frombuffer(tp.tensor_content, dtype=npdt.newbyteorder("<")) \
            .astype(npdt).reshape(shape)
    if dt in (DT_COMPLEX64, DT_COMPLEX128):
        raw = np.asarray(tp.scomplex_val if dt == DT_COMPLEX64 else tp.dcomplex_val)
        vals = (raw[0::2] + 1j * raw[1::2]).astype(npdt)
    elif dt in (DT_HALF, DT_BFLOAT16):
        vals = np.asarray(tp.half_val, dtype=np.int64).astype(np.uint16)
        if dt == DT_HALF:
            vals = vals.view(np.float16)
    else:
        vals = np.asarray(getattr(tp, _TYPED_FIELD[dt]), dtype=npdt)
    if vals.size == 0:
        return np.zeros(shape, dtype=npdt)
    if vals.size != n:
        vals = np.pad(vals, (0, n - vals.size), "edge")
    return vals.reshape(shape)


def make_tensor_proto(value, dtype: Optional[int] = None) -> TensorProto:
    """A TensorProto of a numpy array (or scalar), as TF writes a frozen
    graph's Const: a one-element tensor as its typed value, a larger one
    as little-endian ``tensor_content``."""
    a = np.asarray(value)
    dt = data_type(a.dtype) if dtype is None else dtype
    tp = TensorProto(dtype=dt, tensor_shape=make_shape(a.shape))
    if a.size == 1 and dt in _TYPED_FIELD:
        v = a.reshape(-1)
        if dt in (DT_HALF, DT_BFLOAT16):
            v = v.view(np.uint16)
        setattr(tp, _TYPED_FIELD[dt], v.tolist())
    else:
        tp.tensor_content = np.ascontiguousarray(a).astype(
            a.dtype.newbyteorder("<")).tobytes()
    return tp


def load_graph_def(source) -> GraphDef:
    """A GraphDef from serialized bytes, a path to a ``.pb`` file, an
    object with ``SerializeToString()`` (a TF GraphDef) or a GraphDef of
    this module."""
    if isinstance(source, GraphDef):
        return source
    if isinstance(source, (bytes, bytearray, memoryview)):
        return GraphDef.FromString(source)
    if isinstance(source, (str, os.PathLike)):
        with open(source, "rb") as f:
            return GraphDef.FromString(f.read())
    if hasattr(source, "SerializeToString"):
        return GraphDef.FromString(source.SerializeToString())
    raise TypeError(f"cannot read a GraphDef from {type(source).__name__}")
