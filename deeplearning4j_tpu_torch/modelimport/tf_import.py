"""TensorFlow GraphDef -> SameDiff import (the port of
``modelimport/tf_import.py``).

Reference: `nd4j/samediff-import/samediff-import-{api,tensorflow}`:
`ImportGraph.importGraph` walks protobuf NodeDefs, an `OpMappingRegistry`
maps each TF op to graph-engine ops, and unmapped ops fail with a NAMED
error listing the op.  Same registry pattern here, targeting the port's
`autodiff.SameDiff` on a given device.

The GraphDef is read by the port's own protobuf codec
(``modelimport/tf_proto.py``): no TensorFlow is needed, or imported, to
import a graph.  Shape and static-value inference over already-built
subgraphs runs the graph on meta tensors (``SameDiff.shapes_of``) or on
the host, where the JAX package uses ``jax.eval_shape``.  Control flow
lowers onto SameDiff's ``while_loop`` and ``cond`` in both of TF's forms:
functional While/If (bodies in the graph's function library) and TF1
frames (Enter/Merge/Switch/NextIteration/Exit/LoopCond), with a frameless
Switch/Merge cond collapsing to a select.  `TFImportRegistry.register`
extends the op set.
"""
from __future__ import annotations

from typing import Callable, Dict, List

import numpy as np
import torch

from deeplearning4j_tpu_torch.autodiff import SameDiff
from deeplearning4j_tpu_torch.autodiff.ops import torch_dtype
from deeplearning4j_tpu_torch.modelimport import tf_proto


class UnmappedTFOpException(Exception):
    pass


def _attr_shape(node) -> List[int]:
    return [d.size for d in node.attr["shape"].shape.dim]


def _const_value(node):
    """A Const node's value: a numpy array, or a torch tensor for bfloat16
    (numpy has none)."""
    tp = node.attr["value"].tensor
    a = tf_proto.make_ndarray(tp)
    if tp.dtype == tf_proto.DT_BFLOAT16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return a


def _dtype_name(dt: int, default: str = "float32") -> str:
    return tf_proto.dtype_name(dt) if dt else default


def _host(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def _perm_from_const(sd, name):
    raise UnmappedTFOpException("dynamic permutation input unsupported")


class TFImportRegistry:
    """TF op name -> mapper(sd, node, inputs) -> SDVariable."""

    _MAP: Dict[str, Callable] = {}

    @classmethod
    def register(cls, op_name: str, fn: Callable = None):
        if fn is None:
            def deco(f):
                cls._MAP[op_name] = f
                return f
            return deco
        cls._MAP[op_name] = fn
        return fn

    @classmethod
    def get(cls, op_name: str) -> Callable:
        if op_name not in cls._MAP:
            raise UnmappedTFOpException(
                f"Unmapped TF op '{op_name}' — same failure mode as the "
                "reference's OpMappingRegistry; add via "
                "TFImportRegistry.register")
        return cls._MAP[op_name]


R = TFImportRegistry.register

R("Identity", lambda sd, n, ins: sd.op("identity", ins[0], name=n.name))
R("MatMul", lambda sd, n, ins: sd.op("matmul", ins[0], ins[1], name=n.name))
R("Add", lambda sd, n, ins: sd.op("add", ins[0], ins[1], name=n.name))
R("AddV2", lambda sd, n, ins: sd.op("add", ins[0], ins[1], name=n.name))
R("BiasAdd", lambda sd, n, ins: sd.op("add", ins[0], ins[1], name=n.name))
R("Sub", lambda sd, n, ins: sd.op("sub", ins[0], ins[1], name=n.name))
R("Mul", lambda sd, n, ins: sd.op("mul", ins[0], ins[1], name=n.name))
R("RealDiv", lambda sd, n, ins: sd.op("div", ins[0], ins[1], name=n.name))
R("Maximum", lambda sd, n, ins: sd.op("maximum", ins[0], ins[1],
                                      name=n.name))
R("Minimum", lambda sd, n, ins: sd.op("minimum", ins[0], ins[1],
                                      name=n.name))
R("Relu", lambda sd, n, ins: sd.op("relu", ins[0], name=n.name))
R("Relu6", lambda sd, n, ins: sd.op("relu6", ins[0], name=n.name))
R("Elu", lambda sd, n, ins: sd.op("elu", ins[0], name=n.name))
R("Sigmoid", lambda sd, n, ins: sd.op("sigmoid", ins[0], name=n.name))
R("Tanh", lambda sd, n, ins: sd.op("tanh", ins[0], name=n.name))
R("Softmax", lambda sd, n, ins: sd.op("softmax", ins[0], name=n.name))
R("Exp", lambda sd, n, ins: sd.op("exp", ins[0], name=n.name))
R("Log", lambda sd, n, ins: sd.op("log", ins[0], name=n.name))
R("Sqrt", lambda sd, n, ins: sd.op("sqrt", ins[0], name=n.name))
R("Rsqrt", lambda sd, n, ins: sd.op("pow", sd.op("sqrt", ins[0]), -1.0,
                                    name=n.name))
R("Square", lambda sd, n, ins: sd.op("square", ins[0], name=n.name))
R("Neg", lambda sd, n, ins: sd.op("neg", ins[0], name=n.name))
R("Abs", lambda sd, n, ins: sd.op("abs", ins[0], name=n.name))
R("Erf", lambda sd, n, ins: sd.op("erf", ins[0], name=n.name))
R("Pow", lambda sd, n, ins: sd.op("pow", ins[0], ins[1], name=n.name))


@R("Reshape")
def _reshape(sd, n, ins):
    # a Shape-driven integer subgraph resolves at import time via
    # _static_value (the reference's import likewise only supports
    # statically-resolvable reshape targets)
    shape = _static_value(ins[1], f"Reshape '{n.name}'")
    return sd.op("reshape", ins[0],
                 shape=[int(s) for s in np.asarray(shape)], name=n.name)


@R("Shape")
def _tf_shape(sd, n, ins):
    """Static input shapes (the frozen-graph norm) make Shape a
    compile-time constant; dynamic shapes have no XLA story anyway.
    Leaf nodes (placeholder/const/variable) carry their shape directly;
    op outputs (the flatten pattern `tf.reshape(y, [tf.shape(y)[0], -1])`)
    are inferred by evaluating the already-built subgraph on meta
    tensors."""
    node = sd._nodes[ins[0].name]
    while node.kind == "op" and node.op == "identity":
        node = sd._nodes[node.inputs[0]]
    if node.shape is not None:
        return sd.constant(n.name, np.asarray(node.shape, np.int32))
    phs = {name: nd for name, nd in sd._nodes.items()
           if nd.kind == "placeholder"}
    unshaped = [name for name, nd in phs.items() if nd.shape is None]
    if unshaped:
        raise UnmappedTFOpException(
            f"Shape '{n.name}': placeholders {unshaped} have no static "
            "shape — only statically-shaped graphs import")
    specs = {name: torch.empty(tuple(nd.shape), dtype=torch_dtype(nd.dtype),
                               device="meta")
             for name, nd in phs.items()}
    target = ins[0].name
    try:
        shape, _ = sd.shapes_of(specs, target)[target]
    except Exception as e:
        raise UnmappedTFOpException(
            f"Shape '{n.name}': abstract shape inference over "
            f"'{target}' failed") from e
    return sd.constant(n.name, np.asarray(shape, np.int32))


@R("Transpose")
def _transpose(sd, n, ins):
    perm = [int(p) for p in _static_value(ins[1], f"{n.op} \'{n.name}\'")]
    return sd.op("transpose", ins[0], perm=perm, name=n.name)


@R("ConcatV2")
def _concat(sd, n, ins):
    axis = int(_static_value(ins[-1], f"{n.op} \'{n.name}\'"))
    return sd.op("concat", *ins[:-1], axis=axis, name=n.name)


@R("Mean")
def _mean(sd, n, ins):
    axes = [int(a) for a in np.atleast_1d(_static_value(ins[1], f"{n.op} \'{n.name}\'"))]
    keep = bool(n.attr["keep_dims"].b)
    return sd.op("mean", ins[0], axis=axes, keepdims=keep, name=n.name)


@R("Sum")
def _sum(sd, n, ins):
    axes = [int(a) for a in np.atleast_1d(_static_value(ins[1], f"{n.op} \'{n.name}\'"))]
    keep = bool(n.attr["keep_dims"].b)
    return sd.op("sum", ins[0], axis=axes, keepdims=keep, name=n.name)


@R("Max")
def _max(sd, n, ins):
    axes = [int(a) for a in np.atleast_1d(_static_value(ins[1], f"{n.op} \'{n.name}\'"))]
    keep = bool(n.attr["keep_dims"].b)
    return sd.op("max", ins[0], axis=axes, keepdims=keep, name=n.name)


@R("Conv2D")
def _conv2d(sd, n, ins):
    if n.attr["data_format"].s not in (b"", b"NHWC"):
        raise UnmappedTFOpException("Conv2D: only NHWC supported "
                                    "(TPU-native layout)")
    strides = list(n.attr["strides"].list.i)
    padding = n.attr["padding"].s.decode()
    return sd.op("conv2d", ins[0], ins[1],
                 stride=(int(strides[1]), int(strides[2])),
                 padding=padding, name=n.name)


def _static_shape_of(sd, var):
    """Resolve a variable's static shape through identity chains to its
    constant (frozen-graph weight paths go Const -> Identity('.../read'))."""
    node = sd._nodes[var.name]
    while node.kind == "op" and node.op == "identity":
        node = sd._nodes[node.inputs[0]]
    if node.kind in ("constant", "variable") and node.shape is not None:
        return tuple(node.shape)
    raise UnmappedTFOpException(
        f"cannot resolve a static shape for '{var.name}' "
        f"(kind={node.kind}, op={node.op})")


@R("DepthwiseConv2dNative")
def _depthwise_conv2d_tf(sd, n, ins):
    if n.attr["data_format"].s not in (b"", b"NHWC"):
        raise UnmappedTFOpException("DepthwiseConv2dNative: only NHWC "
                                    "supported (TPU-native layout)")
    strides = list(n.attr["strides"].list.i)
    dil = list(n.attr["dilations"].list.i) or [1, 1, 1, 1]
    # TF filter [H, W, C, mult] -> grouped HWIO [H, W, 1, C*mult],
    # reshaped IN-GRAPH (no weight duplication; works through Identity)
    h, wd, c, mult = _static_shape_of(sd, ins[1])
    w_g = sd.op("reshape", ins[1], shape=[h, wd, 1, c * mult])
    return sd.op("depthwise_conv2d", ins[0], w_g,
                 stride=(int(strides[1]), int(strides[2])),
                 dilation=(int(dil[1]), int(dil[2])),
                 padding=n.attr["padding"].s.decode(), name=n.name)


@R("MaxPool")
def _maxpool(sd, n, ins):
    k = list(n.attr["ksize"].list.i)
    s = list(n.attr["strides"].list.i)
    return sd.op("max_pooling2d", ins[0], kernel=(int(k[1]), int(k[2])),
                 stride=(int(s[1]), int(s[2])),
                 padding=n.attr["padding"].s.decode(), name=n.name)


@R("AvgPool")
def _avgpool(sd, n, ins):
    k = list(n.attr["ksize"].list.i)
    s = list(n.attr["strides"].list.i)
    return sd.op("avg_pooling2d", ins[0], kernel=(int(k[1]), int(k[2])),
                 stride=(int(s[1]), int(s[2])),
                 padding=n.attr["padding"].s.decode(), name=n.name)


@R("Pack")
def _pack(sd, n, ins):
    return sd.op("stack", *ins, axis=int(n.attr["axis"].i), name=n.name)


@R("ExpandDims")
def _expand(sd, n, ins):
    axis = int(_static_value(ins[1], f"{n.op} \'{n.name}\'"))
    return sd.op("expand_dims", ins[0], axis=axis, name=n.name)


@R("Cast")
def _cast(sd, n, ins):
    return sd.op("cast", ins[0], dtype=_dtype_name(n.attr["DstT"].type),
                 name=n.name)


# ---------------------------------------------------------------------------
# BERT-class graph ops (VERDICT #4: BatchMatMul, GatherV2, StridedSlice,
# Squeeze, Split, FusedBatchNorm, Erf-GELU patterns — the set a frozen
# BERT GraphDef needs; reference TFOpMappingRegistry covers the same)
# ---------------------------------------------------------------------------

def _batch_matmul(sd, n, ins):
    a, b = ins[0], ins[1]
    if n.attr["adj_x"].b:
        a = sd.op("swap_last2", a)
    if n.attr["adj_y"].b:
        b = sd.op("swap_last2", b)
    return sd.op("matmul", a, b, name=n.name)


R("BatchMatMul", _batch_matmul)
R("BatchMatMulV2", _batch_matmul)
R("BatchMatMulV3", _batch_matmul)


@R("GatherV2")
def _gather_v2(sd, n, ins):
    axis = int(_static_value(ins[2], f"{n.op} \'{n.name}\'"))
    if int(n.attr["batch_dims"].i):
        raise UnmappedTFOpException("GatherV2 batch_dims != 0 unsupported")
    return sd.op("gather", ins[0], ins[1], axis=axis, name=n.name)


R("Gather", lambda sd, n, ins: sd.op("gather", ins[0], ins[1], axis=0,
                                     name=n.name))


@R("StridedSlice")
def _tf_strided_slice(sd, n, ins):
    return sd.op(
        "tf_strided_slice", ins[0],
        begin=[int(v) for v in _static_value(ins[1], f"{n.op} \'{n.name}\'")],
        end=[int(v) for v in _static_value(ins[2], f"{n.op} \'{n.name}\'")],
        strides=[int(v) for v in _static_value(ins[3], f"{n.op} \'{n.name}\'")],
        begin_mask=int(n.attr["begin_mask"].i),
        end_mask=int(n.attr["end_mask"].i),
        ellipsis_mask=int(n.attr["ellipsis_mask"].i),
        new_axis_mask=int(n.attr["new_axis_mask"].i),
        shrink_axis_mask=int(n.attr["shrink_axis_mask"].i),
        name=n.name)


@R("Squeeze")
def _squeeze(sd, n, ins):
    dims = [int(d) for d in n.attr["squeeze_dims"].list.i]
    return sd.op("squeeze", ins[0], axis=tuple(dims) if dims else None,
                 name=n.name)


@R("Split")
def _split(sd, n, ins):
    # inputs: (axis, value); attr num_split — equal split
    axis = int(_static_value(ins[0], f"{n.op} \'{n.name}\'"))
    num = int(n.attr["num_split"].i)
    v = sd.op("split_equal", ins[1], num=num, axis=axis)
    # secondary outputs take ':i' names — illegal in TF node names, so they
    # can never collide with a later real node (TF uniquifies with _N)
    return tuple(sd.op("tuple_get", v, index=i,
                       name=n.name if i == 0 else f"{n.name}:{i}")
                 for i in range(num))


@R("SplitV")
def _split_v(sd, n, ins):
    sizes = [int(s) for s in _static_value(ins[1], f"{n.op} \'{n.name}\'")]
    axis = int(_static_value(ins[2], f"{n.op} \'{n.name}\'"))
    v = sd.op("split_axis", ins[0], sizes=sizes, axis=axis)
    return tuple(sd.op("tuple_get", v, index=i,
                       name=n.name if i == 0 else f"{n.name}:{i}")
                 for i in range(len(sizes)))


def _fused_bn(sd, n, ins):
    # inputs: x, scale, offset, mean, variance (inference); NHWC layout —
    # params broadcast over the last axis, so plain batch_norm works
    if n.attr["is_training"].b:
        raise UnmappedTFOpException(
            "FusedBatchNorm is_training=true unsupported (freeze first)")
    if n.attr["data_format"].s not in (b"", b"NHWC"):
        raise UnmappedTFOpException("FusedBatchNorm: only NHWC supported")
    eps = float(n.attr["epsilon"].f) if "epsilon" in n.attr else 1e-4
    return sd.op("batch_norm", ins[0], ins[3], ins[4], ins[1], ins[2],
                 eps=eps, name=n.name)


R("FusedBatchNorm", _fused_bn)
R("FusedBatchNormV2", _fused_bn)
R("FusedBatchNormV3", _fused_bn)


@R("OneHot")
def _one_hot(sd, n, ins):
    depth = int(_static_value(ins[1], f"{n.op} \'{n.name}\'"))
    on = float(_static_value(ins[2], f"{n.op} \'{n.name}\'"))
    off = float(_static_value(ins[3], f"{n.op} \'{n.name}\'"))
    axis = int(n.attr["axis"].i) if "axis" in n.attr else -1
    if axis != -1:
        raise UnmappedTFOpException("OneHot axis != -1 unsupported")
    oh = sd.op("one_hot", ins[0], depth=depth)
    if (on, off) == (1.0, 0.0):
        return sd.rename(oh.name, n.name)
    return sd.op("add", sd.op("mul", oh, on - off), off, name=n.name)


@R("Fill")
def _fill(sd, n, ins):
    dims = [int(d) for d in _static_value(ins[0], f"{n.op} \'{n.name}\'")]
    value = _static_value(ins[1], f"{n.op} \'{n.name}\'")
    return sd.constant(n.name, np.full(dims, value))


@R("SquaredDifference")
def _sqdiff(sd, n, ins):
    return sd.op("square", sd.op("sub", ins[0], ins[1]), name=n.name)


R("Select", lambda sd, n, ins: sd.op("where", ins[0], ins[1], ins[2],
                                     name=n.name))
R("SelectV2", lambda sd, n, ins: sd.op("where", ins[0], ins[1], ins[2],
                                       name=n.name))
R("LeakyRelu", lambda sd, n, ins: sd.op(
    "leaky_relu", ins[0],
    alpha=float(n.attr["alpha"].f) if "alpha" in n.attr else 0.2,
    name=n.name))
R("Softplus", lambda sd, n, ins: sd.op("softplus", ins[0], name=n.name))
R("Floor", lambda sd, n, ins: sd.op("floor", ins[0], name=n.name))
R("FloorDiv", lambda sd, n, ins: sd.op("floor_div", ins[0], ins[1],
                                       name=n.name))
R("GreaterEqual", lambda sd, n, ins: sd.op("greater_equal", ins[0], ins[1],
                                           name=n.name))
R("Greater", lambda sd, n, ins: sd.op("greater", ins[0], ins[1],
                                      name=n.name))
R("Less", lambda sd, n, ins: sd.op("less", ins[0], ins[1], name=n.name))
R("Equal", lambda sd, n, ins: sd.op("equal", ins[0], ins[1], name=n.name))
R("LogicalAnd", lambda sd, n, ins: sd.op("logical_and", ins[0], ins[1],
                                         name=n.name))
R("LogicalNot", lambda sd, n, ins: sd.op("logical_not", ins[0],
                                         name=n.name))
R("Gelu", lambda sd, n, ins: sd.op(
    "gelu", ins[0],
    approximate=bool(n.attr["approximate"].b) if "approximate" in n.attr
    else False,                       # tf.nn.gelu defaults to exact erf
    name=n.name))


@R("Tile")
def _tile(sd, n, ins):
    reps = [int(r) for r in _static_value(ins[1], f"{n.op} \'{n.name}\'")]
    return sd.op("tile", ins[0], reps=reps, name=n.name)


def _pad_tf(sd, n, ins):
    paddings = _static_value(ins[1], f"{n.op} \'{n.name}\'").tolist()
    value = 0.0 if len(ins) < 3 else float(_static_value(ins[2], f"{n.op} \'{n.name}\'"))
    return sd.op("pad", ins[0], paddings=paddings, value=value, name=n.name)


R("Pad", _pad_tf)
R("PadV2", _pad_tf)


@R("Min")
def _reduce_min(sd, n, ins):
    axes = [int(a) for a in np.atleast_1d(_static_value(ins[1], f"{n.op} \'{n.name}\'"))]
    return sd.op("min", ins[0], axis=axes,
                 keepdims=bool(n.attr["keep_dims"].b), name=n.name)


# ---- round-4 conformance-corpus mappings (TFGraphTestAllSameDiff-style
# per-op coverage surfaced these as unmapped; each is a thin lowering to
# the registry op of the same semantics) ----

R("FloorMod", lambda sd, n, ins: sd.op("mod", ins[0], ins[1],
                                       name=n.name))
R("Softsign", lambda sd, n, ins: sd.op("softsign", ins[0], name=n.name))
R("Softplus", lambda sd, n, ins: sd.op("softplus", ins[0], name=n.name))
R("Atan", lambda sd, n, ins: sd.op("atan", ins[0], name=n.name))
R("Asin", lambda sd, n, ins: sd.op("asin", ins[0], name=n.name))
R("Acos", lambda sd, n, ins: sd.op("acos", ins[0], name=n.name))
R("Sinh", lambda sd, n, ins: sd.op("sinh", ins[0], name=n.name))
R("Cosh", lambda sd, n, ins: sd.op("cosh", ins[0], name=n.name))
R("Atan2", lambda sd, n, ins: sd.op("atan2", ins[0], ins[1],
                                    name=n.name))
R("Rint", lambda sd, n, ins: sd.op("rint", ins[0], name=n.name))
R("Round", lambda sd, n, ins: sd.op("rint", ins[0], name=n.name))
R("Log1p", lambda sd, n, ins: sd.op("log1p", ins[0], name=n.name))
R("Expm1", lambda sd, n, ins: sd.op("expm1", ins[0], name=n.name))
R("Sign", lambda sd, n, ins: sd.op("sign", ins[0], name=n.name))
R("Floor", lambda sd, n, ins: sd.op("floor", ins[0], name=n.name))
R("Ceil", lambda sd, n, ins: sd.op("ceil", ins[0], name=n.name))
R("LogSoftmax", lambda sd, n, ins: sd.op("log_softmax", ins[0],
                                         name=n.name))
R("LogicalOr", lambda sd, n, ins: sd.op("logical_or", ins[0], ins[1],
                                        name=n.name))
R("LogicalAnd", lambda sd, n, ins: sd.op("logical_and", ins[0], ins[1],
                                         name=n.name))
R("LogicalNot", lambda sd, n, ins: sd.op("logical_not", ins[0],
                                         name=n.name))
R("GatherNd", lambda sd, n, ins: sd.op("gather_nd", ins[0], ins[1],
                                       name=n.name))
R("Selu", lambda sd, n, ins: sd.op("selu", ins[0], name=n.name))


def _tf_argminmax(op):
    def h(sd, n, ins):
        axis = int(_static_value(ins[1], f"{n.op} \'{n.name}\'"))
        v = sd.op(op, ins[0], axis=axis, name=n.name + "__i32")
        # honor output_type (TF defaults to int64)
        out_t = n.attr["output_type"].type
        dt = _dtype_name(out_t, "int64")
        return sd.op("cast", v, dtype=dt, name=n.name)
    return h


R("ArgMax", _tf_argminmax("argmax"))
R("ArgMin", _tf_argminmax("argmin"))


@R("Prod")
def _tf_prod(sd, n, ins):
    axes = [int(a) for a in np.atleast_1d(_static_value(ins[1], f"{n.op} \'{n.name}\'"))]
    return sd.op("prod", ins[0], axis=axes,
                 keepdims=bool(n.attr["keep_dims"].b), name=n.name)


@R("Cumsum")
def _tf_cumsum(sd, n, ins):
    axis = int(_static_value(ins[1], f"{n.op} \'{n.name}\'"))
    return sd.op("cumsum_ext", ins[0], axis=axis,
                 exclusive=bool(n.attr["exclusive"].b),
                 reverse=bool(n.attr["reverse"].b), name=n.name)


@R("TopKV2")
def _tf_topk(sd, n, ins):
    k = int(_static_value(ins[1], f"{n.op} \'{n.name}\'"))
    # explicit inner name: _fresh() generates '<op>:<counter>' which could
    # collide with the '<node>:<i>' output names when the TF node shares
    # the registry op's name
    v = sd.op("top_k", ins[0], k=k, name=f"{n.name}__packed")
    return tuple(sd.op("tuple_get", v, index=i,
                       name=n.name if i == 0 else f"{n.name}:{i}")
                 for i in range(2))


@R("Unpack")
def _tf_unpack(sd, n, ins):
    num = int(n.attr["num"].i)
    axis = int(n.attr["axis"].i)
    v = sd.op("unstack", ins[0], axis=axis, name=f"{n.name}__packed")
    return tuple(sd.op("tuple_get", v, index=i,
                       name=n.name if i == 0 else f"{n.name}:{i}")
                 for i in range(num))


@R("ReverseV2")
def _tf_reverse(sd, n, ins):
    axes = [int(a) for a in np.atleast_1d(_static_value(ins[1], f"{n.op} \'{n.name}\'"))]
    return sd.op("reverse", ins[0], axes=axes, name=n.name)


def _static_value(var, what):
    """Const value of an edge, falling back to import-time evaluation of
    a placeholder-free subgraph (Shape-derived integer math)."""
    try:
        return _host(var.get_arr())
    except ValueError:
        try:
            return _host(var.eval({}))
        except Exception as e:
            raise UnmappedTFOpException(
                f"{what}: input '{var.name}' is not statically "
                "resolvable at import time") from e


@R("Range")
def _tf_range(sd, n, ins):
    start = _static_value(ins[0], f"Range '{n.name}'").item()
    limit = _static_value(ins[1], f"Range '{n.name}'").item()
    delta = _static_value(ins[2], f"Range '{n.name}'").item()
    dt = np.dtype(_dtype_name(n.attr["Tidx"].type))
    return sd.constant(n.name, np.arange(start, limit, delta, dtype=dt))


@R("MirrorPad")
def _tf_mirror_pad(sd, n, ins):
    paddings = _static_value(ins[1], f"{n.op} \'{n.name}\'").tolist()
    mode = n.attr["mode"].s.decode() or "REFLECT"
    return sd.op("mirror_pad", ins[0], paddings=paddings, mode=mode,
                 name=n.name)


@R("Einsum")
def _tf_einsum(sd, n, ins):
    eq = n.attr["equation"].s.decode()
    return sd.op("einsum", *ins, equation=eq, name=n.name)


def _check_resize_attrs(n, what):
    """jax.image.resize samples at half-pixel centers (the TF2
    tf.image.resize convention).  TF1-legacy graphs carry
    align_corners=True or half_pixel_centers=False — both sample
    DIFFERENT source pixels, so importing them silently mismatches the
    source model; reject with a diagnostic instead."""
    if n.attr["align_corners"].b:
        raise UnmappedTFOpException(
            f"{what} '{n.name}': align_corners=True (TF1 legacy sampling) "
            "is not supported — re-export with TF2 tf.image.resize")
    if "half_pixel_centers" in n.attr and not n.attr[
            "half_pixel_centers"].b:
        raise UnmappedTFOpException(
            f"{what} '{n.name}': half_pixel_centers=False (TF1 legacy "
            "sampling) is not supported — re-export with TF2 "
            "tf.image.resize")


@R("ResizeBilinear")
def _tf_resize_bilinear(sd, n, ins):
    size = [int(s) for s in _static_value(ins[1], f"{n.op} \'{n.name}\'")]
    _check_resize_attrs(n, "ResizeBilinear")
    return sd.op("resize_bilinear", ins[0], size=size, name=n.name)


@R("ResizeNearestNeighbor")
def _tf_resize_nearest(sd, n, ins):
    size = [int(s) for s in _static_value(ins[1], f"{n.op} \'{n.name}\'")]
    _check_resize_attrs(n, "ResizeNearestNeighbor")
    return sd.op("resize_nearest", ins[0], size=size, name=n.name)


def _fdef_edge_base(inp: str) -> str:
    """FunctionDef edges are `arg`, `node:out_name:idx`, or `node:idx` —
    the producing node is always the first component."""
    return inp.partition(":")[0]


def _import_function_body(scope, fdef, arg_vars, library):
    """Replay a FunctionDef's nodes into a control-flow child scope
    (reference `samediff-import-tensorflow` imports TF1 While frames; TF2
    frozen graphs carry functional While/If whose cond/body live in
    graph_def.library — the structured form maps 1:1 onto our
    cond/while_loop subgraphs)."""
    produced = {a.name: v
                for a, v in zip(fdef.signature.input_arg, arg_vars)}

    def lookup(inp: str):
        inp = inp[1:] if inp.startswith("^") else inp
        if inp in produced:
            return produced[inp]
        return produced[_fdef_edge_base(inp)]

    for node in fdef.node_def:
        _eval_node(scope, node, produced, lookup, library)
    outs = []
    for out_arg in fdef.signature.output_arg:
        outs.append(lookup(fdef.ret[out_arg.name]))
    return tuple(outs)


def _make_branch_fn(fdef, library):
    def branch(scope, *args):
        return _import_function_body(scope, fdef, args, library)
    return branch


def _eval_node(sd, node, produced, lookup, library):
    """Dispatch one GraphDef/FunctionDef node into `sd` (shared by the
    top-level import walk and control-flow function bodies)."""
    if node.op == "Placeholder":
        shape = _attr_shape(node) or None
        dt = _dtype_name(node.attr["dtype"].type)
        produced[node.name] = sd.placeholder(
            node.name, shape=shape if shape else None, dtype=dt)
        return
    if node.op == "Const":
        produced[node.name] = sd.constant(node.name, _const_value(node))
        return
    if node.op == "NoOp":
        return
    ins = [lookup(i) for i in node.input if not i.startswith("^")]
    if node.op in ("While", "StatelessWhile"):
        cond_f = library[node.attr["cond"].func.name]
        body_f = library[node.attr["body"].func.name]
        out = sd.while_loop(_make_branch_fn(cond_f, library),
                            _make_branch_fn(body_f, library),
                            *ins, name=node.name)
    elif node.op in ("If", "StatelessIf"):
        then_f = library[node.attr["then_branch"].func.name]
        else_f = library[node.attr["else_branch"].func.name]
        out = sd.cond(ins[0], _make_branch_fn(then_f, library),
                      _make_branch_fn(else_f, library),
                      *ins[1:], name=node.name)
    elif node.op in ("Case", "StatelessCase"):
        # N-way tf.case / tf.switch_case: branch_index input selects one
        # of the `branches` functions; TF's contract routes out-of-range
        # indices to the LAST branch.  Lowered as a chain of nested 2-way
        # conds — each level tests `idx == i`, the innermost level is the
        # default — with the index threaded through as a leading operand
        # so inner scopes can test it.
        branch_fns = [_make_branch_fn(library[f.name], library)
                      for f in node.attr["branches"].list.func]
        idx, operands = ins[0], list(ins[1:])
        if len(branch_fns) == 1:
            raise UnmappedTFOpException(
                f"Case '{node.name}' with a single branch — expected the "
                "grappler to fold this; re-freeze the graph")

        def _level(i):
            if i == len(branch_fns) - 1:
                def default(scope, idx_v, *args, _f=branch_fns[i]):
                    return _f(scope, *args)
                return default

            def level(scope, idx_v, *args, _i=i):
                pred = scope.op(
                    "eq", idx_v,
                    scope.constant(f"__case_idx_{_i}", np.int32(_i)))

                def taken(s2, _j, *a, _f=branch_fns[_i]):
                    return _f(s2, *a)

                return scope.cond(pred, taken, _level(_i + 1), idx_v,
                                  *args)
            return level

        pred0 = sd.op("eq", idx,
                      sd.constant(f"{node.name}__idx0", np.int32(0)))

        def _taken0(scope, _j, *args, _f=branch_fns[0]):
            return _f(scope, *args)

        out = sd.cond(pred0, _taken0, _level(1), idx, *operands,
                      name=node.name)
    else:
        out = TFImportRegistry.get(node.op)(sd, node, ins)
    outs = out if isinstance(out, tuple) else (out,)
    produced[node.name] = outs[0]
    for i, v in enumerate(outs):
        produced[f"{node.name}:{i}"] = v


def _frame_cond_merge(scope, node, by_name, loop_switch_names, llookup,
                      cache):
    """where-select for a tf.cond Merge lowered INSIDE a while frame
    (both branches are computable in the pure deframed body, mirroring
    the frameless cond collapse)."""
    ins = [i for i in node.input if not i.startswith("^")]
    base = node.name
    if len(ins) == 1:
        v = llookup(ins[0])
        cache[base] = v
        cache[f"{base}:0"] = v
        return
    if len(ins) != 2:
        raise UnmappedTFOpException(
            f"Merge '{base}': {len(ins)}-way cond inside a while frame "
            "is unsupported (only 2-way tf.cond nests in loops)")

    def controlling(edge):
        seen = set()
        stack = [(edge.lstrip("^"), 0)]
        while stack:
            e, depth = stack.pop()
            b, _, idx = e.partition(":")
            nd = by_name.get(b)
            if nd is None or (b, depth) in seen:
                continue
            seen.add((b, depth))
            if nd.op == "Switch":
                if b in loop_switch_names:
                    continue        # loop-var gate, not this cond's
                if depth == 0:
                    return b, idx == "1"
                stack.append((nd.input[0].lstrip("^"), depth - 1))
                continue
            d2 = depth + 1 if nd.op == "Merge" else depth
            stack.extend((i.lstrip("^"), d2) for i in nd.input
                         if not i.startswith("^"))
        raise UnmappedTFOpException(
            f"Merge input '{edge}' has no controlling Switch in frame")

    try:
        sw, first_true = controlling(ins[0])
    except UnmappedTFOpException:
        sw, other_true = controlling(ins[1])
        first_true = not other_true
    pred = llookup(by_name[sw].input[1])
    tv = llookup(ins[0] if first_true else ins[1])
    fv = llookup(ins[1] if first_true else ins[0])
    v = scope.op("where", pred, tv, fv)
    cache[base] = v
    cache[f"{base}:0"] = v
    cache[f"{base}:1"] = scope.op("where", pred, np.int32(1), np.int32(0))


def _import_v1_while_frame(sd, frame_nodes, produced, lookup, library,
                           const_nodes=None):
    """Deframe one TF1 while loop (Enter/Merge/Switch/NextIteration/Exit/
    LoopCond — the format the reference interprets per-frame in
    `AbstractSession.java`) into ONE structured `sd.while_loop`.

    Loop state = the Merge'd variables plus every loop-invariant Enter
    (passed through unchanged so branch subgraphs stay closure-free).
    Supports single (non-nested) frames — the shape real frozen TF1
    graphs carry."""
    by_name = {n.name: n for n in frame_nodes}
    all_merges = [n for n in frame_nodes if n.op == "Merge"]
    # Loop-STATE merges join an Enter with a NextIteration; any other
    # Merge inside the frame belongs to a tf.cond lowered INSIDE the loop
    # body (functional while_loop bodies containing tf.cond freeze to
    # exactly this shape) and is handled as a where-select in lazy_eval.
    merges = []
    cond_merge_names = set()
    for m in all_merges:
        kinds = {by_name[_fdef_edge_base(i)].op for i in m.input
                 if not i.startswith("^")
                 and _fdef_edge_base(i) in by_name}
        if kinds & {"Enter", "NextIteration"}:
            merges.append(m)
        else:
            cond_merge_names.add(m.name)
    loopconds = [n for n in frame_nodes if n.op == "LoopCond"]
    if len(loopconds) != 1:
        raise UnmappedTFOpException(
            f"while frame needs exactly 1 LoopCond, found {len(loopconds)} "
            "(nested loops unsupported)")
    loopcond = loopconds[0]
    enters = {n.name: n for n in frame_nodes if n.op == "Enter"}
    # merge k: inputs [Enter, NextIteration]
    merge_enter = {}
    merge_next = {}
    for m in merges:
        for inp in m.input:
            b = _fdef_edge_base(inp)
            if b in enters:
                merge_enter[m.name] = enters[b]
            else:
                merge_next[m.name] = b            # NextIteration node name
    loop_merge_names = {m.name for m in merges}
    switches = {}                                  # merge name -> Switch node
    for n in frame_nodes:
        if n.op == "Switch":
            b = _fdef_edge_base(n.input[0])
            if b in loop_merge_names:
                switches[b] = n
    # invariant enters = those not feeding a merge
    merged_enter_names = {e.name for e in merge_enter.values()}
    invariants = [e for e in enters.values()
                  if e.name not in merged_enter_names]

    var_merges = list(merges)
    n_m = len(var_merges)
    arg_index = {m.name: i for i, m in enumerate(var_merges)}
    for j, e in enumerate(invariants):
        arg_index[e.name] = n_m + j
    switch_index = {switches[m.name].name: i
                    for i, m in enumerate(var_merges) if m.name in switches}

    init = [lookup(merge_enter[m.name].input[0]) for m in var_merges] \
        + [lookup(e.input[0]) for e in invariants]

    def lazy_eval(scope, args, argmap, target_edge, cache):
        """Demand-driven evaluation of a frame edge inside a child scope."""
        edge = target_edge[1:] if target_edge.startswith("^") else target_edge
        base = _fdef_edge_base(edge)
        if base in argmap:
            return args[argmap[base]]
        if edge in cache:
            return cache[edge]
        node = by_name.get(base)
        if node is None:
            # graph Consts physically sit outside the frame partition but
            # are referenced from inside: re-declare them in this scope
            if const_nodes is not None and base in const_nodes:
                v = scope.constant(base, const_nodes[base])
                cache[base] = v
                return v
            raise UnmappedTFOpException(
                f"while frame: edge '{edge}' leaves the frame (closure over "
                "outer graph values is unsupported — freeze them as Const)")
        def llookup(inp):
            return lazy_eval(scope, args, argmap, inp, cache)

        if node.op == "Switch" and base not in {
                s.name for s in switches.values()}:
            # body-internal tf.cond Switch: both branches are computed in
            # the pure deframed body; the Switch passes its data through
            v = llookup(node.input[0])
            cache[base] = v
            cache[f"{base}:0"] = v
            cache[f"{base}:1"] = v
            return cache[edge]
        if node.op == "Merge" and base in cond_merge_names:
            _frame_cond_merge(scope, node, by_name,
                              {s.name for s in switches.values()},
                              llookup, cache)
            return cache[edge]
        if node.op in ("Merge", "Switch", "Enter", "NextIteration", "Exit",
                       "LoopCond"):
            raise UnmappedTFOpException(
                f"while frame: unexpected {node.op} at '{edge}'")
        local = {}

        _eval_node(scope, node, local, llookup, library)
        cache.update(local)
        return cache[edge]

    def cond_fn(scope, *args):
        return lazy_eval(scope, args, arg_index, loopcond.input[0], {})

    # body arg map: references to Switch outputs (:1) become the args
    body_argmap = dict(arg_index)
    body_argmap.update(switch_index)

    def body_fn(scope, *args):
        cache = {}
        outs = []
        for m in var_merges:
            ni = by_name[merge_next[m.name]]
            outs.append(lazy_eval(scope, args, body_argmap, ni.input[0],
                                  cache))
        # invariants pass through unchanged
        outs.extend(args[n_m:])
        return tuple(outs)

    final = sd.while_loop(cond_fn, body_fn, *init)
    if not isinstance(final, tuple):
        final = (final,)
    # map each Exit to its variable's final value
    for n in frame_nodes:
        if n.op == "Exit":
            sw = _fdef_edge_base(n.input[0])
            if sw not in switch_index:
                raise UnmappedTFOpException(
                    f"Exit '{n.name}' input is not a loop-var Switch")
            produced[n.name] = final[switch_index[sw]]


def _frame_partition(graph_def):
    """Group nodes by loop frame (fixpoint propagation — lowered GraphDefs
    are NOT topologically ordered): a node is in frame F if it is an Enter
    with frame_name F, or any of its (data or control) inputs comes from an
    in-frame node that is not that frame's Exit.  Exit nodes are in-frame;
    their consumers are not."""
    frame_of = {}
    exits = set()
    nodes = list(graph_def.node)
    for node in nodes:
        if node.op == "Enter":
            frame_of[node.name] = node.attr["frame_name"].s.decode()
    changed = True
    while changed:
        changed = False
        for node in nodes:
            if node.name in frame_of or node.op == "Enter":
                continue
            for inp in node.input:
                b = _fdef_edge_base(inp.lstrip("^"))
                if b in frame_of and b not in exits:
                    frame_of[node.name] = frame_of[b]
                    if node.op == "Exit":
                        exits.add(node.name)
                    changed = True
                    break
    frames = {}
    for node in nodes:
        f = frame_of.get(node.name)
        if f is not None:
            frames.setdefault(f, []).append(node)
    return frames, [n for n in nodes if n.name not in frame_of]


def import_graph_def(graph_def, input_names: List[str] = None,
                     device="cuda") -> SameDiff:
    """Walk a (frozen) GraphDef into a SameDiff graph on `device`.
    `graph_def` is serialized GraphDef bytes, a path to a ``.pb`` file, an
    object with ``SerializeToString()`` or a ``tf_proto.GraphDef``.  Variables must be
    frozen to Const (the reference likewise imports frozen graphs).
    Multi-output TF nodes (Split, FusedBatchNorm, ...) register each output
    under `name:i`; plain `name` refers to output 0, matching TF edge
    naming.  Control flow lowers onto SameDiff while_loop/cond in both
    forms: functional (While/StatelessWhile, If/StatelessIf with bodies in
    graph_def.library) and TF1 raw frames
    (Enter/Merge/Switch/NextIteration/Exit/LoopCond), which the reference
    interprets per-frame in AbstractSession."""
    graph_def = tf_proto.load_graph_def(graph_def)
    sd = SameDiff.create(device=device)
    produced = {}
    library = {f.signature.name: f for f in graph_def.library.function}
    node_by_name = {n.name: n for n in graph_def.node}
    has_frames = any(n.op == "Enter" for n in graph_def.node)
    if has_frames:
        frames, _ = _frame_partition(graph_def)
        frame_of = {n.name: f for f, ns in frames.items() for n in ns}
        const_nodes = {n.name: _const_value(n) for n in graph_def.node
                       if n.op == "Const"}
    else:
        frames, frame_of, const_nodes = {}, {}, {}

    def lookup(inp: str):
        inp = inp[1:] if inp.startswith("^") else inp
        if inp in produced:
            return produced[inp]
        base, _, idx = inp.partition(":")
        if idx not in ("", "0") and base in produced:
            # consuming output i>0 of a node whose mapper produced fewer
            # outputs must fail loudly, not alias to output 0
            raise UnmappedTFOpException(
                f"Edge '{inp}' consumes a secondary output the mapper for "
                f"'{base}' does not produce")
        return produced[base]

    # Lowered/optimized GraphDefs are NOT topologically ordered, so order
    # evaluation with an iterative Kahn sort (no recursion — a reverse-
    # ordered chain of thousands of nodes must not hit Python's stack
    # limit).  Each while frame is one super-node: deps = its Enter
    # inputs; it satisfies its Exit names.
    def owner(name: str):
        f = frame_of.get(name)
        return ("frame", f) if f is not None else ("node", name)

    items = {}                     # item key -> set of dep item keys
    for node in graph_def.node:
        if node.name in frame_of:
            continue
        deps = set()
        for inp in node.input:
            b = _fdef_edge_base(inp.lstrip("^"))
            if b in node_by_name:
                deps.add(owner(b))
        items[("node", node.name)] = deps
    for f, ns in frames.items():
        deps = set()
        for n in ns:
            if n.op == "Enter":
                b = _fdef_edge_base(n.input[0].lstrip("^"))
                if b in node_by_name:
                    deps.add(owner(b))
        deps.discard(("frame", f))
        items[("frame", f)] = deps
    def controlling_switch(edge):
        """Walk data ancestors of a Merge input to the Switch that gates
        its OWN branch; returns (switch name, came-from-true-output).
        Nested conds pair up: crossing another Merge increments a depth
        counter, and a Switch at depth>0 belongs to that inner cond —
        skip THROUGH its data input instead of stopping."""
        seen = set()
        stack = [(edge.lstrip("^"), 0)]
        while stack:
            e, depth = stack.pop()
            base, _, idx = e.partition(":")
            node = node_by_name.get(base)
            if node is None or (base, depth) in seen:
                continue
            seen.add((base, depth))
            if node.op in ("Switch", "_SwitchN"):
                if depth == 0:
                    # returns (name, taken output port, op kind): for
                    # Switch port 1 is the true branch; for _SwitchN the
                    # port IS the branch index (tf.switch_case lowering)
                    return base, int(idx or 0), node.op
                stack.append((node.input[0].lstrip("^"), depth - 1))
                continue
            d2 = depth + 1 if node.op == "Merge" else depth
            stack.extend((i.lstrip("^"), d2) for i in node.input
                         if not i.startswith("^"))
        raise UnmappedTFOpException(
            f"Merge input '{edge}' has no controlling Switch")

    def eval_frameless_cond_node(node):
        """TF1-lowered tf.cond outside loop frames: Switch passes its
        value to both branch edges (pure graphs — both branches are
        computable), Merge selects by the Switch predicate.  The
        reference interprets these per-frame in AbstractSession; here
        they collapse into one `where` select."""
        if node.op in ("Switch", "_SwitchN"):
            data = lookup(node.input[0])
            n_ports = (2 if node.op == "Switch"
                       else int(node.attr["num_outs"].i))
            produced[node.name] = data
            for i in range(n_ports):
                produced[f"{node.name}:{i}"] = data
            return
        ins = [i for i in node.input if not i.startswith("^")]
        if len(ins) == 1:                # grappler-pruned: pass-through
            out = lookup(ins[0])
            produced[node.name] = out
            produced[f"{node.name}:0"] = out
            return
        # Which gate feeds each input?  A constant branch is gated only by
        # CONTROL edges (no data path to the Switch) — its walk fails and
        # its port is inferred from the others.
        controls = []
        for e in ins:
            try:
                controls.append(controlling_switch(e))
            except UnmappedTFOpException:
                controls.append(None)
        known = [c for c in controls if c is not None]
        if not known:
            raise UnmappedTFOpException(
                f"Merge '{node.name}': no input has a controlling Switch")
        n_way = (len(ins) > 2
                 or any(c[2] == "_SwitchN" for c in known))
        if not n_way:
            if controls[0] is not None:
                sw_name, port, _ = controls[0]
                first_is_true = port == 1
            else:
                sw_name, port, _ = controls[1]
                first_is_true = not (port == 1)
            pred = lookup(node_by_name[sw_name].input[1])
            tv = lookup(ins[0] if first_is_true else ins[1])
            fv = lookup(ins[1] if first_is_true else ins[0])
            out = sd.op("where", pred, tv, fv, name=node.name)
            produced[node.name] = out
            produced[f"{node.name}:0"] = out
            # Merge's second output is the taken-branch index
            produced[f"{node.name}:1"] = sd.op(
                "where", pred,
                sd.constant(f"{node.name}__one", np.int32(1)),
                sd.constant(f"{node.name}__zero", np.int32(0)),
                name=f"{node.name}__value_index")
            return
        # N-way tf.case / tf.switch_case (v1 lowering: one _SwitchN feeds
        # this Merge, input k through port k; TF routes out-of-range
        # indices to the LAST branch, so it is the chain's default).
        sw_name = known[0][0]
        sw_node = node_by_name[sw_name]
        if sw_node.op != "_SwitchN":
            raise UnmappedTFOpException(
                f"Merge '{node.name}': {len(ins)} data inputs but the "
                f"controlling gate '{sw_name}' is a 2-way Switch")
        idx_var = lookup(sw_node.input[1])
        ports = {}
        missing = []
        for e, c in zip(ins, controls):
            if c is None:
                missing.append(e)
            else:
                ports[c[1]] = e
        free = set(range(len(ins))) - set(ports)
        if len(missing) > 1 or len(free) != len(missing):
            raise UnmappedTFOpException(
                f"Merge '{node.name}': cannot assign branch ports "
                f"(ungated inputs {missing}, free ports {sorted(free)})")
        if missing:
            ports[free.pop()] = missing[0]
        n = len(ins)
        out = lookup(ports[n - 1])
        taken = sd.constant(f"{node.name}__p{n - 1}", np.int32(n - 1))
        for k in range(n - 2, -1, -1):
            pk = sd.op("eq", idx_var,
                       sd.constant(f"{node.name}__k{k}", np.int32(k)))
            out = sd.op("where", pk, lookup(ports[k]), out,
                        name=node.name if k == 0 else None)
            taken = sd.op("where", pk,
                          sd.constant(f"{node.name}__t{k}", np.int32(k)),
                          taken)
        produced[node.name] = out
        produced[f"{node.name}:0"] = out
        produced[f"{node.name}:1"] = taken

    ready = [k for k, d in items.items() if not d]
    dependents = {}
    for k, d in items.items():
        for dep in d:
            dependents.setdefault(dep, []).append(k)
    remaining = {k: len(d) for k, d in items.items()}
    n_done = 0
    while ready:
        kind, name = ready.pop()
        n_done += 1
        if kind == "node":
            node = node_by_name[name]
            if node.op in ("Switch", "_SwitchN", "Merge"):
                eval_frameless_cond_node(node)
            else:
                _eval_node(sd, node, produced, lookup, library)
        else:
            _import_v1_while_frame(sd, frames[name], produced, lookup,
                                   library, const_nodes)
        for dep in dependents.get((kind, name), ()):
            remaining[dep] -= 1
            if remaining[dep] == 0:
                ready.append(dep)
    if n_done != len(items):
        stuck = [k for k, c in remaining.items() if c > 0][:5]
        raise UnmappedTFOpException(
            f"GraphDef has a dependency cycle outside loop frames "
            f"(unresolved: {stuck})")
    return sd
