"""ONNX -> SameDiff import (the port of ``modelimport/onnx_import.py``).

Reference: `nd4j/samediff-import/samediff-import-onnx`: `ImportGraph`
walks ONNX NodeProtos, an `OpMappingRegistry` maps each op_type to graph
ops, and unmapped ops fail with a NAMED error.  Same registry pattern here,
targeting the port's `autodiff.SameDiff` on a given device.  The model is
read by the port's own protobuf codec (``modelimport/onnx_proto.py``): no
``onnx`` package is needed.

Layout policy: imported graphs stay in ONNX's NCHW / OIHW (the ``*_nchw``
ops of ``autodiff/ops.py``), with no transposes added, so the imported
graph stays comparable node for node with the source model.  A
``LayerNormalization`` over the last axis runs the port's LayerNorm
kernels on the card (the ``layer_norm`` op).

Float initializers become *trainable* variables by default, so an imported
model can be fine-tuned directly with ``sd.fit(...)`` (the reference's
import-then-train story).

Shape-carrying inputs (Reshape's shape, Slice's starts, Pad's pads, ...)
are read on the host.  The importer keeps a host copy of every integer or
small constant it makes (``SDVariable.host``), so an import onto the card
reads none of them back from the device; Shape and Expand infer static
shapes on meta tensors (``SameDiff.shapes_of``), where the JAX package uses
``jax.eval_shape``.
"""
from __future__ import annotations

from typing import Callable, Dict, List

import numpy as np
import torch

from deeplearning4j_tpu_torch.autodiff import SameDiff
from deeplearning4j_tpu_torch.autodiff.ops import torch_dtype
from deeplearning4j_tpu_torch.modelimport.onnx_proto import (
    BFLOAT16, ModelProto, NodeProto, TensorProto, dtype_name, load_model)

#: float constants of at most this many elements keep a host copy too
#: (Clip bounds, Pad values, OneHot values)
HOST_COPY_MAX_FLOATS = 64


class UnmappedOnnxOpException(Exception):
    pass


class OnnxImportRegistry:
    """ONNX op_type -> mapper(sd, node, ins) -> SDVariable | tuple."""

    _MAP: Dict[str, Callable] = {}

    @classmethod
    def register(cls, op_type: str, fn: Callable = None):
        if fn is None:
            def deco(f):
                cls._MAP[op_type] = f
                return f
            return deco
        cls._MAP[op_type] = fn
        return fn

    @classmethod
    def get(cls, op_type: str) -> Callable:
        if op_type not in cls._MAP:
            raise UnmappedOnnxOpException(
                f"Unmapped ONNX op '{op_type}' — same failure mode as the "
                "reference's OpMappingRegistry; add via "
                "OnnxImportRegistry.register")
        return cls._MAP[op_type]


# -- attribute helpers ------------------------------------------------------

def _attrs(node: NodeProto) -> Dict[str, object]:
    return {a.name: a for a in node.attribute}


def _ai(node, name, default=None):
    a = _attrs(node).get(name)
    return default if a is None else int(a.i)


def _af(node, name, default=None):
    a = _attrs(node).get(name)
    return default if a is None else float(a.f)


def _aints(node, name, default=None):
    a = _attrs(node).get(name)
    return default if a is None else [int(v) for v in a.ints]


def _astr(node, name, default=""):
    a = _attrs(node).get(name)
    return default if a is None else a.s.decode()


def _host_of(v) -> np.ndarray:
    """A constant input's value on the host: the copy the importer kept,
    else the stored array read back (a trainable initializer)."""
    a = getattr(v, "host", None)
    if a is None:
        t = v.get_arr()
        a = t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else t
    return np.asarray(a)


def _const_ints(v) -> List[int]:
    """Read a constant input (initializer/Constant) as a python int list."""
    return [int(x) for x in np.atleast_1d(_host_of(v))]


def _with_host(v, arr):
    """Keep `arr` on the handle `v` where the mappers may read it back."""
    arr = np.asarray(arr)
    if not np.issubdtype(arr.dtype, np.floating) or arr.size <= HOST_COPY_MAX_FLOATS:
        v.host = arr
    return v


def _constant(sd, name, arr):
    return _with_host(sd.constant(name, arr), arr)


def _tensor_value(t: TensorProto):
    """A TensorProto's value: numpy, or a torch bfloat16 tensor."""
    a = t.to_array()
    if t.data_type == BFLOAT16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return a


R = OnnxImportRegistry.register

# -- elementwise / unary ----------------------------------------------------

for onnx_op, our in [("Relu", "relu"), ("Sigmoid", "sigmoid"),
                     ("Tanh", "tanh"), ("Erf", "erf"), ("Exp", "exp"),
                     ("Log", "log"), ("Neg", "neg"), ("Abs", "abs"),
                     ("Sqrt", "sqrt"), ("Reciprocal", "reciprocal"),
                     ("Floor", "floor"), ("Ceil", "ceil"),
                     ("Round", "round"), ("Sign", "sign"),
                     ("Softplus", "softplus"), ("Softsign", "softsign"),
                     ("Identity", "identity"), ("Sin", "sin"),
                     ("Cos", "cos"), ("Tan", "tan"), ("Asin", "asin"),
                     ("Acos", "acos"), ("Atan", "atan"), ("Sinh", "sinh"),
                     ("Cosh", "cosh"), ("Not", "logical_not")]:
    R(onnx_op, (lambda our: lambda sd, n, ins:
                sd.op(our, ins[0], name=n.output[0]))(our))

for onnx_op, our in [("Add", "add"), ("Sub", "sub"), ("Mul", "mul"),
                     ("Div", "div"), ("Pow", "pow"),
                     ("Equal", "equal"), ("Greater", "greater"),
                     ("Less", "less"), ("And", "logical_and"),
                     ("Or", "logical_or"),
                     ("GreaterOrEqual", "greater_equal"),
                     ("LessOrEqual", "less_equal")]:
    R(onnx_op, (lambda our: lambda sd, n, ins:
                sd.op(our, ins[0], ins[1], name=n.output[0]))(our))


@R("Gelu")
def _gelu(sd, n, ins):
    approx = _astr(n, "approximate", "none")
    return sd.op("gelu", ins[0], approximate=(approx == "tanh"),
                 name=n.output[0])


@R("LeakyRelu")
def _leaky(sd, n, ins):
    return sd.op("leaky_relu", ins[0], alpha=_af(n, "alpha", 0.01),
                 name=n.output[0])


@R("Elu")
def _elu(sd, n, ins):
    return sd.op("elu", ins[0], name=n.output[0])


@R("Clip")
def _clip(sd, n, ins):
    # opset>=11: min/max as optional inputs; older: attrs
    lo = hi = None
    if len(ins) > 1 and ins[1] is not None:
        lo = float(_host_of(ins[1]))
    else:
        lo = _af(n, "min")
    if len(ins) > 2 and ins[2] is not None:
        hi = float(_host_of(ins[2]))
    else:
        hi = _af(n, "max")
    return sd.op("clip", ins[0], lo=lo, hi=hi, name=n.output[0])


def _variadic(our_op):
    def fn(sd, n, ins):
        if len(ins) == 1:     # don't rename the input node itself
            return sd.op("identity", ins[0], name=n.output[0])
        out = ins[0]
        for x in ins[1:]:
            out = sd.op(our_op, out, x)
        return sd.rename(out.name, n.output[0])
    return fn


R("Min", _variadic("minimum"))
R("Max", _variadic("maximum"))
R("Sum", _variadic("add"))


@R("Where")
def _where(sd, n, ins):
    return sd.op("where", ins[0], ins[1], ins[2], name=n.output[0])


@R("Dropout")
def _dropout(sd, n, ins):
    # inference-mode import: identity (reference does the same for frozen
    # graphs); the optional mask output is not produced
    return sd.op("identity", ins[0], name=n.output[0])


@R("Cast")
def _cast(sd, n, ins):
    return sd.op("cast", ins[0], dtype=dtype_name(_ai(n, "to", 1)), name=n.output[0])


# -- matmul / gemm ----------------------------------------------------------

R("MatMul", lambda sd, n, ins: sd.op("matmul", ins[0], ins[1],
                                     name=n.output[0]))


@R("Gemm")
def _gemm(sd, n, ins):
    args = ins if len(ins) > 2 and ins[2] is not None else ins[:2]
    return sd.op("gemm", *args, alpha=_af(n, "alpha", 1.0),
                 beta=_af(n, "beta", 1.0), trans_a=_ai(n, "transA", 0),
                 trans_b=_ai(n, "transB", 0), name=n.output[0])


# -- conv / pool / norm -----------------------------------------------------

def _conv_pads(node, n_spatial=2):
    auto = _astr(node, "auto_pad", "NOTSET")
    if auto not in ("", "NOTSET", "VALID"):
        raise UnmappedOnnxOpException(
            f"auto_pad={auto} unsupported — export with explicit pads "
            "(torch and tf2onnx both do)")
    pads = _aints(node, "pads", [0] * (2 * n_spatial))
    return pads


@R("Conv")
def _conv(sd, n, ins):
    pads = _conv_pads(n)
    args = ins if len(ins) > 2 and ins[2] is not None else ins[:2]
    return sd.op("conv2d_nchw", *args,
                 stride=tuple(_aints(n, "strides", [1, 1])),
                 pads=tuple(pads),
                 dilation=tuple(_aints(n, "dilations", [1, 1])),
                 groups=_ai(n, "group", 1), name=n.output[0])


@R("ConvTranspose")
def _conv_transpose(sd, n, ins):
    """ONNX ConvTranspose (gradient-form; torch Conv2dTranspose export).
    Weight layout is IOHW — the transpose of Conv's OIHW."""
    if _astr(n, "auto_pad", "NOTSET") not in ("", "NOTSET"):
        raise UnmappedOnnxOpException(
            "ConvTranspose auto_pad unsupported — export with explicit "
            "pads")
    if _aints(n, "output_shape", None) is not None:
        raise UnmappedOnnxOpException(
            "ConvTranspose output_shape attr unsupported — export with "
            "pads/output_padding instead")
    if _ai(n, "group", 1) != 1:
        raise UnmappedOnnxOpException(
            "ConvTranspose group != 1 unsupported — export with group=1")
    args = ins if len(ins) > 2 and ins[2] is not None else ins[:2]
    return sd.op("deconv2d_nchw", *args,
                 stride=tuple(_aints(n, "strides", [1, 1])),
                 pads=tuple(_aints(n, "pads", [0, 0, 0, 0])),
                 dilation=tuple(_aints(n, "dilations", [1, 1])),
                 output_padding=tuple(_aints(n, "output_padding",
                                             [0, 0])),
                 groups=_ai(n, "group", 1), name=n.output[0])


@R("MaxPool")
def _maxpool(sd, n, ins):
    if _ai(n, "ceil_mode", 0):
        raise UnmappedOnnxOpException("MaxPool ceil_mode=1 unsupported")
    k = _aints(n, "kernel_shape")
    return sd.op("max_pool2d_nchw", ins[0], kernel=tuple(k),
                 stride=tuple(_aints(n, "strides", k)),
                 pads=tuple(_conv_pads(n)), name=n.output[0])


@R("AveragePool")
def _avgpool(sd, n, ins):
    if _ai(n, "ceil_mode", 0):
        raise UnmappedOnnxOpException("AveragePool ceil_mode=1 unsupported")
    k = _aints(n, "kernel_shape")
    return sd.op("avg_pool2d_nchw", ins[0], kernel=tuple(k),
                 stride=tuple(_aints(n, "strides", k)),
                 pads=tuple(_conv_pads(n)),
                 count_include_pad=bool(_ai(n, "count_include_pad", 0)),
                 name=n.output[0])


R("GlobalAveragePool", lambda sd, n, ins:
  sd.op("global_avg_pool_nchw", ins[0], name=n.output[0]))


@R("BatchNormalization")
def _bn(sd, n, ins):
    # inputs: X, scale, B, input_mean, input_var (inference form)
    return sd.op("batch_norm_nchw", ins[0], ins[1], ins[2], ins[3], ins[4],
                 eps=_af(n, "epsilon", 1e-5), name=n.output[0])


@R("LayerNormalization")
def _ln(sd, n, ins):
    axis = _ai(n, "axis", -1)
    if axis not in (-1,):
        raise UnmappedOnnxOpException("LayerNormalization axis != -1 "
                                      "unsupported")
    args = ins if len(ins) > 2 and ins[2] is not None else ins[:2]
    return sd.op("layer_norm", *args, eps=_af(n, "epsilon", 1e-5),
                 name=n.output[0])


# -- shape ops --------------------------------------------------------------

@R("Reshape")
def _reshape(sd, n, ins):
    return sd.op("reshape_onnx", ins[0], shape=_const_ints(ins[1]),
                 name=n.output[0])


@R("Flatten")
def _flatten(sd, n, ins):
    return sd.op("flatten2d", ins[0], axis=_ai(n, "axis", 1),
                 name=n.output[0])


@R("Transpose")
def _transpose(sd, n, ins):
    return sd.op("transpose", ins[0], perm=_aints(n, "perm"),
                 name=n.output[0])


@R("Concat")
def _concat(sd, n, ins):
    return sd.op("concat", *ins, axis=_ai(n, "axis", 0), name=n.output[0])


@R("Squeeze")
def _squeeze(sd, n, ins):
    # opset>=13: axes as input; older: attr
    if len(ins) > 1 and ins[1] is not None:
        axes = _const_ints(ins[1])
    else:
        axes = _aints(n, "axes")
    return sd.op("squeeze", ins[0],
                 axis=None if axes is None else tuple(axes),
                 name=n.output[0])


@R("Unsqueeze")
def _unsqueeze(sd, n, ins):
    if len(ins) > 1 and ins[1] is not None:
        axes = _const_ints(ins[1])
    else:
        axes = _aints(n, "axes")
    out = ins[0]
    for ax in sorted(axes):
        out = sd.op("expand_dims", out, axis=ax)
    return sd.rename(out.name, n.output[0])


@R("Slice")
def _slice(sd, n, ins):
    if len(ins) > 1 and ins[1] is not None:    # opset>=10: inputs
        starts = _const_ints(ins[1])
        ends = _const_ints(ins[2])
        axes = _const_ints(ins[3]) if len(ins) > 3 and ins[3] is not None \
            else None
        steps = _const_ints(ins[4]) if len(ins) > 4 and ins[4] is not None \
            else None
    else:                                      # opset<10: attrs
        starts = _aints(n, "starts")
        ends = _aints(n, "ends")
        axes = _aints(n, "axes")
        steps = None
    return sd.op("slice_onnx", ins[0], starts=starts, ends=ends, axes=axes,
                 steps=steps, name=n.output[0])


@R("Gather")
def _gather(sd, n, ins):
    return sd.op("gather", ins[0], ins[1], axis=_ai(n, "axis", 0),
                 name=n.output[0])


@R("Split")
def _split(sd, n, ins):
    axis = _ai(n, "axis", 0)
    if len(ins) > 1 and ins[1] is not None:    # opset>=13: sizes as input
        sizes = _const_ints(ins[1])
    else:
        sizes = _aints(n, "split")
    if sizes is None:
        raise UnmappedOnnxOpException(
            "Split without explicit sizes needs static input shape — "
            "export with 'split' sizes")
    v = sd.op("split_axis", ins[0], sizes=sizes, axis=axis)
    return tuple(sd.op("tuple_get", v, index=i, name=out)
                 for i, out in enumerate(n.output))


@R("Pad")
def _pad(sd, n, ins):
    mode = _astr(n, "mode", "constant")
    if mode not in ("constant", "reflect", "edge"):
        raise UnmappedOnnxOpException(f"Pad mode={mode} unsupported")
    if len(ins) > 3 and ins[3] is not None:
        raise UnmappedOnnxOpException(
            "Pad with the opset-18 `axes` input is unsupported — export "
            "full-rank pads")
    if len(ins) > 1 and ins[1] is not None:    # opset>=11: pads as input
        pads = _const_ints(ins[1])
        value = float(_host_of(ins[2])) \
            if len(ins) > 2 and ins[2] is not None else 0.0
    else:
        pads = _aints(n, "pads")
        value = _af(n, "value", 0.0)
    rank = len(pads) // 2
    paddings = [[pads[i], pads[i + rank]] for i in range(rank)]
    if mode == "constant":
        return sd.op("pad", ins[0], paddings=paddings, value=value,
                     name=n.output[0])
    return sd.op("pad_mode", ins[0], paddings=paddings, mode=mode,
                 name=n.output[0])


# -- reductions / softmax ---------------------------------------------------

def _reduce(our_op):
    def fn(sd, n, ins):
        if len(ins) > 1 and ins[1] is not None:  # opset>=18: axes as input
            axes = _const_ints(ins[1])
        else:
            axes = _aints(n, "axes")
        return sd.op(our_op, ins[0],
                     axis=None if axes is None else tuple(axes),
                     keepdims=bool(_ai(n, "keepdims", 1)),
                     name=n.output[0])
    return fn


R("ReduceMean", _reduce("mean"))
R("ReduceSum", _reduce("sum"))
R("ReduceMax", _reduce("max"))
R("ReduceMin", _reduce("min"))
R("ReduceProd", _reduce("prod"))


@R("Softmax")
def _softmax(sd, n, ins):
    return sd.op("softmax", ins[0], axis=_ai(n, "axis", -1),
                 name=n.output[0])


@R("LogSoftmax")
def _log_softmax(sd, n, ins):
    return sd.op("log_softmax", ins[0], axis=_ai(n, "axis", -1),
                 name=n.output[0])


@R("ArgMax")
def _argmax(sd, n, ins):
    v = sd.op("argmax", ins[0], axis=_ai(n, "axis", 0))
    if _ai(n, "keepdims", 1):
        v = sd.op("expand_dims", v, axis=_ai(n, "axis", 0))
    return sd.rename(v.name, n.output[0])


# -- shape/broadcast ops (torch dynamic-shape export tail) ------------------

def _static_shape(sd, v, ctx: str):
    """Static shape of an imported variable: a leaf's own, else by running
    the graph built so far on meta tensors (only statically-shaped graphs
    import)."""
    node = sd._nodes[v.name]
    if node.kind in ("variable", "constant"):
        return tuple(node.shape)
    if node.kind == "placeholder" and node.shape is not None \
            and None not in node.shape:
        return tuple(node.shape)     # the dominant torch-export pattern
    phs = {name: nd for name, nd in sd._nodes.items()
           if nd.kind == "placeholder"}
    unshaped = [name for name, nd in phs.items() if nd.shape is None]
    if unshaped:
        raise UnmappedOnnxOpException(
            f"{ctx}: placeholders {unshaped} have no static shape — only "
            "statically-shaped graphs import")
    specs = {name: torch.empty(tuple(nd.shape), dtype=torch_dtype(nd.dtype),
                               device="meta")
             for name, nd in phs.items()}
    try:
        shape, _ = sd.shapes_of(specs, v.name)[v.name]
    except Exception as e:
        raise UnmappedOnnxOpException(
            f"{ctx}: abstract shape inference failed") from e
    return tuple(shape)


@R("Shape")
def _shape(sd, n, ins):
    s = _static_shape(sd, ins[0], f"Shape '{n.name}'")
    start = _ai(n, "start", 0)
    end = _ai(n, "end", len(s))
    return _constant(sd, n.output[0], np.asarray(s[start:end], np.int64))


@R("Expand")
def _expand(sd, n, ins):
    target = _const_ints(ins[1])
    xs = _static_shape(sd, ins[0], f"Expand '{n.name}'")
    out = np.broadcast_shapes(tuple(xs), tuple(target))
    return sd.op("broadcast_to", ins[0], shape=list(out), name=n.output[0])


@R("Tile")
def _tile(sd, n, ins):
    return sd.op("tile", ins[0], reps=_const_ints(ins[1]), name=n.output[0])


@R("ConstantOfShape")
def _constant_of_shape(sd, n, ins):
    shape = _const_ints(ins[0])
    a = _attrs(n).get("value")
    fill = a.t.to_array().reshape(()) if a is not None else np.float32(0)
    return _constant(sd, n.output[0], np.full(shape, fill))


@R("Range")
def _range(sd, n, ins):
    start, limit, delta = (_host_of(v).reshape(()) for v in ins)
    # ONNX Range keeps its inputs' type (numpy's arange would widen f32)
    return _constant(sd, n.output[0],
                     np.arange(start, limit, delta).astype(start.dtype))


# -- normalization / activations (opset tail) -------------------------------

@R("InstanceNormalization")
def _instance_norm(sd, n, ins):
    eps = _af(n, "epsilon", 1e-5)
    x, scale, bias = ins
    mu = sd.op("mean", x, axis=[2, 3], keepdims=True)
    d = sd.op("sub", x, mu)
    var = sd.op("mean", sd.op("mul", d, d), axis=[2, 3], keepdims=True)
    inv = sd.op("rsqrt", var + eps)
    s4 = sd.op("reshape", scale, shape=[1, -1, 1, 1])
    b4 = sd.op("reshape", bias, shape=[1, -1, 1, 1])
    return sd.op("add", sd.op("mul", sd.op("mul", d, inv), s4), b4,
                 name=n.output[0])


@R("PRelu")
def _prelu_onnx(sd, n, ins):
    return sd.op("prelu", ins[0], ins[1], name=n.output[0])


@R("HardSigmoid")
def _hard_sigmoid(sd, n, ins):
    alpha = _af(n, "alpha", 0.2)
    beta = _af(n, "beta", 0.5)
    y = ins[0] * alpha + beta
    return sd.op("clip_by_value", y, lo=0.0, hi=1.0, name=n.output[0])


@R("HardSwish")
def _hard_swish(sd, n, ins):
    # onnx HardSwish == the hard_swish op == x*relu6(x+3)/6
    return sd.op("hard_swish", ins[0], name=n.output[0])


# -- misc tensor ops --------------------------------------------------------

@R("CumSum")
def _cumsum(sd, n, ins):
    axis = int(_host_of(ins[1]).reshape(()))
    return sd.op("cumsum_ext", ins[0], axis=axis,
                 exclusive=bool(_ai(n, "exclusive", 0)),
                 reverse=bool(_ai(n, "reverse", 0)), name=n.output[0])


@R("TopK")
def _topk(sd, n, ins):
    k = int(_const_ints(ins[1])[0])
    axis = _ai(n, "axis", -1)
    if axis not in (-1, None):
        xs = _static_shape(sd, ins[0], f"TopK '{n.name}'")
        if axis != len(xs) - 1:
            raise UnmappedOnnxOpException(
                f"TopK '{n.name}': only last-axis supported (got {axis})")
    if _ai(n, "largest", 1) != 1:
        raise UnmappedOnnxOpException(
            f"TopK '{n.name}': largest=0 not supported")
    packed = sd.op("top_k", ins[0], k=k, name=f"{n.output[0]}__packed")
    vals = sd.op("tuple_get", packed, index=0, name=n.output[0])
    idx32 = sd.op("tuple_get", packed, index=1)
    idx = sd.op("cast", idx32, dtype="int64", name=n.output[1])  # onnx I
    return vals, idx


@R("Trilu")
def _trilu(sd, n, ins):
    k = 0 if len(ins) < 2 or ins[1] is None else \
        int(_host_of(ins[1]).reshape(()))
    op = "triu" if _ai(n, "upper", 1) else "tril"
    return sd.op(op, ins[0], k=k, name=n.output[0])


@R("Mod")
def _mod(sd, n, ins):
    op = "fmod" if _ai(n, "fmod", 0) else "mod"
    return sd.op(op, ins[0], ins[1], name=n.output[0])


@R("ReduceL2")
def _reduce_l2(sd, n, ins):
    axes = _aints(n, "axes")
    if len(ins) > 1 and ins[1] is not None:
        axes = _const_ints(ins[1])
    return sd.op("norm2", ins[0], axis=axes,
                 keepdims=bool(_ai(n, "keepdims", 1)), name=n.output[0])


@R("OneHot")
def _one_hot(sd, n, ins):
    depth = int(_host_of(ins[1]).reshape(()))
    values = _host_of(ins[2])
    axis = _ai(n, "axis", -1)
    if axis != -1:
        raise UnmappedOnnxOpException(
            f"OneHot '{n.name}': only axis=-1 supported")
    on, off = float(values[1]), float(values[0])
    idx = ins[0]
    # onnx: i < 0 means depth + i (the one_hot op would emit all-off)
    neg = sd.op("less", idx, idx._coerce(0))
    idx = sd.op("where", neg, idx + depth, idx)
    oh = sd.op("one_hot", idx, depth=depth)
    return sd.rename((oh * (on - off) + off).name, n.output[0])


@R("ScatterND")
def _scatter_nd(sd, n, ins):
    red = _astr(n, "reduction", "none")
    op = {"none": "scatter_nd_update", "add": "scatter_nd_add"}.get(red)
    if op is None:
        raise UnmappedOnnxOpException(
            f"ScatterND '{n.name}': reduction={red} unsupported")
    return sd.op(op, ins[0], ins[1], ins[2], name=n.output[0])


@R("ArgMin")
def _argmin(sd, n, ins):
    v = sd.op("argmin", ins[0], axis=_ai(n, "axis", 0))
    if _ai(n, "keepdims", 1):
        v = sd.op("expand_dims", v, axis=_ai(n, "axis", 0))
    return sd.rename(v.name, n.output[0])


@R("ReduceSumSquare")
def _reduce_ss(sd, n, ins):
    axes = _aints(n, "axes")
    if len(ins) > 1 and ins[1] is not None:
        axes = _const_ints(ins[1])
    sq = sd.op("mul", ins[0], ins[0])
    return sd.op("sum", sq, axis=None if axes is None else tuple(axes),
                 keepdims=bool(_ai(n, "keepdims", 1)), name=n.output[0])


@R("Einsum")
def _einsum(sd, n, ins):
    return sd.op("einsum", *ins, equation=_astr(n, "equation"),
                 name=n.output[0])


@R("GatherND")
def _gather_nd(sd, n, ins):
    if _ai(n, "batch_dims", 0) != 0:
        raise UnmappedOnnxOpException(
            f"GatherND '{n.name}': batch_dims != 0 unsupported")
    return sd.op("gather_nd", ins[0], ins[1], name=n.output[0])


R("ReduceLogSumExp", _reduce("logsumexp"))


@R("Resize")
def _resize(sd, n, ins):
    """ONNX Resize, the torch Upsample export envelope: mode=nearest with
    asymmetric/floor (integer upscale — exactly pixel-repeat, which
    the resize_nearest op's half-pixel nearest also gives at integer
    factors) and mode=linear with half_pixel (= the resize_bilinear op).
    NCHW in/out."""
    mode = _astr(n, "mode", "nearest")
    ct = _astr(n, "coordinate_transformation_mode", "half_pixel")
    xs = _static_shape(sd, ins[0], f"Resize '{n.name}'")
    if len(xs) != 4:
        raise UnmappedOnnxOpException(
            f"Resize '{n.name}': only 4-D NCHW inputs supported")
    if len(ins) > 3 and ins[3] is not None:          # sizes
        sizes = _const_ints(ins[3])
        oh, ow = sizes[2], sizes[3]
    elif len(ins) > 2 and ins[2] is not None:        # scales
        scales = [float(v) for v in np.atleast_1d(_host_of(ins[2]))]
        oh = int(round(xs[2] * scales[2]))
        ow = int(round(xs[3] * scales[3]))
    else:
        raise UnmappedOnnxOpException(
            f"Resize '{n.name}': needs scales or sizes")
    if mode == "nearest":
        nm = _astr(n, "nearest_mode", "round_prefer_floor")
        int_up = oh % xs[2] == 0 and ow % xs[3] == 0
        if not (ct in ("asymmetric", "half_pixel") and int_up
                and nm in ("floor", "round_prefer_floor")):
            raise UnmappedOnnxOpException(
                f"Resize '{n.name}': nearest supported only for integer "
                f"upscale with asymmetric/half_pixel + floor modes "
                f"(got ct={ct}, nearest_mode={nm}, {xs[2:]}→{(oh, ow)})")
        our = "resize_nearest"
    elif mode == "linear":
        if ct != "half_pixel":
            raise UnmappedOnnxOpException(
                f"Resize '{n.name}': linear supported only with "
                f"half_pixel (torch align_corners=False); got {ct}")
        our = "resize_bilinear"
    else:
        raise UnmappedOnnxOpException(
            f"Resize '{n.name}': mode={mode} unsupported")
    nhwc = sd.op("transpose", ins[0], perm=[0, 2, 3, 1])
    y = sd.op(our, nhwc, size=[oh, ow])
    return sd.op("transpose", y, perm=[0, 3, 1, 2], name=n.output[0])


# -- recurrent layers (torch nn.LSTM / nn.GRU exports) ----------------------

def _rnn_weights(sd, n, W, R, B, n_gates, perm, hidden):
    """Split ONNX packed RNN weights into our cell layout.

    ONNX packs W:[1, G*H, I], R:[1, G*H, H], B:[1, 2*G*H] with its own
    gate order; `perm` reorders gate blocks into the registry cells'
    order.  Transformed tensors re-enter the graph as trainable variables
    (imported initializers are trainable, module docstring)."""
    w = _host_of(W)[0]
    r = _host_of(R)[0]
    H = hidden

    def reorder(m):
        blocks = [m[g * H:(g + 1) * H] for g in range(n_gates)]
        return np.concatenate([blocks[g] for g in perm], 0)

    w_ih = reorder(w).T.copy()              # [I, G*H]
    w_hh = reorder(r).T.copy()              # [H, G*H]
    if B is not None:
        b = _host_of(B)[0]
        wb = reorder(b[:n_gates * H])
        rb = reorder(b[n_gates * H:])
    else:
        wb = rb = np.zeros(n_gates * H, w.dtype)
    mk = lambda tag, arr: sd.var(f"{n.output[0]}__{tag}", np.asarray(arr))
    return mk("w_ih", w_ih), mk("w_hh", w_hh), wb, rb


def _rnn_common(sd, n, ins, n_gates):
    if _astr(n, "direction", "forward") != "forward":
        raise UnmappedOnnxOpException(
            f"{n.op_type} '{n.name}': only direction=forward supported")
    if _ai(n, "layout", 0) != 0:
        raise UnmappedOnnxOpException(
            f"{n.op_type} '{n.name}': only layout=0 ([T,B,*]) supported")
    if len(ins) > 4 and ins[4] is not None:
        raise UnmappedOnnxOpException(
            f"{n.op_type} '{n.name}': sequence_lens unsupported — export "
            "fixed-length sequences")
    hidden = _ai(n, "hidden_size")
    B = ins[3] if len(ins) > 3 else None
    xbtf = sd.op("transpose", ins[0], perm=[1, 0, 2])   # [T,B,I]->[B,T,I]
    return hidden, B, xbtf


def _squeeze0(sd, v):
    return None if v is None else sd.op("squeeze", v, axis=(0,))


@R("LSTM")
def _lstm_onnx(sd, n, ins):
    """ONNX LSTM (iofc gate order) -> lstm_layer_full (IFCO)."""
    if len(ins) > 7 and ins[7] is not None:
        raise UnmappedOnnxOpException(
            f"LSTM '{n.name}': peephole weights unsupported")
    hidden, B, xbtf = _rnn_common(sd, n, ins, 4)
    w_ih, w_hh, wb, rb = _rnn_weights(sd, n, ins[1], ins[2], B, 4,
                                      perm=[0, 2, 3, 1], hidden=hidden)
    bias = sd.var(f"{n.output[0]}__b", np.asarray(wb + rb))
    h0 = _squeeze0(sd, ins[5] if len(ins) > 5 else None)
    c0 = _squeeze0(sd, ins[6] if len(ins) > 6 else None)
    if c0 is not None and h0 is None:     # onnx allows either alone
        h0 = sd.op("zeros_like", c0)
    args = [xbtf, w_ih, w_hh, bias] + ([h0] if h0 is not None else []) \
        + ([c0] if c0 is not None else [])
    packed = sd.op("lstm_layer_full", *args,
                   name=f"{n.output[0]}__packed")
    seq = sd.op("tuple_get", packed, index=0)         # [B,T,H]
    h_n = sd.op("tuple_get", packed, index=1)         # [B,H]
    c_n = sd.op("tuple_get", packed, index=2)
    y = sd.op("expand_dims", sd.op("transpose", seq, perm=[1, 0, 2]),
              axis=1, name=n.output[0])               # [T,1,B,H]
    outs = [y]
    if len(n.output) > 1 and n.output[1]:
        outs.append(sd.op("expand_dims", h_n, axis=0, name=n.output[1]))
    if len(n.output) > 2 and n.output[2]:
        outs.append(sd.op("expand_dims", c_n, axis=0, name=n.output[2]))
    return tuple(outs)


@R("GRU")
def _gru_onnx(sd, n, ins):
    """ONNX GRU (zrh gate order) -> gru_layer ([r,z,n] order).

    Only linear_before_reset=1 (the torch export form — and exactly the
    registry gru_cell's semantics: r gates the already-linear W_hn·h+b)."""
    if not _ai(n, "linear_before_reset", 0):
        raise UnmappedOnnxOpException(
            f"GRU '{n.name}': linear_before_reset=0 unsupported (torch "
            "exports 1; the registry cell implements that form)")
    hidden, B, xbtf = _rnn_common(sd, n, ins, 3)
    w_ih, w_hh, wb, rb = _rnn_weights(sd, n, ins[1], ins[2], B, 3,
                                      perm=[1, 0, 2], hidden=hidden)
    b_ih = sd.var(f"{n.output[0]}__b_ih", np.asarray(wb))
    b_hh = sd.var(f"{n.output[0]}__b_hh", np.asarray(rb))
    h0 = _squeeze0(sd, ins[5] if len(ins) > 5 else None)
    if h0 is None:                        # batch/dtype-generic zeros
        h0 = sd.op("zeros_rows_like", xbtf, n=hidden)
    seq = sd.op("gru_layer", xbtf, h0, w_ih, w_hh, b_ih, b_hh,
                name=f"{n.output[0]}__seq")           # [B,T,H]
    y = sd.op("expand_dims", sd.op("transpose", seq, perm=[1, 0, 2]),
              axis=1, name=n.output[0])               # [T,1,B,H]
    outs = [y]
    if len(n.output) > 1 and n.output[1]:
        last = sd.op("gather", seq, sd.constant(None, np.int64(-1)),
                     axis=1)                          # [B,H] final step
        outs.append(sd.op("expand_dims", last, axis=0, name=n.output[1]))
    return tuple(outs)


# -- the import -------------------------------------------------------------

def import_onnx_model(src, trainable: bool = True, device="cuda") -> SameDiff:
    """Import an ONNX model (path, bytes, or ModelProto) into a SameDiff
    graph on `device`.  Graph inputs -> placeholders; float initializers ->
    trainable variables (fine-tunable) unless `trainable=False`; other
    initializers -> constants.  The returned graph records `import_inputs`
    / `import_outputs` (the ONNX graph's I/O names)."""
    model = src if isinstance(src, ModelProto) else load_model(src)
    g = model.graph
    sd = SameDiff.create(device=device)
    produced = {}

    init_names = set()
    for t in g.initializer:
        value = _tensor_value(t)
        init_names.add(t.name)
        floating = isinstance(value, torch.Tensor) or np.issubdtype(value.dtype, np.floating)
        if trainable and floating:
            v = sd.var(t.name, value)
        else:
            v = sd.constant(t.name, value)
        produced[t.name] = v if isinstance(value, torch.Tensor) else _with_host(v, value)

    for vi in g.input:
        if vi.name in produced:
            continue
        shape = None if vi.shape is None else tuple(
            d if d is not None and d > 0 else None for d in vi.shape)
        produced[vi.name] = sd.placeholder(vi.name, shape=shape,
                                           dtype=dtype_name(vi.elem_type))

    for node in g.node:
        if node.op_type == "Constant":
            a = _attrs(node)
            name = node.output[0]
            if "value" in a:
                value = _tensor_value(a["value"].t)
                produced[name] = (sd.constant(name, value) if isinstance(value, torch.Tensor)
                                  else _constant(sd, name, value))
            elif "value_float" in a:
                produced[name] = _constant(sd, name, np.float32(a["value_float"].f))
            elif "value_int" in a:
                produced[name] = _constant(sd, name, np.int64(a["value_int"].i))
            else:
                raise UnmappedOnnxOpException(
                    "Constant node without value/value_float/value_int")
            continue
        fn = OnnxImportRegistry.get(node.op_type)
        ins = [produced[i] if i else None for i in node.input]
        out = fn(sd, node, ins)
        outs = out if isinstance(out, tuple) else (out,)
        for oname, v in zip(node.output, outs):
            if v.name != oname:
                v = sd.rename(v.name, oname)
            produced[oname] = v

    sd.import_inputs = [vi.name for vi in g.input
                        if vi.name not in init_names]
    sd.import_outputs = [vi.name for vi in g.output]
    return sd
