"""Op table for the SameDiff graph engine (the port of ``autodiff/ops.py``,
its core part).

Each entry is a plain function over tensors with the JAX package's
semantics: its rounding, its dtype promotion and its gradients, which here
come from autograd.  Two rules carry JAX's typing over to PyTorch:

* a Python scalar is *weakly typed*, as ``jnp.asarray(2.0)`` is: it takes
  the dtype of the tensor it meets (f32 * 2.0 stays f32).  The graph keeps
  a constant made from a Python scalar as that scalar (``samediff.py``),
  and the binary ops below promote it as JAX does (:func:`_pair`);
* two tensors promote by dtype alone (``torch.promote_types``), whatever
  their ranks: JAX has no rank-0 exception, so a 0-dim f64 tensor times an
  f32 one is f64 here too.

``layer_norm`` goes through the port's ``fused_layer_norm`` and
``multi_head_dot_product_attention`` through ``fused_attention``, so a
graph on the card runs the LayerNorm and flash-attention kernels; a 3x3
stride-1 SAME ``conv2d`` without a bias takes ``conv3x3_same`` as the
port's layers do.

The table holds the core ops, the TF-import support ops, the ONNX-layout
ops (NCHW / OIHW, as ONNX lays them out: ``conv2d_nchw`` and
``deconv2d_nchw`` are ``F.conv2d`` and ``F.conv_transpose2d``, ``gemm`` a
``torch.matmul``, where the JAX package calls ``lax``) and every op that
the namespaces of ``samediff.py`` and the mappers of
``modelimport/tf_import.py`` and ``modelimport/onnx_import.py`` emit.
The JAX table's other families (random, bitwise, segment, most of
scatter, image, the rest of linalg, updater ops, TensorList) are not
ported yet; of its compression family ``encode_threshold`` and
``decode_threshold`` are; ``register_op`` adds ops.
"""
from __future__ import annotations

from typing import Callable, Dict

import numpy as np
import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch.ops.activations import relu6 as _relu6

OP_TABLE: Dict[str, Callable] = {}

_SCALARS = (bool, int, float)


def register_op(name: str, fn: Callable = None):
    if name in OP_TABLE:
        raise ValueError(f"op {name!r} already registered — duplicate "
                         "registrations inflate the op-inventory count")
    if fn is None:
        def deco(f):
            OP_TABLE[name] = f
            return f
        return deco
    OP_TABLE[name] = fn
    return fn


# ---------------------------------------------------------------------------
# typing helpers
# ---------------------------------------------------------------------------

TORCH_DTYPES = {
    "float32": torch.float32, "float64": torch.float64, "float16": torch.float16,
    "bfloat16": torch.bfloat16, "int8": torch.int8, "int16": torch.int16,
    "int32": torch.int32, "int64": torch.int64, "uint8": torch.uint8,
    "bool": torch.bool,
}
DTYPE_NAMES = {v: k for k, v in TORCH_DTYPES.items()}


def torch_dtype(d) -> torch.dtype:
    """A dtype name (``"float32"``), numpy dtype or torch dtype."""
    if isinstance(d, torch.dtype):
        return d
    return TORCH_DTYPES[np.dtype(d).name if not isinstance(d, str) or d not in
                        TORCH_DTYPES else d]


def is_weak(x) -> bool:
    """A Python scalar (not a numpy scalar): JAX's weakly typed value."""
    return isinstance(x, _SCALARS) and not isinstance(x, np.generic)


def _weak_dtype(s, other: torch.dtype) -> torch.dtype:
    """The dtype a weak scalar `s` takes beside a tensor of `other`."""
    if isinstance(s, bool):
        return other
    if isinstance(s, int):
        return torch.int64 if other == torch.bool else other
    # a float scalar: a float tensor keeps its dtype; an int or bool one
    # goes to the default float type
    return other if other.is_floating_point else torch.get_default_dtype()


def as_tensor(x, device=None, dtype=None) -> torch.Tensor:
    """`x` as a tensor (on `device` unless it is one already; a weak scalar
    by ``full``, which a CUDA graph captures as a fill, with no copy from
    host memory)."""
    if isinstance(x, torch.Tensor):
        return x if dtype is None else x.to(dtype)
    dev = device
    if is_weak(x):
        if dtype is None:
            dtype = (torch.bool if isinstance(x, bool) else torch.int64
                     if isinstance(x, int) else torch.get_default_dtype())
        return torch.full((), x, dtype=dtype, device=dev)
    return torch.as_tensor(np.asarray(x), device=dev) if dtype is None else \
        torch.as_tensor(np.asarray(x), device=dev).to(dtype)


def _pair(a, b):
    """Both operands as tensors of JAX's result dtype."""
    ta, tb = isinstance(a, torch.Tensor), isinstance(b, torch.Tensor)
    if ta and tb:
        if a.dtype != b.dtype:
            dt = torch.promote_types(a.dtype, b.dtype)
            a, b = a.to(dt), b.to(dt)
        return a, b
    if ta:
        dt = _weak_dtype(b, a.dtype) if is_weak(b) else None
        b = as_tensor(b, a.device, dt)
        return _pair(a, b)
    if tb:
        dt = _weak_dtype(a, b.dtype) if is_weak(a) else None
        a = as_tensor(a, b.device, dt)
        return _pair(a, b)
    return _pair(as_tensor(a), as_tensor(b))


def _t(x) -> torch.Tensor:
    return as_tensor(x)


def binary(fn):
    return lambda a, b: fn(*_pair(a, b))


def unary(fn):
    return lambda a: fn(_t(a))


def _axes(axis, ndim):
    if axis is None:
        return tuple(range(ndim))
    if isinstance(axis, (list, tuple)):
        return tuple(int(a) for a in axis)
    return (int(axis),)


def _float(a):
    """JAX's unary float ops turn ints and bools into the default float."""
    a = _t(a)
    return a if a.is_floating_point() else a.to(torch.get_default_dtype())


def _reduce(fn):
    def red(a, axis=None, keepdims=False):
        a = _t(a)
        return fn(a, dim=_axes(axis, a.ndim), keepdim=keepdims)
    return red


def _index(x: torch.Tensor, idx) -> torch.Tensor:
    """numpy basic indexing (ints, slices with any step, None, Ellipsis),
    which torch lacks for negative steps."""
    idx = list(idx)
    if Ellipsis in idx:
        i = idx.index(Ellipsis)
        n_real = sum(1 for e in idx if e is not None and e is not Ellipsis)
        idx[i:i + 1] = [slice(None)] * (x.ndim - n_real)
    d = 0
    for e in idx:
        if e is None:
            x = x.unsqueeze(d)
            d += 1
            continue
        if isinstance(e, slice):
            start, stop, step = e.indices(x.shape[d])
            if step == 1:
                x = x.narrow(d, start, max(stop - start, 0))
            else:
                sel = torch.arange(start, stop, step, device=x.device)
                x = x.index_select(d, sel)
            d += 1
        else:
            i = int(e)
            x = x.select(d, i + x.shape[d] if i < 0 else i)
    return x


# ---------------------------------------------------------------------------
# elementwise arithmetic
# ---------------------------------------------------------------------------

def _jax_mod(a, b):
    """jnp.remainder: the sign of the divisor."""
    a, b = _pair(a, b)
    if not a.is_floating_point():
        return torch.remainder(a, b)
    r = torch.fmod(a, b)
    fix = (r != 0) & ((r < 0) != (b < 0))
    return torch.where(fix, r + b, r)


def _jax_floor_div(a, b):
    """jnp.floor_divide: floor for ints; for floats numpy's divmod."""
    a, b = _pair(a, b)
    if not a.is_floating_point():
        return torch.div(a, b, rounding_mode="floor")
    mod = torch.fmod(a, b)
    div = (a - mod) / b
    fix = (mod != 0) & (torch.sign(b) != torch.sign(mod))
    div = torch.where(fix, div - 1, div)
    return torch.round(div)


def _jax_div(a, b):
    a, b = _pair(a, b)
    if not a.is_floating_point():
        # jnp true division of ints gives the default float
        dt = torch.get_default_dtype()
        a, b = a.to(dt), b.to(dt)
    return a / b


def _jax_pow(a, b):
    a, b = _pair(a, b)
    return torch.pow(a, b)


def _clip(a, lo=None, hi=None):
    a = _t(a)
    if lo is not None:
        a = torch.maximum(*_pair(a, lo))
    if hi is not None:
        a = torch.minimum(*_pair(a, hi))
    return a


register_op("add", binary(torch.add))
register_op("sub", binary(torch.sub))
register_op("mul", binary(torch.mul))
register_op("div", _jax_div)
register_op("rsub", lambda a, b: OP_TABLE["sub"](b, a))
register_op("rdiv", lambda a, b: _jax_div(b, a))
register_op("pow", _jax_pow)
register_op("neg", unary(torch.neg))
register_op("abs", unary(lambda a: a if a.dtype == torch.bool
                         else torch.where(a >= 0, a, -a)))  # jnp.abs: gradient 1 at 0
register_op("exp", lambda a: torch.exp(_float(a)))
register_op("log", lambda a: torch.log(_float(a)))
register_op("log1p", lambda a: torch.log1p(_float(a)))
register_op("sqrt", lambda a: torch.sqrt(_float(a)))
register_op("square", lambda a: _t(a) * _t(a))
register_op("reciprocal", lambda a: _jax_div(1.0, a))
register_op("sign", unary(torch.sign))
register_op("floor", unary(torch.floor))
register_op("ceil", unary(torch.ceil))
register_op("round", unary(torch.round))        # half to even, as jnp.round
register_op("clip", _clip)
register_op("maximum", binary(torch.maximum))
register_op("minimum", binary(torch.minimum))
register_op("less", binary(torch.lt))
register_op("less_equal", binary(torch.le))
register_op("greater", binary(torch.gt))
register_op("greater_equal", binary(torch.ge))
register_op("equal", binary(torch.eq))
register_op("not_equal", binary(torch.ne))
register_op("logical_and", lambda a, b: torch.logical_and(_t(a), _t(b)))
register_op("logical_or", lambda a, b: torch.logical_or(_t(a), _t(b)))
register_op("logical_not", unary(torch.logical_not))

# ---- trig / hyperbolic ----
for _n in ["sin", "cos", "tan", "asin", "acos", "atan", "sinh", "cosh",
           "tanh", "asinh", "acosh", "atanh"]:
    register_op(_n, (lambda f: lambda a: f(_float(a)))(getattr(torch, _n)))

# ---- comparisons / logic ----
register_op("eq", binary(torch.eq))
register_op("neq", binary(torch.ne))
register_op("gt", binary(torch.gt))
register_op("gte", binary(torch.ge))
register_op("lt", binary(torch.lt))
register_op("lte", binary(torch.le))


@register_op("where")
def _where(c, a, b):
    a, b = _pair(a, b)
    return torch.where(_t(c).to(torch.bool), a, b)


register_op("isnan", unary(torch.isnan))
register_op("isinf", unary(torch.isinf))


# ---- reductions ----
def _sum(a, dim, keepdim):
    a = _t(a)
    if a.dtype == torch.bool:
        a = a.to(torch.int64)
    return torch.sum(a, dim=dim, keepdim=keepdim)


def _mean(a, dim, keepdim):
    return torch.mean(_float(a), dim=dim, keepdim=keepdim)


def _amax(a, dim, keepdim):
    return torch.amax(a, dim=dim, keepdim=keepdim) if a.ndim else a


def _amin(a, dim, keepdim):
    return torch.amin(a, dim=dim, keepdim=keepdim) if a.ndim else a


def _prod(a, dim, keepdim):
    for d in sorted((x % max(a.ndim, 1) for x in dim), reverse=True):
        a = torch.prod(a, dim=d, keepdim=keepdim) if a.ndim else a
    return a


register_op("sum", _reduce(_sum))
register_op("mean", _reduce(_mean))
register_op("max", _reduce(_amax))
register_op("min", _reduce(_amin))
register_op("prod", _reduce(_prod))
register_op("std", lambda a, axis=None, keepdims=False, ddof=0: torch.std(
    _float(a), dim=_axes(axis, _t(a).ndim), keepdim=keepdims, correction=ddof))
register_op("var", lambda a, axis=None, keepdims=False, ddof=0: torch.var(
    _float(a), dim=_axes(axis, _t(a).ndim), keepdim=keepdims, correction=ddof))
register_op("norm2", lambda a, axis=None, keepdims=False: torch.sqrt(
    torch.sum(_t(a) * _t(a), dim=_axes(axis, _t(a).ndim), keepdim=keepdims)))
register_op("argmax", lambda a, axis=-1: torch.argmax(_t(a), dim=axis))
register_op("argmin", lambda a, axis=-1: torch.argmin(_t(a), dim=axis))
register_op("cumsum", lambda a, axis=0: torch.cumsum(_t(a), dim=axis))
register_op("logsumexp", lambda a, axis=None, keepdims=False: torch.logsumexp(
    _float(a), dim=_axes(axis, _t(a).ndim), keepdim=keepdims))


# ---- linalg / shape ----
def _matmul(a, b):
    a, b = _pair(a, b)
    return torch.matmul(a, b)


def _slice(a, begin, size):
    """lax.dynamic_slice: each start clamped so the window fits."""
    for d, (b0, s) in enumerate(zip(begin, size)):
        s = int(s)
        b0 = min(max(int(b0), 0), a.shape[d] - s)
        a = a.narrow(d, b0, s)
    return a


def _gather(a, idx, axis=0):
    """jnp.take: a negative index counts from the end."""
    axis = axis % a.ndim
    idx = _t(idx).to(torch.int64)
    idx = torch.where(idx < 0, idx + a.shape[axis], idx)
    out = a.index_select(axis, idx.reshape(-1))
    return out.reshape(a.shape[:axis] + idx.shape + a.shape[axis + 1:])


def _pad(a, paddings, value=0.0):
    flat = []
    for lo, hi in reversed([tuple(p) for p in paddings]):
        flat += [int(lo), int(hi)]
    return F.pad(a, flat, value=value)


register_op("matmul", _matmul)
register_op("mmul", _matmul)
register_op("tensordot", lambda a, b, axes=2: torch.tensordot(*_pair(a, b), dims=axes))
register_op("transpose", lambda a, perm=None: a.permute(
    tuple(range(a.ndim))[::-1] if perm is None else tuple(perm)))
register_op("reshape", lambda a, shape: torch.reshape(_t(a), tuple(int(s) for s in shape)))
register_op("permute", lambda a, perm: a.permute(tuple(perm)))
register_op("expand_dims", lambda a, axis=0: torch.unsqueeze(
    _t(a), axis if axis >= 0 else axis + _t(a).ndim + 1))
register_op("squeeze", lambda a, axis=None: torch.squeeze(a) if axis is None
            else torch.squeeze(a, tuple(axis) if isinstance(axis, (list, tuple)) else axis))
register_op("concat", lambda *xs, axis=0: torch.cat(_promote_all(xs), dim=axis))
register_op("stack", lambda *xs, axis=0: torch.stack(_promote_all(xs), dim=axis))
register_op("unstack_at", lambda a, index=0, axis=0: a.select(axis, index))
register_op("tile", lambda a, reps: _t(a).tile(tuple(reps)))
register_op("slice", _slice)
register_op("strided_slice", lambda a, begin, end, strides=None: _index(
    a, [slice(b, e, s) for b, e, s in zip(begin, end, strides or [1] * len(begin))]))
register_op("gather", _gather)
register_op("one_hot", lambda idx, depth, dtype="float32": (
    _t(idx)[..., None] == torch.arange(int(depth), device=_t(idx).device)
).to(torch_dtype(dtype)))
register_op("cast", lambda a, dtype: _t(a).to(torch_dtype(dtype)))
register_op("shape_of", lambda a: torch.tensor(list(a.shape), dtype=torch.int32,
                                               device=a.device))
register_op("zeros_like", lambda a: torch.zeros_like(_t(a)))
register_op("zeros_rows_like", lambda a, n: torch.zeros((a.shape[0], int(n)),
                                                        dtype=a.dtype, device=a.device))
register_op("ones_like", lambda a: torch.ones_like(_t(a)))
register_op("pad", _pad)
register_op("identity", lambda a: a)


def _promote_all(xs):
    xs = [_t(x) for x in xs]
    dt = xs[0].dtype
    for x in xs[1:]:
        dt = torch.promote_types(dt, x.dtype)
    return [x.to(dt) for x in xs]


# ---- nn ----
def _softplus(a):
    a = _float(a)
    return torch.logaddexp(a, torch.zeros_like(a))


def _gelu(a, approximate=True):
    """jax.nn.gelu: the tanh approximation by default."""
    return F.gelu(_float(a), approximate="tanh" if approximate else "none")


register_op("relu", unary(torch.relu))
register_op("relu6", lambda a: (_relu6(_t(a)) if _t(a).is_floating_point() else
                               torch.minimum(torch.relu(_t(a)),
                                             as_tensor(6, _t(a).device, _t(a).dtype))))
register_op("leaky_relu", lambda a, alpha=0.01: torch.where(_t(a) >= 0, _t(a), alpha * _t(a)))
register_op("elu", lambda a: F.elu(_float(a)))
register_op("selu", lambda a: F.selu(_float(a)))
register_op("gelu", _gelu)
register_op("sigmoid", lambda a: torch.sigmoid(_float(a)))
register_op("softplus", _softplus)
register_op("softsign", lambda a: _float(a) / (1 + torch.abs(_float(a))))
register_op("swish", lambda a: F.silu(_float(a)))
register_op("hard_sigmoid", lambda a: F.relu6(_float(a) + 3.0) / 6.0)
register_op("softmax", lambda a, axis=-1: torch.softmax(_float(a), dim=axis))
register_op("log_softmax", lambda a, axis=-1: torch.log_softmax(_float(a), dim=axis))
register_op("erf", lambda a: torch.special.erf(_float(a)))


@register_op("linear")
def _linear(x, w, b=None):
    y = _matmul(x, w)
    return y if b is None else OP_TABLE["add"](y, b)


@register_op("layer_norm")
def _layer_norm(x, gain, bias=None, eps=1e-5, axis=-1):
    if axis in (-1, x.ndim - 1):
        from deeplearning4j_tpu_torch.ops.norm_kernels import fused_layer_norm
        return fused_layer_norm(x, gain, bias, eps)
    mean = torch.mean(x, dim=axis, keepdim=True)
    var = torch.var(x, dim=axis, keepdim=True, correction=0)
    y = (x - mean) / torch.sqrt(var + eps) * gain
    return y if bias is None else y + bias


@register_op("batch_norm")
def _batch_norm(x, mean, var, gamma=None, beta=None, eps=1e-5):
    y = (x - mean) / torch.sqrt(var + eps)
    if gamma is not None:
        y = y * gamma
    if beta is not None:
        y = y + beta
    return y


def keep_mask(rng: torch.Generator, p: float, x: torch.Tensor) -> torch.Tensor:
    """Dropout's keep mask: each element kept with probability `p`, drawn
    from the graph's generator."""
    u = torch.rand(x.shape, generator=rng, device=x.device, dtype=torch.float32)
    return u < p


@register_op("dropout")
def _dropout(x, rng=None, p=0.5):
    """p = RETAIN probability (reference semantics).  Identity when no
    generator is fed (inference)."""
    if rng is None:
        return x
    keep = keep_mask(rng, p, x)
    return torch.where(keep, x / p, torch.zeros((), dtype=x.dtype, device=x.device))


@register_op("embedding_lookup")
def _embedding_lookup(table, idx):
    return table[_t(idx).to(torch.int64)]


# ---- cnn (NHWC / HWIO) ----
def _conv_pads(padding, H, W, kh, kw, stride, dilation):
    from deeplearning4j_tpu_torch.ops.pool_kernels import resolve_pad
    ekh = (kh - 1) * dilation[0] + 1
    ekw = (kw - 1) * dilation[1] + 1
    return resolve_pad(padding, H, W, (ekh, ekw), stride)


def _conv_nhwc(x, w_oihw, stride, padding, dilation, groups=1):
    from deeplearning4j_tpu_torch.ops.pool_kernels import pad_nchw
    xc = x.permute(0, 3, 1, 2)
    pads = _conv_pads(padding, xc.shape[2], xc.shape[3], w_oihw.shape[2],
                      w_oihw.shape[3], tuple(stride), tuple(dilation))
    y = F.conv2d(pad_nchw(xc, pads, 0.0), w_oihw, None, tuple(stride), 0,
                 tuple(dilation), groups)
    return y.permute(0, 2, 3, 1)


@register_op("conv2d")
def _conv2d(x, w, b=None, stride=(1, 1), padding="SAME", dilation=(1, 1)):
    from deeplearning4j_tpu_torch.ops.conv_kernels import conv3x3_eligible, conv3x3_same
    w_oihw = w.permute(3, 2, 0, 1)
    if conv3x3_eligible(x.shape, w_oihw.shape, b, stride, padding, dilation):
        return conv3x3_same(x, w_oihw)
    y = _conv_nhwc(x, w_oihw, stride, padding, dilation)
    return y if b is None else y + b


@register_op("depthwise_conv2d")
def _depthwise_conv2d(x, w, stride=(1, 1), padding="SAME", dilation=(1, 1)):
    """NHWC x, HWIO w [H, W, 1, C*mult] grouped per input channel."""
    return _conv_nhwc(x, w.permute(3, 2, 0, 1), stride, padding, dilation,
                      groups=x.shape[-1])


@register_op("max_pooling2d")
def _max_pool(x, kernel=(2, 2), stride=(2, 2), padding="VALID"):
    from deeplearning4j_tpu_torch.ops.pool_kernels import max_pool2d
    return max_pool2d(x, tuple(kernel), tuple(stride), padding)


@register_op("avg_pooling2d")
def _avg_pool(x, kernel=(2, 2), stride=(2, 2), padding="VALID"):
    """Window sums over the zero-padded input, over the count of the
    window's elements inside the input (lax.reduce_window twice)."""
    from deeplearning4j_tpu_torch.ops.pool_kernels import pad_nchw, resolve_pad
    xc = x.permute(0, 3, 1, 2)
    pads = resolve_pad(padding, xc.shape[2], xc.shape[3], tuple(kernel), tuple(stride))
    s = F.avg_pool2d(pad_nchw(xc, pads, 0.0), tuple(kernel), tuple(stride),
                     divisor_override=1)
    ones = torch.ones_like(xc[:1, :1])
    c = F.avg_pool2d(pad_nchw(ones, pads, 0.0), tuple(kernel), tuple(stride),
                     divisor_override=1)
    return (s / c).permute(0, 2, 3, 1)


# ---- attention ----
@register_op("dot_product_attention")
def _dpa(q, k, v, mask=None, scaled=True):
    """[B, T, H] single-head (reference ``dotProductAttention``)."""
    scores = q @ k.transpose(-1, -2)
    if scaled:
        scores = scores / torch.sqrt(torch.tensor(q.shape[-1], dtype=q.dtype,
                                                  device=q.device))
    if mask is not None:
        scores = torch.where(mask[..., None, :] > 0, scores,
                             torch.full((), -1e9, dtype=scores.dtype, device=scores.device))
    return torch.softmax(scores, dim=-1) @ v


@register_op("multi_head_dot_product_attention")
def _mhdpa(q, k, v, wq, wk, wv, wo, mask=None, scaled=True):
    """Reference ``multi_head_dot_product_attention``: project [B, T, F]
    inputs per head (wq [H, dh, F]), the fused attention, re-project."""
    from deeplearning4j_tpu_torch.ops.attention_kernels import fused_attention

    def proj(x, w):                          # [B,T,F] x [H,dh,F]
        return torch.einsum("btf,hdf->bhtd", x, w)
    qh, kh, vh = proj(q, wq), proj(k, wk), proj(v, wv)
    scale = None if scaled else 1.0
    ctx = fused_attention(qh, kh, vh, mask=mask, scale=scale)  # [B,H,T,dv]
    return torch.einsum("bhtd,ohd->bto", ctx, wo)


# ---- losses (label-first signature, reference SDLoss convention) ----
@register_op("softmax_cross_entropy")
def _sce(labels, logits, axis=-1):
    return torch.mean(-torch.sum(labels * torch.log_softmax(logits, dim=axis), dim=axis))


@register_op("sparse_softmax_cross_entropy")
def _ssce(labels, logits):
    """The mean over every position of -log p[label]."""
    lp = torch.log_softmax(logits, dim=-1)
    picked = torch.gather(lp, -1, _t(labels).to(torch.int64)[..., None])[..., 0]
    return -torch.mean(picked)


@register_op("sigmoid_cross_entropy")
def _sigce(labels, logits):
    """max(x, 0) and |x| with jnp's gradients at 0 (a tie split in half,
    and 1)."""
    return torch.mean(torch.maximum(logits, torch.zeros_like(logits)) - logits * labels
                      + torch.log1p(torch.exp(-torch.where(logits >= 0, logits, -logits))))


register_op("mean_squared_error", lambda labels, preds: torch.mean((labels - preds) ** 2))
register_op("absolute_difference", lambda labels, preds: torch.mean(
    torch.where(labels - preds >= 0, labels - preds, preds - labels)))
register_op("l2_loss", lambda a: 0.5 * torch.sum(a * a))


@register_op("huber_loss")
def _huber(labels, preds, delta=1.0):
    err = torch.abs(labels - preds)
    quad = torch.minimum(err, as_tensor(delta, err.device, err.dtype))
    return torch.mean(0.5 * quad * quad + delta * (err - quad))


@register_op("log_loss")
def _log_loss(labels, probs, eps=1e-7):
    p = _clip(probs, eps, 1 - eps)
    return -torch.mean(labels * torch.log(p) + (1 - labels) * torch.log1p(-p))


@register_op("cosine_distance")
def _cos_dist(labels, preds, axis=-1, eps=1e-8):
    def unit(a):
        n = torch.linalg.vector_norm(a, dim=axis, keepdim=True)
        return a / torch.maximum(n, as_tensor(eps, n.device, n.dtype))
    return torch.mean(1.0 - torch.sum(unit(labels) * unit(preds), dim=axis))


# ---- control-flow support ----
# multi-output nodes (cond, while_loop, scan, splits) hold a tuple;
# tuple_get projects one element out
register_op("tuple_get", lambda t, index: t[index])

# ONNX-layout op that the TF importer's SplitV uses
register_op("split_axis", lambda x, sizes, axis=0: tuple(
    torch.split(x, [int(s) for s in sizes], dim=axis)))


# ---- ONNX-layout ops (NCHW / OIHW; modelimport.onnx_import) ----
def _pads_lrtb(pads):
    """ONNX pads (top, left, bottom, right) as F.pad's (left, right, top,
    bottom)."""
    return (int(pads[1]), int(pads[3]), int(pads[0]), int(pads[2]))


def _bias_nchw(y, b):
    return y if b is None else y + b.reshape(1, -1, 1, 1)


@register_op("conv2d_nchw")
def _conv2d_nchw(x, w, b=None, stride=(1, 1), pads=(0, 0, 0, 0),
                 dilation=(1, 1), groups=1):
    """lax.conv_general_dilated over NCHW x and OIHW w, zero pads (t, l, b,
    r) as given (uneven included)."""
    y = F.conv2d(F.pad(x, _pads_lrtb(pads)), w, None, tuple(stride), 0,
                 tuple(dilation), int(groups))
    return _bias_nchw(y, b)


@register_op("max_pool2d_nchw")
def _max_pool2d_nchw(x, kernel=(2, 2), stride=(2, 2), pads=(0, 0, 0, 0)):
    """lax.reduce_window max over -inf pads (the integer minimum for
    integers).  The gradient goes to the first maximum of each window in
    row-major order, as JAX's select-and-scatter sends it."""
    kernel, stride = tuple(kernel), tuple(stride)
    if x.is_floating_point():
        return F.max_pool2d(F.pad(x, _pads_lrtb(pads), value=float("-inf")),
                            kernel, stride)
    xp = F.pad(x, _pads_lrtb(pads), value=int(torch.iinfo(x.dtype).min))
    return xp.unfold(2, kernel[0], stride[0]).unfold(3, kernel[1], stride[1]).amax((-2, -1))


@register_op("avg_pool2d_nchw")
def _avg_pool2d_nchw(x, kernel=(2, 2), stride=(2, 2), pads=(0, 0, 0, 0),
                     count_include_pad=False):
    """Window sums over zero pads, over the window's size (padding counted,
    or no pads) or over the count of its elements inside the input."""
    kernel, stride, lrtb = tuple(kernel), tuple(stride), _pads_lrtb(pads)
    s = F.avg_pool2d(F.pad(x, lrtb), kernel, stride, divisor_override=1)
    if count_include_pad or not any(pads):
        return s / (kernel[0] * kernel[1])
    ones = torch.ones_like(x[:1, :1])
    return s / F.avg_pool2d(F.pad(ones, lrtb), kernel, stride, divisor_override=1)


register_op("global_avg_pool_nchw", lambda x: torch.mean(x, dim=(2, 3), keepdim=True))


@register_op("reshape_onnx")
def _reshape_onnx(x, shape):
    """ONNX Reshape: 0 copies the input's dim at that position, -1 is
    inferred."""
    return torch.reshape(x, [x.shape[i] if int(s) == 0 else int(s)
                             for i, s in enumerate(shape)])


@register_op("flatten2d")
def _flatten2d(x, axis=1):
    lead = 1
    for d in x.shape[:axis]:
        lead *= d
    return torch.reshape(x, (lead, -1))


def _reverse_axes(a):
    return a.permute(tuple(range(a.ndim))[::-1])


@register_op("gemm")
def _gemm(a, b, c=None, alpha=1.0, beta=1.0, trans_a=0, trans_b=0):
    """alpha * (op(a) @ op(b)) + beta * c, op a transpose where asked."""
    a = _reverse_axes(a) if trans_a else a
    b = _reverse_axes(b) if trans_b else b
    out = OP_TABLE["mul"](alpha, _matmul(a, b))
    return out if c is None else OP_TABLE["add"](out, OP_TABLE["mul"](beta, c))


@register_op("batch_norm_nchw")
def _batch_norm_nchw(x, scale, b, mean, var, eps=1e-5):
    """Inference-form batch norm over axis 1 from the running statistics."""
    shp = (1, -1) + (1,) * (x.ndim - 2)
    inv = scale.reshape(shp) * torch.rsqrt(var.reshape(shp) + eps)
    return (x - mean.reshape(shp)) * inv + b.reshape(shp)


@register_op("deconv2d_nchw")
def _deconv2d_nchw(x, w, b=None, stride=(1, 1), pads=(0, 0, 0, 0),
                   dilation=(1, 1), output_padding=(0, 0), groups=1):
    """ONNX ConvTranspose: x [B, Ci, H, W], w [Ci, Co, kh, kw] (IOHW), the
    gradient form.  The full transposed convolution, then ONNX's pads (t,
    l, b, r) cut from its borders and ``output_padding`` added as zeros
    after its trailing edges."""
    if groups != 1:
        raise NotImplementedError(
            "deconv2d_nchw: grouped ConvTranspose is not supported — "
            "export with group=1")
    y = F.conv_transpose2d(x, w, None, tuple(stride), 0, 0, 1, tuple(dilation))
    t, l, bt, r = (int(p) for p in pads)
    y = F.pad(y, (-l, -r + int(output_padding[1]), -t, -bt + int(output_padding[0])))
    return _bias_nchw(y, b)


@register_op("slice_onnx")
def _slice_onnx(x, starts, ends, axes=None, steps=None):
    """ONNX Slice: starts and ends clamped to the dims (INT64 sentinels
    included), any step, negative ones too."""
    axes = list(range(len(starts))) if axes is None else [int(a) % x.ndim for a in axes]
    steps = [1] * len(starts) if steps is None else [int(s) for s in steps]
    idx = [slice(None)] * x.ndim
    for st, en, ax, sp in zip(starts, ends, axes, steps):
        st, en = int(st), int(en)
        dim = x.shape[ax]
        st = max(st + dim, 0) if st < 0 else min(st, dim)
        if en < 0:
            en = max(en + dim, -1 if sp < 0 else 0)
        else:
            en = min(en, dim)
        idx[ax] = slice(st, en if en != -1 else None, sp)
    return _index(x, idx)


# ---- TF-import support ops (modelimport.tf_import; BERT-class graphs) ----
register_op("swap_last2", lambda a: a.transpose(-1, -2))
register_op("split_equal", lambda a, num, axis=0: tuple(
    torch.split(a, a.shape[axis] // int(num), dim=axis)))


@register_op("tf_strided_slice")
def _tf_strided_slice_op(x, begin, end, strides, begin_mask=0, end_mask=0,
                         ellipsis_mask=0, new_axis_mask=0, shrink_axis_mask=0):
    """TF StridedSlice semantics (masks are bitfields over spec positions)."""
    idx = []
    for i in range(len(begin)):
        if (ellipsis_mask >> i) & 1:
            idx.append(Ellipsis)
        elif (new_axis_mask >> i) & 1:
            idx.append(None)
        elif (shrink_axis_mask >> i) & 1:
            idx.append(int(begin[i]))
        else:
            b = None if (begin_mask >> i) & 1 else int(begin[i])
            e = None if (end_mask >> i) & 1 else int(end[i])
            idx.append(slice(b, e, int(strides[i])))
    return _index(x, idx)


register_op("floor_div", _jax_floor_div)     # int-preserving (TF FloorDiv)


# ---- further ops the namespaces and the TF mappers emit ----
register_op("expm1", lambda a: torch.expm1(_float(a)))
register_op("rsqrt", lambda a: torch.rsqrt(_float(a)))
register_op("mod", _jax_mod)
register_op("fmod", binary(torch.fmod))       # the dividend's sign, as jnp.fmod
register_op("tril", lambda a, k=0: torch.tril(_t(a), int(k)))
register_op("triu", lambda a, k=0: torch.triu(_t(a), int(k)))
register_op("atan2", binary(torch.atan2))
register_op("rint", unary(torch.round))


@register_op("top_k")
def _top_k(a, k=1):
    """lax.top_k: the k largest along the last axis, descending, ties to
    the lower index, +0.0 above -0.0; int32 indices.  A first stable sort
    puts every -0.0 after the rest, so the stable descending sort, which
    ranks the two zeros equal, keeps +0.0 first."""
    a = _t(a)
    first = None
    if a.is_floating_point():
        neg_zero = (a == 0) & torch.signbit(a)
        first = torch.sort(neg_zero.to(torch.int8), dim=-1, stable=True)[1]
        a = torch.gather(a, -1, first)
    vals, idx = torch.sort(a, dim=-1, descending=True, stable=True)
    if first is not None:
        idx = torch.gather(first, -1, idx)
    return vals[..., :k], idx[..., :k].to(torch.int32)


register_op("gather_nd", lambda a, idx: a[tuple(_t(idx).to(torch.int64).movedim(-1, 0))])


def _resize_weights(n_in: int, n_out: int, antialias: bool = True) -> np.ndarray:
    """jax.image's bilinear (triangle kernel) weight matrix [n_in, n_out]
    at half-pixel centres, widened for downsampling (antialias)."""
    scale = n_out / n_in
    inv = 1.0 / scale
    kscale = max(inv, 1.0) if antialias else 1.0
    sample = (np.arange(n_out) + 0.5) * inv - 0.5
    x = np.abs(sample[None, :] - np.arange(n_in, dtype=np.float64)[:, None]) / kscale
    w = np.maximum(0.0, 1.0 - x)
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, 1), 0)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return np.where(inside[None, :], w, 0)


@register_op("resize_bilinear")
def _resize_bilinear(a, size):
    """jax.image.resize(..., "bilinear") of NHWC `a` to `size` (H, W)."""
    out = a
    for d, n in zip((1, 2), size):
        n_in = out.shape[d]
        if n_in == int(n):
            continue
        w = torch.as_tensor(_resize_weights(n_in, int(n)), dtype=a.dtype, device=a.device)
        out = torch.movedim(torch.tensordot(out, w, dims=([d], [0])), -1, d)
    return out


@register_op("resize_nearest")
def _resize_nearest(a, size):
    """jax.image.resize(..., "nearest"): source index floor((i + 0.5) * m / n)."""
    for d, n in zip((1, 2), size):
        m = a.shape[d]
        if m == int(n):
            continue
        off = np.floor((np.arange(int(n), dtype=np.float32) + 0.5)
                       * np.float32(m) / np.float32(int(n))).astype(np.int64)
        a = a.index_select(d, torch.as_tensor(off, device=a.device))
    return a


@register_op("mirror_pad")
def _mirror_pad(a, paddings, mode="REFLECT"):
    kind = "reflect" if mode.upper() == "REFLECT" else "symmetric"
    for d, (lo, hi) in enumerate(paddings):
        if lo or hi:
            idx = np.pad(np.arange(a.shape[d]), (int(lo), int(hi)), mode=kind)
            a = a.index_select(d, torch.as_tensor(idx, device=a.device))
    return a


@register_op("cumsum_ext")
def _cumsum_ext(a, axis=0, exclusive=False, reverse=False):
    """TF-style cumsum with its exclusive and reverse attrs."""
    if reverse:
        a = torch.flip(a, dims=(axis,))
    out = torch.cumsum(a, dim=axis)
    if exclusive:
        out = out - a
    if reverse:
        out = torch.flip(out, dims=(axis,))
    return out


@register_op("lstm_layer")
def _lstm_layer_ifog(x, w, rw, b):
    """Whole-sequence LSTM, IFOG gate order, [B, T, F] in, [B, T, H] out
    (the ``sd.rnn.lstm_layer`` contract): a loop over T."""
    H = rw.shape[0]
    h = torch.zeros((x.shape[0], H), dtype=x.dtype, device=x.device)
    c = h
    hs = []
    for t in range(x.shape[1]):
        z = x[:, t] @ w + h @ rw + b
        i, f, o = (torch.sigmoid(z[:, :H]), torch.sigmoid(z[:, H:2 * H]),
                   torch.sigmoid(z[:, 2 * H:3 * H]))
        g = torch.tanh(z[:, 3 * H:])
        c = f * c + i * g
        h = o * torch.tanh(c)
        hs.append(h)
    return torch.stack(hs, dim=1)


def _einsum(*args, equation=None):
    """Equation as the first positional or as the `equation` attr."""
    if equation is None:
        equation, args = args[0], args[1:]
    return torch.einsum(equation, *_promote_all(args))


register_op("einsum", _einsum)
register_op("unstack", lambda a, axis=0: tuple(torch.unbind(a, dim=axis)))
register_op("reverse", lambda x, axes: torch.flip(
    x, dims=tuple(axes) if isinstance(axes, (list, tuple)) else (int(axes),)))

# gradient compression: the encode_threshold / decode_threshold declarable
# ops, on the host codec's wire format (int32 sign-in-index codes +-(i + 1),
# 0 as padding); the residual carry is native_ops.ThresholdCodec's, not theirs


@register_op("encode_threshold")
def _encode_threshold(grad, threshold=1e-3, max_elements=None):
    """The flattened gradient's first `max_elements` entries (in index
    order) with |g| >= threshold as +-(i + 1), padded with 0."""
    v = _t(grad).reshape(-1)
    n = v.shape[0]
    cap = n if max_elements is None else min(int(max_elements), n)
    idx = torch.nonzero(torch.ge(*_pair(torch.abs(v), threshold))).reshape(-1)[:cap]
    out = torch.zeros(cap, dtype=torch.int32, device=v.device)
    out[:idx.numel()] = torch.sign(v[idx]).to(torch.int32) * (idx.to(torch.int32) + 1)
    return out


@register_op("decode_threshold")
def _decode_threshold(encoded, size, threshold=1e-3):
    """The inverse: +-threshold added at |code| - 1; 0 codes are padding."""
    e = _t(encoded).to(torch.int32)
    idx = torch.clamp(torch.abs(e) - 1, 0, size - 1).to(torch.int64)
    val = torch.mul(*_pair(torch.sign(e).to(torch.float32), threshold))
    return torch.zeros(size, dtype=torch.float32, device=e.device).index_add_(0, idx, val)


# dropout's generator: the graph feeds one generator a step; a missing one
# (inference) stays missing, which makes dropout the identity
register_op("rng_fold_opt", lambda rng, tag=0: rng)


# ---- further ops the ONNX mappers emit ----
def _nd_index(idx):
    """ScatterND's index tensor [..., k] as k index tensors."""
    return tuple(_t(idx).to(torch.int64).movedim(-1, 0))


register_op("scatter_nd_add", lambda a, idx, updates: _t(a).index_put(
    _nd_index(idx), _t(updates).to(_t(a).dtype), accumulate=True))
register_op("scatter_nd_update", lambda a, idx, updates: _t(a).index_put(
    _nd_index(idx), _t(updates).to(_t(a).dtype)))
register_op("broadcast_to", lambda a, shape: _t(a).broadcast_to(tuple(int(s) for s in shape)))
register_op("prelu", lambda x, alpha: torch.where(_t(x) >= 0, *_pair(x, OP_TABLE["mul"](alpha, x))))
# x * relu6(x + 3) / 6 with relu6's gradient 0 at 0 and 6, as jax.nn.hard_swish
register_op("hard_swish", lambda a: _float(a) * _relu6(_float(a) + 3.0) / 6.0)
# jnp.clip: a maximum then a minimum, each tie's gradient split in half
register_op("clip_by_value", lambda a, lo, hi: OP_TABLE["minimum"](OP_TABLE["maximum"](a, lo), hi))


@register_op("pad_mode")
def _pad_mode(a, paddings, mode="constant", value=0.0):
    """jnp.pad in its constant, reflect, symmetric and edge modes (numpy's
    index rules, gathered dim by dim; the gradient sums the copies)."""
    if mode == "constant":
        return _pad(a, paddings, value)
    for d, (lo, hi) in enumerate(paddings):
        if lo or hi:
            idx = np.pad(np.arange(a.shape[d]), (int(lo), int(hi)), mode=mode)
            a = a.index_select(d, torch.as_tensor(idx, device=a.device))
    return a


def _bias(b):
    return 0 if b is None else b


def _gru_cell(x, h, w_ih, w_hh, b_ih=None, b_hh=None):
    """One GRU step, gates [reset, update, new]."""
    gi = x @ w_ih + _bias(b_ih)
    gh = h @ w_hh + _bias(b_hh)
    H = h.shape[-1]
    r = torch.sigmoid(gi[..., :H] + gh[..., :H])
    z = torch.sigmoid(gi[..., H:2 * H] + gh[..., H:2 * H])
    n = torch.tanh(gi[..., 2 * H:] + r * gh[..., 2 * H:])
    return (1 - z) * n + z * h


@register_op("gru_layer")
def _gru_layer(x, h0, w_ih, w_hh, b_ih=None, b_hh=None):
    """[B, T, F] -> [B, T, H]: the GRU step over T."""
    h, ys = h0, []
    for t in range(x.shape[1]):
        h = _gru_cell(x[:, t], h, w_ih, w_hh, b_ih, b_hh)
        ys.append(h)
    return torch.stack(ys, dim=1)


@register_op("lstm_layer_full")
def _lstm_layer_full(x, w_ih, w_hh, b=None, h0=None, c0=None):
    """The reference lstmLayer's full output, gates IFCO: (the h sequence
    [B, T, H], the last h, the last c)."""
    H = w_hh.shape[0]
    zeros = torch.zeros((x.shape[0], H), dtype=x.dtype, device=x.device)
    h = zeros if h0 is None else h0
    c = zeros if c0 is None else c0
    ys = []
    for t in range(x.shape[1]):
        g = x[:, t] @ w_ih + h @ w_hh + _bias(b)
        i, f = torch.sigmoid(g[..., :H]), torch.sigmoid(g[..., H:2 * H])
        cc, o = torch.tanh(g[..., 2 * H:3 * H]), torch.sigmoid(g[..., 3 * H:])
        c = f * c + i * cc
        h = o * torch.tanh(c)
        ys.append(h)
    return torch.stack(ys, dim=1), h, c

del _n
