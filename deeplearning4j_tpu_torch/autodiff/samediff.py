"""SameDiff: declare a graph, run it, train it (the port of
``autodiff/samediff.py``).

A graph is a dict of named :class:`Node`s (placeholders, trainable
variables, constants and ops over ``autodiff/ops.py``'s table).  The JAX
package traces the graph into one function and compiles it; the port walks
it eagerly (an iterative post-order walk, no recursion: an imported BERT
has ~1,000 nodes), and autograd gives the gradients.  On the card,
``fit_steps`` captures k training steps into one CUDA graph and replays it
once a block (``utils/scan_fit.py``'s :class:`GraphStep`), as the port's
networks do; ``fit(iterator=..., fused_steps=k)`` feeds it.

Control flow keeps the JAX package's structured form: ``cond``,
``while_loop`` and ``scan`` trace their bodies into child graphs
(:class:`_SubGraph`) stored as JSON attributes, so they save and load.
The port runs one branch of a ``cond`` and steps a ``while_loop`` on the
host (each reads its predicate back), so a graph with either cannot be
captured by ``fit_steps``; ``scan`` is a loop over the leading axis.

Typing follows JAX: a constant made from a Python scalar stays that scalar
and is weakly typed (``x * 2.0`` keeps x's dtype); a loaded constant is an
array, as it is in the JAX package after ``load``.

Under ZeRO-1 (``parallel.zero.enable_zero1(sd, mesh)``) the step runs the
JAX package's transform: every rank computes the loss and gradients of
the same whole batch, keeps its rows of each sharded variable's gradient,
runs the updater on its shard of the variables and moments, and the new
shards are all-gathered into the variables (``fit_steps`` captures the
collectives with the step on the card); ``save`` writes the moments
gathered whole, so every rank of the mesh calls it.

The zip is the JAX package's: ``graph.json`` (format
``deeplearning4j_tpu.samediff.v1``), ``variables.npz``, ``constants.npz``
and ``updater.npz`` (the updater state's leaves in sorted-key tree order),
so a graph saved by either package loads in the other.
"""
from __future__ import annotations

import dataclasses
import io
import json
import zipfile
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from deeplearning4j_tpu_torch.autodiff.ops import (DTYPE_NAMES, OP_TABLE, as_tensor,
                                                   is_weak, torch_dtype)
from deeplearning4j_tpu_torch.ops.initializers import init_weights
from deeplearning4j_tpu_torch.train.updaters import (Adam, IUpdater, StepScalars,
                                                     scalar_dtype, tree_leaves)
from deeplearning4j_tpu_torch.utils.counters import advance, device_counters
from deeplearning4j_tpu_torch.utils.devices import resolve_device

FORMAT = "deeplearning4j_tpu.samediff.v1"


class NotPortedError(NotImplementedError):
    """An op of the JAX package's table that the port has not ported yet."""


# ---------------------------------------------------------------------------
# Graph nodes
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Node:
    name: str
    kind: str                   # placeholder | variable | constant | op
    op: Optional[str] = None
    inputs: Tuple[str, ...] = ()
    attrs: Dict[str, Any] = dataclasses.field(default_factory=dict)
    shape: Optional[Tuple[int, ...]] = None
    dtype: str = "float32"


class SDVariable:
    """Symbolic handle into a SameDiff graph (reference `SDVariable`)."""

    def __init__(self, sd: "SameDiff", name: str):
        self.sd = sd
        self.name = name

    # -- operator sugar (reference SDVariable.add/mul/mmul/...) --
    def _coerce(self, other) -> "SDVariable":
        return other if isinstance(other, SDVariable) \
            else self.sd.constant(None, other)

    def __add__(self, o): return self.sd.op("add", self, self._coerce(o))
    def __radd__(self, o): return self.sd.op("add", self._coerce(o), self)
    def __sub__(self, o): return self.sd.op("sub", self, self._coerce(o))
    def __rsub__(self, o): return self.sd.op("sub", self._coerce(o), self)
    def __mul__(self, o): return self.sd.op("mul", self, self._coerce(o))
    def __rmul__(self, o): return self.sd.op("mul", self._coerce(o), self)
    def __truediv__(self, o): return self.sd.op("div", self, self._coerce(o))
    def __rtruediv__(self, o): return self.sd.op("div", self._coerce(o), self)
    def __pow__(self, o): return self.sd.op("pow", self, self._coerce(o))
    def __neg__(self): return self.sd.op("neg", self)
    def __matmul__(self, o): return self.sd.op("matmul", self, self._coerce(o))

    def mmul(self, o): return self.sd.op("matmul", self, self._coerce(o))
    def add(self, o): return self.__add__(o)
    def sub(self, o): return self.__sub__(o)
    def mul(self, o): return self.__mul__(o)
    def reshape(self, *shape): return self.sd.op("reshape", self, shape=list(shape))

    def transpose(self, *perm):
        return self.sd.op("transpose", self, perm=list(perm) or None)

    def sum(self, axis=None, keepdims=False):
        return self.sd.op("sum", self, axis=axis, keepdims=keepdims)

    def mean(self, axis=None, keepdims=False):
        return self.sd.op("mean", self, axis=axis, keepdims=keepdims)

    def max(self, axis=None, keepdims=False):
        return self.sd.op("max", self, axis=axis, keepdims=keepdims)

    def min(self, axis=None, keepdims=False):
        return self.sd.op("min", self, axis=axis, keepdims=keepdims)

    def std(self, axis=None, keepdims=False):
        return self.sd.op("std", self, axis=axis, keepdims=keepdims)

    def argmax(self, axis=-1): return self.sd.op("argmax", self, axis=axis)

    def rename(self, name: str) -> "SDVariable":
        return self.sd.rename(self.name, name)

    def eval(self, feeds: Optional[Dict[str, Any]] = None):
        return self.sd.output(feeds or {}, self.name)[self.name]

    def get_arr(self):
        """Current value of a variable or constant (reference
        `SDVariable.getArr`)."""
        node = self.sd._nodes[self.name]
        if node.kind == "variable":
            return self.sd.variables_[self.name]
        if node.kind == "constant":
            return self.sd._constants[self.name]
        raise ValueError(f"{self.name} has no stored array (kind={node.kind})")

    def __repr__(self):
        return f"SDVariable({self.name!r})"


# ---------------------------------------------------------------------------
# Op namespaces (reference codegen'd SDMath / SDNN / SDCNN / SDRNN / SDLoss)
# ---------------------------------------------------------------------------

def _not_ported(namespace: str, op: str) -> NotPortedError:
    return NotPortedError(
        f"{namespace}.{op}: op '{op}' is not ported yet (its family waits "
        "for a later slice; ROADMAP.md A4)")


class _Namespace:
    def __init__(self, sd: "SameDiff"):
        self._sd = sd


class SDMath(_Namespace):
    def __getattr__(self, op):
        if op.startswith("_"):
            raise AttributeError(op)
        if op not in OP_TABLE:
            raise AttributeError(
                f"No op '{op}' registered (reference: unmapped op error in "
                "ImportGraph — add via autodiff.ops.register_op)")

        def call(*args, name=None, **attrs):
            return self._sd.op(op, *args, name=name, **attrs)
        return call


class SDNN(_Namespace):
    def relu(self, x, name=None): return self._sd.op("relu", x, name=name)
    def sigmoid(self, x, name=None): return self._sd.op("sigmoid", x, name=name)
    def tanh(self, x, name=None): return self._sd.op("tanh", x, name=name)
    def gelu(self, x, name=None): return self._sd.op("gelu", x, name=name)
    def elu(self, x, name=None): return self._sd.op("elu", x, name=name)

    def softmax(self, x, axis=-1, name=None):
        return self._sd.op("softmax", x, axis=axis, name=name)

    def log_softmax(self, x, axis=-1, name=None):
        return self._sd.op("log_softmax", x, axis=axis, name=name)

    def linear(self, x, w, b=None, name=None):
        args = (x, w) if b is None else (x, w, b)
        return self._sd.op("linear", *args, name=name)

    def layer_norm(self, x, gain, bias=None, eps=1e-5, name=None):
        args = (x, gain) if bias is None else (x, gain, bias)
        return self._sd.op("layer_norm", *args, eps=eps, name=name)

    def dropout(self, x, p=0.5, name=None):
        """Active only during fit(), which feeds the graph's generator."""
        site = self._sd.op("rng_fold_opt", self._sd._rng_var(),
                           tag=self._sd._next_rng_tag())
        return self._sd.op("dropout", x, site, p=p, name=name)

    def batch_norm(self, x, mean, var, gamma=None, beta=None, eps=1e-5,
                   name=None):
        args = [x, mean, var] + ([gamma] if gamma is not None else []) \
            + ([beta] if beta is not None else [])
        return self._sd.op("batch_norm", *args, eps=eps, name=name)

    def multi_head_dot_product_attention(self, q, k, v, mask=None, name=None):
        args = (q, k, v) if mask is None else (q, k, v, mask)
        return self._sd.op("dot_product_attention", *args, name=name)


class SDCNN(_Namespace):
    def conv2d(self, x, w, b=None, stride=(1, 1), padding="SAME",
               dilation=(1, 1), name=None):
        args = (x, w) if b is None else (x, w, b)
        return self._sd.op("conv2d", *args, stride=tuple(stride),
                           padding=padding, dilation=tuple(dilation), name=name)

    def max_pooling2d(self, x, kernel=(2, 2), stride=(2, 2), padding="VALID",
                      name=None):
        return self._sd.op("max_pooling2d", x, kernel=tuple(kernel),
                           stride=tuple(stride), padding=padding, name=name)

    def avg_pooling2d(self, x, kernel=(2, 2), stride=(2, 2), padding="VALID",
                      name=None):
        return self._sd.op("avg_pooling2d", x, kernel=tuple(kernel),
                           stride=tuple(stride), padding=padding, name=name)


class SDRNN(_Namespace):
    def lstm_layer(self, x, w, rw, b, name=None):
        """Whole-sequence LSTM, IFOG gate order, [B,T,F] in, [B,T,H] out."""
        return self._sd.op("lstm_layer", x, w, rw, b, name=name)


class _TableNamespace(_Namespace):
    """OP_TABLE delegation scoped by the JAX namespace's op list; an op of
    the list that the port's table lacks raises :class:`NotPortedError`."""

    OPS: tuple = ()

    def __getattr__(self, op):
        if op.startswith("_") or (self.OPS and op not in self.OPS):
            raise AttributeError(f"{type(self).__name__} has no op '{op}'")
        if op not in OP_TABLE:
            raise _not_ported(type(self).__name__, op)

        def call(*args, name=None, **attrs):
            return self._sd.op(op, *args, name=name, **attrs)
        return call


class SDBitwise(_TableNamespace):
    OPS = ("bitwise_and", "bitwise_or", "bitwise_xor", "bitwise_not",
           "shift_left", "shift_right", "cyclic_shift_left",
           "bits_hamming_distance", "toggle_bits")


class SDImage(_TableNamespace):
    OPS = ("rgb_to_hsv", "hsv_to_rgb", "rgb_to_yiq", "yiq_to_rgb",
           "rgb_to_yuv", "yuv_to_rgb", "rgb_to_grs", "adjust_hue",
           "adjust_saturation", "adjust_contrast", "crop_and_resize",
           "extract_image_patches", "non_max_suppression",
           "resize_bilinear", "resize_nearest", "image_resize")


class SDLinalg(_TableNamespace):
    OPS = ("cholesky", "solve", "triangular_solve", "matrix_inverse",
           "matrix_determinant", "log_matrix_determinant", "qr", "svd",
           "eig_sym", "lstsq", "lu", "pinv", "expm", "matrix_band_part",
           "matrix_diag", "matrix_diag_part", "matrix_set_diag", "mmul",
           "matmul", "tri", "tril", "triu", "cross", "diag", "diag_part",
           "trace", "einsum")


class SDRandom(_Namespace):
    """Reference `SDRandom`: the random family is not ported yet."""

    _OPS = ("random_uniform", "random_normal", "random_bernoulli",
            "random_exponential", "random_gamma", "random_poisson",
            "random_shuffle", "multinomial", "uniform", "normal", "bernoulli")

    def __getattr__(self, op):
        if op.startswith("_") or op not in self._OPS:
            raise AttributeError(f"SDRandom has no op '{op}'")
        raise _not_ported("SDRandom", op)


class SDLoss(_Namespace):
    def softmax_cross_entropy(self, labels, logits, name=None):
        return self._sd.op("softmax_cross_entropy", labels, logits, name=name)

    def sparse_softmax_cross_entropy(self, labels, logits, name=None):
        return self._sd.op("sparse_softmax_cross_entropy", labels, logits, name=name)

    def sigmoid_cross_entropy(self, labels, logits, name=None):
        return self._sd.op("sigmoid_cross_entropy", labels, logits, name=name)

    def mean_squared_error(self, labels, preds, name=None):
        return self._sd.op("mean_squared_error", labels, preds, name=name)

    def absolute_difference(self, labels, preds, name=None):
        return self._sd.op("absolute_difference", labels, preds, name=name)

    def l2_loss(self, x, name=None):
        return self._sd.op("l2_loss", x, name=name)

    def huber_loss(self, labels, preds, delta=1.0, name=None):
        return self._sd.op("huber_loss", labels, preds, delta=delta, name=name)

    def log_loss(self, labels, probs, name=None):
        return self._sd.op("log_loss", labels, probs, name=name)

    def cosine_distance(self, labels, preds, axis=-1, name=None):
        return self._sd.op("cosine_distance", labels, preds, axis=axis, name=name)


# ---------------------------------------------------------------------------
# TrainingConfig
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class TrainingConfig:
    """Reference `TrainingConfig`: updater + which placeholders receive
    features/labels + l1/l2."""

    updater: IUpdater = dataclasses.field(default_factory=lambda: Adam(1e-3))
    data_set_feature_mapping: Sequence[str] = ()
    data_set_label_mapping: Sequence[str] = ()
    l1: float = 0.0
    l2: float = 0.0

    def to_json(self) -> dict:
        return {"updater": self.updater.to_json(),
                "features": list(self.data_set_feature_mapping),
                "labels": list(self.data_set_label_mapping),
                "l1": self.l1, "l2": self.l2}

    @staticmethod
    def from_json(d: dict) -> "TrainingConfig":
        return TrainingConfig(updater=IUpdater.from_json(d["updater"]),
                              data_set_feature_mapping=d["features"],
                              data_set_label_mapping=d["labels"],
                              l1=d.get("l1", 0.0), l2=d.get("l2", 0.0))


# ---------------------------------------------------------------------------
# Control flow
# ---------------------------------------------------------------------------

_CONTROL_FLOW_OPS = ("cond", "while_loop", "scan")


class _SubGraph:
    """A traced sub-function: its own node set + constants, positional
    placeholder args, named outputs; serializes to plain JSON."""

    def __init__(self, sd: "SameDiff", arg_names: List[str], out_names: List[str]):
        self.sd = sd
        self.arg_names = arg_names
        self.out_names = out_names

    @staticmethod
    def trace(fn: Callable, n_args: int, device) -> "_SubGraph":
        child = SameDiff(device=device)
        phs = [child.placeholder(f"__arg{i}__") for i in range(n_args)]
        outs = fn(child, *phs)
        if isinstance(outs, SDVariable):
            outs = (outs,)
        out_names = []
        for o in outs:
            if not isinstance(o, SDVariable) or o.sd is not child:
                raise ValueError(
                    "control-flow body must return SDVariable(s) built in "
                    "the scope it was handed (fn(scope, *args) -> vars)")
            out_names.append(o.name)
        if child.variables_:
            raise ValueError(
                "control-flow bodies cannot declare trainable variables — "
                "declare them in the outer graph and pass as operands")
        return _SubGraph(child, [p.name for p in phs], out_names)

    def call(self, args: Sequence[Any], meta: bool = False) -> Tuple[Any, ...]:
        feeds = dict(zip(self.arg_names, args))
        outs = self.sd._eval_graph(feeds, {}, self.out_names, meta=meta)
        return tuple(outs[n] for n in self.out_names)

    def to_json(self) -> dict:
        consts = {}
        for k, v in self.sd._constants.items():
            a = _numpy(v)
            consts[k] = {"data": a.tolist(), "dtype": str(a.dtype),
                         "shape": list(a.shape)}
        return {"nodes": [dataclasses.asdict(n) for n in self.sd._nodes.values()],
                "constants": consts,
                "args": self.arg_names, "outputs": self.out_names}

    @staticmethod
    def from_json(d: dict, device) -> "_SubGraph":
        child = SameDiff(device=device)
        for nd in d["nodes"]:
            node = _node_from_json(nd)
            child._nodes[node.name] = node
        child._constants = {
            k: _to_device(np.array(v["data"], dtype=v["dtype"]).reshape(v["shape"]),
                          child.device)
            for k, v in d["constants"].items()}
        return _SubGraph(child, list(d["args"]), list(d["outputs"]))


def _dtype_of(x) -> torch.dtype:
    return x.dtype if isinstance(x, torch.Tensor) else as_tensor(x).dtype


def _pred(p) -> bool:
    """A control-flow predicate, read back to the host."""
    return bool(as_tensor(p).reshape(()).item())


class _ControlFlow:
    """Runs one control-flow node; its child graphs are parsed from their
    JSON once and kept until the graph changes."""

    def __init__(self, sd: "SameDiff"):
        self.sd = sd
        self.cache: Dict[Tuple[str, str], _SubGraph] = {}

    def graph(self, node: Node, attr: str) -> _SubGraph:
        key = (node.name, attr)
        g = self.cache.get(key)
        if g is None:
            g = self.cache[key] = _SubGraph.from_json(node.attrs[attr], self.sd.device)
        return g

    def __call__(self, node: Node, args: List[Any], meta: bool = False) -> Any:
        if node.op == "cond":
            return self._cond(node, args, meta)
        if node.op == "while_loop":
            return self._while(node, args, meta)
        return self._scan(node, args, meta)

    def _cond(self, node, args, meta):
        tg, fg = self.graph(node, "true_graph"), self.graph(node, "false_graph")
        operands = tuple(args[1:])
        if meta:
            # the branch taken is data-dependent: the true branch's shapes,
            # promoted with the false branch's dtypes
            taken, other = tg.call(operands, meta=True), fg.call(operands, meta=True)
        else:
            g, o = (tg, fg) if _pred(args[0]) else (fg, tg)
            taken = g.call(operands)
            other = _meta_outputs(o, operands)
        # the branches' outputs promote pairwise, as lax.cond requires
        # one type for both
        out = []
        for i, t in enumerate(taken):
            dt = _dtype_of(t)
            if other is not None:
                dt = torch.promote_types(dt, _dtype_of(other[i]))
            out.append(self.tensor(t).to(dt))
        return out[0] if len(out) == 1 else tuple(out)

    def tensor(self, x) -> torch.Tensor:
        return as_tensor(x, self.sd.device)

    def _while(self, node, args, meta):
        cg, bg = self.graph(node, "cond_graph"), self.graph(node, "body_graph")
        state = tuple(self.tensor(x) for x in args)
        if meta:
            return state[0] if len(state) == 1 else state
        dts = [x.dtype for x in state]          # the body keeps the state's types
        while _pred(cg.call(state)[0]):
            state = tuple(self.tensor(o).to(d) for o, d in zip(bg.call(state), dts))
        return state[0] if len(state) == 1 else tuple(state)

    def _scan(self, node, args, meta):
        bg = self.graph(node, "body_graph")
        n_carry = int(node.attrs["n_carry"])
        carry = tuple(self.tensor(a) for a in args[:n_carry])
        xs = self.tensor(args[n_carry])
        consts = tuple(args[n_carry + 1:])
        ys = []
        for t in range(xs.shape[0]):
            outs = bg.call(carry + (xs[t],) + consts, meta=meta)
            carry = tuple(self.tensor(o).to(c.dtype) for o, c in zip(outs[:n_carry], carry))
            ys.append([self.tensor(o) for o in outs[n_carry:]])
        stacked = tuple(torch.stack([y[i] for y in ys]) for i in range(len(ys[0])))
        return tuple(carry) + stacked


def _meta_outputs(g: _SubGraph, operands):
    """The outputs of `g` on meta tensors (shapes and dtypes only), or None
    where an op cannot run on meta tensors."""
    try:
        return g.call(tuple(_to_meta(x) for x in operands), meta=True)
    except Exception:
        return None


def _to_meta(x):
    if isinstance(x, torch.Tensor):
        return torch.empty(x.shape, dtype=x.dtype, device="meta")
    return x


def _to_device(a, device) -> torch.Tensor:
    """A copy of `a` on `device` (never a view of the caller's memory: the
    training step writes variables in place)."""
    return torch.from_numpy(np.array(a)).to(device)


def _numpy(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        t = v.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.numpy()
    return np.asarray(v)


def _node_from_json(nd: dict) -> Node:
    return Node(name=nd["name"], kind=nd["kind"], op=nd.get("op"),
                inputs=tuple(nd["inputs"]),
                attrs=_detuple_attrs(nd.get("attrs", {})),
                shape=None if nd.get("shape") is None else tuple(nd["shape"]),
                dtype=nd.get("dtype", "float32"))


# ---------------------------------------------------------------------------
# SameDiff
# ---------------------------------------------------------------------------

RNG_FEED = "__dropout_rng__"


class SameDiff:
    """The graph container (reference `SameDiff.create()`), on one device:
    ``"cuda"`` by default, which raises without CUDA unless ``"cpu"`` is
    given."""

    def __init__(self, device=None):
        self.device = resolve_device(device)
        self._nodes: Dict[str, Node] = {}
        self.variables_: Dict[str, torch.Tensor] = {}   # trainable values
        self._constants: Dict[str, Any] = {}
        self._loss_names: List[str] = []
        self._counter = 0
        self.training_config: Optional[TrainingConfig] = None
        self.opt_state_: Optional[Any] = None
        self.iteration = 0
        self.epoch = 0
        self._score = None
        self._scan_step = None
        self._step_transform = None                      # parallel/zero.py
        self._tick_names: Tuple[str, ...] = ()
        self._flow = _ControlFlow(self)
        self._init_gen = torch.Generator(device=self.device).manual_seed(0)
        self._rng = torch.Generator(device=self.device).manual_seed(0)
        self.math = SDMath(self)
        self.nn = SDNN(self)
        self.cnn = SDCNN(self)
        self.rnn = SDRNN(self)
        self.loss = SDLoss(self)
        self.bitwise = SDBitwise(self)
        self.image = SDImage(self)
        self.linalg = SDLinalg(self)
        self.random = SDRandom(self)

    @staticmethod
    def create(device=None) -> "SameDiff":
        return SameDiff(device=device)

    # ---- naming ----
    def _fresh(self, base: str) -> str:
        # ':' is illegal in TF/ONNX node names, so generated names never
        # collide with names a later model import brings
        self._counter += 1
        name = f"{base}:{self._counter}"
        while name in self._nodes:
            self._counter += 1
            name = f"{base}:{self._counter}"
        return name

    def _add(self, node: Node) -> SDVariable:
        if node.name in self._nodes:
            raise ValueError(f"Duplicate variable name '{node.name}'")
        self._nodes[node.name] = node
        self._invalidate()
        return SDVariable(self, node.name)

    def _invalidate(self):
        self._scan_step = None
        self._flow.cache.clear()

    # ---- declaration API ----
    def placeholder(self, name: str, shape: Optional[Sequence[int]] = None,
                    dtype: str = "float32") -> SDVariable:
        """reference `sd.placeHolder` (-1 = batch dim, kept as None)."""
        shp = None if shape is None else tuple(
            None if s in (-1, None) else int(s) for s in shape)
        return self._add(Node(name, "placeholder", shape=shp, dtype=dtype))

    place_holder = placeholder

    def var(self, name: str, init: Union[np.ndarray, str, torch.Tensor],
            *shape: int, dtype: str = "float32") -> SDVariable:
        """Trainable variable: `sd.var("w", array)` or
        `sd.var("w", "XAVIER", 784, 10)` (drawn from the graph's generator,
        seeded 0, through ``ops/initializers.py``)."""
        if isinstance(init, str):
            arr = init_weights(self._init_gen, tuple(shape), init, torch_dtype(dtype),
                               self.device)
        else:
            arr = self._array(init).clone()
        v = self._add(Node(name, "variable", shape=tuple(arr.shape),
                           dtype=DTYPE_NAMES[arr.dtype]))
        self.variables_[name] = arr
        return v

    def zero(self, name: str, *shape: int, dtype: str = "float32"):
        return self.var(name, np.zeros(shape, dtype))

    def one(self, name: str, *shape: int, dtype: str = "float32"):
        return self.var(name, np.ones(shape, dtype))

    def constant(self, name: Optional[str], value) -> SDVariable:
        """A constant; a Python scalar stays a (weakly typed) scalar."""
        name = name or self._fresh("const")
        if is_weak(value):
            arr = value
            shape, dtype = (), np.asarray(value).dtype.name
        else:
            arr = self._array(value)
            shape, dtype = tuple(arr.shape), DTYPE_NAMES[arr.dtype]
        v = self._add(Node(name, "constant", shape=shape, dtype=dtype))
        self._constants[name] = arr
        return v

    def _array(self, value) -> torch.Tensor:
        if isinstance(value, torch.Tensor):
            return value.detach().to(self.device)
        return _to_device(np.asarray(value), self.device)

    def op(self, opname: str, *inputs, name: Optional[str] = None,
           **attrs) -> SDVariable:
        if opname not in OP_TABLE and opname not in _CONTROL_FLOW_OPS:
            raise KeyError(
                f"Unmapped op '{opname}' — the reference raises the same "
                "named error from ImportGraph/OpMappingRegistry; register "
                "via autodiff.ops.register_op")
        ins = []
        for x in inputs:
            if isinstance(x, SDVariable):
                if x.sd is not self:
                    raise ValueError(
                        f"'{x.name}' belongs to a different SameDiff scope "
                        "(reference: cross-frame use needs Enter; here, pass "
                        "it as an operand to the control-flow op instead)")
                ins.append(x.name)
            else:
                ins.append(self.constant(None, x).name)
        name = name or self._fresh(opname)
        return self._add(Node(name, "op", op=opname, inputs=tuple(ins),
                              attrs=dict(attrs)))

    def rename(self, old: str, new: str) -> SDVariable:
        if new in self._nodes:
            raise ValueError(f"Cannot rename '{old}' to '{new}': name taken")
        node = self._nodes.pop(old)
        node.name = new
        self._nodes[new] = node
        if old in self.variables_:
            self.variables_[new] = self.variables_.pop(old)
        if old in self._constants:
            self._constants[new] = self._constants.pop(old)
        for n in self._nodes.values():
            n.inputs = tuple(new if i == old else i for i in n.inputs)
        self._loss_names = [new if n == old else n for n in self._loss_names]
        self._invalidate()
        return SDVariable(self, new)

    def get_variable(self, name: str) -> SDVariable:
        return SDVariable(self, name)

    def _rng_var(self) -> SDVariable:
        """Hidden placeholder feeding dropout's generator during training."""
        if RNG_FEED not in self._nodes:
            self._add(Node(RNG_FEED, "placeholder", dtype="uint32"))
        return SDVariable(self, RNG_FEED)

    def _next_rng_tag(self) -> int:
        """A unique tag per stochastic node (kept for the shared graph
        format), seeded from the tags already in the graph."""
        tag = getattr(self, "_rng_tag", None)
        if tag is None:
            tag = 1 + max(
                (int(n.attrs.get("tag", -1)) for n in self._nodes.values()
                 if n.kind == "op" and n.op in ("rng_fold", "rng_fold_opt")),
                default=-1)
        self._rng_tag = tag + 1
        return tag

    # ---- control flow ----
    def _split_outputs(self, v: SDVariable, n_out: int):
        if n_out == 1:
            return v
        return tuple(self.op("tuple_get", v, index=i) for i in range(n_out))

    def cond(self, pred, true_fn: Callable, false_fn: Callable,
             *operands, name: Optional[str] = None):
        """`sd.cond(pred, lambda s, x: ..., lambda s, x: ..., x)`: each
        branch fn receives a fresh scope plus one SDVariable per operand
        and returns as many outputs as the other.  Differentiable through
        the branch taken."""
        n = len(operands)
        tg = _SubGraph.trace(true_fn, n, self.device)
        fg = _SubGraph.trace(false_fn, n, self.device)
        if len(tg.out_names) != len(fg.out_names):
            raise ValueError(
                f"cond branches disagree on output arity "
                f"({len(tg.out_names)} vs {len(fg.out_names)})")
        v = self.op("cond", pred, *operands, name=name,
                    true_graph=tg.to_json(), false_graph=fg.to_json(),
                    n_out=len(tg.out_names))
        return self._split_outputs(v, len(tg.out_names))

    def while_loop(self, cond_fn: Callable, body_fn: Callable,
                   *init, name: Optional[str] = None):
        """`sd.while_loop(lambda s, i, acc: ..., lambda s, i, acc: (...), i0,
        acc0)`: `cond_fn` returns one scalar-bool output, `body_fn` one
        output per loop-state operand.  Forward only, as in the JAX
        package."""
        n = len(init)
        cg = _SubGraph.trace(cond_fn, n, self.device)
        if len(cg.out_names) != 1:
            raise ValueError("while_loop cond_fn must return exactly one "
                             "(scalar bool) output")
        bg = _SubGraph.trace(body_fn, n, self.device)
        if len(bg.out_names) != n:
            raise ValueError(
                f"while_loop body_fn must return {n} outputs (one per loop "
                f"state operand), got {len(bg.out_names)}")
        v = self.op("while_loop", *init, name=name,
                    cond_graph=cg.to_json(), body_graph=bg.to_json())
        return self._split_outputs(v, n)

    def scan(self, body_fn: Callable, init, xs, *, consts=(),
             name: Optional[str] = None):
        """`sd.scan(lambda s, carry..., x, *consts: (new_carry..., y...),
        init, xs, consts=(w, ...))` over the leading axis of `xs`; returns
        `(final_carry, ys)`, the per-step outputs stacked on a new leading
        axis.  Differentiable."""
        carry = tuple(init) if isinstance(init, (tuple, list)) else (init,)
        n_carry = len(carry)
        consts = tuple(consts)
        bg = _SubGraph.trace(body_fn, n_carry + 1 + len(consts), self.device)
        n_ys = len(bg.out_names) - n_carry
        if n_ys < 1:
            raise ValueError(
                f"scan body_fn must return the {n_carry} new carry value(s) "
                "plus at least one per-step output")
        v = self.op("scan", *carry, xs, *consts, name=name,
                    body_graph=bg.to_json(), n_carry=n_carry,
                    n_consts=len(consts))
        parts = self._split_outputs(v, n_carry + n_ys)
        fc = parts[:n_carry]
        ys = parts[n_carry:]
        final_carry = fc if isinstance(init, (tuple, list)) else fc[0]
        return final_carry, (ys[0] if n_ys == 1 else ys)

    def set_loss_variables(self, *names):
        self._loss_names = [n.name if isinstance(n, SDVariable) else n
                            for n in names]
        self._invalidate()

    def set_training_config(self, cfg: TrainingConfig):
        self.training_config = cfg
        self._invalidate()

    # ---- evaluation ----
    def _eval_graph(self, feeds: Dict[str, Any], variables: Dict[str, Any],
                    names: Sequence[str], meta: bool = False) -> Dict[str, Any]:
        """Iterative post-order walk (an explicit stack, no recursion).
        With `meta`, every stored array enters as a meta tensor: the walk
        gives shapes and dtypes without computing."""
        cache: Dict[str, Any] = {}

        def leaf_value(node: Node):
            n = node.name
            if node.kind == "placeholder":
                if n not in feeds:
                    if n == RNG_FEED:
                        return None
                    raise KeyError(f"Placeholder '{n}' not fed")
                return feeds[n]
            v = variables[n] if node.kind == "variable" else self._constants[n]
            return _to_meta(v) if meta else v

        for target in names:
            stack = [target]
            while stack:
                n = stack[-1]
                if n in cache:
                    stack.pop()
                    continue
                node = self._nodes[n]
                if node.kind != "op":
                    cache[n] = leaf_value(node)
                    stack.pop()
                    continue
                pending = [i for i in node.inputs if i not in cache]
                if pending:
                    stack.extend(pending)
                    continue
                args = [cache[i] for i in node.inputs]
                if node.op in _CONTROL_FLOW_OPS:
                    cache[n] = self._flow(node, args, meta)
                else:
                    cache[n] = OP_TABLE[node.op](*args, **node.attrs)
                stack.pop()

        return {n: cache[n] for n in names}

    def _feeds(self, feeds: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        return {k: self._array(v) for k, v in feeds.items()}

    def output(self, feeds: Dict[str, Any], *names) -> Dict[str, Any]:
        """Multi-output inference (reference `sd.output(Map, String...)`)."""
        names = tuple(n.name if isinstance(n, SDVariable) else n for n in names)
        with torch.no_grad():
            out = self._eval_graph(self._feeds(feeds), self.variables_, names)
        return {k: as_tensor(v, self.device) if is_weak(v) else v for k, v in out.items()}

    def batch_output(self, feeds, *names):
        return self.output(feeds, *names)

    def shapes_of(self, feeds: Dict[str, Any], *names) -> Dict[str, Tuple]:
        """The (shape, dtype) of each named output for feeds of these
        shapes and dtypes (arrays or meta tensors), computed on meta
        tensors without running the graph."""
        names = tuple(n.name if isinstance(n, SDVariable) else n for n in names)
        meta_feeds = {k: _to_meta(self._array(v) if not isinstance(v, torch.Tensor) else v)
                      for k, v in feeds.items()}
        out = self._eval_graph(meta_feeds, self.variables_, names, meta=True)
        return {k: (tuple(as_tensor(v).shape), as_tensor(v).dtype) for k, v in out.items()}

    # ---- training ----
    def _total_loss(self, variables, feeds):
        vals = self._eval_graph(feeds, variables, self._loss_names)
        loss = 0.0
        for v in vals.values():
            v = as_tensor(v, self.device)
            loss = loss + (v if v.ndim == 0 else torch.sum(v))
        cfg = self.training_config
        if cfg and (cfg.l1 or cfg.l2):
            for arr in variables.values():
                if cfg.l1:
                    loss = loss + cfg.l1 * torch.sum(torch.abs(arr))
                if cfg.l2:
                    loss = loss + 0.5 * cfg.l2 * torch.sum(arr * arr)
        return loss

    def _loss_and_grads(self, feeds) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        leaves = {n: v.detach().requires_grad_(True) for n, v in self.variables_.items()}
        with torch.enable_grad():
            loss = self._total_loss(leaves, feeds)
            got = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True) \
                if leaves else ()
        grads = {n: torch.zeros_like(v) if g is None else g
                 for (n, v), g in zip(leaves.items(), got)}
        return loss.detach(), grads

    def _step(self, feeds: Dict[str, Any], epoch: torch.Tensor) -> torch.Tensor:
        """One training step, written in place: variables, updater state
        and the iteration counter; returns the loss."""
        if RNG_FEED in self._nodes:
            feeds = dict(feeds)
            feeds[RNG_FEED] = self._rng
        loss, grads = self._loss_and_grads(feeds)
        it = self._iter_dev
        upd_cfg = self.training_config.updater
        zt = self._step_transform
        with torch.no_grad():
            scalars = StepScalars(it, epoch, scalar_dtype(self.variables_)).of(upd_cfg)
            view = self.variables_ if zt is None else zt.update_view(None, self.variables_)
            if zt is not None:
                grads = zt.scatter(None, grads)
            upd, _ = upd_cfg.apply(self.opt_state_, grads, it, epoch,
                                   params=view, scalars=scalars)
            if zt is None:
                for n, p in self.variables_.items():
                    p.sub_(upd[n])
            else:
                zt.restore(None, self.variables_, view, upd)
            it.add_(1)
        return loss

    def _train_tick(self, carry, epoch, batch) -> torch.Tensor:
        return self._step(dict(zip(self._tick_names, batch)), epoch)

    def _carry(self) -> List[torch.Tensor]:
        return (list(self.variables_.values())
                + [t for t in tree_leaves(self.opt_state_) if isinstance(t, torch.Tensor)]
                + [device_counters(self)[0]])

    def _ready(self):
        if self.training_config is None:
            raise ValueError("set_training_config(...) first (reference "
                             "throws the same)")
        if not self._loss_names:
            raise ValueError("set_loss_variables(...) first")
        if self.opt_state_ is None:
            self.opt_state_ = self.training_config.updater.init_state(self.variables_)

    def fit(self, data=None, labels=None, *, iterator=None, epochs: int = 1,
            feeds: Optional[Dict[str, Any]] = None,
            fused_steps: Optional[int] = None) -> "SameDiff":
        """fit(features, labels) / fit(feeds={...}) for one batch, or
        fit(iterator=multi_data_set_iterator, epochs=N).  `fused_steps=k`
        trains blocks of k consecutive same-shape batches through one
        `fit_steps` (tails step alone)."""
        self._ready()
        fused_steps = fused_steps or 1
        if iterator is not None:
            from deeplearning4j_tpu_torch.utils.scan_fit import blocks_of
            for _ in range(epochs):
                if hasattr(iterator, "reset"):
                    iterator.reset()
                if fused_steps > 1:
                    for block in blocks_of(iterator, fused_steps):
                        if len(block) == 1:
                            self._fit_feeds(self._map_dataset(block[0]))
                        else:
                            fl = [self._map_dataset(ds) for ds in block]
                            self.fit_steps({k: [f[k] for f in fl] for k in fl[0]})
                else:
                    for ds in iterator:
                        self._fit_feeds(self._map_dataset(ds))
                self.epoch += 1
            return self
        if feeds is None:
            cfg = self.training_config
            feeds = {}
            xs = data if isinstance(data, (list, tuple)) else [data]
            ys = labels if isinstance(labels, (list, tuple)) else [labels]
            for n, v in zip(cfg.data_set_feature_mapping, xs):
                feeds[n] = v
            for n, v in zip(cfg.data_set_label_mapping, ys):
                feeds[n] = v
        self._fit_feeds(feeds)
        return self

    def _map_dataset(self, ds):
        cfg = self.training_config
        feeds = {}
        feats = ds.features if isinstance(ds.features, (list, tuple)) else [ds.features]
        labs = ds.labels if isinstance(ds.labels, (list, tuple)) else [ds.labels]
        for n, v in zip(cfg.data_set_feature_mapping, feats):
            feeds[n] = v
        for n, v in zip(cfg.data_set_label_mapping, labs):
            feeds[n] = v
        return feeds

    def _fit_feeds(self, feeds: Dict[str, Any]):
        _, epoch = device_counters(self)
        self._score = self._step(self._feeds(feeds), epoch)
        advance(self)

    def fit_steps(self, feeds: Dict[str, Any]) -> torch.Tensor:
        """k training steps as one block: every feed carries a leading
        `[k, batch, ...]` steps axis (a stride-0 ``broadcast_to`` view
        included) or is a list of k per-step arrays.  One CUDA-graph replay
        on the card, the same step k times on the CPU; the same math as k
        `fit(feeds=...)` calls.  Returns the k losses."""
        from deeplearning4j_tpu_torch.nn.multilayer import block_tensor
        from deeplearning4j_tpu_torch.utils.scan_fit import GraphStep, check_steps_axes
        self._ready()
        names = tuple(sorted(feeds))
        block = [[self._array(a) for a in feeds[n]] if isinstance(feeds[n], (list, tuple))
                 else block_tensor(feeds[n], self.device) for n in names]
        k = check_steps_axes(zip(names, block))
        if self._scan_step is None:
            self._scan_step = GraphStep(self._train_tick)
        self._tick_names = names
        _, epoch = device_counters(self)
        losses = self._scan_step(self._carry(), epoch, block, key=names,
                                 generator=self._rng if RNG_FEED in self._nodes else None)
        self._score = losses[-1]
        advance(self, int(k))
        return losses

    def score(self) -> float:
        """Loss of the most recent step; reading it waits for the card."""
        return float(self._score) if self._score is not None else float("nan")

    def evaluate(self, iterator, output_name, evaluation=None, label_index: int = 0):
        """Classification eval over a DataSetIterator (reference
        `sd.evaluate(iterator, outputVariable, new Evaluation())`)."""
        from deeplearning4j_tpu_torch.train.evaluation import Evaluation
        if self.training_config is None:
            raise ValueError("set_training_config(...) first — evaluate "
                             "uses its feature/label mappings")
        output_name = output_name.name if isinstance(output_name, SDVariable) \
            else output_name
        ev = evaluation or Evaluation()
        if hasattr(iterator, "reset"):
            iterator.reset()
        for ds in iterator:
            feeds = self._map_dataset(ds)
            labels = ds.labels[label_index] \
                if isinstance(ds.labels, (list, tuple)) else ds.labels
            preds = self.output(
                {k: v for k, v in feeds.items()
                 if k not in self.training_config.data_set_label_mapping},
                output_name)[output_name]
            lmask = getattr(ds, "labels_mask", None)
            if lmask is None:
                lmasks = getattr(ds, "labels_masks", None)
                if lmasks is not None:
                    lmask = lmasks[label_index]
            ev.eval(_numpy(labels), _numpy(preds),
                    mask=None if lmask is None else _numpy(lmask))
        return ev

    def calculate_gradients(self, feeds: Dict[str, Any], *wrt) -> Dict[str, np.ndarray]:
        """Gradients of the summed loss wrt named variables (reference
        `sd.calculateGradients`), as numpy arrays."""
        wrt = [w.name if isinstance(w, SDVariable) else w for w in wrt] \
            or list(self.variables_)
        _, grads = self._loss_and_grads(self._feeds(feeds))
        return {w: _numpy(grads[w]) for w in wrt}

    def set_executable_cache(self, cache):
        raise NotImplementedError(
            "set_executable_cache (the compiled-step cache) is not ported yet "
            "(ROADMAP.md A6)")

    def apply_schedule(self, schedule):
        raise NotImplementedError(
            "apply_schedule (compile schedules) is not ported yet (ROADMAP.md A6)")

    # ---- serialization ----
    def save(self, path: str, save_updater_state: bool = True):
        graph = {
            "format": FORMAT,
            "nodes": [dataclasses.asdict(n) for n in self._nodes.values()],
            "loss_variables": self._loss_names,
            "iteration": self.iteration, "epoch": self.epoch,
            "training_config": (self.training_config.to_json()
                                if self.training_config else None),
        }
        with zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED) as z:
            z.writestr("graph.json", json.dumps(graph, default=_json_default))
            z.writestr("variables.npz", _npz_bytes(
                {k: _numpy(v) for k, v in self.variables_.items()}))
            z.writestr("constants.npz", _npz_bytes(
                {k: _numpy(v) for k, v in self._constants.items()}))
            if save_updater_state and self.opt_state_ is not None:
                zt = self._step_transform
                leaves = list(tree_leaves(self.opt_state_ if zt is None
                                          else zt.gather_opt(None, self.opt_state_)))
                z.writestr("updater.npz", _npz_bytes(
                    {str(i): _numpy(l) for i, l in enumerate(leaves)}))

    @staticmethod
    def load(path: str, load_updater_state: bool = True, device=None) -> "SameDiff":
        sd = SameDiff(device=device)
        with zipfile.ZipFile(path, "r") as z:
            graph = json.loads(z.read("graph.json").decode())
            if graph.get("format", FORMAT) != FORMAT:
                raise ValueError(f"{path}: format {graph.get('format')!r}, want {FORMAT!r}")
            variables = _npz_load(z.read("variables.npz"))
            constants = _npz_load(z.read("constants.npz"))
            for nd in graph["nodes"]:
                node = _node_from_json(nd)
                sd._nodes[node.name] = node
            sd.variables_ = {k: _to_device(v, sd.device) for k, v in variables.items()}
            sd._constants = {k: _to_device(v, sd.device) for k, v in constants.items()}
            sd._loss_names = graph["loss_variables"]
            sd.iteration = graph["iteration"]
            sd.epoch = graph["epoch"]
            if graph["training_config"]:
                sd.training_config = TrainingConfig.from_json(graph["training_config"])
            if load_updater_state and "updater.npz" in z.namelist() \
                    and sd.training_config is not None:
                sd.opt_state_ = sd.training_config.updater.init_state(sd.variables_)
                saved = _npz_load(z.read("updater.npz"))
                leaves = [l for l in tree_leaves(sd.opt_state_) if isinstance(l, torch.Tensor)]
                if len(saved) != len(leaves):
                    raise ValueError(f"{path}: updater.npz holds {len(saved)} leaves, the "
                                     f"updater's state has {len(leaves)}")
                with torch.no_grad():
                    for i, leaf in enumerate(leaves):
                        leaf.copy_(torch.as_tensor(saved[str(i)]))
        return sd

    def summary(self) -> str:
        lines = [f"{'name':30s} {'kind':12s} {'op':24s} inputs"]
        for n in self._nodes.values():
            lines.append(f"{n.name:30s} {n.kind:12s} {n.op or '-':24s} "
                         f"{list(n.inputs)}")
        return "\n".join(lines)


def _json_default(o):
    if isinstance(o, np.integer):
        return int(o)
    if isinstance(o, np.floating):
        return float(o)
    if isinstance(o, (np.ndarray, torch.Tensor)):
        return _numpy(o).tolist()
    if isinstance(o, tuple):
        return list(o)
    raise TypeError(f"not json-serializable: {type(o)}")


def _detuple_attrs(attrs: Dict[str, Any]) -> Dict[str, Any]:
    """JSON turns tuples into lists; ops that need tuples re-tuple them."""
    out = {}
    for k, v in attrs.items():
        out[k] = tuple(v) if isinstance(v, list) and k in (
            "stride", "kernel", "dilation", "perm") else v
    return out


def _npz_bytes(arrays: Dict[str, np.ndarray]) -> bytes:
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    return buf.getvalue()


def _npz_load(data: bytes) -> Dict[str, np.ndarray]:
    with np.load(io.BytesIO(data), allow_pickle=False) as z:
        return {k: z[k] for k in z.files}
