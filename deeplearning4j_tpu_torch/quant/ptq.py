"""Post-training quantizer: f32 model -> int8/bf16 `QuantizedModel` (the
port of ``quant/ptq.py``).

`quantize_model` walks a model's parameters and rewrites every
weight-bearing leaf into one of three forms:

- **int8 `QTensor`** (the normal case): symmetric per-output-channel
  scales, 4x smaller resident than f32;
- **bf16 fallback** for range-hostile tensors (`range_hostility` above the
  threshold), where int8 would zero most of a channel's mass;
- **untouched** for small and 1-D leaves (biases, norm gains).

Each leaf is judged and quantized in the JAX package's layout: along the
axis that is last there (a conv ``W`` is HWIO in the JAX tree, OIHW here,
``Layer.TORCH_LAYOUT``, so its channels are the port's axis 0), with the
hostility computed on that layout, so the QTensors and the report equal
the JAX package's (``convert.quant_params_to_jax``).  The QTensors are
then stored in the port's layout on the model's device.

`QuantizedModel` is serving-shaped: `conf` / `params_` / `state_` /
`device` and `_forward(params, state, x, train=False)`, the contract the
bucket cache runs, so `ModelServer` serves it unmodified.  It wraps a
MultiLayerNetwork, a single-input ComputationGraph or a SameDiff graph (an
imported ONNX model, the way the port serves one).  MultiLayerNetwork
models send their Dense layers (the Output layer included) through the
quantized products: weight-only int8 (``quantized_dense``, the ``q_matmul``
kernel on CUDA) or, with ``quantize_activations`` and calibration, int8
activations (``quantized_matmul_static``, the ``int8_matmul`` kernel); every
other layer dequantizes its parameters and runs the stock layer.
ComputationGraph models dequantize every parameter and run the stock graph;
SameDiff graphs quantize their ``variables_`` (each leaf as the JAX package
judges it: the graph's arrays have the same layout in both packages),
dequantize them to f32 and run the graph from its one placeholder to its
first op that no other op consumes.
A MultiLayerNetwork's quantized leaves may be placed by
``parallel.shard_model_params`` on a mesh with a ``model`` axis (this
rank's block of ``q`` and of its ``scale``): inside ``with mesh:`` a Dense
layer whose ``W`` is cut on its output channels runs column-parallel (the
product on the local block, then an all-gather of the output features
over ``model``), and any other cut leaf is gathered whole where it is used.
A model of any other kind raises `TypeError`.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch.convert import jax_view
from deeplearning4j_tpu_torch.monitor.instrument import quant_instruments
from deeplearning4j_tpu_torch.nn.multilayer import torch_dtype
from deeplearning4j_tpu_torch.ops.quant_kernels import (
    QTensor, dequantize, quantize_tensor, quantized_dense,
    quantized_matmul_static, range_hostility)
from deeplearning4j_tpu_torch.quant.calibrate import CalibrationStats, is_mln


def dtype_name(dt: torch.dtype) -> str:
    """A torch dtype as the JAX package names it (``float32``, ``int8``)."""
    return str(dt).replace("torch.", "")


@dataclasses.dataclass(frozen=True)
class QuantConfig:
    """Knobs for `quantize_model`, field for field the JAX package's."""

    dtype: str = "int8"              # target weight dtype
    fallback_dtype: str = "bfloat16"  # range-hostile escape hatch
    hostility_threshold: float = 127.0  # range_hostility above -> fallback
    min_ndim: int = 2                # 1-D leaves (biases, gains) stay f32
    min_size: int = 256              # tiny leaves stay f32
    quantize_activations: bool = False  # static int8 input scales (MLN)
    acc_dtype: Optional[str] = None  # accumulator; default compute_dtype/f32

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), sort_keys=True)


def _leaf_plan(view: torch.Tensor, config: QuantConfig) -> str:
    """Which form a leaf (in the JAX layout) takes: 'int8' | 'bf16' |
    'keep'."""
    if not view.is_floating_point():
        return "keep"
    if view.ndim < config.min_ndim or view.numel() < config.min_size:
        return "keep"
    if range_hostility(view.contiguous()) > config.hostility_threshold:
        return "bf16"
    return "int8"


def _quantize_leaf(layer, key: str, t: torch.Tensor) -> QTensor:
    """quantize_tensor along the JAX layout's last axis, stored back in the
    port's layout (q and scale permuted alike)."""
    t = t.detach()
    perm = layer.TORCH_LAYOUT.get(key)
    qt = quantize_tensor(jax_view(layer, key, t), axis=-1)
    if perm is None:
        return qt
    return QTensor(qt.q.permute(*perm).contiguous(),
                   qt.scale.permute(*perm).contiguous(),
                   axis=perm.index(t.ndim - 1))


def _rewrite(view: torch.Tensor, leaf: torch.Tensor, quantize, config: QuantConfig):
    """(new leaf, the dtype the report names) of a leaf judged in the JAX
    layout `view`; `quantize()` gives its QTensor."""
    plan = _leaf_plan(view, config)
    if plan == "int8":
        return quantize(), "int8"
    if plan == "bf16":
        return leaf.to(torch_dtype(config.fallback_dtype)), config.fallback_dtype
    return leaf, dtype_name(leaf.dtype)


def _quantize_leaves(params, config: QuantConfig):
    """A SameDiff graph's flat {name: tensor} variables, whose layout is the
    JAX package's; returns (new_tree, report) with the JAX tree paths
    (``['w']``)."""
    report: Dict[str, str] = {}
    tree: Dict[str, Any] = {}
    for name in sorted(params):
        leaf = params[name].detach()
        tree[name], report[f"[{name!r}]"] = _rewrite(
            leaf, leaf, lambda: quantize_tensor(leaf, axis=-1), config)
    return tree, report


def _quantize_tree(model, params, config: QuantConfig):
    """Rewrite a {name: {key: tensor}} parameter tree; returns (new_tree,
    report) where report maps the JAX tree path of each leaf (``['layer_0']
    ['W']``) to the dtype it became."""
    report: Dict[str, str] = {}
    tree: Dict[str, Dict[str, Any]] = {}
    for name in sorted(params):
        tree[name] = {}
        layer = model.layer_by_name(name) if params[name] else None
        for key in sorted(params[name]):
            leaf = params[name][key]
            if isinstance(leaf, QTensor):
                raise ValueError("model is already quantized")
            leaf = leaf.detach()
            tree[name][key], report[f"[{name!r}][{key!r}]"] = _rewrite(
                jax_view(layer, key, leaf), leaf,
                lambda: _quantize_leaf(layer, key, leaf), config)
    return tree, report


def _deq_tree(tree, dtype):
    """Dequantize every QTensor (and cast floating leaves) to `dtype`."""
    if isinstance(tree, dict):
        return {k: _deq_tree(v, dtype) for k, v in tree.items()}
    if isinstance(tree, QTensor):
        return dequantize(tree, dtype)
    if isinstance(tree, torch.Tensor) and tree.is_floating_point():
        return tree.to(dtype)
    return tree


def _tree_bytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(_tree_bytes(v) for v in tree.values())
    if isinstance(tree, QTensor):
        return tree.nbytes
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    return 0


def model_kind(model) -> str:
    """'mln', 'graph' or 'samediff'; raises TypeError for any other
    model."""
    if is_mln(model):
        return "mln"
    if hasattr(model, "_as_input_dict"):
        return "graph"
    if hasattr(model, "_nodes"):
        return "samediff"
    raise TypeError(
        f"cannot serve a quantized {type(model).__name__}: need a "
        "MultiLayerNetwork, ComputationGraph or SameDiff model")


def samediff_io(sd) -> Tuple[list, list]:
    """A graph's served inputs and outputs: its placeholders (dropout's
    generator feed aside) and the ops no other op consumes, in graph
    order."""
    from deeplearning4j_tpu_torch.autodiff.samediff import RNG_FEED
    nodes = sd._nodes
    consumed = {i for node in nodes.values() if node.kind == "op" for i in node.inputs}
    ins = [n for n, node in nodes.items() if node.kind == "placeholder" and n != RNG_FEED]
    outs = [n for n, node in nodes.items() if node.kind == "op" and n not in consumed]
    return ins, outs


class QuantizedModel:
    """Serving-shaped wrapper holding a quantized parameter tree of a
    MultiLayerNetwork, a single-input ComputationGraph or a SameDiff graph,
    on the base model's device."""

    is_quantized = True

    def __init__(self, base, params, config: QuantConfig,
                 calibration: Optional[CalibrationStats],
                 report: Dict[str, str]):
        self.kind = model_kind(base)
        self.base = base
        self.conf = getattr(base, "conf", None)
        self.device = base.device
        self.params_ = params
        self.state_ = getattr(base, "state_", None) or {}
        self.config = config
        self.calibration = calibration
        self.report = report
        if self.kind == "samediff":
            self._sd_inputs, self._sd_outputs = samediff_io(base)

    # ---- dtype plumbing ----
    def acc_dtype(self) -> torch.dtype:
        """The accumulating dtype every product and dequantize lands in:
        the configured override, else the base model's compute_dtype, else
        f32."""
        if self.config.acc_dtype is not None:
            return torch_dtype(self.config.acc_dtype)
        cd = getattr(self.conf, "compute_dtype", None)
        return torch_dtype(cd) if cd is not None else torch.float32

    # ---- forward (the serving contract) ----
    def _forward(self, params, state, x, *, train: bool = False,
                 rng=None, mask=None) -> Tuple[Any, Any]:
        if train:
            raise ValueError("a quantized model serves inference only")
        if self.kind == "mln":
            return self._forward_mln(params, state, x)
        if self.kind == "samediff":
            if len(self._sd_inputs) != 1 or not self._sd_outputs:
                raise ValueError(
                    f"quantized serving needs one placeholder and at least "
                    f"one output; graph has inputs {self._sd_inputs}, "
                    f"outputs {self._sd_outputs}")
            out = self._sd_outputs[0]
            deq = _deq_tree(params, torch.float32)
            return self.base._eval_graph({self._sd_inputs[0]: x}, deq, [out])[out], state
        names = list(self.conf.network_inputs)
        if len(names) != 1:
            raise ValueError(
                f"quantized serving handles single-input graphs; this one "
                f"has inputs {names}")
        deq = _deq_tree(params, torch.float32)
        acts, st = self.base._forward(deq, state, {names[0]: x},
                                      train=False, rng=None)
        return acts[self.conf.network_outputs[0]], st

    def _forward_mln(self, params, state, x):
        from deeplearning4j_tpu_torch.nn.layers import DenseLayer
        from deeplearning4j_tpu_torch.parallel.mesh import current_mesh
        from deeplearning4j_tpu_torch.parallel.sharding import gathered_leaf

        acc = self.acc_dtype()
        if x.is_floating_point():
            x = x.to(acc)
        mesh = current_mesh()
        new_state = dict(state)
        for i, layer in enumerate(self.conf.layers):
            name = self.conf.layer_name(i)
            lp = params[name]
            shapes = {k: tuple(v.shape) for k, v in self.base.params_.get(name, {}).items()}
            w = lp.get("W")
            if isinstance(layer, DenseLayer) and isinstance(w, QTensor):
                # flatten exactly as DenseLayer.apply does (NHWC order)
                if x.ndim > 2 and x.ndim != 3:
                    x = x.reshape(x.shape[0], -1)
                cols = tuple(w.q.shape) != shapes["W"]      # column-parallel block
                b = lp.get("b")
                if cols and b is not None and b.shape[-1] != w.q.shape[-1]:
                    n = w.q.shape[-1]
                    b = b.narrow(-1, mesh.coordinate("model") * n, n)
                akey = f"{name}:in"
                if (self.config.quantize_activations
                        and self.calibration is not None
                        and akey in self.calibration.ranges):
                    y = quantized_matmul_static(
                        x, w, self.calibration.scale(akey), acc_dtype=acc)
                    if b is not None:
                        y = y + b.to(acc)
                else:
                    y = quantized_dense(x, w, b, acc_dtype=acc)
                if cols:
                    y = gathered_leaf(y, tuple(y.shape[:-1]) + (shapes["W"][-1],), mesh)
                x = layer.act_fn()(y)
            else:
                if mesh is not None:
                    lp = {k: gathered_leaf(v, shapes[k], mesh) if k in shapes else v
                          for k, v in lp.items()}
                x, new_state[name] = layer.apply(_deq_tree(lp, acc),
                                                 state[name], x)
        return x, new_state

    # ---- convenience inference ----
    @torch.inference_mode()
    def output(self, x) -> torch.Tensor:
        """Quantized inference on the model's device; returns a tensor
        there."""
        x = torch.as_tensor(x, device=self.device)
        return self._forward(self.params_, self.state_, x)[0]

    # ---- identity / accounting ----
    def quant_fingerprint(self) -> Dict[str, Any]:
        """Config + calibration crc + the per-leaf dtype plan: what would
        fold into an executable-cache key (the port has no such cache
        yet)."""
        return {
            "config": json.loads(self.config.to_json()),
            "calibration_crc": (self.calibration.crc32()
                                if self.calibration is not None else None),
            "report": dict(sorted(self.report.items())),
            "base_class": type(self.base).__name__,
        }

    def bytes_resident(self) -> int:
        """Bytes the quantized params + state occupy (int8 + scales)."""
        return _tree_bytes(self.params_) + _tree_bytes(self.state_)

    def dominant_dtype(self) -> str:
        n_int8 = sum(1 for v in self.report.values() if v == "int8")
        n_fb = sum(1 for v in self.report.values()
                   if v == self.config.fallback_dtype)
        return "int8" if n_int8 >= n_fb else self.config.fallback_dtype

    def describe(self) -> Dict[str, Any]:
        counts: Dict[str, int] = {}
        for v in self.report.values():
            counts[v] = counts.get(v, 0) + 1
        return {
            "kind": self.kind,
            "dtypes": counts,
            "bytes_resident": self.bytes_resident(),
            "acc_dtype": dtype_name(self.acc_dtype()),
            "calibration": (self.calibration.to_dict()
                            if self.calibration is not None else None),
        }


@torch.no_grad()
def quantize_model(model, calibration: Optional[CalibrationStats] = None,
                   config: Optional[QuantConfig] = None) -> QuantizedModel:
    """Quantize a trained model for inference.  A pure function of
    (weights, calibration, config): quantizing the same model twice gives
    bit-identical QTensors."""
    if getattr(model, "is_quantized", False):
        raise ValueError("model is already quantized")
    kind = model_kind(model)
    config = config if config is not None else QuantConfig()
    params = getattr(model, "variables_" if kind == "samediff" else "params_", None)
    if params is None:
        raise TypeError(f"{type(model).__name__} has no parameters to quantize")
    f32_bytes = _tree_bytes(params)
    qparams, report = (_quantize_leaves(params, config) if kind == "samediff"
                       else _quantize_tree(model, params, config))
    qm = QuantizedModel(model, qparams, config, calibration, report)
    saved = f32_bytes - _tree_bytes(qparams)
    quant_instruments().record_model(qm.dominant_dtype(), max(saved, 0))
    return qm


# ---------------------------------------------------------------------------
# parity harness
# ---------------------------------------------------------------------------

def _host(t) -> np.ndarray:
    if isinstance(t, (list, tuple)):
        t = t[0]
    return t.detach().to(torch.float32).cpu().numpy()


@torch.inference_mode()
def _base_forward(model, x) -> np.ndarray:
    """f32 forward of a servable model (quantized or not); a SameDiff graph
    from its one placeholder to its first unconsumed op."""
    if not getattr(model, "is_quantized", False) and hasattr(model, "_nodes"):
        ins, outs = samediff_io(model)
        return _host(model.output({ins[0]: x}, outs[0])[outs[0]])
    return _host(model.output(x))


def parity_check(base, quantized: QuantizedModel, x,
                 task: str = "auto") -> Dict[str, Any]:
    """f32-vs-quantized accuracy delta on one batch: top-1 disagreement
    for classification-shaped outputs, relative L2 error otherwise.
    Records the `quant_accuracy_delta` gauge; the acceptance gate is
    delta <= 0.01 (1%)."""
    ref = _base_forward(base, x)
    got = _base_forward(quantized, x)
    if got.shape != ref.shape:
        raise ValueError(
            f"parity shape mismatch: f32 {ref.shape} vs quant {got.shape}")
    if task == "auto":
        task = ("classification"
                if ref.ndim == 2 and ref.shape[-1] > 1 else "regression")
    if task == "classification":
        delta = float(np.mean(np.argmax(ref, -1) != np.argmax(got, -1)))
    else:
        denom = float(np.linalg.norm(ref)) or 1.0
        delta = float(np.linalg.norm(got - ref)) / denom
    quant_instruments().record_accuracy_delta(delta)
    return {"task": task, "delta": delta, "n": int(ref.shape[0])}
