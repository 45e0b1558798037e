"""ComputationGraph: the arbitrary-DAG model (the port of ``nn/graph.py``).

The vertices, the configuration, its builder and its JSON are the JAX
package's, field for field, so ``ComputationGraphConfiguration.to_json()``
is the same string in both packages.  The network is an ``nn.Module``: one
submodule per vertex under ``vertices`` holds that vertex's parameters
(``nn.Parameter``s named after the JAX tree, in the port's layouts) and its
layer state as buffers (BatchNormalization's running ``mean``/``var``).
``params()``/``set_params()`` keep the JAX flat order (``tree_leaves``:
vertex names, then keys, sorted as strings).

Training runs eagerly: one ``fit(features, labels)`` call is one step.  The
summed loss of the output heads plus the l1/l2 penalty is differentiated by
autograd (in place of ``jax.value_and_grad``), then each vertex's updater
runs in topological order and its update is subtracted from the
parameters in place under ``torch.no_grad()``.  Under
``compute_dtype="bfloat16"`` the forward runs on bf16 casts of the f32
master parameters, so the gradients reach the f32 parameters.  Dropout
masks come from a ``torch.Generator`` seeded from the configuration seed.

Not ported yet: ``fit_steps`` / fused k-step loops, iterators and
epochs, gradient sharing, ZeRO, the executable cache, compile schedules,
device normalizers, instruments, listeners, gradient checkpointing
(``remat``), evaluation and save/load.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from deeplearning4j_tpu_torch import convert
from deeplearning4j_tpu_torch.nn.core import InputType, Layer
from deeplearning4j_tpu_torch.nn.multilayer import (_add_scaled_where,
                                                    _masked_leaves, torch_dtype)
from deeplearning4j_tpu_torch.train.updaters import (
    IUpdater, Sgd, apply_gradient_normalization, tree_map)
from deeplearning4j_tpu_torch.utils.devices import resolve_device

Params = Dict[str, Dict[str, torch.Tensor]]


# ---------------------------------------------------------------------------
# Graph vertices
# ---------------------------------------------------------------------------

@dataclasses.dataclass(kw_only=True)
class GraphVertex:
    """Non-layer graph node combining or reshaping activations: a config
    dataclass whose `apply` is the forward over its input list."""

    name: Optional[str] = None

    def initialize(self, gen: torch.Generator, input_types: List[InputType],
                   dtype=torch.float32, device=None):
        return {}, {}, self.output_type(input_types)

    def output_type(self, input_types: List[InputType]) -> InputType:
        raise NotImplementedError

    def apply(self, params, state, inputs: List[torch.Tensor], *,
              train: bool = False, rng=None) -> Tuple[torch.Tensor, Dict]:
        raise NotImplementedError

    def to_json(self) -> dict:
        d = {f.name: getattr(self, f.name) for f in dataclasses.fields(self)}
        d["@vertex"] = type(self).__name__
        return d

    @staticmethod
    def from_json(d: dict) -> "GraphVertex":
        d = dict(d)
        kind = d.pop("@vertex")
        if kind not in VERTEX_REGISTRY:
            raise ValueError(f"vertex type {kind!r} is not ported yet; have "
                             f"{sorted(VERTEX_REGISTRY)}")
        cls = VERTEX_REGISTRY[kind]
        field_names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in field_names})


@dataclasses.dataclass(kw_only=True)
class MergeVertex(GraphVertex):
    """Concatenate along the last (channel / feature) axis."""

    def output_type(self, input_types):
        t0 = input_types[0]
        feat = sum(t.shape[-1] for t in input_types)
        return InputType(t0.kind, t0.shape[:-1] + (feat,))

    def apply(self, params, state, inputs, *, train=False, rng=None):
        return torch.cat(inputs, dim=-1), state


@dataclasses.dataclass(kw_only=True)
class ElementWiseVertex(GraphVertex):
    """Pointwise combine: Add | Subtract | Product | Average | Max (the
    ResNet shortcut is Add)."""

    op: str = "Add"

    def output_type(self, input_types):
        return input_types[0]

    def apply(self, params, state, inputs, *, train=False, rng=None):
        op = self.op.lower()
        if op == "subtract":
            if len(inputs) != 2:
                raise ValueError("ElementWiseVertex Subtract requires exactly "
                                 f"2 inputs, got {len(inputs)}")
            return inputs[0] - inputs[1], state
        acc = inputs[0]
        for x in inputs[1:]:
            if op in ("add", "average"):
                acc = acc + x
            elif op == "product":
                acc = acc * x
            elif op == "max":
                acc = torch.maximum(acc, x)
            else:
                raise ValueError(f"Unknown ElementWiseVertex op {self.op}")
        if op == "average":
            acc = acc / len(inputs)
        return acc, state


@dataclasses.dataclass(kw_only=True)
class SubsetVertex(GraphVertex):
    """Feature-axis slice [from, to] inclusive."""

    range_from: int = 0
    range_to: int = 0

    def output_type(self, input_types):
        t = input_types[0]
        return InputType(t.kind, t.shape[:-1] + (self.range_to - self.range_from + 1,))

    def apply(self, params, state, inputs, *, train=False, rng=None):
        return inputs[0][..., self.range_from:self.range_to + 1], state


@dataclasses.dataclass(kw_only=True)
class L2NormalizeVertex(GraphVertex):
    """x / ||x||_2 over the non-batch dims."""

    eps: float = 1e-8

    def output_type(self, input_types):
        return input_types[0]

    def apply(self, params, state, inputs, *, train=False, rng=None):
        x = inputs[0]
        norm = torch.sqrt(torch.sum(x * x, dim=tuple(range(1, x.ndim)), keepdim=True))
        return x / torch.clamp(norm, min=self.eps), state


@dataclasses.dataclass(kw_only=True)
class ScaleVertex(GraphVertex):
    """x * scale."""

    scale: float = 1.0

    def output_type(self, input_types):
        return input_types[0]

    def apply(self, params, state, inputs, *, train=False, rng=None):
        return inputs[0] * self.scale, state


@dataclasses.dataclass(kw_only=True)
class ShiftVertex(GraphVertex):
    """x + shift."""

    shift: float = 0.0

    def output_type(self, input_types):
        return input_types[0]

    def apply(self, params, state, inputs, *, train=False, rng=None):
        return inputs[0] + self.shift, state


@dataclasses.dataclass(kw_only=True)
class StackVertex(GraphVertex):
    """Stack along the batch axis."""

    def output_type(self, input_types):
        return input_types[0]

    def apply(self, params, state, inputs, *, train=False, rng=None):
        return torch.cat(inputs, dim=0), state


@dataclasses.dataclass(kw_only=True)
class UnstackVertex(GraphVertex):
    """Batch chunk `from_index` of `stack_size` equal chunks."""

    from_index: int = 0
    stack_size: int = 1

    def output_type(self, input_types):
        return input_types[0]

    def apply(self, params, state, inputs, *, train=False, rng=None):
        x = inputs[0]
        n = x.shape[0] // self.stack_size
        return x[self.from_index * n:(self.from_index + 1) * n], state


@dataclasses.dataclass(kw_only=True)
class ReshapeVertex(GraphVertex):
    """Reshape the non-batch dims; `shape` excludes the batch dimension."""

    shape: Sequence[int] = ()

    def output_type(self, input_types):
        return InputType("feedforward" if len(self.shape) == 1 else
                         input_types[0].kind, tuple(self.shape))

    def apply(self, params, state, inputs, *, train=False, rng=None):
        x = inputs[0]
        return x.reshape((x.shape[0],) + tuple(self.shape)), state


@dataclasses.dataclass(kw_only=True)
class LayerVertex(GraphVertex):
    """Wraps a `Layer` config as a single-input graph vertex."""

    layer: Layer = None

    def initialize(self, gen, input_types, dtype=torch.float32, device=None):
        return self.layer.initialize(gen, input_types[0], dtype, device)

    def apply(self, params, state, inputs, *, train=False, rng=None):
        return self.layer.apply(params, state, inputs[0], train=train, rng=rng)

    def to_json(self) -> dict:
        return {"@vertex": "LayerVertex", "name": self.name,
                "layer": self.layer.to_json()}


VERTEX_REGISTRY = {c.__name__: c for c in [
    MergeVertex, ElementWiseVertex, SubsetVertex, L2NormalizeVertex,
    ScaleVertex, ShiftVertex, StackVertex, UnstackVertex, ReshapeVertex,
    LayerVertex]}


def register_vertex(cls):
    VERTEX_REGISTRY[cls.__name__] = cls
    return cls


# ---------------------------------------------------------------------------
# Configuration + builder
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ComputationGraphConfiguration:
    """DAG config: named inputs, vertices with their input edges, named
    outputs, global defaults.  The JSON round trip is a public contract
    shared with the JAX package."""

    network_inputs: List[str]
    input_types: Dict[str, InputType]
    vertices: Dict[str, GraphVertex]            # insertion order preserved
    vertex_inputs: Dict[str, List[str]]
    network_outputs: List[str]
    seed: int = 0
    updater: IUpdater = dataclasses.field(default_factory=lambda: Sgd(1e-2))
    weight_init: str = "XAVIER"
    activation: Any = "identity"
    l1: float = 0.0
    l2: float = 0.0
    weight_decay: float = 0.0
    dtype: str = "float32"
    compute_dtype: Optional[str] = None   # bf16 compute over f32 params
    remat: bool = False                   # not ported: raises in training
    gradient_normalization: Optional[str] = None
    gradient_normalization_threshold: float = 1.0

    def topological_order(self) -> List[str]:
        """Kahn topological sort over vertex names."""
        indeg = {n: 0 for n in self.vertices}
        children: Dict[str, List[str]] = {n: [] for n in self.vertices}
        for name, ins in self.vertex_inputs.items():
            for src in ins:
                if src in self.vertices:
                    indeg[name] += 1
                    children[src].append(name)
                elif src not in self.network_inputs:
                    raise ValueError(f"Vertex '{name}' input '{src}' unknown")
        order = [n for n in self.vertices if indeg[n] == 0]
        i = 0
        while i < len(order):
            for ch in children[order[i]]:
                indeg[ch] -= 1
                if indeg[ch] == 0:
                    order.append(ch)
            i += 1
        if len(order) != len(self.vertices):
            cyc = set(self.vertices) - set(order)
            raise ValueError(f"Graph has a cycle involving {sorted(cyc)}")
        return order

    def to_json(self) -> str:
        return json.dumps({
            "format": "deeplearning4j_tpu.ComputationGraphConfiguration.v1",
            "network_inputs": self.network_inputs,
            "input_types": {k: v.to_json() for k, v in self.input_types.items()},
            "vertices": {k: v.to_json() for k, v in self.vertices.items()},
            "vertex_inputs": self.vertex_inputs,
            "network_outputs": self.network_outputs,
            "seed": self.seed,
            "updater": self.updater.to_json(),
            "weight_init": self.weight_init,
            "activation": self.activation if isinstance(self.activation, str)
                          else getattr(self.activation, "__name__", "identity"),
            "l1": self.l1, "l2": self.l2, "weight_decay": self.weight_decay,
            "dtype": self.dtype,
            "compute_dtype": self.compute_dtype,
            "remat": self.remat,
            "gradient_normalization": self.gradient_normalization,
            "gradient_normalization_threshold": self.gradient_normalization_threshold,
        }, indent=2)

    @staticmethod
    def from_json(s: str) -> "ComputationGraphConfiguration":
        d = json.loads(s)

        def load_vertex(vd):
            if vd["@vertex"] == "LayerVertex":
                return LayerVertex(name=vd.get("name"),
                                   layer=Layer.from_json(vd["layer"]))
            return GraphVertex.from_json(vd)

        return ComputationGraphConfiguration(
            network_inputs=d["network_inputs"],
            input_types={k: InputType.from_json(v)
                         for k, v in d["input_types"].items()},
            vertices={k: load_vertex(v) for k, v in d["vertices"].items()},
            vertex_inputs={k: list(v) for k, v in d["vertex_inputs"].items()},
            network_outputs=d["network_outputs"],
            seed=d["seed"], updater=IUpdater.from_json(d["updater"]),
            weight_init=d["weight_init"], activation=d["activation"],
            l1=d["l1"], l2=d["l2"], weight_decay=d.get("weight_decay", 0.0),
            dtype=d.get("dtype", "float32"),
            compute_dtype=d.get("compute_dtype"),
            remat=d.get("remat", False),
            gradient_normalization=d.get("gradient_normalization"),
            gradient_normalization_threshold=d.get(
                "gradient_normalization_threshold", 1.0),
        )


class GraphBuilder:
    """Fluent DAG builder."""

    def __init__(self):
        self._inputs: List[str] = []
        self._input_types: Dict[str, InputType] = {}
        self._vertices: Dict[str, GraphVertex] = {}
        self._vertex_inputs: Dict[str, List[str]] = {}
        self._outputs: List[str] = []
        self._seed = 0
        self._updater: IUpdater = Sgd(1e-2)
        self._weight_init = "XAVIER"
        self._activation: Any = "identity"
        self._l1 = 0.0
        self._l2 = 0.0
        self._weight_decay = 0.0
        self._dtype = "float32"
        self._compute_dtype = None
        self._remat = False
        self._grad_norm = None
        self._grad_norm_threshold = 1.0

    # global defaults
    def seed(self, s): self._seed = int(s); return self
    def updater(self, u): self._updater = u; return self
    def weight_init(self, w): self._weight_init = w; return self
    def activation(self, a): self._activation = a; return self
    def l1(self, v): self._l1 = float(v); return self
    def l2(self, v): self._l2 = float(v); return self
    def weight_decay(self, v): self._weight_decay = float(v); return self
    def dtype(self, dt): self._dtype = dt; return self
    def compute_dtype(self, dt): self._compute_dtype = dt; return self

    def gradient_checkpointing(self, on: bool = True):
        self._remat = bool(on); return self

    def gradient_normalization(self, mode, threshold=1.0):
        self._grad_norm = mode; self._grad_norm_threshold = threshold; return self

    # graph topology
    def add_inputs(self, *names: str):
        self._inputs.extend(names); return self

    def set_input_types(self, *types: InputType):
        if len(types) != len(self._inputs):
            raise ValueError(
                f"set_input_types got {len(types)} types for "
                f"{len(self._inputs)} declared inputs (call add_inputs first)")
        for name, t in zip(self._inputs, types):
            self._input_types[name] = t
        return self

    def add_layer(self, name: str, layer: Layer, *inputs: str):
        layer.name = layer.name or name
        return self.add_vertex(name, LayerVertex(layer=layer), *inputs)

    def add_vertex(self, name: str, vertex: GraphVertex, *inputs: str):
        if name in self._vertices or name in self._inputs:
            raise ValueError(f"Duplicate vertex name '{name}'")
        vertex.name = name
        self._vertices[name] = vertex
        self._vertex_inputs[name] = list(inputs)
        return self

    def set_outputs(self, *names: str):
        self._outputs = list(names); return self

    def build(self) -> ComputationGraphConfiguration:
        if not self._outputs:
            raise ValueError("set_outputs(...) is required")
        for name in self._inputs:
            if name not in self._input_types:
                raise ValueError(f"Input '{name}' has no InputType "
                                 "(set_input_types required for shape inference)")
        return ComputationGraphConfiguration(
            network_inputs=self._inputs, input_types=dict(self._input_types),
            vertices=self._vertices, vertex_inputs=self._vertex_inputs,
            network_outputs=self._outputs, seed=self._seed,
            updater=self._updater, weight_init=self._weight_init,
            activation=self._activation, l1=self._l1, l2=self._l2,
            weight_decay=self._weight_decay, dtype=self._dtype,
            compute_dtype=self._compute_dtype,
            remat=self._remat,
            gradient_normalization=self._grad_norm,
            gradient_normalization_threshold=self._grad_norm_threshold)


# ---------------------------------------------------------------------------
# Network
# ---------------------------------------------------------------------------

class ComputationGraph(nn.Module):
    """DAG network: `init`, `fit(features, labels)`, `score`, `score_for`,
    `output(*features)`, `gradient_for`, `params`/`set_params`.  Lives on
    `device` (``"cuda"`` by default, which raises without CUDA unless the
    caller passes ``device="cpu"``)."""

    def __init__(self, conf: ComputationGraphConfiguration, device=None):
        super().__init__()
        self.conf = conf
        self.device = resolve_device(device)
        self.vertices = nn.ModuleDict()
        self.opt_state_: Optional[Dict[str, Any]] = None
        self.iteration = 0
        self.epoch = 0
        self._topo = conf.topological_order()
        self._consumed = {s for ins in conf.vertex_inputs.values() for s in ins}
        self._rng: Optional[torch.Generator] = None
        self._score: Optional[torch.Tensor] = None

    def _layer_of(self, name: str) -> Optional[Layer]:
        v = self.conf.vertices[name]
        return v.layer if isinstance(v, LayerVertex) else None

    def layer_by_name(self, name: str) -> Layer:
        layer = self._layer_of(name)
        if layer is None:
            raise KeyError(f"vertex {name!r} is not a layer")
        return layer

    # ---- init ----
    def init(self) -> "ComputationGraph":
        dtype = torch_dtype(self.conf.dtype)
        types: Dict[str, InputType] = dict(self.conf.input_types)
        gen = torch.Generator(device=self.device).manual_seed(self.conf.seed)
        for name in self._topo:
            vertex = self.conf.vertices[name]
            layer = self._layer_of(name)
            if layer is not None:
                if layer.weight_init is None:
                    layer.weight_init = self.conf.weight_init
                if layer.activation is None and not hasattr(layer, "loss"):
                    layer.activation = self.conf.activation
            in_types = [types[s] for s in self.conf.vertex_inputs[name]]
            p, s, out_t = vertex.initialize(gen, in_types, dtype, self.device)
            holder = nn.Module()
            for k, v in p.items():
                holder.register_parameter(k, nn.Parameter(v))
            for k, v in s.items():
                holder.register_buffer(k, v)
            self.vertices[name] = holder
            types[name] = out_t
        self._rng = torch.Generator(device=self.device).manual_seed(self.conf.seed)
        self.opt_state_ = {name: self._updater_for(name).init_state(self.params_[name])
                           for name in self._topo}
        return self

    @property
    def params_(self) -> Params:
        """{vertex name: {param key: Parameter}}, the JAX tree's shape
        (vertices without parameters map to {})."""
        if self._rng is None:
            raise RuntimeError("call init() first")
        return {name: dict(self.vertices[name]._parameters) for name in self._topo}

    @property
    def state_(self) -> Params:
        """{vertex name: {state key: tensor}}: BatchNormalization's running
        mean and var (buffers), {} elsewhere."""
        if self._rng is None:
            raise RuntimeError("call init() first")
        return {name: dict(self.vertices[name]._buffers) for name in self._topo}

    @torch.no_grad()
    def _set_state(self, new_state: Params) -> None:
        for name, sub in new_state.items():
            bufs = self.vertices[name]._buffers
            for k, v in sub.items():
                if v is not bufs[k]:
                    bufs[k].copy_(v)

    def _updater_for(self, name: str) -> IUpdater:
        layer = self._layer_of(name)
        if layer is not None and layer.updater is not None:
            return layer.updater
        return self.conf.updater

    # ---- forward ----
    def _forward(self, params: Params, state: Params, inputs: Dict[str, Any],
                 *, train: bool, rng: Optional[torch.Generator],
                 want_head_inputs: bool = False):
        """Run the DAG; returns every vertex's activation and the new state
        (plus, when `want_head_inputs`, the input of each loss head; a head
        whose activation no vertex consumes is then not run)."""
        if train and self.conf.remat:
            raise NotImplementedError(
                "gradient checkpointing (remat) is not ported yet")
        cd = self.conf.compute_dtype
        if cd is not None:
            dt = torch_dtype(cd)

            def cast(a):
                return a.to(dt) if a.is_floating_point() else a
            params = {n: {k: cast(v) for k, v in p.items()} for n, p in params.items()}
            inputs = {k: cast(v) for k, v in inputs.items()}
        acts: Dict[str, torch.Tensor] = dict(inputs)
        head_inputs: Dict[str, torch.Tensor] = {}
        new_state = dict(state)
        for name in self._topo:
            vertex = self.conf.vertices[name]
            layer = self._layer_of(name)
            vrng = rng if (rng is not None and layer is not None
                           and layer.STOCHASTIC) else None
            xs = [acts[s] for s in self.conf.vertex_inputs[name]]
            if (want_head_inputs and name in self.conf.network_outputs
                    and layer is not None and hasattr(layer, "compute_loss")):
                head_inputs[name] = xs[0]
                if name not in self._consumed:
                    continue
            acts[name], new_state[name] = vertex.apply(
                params[name], state[name], xs, train=train, rng=vrng)
        if want_head_inputs:
            return acts, new_state, head_inputs
        return acts, new_state

    def _loss(self, params: Params, state: Params, inputs: Dict[str, Any],
              labels: List[Any], rng, labels_masks: Optional[List[Any]] = None,
              train: bool = True) -> Tuple[torch.Tensor, Params]:
        """Summed loss over all output heads + regularization."""
        acts, new_state, head_inputs = self._forward(
            params, state, inputs, train=train, rng=rng, want_head_inputs=True)
        loss = 0.0
        for j, name in enumerate(self.conf.network_outputs):
            layer = self._layer_of(name)
            if layer is None or not hasattr(layer, "compute_loss"):
                raise ValueError(f"Output vertex '{name}' is not a loss head")
            lmask = labels_masks[j] if labels_masks else None
            lrng = rng if layer.STOCHASTIC else None
            loss = loss + layer.compute_loss(
                params[name], state[name], head_inputs[name], labels[j],
                train=train, rng=lrng, mask=lmask)
        return loss + self._reg_penalty(params), new_state

    def _reg_penalty(self, params: Params):
        penalty = 0.0
        for name in self._topo:
            layer = self._layer_of(name)
            if layer is None:
                continue
            l1 = layer.l1 if layer.l1 is not None else self.conf.l1
            l2 = layer.l2 if layer.l2 is not None else self.conf.l2
            if l1 == 0.0 and l2 == 0.0:
                continue
            rmask = layer.regularizable_mask(params[name])
            for w in _masked_leaves(params[name], rmask):
                if l1:
                    penalty = penalty + l1 * torch.sum(torch.abs(w))
                if l2:
                    penalty = penalty + 0.5 * l2 * torch.sum(w * w)
        return penalty

    def _grads(self, loss: torch.Tensor, params: Params) -> Params:
        """d loss / d params by autograd, zeros where a parameter does not
        reach the loss (as jax.grad gives)."""
        leaves = [(n, k, p) for n in self._topo for k, p in params[n].items()]
        got = torch.autograd.grad(loss, [p for _, _, p in leaves],
                                  allow_unused=True) if leaves else ()
        grads: Params = {n: {} for n in self._topo}
        for (n, k, p), g in zip(leaves, got):
            grads[n][k] = torch.zeros_like(p) if g is None else g
        return grads

    # ---- one training step ----
    def _fit_batch(self, inputs: Dict[str, torch.Tensor],
                   labels: List[torch.Tensor], lmasks=None) -> None:
        conf = self.conf
        params = self.params_
        loss, new_state = self._loss(params, self.state_, inputs, labels,
                                     self._rng, lmasks)
        grads = self._grads(loss, params)
        it, ep = self.iteration, self.epoch
        with torch.no_grad():
            for name in self._topo:
                layer = self._layer_of(name)
                if not params[name] or (layer is not None and layer.frozen):
                    continue
                g = grads[name]
                own = layer is not None and layer.gradient_normalization is not None
                gn = layer.gradient_normalization if own else conf.gradient_normalization
                if gn:
                    thr = (layer.gradient_normalization_threshold if own
                           else conf.gradient_normalization_threshold)
                    g = apply_gradient_normalization(g, gn, thr)
                upd_cfg = self._updater_for(name)
                upd, self.opt_state_[name] = upd_cfg.apply(
                    self.opt_state_[name], g, it, ep, params=params[name])
                wd = (layer.weight_decay if layer is not None and
                      layer.weight_decay is not None else conf.weight_decay)
                if wd and layer is not None:
                    lr = upd_cfg.lr_at(it, ep)
                    upd = _add_scaled_where(upd, params[name],
                                            layer.regularizable_mask(params[name]),
                                            lr * wd)
                tree_map(lambda p, u: p.sub_(u), params[name], upd)
        self._set_state(new_state)
        self._score = loss.detach()
        self.iteration += 1

    # ---- public API ----
    def _as_input_dict(self, features) -> Dict[str, torch.Tensor]:
        if isinstance(features, dict):
            return {k: torch.as_tensor(v, device=self.device)
                    for k, v in features.items()}
        if not isinstance(features, (list, tuple)):
            features = [features]
        return {n: torch.as_tensor(f, device=self.device)
                for n, f in zip(self.conf.network_inputs, features)}

    def _as_list(self, labels) -> List[torch.Tensor]:
        if not isinstance(labels, (list, tuple)):
            labels = [labels]
        return [torch.as_tensor(l, device=self.device) for l in labels]

    def fit(self, features, labels=None) -> "ComputationGraph":
        """One training step on one batch: fit(features, labels), single-
        or multi-input/output (lists, or a dict of inputs by name)."""
        if labels is None:
            raise NotImplementedError(
                "fit over an iterator is not ported yet; call "
                "fit(features, labels) per batch")
        self._fit_batch(self._as_input_dict(features), self._as_list(labels))
        return self

    def score(self) -> float:
        """The most recent minibatch loss (blocks until it is computed)."""
        return float(self._score) if self._score is not None else float("nan")

    @torch.no_grad()
    def score_for(self, features, labels) -> float:
        loss, _ = self._loss(self.params_, self.state_,
                             self._as_input_dict(features),
                             self._as_list(labels), None, train=False)
        return float(loss)

    @torch.inference_mode()
    def output(self, *features, train: bool = False) -> List[torch.Tensor]:
        """Inference outputs in `network_outputs` order, as tensors on the
        network's device (`train=True` uses batch statistics and updates
        no state)."""
        if len(features) == 1 and isinstance(features[0], (list, tuple, dict)):
            features = features[0]
        else:
            features = list(features)
        acts, _ = self._forward(self.params_, self.state_,
                                self._as_input_dict(features), train=train,
                                rng=None)
        return [acts[n] for n in self.conf.network_outputs]

    def gradient_for(self, features, labels) -> Params:
        """Analytic gradients {vertex: {key: tensor}} in the port's layouts,
        in eval mode (running BN statistics, no dropout), as the JAX
        package's `gradient_for`."""
        params = self.params_
        loss, _ = self._loss(params, self.state_, self._as_input_dict(features),
                             self._as_list(labels), None, train=False)
        return self._grads(loss, params)

    # ---- flat-param view (JAX tree_leaves order) ----
    def num_params(self) -> int:
        return sum(p.numel() for p in self.parameters())

    def params(self) -> np.ndarray:
        return convert.flat_params(self)

    def set_params(self, flat: np.ndarray) -> None:
        convert.set_flat_params(self, flat)
