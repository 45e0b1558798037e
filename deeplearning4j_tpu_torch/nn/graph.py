"""ComputationGraph: the arbitrary-DAG model (the port of ``nn/graph.py``).

The vertices, the configuration, its builder and its JSON are the JAX
package's, field for field, so ``ComputationGraphConfiguration.to_json()``
is the same string in both packages.  The network is an ``nn.Module``: one
submodule per vertex under ``vertices`` holds that vertex's parameters
(``nn.Parameter``s named after the JAX tree, in the port's layouts) and its
layer state as buffers (BatchNormalization's running ``mean``/``var``).
``params()``/``set_params()`` keep the JAX flat order (``tree_leaves``:
vertex names, then keys, sorted as strings).

One step body serves every training entry point, as in
``MultiLayerNetwork``: the summed loss of the output heads (each with its
labels mask) plus the l1/l2 penalty is differentiated by autograd (in
place of ``jax.value_and_grad``), then each vertex's updater runs in
topological order and its update is subtracted from the parameters in
place under ``torch.no_grad()`` (``nn.multilayer.apply_updates``); the
layer state, the updater state and the int32 iteration counter on the
device are written in place too.  ``fit(features, labels)`` runs the body
once, eagerly; ``fit_steps`` runs k of them as one CUDA-graph replay on
the card (``utils/scan_fit.py``); ``fit(iterator, epochs, fused_steps)``
steps per batch or in staged blocks.  Under ``compute_dtype="bfloat16"``
the forward runs on bf16 casts of the f32 master parameters, so the
gradients reach the f32 parameters.  Dropout masks come from a
``torch.Generator`` seeded from the configuration seed.  A fitted
normalizer per input (``set_normalizer``) runs inside the step, ``output``
and ``score_for``.  Listeners hear of each step (once a fused block) and
epoch.  ``save``/``load`` write and read the ModelSerializer zip
(``utils/serialization.py``).

``set_gradient_sharing`` splits the step around a host exchange across a
gang of processes, as ``MultiLayerNetwork``'s does (``nn.multilayer.
shared_step``); the blocks of ``fit_steps`` then run step by step.

Not ported yet: the executable cache, compile schedules and gradient
checkpointing (``remat``).  ``evaluate`` takes
single-output graphs, as in the JAX package.
"""
from __future__ import annotations

import dataclasses
import json
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from deeplearning4j_tpu_torch import convert
from deeplearning4j_tpu_torch.monitor.instrument import TrainingInstruments
from deeplearning4j_tpu_torch.monitor.spans import span
from deeplearning4j_tpu_torch.nn.core import InputType, Layer
from deeplearning4j_tpu_torch.parallel.sharding import whole
from deeplearning4j_tpu_torch.nn.multilayer import (apply_updates, block_tensor,
                                                    copy_into, grads_of, holder_of,
                                                    reg_penalty, shared_step,
                                                    step_gradients, step_loss, tree_of,
                                                    torch_dtype)
from deeplearning4j_tpu_torch.train.updaters import IUpdater, Sgd, tree_leaves, tree_map
from deeplearning4j_tpu_torch.utils import data_parallel
from deeplearning4j_tpu_torch.utils.counters import advance, device_counters
from deeplearning4j_tpu_torch.utils.data_parallel import penalty_share
from deeplearning4j_tpu_torch.utils.devices import resolve_device
from deeplearning4j_tpu_torch.utils.scan_fit import GraphStep, _at, check_steps_axes

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
    """DAG network: `init`, `fit(features, labels | iterator)`,
    `fit_steps`, `score`/`score_array`/`score_for`, `output(*features)`,
    `feed_forward`, `gradient_for`, `evaluate`, `set_normalizer`,
    `set_listeners`, `params`/`set_params`, `save`/`load`.  Lives on
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
        self.listeners: List[Any] = []
        self._instr: Optional[TrainingInstruments] = None
        self._device_norm: Dict[str, Any] = {}
        self._scan_step: Optional[GraphStep] = None
        self._dp = None                  # parallel/wrapper.py
        self._step_transform = None      # parallel/zero.py
        self._tp = None                  # parallel/sharding.py
        self._grad_sharing = None        # parallel/hierarchical.py

    def _instruments(self) -> TrainingInstruments:
        if self._instr is None:
            self._instr = TrainingInstruments(type(self).__name__)
        return self._instr

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
            self.vertices[name] = holder_of(p, s)
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
        return {name: tree_of(self.vertices[name]) for name in self._topo}

    @property
    def state_(self) -> Params:
        """{vertex name: {state key: tensor}}: BatchNormalization's running
        mean and var (buffers), {} elsewhere."""
        if self._rng is None:
            raise RuntimeError("call init() first")
        return {name: tree_of(self.vertices[name], "_buffers") for name in self._topo}

    @torch.no_grad()
    def _set_state(self, new_state: Params) -> None:
        copy_into(self.state_, new_state)

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
            params = tree_map(cast, params)
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
            if self._tp is not None and layer is not None:
                acts[name], new_state[name] = self._tp.apply(
                    name, layer, params[name], state[name], xs[0], train=train, rng=vrng)
            else:
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
            kw = dict(train=train, rng=lrng, mask=lmask)
            if self._tp is not None:
                loss = loss + self._tp.compute_loss(name, layer, params[name], state[name],
                                                    head_inputs[name], labels[j], **kw)
            else:
                loss = loss + layer.compute_loss(params[name], state[name],
                                                 head_inputs[name], labels[j], **kw)
        return loss + penalty_share(self._reg_penalty(params)), new_state

    def _named_layers(self):
        return [(name, self._layer_of(name)) for name in self._topo]

    def _reg_penalty(self, params: Params):
        return reg_penalty(self.conf, self._named_layers(), params,
                           None if self._tp is None else self._tp.penalty_reduce(params))

    # ---- one training step ----
    def _carry(self) -> List[torch.Tensor]:
        """The tensors a step writes in place: parameters, layer state,
        updater state and the iteration counter."""
        return (list(tree_leaves(self.params_)) + list(tree_leaves(self.state_))
                + [t for t in tree_leaves(self.opt_state_) if isinstance(t, torch.Tensor)]
                + [device_counters(self)[0]])

    def _batch(self, inputs: Dict[str, torch.Tensor], labels: List[torch.Tensor],
               lmasks) -> List[Optional[torch.Tensor]]:
        """One step's tensors in a fixed order: the network inputs, the
        labels and the labels masks (None where a head has none)."""
        n_out = len(self.conf.network_outputs)
        return ([inputs[n] for n in self.conf.network_inputs] + list(labels)
                + (list(lmasks) if lmasks else [None] * n_out))

    def _grads(self, batch):
        """The grad half on `_batch`'s list: forward and backward, the
        gradients summed over a data-parallel group; (gradients, loss, new
        layer state), nothing written."""
        n_in, n_out = len(self.conf.network_inputs), len(self.conf.network_outputs)
        inputs = self._apply_device_norm(dict(zip(self.conf.network_inputs, batch[:n_in])))
        labels = list(batch[n_in:n_in + n_out])
        lm = batch[n_in + n_out:]
        lmasks = None if all(m is None for m in lm) else list(lm)
        params = self.params_
        with data_parallel.active(self._dp):
            loss, new_state = self._loss(params, self.state_, inputs, labels,
                                         self._rng, lmasks)
        return step_gradients(self, loss, params), loss, new_state

    def _train_tick(self, carry, epoch, batch) -> torch.Tensor:
        """One step body on `_batch`'s list; every result is written into
        the tensor it replaces, the iteration counter included; returns
        the loss."""
        params = self.params_
        grads, loss, new_state = self._grads(batch)
        apply_updates(self.conf, self._named_layers(), params, grads,
                      self.opt_state_, self._updater_for, self._iter_dev, epoch,
                      self._step_transform, tp=self._tp)
        self._set_state(new_state)
        with torch.no_grad():
            self._iter_dev.add_(1)
        return step_loss(self, loss)

    def _fit_batch(self, inputs: Dict[str, torch.Tensor],
                   labels: List[torch.Tensor], lmasks=None) -> None:
        t0 = time.perf_counter()
        _, epoch = device_counters(self)
        batch = self._batch(inputs, labels, lmasks)
        if self._grad_sharing is not None:
            loss = shared_step(self, batch)
        else:
            loss = self._train_tick(None, epoch, batch)
        self._instruments().record_dispatch(time.perf_counter() - t0)
        self._score = loss
        self._last_batch_size = int(next(iter(inputs.values())).shape[0])
        advance(self)
        for lst in self.listeners:
            lst.iteration_done(self, self.iteration, self.epoch)

    def _get_scan_step(self) -> GraphStep:
        if self._scan_step is None:
            self._scan_step = GraphStep(self._train_tick)
        return self._scan_step

    def fit_steps(self, features, labels, labels_masks=None) -> torch.Tensor:
        """Run k training steps as one block (one CUDA-graph replay on the
        card); every array in `features`/`labels`/`labels_masks` carries a
        leading `[k, batch]` steps axis (a stride-0 ``broadcast_to`` view
        included).  The same math as k sequential `fit` calls; listeners
        fire once per block.  Returns the k losses as a fresh device
        tensor."""
        if isinstance(features, dict):
            inputs = {n: block_tensor(a, self.device) for n, a in features.items()}
        else:
            if not isinstance(features, (list, tuple)):
                features = [features]
            inputs = {n: block_tensor(a, self.device)
                      for n, a in zip(self.conf.network_inputs, features)}
        if not isinstance(labels, (list, tuple)):
            labels = [labels]
        labels = [block_tensor(l, self.device) for l in labels]
        if labels_masks is not None and not isinstance(labels_masks, (list, tuple)):
            labels_masks = [labels_masks]
        lmasks = (None if labels_masks is None
                  else [block_tensor(m, self.device) for m in labels_masks])
        k = check_steps_axes(
            [(f"input '{n}'", a) for n, a in inputs.items()]
            + [(f"label {i}", l) for i, l in enumerate(labels)]
            + [(f"labels_mask {i}", m) for i, m in enumerate(lmasks or [])])
        return self._fit_block(self._batch(inputs, labels, lmasks), int(k),
                               int(next(iter(inputs.values())).shape[1]))

    def _fit_block(self, block, k: int, batch_n: int) -> torch.Tensor:
        """One block of k steps through the graph step; `block` is
        `_batch`'s list with, per entry, None, a stacked `[k, ...]` tensor
        or a list of k per-step tensors (copied straight into the graph's
        input buffers).  With gradient sharing on, the k steps run one by
        one through the split step."""
        if self._grad_sharing is not None:
            n_in = len(self.conf.network_inputs)
            n_out = len(self.conf.network_outputs)
            losses = []
            for i in range(k):
                b = [_at(e, i) for e in block]
                lm = b[n_in + n_out:]
                self._fit_batch(dict(zip(self.conf.network_inputs, b[:n_in])),
                                b[n_in:n_in + n_out],
                                None if all(m is None for m in lm) else lm)
                losses.append(self._score)
            return torch.stack(losses)
        step = self._get_scan_step()
        _, epoch = device_counters(self)
        t0 = time.perf_counter()
        losses = step(self._carry(), epoch, block,
                      key=tuple(sorted((n, id(d)) for n, d in self._device_norm.items())),
                      generator=self._rng)
        ins = self._instruments()
        ins.record_dispatch(time.perf_counter() - t0, steps=k)
        ins.check_compile(step, self)
        self._score = losses[-1]
        self._last_batch_size = batch_n
        advance(self, k)
        for lst in self.listeners:
            lst.iteration_done(self, self.iteration, self.epoch)
        return losses

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

    def _masks(self, lmasks) -> Optional[List[Optional[torch.Tensor]]]:
        if lmasks is None:
            return None
        if not isinstance(lmasks, (list, tuple)):
            lmasks = [lmasks]
        return [None if m is None else torch.as_tensor(m, device=self.device)
                for m in lmasks]

    def fit(self, data, labels=None, *, epochs: int = 1,
            fused_steps: Optional[int] = None) -> "ComputationGraph":
        """fit(features, labels) for one batch (single- or multi-input and
        output: lists, or a dict of inputs by name), or fit(iterator,
        epochs=N): `reset()` the iterator each epoch, one step per DataSet
        (its `labels_mask`, one or a list per head, reaches the loss), then
        count the epoch and call each listener's `on_epoch_end`.

        `fused_steps=k` fuses blocks of k consecutive same-shape batches,
        staged on the device and stacked there, into `fit_steps`; tails and
        shape changes step one by one (the same math either way)."""
        if labels is not None:
            if fused_steps not in (None, 1):
                raise ValueError(
                    "fused_steps applies to the iterator form only; for a "
                    "pre-stacked [k, batch, ...] block call fit_steps")
            self._fit_batch(self._as_input_dict(data), self._as_list(labels))
            return self
        fused_steps = fused_steps or 1
        for _ in range(epochs):
            if hasattr(data, "reset"):
                data.reset()
            with span("fit_epoch", model=type(self).__name__):
                if fused_steps > 1:
                    self._fit_epoch_fused(data, fused_steps)
                else:
                    for ds in data:
                        self._fit_dataset(ds)
            self.epoch += 1
            self._instruments().record_epoch()
            for lst in self.listeners:
                if hasattr(lst, "on_epoch_end"):
                    lst.on_epoch_end(self)
        return self

    def _fit_dataset(self, ds) -> None:
        self._fit_batch(self._as_input_dict(ds.features), self._as_list(ds.labels),
                        self._masks(getattr(ds, "labels_mask", None)))

    def _fit_epoch_fused(self, iterator, k: int) -> None:
        """Blocks of k batches staged on the device
        (`data.pipeline.device_blocks`), each loaded into the graph's input
        buffers; tails, shape changes and blocks that mix masked and
        unmasked batches step one by one."""
        from deeplearning4j_tpu_torch.data.pipeline import device_blocks
        for kind, payload in device_blocks(iterator, k, device=self.device):
            if kind == "single":
                self._fit_dataset(payload)
                continue
            xs, ys, _, lms = payload
            feats = [self._as_input_dict(x) for x in xs]
            labs = [self._as_list(y) for y in ys]
            masks = None if lms is None else [self._masks(m) for m in lms]
            self._fit_block(
                self._batch({n: [f[n] for f in feats] for n in feats[0]},
                            [[l[i] for l in labs] for i in range(len(labs[0]))],
                            None if masks is None else
                            [None if masks[0][i] is None else [m[i] for m in masks]
                             for i in range(len(masks[0]))]),
                len(feats), int(next(iter(feats[0].values())).shape[0]))

    def set_gradient_sharing(self, sharing) -> "ComputationGraph":
        """Gang gradient sharing on or off, as
        ``MultiLayerNetwork.set_gradient_sharing``."""
        from deeplearning4j_tpu_torch.parallel.hierarchical import as_runtime
        self._grad_sharing = as_runtime(sharing, self._grad_sharing)
        return self

    @property
    def gradient_sharing(self):
        """The installed ``HierarchicalAllReduce``, or None."""
        return self._grad_sharing

    def score(self) -> float:
        """The most recent minibatch loss (blocks until it is computed)."""
        return float(self._score) if self._score is not None else float("nan")

    def score_array(self) -> Optional[torch.Tensor]:
        """The most recent minibatch loss as a device tensor (None before
        the first step); never waits for the card."""
        return self._score

    def _apply_device_norm(self, inputs: Dict[str, Any]) -> Dict[str, Any]:
        """Each normalized input (f32, as the host transform gives it) in
        the graph's dtype, as the JAX package's promotion gives it."""
        if not self._device_norm:
            return inputs
        dt = torch_dtype(self.conf.dtype)
        return {n: (self._device_norm[n].apply_features(a).to(dt)
                    if n in self._device_norm else a)
                for n, a in inputs.items()}

    def set_normalizer(self, normalizers) -> "ComputationGraph":
        """Fold fitted normalizers into the training step, `output` and
        `score_for` as an on-device prologue.  `normalizers` is
        `{input_name: normalizer}` (a bare normalizer applies to every
        network input), or None to clear.  Labels pass through untouched
        (the MultiNormalizer features-only contract).  Captured fused
        steps are dropped."""
        from deeplearning4j_tpu_torch.data.pipeline import DeviceNormalizer
        if normalizers is None:
            self._device_norm = {}
        else:
            if not isinstance(normalizers, dict):
                normalizers = {n: normalizers for n in self.conf.network_inputs}
            unknown = set(normalizers) - set(self.conf.network_inputs)
            if unknown:
                raise ValueError(f"unknown network inputs: {sorted(unknown)}")
            self._device_norm = {n: DeviceNormalizer.from_host(nz, self.device)
                                 for n, nz in normalizers.items()}
        self._scan_step = None
        return self

    def set_listeners(self, *listeners) -> "ComputationGraph":
        """Listeners (``train/listeners.py``) hear of each step through
        `iteration_done(model, iteration, epoch)`, and of each epoch
        through `on_epoch_end(model)` if they have it."""
        self.listeners = list(listeners)
        return self

    @torch.no_grad()
    def score_for(self, features, labels) -> float:
        loss, _ = self._loss(self.params_, self.state_,
                             self._apply_device_norm(self._as_input_dict(features)),
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
                                self._apply_device_norm(self._as_input_dict(features)),
                                train=train, rng=None)
        return [acts[n] for n in self.conf.network_outputs]

    @torch.inference_mode()
    def feed_forward(self, *features, train: bool = False) -> Dict[str, torch.Tensor]:
        """Every vertex's activation (and each input) by name, without
        dropout and without the normalizer, as the JAX package's."""
        if len(features) == 1 and isinstance(features[0], (list, tuple, dict)):
            features = features[0]
        else:
            features = list(features)
        with whole(self):
            acts, _ = self._forward(self.params_, self.state_,
                                    self._as_input_dict(features), train=train, rng=None)
        return acts

    def evaluate(self, iterator, evaluation=None):
        """Classification evaluation of a single-output graph over an
        iterator (a multi-output graph raises `ValueError`: run `output`
        and feed an `Evaluation` per head)."""
        if len(self.conf.network_outputs) != 1:
            raise ValueError(
                "evaluate() requires a single-output graph; this one has "
                f"{self.conf.network_outputs} — use output() + Evaluation "
                "per head")
        from deeplearning4j_tpu_torch.train.evaluation import Evaluation
        ev = evaluation or Evaluation()
        if hasattr(iterator, "reset"):
            iterator.reset()
        for ds in iterator:
            labels = ds.labels if isinstance(ds.labels, (list, tuple)) else [ds.labels]
            ev.eval(labels[0], self.output(ds.features)[0])
        return ev

    def gradient_for(self, features, labels) -> Params:
        """Analytic gradients {vertex: {key: tensor}} in the port's layouts,
        in eval mode (running BN statistics, no dropout), as the JAX
        package's `gradient_for`."""
        with whole(self):
            params = self.params_
            loss, _ = self._loss(params, self.state_, self._as_input_dict(features),
                                 self._as_list(labels), None, train=False)
            return grads_of(loss, params)

    # ---- flat-param view (JAX tree_leaves order) ----
    def num_params(self) -> int:
        with whole(self):
            return sum(p.numel() for p in self.parameters())

    def state_dict(self, *args, **kwargs):
        """``nn.Module.state_dict`` with whole leaves under tensor
        parallelism (collective there: every rank calls it)."""
        with whole(self):
            return super().state_dict(*args, **kwargs)

    def params(self) -> np.ndarray:
        return convert.flat_params(self)

    def set_params(self, flat: np.ndarray) -> None:
        convert.set_flat_params(self, flat)

    # ---- persistence (the ModelSerializer zip) ----
    def save(self, path: str, save_updater: bool = True) -> None:
        from deeplearning4j_tpu_torch.utils.serialization import write_model
        with whole(self):
            write_model(self, path, save_updater=save_updater)

    @staticmethod
    def load(path: str, load_updater: bool = True,
             device=None) -> "ComputationGraph":
        from deeplearning4j_tpu_torch.utils.serialization import read_model
        return read_model(path, load_updater=load_updater, device=device)
