"""MultiLayerNetwork: the sequential-stack model (the port of
``nn/multilayer.py``).

The configuration, its builder and its JSON are the JAX package's, field
for field, so ``MultiLayerConfiguration.to_json()`` is the same string in
both packages.  The network is an ``nn.Module`` whose parameters are named
after the JAX parameter tree: ``state_dict()`` keys are ``layer_0.W``,
``layer_0.b``, ... and map one to one onto ``params_["layer_0"]["W"]`` of
the JAX network (layouts per ``convert.py``).  ``params()``/``set_params()``
keep the JAX flat order, which is ``jax.tree_util.tree_leaves`` order: dict
keys sorted as strings (``layer_10`` before ``layer_2``, ``W`` before
``b``), each leaf raveled in its JAX layout (a conv ``W`` in HWIO).

Randomness comes from an explicit ``torch.Generator`` seeded from the
config seed; the network lives on the ``device`` it is given (``"cuda"``
by default).

One step body serves every training entry point.  The loss (the output
head's, plus the l1/l2 penalty) is differentiated by autograd in place of
``jax.value_and_grad``; then ``apply_updates`` runs each layer's gradient
normalization, updater and decoupled weight decay, and subtracts the
update from the parameters in place under ``torch.no_grad()``, as the JAX
step does layer by layer.  The body writes every result into the tensor it
replaces: parameters, updater state, layer state and the iteration counter
(an int32 tensor on the device, ``utils/counters.py``, from which the
learning rate and the bias corrections are computed).  ``fit(x, y)`` runs
it once, eagerly; ``fit_steps`` runs k of them as one CUDA-graph replay on
the card (``utils/scan_fit.py``), and ``fit(iterator, fused_steps=k)``
feeds it staged blocks (``data/pipeline.py``).  ``ComputationGraph`` runs
the same helpers.  The step never waits for the card: the loss stays a
device tensor (``score_array``) until ``score()`` reads it.  Dropout masks
come from a second generator on the network's device, seeded from the
config seed (Philox: the masks match the JAX package's in distribution
only); a CUDA graph registers it, so each replay draws fresh masks.
``remat`` recomputes each layer's forward in the backward
(``torch.utils.checkpoint``), with the same dropout masks.
``set_normalizer`` folds a fitted normalizer into the step, ``output``,
``score_for`` and ``gradient_for``.

``evaluate`` runs ``output`` per batch of an iterator and feeds an
``Evaluation`` (``train/evaluation.py``); listeners
(``train/listeners.py``) hear of every step (once a fused block) and
epoch.

``parallel.ParallelWrapper`` trains a network data-parallel: it installs
a data-parallel step (``utils/data_parallel.py``, ``_dp``) that makes the
loss means and BatchNorm's statistics global and sums the gradients over
the group between the backward and ``apply_updates``, and, with
``optimizer_sharding``, the ZeRO-1 transform (``parallel/zero.py``,
``_step_transform``) that ``apply_updates`` threads through each layer.
Without a wrapper both are None and the step is unchanged.

``set_gradient_sharing`` (``parallel/hierarchical.py``) splits the step in
two around a host-side exchange across a gang of hosts: the grad half
(``_grads``: forward, backward, the data-parallel sum; under ZeRO-1 the
reduce-scatter, ``Zero1Transform.reduce_scatter``), then
``exchange_gradients`` (the tree in the JAX layouts to the host, through
the host's leader where the wrapper's mesh holds more than one rank,
combined over the gang, back in the port's layouts), then the apply half
(``apply_updates`` on the combined gradient: normalization sees the whole
gradient, as JAX's apply half does).  That path runs eagerly, step by
step: a host exchange cannot sit inside a CUDA-graph capture, so
``fit_steps`` and ``fit(iterator, fused_steps=k)`` run their k steps one
by one while sharing is on (listeners then hear of every step).  Without
sharing the step, its bits and its graph are unchanged.

Not ported yet, and raising ``NotImplementedError``:
``set_executable_cache`` and ``apply_schedule``.
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
from deeplearning4j_tpu_torch.train.updaters import (
    IUpdater, Sgd, StepScalars, apply_gradient_normalization, scalar_dtype,
    tree_leaves, tree_map)
from deeplearning4j_tpu_torch.utils import data_parallel
from deeplearning4j_tpu_torch.utils.counters import advance, device_counters
from deeplearning4j_tpu_torch.utils.data_parallel import DataParallelStep, penalty_share
from deeplearning4j_tpu_torch.utils.devices import resolve_device
from deeplearning4j_tpu_torch.utils.scan_fit import GraphStep, _at, check_steps_axes

Params = Dict[str, Dict[str, torch.Tensor]]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float64": torch.float64, "float16": torch.float16}


def torch_dtype(name: str) -> torch.dtype:
    if name not in _DTYPES:
        raise ValueError(f"unsupported dtype {name!r}; want one of {sorted(_DTYPES)}")
    return _DTYPES[name]


def _masked_leaves(params, mask):
    """Yield param leaves where the layer's regularizable_mask is True
    (mask may mark whole subtrees)."""
    if isinstance(mask, dict):
        for k, m in mask.items():
            yield from _masked_leaves(params[k], m)
    elif mask:
        yield from tree_leaves(params)


def _add_scaled_where(upd, params, mask, scale):
    """upd + scale * params wherever mask is True (decoupled weight decay)."""
    if isinstance(mask, dict):
        return {k: _add_scaled_where(upd[k], params[k], mask[k], scale)
                for k in upd}
    if mask:
        return tree_map(lambda u, p: u + scale * p, upd, params)
    return upd


def reg_penalty(conf, layers, params, reduce=None):
    """The l1/l2 penalty the score includes: l1 * sum|w| + 0.5 * l2 * sum
    w^2 over each layer's regularizable parameters (a layer's own l1/l2
    over the configuration's).  `layers` yields (name, layer or None).
    `reduce(w, term)` (tensor parallelism) sums a leaf's terms over the
    ranks that hold its blocks."""
    penalty = 0.0
    for name, layer in layers:
        if layer is None:
            continue
        l1 = layer.l1 if layer.l1 is not None else conf.l1
        l2 = layer.l2 if layer.l2 is not None else conf.l2
        if l1 == 0.0 and l2 == 0.0:
            continue
        for w in _masked_leaves(params[name], layer.regularizable_mask(params[name])):
            if l1:
                term = l1 * torch.sum(torch.abs(w))
                penalty = penalty + (term if reduce is None else reduce(w, term))
            if l2:
                term = 0.5 * l2 * torch.sum(w * w)
                penalty = penalty + (term if reduce is None else reduce(w, term))
    return penalty


def holder_of(params: Dict, state: Optional[Dict] = None) -> nn.Module:
    """A module holding one layer's parameter tree as Parameters and, where
    given, its state tree as buffers; a nested dict (Bidirectional's
    ``fwd`` and ``bwd``) becomes a submodule of that name, so state_dict
    keys follow the JAX tree (``layer_0.fwd.W``)."""
    m = nn.Module()
    state = state or {}
    for k, v in params.items():
        if isinstance(v, dict):
            m.add_module(k, holder_of(v, state.get(k)))
        else:
            m.register_parameter(k, nn.Parameter(v))
    for k, v in state.items():
        if not isinstance(v, dict):     # a nested state sits with its params
            m.register_buffer(k, v)
    return m


def tree_of(m: nn.Module, attr: str = "_parameters") -> Dict:
    """The tree a `holder_of` module holds: its Parameters
    (``"_parameters"``) or its buffers (``"_buffers"``), nested by
    submodule."""
    out = dict(getattr(m, attr))
    for k, c in m._modules.items():
        out[k] = tree_of(c, attr)
    return out


def grads_of(loss: torch.Tensor, params) -> Dict:
    """d loss / d params by autograd, as a tree of the params' shape, with
    zeros where a parameter does not reach the loss (as jax.grad gives)."""
    leaves = list(tree_leaves(params))
    got = torch.autograd.grad(loss, leaves, allow_unused=True) if leaves else ()
    by_id = {id(p): g for p, g in zip(leaves, got)}
    return tree_map(lambda p: torch.zeros_like(p) if by_id[id(p)] is None
                    else by_id[id(p)], params)


def step_gradients(net, loss: torch.Tensor, params) -> Dict:
    """A training step's gradients: `grads_of`, then, in a data-parallel
    step (``net._dp``), summed over the group (the leaves ZeRO-1
    reduce-scatters itself are left to it)."""
    grads = grads_of(loss, params)
    if net._dp is None:
        return grads
    zt = net._step_transform
    return net._dp.reduce_gradients(grads, skip=zt.scattered if zt is not None else ())


def step_loss(net, loss: torch.Tensor) -> torch.Tensor:
    """The loss a step reports: the global mean in a data-parallel step."""
    return loss.detach() if net._dp is None else net._dp.global_loss(loss)


def copy_into(dst, src) -> None:
    """Write each tensor of tree `src` into the tensor of tree `dst` at
    the same place, in place, so carried state keeps its addresses."""
    if isinstance(dst, dict):
        for k, d in dst.items():
            copy_into(d, src[k])
    elif isinstance(dst, torch.Tensor) and dst is not src:
        dst.copy_(src)


@torch.no_grad()
def apply_updates(conf, layers, params, grads, opt_state, updater_for,
                  iteration, epoch, zero=None, prescattered: bool = False,
                  tp=None) -> None:
    """One optimizer step over every layer, in place: the JAX step's
    per-layer loop.  `layers` yields (name, layer or None: a graph vertex
    without one); a frozen layer, or one without parameters, is left as
    it is, updater state included.  Each other layer's gradient goes
    through its gradient normalization (the layer's own, else the
    configuration's), then its updater (`updater_for(name)`), then gains
    the decoupled weight decay lr * coeff * w on its regularizable
    parameters, and is subtracted from the parameters.  The updater
    writes its state in place.  `iteration` and `epoch` are the step's
    int32 counter tensors (``utils/counters.py``); each distinct updater's
    scalars are computed from them once.  `zero` is the ZeRO-1 transform
    (``parallel/zero.py``) where the weight update is sharded: after the
    gradient normalization it scatters the gradient, the updater and the
    weight decay run on this rank's shard, and the new shards are gathered
    into the parameters; with `prescattered` (a split step's apply half)
    the leaves ZeRO-1 reduce-scatters arrive as their shards already.
    `tp`, the tensor-parallel transform (``parallel/sharding.py``),
    normalizes a layer with split leaves over its whole gradient."""
    scalars = StepScalars(iteration, epoch, scalar_dtype(params))
    for name, layer in layers:
        if not params[name] or (layer is not None and layer.frozen):
            continue
        g = grads[name]
        own = layer is not None and layer.gradient_normalization is not None
        gn = layer.gradient_normalization if own else conf.gradient_normalization
        if gn:
            thr = (layer.gradient_normalization_threshold if own
                   else conf.gradient_normalization_threshold)
            g = (apply_gradient_normalization(g, gn, thr) if tp is None
                 else tp.normalized(name, g, gn, thr))
        view = params[name]
        if zero is not None:
            g = zero.scatter(name, g, reduced=prescattered)
            view = zero.update_view(name, view)
        upd_cfg = updater_for(name)
        s = scalars.of(upd_cfg)
        upd, _ = upd_cfg.apply(opt_state[name], g, iteration, epoch,
                               params=view, scalars=s)
        wd = (layer.weight_decay if layer is not None and layer.weight_decay
              is not None else conf.weight_decay)
        if wd and layer is not None:
            upd = _add_scaled_where(upd, view, layer.regularizable_mask(view),
                                    s["lr"] * wd)
        if zero is None:
            tree_map(lambda p, u: p.sub_(u), params[name], upd)
        else:
            zero.restore(name, params[name], view, upd)


def block_tensor(a, device) -> Optional[torch.Tensor]:
    """A [k, ...] block on `device`.  A host array whose steps axis has
    stride 0 (``np.broadcast_to``) crosses as one step and is broadcast
    again on the device."""
    if a is None or isinstance(a, torch.Tensor):
        return None if a is None else a.to(device)
    a = np.asarray(a)
    if a.ndim and a.shape[0] > 1 and a.strides[0] == 0:
        return torch.as_tensor(a[0].copy(), device=device).expand(a.shape)
    return torch.as_tensor(a, device=device)


def exchange_gradients(net, grads) -> Dict:
    """The host exchange of a split step: `grads` (the grad half's tree)
    viewed in the JAX package's layouts, combined over the gang by
    ``net._grad_sharing.exchange`` and put back on the device in the
    port's layouts and the gradients' dtypes, each leaf contiguous.
    Under ZeRO-1 a reduce-scattered leaf is its shard, which is in the JAX
    layout already.  In a data-parallel step over more than one rank the
    wrapper's mesh is the host (``hierarchical.HostLink``): its leader
    gathers the shards into the padded leaves, and a ZeRO-1-sharded leaf
    the step all-reduced whole crosses padded too, so the leader's tree is
    the JAX host's."""
    from deeplearning4j_tpu_torch.parallel.hierarchical import host_link
    zt = net._step_transform
    skip = zt.scattered if zt is not None else frozenset()
    host = host_link(net._dp.mesh) if net._dp is not None else None

    def padded(name, path):
        if zt is None or host is None or (name, ".".join(path)) in skip:
            return 0
        pl = zt.plans[name]
        for k in path:
            pl = pl[k]
        return pl.pad if pl.kind == "shard" else 0

    def views(tree, name, layout, path=()):
        if isinstance(tree, dict):
            return {k: views(v, name, layout, path + (k,)) for k, v in tree.items()}
        if (name, ".".join(path)) in skip:
            return tree
        v = convert.jax_view(layout, path[-1], tree)
        pad = padded(name, path)
        return v if not pad else torch.cat([v, v.new_zeros((pad,) + tuple(v.shape[1:]))])

    def marks(tree, name, path=()):
        if isinstance(tree, dict):
            return {k: marks(v, name, path + (k,)) for k, v in tree.items()}
        return (name, ".".join(path)) in skip

    def back(tree, got, name, layout, path=()):
        if isinstance(tree, dict):
            return {k: back(v, got[k], name, layout, path + (k,)) for k, v in tree.items()}
        t = got if isinstance(got, torch.Tensor) else torch.as_tensor(np.asarray(got, np.float32))
        t = t.to(tree.device, tree.dtype)
        pad = padded(name, path)
        if pad:
            t = t[:t.shape[0] - pad]
        perm = None if (name, ".".join(path)) in skip else layout.TORCH_LAYOUT.get(path[-1])
        return t.contiguous() if perm is None else t.permute(*perm).contiguous()

    layouts = {name: convert._layer_or_layout(net, name) for name in grads}
    tree = {name: views(g, name, layouts[name]) for name, g in grads.items()}
    combined = (net._grad_sharing.exchange(tree) if host is None else
                net._grad_sharing.exchange(tree, host,
                                           {name: marks(g, name) for name, g in grads.items()}))
    return {name: back(g, combined[name], name, layouts[name]) for name, g in grads.items()}


def shared_step(net, batch) -> torch.Tensor:
    """One training step of a MultiLayerNetwork or ComputationGraph with
    gradient sharing on: the grad half (``net._grads``; under ZeRO-1 the
    reduce-scatter of the leaves it shards), the layer state written, the
    exchange, then the apply half and the counter.  Returns the step's
    loss (the global mean in a data-parallel step)."""
    grads, loss, new_state = net._grads(batch)
    zt = net._step_transform
    if zt is not None:
        grads = {name: zt.reduce_scatter(name, g) for name, g in grads.items()}
    with torch.no_grad():
        copy_into(net.state_, new_state)
    loss = step_loss(net, loss)
    combined = exchange_gradients(net, grads)
    _, epoch = device_counters(net)
    apply_updates(net.conf, net._named_layers(), net.params_, combined, net.opt_state_,
                  net._updater_for, net._iter_dev, epoch, zt, prescattered=True,
                  tp=net._tp)
    with torch.no_grad():
        net._iter_dev.add_(1)
    return loss


def _not_ported(what: str):
    raise NotImplementedError(f"{what} is not ported yet")


# ---------------------------------------------------------------------------
# Configuration
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class MultiLayerConfiguration:
    """Sequential config: ordered layer configs + global defaults.  The
    JSON round trip is a public contract shared with the JAX package."""

    layers: List[Layer]
    input_type: InputType
    seed: int = 0
    updater: IUpdater = dataclasses.field(default_factory=lambda: Sgd(1e-2))
    weight_init: str = "XAVIER"
    activation: Any = "identity"
    l1: float = 0.0
    l2: float = 0.0
    weight_decay: float = 0.0
    dtype: str = "float32"
    # bf16 compute path: params stay `dtype`, activations + layer params are
    # cast to compute_dtype inside the forward
    compute_dtype: Optional[str] = None
    gradient_normalization: Optional[str] = None
    gradient_normalization_threshold: float = 1.0
    remat: bool = False

    def layer_name(self, i: int) -> str:
        return self.layers[i].name or f"layer_{i}"

    def to_json(self) -> str:
        return json.dumps({
            "format": "deeplearning4j_tpu.MultiLayerConfiguration.v1",
            "layers": [l.to_json() for l in self.layers],
            "input_type": self.input_type.to_json(),
            "seed": self.seed,
            "updater": self.updater.to_json(),
            "weight_init": self.weight_init,
            "activation": self.activation if isinstance(self.activation, str)
                          else getattr(self.activation, "__name__", "identity"),
            "l1": self.l1, "l2": self.l2, "weight_decay": self.weight_decay,
            "dtype": self.dtype,
            "compute_dtype": self.compute_dtype,
            "gradient_normalization": self.gradient_normalization,
            "gradient_normalization_threshold": self.gradient_normalization_threshold,
            "remat": self.remat,
        }, indent=2)

    @staticmethod
    def from_json(s: str) -> "MultiLayerConfiguration":
        d = json.loads(s)
        return MultiLayerConfiguration(
            layers=[Layer.from_json(l) for l in d["layers"]],
            input_type=InputType.from_json(d["input_type"]),
            seed=d["seed"],
            updater=IUpdater.from_json(d["updater"]),
            weight_init=d["weight_init"],
            activation=d["activation"],
            l1=d["l1"], l2=d["l2"], weight_decay=d.get("weight_decay", 0.0),
            dtype=d.get("dtype", "float32"),
            compute_dtype=d.get("compute_dtype"),
            gradient_normalization=d.get("gradient_normalization"),
            gradient_normalization_threshold=d.get("gradient_normalization_threshold", 1.0),
            remat=d.get("remat", False),
        )


class NeuralNetConfiguration:
    """Fluent builder mirroring `NeuralNetConfiguration.Builder` ->
    `.list()` -> `.build()`."""

    class Builder:
        def __init__(self):
            self._seed = 0
            self._updater: IUpdater = Sgd(1e-2)
            self._weight_init = "XAVIER"
            self._activation: Any = "identity"
            self._l1 = 0.0
            self._l2 = 0.0
            self._weight_decay = 0.0
            self._dtype = "float32"
            self._compute_dtype = None
            self._grad_norm = None
            self._grad_norm_threshold = 1.0
            self._input_type: Optional[InputType] = None
            self._remat = False

        def seed(self, s: int):
            self._seed = int(s); return self

        def updater(self, u: IUpdater):
            self._updater = u; return self

        def weight_init(self, w: str):
            self._weight_init = w; return self

        def activation(self, a):
            self._activation = a; return self

        def l1(self, v: float):
            self._l1 = float(v); return self

        def l2(self, v: float):
            self._l2 = float(v); return self

        def weight_decay(self, v: float):
            self._weight_decay = float(v); return self

        def dtype(self, dt: str):
            self._dtype = dt; return self

        def compute_dtype(self, dt: str):
            self._compute_dtype = dt; return self

        def gradient_normalization(self, mode: str, threshold: float = 1.0):
            self._grad_norm = mode; self._grad_norm_threshold = threshold; return self

        def gradient_checkpointing(self, on: bool = True):
            self._remat = bool(on); return self

        def set_input_type(self, it: InputType):
            self._input_type = it; return self

        def list(self, layers: Sequence[Layer]) -> "NeuralNetConfiguration.ListBuilder":
            return NeuralNetConfiguration.ListBuilder(self, list(layers))

    class ListBuilder:
        def __init__(self, parent: "NeuralNetConfiguration.Builder", layers: List[Layer]):
            self.parent = parent
            self.layers = layers

        def set_input_type(self, it: InputType):
            self.parent._input_type = it; return self

        def build(self) -> MultiLayerConfiguration:
            p = self.parent
            if p._input_type is None:
                raise ValueError("set_input_type(...) is required (shape inference)")
            return MultiLayerConfiguration(
                layers=self.layers, input_type=p._input_type, seed=p._seed,
                updater=p._updater, weight_init=p._weight_init,
                activation=p._activation, l1=p._l1, l2=p._l2,
                weight_decay=p._weight_decay, dtype=p._dtype,
                compute_dtype=p._compute_dtype,
                gradient_normalization=p._grad_norm,
                gradient_normalization_threshold=p._grad_norm_threshold,
                remat=p._remat,
            )

    @staticmethod
    def builder() -> "NeuralNetConfiguration.Builder":
        return NeuralNetConfiguration.Builder()


# ---------------------------------------------------------------------------
# Network
# ---------------------------------------------------------------------------

class MultiLayerNetwork(nn.Module):
    """Sequential network: `init`, `fit(x, y | iterator)`, `output`,
    `feed_forward`, `score`/`score_array`/`score_for`, `gradient_for`,
    `evaluate`, `params`/`set_params`, `save`/`load`.

    One submodule per layer, named by `conf.layer_name(i)`, holds that
    layer's parameters; layers without parameters hold none."""

    def __init__(self, conf: MultiLayerConfiguration, device=None):
        super().__init__()
        self.conf = conf
        self.device = resolve_device(device)
        self.state_: Optional[Dict[str, Dict]] = None
        self.opt_state_: Optional[Dict[str, Any]] = None
        self.iteration = 0
        self.epoch = 0
        self.listeners: List[Any] = []
        self._rng: Optional[torch.Generator] = None
        self._score: Optional[torch.Tensor] = None
        self._instr: Optional[TrainingInstruments] = None
        self._layer_types: List[InputType] = []
        self._device_norm = None
        self._scan_step: Optional[GraphStep] = None
        self._dp: Optional[DataParallelStep] = None      # parallel/wrapper.py
        self._step_transform = None                      # parallel/zero.py
        self._grad_sharing = None                        # parallel/hierarchical.py
        self._tp = None                                  # parallel/sharding.py

    def _instruments(self) -> TrainingInstruments:
        if self._instr is None:
            self._instr = TrainingInstruments(type(self).__name__)
        return self._instr

    # ---- init ----
    def init(self) -> "MultiLayerNetwork":
        dtype = torch_dtype(self.conf.dtype)
        it = self.conf.input_type
        gen = torch.Generator(device=self.device).manual_seed(self.conf.seed)
        self._layer_types = [it]
        state = {}
        for i, layer in enumerate(self.conf.layers):
            if layer.weight_init is None:
                layer.weight_init = self.conf.weight_init
            if layer.activation is None and not hasattr(layer, "loss"):
                layer.activation = self.conf.activation
            p, s, it = layer.initialize(gen, it, dtype, self.device)
            name = self.conf.layer_name(i)
            self.add_module(name, holder_of(p))
            state[name] = s
            self._layer_types.append(it)
        self.state_ = state
        self._rng = torch.Generator(device=self.device).manual_seed(self.conf.seed)
        self.opt_state_ = self._init_opt_state(self.params_)
        return self

    @property
    def params_(self) -> Params:
        """{layer name: {param key: Parameter}}, the JAX tree's shape
        (nested where the JAX tree is: Bidirectional's ``fwd``/``bwd``)."""
        if self.state_ is None:
            raise RuntimeError("call init() first")
        return {self.conf.layer_name(i): tree_of(getattr(self, self.conf.layer_name(i)))
                for i in range(len(self.conf.layers))}

    def layer_by_name(self, name: str) -> Layer:
        for i, layer in enumerate(self.conf.layers):
            if self.conf.layer_name(i) == name:
                return layer
        raise KeyError(name)

    def _named_layers(self):
        return [(self.conf.layer_name(i), layer)
                for i, layer in enumerate(self.conf.layers)]

    def _updater_for(self, name: str) -> IUpdater:
        layer = self.layer_by_name(name)
        return layer.updater if layer.updater is not None else self.conf.updater

    def _init_opt_state(self, params: Params) -> Dict[str, Any]:
        return {name: self._updater_for(name).init_state(params[name])
                for name, _ in self._named_layers()}

    # ---- forward ----
    def _cast_compute(self, params: Params, x: torch.Tensor):
        """Mixed precision: with `compute_dtype`, cast params and a floating
        input to it.  Without, a floating input is cast to the network's
        `dtype` (the port computes in the network's dtype; it does not
        promote)."""
        cd = self.conf.compute_dtype
        dt = torch_dtype(cd if cd is not None else self.conf.dtype)
        if cd is not None:
            params = tree_map(lambda v: v.to(dt) if v.is_floating_point() else v, params)
        if x.is_floating_point():
            x = x.to(dt)
        return params, x

    def _forward(self, params: Params, state: Dict, x: torch.Tensor, *,
                 train: bool = False, rng: Optional[torch.Generator] = None,
                 mask: Optional[torch.Tensor] = None,
                 upto: Optional[int] = None) -> Tuple[torch.Tensor, Dict]:
        """Layers [0, upto) (all by default).  In train mode a STOCHASTIC
        layer draws its dropout mask from `rng`; a [B, T] `mask` reaches
        each layer until one leaves sequence space or changes the sequence
        length."""
        params, x = self._cast_compute(params, x)
        new_state = dict(state)
        n = len(self.conf.layers) if upto is None else upto
        for i in range(n):
            layer = self.conf.layers[i]
            name = self.conf.layer_name(i)
            lrng = rng if (rng is not None and layer.STOCHASTIC) else None
            if self.conf.remat and train:
                x, new_state[name] = self._checkpointed(
                    name, layer, params[name], state[name], x, lrng, mask)
            else:
                x, new_state[name] = self._apply_layer(name, layer, params[name], state[name],
                                                       x, train=train, rng=lrng, mask=mask)
            if mask is not None and self._layer_types:
                t_in, t_out = self._layer_types[i], self._layer_types[i + 1]
                if (t_out.kind != "recurrent"
                        or (t_in.kind == "recurrent"
                            and t_in.shape[0] != t_out.shape[0])):
                    mask = None
        return x, new_state

    def _apply_layer(self, name, layer, p, s, x, **kw):
        """Layer `name`'s forward, through the tensor-parallel transform
        where the network has one."""
        if self._tp is not None:
            return self._tp.apply(name, layer, p, s, x, **kw)
        return layer.apply(p, s, x, **kw)

    def _checkpointed(self, name, layer, p, s, x, rng, mask):
        """One layer under `torch.utils.checkpoint`: its activations are
        recomputed in the backward.  Dropout draws from a copy of `rng`
        made before the layer, so the recomputation draws the same mask;
        `rng` then moves on as if the layer had drawn from it."""
        from torch.utils.checkpoint import checkpoint
        start = None if rng is None else rng.get_state()
        used = []

        def run(p_, s_, x_, m_):
            g = None
            if start is not None:
                g = torch.Generator(device=self.device)
                g.set_state(start)
            used.append(g)
            return self._apply_layer(name, layer, p_, s_, x_, train=True, rng=g, mask=m_)

        out = checkpoint(run, p, s, x, mask, use_reentrant=False)
        if rng is not None:
            rng.set_state(used[0].get_state())
        return out

    def _loss(self, params: Params, state: Dict, x, y, rng,
              features_mask=None, labels_mask=None, train: bool = True):
        """Score = the head's data loss + the l1/l2 penalty.
        `features_mask` feeds the forward, `labels_mask` the loss."""
        out_idx = len(self.conf.layers) - 1
        head = self.conf.layers[out_idx]
        if not hasattr(head, "compute_loss"):
            raise ValueError("Last layer must be an OutputLayer/LossLayer")
        h, new_state = self._forward(params, state, x, train=train, rng=rng,
                                     mask=features_mask, upto=out_idx)
        name = self.conf.layer_name(out_idx)
        hp, h = self._cast_compute({name: params[name]}, h)   # bf16 head too
        kw = dict(train=train, rng=rng if head.STOCHASTIC else None, mask=labels_mask)
        if self._tp is not None:
            loss = self._tp.compute_loss(name, head, hp[name], state[name], h, y, **kw)
        else:
            loss = head.compute_loss(hp[name], state[name], h, y, **kw)
        return loss + penalty_share(self._reg_penalty(params)), new_state

    def _reg_penalty(self, params: Params):
        return reg_penalty(self.conf, self._named_layers(), params,
                           None if self._tp is None else self._tp.penalty_reduce(params))

    def _tensor(self, a) -> Optional[torch.Tensor]:
        return None if a is None else torch.as_tensor(a, device=self.device)

    # ---- one training step ----
    def _carry(self) -> List[torch.Tensor]:
        """The tensors a step writes in place: parameters, layer state,
        updater state and the iteration counter."""
        return (list(tree_leaves(self.params_))
                + [t for t in tree_leaves(self.state_) if isinstance(t, torch.Tensor)]
                + [t for t in tree_leaves(self.opt_state_) if isinstance(t, torch.Tensor)]
                + [device_counters(self)[0]])

    def _grads(self, batch):
        """The grad half on batch [x, y, features mask, labels mask]:
        forward and backward, the gradients summed over a data-parallel
        group; (gradients, loss, new layer state), nothing written."""
        x, y, fmask, lmask = batch
        if self._device_norm is not None:
            x = self._device_norm.apply_features(x)
            y = self._device_norm.apply_labels(y)
        params = self.params_
        with data_parallel.active(self._dp):
            loss, new_state = self._loss(params, self.state_, x, y, self._rng,
                                         fmask, lmask)
        return step_gradients(self, loss, params), loss, new_state

    def _train_tick(self, carry, epoch, batch) -> torch.Tensor:
        """One step body on batch [x, y, features mask, labels mask]:
        every result is written into the tensor it replaces (``carry``),
        the iteration counter included; returns the loss."""
        params = self.params_
        grads, loss, new_state = self._grads(batch)
        apply_updates(self.conf, self._named_layers(), params, grads,
                      self.opt_state_, self._updater_for, self._iter_dev, epoch,
                      self._step_transform, tp=self._tp)
        with torch.no_grad():
            copy_into(self.state_, new_state)
            self._iter_dev.add_(1)
        return step_loss(self, loss)

    def _fit_batch(self, x, y, fmask=None, lmask=None) -> None:
        t0 = time.perf_counter()
        _, epoch = device_counters(self)
        if self._grad_sharing is not None:
            loss = shared_step(self, [x, y, fmask, lmask])
        else:
            loss = self._train_tick(None, epoch, [x, y, fmask, lmask])
        self._instruments().record_dispatch(time.perf_counter() - t0)
        self._score = loss
        self._last_batch_size = int(x.shape[0])
        advance(self)
        for lst in self.listeners:
            lst.iteration_done(self, self.iteration, self.epoch)

    def _get_scan_step(self) -> GraphStep:
        if self._scan_step is None:
            self._scan_step = GraphStep(self._train_tick)
        return self._scan_step

    def fit_steps(self, xs, ys, features_masks=None, labels_masks=None):
        """Run `k` training steps as one block: one CUDA-graph replay on
        the card, the same body k times on the CPU.

        Two input forms: stacked `[k, batch, ...]` arrays with a leading
        steps axis (a stride-0 ``broadcast_to`` view included), or lists of
        `k` per-step `[batch, ...]` arrays (the staged prefetch path),
        copied into the graph's input buffers on the device.  The same
        math as `k` sequential `fit(x, y)` calls; listeners fire once per
        block.  Returns the k losses as a fresh device tensor.  With
        gradient sharing on, the k steps run one by one through the split
        step (listeners fire each step)."""
        if isinstance(xs, (list, tuple)):
            k = len(xs)
            if not (isinstance(ys, (list, tuple)) and len(ys) == k):
                raise ValueError("list-form fit_steps needs xs and ys as "
                                 f"equal-length lists, got {k} xs / "
                                 f"{'non-list' if not isinstance(ys, (list, tuple)) else len(ys)} ys")

            def steps(ms, what):
                if ms is None:
                    return None
                if len(ms) != k or any(m is None for m in ms):
                    raise ValueError(f"list-form fit_steps needs {what} for "
                                     f"all {k} steps or none")
                return [self._tensor(m) for m in ms]

            block = [[self._tensor(a) for a in xs], [self._tensor(a) for a in ys],
                     steps(features_masks, "features_masks"),
                     steps(labels_masks, "labels_masks")]
            batch_n = int(block[0][0].shape[0])
        else:
            block = [block_tensor(a, self.device)
                     for a in (xs, ys, features_masks, labels_masks)]
            check_steps_axes(zip(("xs", "ys", "features_masks", "labels_masks"), block))
            k = int(block[0].shape[0])
            batch_n = int(block[0].shape[1])
        if self._grad_sharing is not None:
            losses = []
            for i in range(k):
                self._fit_batch(*[_at(e, i) for e in block])
                losses.append(self._score)
            return torch.stack(losses)
        step = self._get_scan_step()
        _, epoch = device_counters(self)
        t0 = time.perf_counter()
        losses = step(self._carry(), epoch, block, key=(id(self._device_norm),),
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
    def fit(self, data, labels=None, *, epochs: int = 1, features_mask=None,
            labels_mask=None, fused_steps: Optional[int] = None):
        """fit(x, y) for one batch, or fit(iterator, epochs=N): `reset()`
        the iterator each epoch, one step per DataSet, then count the
        epoch and call each listener's `on_epoch_end`.

        `fused_steps=k` trains blocks of k consecutive same-shape batches,
        staged on the device (`data.pipeline.device_blocks`), through
        `fit_steps`; tails and batches whose shape differs from their
        block take the per-step path, so results equal `fused_steps=1`'s
        up to listener cadence."""
        if labels is not None:
            if fused_steps not in (None, 1):
                raise ValueError(
                    "fused_steps applies to the iterator form only; for a "
                    "pre-stacked [k, batch, ...] block call fit_steps(xs, ys)")
            self._fit_batch(self._tensor(data), self._tensor(labels),
                            self._tensor(features_mask), self._tensor(labels_mask))
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
        self._fit_batch(self._tensor(ds.features), self._tensor(ds.labels),
                        self._tensor(getattr(ds, "features_mask", None)),
                        self._tensor(getattr(ds, "labels_mask", None)))

    def _fit_epoch_fused(self, iterator, k: int) -> None:
        """Blocks of k staged batches through `fit_steps`' list form;
        tails, shape changes and mixed-mask blocks step one by one."""
        from deeplearning4j_tpu_torch.data.pipeline import device_blocks
        for kind, payload in device_blocks(iterator, k, device=self.device):
            if kind == "single":
                self._fit_dataset(payload)
            else:
                self.fit_steps(*payload)

    def set_normalizer(self, normalizer) -> "MultiLayerNetwork":
        """Fold a fitted normalizer (NormalizerStandardize / MinMaxScaler /
        ImagePreProcessingScaler, or a DeviceNormalizer) into the training
        step, `output`, `score_for` and `gradient_for` as an on-device
        prologue, in place of host-side `set_pre_processor` ETL.  None
        clears it.  Captured fused steps are dropped."""
        from deeplearning4j_tpu_torch.data.pipeline import DeviceNormalizer
        self._device_norm = (None if normalizer is None
                             else DeviceNormalizer.from_host(normalizer, self.device))
        self._scan_step = None
        return self

    def _normalized(self, x, y=None):
        if self._device_norm is None:
            return x, y
        return (self._device_norm.apply_features(x),
                self._device_norm.apply_labels(y))

    def set_gradient_sharing(self, sharing) -> "MultiLayerNetwork":
        """Turn gang gradient sharing on or off: a
        ``HierarchicalGradientSharing`` config (the runtime is built here),
        a prebuilt ``HierarchicalAllReduce``, or None to clear (the
        replaced runtime's sockets are closed).  While on, every training
        step is the split step (``shared_step``)."""
        from deeplearning4j_tpu_torch.parallel.hierarchical import as_runtime
        self._grad_sharing = as_runtime(sharing, self._grad_sharing)
        return self

    @property
    def gradient_sharing(self):
        """The installed ``HierarchicalAllReduce``, or None."""
        return self._grad_sharing

    def set_executable_cache(self, cache):
        _not_ported("set_executable_cache (the compiled-step cache)")

    def apply_schedule(self, schedule):
        _not_ported("apply_schedule (compile schedules)")

    def evaluate(self, iterator, evaluation=None):
        """Classification evaluation over an iterator: `reset()` it, run
        `output` on each batch's features and feed `evaluation` (a new
        `Evaluation` by default) the labels and outputs."""
        from deeplearning4j_tpu_torch.train.evaluation import Evaluation
        ev = evaluation or Evaluation()
        if hasattr(iterator, "reset"):
            iterator.reset()
        for ds in iterator:
            ev.eval(ds.labels, self.output(ds.features))
        return ev

    def score(self) -> float:
        """Loss of the most recent minibatch; reading it waits for the
        step to finish."""
        return float(self._score) if self._score is not None else float("nan")

    def score_array(self) -> Optional[torch.Tensor]:
        """Loss of the most recent minibatch as a device tensor (None before
        the first step); never waits for the card."""
        return self._score

    @torch.no_grad()
    def score_for(self, x, y, features_mask=None, labels_mask=None) -> float:
        """Score on given data without updating, in eval mode (no dropout,
        BN running statistics)."""
        x, y = self._normalized(self._tensor(x), self._tensor(y))
        loss, _ = self._loss(self.params_, self.state_, x, y, None,
                             self._tensor(features_mask),
                             self._tensor(labels_mask), train=False)
        return float(loss)

    @torch.inference_mode()
    def output(self, x, train: bool = False) -> torch.Tensor:
        """Inference forward pass; `x` (numpy or tensor, NHWC for image
        models) moves to the network's device.  Returns a tensor there."""
        x, _ = self._normalized(self._tensor(x))
        return self._forward(self.params_, self.state_, x, train=train)[0]

    @torch.inference_mode()
    def feed_forward(self, x, train: bool = False) -> List[torch.Tensor]:
        """Every layer's activation, the input first, on the master
        parameters (no compute-dtype cast) and without dropout."""
        with whole(self):
            return self._feed_forward(x, train)

    def _feed_forward(self, x, train: bool) -> List[torch.Tensor]:
        acts = [self._tensor(x)]
        h = acts[0]
        if h.is_floating_point():
            h = h.to(torch_dtype(self.conf.dtype))
        params = self.params_
        for name, layer in self._named_layers():
            h, _ = layer.apply(params[name], self.state_[name], h, train=train)
            acts.append(h)
        return acts

    def gradient_for(self, x, y, features_mask=None, labels_mask=None) -> Params:
        """Analytic gradients {layer: {key: tensor}} of the score, in the
        port's layouts, in eval mode (consistent with `score_for`)."""
        with whole(self):
            return self._gradient_for(x, y, features_mask, labels_mask)

    def _gradient_for(self, x, y, features_mask, labels_mask) -> Params:
        params = self.params_
        x, y = self._normalized(self._tensor(x), self._tensor(y))
        loss, _ = self._loss(params, self.state_, x, y, None,
                             self._tensor(features_mask),
                             self._tensor(labels_mask), train=False)
        return grads_of(loss, params)

    def set_listeners(self, *listeners) -> "MultiLayerNetwork":
        """Listeners (``train/listeners.py``, or any object with
        `iteration_done(model, iteration, epoch)`) hear of each step, and
        of each epoch through `on_epoch_end(model)` if they have it."""
        self.listeners = list(listeners)
        return self

    def add_listeners(self, *listeners) -> "MultiLayerNetwork":
        self.listeners.extend(listeners)
        return self

    # ---- flat-param view (JAX tree_leaves order) ----
    def _jax_leaves(self) -> List[Tuple[str, str]]:
        return convert.jax_leaves(self.params_)

    def num_params(self) -> int:
        with whole(self):
            return sum(p.numel() for p in self.parameters())

    def state_dict(self, *args, **kwargs):
        """``nn.Module.state_dict`` with whole leaves under tensor
        parallelism (collective there: every rank calls it)."""
        with whole(self):
            return super().state_dict(*args, **kwargs)

    def params(self) -> np.ndarray:
        """Single flat parameter vector in the JAX package's order and
        layouts."""
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
             device=None) -> "MultiLayerNetwork":
        from deeplearning4j_tpu_torch.utils.serialization import read_model
        return read_model(path, load_updater=load_updater, device=device)
