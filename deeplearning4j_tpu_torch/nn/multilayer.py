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

Training runs eagerly: one ``fit(x, y)`` is one step.  The loss (the
output head's, plus the l1/l2 penalty) is differentiated by autograd in
place of ``jax.value_and_grad``; then ``apply_updates`` runs each layer's
gradient normalization, updater and decoupled weight decay, and subtracts
the update from the parameters in place under ``torch.no_grad()``, as the
JAX step does layer by layer.  ``ComputationGraph`` runs the same helper.
The step never waits for the card: the loss stays a device tensor
(``score_array``) until ``score()`` reads it.  Dropout masks come from a
second generator on the network's device, seeded from the config seed
(Philox: the masks match the JAX package's in distribution only).
``remat`` recomputes each layer's forward in the backward
(``torch.utils.checkpoint``), with the same dropout masks.

``evaluate`` runs ``output`` per batch of an iterator and feeds an
``Evaluation`` (``train/evaluation.py``); listeners
(``train/listeners.py``) hear of every step and epoch.

Not ported yet, and raising ``NotImplementedError``: ``fit_steps`` and
``fused_steps > 1``, ``set_normalizer``, ``set_gradient_sharing``,
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
from deeplearning4j_tpu_torch.train.updaters import (
    IUpdater, Sgd, apply_gradient_normalization, tree_leaves, tree_map)
from deeplearning4j_tpu_torch.utils.devices import resolve_device

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


def reg_penalty(conf, layers, params):
    """The l1/l2 penalty the score includes: l1 * sum|w| + 0.5 * l2 * sum
    w^2 over each layer's regularizable parameters (a layer's own l1/l2
    over the configuration's).  `layers` yields (name, layer or None)."""
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
                penalty = penalty + l1 * torch.sum(torch.abs(w))
            if l2:
                penalty = penalty + 0.5 * l2 * torch.sum(w * w)
    return penalty


def grads_of(loss: torch.Tensor, params) -> Dict:
    """d loss / d params by autograd, as a tree of the params' shape, with
    zeros where a parameter does not reach the loss (as jax.grad gives)."""
    leaves = [(n, k, p) for n in params for k, p in params[n].items()]
    got = torch.autograd.grad(loss, [p for _, _, p in leaves],
                              allow_unused=True) if leaves else ()
    grads: Dict = {n: {} for n in params}
    for (n, k, p), g in zip(leaves, got):
        grads[n][k] = torch.zeros_like(p) if g is None else g
    return grads


@torch.no_grad()
def apply_updates(conf, layers, params, grads, opt_state, updater_for,
                  iteration: int, epoch: int) -> None:
    """One optimizer step over every layer, in place: the JAX step's
    per-layer loop.  `layers` yields (name, layer or None: a graph vertex
    without one); a frozen layer, or one without parameters, is left as
    it is, updater state included.  Each other layer's gradient goes
    through its gradient normalization (the layer's own, else the
    configuration's), then its updater (`updater_for(name)`), then gains
    the decoupled weight decay lr * coeff * w on its regularizable
    parameters, and is subtracted from the parameters."""
    for name, layer in layers:
        if not params[name] or (layer is not None and layer.frozen):
            continue
        g = grads[name]
        own = layer is not None and layer.gradient_normalization is not None
        gn = layer.gradient_normalization if own else conf.gradient_normalization
        if gn:
            thr = (layer.gradient_normalization_threshold if own
                   else conf.gradient_normalization_threshold)
            g = apply_gradient_normalization(g, gn, thr)
        upd_cfg = updater_for(name)
        upd, opt_state[name] = upd_cfg.apply(opt_state[name], g, iteration,
                                             epoch, params=params[name])
        wd = (layer.weight_decay if layer is not None and layer.weight_decay
              is not None else conf.weight_decay)
        if wd and layer is not None:
            lr = upd_cfg.lr_at(iteration, epoch)
            upd = _add_scaled_where(upd, params[name],
                                    layer.regularizable_mask(params[name]),
                                    lr * wd)
        tree_map(lambda p, u: p.sub_(u), params[name], upd)


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
            holder = nn.Module()
            for k, v in p.items():
                holder.register_parameter(k, nn.Parameter(v))
            name = self.conf.layer_name(i)
            self.add_module(name, holder)
            state[name] = s
            self._layer_types.append(it)
        self.state_ = state
        self._rng = torch.Generator(device=self.device).manual_seed(self.conf.seed)
        self.opt_state_ = self._init_opt_state(self.params_)
        return self

    @property
    def params_(self) -> Params:
        """{layer name: {param key: Parameter}}, the JAX tree's shape."""
        if self.state_ is None:
            raise RuntimeError("call init() first")
        return {self.conf.layer_name(i): dict(
                    getattr(self, self.conf.layer_name(i))._parameters)
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
            params = {n: {k: (v.to(dt) if v.is_floating_point() else v)
                          for k, v in p.items()} for n, p in params.items()}
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
                    layer, params[name], state[name], x, lrng, mask)
            else:
                x, new_state[name] = layer.apply(params[name], state[name], x,
                                                 train=train, rng=lrng, mask=mask)
            if mask is not None and self._layer_types:
                t_in, t_out = self._layer_types[i], self._layer_types[i + 1]
                if (t_out.kind != "recurrent"
                        or (t_in.kind == "recurrent"
                            and t_in.shape[0] != t_out.shape[0])):
                    mask = None
        return x, new_state

    def _checkpointed(self, layer, p, s, x, rng, mask):
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
            return layer.apply(p_, s_, x_, train=True, rng=g, mask=m_)

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
        loss = head.compute_loss(hp[name], state[name], h, y, train=train,
                                 rng=rng if head.STOCHASTIC else None,
                                 mask=labels_mask)
        return loss + self._reg_penalty(params), new_state

    def _reg_penalty(self, params: Params):
        return reg_penalty(self.conf, self._named_layers(), params)

    def _tensor(self, a) -> Optional[torch.Tensor]:
        return None if a is None else torch.as_tensor(a, device=self.device)

    # ---- one training step ----
    def _fit_batch(self, x, y, fmask=None, lmask=None) -> None:
        t0 = time.perf_counter()
        params = self.params_
        loss, new_state = self._loss(params, self.state_, x, y, self._rng,
                                     fmask, lmask)
        grads = grads_of(loss, params)
        apply_updates(self.conf, self._named_layers(), params, grads,
                      self.opt_state_, self._updater_for, self.iteration,
                      self.epoch)
        self.state_ = tree_map(lambda t: t.detach(), new_state)
        self._instruments().record_dispatch(time.perf_counter() - t0)
        self._score = loss.detach()
        self._last_batch_size = int(x.shape[0])
        self.iteration += 1
        for lst in self.listeners:
            lst.iteration_done(self, self.iteration, self.epoch)

    # ---- public API ----
    def fit(self, data, labels=None, *, epochs: int = 1, features_mask=None,
            labels_mask=None, fused_steps: Optional[int] = None):
        """fit(x, y) for one batch, or fit(iterator, epochs=N): `reset()`
        the iterator each epoch, one step per DataSet, then count the
        epoch and call each listener's `on_epoch_end`."""
        if fused_steps not in (None, 1):
            _not_ported("fused_steps > 1 (fit_steps)")
        if labels is not None:
            self._fit_batch(self._tensor(data), self._tensor(labels),
                            self._tensor(features_mask), self._tensor(labels_mask))
            return self
        for _ in range(epochs):
            if hasattr(data, "reset"):
                data.reset()
            with span("fit_epoch", model=type(self).__name__):
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

    def fit_steps(self, xs, ys, features_masks=None, labels_masks=None):
        _not_ported("fit_steps (k steps in one dispatch)")

    def set_normalizer(self, normalizer):
        _not_ported("set_normalizer (the on-device normalizer)")

    def set_gradient_sharing(self, sharing):
        _not_ported("set_gradient_sharing (hierarchical gradient sharing)")

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
        loss, _ = self._loss(self.params_, self.state_, self._tensor(x),
                             self._tensor(y), None, self._tensor(features_mask),
                             self._tensor(labels_mask), train=False)
        return float(loss)

    @torch.inference_mode()
    def output(self, x, train: bool = False) -> torch.Tensor:
        """Inference forward pass; `x` (numpy or tensor, NHWC for image
        models) moves to the network's device.  Returns a tensor there."""
        return self._forward(self.params_, self.state_, self._tensor(x),
                             train=train)[0]

    @torch.inference_mode()
    def feed_forward(self, x, train: bool = False) -> List[torch.Tensor]:
        """Every layer's activation, the input first, on the master
        parameters (no compute-dtype cast) and without dropout."""
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
        params = self.params_
        loss, _ = self._loss(params, self.state_, self._tensor(x), self._tensor(y),
                             None, self._tensor(features_mask),
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
        return sum(p.numel() for p in self.parameters())

    def params(self) -> np.ndarray:
        """Single flat parameter vector in the JAX package's order and
        layouts."""
        return convert.flat_params(self)

    def set_params(self, flat: np.ndarray) -> None:
        convert.set_flat_params(self, flat)

    # ---- persistence (the ModelSerializer zip) ----
    def save(self, path: str, save_updater: bool = True) -> None:
        from deeplearning4j_tpu_torch.utils.serialization import write_model
        write_model(self, path, save_updater=save_updater)

    @staticmethod
    def load(path: str, load_updater: bool = True,
             device=None) -> "MultiLayerNetwork":
        from deeplearning4j_tpu_torch.utils.serialization import read_model
        return read_model(path, load_updater=load_updater, device=device)
