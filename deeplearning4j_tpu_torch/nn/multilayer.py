"""MultiLayerNetwork: the sequential-stack model (the port of
``nn/multilayer.py``, inference half).

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
by default).  ``fit``, scoring and serialization come with the training
slice.
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
from deeplearning4j_tpu_torch.train.updaters import (IUpdater, Sgd, tree_leaves,
                                                     tree_map)
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
    """Sequential network: `init`, `output`, `params`/`set_params`.

    One submodule per layer, named by `conf.layer_name(i)`, holds that
    layer's parameters; layers without parameters hold none."""

    def __init__(self, conf: MultiLayerConfiguration, device=None):
        super().__init__()
        self.conf = conf
        self.device = resolve_device(device)
        self.state_: Optional[Dict[str, Dict]] = None
        self._layer_types: List[InputType] = []

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
                 train: bool = False) -> Tuple[torch.Tensor, Dict]:
        if train:
            raise NotImplementedError(
                "training forward (dropout, batch statistics) is not ported yet")
        params, x = self._cast_compute(params, x)
        new_state = dict(state)
        for i in range(len(self.conf.layers)):
            name = self.conf.layer_name(i)
            x, new_state[name] = self.conf.layers[i].apply(
                params[name], state[name], x)
        return x, new_state

    @torch.inference_mode()
    def output(self, x, train: bool = False) -> torch.Tensor:
        """Inference forward pass; `x` (numpy or tensor, NHWC for image
        models) moves to the network's device.  Returns a tensor there."""
        x = torch.as_tensor(x, device=self.device)
        return self._forward(self.params_, self.state_, x, train=train)[0]

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
