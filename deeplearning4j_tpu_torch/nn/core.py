"""Layer-config NN API core (the port of ``nn/core.py``).

Layer configs stay dataclasses with the JAX package's fields and JSON form,
so a configuration reads and writes the same JSON in both packages.  A
layer's parameters are tensors: ``initialize`` makes them and ``apply``
runs the forward over them, in inference or (``train=True``) training
mode; autograd gives the backward.  The network (``nn.multilayer``,
``nn.graph``) owns them as ``nn.Parameter``s named after the JAX
parameter tree.

Public activations are NHWC and ``InputType.convolutional`` is (H, W, C),
as in the JAX package.  A parameter is stored in PyTorch's layout
(``Layer.TORCH_LAYOUT``); ``convert.py`` maps it to and from the JAX one.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from deeplearning4j_tpu_torch.ops.activations import get_activation

Params = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class InputType:
    """Shape metadata (without batch dim) used for layer shape inference."""

    kind: str           # "feedforward" | "convolutional" | "recurrent"
    shape: Tuple[int, ...]

    @staticmethod
    def feed_forward(size: int) -> "InputType":
        return InputType("feedforward", (int(size),))

    @staticmethod
    def convolutional(height: int, width: int, channels: int) -> "InputType":
        # NHWC without batch: (H, W, C)
        return InputType("convolutional", (int(height), int(width), int(channels)))

    @staticmethod
    def recurrent(size: int, timesteps: Optional[int] = None) -> "InputType":
        # (T, F) without batch; T may be None (dynamic padded length)
        return InputType("recurrent", (timesteps if timesteps is None else int(timesteps), int(size)))

    def flat_size(self) -> int:
        n = 1
        for s in self.shape:
            if s is None:
                raise ValueError("Cannot flatten dynamic dimension")
            n *= s
        return n

    def to_json(self) -> dict:
        return {"kind": self.kind, "shape": list(self.shape)}

    @staticmethod
    def from_json(d: dict) -> "InputType":
        return InputType(d["kind"], tuple(d["shape"]))


@dataclasses.dataclass(kw_only=True)
class Layer:
    """Base layer config, field for field the JAX package's ``Layer``.

    Per-layer hyperparameters override the global defaults set on
    `NeuralNetConfiguration`.  Subclasses implement `initialize` (params +
    output InputType) and `apply` (forward).  The class attributes below
    are fields in the JAX package that never reach the JSON; here they are
    plain class attributes.
    """

    name: Optional[str] = None
    activation: Optional[Any] = None          # name or callable
    weight_init: Optional[str] = None         # WeightInit scheme name
    bias_init: float = 0.0
    updater: Optional[Any] = None             # per-layer IUpdater override
    l1: Optional[float] = None
    l2: Optional[float] = None
    weight_decay: Optional[float] = None
    dropout: Optional[float] = None           # RETAIN probability (reference semantics)
    gradient_normalization: Optional[str] = None
    gradient_normalization_threshold: float = 1.0
    frozen: bool = False                      # transfer-learning freeze

    #: {param key: permutation} taking a parameter from the JAX package's
    #: layout to the layout this port stores (empty: the same layout)
    TORCH_LAYOUT = {}
    #: param keys subject to l1/l2/weight decay (biases excluded)
    REGULARIZABLE = ("W",)
    #: does this layer carry non-trainable state (BN running stats)?
    HAS_STATE = False
    #: does apply() draw random numbers in train mode (dropout)?
    STOCHASTIC = False

    def initialize(self, gen: torch.Generator, input_type: InputType,
                   dtype=torch.float32, device=None
                   ) -> Tuple[Params, Dict, InputType]:
        """Returns (params, state, output_type)."""
        raise NotImplementedError

    def apply(self, params: Params, state: Dict, x: torch.Tensor, *,
              train: bool = False, rng: Optional[torch.Generator] = None
              ) -> Tuple[torch.Tensor, Dict]:
        """Forward; returns (output, new_state).  `train` selects batch
        statistics and input dropout; `rng` draws the dropout masks."""
        raise NotImplementedError

    def regularizable_mask(self, params: Params) -> Dict[str, bool]:
        """True where l1/l2/weight decay apply, per param key."""
        return {k: (k in self.REGULARIZABLE) for k in params}

    def maybe_input_dropout(self, x, train, rng):
        """`dropout` on a layer config drops the layer's *input* in train
        mode (retain probability `dropout`, inverted scaling).  The mask
        comes from `rng`, a torch.Generator on x's device, so it matches
        the JAX package in distribution only."""
        if not train or self.dropout is None or self.dropout >= 1.0 or rng is None:
            return x
        p = self.dropout
        keep = torch.rand(x.shape, generator=rng, device=x.device) < p
        return torch.where(keep, x / p, torch.zeros((), dtype=x.dtype, device=x.device))

    # ---- config resolution helpers ----
    def act_fn(self, default="identity"):
        return get_activation(self.activation if self.activation is not None else default)

    def winit(self, default="XAVIER") -> str:
        return self.weight_init if self.weight_init is not None else default

    # ---- JSON round-trip ----
    def to_json(self) -> dict:
        from deeplearning4j_tpu_torch.train.updaters import IUpdater
        d = {}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if isinstance(v, IUpdater):
                v = v.to_json()
            elif isinstance(v, Layer):      # nested layer (Bidirectional etc.)
                v = v.to_json()
            elif callable(v) and not isinstance(v, str):
                v = getattr(v, "__name__", str(v))
            d[f.name] = v
        d["@layer"] = type(self).__name__
        return d

    @staticmethod
    def from_json(d: dict) -> "Layer":
        from deeplearning4j_tpu_torch.nn import LAYER_REGISTRY
        from deeplearning4j_tpu_torch.train.updaters import IUpdater
        d = dict(d)
        kind = d.pop("@layer")
        if kind not in LAYER_REGISTRY:
            raise ValueError(f"layer type {kind!r} is not ported yet; have "
                             f"{sorted(LAYER_REGISTRY)}")
        cls = LAYER_REGISTRY[kind]
        if isinstance(d.get("updater"), dict):
            d["updater"] = IUpdater.from_json(d["updater"])
        for k, v in list(d.items()):
            if isinstance(v, dict) and "@layer" in v:
                d[k] = Layer.from_json(v)
        field_names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in field_names})
