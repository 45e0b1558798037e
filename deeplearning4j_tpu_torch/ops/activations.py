"""Activation functions, by the names of the JAX package's inventory.

The serving slice ports the names its layers use: the fused-dense epilogue
set (identity, linear, relu, tanh, sigmoid, exact-erf gelu) and softmax.
The rest of ``deeplearning4j_tpu/ops/activations.py`` is not ported yet;
asking for one of those names raises.
"""
from __future__ import annotations

from typing import Callable, Dict

import torch
import torch.nn.functional as F

Activation = Callable[[torch.Tensor], torch.Tensor]


def identity(x):
    return x


def relu(x):
    return torch.relu(x)


def gelu(x):
    return F.gelu(x, approximate="none")


def sigmoid(x):
    return torch.sigmoid(x)


def tanh(x):
    return torch.tanh(x)


def softmax(x, axis=-1):
    return torch.softmax(x, dim=axis)


ACTIVATIONS: Dict[str, Activation] = {
    "identity": identity,
    "linear": identity,
    "relu": relu,
    "gelu": gelu,
    "sigmoid": sigmoid,
    "tanh": tanh,
    "softmax": softmax,
}


def get_activation(name_or_fn) -> Activation:
    """Resolve an activation by name (case-insensitive) or pass through a
    callable."""
    if callable(name_or_fn):
        return name_or_fn
    key = str(name_or_fn).lower()
    if key not in ACTIVATIONS:
        raise ValueError(
            f"Unknown or not yet ported activation '{name_or_fn}'. "
            f"Known: {sorted(ACTIVATIONS)}")
    return ACTIVATIONS[key]
