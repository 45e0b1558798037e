"""Activation functions, by the names of the JAX package's inventory (the
port of ``ops/activations.py``): all 22 names.

Each function is written as the JAX package's is (``jax.nn`` or ``jnp``),
so that it equals it in value and in gradient, at its kinks too.  The
torch function of the same name is used only where its gradient at the
kinks is JAX's:

* ``leakyrelu`` is ``where(x >= 0, x, alpha * x)`` (slope 1 at 0, as
  ``jax.nn.leaky_relu``; ``F.leaky_relu`` gives ``alpha`` there);
* ``hardtanh`` and ``hardsigmoid`` clip by ``minimum(maximum(...))``, as
  ``jnp.clip`` does, so a tie with a bound splits the gradient in half
  (``torch.clamp`` gives 1 there, ``F.hardtanh`` 0); ``hardsigmoid`` is
  ``clip(0.2 x + 0.5, 0, 1)``, not torch's ``x / 6 + 1 / 2``;
* ``softplus`` is ``logaddexp(x, 0)``, as JAX's (``F.softplus`` returns
  ``x`` itself above its threshold of 20);
* ``relu6`` is ``F.hardtanh(x, 0, 6)``: slope 0 at 0 and at 6, as the
  custom derivative of ``jax.nn.relu6``.
"""
from __future__ import annotations

import math
from typing import Callable, Dict

import torch
import torch.nn.functional as F

Activation = Callable[[torch.Tensor], torch.Tensor]


def _clip(x, lo, hi):
    """``jnp.clip``: minimum(maximum(x, lo), hi), ties split in half."""
    return torch.minimum(torch.maximum(x, x.new_tensor(lo)), x.new_tensor(hi))


def identity(x):
    return x


def relu(x):
    return torch.relu(x)


def relu6(x):
    return F.hardtanh(x, 0.0, 6.0)


def leakyrelu(x, alpha=0.01):
    return torch.where(x >= 0, x, alpha * x)


def elu(x, alpha=1.0):
    return torch.where(x > 0, x,
                       alpha * torch.expm1(torch.where(x > 0, torch.zeros_like(x), x)))


def selu(x):
    return 1.0507009873554804934193349852946 * elu(x, 1.6732632423543772848170429916717)


def gelu(x):
    return F.gelu(x, approximate="none")


def gelu_tanh(x):
    cdf = 0.5 * (1.0 + torch.tanh(math.sqrt(2 / math.pi) * (x + 0.044715 * (x ** 3))))
    return x * cdf


def sigmoid(x):
    return torch.sigmoid(x)


def hardsigmoid(x):
    return _clip(0.2 * x + 0.5, 0.0, 1.0)


def tanh(x):
    return torch.tanh(x)


def hardtanh(x):
    return _clip(x, -1.0, 1.0)


def rationaltanh(x):
    return 1.7159 * torch.tanh(2.0 * x / 3.0)


def rectifiedtanh(x):
    return torch.maximum(x.new_tensor(0.0), torch.tanh(x))


def softmax(x, axis=-1):
    return torch.softmax(x, dim=axis)


def softplus(x):
    return torch.logaddexp(x, x.new_tensor(0.0))


def softsign(x):
    return x / (torch.abs(x) + 1)


def swish(x):
    return x * torch.sigmoid(x)


def mish(x):
    return x * torch.tanh(softplus(x))


def cube(x):
    return x * x * x


def thresholdedrelu(x, theta=1.0):
    return torch.where(x > theta, x, torch.zeros_like(x))


ACTIVATIONS: Dict[str, Activation] = {
    "identity": identity,
    "linear": identity,
    "relu": relu,
    "relu6": relu6,
    "leakyrelu": leakyrelu,
    "elu": elu,
    "selu": selu,
    "gelu": gelu,
    "gelu_tanh": gelu_tanh,
    "sigmoid": sigmoid,
    "hardsigmoid": hardsigmoid,
    "tanh": tanh,
    "hardtanh": hardtanh,
    "rationaltanh": rationaltanh,
    "rectifiedtanh": rectifiedtanh,
    "softmax": softmax,
    "softplus": softplus,
    "softsign": softsign,
    "swish": swish,
    "mish": mish,
    "cube": cube,
    "thresholdedrelu": thresholdedrelu,
}


def get_activation(name_or_fn) -> Activation:
    """Resolve an activation by name (case-insensitive) or pass through a
    callable."""
    if callable(name_or_fn):
        return name_or_fn
    key = str(name_or_fn).lower()
    if key not in ACTIVATIONS:
        raise ValueError(
            f"Unknown activation '{name_or_fn}'. Known: {sorted(ACTIVATIONS)}")
    return ACTIVATIONS[key]
