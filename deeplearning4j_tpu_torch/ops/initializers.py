"""Weight initialization (the port of ``ops/initializers.py``): every
DL4J WeightInit scheme the JAX package draws.

Fan conventions follow the JAX package: a dense W [nIn, nOut] has
fanIn = nIn, fanOut = nOut; a conv kernel given in HWIO [kh, kw, cin, cout]
has fanIn = kh*kw*cin, fanOut = kh*kw*cout.  `shape` is always the JAX
layout (a layer permutes to its ``TORCH_LAYOUT`` afterwards).  Random
numbers come from the explicit ``torch.Generator`` passed in, never from a
global RNG, so they match the JAX package in distribution only; ZERO, ONES,
IDENTITY and CONSTANT draw nothing and are exact.
"""
from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch


def _fans(shape: Sequence[int]) -> Tuple[float, float]:
    if len(shape) == 1:
        return float(shape[0]), float(shape[0])
    if len(shape) == 2:
        return float(shape[0]), float(shape[1])
    receptive = 1.0
    for s in shape[:-2]:
        receptive *= s
    return receptive * shape[-2], receptive * shape[-1]


def _orthogonal(gen, shape, device) -> torch.Tensor:
    """``jax.nn.initializers.orthogonal()``: the last axis holds the
    columns, the others are flattened into rows; the columns (or, with
    fewer rows than columns, the rows) are orthonormal."""
    if len(shape) < 2:
        raise ValueError("ORTHOGONAL init requires at least 2 dimensions")
    n_cols = shape[-1]
    n_rows = math.prod(shape) // n_cols
    tall = (n_rows, n_cols) if n_rows >= n_cols else (n_cols, n_rows)
    a = torch.randn(tall, generator=gen, dtype=torch.float32, device=device)
    q, r = torch.linalg.qr(a)
    q = q * torch.sign(torch.diagonal(r))
    if n_rows < n_cols:
        q = q.t()
    return q.reshape(shape)


def init_weights(gen: torch.Generator, shape: Sequence[int], scheme: str,
                 dtype=torch.float32, device=None,
                 dist_params=None) -> torch.Tensor:
    """A weight tensor of `shape` (JAX layout) per a DL4J WeightInit name,
    drawn from `gen` on `device` (the generator's device by default).
    CONSTANT takes its value from ``dist_params["value"]`` (0 without)."""
    scheme = scheme.upper()
    fan_in, fan_out = _fans(shape)
    shape = tuple(int(s) for s in shape)
    device = gen.device if device is None else device
    if scheme == "ZERO":
        return torch.zeros(shape, dtype=dtype, device=device)
    if scheme == "ONES":
        return torch.ones(shape, dtype=dtype, device=device)
    if scheme == "IDENTITY":
        if len(shape) != 2 or shape[0] != shape[1]:
            raise ValueError("IDENTITY init requires a square 2-D shape")
        return torch.eye(shape[0], dtype=dtype, device=device)
    if scheme == "CONSTANT":
        value = (dist_params or {}).get("value", 0.0)
        return torch.full(shape, value, dtype=dtype, device=device)
    if scheme == "ORTHOGONAL":
        return _orthogonal(gen, shape, device).to(dtype)

    def normal(std):
        return (torch.randn(shape, generator=gen, dtype=torch.float32,
                            device=device) * std).to(dtype)

    def uniform(a):
        u = torch.rand(shape, generator=gen, dtype=torch.float32, device=device)
        return (u * (2.0 * a) - a).to(dtype)

    if scheme in ("NORMAL", "XAVIER_FAN_IN", "LECUN_NORMAL"):
        # N(0, 1/sqrt(fanIn)), as the JAX package
        return normal(1.0 / math.sqrt(fan_in))
    if scheme == "GAUSSIAN":
        return normal(1.0)
    if scheme in ("XAVIER", "VAR_SCALING_NORMAL_FAN_AVG"):
        # Glorot normal: N(0, 2/(fanIn+fanOut))
        return normal(math.sqrt(2.0 / (fan_in + fan_out)))
    if scheme in ("RELU", "HE", "HE_NORMAL"):
        # He normal: N(0, 2/fanIn)
        return normal(math.sqrt(2.0 / fan_in))
    if scheme == "UNIFORM":
        return uniform(math.sqrt(1.0 / fan_in))
    if scheme == "XAVIER_UNIFORM":
        return uniform(math.sqrt(6.0 / (fan_in + fan_out)))
    if scheme in ("RELU_UNIFORM", "HE_UNIFORM"):
        return uniform(math.sqrt(6.0 / fan_in))
    if scheme == "LECUN_UNIFORM":
        return uniform(math.sqrt(3.0 / fan_in))
    if scheme == "SIGMOID_UNIFORM":
        return uniform(4.0 * math.sqrt(6.0 / (fan_in + fan_out)))
    raise ValueError(f"Unknown weight init scheme '{scheme}'")
