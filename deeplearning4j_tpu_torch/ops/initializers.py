"""Weight initialization (the port of ``ops/initializers.py``).

Fan conventions follow the JAX package: a dense W [nIn, nOut] has
fanIn = nIn, fanOut = nOut; a conv kernel given in HWIO [kh, kw, cin, cout]
has fanIn = kh*kw*cin, fanOut = kh*kw*cout.  Random numbers come from the
explicit ``torch.Generator`` passed in, never from a global RNG, so they
match the JAX package in distribution only.  The slice ports the schemes
its zoo models use (XAVIER, RELU, NORMAL).
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


def init_weights(gen: torch.Generator, shape: Sequence[int], scheme: str,
                 dtype=torch.float32, device=None) -> torch.Tensor:
    """A weight tensor of `shape` (JAX layout) per a DL4J WeightInit name,
    drawn from `gen` on `device` (the generator's device by default)."""
    scheme = scheme.upper()
    fan_in, fan_out = _fans(shape)
    shape = tuple(int(s) for s in shape)
    device = gen.device if device is None else device
    normal = torch.randn(shape, generator=gen, dtype=torch.float32,
                         device=device)
    if scheme == "NORMAL":
        # N(0, 1/sqrt(fanIn)), as the JAX package
        std = 1.0 / math.sqrt(fan_in)
    elif scheme == "XAVIER":
        # Glorot normal: N(0, 2/(fanIn+fanOut))
        std = math.sqrt(2.0 / (fan_in + fan_out))
    elif scheme in ("RELU", "HE", "HE_NORMAL"):
        # He normal: N(0, 2/fanIn)
        std = math.sqrt(2.0 / fan_in)
    else:
        raise ValueError(
            f"Unknown or not yet ported weight init scheme '{scheme}'")
    return (normal * std).to(dtype)
