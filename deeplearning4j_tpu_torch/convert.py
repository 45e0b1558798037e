"""Carry parameters between the JAX package and the port.

The JAX package keeps a network's parameters as a tree of arrays,
``{layer_name: {param_key: array}}``; the port keeps them as
``nn.Parameter``s of the same names (``layer_0.W``, ``layer_0.b``, ...).
The layouts differ only where PyTorch's idiom does: a Dense ``W`` stays
``[n_in, n_out]`` (the kernel computes ``x @ W``), a conv ``W`` is HWIO in
the JAX tree and OIHW in the port (``Layer.TORCH_LAYOUT``).  Arrays cross
as numpy, so this module needs nothing of the JAX package: a caller turns a
JAX tree into numpy first (``jax.tree_util.tree_map(np.asarray, params)``).
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

Tree = Dict[str, Dict[str, np.ndarray]]


def _inverse(perm):
    return tuple(int(i) for i in np.argsort(perm))


def to_jax_layout(layer, key: str, t: torch.Tensor) -> np.ndarray:
    """One port parameter as a numpy array in the JAX package's layout
    (bf16 widens to f32: numpy has no bf16)."""
    perm = layer.TORCH_LAYOUT.get(key)
    t = t.detach()
    if perm is not None:
        t = t.permute(*_inverse(perm))
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.cpu().contiguous().numpy()


def from_jax_layout(layer, key: str, arr) -> torch.Tensor:
    """One JAX-layout array as a CPU tensor in the port's layout."""
    t = torch.tensor(np.asarray(arr))
    perm = layer.TORCH_LAYOUT.get(key)
    return t.permute(*perm) if perm is not None else t


def params_to_jax(net) -> Tree:
    """The port network's parameters as a JAX-layout tree of numpy arrays."""
    params = net.params_
    return {name: {k: to_jax_layout(net.layer_by_name(name), k, v)
                   for k, v in params[name].items()}
            for name in params}


@torch.no_grad()
def params_from_jax(net, tree: Tree) -> None:
    """Load a JAX-layout tree of numpy arrays into the port network, in
    place; every layer's keys and shapes must match."""
    params = net.params_
    if set(tree) != set(params):
        raise ValueError(f"layer names differ: {sorted(tree)} vs {sorted(params)}")
    for name, sub in params.items():
        if set(tree[name]) != set(sub):
            raise ValueError(f"{name}: param keys differ: "
                             f"{sorted(tree[name])} vs {sorted(sub)}")
        layer = net.layer_by_name(name)
        for k, p in sub.items():
            t = from_jax_layout(layer, k, tree[name][k])
            if tuple(t.shape) != tuple(p.shape):
                raise ValueError(f"{name}.{k}: shape {tuple(t.shape)} (port "
                                 f"layout) != {tuple(p.shape)}")
            p.copy_(t)
