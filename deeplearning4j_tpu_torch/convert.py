"""Carry parameters and layer state between the JAX package and the port.

The JAX package keeps a network's parameters as a tree of arrays,
``{layer_name: {param_key: array}}`` (a ComputationGraph's keys are its
vertex names); the port keeps them as ``nn.Parameter``s of the same names
(``layer_0.W``, ``vertices.s0b0_a_conv.W``, ...).  Layer state (the
BatchNormalization running ``mean`` and ``var``) is a tree of the same
shape, ``net.state_``, in both packages and in the same layout.
The layouts differ only where PyTorch's idiom does: a Dense ``W`` stays
``[n_in, n_out]`` (the kernel computes ``x @ W``), a conv ``W`` is HWIO in
the JAX tree and OIHW in the port (``Layer.TORCH_LAYOUT``).  Arrays cross
as numpy, so this module needs nothing of the JAX package: a caller turns a
JAX tree into numpy first (``jax.tree_util.tree_map(np.asarray, params)``).
A BertModel's tree (``bert_params_from_jax``/``bert_params_to_jax``) is
the JAX package's ``params_`` as it is: named arrays plus the stacked
``layers`` dict, every layout the same in both packages; its updater state
(``bert_opt_state_from_jax``/``bert_opt_state_to_jax``, Adam's ``m`` and
``v``) is a dict of such trees.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

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
        for k, p in sub.items():
            t = from_jax_layout(net.layer_by_name(name), k, tree[name][k])
            if tuple(t.shape) != tuple(p.shape):
                raise ValueError(f"{name}.{k}: shape {tuple(t.shape)} (port "
                                 f"layout) != {tuple(p.shape)}")
            p.copy_(t)


def jax_leaves(params) -> List[Tuple[str, str]]:
    """(name, key) of every parameter in ``jax.tree_util.tree_leaves``
    order: dict keys sorted as strings (``layer_10`` before ``layer_2``,
    ``W`` before ``b``)."""
    return [(name, k) for name in sorted(params) for k in sorted(params[name])]


def flat_params(net) -> np.ndarray:
    """The network's parameters as one flat vector in the JAX package's
    order and layouts."""
    tree = params_to_jax(net)
    leaves = [tree[n][k].ravel() for n, k in jax_leaves(tree)]
    return np.concatenate(leaves) if leaves else np.zeros((0,), np.float32)


def set_flat_params(net, flat) -> None:
    """Load a flat vector in the JAX package's order into the network."""
    flat = np.asarray(flat)
    tree = params_to_jax(net)
    off = 0
    for n, k in jax_leaves(tree):
        shape = tree[n][k].shape
        size = int(np.prod(shape))
        tree[n][k] = flat[off:off + size].reshape(shape)
        off += size
    if off != flat.size:
        raise ValueError(f"Param count mismatch: {flat.size} vs {off}")
    params_from_jax(net, tree)


def state_to_jax(net) -> Tree:
    """The network's layer state as a tree of numpy arrays (bf16 widens to
    f32)."""
    return {name: {k: (v.detach().float() if v.dtype == torch.bfloat16
                       else v.detach()).cpu().numpy()
                   for k, v in sub.items()}
            for name, sub in net.state_.items()}


@torch.no_grad()
def state_from_jax(net, tree: Tree) -> None:
    """Load a JAX state tree of numpy arrays into the network's state
    tensors, in place; names, keys and shapes must match."""
    state = net.state_
    if set(tree) != set(state):
        raise ValueError(f"layer names differ: {sorted(tree)} vs {sorted(state)}")
    for name, sub in state.items():
        if set(tree[name]) != set(sub):
            raise ValueError(f"{name}: state keys differ: "
                             f"{sorted(tree[name])} vs {sorted(sub)}")
        for k, t in sub.items():
            arr = np.asarray(tree[name][k])
            if tuple(arr.shape) != tuple(t.shape):
                raise ValueError(f"{name}.{k}: shape {tuple(arr.shape)} != "
                                 f"{tuple(t.shape)}")
            t.copy_(torch.from_numpy(np.array(arr)))


def _numpy_tree(tree) -> Dict:
    if isinstance(tree, dict):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    return tree.detach().float().cpu().numpy()


@torch.no_grad()
def _load_tree(dst, src, where: str) -> None:
    """Copy a nested dict of numpy arrays into the tensors of `dst`, in
    place; keys and shapes must match."""
    if set(src) != set(dst):
        raise ValueError(f"{where}: keys differ: {sorted(src)} vs {sorted(dst)}")
    for k, t in dst.items():
        if isinstance(t, dict):
            _load_tree(t, src[k], f"{where}{k}.")
            continue
        arr = np.asarray(src[k])
        if tuple(arr.shape) != tuple(t.shape):
            raise ValueError(f"{where}{k}: shape {arr.shape} != {tuple(t.shape)}")
        t.copy_(torch.from_numpy(np.array(arr, dtype=np.float32)))


def bert_params_to_jax(model) -> Dict:
    """A BertModel's parameters as the JAX package's tree of numpy arrays."""
    return _numpy_tree(model.params_)


def bert_params_from_jax(model, tree: Dict) -> None:
    """Load the JAX package's BERT tree of numpy arrays into a BertModel, in
    place; names and shapes must match."""
    _load_tree(model.params_, tree, "")


def bert_opt_state_to_jax(model) -> Dict:
    """A BertModel's updater state (Adam: ``{"m": tree, "v": tree}``) as the
    JAX package's ``opt_state_`` of numpy arrays."""
    return _numpy_tree(model.opt_state_)


def bert_opt_state_from_jax(model, tree: Dict) -> None:
    """Load the JAX package's BERT updater state (numpy arrays) into a
    BertModel's ``opt_state_``, in place; keys and shapes must match."""
    _load_tree(model.opt_state_, tree, "")
