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

A MultiLayerNetwork's or ComputationGraph's updater state
(``opt_state_to_jax``/``opt_state_from_jax``) is ``{layer_name:
updater_state}``, where each updater's state is built of trees that mirror
the layer's parameters (Adam ``{"m": {"W", "b"}, "v": {...}}``, Nesterovs
``{"W", "b"}``, Sgd ``()``).  A moment is keyed by the parameter it
belongs to, so it crosses in that parameter's layout: the moments of a
conv ``W`` are HWIO in the JAX tree and OIHW in the port, like ``W``.
``layout_leaves`` lists the tensors of any such network-keyed tree
(parameters, state or updater state) in the JAX package's ``tree_leaves``
order with their layout permutation, for the ModelSerializer zip.

A quantized model's tree (``quant_params_from_jax``/``quant_params_to_jax``)
is the same ``{layer_name: {param_key: leaf}}`` tree in which a quantized
leaf crosses as ``{"q": int8 array, "scale": f32 array, "axis": int}``
(the JAX package's ``QTensor`` fields), in the JAX layout: the conv layout
permutation applies to ``q`` and ``scale`` alike and moves ``axis`` with
them.  A ``TinyDecodeModel``'s tree (``decode_params_from_jax``/
``decode_params_to_jax``) is its flat dict of named arrays, every layout
the same in both packages.

A SameDiff graph (``samediff_from_jax``/``samediff_to_jax``) crosses whole:
its nodes (the shared JSON form), variables, constants (a weakly typed
JAX scalar as a Python scalar, so it promotes as in JAX), loss names,
training configuration, counters and updater state (its leaves in
``tree_leaves`` order, dict keys sorted).  ``samediff_from_jax`` reads the
JAX graph's attributes (its arrays through ``np.asarray``), so it too
needs nothing of the JAX package; ``samediff_to_jax`` returns plain
numpy parts for the caller to assemble.  The user-facing path across the
packages is the shared zip (``SameDiff.save``/``load``).
"""
from __future__ import annotations

import json
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

Tree = Dict[str, Dict[str, np.ndarray]]


def _inverse(perm):
    return tuple(int(i) for i in np.argsort(perm))


def jax_view(layer, key: str, t: torch.Tensor) -> torch.Tensor:
    """One port parameter viewed in the JAX package's layout (no copy)."""
    perm = layer.TORCH_LAYOUT.get(key)
    return t.permute(*_inverse(perm)) if perm is not None else t


def to_jax_layout(layer, key: str, t: torch.Tensor) -> np.ndarray:
    """One port parameter as a numpy array in the JAX package's layout
    (bf16 widens to f32: numpy has no bf16)."""
    t = jax_view(layer, key, t.detach())
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.cpu().contiguous().numpy()


def from_jax_layout(layer, key: str, arr) -> torch.Tensor:
    """One JAX-layout array as a CPU tensor in the port's layout."""
    t = torch.tensor(np.asarray(arr))
    perm = layer.TORCH_LAYOUT.get(key)
    return t.permute(*perm) if perm is not None else t


def params_to_jax(net) -> Tree:
    """The port network's parameters as a JAX-layout tree of numpy arrays
    (nested where the JAX tree is, as Bidirectional's ``fwd``/``bwd``)."""
    from deeplearning4j_tpu_torch.parallel.sharding import whole
    with whole(net):
        params = net.params_
        return {name: _numpy_tree(params[name], _layer_or_layout(net, name))
                for name in params}


@torch.no_grad()
def params_from_jax(net, tree: Tree) -> None:
    """Load a JAX-layout tree of numpy arrays into the port network, in
    place; every layer's keys and shapes must match."""
    from deeplearning4j_tpu_torch.parallel.sharding import whole
    with whole(net):
        params = net.params_
        if set(tree) != set(params):
            raise ValueError(f"layer names differ: {sorted(tree)} vs {sorted(params)}")
        for name, sub in params.items():
            _load_tree(sub, tree[name], f"{name}.", _layer_or_layout(net, name))


def _sorted_leaves(tree, path=()):
    """(key path, leaf) of a nested dict in ``jax.tree_util.tree_leaves``
    order: dict keys sorted as strings at every level."""
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _sorted_leaves(tree[k], path + (k,))
        else:
            yield path + (k,), tree[k]


def jax_leaves(params) -> List[Tuple[str, str]]:
    """(name, key) of every parameter in ``jax.tree_util.tree_leaves``
    order: dict keys sorted as strings (``layer_10`` before ``layer_2``,
    ``W`` before ``b``); a nested key is dotted (``fwd.W``)."""
    return [(path[0], ".".join(path[1:])) for path, _ in _sorted_leaves(params)]


def flat_params(net) -> np.ndarray:
    """The network's parameters as one flat vector in the JAX package's
    order and layouts."""
    leaves = [a.ravel() for _, a in _sorted_leaves(params_to_jax(net))]
    return np.concatenate(leaves) if leaves else np.zeros((0,), np.float32)


def set_flat_params(net, flat) -> None:
    """Load a flat vector in the JAX package's order into the network."""
    flat = np.asarray(flat)
    tree = params_to_jax(net)
    off = 0
    for path, a in _sorted_leaves(tree):
        sub = tree
        for k in path[:-1]:
            sub = sub[k]
        sub[path[-1]] = flat[off:off + a.size].reshape(a.shape)
        off += a.size
    if off != flat.size:
        raise ValueError(f"Param count mismatch: {flat.size} vs {off}")
    params_from_jax(net, tree)


def state_to_jax(net) -> Tree:
    """The network's layer state as a tree of numpy arrays (bf16 widens to
    f32)."""
    return {name: _numpy_tree(sub, _Layout) for name, sub in net.state_.items()}


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
        _load_tree(sub, tree[name], f"{name}.", _Layout)


class _Layout:
    """Stands in for a layer where a tree has no layout permutations (a
    graph vertex without a layer)."""

    TORCH_LAYOUT: Dict = {}


def _numpy_tree(tree, layer=None, key=None):
    """A nested dict of tensors as numpy arrays.  With `layer`, each leaf
    goes to the JAX layout of the parameter its key names (bf16 widens to
    f32); without, every leaf widens to f32."""
    if isinstance(tree, dict):
        return {k: _numpy_tree(v, layer, k) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tree
    if layer is not None:
        return to_jax_layout(layer, key, tree)
    return tree.detach().float().cpu().numpy()


@torch.no_grad()
def _load_tree(dst, src, where: str, layer=None) -> None:
    """Copy a nested dict of numpy arrays into the tensors of `dst`, in
    place; keys and shapes must match.  With `layer`, each array is in the
    JAX layout of the parameter its key names."""
    if isinstance(dst, tuple):
        if len(dst) or len(src):
            raise ValueError(f"{where}: only empty tuples are state leaves")
        return
    if set(src) != set(dst):
        raise ValueError(f"{where}: keys differ: {sorted(src)} vs {sorted(dst)}")
    for k, t in dst.items():
        if isinstance(t, (dict, tuple)):
            _load_tree(t, src[k], f"{where}{k}.", layer)
            continue
        arr = np.asarray(src[k])
        new = (from_jax_layout(layer, k, arr) if layer is not None
               else torch.from_numpy(np.array(arr, dtype=np.float32)))
        if tuple(new.shape) != tuple(t.shape):
            raise ValueError(f"{where}{k}: shape {tuple(new.shape)} (port layout) "
                             f"!= {tuple(t.shape)}")
        t.copy_(new)


def _layer_or_layout(net, name: str):
    try:
        return net.layer_by_name(name)
    except KeyError:            # a graph vertex that is not a layer
        return _Layout


def opt_state_to_jax(net) -> Dict:
    """A MultiLayerNetwork's or ComputationGraph's updater state as the
    JAX package's ``opt_state_`` of numpy arrays, each moment in the JAX
    layout of its parameter (bf16 widens to f32)."""
    from deeplearning4j_tpu_torch.parallel.sharding import whole
    with whole(net):
        return {name: _numpy_tree(sub, _layer_or_layout(net, name))
                for name, sub in net.opt_state_.items()}


def opt_state_from_jax(net, tree: Dict) -> None:
    """Load the JAX package's ``opt_state_`` (numpy arrays, JAX layouts)
    into a MultiLayerNetwork's or ComputationGraph's updater state, in
    place; names, keys and shapes must match."""
    from deeplearning4j_tpu_torch.parallel.sharding import whole
    with whole(net):
        state = net.opt_state_
        if set(tree) != set(state):
            raise ValueError(f"layer names differ: {sorted(tree)} vs {sorted(state)}")
        for name, sub in state.items():
            _load_tree(sub, tree[name], f"{name}.", _layer_or_layout(net, name))


def layout_leaves(net, tree) -> List[Tuple[torch.Tensor, Optional[Tuple[int, ...]]]]:
    """Every tensor of a network-keyed tree (``{layer_name: subtree}``:
    parameters, layer state or updater state) in the JAX package's
    ``tree_leaves`` order (dict keys sorted as strings at every level),
    each with the permutation taking its JAX layout to the port's (None
    where they are the same)."""
    out: List = []

    def walk(sub, layout, key):
        if isinstance(sub, dict):
            for k in sorted(sub):
                walk(sub[k], layout, k)
        elif isinstance(sub, torch.Tensor):
            out.append((sub, layout.get(key)))
        elif not (isinstance(sub, tuple) and not sub):
            raise TypeError(f"unexpected tree leaf {type(sub).__name__}")

    for name in sorted(tree):
        walk(tree[name], _layer_or_layout(net, name).TORCH_LAYOUT, None)
    return out


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


def _qtensor_to_jax(layer, key: str, qt) -> Dict[str, object]:
    perm = layer.TORCH_LAYOUT.get(key)
    return {"q": jax_view(layer, key, qt.q.detach()).cpu().contiguous().numpy(),
            "scale": jax_view(layer, key, qt.scale.detach()).cpu().contiguous().numpy(),
            "axis": int(perm[qt.axis] if perm is not None else qt.axis)}


def quant_params_to_jax(qm) -> Dict:
    """A QuantizedModel's parameters as a JAX-layout tree of numpy arrays;
    quantized leaves as ``{"q", "scale", "axis"}``, bf16 leaves widened to
    f32.  A SameDiff graph's tree is flat, ``{name: leaf}``, in the layout
    both packages share."""
    from deeplearning4j_tpu_torch.ops.quant_kernels import QTensor

    if qm.kind == "samediff":
        return {n: ({"q": v.q.detach().cpu().numpy(), "scale": v.scale.detach().cpu().numpy(),
                     "axis": int(v.axis)} if isinstance(v, QTensor)
                    else v.detach().float().cpu().numpy() if v.dtype == torch.bfloat16
                    else v.detach().cpu().numpy())
                for n, v in qm.params_.items()}
    out: Dict = {}
    for name, sub in qm.params_.items():
        out[name] = {}
        for k, v in sub.items():
            layer = qm.base.layer_by_name(name)
            out[name][k] = (_qtensor_to_jax(layer, k, v) if isinstance(v, QTensor)
                            else to_jax_layout(layer, k, v))
    return out


@torch.no_grad()
def quant_params_from_jax(qm, tree: Dict) -> None:
    """Load a JAX-layout quantized tree (quantized leaves as ``{"q",
    "scale", "axis"}`` of numpy arrays, other leaves arrays) into a
    QuantizedModel's ``params_``, on its device; names must match and a
    plain leaf keeps the dtype the port's leaf has."""
    from deeplearning4j_tpu_torch.ops.quant_kernels import QTensor

    params = qm.params_
    if set(tree) != set(params):
        raise ValueError(f"layer names differ: {sorted(tree)} vs {sorted(params)}")
    if qm.kind == "samediff":
        for name, leaf in tree.items():
            if isinstance(leaf, dict):
                q = torch.tensor(np.asarray(leaf["q"]))
                params[name] = QTensor(q.to(qm.device),
                                       torch.tensor(np.asarray(leaf["scale"], np.float32)
                                                    ).to(qm.device),
                                       axis=int(leaf["axis"]) % q.ndim)
            else:
                params[name] = torch.tensor(np.asarray(leaf)).to(
                    device=qm.device, dtype=params[name].dtype)
        return
    for name, sub in params.items():
        if set(tree[name]) != set(sub):
            raise ValueError(f"{name}: param keys differ: "
                             f"{sorted(tree[name])} vs {sorted(sub)}")
        for k in list(sub):
            layer = qm.base.layer_by_name(name)
            leaf = tree[name][k]
            if isinstance(leaf, dict):
                perm = layer.TORCH_LAYOUT.get(k)
                q = torch.tensor(np.asarray(leaf["q"]))
                scale = torch.tensor(np.asarray(leaf["scale"], np.float32))
                axis = int(leaf["axis"]) % q.ndim
                if perm is not None:
                    q, scale, axis = q.permute(*perm), scale.permute(*perm), perm.index(axis)
                sub[k] = QTensor(q.contiguous().to(qm.device),
                                 scale.contiguous().to(qm.device), axis=axis)
            else:
                dtype = sub[k].dtype if isinstance(sub[k], torch.Tensor) else None
                sub[k] = from_jax_layout(layer, k, leaf).contiguous().to(
                    device=qm.device, dtype=dtype)


def decode_params_to_jax(model) -> Dict[str, np.ndarray]:
    """A TinyDecodeModel's parameters as the JAX package's dict of numpy
    arrays."""
    return {k: v.detach().float().cpu().numpy() for k, v in model.params_.items()}


@torch.no_grad()
def decode_params_from_jax(model, tree: Dict) -> None:
    """Load the JAX package's TinyDecodeModel parameters (numpy arrays)
    into the port's model, in place; names and shapes must match."""
    _load_tree(model.params_, tree, "")


# ---------------------------------------------------------------------------
# SameDiff graphs
# ---------------------------------------------------------------------------


def _tree_leaves(tree) -> list:
    """Leaves of a nested dict/tuple in ``jax.tree_util.tree_leaves`` order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _tree_leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in _tree_leaves(v)]
    return [tree]


def _jax_constant(v):
    """A JAX constant as the port keeps it: a weakly typed 0-dim array as
    its Python scalar, anything else as numpy."""
    a = np.asarray(v)
    if getattr(v, "weak_type", False) and a.ndim == 0:
        return a.item()
    return a


def samediff_from_jax(sd_jax, device="cuda"):
    """A port ``SameDiff`` on `device` equal to the JAX package's graph
    `sd_jax`: nodes, variables, constants, loss names, training
    configuration, counters and updater state."""
    import dataclasses

    from deeplearning4j_tpu_torch.autodiff.samediff import (SameDiff, TrainingConfig,
                                                            _json_default, _node_from_json)
    from deeplearning4j_tpu_torch.train.updaters import tree_leaves
    sd = SameDiff(device=device)
    for node in sd_jax._nodes.values():
        n = _node_from_json(json.loads(json.dumps(dataclasses.asdict(node),
                                                  default=_json_default)))
        sd._nodes[n.name] = n
    sd.variables_ = {k: sd._array(np.asarray(v)) for k, v in sd_jax.variables_.items()}
    sd._constants = {k: (c if isinstance(c, (bool, int, float)) else sd._array(c))
                     for k, c in ((k, _jax_constant(v)) for k, v in sd_jax._constants.items())}
    sd._loss_names = list(sd_jax._loss_names)
    sd.iteration, sd.epoch = int(sd_jax.iteration), int(sd_jax.epoch)
    if sd_jax.training_config is not None:
        sd.training_config = TrainingConfig.from_json(sd_jax.training_config.to_json())
        if sd_jax.opt_state_ is not None:
            sd.opt_state_ = sd.training_config.updater.init_state(sd.variables_)
            leaves = [l for l in tree_leaves(sd.opt_state_) if isinstance(l, torch.Tensor)]
            src = _tree_leaves(sd_jax.opt_state_)
            if len(src) != len(leaves):
                raise ValueError(f"the JAX updater state has {len(src)} leaves, the port's "
                                 f"{len(leaves)}")
            with torch.no_grad():
                for dst, a in zip(leaves, src):
                    dst.copy_(torch.from_numpy(np.array(a)))
    return sd


def samediff_to_jax(sd) -> Dict:
    """A port ``SameDiff`` as numpy parts the JAX package's graph is built
    from: ``nodes`` (the JSON form), ``variables``, ``constants`` (weak
    scalars as Python scalars), ``loss_variables``, ``training_config``
    (JSON), ``iteration``, ``epoch`` and ``updater_leaves`` (None before the
    first step)."""
    import dataclasses

    from deeplearning4j_tpu_torch.autodiff.samediff import _json_default
    from deeplearning4j_tpu_torch.train.updaters import tree_leaves

    def host(v):
        if isinstance(v, torch.Tensor):
            return v.detach().cpu().numpy()
        return v
    return {
        "nodes": [json.loads(json.dumps(dataclasses.asdict(n), default=_json_default))
                  for n in sd._nodes.values()],
        "variables": {k: host(v) for k, v in sd.variables_.items()},
        "constants": {k: host(v) for k, v in sd._constants.items()},
        "loss_variables": list(sd._loss_names),
        "training_config": (None if sd.training_config is None
                            else sd.training_config.to_json()),
        "iteration": sd.iteration, "epoch": sd.epoch,
        "updater_leaves": (None if sd.opt_state_ is None else
                           [host(l) for l in tree_leaves(sd.opt_state_)]),
    }
