"""Gradient updaters (the port of ``train/updaters.py``).

The configs keep the JAX package's fields and JSON form.  The training
slice ports the update math of Sgd, NoOp, Nesterovs and Adam with the JAX
formulas, and ``apply_gradient_normalization``.  An updater is a function
over a tree of tensors (a vertex's ``{param key: tensor}``, nested dicts
allowed): ``init_state(params)`` gives its state and
``apply(state, grads, iteration, epoch, params)`` returns
``(update, new_state)``.  ``apply`` builds new state tensors and never
writes to its arguments; the network subtracts the returned update from
its parameters in place under ``torch.no_grad()``, as the reference's
optimizer loop does (``params.subi(update)``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Tuple

import torch

from deeplearning4j_tpu_torch.train.schedules import ISchedule, resolve_schedule

Tree = Any


def tree_map(fn: Callable, tree: Tree, *rest: Tree) -> Tree:
    """Map `fn` over the tensor leaves of nested dicts of the same shape."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    return fn(tree, *rest)


def tree_leaves(tree: Tree):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_leaves(tree[k])
    else:
        yield tree


def _zeros_like_tree(params: Tree) -> Tree:
    return tree_map(lambda p: torch.zeros_like(p, requires_grad=False), params)


@dataclasses.dataclass
class IUpdater:
    """Base updater config."""

    learning_rate: Any = 1e-3  # float or ISchedule

    def lr_at(self, iteration, epoch=0) -> float:
        return resolve_schedule(self.learning_rate).value_at(iteration, epoch)

    def init_state(self, params: Tree) -> Tree:
        return ()

    def apply(self, state: Tree, grads: Tree, iteration, epoch=0,
              params: Tree = None) -> Tuple[Tree, Tree]:
        """Returns (update_to_subtract, new_state)."""
        raise NotImplementedError(
            f"{type(self).__name__}: the update math is not ported yet")

    def to_json(self) -> dict:
        d = {}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if isinstance(v, ISchedule):
                v = v.to_json()
            d[f.name] = v
        d["@updater"] = type(self).__name__
        return d

    @staticmethod
    def from_json(d: dict) -> "IUpdater":
        d = dict(d)
        kind = d.pop("@updater")
        if kind not in UPDATERS:
            raise ValueError(f"updater {kind!r} is not ported yet; have "
                             f"{sorted(UPDATERS)}")
        if isinstance(d.get("learning_rate"), dict):
            d["learning_rate"] = ISchedule.from_json(d["learning_rate"])
        return UPDATERS[kind](**d)


@dataclasses.dataclass
class Sgd(IUpdater):
    def apply(self, state, grads, iteration, epoch=0, params=None):
        lr = self.lr_at(iteration, epoch)
        return tree_map(lambda g: lr * g, grads), state


@dataclasses.dataclass
class NoOp(IUpdater):
    """Gradient passed through unmodified."""

    def apply(self, state, grads, iteration, epoch=0, params=None):
        return grads, state


@dataclasses.dataclass
class Nesterovs(IUpdater):
    """Nesterov momentum, the cs231n formulation of the reference:
    v_new = mu*v - lr*g; update = mu*v - (1+mu)*v_new (subtracted)."""

    learning_rate: Any = 0.1
    momentum: float = 0.9

    def init_state(self, params):
        return _zeros_like_tree(params)

    def apply(self, state, grads, iteration, epoch=0, params=None):
        lr = self.lr_at(iteration, epoch)
        mu = self.momentum
        v_new = tree_map(lambda v, g: mu * v - lr * g, state, grads)
        upd = tree_map(lambda v, vn: mu * v - (1.0 + mu) * vn, state, v_new)
        return upd, v_new


@dataclasses.dataclass
class Adam(IUpdater):
    """Adam with epsilon outside the sqrt: alpha_t = lr*sqrt(1-b2^t)/(1-b1^t);
    update = alpha_t * m / (sqrt(v) + eps).  alpha_t is taken in f32, as
    the JAX package computes it."""

    learning_rate: Any = 1e-3
    beta1: float = 0.9
    beta2: float = 0.999
    epsilon: float = 1e-8

    def init_state(self, params):
        return {"m": _zeros_like_tree(params), "v": _zeros_like_tree(params)}

    def apply(self, state, grads, iteration, epoch=0, params=None):
        b1, b2, eps = self.beta1, self.beta2, self.epsilon
        f32 = torch.float32
        t = torch.tensor(float(iteration), dtype=f32) + 1.0
        alpha = (torch.tensor(self.lr_at(iteration, epoch), dtype=f32)
                 * torch.sqrt(1.0 - torch.tensor(b2, dtype=f32) ** t)
                 / (1.0 - torch.tensor(b1, dtype=f32) ** t))
        m = tree_map(lambda m_, g: b1 * m_ + (1 - b1) * g, state["m"], grads)
        v = tree_map(lambda v_, g: b2 * v_ + (1 - b2) * g * g, state["v"], grads)
        upd = tree_map(lambda m_, v_: alpha.to(m_.device) * m_ / (torch.sqrt(v_) + eps),
                       m, v)
        return upd, {"m": m, "v": v}


UPDATERS: Dict[str, type] = {c.__name__: c for c in [Sgd, NoOp, Nesterovs, Adam]}


def apply_gradient_normalization(grads: Tree, mode, threshold: float = 1.0) -> Tree:
    """The reference's ``GradientNormalization`` modes, per layer or per
    parameter: renormalize or clip."""
    if mode is None or mode == "None":
        return grads
    leaves = list(tree_leaves(grads))

    def layer_norm():
        return torch.sqrt(sum(torch.sum(g * g) for g in leaves))

    if mode == "RenormalizeL2PerLayer":
        scale = 1.0 / torch.clamp(layer_norm(), min=1e-12)
        return tree_map(lambda g: g * scale, grads)
    if mode == "RenormalizeL2PerParamType":
        return tree_map(
            lambda g: g / torch.clamp(torch.sqrt(torch.sum(g * g)), min=1e-12), grads)
    if mode == "ClipElementWiseAbsoluteValue":
        return tree_map(lambda g: torch.clamp(g, -threshold, threshold), grads)
    if mode == "ClipL2PerLayer":
        scale = torch.clamp(threshold / torch.clamp(layer_norm(), min=1e-12), max=1.0)
        return tree_map(lambda g: g * scale, grads)
    if mode == "ClipL2PerParamType":
        def clip(g):
            n = torch.sqrt(torch.sum(g * g))
            return g * torch.clamp(threshold / torch.clamp(n, min=1e-12), max=1.0)
        return tree_map(clip, grads)
    raise ValueError(f"Unknown gradient normalization mode '{mode}'")
