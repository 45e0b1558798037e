"""Gradient updaters (the port of ``train/updaters.py``).

The configs keep the JAX package's fields and JSON form, and the update
math of all eleven (Sgd, NoOp, Nesterovs, Adam, AdamW, AMSGrad, Nadam,
AdaMax, AdaGrad, RmsProp, AdaDelta) follows the JAX formulas line for line:
epsilon where the JAX package puts it, the bias corrections taken in f32
as it takes them, and the same state keys (the zip stores the state in
key order).  ``apply_gradient_normalization`` is the JAX package's too.  An updater is a function
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
        """Returns (update_to_subtract, new_state).  `params` is given for
        updaters that read the current parameters (decoupled weight
        decay); the others ignore it."""
        raise NotImplementedError

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
            raise ValueError(f"unknown updater {kind!r}; have "
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


def _f32(v) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.float32)


def _step_t(iteration) -> torch.Tensor:
    """The 1-based step count as the f32 scalar the JAX package raises the
    betas to.  The f32 scalars stay 0-dim CPU tensors: PyTorch takes them
    as scalars beside CUDA tensors, so no copy to the card is made."""
    return _f32(float(iteration)) + 1.0


def _adam_alpha(u, iteration, epoch) -> torch.Tensor:
    """lr * sqrt(1 - b2^t) / (1 - b1^t) in f32 (Adam, AdamW, AMSGrad)."""
    t = _step_t(iteration)
    return (_f32(u.lr_at(iteration, epoch)) * torch.sqrt(1.0 - _f32(u.beta2) ** t)
            / (1.0 - _f32(u.beta1) ** t))


def _moments(state, grads, b1, b2):
    m = tree_map(lambda m_, g: b1 * m_ + (1 - b1) * g, state["m"], grads)
    v = tree_map(lambda v_, g: b2 * v_ + (1 - b2) * g * g, state["v"], grads)
    return m, v


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
        eps = self.epsilon
        alpha = _adam_alpha(self, iteration, epoch)
        m, v = _moments(state, grads, self.beta1, self.beta2)
        upd = tree_map(lambda m_, v_: alpha * m_ / (torch.sqrt(v_) + eps),
                       m, v)
        return upd, {"m": m, "v": v}


@dataclasses.dataclass
class AdamW(Adam):
    """Adam plus decoupled weight decay, added to the update scaled by the
    learning rate (the reference's WeightDecay with applyLR=true)."""

    weight_decay: float = 0.01

    def apply(self, state, grads, iteration, epoch=0, params=None):
        upd, new_state = super().apply(state, grads, iteration, epoch)
        if params is not None and self.weight_decay:
            lr = self.lr_at(iteration, epoch)
            upd = tree_map(lambda u, p: u + lr * self.weight_decay * p, upd, params)
        return upd, new_state


@dataclasses.dataclass
class AMSGrad(IUpdater):
    """Adam on the running maximum of the second moment (``vhat``)."""

    learning_rate: Any = 1e-3
    beta1: float = 0.9
    beta2: float = 0.999
    epsilon: float = 1e-8

    def init_state(self, params):
        z = _zeros_like_tree
        return {"m": z(params), "v": z(params), "vhat": z(params)}

    def apply(self, state, grads, iteration, epoch=0, params=None):
        eps = self.epsilon
        alpha = _adam_alpha(self, iteration, epoch)
        m, v = _moments(state, grads, self.beta1, self.beta2)
        vhat = tree_map(torch.maximum, state["vhat"], v)
        upd = tree_map(lambda m_, vh: alpha * m_ / (torch.sqrt(vh) + eps),
                       m, vhat)
        return upd, {"m": m, "v": v, "vhat": vhat}


@dataclasses.dataclass
class Nadam(IUpdater):
    """update = lr * (b1*mhat + (1-b1)*g/(1-b1^t)) / (sqrt(vhat) + eps)."""

    learning_rate: Any = 1e-3
    beta1: float = 0.9
    beta2: float = 0.999
    epsilon: float = 1e-8

    def init_state(self, params):
        return {"m": _zeros_like_tree(params), "v": _zeros_like_tree(params)}

    def apply(self, state, grads, iteration, epoch=0, params=None):
        lr = self.lr_at(iteration, epoch)
        t = _step_t(iteration)
        b1, b2, eps = self.beta1, self.beta2, self.epsilon
        one_minus_b1t = 1.0 - _f32(b1) ** t
        one_minus_b2t = 1.0 - _f32(b2) ** t
        m, v = _moments(state, grads, b1, b2)

        def leaf(m_, v_, g):
            mhat = m_ / one_minus_b1t
            vhat = v_ / one_minus_b2t
            return lr * (b1 * mhat + (1 - b1) * g / one_minus_b1t) / (torch.sqrt(vhat) + eps)

        return tree_map(leaf, m, v, grads), {"m": m, "v": v}


@dataclasses.dataclass
class AdaMax(IUpdater):
    """Adam under the infinity norm: u = max(b2*u, |g|);
    update = lr/(1-b1^t) * m / (u + eps)."""

    learning_rate: Any = 1e-3
    beta1: float = 0.9
    beta2: float = 0.999
    epsilon: float = 1e-8

    def init_state(self, params):
        return {"m": _zeros_like_tree(params), "u": _zeros_like_tree(params)}

    def apply(self, state, grads, iteration, epoch=0, params=None):
        t = _step_t(iteration)
        b1, b2, eps = self.beta1, self.beta2, self.epsilon
        m = tree_map(lambda m_, g: b1 * m_ + (1 - b1) * g, state["m"], grads)
        u = tree_map(lambda u_, g: torch.maximum(b2 * u_, torch.abs(g)), state["u"], grads)
        alpha = _f32(self.lr_at(iteration, epoch)) / (1.0 - _f32(b1) ** t)
        upd = tree_map(lambda m_, u_: alpha * m_ / (u_ + eps), m, u)
        return upd, {"m": m, "u": u}


@dataclasses.dataclass
class AdaGrad(IUpdater):
    """h += g^2; update = lr * g / (sqrt(h) + eps)."""

    learning_rate: Any = 1e-1
    epsilon: float = 1e-6

    def init_state(self, params):
        return _zeros_like_tree(params)

    def apply(self, state, grads, iteration, epoch=0, params=None):
        lr = self.lr_at(iteration, epoch)
        h = tree_map(lambda h_, g: h_ + g * g, state, grads)
        upd = tree_map(lambda h_, g: lr * g / (torch.sqrt(h_) + self.epsilon), h, grads)
        return upd, h


@dataclasses.dataclass
class RmsProp(IUpdater):
    """r = rho*r + (1-rho)*g^2; update = lr*g / sqrt(r + eps) (epsilon
    inside the sqrt, as in the reference)."""

    learning_rate: Any = 1e-1
    rms_decay: float = 0.95
    epsilon: float = 1e-8

    def init_state(self, params):
        return _zeros_like_tree(params)

    def apply(self, state, grads, iteration, epoch=0, params=None):
        lr = self.lr_at(iteration, epoch)
        rho = self.rms_decay
        r = tree_map(lambda r_, g: rho * r_ + (1 - rho) * g * g, state, grads)
        upd = tree_map(lambda r_, g: lr * g / torch.sqrt(r_ + self.epsilon), r, grads)
        return upd, r


@dataclasses.dataclass
class AdaDelta(IUpdater):
    """No learning rate (the reference's AdaDelta has rho and epsilon
    only); state ``{"msg", "msdx"}``."""

    learning_rate: Any = 0.0  # unused
    rho: float = 0.95
    epsilon: float = 1e-6

    def init_state(self, params):
        return {"msg": _zeros_like_tree(params), "msdx": _zeros_like_tree(params)}

    def apply(self, state, grads, iteration, epoch=0, params=None):
        rho, eps = self.rho, self.epsilon
        msg = tree_map(lambda a, g: rho * a + (1 - rho) * g * g, state["msg"], grads)
        upd = tree_map(lambda msg_, msdx_, g: g * torch.sqrt(msdx_ + eps) / torch.sqrt(msg_ + eps),
                       msg, state["msdx"], grads)
        msdx = tree_map(lambda a, d: rho * a + (1 - rho) * d * d, state["msdx"], upd)
        return upd, {"msg": msg, "msdx": msdx}


UPDATERS: Dict[str, type] = {
    c.__name__: c
    for c in [Sgd, NoOp, Nesterovs, Adam, AdamW, AMSGrad, Nadam, AdaMax,
              AdaGrad, RmsProp, AdaDelta]
}


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
