"""Gradient updaters (the port of ``train/updaters.py``).

The configs keep the JAX package's fields and JSON form, and the update
math of all eleven (Sgd, NoOp, Nesterovs, Adam, AdamW, AMSGrad, Nadam,
AdaMax, AdaGrad, RmsProp, AdaDelta) follows the JAX formulas line for line:
epsilon where the JAX package puts it, the bias corrections taken in the
dtype it takes them in, and the same state keys (the zip stores the state in
key order).  ``apply_gradient_normalization`` is the JAX package's too.  An updater is a function
over a tree of tensors (a vertex's ``{param key: tensor}``, nested dicts
allowed): ``init_state(params)`` gives its state and
``apply(state, grads, iteration, epoch, params)`` returns
``(update, state)``.  ``apply`` writes the new state into the tensors of
`state` in place (each with the roundings of the JAX formula, so a
carried state keeps its addresses and is read and written once a step)
and never writes to the gradients; the network subtracts the returned
update from its parameters in place under ``torch.no_grad()``, as the
reference's optimizer loop does (``params.subi(update)``).

Every per-step scalar (the learning rate, Adam's bias corrections) comes
from ``scalars(iteration, epoch, dtype)``: 0-dim tensors computed from the
iteration and epoch counters.  A training step passes the int32 counter
tensors of its device (``utils/counters.py``), so the scalars are computed
there and a captured CUDA graph replays them from the current counts; it
computes them once a step per distinct updater (:class:`StepScalars`) and
hands them to ``apply``.  Python ints give the same scalars as CPU tensors.
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


def tree_map_like_params(fn: Callable[[Tree, Tree], Tree], state: Tree, params: Tree,
                         fallback: Callable[[Tree], Tree],
                         shape_of: Callable[[Any], Tuple[int, ...]] = None) -> Tree:
    """Map over the parts of an updater-state tree that mirror the
    parameters' tree (the JAX package's ``tree_map_like_params``).

    Every ``init_state`` builds its state from parameter-shaped moment
    trees, nested in different ways: per-layer states ``{"m": layer_params,
    "v": ...}``, a network's ``{layer: state}``, and Sgd/NoOp's ``()``.  This
    walks `state` from the top and, at every subtree whose dict structure
    and per-leaf shapes (``shape_of(param_leaf)``, the leaf's own shape by
    default) match `params`, calls ``fn(state_sub, param_sub)``; dict levels
    that do not match recurse (descending `params` by key where it has
    the key), and anything else gets ``fallback(sub)`` (step counts,
    scalars, empty states)."""
    if shape_of is None:
        def shape_of(p):
            return tuple(p.shape)

    def structure(t):
        if isinstance(t, dict):
            return tuple((k, structure(t[k])) for k in sorted(t))
        return None

    def matches(sub, psub):
        if not isinstance(sub, dict) or structure(sub) != structure(psub):
            return False
        s_leaves, p_leaves = list(tree_leaves(sub)), list(tree_leaves(psub))
        return bool(s_leaves) and all(
            isinstance(a, torch.Tensor) and tuple(a.shape) == tuple(shape_of(b))
            for a, b in zip(s_leaves, p_leaves))

    def walk(sub, psub):
        if matches(sub, psub):
            return fn(sub, psub)
        if isinstance(sub, dict):
            return {k: walk(v, psub[k] if isinstance(psub, dict) and k in psub else psub)
                    for k, v in sub.items()}
        return fallback(sub)

    return walk(state, params)


def _zeros_like_tree(params: Tree) -> Tree:
    return tree_map(lambda p: torch.zeros_like(p, requires_grad=False), params)


def scalar_dtype(tree: Tree) -> torch.dtype:
    """The dtype of a step's learning rate: f64 for f64 parameters, else
    f32 (the JAX package computes its schedules in the default float type,
    f64 only with x64 on)."""
    for leaf in tree_leaves(tree):
        if isinstance(leaf, torch.Tensor) and leaf.dtype == torch.float64:
            return torch.float64
    return torch.float32


def _counter(c) -> torch.Tensor:
    return c if isinstance(c, torch.Tensor) else torch.tensor(int(c), dtype=torch.int32)


class StepScalars:
    """One training step's updater scalars, computed once a step for each
    distinct updater (by identity) from the step's counter tensors, so an
    eager step launches no per-layer scalar work."""

    def __init__(self, iteration: torch.Tensor, epoch: torch.Tensor,
                 dtype: torch.dtype = torch.float32):
        self.iteration, self.epoch, self.dtype = iteration, epoch, dtype
        self._memo: Dict[int, Dict[str, torch.Tensor]] = {}

    def of(self, updater: "IUpdater") -> Dict[str, torch.Tensor]:
        got = self._memo.get(id(updater))
        if got is None:
            got = self._memo[id(updater)] = updater.scalars(
                self.iteration, self.epoch, self.dtype)
        return got


@dataclasses.dataclass
class IUpdater:
    """Base updater config."""

    learning_rate: Any = 1e-3  # float or ISchedule

    def lr_at(self, iteration, epoch=0) -> float:
        return resolve_schedule(self.learning_rate).value_at(iteration, epoch)

    def scalars(self, iteration, epoch=0, dtype=torch.float32) -> Dict[str, torch.Tensor]:
        """This step's scalars as 0-dim tensors on the counters' device:
        ``lr`` in `dtype` (the schedule's tensor form), and the updater's
        own (``alpha``, the bias corrections) in the dtype the JAX package
        promotes them to.  `iteration` and `epoch` are int32 tensors or ints."""
        it, ep = _counter(iteration), _counter(epoch)
        return {"lr": resolve_schedule(self.learning_rate).value_tensor(it, ep, dtype)}

    def init_state(self, params: Tree) -> Tree:
        return ()

    def apply(self, state: Tree, grads: Tree, iteration, epoch=0,
              params: Tree = None, scalars=None) -> Tuple[Tree, Tree]:
        """Returns (update_to_subtract, state), the new state written into
        `state`'s tensors in place.  `params` is given for
        updaters that read the current parameters (decoupled weight
        decay); the others ignore it.  `scalars` are this step's
        ``scalars(iteration, epoch, dtype)``, computed here when not
        given."""
        raise NotImplementedError

    def _scalars(self, scalars, iteration, epoch, grads) -> Dict[str, torch.Tensor]:
        return scalars if scalars is not None else self.scalars(
            iteration, epoch, scalar_dtype(grads))

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
    def apply(self, state, grads, iteration, epoch=0, params=None, scalars=None):
        lr = self._scalars(scalars, iteration, epoch, grads)["lr"]
        return tree_map(lambda g: lr * g, grads), state


@dataclasses.dataclass
class NoOp(IUpdater):
    """Gradient passed through unmodified."""

    def apply(self, state, grads, iteration, epoch=0, params=None, scalars=None):
        return grads, state


@dataclasses.dataclass
class Nesterovs(IUpdater):
    """Nesterov momentum, the cs231n formulation of the reference:
    v_new = mu*v - lr*g; update = mu*v - (1+mu)*v_new (subtracted)."""

    learning_rate: Any = 0.1
    momentum: float = 0.9

    def init_state(self, params):
        return _zeros_like_tree(params)

    def apply(self, state, grads, iteration, epoch=0, params=None, scalars=None):
        lr = self._scalars(scalars, iteration, epoch, grads)["lr"]
        mu = self.momentum

        def leaf(v, g):
            mv = mu * v
            torch.sub(mv, lr * g, out=v)            # v <- mu*v - lr*g
            return mv.sub_((1.0 + mu) * v)

        return tree_map(leaf, state, grads), state


def _step_t(iteration) -> torch.Tensor:
    """The 1-based step count as the f32 scalar the JAX package raises the
    betas to."""
    return _counter(iteration).to(torch.float32) + 1.0


def _alpha_lr(u, lr: torch.Tensor) -> torch.Tensor:
    """The learning rate as it meets the f32 bias terms of alpha.  The JAX
    package's lr is weakly typed, so alpha stays f32, unless the schedule
    gives a strongly typed value (``ISchedule.STRONG``: an f64 one under
    x64), which promotes alpha to its dtype."""
    return lr if resolve_schedule(u.learning_rate).STRONG else lr.to(torch.float32)


def _adam_scalars(u, iteration, epoch, dtype) -> Dict[str, torch.Tensor]:
    """lr, and alpha = lr * sqrt(1 - b2^t) / (1 - b1^t) (Adam, AdamW,
    AMSGrad), in f32 unless the lr is strongly typed (``_alpha_lr``)."""
    s = IUpdater.scalars(u, iteration, epoch, dtype)
    t = _step_t(iteration)
    s["alpha"] = (_alpha_lr(u, s["lr"]) * torch.sqrt(1.0 - torch.pow(u.beta2, t))
                  / (1.0 - torch.pow(u.beta1, t)))
    return s


def _moments(state, grads, b1, b2):
    """m <- b1*m + (1-b1)*g and v <- b2*v + (1-b2)*g*g, in place."""
    m = tree_map(lambda m_, g: m_.mul_(b1).add_((1 - b1) * g), state["m"], grads)
    v = tree_map(lambda v_, g: v_.mul_(b2).add_((1 - b2) * g * g), state["v"], grads)
    return m, v


@dataclasses.dataclass
class Adam(IUpdater):
    """Adam with epsilon outside the sqrt: alpha_t = lr*sqrt(1-b2^t)/(1-b1^t);
    update = alpha_t * m / (sqrt(v) + eps).  alpha_t is taken in the JAX
    package's promoted dtype (``_alpha_lr``)."""

    learning_rate: Any = 1e-3
    beta1: float = 0.9
    beta2: float = 0.999
    epsilon: float = 1e-8

    def init_state(self, params):
        return {"m": _zeros_like_tree(params), "v": _zeros_like_tree(params)}

    def scalars(self, iteration, epoch=0, dtype=torch.float32):
        return _adam_scalars(self, iteration, epoch, dtype)

    def apply(self, state, grads, iteration, epoch=0, params=None, scalars=None):
        eps = self.epsilon
        alpha = self._scalars(scalars, iteration, epoch, grads)["alpha"]
        m, v = _moments(state, grads, self.beta1, self.beta2)
        upd = tree_map(lambda m_, v_: alpha * m_ / (torch.sqrt(v_) + eps),
                       m, v)
        return upd, state


@dataclasses.dataclass
class AdamW(Adam):
    """Adam plus decoupled weight decay, added to the update scaled by the
    learning rate (the reference's WeightDecay with applyLR=true)."""

    weight_decay: float = 0.01

    def apply(self, state, grads, iteration, epoch=0, params=None, scalars=None):
        scalars = self._scalars(scalars, iteration, epoch, grads)
        upd, new_state = super().apply(state, grads, iteration, epoch, scalars=scalars)
        if params is not None and self.weight_decay:
            lr = scalars["lr"]
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

    def scalars(self, iteration, epoch=0, dtype=torch.float32):
        return _adam_scalars(self, iteration, epoch, dtype)

    def apply(self, state, grads, iteration, epoch=0, params=None, scalars=None):
        eps = self.epsilon
        alpha = self._scalars(scalars, iteration, epoch, grads)["alpha"]
        m, v = _moments(state, grads, self.beta1, self.beta2)
        vhat = tree_map(lambda vh, v_: torch.maximum(vh, v_, out=vh), state["vhat"], v)
        upd = tree_map(lambda m_, vh: alpha * m_ / (torch.sqrt(vh) + eps),
                       m, vhat)
        return upd, state


@dataclasses.dataclass
class Nadam(IUpdater):
    """update = lr * (b1*mhat + (1-b1)*g/(1-b1^t)) / (sqrt(vhat) + eps)."""

    learning_rate: Any = 1e-3
    beta1: float = 0.9
    beta2: float = 0.999
    epsilon: float = 1e-8

    def init_state(self, params):
        return {"m": _zeros_like_tree(params), "v": _zeros_like_tree(params)}

    def scalars(self, iteration, epoch=0, dtype=torch.float32):
        s = super().scalars(iteration, epoch, dtype)
        t = _step_t(iteration)
        s["one_minus_b1t"] = 1.0 - torch.pow(self.beta1, t)
        s["one_minus_b2t"] = 1.0 - torch.pow(self.beta2, t)
        return s

    def apply(self, state, grads, iteration, epoch=0, params=None, scalars=None):
        s = self._scalars(scalars, iteration, epoch, grads)
        lr, one_minus_b1t, one_minus_b2t = s["lr"], s["one_minus_b1t"], s["one_minus_b2t"]
        b1, b2, eps = self.beta1, self.beta2, self.epsilon
        m, v = _moments(state, grads, b1, b2)

        def leaf(m_, v_, g):
            mhat = m_ / one_minus_b1t
            vhat = v_ / one_minus_b2t
            return lr * (b1 * mhat + (1 - b1) * g / one_minus_b1t) / (torch.sqrt(vhat) + eps)

        return tree_map(leaf, m, v, grads), state


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

    def scalars(self, iteration, epoch=0, dtype=torch.float32):
        s = super().scalars(iteration, epoch, dtype)
        s["alpha"] = _alpha_lr(self, s["lr"]) / (
            1.0 - torch.pow(self.beta1, _step_t(iteration)))
        return s

    def apply(self, state, grads, iteration, epoch=0, params=None, scalars=None):
        alpha = self._scalars(scalars, iteration, epoch, grads)["alpha"]
        b1, b2, eps = self.beta1, self.beta2, self.epsilon
        m = tree_map(lambda m_, g: m_.mul_(b1).add_((1 - b1) * g), state["m"], grads)
        u = tree_map(lambda u_, g: torch.maximum(u_.mul_(b2), torch.abs(g), out=u_),
                     state["u"], grads)
        upd = tree_map(lambda m_, u_: alpha * m_ / (u_ + eps), m, u)
        return upd, state


@dataclasses.dataclass
class AdaGrad(IUpdater):
    """h += g^2; update = lr * g / (sqrt(h) + eps)."""

    learning_rate: Any = 1e-1
    epsilon: float = 1e-6

    def init_state(self, params):
        return _zeros_like_tree(params)

    def apply(self, state, grads, iteration, epoch=0, params=None, scalars=None):
        lr = self._scalars(scalars, iteration, epoch, grads)["lr"]
        h = tree_map(lambda h_, g: h_.add_(g * g), state, grads)
        upd = tree_map(lambda h_, g: lr * g / (torch.sqrt(h_) + self.epsilon), h, grads)
        return upd, state


@dataclasses.dataclass
class RmsProp(IUpdater):
    """r = rho*r + (1-rho)*g^2; update = lr*g / sqrt(r + eps) (epsilon
    inside the sqrt, as in the reference)."""

    learning_rate: Any = 1e-1
    rms_decay: float = 0.95
    epsilon: float = 1e-8

    def init_state(self, params):
        return _zeros_like_tree(params)

    def apply(self, state, grads, iteration, epoch=0, params=None, scalars=None):
        lr = self._scalars(scalars, iteration, epoch, grads)["lr"]
        rho = self.rms_decay
        r = tree_map(lambda r_, g: r_.mul_(rho).add_((1 - rho) * g * g), state, grads)
        upd = tree_map(lambda r_, g: lr * g / torch.sqrt(r_ + self.epsilon), r, grads)
        return upd, state


@dataclasses.dataclass
class AdaDelta(IUpdater):
    """No learning rate in the update (the reference's AdaDelta has rho and
    epsilon only); state ``{"msg", "msdx"}``.  Its ``lr`` scalar (0 by
    default) still scales the network's weight decay, as the JAX package's
    ``lr_at`` does."""

    learning_rate: Any = 0.0  # scales weight decay only
    rho: float = 0.95
    epsilon: float = 1e-6

    def init_state(self, params):
        return {"msg": _zeros_like_tree(params), "msdx": _zeros_like_tree(params)}

    def apply(self, state, grads, iteration, epoch=0, params=None, scalars=None):
        rho, eps = self.rho, self.epsilon
        msg = tree_map(lambda a, g: a.mul_(rho).add_((1 - rho) * g * g), state["msg"], grads)
        upd = tree_map(lambda msg_, msdx_, g: g * torch.sqrt(msdx_ + eps) / torch.sqrt(msg_ + eps),
                       msg, state["msdx"], grads)
        tree_map(lambda a, d: a.mul_(rho).add_((1 - rho) * d * d), state["msdx"], upd)
        return upd, state


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
