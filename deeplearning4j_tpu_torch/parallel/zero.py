"""ZeRO-1: the weight update sharded over the data axis (the port of
``parallel/zero.py``; Xu et al., arXiv:2004.13336).

Instead of every rank all-reducing whole gradients and running the whole
optimizer step on whole moments, each rank reduce-scatters the gradient,
runs the updater on its 1/N shard of the parameters and moments, and the
updated shards are all-gathered into the parameters for the next forward.
Same math; ~N times less optimizer state a rank.

The per-leaf policy is the JAX package's (:func:`build_plans`), taken in
the JAX package's layout of each parameter (a conv ``W`` is HWIO there,
OIHW in the port), so a rank's moment shards, the bytes they take
(:func:`opt_state_bytes_per_replica`) and the sharded checkpoint's chunks
are the JAX package's on the same mesh:

* a leaf whose leading dim (JAX layout) is at least N shards dim 0 over
  the data axis; a leading dim that N does not divide is zero-padded to the
  next multiple of N inside the step.  The parameter keeps its true shape
  on every rank; its moments are stored padded and sharded: rank r keeps
  rows [r * s, (r + 1) * s) of the padded leaf.  Zero pads are a fixed
  point of every elementwise updater (zero gradient, zero moment, zero
  update), so they never leak into values;
* tiny leaves (a bias narrower than the axis) stay replicated;
* a leaf that tensor-parallel sharding rules split (``parallel/
  sharding.py``) keeps its ``model`` blocks, and their moments follow it:
  the rules win per leaf, as in the JAX package.

In the step (``nn/multilayer.apply_updates``), after each layer's gradient
normalization: :meth:`Zero1Transform.scatter` (``reduce_scatter_tensor`` of
the padded dim-0 gradient over the data axis's subgroup; a layer with
gradient normalization needs its whole gradient, so its leaves are
all-reduced with the rest and scatter takes this rank's rows), the
updater and the decoupled weight decay on the
shard (:meth:`update_view`), then :meth:`restore`
(``all_gather_into_tensor`` into the padded leaf, unpadded and written into
the parameter in place).  With no process group (a one-rank mesh) the
collectives are copies.

:func:`reshard_zero1` moves the sharded state to another mesh when the
world changes (a member left or joined): the moments are gathered to
their true shapes over the old mesh (:func:`disable_zero1`, the portable
layout) and cut again for the new one, in process, the same unpad-then-
replan route the sharded checkpoint's loader takes from disk.
:func:`reshard_to_devices` does it for a data-axis mesh over given ranks.

A SameDiff graph takes the same transform over its ``variables_`` (one
plan a variable, :meth:`Zero1Transform.scatter` and friends with the name
None): every rank feeds the whole batch, so its gradients are equal on
every rank and ``scatter`` slices this rank's rows without a sum, as the
JAX graph's sharding constraint does.  Under hierarchical gradient
sharing on a host of several ranks, the leader gathers the host's shards
of each reduce-scattered leaf into the whole padded leaf before the gang
exchange, and the combined gradient goes back as each rank's rows
(``parallel/hierarchical.py`` ``HostLink``, ``nn/multilayer.py``
``exchange_gradients``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import torch

from deeplearning4j_tpu_torch.train.updaters import tree_map_like_params

Tree = Any


def _inverse(perm):
    return tuple(sorted(range(len(perm)), key=lambda i: perm[i]))


@dataclasses.dataclass(frozen=True)
class LeafPlan:
    """Per-parameter placement decision.  `shape` is the leaf's true shape
    in the JAX layout, `perm` the permutation taking that layout to the
    port's (None where they are the same), `pad` the zero rows that make
    dim 0 divide by the data-parallel degree `n`."""

    kind: str                 # "shard" | "repl"
    shape: Tuple[int, ...]
    pad: int
    n: int
    perm: Optional[Tuple[int, ...]] = None

    @property
    def padded_shape(self) -> Tuple[int, ...]:
        if not self.shape:
            return self.shape
        return (self.shape[0] + self.pad,) + tuple(self.shape[1:])

    @property
    def rows(self) -> int:
        """Rows of the padded leaf a rank keeps."""
        return self.padded_shape[0] // self.n

    @property
    def port_shape(self) -> Tuple[int, ...]:
        if self.perm is None:
            return self.shape
        return tuple(self.shape[i] for i in self.perm)

    @property
    def stored_shape(self) -> Tuple[int, ...]:
        """A moment's shape on one rank: the shard for a sharded leaf (JAX
        layout), the parameter's for a replicated one (port layout)."""
        if self.kind == "shard":
            return (self.rows,) + tuple(self.shape[1:])
        return self.port_shape

    def to_jax(self, t: torch.Tensor) -> torch.Tensor:
        return t if self.perm is None else t.permute(*_inverse(self.perm))

    def to_port(self, t: torch.Tensor) -> torch.Tensor:
        return t if self.perm is None else t.permute(*self.perm)


def build_plans(params: Tree, mesh, axis: str = "data", layout_of=None,
                exclude=frozenset()) -> Tree:
    """A `LeafPlan` for every parameter leaf (the tree of `params`, plans
    as leaves).  `layout_of(name)` gives layer `name`'s ``TORCH_LAYOUT``
    (``{key: permutation from the JAX layout}``); without it every layout
    is the JAX one.  Leaves whose (layer, dotted key) is in `exclude`
    (tensor-parallel blocks) stay replicated over the axis."""
    n = mesh.shape[axis]

    def plans(sub, layout, name, path=()):
        out = {}
        for k, v in sub.items():
            if isinstance(v, dict):
                out[k] = plans(v, layout, name, path + (k,))
                continue
            perm = layout.get(k)
            shape = tuple(v.shape) if perm is None else tuple(
                v.shape[i] for i in _inverse(perm))
            if (name, ".".join(path + (k,))) not in exclude and len(shape) >= 1 \
                    and shape[0] >= n:
                out[k] = LeafPlan("shard", shape, (-shape[0]) % n, n,
                                  None if perm is None else tuple(perm))
            else:
                out[k] = LeafPlan("repl", shape, 0, n, None if perm is None else tuple(perm))
        return out

    return {name: plans(sub, (layout_of(name) if layout_of is not None else {}) or {}, name)
            for name, sub in params.items()}


def _leaves_with_keys(tree, prefix=()):
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _leaves_with_keys(v, prefix + (k,))
        else:
            yield prefix + (k,), v


class Zero1Transform:
    """The step transform `apply_updates` threads through each layer (see
    the module docstring).  `scattered` holds the (layer, dotted key) of
    the leaves the step reduce-scatters (the data-parallel step leaves
    their gradients unreduced); every other sharded leaf arrives all-reduced
    and `scatter` takes this rank's rows of it."""

    def __init__(self, mesh, axis: str, plans: Tree, scattered=frozenset()):
        self.mesh = mesh
        self.axis = axis
        self.plans = plans
        self.scattered = frozenset(scattered)
        self.coord = mesh.coordinate(axis)

    def _sub(self, name: Optional[str]) -> Tree:
        """Layer `name`'s plans; None: the whole tree (a SameDiff graph's
        variables)."""
        return self.plans if name is None else self.plans[name]

    def _rows(self, pl: LeafPlan, full: torch.Tensor) -> torch.Tensor:
        return full[self.coord * pl.rows:(self.coord + 1) * pl.rows]

    def _padded(self, pl: LeafPlan, t: torch.Tensor) -> torch.Tensor:
        """Port-layout `t` as the contiguous padded JAX-layout leaf."""
        j = pl.to_jax(t)
        if pl.pad:
            j = torch.cat([j, j.new_zeros((pl.pad,) + tuple(j.shape[1:]))])
        return j.contiguous()

    def scatter(self, name: str, grads: Tree, reduced: bool = False) -> Tree:
        """This rank's update-layout gradient of layer `name`: the rows of
        the summed padded gradient for sharded leaves, the (all-reduced)
        gradient for replicated ones.  With `reduced`, the leaves the step
        reduce-scatters arrive as their shards already
        (:meth:`reduce_scatter`) and pass through."""
        def one(path, pl, g):
            if pl.kind != "shard":
                return g
            if (name, ".".join(path)) in self.scattered:
                return g if reduced else self._shard_of(pl, g)
            return self._rows(pl, self._padded(pl, g))
        return _map_paths(one, self._sub(name), grads)

    def reduce_scatter(self, name: str, grads: Tree) -> Tree:
        """Layer `name`'s gradient with each leaf the step reduce-scatters
        replaced by this rank's shard of its sum (the grad half of a split
        step ships these); every other leaf as it is."""
        return _map_paths(lambda path, pl, g: self._shard_of(pl, g)
                          if (name, ".".join(path)) in self.scattered else g,
                          self.plans[name], grads)

    def _shard_of(self, pl: LeafPlan, g: torch.Tensor) -> torch.Tensor:
        full = self._padded(pl, g)
        out = full.new_empty((pl.rows,) + tuple(full.shape[1:]))
        self._reduce_scatter(out, full)
        return out

    def update_view(self, name: str, params: Tree) -> Tree:
        """Layer `name`'s parameters as the updater sees them: this rank's
        rows of the padded JAX-layout leaf where sharded."""
        return _map_paths(lambda path, pl, p: self._rows(pl, self._padded(pl, p.detach()))
                          if pl.kind == "shard" else p, self._sub(name), params)

    @torch.no_grad()
    def restore(self, name: str, params: Tree, view: Tree, upd: Tree) -> None:
        """Subtract `upd` from the update view and write the result into
        layer `name`'s parameters in place: replicated leaves directly,
        sharded ones through an all-gather of the new shards."""
        def one(path, pl, p, v, u):
            if pl.kind != "shard":
                p.sub_(u)
                return p
            shard = (v - u).contiguous()
            full = shard.new_empty(pl.padded_shape)
            self._all_gather(full, shard)
            p.copy_(pl.to_port(full[:pl.shape[0]]))
            return p
        _map_paths(one, self._sub(name), params, view, upd)

    def constrain_opt(self, name: str, opt_state: Tree) -> Tree:
        """Layer `name`'s updater state as this rank keeps it: each moment
        of a sharded leaf cut to this rank's rows of its padded JAX-layout
        form (copies); everything else as it is."""
        def cut(sub, plan_sub):
            return _map_paths(lambda path, pl, s: self._rows(pl, self._padded(pl, s)).clone()
                              if pl.kind == "shard" else s, plan_sub, sub)
        return tree_map_like_params(cut, opt_state, self._sub(name), lambda s: s,
                                    shape_of=lambda pl: pl.port_shape)

    def gather_opt(self, name: str, opt_state: Tree) -> Tree:
        """The inverse of `constrain_opt`: whole moments at the parameters'
        true shapes and port layouts (one all-gather a sharded moment)."""
        def whole(sub, plan_sub):
            def one(path, pl, s):
                if pl.kind != "shard":
                    return s
                full = s.new_empty(pl.padded_shape)
                self._all_gather(full, s.contiguous())
                return pl.to_port(full[:pl.shape[0]]).contiguous()
            return _map_paths(one, plan_sub, sub)
        return tree_map_like_params(whole, opt_state, self._sub(name), lambda s: s,
                                    shape_of=lambda pl: pl.stored_shape)

    def _group(self):
        return self.mesh.group(self.axis) if self.mesh.shape[self.axis] > 1 else None

    def _reduce_scatter(self, out: torch.Tensor, full: torch.Tensor) -> None:
        if not self.mesh.distributed or (self.mesh.shape[self.axis] == 1 < self.mesh.size):
            out.copy_(full)
            return
        import torch.distributed as dist
        dist.reduce_scatter_tensor(out, full, group=self._group())

    def _all_gather(self, full: torch.Tensor, shard: torch.Tensor) -> None:
        if not self.mesh.distributed or (self.mesh.shape[self.axis] == 1 < self.mesh.size):
            full.copy_(shard)
            return
        import torch.distributed as dist
        dist.all_gather_into_tensor(full, shard, group=self._group())


def _map_paths(fn, plans: Tree, tree: Tree, *rest: Tree, prefix=()) -> Tree:
    """fn(key path, plan, leaf, *rest leaves) over `plans`' leaves."""
    out = {}
    for k, pl in plans.items():
        if isinstance(pl, dict):
            out[k] = _map_paths(fn, pl, tree[k], *(r[k] for r in rest), prefix=prefix + (k,))
        else:
            out[k] = fn(prefix + (k,), pl, tree[k], *(r[k] for r in rest))
    return out


def _invalidate_steps(model) -> None:
    model._scan_step = None


def _normalized_layers(model):
    """Names of the layers whose gradients go through a gradient
    normalization (the layer's own, else the configuration's)."""
    out = set()
    for name, layer in model._named_layers():
        own = layer is not None and layer.gradient_normalization is not None
        if (layer.gradient_normalization if own
                else model.conf.gradient_normalization):
            out.add(name)
    return out


def enable_zero1(model, mesh, axis: str = "data", exclude=frozenset()) -> Zero1Transform:
    """Turn on the sharded weight update for a MultiLayerNetwork,
    ComputationGraph or SameDiff graph: per-leaf plans, the moments cut to
    this rank's shards, the transform installed and the captured steps
    dropped.  Idempotent for an unchanged (mesh, axis).  Every rank calls
    it.  `exclude`: the (layer, dotted key) of tensor-parallel leaves.

    A SameDiff graph is planned over its ``variables_`` (enable it once the
    graph and its training configuration are final): every rank feeds the
    same whole batch, as the JAX graph does under ``with mesh:``, so its
    gradients are equal on every rank and ``scatter`` slices each rank's
    rows of them (JAX's ``with_sharding_constraint``) without a sum."""
    existing = getattr(model, "_step_transform", None)
    if existing is not None and existing.mesh is mesh and existing.axis == axis:
        return existing
    disable_zero1(model)
    if hasattr(model, "variables_"):
        if model.opt_state_ is None:
            cfg = model.training_config
            if cfg is None or cfg.updater is None:
                raise ValueError("optimizer sharding needs an updater: call "
                                 "set_training_config(...) first")
            model.opt_state_ = cfg.updater.init_state(model.variables_)
        # one "layer" of variables, in the JAX layout
        zt = Zero1Transform(mesh, axis, build_plans({None: model.variables_}, mesh, axis)[None])
        model.opt_state_ = zt.constrain_opt(None, model.opt_state_)
        model._step_transform = zt
        _invalidate_steps(model)
        return zt
    if getattr(model, "opt_state_", None) is None:
        raise ValueError("model must be initialized before optimizer sharding "
                         "(call init() first)")
    from deeplearning4j_tpu_torch import convert
    params = model.params_
    plans = build_plans(params, mesh, axis,
                        lambda name: convert._layer_or_layout(model, name).TORCH_LAYOUT,
                        exclude)
    normalized = _normalized_layers(model)
    scattered = {(name, ".".join(path)) for name in plans if name not in normalized
                 for path, pl in _leaves_with_keys(plans[name]) if pl.kind == "shard"}
    zt = Zero1Transform(mesh, axis, plans, scattered)
    model.opt_state_ = {name: zt.constrain_opt(name, sub)
                        for name, sub in model.opt_state_.items()}
    model._step_transform = zt
    _invalidate_steps(model)
    return zt


def disable_zero1(model) -> None:
    """Remove the step transform and gather the moments back to whole
    tensors at their true shapes (every rank calls it).  No-op when ZeRO-1
    was never enabled."""
    zt = getattr(model, "_step_transform", None)
    if zt is None:
        return
    if hasattr(model, "variables_"):
        model.opt_state_ = zt.gather_opt(None, model.opt_state_)
    else:
        model.opt_state_ = {name: zt.gather_opt(name, sub)
                            for name, sub in model.opt_state_.items()}
    model._step_transform = None
    _invalidate_steps(model)


def reshard_zero1(model, new_mesh, axis: str = "data",
                  rules=None) -> Optional[Zero1Transform]:
    """Re-shard a ZeRO-1 model onto a DIFFERENT mesh (an elastic world
    change: the data axis shrank or grew).  Every rank of the old mesh
    calls it: the old transform is torn down through `disable_zero1`
    (the moments gathered and unpadded to their true shapes), then the
    ranks of `new_mesh` enable it there, where `build_plans` derives the
    shard/replicate decisions and the padding for the new axis size.  A
    tensor-parallel model's split leaves keep their blocks, as in
    `enable_zero1` (`rules` is accepted for the JAX package's signature;
    the model's own tensor-parallel state names the leaves).  The step
    counters are the model's tensors and stay where they are.  Returns
    the new transform, or None on a rank outside `new_mesh`, which keeps
    whole moments."""
    disable_zero1(model)
    if not new_mesh.member:
        return None
    tp = getattr(model, "_tp", None)
    return enable_zero1(model, new_mesh, axis=axis,
                        exclude=tp.leaf_keys() if tp is not None else frozenset())


def reshard_to_devices(model, devices, axis: str = "data",
                       rules=None) -> Optional[Zero1Transform]:
    """A world change named by its ranks: re-shard the model's ZeRO-1
    state onto a fresh data-axis mesh over exactly `devices` (the
    surviving ranks after a shrink, or the grown world).  Every rank of
    the default group calls it (the mesh's groups are made here).  Returns
    the new transform, or None where ZeRO-1 was never enabled (a plain
    data-parallel model has no sharded moments to move) or on a rank
    outside `devices`."""
    if getattr(model, "_step_transform", None) is None:
        return None
    from deeplearning4j_tpu_torch.parallel.mesh import make_mesh
    mesh = make_mesh({axis: len(devices)}, devices=list(devices), device=model.device)
    return reshard_zero1(model, mesh, axis=axis, rules=rules)


def opt_state_bytes_per_replica(opt_state: Tree) -> int:
    """Optimizer-state bytes this rank holds: replicated leaves in full,
    sharded ones as their shards (the quantity the
    ``training_opt_state_bytes{sharded=}`` gauge reports)."""
    total = 0

    def walk(t):
        nonlocal total
        if isinstance(t, dict):
            for v in t.values():
                walk(v)
        elif isinstance(t, (list, tuple)):
            for v in t:
                walk(v)
        elif isinstance(t, torch.Tensor):
            total += t.numel() * t.element_size()
    walk(opt_state)
    return total
