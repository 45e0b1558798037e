"""Parameter sharding rules: tensor parallelism (the port of
``parallel/sharding.py``).

Weight matrices are annotated with :class:`PartitionSpec`s over the
``model`` mesh axis.  Rules are ordered (regex -> spec) pairs matched
against a parameter's path in the JAX package's tree (``layer_0/W``) with
its JAX shape (a conv ``W`` in HWIO), so a user's rules mean the same in
both packages; the default splits the last dim of a >= 2-D leaf over
``model`` where the axis divides it (the output dim of a Dense ``W``, the
output channels of a conv ``W``) and replicates everything else.

The JAX package places each leaf with its ``NamedSharding`` and XLA
inserts the collectives.  The port stores this rank's block of each
sharded leaf (:func:`shard_model_params`; the spec mapped through the
layer's ``TORCH_LAYOUT``: a conv's HWIO dim 3 is its OIHW dim 0) and a
:class:`TensorParallel` transform on the network computes with it:

* a Dense or Output layer whose ``W`` is split on its output dim runs
  column-parallel: its product on the local ``[K, N/m]`` block
  (``fused_dense`` where the activation is an epilogue one), then an
  all-gather of the output features before anything that needs all of
  them; the input's gradient is summed over the ``model`` group;
* any other sharded leaf (a conv filter, a bias under ``P("model")``) is
  gathered where it is used; its gradient is this rank's block of the
  whole gradient (every ``model`` rank ran the same rows, so it is not
  summed over them).

``net.params()``, ``state_dict()``, ``save`` and the sharded checkpoint
see the whole leaves (:meth:`TensorParallel.gathered`); the updater state
of a sharded leaf is kept as blocks that follow the parameter's spec.
"""
from __future__ import annotations

import contextlib
import dataclasses
import re
from typing import Any, Dict, List, Optional, Tuple

import torch


class PartitionSpec(tuple):
    """One entry per dim of a leaf: a mesh axis name it is split over, or
    None (replicated on that dim); shorter than the leaf's rank means the
    rest are None (``jax.sharding.PartitionSpec``)."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple(self)!r}"


P = PartitionSpec


def path_str(path) -> str:
    """The JAX package's ``_path_str``: a tree path joined by ``/``."""
    return "/".join(str(p) for p in path)


@dataclasses.dataclass
class ShardingRules:
    """Ordered (regex -> PartitionSpec) rules applied to param-tree paths
    (first match wins).  `None` entries in a spec mean replicate that dim."""

    rules: List[Tuple[str, PartitionSpec]] = dataclasses.field(default_factory=list)
    model_axis: str = "model"

    def add(self, pattern: str, spec: PartitionSpec) -> "ShardingRules":
        self.rules.append((pattern, spec))
        return self

    def spec_for(self, path: str, shape: Tuple[int, ...], mesh) -> PartitionSpec:
        for pattern, spec in self.rules:
            if re.search(pattern, path):
                return spec
        return self._default_spec(path, shape, mesh)

    def _default_spec(self, path: str, shape, mesh) -> PartitionSpec:
        """Megatron-style default: split a >= 2-D leaf's last dim over
        `model` when the axis exists and divides it; the rest replicated."""
        if self.model_axis not in mesh.axis_names:
            return P()
        size = mesh.shape[self.model_axis]
        if len(shape) >= 2 and shape[-1] % size == 0 and shape[-1] >= size:
            return P(*([None] * (len(shape) - 1) + [self.model_axis]))
        return P()


@dataclasses.dataclass(frozen=True)
class LeafShard:
    """How one leaf is split: `spec` in the JAX layout, `dim` the port
    layout's dim it splits over `axis` (n ways), `shape` the leaf's whole
    shape in the port layout."""

    spec: PartitionSpec
    dim: int
    axis: str
    n: int
    shape: Tuple[int, ...]


def _inverse(perm):
    return tuple(sorted(range(len(perm)), key=lambda i: perm[i]))


def _split_dims(spec: PartitionSpec, shape_port: Tuple[int, ...], perm, mesh,
                path: str) -> List[Tuple[int, Tuple[str, ...]]]:
    """(port-layout dim, mesh axes) of each dim that the JAX-layout `spec`
    splits over axes wider than 1, as ``NamedSharding`` reads a spec: an
    entry is an axis name or a tuple of them (the dim split over their
    product, row-major)."""
    parts = list(spec) + [None] * (len(shape_port) - len(spec))
    out = []
    for d_jax, entry in enumerate(parts):
        if entry is None:
            continue
        axes = tuple(entry) if isinstance(entry, (tuple, list)) else (entry,)
        for a in axes:
            if a not in mesh.shape:
                raise ValueError(f"{path}: spec {spec!r} names axis {a!r}, not on the mesh "
                                 f"{mesh.shape}")
        axes = tuple(a for a in axes if mesh.shape[a] > 1)
        if not axes:
            continue
        d = d_jax if perm is None else list(perm).index(d_jax)
        n = 1
        for a in axes:
            n *= mesh.shape[a]
        if shape_port[d] % n:
            raise ValueError(f"{path}: dim of size {shape_port[d]} does not split over "
                             f"axes {axes} of size {n}")
        out.append((d, axes))
    return out


def leaf_shard(spec: PartitionSpec, shape_port: Tuple[int, ...], perm, mesh,
               path: str) -> Optional[LeafShard]:
    """The split of one leaf whose JAX-layout spec is `spec` (None where
    it is replicated on the mesh), for the wrapper's tensor parallelism,
    which computes with a leaf split on one dim over one axis: a split
    over two dims or over a tuple of axes raises (``shard_model_params``
    places any spec)."""
    dims = _split_dims(spec, shape_port, perm, mesh, path)
    if not dims:
        return None
    if len(dims) > 1 or len(dims[0][1]) > 1:
        raise NotImplementedError(f"{path}: spec {spec!r} splits more than one dim or "
                                  "over a tuple of axes: the wrapper's tensor parallelism "
                                  "computes with one axis on one dim (shard_model_params "
                                  "places the spec)")
    d, (axis,) = dims[0]
    return LeafShard(spec, d, axis, mesh.shape[axis], tuple(shape_port))


def _jax_shape(t: torch.Tensor, perm) -> Tuple[int, ...]:
    return tuple(t.shape) if perm is None else tuple(t.shape[i] for i in _inverse(perm))


def plan_shards(net, mesh, rules: Optional[ShardingRules] = None) -> Dict[str, Dict]:
    """{layer: {key: LeafShard}} for the network's sharded leaves (nested
    as the parameter tree), from the rules on the JAX paths and shapes."""
    from deeplearning4j_tpu_torch import convert
    rules = rules or ShardingRules()

    def walk(tree, name, layout, path):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                sub = walk(v, name, layout, path + (k,))
                if sub:
                    out[k] = sub
                continue
            perm = layout.get(k)
            p = path_str((name,) + path + (k,))
            spec = rules.spec_for(p, _jax_shape(v, perm), mesh)
            ls = leaf_shard(spec, tuple(v.shape), perm, mesh, p)
            if ls is not None:
                if ls.axis == "data":
                    raise NotImplementedError(
                        f"{p}: the wrapper's tensor parallelism does not split a parameter "
                        "over the data axis (its rows differ there); shard_model_params "
                        "places such a spec, and optimizer_sharding shards the update")
                out[k] = ls
        return out

    plans = {}
    for name, sub in net.params_.items():
        layout = convert._layer_or_layout(net, name).TORCH_LAYOUT or {}
        got = walk(sub, name, layout, ())
        if got:
            plans[name] = got
    return plans


def _block(t: torch.Tensor, ls: LeafShard, coord: int) -> torch.Tensor:
    per = ls.shape[ls.dim] // ls.n
    return t.narrow(ls.dim, coord * per, per)


def shard_model_params(params: Any, mesh, rules: Optional[ShardingRules] = None,
                       layouts: Optional[Dict[str, Dict]] = None) -> Any:
    """This rank's block of every leaf of a ``{layer: {key: tensor}}``
    tree under the rules (copies; replicated leaves as they are), for any
    spec JAX's ``NamedSharding`` takes: several split dims, a dim split
    over a tuple of axes (row-major over them), the ``data`` axis too.
    `layouts` gives each layer's ``TORCH_LAYOUT`` (default: every leaf in
    the JAX layout).  A quantized leaf (``QTensor``) is a node of two
    leaves, as in the JAX package's tree: its int8 ``q`` and its
    per-channel ``scale`` each take their own rule (the default splits
    both on the channel dim, so they split alike)."""
    from deeplearning4j_tpu_torch.ops.quant_kernels import QTensor
    rules = rules or ShardingRules()
    layouts = layouts or {}

    def one(v, name, path, perm):
        p = path_str((name,) + path)
        dims = _split_dims(rules.spec_for(p, _jax_shape(v, perm), mesh), tuple(v.shape),
                           perm, mesh, p)
        for d, axes in dims:
            n, c = 1, 0
            for a in axes:                       # row-major over the tuple's axes
                n, c = n * mesh.shape[a], c * mesh.shape[a] + mesh.coordinate(a)
            per = v.shape[d] // n
            v = v.narrow(d, c * per, per)
        return v.clone() if dims else v

    def walk(tree, name, path):
        out = {}
        for k, v in tree.items():
            perm = layouts.get(name, {}).get(k)
            if isinstance(v, dict):
                out[k] = walk(v, name, path + (k,))
            elif isinstance(v, QTensor):
                out[k] = QTensor(one(v.q, name, path + (k, "q"), perm),
                                 one(v.scale, name, path + (k, "scale"), perm), v.axis)
            else:
                out[k] = one(v, name, path + (k,), perm)
        return out
    return {name: walk(sub, name, ()) if isinstance(sub, dict) else sub
            for name, sub in params.items()}


def gathered_leaf(leaf, shape, mesh, axis: str = "model"):
    """A leaf that `shard_model_params` may have cut (a tensor or a
    ``QTensor``) made whole again at `shape` (the port layout's) by an
    all-gather over `axis` on the dim it was cut on; whole leaves as they
    are.  Collective over the axis where anything is gathered."""
    from deeplearning4j_tpu_torch.ops.quant_kernels import QTensor
    from deeplearning4j_tpu_torch.parallel.collectives import _gather

    def whole(t):
        if tuple(t.shape) == tuple(shape):
            return t
        d = next(i for i, (a, b) in enumerate(zip(t.shape, shape)) if a != b)
        return _gather(t, mesh, axis, d)
    if isinstance(leaf, QTensor):
        if tuple(leaf.q.shape) == tuple(shape):
            return leaf
        d = next(i for i, (a, b) in enumerate(zip(leaf.q.shape, shape)) if a != b)
        scale = leaf.scale if leaf.scale.shape[d] == 1 else _gather(leaf.scale, mesh, axis, d)
        return QTensor(_gather(leaf.q, mesh, axis, d), scale, leaf.axis)
    return whole(leaf)


def _holder(net, name: str):
    """The module holding layer `name`'s parameters."""
    vertices = getattr(net, "vertices", None)
    return vertices[name] if vertices is not None else getattr(net, name)


def _walk(plan, fn, *trees, prefix=()):
    """fn(path, LeafShard, *leaves) over `plan`'s leaves; returns a dict of
    the results (nested as `plan`)."""
    out = {}
    for k, ls in plan.items():
        if isinstance(ls, dict):
            out[k] = _walk(ls, fn, *(t[k] for t in trees), prefix=prefix + (k,))
        else:
            out[k] = fn(prefix + (k,), ls, *(t[k] for t in trees))
    return out


class TensorParallel:
    """The tensor-parallel transform a network carries (``net._tp``; see
    the module docstring): `plans` ({layer: {key: LeafShard}}, from
    :func:`plan_shards`) says which leaves are split, over which axis and
    on which dim.  Installed by ``ParallelWrapper(..., sharding_rules=)``;
    every rank of the mesh runs the same calls."""

    def __init__(self, mesh, plans: Dict[str, Dict]):
        self.mesh = mesh
        self.plans = plans
        self.sharded = False
        self._depth = 0

    def leaf_keys(self) -> frozenset:
        """(layer, dotted key) of every split leaf (ZeRO-1 leaves them
        alone: the rules win per leaf)."""
        out = set()
        for name, plan in self.plans.items():
            _walk(plan, lambda path, ls: out.add((name, ".".join(path))))
        return frozenset(out)

    # ---- placement ----
    def _leaf_info(self, net, name):
        """Layer `name`'s parameter tree with each leaf's LeafShard, or its
        shape where it is replicated (for ``tree_map_like_params``)."""
        plan = self.plans[name]

        def info(tree, sub):
            return {k: (info(v, sub.get(k, {})) if isinstance(v, dict)
                        else sub.get(k, tuple(v.shape))) for k, v in tree.items()}
        return info(net.params_[name], plan)

    def _shape_of(self, blocks: bool):
        def shape_of(i):
            if isinstance(i, LeafShard):
                if not blocks:
                    return i.shape
                return tuple(d // i.n if j == i.dim else d for j, d in enumerate(i.shape))
            return i
        return shape_of

    @torch.no_grad()
    def shard_(self, net) -> None:
        """Every sharded leaf becomes this rank's block, as a new Parameter
        (copied), and the updater state's moments of it too."""
        if self.sharded:
            return
        from deeplearning4j_tpu_torch.train.updaters import tree_map_like_params
        for name, plan in self.plans.items():
            infos = self._leaf_info(net, name)

            def cut(path, ls, p):
                return _block(p, ls, self.mesh.coordinate(ls.axis)).contiguous().clone()
            params = net.params_[name]
            blocks = _walk(plan, cut, params)
            self._install(net, name, plan, blocks, params)
            if net.opt_state_ is not None:
                net.opt_state_[name] = tree_map_like_params(
                    lambda sub, isub: _map_info(sub, isub, lambda t, ls: _block(
                        t, ls, self.mesh.coordinate(ls.axis)).contiguous().clone()),
                    net.opt_state_[name], infos, lambda s: s, shape_of=self._shape_of(False))
        self.sharded = True
        net._scan_step = None

    @torch.no_grad()
    def unshard_(self, net) -> None:
        """The inverse of :meth:`shard_`: whole leaves (all-gathered) as new
        Parameters, and whole moments."""
        if not self.sharded:
            return
        from deeplearning4j_tpu_torch.parallel.collectives import _gather
        from deeplearning4j_tpu_torch.train.updaters import tree_map_like_params
        for name, plan in self.plans.items():
            infos = self._leaf_info(net, name)
            params = net.params_[name]
            whole = _walk(plan, lambda path, ls, p: _gather(p.detach(), self.mesh, ls.axis,
                                                            ls.dim).contiguous(), params)
            self._install(net, name, plan, whole, params)
            if net.opt_state_ is not None:
                net.opt_state_[name] = tree_map_like_params(
                    lambda sub, isub: _map_info(sub, isub, lambda t, ls: _gather(
                        t, self.mesh, ls.axis, ls.dim).contiguous()),
                    net.opt_state_[name], infos, lambda s: s, shape_of=self._shape_of(True))
        self.sharded = False
        net._scan_step = None

    @staticmethod
    def _install(net, name, plan, new, old) -> None:
        holder = _holder(net, name)

        def put(mod, sub_plan, sub_new, sub_old):
            for k, v in sub_plan.items():
                if isinstance(v, dict):
                    put(getattr(mod, k), v, sub_new[k], sub_old[k])
                else:
                    mod.register_parameter(k, torch.nn.Parameter(
                        sub_new[k], requires_grad=sub_old[k].requires_grad))
        put(holder, plan, new, old)

    @contextlib.contextmanager
    def gathered(self, net):
        """Within the block the network holds whole leaves and computes as
        the plain network does (``net._tp`` is None); on leaving, each
        rank's blocks are cut again from the (possibly rewritten) whole
        leaves.  Collective: every rank enters it.  Reentrant."""
        if self._depth:
            self._depth += 1
            try:
                yield
            finally:
                self._depth -= 1
            return
        self._depth = 1
        self.unshard_(net)
        net._tp = None
        try:
            yield
        finally:
            net._tp = self
            self.shard_(net)
            self._depth = 0

    # ---- the step ----
    def _gather_leaves(self, plan, p):
        from deeplearning4j_tpu_torch.parallel.collectives import gather_from
        out = dict(p)
        for k, ls in plan.items():
            if isinstance(ls, dict):
                out[k] = self._gather_leaves(ls, p[k])
            else:
                out[k] = gather_from(p[k], self.mesh, ls.axis, ls.dim)
        return out

    def _column(self, name, layer) -> Optional[LeafShard]:
        """W's split where layer `name` runs column-parallel: a Dense or
        Output layer whose W splits on its output dim (and its bias, if
        split, likewise)."""
        from deeplearning4j_tpu_torch.nn.layers import DenseLayer
        plan = self.plans.get(name, {})
        w = plan.get("W")
        if not isinstance(layer, DenseLayer) or not isinstance(w, LeafShard) or w.dim != 1:
            return None
        b = plan.get("b")
        if set(plan) - {"W", "b"} or (b is not None and (b.axis != w.axis or b.dim != 0)):
            return None
        return w

    def _column_params(self, name, layer, p):
        """Layer `name`'s W block and the matching block of its bias (cut
        here where the rules leave the bias whole)."""
        from deeplearning4j_tpu_torch.parallel.collectives import scatter_to
        out = {"W": p["W"]}
        if layer.has_bias:
            out["b"] = p["b"] if "b" in self.plans[name] else scatter_to(
                p["b"], self.mesh, self.plans[name]["W"].axis, 0)
        return out

    def apply(self, name, layer, p, s, x, **kw):
        """Layer `name`'s forward on this rank's blocks."""
        plan = self.plans.get(name)
        if not plan:
            return layer.apply(p, s, x, **kw)
        if self._column(name, layer) is None:
            return layer.apply(self._gather_leaves(plan, p), s, x, **kw)
        from deeplearning4j_tpu_torch.parallel.collectives import copy_to, gather_from
        axis, blocks = plan["W"].axis, self._column_params(name, layer, p)
        if layer.epilogue() is not None:
            # the layer's own fused_dense on the blocks; an elementwise
            # activation commutes with the gather of the features
            y, s = layer.apply(blocks, s, copy_to(x, self.mesh, axis), **kw)
            return gather_from(y, self.mesh, axis, -1), s
        x = copy_to(layer.prepare(x, kw.get("train", False), kw.get("rng")), self.mesh, axis)
        y = gather_from(layer.pre_activation(blocks, x), self.mesh, axis, -1)
        return layer.act_fn()(y), s

    def compute_loss(self, name, head, p, s, x, labels, **kw):
        """A loss head's loss on this rank's blocks: the logits gathered
        before the loss."""
        plan = self.plans.get(name)
        if not plan:
            return head.compute_loss(p, s, x, labels, **kw)
        if self._column(name, head) is None:
            return head.compute_loss(self._gather_leaves(plan, p), s, x, labels, **kw)
        from deeplearning4j_tpu_torch.ops.losses import apply_loss
        from deeplearning4j_tpu_torch.parallel.collectives import copy_to, gather_from
        axis = plan["W"].axis
        x = copy_to(head.prepare(x, kw.get("train", True), kw.get("rng")), self.mesh, axis)
        pre = gather_from(head.logits(self._column_params(name, head, p), x), self.mesh, axis, -1)
        return apply_loss(head.loss, head.act_fn(), pre, labels, kw.get("mask"))

    def penalty_reduce(self, params):
        """The `reduce` of ``reg_penalty``: a sharded leaf's l1/l2 term
        summed over its axis (every rank's loss holds the whole penalty;
        the backward of the sum is the identity)."""
        from deeplearning4j_tpu_torch.parallel.collectives import reduce_from
        axes = {}
        for name, plan in self.plans.items():
            _walk(plan, lambda path, ls, leaf: axes.__setitem__(id(leaf), ls.axis),
                  params[name])

        def reduce(w, term):
            axis = axes.get(id(w))
            return term if axis is None else reduce_from(term, self.mesh, axis)
        return reduce

    def normalized(self, name, grads, mode, threshold):
        """A gradient normalization of layer `name` over its whole
        gradient: the blocks gathered, normalized, cut again."""
        from deeplearning4j_tpu_torch.parallel.collectives import _gather
        from deeplearning4j_tpu_torch.train.updaters import apply_gradient_normalization
        plan = self.plans.get(name)
        if not plan:
            return apply_gradient_normalization(grads, mode, threshold)

        def whole(tree, sub):
            return {k: (whole(v, sub[k]) if isinstance(v, dict) else
                        _gather(v, self.mesh, sub[k].axis, sub[k].dim) if k in sub else v)
                    for k, v in tree.items()}

        def blocks(tree, sub):
            return {k: (blocks(v, sub[k]) if isinstance(v, dict) else
                        _block(v, sub[k], self.mesh.coordinate(sub[k].axis)) if k in sub
                        else v) for k, v in tree.items()}
        return blocks(apply_gradient_normalization(whole(grads, plan), mode, threshold), plan)


def _map_info(sub, infos, fn):
    """fn(tensor, LeafShard) over a moment tree's sharded leaves."""
    return {k: (_map_info(v, infos[k], fn) if isinstance(v, dict) else
                fn(v, infos[k]) if isinstance(infos[k], LeafShard) else v)
            for k, v in sub.items()}


def whole(net):
    """A context in which the network holds whole leaves: the tensor-
    parallel transform's :meth:`TensorParallel.gathered`, or nothing
    where it has none."""
    tp = getattr(net, "_tp", None)
    return tp.gathered(net) if tp is not None else contextlib.nullcontext()
