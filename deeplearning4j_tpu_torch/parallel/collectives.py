"""The shard_map collectives over one axis of a :class:`~.mesh.Mesh`
(port-only: the JAX package calls ``jax.lax`` inside ``shard_map``).

Each function runs over this rank's process subgroup along `axis`
(``mesh.group(axis)``) and is differentiable.  At an axis of size 1 it is
the identity (or this rank's whole tensor) and makes no collective call.

=========================  ==================================  ==========================
JAX                        here                                backward
=========================  ==================================  ==========================
``axis_index``             ``mesh.coordinate(axis)``           --
``psum``                   :func:`psum` (``all_reduce``)       ``psum``
``all_gather(tiled=True)`` :func:`all_gather`                  ``psum_scatter``
``psum_scatter(tiled)``    :func:`psum_scatter`                ``all_gather``
``ppermute``               :func:`ppermute`                    the inverse permutation
=========================  ==================================  ==========================

Their backwards are the adjoints of the forwards as linear maps across the
ranks, so the gradient a rank receives is that of the sum of every rank's
objective: a program whose ranks each hold their own part of the
activations (a sequence chunk, a pipeline stage, a microbatch) gets the
gradient of the whole.

Where every rank of the axis computes the same values (a tensor-parallel
layer inside a data-parallel step, a pipeline's replicated output), the
objective of the whole is each rank's own, not their sum, and the
Megatron pairs apply:

* :func:`copy_to` is the identity, its backward a ``psum`` (the input of a
  column-parallel product, whose ranks each see part of the gradient);
* :func:`reduce_from` is a ``psum``, its backward the identity (a partial
  result made whole and then used alike on every rank);
* :func:`gather_from` all-gathers, its backward keeps this rank's block of
  the (alike) gradient;
* :func:`scatter_to` keeps this rank's block, its backward all-gathers.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch


def _dist():
    import torch.distributed as dist
    return dist


def _size(mesh, axis: str) -> int:
    return mesh.shape[axis]


def _sum(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    out = x.contiguous().clone()
    _dist().all_reduce(out, group=mesh.group(axis))
    return out


def _gather(x: torch.Tensor, mesh, axis: str, dim: int) -> torch.Tensor:
    n = _size(mesh, axis)
    front = x.movedim(dim, 0).contiguous()
    out = front.new_empty((n * front.shape[0],) + tuple(front.shape[1:]))
    _dist().all_gather_into_tensor(out, front, group=mesh.group(axis))
    return out.movedim(0, dim)


def _scatter_sum(x: torch.Tensor, mesh, axis: str, dim: int) -> torch.Tensor:
    n = _size(mesh, axis)
    front = x.movedim(dim, 0).contiguous()
    if front.shape[0] % n:
        raise ValueError(f"psum_scatter: dim {dim} of size {front.shape[0]} does not "
                         f"split over axis {axis!r} of size {n}")
    out = front.new_empty((front.shape[0] // n,) + tuple(front.shape[1:]))
    _dist().reduce_scatter_tensor(out, front, group=mesh.group(axis))
    return out.movedim(0, dim)


def _block(x: torch.Tensor, mesh, axis: str, dim: int) -> torch.Tensor:
    n = _size(mesh, axis)
    if x.shape[dim] % n:
        raise ValueError(f"dim {dim} of size {x.shape[dim]} does not split over "
                         f"axis {axis!r} of size {n}")
    per = x.shape[dim] // n
    return x.narrow(dim, mesh.coordinate(axis) * per, per)


def _permute(x: torch.Tensor, mesh, axis: str,
             perm: Sequence[Tuple[int, int]]) -> torch.Tensor:
    """Send to the destinations of this rank's coordinate and receive from
    its sources (zeros where no one sends), in one batch of point-to-point
    operations."""
    dist = _dist()
    me = mesh.coordinate(axis)
    line = mesh.line(axis)
    group = mesh.group(axis)
    x = x.contiguous()
    out = torch.zeros_like(x)
    ops = []
    for src, dst in perm:
        if src == me:
            ops.append(dist.P2POp(dist.isend, x, line[dst], group))
        if dst == me:
            ops.append(dist.P2POp(dist.irecv, out, line[src], group))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return out


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return _sum(x, mesh, axis)

    @staticmethod
    def backward(ctx, g):
        return _sum(g, ctx.mesh, ctx.axis), None, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        return _gather(x, mesh, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return _scatter_sum(g, ctx.mesh, ctx.axis, ctx.dim), None, None, None


class _PsumScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        return _scatter_sum(x, mesh, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return _gather(g, ctx.mesh, ctx.axis, ctx.dim), None, None, None


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, perm):
        ctx.mesh, ctx.axis, ctx.perm = mesh, axis, perm
        return _permute(x, mesh, axis, perm)

    @staticmethod
    def backward(ctx, g):
        inverse = tuple((d, s) for s, d in ctx.perm)
        return _permute(g, ctx.mesh, ctx.axis, inverse), None, None, None


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _sum(g, ctx.mesh, ctx.axis), None, None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        return _sum(x, mesh, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        return _gather(x, mesh, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return _block(g, ctx.mesh, ctx.axis, ctx.dim).contiguous(), None, None, None


class _ScatterTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        return _block(x, mesh, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return _gather(g, ctx.mesh, ctx.axis, ctx.dim), None, None, None


def psum(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """``lax.psum``: the sum over the axis, on every rank of it."""
    return x if _size(mesh, axis) == 1 else _Psum.apply(x, mesh, axis)


def all_gather(x: torch.Tensor, mesh, axis: str, dim: int = 0) -> torch.Tensor:
    """``lax.all_gather(tiled=True)``: the ranks' blocks concatenated along
    `dim` in axis order."""
    return x if _size(mesh, axis) == 1 else _AllGather.apply(x, mesh, axis, dim)


def psum_scatter(x: torch.Tensor, mesh, axis: str, dim: int = 0) -> torch.Tensor:
    """``lax.psum_scatter(tiled=True)``: this rank's block along `dim` of
    the sum over the axis."""
    return x if _size(mesh, axis) == 1 else _PsumScatter.apply(x, mesh, axis, dim)


def ppermute(x: torch.Tensor, mesh, axis: str,
             perm: Sequence[Tuple[int, int]]) -> torch.Tensor:
    """``lax.ppermute``: `perm` holds (source, destination) coordinates
    along the axis; a rank no one sends to gets zeros.  At size 1 the
    identity where (0, 0) is in `perm`."""
    perm = tuple((int(s), int(d)) for s, d in perm)
    if _size(mesh, axis) == 1:
        return x if (0, 0) in perm else torch.zeros_like(x)
    return _PPermute.apply(x, mesh, axis, perm)


def ring_perm(n: int) -> Tuple[Tuple[int, int], ...]:
    """Each coordinate to the next, the last to the first."""
    return tuple((j, (j + 1) % n) for j in range(n))


def copy_to(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """Identity forward, ``psum`` backward."""
    return x if _size(mesh, axis) == 1 else _CopyTo.apply(x, mesh, axis)


def reduce_from(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """``psum`` forward, identity backward."""
    return x if _size(mesh, axis) == 1 else _ReduceFrom.apply(x, mesh, axis)


def gather_from(x: torch.Tensor, mesh, axis: str, dim: int) -> torch.Tensor:
    """All-gather forward; the backward keeps this rank's block."""
    return x if _size(mesh, axis) == 1 else _GatherFrom.apply(x, mesh, axis, dim)


def scatter_to(x: torch.Tensor, mesh, axis: str, dim: int) -> torch.Tensor:
    """This rank's block forward; the backward all-gathers."""
    return x if _size(mesh, axis) == 1 else _ScatterTo.apply(x, mesh, axis, dim)


def block_of(x: torch.Tensor, mesh, axis: str, dim: int) -> torch.Tensor:
    """This rank's block of `x` along `dim` (a view; no gradient rule)."""
    return x if _size(mesh, axis) == 1 else _block(x, mesh, axis, dim)
