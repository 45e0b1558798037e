"""Device mesh over the ranks of a process group (the port of
``parallel/mesh.py``).

The JAX package's mesh names the axes of an array of devices that one
program drives.  The port runs one process per rank (``torch.distributed``:
NCCL with one card a rank, gloo on the CPU), so a :class:`Mesh` names axes
over the ranks of the default process group; this process is one of them
and owns one device.  Axis convention as in the JAX package: ``data``
(data parallelism), ``model`` (tensor parallelism), ``pipe`` (pipeline
stages), ``seq`` (sequence/context parallelism).  Ranks sit on the mesh in
row-major order over the axes, as JAX's ``np.array(devices).reshape``
places devices, so :meth:`Mesh.coordinate` is JAX's ``axis_index``.

An axis wider than 1 gets its process subgroups when the mesh is made: one
``dist.new_group`` for each line of the mesh along that axis, built in the
same order on every rank (so every rank calls :func:`make_mesh` with the
same axes, in the same order, as every rank joins a JAX mesh).
:meth:`Mesh.group` is this rank's line along an axis: the group the
shard_map collectives of ``parallel/collectives.py`` run over.  A ``data``
axis that spans the whole world is the default group itself.  ``with mesh:``
makes it the :func:`current_mesh` that ``ring_attention`` and the pipeline
read when no mesh is passed, as JAX's ``with mesh:`` does.

A mesh over part of the ranks (``make_mesh(axes, devices=ranks)``) is built
the same way on every rank of the default group, since ``dist.new_group``
is collective over it: its lines' subgroups and :attr:`Mesh.group_all`,
the subgroup of its ranks, in place of the default group.  Only its ranks
take part in its collectives; on a rank outside it the mesh is a
non-member (:attr:`Mesh.member` False), and a mesh over one rank runs no
collective at all.

With no process group, :func:`make_mesh` is the one-rank mesh of this
process's device (``jax.devices()`` in one process); the device rule of
every entry point holds (``"cuda"`` unless the caller asks for the CPU).

:func:`data_sharding` and :func:`replicated` are placement descriptors
that ``data/pipeline.py`` understands: a :class:`Placement` stages this
rank's row window of a global batch (or the whole array) onto the mesh's
device.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch.utils.devices import resolve_device


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """Named axis sizes, e.g. {'data': 4}.  Axis order follows insertion
    order; sizes must multiply to the number of ranks used."""

    axes: Dict[str, int]

    def total(self) -> int:
        n = 1
        for v in self.axes.values():
            n *= v
        return n


class Mesh:
    """Named axes over `ranks` of the default process group (None: no
    group, one rank).  ``shape`` maps axis names to sizes, ``size`` is the
    number of ranks, ``rank`` this process's place in ``ranks`` (-1 on a
    rank outside them), ``device`` the device this process computes on and
    ``group_all`` the process group of the mesh's ranks (None: the default
    group)."""

    def __init__(self, axes: Dict[str, int], ranks: Sequence[int], rank: int,
                 device: torch.device, distributed: bool, groups=None, group_all=None):
        self.shape: Dict[str, int] = dict(axes)
        self.axis_names: Tuple[str, ...] = tuple(axes)
        self.ranks: Tuple[int, ...] = tuple(ranks)
        self.rank = int(rank)
        self.device = device
        self.distributed = bool(distributed)
        self._groups = dict(groups or {})
        self.group_all = group_all

    @property
    def size(self) -> int:
        return len(self.ranks)

    @property
    def member(self) -> bool:
        """Whether this process is one of the mesh's ranks."""
        return self.rank >= 0

    @property
    def src(self) -> int:
        """The global rank of the mesh's first rank (a broadcast's
        source)."""
        return self.ranks[0]

    def group(self, axis: str):
        """This rank's process subgroup along `axis` (None: the default
        group, for a ``data`` axis over the whole world).  Raises for an
        axis of size 1, which needs no collective."""
        if self.shape[axis] == 1:
            raise ValueError(f"mesh axis {axis!r} has size 1: it has no group")
        return self._groups.get(axis)

    def line(self, axis: str) -> Tuple[int, ...]:
        """The global ranks of this rank's line along `axis`, in axis
        order."""
        return tuple(self.ranks[p] for p in _line(self.shape, self.rank, axis))

    def __enter__(self) -> "Mesh":
        _current.stack = getattr(_current, "stack", []) + [self]
        return self

    def __exit__(self, *exc) -> None:
        _current.stack.pop()

    def coordinate(self, axis: str) -> int:
        """This rank's index along `axis` (row-major over the axes)."""
        idx = self.rank
        names = list(self.axis_names)
        for name in reversed(names[names.index(axis) + 1:]):
            idx //= self.shape[name]
        return idx % self.shape[axis]

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, rank {self.rank} of {self.size}, "
                f"device {self.device})")


_current = threading.local()


def current_mesh() -> Optional[Mesh]:
    """The innermost mesh entered with ``with mesh:`` on this thread."""
    stack = getattr(_current, "stack", [])
    return stack[-1] if stack else None


def resolve_mesh(mesh: Optional[Mesh]) -> Mesh:
    """`mesh`, else the current one; raises where there is neither."""
    mesh = mesh if mesh is not None else current_mesh()
    if mesh is None:
        raise ValueError("no mesh: pass mesh= or call inside `with mesh:`")
    return mesh


def _line(shape: Dict[str, int], rank: int, axis: str) -> Tuple[int, ...]:
    grid = np.arange(int(np.prod(list(shape.values())))).reshape(tuple(shape.values()))
    at = np.unravel_index(rank, grid.shape)
    i = list(shape).index(axis)
    idx = tuple(slice(None) if j == i else at[j] for j in range(len(at)))
    return tuple(int(r) for r in grid[idx])


def _axis_groups(shape: Dict[str, int], ranks: Sequence[int], whole, rank: int):
    """One ``dist.new_group`` for each line of the mesh along each axis
    wider than 1, in axis order then line order (the same calls on every
    rank of the default group); returns this rank's group for each such
    axis.  A ``data`` axis over all of the mesh's ranks is `whole`, the
    mesh's own group (None: the default group)."""
    import torch.distributed as dist
    grid = np.asarray(ranks).reshape(tuple(shape.values()))
    out = {}
    for i, (axis, n) in enumerate(shape.items()):
        if n == 1:
            continue
        if n == len(ranks) and axis == "data":
            out[axis] = whole
            continue
        lines = np.moveaxis(grid, i, -1).reshape(-1, n)
        for line in lines:
            g = dist.new_group([int(r) for r in line])
            if rank in line:
                out[axis] = g
    return out


def _group_device(backend: str, device) -> torch.device:
    if device is not None:
        dev = resolve_device(device)
    elif backend == "nccl":
        dev = resolve_device(torch.device("cuda", torch.cuda.current_device()))
    else:
        dev = torch.device("cpu")
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError(f"an NCCL group computes on CUDA devices, not {dev}")
    if backend == "gloo" and dev.type == "cuda":
        raise ValueError("a gloo group runs the CPU path; a CUDA model needs an NCCL "
                         "group (initialize() on a machine with cards)")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def make_mesh(axes: Optional[Dict[str, int]] = None,
              devices: Optional[Sequence[int]] = None, device=None) -> Mesh:
    """A Mesh over the ranks `devices` (default: every rank of the default
    process group).  With no axes given, a pure data-parallel mesh over
    them.  With no process group, the one-rank mesh of `device` (``"cuda"``
    by default; ``"cpu"`` where the caller asks).  Every rank of the
    default group calls it with the same axes and ranks: an axis wider
    than 1 builds its subgroups here, and a mesh over part of the ranks
    its own group too (a rank outside it gets a non-member mesh)."""
    import torch.distributed as dist
    distributed = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size() if distributed else 1
    ranks = list(devices) if devices is not None else list(range(world))
    if axes is None:
        axes = {"data": len(ranks)}
    spec = MeshSpec(dict(axes))
    if spec.total() != len(ranks):
        raise ValueError(f"Mesh axes {axes} require {spec.total()} ranks, "
                         f"have {len(ranks)}")
    if sorted(set(ranks)) != sorted(ranks) or any(not 0 <= r < world for r in ranks):
        raise ValueError(f"mesh ranks {ranks}: want distinct ranks of a world of {world}")
    if not distributed:
        return Mesh(axes, ranks, 0, resolve_device(device), False)
    dev = _group_device(dist.get_backend(), device)
    me = dist.get_rank()
    pos = ranks.index(me) if me in ranks else -1
    if ranks == list(range(world)):
        return Mesh(axes, ranks, pos, dev, True, _axis_groups(dict(axes), ranks, None, me))
    if len(ranks) == 1:
        # one rank: no collective, so no group (nothing is called on the others)
        return Mesh(axes, ranks, pos, dev, False)
    whole = dist.new_group(ranks)
    return Mesh(axes, ranks, pos, dev, True, _axis_groups(dict(axes), ranks, whole, me),
                group_all=whole)


@dataclasses.dataclass(frozen=True)
class Placement:
    """Where a staged array lands: the mesh's device and, for ``"data"``,
    only this rank's row window of `batch_dim` (the global batch split
    evenly over the data axis); ``"replicated"`` stages the whole array."""

    kind: str
    mesh: Mesh
    axis: str = "data"
    batch_dim: int = 0

    @property
    def device(self) -> torch.device:
        return self.mesh.device

    def window(self, a):
        """This rank's part of `a` (numpy or tensor), a view where `a` is
        one; raises where the batch does not split evenly."""
        if self.kind == "replicated" or a is None:
            return a
        n = self.mesh.shape[self.axis]
        b = int(np.shape(a)[self.batch_dim])
        if b % n:
            raise ValueError(f"Batch size {b} not divisible by data-parallel "
                             f"degree {n}")
        r = self.mesh.coordinate(self.axis)
        per = b // n
        idx = (slice(None),) * self.batch_dim + (slice(r * per, (r + 1) * per),)
        return a[idx]


def data_sharding(mesh: Mesh, axis: str = "data", batch_dim: int = 0) -> Placement:
    """Placement of a batch: its `batch_dim` split over `axis`, this rank
    staging its own rows."""
    return Placement("data", mesh, axis, batch_dim)


def replicated(mesh: Mesh) -> Placement:
    return Placement("replicated", mesh)
