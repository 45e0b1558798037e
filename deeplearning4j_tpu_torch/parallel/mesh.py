"""Device mesh over the ranks of a process group (the port of
``parallel/mesh.py``).

The JAX package's mesh names the axes of an array of devices that one
program drives.  The port runs one process per rank (``torch.distributed``:
NCCL with one card a rank, gloo on the CPU), so a :class:`Mesh` names axes
over the ranks of the default process group; this process is one of them
and owns one device.  Axis convention as in the JAX package: ``data``
(data parallelism), ``model``, ``pipe``, ``seq``.  Only ``data`` may be
wider than 1 here: tensor, pipeline and sequence parallelism are not
ported.

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
    number of ranks, ``rank`` this process's place in ``ranks`` and
    ``device`` the device this process computes on."""

    def __init__(self, axes: Dict[str, int], ranks: Sequence[int], rank: int,
                 device: torch.device, distributed: bool):
        self.shape: Dict[str, int] = dict(axes)
        self.axis_names: Tuple[str, ...] = tuple(axes)
        self.ranks: Tuple[int, ...] = tuple(ranks)
        self.rank = int(rank)
        self.device = device
        self.distributed = bool(distributed)

    @property
    def size(self) -> int:
        return len(self.ranks)

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
    by default; ``"cpu"`` where the caller asks)."""
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
    wide = {a: n for a, n in axes.items() if a != "data" and n > 1}
    if wide:
        raise NotImplementedError(
            f"mesh axes {wide}: only the data axis is ported (tensor, pipeline "
            "and sequence parallelism are not)")
    if ranks != list(range(world)):
        raise NotImplementedError(
            f"a mesh over ranks {ranks} of a world of {world}: only a mesh over "
            "every rank of the default process group is ported")
    if distributed:
        dev = _group_device(dist.get_backend(), device)
        return Mesh(axes, ranks, dist.get_rank(), dev, True)
    return Mesh(axes, ranks, 0, resolve_device(device), False)


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
