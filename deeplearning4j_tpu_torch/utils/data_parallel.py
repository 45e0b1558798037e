"""The data-parallel step: what a training step does differently when it
runs as one rank of a data-parallel group (the SPMD semantics of the JAX
package's ``parallel/wrapper.py``, made explicit).

The JAX wrapper is one program over a device mesh: its data-parallel step
is the single-device step on the global batch, and XLA's partitioner makes
every reduction over the batch a reduction over the whole mesh.  The port
runs one process per rank, each on its own rows of the global batch, so
the step makes those reductions global itself (``torch.distributed``:
NCCL on the card, gloo on the CPU):

* a loss's mean over examples becomes the rank's share of the global mean:
  an unmasked mean is divided by the group size (every rank holds as many
  rows), and a masked mean is divided by the global mask sum
  (:func:`global_count`, one all-reduce of a scalar), so a padded final
  batch whose zero-mask rows sit on the last rank only keeps the JAX
  denominator;
* the l1/l2 penalty is divided by the group size, so it counts once;
* the gradients are summed over the group (:meth:`DataParallelStep.
  reduce_gradients`): the gradient of the global mean, in a few flat
  buckets per dtype, not one collective per tensor;
* BatchNormalization's training statistics are taken over the global batch
  (:func:`global_moments`: one all-reduce of the per-channel sum, sum of
  squares and count; its backward all-reduces the two per-channel gradient
  sums);
* the loss the step reports is the sum of the ranks' shares, the global
  mean (:meth:`DataParallelStep.global_loss`).

:func:`active` installs a step for the forward of one training step;
layers and losses read it through :func:`current`.  Without one (no
wrapper), every helper returns its argument, so the step is unchanged bit
for bit.  A one-rank group takes its BatchNorm statistics as the plain
layer does (they are the global ones), so a one-rank step equals the plain
step bit for bit with its collectives in place.

Each collective the step issues adds one to ``collectives`` (a launch
count, as the kernels' wrappers keep: a CUDA-graph replay does not tick
it).
"""
from __future__ import annotations

import contextlib
import threading
from typing import Dict, Iterator, List, Optional, Tuple

import torch

#: most bytes a gradient bucket holds (a bucket is one all-reduce)
BUCKET_BYTES = 32 * 1024 * 1024

_local = threading.local()


def current() -> Optional["DataParallelStep"]:
    """The data-parallel step installed for this thread's forward, or None."""
    return getattr(_local, "step", None)


@contextlib.contextmanager
def active(step: Optional["DataParallelStep"]) -> Iterator[None]:
    """Within the block, `current()` is `step` (None leaves it unset)."""
    prev = current()
    _local.step = step
    try:
        yield
    finally:
        _local.step = prev


def mean_share(mean: torch.Tensor) -> torch.Tensor:
    """An unmasked mean over this rank's rows as its share of the global
    mean (every rank holds as many rows)."""
    step = current()
    if step is None or step.size == 1:
        return mean
    return mean / step.size


def global_count(count: torch.Tensor) -> torch.Tensor:
    """A masked mean's denominator (a sum of mask entries) summed over the
    group."""
    step = current()
    if step is None:
        return count
    return step.all_reduce(count.detach().clone())


def penalty_share(penalty):
    """The l1/l2 penalty's share on this rank, so the summed loss counts it
    once."""
    step = current()
    if step is None or step.size == 1:
        return penalty
    return penalty / step.size


def global_moments(xs: torch.Tensor, dims: Tuple[int, ...]):
    """(E[xs], E[xs * xs]) per channel over the global batch, or None where
    the plain layer's local statistics are the global ones (no step, or a
    one-rank group)."""
    step = current()
    if step is None or step.size == 1:
        return None
    return _GlobalMoments.apply(xs, dims, step)


class _GlobalMoments(torch.autograd.Function):
    """Forward: one all-reduce of [sum xs, sum xs^2, count] over the group,
    then the two means.  Backward: one all-reduce of the two per-channel
    gradient sums (every rank's loss depends on every rank's rows through
    the global statistics), then the local rows' gradient."""

    @staticmethod
    def forward(ctx, xs, dims, step):
        c = xs.shape[-1]
        count = xs.numel() // max(c, 1)
        buf = torch.cat([torch.sum(xs, dim=dims), torch.sum(xs * xs, dim=dims),
                         torch.full((1,), float(count), dtype=xs.dtype, device=xs.device)])
        step.all_reduce(buf)
        n = buf[2 * c]
        ctx.save_for_backward(xs, n)
        ctx.step, ctx.c = step, c
        return buf[:c] / n, buf[c:2 * c] / n

    @staticmethod
    def backward(ctx, g1, g2):
        xs, n = ctx.saved_tensors
        c = ctx.c
        g = torch.cat([torch.zeros(c, dtype=xs.dtype, device=xs.device) if g1 is None else g1,
                       torch.zeros(c, dtype=xs.dtype, device=xs.device) if g2 is None else g2])
        ctx.step.all_reduce(g)
        return (g[:c] + 2.0 * xs * g[c:]) / n, None, None


class DataParallelStep:
    """One rank's part of a data-parallel training step over `group` (the
    default process group where None) of `size` ranks.  Without a process
    group (`distributed` False: a one-rank mesh, or a data axis of size 1
    on a wider mesh) the collectives are the identity.  `mesh` is the
    wrapper's mesh the step belongs to (the host of gradient sharing's
    split step)."""

    def __init__(self, size: int, distributed: bool = True, group=None, mesh=None):
        self.size = int(size)
        self.distributed = bool(distributed)
        self.group = group
        self.mesh = mesh
        self.collectives = 0
        self.last_buckets = 0

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """Sum `t` over the group, in place; returns it."""
        if self.distributed:
            import torch.distributed as dist
            self.collectives += 1
            dist.all_reduce(t, group=self.group)
        return t

    def global_loss(self, loss: torch.Tensor) -> torch.Tensor:
        """The step's reported loss: the ranks' shares summed."""
        return self.all_reduce(loss.detach().clone())

    def reduce_gradients(self, grads: Dict, skip=frozenset()) -> Dict:
        """`grads` (``{name: {key: tensor}}``, nested as the parameters)
        summed over the group, in buckets of one dtype of at most
        `BUCKET_BYTES` each, in tree order; the result's tensors are views
        of the buckets.  Leaves whose (name, key) is in `skip` pass
        through unreduced (ZeRO-1 reduce-scatters them itself)."""
        leaves: List[Tuple[Tuple[str, ...], torch.Tensor]] = list(_paths(grads))
        out = dict(leaves)
        buckets = bucketed([(p, g) for p, g in leaves
                            if (p[0], ".".join(p[1:])) not in skip], BUCKET_BYTES)
        for bucket in buckets:
            flat = torch.cat([g.reshape(-1) for _, g in bucket])
            self.all_reduce(flat)
            off = 0
            for p, g in bucket:
                out[p] = flat[off:off + g.numel()].view(g.shape)
                off += g.numel()
        self.last_buckets = len(buckets)
        return _rebuild(grads, out)


def bucketed(items, bucket_bytes: int):
    """(key, tensor) pairs grouped by dtype, in order, into buckets of at
    most `bucket_bytes` (a larger tensor is a bucket of its own)."""
    by_dtype: Dict[torch.dtype, list] = {}
    for key, t in items:
        by_dtype.setdefault(t.dtype, []).append((key, t))
    out = []
    for group in by_dtype.values():
        bucket, nbytes = [], 0
        for key, t in group:
            size = t.numel() * t.element_size()
            if bucket and nbytes + size > bucket_bytes:
                out.append(bucket)
                bucket, nbytes = [], 0
            bucket.append((key, t))
            nbytes += size
        if bucket:
            out.append(bucket)
    return out


def _paths(tree, prefix=()):
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _paths(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _rebuild(tree, by_path, prefix=()):
    return {k: (_rebuild(v, by_path, prefix + (k,)) if isinstance(v, dict)
                else by_path[prefix + (k,)]) for k, v in tree.items()}
