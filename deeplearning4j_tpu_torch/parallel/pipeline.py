"""Pipeline parallelism: GPipe-style microbatched stages over the mesh
axis ``pipe`` (the port of ``parallel/pipeline.py``).

S identical stages sit on the S ranks of the axis, their parameters
stacked on a leading [S, ...] axis; M microbatches stream through M + S - 1
ticks.  At tick t stage s works on microbatch t - s and hands its output to
stage s + 1 (``ppermute`` over the axis's subgroup,
``parallel/collectives.py``); the last stage's outputs are then summed
over the axis one-hot, so every rank returns them.  Autograd through the
ticks is the reverse schedule: each rank gets its own stage's gradients,
and the input's gradient is summed over the stages (stage 0's), as JAX's
transpose of a replicated input gives.

Unlike the JAX program, which runs every stage every tick (the bubbles on
garbage), a rank skips its bubble ticks and sends zeros: the results are
the same.  Every rank of the axis calls :func:`pipeline_apply` with the
same batch.  Stages must be homogeneous; heterogeneous heads and
embeddings run outside the pipelined region.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from deeplearning4j_tpu_torch.parallel.collectives import _permute, _sum
from deeplearning4j_tpu_torch.parallel.mesh import resolve_mesh
from deeplearning4j_tpu_torch.train.updaters import tree_leaves, tree_map


def stack_stage_params(per_stage_params: list):
    """[params tree per stage] -> one tree with leaves stacked on axis 0."""
    return tree_map(lambda *leaves: torch.stack(leaves), *per_stage_params)


def stage_slice(stacked_params, mesh=None, axis: str = "pipe"):
    """This rank's stage of a stacked tree, as [1, ...] leaves (copies):
    what a rank keeps of the stacked parameters (``local=True`` below)."""
    mesh = resolve_mesh(mesh)
    s = mesh.coordinate(axis)
    return tree_map(lambda l: l[s:s + 1].clone(), stacked_params)


def _stages(stacked_params, S: int, axis: str, local: bool) -> int:
    n = next(iter(tree_leaves(stacked_params))).shape[0]
    if local and n != 1:
        raise ValueError(f"local stage params have {n} stages on their leading axis; "
                         "this rank's stage is one")
    if not local and n != S:
        raise ValueError(
            f"{n} stacked stages but mesh axis '{axis}' has {S} "
            "devices — stage count must equal the pipe-axis size")
    return n


def pipeline_apply(block_fn: Callable, stacked_params, x: torch.Tensor,
                   mesh=None, axis: str = "pipe",
                   num_microbatches: Optional[int] = None,
                   local: bool = False) -> torch.Tensor:
    """Run `x` through the S pipelined stages of `block_fn`.

    block_fn(stage_params, microbatch) -> microbatch (same shape).
    stacked_params: leaves [S, ...] with S the axis size (every rank
    passes the whole stack and uses its own row), or with ``local=True``
    this rank's stage alone, [1, ...] (:func:`stage_slice`).
    x: [B, ...], the same on every rank; B must divide by
    `num_microbatches` (default S).  Returns [B, ...] on every rank."""
    mesh = resolve_mesh(mesh)
    S = mesh.shape[axis]
    _stages(stacked_params, S, axis, local)
    M = num_microbatches or S
    B = x.shape[0]
    if B % M:
        raise ValueError(f"Batch {B} not divisible by {M} microbatches")
    stage = mesh.coordinate(axis)
    p_local = tree_map(lambda l: l[0] if local else l[stage], stacked_params)
    xs = x.reshape(M, B // M, *x.shape[1:])
    return run_schedule(block_fn, p_local, xs, mesh, axis).reshape(x.shape)


def run_schedule(block_fn: Callable, params, xs: torch.Tensor, mesh, axis: str,
                 remat: bool = False) -> torch.Tensor:
    """The M + S - 1 ticks of this rank's stage, `block_fn(params, h)`,
    over microbatches `xs` [M, ...] (the same on every rank of the axis);
    returns the last stage's outputs [M, ...] on every rank.

    One autograd node holds the whole schedule, so the backward runs the
    reverse schedule in a fixed order on every rank: tick by tick from
    the last, each rank takes its stage's gradients for that tick and
    sends its input's gradient to the stage before, in one batch of
    point-to-point operations a tick (a rank in a bubble sends zeros).
    The output's gradient is taken as it is on every rank (it is the same
    output); the input's is summed over the axis.  With `remat` each tick's
    block is recomputed in the backward instead of kept."""
    keys = sorted(_flat(params))
    leaves = [_flat(params)[k] for k in keys]
    return _Schedule.apply((block_fn, params, keys, mesh, axis, bool(remat)), xs, *leaves)


def _forward(S: int):
    """Each stage to the next (the last sends nothing, stage 0 receives
    zeros)."""
    return tuple((i, i + 1) for i in range(S - 1))


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, prefix + (k,)))
        return out
    return {prefix: tree}


def _unflat(like, by_key, prefix=()):
    if isinstance(like, dict):
        return {k: _unflat(v, by_key, prefix + (k,)) for k, v in like.items()}
    return by_key[prefix]


class _Schedule(torch.autograd.Function):
    @staticmethod
    def forward(ctx, run, xs, *leaves):
        block_fn, params, keys, mesh, axis, remat = run
        S, M = mesh.shape[axis], xs.shape[0]
        stage = mesh.coordinate(axis)
        p_det = [l.detach().requires_grad_(l.requires_grad) for l in leaves]
        p_tree = _unflat(params, dict(zip(keys, p_det)))
        ticks, outputs, incoming = [], [], None
        for t in range(M + S - 1):
            mb = t - stage
            y = None
            if 0 <= mb < M:
                a = (xs[mb] if stage == 0 else incoming).detach()
                a.requires_grad_(stage > 0 or xs.requires_grad)
                with torch.set_grad_enabled(not remat):
                    y = block_fn(p_tree, a)
                ticks.append((a, None if remat else y))
                y = y.detach()
                if stage == S - 1:
                    outputs.append(y)
            if S > 1:
                incoming = _permute(y if y is not None else torch.zeros_like(xs[0]), mesh,
                                    axis, _forward(S))
        out = torch.stack(outputs) if stage == S - 1 else torch.zeros_like(xs)
        if S > 1:
            out = _sum(out, mesh, axis)
        ctx.run, ctx.ticks, ctx.p_det, ctx.p_tree = run, ticks, p_det, p_tree
        ctx.xs_grad = xs.requires_grad
        return out

    @staticmethod
    def backward(ctx, g):
        block_fn, params, keys, mesh, axis, remat = ctx.run
        S, M = mesh.shape[axis], g.shape[0]
        stage = mesh.coordinate(axis)
        backward = tuple((d, s) for s, d in _forward(S))
        want = [p for p in ctx.p_det if p.requires_grad]
        grads = [torch.zeros_like(p) for p in ctx.p_det]
        dxs = torch.zeros_like(g) if (stage == 0 and ctx.xs_grad) else None
        ticks = list(ctx.ticks)
        g_y = None
        for t in reversed(range(M + S - 1)):
            mb = t - stage
            d_in = None
            if 0 <= mb < M:
                a, y = ticks.pop()
                if stage == S - 1:
                    g_y = g[mb]
                if y is None:
                    with torch.enable_grad():
                        y = block_fn(ctx.p_tree, a)
                inputs = ([a] if a.requires_grad else []) + want
                got = (torch.autograd.grad(y, inputs, g_y, allow_unused=True)
                       if inputs else ())
                if a.requires_grad:
                    d_in, got = got[0], got[1:]
                    if stage == 0:
                        dxs[mb] = d_in
                it = iter(got)
                for i, p in enumerate(ctx.p_det):
                    if p.requires_grad:
                        d = next(it)
                        if d is not None:
                            grads[i] = grads[i] + d
            if S > 1:
                g_y = _permute(d_in if d_in is not None else torch.zeros_like(g[0]), mesh,
                               axis, backward)
        if ctx.xs_grad:
            if dxs is None:
                dxs = torch.zeros_like(g)
            if S > 1:
                dxs = _sum(dxs, mesh, axis)
        return (None, dxs, *[gr if p.requires_grad else None
                             for gr, p in zip(grads, ctx.p_det)])


def sequential_apply(block_fn: Callable, stacked_params, x: torch.Tensor) -> torch.Tensor:
    """The semantics pipeline_apply must match: the S stages in order on
    one device (the correctness oracle)."""
    S = next(iter(tree_leaves(stacked_params))).shape[0]
    h = x
    for i in range(S):
        h = block_fn(tree_map(lambda l: l[i], stacked_params), h)
    return h
