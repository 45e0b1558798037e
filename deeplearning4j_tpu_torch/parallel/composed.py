"""Composed 3D parallelism: dp x tp x pp in one train step (the port of
``parallel/composed.py``).

One mesh with three axes, one process a rank:

- ``data``: the batch's microbatch rows split over the axis; gradients of
  every leaf summed over it;
- ``model``: Megatron tensor parallelism for the MLP (column-parallel
  ``w1``, row-parallel ``w2``) with sequence parallelism on the same
  axis: activations stay split on the sequence, an ``all_gather`` makes
  the whole sequence for the sharded products and a ``psum_scatter``
  returns the partial sums to the sequence chunks; the attention runs as
  a ring over this axis (:func:`~.ring_attention.ring_attention`);
- ``pipe``: GPipe stages, homogeneous transformer blocks with parameters
  stacked on a leading [S, ...] axis, microbatches streamed through the
  schedule of ``pipeline.run_schedule``.

A rank keeps only its part of the stacked parameters
(:func:`shard_stage_params`: its stage, and its column/row block of
``w1``/``w2``); :func:`gather_stage_params` puts the whole stack back
together on every rank.  Every rank calls the step with the same global
batch and takes its own block of it.  The products are ``torch.matmul``
(the JAX package computes them with ``@`` outside any Pallas kernel) and
the attention is the plain ring, as in the JAX package.

:func:`composed_oracle` is the single-device semantics the sharded step
must match up to floating-point tolerance.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch.parallel import collectives as col
from deeplearning4j_tpu_torch.parallel.mesh import resolve_mesh
from deeplearning4j_tpu_torch.parallel.pipeline import run_schedule
from deeplearning4j_tpu_torch.parallel.ring_attention import ring_attention
from deeplearning4j_tpu_torch.parallel.sharding import PartitionSpec as P
from deeplearning4j_tpu_torch.utils.devices import resolve_device

#: the leaves split over the model axis, and the dim of a stage's leaf
#: they split on (``stage_specs``)
_TP_DIM = {"w1": 1, "w2": 0}


def init_stage_params(rng, n_stages: int, d_model: int, n_heads: int,
                      d_ff: int, device="cuda") -> Dict[str, torch.Tensor]:
    """Per-stage transformer-block params stacked on a leading [S, ...]
    axis, drawn from `rng` (a ``numpy.random.RandomState``) in the JAX
    package's order, so both packages start from the same arrays."""
    dev = resolve_device(device)

    def g(*s, scale=0.2):
        return torch.as_tensor(rng.randn(*s).astype(np.float32) * scale, device=dev)
    S, D, F = n_stages, d_model, d_ff
    return {
        "wqkv": g(S, D, 3 * D), "wo": g(S, D, D),
        "w1": g(S, D, F), "w2": g(S, F, D),
        "ln1_g": torch.ones((S, D), dtype=torch.float32, device=dev),
        "ln1_b": torch.zeros((S, D), dtype=torch.float32, device=dev),
        "ln2_g": torch.ones((S, D), dtype=torch.float32, device=dev),
        "ln2_b": torch.zeros((S, D), dtype=torch.float32, device=dev),
    }


def stage_specs(tp_axis: str = "model", pipe_axis: str = "pipe"):
    """PartitionSpecs for the stacked stage tree: every leaf on the stage
    axis; the MLP weights also on the tp axis (column-parallel W1 on its
    output dim, row-parallel W2 on its input dim).  Attention weights are
    replicated over tp: the tp axis carries the sequence for attention
    (ring), not the heads."""
    return {
        "wqkv": P(pipe_axis, None, None), "wo": P(pipe_axis, None, None),
        "w1": P(pipe_axis, None, tp_axis), "w2": P(pipe_axis, tp_axis, None),
        "ln1_g": P(pipe_axis, None), "ln1_b": P(pipe_axis, None),
        "ln2_g": P(pipe_axis, None), "ln2_b": P(pipe_axis, None),
    }


def _ln(x, g, b, eps=1e-5):
    m = x.mean(-1, keepdim=True)
    v = ((x - m) ** 2).mean(-1, keepdim=True)
    return (x - m) / torch.sqrt(v + eps) * g + b


def _split_heads(x, n_heads):
    b, t, d = x.shape
    return x.reshape(b, t, n_heads, d // n_heads).permute(0, 2, 1, 3)


def _merge_heads(x):
    b, h, t, dh = x.shape
    return x.permute(0, 2, 1, 3).reshape(b, t, h * dh)


def block_sp(p, h, n_heads: int, tp_axis: str, mesh=None):
    """One transformer block on a sequence-split activation [mb, T_local,
    D], this rank's block of ``w1``/``w2`` in `p`."""
    mesh = resolve_mesh(mesh)
    x = _ln(h, p["ln1_g"], p["ln1_b"])
    q, k, v = torch.split(x @ p["wqkv"], x.shape[-1], dim=-1)
    att = ring_attention(_split_heads(q, n_heads), _split_heads(k, n_heads),
                         _split_heads(v, n_heads), axis_name=tp_axis, causal=True,
                         mesh=mesh)
    h = h + _merge_heads(att) @ p["wo"]
    x = _ln(h, p["ln2_g"], p["ln2_b"])
    full = col.all_gather(x, mesh, tp_axis, dim=1)
    u = torch.relu(full @ p["w1"])                      # [mb, T, F_local]
    mlp = col.psum_scatter(u @ p["w2"], mesh, tp_axis, dim=1)   # [mb, T_local, D]
    return h + mlp


def block_oracle(p, h, n_heads: int):
    """Single-device semantics of `block_sp` (full sequence)."""
    x = _ln(h, p["ln1_g"], p["ln1_b"])
    q, k, v = (_split_heads(t, n_heads)
               for t in torch.split(x @ p["wqkv"], x.shape[-1], dim=-1))
    scale = q.shape[-1] ** -0.5
    s = torch.einsum("bhqd,bhkd->bhqk", q * scale, k)
    T = q.shape[2]
    causal = torch.tril(torch.ones((T, T), dtype=torch.bool, device=h.device))
    s = torch.where(causal[None, None], s, torch.full_like(s, -1e30))
    att = torch.einsum("bhqk,bhkd->bhqd", torch.softmax(s, -1).to(v.dtype), v)
    h = h + _merge_heads(att) @ p["wo"]
    x = _ln(h, p["ln2_g"], p["ln2_b"])
    return h + torch.relu(x @ p["w1"]) @ p["w2"]


def _stage_rows(stacked, mesh, tp_axis, pipe_axis):
    """This rank's stage of each leaf (a view), and its block of w1/w2."""
    s = mesh.coordinate(pipe_axis)
    out = {}
    for k, v in stacked.items():
        row = v[s:s + 1]
        if k in _TP_DIM:
            row = col.block_of(row, mesh, tp_axis, _TP_DIM[k] + 1)
        out[k] = row
    return out


def shard_stage_params(stacked, mesh=None, tp_axis: str = "model",
                       pipe_axis: str = "pipe"):
    """This rank's part of a stacked stage tree, [1, ...] leaves (copies):
    its stage, and its block of w1 (columns) and w2 (rows)."""
    mesh = resolve_mesh(mesh)
    return {k: v.detach().clone().contiguous()
            for k, v in _stage_rows(stacked, mesh, tp_axis, pipe_axis).items()}


@torch.no_grad()
def gather_stage_params(local, mesh=None, tp_axis: str = "model",
                        pipe_axis: str = "pipe"):
    """The whole stacked tree on every rank from each rank's part
    (:func:`shard_stage_params`'s inverse; collective)."""
    mesh = resolve_mesh(mesh)
    out = {}
    for k, v in local.items():
        if k in _TP_DIM:
            v = col._gather(v, mesh, tp_axis, _TP_DIM[k] + 1) if mesh.shape[tp_axis] > 1 else v
        out[k] = col._gather(v, mesh, pipe_axis, 0) if mesh.shape[pipe_axis] > 1 else v.clone()
    return out


def _local_block(x, mesh, data_axis, tp_axis, M):
    """[M, mb_local, T_local, D] of a global [B, T, D] batch."""
    x = torch.as_tensor(x, device=mesh.device)
    B = x.shape[0]
    if B % M:
        raise ValueError(f"batch {B} % {M} microbatches != 0")
    xs = x.reshape(M, B // M, *x.shape[1:])
    xs = col.block_of(xs, mesh, data_axis, 1)
    return col.block_of(xs, mesh, tp_axis, 2)


def _forward_local(params, xs, mesh, n_heads, tp_axis, pipe_axis, remat):
    p = {k: v[0] for k, v in params.items()}
    return run_schedule(lambda q, h: block_sp(q, h, n_heads, tp_axis, mesh), p, xs,
                        mesh, pipe_axis, remat=remat)


def composed_apply(stacked, x, mesh=None, n_heads: int = 1, data_axis: str = "data",
                   tp_axis: str = "model", pipe_axis: str = "pipe",
                   num_microbatches: Optional[int] = None, remat: bool = False,
                   local: bool = False):
    """Forward through S pipelined sequence-parallel TP blocks.

    x: the global [B, T, D] batch on every rank (B splits into the
    microbatches, each microbatch's rows over `data_axis`, T over
    `tp_axis`).  stacked: the `init_stage_params` tree (leaves [S, ...]),
    or with ``local=True`` this rank's part (:func:`shard_stage_params`).
    `remat` recomputes each tick's block in the backward.  Each rank's
    output stays [M, mb_local, T_local, D] until it is gathered: the
    microbatch axis merges globally (a local merge would interleave the
    data shards).  Returns the global [B, T, D] on every rank."""
    mesh = resolve_mesh(mesh)
    M = num_microbatches or mesh.shape[pipe_axis]
    params = stacked if local else _stage_rows(stacked, mesh, tp_axis, pipe_axis)
    x = torch.as_tensor(x, device=mesh.device)
    out = _forward_local(params, _local_block(x, mesh, data_axis, tp_axis, M), mesh,
                         n_heads, tp_axis, pipe_axis, remat)
    out = col.gather_from(out, mesh, tp_axis, 2)
    out = col.gather_from(out, mesh, data_axis, 1)
    return out.reshape(x.shape)


def composed_oracle(stacked, x, n_heads: int):
    """Sequential single-device semantics of `composed_apply`."""
    h = torch.as_tensor(x, device=next(iter(stacked.values())).device)
    for i in range(next(iter(stacked.values())).shape[0]):
        h = block_oracle({k: v[i] for k, v in stacked.items()}, h, n_heads)
    return h


class _Step:
    """forward, MSE loss and gradients of one composed step on this
    rank's part of the parameters; the gradients summed over the ranks
    that hold the same leaf."""

    def __init__(self, mesh, n_heads, remat, data_axis="data", tp_axis="model",
                 pipe_axis="pipe", num_microbatches=None):
        self.mesh, self.n_heads, self.remat = mesh, n_heads, bool(remat)
        self.axes = (data_axis, tp_axis, pipe_axis)
        self.M = num_microbatches

    def grads(self, params, x, y):
        mesh = self.mesh
        data_axis, tp_axis, pipe_axis = self.axes
        M = self.M or mesh.shape[pipe_axis]
        keys = sorted(params)
        leaves = {k: params[k].detach().requires_grad_(True) for k in keys}
        xs = _local_block(x, mesh, data_axis, tp_axis, M)
        ys = _local_block(y, mesh, data_axis, tp_axis, M).to(xs.dtype)
        out = _forward_local(leaves, xs, mesh, self.n_heads, tp_axis, pipe_axis, self.remat)
        n = torch.as_tensor(y).numel()
        local = torch.sum((out - ys) ** 2) / n
        got = torch.autograd.grad(local, [leaves[k] for k in keys])
        grads = {}
        for k, g in zip(keys, got):
            if mesh.shape[data_axis] > 1:
                g = col._sum(g, mesh, data_axis)
            if k not in _TP_DIM and mesh.shape[tp_axis] > 1:
                g = col._sum(g, mesh, tp_axis)
            grads[k] = g
        loss = local.detach()
        for axis in (data_axis, tp_axis):
            if mesh.shape[axis] > 1:
                loss = col._sum(loss, mesh, axis)
        return loss, grads


def _sgd(params, grads, lr):
    return {k: params[k].detach() - lr * grads[k] for k in params}


def composed_train_step(mesh=None, n_heads: int = 1, lr: float = 0.1,
                        remat: bool = False, **axes):
    """The full train step: forward through the 3D-parallel stack, MSE
    loss, gradients, SGD update.  Returns step(params, x, y) -> (new
    params, loss), with `params` this rank's part
    (:func:`shard_stage_params`), x and y the global batch on every rank
    and the loss the global mean (a 0-d tensor, the same on every
    rank)."""
    core = _Step(resolve_mesh(mesh), n_heads, remat, **axes)

    def step(params, x, y):
        loss, grads = core.grads(params, x, y)
        return _sgd(params, grads, lr), loss
    return step


class ComposedParallel:
    """The 3D-parallel train step with optional hierarchical gradient
    sharing across a gang of processes.

    Without sharing, `fit_batch` is `composed_train_step`.  With a
    ``HierarchicalGradientSharing`` config (or a built
    ``HierarchicalAllReduce``) the step splits as the networks' does: the
    grad half (every collective of the mesh included), the host exchange
    over the gang (``parallel/hierarchical.py``) of this rank's gradient
    parts, then the SGD apply half."""

    def __init__(self, mesh=None, n_heads: int = 1, lr: float = 0.1,
                 remat: bool = False, gradient_sharing=None, **axes):
        self.mesh = resolve_mesh(mesh)
        self.n_heads = n_heads
        self.lr = lr
        self._sharing = None
        if gradient_sharing is not None:
            from deeplearning4j_tpu_torch.parallel.hierarchical import as_runtime
            self._sharing = as_runtime(gradient_sharing, None)
        self._core = _Step(self.mesh, n_heads, remat, **axes)

    @property
    def gradient_sharing(self):
        return self._sharing

    def fit_batch(self, params, x, y):
        """(new params, loss) after one step; with sharing on the
        gradients cross the gang's exchange between the two halves."""
        loss, grads = self._core.grads(params, x, y)
        if self._sharing is not None:
            combined = self._sharing.exchange(grads)
            grads = {k: torch.as_tensor(np.asarray(combined[k], np.float32)).to(
                g.device, g.dtype) for k, g in grads.items()}
        return _sgd(params, grads, self.lr), loss

    def close(self) -> None:
        if self._sharing is not None:
            self._sharing.close()


def composed_train_steps(mesh=None, n_heads: int = 1, lr: float = 0.1,
                         remat: bool = False, **axes):
    """k composed steps in one call: `xs`/`ys` carry a leading steps axis;
    returns (params, the k losses).  A loop over `composed_train_step`: a
    CUDA-graph capture of the collectives is left out (NCCL groups held by
    live graphs hung at teardown)."""
    step = composed_train_step(mesh, n_heads, lr=lr, remat=remat, **axes)

    def steps(params, xs, ys):
        losses = []
        for i in range(len(xs)):
            params, loss = step(params, xs[i], ys[i])
            losses.append(loss)
        return params, torch.stack(losses)
    return steps
