"""Ring attention: sequence (context) parallelism over a mesh axis (the
port of ``parallel/ring_attention.py``; Liu et al. 2023, "Ring Attention
with Blockwise Transformers").

The sequence axis is split over the ranks of mesh axis ``seq``: rank i
holds query, key and value chunk i ([B, H, T_local, D], contiguous
layout).  Each step attends the local queries to the key/value chunk in
hand, then passes that chunk on round the ring (``ppermute`` over the
axis's subgroup, ``parallel/collectives.py``) while the online-softmax
statistics accumulate in f32.  Every rank calls the function with its own
chunks; it returns its own output chunk::

    mesh = make_mesh({"seq": 4}, device="cpu")       # every rank
    out = ring_attention(q_chunk, k_chunk, v_chunk, "seq", causal=True,
                         mesh=mesh)

:func:`ring_attention` is plain PyTorch and differentiable by autograd
(its backward sends the gradients of the chunks back round the ring).
:func:`ring_attention_flash` computes each step's chunk-against-chunk
attention with the port's flash kernel (``ops/kernels/attention.py``: the
CUDA kernel on CUDA tensors, its plain version on CPU tensors), which
returns the rows' logsumexp, and merges the steps by it; its backward is
the plain ring's, as the JAX package's ``custom_vjp`` is.
"""
from __future__ import annotations

from typing import Optional

import torch

from deeplearning4j_tpu_torch.parallel.collectives import ppermute, ring_perm
from deeplearning4j_tpu_torch.parallel.mesh import resolve_mesh

NEG_INF = -1e30


def ring_attention(q, k, v, axis_name: str = "seq", causal: bool = False,
                   scale: Optional[float] = None, mask=None, mesh=None):
    """[B, H, T_local, D] chunks on each rank of `axis_name`; returns the
    local output chunk in q's dtype.

    Causal masking uses global positions: rank i holds chunk i, and the
    source rank of the key/value chunk in hand is tracked each step.
    `mask`: an optional [B, T_local] 1/0 keep-mask over the local key/value
    chunk; it travels round the ring with its chunk.  Scores and
    statistics are f32 whatever the inputs' dtype, as in the JAX package
    (bf16 normalizer drift would grow with the ring's length).  `mesh`
    defaults to the current one (``with mesh:``)."""
    mesh = resolve_mesh(mesh)
    if scale is None:
        scale = q.shape[-1] ** -0.5
    n = mesh.shape[axis_name]
    my = mesh.coordinate(axis_name)
    T = q.shape[2]
    acc_t = torch.float32
    qs = (q * scale).to(acc_t)
    rows = torch.arange(T, device=q.device)[:, None]

    def accumulate(acc, m, l, kc, vc, mc, src):
        s = torch.einsum("bhqd,bhkd->bhqk", qs, kc.to(acc_t))
        if mc is not None:
            s = torch.where(mc[:, None, None, :] > 0, s, torch.full_like(s, NEG_INF))
        if causal:
            cols = torch.arange(kc.shape[2], device=q.device)[None, :]
            s = torch.where(my * T + rows >= src * T + cols, s, torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l_new = corr * l + p.sum(-1)
        acc_new = corr[..., None] * acc + torch.einsum(
            "bhqk,bhkd->bhqd", p.to(vc.dtype).to(acc_t), vc.to(acc_t))
        return acc_new, m_new, l_new

    acc = torch.zeros(q.shape, dtype=acc_t, device=q.device)
    m = torch.full(q.shape[:-1], NEG_INF, dtype=acc_t, device=q.device)
    l = torch.zeros(q.shape[:-1], dtype=acc_t, device=q.device)
    acc, m, l = accumulate(acc, m, l, k, v, mask, my)       # step 0: the local chunk
    kc, vc, mc = k, v, mask
    perm = ring_perm(n)
    for i in range(1, n):
        kc = ppermute(kc, mesh, axis_name, perm)
        vc = ppermute(vc, mesh, axis_name, perm)
        if mc is not None:
            mc = ppermute(mc, mesh, axis_name, perm)
        acc, m, l = accumulate(acc, m, l, kc, vc, mc, (my - i) % n)
    return (acc / l[..., None]).to(q.dtype)


def ring_attention_flash(q, k, v, axis_name: str = "seq", causal: bool = False,
                         scale=None, block_q: Optional[int] = None,
                         block_k: Optional[int] = None, interpret: bool = False,
                         mesh=None):
    """Ring attention whose chunk-against-chunk attention is the flash
    kernel, ``ops.kernels.attention.flash_attention``, returning ``(out,
    lse)``; the steps merge by logsumexp::

        lse' = logaddexp(lse, lse_i)
        out' = exp(lse - lse') * out + exp(lse_i - lse') * out_i

    Causal needs no kernel variant per step: at step i the chunk in hand
    (from rank ``(my - i) mod n``) lies wholly below the diagonal (kept)
    or wholly above it (its lse forced to -inf, so the merge leaves the
    result as it was); only step 0, the diagonal chunk, runs the causal
    kernel.  So a call launches the forward kernel n times, the causal one
    once.  Differentiable: the backward is the plain ring's
    (:func:`ring_attention` recomputed under autograd), as the JAX
    package's ``custom_vjp`` is, so the flash backward kernels are not on
    this path.

    ``block_q`` and ``block_k`` are accepted for the JAX signature and
    ignored: the CUDA kernel's tiles are compile-time constants
    (``tiles.DEFAULT_TILES["attention"]``), and ``interpret`` means
    nothing here.  On a CUDA tensor a head wider than ``MAX_D`` (128)
    raises, as the kernel cannot take it."""
    from deeplearning4j_tpu_torch.ops.kernels import attention as fa
    mesh = resolve_mesh(mesh)
    if q.is_cuda and q.shape[-1] > fa.MAX_D:
        raise ValueError(f"ring_attention_flash: head size {q.shape[-1]} > "
                         f"{fa.MAX_D}, which the flash kernel does not take")
    return _RingFlash.apply(q, k, v, mesh, axis_name, bool(causal), scale)


def _ring_flash_forward(q, k, v, mesh, axis_name, causal, scale):
    from deeplearning4j_tpu_torch.ops.kernels.attention import flash_attention
    n = mesh.shape[axis_name]
    my = mesh.coordinate(axis_name)
    B, H, T, _ = q.shape

    def inner(kc, vc, diag):
        out, lse = flash_attention(q, kc, vc, causal=bool(causal and diag), scale=scale)
        return out.to(torch.promote_types(out.dtype, torch.float32)), lse.reshape(B, H, T)

    out, lse = inner(k, v, True)
    kc, vc = k, v
    perm = ring_perm(n)
    for i in range(1, n):
        kc = ppermute(kc, mesh, axis_name, perm)
        vc = ppermute(vc, mesh, axis_name, perm)
        out_i, lse_i = inner(kc, vc, False)
        if causal and not (my - i) % n < my:
            lse_i = torch.full_like(lse_i, NEG_INF)
        lse_new = torch.logaddexp(lse, lse_i)
        out = (torch.exp(lse - lse_new)[..., None] * out
               + torch.exp(lse_i - lse_new)[..., None] * out_i)
        lse = lse_new
    return out.to(q.dtype)


class _RingFlash(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, mesh, axis_name, causal, scale):
        ctx.save_for_backward(q, k, v)
        ctx.args = (mesh, axis_name, causal, scale)
        return _ring_flash_forward(q, k, v, mesh, axis_name, causal, scale)

    @staticmethod
    def backward(ctx, g):
        mesh, axis_name, causal, scale = ctx.args
        q, k, v = (t.detach().requires_grad_(True) for t in ctx.saved_tensors)
        with torch.enable_grad():
            out = ring_attention(q, k, v, axis_name, causal, scale, mesh=mesh)
        dq, dk, dv = torch.autograd.grad(out, (q, k, v), g)
        return dq, dk, dv, None, None, None, None
