"""Attention over [B, H, T, D] (the port of ``ops/attention_kernels.py``).

* :func:`mha_reference`: naive attention, the ground truth (materialized
  [T, S] scores in the inputs' dtype).  ``mask`` is a [B, S] 1/0 keep-mask
  over KV positions; dropped positions get NEG_INF.
* :func:`blockwise_attention`: the online-softmax recurrence over KV blocks
  in plain PyTorch (O(T) memory in the scores), differentiable by autograd
  where the JAX package has a custom VJP.
* :func:`flash_attention_plain`: the plain version of the CUDA kernel, with
  ``_flash_kernel``'s semantics: scores in f32, the keep-mask as an
  additive NEG_INF bias, an online softmax over KV tiles of the kernel's
  64 rows, p cast to V's dtype before P.V, out in q's dtype and
  ``lse = m + log(l)`` [B*H, T] f32.  Under ``causal`` the keys after a
  query add nothing (-inf), where the JAX package's dense reference gives
  them NEG_INF: the two agree wherever a row keeps one real score.
* :func:`flash_attention_bwd_plain`: the plain version of the two
  backward kernels, with ``_flash_bwd_dq_kernel``'s and
  ``_flash_bwd_dkv_kernel``'s arithmetic: delta = rowsum(dO * out) in
  f32, p rebuilt from the forward's lse under the forward's masking, ds =
  p * (dP - delta), dq, dk and dv accumulated in f32 from ds, p and dO
  rounded to the inputs' dtype, as the TPU kernels round them.
* :func:`fused_attention`: the dispatcher BERT calls.  For CUDA tensors
  under ``auto`` it runs the kernel (``ops.kernels.attention``) at every
  shape: the JAX package's TPU threshold (``_FLASH_MIN_SEQ``) is not
  copied.  For CPU tensors, or in ``reference`` mode, it runs
  :func:`mha_reference`, or :func:`blockwise_attention` above 2 GB of
  scores, as the JAX package does off the TPU.
* :func:`quantized_projection` and :func:`quantized_mha`: attention with
  int8 weights for serving: the four projections through
  ``quant_kernels.quantized_matmul`` (the ``q_matmul`` kernel on the card)
  and the scores through :func:`fused_attention` (the flash kernel).
"""
from __future__ import annotations

import torch

from deeplearning4j_tpu_torch.ops.kernels import attention as _kernel
from deeplearning4j_tpu_torch.ops.kernels import dispatch
from deeplearning4j_tpu_torch.ops.kernels.tiles import DEFAULT_TILES
from deeplearning4j_tpu_torch.ops.quant_kernels import quantized_matmul

NEG_INF = -1e30
#: beyond ~2 GB of scores the plain path runs blockwise, as in the JAX package
_SCORE_BYTES_MAX = 2 << 30


def _scale(q, scale):
    return q.shape[-1] ** -0.5 if scale is None else scale


def mha_reference(q, k, v, mask=None, causal: bool = False, scale=None):
    """Naive attention (ground truth) in the inputs' dtype."""
    scale = _scale(q, scale)
    scores = torch.einsum("bhqd,bhkd->bhqk", q, k) * scale
    if causal:
        T, S = q.shape[2], k.shape[2]
        keep = (torch.arange(T, device=q.device)[:, None]
                >= torch.arange(S, device=q.device)[None, :])
        scores = torch.where(keep, scores, torch.full_like(scores, NEG_INF))
    if mask is not None:
        scores = torch.where(mask[:, None, None, :] > 0, scores,
                             torch.full_like(scores, NEG_INF))
    p = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, v)


def _blockwise_fwd(q, k, v, mask, causal, scale, block_k):
    """Online softmax over KV blocks of ``block_k`` rows (JAX's scan)."""
    B, H, T, D = q.shape
    S = k.shape[2]
    qs = q * scale
    acc = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    m = torch.full((B, H, T), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, H, T), dtype=torch.float32, device=q.device)
    rows = torch.arange(T, device=q.device)[:, None]
    for k0 in range(0, S, block_k):
        kj, vj = k[:, :, k0:k0 + block_k], v[:, :, k0:k0 + block_k]
        s = torch.einsum("bhqd,bhkd->bhqk", qs.float(), kj.float())
        if mask is not None:
            mj = mask[:, k0:k0 + block_k]
            s = torch.where(mj[:, None, None, :] > 0, s, torch.full_like(s, NEG_INF))
        if causal:
            cols = k0 + torch.arange(kj.shape[2], device=q.device)[None, :]
            s = torch.where(rows >= cols, s, torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = corr * l + p.sum(-1)
        acc = corr[..., None] * acc + torch.einsum(
            "bhqk,bhkd->bhqd", p.to(vj.dtype).float(), vj.float())
        m = m_new
    return (acc / l[..., None]).to(q.dtype)


def blockwise_attention(q, k, v, mask=None, causal: bool = False, scale=None,
                        block_k: int = 128):
    """O(T)-memory attention by the online-softmax recurrence; falls back
    to :func:`mha_reference` when S is not a multiple of the block, as the
    JAX package does.  Differentiable (autograd recomputes nothing: it
    keeps each block's scores)."""
    scale = _scale(q, scale)
    bk = min(block_k, k.shape[2])
    if k.shape[2] % bk:
        return mha_reference(q, k, v, mask, causal, scale)
    return _blockwise_fwd(q, k, v, mask, causal, scale, bk)


def flash_attention_plain(q, k, v, mask=None, causal: bool = False,
                          scale=None):
    """The kernel's arithmetic in plain PyTorch -> (out in q's dtype, lse
    [B*H, T] f32; f64 inputs stay f64).  KV tiles of the kernel's rows,
    so p rounds alike in both; the last tile may be short."""
    B, H, T, D = q.shape
    S = k.shape[2]
    scale = _scale(q, scale)
    bk = DEFAULT_TILES["attention"].block_kv
    acc_t = torch.promote_types(q.dtype, torch.float32)
    qf = q.to(acc_t)
    acc = torch.zeros((B, H, T, D), dtype=acc_t, device=q.device)
    m = torch.full((B, H, T), NEG_INF, dtype=acc_t, device=q.device)
    l = torch.zeros((B, H, T), dtype=acc_t, device=q.device)
    bias = None
    if mask is not None:
        bias = torch.where(mask.reshape(B, S) > 0, 0.0, NEG_INF).to(acc_t)
    rows = torch.arange(T, device=q.device)[:, None]
    for k0 in range(0, S, bk):
        kj, vj = k[:, :, k0:k0 + bk], v[:, :, k0:k0 + bk]
        s = (qf @ kj.to(acc_t).transpose(-1, -2)) * scale
        if bias is not None:
            s = s + bias[:, None, None, k0:k0 + bk]
        if causal:
            cols = k0 + torch.arange(kj.shape[2], device=q.device)[None, :]
            s = s.masked_fill(cols > rows, float("-inf"))
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = corr * l + p.sum(-1)
        acc = corr[..., None] * acc + p.to(v.dtype).to(acc_t) @ vj.to(acc_t)
        m = m_new
    out = (acc / l[..., None]).to(q.dtype)
    return out, (m + torch.log(l)).reshape(B * H, T)


def flash_attention_bwd_plain(q, k, v, out, lse, g, mask=None,
                              causal: bool = False, scale=None):
    """The backward kernels' arithmetic in plain PyTorch -> (dq, dk, dv) in
    q's, k's and v's dtypes (f64 inputs stay f64).  `out` and `lse` [B*H,
    T] are the forward's, `g` is dO.  The scores are rebuilt with the
    forward's masking (the keep-mask's NEG_INF bias, -inf for causal keys)
    and p = exp(s - lse); no tiling enters the arithmetic, only the order
    of the sums.  As in the TPU kernels, a row whose every key is masked
    has lse = NEG_INF, and p there is exp(0) = 1, not the forward's 1/S."""
    B, H, T, D = q.shape
    S = k.shape[2]
    scale = _scale(q, scale)
    acc_t = torch.promote_types(q.dtype, torch.float32)
    qf, kf, vf, gf = (t.to(acc_t) for t in (q, k, v, g))
    delta = torch.sum(gf * out.to(acc_t), dim=-1, keepdim=True)
    s = (qf @ kf.transpose(-1, -2)) * scale
    if mask is not None:
        s = s + torch.where(mask.reshape(B, S) > 0, 0.0, NEG_INF).to(acc_t)[:, None, None, :]
    if causal:
        cols = torch.arange(S, device=q.device)[None, :]
        rows = torch.arange(T, device=q.device)[:, None]
        s = s.masked_fill(cols > rows, float("-inf"))
    p = torch.exp(s - lse.reshape(B, H, T, 1).to(acc_t))
    dp = gf @ vf.transpose(-1, -2)
    ds = p * (dp - delta)
    dq = (ds.to(k.dtype).to(acc_t) @ kf) * scale
    dk = (ds.to(q.dtype).to(acc_t).transpose(-1, -2) @ qf) * scale
    dv = p.to(g.dtype).to(acc_t).transpose(-1, -2) @ gf
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def fused_attention(q, k, v, mask=None, causal: bool = False, scale=None):
    """The dispatcher: the kernel for CUDA tensors, the JAX package's plain
    paths for CPU tensors or in ``reference`` mode.  Differentiable
    everywhere.  A CUDA input the kernel does not take raises."""
    if dispatch.resolve("attention", q, k, v, mask=mask,
                        causal=causal) == "kernel":
        return _kernel.FlashAttention.apply(q, k, v, mask, causal, scale)[0]
    B, H, T, _ = q.shape
    if B * H * T * k.shape[2] * q.element_size() <= _SCORE_BYTES_MAX:
        return mha_reference(q, k, v, mask, causal, scale)
    return blockwise_attention(q, k, v, mask, causal, scale)


# ---------------------------------------------------------------------------
# Quantized inference projections (the quant subsystem's attention path)
# ---------------------------------------------------------------------------

def quantized_projection(x, qt, b=None, acc_dtype=None):
    """[B, T, F] @ int8 [F, O] with per-output-channel scales: the scale
    multiplies the product, then the bias is added in the product's dtype
    (the q/k/v/out projections hold an attention block's weight bytes, so
    they are what quantization shrinks)."""
    y = quantized_matmul(x, qt, acc_dtype=acc_dtype)
    if b is not None:
        y = y + b.to(y.dtype)
    return y


def quantized_mha(x, w_qkv, w_out, n_heads: int, b_qkv=None, b_out=None,
                  mask=None, causal=False, acc_dtype=None):
    """Self-attention with its projections served from int8 weights
    (`w_qkv`: QTensor [F, 3F']; `w_out`: QTensor [F', F_out]) and the
    score, softmax and value math in the accumulating dtype through
    :func:`fused_attention`: two ``q_matmul`` launches and one flash
    launch a call on the card."""
    B, T, _ = x.shape
    qkv = quantized_projection(x, w_qkv, b=b_qkv, acc_dtype=acc_dtype)
    q, k, v = torch.split(qkv, qkv.shape[-1] // 3, dim=-1)
    d = q.shape[-1] // n_heads

    def heads(a):          # [B, T, H*D] -> [B, H, T, D]
        return a.reshape(B, T, n_heads, d).transpose(1, 2)

    o = fused_attention(heads(q), heads(k), heads(v), mask=mask, causal=causal)
    o = o.transpose(1, 2).reshape(B, T, n_heads * d)
    return quantized_projection(o, w_out, b=b_out, acc_dtype=acc_dtype)
