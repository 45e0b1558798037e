"""Paged-KV decode attention of the kernel tier (the port of
``ops/pallas/paged_attention.py``).

The decode loop is one query token per sequence attending over that
sequence's whole history.  The serving layer (``serving/decode.py``) keeps
KV in fixed-size pages shared by every sequence, and each sequence owns a
block table, the ordered page indices of its history.  Two
implementations of one function:

- :func:`paged_attention_plain`, the port of ``paged_attention_reference``
  and the spec: gather each sequence's pages per its block table, masked
  softmax over the rebuilt history, f32 math;
- the CUDA kernel in ``csrc/paged_attention.cu`` (see that file for its
  design and bound), launched by :func:`paged_attention` on CUDA tensors,
  which walks the pages with an online softmax in the TPU kernel's order.

Int8 pages carry one f32 scale per (token, head) row, made by
``quantize_tensor(rows, axis=0)``; both implementations widen them with the
same ``f32(x) * f32(scale)`` (:func:`dequant_rows`).

Layout (shared with ``serving.decode.PagedKVCache``):

- ``q``            [B, H, D]         one decode token per sequence
- ``k_pages``      [P, page, H, D]   f32/bf16, or int8 with scales
- ``v_pages``      [P, page, H, D]
- ``k_scales``     [P, page, H]      f32 (int8 pages only)
- ``v_scales``     [P, page, H]
- ``block_tables`` [B, max_pages]    int32; slots past a sequence's last
                                     page hold 0 and are never read
- ``seq_lens``     [B]               int32, >= 1

:func:`paged_supports` keeps the JAX package's hard predicates plus the
kernel's limits (D <= 256, page <= 64, contiguous operands); the TPU's
``paged_profitable`` thresholds are not carried over.  ``LAUNCHES`` counts
kernel launches, and only those.
"""
from __future__ import annotations

import math

import torch

from deeplearning4j_tpu_torch.monitor.registry import registry

#: masked logits, not -inf, so fully masked tails stay NaN-free
NEG_INF = -1e30
_Q_CODES = {torch.float32: 0, torch.bfloat16: 1}
#: the kernel's limits (``dl4j_paged_attention_limits``)
MAX_D = 256
MAX_PAGE = 64

LAUNCHES = registry().counter(
    "ops_kernel_launches_total", help="hand-written kernel launches",
    labels={"kernel": "paged_attention"})

_limits_checked = False


def dequant_rows(x, scales, dtype=torch.float32):
    """Widen KV rows: ``x`` [..., D] int8 (or float: then a plain cast),
    ``scales`` [...] broadcast over D, the inverse of
    ``quantize_tensor(rows, axis=0)``."""
    x = x.to(dtype)
    if scales is not None:
        x = x * scales.to(dtype)[..., None]
    return x


def _sm_scale(D, scale):
    return (1.0 / math.sqrt(D)) if scale is None else float(scale)


def paged_attention_plain(q, k_pages, v_pages, block_tables, seq_lens,
                          scale=None, k_scales=None, v_scales=None):
    """Gather each sequence's pages per its block table and run masked
    attention over the rebuilt history, in f32; output in q's dtype."""
    B, H, D = q.shape
    page = k_pages.shape[1]
    sm = _sm_scale(D, scale)
    k = dequant_rows(k_pages, k_scales)           # [P, page, H, D] f32
    v = dequant_rows(v_pages, v_scales)
    bt = block_tables.long()
    L = bt.shape[1] * page
    kg = k[bt].reshape(B, L, H, D).permute(0, 2, 1, 3)
    vg = v[bt].reshape(B, L, H, D).permute(0, 2, 1, 3)
    s = torch.einsum("bhd,bhld->bhl", q.to(torch.float32), kg) * sm
    pos = torch.arange(L, device=q.device)[None, None, :]
    valid = pos < seq_lens.to(torch.int64)[:, None, None]
    s = torch.where(valid, s, torch.full_like(s, NEG_INF))
    w = torch.softmax(s, dim=-1)
    out = torch.einsum("bhl,bhld->bhd", w, vg)
    return out.to(q.dtype)


def _int_vector(t, n) -> bool:
    return (isinstance(t, torch.Tensor) and t.ndim == 1 and t.shape[0] == n
            and not t.is_floating_point())


def paged_supports(q, k_pages, v_pages, block_tables, seq_lens, scale=None,
                   k_scales=None, v_scales=None, **kw) -> bool:
    """Hard constraints: q [B, H, D] f32 or bf16 with 1 <= D <= 256; pages
    [P, page, H, D] with page <= 64, in q's dtype or int8 with f32 scales
    [P, page, H]; block tables [B, max_pages] and lengths [B] of integers;
    contiguous operands."""
    ts = (q, k_pages, v_pages, block_tables, seq_lens)
    if not all(isinstance(t, torch.Tensor) for t in ts):
        return False
    if q.ndim != 3 or k_pages.ndim != 4 or q.dtype not in _Q_CODES:
        return False
    if k_pages.shape != v_pages.shape or k_pages.dtype != v_pages.dtype:
        return False
    B, H, D = q.shape
    if (k_pages.shape[2] != H or k_pages.shape[3] != D or not 1 <= D <= MAX_D
            or not 1 <= k_pages.shape[1] <= MAX_PAGE):
        return False
    if k_pages.dtype == torch.int8:
        if not all(isinstance(s, torch.Tensor) and s.dtype == torch.float32
                   and s.shape == k_pages.shape[:3] and s.is_contiguous()
                   for s in (k_scales, v_scales)):
            return False
    elif k_pages.dtype != q.dtype:
        return False
    if (block_tables.ndim != 2 or block_tables.shape[0] != B
            or block_tables.shape[1] < 1 or block_tables.is_floating_point()):
        return False
    return _int_vector(seq_lens, B) and all(t.is_contiguous() for t in ts[:3])


def _check_limits(lib) -> None:
    """Once per process: the library's limits are the ones this module
    states."""
    global _limits_checked
    if _limits_checked:
        return
    import ctypes
    d, p = ctypes.c_int(), ctypes.c_int()
    lib.dl4j_paged_attention_limits(ctypes.byref(d), ctypes.byref(p))
    if (d.value, p.value) != (MAX_D, MAX_PAGE):
        raise RuntimeError(
            f"paged_attention: the library takes D <= {d.value}, page <= "
            f"{p.value}; this module says {MAX_D}, {MAX_PAGE}")
    _limits_checked = True


def paged_attention(q, k_pages, v_pages, block_tables, seq_lens, scale=None,
                    k_scales=None, v_scales=None) -> torch.Tensor:
    """Launch the kernel on CUDA tensors: [B, H, D] out in q's dtype.
    Raises for inputs the kernel does not take (``paged_supports``) and if
    the launch fails.  The caller (``serving/decode.py``) asks
    ``dispatch.resolve`` first; CPU tensors take
    :func:`paged_attention_plain`."""
    from deeplearning4j_tpu_torch.ops.kernels import build

    if not paged_supports(q, k_pages, v_pages, block_tables, seq_lens,
                          k_scales=k_scales, v_scales=v_scales):
        raise ValueError("paged_attention: the kernel does not take these inputs")
    B, H, D = q.shape
    page = k_pages.shape[1]
    max_pages = block_tables.shape[1]
    quantized = k_pages.dtype == torch.int8
    bt = block_tables.to(torch.int32).contiguous()
    sl = seq_lens.to(torch.int32).contiguous()
    qc = q.contiguous()
    out = torch.empty((B, H, D), dtype=q.dtype, device=q.device)
    lib = build.library()
    _check_limits(lib)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.dl4j_paged_attention(
            qc.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            k_scales.data_ptr() if quantized else None,
            v_scales.data_ptr() if quantized else None,
            bt.data_ptr(), sl.data_ptr(), out.data_ptr(), B, H, D, page,
            max_pages, _sm_scale(D, scale), _Q_CODES[q.dtype], int(quantized),
            stream)
    if rc != 0:
        raise RuntimeError(
            f"paged_attention launch failed: {build.error_string(rc)} (code {rc})")
    LAUNCHES.inc()
    return out
