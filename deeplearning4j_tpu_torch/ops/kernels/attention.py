"""Flash attention entry point of the kernel tier (the port of
``ops/pallas/attention.py``).

:func:`flash_attention` returns ``(out, lse)``: the CUDA kernel
(``csrc/flash_attn_fwd.cu``; see that file for its design and bound) for
CUDA tensors, the kernel's plain version
(``ops.attention_kernels.flash_attention_plain``) for CPU tensors or in
``reference`` mode.  The JAX wrapper pads T and S to block multiples and
builds a padded mask; this one does not: the kernel masks ragged tails
itself and reads the [B, S] keep-mask in place.  q and k/v may be strided
views (unit stride over D); out takes q's layout where q is dense, so a
caller that split heads out of a [B, T, H*D] product merges them back
without a copy.  :func:`attention_reference` is the definition of
correctness (``mha_reference``).  The kernel's backward is the VJP of the
plain version (:class:`FlashAttention`) until the dQ and dK/dV kernels are
ported.  ``LAUNCHES`` counts kernel launches, and only those.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from deeplearning4j_tpu_torch.monitor.registry import registry
from deeplearning4j_tpu_torch.ops.kernels import dispatch
from deeplearning4j_tpu_torch.ops.kernels.tiles import DEFAULT_TILES

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
#: the kernel's mask codes (``enum MaskDtype`` in ``csrc/flash_attn_fwd.cu``)
_MASK_CODES = {None: 0, torch.float32: 1, torch.bfloat16: 2, torch.float16: 3,
               torch.float64: 4}
MAX_D = 128
_MAX_Q_TILES = 65535

LAUNCHES = registry().counter(
    "ops_kernel_launches_total", help="hand-written kernel launches",
    labels={"kernel": "flash_attn_fwd"})

_tile_checked = False


def _unit_last(t) -> bool:
    return t.stride(-1) == 1 or t.shape[-1] == 1


def attention_supports(q, k, v, mask=None, causal: bool = False, **kw) -> bool:
    """Hard constraints of the kernel: [B, H, T, D] q and [B, H, S, D] k, v
    of one dtype, f32 or bf16, 1 <= D <= 128, S >= 1, unit stride over D;
    an optional [B, S] float keep-mask."""
    if not all(isinstance(t, torch.Tensor) and t.ndim == 4 for t in (q, k, v)):
        return False
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        return False
    B, H, T, D = q.shape
    S = k.shape[2]
    if (tuple(k.shape) != (B, H, S, D) or tuple(v.shape) != (B, H, S, D)
            or not 1 <= D <= MAX_D or S < 1
            or -(-T // DEFAULT_TILES["attention"].block_q) > _MAX_Q_TILES
            or not all(_unit_last(t) for t in (q, k, v))):
        return False
    if mask is not None:
        if not (isinstance(mask, torch.Tensor) and mask.dtype in _MASK_CODES
                and tuple(mask.shape) == (B, S)):
            return False
    return True


def attention_reference(q, k, v, mask=None, causal: bool = False, scale=None):
    from deeplearning4j_tpu_torch.ops import attention_kernels as ak

    return ak.mha_reference(q, k, v, mask=mask, causal=causal, scale=scale)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    mask: Optional[torch.Tensor] = None, causal: bool = False,
                    scale: Optional[float] = None):
    """[B, H, T, D] flash attention -> (out [B, H, T, D] in q's dtype,
    lse [B*H, T] f32).  Differentiable in q, k and v."""
    if dispatch.resolve("attention", q, k, v, mask=mask,
                        causal=causal) == "reference":
        from deeplearning4j_tpu_torch.ops import attention_kernels as ak

        return ak.flash_attention_plain(q, k, v, mask, causal, scale)
    return FlashAttention.apply(q, k, v, mask, causal, scale)


class FlashAttention(torch.autograd.Function):
    """The kernel's forward; its backward recomputes the plain version and
    takes that VJP.  lse is not differentiable."""

    @staticmethod
    def forward(ctx, q, k, v, mask, causal, scale):
        ctx.save_for_backward(q, k, v, mask)
        ctx.causal, ctx.scale = causal, scale
        out, lse = launch(q, k, v, mask, causal, scale)
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, g, _g_lse):
        from deeplearning4j_tpu_torch.ops import attention_kernels as ak

        q, k, v, mask = ctx.saved_tensors
        needs = ctx.needs_input_grad[:3]
        with torch.enable_grad():
            ins = [t.detach().requires_grad_(n) for t, n in zip((q, k, v), needs)]
            out, _ = ak.flash_attention_plain(*ins, mask, ctx.causal, ctx.scale)
            wanted = [t for t, n in zip(ins, needs) if n]
            grads = iter(torch.autograd.grad(out, wanted, g) if wanted else ())
        return (*(next(grads) if n else None for n in needs), None, None, None)


def _check_tile(lib) -> None:
    """Once per process: the library's compiled tiles are the ones
    ``DEFAULT_TILES`` records for it."""
    global _tile_checked
    if _tile_checked:
        return
    bq, bk = ctypes.c_int(), ctypes.c_int()
    lib.dl4j_flash_attn_tile(ctypes.byref(bq), ctypes.byref(bk))
    want = DEFAULT_TILES["attention"]
    if (bq.value, bk.value) != (want.block_q, want.block_kv):
        raise RuntimeError(
            f"flash_attn_fwd: the library is compiled for block_q, block_kv="
            f"{(bq.value, bk.value)}, DEFAULT_TILES says {want.config_key()}")
    _tile_checked = True


def launch(q, k, v, mask=None, causal: bool = False, scale=None):
    """(out, lse) of the flash-attention forward on the card."""
    from deeplearning4j_tpu_torch.ops.kernels import build

    B, H, T, D = q.shape
    S = k.shape[2]
    scale = D ** -0.5 if scale is None else float(scale)
    out = torch.empty_like(q)        # q's strides where q is dense
    lse = torch.empty((B * H, T), dtype=torch.float32, device=q.device)
    if B * H * T == 0:
        return out, lse
    if mask is not None and not _unit_last(mask):
        mask = mask.contiguous()
    strides = (ctypes.c_longlong * 13)(
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
        mask.stride(0) if mask is not None else 0)
    lib = build.library()
    _check_tile(lib)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.dl4j_flash_attn_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if mask is None else mask.data_ptr(), out.data_ptr(),
            lse.data_ptr(), strides, B, H, T, S, D,
            _MASK_CODES[None if mask is None else mask.dtype], int(bool(causal)),
            scale, _DTYPE_CODES[q.dtype], stream)
    if rc != 0:
        raise RuntimeError(
            f"flash_attn_fwd launch failed: {build.error_string(rc)} (code {rc})")
    LAUNCHES.inc()
    return out, lse
