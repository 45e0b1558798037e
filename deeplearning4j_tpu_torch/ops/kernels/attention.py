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
correctness (``mha_reference``).

:class:`FlashAttention`, the autograd wrapper of the kernel path, keeps
out and lse from the forward kernel and its backward calls
:func:`launch_bwd`, which launches the dQ and dK/dV kernels
(``csrc/flash_attn_bwd.cu``) on them; their plain version is
``ops.attention_kernels.flash_attention_bwd_plain``.  dq, dk and dv take
q's, k's and v's layouts, so head-split gradients merge back without a
copy.
``LAUNCHES``, ``DQ_LAUNCHES`` and ``DKV_LAUNCHES`` count kernel launches,
and only those.
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
DQ_LAUNCHES = registry().counter(
    "ops_kernel_launches_total", help="hand-written kernel launches",
    labels={"kernel": "flash_attn_bwd_dq"})
DKV_LAUNCHES = registry().counter(
    "ops_kernel_launches_total", help="hand-written kernel launches",
    labels={"kernel": "flash_attn_bwd_dkv"})

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


def bwd_supports(q, k, v, out=None, lse=None, g=None, mask=None,
                 causal: bool = False, **kw) -> bool:
    """What :func:`attention_supports` takes for q, k, v and the mask; out
    and dO of q's shape and dtype, lse [B*H, T] f32."""
    if not attention_supports(q, k, v, mask=mask, causal=causal):
        return False
    B, H, T, _ = q.shape
    return (all(isinstance(t, torch.Tensor) and t.dtype == q.dtype
                and t.shape == q.shape for t in (out, g))
            and isinstance(lse, torch.Tensor) and lse.dtype == torch.float32
            and tuple(lse.shape) == (B * H, T))


class FlashAttention(torch.autograd.Function):
    """The forward kernel, keeping out and lse; the dQ and dK/dV kernels on
    them.  lse is not differentiable."""

    @staticmethod
    def forward(ctx, q, k, v, mask, causal, scale):
        out, lse = launch(q, k, v, mask, causal, scale)
        ctx.save_for_backward(q, k, v, mask, out, lse)
        ctx.causal, ctx.scale = causal, scale
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, g, _g_lse):
        q, k, v, mask, out, lse = ctx.saved_tensors
        grads = launch_bwd(q, k, v, out, lse, g, mask, ctx.causal, ctx.scale)
        return (*(d if n else None for d, n in zip(grads, ctx.needs_input_grad)),
                None, None, None)


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


def _mask_args(mask):
    """(mask with a unit last stride, its row stride, its dtype code)."""
    if mask is None:
        return None, 0, _MASK_CODES[None]
    if not _unit_last(mask):
        mask = mask.contiguous()
    return mask, mask.stride(0), _MASK_CODES[mask.dtype]


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
    mask, mask_b, mask_code = _mask_args(mask)
    strides = (ctypes.c_longlong * 13)(
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3], mask_b)
    lib = build.library()
    _check_tile(lib)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.dl4j_flash_attn_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if mask is None else mask.data_ptr(), out.data_ptr(),
            lse.data_ptr(), strides, B, H, T, S, D, mask_code, int(bool(causal)),
            scale, _DTYPE_CODES[q.dtype], stream)
    if rc != 0:
        raise RuntimeError(
            f"flash_attn_fwd launch failed: {build.error_string(rc)} (code {rc})")
    LAUNCHES.inc()
    return out, lse


class _BwdArgs:
    """The checked arguments of one backward call, shared by its two
    launches: tensors with a unit stride over D, the 25 strides, the
    outputs dq, dk, dv (in q's, k's and v's layouts where those are dense)
    and the delta [B*H, T] that the dQ kernel writes for the dK/dV kernel."""

    def __init__(self, q, k, v, out, lse, g, mask, causal, scale):
        if not bwd_supports(q, k, v, out, lse, g, mask=mask, causal=causal):
            raise ValueError("flash_attn_bwd: the kernels do not take these inputs")
        B, H, T, D = q.shape
        self.q, self.k, self.v = q, k, v
        self.out = out if _unit_last(out) else out.contiguous()
        self.g = g if _unit_last(g) else g.contiguous()
        self.lse = lse.contiguous()
        self.dq, self.dk, self.dv = (torch.empty_like(t) for t in (q, k, v))
        self.delta = torch.empty((B * H, T), dtype=torch.float32, device=q.device)
        self.empty = B * H * T == 0
        self.mask, mask_b, mask_code = _mask_args(mask)
        self.strides = (ctypes.c_longlong * 25)(
            *(s for t in (q, k, v, self.out, self.g, self.dq, self.dk, self.dv)
              for s in t.stride()[:3]), mask_b)
        self.shape = (B, H, T, k.shape[2], D, mask_code, int(bool(causal)),
                      D ** -0.5 if scale is None else float(scale), _DTYPE_CODES[q.dtype])


def _ptr(t):
    return None if t is None else t.data_ptr()


def _run(a: _BwdArgs, name: str, fn, counter, *ptrs) -> None:
    from deeplearning4j_tpu_torch.ops.kernels import build

    with torch.cuda.device(a.q.device):
        stream = torch.cuda.current_stream(a.q.device).cuda_stream
        rc = fn(*ptrs, a.strides, *a.shape, stream)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: {build.error_string(rc)} (code {rc})")
    counter.inc()


def launch_bwd_dq(a: _BwdArgs) -> None:
    """The dQ kernel: a.dq, and a.delta for :func:`launch_bwd_dkv`."""
    from deeplearning4j_tpu_torch.ops.kernels import build

    _run(a, "flash_attn_bwd_dq", build.library().dl4j_flash_attn_bwd_dq, DQ_LAUNCHES,
         *map(_ptr, (a.q, a.k, a.v, a.out, a.g, a.lse, a.mask, a.dq, a.delta)))


def launch_bwd_dkv(a: _BwdArgs) -> None:
    """The dK/dV kernel: a.dk and a.dv, from the delta the dQ kernel wrote."""
    from deeplearning4j_tpu_torch.ops.kernels import build

    _run(a, "flash_attn_bwd_dkv", build.library().dl4j_flash_attn_bwd_dkv, DKV_LAUNCHES,
         *map(_ptr, (a.q, a.k, a.v, a.g, a.lse, a.delta, a.mask, a.dk, a.dv)))


def launch_bwd(q, k, v, out, lse, g, mask=None, causal: bool = False, scale=None):
    """(dq, dk, dv) of flash attention on the card: the dQ kernel (which
    also writes delta = rowsum(dO * out)), then the dK/dV kernel.  dq, dk
    and dv take q's, k's and v's strides where those are dense.  A CUDA
    input the kernels do not take raises."""
    a = _BwdArgs(q, k, v, out, lse, g, mask, causal, scale)
    if a.empty:
        return a.dq, a.dk.zero_(), a.dv.zero_()
    launch_bwd_dq(a)
    launch_bwd_dkv(a)
    return a.dq, a.dk, a.dv
