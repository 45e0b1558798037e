"""fused_dense: a dense layer's matmul with bias + activation in its epilogue.

Port of ``deeplearning4j_tpu/ops/pallas/matmul.py``'s ``fused_dense``.  Two
implementations of one function, ``y = act(x @ W + b)`` accumulated in f32
with the bias and the activation applied in f32 and the result stored in
x's dtype:

* :func:`fused_dense_reference`, the plain PyTorch version and the spec;
* the CUDA kernel in ``csrc/fused_dense.cu``, launched by
  :func:`fused_dense` on CUDA tensors (see that file for its design and
  bound).

:func:`fused_dense` asks ``dispatch.resolve`` which one runs: CPU tensors
take the plain version, CUDA tensors the kernel, and ``reference`` mode the
plain version anywhere.  The kernel's backward is the plain version's VJP
(:class:`FusedDense`).  ``LAUNCHES`` counts kernel launches, and only
those.  The weight-only and int8 products of the JAX module
(``q_matmul``, ``int8_matmul``) are not ported yet.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch.monitor.registry import registry
from deeplearning4j_tpu_torch.ops.kernels import dispatch
from deeplearning4j_tpu_torch.ops.kernels.tiles import DEFAULT_TILES

#: Epilogue activations.  The plain version applies these functions; the
#: kernel applies the same math in f32 (``csrc/fused_dense.cu``).
EPILOGUE_ACTIVATIONS: Dict[str, Any] = {
    "identity": lambda y: y,
    "linear": lambda y: y,
    "relu": torch.relu,
    "tanh": torch.tanh,
    "sigmoid": torch.sigmoid,
    # exact erf form, matching ops.activations.gelu
    "gelu": lambda y: F.gelu(y, approximate="none"),
}

#: the kernel's activation codes (``enum Act`` in ``csrc/fused_dense.cu``)
_ACT_CODES = {None: 0, "identity": 0, "linear": 0, "relu": 1, "tanh": 2,
              "sigmoid": 3, "gelu": 4}
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_FLOAT_DTYPES = (torch.float32, torch.bfloat16)
_INT_MAX = 2 ** 31 - 1

#: kernel launches of fused_dense (the plain version does not count)
LAUNCHES = registry().counter(
    "ops_kernel_launches_total", help="hand-written kernel launches",
    labels={"kernel": "fused_dense"})

_tile_checked = False


def fused_dense_reference(x: torch.Tensor, w: torch.Tensor,
                          bias: Optional[torch.Tensor] = None,
                          activation: Optional[str] = None) -> torch.Tensor:
    """f32 product, then bias, then the epilogue activation, all in f32
    (f64 inputs stay f64); output in x's dtype."""
    acc = torch.promote_types(x.dtype, torch.float32)
    y = torch.matmul(x.to(acc), w.to(acc))
    if bias is not None:
        y = y + bias.to(acc)
    if activation is not None:
        y = EPILOGUE_ACTIVATIONS[activation](y)
    return y.to(x.dtype)


def dense_supports(x, w, bias=None, activation=None, **kw) -> bool:
    return (
        isinstance(x, torch.Tensor) and isinstance(w, torch.Tensor)
        and x.ndim >= 2 and w.ndim == 2
        and x.dtype in _FLOAT_DTYPES and w.dtype == x.dtype
        and (bias is None or bias.dtype in _FLOAT_DTYPES)
        and (activation is None or activation in EPILOGUE_ACTIVATIONS)
    )


def fused_dense(x: torch.Tensor, w: torch.Tensor,
                bias: Optional[torch.Tensor] = None,
                activation: Optional[str] = None) -> torch.Tensor:
    """Dense forward with bias + activation fused into the matmul epilogue:
    the kernel for CUDA tensors, the plain version for CPU tensors or in
    ``reference`` mode.  Differentiable either way: the kernel's backward
    is the VJP of the plain version (:class:`FusedDense`)."""
    if dispatch.resolve("fused_dense", x, w, bias=bias,
                        activation=activation) == "reference":
        return fused_dense_reference(x, w, bias, activation)
    return FusedDense.apply(x, w, bias, activation)


class FusedDense(torch.autograd.Function):
    """The kernel's forward; its backward recomputes the plain version and
    takes that VJP, as the JAX package's ``_fused_dense_bwd`` does (no
    epilogue residuals are kept)."""

    @staticmethod
    def forward(ctx, x, w, bias, activation):
        ctx.save_for_backward(x, w, bias)
        ctx.activation = activation
        return _launch(x, w, bias, activation)

    @staticmethod
    def backward(ctx, g):
        x, w, bias = ctx.saved_tensors
        needs = ctx.needs_input_grad[:3]
        with torch.enable_grad():
            ins = [None if t is None else t.detach().requires_grad_(n)
                   for t, n in zip((x, w, bias), needs)]
            y = fused_dense_reference(ins[0], ins[1], ins[2], ctx.activation)
            wanted = [t for t, n in zip(ins, needs) if n]
            grads = iter(torch.autograd.grad(y, wanted, g) if wanted else ())
        return (*(next(grads) if n else None for n in needs), None)


def _check_tile(lib) -> None:
    """Once per process: the library's compiled tile is the one
    ``DEFAULT_TILES`` records for it."""
    global _tile_checked
    if _tile_checked:
        return
    import ctypes
    bm, bn, bk = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    lib.dl4j_fused_dense_tile(ctypes.byref(bm), ctypes.byref(bn),
                              ctypes.byref(bk))
    want = DEFAULT_TILES["fused_dense"]
    if (bm.value, bn.value, bk.value) != (want.block_m, want.block_n,
                                          want.block_k):
        raise RuntimeError(
            f"fused_dense: the library is compiled for tile m,n,k="
            f"{(bm.value, bn.value, bk.value)}, DEFAULT_TILES says "
            f"{want.config_key()}")
    _tile_checked = True


def _launch(x, w, bias, activation) -> torch.Tensor:
    from deeplearning4j_tpu_torch.ops.kernels import build

    K = x.shape[-1]
    N = w.shape[1]
    lead = tuple(x.shape[:-1])
    x2 = x.reshape(-1, K)
    M = x2.shape[0]
    if w.shape[0] != K:
        raise ValueError(f"fused_dense: x is [.., {K}] but W is {tuple(w.shape)}")
    if not (x2.is_contiguous() and w.is_contiguous()):
        raise ValueError("fused_dense: the kernel takes contiguous x and W")
    if max(M, N, K) > _INT_MAX:
        raise ValueError(f"fused_dense: M={M} N={N} K={K} exceed 32 bits")
    if bias is not None:
        if tuple(bias.shape) != (N,):
            raise ValueError(
                f"fused_dense: bias is {tuple(bias.shape)}, want ({N},)")
        bias = bias.to(torch.float32).contiguous()
    y = torch.empty((M, N), dtype=x.dtype, device=x.device)
    if M == 0 or N == 0:
        return y.reshape(lead + (N,))
    lib = build.library()
    _check_tile(lib)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.dl4j_fused_dense(
            x2.data_ptr(), w.data_ptr(),
            None if bias is None else bias.data_ptr(), y.data_ptr(),
            M, N, K, _DTYPE_CODES[x.dtype], _ACT_CODES[activation], stream)
    if rc != 0:
        raise RuntimeError(
            f"fused_dense launch failed: {build.error_string(rc)} (code {rc})")
    LAUNCHES.inc()
    return y.reshape(lead + (N,))
