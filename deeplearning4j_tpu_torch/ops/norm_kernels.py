"""LayerNorm over the last axis whose forward runs a hand-written kernel
(the port of ``ops/norm_kernels.py``).

* :func:`layer_norm_reference` is the JAX package's plain composition,
  computed in x's dtype with the population variance: what the JAX package
  runs off the TPU, and what the port runs for CPU tensors and in
  ``reference`` dispatch mode.
* :func:`layer_norm_plain` is the plain version of the kernel, with
  ``_ln_fwd_kernel``'s semantics: x widened to f32, the centred variance
  ``mean((x - mean)^2)``, ``rsqrt(var + eps)``, gain and bias widened to
  f32, y cast back to x's dtype; it also returns mean and rstd [rows] f32.
* :func:`layer_norm_fwd` returns (y, mean, rstd): the CUDA kernel
  (``ops/kernels/layer_norm.py``, ``csrc/layer_norm_fwd.cu``) for CUDA
  tensors, :func:`layer_norm_plain` for CPU tensors or in ``reference``
  mode.
* :func:`fused_layer_norm` is the dispatcher the layers and BERT call.
  Under ``auto`` on CUDA it runs the kernel for any rows and any 1 <= F <=
  8192: none of the JAX package's TPU gates (rows % 256, F % 128, rows >=
  1024) is copied.  For CPU tensors, or in ``reference`` mode, it runs
  :func:`layer_norm_reference`, as the JAX package does off the TPU.

The kernel's backward is the VJP of :func:`layer_norm_plain`
(:class:`FusedLayerNorm`) until the backward kernel (the JAX package's
``_ln_bwd_kernel``) is ported.
"""
from __future__ import annotations

from typing import Optional

import torch

from deeplearning4j_tpu_torch.ops.kernels import dispatch
from deeplearning4j_tpu_torch.ops.kernels import layer_norm as _kernel


def layer_norm_reference(x: torch.Tensor, gain: torch.Tensor,
                         bias: Optional[torch.Tensor] = None,
                         eps: float = 1e-5) -> torch.Tensor:
    """Layer norm over the last axis in x's dtype, population variance."""
    mean = torch.mean(x, dim=-1, keepdim=True)
    var = torch.var(x, dim=-1, keepdim=True, correction=0)
    y = (x - mean) / torch.sqrt(var + eps) * gain
    return y if bias is None else y + bias


def layer_norm_plain(x: torch.Tensor, gain: torch.Tensor,
                     bias: Optional[torch.Tensor] = None, eps: float = 1e-5):
    """The kernel's arithmetic in plain PyTorch: (y in x's dtype, mean
    [rows] f32, rstd [rows] f32); f64 inputs stay f64."""
    acc = torch.promote_types(x.dtype, torch.float32)
    xf = x.to(acc)
    mean = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean((xf - mean) ** 2, dim=-1, keepdim=True)
    rstd = torch.rsqrt(var + eps)
    y = (xf - mean) * rstd * gain.to(acc)
    if bias is not None:
        y = y + bias.to(acc)
    return y.to(x.dtype), mean.reshape(-1), rstd.reshape(-1)


def layer_norm_fwd(x: torch.Tensor, gain: torch.Tensor,
                   bias: Optional[torch.Tensor] = None, eps: float = 1e-5):
    """(y, mean, rstd) of a layer norm over x's last axis: the kernel for
    CUDA tensors (not differentiable), the plain version for CPU tensors or
    in ``reference`` mode."""
    if dispatch.resolve("layer_norm", x, gain, bias=bias) == "reference":
        return layer_norm_plain(x, gain, bias, eps)
    return _kernel.launch(x, gain, bias, eps)


class FusedLayerNorm(torch.autograd.Function):
    """The kernel's forward; its backward recomputes :func:`layer_norm_plain`
    and takes that VJP."""

    @staticmethod
    def forward(ctx, x, gain, bias, eps):
        ctx.save_for_backward(x, gain, bias)
        ctx.eps = eps
        return _kernel.launch(x, gain, bias, eps)[0]

    @staticmethod
    def backward(ctx, g):
        x, gain, bias = ctx.saved_tensors
        needs = ctx.needs_input_grad[:3]
        with torch.enable_grad():
            ins = [None if t is None else t.detach().requires_grad_(n)
                   for t, n in zip((x, gain, bias), needs)]
            y = layer_norm_plain(ins[0], ins[1], ins[2], ctx.eps)[0]
            wanted = [t for t, n in zip(ins, needs) if n]
            grads = iter(torch.autograd.grad(y, wanted, g) if wanted else ())
        return (*(next(grads) if n else None for n in needs), None)


def fused_layer_norm(x: torch.Tensor, gain: torch.Tensor,
                     bias: Optional[torch.Tensor] = None,
                     eps: float = 1e-5) -> torch.Tensor:
    """Layer norm over the last axis: the kernel for CUDA tensors, the
    JAX package's plain composition for CPU tensors or in ``reference``
    mode.  A CUDA input the kernel does not take raises."""
    if dispatch.resolve("layer_norm", x, gain, bias=bias) == "reference":
        return layer_norm_reference(x, gain, bias, eps)
    return FusedLayerNorm.apply(x, gain, bias, eps)
