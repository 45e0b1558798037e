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
* :func:`layer_norm_bwd_plain` is the plain version of the backward
  kernel, with ``_ln_bwd_kernel``'s arithmetic: from the forward's mean
  and rstd, dx per row in x's dtype, and dgain and dbias summed over the
  rows in f32 and cast to gain's and bias's dtypes, as ``_fused_ln_bwd``
  returns them.
* :func:`fused_layer_norm` is the dispatcher the layers and BERT call.
  Under ``auto`` on CUDA it runs the kernels for any rows and any 1 <= F
  <= 8192: none of the JAX package's TPU gates (rows % 256, F % 128, rows
  >= 1024) is copied.  For CPU tensors, or in ``reference`` mode, it runs
  :func:`layer_norm_reference` under autograd, as the JAX package does off
  the TPU.

:class:`FusedLayerNorm` is the autograd wrapper of the kernel path: its
forward launches the forward kernel and keeps the mean and rstd it
emits; its backward launches the backward kernel on them and recomputes
nothing (``ops/kernels/layer_norm.py``'s ``launch_bwd``, on the card
only).
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


def layer_norm_bwd_plain(x: torch.Tensor, gain: torch.Tensor,
                         mean: torch.Tensor, rstd: torch.Tensor,
                         dy: torch.Tensor, bias_dtype=None):
    """The backward kernel's arithmetic in plain PyTorch: (dx in x's dtype,
    dgain in gain's dtype, dbias in `bias_dtype`, or None when it is None).
    mean and rstd are the forward's [rows]; f64 inputs stay f64."""
    F = x.shape[-1]
    acc = torch.promote_types(x.dtype, torch.float32)
    xf = x.reshape(-1, F).to(acc)
    dyf = dy.reshape(-1, F).to(acc)
    xhat = (xf - mean.to(acc)[:, None]) * rstd.to(acc)[:, None]
    wdy = dyf * gain.to(acc)
    c1 = torch.mean(wdy * xhat, dim=-1, keepdim=True)
    c2 = torch.mean(wdy, dim=-1, keepdim=True)
    dx = (wdy - xhat * c1 - c2) * rstd.to(acc)[:, None]
    dgain = torch.sum(dyf * xhat, dim=0).to(gain.dtype)
    dbias = None if bias_dtype is None else torch.sum(dyf, dim=0).to(bias_dtype)
    return dx.to(x.dtype).reshape(x.shape), dgain, dbias


class FusedLayerNorm(torch.autograd.Function):
    """The forward kernel, keeping its mean and rstd; the backward kernel
    on them.  Gradients come back in x's, gain's and bias's dtypes."""

    @staticmethod
    def forward(ctx, x, gain, bias, eps):
        y, mean, rstd = _kernel.launch(x, gain, bias, eps)
        ctx.save_for_backward(x, gain, mean, rstd)
        ctx.bias_dtype = None if bias is None else bias.dtype
        return y

    @staticmethod
    def backward(ctx, g):
        x, gain, mean, rstd = ctx.saved_tensors
        dx, dgain, dbias = _kernel.launch_bwd(x, gain, mean, rstd, g, ctx.bias_dtype)
        needs = ctx.needs_input_grad
        return (dx if needs[0] else None, dgain if needs[1] else None,
                dbias if needs[2] else None, None)


def fused_layer_norm(x: torch.Tensor, gain: torch.Tensor,
                     bias: Optional[torch.Tensor] = None,
                     eps: float = 1e-5) -> torch.Tensor:
    """Layer norm over the last axis: the kernel for CUDA tensors, the
    JAX package's plain composition for CPU tensors or in ``reference``
    mode.  A CUDA input the kernel does not take raises."""
    if dispatch.resolve("layer_norm", x, gain, bias=bias) == "reference":
        return layer_norm_reference(x, gain, bias, eps)
    return FusedLayerNorm.apply(x, gain, bias, eps)
