"""3x3 stride-1 SAME convolution whose backward runs hand-written kernels
(the port of ``ops/conv_kernels.py``'s wgrad/dgrad pair and its
``conv3x3_same`` custom VJP).

For a 3x3 stride-1 SAME NHWC conv ``y = conv(x, W)``:

* the filter gradient ``dW[co, ci, i, j] = sum_{b,h,w} x_pad[b, h+i, w+j, ci]
  * dy[b, h, w, co]`` is nine [Ci, K] x [K, Co] products over K = B*H*W,
  one per tap, each with a shifted view of x (:func:`conv3x3_wgrad`);
* the input gradient ``dx = SAME-conv(dy, W rotated 180 degrees with its
  channels swapped)`` is nine [K, Co] x [Co, Ci] products summed
  (:func:`conv3x3_dgrad`).

Each has its plain PyTorch version beside it, the nine-tap formulation over
shifted views of the zero-padded input, in f32 (or f64 for f64 inputs);
CPU tensors and ``reference`` mode run it.  On CUDA tensors the CUDA
kernels run (``ops/kernels/conv3x3.py``, ``csrc/conv3x3_{wgrad,dgrad}.cu``)
or the call raises.  Both return f32; :class:`Conv3x3Same`'s backward casts
dW to W's dtype and dx to x's dtype, as the JAX VJP does.

Layouts: x, dy and dx are NHWC; W and dW are the port's OIHW
(``ConvolutionLayer.TORCH_LAYOUT``; the JAX package's are HWIO).  The
kernels write dW in OIHW themselves.  There is no gate like the JAX
package's ``CONV_BWD_PALLAS``: every eligible conv whose backward autograd
records goes through ``conv3x3_same``, and ``reference`` dispatch mode is
the only switch.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch.ops.kernels import conv3x3, dispatch


def conv3x3_eligible(x_shape, w_shape, b, stride, padding, dilation) -> bool:
    """The convs :func:`conv3x3_same` covers: 3x3 (OIHW ``w_shape``),
    stride 1, SAME, undilated, NHWC input, no bias (the layer adds its bias
    afterwards)."""
    return (b is None
            and tuple(stride) == (1, 1) and tuple(dilation) == (1, 1)
            and padding == "SAME"
            and len(w_shape) == 4 and tuple(w_shape[2:]) == (3, 3)
            and len(x_shape) == 4)


def _acc(dtype):
    return torch.promote_types(dtype, torch.float32)


def conv3x3_wgrad_reference(x: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """Plain version: dW [Co, Ci, 3, 3] as nine shifted-view products."""
    B, H, W, Ci = x.shape
    Co = dy.shape[-1]
    acc = _acc(x.dtype)
    xp = F.pad(x.to(acc), (0, 0, 1, 1, 1, 1))
    d = dy.to(acc).reshape(-1, Co)
    taps = [d.t() @ xp[:, i:i + H, j:j + W, :].reshape(-1, Ci)
            for i in range(3) for j in range(3)]
    return torch.stack(taps, dim=-1).reshape(Co, Ci, 3, 3)


def conv3x3_dgrad_reference(dy: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain version: dx [B, H, W, Ci] as nine shifted-view products
    against the rotated, channel-swapped filter taps."""
    B, H, W, Co = dy.shape
    Ci = w.shape[1]
    acc = _acc(dy.dtype)
    dyp = F.pad(dy.to(acc), (0, 0, 1, 1, 1, 1))
    wa = w.to(acc)
    dx = torch.zeros((B * H * W, Ci), dtype=acc, device=dy.device)
    for i in range(3):
        for j in range(3):
            dx = dx + dyp[:, i:i + H, j:j + W, :].reshape(-1, Co) @ wa[:, :, 2 - i, 2 - j]
    return dx.reshape(B, H, W, Ci)


def conv3x3_wgrad(x: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """Filter gradient of a 3x3 stride-1 SAME NHWC conv: x [B, H, W, Ci],
    dy [B, H, W, Co] -> dW [Co, Ci, 3, 3] float32."""
    if x.ndim != 4 or dy.ndim != 4 or tuple(dy.shape[:3]) != tuple(x.shape[:3]):
        raise ValueError(f"dy {tuple(dy.shape)} mismatches x {tuple(x.shape)}")
    if dispatch.resolve("conv3x3_wgrad", x, dy) == "reference":
        return conv3x3_wgrad_reference(x, dy)
    return conv3x3.launch_wgrad(x, dy)


def conv3x3_dgrad(dy: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Input gradient of a 3x3 stride-1 SAME NHWC conv: dy [B, H, W, Co],
    w [Co, Ci, 3, 3] -> dx [B, H, W, Ci] float32."""
    if dy.ndim != 4 or w.ndim != 4 or tuple(w.shape[2:]) != (3, 3) \
            or w.shape[0] != dy.shape[3]:
        raise ValueError(f"w {tuple(w.shape)} is not [{dy.shape[-1]}, Ci, 3, 3]")
    if dispatch.resolve("conv3x3_dgrad", dy, w) == "reference":
        return conv3x3_dgrad_reference(dy, w)
    return conv3x3.launch_dgrad(dy, w)


def _conv_forward(x, w):
    return F.conv2d(x.permute(0, 3, 1, 2), w, None, 1, 1).permute(0, 2, 3, 1)


class Conv3x3Same(torch.autograd.Function):
    """NHWC x, OIHW w -> NHWC y.  The forward is the library conv (what XLA
    ran in the JAX package); the backward is :func:`conv3x3_dgrad` and
    :func:`conv3x3_wgrad`, each computed only when its input needs it."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return _conv_forward(x, w)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        # the kernels take NHWC-contiguous tensors; the cotangent is
        # copied only if it arrives with other strides
        dy = dy.contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = conv3x3_dgrad(dy, w.contiguous()).to(x.dtype)
        if ctx.needs_input_grad[1]:
            dw = conv3x3_wgrad(x.contiguous(), dy).to(w.dtype)
        return dx, dw


def conv3x3_same(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """3x3 stride-1 SAME conv of NHWC `x` with OIHW `w`, no bias."""
    return Conv3x3Same.apply(x, w)
