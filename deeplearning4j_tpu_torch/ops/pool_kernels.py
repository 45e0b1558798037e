"""NHWC max pooling with ``lax.reduce_window`` semantics.

Port of the forward of ``deeplearning4j_tpu/ops/pool_kernels.py``.  The
padding rules are lax's: ``"VALID"`` pads nothing and drops the ragged
tail, ``"SAME"`` pads ``(Ho - 1) * s + k - H`` in total with the smaller
half first (asymmetric when odd), and explicit ``((lo, hi), (lo, hi))``
pads as given.  Padding is filled with ``-inf``, so a padded cell never
wins.  Runs ``max_pool2d`` on an NCHW view of the NHWC tensor (a
channels-last view, no copy).

Backward: autograd's ``max_pool2d`` backward gives each window's whole
gradient to the first maximum in window order (row-major over the window,
as PyTorch's CPU and CUDA kernels keep a running max that only a strictly
greater value replaces).  That is the JAX package's default, XLA's
select-and-scatter; exact ties (ReLU zeros) are where the rule shows.  The
JAX package's tie-splitting taps backward (``POOL_BWD_TAPS``, off by
default there) is not ported.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def resolve_pad(padding, H, W, kernel, stride):
    """Per-dim (lo, hi) pads matching lax.reduce_window's semantics."""
    kh, kw = kernel
    sh, sw = stride
    if padding == "VALID":
        return (0, 0), (0, 0)
    if padding == "SAME":
        Ho, Wo = -(-H // sh), -(-W // sw)
        th = max((Ho - 1) * sh + kh - H, 0)
        tw = max((Wo - 1) * sw + kw - W, 0)
        return (th // 2, th - th // 2), (tw // 2, tw - tw // 2)
    (plh, phh), (plw, phw) = padding
    return (int(plh), int(phh)), (int(plw), int(phw))


def pad_nchw(x: torch.Tensor, pads, value: float) -> torch.Tensor:
    (plh, phh), (plw, phw) = pads
    if plh or phh or plw or phw:
        x = F.pad(x, (plw, phw, plh, phh), value=value)
    return x


def max_pool2d(x: torch.Tensor, kernel, stride, padding="VALID") -> torch.Tensor:
    """NHWC max pool; `padding`: "SAME" | "VALID" | ((lo,hi),(lo,hi))."""
    xc = x.permute(0, 3, 1, 2)
    pads = resolve_pad(padding, xc.shape[2], xc.shape[3], kernel, stride)
    y = F.max_pool2d(pad_nchw(xc, pads, float("-inf")), tuple(kernel),
                     tuple(stride))
    return y.permute(0, 2, 3, 1)
