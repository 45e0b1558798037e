"""NHWC max pooling with ``lax.reduce_window`` semantics.

Port of ``deeplearning4j_tpu/ops/pool_kernels.py``.  The
padding rules are lax's: ``"VALID"`` pads nothing and drops the ragged
tail, ``"SAME"`` pads ``(Ho - 1) * s + k - H`` in total with the smaller
half first (asymmetric when odd), and explicit ``((lo, hi), (lo, hi))``
pads as given.  Padding is filled with ``-inf``, so a padded cell never
wins.  Runs ``max_pool2d`` on an NCHW view of the NHWC tensor (a
channels-last view, no copy).

Backward: by default autograd's ``max_pool2d`` backward gives each
window's whole gradient to the first maximum in window order (row-major
over the window, as PyTorch's CPU and CUDA kernels keep a running max that
only a strictly greater value replaces).  That is the JAX package's
default, XLA's select-and-scatter; exact ties (ReLU zeros) are where the
rule shows.  With ``POOL_BWD_TAPS["enabled"]`` (the environment variable
``DL4J_TPU_POOL_BWD_TAPS=1``, as the JAX module reads it; off by default
there and here) :func:`max_pool2d` runs :func:`max_pool2d_taps` instead,
the JAX package's taps backward: the max match is recomputed on the
output grid with kh*kw shifted strided views, and ``dy * [x == y] / ties``
is added back through kh*kw strided slices, so tied maxima share a
window's gradient evenly (sum(dx) == sum(dy)).  It computes in f32, tap by
tap in the JAX order, and returns dx in x's dtype, as the JAX ``_bwd``
does.
"""
from __future__ import annotations

import os

import torch
import torch.nn.functional as F

POOL_BWD_TAPS = {
    "enabled": os.environ.get("DL4J_TPU_POOL_BWD_TAPS", "") == "1",
}


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


def _pool_fwd(x: torch.Tensor, kernel, stride, padding) -> torch.Tensor:
    xc = x.permute(0, 3, 1, 2)
    pads = resolve_pad(padding, xc.shape[2], xc.shape[3], kernel, stride)
    y = F.max_pool2d(pad_nchw(xc, pads, float("-inf")), tuple(kernel),
                     tuple(stride))
    return y.permute(0, 2, 3, 1)


class _MaxPoolTaps(torch.autograd.Function):
    """The forward of :func:`_pool_fwd`, the JAX package's taps backward."""

    @staticmethod
    def forward(ctx, x, kernel, stride, padding):
        y = _pool_fwd(x, kernel, stride, padding)
        ctx.save_for_backward(x, y)
        ctx.cfg = (kernel, stride, padding)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, y = ctx.saved_tensors
        (kh, kw), (sh, sw), padding = ctx.cfg
        B, H, W, C = x.shape
        Ho, Wo = y.shape[1], y.shape[2]
        (plh, _), (plw, _) = resolve_pad(padding, H, W, (kh, kw), (sh, sw))
        Lh, Lw = (Ho - 1) * sh + kh, (Wo - 1) * sw + kw     # padded window coverage
        xp = F.pad(x.float(), (0, 0, plw, max(Lw - W - plw, 0), plh, max(Lh - H - plh, 0)),
                   value=float("-inf"))[:, :Lh, :Lw, :]
        yf = y.float()

        def tap(t, ti, tj):
            return t[:, ti:ti + (Ho - 1) * sh + 1:sh, tj:tj + (Wo - 1) * sw + 1:sw, :]

        taps, ties = [], 0.0
        for ti in range(kh):
            for tj in range(kw):
                eq = (tap(xp, ti, tj) == yf).float()
                taps.append(eq)
                ties = ties + eq
        scale = dy.float() / ties
        dxp = torch.zeros((B, Lh, Lw, C), dtype=torch.float32, device=x.device)
        for i, (ti, tj) in enumerate((a, b) for a in range(kh) for b in range(kw)):
            tap(dxp, ti, tj).add_(taps[i] * scale)
        dx = dxp[:, plh:plh + H, plw:plw + W, :]
        if dx.shape[1] < H or dx.shape[2] < W:     # VALID with a cropped tail
            dx = F.pad(dx, (0, 0, 0, W - dx.shape[2], 0, H - dx.shape[1]))
        return dx.to(x.dtype), None, None, None


def max_pool2d_taps(x: torch.Tensor, kernel, stride, padding="VALID") -> torch.Tensor:
    """NHWC max pool whose backward splits tied maxima evenly (see the
    module docstring).  `padding`: "SAME" | "VALID" | ((lo,hi),(lo,hi))."""
    return _MaxPoolTaps.apply(x, tuple(kernel), tuple(stride), padding)


def max_pool2d(x: torch.Tensor, kernel, stride, padding="VALID") -> torch.Tensor:
    """NHWC max pool; `padding`: "SAME" | "VALID" | ((lo,hi),(lo,hi)).  The
    taps backward when ``POOL_BWD_TAPS["enabled"]``, else autograd's."""
    if POOL_BWD_TAPS["enabled"]:
        return max_pool2d_taps(x, kernel, stride, padding)
    return _pool_fwd(x, kernel, stride, padding)
