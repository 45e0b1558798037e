"""Int8 weight-quantization primitives of the inference path (the port of
``ops/quant_kernels.py``).

- :class:`QTensor`: int8 (or bf16-fallback) values and f32 per-channel
  scales along ``axis``, a plain holder of two tensors (``.to(device)``
  moves both).  In a model it keeps the port's layout: a conv ``W`` is
  OIHW with its scale ``[O, 1, 1, 1]`` along axis 0, which is the JAX
  layout's last axis (HWIO's O).
- :func:`quantize_tensor` / :func:`dequantize`: per-channel symmetric int8,
  the same numbers as the JAX package's numpy code to the bit:
  ``amax / 127`` in the input's dtype, round half to even, clip to +-127,
  scale 1 for an all-zero channel.  Runs on torch tensors on any device;
  every division is tensor by tensor (PyTorch turns a CUDA tensor divided
  by a Python scalar into a product with its reciprocal, which can differ
  in the last bit).
- :func:`quantized_matmul` / :func:`quantized_dense`: the weight-only
  product; :func:`quantized_matmul_static`: int8 activations at a
  calibration scale times int8 weights, int32 accumulation.  Each asks
  ``dispatch.resolve`` which implementation runs: the hand-written
  ``q_matmul`` / ``int8_matmul`` kernels (``ops/kernels/matmul.py``) for
  CUDA tensors, their plain versions for CPU tensors or in ``reference``
  mode.
- :func:`range_hostility` and :func:`quantization_error` run on the host
  in float64 with numpy, as the JAX package does, so the value that
  decides int8 against the bf16 fallback is the same to the bit.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch.ops.kernels import dispatch
from deeplearning4j_tpu_torch.ops.kernels import matmul as km
from deeplearning4j_tpu_torch.ops.kernels.matmul import (  # noqa: F401
    dequant_epilogue)

INT8_MAX = 127.0


class QTensor:
    """Quantized tensor: int8 (or bf16-fallback) values ``q`` and per-channel
    scales ``scale`` (1 everywhere but ``axis``, so they broadcast)."""

    def __init__(self, q, scale, axis: int = -1):
        self.q = q
        self.scale = scale
        self.axis = int(axis)

    def to(self, device) -> "QTensor":
        return QTensor(self.q.to(device), self.scale.to(device), self.axis)

    @property
    def shape(self) -> Tuple[int, ...]:
        return tuple(self.q.shape)

    @property
    def ndim(self) -> int:
        return self.q.ndim

    @property
    def dtype(self):
        return self.q.dtype

    @property
    def nbytes(self) -> int:
        return int(self.q.numel() * self.q.element_size()
                   + self.scale.numel() * self.scale.element_size())

    def __repr__(self):
        return (f"QTensor(shape={self.shape}, dtype={self.q.dtype}, "
                f"axis={self.axis})")


def _as_tensor(w) -> torch.Tensor:
    return w if isinstance(w, torch.Tensor) else torch.as_tensor(np.asarray(w))


def quantize_tensor(w, axis: int = -1) -> QTensor:
    """Symmetric per-channel int8 quantization: one scale per slice along
    ``axis`` (for a dense W of [n_in, n_out], axis=-1 is per output
    channel).  All-zero channels get scale 1 so dequantization stays
    finite.  The result lies on w's device."""
    w = _as_tensor(w).detach()
    nd = w.ndim
    axis = axis % nd if nd else 0
    reduce_axes = tuple(i for i in range(nd) if i != axis)
    aw = w.abs()
    amax = aw.amax(dim=reduce_axes, keepdim=True) if reduce_axes else aw
    scale = amax / torch.full_like(amax, INT8_MAX)
    scale = torch.where(scale == 0.0, torch.ones_like(scale), scale)
    scale = scale.to(torch.float32)
    # numpy divides w by the f32 scale in their promoted type
    pt = torch.promote_types(w.dtype, torch.float32)
    q = torch.clamp(torch.round(w.to(pt) / scale.to(pt)),
                    -INT8_MAX, INT8_MAX).to(torch.int8)
    return QTensor(q, scale, axis=axis)


def dequantize(qt: QTensor, dtype=torch.float32) -> torch.Tensor:
    """Reconstruct a dense tensor in ``dtype``: ``f(q) * f(scale)``."""
    return (qt.q.to(dtype) * qt.scale.to(dtype)).to(dtype)


def _host64(w) -> np.ndarray:
    if isinstance(w, torch.Tensor):
        w = w.detach().cpu()
        if w.dtype == torch.bfloat16:
            w = w.float()
        w = w.numpy()
    return np.asarray(w, np.float64)


def quantization_error(w, axis: int = -1) -> float:
    """Mean |w - dequant(quant(w))| / mean |w|: the relative information
    loss of an int8 round trip (the bf16-fallback signal)."""
    w = _host64(w)
    qt = quantize_tensor(torch.from_numpy(w), axis=axis)
    deq = qt.q.numpy().astype(np.float64) * qt.scale.numpy().astype(np.float64)
    denom = float(np.abs(w).mean()) or 1.0
    return float(np.abs(w - deq).mean()) / denom


def range_hostility(w, axis: int = -1) -> float:
    """max / mean of |w| within the worst channel along ``axis``: above
    ~127 most of that channel's mass rounds to zero in int8, the case
    ``quant/ptq.py`` sends to bf16.  Host numpy in float64, as in the JAX
    package (so pass w in the JAX layout to get its value to the bit)."""
    w = _host64(w)
    nd = w.ndim
    axis = axis % nd if nd else 0
    reduce_axes = tuple(i for i in range(nd) if i != axis)
    aw = np.abs(w)
    amax = aw.max(axis=reduce_axes)
    amean = aw.mean(axis=reduce_axes)
    ratio = amax / np.where(amean == 0.0, 1.0, amean)
    return float(ratio.max()) if ratio.size else 0.0


def _check_axis(qt: QTensor, what: str) -> None:
    if qt.axis != qt.ndim - 1:
        raise ValueError(
            f"{what} needs per-output-channel scales (axis={qt.ndim - 1}), "
            f"got axis={qt.axis}")


def quantized_matmul(x, qt: QTensor, acc_dtype=None):
    """x @ dequant(W) computed as (x @ W_q) * scale: int8 W widened to the
    accumulating dtype (default x's), the per-output-channel scale applied
    to the product.  CUDA tensors run the ``q_matmul`` kernel."""
    _check_axis(qt, "quantized_matmul")
    if dispatch.resolve("q_matmul", x, qt.q, qt.scale,
                        acc_dtype=acc_dtype) == "kernel":
        return km.q_matmul(x, qt.q, qt.scale, acc_dtype=acc_dtype)
    return km.q_matmul_plain(x, qt.q, qt.scale, acc_dtype=acc_dtype)


def quantize_activation(x, scale):
    """Static activation quantization at a calibration scale (a Python
    float): round half to even of ``x / scale`` in x's dtype, clipped to
    +-127, as int8."""
    s = torch.full((), float(scale), dtype=x.dtype, device=x.device)
    return torch.clamp(torch.round(x / s), -INT8_MAX, INT8_MAX).to(torch.int8)


def quantized_matmul_static(x, qt: QTensor, x_scale,
                            acc_dtype=torch.float32):
    """int8 activations (static calibration scale) x int8 weights with an
    int32 accumulator, dequantized once by ``x_scale * w_scale``.  CUDA
    tensors run the ``int8_matmul`` kernel."""
    _check_axis(qt, "static quantized matmul")
    xq = quantize_activation(x, x_scale)
    if dispatch.resolve("int8_matmul", xq, qt.q, qt.scale, x_scale,
                        out_dtype=acc_dtype) == "kernel":
        return km.int8_matmul(xq, qt.q, qt.scale, x_scale=x_scale,
                              out_dtype=acc_dtype)
    return km.int8_matmul_plain(xq, qt.q, qt.scale, x_scale=x_scale,
                                out_dtype=acc_dtype)


def quantized_dense(x, qt: QTensor, b: Optional[torch.Tensor] = None,
                    acc_dtype=None):
    """Dense-layer hot path: quantized matmul + bias in the accumulating
    dtype (the calling layer applies its activation).  The kernel fuses
    the bias into its f32 epilogue; the plain path adds it in the
    accumulating dtype after the scale, as the JAX package does."""
    _check_axis(qt, "quantized_dense")
    if dispatch.resolve("q_matmul", x, qt.q, qt.scale, bias=b,
                        acc_dtype=acc_dtype) == "kernel":
        return km.q_matmul(x, qt.q, qt.scale, bias=b, acc_dtype=acc_dtype)
    return km.q_matmul_plain(x, qt.q, qt.scale, bias=b, acc_dtype=acc_dtype)
