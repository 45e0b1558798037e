"""Launcher of the LayerNorm forward kernel (``csrc/layer_norm_fwd.cu``; see
that file for its design and bound).

:func:`launch` checks what the kernel takes, allocates y, mean and rstd
with ``torch.empty``, launches on PyTorch's current stream and raises if
the launch fails.  ``LAUNCHES`` counts launches, and only those.  The
public functions and the plain version are in ``ops/norm_kernels.py``,
which calls this only for CUDA tensors.
"""
from __future__ import annotations

import torch

from deeplearning4j_tpu_torch.monitor.registry import registry

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_INT_MAX = 2 ** 31 - 1
#: widest row the kernel takes (one block of 256 threads reduces a row)
MAX_F = 8192

LAUNCHES = registry().counter(
    "ops_kernel_launches_total", help="hand-written kernel launches",
    labels={"kernel": "layer_norm_fwd"})


def _vector(t, F) -> bool:
    return (isinstance(t, torch.Tensor) and t.dtype in _DTYPE_CODES
            and tuple(t.shape) == (F,))


def supports(x, gain, bias=None, **kw) -> bool:
    """f32 or bf16 x with a contiguous last axis of 1 to 8192 features;
    gain and bias [F] f32 or bf16 (bias may be None)."""
    if not (isinstance(x, torch.Tensor) and x.ndim >= 1
            and x.dtype in _DTYPE_CODES):
        return False
    F = x.shape[-1]
    return (1 <= F <= MAX_F and (x.stride(-1) == 1 or F == 1)
            and _vector(gain, F) and (bias is None or _vector(bias, F)))


def launch(x: torch.Tensor, gain: torch.Tensor, bias, eps: float):
    """(y, mean, rstd) of a LayerNorm over x's last axis on the card: y in
    x's shape and dtype, mean and rstd [rows] f32."""
    from deeplearning4j_tpu_torch.ops.kernels import build

    F = x.shape[-1]
    x2 = x.reshape(-1, F)            # a view where the rows are evenly spaced
    rows = x2.shape[0]
    if rows > 1 and x2.stride(0) < F:  # overlapping rows (an expanded x)
        x2 = x2.contiguous()
    if rows > _INT_MAX:
        raise ValueError(f"layer_norm_fwd: {rows} rows exceed 32 bits")
    gain = gain.contiguous()
    if bias is not None:
        bias = bias.to(gain.dtype).contiguous()
    y = torch.empty((rows, F), dtype=x.dtype, device=x.device)
    mean = torch.empty((rows,), dtype=torch.float32, device=x.device)
    rstd = torch.empty((rows,), dtype=torch.float32, device=x.device)
    if rows == 0:
        return y.reshape(x.shape), mean, rstd
    # a one-row view may carry any stride over its single row
    x_stride = x2.stride(0) if rows > 1 else F
    lib = build.library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.dl4j_layer_norm_fwd(
            x2.data_ptr(), gain.data_ptr(),
            None if bias is None else bias.data_ptr(), y.data_ptr(),
            mean.data_ptr(), rstd.data_ptr(), rows, F, x_stride, float(eps),
            _DTYPE_CODES[x.dtype], _DTYPE_CODES[gain.dtype], stream)
    if rc != 0:
        raise RuntimeError(
            f"layer_norm_fwd launch failed: {build.error_string(rc)} (code {rc})")
    LAUNCHES.inc()
    return y.reshape(x.shape), mean, rstd
