"""Launchers of the LayerNorm kernels (``csrc/layer_norm_fwd.cu`` and
``csrc/layer_norm_bwd.cu``; see those files for their design and bound).

:func:`launch` (forward) and :func:`launch_bwd` (backward) check what the
kernel takes, allocate outputs and scratch with ``torch.empty``, launch on
PyTorch's current stream and raise if the launch fails.  ``LAUNCHES`` and
``BWD_LAUNCHES`` count launches, and only those.  The public functions and
the plain versions are in ``ops/norm_kernels.py``, which calls these only
for CUDA tensors.
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
BWD_LAUNCHES = registry().counter(
    "ops_kernel_launches_total", help="hand-written kernel launches",
    labels={"kernel": "layer_norm_bwd"})


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


def bwd_supports(x, gain, mean=None, rstd=None, dy=None, **kw) -> bool:
    """What :func:`supports` takes for x and gain; mean and rstd [rows]
    f32; dy of x's shape and dtype with a contiguous last axis."""
    if not supports(x, gain):
        return False
    rows = x.numel() // max(x.shape[-1], 1)
    stats = all(isinstance(t, torch.Tensor) and t.dtype == torch.float32
                and tuple(t.shape) == (rows,) for t in (mean, rstd))
    return (stats and isinstance(dy, torch.Tensor) and dy.dtype == x.dtype
            and dy.shape == x.shape)


def _rows_view(t: torch.Tensor, F: int) -> torch.Tensor:
    """t as [rows, F] with unit stride over F and evenly spaced,
    non-overlapping rows: a view where one exists, else a copy."""
    t2 = t.reshape(-1, F)
    if (t2.stride(-1) != 1 and F > 1) or (t2.shape[0] > 1 and t2.stride(0) < F):
        t2 = t2.contiguous()
    return t2


def _row_stride(t2: torch.Tensor, F: int) -> int:
    # a one-row view may carry any stride over its single row
    return t2.stride(0) if t2.shape[0] > 1 else F


def launch(x: torch.Tensor, gain: torch.Tensor, bias, eps: float):
    """(y, mean, rstd) of a LayerNorm over x's last axis on the card: y in
    x's shape and dtype, mean and rstd [rows] f32."""
    from deeplearning4j_tpu_torch.ops.kernels import build

    F = x.shape[-1]
    x2 = _rows_view(x, F)
    rows = x2.shape[0]
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
    x_stride = _row_stride(x2, F)
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


def launch_bwd(x: torch.Tensor, gain: torch.Tensor, mean: torch.Tensor,
               rstd: torch.Tensor, dy: torch.Tensor, bias_dtype=None):
    """(dx, dgain, dbias) of a LayerNorm on the card from the forward's
    mean and rstd: dx in x's shape and dtype, dgain [F] in gain's dtype,
    dbias [F] in `bias_dtype` (None: no dbias).  A CUDA input the kernel
    does not take raises."""
    from deeplearning4j_tpu_torch.ops.kernels import build

    if not bwd_supports(x, gain, mean, rstd, dy):
        raise ValueError("layer_norm_bwd: the kernel does not take these inputs")
    if bias_dtype is not None and bias_dtype not in _DTYPE_CODES:
        raise ValueError(f"layer_norm_bwd: bias dtype {bias_dtype} is not f32 or bf16")
    F = x.shape[-1]
    x2, dy2 = _rows_view(x, F), _rows_view(dy, F)
    rows = x2.shape[0]
    if rows > _INT_MAX:
        raise ValueError(f"layer_norm_bwd: {rows} rows exceed 32 bits")
    dev = x.device
    gain = gain.contiguous()
    dx = torch.empty((rows, F), dtype=x.dtype, device=dev)
    dgain = torch.empty((F,), dtype=gain.dtype, device=dev)
    dbias = (None if bias_dtype is None
             else torch.empty((F,), dtype=bias_dtype, device=dev))
    if rows == 0:
        if dbias is not None:
            dbias.zero_()
        return dx.reshape(x.shape), dgain.zero_(), dbias
    lib = build.library()
    nblk = lib.dl4j_layer_norm_bwd_blocks(rows, F)
    partials = torch.empty((2, nblk, F), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.dl4j_layer_norm_bwd(
            x2.data_ptr(), gain.data_ptr(), mean.data_ptr(), rstd.data_ptr(),
            dy2.data_ptr(), dx.data_ptr(), dgain.data_ptr(),
            None if dbias is None else dbias.data_ptr(), partials.data_ptr(),
            rows, F, _row_stride(x2, F), _row_stride(dy2, F), nblk,
            _DTYPE_CODES[x.dtype], _DTYPE_CODES[gain.dtype],
            _DTYPE_CODES[bias_dtype] if bias_dtype is not None else 0, stream)
    if rc != 0:
        raise RuntimeError(
            f"layer_norm_bwd launch failed: {build.error_string(rc)} (code {rc})")
    BWD_LAUNCHES.inc()
    return dx.reshape(x.shape), dgain, dbias
