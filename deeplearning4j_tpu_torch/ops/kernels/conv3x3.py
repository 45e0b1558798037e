"""Launchers of the 3x3 conv backward kernels (``csrc/conv3x3_wgrad.cu``,
``csrc/conv3x3_dgrad.cu``; see those files for design and bound).

Each launcher checks what its kernel takes, allocates its outputs (and
wgrad's split-K scratch) with ``torch.empty``, launches on PyTorch's
current stream and raises if the launch fails.  ``WGRAD_LAUNCHES`` and
``DGRAD_LAUNCHES`` count launches, and only those.  The public functions
and their plain versions are in ``ops/conv_kernels.py``, which calls these
only for CUDA tensors.
"""
from __future__ import annotations

import torch

from deeplearning4j_tpu_torch.monitor.registry import registry

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_INT_MAX = 2 ** 31 - 1
#: wgrad's pass 1 aims at this many blocks (about four per SM of an H100,
#: which has 132) before it splits the positions K further
_WGRAD_TARGET_BLOCKS = 4 * 132
_WGRAD_TILE = 64      # (ci, co) tile of pass 1
_WGRAD_STEP = 16      # positions per K step of pass 1

WGRAD_LAUNCHES = registry().counter(
    "ops_kernel_launches_total", help="hand-written kernel launches",
    labels={"kernel": "conv3x3_wgrad"})
DGRAD_LAUNCHES = registry().counter(
    "ops_kernel_launches_total", help="hand-written kernel launches",
    labels={"kernel": "conv3x3_dgrad"})


def _nhwc(t) -> bool:
    return (isinstance(t, torch.Tensor) and t.ndim == 4
            and t.dtype in _DTYPE_CODES)


def wgrad_supports(x, dy, **kw) -> bool:
    return (_nhwc(x) and _nhwc(dy) and dy.dtype == x.dtype
            and tuple(dy.shape[:3]) == tuple(x.shape[:3]))


def dgrad_supports(dy, w, **kw) -> bool:
    return (_nhwc(dy) and isinstance(w, torch.Tensor) and w.dtype == dy.dtype
            and w.ndim == 4 and tuple(w.shape[2:]) == (3, 3)
            and w.shape[0] == dy.shape[3])


def _check(name, *tensors):
    for t in tensors:
        if not t.is_contiguous():
            raise ValueError(f"{name}: the kernel takes contiguous NHWC "
                             f"tensors and an OIHW filter; got strides "
                             f"{t.stride()} for shape {tuple(t.shape)}")
    B, H, W = tensors[0].shape[:3]
    if B * H * W > _INT_MAX:
        raise ValueError(f"{name}: B*H*W = {B * H * W} exceeds 32 bits")


def wgrad_split(K: int, Ci: int, Co: int):
    """(splits, chunk) of pass 1: chunk positions per block, a multiple of
    the K step, and splits * chunk >= K."""
    tiles = -(-Ci // _WGRAD_TILE) * -(-Co // _WGRAD_TILE) * 9
    steps = -(-K // _WGRAD_STEP)
    splits = max(1, min(-(-_WGRAD_TARGET_BLOCKS // tiles), steps, 65535 // 9))
    chunk = -(-steps // splits) * _WGRAD_STEP
    return -(-K // chunk), chunk


def launch_wgrad(x: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """dW [Co, Ci, 3, 3] f32 of a 3x3 stride-1 SAME conv, from NHWC x and
    dy on the card."""
    from deeplearning4j_tpu_torch.ops.kernels import build

    _check("conv3x3_wgrad", x, dy)
    B, H, W, Ci = x.shape
    Co = dy.shape[3]
    splits, chunk = wgrad_split(B * H * W, Ci, Co)
    partial = torch.empty((splits, 9, Ci, Co), dtype=torch.float32,
                          device=x.device)
    dw = torch.empty((Co, Ci, 3, 3), dtype=torch.float32, device=x.device)
    lib = build.library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.dl4j_conv3x3_wgrad(
            x.data_ptr(), dy.data_ptr(), partial.data_ptr(), dw.data_ptr(),
            B, H, W, Ci, Co, splits, chunk, _DTYPE_CODES[x.dtype], stream)
    if rc != 0:
        raise RuntimeError(
            f"conv3x3_wgrad launch failed: {build.error_string(rc)} (code {rc})")
    WGRAD_LAUNCHES.inc()
    return dw


def launch_dgrad(dy: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """dx [B, H, W, Ci] f32 of a 3x3 stride-1 SAME conv, from NHWC dy and
    the OIHW filter on the card."""
    from deeplearning4j_tpu_torch.ops.kernels import build

    _check("conv3x3_dgrad", dy, w)
    B, H, W, Co = dy.shape
    Ci = w.shape[1]
    dx = torch.empty((B, H, W, Ci), dtype=torch.float32, device=dy.device)
    lib = build.library()
    with torch.cuda.device(dy.device):
        stream = torch.cuda.current_stream(dy.device).cuda_stream
        rc = lib.dl4j_conv3x3_dgrad(
            dy.data_ptr(), w.data_ptr(), dx.data_ptr(), B, H, W, Ci, Co,
            _DTYPE_CODES[dy.dtype], stream)
    if rc != 0:
        raise RuntimeError(
            f"conv3x3_dgrad launch failed: {build.error_string(rc)} (code {rc})")
    DGRAD_LAUNCHES.inc()
    return dx
