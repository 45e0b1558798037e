"""Launchers of the 3x3 conv backward kernels (``csrc/conv3x3_wgrad.cu``,
``csrc/conv3x3_dgrad.cu``, both on the implicit GEMM of
``csrc/conv3x3_igemm.cuh``; see those files for design and bound).

Each launcher checks what its kernel takes, allocates its output with
``torch.empty``, launches on PyTorch's current stream and raises if the
launch fails.  :func:`conv_plan` picks the grid and the split of the
reduction; the split's f32 workspace, its int32 arrival counters and
dgrad's packed filter are buffers kept per (device, stream), as
``matmul.py`` keeps its own (launches on one stream run in order, so they
never share them at once; the kernels leave the counters zero, so a
replayed CUDA graph starts clean; a graph being captured holds the ones
it bakes in, ``matmul.hold_if_capturing``).
``WGRAD_LAUNCHES`` and ``DGRAD_LAUNCHES`` count launches, one a call, and
only those.  The public functions and their plain versions are in
``ops/conv_kernels.py``, which calls these only for CUDA tensors.
"""
from __future__ import annotations

import functools
import threading
from typing import Dict, NamedTuple, Tuple

import torch

from deeplearning4j_tpu_torch.monitor.registry import registry
from deeplearning4j_tpu_torch.ops.kernels.matmul import (_current_stream,
                                                         _on_device, _sm_count,
                                                         hold_if_capturing)

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
#: the product each dtype runs on: 3xTF32 tensor-core products for f32,
#: bf16 tensor-core products for bf16 (both with f32 accumulators)
ROUTES = {torch.float32: "3xtf32", torch.bfloat16: "mma_bf16"}
_INT_MAX = 2 ** 31 - 1
#: the output tile and reduction step of ``csrc/conv3x3_igemm.cuh``
BLOCK_M = 64
BLOCK_N = 64
BLOCK_K = 32
#: fewest blocks per SM the grid may have (latency hiding), where the
#: reduction has steps enough to split
MIN_BLOCKS_PER_SM = 2
#: most slices of a split reduction
MAX_SPLITS = 64
#: a split within this many percent of the best makespan is taken if it
#: has fewer slices (less workspace traffic)
SPLIT_SLACK_PCT = 5
#: dgrad's packed filter rows are padded to this many elements (16 bytes
#: of bf16)
PACK_ALIGN = 8

WGRAD_LAUNCHES = registry().counter(
    "ops_kernel_launches_total", help="hand-written kernel launches",
    labels={"kernel": "conv3x3_wgrad"})
DGRAD_LAUNCHES = registry().counter(
    "ops_kernel_launches_total", help="hand-written kernel launches",
    labels={"kernel": "conv3x3_dgrad"})

_buffers_lock = threading.Lock()
#: (device index, stream) -> (f32 workspace, int32 counters, packed filter bytes)
_buffers: Dict[Tuple[int, int], Tuple[torch.Tensor, torch.Tensor, torch.Tensor]] = {}
_tile_checked = False


class ConvPlan(NamedTuple):
    """One launch: ``grid`` is (M tiles, N tiles, z) with z = S for dgrad
    and 9 * S for wgrad (tap-major); slice s sums the reduction steps
    ``slices[s]`` of ``steps``; ``tiles`` output tiles share the counters;
    ``workspace_bytes`` holds the f32 partial tiles [S, tiles, 64 * 64]
    (none when S = 1); ``packed_w_bytes`` is dgrad's [9, Co, ci_ld]
    filter (0 for wgrad)."""
    steps: int
    splits: int
    slices: Tuple[Tuple[int, int], ...]
    grid: Tuple[int, int, int]
    tiles: int
    workspace_bytes: int
    packed_w_bytes: int


@functools.lru_cache(maxsize=1024)
def conv_plan(kernel: str, B: int, H: int, W: int, Ci: int, Co: int,
              sm_count: int, itemsize: int = 4) -> ConvPlan:
    """The launch of ``kernel`` (``conv3x3_wgrad`` or ``conv3x3_dgrad``) on
    x [B, H, W, Ci] / dy [B, H, W, Co] of ``itemsize``-byte elements.

    dgrad: M = B*H*W positions, N = Ci, one tile layer, and the reduction
    runs over 9 taps x ceil(Co / 32) channel steps.  wgrad: nine layers of
    M = Ci by N = Co tiles, one per tap, and the reduction runs over
    ceil(B*H*W / 32) position steps.

    The reduction is split into S slices, at most one a step; slice s
    covers steps ``[s*steps//S, (s+1)*steps//S)``, the formula of
    ``slice_bounds`` in ``csrc/conv3x3_igemm.cuh``.  S is the fewest
    slices that give the grid ``MIN_BLOCKS_PER_SM`` blocks per SM and a
    makespan (blocks on the busiest SM times steps a block) within
    ``SPLIT_SLACK_PCT`` percent of the best for up to ``MAX_SPLITS``
    slices: 270 blocks on 132 SMs put 3 blocks' work on some SMs and 2 on
    others, while 396 blocks put 3 on each."""
    P = B * H * W
    if kernel == "conv3x3_wgrad":
        mt, nt, layers = -(-Ci // BLOCK_M), -(-Co // BLOCK_N), 9
        steps = -(-P // BLOCK_K)
    elif kernel == "conv3x3_dgrad":
        mt, nt, layers = -(-P // BLOCK_M), -(-Ci // BLOCK_N), 1
        steps = 9 * -(-Co // BLOCK_K)
    else:
        raise ValueError(f"no conv kernel {kernel!r}")
    tiles = mt * nt * layers
    most = max(1, min(steps, MAX_SPLITS, 65535 // layers))
    least = min(most, -(-MIN_BLOCKS_PER_SM * sm_count // tiles))

    def makespan(S):
        return -(-tiles * S // sm_count) * -(-steps // S)

    best = min(makespan(S) for S in range(least, most + 1))
    S = next(S for S in range(least, most + 1)
             if makespan(S) * 100 <= best * (100 + SPLIT_SLACK_PCT))
    slices = tuple((s * steps // S, (s + 1) * steps // S) for s in range(S))
    ws = S * tiles * BLOCK_M * BLOCK_N * 4 if S > 1 else 0
    ci_ld = -(-Ci // PACK_ALIGN) * PACK_ALIGN
    packed = 9 * Co * ci_ld * itemsize if kernel == "conv3x3_dgrad" else 0
    return ConvPlan(steps, S, slices, (mt, nt, layers * S), tiles, ws, packed)


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


def _check_tile(lib) -> None:
    """Once per process: the library's compiled tile is the plan's."""
    global _tile_checked
    if _tile_checked:
        return
    import ctypes
    got = [ctypes.c_int() for _ in range(3)]
    lib.dl4j_conv3x3_tile(*map(ctypes.byref, got))
    if tuple(v.value for v in got) != (BLOCK_M, BLOCK_N, BLOCK_K):
        raise RuntimeError(
            f"conv3x3: the library is compiled for tile m,n,k="
            f"{tuple(v.value for v in got)}, the plan assumes "
            f"{(BLOCK_M, BLOCK_N, BLOCK_K)}")
    _tile_checked = True


def _launch_args(kernel: str, t: torch.Tensor, Ci: int, Co: int):
    """(library, stream, plan, workspace pointer, counters pointer, packed
    filter pointer) for one launch on the device's current stream.  The
    buffers are the stream's; a zeroed counter buffer (and a workspace, a
    filter buffer) replaces one that is too small.  Call under
    :func:`_on_device`."""
    from deeplearning4j_tpu_torch.ops.kernels import build

    lib = build.library()
    _check_tile(lib)
    device = t.device
    idx = device.index
    stream = _current_stream(idx)
    B, H, W = t.shape[:3]
    plan = conv_plan(kernel, B, H, W, Ci, Co, _sm_count(idx), t.element_size())
    with _buffers_lock:
        ws, ctr, wp = _buffers.get((idx, stream), (None, None, None))
        if ws is None or ws.numel() * 4 < plan.workspace_bytes:
            ws = torch.empty(max(1, plan.workspace_bytes // 4), dtype=torch.float32,
                             device=device)
        if ctr is None or ctr.numel() < plan.tiles:
            ctr = torch.zeros(plan.tiles, dtype=torch.int32, device=device)
        if wp is None or wp.numel() < plan.packed_w_bytes:
            wp = torch.empty(max(16, plan.packed_w_bytes), dtype=torch.uint8,
                             device=device)
        _buffers[(idx, stream)] = (ws, ctr, wp)
    hold_if_capturing(ws, ctr, wp)
    return lib, stream, plan, ws.data_ptr(), ctr.data_ptr(), wp.data_ptr()


def _raise_on(name: str, rc: int) -> None:
    from deeplearning4j_tpu_torch.ops.kernels import build

    if rc != 0:
        raise RuntimeError(
            f"{name} launch failed: {build.error_string(rc)} (code {rc})")


def launch_wgrad(x: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """dW [Co, Ci, 3, 3] f32 of a 3x3 stride-1 SAME conv, from NHWC x and
    dy on the card."""
    _check("conv3x3_wgrad", x, dy)
    B, H, W, Ci = x.shape
    Co = dy.shape[3]
    dw = torch.empty((Co, Ci, 3, 3), dtype=torch.float32, device=x.device)
    with _on_device(x.device):
        lib, stream, plan, ws, ctr, _ = _launch_args("conv3x3_wgrad", x, Ci, Co)
        rc = lib.dl4j_conv3x3_wgrad(
            x.data_ptr(), dy.data_ptr(), dw.data_ptr(), ws, ctr,
            B, H, W, Ci, Co, plan.splits, _DTYPE_CODES[x.dtype], stream)
    _raise_on("conv3x3_wgrad", rc)
    WGRAD_LAUNCHES.inc()
    return dw


def launch_dgrad(dy: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """dx [B, H, W, Ci] f32 of a 3x3 stride-1 SAME conv, from NHWC dy and
    the OIHW filter on the card."""
    _check("conv3x3_dgrad", dy, w)
    B, H, W, Co = dy.shape
    Ci = w.shape[1]
    dx = torch.empty((B, H, W, Ci), dtype=torch.float32, device=dy.device)
    with _on_device(dy.device):
        lib, stream, plan, ws, ctr, wp = _launch_args("conv3x3_dgrad", dy, Ci, Co)
        rc = lib.dl4j_conv3x3_dgrad(
            dy.data_ptr(), w.data_ptr(), wp, dx.data_ptr(), ws, ctr,
            B, H, W, Ci, Co, plan.splits, _DTYPE_CODES[dy.dtype], stream)
    _raise_on("conv3x3_dgrad", rc)
    DGRAD_LAUNCHES.inc()
    return dx
