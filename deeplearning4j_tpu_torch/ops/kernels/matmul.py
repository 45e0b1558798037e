"""fused_dense: a dense layer's matmul with bias + activation in its epilogue.

Port of ``deeplearning4j_tpu/ops/pallas/matmul.py``'s ``fused_dense``.  Two
implementations of one function, ``y = act(x @ W + b)`` accumulated in f32
with the bias and the activation applied in f32 and the result stored in
x's dtype:

* :func:`fused_dense_reference`, the plain PyTorch version and the spec;
* the CUDA kernel in ``csrc/fused_dense.cu``, launched by
  :func:`fused_dense` on CUDA tensors (see that file and
  ``csrc/skinny_gemm.cuh`` for its design and bound).

:func:`fused_dense` asks ``dispatch.resolve`` which one runs: CPU tensors
take the plain version, CUDA tensors the kernel, and ``reference`` mode the
plain version anywhere.  The kernel's backward is the plain version's VJP
(:class:`FusedDense`).  ``LAUNCHES`` counts kernel launches, and only
those.

The same module holds the two quantized products of the JAX module, each a
kernel of its own with its plain version beside it:

* :func:`q_matmul` (``csrc/q_matmul.cu``): weight-only int8, ``x @ f(Wq)``
  accumulated in f32, then ``* scale + bias`` in f32 and one cast, as the
  TPU kernel does; :func:`q_matmul_plain` follows
  ``q_matmul_reference`` instead, which rounds the product, the scaled
  product and the bias sum to the accumulating dtype (the same in f32,
  a few ulps apart in bf16);
* :func:`int8_matmul` (``csrc/int8_matmul.cu``): int8 x int8 with an int32
  accumulator and the ``dequant_epilogue`` order, bitwise equal to
  :func:`int8_matmul_plain`.

``Q_LAUNCHES`` and ``INT8_LAUNCHES`` count their launches.

The three kernels share one skinny-M, split-K GEMM
(``csrc/skinny_gemm.cuh``): :func:`gemm_plan` picks its K split, and the
wrappers hand it a workspace for the partial sums (f32, or int32 for
``int8_matmul``: the same 4-byte words) and an int32 counter buffer, both
kept per device and stream (launches on one stream run in order, so they
never share them at once; the kernel leaves the counters zero, so a
replayed CUDA graph starts clean).  A CUDA graph bakes the buffers of its
capture stream in; :func:`hold_if_capturing` keeps them for it.
"""
from __future__ import annotations

import contextlib
import functools
import threading
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch.monitor.registry import registry
from deeplearning4j_tpu_torch.ops.kernels import dispatch
from deeplearning4j_tpu_torch.ops.kernels.tiles import DEFAULT_TILES

#: Epilogue activations.  The plain version applies these functions; the
#: kernel applies the same math in f32 (``csrc/fused_dense.cu``).
EPILOGUE_ACTIVATIONS: Dict[str, Any] = {
    "identity": lambda y: y,
    "linear": lambda y: y,
    "relu": torch.relu,
    "tanh": torch.tanh,
    "sigmoid": torch.sigmoid,
    # exact erf form, matching ops.activations.gelu
    "gelu": lambda y: F.gelu(y, approximate="none"),
}

#: the kernel's activation codes (``enum Act`` in ``csrc/fused_dense.cu``)
_ACT_CODES = {None: 0, "identity": 0, "linear": 0, "relu": 1, "tanh": 2,
              "sigmoid": 3, "gelu": 4}
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_FLOAT_DTYPES = (torch.float32, torch.bfloat16)
_INT_MAX = 2 ** 31 - 1

#: kernel launches of fused_dense (the plain version does not count)
LAUNCHES = registry().counter(
    "ops_kernel_launches_total", help="hand-written kernel launches",
    labels={"kernel": "fused_dense"})

Q_LAUNCHES = registry().counter(
    "ops_kernel_launches_total", help="hand-written kernel launches",
    labels={"kernel": "q_matmul"})
INT8_LAUNCHES = registry().counter(
    "ops_kernel_launches_total", help="hand-written kernel launches",
    labels={"kernel": "int8_matmul"})
#: largest K whose int32 sum of int8 products cannot overflow
#: (K * 127 * 127 <= 2**31 - 1); the plain version's f64 product is exact
#: up to there too
INT8_MAX_K = (2 ** 31 - 1) // (127 * 127)

_tiles_checked: set = set()
#: blocks the split-K grid aims at, per SM
BLOCKS_PER_SM = 2
#: largest workspace kept between launches; a larger one is allocated per call
MAX_CACHED_WORKSPACE = 32 << 20
_buffers_lock = threading.Lock()
#: (device index, stream) -> (workspace of 4-byte words, f32 or int32 as the
#: kernel reads them; int32 arrival counters)
_buffers: Dict[Tuple[int, int], Tuple[torch.Tensor, torch.Tensor]] = {}
#: the buffers launches used while their stream was being captured into a
#: CUDA graph: the graph bakes their addresses in, so its owner takes them
#: (:func:`take_captured_buffers`) and keeps them as long as the graph, even
#: after a larger buffer replaces one in ``_buffers``
_captured: List[torch.Tensor] = []
_sm_counts: Dict[int, int] = {}


class GemmPlan(NamedTuple):
    """A launch of the split-K GEMM: ``grid`` is (column tiles, ``splits``,
    row tiles); slice s sums K rows ``slices[s]``; ``workspace_bytes`` is
    the partials [splits, M, N], 4 bytes each (f32, or int32 for
    ``int8_matmul``)."""
    block_m: int
    block_n: int
    block_k: int
    splits: int
    slices: Tuple[Tuple[int, int], ...]
    grid: Tuple[int, int, int]
    workspace_bytes: int


@functools.lru_cache(maxsize=1024)
def gemm_plan(M: int, N: int, K: int, sm_count: int,
              kernel: str = "fused_dense") -> GemmPlan:
    """The K split of ``kernel``'s launch (``fused_dense``, ``q_matmul`` or
    ``int8_matmul``):
    enough slices S that the grid has ``BLOCKS_PER_SM`` blocks per SM, at
    most one per K step of ``block_k`` rows.  Slice s covers the K steps
    ``[s*ksteps//S, (s+1)*ksteps//S)``, the last clipped at K;
    ``slice_bounds`` in ``csrc/skinny_gemm.cuh`` is the same formula."""
    t = DEFAULT_TILES[kernel]
    bm, bn, bk = t.block_m, t.block_n, t.block_k
    n_tiles, m_tiles = -(-N // bn), -(-M // bm)
    ksteps = max(1, -(-K // bk))
    want = -(-BLOCKS_PER_SM * sm_count // (n_tiles * m_tiles))
    S = max(1, min(ksteps, want))
    slices = tuple(((s * ksteps // S) * bk, min(K, ((s + 1) * ksteps // S) * bk))
                   for s in range(S))
    return GemmPlan(bm, bn, bk, S, slices, (n_tiles, S, m_tiles), S * M * N * 4)


def _sm_count(idx: int) -> int:
    if idx not in _sm_counts:
        _sm_counts[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return _sm_counts[idx]


def _current_stream(idx: int) -> int:
    raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    return raw(idx) if raw is not None else torch.cuda.current_stream(idx).cuda_stream


def _on_device(device: torch.device):
    """The device's context for a launch through ctypes (which launches on
    the current device); nothing to do when it is current already."""
    if device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(device)


def _f32_row(t: torch.Tensor, N: int) -> torch.Tensor:
    """t as a contiguous f32 [N] row; t itself (no call on the launch path)
    when it is one already."""
    if t.dtype == torch.float32 and t.dim() == 1 and t.is_contiguous():
        return t
    return t.to(torch.float32).reshape(N).contiguous()


def hold_if_capturing(*buffers: torch.Tensor) -> None:
    """Keep `buffers` for the graph being captured on the current stream."""
    if torch.cuda.is_current_stream_capturing():
        with _buffers_lock:
            _captured.extend(buffers)


def take_captured_buffers() -> List[torch.Tensor]:
    """The buffers held since the last call (see ``_captured``)."""
    with _buffers_lock:
        out = list(_captured)
        _captured.clear()
    return out


def _gemm_args(device: torch.device, M: int, N: int, K: int, kernel: str):
    """(stream, S, workspace pointer, counters pointer) for one launch of
    ``kernel`` on the device's current stream.  The workspace and counters
    are the stream's; a zeroed counter buffer (and a workspace) replaces
    one that is too small.  Call under :func:`_on_device`."""
    idx = device.index
    stream = _current_stream(idx)
    plan = gemm_plan(M, N, K, _sm_count(idx), kernel)
    n_ws = plan.workspace_bytes // 4
    tiles = plan.grid[0] * plan.grid[2]
    with _buffers_lock:
        ws, ctr = _buffers.get((idx, stream), (None, None))
        if ctr is None or ctr.numel() < tiles:
            ctr = torch.zeros(tiles, dtype=torch.int32, device=device)
        if plan.workspace_bytes > MAX_CACHED_WORKSPACE:
            ws_now = torch.empty(n_ws, dtype=torch.float32, device=device)
        else:
            if ws is None or ws.numel() < n_ws:
                ws = torch.empty(n_ws, dtype=torch.float32, device=device)
            ws_now = ws
        _buffers[(idx, stream)] = (ws, ctr)
    hold_if_capturing(ws_now, ctr)
    return stream, plan.splits, ws_now.data_ptr(), ctr.data_ptr()


def fused_dense_reference(x: torch.Tensor, w: torch.Tensor,
                          bias: Optional[torch.Tensor] = None,
                          activation: Optional[str] = None) -> torch.Tensor:
    """f32 product, then bias, then the epilogue activation, all in f32
    (f64 inputs stay f64); output in x's dtype."""
    acc = torch.promote_types(x.dtype, torch.float32)
    y = torch.matmul(x.to(acc), w.to(acc))
    if bias is not None:
        y = y + bias.to(acc)
    if activation is not None:
        y = EPILOGUE_ACTIVATIONS[activation](y)
    return y.to(x.dtype)


def dense_supports(x, w, bias=None, activation=None, **kw) -> bool:
    return (
        isinstance(x, torch.Tensor) and isinstance(w, torch.Tensor)
        and x.ndim >= 2 and w.ndim == 2
        and x.dtype in _FLOAT_DTYPES and w.dtype == x.dtype
        and (bias is None or bias.dtype in _FLOAT_DTYPES)
        and (activation is None or activation in EPILOGUE_ACTIVATIONS)
    )


def fused_dense(x: torch.Tensor, w: torch.Tensor,
                bias: Optional[torch.Tensor] = None,
                activation: Optional[str] = None) -> torch.Tensor:
    """Dense forward with bias + activation fused into the matmul epilogue:
    the kernel for CUDA tensors, the plain version for CPU tensors or in
    ``reference`` mode.  Differentiable either way: the kernel's backward
    is the VJP of the plain version (:class:`FusedDense`)."""
    if dispatch.resolve("fused_dense", x, w, bias=bias,
                        activation=activation) == "reference":
        return fused_dense_reference(x, w, bias, activation)
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (x, w, bias)):
        return FusedDense.apply(x, w, bias, activation)
    return _launch(x, w, bias, activation)


class FusedDense(torch.autograd.Function):
    """The kernel's forward; its backward recomputes the plain version and
    takes that VJP, as the JAX package's ``_fused_dense_bwd`` does (no
    epilogue residuals are kept)."""

    @staticmethod
    def forward(ctx, x, w, bias, activation):
        ctx.save_for_backward(x, w, bias)
        ctx.activation = activation
        return _launch(x, w, bias, activation)

    @staticmethod
    def backward(ctx, g):
        x, w, bias = ctx.saved_tensors
        needs = ctx.needs_input_grad[:3]
        with torch.enable_grad():
            ins = [None if t is None else t.detach().requires_grad_(n)
                   for t, n in zip((x, w, bias), needs)]
            y = fused_dense_reference(ins[0], ins[1], ins[2], ctx.activation)
            wanted = [t for t, n in zip(ins, needs) if n]
            grads = iter(torch.autograd.grad(y, wanted, g) if wanted else ())
        return (*(next(grads) if n else None for n in needs), None)


def _check_tile(lib, name: str = "fused_dense") -> None:
    """Once per process and kernel: the library's compiled tile is the one
    ``DEFAULT_TILES`` records for it."""
    if name in _tiles_checked:
        return
    import ctypes
    bm, bn, bk = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    getattr(lib, f"dl4j_{name}_tile")(ctypes.byref(bm), ctypes.byref(bn),
                                      ctypes.byref(bk))
    want = DEFAULT_TILES[name]
    if (bm.value, bn.value, bk.value) != (want.block_m, want.block_n,
                                          want.block_k):
        raise RuntimeError(
            f"{name}: the library is compiled for tile m,n,k="
            f"{(bm.value, bn.value, bk.value)}, DEFAULT_TILES says "
            f"{want.config_key()}")
    _tiles_checked.add(name)


def _launch(x, w, bias, activation) -> torch.Tensor:
    from deeplearning4j_tpu_torch.ops.kernels import build

    K = x.shape[-1]
    N = w.shape[1]
    lead = tuple(x.shape[:-1])
    x2 = x if x.dim() == 2 else x.reshape(-1, K)
    M = x2.shape[0]
    if w.shape[0] != K:
        raise ValueError(f"fused_dense: x is [.., {K}] but W is {tuple(w.shape)}")
    if not (x2.is_contiguous() and w.is_contiguous()):
        raise ValueError("fused_dense: the kernel takes contiguous x and W")
    if max(M, N, K) > _INT_MAX:
        raise ValueError(f"fused_dense: M={M} N={N} K={K} exceed 32 bits")
    if bias is not None:
        if tuple(bias.shape) != (N,):
            raise ValueError(
                f"fused_dense: bias is {tuple(bias.shape)}, want ({N},)")
        bias = _f32_row(bias, N)
    y = torch.empty((M, N), dtype=x.dtype, device=x.device)
    if M == 0 or N == 0:
        return y.reshape(lead + (N,))
    lib = build.library()
    _check_tile(lib)
    with _on_device(x.device):
        stream, S, ws, ctr = _gemm_args(x.device, M, N, K, "fused_dense")
        rc = lib.dl4j_fused_dense(
            x2.data_ptr(), w.data_ptr(),
            None if bias is None else bias.data_ptr(), y.data_ptr(), ws, ctr,
            M, N, K, S, _DTYPE_CODES[x.dtype], _ACT_CODES[activation], stream)
    if rc != 0:
        raise RuntimeError(
            f"fused_dense launch failed: {build.error_string(rc)} (code {rc})")
    LAUNCHES.inc()
    return y if x.dim() == 2 else y.reshape(lead + (N,))


# ---------------------------------------------------------------------------
# quantized products: weight-only int8 (q_matmul), int8 x int8 (int8_matmul)
# ---------------------------------------------------------------------------

def _combined_scale(w_scale, x_scale, N: int) -> torch.Tensor:
    """Per-channel weight scales (and an optional scalar activation scale)
    as the one [N] f32 row the epilogue multiplies by: ``f32(x_scale) *
    f32(w_scale)``, rounded once, as the JAX package's ``_combined_scale``.
    The plain version's; ``csrc/int8_matmul.cu`` rounds the same product in
    its epilogue."""
    scale = w_scale.to(torch.float32).reshape(N)
    if x_scale is not None:
        xs = torch.as_tensor(x_scale, dtype=torch.float32, device=scale.device)
        scale = xs * scale
    return scale


def dequant_epilogue(y, scale, bias=None, out_dtype=None) -> torch.Tensor:
    """Shared int8 -> float epilogue: widen the int32 accumulator to f32,
    multiply by the (already combined) per-channel scale row, add the
    optional bias, all in f32, then cast.  ``csrc/int8_matmul.cu`` applies
    the same two roundings in the same order."""
    y = y.to(torch.float32) * scale.to(torch.float32)
    if bias is not None:
        y = y + bias.to(torch.float32)
    if out_dtype is not None:
        y = y.to(out_dtype)
    return y


def _is_scalar(v) -> bool:
    if isinstance(v, torch.Tensor):
        return v.ndim == 0
    return isinstance(v, (int, float))


def q_matmul_plain(x, wq, w_scale, bias=None, acc_dtype=None) -> torch.Tensor:
    """The plain version (``q_matmul_reference``): the product in the
    accumulating dtype (default x's), times the scale, plus the bias, each
    step rounded to that dtype."""
    acc = x.dtype if acc_dtype is None else acc_dtype
    y = torch.matmul(x.to(acc), wq.to(acc))
    y = y * w_scale.to(acc).reshape((1,) * (y.ndim - 1) + (-1,))
    if bias is not None:
        y = y + bias.to(y.dtype)
    return y


def q_supports(x, wq, w_scale, bias=None, acc_dtype=None, **kw) -> bool:
    """x [.., K] f32 or bf16, int8 W [K, N], N scales, a float bias [N] or
    none; the accumulating dtype f32 or bf16."""
    if not (isinstance(x, torch.Tensor) and isinstance(wq, torch.Tensor)
            and isinstance(w_scale, torch.Tensor)):
        return False
    acc = x.dtype if acc_dtype is None else acc_dtype
    return (x.ndim >= 2 and wq.ndim == 2 and x.dtype in _FLOAT_DTYPES
            and wq.dtype == torch.int8 and acc in _FLOAT_DTYPES
            and x.shape[-1] == wq.shape[0]
            and w_scale.is_floating_point() and w_scale.numel() == wq.shape[1]
            and (bias is None or (bias.dtype in _FLOAT_DTYPES
                                  and tuple(bias.shape) == (wq.shape[1],))))


def q_matmul(x, wq, w_scale, bias=None, acc_dtype=None) -> torch.Tensor:
    """Launch the weight-only kernel (``csrc/q_matmul.cu``) on CUDA
    tensors: x is cast to the accumulating dtype (the TPU kernel's compute
    dtype), W widens on chip, the product accumulates in f32, and
    ``* scale + bias`` run in f32 before one cast to the accumulating
    dtype."""
    from deeplearning4j_tpu_torch.ops.kernels import build

    if not q_supports(x, wq, w_scale, bias, acc_dtype):
        raise ValueError("q_matmul: the kernel does not take these inputs")
    acc = x.dtype if acc_dtype is None else acc_dtype
    K, N = wq.shape
    lead = tuple(x.shape[:-1])
    x2 = (x if x.dtype == acc and x.dim() == 2 and x.is_contiguous()
          else x.to(acc).reshape(-1, K).contiguous())
    M = x2.shape[0]
    if max(M, N, K) > _INT_MAX:
        raise ValueError(f"q_matmul: M={M} N={N} K={K} exceed 32 bits")
    scale = _f32_row(w_scale, N)
    bias = None if bias is None else _f32_row(bias, N)
    if not wq.is_contiguous():
        wq = wq.contiguous()
    y = torch.empty((M, N), dtype=acc, device=x.device)
    if M == 0 or N == 0:
        return y.reshape(lead + (N,))
    lib = build.library()
    _check_tile(lib, "q_matmul")
    with _on_device(x.device):
        stream, S, ws, ctr = _gemm_args(x.device, M, N, K, "q_matmul")
        rc = lib.dl4j_q_matmul(
            x2.data_ptr(), wq.data_ptr(), scale.data_ptr(),
            None if bias is None else bias.data_ptr(), y.data_ptr(), ws, ctr,
            M, N, K, S, _DTYPE_CODES[acc], stream)
    if rc != 0:
        raise RuntimeError(
            f"q_matmul launch failed: {build.error_string(rc)} (code {rc})")
    Q_LAUNCHES.inc()
    return y if x.dim() == 2 else y.reshape(lead + (N,))


def int8_matmul_plain(xq, wq, w_scale, x_scale=None, bias=None,
                      out_dtype=torch.float32) -> torch.Tensor:
    """The plain version (``int8_matmul_reference``): the int32 product,
    then ``dequant_epilogue``.  The product is taken in float64, which is
    exact here (every partial sum is an integer below 2**53, K <=
    ``INT8_MAX_K``), because CUDA has no int32 matmul in PyTorch."""
    y = torch.matmul(xq.to(torch.float64), wq.to(torch.float64)).to(torch.int32)
    return dequant_epilogue(y, _combined_scale(w_scale, x_scale, wq.shape[1]),
                            bias=bias, out_dtype=out_dtype)


def int8_supports(xq, wq, w_scale, x_scale=None, bias=None,
                  out_dtype=torch.float32, **kw) -> bool:
    """int8 x [.., K] and W [K, N] with K <= ``INT8_MAX_K``, N scales, a
    scalar x_scale or none, a float bias [N] or none, f32 or bf16 out."""
    if not (isinstance(xq, torch.Tensor) and isinstance(wq, torch.Tensor)
            and isinstance(w_scale, torch.Tensor)):
        return False
    return (xq.ndim >= 2 and wq.ndim == 2 and xq.dtype == torch.int8
            and wq.dtype == torch.int8 and xq.shape[-1] == wq.shape[0]
            and wq.shape[0] <= INT8_MAX_K
            and w_scale.is_floating_point() and w_scale.numel() == wq.shape[1]
            and (x_scale is None or _is_scalar(x_scale))
            and out_dtype in _FLOAT_DTYPES
            and (bias is None or (bias.dtype in _FLOAT_DTYPES
                                  and tuple(bias.shape) == (wq.shape[1],))))


def int8_matmul(xq, wq, w_scale, x_scale=None, bias=None,
                out_dtype=torch.float32) -> torch.Tensor:
    """Launch the int8 kernel (``csrc/int8_matmul.cu``) on CUDA tensors:
    int32 accumulation (split-K partials summed in int32), then
    ``f32(acc) * (x_scale * w_scale) + bias`` in f32 with no fused
    multiply-add, then one cast; bitwise equal to
    :func:`int8_matmul_plain`.  x_scale goes to the kernel as an f32
    argument, whose epilogue rounds ``x_scale * w_scale`` as
    ``_combined_scale`` does."""
    from deeplearning4j_tpu_torch.ops.kernels import build

    if not int8_supports(xq, wq, w_scale, x_scale, bias, out_dtype):
        raise ValueError("int8_matmul: the kernel does not take these inputs")
    K, N = wq.shape
    lead = tuple(xq.shape[:-1])
    x2 = xq.reshape(-1, K).contiguous()
    M = x2.shape[0]
    if M > _INT_MAX or N > _INT_MAX:
        raise ValueError(f"int8_matmul: M={M} N={N} exceed 32 bits")
    w_scale = _f32_row(w_scale, N)
    xs = 1.0 if x_scale is None else float(x_scale)
    bias = None if bias is None else _f32_row(bias, N)
    wq = wq.contiguous()
    y = torch.empty((M, N), dtype=out_dtype, device=xq.device)
    if M == 0 or N == 0:
        return y.reshape(lead + (N,))
    lib = build.library()
    _check_tile(lib, "int8_matmul")
    with _on_device(xq.device):
        stream, S, ws, ctr = _gemm_args(xq.device, M, N, K, "int8_matmul")
        rc = lib.dl4j_int8_matmul(
            x2.data_ptr(), wq.data_ptr(), w_scale.data_ptr(),
            None if bias is None else bias.data_ptr(), y.data_ptr(), ws, ctr,
            M, N, K, S, xs, _DTYPE_CODES[out_dtype], stream)
    if rc != 0:
        raise RuntimeError(
            f"int8_matmul launch failed: {build.error_string(rc)} (code {rc})")
    INT8_LAUNCHES.inc()
    return y.reshape(lead + (N,))
