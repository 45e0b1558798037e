"""Paged-KV decode attention of the kernel tier (the port of
``ops/pallas/paged_attention.py``).

The decode loop is one query token per sequence attending over that
sequence's whole history.  The serving layer (``serving/decode.py``) keeps
KV in fixed-size pages shared by every sequence, and each sequence owns a
block table, the ordered page indices of its history.  Two
implementations of one function:

- :func:`paged_attention_plain`, the port of ``paged_attention_reference``
  and the spec: gather each sequence's pages per its block table, masked
  softmax over the rebuilt history, f32 math;
- the CUDA kernel in ``csrc/paged_attention.cu`` (see that file for its
  design and bound), launched by :func:`paged_attention` on CUDA tensors:
  each (sequence, head group)'s history is split over several blocks on
  page boundaries (:func:`paged_plan`), each block runs an online softmax
  over its pages, and the last block of a (sequence, head group) combines
  the splits in split order.

Int8 pages carry one f32 scale per (token, head) row, made by
``quantize_tensor(rows, axis=0)``; both implementations widen them with the
same ``f32(x) * f32(scale)`` (:func:`dequant_rows`).

Layout (shared with ``serving.decode.PagedKVCache``):

- ``q``            [B, H, D]         one decode token per sequence
- ``k_pages``      [P, page, H, D]   f32/bf16, or int8 with scales
- ``v_pages``      [P, page, H, D]
- ``k_scales``     [P, page, H]      f32 (int8 pages only)
- ``v_scales``     [P, page, H]
- ``block_tables`` [B, max_pages]    int32; slots past a sequence's last
                                     page hold 0 and are never read
- ``seq_lens``     [B]               int32, >= 1

:func:`paged_supports` keeps the JAX package's hard predicates plus the
kernel's limits (D <= 256, page <= 64, contiguous operands); the TPU's
``paged_profitable`` thresholds are not carried over.  ``LAUNCHES`` counts
kernel launches, and only those.
"""
from __future__ import annotations

import functools
import math
import threading
from typing import Dict, NamedTuple, Tuple

import torch

from deeplearning4j_tpu_torch.monitor.registry import registry
from deeplearning4j_tpu_torch.ops.kernels.matmul import _current_stream, _on_device, _sm_count

#: masked logits, not -inf, so fully masked tails stay NaN-free
NEG_INF = -1e30
_Q_CODES = {torch.float32: 0, torch.bfloat16: 1}
#: the kernel's limits (``dl4j_paged_attention_limits``)
MAX_D = 256
MAX_PAGE = 64
MAX_SPLITS = 128
#: blocks the split grid aims at per SM, and the most heads a block takes
#: side by side (chosen by ``paged_variants.py``'s timings on an H100)
BLOCKS_PER_SM = 4
HEADS_PER_BLOCK = 2
#: threads of a block and rows a row group takes from each ring stage
#: (``THREADS`` and ``ROWS_PER_GROUP`` in the source)
_THREADS = 128
_ROWS_PER_GROUP = 2

LAUNCHES = registry().counter(
    "ops_kernel_launches_total", help="hand-written kernel launches",
    labels={"kernel": "paged_attention"})

_limits_checked = False
_counters_lock = threading.Lock()
#: (device index, stream) -> int32 arrival counters, zero between launches
_counters: Dict[Tuple[int, int], torch.Tensor] = {}


class PagedPlan(NamedTuple):
    """A launch of the split kernel: blocks of ``heads`` heads side by
    side, ``splits`` blocks per (b, head group), split s taking the pages
    ``[s * pages_per_split, (s + 1) * pages_per_split)`` of the block
    table; ring stages of ``tile_rows`` rows (``tile_rows / heads``
    tokens); ``blocks`` = B * H / heads * splits."""
    splits: int
    pages_per_split: int
    heads: int
    tile_rows: int
    blocks: int


def tile_rows(D: int, kv_itemsize: int) -> int:
    """Rows of one ring stage (``geometry`` in the source): a row group
    has as many lanes as the row has 16-byte pieces (a power of two, at
    most 32), and takes ``_ROWS_PER_GROUP`` rows of a stage."""
    pieces = -(-D * kv_itemsize // 16)
    lanes = 1
    while lanes < pieces and lanes < 32:
        lanes *= 2
    return _ROWS_PER_GROUP * (_THREADS // lanes)


@functools.lru_cache(maxsize=1024)
def paged_plan(B: int, H: int, D: int, page: int, max_pages: int,
               kv_itemsize: int, sm_count: int) -> PagedPlan:
    """The grid of a launch, from the shapes alone (never from the
    lengths, so a decode step reads nothing back from the card): the most
    heads a block takes (a power of two dividing H, at most
    ``HEADS_PER_BLOCK`` and the block's row groups), then enough history
    splits that the grid has ``BLOCKS_PER_SM`` blocks per SM, each split at
    least one ring stage of tokens long and at most ``MAX_SPLITS``; splits
    fall on page boundaries, and the last one is not empty."""
    rows = tile_rows(D, kv_itemsize)
    heads = 1
    while (heads * 2 <= min(HEADS_PER_BLOCK, rows // _ROWS_PER_GROUP)
           and H % (heads * 2) == 0):
        heads *= 2
    groups = B * H // heads
    min_pages = max(1, rows // heads // page)
    most = max(1, min(MAX_SPLITS, max_pages // min_pages))
    want = -(-BLOCKS_PER_SM * sm_count // groups)
    splits = max(1, min(most, want))
    per = -(-max_pages // splits)
    splits = -(-max_pages // per)
    return PagedPlan(splits, per, heads, rows, groups * splits)


def dequant_rows(x, scales, dtype=torch.float32):
    """Widen KV rows: ``x`` [..., D] int8 (or float: then a plain cast),
    ``scales`` [...] broadcast over D, the inverse of
    ``quantize_tensor(rows, axis=0)``."""
    x = x.to(dtype)
    if scales is not None:
        x = x * scales.to(dtype)[..., None]
    return x


def _sm_scale(D, scale):
    return (1.0 / math.sqrt(D)) if scale is None else float(scale)


def paged_attention_plain(q, k_pages, v_pages, block_tables, seq_lens,
                          scale=None, k_scales=None, v_scales=None):
    """Gather each sequence's pages per its block table and run masked
    attention over the rebuilt history, in f32; output in q's dtype."""
    B, H, D = q.shape
    page = k_pages.shape[1]
    sm = _sm_scale(D, scale)
    k = dequant_rows(k_pages, k_scales)           # [P, page, H, D] f32
    v = dequant_rows(v_pages, v_scales)
    bt = block_tables.long()
    L = bt.shape[1] * page
    kg = k[bt].reshape(B, L, H, D).permute(0, 2, 1, 3)
    vg = v[bt].reshape(B, L, H, D).permute(0, 2, 1, 3)
    s = torch.einsum("bhd,bhld->bhl", q.to(torch.float32), kg) * sm
    pos = torch.arange(L, device=q.device)[None, None, :]
    valid = pos < seq_lens.to(torch.int64)[:, None, None]
    s = torch.where(valid, s, torch.full_like(s, NEG_INF))
    w = torch.softmax(s, dim=-1)
    out = torch.einsum("bhl,bhld->bhd", w, vg)
    return out.to(q.dtype)


def _int_vector(t, n) -> bool:
    return (isinstance(t, torch.Tensor) and t.ndim == 1 and t.shape[0] == n
            and not t.is_floating_point())


def paged_supports(q, k_pages, v_pages, block_tables, seq_lens, scale=None,
                   k_scales=None, v_scales=None, **kw) -> bool:
    """Hard constraints: q [B, H, D] f32 or bf16 with 1 <= D <= 256; pages
    [P, page, H, D] with page <= 64, in q's dtype or int8 with f32 scales
    [P, page, H]; block tables [B, max_pages] and lengths [B] of integers;
    contiguous operands."""
    ts = (q, k_pages, v_pages, block_tables, seq_lens)
    if not all(isinstance(t, torch.Tensor) for t in ts):
        return False
    if q.ndim != 3 or k_pages.ndim != 4 or q.dtype not in _Q_CODES:
        return False
    if k_pages.shape != v_pages.shape or k_pages.dtype != v_pages.dtype:
        return False
    B, H, D = q.shape
    if (k_pages.shape[2] != H or k_pages.shape[3] != D or not 1 <= D <= MAX_D
            or not 1 <= k_pages.shape[1] <= MAX_PAGE):
        return False
    if k_pages.dtype == torch.int8:
        if not all(isinstance(s, torch.Tensor) and s.dtype == torch.float32
                   and s.shape == k_pages.shape[:3] and s.is_contiguous()
                   for s in (k_scales, v_scales)):
            return False
    elif k_pages.dtype != q.dtype:
        return False
    if (block_tables.ndim != 2 or block_tables.shape[0] != B
            or block_tables.shape[1] < 1 or block_tables.is_floating_point()):
        return False
    return _int_vector(seq_lens, B) and all(t.is_contiguous() for t in ts[:3])


def _check_limits(lib) -> None:
    """Once per process: the library's limits are the ones this module
    states."""
    global _limits_checked
    if _limits_checked:
        return
    import ctypes
    got = [ctypes.c_int() for _ in range(3)]
    lib.dl4j_paged_attention_limits(*map(ctypes.byref, got))
    got = tuple(v.value for v in got)
    if got != (MAX_D, MAX_PAGE, MAX_SPLITS):
        raise RuntimeError(
            f"paged_attention: the library's (D, page, splits) limits are "
            f"{got}; this module says {(MAX_D, MAX_PAGE, MAX_SPLITS)}")
    _limits_checked = True


def _stream_counters(device: torch.device, stream: int, n: int) -> torch.Tensor:
    """The stream's arrival counters, at least ``n``; a zeroed buffer
    replaces one that is too small (launches on one stream run in order,
    and the kernel leaves the counters zero)."""
    with _counters_lock:
        ctr = _counters.get((device.index, stream))
        if ctr is None or ctr.numel() < n:
            ctr = torch.zeros(n, dtype=torch.int32, device=device)
            _counters[(device.index, stream)] = ctr
        return ctr


def paged_attention(q, k_pages, v_pages, block_tables, seq_lens, scale=None,
                    k_scales=None, v_scales=None) -> torch.Tensor:
    """Launch the kernel on CUDA tensors: [B, H, D] out in q's dtype.
    Raises for inputs the kernel does not take (``paged_supports``) and if
    the launch fails.  The caller (``serving/decode.py``) asks
    ``dispatch.resolve`` first; CPU tensors take
    :func:`paged_attention_plain`."""
    from deeplearning4j_tpu_torch.ops.kernels import build

    if not paged_supports(q, k_pages, v_pages, block_tables, seq_lens,
                          k_scales=k_scales, v_scales=v_scales):
        raise ValueError("paged_attention: the kernel does not take these inputs")
    B, H, D = q.shape
    page = k_pages.shape[1]
    max_pages = block_tables.shape[1]
    quantized = k_pages.dtype == torch.int8
    dev = q.device
    bt = block_tables.to(torch.int32).contiguous()
    sl = seq_lens.to(torch.int32).contiguous()
    qc = q.contiguous()
    out = torch.empty((B, H, D), dtype=q.dtype, device=dev)
    lib = build.library()
    _check_limits(lib)
    with _on_device(dev):
        stream = _current_stream(dev.index)
        plan = paged_plan(B, H, D, page, max_pages, k_pages.element_size(),
                          _sm_count(dev.index))
        ws = ctr = None
        if plan.splits > 1:
            ws = torch.empty(B * H * plan.splits * (D + 2), dtype=torch.float32, device=dev)
            ctr = _stream_counters(dev, stream, B * H)
        rc = lib.dl4j_paged_attention(
            qc.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            k_scales.data_ptr() if quantized else None,
            v_scales.data_ptr() if quantized else None,
            bt.data_ptr(), sl.data_ptr(), out.data_ptr(),
            None if ws is None else ws.data_ptr(),
            None if ctr is None else ctr.data_ptr(), B, H, D, page, max_pages,
            plan.splits, plan.pages_per_split, plan.heads, _sm_scale(D, scale),
            _Q_CODES[q.dtype], int(quantized), stream)
    if rc != 0:
        raise RuntimeError(
            f"paged_attention launch failed: {build.error_string(rc)} (code {rc})")
    LAUNCHES.inc()
    return out
