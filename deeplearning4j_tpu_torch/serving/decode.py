"""Autoregressive decode engine: prefill/decode split over a paged KV cache
with token-level continuous batching (the port of ``serving/decode.py``).

**Prefill through the bucket ladder.**  A prompt of length T is padded to
the power-of-two bucket ``bucket_for(T)`` and run through the model's
prefill at that shape, so a length-skewed flood meets only
``log2(max_prompt)`` prefill shapes, all run once by ``warmup()``.

**Token-level continuous batching.**  After prefill a sequence enters the
decode loop: every step advances all active sequences by one token (QKV
projection, KV append, one paged-attention launch over the whole batch,
output head), and between steps sequences are admitted from the waiting
queue and retired the moment they finish, releasing their slot and KV
pages at once.  The decode batch is padded to a power-of-two row bucket,
so admits and retires never change a shape.

**Paged KV.**  KV lives in fixed-size pages shared by every sequence
(:class:`PagedKVCache`): a free-list allocator hands out pages, each
sequence owns a block table, and exhaustion sheds (``KVCacheExhausted`` is
a ``RejectedError``) instead of crashing.  ``kv_dtype="int8"`` stores pages
as int8 with one f32 scale per (token, head) row, the bytes of the JAX
package's per-token ``quantize_tensor(rows, axis=0)``.

What differs from the JAX package: the page pools are device tensors,
written in place (the JAX cache keeps host numpy pools and hands them to
the jitted step on every call), and a step's appended rows are quantized
and stored for the whole batch at once; there is no jit, so
``fresh_compiles()`` is the shape-key accounting (the first run of a
prefill or decode shape is a miss), which is zero after ``warmup()`` for
any admissible flood; the KV dtype is not folded into a kernel-tier
fingerprint (the port has none yet).  Prefill runs the plain attention
(``mha_reference``), as in the JAX package.  Fleet integration
(``serving/fleet.py``) is not ported yet; :class:`DecodeServerAdapter` is
the ModelServer-shaped surface it will use.
"""
from __future__ import annotations

import dataclasses
import itertools
import math
import threading
import time
from concurrent.futures import Future
from typing import Any, Dict, List, Optional, Sequence, Set, Tuple

import numpy as np
import torch
from torch import nn

from deeplearning4j_tpu_torch.monitor.instrument import (DecodeInstruments,
                                                         decode_instruments)
from deeplearning4j_tpu_torch.monitor.registry import MetricsRegistry
from deeplearning4j_tpu_torch.ops.kernels import dispatch
from deeplearning4j_tpu_torch.ops.kernels import paged_attention as pa
from deeplearning4j_tpu_torch.ops.kernels.tiles import DEFAULT_TILES
from deeplearning4j_tpu_torch.ops.quant_kernels import INT8_MAX
from deeplearning4j_tpu_torch.serving.batcher import (DeadlineExceededError,
                                                      RejectedError)
from deeplearning4j_tpu_torch.serving.compile_cache import bucket_for, bucket_sizes
from deeplearning4j_tpu_torch.serving.metrics import ServingMetrics
from deeplearning4j_tpu_torch.serving.resilience import FatalReplicaError
from deeplearning4j_tpu_torch.utils.counters import HitMissCounters
from deeplearning4j_tpu_torch.utils.devices import resolve_device


class KVCacheExhausted(RejectedError):
    """The paged KV pool has no free page.  A `RejectedError`: the caller
    sheds the sequence, never a crash or a silent truncation."""


# ---------------------------------------------------------------------------
# Free-list page allocator
# ---------------------------------------------------------------------------


class KVBlockAllocator:
    """Fixed pool of KV pages handed out through a free list.  O(1)
    alloc/free; pages are position-independent, so any free page serves any
    sequence.  `alloc` is all-or-nothing."""

    def __init__(self, num_blocks: int):
        if num_blocks < 1:
            raise ValueError("need at least one KV block")
        self.num_blocks = int(num_blocks)
        self._free: List[int] = list(range(self.num_blocks - 1, -1, -1))
        self._allocated: Set[int] = set()
        self.high_water = 0
        self._lock = threading.Lock()

    def alloc(self, n: int = 1) -> List[int]:
        with self._lock:
            if n > len(self._free):
                raise KVCacheExhausted(
                    f"KV pool exhausted: need {n} pages, "
                    f"{len(self._free)}/{self.num_blocks} free — shed")
            blocks = [self._free.pop() for _ in range(n)]
            self._allocated.update(blocks)
            self.high_water = max(self.high_water, len(self._allocated))
            return blocks

    def free(self, blocks: Sequence[int]) -> None:
        with self._lock:
            for b in blocks:
                if b not in self._allocated:
                    raise ValueError(f"double free of KV block {b}")
                self._allocated.remove(b)
                self._free.append(b)

    @property
    def in_use(self) -> int:
        with self._lock:
            return len(self._allocated)

    @property
    def free_count(self) -> int:
        with self._lock:
            return len(self._free)


# ---------------------------------------------------------------------------
# Paged KV cache
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class _SeqPages:
    blocks: List[int]
    length: int = 0


def quantize_rows(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """int8 rows and f32 scales of ``x`` [..., D]: one scale per row over D,
    the numbers ``quantize_tensor(x_t, axis=0)`` gives for each [H, D]
    token (``amax / 127``, round half to even, clip, scale 1 for a zero
    row), vectorised over tokens; every division is tensor by tensor."""
    x = x.to(torch.float32)
    amax = x.abs().amax(dim=-1, keepdim=True)
    scale = amax / torch.full_like(amax, INT8_MAX)
    scale = torch.where(scale == 0.0, torch.ones_like(scale), scale)
    q = torch.clamp(torch.round(x / scale), -INT8_MAX, INT8_MAX).to(torch.int8)
    return q, scale[..., 0]


class PagedKVCache:
    """KV storage as ``[num_blocks, page_size, H, D]`` page pools on a
    device plus per-sequence block tables (the layout of
    ``ops/kernels/paged_attention.py``).

    ``dtype="f32"`` stores float32 pages; ``dtype="int8"`` stores int8 pages
    with per-(token, head) f32 scales.  Writes are in-place appends to the
    device pools; block-table slots past a sequence's last page hold 0."""

    def __init__(self, num_blocks: int, page_size: int, n_heads: int,
                 head_dim: int, dtype: str = "f32", device=None):
        if dtype not in ("f32", "int8"):
            raise ValueError(f"kv dtype {dtype!r}: want 'f32' or 'int8'")
        self.device = resolve_device(device)
        self.page_size = int(page_size)
        self.n_heads = int(n_heads)
        self.head_dim = int(head_dim)
        self.dtype = dtype
        self.allocator = KVBlockAllocator(num_blocks)
        shape = (int(num_blocks), self.page_size, self.n_heads, self.head_dim)
        store = torch.int8 if dtype == "int8" else torch.float32
        self.k_pages = torch.zeros(shape, dtype=store, device=self.device)
        self.v_pages = torch.zeros(shape, dtype=store, device=self.device)
        if dtype == "int8":
            self.k_scales = torch.ones(shape[:3], dtype=torch.float32, device=self.device)
            self.v_scales = torch.ones(shape[:3], dtype=torch.float32, device=self.device)
        else:
            self.k_scales = self.v_scales = None
        self._seqs: Dict[int, _SeqPages] = {}
        self._lock = threading.Lock()

    # ---- sequence lifecycle ----
    def allocate(self, seq_id: int) -> None:
        with self._lock:
            if seq_id in self._seqs:
                raise ValueError(f"sequence {seq_id} already allocated")
            self._seqs[seq_id] = _SeqPages(blocks=[])

    def reserve(self, seq_id: int, T: int) -> List[int]:
        """Grow a sequence by T tokens and return their flat slots
        (``block * page_size + slot``) in the pools.  Every page the tokens
        need is allocated up front, so ``KVCacheExhausted`` leaves the
        sequence exactly as it was."""
        with self._lock:
            seq = self._seqs[seq_id]
            have = len(seq.blocks) * self.page_size - seq.length
            need_pages = max(0, -(-(T - have) // self.page_size))
            if need_pages:
                seq.blocks.extend(self.allocator.alloc(need_pages))
            pos = range(seq.length, seq.length + T)
            seq.length += T
            return [seq.blocks[p // self.page_size] * self.page_size
                    + p % self.page_size for p in pos]

    def store(self, slots: Sequence[int], k, v) -> None:
        """Write rows ``k``/``v`` [n, H, D] into the flat ``slots`` that
        :meth:`reserve` returned (int8 pages: quantized on the device)."""
        idx = torch.as_tensor(list(slots), dtype=torch.int64, device=self.device)
        k = torch.as_tensor(k, device=self.device)
        v = torch.as_tensor(v, device=self.device)
        shape = (-1, self.n_heads, self.head_dim)
        if self.dtype == "int8":
            for rows, pool, scales in ((k, self.k_pages, self.k_scales),
                                       (v, self.v_pages, self.v_scales)):
                q, s = quantize_rows(rows)
                pool.view(shape).index_copy_(0, idx, q)
                scales.view(-1, self.n_heads).index_copy_(0, idx, s)
        else:
            self.k_pages.view(shape).index_copy_(0, idx, k.to(torch.float32))
            self.v_pages.view(shape).index_copy_(0, idx, v.to(torch.float32))

    def write(self, seq_id: int, k, v) -> None:
        """Append T tokens of KV (``k``/``v`` [T, H, D] f32, numpy or a
        tensor), growing the sequence's block table page by page;
        ``KVCacheExhausted`` leaves the sequence as it was."""
        k = torch.as_tensor(k, device=self.device)
        self.store(self.reserve(seq_id, int(k.shape[0])), k, v)

    def free_seq(self, seq_id: int) -> None:
        with self._lock:
            seq = self._seqs.pop(seq_id, None)
        if seq is not None and seq.blocks:
            self.allocator.free(seq.blocks)

    def seq_len(self, seq_id: int) -> int:
        with self._lock:
            return self._seqs[seq_id].length

    # ---- attention inputs ----
    def block_tables(self, seq_ids: Sequence[int], rows: int,
                     max_pages: int) -> Tuple[np.ndarray, np.ndarray]:
        """[rows, max_pages] int32 block tables + [rows] int32 lengths for
        `seq_ids` (host numpy), padded: unused slots and padding rows hold
        block 0 / length 1 (masked garbage the caller discards)."""
        bt = np.zeros((rows, max_pages), np.int32)
        sl = np.ones(rows, np.int32)
        with self._lock:
            for i, sid in enumerate(seq_ids):
                seq = self._seqs[sid]
                bt[i, :len(seq.blocks)] = seq.blocks
                sl[i] = max(seq.length, 1)
        return bt, sl

    def pages(self) -> Tuple[torch.Tensor, ...]:
        """The attention operands: (k_pages, v_pages) for f32 pages, plus
        (k_scales, v_scales) for int8 pages."""
        if self.dtype == "int8":
            return (self.k_pages, self.v_pages, self.k_scales, self.v_scales)
        return (self.k_pages, self.v_pages)

    # ---- accounting ----
    @property
    def blocks_in_use(self) -> int:
        return self.allocator.in_use

    @property
    def bytes_per_block(self) -> int:
        kv = 2 * self.page_size * self.n_heads * self.head_dim
        if self.dtype == "int8":
            return kv + 2 * self.page_size * self.n_heads * 4  # f32 scales
        return kv * 4

    @property
    def bytes_in_use(self) -> int:
        return self.blocks_in_use * self.bytes_per_block

    @property
    def active_sequences(self) -> int:
        with self._lock:
            return len(self._seqs)


# ---------------------------------------------------------------------------
# A minimal decode model (tests / chip_smoke / examples)
# ---------------------------------------------------------------------------


class TinyDecodeModel(nn.Module):
    """Smallest model of the decode contract: `prefill(tokens, lens)`,
    `decode_qkv(tokens)`, `decode_out(attn)`: an embedding, one causal
    attention block's QKV/out projections and a logits head.  Its weights
    are the JAX package's numbers: drawn from ``np.random.default_rng(seed)``
    in the same order, as f32, on ``device`` (``"cuda"`` by default)."""

    NAMES = ("embed", "wq", "wk", "wv", "wo", "head")

    def __init__(self, vocab: int = 128, d_model: int = 64,
                 n_heads: int = 4, seed: int = 0, device=None):
        super().__init__()
        if d_model % n_heads:
            raise ValueError("d_model must divide into heads")
        self.device = resolve_device(device)
        self.vocab = int(vocab)
        self.d_model = int(d_model)
        self.n_heads = int(n_heads)
        self.head_dim = d_model // n_heads
        rng = np.random.default_rng(seed)
        s = 1.0 / math.sqrt(d_model)
        shapes = {"embed": ((vocab, d_model), 0.3), "wq": ((d_model, d_model), s),
                  "wk": ((d_model, d_model), s), "wv": ((d_model, d_model), s),
                  "wo": ((d_model, d_model), s), "head": ((d_model, vocab), s)}
        for name in self.NAMES:
            shape, scale = shapes[name]
            w = (rng.standard_normal(shape) * scale).astype(np.float32)
            self.register_parameter(name, nn.Parameter(
                torch.from_numpy(w).to(self.device), requires_grad=False))

    @property
    def params_(self) -> Dict[str, torch.Tensor]:
        return {n: getattr(self, n) for n in self.NAMES}

    def _proj(self, x, name):
        y = x @ getattr(self, name)
        return y.reshape(x.shape[:-1] + (self.n_heads, self.head_dim))

    def prefill(self, tokens, lens):
        """[B, T] integer prompts (zero-padded past `lens`) -> (last-token
        logits [B, V], k [B, T, H, D], v [B, T, H, D])."""
        from deeplearning4j_tpu_torch.ops import attention_kernels as ak

        B, T = tokens.shape
        x = self.embed[tokens.long()]                 # [B, T, dm]
        q, k, v = (self._proj(x, n) for n in ("wq", "wk", "wv"))
        qh, kh, vh = (a.permute(0, 2, 1, 3) for a in (q, k, v))
        keep = (torch.arange(T, device=tokens.device)[None, :]
                < lens[:, None]).to(torch.float32)  # [B, T]
        o = ak.mha_reference(qh, kh, vh, mask=keep, causal=True)
        h = o.permute(0, 2, 1, 3).reshape(B, T, self.d_model) @ self.wo
        last = h[torch.arange(B, device=tokens.device), lens.long() - 1] @ self.head
        return last, k, v

    def decode_qkv(self, tokens):
        """[B] integer tokens -> (q, k, v) each [B, H, D] for one step."""
        x = self.embed[tokens.long()]                 # [B, dm]
        return (self._proj(x, "wq"), self._proj(x, "wk"), self._proj(x, "wv"))

    def decode_out(self, attn):
        """[B, H, D] paged-attention output -> logits [B, V]."""
        h = attn.reshape(attn.shape[0], self.d_model) @ self.wo
        return h @ self.head


# ---------------------------------------------------------------------------
# Decode sequences
# ---------------------------------------------------------------------------


@dataclasses.dataclass(eq=False)           # identity eq, like _Request
class DecodeSequence:
    seq_id: int
    prompt: np.ndarray                     # [T] int32
    max_new_tokens: int
    future: Future
    priority: int = 0
    eos_token: Optional[int] = None
    enqueued: float = 0.0                  # time.monotonic()
    deadline: Optional[float] = None       # absolute monotonic, or None
    generated: List[int] = dataclasses.field(default_factory=list)
    t_last: float = 0.0                    # last token emit (monotonic)
    restarts: int = 0                      # failover restarts (fleet)


def paged_attn(q, k_pages, v_pages, block_tables, seq_lens,
               k_scales=None, v_scales=None):
    """Dispatched paged attention: the kernel for CUDA tensors, the plain
    version for CPU tensors or in ``reference`` mode."""
    if dispatch.resolve("paged_attention", q, k_pages, v_pages, block_tables,
                        seq_lens, k_scales=k_scales,
                        v_scales=v_scales) == "kernel":
        return pa.paged_attention(q, k_pages, v_pages, block_tables, seq_lens,
                                  k_scales=k_scales, v_scales=v_scales)
    return pa.paged_attention_plain(q, k_pages, v_pages, block_tables,
                                    seq_lens, k_scales=k_scales,
                                    v_scales=v_scales)


# ---------------------------------------------------------------------------
# The engine
# ---------------------------------------------------------------------------


class DecodeEngine:
    """Token-level continuous batching over a paged KV cache on the model's
    device.

    `submit()` enqueues a prompt and returns a Future resolving to the
    generated token ids; one worker thread runs the admit -> step -> retire
    loop.  Shapes are bucketed (prompt-length pow2 buckets for prefill,
    batch-row pow2 buckets for decode, a fixed pool), so after `warmup()` a
    shape-skewed flood meets no new shape (`fresh_compiles()`).
    `decode_steps` counts the decode steps run after construction (each one
    paged-attention call over the batch); warmup's runs do not count."""

    _ids = itertools.count()

    def __init__(self, model, *, num_blocks: int = 128,
                 page_size: Optional[int] = None, max_seq_len: int = 256,
                 max_decode_batch: int = 8, kv_dtype: str = "f32",
                 max_waiting: int = 64, max_new_tokens_default: int = 32,
                 prompt_min_bucket: int = 8,
                 model_label: str = "decode",
                 server_label: Optional[str] = None,
                 registry_: Optional[MetricsRegistry] = None):
        self.model = model
        self.device = model.device
        self.page_size = int(page_size) if page_size else \
            max(int(DEFAULT_TILES["paged_attention"].block_kv), 1)
        self.max_seq_len = int(max_seq_len)
        self.max_pages = -(-self.max_seq_len // self.page_size)
        self.max_decode_batch = int(max_decode_batch)
        self.max_waiting = int(max_waiting)
        self.max_new_tokens_default = int(max_new_tokens_default)
        self.kv_dtype = kv_dtype
        self.model_label = model_label
        self.cache = PagedKVCache(num_blocks, self.page_size, model.n_heads,
                                  model.head_dim, dtype=kv_dtype,
                                  device=self.device)
        self.metrics = ServingMetrics(
            server_label=server_label if server_label is not None
            else f"decode{next(DecodeEngine._ids)}",
            model_label=model_label, registry_=registry_)
        self.instruments = decode_instruments() if registry_ is None \
            else DecodeInstruments(registry_)
        self.compile_counters = HitMissCounters("decode_compile")
        self._shapes: Set[Tuple] = set()
        # pow2 ladders: prompt buckets over the time axis, decode buckets
        # over batch rows (serving/compile_cache.py's ladder)
        max_prompt = max(self.max_seq_len - 1, 1)
        self.prompt_buckets = bucket_sizes(
            max_prompt, min_bucket=min(prompt_min_bucket, max_prompt))
        self.batch_buckets = bucket_sizes(self.max_decode_batch)
        self._waiting: List[DecodeSequence] = []
        self._active: List[DecodeSequence] = []
        self._cond = threading.Condition()
        self._stop = False
        self._draining = False
        self._poisoned: Optional[BaseException] = None
        self._step_since: Optional[float] = None
        self._seq_ids = itertools.count()
        self.tokens_emitted = 0
        self.decode_steps = 0
        self._worker = threading.Thread(target=self._loop, daemon=True,
                                        name="decode-engine")
        self._worker.start()

    # ---- step tail: paged attention + head ----
    def _attn_step(self, q, block_tables, seq_lens):
        pages = self.cache.pages()
        ks, vs = (pages[2], pages[3]) if len(pages) == 4 else (None, None)
        attn = paged_attn(q, pages[0], pages[1], block_tables, seq_lens,
                          k_scales=ks, v_scales=vs)
        return self.model.decode_out(attn)

    # ---- shape accounting ----
    def _count_shape(self, kind: str, key) -> None:
        k = (kind, key)
        if k in self._shapes:
            self.compile_counters.hit()
            self.metrics.cache.hit()
        else:
            self._shapes.add(k)
            self.compile_counters.miss()
            self.metrics.cache.miss()

    def fresh_compiles(self) -> int:
        """Distinct prefill and decode shapes run so far (the JAX package's
        shape-key accounting; PyTorch has no jit cache to read)."""
        return int(self.compile_counters.misses.value)

    # ---- client side ----
    def submit(self, prompt, max_new_tokens: Optional[int] = None,
               priority: int = 0, deadline_ms: Optional[float] = None,
               eos_token: Optional[int] = None) -> Future:
        """Enqueue one prompt; the Future resolves to the generated token
        ids (np.int32, `<= max_new_tokens` of them, shorter on EOS).
        Raises `RejectedError` when shedding (queue full, a prompt that can
        never fit, shutdown)."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if prompt.size < 1:
            raise ValueError("empty prompt")
        mnt = int(max_new_tokens) if max_new_tokens is not None \
            else self.max_new_tokens_default
        if prompt.size + mnt > self.max_seq_len:
            raise RejectedError(
                f"prompt of {prompt.size} + {mnt} new tokens exceeds "
                f"max_seq_len={self.max_seq_len}")
        now = time.monotonic()
        seq = DecodeSequence(
            seq_id=next(self._seq_ids), prompt=prompt,
            max_new_tokens=mnt, future=Future(), priority=int(priority),
            eos_token=eos_token, enqueued=now,
            deadline=None if deadline_ms is None
            else now + float(deadline_ms) / 1000.0)
        with self._cond:
            if self._poisoned is not None:
                # fatal, not shed: a caller's failover should restart the
                # sequence elsewhere
                self.metrics.rejected.inc()
                raise FatalReplicaError(
                    f"decode engine poisoned: {self._poisoned!r}")
            if self._stop or self._draining:
                self.metrics.rejected.inc()
                self.metrics.record_shed(seq.priority, "rejected")
                raise RejectedError("decode engine is shut down")
            if len(self._waiting) >= self.max_waiting:
                self.metrics.rejected.inc()
                self.metrics.record_shed(seq.priority, "rejected")
                raise RejectedError(
                    f"decode queue full ({self.max_waiting} waiting); "
                    "load shed — back off and retry")
            self._waiting.append(seq)
            self.metrics.record_submit(
                len(self._waiting) + len(self._active))
            self._cond.notify_all()
        return seq.future

    def generate(self, prompt, **kw) -> np.ndarray:
        """Blocking convenience form of `submit`."""
        timeout = kw.pop("timeout", None)
        return self.submit(prompt, **kw).result(timeout=timeout)

    def cancel(self, fut: Future) -> bool:
        """Retire the sequence behind `fut` now, waiting or mid-flight; its
        queue slot and KV pages are released at once."""
        with self._cond:
            for seq in self._waiting:
                if seq.future is fut:
                    self._waiting.remove(seq)
                    self._cond.notify_all()
                    fut.cancel()
                    return True
            for seq in self._active:
                if seq.future is fut:
                    self._retire_locked(seq)
                    fut.cancel()
                    return True
        return False

    # ---- probes / stats ----
    @property
    def queue_depth(self) -> int:
        with self._cond:
            return len(self._waiting) + len(self._active)

    @property
    def accepting(self) -> bool:
        with self._cond:
            return not (self._stop or self._draining
                        or self._poisoned is not None)

    @property
    def step_age_s(self) -> Optional[float]:
        since = self._step_since
        return None if since is None else time.monotonic() - since

    def readyz(self) -> Dict[str, Any]:
        reasons = []
        if self._poisoned is not None:
            reasons.append(f"engine poisoned: {self._poisoned!r}")
        if self._stop or self._draining:
            reasons.append("engine is shut down")
        return {"ready": not reasons, "reasons": reasons}

    def stats(self) -> Dict[str, Any]:
        with self._cond:
            active, waiting = len(self._active), len(self._waiting)
        return {
            "active": active, "waiting": waiting,
            "tokens_emitted": self.tokens_emitted,
            "decode_steps": self.decode_steps,
            "kv": {"dtype": self.kv_dtype,
                   "page_size": self.page_size,
                   "blocks_in_use": self.cache.blocks_in_use,
                   "blocks_total": self.cache.allocator.num_blocks,
                   "bytes_in_use": self.cache.bytes_in_use,
                   "bytes_per_block": self.cache.bytes_per_block,
                   "high_water": self.cache.allocator.high_water},
            "compile": dict(self.compile_counters.snapshot(),
                            fresh=self.fresh_compiles()),
            "buckets": {"prompt": list(self.prompt_buckets),
                        "batch": list(self.batch_buckets)},
        }

    # ---- warmup ----
    @torch.inference_mode()
    def warmup(self) -> int:
        """Run every prefill prompt bucket and decode batch bucket once
        ahead of traffic; returns the number of shapes run.  After this,
        any admissible flood meets no new shape."""
        dev = self.device
        lens = torch.ones(1, dtype=torch.int64, device=dev)
        for tb in self.prompt_buckets:
            self._count_shape("prefill", tb)
            self.model.prefill(torch.zeros((1, tb), dtype=torch.int64, device=dev), lens)
        for bb in self.batch_buckets:
            self._count_shape("decode", bb)
            q, _, _ = self.model.decode_qkv(torch.zeros(bb, dtype=torch.int64, device=dev))
            self._attn_step(q, torch.zeros((bb, self.max_pages), dtype=torch.int32, device=dev),
                            torch.ones(bb, dtype=torch.int32, device=dev))
        return self.fresh_compiles()

    # ---- worker: admit / prefill ----
    def _admit_locked(self) -> None:
        """Move waiting sequences into the decode batch (priority order,
        FIFO within a level) while batch slots and KV pages allow; a
        pool-exhausted admit stops cleanly and retries next step."""
        now = time.monotonic()
        for seq in list(self._waiting):
            if seq.future.cancelled():
                self._waiting.remove(seq)
            elif seq.deadline is not None and now > seq.deadline:
                self._waiting.remove(seq)
                self.metrics.expired.inc()
                self.metrics.record_shed(seq.priority, "expired")
                seq.future.set_exception(DeadlineExceededError(
                    "deadline passed before prefill"))
        self._waiting.sort(key=lambda s: (-s.priority, s.enqueued))
        for seq in list(self._waiting):
            if len(self._active) >= self.max_decode_batch:
                break
            try:
                self._prefill(seq)
            except KVCacheExhausted:
                break                    # no pages now; retry next step
            except Exception as e:       # model failure: fail this seq
                self._waiting.remove(seq)
                self.metrics.failed.inc()
                if not seq.future.cancelled():
                    seq.future.set_exception(e)
                continue
            self._waiting.remove(seq)
        self._note_gauges()

    def _prefill(self, seq: DecodeSequence) -> None:
        """One sequence through the bucketed prefill: pad the prompt to its
        pow2 bucket, write the prompt's KV into fresh pages, and emit the
        first generated token."""
        T = int(seq.prompt.size)
        tb = bucket_for(T, self.prompt_buckets[-1],
                        min_bucket=self.prompt_buckets[0])
        self._count_shape("prefill", tb)
        tokens = np.zeros((1, tb), np.int64)
        tokens[0, :T] = seq.prompt
        last, k, v = self.model.prefill(
            torch.as_tensor(tokens, device=self.device),
            torch.tensor([T], dtype=torch.int64, device=self.device))
        self.cache.allocate(seq.seq_id)
        try:
            self.cache.write(seq.seq_id, k[0, :T], v[0, :T])
        except KVCacheExhausted:
            self.cache.free_seq(seq.seq_id)
            raise
        self._active.append(seq)
        tok = int(last[0].argmax())
        now = time.monotonic()
        seq.t_last = now
        self._emit(seq, tok, inter_ms=None, now=now)

    # ---- worker: one decode step ----
    def _emit(self, seq: DecodeSequence, tok: int,
              inter_ms: Optional[float], now: float) -> None:
        seq.generated.append(tok)
        self.tokens_emitted += 1
        self.instruments.record_token(self.model_label, inter_ms)
        done = (len(seq.generated) >= seq.max_new_tokens
                or (seq.eos_token is not None and tok == seq.eos_token))
        expired = (seq.deadline is not None and now > seq.deadline)
        if done:
            self._retire_locked(seq)
            self.metrics.completed.inc()
            self.metrics.record_latency((now - seq.enqueued) * 1000.0)
            if not seq.future.cancelled():
                seq.future.set_result(np.asarray(seq.generated, np.int32))
        elif expired:
            self._retire_locked(seq)
            self.metrics.expired.inc()
            self.metrics.record_shed(seq.priority, "expired")
            if not seq.future.cancelled():
                seq.future.set_exception(DeadlineExceededError(
                    f"deadline passed after {len(seq.generated)} tokens"))

    def _retire_locked(self, seq: DecodeSequence) -> None:
        """Drop a sequence from the decode batch and release its KV pages
        and batch slot now, between steps."""
        if seq in self._active:
            self._active.remove(seq)
        try:
            self.cache.free_seq(seq.seq_id)
        except KeyError:
            pass
        self._cond.notify_all()

    def _step_locked(self) -> None:
        """Advance every active sequence one token: batched QKV at the pow2
        row bucket, one device append of the live rows' KV (a page alloc on
        page boundaries; exhaustion sheds that one sequence), one
        paged-attention launch and the head, then argmax/emit/retire."""
        actives = list(self._active)
        bb = bucket_for(len(actives), self.batch_buckets[-1],
                        min_bucket=self.batch_buckets[0])
        self._step_since = time.monotonic()
        try:
            tokens = np.zeros(bb, np.int64)
            for i, seq in enumerate(actives):
                tokens[i] = seq.generated[-1]
            self._count_shape("decode", bb)
            q, k, v = self.model.decode_qkv(torch.as_tensor(tokens, device=self.device))
            live: List[Tuple[int, DecodeSequence]] = []
            slots: List[int] = []
            for i, seq in enumerate(actives):
                if seq.future.cancelled():
                    self._retire_locked(seq)
                    continue
                try:
                    slots += self.cache.reserve(seq.seq_id, 1)
                except KVCacheExhausted as e:
                    self._retire_locked(seq)   # shed this sequence only
                    self.metrics.record_shed(seq.priority, "rejected")
                    self.metrics.rejected.inc()
                    if not seq.future.cancelled():
                        seq.future.set_exception(e)
                    continue
                live.append((i, seq))
            if not live:
                return
            rows = torch.as_tensor([i for i, _ in live], device=self.device)
            self.cache.store(slots, k[rows], v[rows])
            bt, sl = self.cache.block_tables(
                [s.seq_id for _, s in live], bb, self.max_pages)
            # scatter back to each sequence's row; rows of retired/padding
            # sequences keep (block 0, length 1)
            bt_full = np.zeros((bb, self.max_pages), np.int32)
            sl_full = np.ones(bb, np.int32)
            for j, (i, _) in enumerate(live):
                bt_full[i] = bt[j]
                sl_full[i] = sl[j]
            logits = self._attn_step(q, torch.as_tensor(bt_full, device=self.device),
                                     torch.as_tensor(sl_full, device=self.device))
            toks = logits.argmax(dim=-1).cpu().numpy()
            self.decode_steps += 1
            now = time.monotonic()
            self.metrics.record_dispatch(
                n_requests=0, rows=len(live), padded_rows=bb - len(live),
                dispatch_ms=(now - self._step_since) * 1000.0)
            for i, seq in live:
                inter = (now - seq.t_last) * 1000.0
                seq.t_last = now
                self._emit(seq, int(toks[i]), inter_ms=inter, now=now)
        finally:
            self._step_since = None
            self._note_gauges()

    def _note_gauges(self) -> None:
        self.instruments.record_active(self.model_label, len(self._active))
        self.instruments.record_kv(
            self.model_label, self.cache.blocks_in_use,
            self.cache.bytes_in_use, self.kv_dtype)
        self.metrics.record_queue_depth(
            len(self._waiting) + len(self._active))

    # ---- worker loop ----
    def _loop(self) -> None:
        with torch.inference_mode():
            while True:
                with self._cond:
                    if self._stop:
                        return
                    self._admit_locked()
                    if not self._active:
                        if self._draining and not self._waiting:
                            return
                        self._cond.wait(timeout=0.02)
                        continue
                    try:
                        self._step_locked()
                    except Exception as e:   # device path died: poison
                        self._poison_locked(e)
                        return

    def _poison_locked(self, exc: BaseException) -> None:
        self._poisoned = exc
        for seq in self._active + self._waiting:
            try:
                self.cache.free_seq(seq.seq_id)
            except KeyError:
                pass
            self.metrics.failed.inc()
            if not seq.future.done():
                seq.future.set_exception(exc)
        self._active.clear()
        self._waiting.clear()
        self._cond.notify_all()

    # ---- failure / lifecycle ----
    def kill(self, exc: Optional[BaseException] = None) -> None:
        """Fail the engine now (chaos hook / replica-death injection): every
        in-flight and waiting sequence fails with a fatal replica error."""
        e = exc if exc is not None else FatalReplicaError("decode engine killed")
        with self._cond:
            self._poison_locked(e)
            self._stop = True
            self._cond.notify_all()

    @property
    def poisoned(self) -> Optional[BaseException]:
        return self._poisoned

    def shutdown(self, drain: bool = True, timeout: float = 10.0) -> None:
        """Stop admission; with `drain`, let the worker finish queued and
        in-flight sequences (bounded by `timeout`), then fail leftovers.
        Idempotent."""
        with self._cond:
            self._draining = True
            self._cond.notify_all()
        if drain:
            end = time.monotonic() + timeout
            with self._cond:
                while ((self._waiting or self._active)
                       and self._poisoned is None
                       and time.monotonic() < end):
                    self._cond.wait(timeout=0.05)
        with self._cond:
            self._stop = True
            self._cond.notify_all()
        self._worker.join(timeout=timeout)
        with self._cond:
            leftovers = self._active + self._waiting
            self._active, self._waiting = [], []
        for seq in leftovers:
            try:
                self.cache.free_seq(seq.seq_id)
            except KeyError:
                pass
            if not seq.future.done():
                seq.future.set_exception(RejectedError(
                    "decode engine shut down before this sequence "
                    "finished"))


# ---------------------------------------------------------------------------
# Fleet adapter: a DecodeEngine with the ModelServer surface
# ---------------------------------------------------------------------------


class _EngineBatcherView:
    """The `server.batcher` surface a fleet reads."""

    def __init__(self, engine: DecodeEngine):
        self._engine = engine

    @property
    def queue_depth(self) -> int:
        return self._engine.queue_depth

    @property
    def accepting(self) -> bool:
        return self._engine.accepting

    @property
    def inflight_age_s(self) -> Optional[float]:
        return self._engine.step_age_s


class _EngineCacheView:
    """The `server.cache` surface (drain/evict call `invalidate`)."""

    def invalidate(self) -> int:
        return 0


class DecodeServerAdapter:
    """Wraps a `DecodeEngine` in the ModelServer surface a fleet replica
    touches (`batcher.queue_depth`, `cache.invalidate`, `readyz`,
    `shutdown`)."""

    def __init__(self, engine: DecodeEngine):
        self.engine = engine
        self.batcher = _EngineBatcherView(engine)
        self.cache = _EngineCacheView()

    @property
    def metrics(self) -> ServingMetrics:
        return self.engine.metrics

    def readyz(self) -> Dict[str, Any]:
        return self.engine.readyz()

    def healthz(self) -> Dict[str, Any]:
        return {"ok": self.engine.poisoned is None,
                "stats": self.engine.stats()}

    def stats(self) -> Dict[str, Any]:
        return self.engine.stats()

    def shutdown(self, drain: bool = True, timeout: float = 10.0) -> None:
        self.engine.shutdown(drain=drain, timeout=timeout)
