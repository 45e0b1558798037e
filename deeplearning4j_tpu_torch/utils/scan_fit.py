"""Fused multi-step training (the port of ``utils/scan_fit.py``, shared by
MultiLayerNetwork and ComputationGraph).

The JAX package runs k training steps as one ``lax.scan`` dispatch; the
port's counterpart is :class:`GraphStep`, k step bodies captured once into
one ``torch.cuda.CUDAGraph`` and replayed once a block.  A CUDA graph
replays device work at fixed addresses and none of the host's work, so the
step body it captures must:

* write every result into the tensor it replaces (``copy_``, ``sub_``,
  ``add_``): parameters, updater state, layer state and the step counters
  are the *carry*, read and written at the same addresses on every replay;
* read no per-step host value: the learning rate and the bias corrections
  come from the device counters (``utils/counters.py``);
* read its batch from the graph's static input buffers, which each block
  is copied into on the device before the replay.

:func:`blocks_of` groups an iterator's batches into blocks of k with one
shape key; ``data/pipeline.py`` stages them.
"""
from __future__ import annotations

import gc
import time
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch


def blocks_of(iterator, k: int):
    """Group consecutive same-shape DataSets from `iterator` into lists of
    exactly `k` (ready for one fused `fit_steps`).  Batches that do not
    fill a block (the epoch tail, or a shape change mid-stream) are yielded
    as single-element lists, so the caller takes the per-step path instead
    of capturing a graph for a one-off k."""
    def shapes(x):
        if x is None:
            return None
        if isinstance(x, (list, tuple)):            # multi-input/-output
            return tuple(None if e is None else tuple(np.shape(e)) for e in x)
        if isinstance(x, dict):
            return tuple(sorted((n, tuple(np.shape(v))) for n, v in x.items()))
        return tuple(np.shape(x))

    def first_attr(ds, *names):
        # explicit `is None`: the truth value of an ndarray mask raises
        for n in names:
            v = getattr(ds, n, None)
            if v is not None:
                return v
        return None

    def key(ds):
        return (shapes(ds.features), shapes(ds.labels),
                shapes(first_attr(ds, "features_mask", "features_masks")),
                shapes(first_attr(ds, "labels_mask", "labels_masks")))

    buf, buf_key = [], None
    for ds in iterator:
        dk = key(ds)
        if buf and dk != buf_key:
            for b in buf:
                yield [b]
            buf = []
        buf.append(ds)
        buf_key = dk
        if len(buf) == k:
            yield buf
            buf = []
    for b in buf:
        yield [b]


def check_steps_axes(named_arrays):
    """Validate that every non-None array shares one leading steps axis.

    `named_arrays` is an iterable of (name, array, list of k per-step
    arrays, or None); returns k.  Raising here names the offending array
    before any step runs."""
    k, ref = None, None
    for name, a in named_arrays:
        if a is None:
            continue
        n = len(a) if isinstance(a, (list, tuple)) else a.shape[0]
        if k is None:
            k, ref = n, name
        elif n != k:
            raise ValueError(
                f"steps axis mismatch: '{name}' has {n} steps but "
                f"'{ref}' has {k} — every array needs the same leading "
                f"[k, batch, ...] steps axis")
    if k is None:
        raise ValueError("fit_steps needs at least one array input")
    return k


# ---------------------------------------------------------------------------
# k steps as one CUDA graph
# ---------------------------------------------------------------------------

#: a block entry: None, a stacked [k, ...] tensor, or a list of k tensors
Entry = Any

_capture_streams: Dict[int, torch.cuda.Stream] = {}


def _capture_stream(device: torch.device) -> "torch.cuda.Stream":
    """One side stream per device for warm-ups and captures: the kernels'
    per-stream buffers a graph bakes in are this stream's, which nothing
    else launches on."""
    idx = device.index if device.index is not None else torch.cuda.current_device()
    if idx not in _capture_streams:
        _capture_streams[idx] = torch.cuda.Stream(device=idx)
    return _capture_streams[idx]


def _steps(block: Sequence[Entry]) -> int:
    for e in block:
        if e is not None:
            return len(e)
    raise ValueError("fit_steps needs at least one array input")


def _at(entry: Entry, i: int):
    return None if entry is None else entry[i]


def _signature(block: Sequence[Entry]) -> Tuple:
    """Per entry: None, or the per-step (shape, dtype); a list's entries
    must all agree."""
    sig = []
    for e in block:
        if e is None:
            sig.append(None)
            continue
        if isinstance(e, torch.Tensor):
            sig.append((tuple(e.shape[1:]), e.dtype))
            continue
        first = (tuple(e[0].shape), e[0].dtype)
        for t in e[1:]:
            if (tuple(t.shape), t.dtype) != first:
                raise ValueError(
                    f"fit_steps: the steps of a block differ in shape or dtype: "
                    f"{first} and {(tuple(t.shape), t.dtype)}")
        sig.append(first)
    return tuple(sig)


def _load(statics: Sequence[Optional[torch.Tensor]], block: Sequence[Entry]) -> None:
    """Copy a block into the graph's static buffers on the current stream
    (device to device: the block is staged on the card already)."""
    for s, e in zip(statics, block):
        if s is None:
            continue
        if isinstance(e, torch.Tensor):
            s.copy_(e)
        else:
            torch.stack(list(e), out=s)


class _Captured(NamedTuple):
    graph: Any
    statics: List[Optional[torch.Tensor]]
    losses: torch.Tensor
    ptrs: Tuple[int, ...]
    held: List[torch.Tensor]


def register_generator(graph, generator) -> None:
    """Register a dropout generator with `graph`, so each replay draws
    fresh masks; raise where this PyTorch cannot (the masks drawn at
    capture would be replayed unchanged)."""
    register = getattr(graph, "register_generator_state", None)
    if register is None:
        raise RuntimeError(
            "the network draws dropout masks from its own generator, and this "
            "PyTorch's CUDAGraph has no register_generator_state: a graph would "
            "replay one mask; train it with fit(x, y) step by step instead")
    register(generator)


class GraphStep:
    """``step(carry, epoch, block) -> losses[k]``: k training steps, the
    counterpart of the JAX package's ``make_scan_step``.

    `tick(carry, epoch, batch) -> loss` is one step body: it reads the
    step's batch (a list of tensors or None, one per block entry), writes
    its results into the `carry` tensors in place and returns the 0-dim
    loss.  `block` holds, per entry, None, a stacked ``[k, ...]`` tensor
    (a stride-0 ``broadcast_to`` view included) or a list of k tensors.

    On a CUDA device the k bodies are captured once per (k, per-step shapes
    and dtypes, mask presence, dispatch mode, the caller's `key`) into one
    ``torch.cuda.CUDAGraph``, after a warm-up body on a side stream whose
    effects on the carry and the generator are undone; each block is then
    one ``replay()``.  The carry's addresses are part of the graph: a carry
    rebound from outside (``load``, ``set_params``) is captured afresh.  A
    failed capture raises; nothing falls back to eager steps.  On the CPU,
    where the caller asked for it, the same body runs eagerly.  The losses
    come back as a fresh tensor, never the graph's output buffer, which
    the next replay overwrites."""

    def __init__(self, tick: Callable):
        self.tick = tick
        self.captures = 0
        self.capture_seconds: List[float] = []
        self._graphs: Dict[Tuple, _Captured] = {}

    def __call__(self, carry: Sequence[torch.Tensor], epoch: torch.Tensor,
                 block: Sequence[Entry], key: Tuple = (),
                 generator: Optional[torch.Generator] = None) -> torch.Tensor:
        k = _steps(block)
        if epoch.device.type != "cuda":
            return torch.stack([self.tick(carry, epoch, [_at(e, i) for e in block])
                                for i in range(k)])
        from deeplearning4j_tpu_torch.ops.kernels import dispatch
        gkey = (k, _signature(block), dispatch.dispatch_mode(), key,
                None if generator is None else id(generator))
        ptrs = tuple(t.data_ptr() for t in carry) + (epoch.data_ptr(),)
        rec = self._graphs.get(gkey)
        if rec is None or rec.ptrs != ptrs:
            self._graphs.pop(gkey, None)
            rec = self._graphs[gkey] = self._capture(carry, epoch, block, k, ptrs,
                                                     generator)
        _load(rec.statics, block)
        rec.graph.replay()
        return rec.losses.clone()

    def _capture(self, carry, epoch, block, k, ptrs, generator) -> _Captured:
        from deeplearning4j_tpu_torch.ops.kernels import matmul
        t0 = time.perf_counter()
        dev = epoch.device
        statics = [None if s is None else torch.empty((k,) + s[0], dtype=s[1], device=dev)
                   for s in _signature(block)]
        _load(statics, block)
        side = _capture_stream(dev)
        cur = torch.cuda.current_stream(dev)
        # warm-up: one body on the side stream (the kernels' plans and
        # buffers, cuDNN's choices, the library build), then the carry and
        # the generator are put back as they were
        saved = [t.detach().clone() for t in carry]
        gen0 = None if generator is None else generator.get_state()
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            self.tick(carry, epoch, [_at(s, 0) for s in statics])
        cur.wait_stream(side)
        draws = generator is not None and not torch.equal(generator.get_state(), gen0)
        with torch.no_grad():
            for t, s in zip(carry, saved):
                t.copy_(s)
        if generator is not None:
            generator.set_state(gen0)
        del saved
        matmul.take_captured_buffers()
        graph = torch.cuda.CUDAGraph()
        if draws:
            register_generator(graph, generator)
        # a dead graph (a dropped network holds its step in a reference
        # cycle) that the cyclic collector frees during the capture would
        # destroy its executable mid-capture and invalidate the capture:
        # collect before it, and not during it
        gc.collect()
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph, stream=side):
                losses = torch.stack([self.tick(carry, epoch, [_at(s, i) for s in statics])
                                      for i in range(k)])
        finally:
            if collecting:
                gc.enable()
        held = matmul.take_captured_buffers()
        self.captures += 1
        self.capture_seconds.append(time.perf_counter() - t0)
        return _Captured(graph, statics, losses, ptrs, held)
