"""Fault-tolerant training: checkpoint manager, auto-resume, preemption
handling, a divergence guard and the elastic trainer (the port of
``train/resilience.py``).

Reference role: `CheckpointListener` (periodic tmp-and-rename checkpoints
with keep-last-K retention) and the Spark `TrainingMaster`'s driver
resync after executor loss, rebuilt over the sharded checkpoint format of
``parallel/checkpoint.py`` (the JAX package's, so a checkpoint crosses
between the packages either way).  Under ZeRO-1 the moments live sharded
over the ranks, so recovery goes through the resharding loader.

* :class:`CheckpointManager`: step- and time-triggered saves into
  ``ckpt-{step}`` subdirectories, keep-last-K retention, per-chunk crc32
  checksums (verified on read), an optional background writer, and a
  restore that falls back to the newest *intact* checkpoint when the
  latest is torn (no manifest) or checksum-corrupt.
* :class:`FaultTolerantTrainer`: a MultiLayerNetwork / ComputationGraph /
  ParallelWrapper fit loop with full-state auto-resume (parameters, layer
  state, updater state, counters, the dropout generator, the normalizer,
  the iterator's position), SIGTERM checkpoint-and-exit
  (:class:`Preempted`) and a :class:`DivergenceGuard` with ``skip`` and
  ``rollback`` policies.
* :class:`ElasticTrainer`: survives gang membership changes of
  ``HierarchicalGradientSharing(elastic=True)`` by rewinding every member
  to the coordinated checkpoint.

**Restore in place.**  A fused block replays a CUDA graph at fixed
addresses (``utils/scan_fit.py``), and ZeRO-1's views and the updater
state hold the live tensors too.  So every restore writes into the live
tensors (``copy_``): parameters, layer state (BatchNorm statistics),
updater moments, and the device step counters, which are written again
in place on the next step (``utils/counters.py``).  No tensor is rebound,
and a captured block goes on replaying the restored values.

**The async snapshot.**  The port's updates are in place, so `save` stages
every leaf into one host buffer a dtype (pinned on the card) with one
synchronize before it returns; the next step cannot change that copy.

**The checkpoint tree** is the JAX package's ``{"opt", "params", "rng",
"state"}`` in its layouts, with its metadata (``iteration``, ``epoch``,
``step``, ``batch_in_epoch``, the normalizer, the configuration).  The
``rng`` leaf cannot cross (threefry against Philox), by this rule: the
port writes there the JAX package's initial key for the network's seed
(``jax.random.PRNGKey(seed)``: ``[seed >> 32, seed & 0xffffffff]`` as
uint32), so the JAX package restores a port checkpoint with its dropout
stream started afresh from the seed; the port keeps its own generator's
state in the metadata (``torch_rng``) and never reads the ``rng`` leaf,
so a JAX checkpoint leaves the port's generator as it is.

A run killed at step N and auto-resumed ends with the parameters of an
uninterrupted run, bit for bit: saves are exact copies and the data order
is the iterator's own determinism.
"""
from __future__ import annotations

import base64
import json
import os
import shutil
import signal
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch.monitor.instrument import (gang_instruments,
                                                         resilience_instruments)
from deeplearning4j_tpu_torch.parallel.checkpoint import (
    MANIFEST, ChecksumError, ShardedLeaf, _model_tree, _rank_world, assign_model_tree,
    load_sharded, read_metadata, save_sharded, verify_checkpoint)
from deeplearning4j_tpu_torch.train.earlystopping import MaxScoreIterationTerminationCondition


class Preempted(RuntimeError):
    """Raised out of `FaultTolerantTrainer.fit` after a preemption signal
    was honored with a final checkpoint.  `exit_code` is the conventional
    128+SIGTERM=143 for supervisors that propagate it."""

    def __init__(self, message: str, signum: int = signal.SIGTERM):
        super().__init__(message)
        self.signum = signum
        self.exit_code = 128 + int(signum)


class DivergenceError(RuntimeError):
    """The divergence guard gave up: more than `max_events` flagged steps,
    or a rollback was requested with no checkpoint to roll back to."""


class NoIntactCheckpointError(RuntimeError):
    """Checkpoints exist under the directory but every one is torn or
    checksum-corrupt: nothing intact to restore."""


# ---------------------------------------------------------------------------
# The checkpoint tree
# ---------------------------------------------------------------------------

def jax_seed_key(seed: int) -> np.ndarray:
    """``jax.random.PRNGKey(seed)`` as numpy: the ``rng`` leaf the port
    writes (see the module docstring)."""
    seed = int(seed)
    return np.array([(seed >> 32) & 0xFFFFFFFF, seed & 0xFFFFFFFF], np.uint32)


def _fast_path(model) -> bool:
    """The tree can be walked leaf by leaf from the live tensors: no
    ZeRO-1 shards and no tensor-parallel blocks (those go through
    ``parallel/checkpoint.py``'s gathering walk)."""
    return (getattr(model, "_step_transform", None) is None
            and getattr(model, "_tp", None) is None)


def _walk(tree, fn, layer, key=None):
    """fn(tensor, perm) over a network-keyed subtree, each leaf with the
    permutation taking its port layout to the JAX one (None: the same);
    tuples (an updater without state) pass through, as in ``convert``."""
    if isinstance(tree, dict):
        return {k: _walk(v, fn, layer, k) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tree
    perm = layer.TORCH_LAYOUT.get(key) if layer is not None else None
    return fn(tree, None if perm is None else tuple(int(i) for i in np.argsort(perm)))


def _map_model(model, fn) -> Dict[str, Any]:
    """``{"params", "state", "opt"}`` with fn(tensor, perm) at every leaf."""
    from deeplearning4j_tpu_torch import convert
    lay = convert._layer_or_layout
    return {"params": {n: _walk(s, fn, lay(model, n)) for n, s in model.params_.items()},
            "state": {n: _walk(s, fn, None) for n, s in model.state_.items()},
            "opt": {n: _walk(s, fn, lay(model, n)) for n, s in model.opt_state_.items()}}


def _host_dtype(t: torch.Tensor) -> torch.dtype:
    """A leaf's dtype in the checkpoint: bf16 widens to f32 (numpy has no
    bf16), as ``convert`` writes it."""
    return torch.float32 if t.dtype == torch.bfloat16 else t.dtype


def _template(model) -> Dict[str, Any]:
    """The checkpoint tree's structure, shapes and dtypes with no data
    (meta tensors), the `like` of `load_sharded`."""
    if not _fast_path(model):
        tree = _model_tree(model, template=True)
    else:
        def meta(t, perm):
            shape = tuple(t.shape) if perm is None else tuple(t.shape[i] for i in perm)
            return torch.empty(shape, dtype=_host_dtype(t), device="meta")
        tree = _map_model(model, meta)
    tree["rng"] = jax_seed_key(0)
    return tree


class _Staging:
    """Reusable host buffers for snapshots: one flat buffer a dtype,
    pinned where the tensors are on the card."""

    def __init__(self):
        self._bufs: Dict[Tuple, torch.Tensor] = {}

    def buffer(self, dtype: torch.dtype, n: int, pinned: bool) -> torch.Tensor:
        key = (dtype, pinned)
        buf = self._bufs.get(key)
        if buf is None or buf.numel() < n:
            buf = torch.empty(n, dtype=dtype, pin_memory=pinned)
            self._bufs[key] = buf
        return buf[:n]


def _host_snapshot(model, staging: Optional[_Staging] = None) -> Dict[str, Any]:
    """A host copy of the model's checkpoint tree (numpy, JAX layouts)
    that the next step cannot change: every leaf goes into one flat
    device buffer a dtype, which crosses in one copy (into `staging`'s
    buffer, pinned on the card), with one synchronize at the end.  The
    returned arrays are views of `staging`: the caller keeps it unused
    until they are written."""
    if not _fast_path(model):
        tree = _model_tree(model)
        return _copy_leaves(tree)
    leaves: List[Tuple[torch.Tensor, Optional[Tuple[int, ...]]]] = []
    ids = _map_model(model, lambda t, perm: leaves.append((t, perm)) or len(leaves) - 1)
    groups: Dict[torch.dtype, List[int]] = {}
    for i, (t, _) in enumerate(leaves):
        groups.setdefault(_host_dtype(t), []).append(i)
    copies = []
    on_card = False
    for dt, members in groups.items():
        flat = torch.cat([leaves[i][0].detach().reshape(-1).to(dt) for i in members])
        on_card = on_card or flat.is_cuda
        if staging is None and not flat.is_cuda:
            buf = flat            # torch.cat made a copy already
        else:
            buf = (staging or _Staging()).buffer(dt, flat.numel(), pinned=flat.is_cuda)
            buf.copy_(flat, non_blocking=flat.is_cuda)
        copies.append((buf, members))
    if on_card:
        torch.cuda.synchronize()
    host: Dict[int, np.ndarray] = {}
    for buf, members in copies:
        arr, off = buf.numpy(), 0
        for i in members:
            t, perm = leaves[i]
            a = arr[off:off + t.numel()].reshape(tuple(t.shape))
            host[i] = a if perm is None else a.transpose(perm)
            off += t.numel()

    def fill(sub):
        if isinstance(sub, dict):
            return {k: fill(v) for k, v in sub.items()}
        return sub if isinstance(sub, tuple) else host[sub]
    return fill(ids)


def _copy_leaves(tree):
    if isinstance(tree, dict):
        return {k: _copy_leaves(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_copy_leaves(v) for v in tree)
    if isinstance(tree, ShardedLeaf):
        return ShardedLeaf(tree.shape, tree.dtype, tree.window,
                           None if tree.data is None else np.array(tree.data))
    return np.array(tree) if tree is not None else None


def _tree_nbytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(_tree_nbytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_tree_nbytes(v) for v in tree)
    if isinstance(tree, ShardedLeaf):
        return 0 if tree.data is None else int(np.asarray(tree.data).nbytes)
    return int(getattr(tree, "nbytes", 0) or 0)


def _unshard(tree):
    """A snapshot's ZeRO-1 ShardedLeafs as their windows' data (what
    `load_sharded` returns for them)."""
    if isinstance(tree, dict):
        return {k: _unshard(v) for k, v in tree.items()}
    if isinstance(tree, ShardedLeaf):
        return tree.data
    return tree


def _rng_to_meta(model) -> Optional[Dict[str, str]]:
    gen = getattr(model, "_rng", None)
    if not isinstance(gen, torch.Generator):
        return None
    return {"device": gen.device.type,
            "state": base64.b64encode(gen.get_state().numpy().tobytes()).decode("ascii")}


def _rng_from_meta(model, meta: Optional[Dict[str, str]]) -> None:
    """Restore the port's dropout generator from a port checkpoint's
    metadata; a checkpoint without it (the JAX package's) leaves the
    generator as it is."""
    gen = getattr(model, "_rng", None)
    if not meta or not isinstance(gen, torch.Generator) or meta["device"] != gen.device.type:
        return
    state = np.frombuffer(base64.b64decode(meta["state"]), np.uint8).copy()
    gen.set_state(torch.from_numpy(state))


@torch.no_grad()
def _assign(model, tree: Dict[str, Any], iteration: Optional[int] = None,
            epoch: Optional[int] = None) -> None:
    """Write a checkpoint tree into the live tensors (in place) and the
    counters into the host shadows; the device counters are written again
    in place on the next step (``utils/counters.py``)."""
    assign_model_tree(model, tree)
    if iteration is not None:
        model.iteration = int(iteration)
    if epoch is not None and hasattr(model, "epoch"):
        model.epoch = int(epoch)
    model._iter_sync = None
    model._epoch_sync = None


def _normalizer_to_meta(nz) -> Optional[Dict[str, str]]:
    if nz is None or not hasattr(nz, "to_bytes"):
        return None
    return {"class": type(nz).__name__,
            "data": base64.b64encode(nz.to_bytes()).decode("ascii")}


def normalizer_from_meta(meta: Optional[Dict[str, str]]):
    """Rebuild a fitted normalizer recorded by `CheckpointManager.save`
    (or None when the checkpoint carried none)."""
    if not meta:
        return None
    from deeplearning4j_tpu_torch.data import normalizers as _n
    cls = getattr(_n, meta["class"], None)
    if cls is None:
        raise ValueError(f"unknown normalizer class {meta['class']!r} "
                         "recorded in checkpoint metadata")
    return cls.from_bytes(base64.b64decode(meta["data"]))


# ---------------------------------------------------------------------------
# CheckpointManager
# ---------------------------------------------------------------------------

class CheckpointManager:
    """Periodic sharded checkpoints with retention, checksums, async save
    and intact-fallback restore.

        mgr = CheckpointManager(dir, keep_last=3, save_every_steps=100,
                                async_save=True)
        meta = mgr.restore(net)            # newest intact, or None
        for ds in iterator:
            net.fit(ds.features, ds.labels)
            mgr.maybe_save(net)            # trigger-gated
        mgr.wait()                         # join the background writer

    Layout: one ``ckpt-{step:010d}`` subdirectory per save, each a
    ``parallel/checkpoint.py`` sharded checkpoint (committed by the atomic
    manifest rename).  Retention keeps the newest `keep_last` committed
    checkpoints; uncommitted (torn) directories older than the newest
    committed one are torn-write debris and are removed too.

    An async save stages a host copy *synchronously* (one synchronize)
    into one reused staging buffer and writes it in ONE background
    thread; every later save, blocking or not, joins that write before
    it refills the buffer, so one snapshot at most is held.  A job of
    more than one process in a ``torch.distributed`` group saves
    synchronously (every rank takes part in the save's barrier at the
    same step).
    """

    PREFIX = "ckpt-"

    def __init__(self, directory: str, keep_last: int = 3,
                 save_every_steps: Optional[int] = None,
                 save_every_seconds: Optional[float] = None,
                 async_save: bool = False):
        if keep_last < 1:
            raise ValueError(f"keep_last must be >= 1, got {keep_last}")
        self.directory = directory
        self.keep_last = int(keep_last)
        self.save_every_steps = save_every_steps
        self.save_every_seconds = save_every_seconds
        self.async_save = bool(async_save)
        os.makedirs(directory, exist_ok=True)
        self._last_save_step = 0
        self._last_save_time = time.monotonic()
        self._pending: Optional[threading.Thread] = None
        self._async_error: Optional[BaseException] = None
        self._staging = _Staging()
        self._ins = resilience_instruments()
        #: seconds of each save's host snapshot: what an async save costs
        #: the step path (besides waiting for an earlier write)
        self.snapshot_s: List[float] = []

    # ---- directory layout ----
    def checkpoint_path(self, step: int) -> str:
        return os.path.join(self.directory, f"{self.PREFIX}{step:010d}")

    def _step_of(self, name: str) -> Optional[int]:
        if not name.startswith(self.PREFIX):
            return None
        try:
            return int(name[len(self.PREFIX):])
        except ValueError:
            return None

    def steps(self) -> List[int]:
        """Committed checkpoint steps, ascending (commit = manifest
        present; a directory mid-write or torn by a crash is excluded)."""
        out = []
        try:
            names = os.listdir(self.directory)
        except FileNotFoundError:
            return []
        for name in names:
            step = self._step_of(name)
            if step is None:
                continue
            if os.path.exists(os.path.join(self.directory, name, MANIFEST)):
                out.append(step)
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    # ---- save ----
    def maybe_save(self, model, **kwargs) -> bool:
        """Save iff a trigger is due: `save_every_steps` optimizer steps
        or `save_every_seconds` wall seconds since the last save.  Returns
        whether a save was started.  In a multi-process job the step
        trigger agrees across ranks (the same iteration counter) and the
        time trigger does not: use step triggers there."""
        step = int(model.iteration)
        due = (self.save_every_steps is not None
               and step - self._last_save_step >= self.save_every_steps)
        if not due and self.save_every_seconds is not None:
            due = time.monotonic() - self._last_save_time >= self.save_every_seconds
        if not due:
            return False
        self.save(model, **kwargs)
        return True

    def save(self, model, *, step: Optional[int] = None,
             metadata: Optional[Dict[str, Any]] = None,
             normalizer=None, block: Optional[bool] = None) -> str:
        """Checkpoint the model's full state now; returns the checkpoint
        directory.  `block=False` (the default under `async_save=True`)
        hands the write to the background thread after a synchronous host
        snapshot; `block=True` writes before returning (the preemption
        path)."""
        self._raise_async_error()
        step = int(model.iteration) if step is None else int(step)
        meta = dict(metadata or {})
        meta.setdefault("iteration", int(model.iteration))
        meta.setdefault("epoch", int(model.epoch) if hasattr(model, "epoch") else 0)
        meta["step"] = step
        nz_meta = _normalizer_to_meta(normalizer)
        if nz_meta is not None:
            meta["normalizer"] = nz_meta
        rng_meta = _rng_to_meta(model)
        if rng_meta is not None:
            meta["torch_rng"] = rng_meta
        conf = getattr(model, "conf", None)
        if conf is not None and hasattr(conf, "to_json"):
            try:
                meta.setdefault("config", conf.to_json())
            except Exception:
                pass                    # the configuration is advisory, not state
        target = self.checkpoint_path(step)
        multi = _rank_world()[1] > 1    # every rank of the group saves
        use_async = (self.async_save and not multi) if block is None else (not block)
        if use_async and multi:
            raise ValueError("async checkpoint saves are single-process only "
                             "(every rank must reach the save barrier)")
        self._last_save_step = step
        self._last_save_time = time.monotonic()
        seed = int(getattr(conf, "seed", 0) or 0)
        # every save, blocking or not, joins the background write first:
        # that write reads the staging buffer this snapshot refills
        self.wait()
        t0 = time.perf_counter()
        snap = _host_snapshot(model, self._staging)
        self.snapshot_s.append(time.perf_counter() - t0)
        snap["rng"] = jax_seed_key(seed)
        if use_async:
            t = threading.Thread(target=self._write_async, args=(target, snap, meta),
                                 name="ckpt-writer", daemon=True)
            self._pending = t
            t.start()
        else:
            self._write(target, snap, meta)
        return target

    def _write(self, target: str, tree, meta: Dict[str, Any]) -> None:
        t0 = time.perf_counter()
        save_sharded(target, tree, metadata=meta)
        self._ins.record_save(time.perf_counter() - t0, _tree_nbytes(tree))
        self.gc()

    def _write_async(self, target: str, snap, meta: Dict[str, Any]) -> None:
        try:
            self._write(target, snap, meta)
        except BaseException as e:      # surfaced on the next save()/wait()
            self._async_error = e

    def wait(self) -> None:
        """Join any in-flight background save (and re-raise its error)."""
        t, self._pending = self._pending, None
        if t is not None:
            t.join()
        self._raise_async_error()

    def _raise_async_error(self) -> None:
        err, self._async_error = self._async_error, None
        if err is not None:
            raise RuntimeError("background checkpoint save failed") from err

    # ---- retention ----
    def gc(self) -> int:
        """Keep the newest `keep_last` committed checkpoints; drop older
        committed ones and any uncommitted (torn) directory older than the
        newest committed step.  Returns the number removed.  In a
        multi-process job only rank 0 removes."""
        if _rank_world()[0] != 0:
            return 0
        try:
            names = os.listdir(self.directory)
        except FileNotFoundError:
            return 0
        by_step = {step: name for name in names
                   if (step := self._step_of(name)) is not None}
        committed = sorted(step for step, name in by_step.items()
                           if os.path.exists(os.path.join(self.directory, name, MANIFEST)))
        keep = set(committed[-self.keep_last:])
        newest = committed[-1] if committed else None
        removed = 0
        for step, name in by_step.items():
            if step in keep:
                continue
            if step not in committed and (newest is None or step >= newest):
                continue    # possibly a save in flight: never remove the head
            shutil.rmtree(os.path.join(self.directory, name), ignore_errors=True)
            removed += 1
        if removed:
            self._ins.checkpoint_gc.inc(removed)
        return removed

    # ---- restore ----
    def restore(self, model, step: Optional[int] = None) -> Optional[Dict[str, Any]]:
        """Restore the newest *intact* checkpoint into `model`, in place
        (for a ZeRO-1 or ParallelWrapper run, place the model first, so
        the resharding loader reads this rank's windows of the moments).

        Returns the checkpoint's metadata, or None when the directory
        holds no checkpoint at all.  A torn or checksum-corrupt newest
        checkpoint is skipped (counted as a fallback) for the next older
        intact one; if every checkpoint is damaged, raises
        :class:`NoIntactCheckpointError` chained to the last failure.

        `step` pins the restore to that checkpoint (falling back only to
        OLDER intact ones): the elastic gang uses it so every member
        rewinds to the same coordinated resume point even if a newer
        checkpoint landed meanwhile."""
        self.wait()
        candidates = sorted(self.steps(), reverse=True)
        if step is not None:
            candidates = [s for s in candidates if s <= int(step)]
        last_err: Optional[Exception] = None
        for step in candidates:
            d = self.checkpoint_path(step)
            try:
                verify_checkpoint(d)
            except (ChecksumError, FileNotFoundError, ValueError) as e:
                last_err = e
                self._ins.restore_fallbacks.inc()
                continue
            tree = load_sharded(d, _template(model))
            meta = read_metadata(d)
            _assign(model, tree, meta.get("iteration"), meta.get("epoch"))
            _rng_from_meta(model, meta.get("torch_rng"))
            self._ins.restores.inc()
            return meta
        if last_err is not None:
            raise NoIntactCheckpointError(
                f"{self.directory}: {len(candidates)} checkpoint(s) found "
                "but none intact") from last_err
        return None


# ---------------------------------------------------------------------------
# Divergence guard
# ---------------------------------------------------------------------------

class DivergenceGuard:
    """Per-step divergence detection with a recovery policy.

    Triggers (checked after each optimizer step on the blocking score):
      * NaN/inf loss: `earlystopping.MaxScoreIterationTerminationCondition`
        (its `score == score` NaN check), plus an explicit isfinite check
        (inf compares False against an inf max_score);
      * `max_score`: absolute loss ceiling (same condition object);
      * `spike_factor`: loss > factor x median of the last `window`
        healthy losses (needs >= 5 history entries);
      * `grad_norm_threshold`: opt-in PRE-step check via
        `model.gradient_for` (an extra forward and backward a step).

    Policies:
      * ``"skip"``: restore the pre-step host snapshot the trainer keeps
        while this policy is active, discarding the poisoned update; the
        batch is consumed (skipped).
      * ``"rollback"``: restore the newest intact checkpoint via the
        manager (losing up to one save interval of steps), then replay;
        the offending batch is remembered and skipped on replay so the
        run makes progress instead of diverging again.

    More than `max_events` flagged steps raises :class:`DivergenceError`.
    """

    def __init__(self, policy: str = "skip", max_score: Optional[float] = None,
                 spike_factor: Optional[float] = None, window: int = 20,
                 grad_norm_threshold: Optional[float] = None, max_events: int = 8):
        if policy not in ("skip", "rollback"):
            raise ValueError(f"policy must be 'skip' or 'rollback', got {policy!r}")
        self.policy = policy
        self.spike_factor = spike_factor
        self.window = int(window)
        self.grad_norm_threshold = grad_norm_threshold
        self.max_events = int(max_events)
        self.events = 0
        self._history: List[float] = []
        self._cond = MaxScoreIterationTerminationCondition(
            float("inf") if max_score is None else float(max_score))

    def check(self, score: float) -> Optional[str]:
        """Reason string when `score` is divergent, else None (and the
        score joins the healthy history)."""
        score = float(score)
        if self._cond.terminate(score) or not np.isfinite(score):
            if not np.isfinite(score):
                return "nan/inf loss"
            return f"loss {score:g} > max_score {self._cond.max_score:g}"
        if self.spike_factor is not None and len(self._history) >= 5:
            ref = float(np.median(self._history))
            if score > self.spike_factor * ref:
                return (f"loss spike {score:g} > {self.spike_factor:g}x "
                        f"median {ref:g}")
        self._history.append(score)
        if len(self._history) > self.window:
            self._history.pop(0)
        return None

    def grad_norm(self, model, ds) -> Optional[float]:
        """Global L2 gradient norm for the batch, or None when the model
        has no `gradient_for` (opt-in pre-step check)."""
        from deeplearning4j_tpu_torch.train.updaters import tree_leaves
        fn = getattr(model, "gradient_for", None)
        if fn is None:
            return None
        grads = fn(ds.features, ds.labels)
        sq = 0.0
        for leaf in tree_leaves(grads):
            g = np.asarray(leaf.detach().cpu().double() if isinstance(leaf, torch.Tensor)
                           else leaf, np.float64)
            sq += float(np.vdot(g, g))
        return float(np.sqrt(sq))


# ---------------------------------------------------------------------------
# FaultTolerantTrainer
# ---------------------------------------------------------------------------

class _Rollback(Exception):
    """Internal control flow: unwind the epoch loop after a divergence
    rollback restored an earlier (epoch, batch) position."""

    def __init__(self, skip: int):
        self.skip = skip


class FaultTolerantTrainer:
    """Fit loop with auto-resume, preemption handling and divergence
    recovery.

        mgr = CheckpointManager(dir, save_every_steps=50, async_save=True)
        trainer = FaultTolerantTrainer(net, mgr, normalizer=nz)
        trainer.fit(iterator, epochs=10)     # resumes if mgr has state

    Accepts a MultiLayerNetwork / ComputationGraph (or a ParallelWrapper
    around one: ZeRO-1 moments restore through the resharding loader at
    their sharded layout).  `hooks` are callables invoked with the trainer
    after every step (the chaos harness's injection point).  On a
    preemption signal (default SIGTERM) the current step finishes, a
    blocking checkpoint commits, and :class:`Preempted` unwinds out of
    `fit`; the supervisor relaunches and the next `fit` fast-forwards the
    iterator to `batch_in_epoch` from the checkpoint metadata and
    continues bit for bit.
    """

    def __init__(self, model, manager: Optional[CheckpointManager] = None, *,
                 normalizer=None, divergence: Optional[DivergenceGuard] = None,
                 preempt_signals: Sequence[int] = (signal.SIGTERM,),
                 hooks: Sequence[Callable[["FaultTolerantTrainer"], None]] = (),
                 auto_resume: bool = True, save_initial: bool = True):
        # a ParallelWrapper duck-types as (has .model and ._fit_ds)
        if hasattr(model, "model") and hasattr(model, "_fit_ds"):
            self.wrapper = model
            self.model = model.model
        else:
            self.wrapper = None
            self.model = model
        self.manager = manager
        self.normalizer = normalizer
        self.guard = divergence
        self.preempt_signals = tuple(preempt_signals)
        self.hooks = list(hooks)
        self.auto_resume = bool(auto_resume)
        self.save_initial = bool(save_initial)
        self.resumed_from: Optional[Dict[str, Any]] = None
        self.batch_in_epoch = 0
        self._preempt_signum: Optional[int] = None
        self._old_handlers: Dict[int, Any] = {}
        self._prev: Optional[Tuple[Any, int]] = None
        self._skip_batches: set = set()
        self._staging = _Staging()          # the skip policy's pre-step copies
        self._ins = resilience_instruments()

    # ---- signals ----
    def _install_signals(self) -> None:
        self._preempt_signum = None
        for sig in self.preempt_signals:
            try:
                self._old_handlers[sig] = signal.signal(sig, self._on_signal)
            except (ValueError, OSError):
                pass            # not the main thread: signals stay external

    def _restore_signals(self) -> None:
        for sig, old in self._old_handlers.items():
            try:
                signal.signal(sig, old)
            except (ValueError, OSError):
                pass
        self._old_handlers = {}

    def _on_signal(self, signum, frame) -> None:
        self._preempt_signum = signum

    # ---- state snapshot (skip policy) ----
    def _snapshot_prev(self) -> None:
        """Host copy of the pre-step state (ZeRO-1 windows included), for a
        skip to write back into the live tensors."""
        self._prev = (_unshard(_host_snapshot(self.model, self._staging)),
                      int(self.model.iteration))

    def _restore_prev(self) -> None:
        assert self._prev is not None
        tree, iteration = self._prev
        _assign(self.model, tree, iteration)

    # ---- fitting ----
    def _fit_one(self, ds) -> None:
        if self.wrapper is not None:
            self.wrapper._fit_ds(ds)
        else:
            self.model._fit_dataset(ds)

    def _save_meta(self, batch_in_epoch: int) -> Dict[str, Any]:
        return {"batch_in_epoch": int(batch_in_epoch)}

    def _checkpoint_kwargs(self) -> Dict[str, Any]:
        return {"normalizer": self.normalizer}

    def fit(self, data, *, epochs: int = 1, fused_steps: int = 1):
        """Train until `model.epoch == epochs`, resuming from the manager's
        newest intact checkpoint when one exists.  `data` must iterate
        deterministically for a bitwise resume (e.g. `shuffle=False`, or a
        seeded order keyed on the epoch)."""
        if fused_steps > 1 and (self.wrapper is not None or self.guard is not None):
            raise ValueError(
                "fused_steps > 1 composes with the plain model path only "
                "(no ParallelWrapper, no divergence guard): a fused block "
                "is one dispatch, so per-step recovery points don't exist "
                "inside it")
        self._install_signals()
        try:
            skip = self._resume()
            while self.model.epoch < epochs:
                if hasattr(data, "reset"):
                    data.reset()
                try:
                    self._run_epoch(data, skip, fused_steps)
                except _Rollback as rb:
                    skip = rb.skip     # epoch/iteration already restored
                    continue
                skip = 0
                self.model.epoch += 1
                self.batch_in_epoch = 0
                for lst in getattr(self.model, "listeners", ()):
                    if hasattr(lst, "on_epoch_end"):
                        lst.on_epoch_end(self.model)
                if self.manager is not None:
                    self.manager.maybe_save(self.model, metadata=self._save_meta(0),
                                            **self._checkpoint_kwargs())
                self._epoch_boundary()
            return self.model
        finally:
            self._restore_signals()
            if self.manager is not None:
                self.manager.wait()

    def _resume(self) -> int:
        """Restore full state if a checkpoint exists; otherwise apply the
        fresh-start normalizer and (optionally) commit an initial
        checkpoint so rollback and preemption always have a floor.
        Returns the number of batches to fast-forward in the current
        epoch."""
        if self.wrapper is not None:
            self.wrapper._place_model()     # restore at the placed layout
        meta = None
        if (self.auto_resume and self.manager is not None
                and self.manager.latest_step() is not None):
            meta = self.manager.restore(self.model)
        if meta is not None:
            self.resumed_from = meta
            if self.normalizer is None and meta.get("normalizer"):
                self.normalizer = normalizer_from_meta(meta["normalizer"])
            if self.normalizer is not None and hasattr(self.model, "set_normalizer"):
                self.model.set_normalizer(self.normalizer)
            self.batch_in_epoch = int(meta.get("batch_in_epoch", 0))
            return self.batch_in_epoch
        if self.normalizer is not None and hasattr(self.model, "set_normalizer"):
            self.model.set_normalizer(self.normalizer)
        if self.manager is not None and self.save_initial:
            self.manager.save(self.model, metadata=self._save_meta(0), block=True,
                              **self._checkpoint_kwargs())
        return 0

    def _epoch_boundary(self) -> None:
        """Hook between epochs (after the boundary checkpoint): the safe
        point where :class:`ElasticTrainer` admits replacement workers.
        No-op here."""

    def _run_epoch(self, data, skip: int, fused_steps: int) -> None:
        if fused_steps > 1:
            self._run_epoch_fused(data, skip, fused_steps)
            return
        for i, ds in enumerate(data):
            if i < skip:
                continue
            epoch = int(self.model.epoch)
            if (epoch, i) in self._skip_batches:
                self.batch_in_epoch = i + 1
                continue
            if self.guard is not None:
                thr = self.guard.grad_norm_threshold
                if thr is not None:
                    norm = self.guard.grad_norm(self.model, ds)
                    if norm is not None and norm > thr:
                        self._flag_divergence(f"gradient norm {norm:g} > {thr:g}", i,
                                              stepped=False)
                        self.batch_in_epoch = i + 1
                        continue
                if self.guard.policy == "skip":
                    self._snapshot_prev()
            self._fit_one(ds)
            self.batch_in_epoch = i + 1
            if self.guard is not None:
                reason = self.guard.check(float(self.model.score()))
                if reason is not None:
                    self._flag_divergence(reason, i, stepped=True)
            self._step_end()

    def _run_epoch_fused(self, data, skip: int, k: int) -> None:
        """Blocks of k batches, each through the model's own fused path
        (``_fit_epoch_fused``: one replay a full same-shape block, single
        steps for the rest), a recovery point after each block."""
        from deeplearning4j_tpu_torch.utils.scan_fit import blocks_of

        def remaining():
            for i, ds in enumerate(data):
                if i >= skip:
                    yield ds
        n_done = skip
        for block in blocks_of(remaining(), k):
            self.model._fit_epoch_fused(block, k)
            n_done += len(block)
            self.batch_in_epoch = n_done
            self._step_end()

    def _step_end(self) -> None:
        for hook in self.hooks:
            hook(self)
        if self._preempt_signum is not None:
            signum = self._preempt_signum
            if self.manager is not None:
                self.manager.save(self.model, metadata=self._save_meta(self.batch_in_epoch),
                                  block=True, **self._checkpoint_kwargs())
            self._ins.preemptions.inc()
            raise Preempted(
                f"preemption signal {signum}: checkpointed at iteration "
                f"{self.model.iteration} and exiting", signum)
        if self.manager is not None:
            self.manager.maybe_save(self.model, metadata=self._save_meta(self.batch_in_epoch),
                                    **self._checkpoint_kwargs())

    # ---- divergence handling ----
    def _flag_divergence(self, reason: str, batch_idx: int, stepped: bool) -> None:
        assert self.guard is not None
        self.guard.events += 1
        self._ins.divergence_events.inc()
        if self.guard.events > self.guard.max_events:
            raise DivergenceError(
                f"divergence guard exhausted ({self.guard.max_events} events); "
                f"last: {reason}")
        if self.guard.policy == "skip":
            if stepped:
                self._restore_prev()    # discard the poisoned update
            return
        # rollback: remember the offender so the replay skips it (the
        # replay is deterministic: it would diverge at the same batch)
        self._skip_batches.add((int(self.model.epoch), batch_idx))
        if self.manager is None or self.manager.latest_step() is None:
            raise DivergenceError(f"rollback requested ({reason}) but no checkpoint exists")
        meta = self.manager.restore(self.model)
        self._ins.rollbacks.inc()
        raise _Rollback(skip=int(meta.get("batch_in_epoch", 0)))


# ---------------------------------------------------------------------------
# Elastic trainer: gang reformation -> checkpoint-coordinated resume
# ---------------------------------------------------------------------------

class ElasticTrainer(FaultTolerantTrainer):
    """Fault-tolerant fit loop that survives gang membership changes.

    Runs on every member of an elastic gradient-sharing gang
    (``HierarchicalGradientSharing(elastic=True)``).  When a peer dies,
    partitions or straggles, the mesh re-forms under a new generation and
    the exchange raises ``GangReformed``: this trainer catches it,
    rebuilds the codec state (fresh error-feedback residuals and
    thresholds: the rewind discards the steps that built them, so
    flushing would count gradient mass twice), restores the coordinated
    checkpoint step every member was told to rewind to, in place,
    fast-forwards the iterator and continues at the new world size.  A
    ``GangReformed`` between the two halves of a split step leaves the
    step uncounted (the iteration, the device counters and the listeners
    move only after the apply half), and the rewind restores the state the
    grad half wrote.

    Policies (coordinator side, `policy=`):

    * ``"shrink"`` (default): keep training at the reduced world; parked
      replacement workers are admitted at the next EPOCH BOUNDARY after a
      fresh blocking checkpoint, so the grown gang starts from the same
      state.
    * ``"block"``: right after a shrink the coordinator waits up to
      `rejoin_wait_s` for a replacement and admits it at the same resume
      step; the peers' heartbeats keep flowing from the reactor thread,
      so their blocked exchanges never false-positive meanwhile.

    Only the coordinator (rank 0) should own a WRITING manager
    (`save_every_steps` set); peers pass a manager on the same shared
    directory with ``save_every_steps=None`` and ``save_initial=False``
    so they restore from it but never race rank 0's writes.

    `control_dir` opts into externally requested shrinks: the
    coordinator polls the directory each step for a
    ``shrink-request.json``; on one, it commits a blocking checkpoint,
    evicts the requested rank at that coordinated resume step
    (`request_evict`: the victim raises ``GangEvictedError`` and parks;
    the survivors catch ``GangReformed`` and rewind bit for bit) and
    atomically writes ``shrink-ack.json`` with the resume step and the new
    generation.
    """

    SHRINK_REQUEST = "shrink-request.json"
    SHRINK_ACK = "shrink-ack.json"

    def __init__(self, model, manager: Optional[CheckpointManager] = None, *,
                 policy: str = "shrink", rejoin_wait_s: float = 30.0,
                 control_dir: Optional[str] = None, **kwargs):
        super().__init__(model, manager, **kwargs)
        if policy not in ("shrink", "block"):
            raise ValueError(f"policy must be 'shrink' or 'block', got {policy!r}")
        self.policy = policy
        self.rejoin_wait_s = float(rejoin_wait_s)
        self.control_dir = control_dir
        self.reformations: List[Dict[str, Any]] = []
        self._gang = gang_instruments()
        sharing = self._sharing()
        if sharing is not None and manager is not None \
                and hasattr(sharing, "set_resume_step_provider"):
            # the REFORM frame carries rank 0's newest checkpoint step, so
            # every survivor rewinds to the same state
            sharing.set_resume_step_provider(manager.latest_step)

    def _sharing(self):
        return getattr(self.model, "_grad_sharing", None)

    # ---- reformation handling ----
    def _run_epoch(self, data, skip: int, fused_steps: int) -> None:
        from deeplearning4j_tpu_torch.parallel.transport import GangReformed
        try:
            super()._run_epoch(data, skip, fused_steps)
        except GangReformed as e:
            new_skip = self._on_reform(e)
            raise _Rollback(skip=new_skip)

    def _on_reform(self, e) -> int:
        """Rebuild the sharing state and rewind to the coordinated resume
        step; returns the iterator fast-forward count."""
        t0 = time.perf_counter()
        sharing = self._sharing()
        if sharing is not None:
            sharing.rebuild(flush_residuals=False)
        skip = self._restore_at(e.resume_step)
        if self.policy == "block" and sharing is not None \
                and sharing.rank == 0 and e.cause != "join":
            if sharing.wait_for_joiner(self.rejoin_wait_s) \
                    and sharing.admit_joiners(e.resume_step) is not None:
                # admission moved the generation on again; start the grown
                # gang from fresh codec state like everyone else
                sharing.rebuild(flush_residuals=False)
        resume_ms = (time.perf_counter() - t0) * 1000.0
        self._gang.resume_ms.observe(resume_ms)
        self.reformations.append({
            "cause": e.cause, "generation": e.generation, "world": e.world,
            "rank": e.rank, "resume_step": e.resume_step,
            "detection_ms": e.detection_ms, "resume_ms": resume_ms})
        return skip

    def _restore_at(self, step: int) -> int:
        if self.manager is None:
            return 0
        meta = self.manager.restore(self.model, step=step)
        if meta is None:
            return 0
        self.resumed_from = meta
        if self.normalizer is None and meta.get("normalizer"):
            self.normalizer = normalizer_from_meta(meta["normalizer"])
        if self.normalizer is not None and hasattr(self.model, "set_normalizer"):
            self.model.set_normalizer(self.normalizer)
        self.batch_in_epoch = int(meta.get("batch_in_epoch", 0))
        return self.batch_in_epoch

    # ---- externally requested shrink ----
    def _step_end(self) -> None:
        self._poll_shrink_request()
        super()._step_end()

    def _poll_shrink_request(self) -> None:
        """Coordinator side: honor a pending `shrink-request.json` from the
        control directory.  The blocking checkpoint commits BEFORE the
        eviction, so whatever happens next (the victim already dead, the
        requester gone, the coordinator's own GangReformed) training
        rewinds to an intact coordinated step."""
        if self.control_dir is None or self.manager is None:
            return
        sharing = self._sharing()
        if sharing is None or sharing.rank != 0 or not hasattr(sharing, "request_evict"):
            return
        req_path = os.path.join(self.control_dir, self.SHRINK_REQUEST)
        if not os.path.exists(req_path):
            return
        try:
            with open(req_path) as f:
                req = json.load(f)
        except (OSError, ValueError):
            return                  # mid-write; picked up next step
        victim = int(req.get("rank", sharing.world - 1))
        if not (0 < victim < sharing.world):
            ack = {"request_id": req.get("id"),
                   "error": f"rank {victim} not evictable (world {sharing.world})"}
        else:
            self.manager.save(self.model, metadata=self._save_meta(self.batch_in_epoch),
                              block=True, **self._checkpoint_kwargs())
            step = int(self.manager.latest_step() or 0)
            info = sharing.request_evict(victim, resume_step=step, cause="shrink") or {}
            ack = {"request_id": req.get("id"), "resume_step": step,
                   "generation": info.get("generation"), "world": info.get("world"),
                   "rank": victim}
        ack_path = os.path.join(self.control_dir, self.SHRINK_ACK)
        tmp = ack_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(ack, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, ack_path)
        try:
            os.remove(req_path)
        except OSError:
            pass

    # ---- joiner admission (shrink policy: epoch boundary) ----
    def _epoch_boundary(self) -> None:
        sharing = self._sharing()
        if sharing is None or not sharing.has_pending_joiner() \
                or sharing.rank != 0 or self.manager is None:
            return
        # a fresh blocking checkpoint: the exact state the grown gang
        # (the joiner included) starts from
        self.manager.save(self.model, metadata=self._save_meta(0), block=True,
                          **self._checkpoint_kwargs())
        step = self.manager.latest_step()
        info = sharing.admit_joiners(int(step))
        if info is None:
            return
        sharing.rebuild(flush_residuals=False)
        skip = self._restore_at(int(step))
        self.batch_in_epoch = skip
        self.reformations.append({
            "cause": "join", "generation": info["generation"], "world": info["world"],
            "rank": 0, "resume_step": int(step), "detection_ms": None, "resume_ms": None})
