"""ParallelWrapper / ParallelInference: data-parallel training and
inference (the port of ``parallel/wrapper.py``).

The JAX wrapper runs one SPMD program over a mesh: the batch is split over
the ``data`` axis, the parameters are replicated, and XLA inserts the
gradient all-reduce.  Its data-parallel step is the single-device step on
the global batch, exactly.  The port runs one process per rank
(``torch.distributed``: NCCL with one card a rank, gloo on the CPU).  Every
rank builds the same network, wraps it and calls the wrapper with the same
global batch; the wrapper hands the model this rank's rows of it and
installs a data-parallel step on the model (``utils/data_parallel.py``),
which makes every reduction over the batch global: the loss means, the
gradients (summed over the group in a few flat buckets, between the
backward and the update) and BatchNormalization's statistics.  So each
rank takes the single-device step on the global batch, and the parameters
stay equal on every rank.  ``fit_steps`` is one CUDA-graph replay a block
on the card with the collectives captured in it.

The reference's sync modes (averaging, gradient sharing) both run as the
synchronous gradient all-reduce of every step; ``averaging_frequency`` and
``prefetch_buffer`` are accepted and do nothing.  Listeners, the checkpoint
listener among them, hear of each step on rank 0 only, as the JAX single
controller's do (under ``sharding_rules`` on whole leaves: every rank
gathers them for each notification).

``sharding_rules`` (``parallel/sharding.py``) adds tensor parallelism over
the mesh's ``model`` axis: a mesh ``{data: d, model: m}`` trains exactly
as plain data parallelism does.  At placement every rank keeps its block
of each leaf the rules split and of that leaf's updater state, and the
network computes with them (``sharding.TensorParallel``); the data-parallel
reductions run over the ``data`` subgroup only.  With
``optimizer_sharding`` the rules win per leaf: a split leaf keeps its
``model`` blocks, the rest are ZeRO-1's.

``gradient_sharing`` (a ``HierarchicalGradientSharing`` config) installs
hierarchical gradient sharing on the model at placement
(``parallel/hierarchical.py``): the wrapper's mesh is the host (the JAX
"ICI" role: a gang launch makes each host's ranks a process group of
their own), its first rank the leader that alone joins the gang of hosts
coupled by the TCP gradient mesh (the "DCN" role), gathering the host's
gradient and sending the combined one back to the host's ranks.  Sharing
together with sharing rules on a mesh of more than one rank raises
``NotImplementedError``: a host's split step runs over its data axis.

``ParallelInference`` runs over any mesh: the parameters replicated on
every rank (rank 0's, broadcast), the batch split over the ``data`` axis,
every other axis computing the same rows again.
"""
from __future__ import annotations

import contextlib
import time
import warnings
from typing import Any, List, Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch.monitor.instrument import ParallelInstruments
from deeplearning4j_tpu_torch.parallel import zero
from deeplearning4j_tpu_torch.parallel.mesh import Mesh, data_sharding, make_mesh
from deeplearning4j_tpu_torch.utils.data_parallel import (BUCKET_BYTES, DataParallelStep,
                                                         bucketed)


def _map_arrays(fn, x):
    """fn over the arrays of a batch: one array, a list/tuple or a dict."""
    if x is None:
        return None
    if isinstance(x, (list, tuple)):
        return type(x)(_map_arrays(fn, e) for e in x)
    if isinstance(x, dict):
        return {k: _map_arrays(fn, v) for k, v in x.items()}
    return fn(x)


def _pad_tail(a, pad: int, mode: str) -> np.ndarray:
    """Append `pad` rows: repeats of the last row (features and labels) or
    zeros (masks: padded rows add nothing to the masked loss mean)."""
    a = np.asarray(a)
    tail = (np.repeat(a[-1:], pad, axis=0) if mode == "repeat"
            else np.zeros((pad,) + a.shape[1:], a.dtype))
    return np.concatenate([a, tail], axis=0)


def _pad_partial_lists(feats, labels, lmasks, pad: int):
    """Pad a partial batch up to a size the data-parallel degree divides so
    that the step stays exact: features and labels repeat their last row,
    labels masks get zero rows (losses reduce as sum(per * mask) /
    max(sum(mask), 1), so zero-mask rows change neither the loss nor a
    gradient).  Labels without a mask get a ``[ones(b); zeros(pad)]``
    vector mask where they are 2-D; for higher-rank unmasked labels no mask
    shape is right for every loss, so this returns None and the caller
    drops the batch with a one-time warning.  The repeated rows still pass
    through the forward, so BatchNorm's batch statistics see them."""
    new_lms = []
    for i, l in enumerate(labels):
        m = lmasks[i] if lmasks is not None else None
        if m is not None:
            new_lms.append(_pad_tail(m, pad, "zero"))
        elif np.ndim(l) == 2:
            b = int(np.shape(l)[0])
            new_lms.append(np.concatenate([np.ones(b, np.float32),
                                           np.zeros(pad, np.float32)]))
        else:
            return None
    feats = [_pad_tail(f, pad, "repeat") for f in feats]
    labels = [_pad_tail(l, pad, "repeat") for l in labels]
    return feats, labels, new_lms


def _host(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _any_rank_has(listeners, mesh: Mesh) -> bool:
    """Whether any rank of the mesh holds listeners (collective)."""
    import torch.distributed as dist
    n = torch.tensor([len(listeners)], device=mesh.device)
    dist.all_reduce(n, op=dist.ReduceOp.MAX, group=mesh.group_all)
    return bool(n.item())


class _HeardWhole:
    """Every rank's one listener under tensor parallelism: each
    notification runs inside ``TensorParallel.gathered`` (an all-gather of
    the split leaves and their moments, and a cut back after), and the
    listeners it holds (rank 0's; none on the other ranks) hear it there."""

    def __init__(self, tp, listeners):
        self.tp, self.listeners = tp, list(listeners)

    def iteration_done(self, model, iteration, epoch):
        with self.tp.gathered(model):
            for lst in self.listeners:
                lst.iteration_done(model, iteration, epoch)

    def on_epoch_end(self, model):
        with self.tp.gathered(model):
            for lst in self.listeners:
                if hasattr(lst, "on_epoch_end"):
                    lst.on_epoch_end(model)


def _check_model_device(model, mesh: Mesh) -> None:
    dev = model.device
    if dev.type != mesh.device.type:
        raise ValueError(
            f"the model lives on {dev} but the mesh computes on {mesh.device}: a "
            "CUDA model needs an NCCL group, a CPU model a gloo group or none")
    if dev.type == "cuda" and (dev.index if dev.index is not None
                               else torch.cuda.current_device()) != mesh.device.index:
        raise ValueError(f"the model lives on {dev}, this rank's card is {mesh.device}")


class ParallelWrapper:
    """Data-parallel trainer wrapping a MultiLayerNetwork or
    ComputationGraph, with the reference builder's API::

        pw = (ParallelWrapper.builder(net)
              .workers(2)                      # default: every rank
              .optimizer_sharding(True)        # ZeRO-1 (parallel/zero.py)
              .build())
        pw.fit(iterator, epochs=2)
        pw.fit_steps(xs, ys)                   # [k, global batch, ...]
    """

    def __init__(self, model, mesh: Optional[Mesh] = None, data_axis: str = "data",
                 sharding_rules=None, training_mode: str = "SHARED_GRADIENTS",
                 optimizer_sharding: bool = False, gradient_sharing=None):
        self.model = model
        self._rules = sharding_rules
        self.mesh = mesh if mesh is not None else make_mesh(device=model.device)
        self.data_axis = data_axis
        self.training_mode = training_mode
        self._zero1 = bool(optimizer_sharding)
        self._sharing_cfg = gradient_sharing  # HierarchicalGradientSharing
        self._placed = False
        self._warned_drop = False
        self._instr: Optional[ParallelInstruments] = None
        _check_model_device(model, self.mesh)

    def _instruments(self) -> ParallelInstruments:
        if self._instr is None:
            self._instr = ParallelInstruments()
        return self._instr

    # ---- builder (reference ParallelWrapper.Builder) ----
    class Builder:
        def __init__(self, model):
            self._model = model
            self._workers: Optional[int] = None
            self._mesh: Optional[Mesh] = None
            self._mode = "SHARED_GRADIENTS"
            self._zero1 = False
            self._sharing = None
            self._rules = None

        def workers(self, n: int):
            self._workers = int(n); return self

        def mesh(self, m: Mesh):
            self._mesh = m; return self

        def training_mode(self, mode: str):
            # AVERAGING | SHARED_GRADIENTS | CUSTOM: all the synchronous all-reduce
            self._mode = mode; return self

        def sharding_rules(self, rules):
            """Tensor parallelism over the mesh's ``model`` axis
            (``parallel/sharding.py``)."""
            self._rules = rules; return self

        def optimizer_sharding(self, on: bool = True):
            """ZeRO-1 sharded weight update (``parallel/zero.py``)."""
            self._zero1 = bool(on); return self

        def gradient_sharing(self, cfg=True):
            """Hierarchical gradient sharing across a gang of processes
            (``parallel/hierarchical.py``): a ``HierarchicalGradientSharing``
            config, True for the environment's defaults, or None/False for
            none."""
            self._sharing = _sharing_config(cfg); return self

        def averaging_frequency(self, n: int):
            return self  # no-op: the synchronous all-reduce has no averaging lag

        def prefetch_buffer(self, n: int):
            return self  # no-op: prefetch is the data pipeline's (fit_prefetched)

        def build(self) -> "ParallelWrapper":
            mesh = self._mesh
            if mesh is None:
                mesh = make_mesh(device=self._model.device)
                if self._workers is not None and self._workers != mesh.size:
                    if self._workers > mesh.size:
                        raise ValueError(
                            f"workers({self._workers}) exceeds the world of {mesh.size} "
                            "rank(s): start one process a worker (multihost.LocalLauncher)")
                    # the first n ranks (every rank of the group calls this);
                    # the others are not workers and train nothing
                    mesh = make_mesh({"data": self._workers},
                                     devices=list(range(self._workers)),
                                     device=self._model.device)
            return ParallelWrapper(self._model, mesh, training_mode=self._mode,
                                   sharding_rules=self._rules,
                                   optimizer_sharding=self._zero1,
                                   gradient_sharing=self._sharing)

    @staticmethod
    def builder(model) -> "ParallelWrapper.Builder":
        return ParallelWrapper.Builder(model)

    # ---- placement ----
    @property
    def degree(self) -> int:
        return self.mesh.shape[self.data_axis]

    def optimizer_sharding(self, on: bool = True) -> "ParallelWrapper":
        """Turn the ZeRO-1 sharded weight update on or off; it takes effect
        at the next fit call (every rank calls this)."""
        on = bool(on)
        if on != self._zero1:
            self._zero1 = on
            if not on:
                zero.disable_zero1(self.model)
            self._placed = False
        return self

    def gradient_sharing(self, cfg) -> "ParallelWrapper":
        """Turn hierarchical gradient sharing on (a
        ``HierarchicalGradientSharing`` config, or True for the
        environment's defaults) or off (None/False) at run time; installed
        on the model now if it is placed, else at placement."""
        self._sharing_cfg = _sharing_config(cfg)
        if self._placed:
            self.model.set_gradient_sharing(self._sharing_cfg)
        return self

    def _place_model(self) -> None:
        """Once: make the parameters, layer state and updater state equal on
        every rank (rank 0's, broadcast in buckets), run a first collective
        (so an NCCL communicator exists before any capture), seed each
        rank's dropout generator apart, shard the updater state under
        ZeRO-1, install the data-parallel step and the gradient sharing
        (or remove a model's own).  Captured steps are dropped."""
        if self._placed:
            return
        m = self.model
        if getattr(m, "opt_state_", None) is None:
            raise ValueError("call init() on the model before wrapping it")
        if self._sharing_cfg is not None:
            if self._rules is not None and self.mesh.size > 1:
                raise NotImplementedError(
                    "gradient sharing with sharding rules on a mesh of more than one "
                    "rank is not ported: a host's split step runs over its data axis")
            m.set_gradient_sharing(self._sharing_cfg)
        elif getattr(m, "_grad_sharing", None) is not None:
            m.set_gradient_sharing(None)
        mesh = self.mesh
        if m._tp is not None:
            zero.disable_zero1(m)
            m._tp.unshard_(m)
            m._tp = None
        if mesh.distributed:
            import torch.distributed as dist
            dist.all_reduce(torch.zeros(1, device=mesh.device), group=mesh.group_all)
            if mesh.size > 1:
                zero.disable_zero1(m)
                _broadcast_tensors(_model_tensors(m), mesh)
                coord = mesh.coordinate(self.data_axis)
                if coord and m._dp is None and getattr(m, "_rng", None) is not None:
                    m._rng.manual_seed(m.conf.seed * 1_000_003 + coord)
        tp_leaves = frozenset()
        if self._rules is not None:
            from deeplearning4j_tpu_torch.parallel.sharding import TensorParallel, plan_shards
            zero.disable_zero1(m)
            plans = plan_shards(m, mesh, self._rules)
            if plans:
                m._tp = TensorParallel(mesh, plans)
                m._tp.shard_(m)
                tp_leaves = m._tp.leaf_keys()
        if self._zero1:
            zero.enable_zero1(m, mesh, self.data_axis, exclude=tp_leaves)
        else:
            zero.disable_zero1(m)
        n = self.degree
        m._dp = DataParallelStep(n, distributed=mesh.distributed and (n > 1 or mesh.size == 1),
                                 group=mesh.group(self.data_axis) if n > 1 else None,
                                 mesh=mesh)
        m._scan_step = None
        self._placed = True
        ins = self._instruments()
        ins.replicas.set(self.degree)
        ins.record_opt_state_bytes(zero.opt_state_bytes_per_replica(m.opt_state_),
                                   self._zero1)

    @contextlib.contextmanager
    def _listening(self):
        """Listeners hear of steps on rank 0 only.  Under tensor
        parallelism what a listener calls (``save``, ``params``,
        ``output``, ``evaluate``) is collective, so where any rank has
        listeners every rank hears each notification through
        :class:`_HeardWhole`: the network holds whole leaves for it, and
        rank 0's listeners run on them without a collective."""
        m = self.model
        kept = m.listeners
        heard = kept if self.mesh.rank == 0 else []
        if m._tp is not None and _any_rank_has(kept, self.mesh):
            heard = [_HeardWhole(m._tp, heard)]
        m.listeners = heard
        try:
            yield
        finally:
            m.listeners = kept

    def _local(self, x, batch_dim: int = 0):
        """This rank's rows of every array of a global batch."""
        place = data_sharding(self.mesh, self.data_axis, batch_dim)
        return _map_arrays(place.window, x)

    # ---- training ----
    def _warn_drop(self, b: int, n: int) -> None:
        if not self._warned_drop:
            warnings.warn(
                f"dropping final partial batch of {b} rows: not divisible by the "
                f"data-parallel degree {n} and the labels take no mask (rank > 2 "
                "without an explicit labels_mask), so mask-padding cannot express "
                "it exactly; pass a labels mask or size batches to a multiple of "
                "the mesh", stacklevel=3)
            self._warned_drop = True

    def _fit_ds(self, ds) -> None:
        """One DataSet/MultiDataSet: this rank's rows of its arrays through
        the model's step.  A final partial batch is padded exactly
        (`_pad_partial_lists`) or dropped with a one-time warning."""
        m = self.model
        n = self.degree
        if hasattr(ds, "features_masks"):                     # MultiDataSet
            if ds.features_masks is not None and any(
                    mk is not None for mk in ds.features_masks):
                raise NotImplementedError(
                    "ComputationGraph training does not consume feature masks")
            feats, labels = list(ds.features), list(ds.labels)
            lms = list(ds.labels_masks) if ds.labels_masks is not None else None
            b = int(np.shape(feats[0])[0])
            pad = (-b) % n
            if pad:
                padded = _pad_partial_lists([_host(f) for f in feats],
                                            [_host(l) for l in labels],
                                            None if lms is None else
                                            [None if mk is None else _host(mk) for mk in lms],
                                            pad)
                if padded is None:
                    self._warn_drop(b, n)
                    return
                feats, labels, lms = padded
            t0 = time.perf_counter()
            m._fit_batch(m._as_input_dict(self._local(feats)), m._as_list(self._local(labels)),
                         m._masks(self._local(lms)))
            self._instruments().record_dispatch(time.perf_counter() - t0)
            return
        fm = getattr(ds, "features_mask", None)
        lm = getattr(ds, "labels_mask", None)
        feats, labels = ds.features, ds.labels
        b = int(np.shape(feats)[0])
        pad = (-b) % n
        if pad:
            padded = _pad_partial_lists([_host(feats)], [_host(labels)],
                                        None if lm is None else [_host(lm)], pad)
            if padded is None:
                self._warn_drop(b, n)
                return
            (feats,), (labels,), (lm,) = padded
            if fm is not None:
                fm = _pad_tail(_host(fm), pad, "repeat")
        t0 = time.perf_counter()
        if hasattr(m, "_as_input_dict"):                      # a CG fed a DataSet
            if fm is not None:
                raise NotImplementedError(
                    "ComputationGraph training does not consume feature masks")
            m._fit_batch(m._as_input_dict(self._local(feats)),
                         m._as_list(self._local(labels)),
                         None if lm is None else m._masks([self._local(lm)]))
        else:
            m.fit(self._local(feats), self._local(labels),
                  features_mask=self._local(fm), labels_mask=self._local(lm))
        self._instruments().record_dispatch(time.perf_counter() - t0)

    def fit(self, data, labels=None, *, epochs: int = 1) -> "ParallelWrapper":
        """fit(x, y) on a global batch, fit(DataSet/MultiDataSet), or
        fit(iterator, epochs=N): each rank trains on its rows of every batch
        array (features, labels, masks).  On a rank outside the mesh
        (``workers(n)`` below the world) it returns at once."""
        if not self.mesh.member:
            return self
        self._place_model()
        m = self.model
        with self._listening():
            if labels is not None:
                x, y = self._local(data), self._local(labels)
                for _ in range(epochs):
                    m.fit(x, y)
                    if epochs > 1:
                        m.epoch += 1
                return self
            if hasattr(data, "features"):
                for _ in range(epochs):
                    self._fit_ds(data)
                    m.epoch += 1
                return self
            for _ in range(epochs):
                if hasattr(data, "reset"):
                    data.reset()
                for ds in data:
                    self._fit_ds(ds)
                m.epoch += 1
        return self

    def sharded_placement(self, batch_dim: int = 0):
        """Placement for ``data.pipeline`` (``stage``,
        ``DevicePrefetchIterator``, ``device_blocks``): each array staged as
        this rank's rows only, onto this rank's device."""
        return data_sharding(self.mesh, self.data_axis, batch_dim)

    def fit_prefetched(self, iterator, *, epochs: int = 1,
                       fused_steps: Optional[int] = None,
                       prefetch_depth: Optional[int] = None,
                       zero1: Optional[bool] = None) -> "ParallelWrapper":
        """Training from a host iterator through the device pipeline: each
        batch's rows for this rank staged `prefetch_depth` (2) batches
        ahead (`sharded_placement`), then the model's `fit(...,
        fused_steps=k)` (1: step by step)."""
        from deeplearning4j_tpu_torch.data.pipeline import DevicePrefetchIterator
        if zero1 is not None:
            self.optimizer_sharding(zero1)
        if not self.mesh.member:
            return self
        self._place_model()
        pf = DevicePrefetchIterator(iterator, depth=prefetch_depth or 2,
                                    placement=self.sharded_placement())
        try:
            with self._listening():
                self.model.fit(pf, epochs=epochs, fused_steps=fused_steps or 1)
        finally:
            pf.close()
        return self

    def fit_steps(self, xs, ys, *, zero1: Optional[bool] = None) -> torch.Tensor:
        """k data-parallel steps as one block: `[k, global batch, ...]`
        arrays (a stride-0 ``broadcast_to`` view included), this rank's rows
        of axis 1 through the model's `fit_steps` (one CUDA-graph replay on
        the card, the collectives captured in it).  Returns the k global
        losses (None on a rank outside the mesh)."""
        if zero1 is not None:
            self.optimizer_sharding(zero1)
        if not self.mesh.member:
            return None
        self._place_model()
        xs, ys = self._local(xs, batch_dim=1), self._local(ys, batch_dim=1)
        t0 = time.perf_counter()
        with self._listening():
            out = self.model.fit_steps(xs, ys)
        self._instruments().record_dispatch(time.perf_counter() - t0)
        return out

    def fit_host_local(self, features, labels) -> "ParallelWrapper":
        """Each rank passes its own rows of the global batch (all ranks as
        many); the same data-parallel step."""
        from deeplearning4j_tpu_torch.parallel.multihost import shard_host_local_batch
        self._place_model()
        x = shard_host_local_batch(self.mesh, features, self.data_axis)
        y = shard_host_local_batch(self.mesh, labels, self.data_axis)
        with self._listening():
            self.model.fit(x, y)
        return self

    def fit_steps_host_local(self, xs, ys) -> torch.Tensor:
        """Each rank passes its own rows of a `[k, global batch, ...]` block
        (`[k, local batch, ...]`); one block as in `fit_steps`."""
        from deeplearning4j_tpu_torch.parallel.multihost import shard_host_local_batch
        self._place_model()
        xs = shard_host_local_batch(self.mesh, xs, self.data_axis, batch_dim=1)
        ys = shard_host_local_batch(self.mesh, ys, self.data_axis, batch_dim=1)
        with self._listening():
            return self.model.fit_steps(xs, ys)

    def measure_replica_skew(self) -> float:
        """Blocking diagnostic: each rank waits for its device's queued work
        and the spread of those waits over the ranks (max - min, ms) is
        recorded in the ``parallel_replica_skew_ms`` gauge.  Host waits,
        not device timestamps: an imbalance signal, not a profiler; never
        call it inside the hot loop."""
        t0 = time.perf_counter()
        if self.mesh.device.type == "cuda":
            torch.cuda.synchronize(self.mesh.device)
        waits = [(time.perf_counter() - t0) * 1000.0]
        if self.mesh.distributed and self.mesh.size > 1:
            import torch.distributed as dist
            mine = torch.tensor(waits, dtype=torch.float64, device=self.mesh.device)
            got = [torch.empty_like(mine) for _ in range(self.mesh.size)]
            dist.all_gather(got, mine, group=self.mesh.group_all)
            waits = [float(t) for t in got]
        skew = max(waits) - min(waits)
        self._instruments().replica_skew_ms.set(skew)
        return skew

    def average_updaters(self):
        return self  # no-op: one logical updater state

    def shutdown(self):
        return self  # no-op: no trainer threads to stop


def _sharing_config(cfg):
    """The argument of `Builder.gradient_sharing` or of the run-time
    toggle: True is the environment's defaults, False or None is off, a
    config is itself."""
    if cfg is True:
        from deeplearning4j_tpu_torch.parallel.hierarchical import (
            HierarchicalGradientSharing)
        return HierarchicalGradientSharing()
    return None if cfg is False else cfg


def _model_tensors(m) -> List[torch.Tensor]:
    from deeplearning4j_tpu_torch.train.updaters import tree_leaves
    return ([p.data for p in tree_leaves(m.params_)]
            + [t for t in tree_leaves(m.state_) if isinstance(t, torch.Tensor)]
            + [t for t in tree_leaves(m.opt_state_) if isinstance(t, torch.Tensor)])


@torch.no_grad()
def _broadcast_tensors(tensors: List[torch.Tensor], mesh: Mesh) -> None:
    """The mesh's first rank's values into `tensors` on every rank of the
    mesh: one broadcast a flat bucket of one dtype."""
    import torch.distributed as dist
    for bucket in bucketed(list(enumerate(tensors)), BUCKET_BYTES):
        flat = torch.cat([t.reshape(-1) for _, t in bucket])
        dist.broadcast(flat, mesh.src, group=mesh.group_all)
        off = 0
        for _, t in bucket:
            t.copy_(flat[off:off + t.numel()].view(t.shape))
            off += t.numel()


class ParallelInference:
    """Data-parallel batched inference over any mesh: the parameters and
    layer state replicated on every rank (a tensor-parallel model's blocks
    gathered whole, then rank 0's values broadcast: the JAX package's
    replicated sharding), each data coordinate running the forward on its
    rows of the (padded) global batch and the outputs all-gathered over
    the ``data`` axis, so every rank returns the whole answer; the ranks of
    any other axis compute the same rows.  A list of requests is
    concatenated, run once and split back."""

    def __init__(self, model, mesh: Optional[Mesh] = None, data_axis: str = "data"):
        self.model = model
        self.mesh = mesh if mesh is not None else make_mesh(device=model.device)
        self.data_axis = data_axis
        _check_model_device(model, self.mesh)
        if getattr(model, "_tp", None) is not None:
            model._tp.unshard_(model)
            model._tp = None
        if self.mesh.distributed and self.mesh.size > 1 and self.mesh.member:
            from deeplearning4j_tpu_torch.train.updaters import tree_leaves
            tensors = [t.data if isinstance(t, torch.nn.Parameter) else t
                       for tree in (model.params_, model.state_)
                       for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]
            with torch.no_grad():
                _broadcast_tensors(tensors, self.mesh)

    def output(self, x):
        """Single-request or list-of-requests inference (numpy out)."""
        if isinstance(x, (list, tuple)):
            return self._output_batched(list(x))
        return self._run(np.asarray(x))

    def _run(self, x: np.ndarray) -> np.ndarray:
        n = self.mesh.shape[self.data_axis]
        if x.shape[0] == 0:
            padded = np.zeros((n,) + x.shape[1:], x.dtype)
        else:
            pad = (-x.shape[0]) % n
            padded = np.concatenate([x, np.repeat(x[-1:], pad, 0)]) if pad else x
        local = data_sharding(self.mesh, self.data_axis).window(padded)
        out = self.model.output(local)
        if isinstance(out, (list, tuple)):    # ComputationGraph
            out = out[0]
        out = out.contiguous()
        if self.mesh.distributed and n > 1:
            import torch.distributed as dist
            full = out.new_empty((padded.shape[0],) + tuple(out.shape[1:]))
            dist.all_gather_into_tensor(full, out, group=self.mesh.group(self.data_axis))
            out = full
        return out[: x.shape[0]].cpu().numpy()

    def _output_batched(self, requests: List[np.ndarray]) -> List[np.ndarray]:
        if not requests:
            return []
        requests = [np.asarray(r) for r in requests]
        trailing = requests[0].shape[1:]
        for i, r in enumerate(requests[1:], 1):
            if r.shape[1:] != trailing:
                raise ValueError(
                    f"heterogeneous request shapes: request 0 has trailing dims "
                    f"{trailing} but request {i} has {r.shape[1:]}; ParallelInference "
                    "batches same-shape requests only (serving.ModelServer routes "
                    "mixed shapes to per-shape buckets)")
        sizes = [r.shape[0] for r in requests]
        out = self._run(np.concatenate(requests, axis=0))
        res, off = [], 0
        for s in sizes:
            res.append(out[off: off + s])
            off += s
        return res


class DynamicBatchingInference:
    """Deprecated: use ``serving.ModelServer``.  A thin wrapper over the
    serving runtime's ``ContinuousBatcher``: `submit(x)` returns a
    ``concurrent.futures.Future``, `output(x)` waits for it; requests are
    grouped by trailing dims and dtype.  Each dispatch is collective over
    the mesh, so on more than one rank every rank must submit the same
    requests in the same order."""

    def __init__(self, inference: ParallelInference, max_batch: int = 32,
                 timeout_ms: float = 10.0):
        warnings.warn(
            "DynamicBatchingInference is deprecated; use "
            "deeplearning4j_tpu_torch.serving.ModelServer (shape buckets, deadlines, "
            "backpressure, SLO metrics)", DeprecationWarning, stacklevel=2)
        from deeplearning4j_tpu_torch.serving.batcher import ContinuousBatcher
        self.inference = inference
        self.max_batch = int(max_batch)
        self._batcher = ContinuousBatcher(
            lambda group, xs: inference._output_batched(xs),
            max_batch=max_batch, batch_timeout_ms=timeout_ms)

    def submit(self, x: Any):
        x = np.asarray(x)
        return self._batcher.submit(x, group=(tuple(x.shape[1:]), str(x.dtype)))

    def output(self, x: Any) -> np.ndarray:
        return self.submit(x).result()

    def shutdown(self):
        """Graceful and idempotent: drains queued requests, then stops."""
        self._batcher.shutdown(drain=True, timeout=10.0)
