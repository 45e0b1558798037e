"""Hierarchical gradient sharing: a gradient combined across a gang of
processes over TCP, dense f32 or threshold-compressed with error feedback
(the port of ``parallel/hierarchical.py``).

Reference: ParallelWrapper's Aeron threshold GradientSharing at the scale
of hosts.  The JAX package has two links: ICI inside a host's mesh, where
XLA's all-reduce runs inside the compiled step, and DCN between hosts,
which this module compresses.  In the port the first role is the
data-parallel group of one host (``torch.distributed``, NCCL: the
wrapper's ranks), and the second the *gang*: processes coupled only by
the TCP gradient mesh (``transport.TcpGradientMesh``), which forms no
``torch.distributed`` group of its own.  One training step splits in two
halves (``set_gradient_sharing`` on the networks):

1. the grad half: forward, backward and the data-parallel sum over the
   host's group (under ZeRO-1 the reduce-scatter), no update;
2. the exchange (this module, on the host): the gradient tree goes to the
   host as f32 in the JAX package's layouts, is threshold-encoded (the
   residuals carried per process by the codecs) or packed dense, is
   all-gathered over the mesh, every rank's stream is decoded and the
   results are summed in rank order from rank 0's (then scaled by
   ``np.float32(1 / world)`` for ``combine="mean"``), so every rank gets
   the same bits;
3. the apply half: gradient normalization, the updater and the weight
   decay on the combined gradient.

Error feedback gives the convergence: what a threshold cuts this step the
residual emits later, so the sum over steps of the applied gradients
tracks the true sum.  ``world == 1`` needs no sockets: the codec round
trip still runs.

This slice supports a gang member of one card, or any wrapper world with
a gang of world 1.  A wrapper world above 1 together with a gang world
above 1 needs a host subgroup and a leader, which are not ported
(:func:`check_composable` raises).  ``elastic=True`` forms the gang over
``transport.ElasticGradientMesh`` instead: a member lost to a crash, a
partition or a straggle re-forms the gang under a new generation, and the
exchange raises ``GangReformed`` on every survivor for
``train.resilience.ElasticTrainer`` to rewind; a replacement started with
``join=True`` (``DL4J_TPU_JOIN=1``) is parked until the coordinator admits
it, and the coordinator can evict a rank (the joiner and evict
pass-throughs below).
"""
from __future__ import annotations

import dataclasses
import os
import time
from typing import Any, Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch.parallel.compression import tree_flatten, tree_unflatten

ENV_PID = "DL4J_TPU_PROCESS_ID"
ENV_NPROC = "DL4J_TPU_NUM_PROCESSES"
ENV_GRAD_PORT = "DL4J_TPU_GRADIENT_PORT"
ENV_GRAD_HOST = "DL4J_TPU_GRADIENT_HOST"
ENV_HEARTBEAT = "DL4J_TPU_HEARTBEAT_S"
ENV_DEADLINE = "DL4J_TPU_FAILURE_DEADLINE_S"
ENV_JOIN = "DL4J_TPU_JOIN"

Tree = Any


def _env_int(name: str, default: int) -> int:
    v = os.environ.get(name)
    return default if v in (None, "") else int(v)


def _env_float(name: str, default: float) -> float:
    v = os.environ.get(name)
    return default if v in (None, "") else float(v)


def _env_bool(name: str, default: bool) -> bool:
    v = os.environ.get(name)
    if v in (None, ""):
        return default
    return v.strip().lower() in ("1", "true", "yes", "on")


@dataclasses.dataclass(frozen=True)
class HierarchicalGradientSharing:
    """Config of the gang's gradient exchange.

    `rank`/`world`/`port`/`host` default to the ``DL4J_TPU_*`` environment
    the launchers export (read at `resolve()` time, not at import), so a
    worker script passes the config through.  `compressed=False` selects
    the dense f32 wire path: the same topology, no codec (the A/B
    baseline).  `combine="mean"` divides the gang's sum by `world`, the
    global-mean gradient; `combine="sum"` keeps the reference
    accumulator's raw sum."""

    threshold: float = 1e-3
    adaptive_target_density: float = 1e-2
    compressed: bool = True
    combine: str = "mean"             # "mean" | "sum"
    rank: Optional[int] = None        # default: env, else 0
    world: Optional[int] = None       # default: env, else 1
    port: Optional[int] = None        # default: env, else 49152
    host: Optional[str] = None        # default: env, else 127.0.0.1
    timeout: float = 60.0
    # elastic gang membership: heartbeat failure detection and
    # generation-fenced reformation instead of fail-stop
    elastic: bool = False
    heartbeat_interval_s: Optional[float] = None   # env, else 0.25
    failure_deadline_s: Optional[float] = None     # env, else 5.0
    join: Optional[bool] = None       # env DL4J_TPU_JOIN, else False

    def __post_init__(self):
        if self.combine not in ("mean", "sum"):
            raise ValueError(f"combine must be 'mean' or 'sum', got {self.combine!r}")

    def resolve(self) -> "HierarchicalGradientSharing":
        """Fill rank/world/port/host (and the elastic knobs) from the
        launcher's environment."""
        return dataclasses.replace(
            self,
            rank=self.rank if self.rank is not None else _env_int(ENV_PID, 0),
            world=self.world if self.world is not None else _env_int(ENV_NPROC, 1),
            port=self.port if self.port is not None else _env_int(ENV_GRAD_PORT, 49152),
            host=self.host if self.host is not None
            else os.environ.get(ENV_GRAD_HOST, "127.0.0.1"),
            heartbeat_interval_s=self.heartbeat_interval_s
            if self.heartbeat_interval_s is not None else _env_float(ENV_HEARTBEAT, 0.25),
            failure_deadline_s=self.failure_deadline_s
            if self.failure_deadline_s is not None else _env_float(ENV_DEADLINE, 5.0),
            join=self.join if self.join is not None else _env_bool(ENV_JOIN, False))


def _host_f32(grads: Tree) -> Tree:
    """The gradient tree on the host as f32 numpy (``np.asarray(g,
    np.float32)`` of each leaf).  Tensors cross in one copy: cast to f32
    and laid end to end on their device, then split on the host."""
    leaves, treedef = tree_flatten(grads)
    tensors = [i for i, l in enumerate(leaves) if isinstance(l, torch.Tensor)]
    out = [None if isinstance(l, torch.Tensor) else np.asarray(l, np.float32)
           for l in leaves]
    if tensors:
        flat = torch.cat([leaves[i].detach().reshape(-1).to(torch.float32)
                          for i in tensors]).cpu().numpy()
        off = 0
        for i in tensors:
            n = leaves[i].numel()
            out[i] = flat[off:off + n].reshape(tuple(leaves[i].shape))
            off += n
    return tree_unflatten(treedef, out)


class HierarchicalAllReduce:
    """The host-side exchange runtime one model owns.

    Builds the per-leaf codecs lazily from the first gradient tree it sees
    (that fixes the leaves and their shapes) and the TCP mesh (none when
    `world == 1`).  ``exchange(grads)`` is the whole gang phase: device to
    host, encode (or pack dense), all-gather, decode, sum, combine and the
    metrics.  One exchange at a time: not thread-safe."""

    def __init__(self, config: HierarchicalGradientSharing):
        self.config = config.resolve()
        self._exchange = None          # CompressedGradientExchange
        self._mesh = None              # TcpGradientMesh | ElasticGradientMesh
        self._ready = False
        self._instr = None
        self._template = None
        self._resume_step_provider = None
        self._last_wire_bytes = 0
        self._last_ratio = 1.0
        self.exchanges = 0

    @property
    def rank(self) -> int:
        # an elastic reformation remaps the rank in place
        return self._mesh.rank if self._mesh is not None else self.config.rank

    @property
    def world(self) -> int:
        return self._mesh.world if self._mesh is not None else self.config.world

    @property
    def mesh(self):
        return self._mesh

    def set_resume_step_provider(self, fn) -> None:
        """Coordinator side: the callable returning the checkpoint step
        every member resumes from after a reformation (``ElasticTrainer``
        wires ``CheckpointManager.latest_step``)."""
        self._resume_step_provider = fn
        if self._mesh is not None and hasattr(self._mesh, "resume_step_provider"):
            self._mesh.resume_step_provider = fn

    def _ensure(self, grads: Tree) -> None:
        if self._ready:
            return
        from deeplearning4j_tpu_torch.monitor.instrument import comms_instruments
        self._instr = comms_instruments()
        leaves, treedef = tree_flatten(grads)
        self._template = tree_unflatten(
            treedef, [np.zeros(np.shape(g), np.float32) for g in leaves])
        if self.config.compressed:
            self._build_exchange()
        if self.config.elastic:
            from deeplearning4j_tpu_torch.parallel.transport import (ElasticGradientMesh,
                                                                     GangReformed)
            c = self.config
            self._mesh = ElasticGradientMesh(
                rank=c.rank, world=c.world, port=c.port, host=c.host, timeout=c.timeout,
                heartbeat_interval=c.heartbeat_interval_s,
                failure_deadline=c.failure_deadline_s, join=bool(c.join),
                resume_step_provider=self._resume_step_provider)
            if c.join and self._mesh.join_info is not None:
                # a replacement learns its resume point only at admission:
                # surface it as a reformation, so the trainer restores the
                # checkpoint the survivors rewound to
                self._ready = True
                raise GangReformed({
                    "generation": self._mesh.generation, "world": self._mesh.world,
                    "rank": self._mesh.rank, "rank_map": {self._mesh.rank: self._mesh.rank},
                    "lost": [], "cause": "join",
                    "resume_step": self._mesh.join_info.get("resume_step", 0)})
        elif self.config.world > 1:
            from deeplearning4j_tpu_torch.parallel.transport import TcpGradientMesh
            self._mesh = TcpGradientMesh(
                rank=self.config.rank, world=self.config.world, port=self.config.port,
                host=self.config.host, timeout=self.config.timeout)
        self._ready = True

    def _build_exchange(self) -> None:
        from deeplearning4j_tpu_torch.parallel.compression import CompressedGradientExchange
        self._exchange = CompressedGradientExchange(
            self._template, threshold=self.config.threshold,
            adaptive_target_density=self.config.adaptive_target_density)

    def rebuild(self, flush_residuals: bool = False) -> None:
        """Fresh codecs (zero residuals, thresholds back at the configured
        start), as a rewind to a checkpoint needs; `flush_residuals=True`
        carries the old error-feedback mass into them instead."""
        if self._template is None or not self.config.compressed:
            return
        old = self._exchange
        self._build_exchange()
        if flush_residuals and old is not None:
            self._exchange.flush_into(old.residuals())

    def exchange(self, grads: Tree) -> Tree:
        """The host group's gradient tree (tensors or arrays, in the JAX
        package's layouts) in, the gang-combined tree out (f32 numpy
        leaves; the apply half puts them back on the device)."""
        t0 = time.perf_counter()
        host_grads = _host_f32(grads)
        self._ensure(host_grads)
        mesh = self._mesh
        sent0 = mesh.bytes_sent + mesh.bytes_received if mesh else 0
        if self.config.compressed:
            total = self._exchange_compressed(host_grads)
            ratio = self._last_ratio
        else:
            total = self._exchange_dense(host_grads)
            ratio = 1.0
        if mesh is not None:
            self._last_wire_bytes = mesh.bytes_sent + mesh.bytes_received - sent0
        w = self.world                 # changes under elastic membership
        if self.config.combine == "mean" and w > 1:
            inv = np.float32(1.0 / w)
            leaves, treedef = tree_flatten(total)
            total = tree_unflatten(treedef, [a * inv for a in leaves])
        self.exchanges += 1
        self._instr.record_exchange(time.perf_counter() - t0, self._last_wire_bytes,
                                    ratio, self.config.compressed)
        return total

    def _exchange_compressed(self, host_grads: Tree) -> Tree:
        from deeplearning4j_tpu_torch.parallel.compression import _tree_add
        from deeplearning4j_tpu_torch.parallel.transport import pack_streams, unpack_streams
        ex = self._exchange
        streams = ex.encode(host_grads)
        self._last_ratio = ex.compression_ratio(streams)
        if self._mesh is None:
            # one process: the codec round trip (residuals included) still
            # runs, so training behaves as a member of a larger gang
            self._last_wire_bytes = sum(4 * (len(s) + 1) for s in streams)
            return ex.decode(streams, ex.thresholds())
        payload = pack_streams(streams, ex.thresholds())
        total = None
        for peer_payload in self._mesh.allgather(payload):
            peer_streams, peer_thr = unpack_streams(peer_payload)
            dense = ex.decode(peer_streams, peer_thr)
            total = dense if total is None else _tree_add(total, dense)
        return total

    def _exchange_dense(self, host_grads: Tree) -> Tree:
        if self._mesh is None:
            leaves, _ = tree_flatten(host_grads)
            self._last_wire_bytes = sum(4 * l.size for l in leaves)
            return host_grads
        from deeplearning4j_tpu_torch.parallel.compression import allreduce_dense
        return allreduce_dense(self._mesh, host_grads)

    # ---- elastic joiner admission and eviction (coordinator only) ----
    def has_pending_joiner(self) -> bool:
        return self._mesh is not None and \
            getattr(self._mesh, "has_pending_joiner", lambda: False)()

    def wait_for_joiner(self, timeout: float) -> bool:
        if self._mesh is None or not hasattr(self._mesh, "wait_for_joiner"):
            return False
        return self._mesh.wait_for_joiner(timeout)

    def admit_joiners(self, resume_step: int):
        """Admit parked replacements (the generation moves on and the peers
        raise ``GangReformed``).  Returns the reform info, or None; the
        caller (``ElasticTrainer``) rebuilds the codecs and restores the
        checkpoint on the coordinator itself."""
        if self._mesh is None or not hasattr(self._mesh, "admit_joiners"):
            return None
        return self._mesh.admit_joiners(resume_step)

    def request_evict(self, rank: int, resume_step=None, cause: str = "shrink"):
        """Coordinated shrink: evict `rank` at an agreed resume step.
        Returns the reform info, or None when the gang is not elastic."""
        if self._mesh is None or not hasattr(self._mesh, "request_evict"):
            return None
        return self._mesh.request_evict(rank, resume_step=resume_step, cause=cause)

    def stats(self) -> dict:
        """The last exchange's numbers (what bench.py's ``--comms``
        aggregates)."""
        mesh = self._mesh
        out = {
            "rank": self.rank,
            "world": self.world,
            "compressed": self.config.compressed,
            "exchanges": self.exchanges,
            "last_wire_bytes": self._last_wire_bytes,
            "last_compression_ratio": self._last_ratio,
            "bytes_sent_total": mesh.bytes_sent if mesh else 0,
            "bytes_received_total": mesh.bytes_received if mesh else 0,
        }
        if self.config.elastic and mesh is not None:
            out["generation"] = mesh.generation
            out["reformations"] = mesh.reformations
            out["stale_frames"] = mesh.stale_frames
        return out

    def close(self) -> None:
        if self._mesh is not None:
            self._mesh.close()
            self._mesh = None
        self._ready = False

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def as_runtime(sharing, current=None) -> Optional[HierarchicalAllReduce]:
    """What ``set_gradient_sharing`` installs: a runtime built from a
    `HierarchicalGradientSharing`, a prebuilt `HierarchicalAllReduce` as
    it is, or None.  The `current` runtime is closed (its sockets) unless
    it is the one installed again."""
    if sharing is None:
        new = None
    elif isinstance(sharing, HierarchicalGradientSharing):
        new = HierarchicalAllReduce(sharing)
    elif isinstance(sharing, HierarchicalAllReduce):
        new = sharing
    else:
        raise TypeError("set_gradient_sharing expects HierarchicalGradientSharing, "
                        f"HierarchicalAllReduce or None, got {type(sharing).__name__}")
    if current is not None and current is not new:
        current.close()
    return new


def check_composable(dp_size: int, sharing: HierarchicalAllReduce) -> None:
    """A data-parallel group of more than one rank under a gang of more
    than one process would need a host subgroup and its leader, which are
    not ported: refuse it."""
    world = sharing.world
    if dp_size > 1 and world > 1:
        raise NotImplementedError(
            f"gradient sharing over a gang of {world} processes with a data-parallel "
            f"group of {dp_size} ranks in each needs host subgroups and a leader a "
            "host, which are not ported (ROADMAP A5): run one card a gang member, or "
            "a gang of world 1")
