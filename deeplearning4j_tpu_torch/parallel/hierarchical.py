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

**A host of several ranks.**  A JAX gang member is one process over a
local mesh of ``devices_per_process`` devices; in the port it is a *host*
(``multihost.LocalLauncher(n, d, gang=True)``): ``d`` one-card ranks with
a process group of their own, over which the wrapper's mesh, its
data-parallel sum and ZeRO-1 run unchanged.  The mesh's first rank, the
host's local rank 0, is its *leader* (:class:`HostLink`): it alone builds
the codecs (so the residuals live on it, as in the one JAX process) and
joins the gang, as gang rank ``host_index``; the gang's world is the
number of hosts.  A split step on a host (``exchange(grads, host=...)``):

1. every rank runs the grad half (under ZeRO-1 the reduce-scatter);
2. the leader gathers the host's shards of each reduce-scattered leaf
   into the whole padded leaf (one ``gather`` of one flat buffer: what a
   JAX host's ``np.asarray`` of a sharded global array gives), takes the
   tree to the host as f32 in the JAX layouts and runs the exchange above,
   so its frames are a JAX process's with the same local mesh;
3. the combined gradient goes back to the host's ranks as one broadcast of
   one flat f32 buffer, or under ZeRO-1 one scatter (each rank its rows of
   the sharded leaves, and the whole of the others); a status word leads
   the buffer, so a failed exchange (a lost peer) raises on every rank of
   the host, not only on the leader.

No other rank opens a gang socket or records the ``comms_*`` series.
``elastic=True`` on a host of more than one rank raises
``NotImplementedError``: the elastic gang's members are one-rank hosts.
``elastic=True`` forms the gang over
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

#: the host layout of the launchers (``parallel/multihost.py``)
ENV_DPP = "DL4J_TPU_DEVICES_PER_PROCESS"
ENV_LOCAL = "DL4J_TPU_LOCAL_RANK"


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


def _buffer_len(shapes) -> int:
    """A send-back buffer's f32 words: the status word and every leaf."""
    return 1 + sum(int(np.prod(s, dtype=np.int64)) for s in shapes)


class HostLink:
    """The ranks of one host as the gang sees them: a mesh over more than
    one rank (the wrapper's), whose first rank leads.  Its collectives run
    over the mesh's group on every rank of it; each moves one flat f32
    buffer."""

    def __init__(self, mesh):
        self.mesh = mesh

    @property
    def leader(self) -> bool:
        return self.mesh.rank == 0

    @property
    def size(self) -> int:
        return self.mesh.size

    @torch.no_grad()
    def gather(self, shards):
        """Row shards of leaves (rank r holds block r of each leaf's dim 0,
        every rank with the same shapes) to the leader as whole leaves, the
        blocks in rank order; None on the other ranks."""
        import torch.distributed as dist
        flat = torch.cat([t.reshape(-1).to(torch.float32) for t in shards])
        bufs = [torch.empty_like(flat) for _ in range(self.size)] if self.leader else None
        dist.gather(flat, bufs, dst=self.mesh.src, group=self.mesh.group_all)
        if not self.leader:
            return None
        out, off = [], 0
        for t in shards:
            n = t.numel()
            out.append(torch.cat([b[off:off + n].view(tuple(t.shape)) for b in bufs]))
            off += n
        return out

    @torch.no_grad()
    def send_back(self, combined, shapes, rows, device):
        """The leader's combined leaves (f32 numpy, the row-sharded ones
        whole) to every rank of the host: each rank gets the whole of the
        leaves with `rows` False and its own block of the others, at
        `shapes` (this rank's).  One broadcast, or one scatter where any
        leaf is row-sharded.  Returns this rank's leaves, f32 tensors on
        `device`."""
        bufs = (torch.from_numpy(self._payloads(combined, shapes, rows)).to(device)
                if self.leader else None)
        recv = self._deliver(bufs, shapes, rows, device)
        if recv[0].item() != 0.0:
            self._raise_failure()
        out, off = [], 1
        for s in shapes:
            k = int(np.prod(s, dtype=np.int64))
            out.append(recv[off:off + k].view(s))
            off += k
        return out

    def _deliver(self, bufs, shapes, rows, device) -> torch.Tensor:
        """The collective of `send_back` and `fail`: the leader's row of
        `bufs` to every rank (broadcast), or row r to rank r (scatter)."""
        import torch.distributed as dist
        src, group = self.mesh.src, self.mesh.group_all
        if not any(rows):
            recv = bufs[0] if self.leader else torch.empty(
                _buffer_len(shapes), dtype=torch.float32, device=device)
            dist.broadcast(recv, src, group=group)
            return recv
        recv = torch.empty(_buffer_len(shapes), dtype=torch.float32, device=device)
        dist.scatter(recv, list(bufs) if self.leader else None, src=src, group=group)
        return recv

    def _payloads(self, combined, shapes, rows) -> np.ndarray:
        """[ranks, 1 + elements] f32 (one row where nothing is
        row-sharded): a zero status word, then each leaf in order, whole
        or the rank's block of its dim 0."""
        ranks = self.size if any(rows) else 1
        out = np.empty((ranks, _buffer_len(shapes)), np.float32)
        out[:, 0] = 0.0
        off = 1
        for a, s, row in zip(combined, shapes, rows):
            a = np.asarray(a, np.float32)
            k = int(np.prod(s, dtype=np.int64))
            for r in range(ranks):
                out[r, off:off + k] = (a[r * s[0]:(r + 1) * s[0]] if row else a).reshape(-1)
            off += k
        return out

    @torch.no_grad()
    def fail(self, error: BaseException, shapes, rows, device) -> None:
        """The leader's half of a failed exchange: buffers whose status
        word is 1 (the collective the ranks wait in), then the error as an
        object broadcast over the host."""
        import torch.distributed as dist
        bufs = torch.zeros((self.size if any(rows) else 1, _buffer_len(shapes)),
                           dtype=torch.float32, device=device)
        bufs[:, 0] = 1.0
        self._deliver(bufs, shapes, rows, device)
        dist.broadcast_object_list([f"{type(error).__name__}: {error}"], self.mesh.src,
                                   group=self.mesh.group_all,
                                   device=device if device.type == "cuda" else None)

    def _raise_failure(self):
        import torch.distributed as dist
        got = [None]
        dist.broadcast_object_list(got, self.mesh.src, group=self.mesh.group_all,
                                   device=self.mesh.device
                                   if self.mesh.device.type == "cuda" else None)
        raise RuntimeError(f"the host's leader (global rank {self.mesh.src}) failed its "
                           f"gang exchange: {got[0]}")


def host_link(mesh) -> Optional[HostLink]:
    """The host link of a data-parallel mesh: None for a one-rank mesh (the
    process is its own host)."""
    if mesh is None or not mesh.distributed or mesh.size == 1:
        return None
    return HostLink(mesh)


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
        if _env_int(ENV_DPP, 1) > 1 and _env_int(ENV_LOCAL, 0) != 0:
            raise RuntimeError(
                f"local rank {_env_int(ENV_LOCAL, 0)} of a host of {_env_int(ENV_DPP, 1)} "
                "ranks: only the host's leader joins the gang (share gradients through "
                "ParallelWrapper over the host's group)")
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

    def exchange(self, grads: Tree, host: Optional[HostLink] = None, rows=None) -> Tree:
        """The host's gradient tree (tensors or arrays, in the JAX
        package's layouts) in, the gang-combined tree out.  Without `host`
        (a one-rank host) the leaves come out as f32 numpy arrays (the apply
        half puts them back on the device).  With `host`, every rank of it
        calls this with its tree, `rows` (a tree of bools, or None) marking
        the leaves it holds a dim-0 block of; the leader gathers, exchanges
        and sends back (the module docstring), and the leaves come out as
        f32 tensors on this rank's device, the marked ones as this rank's
        block."""
        if host is None:
            return self._exchange_tree(grads)
        return self._exchange_host(grads, host, rows)

    def _exchange_host(self, grads: Tree, host: HostLink, rows) -> Tree:
        if self.config.elastic:
            raise NotImplementedError(
                "elastic gradient sharing on a host of more than one rank is not "
                "ported: an elastic gang's members are one-rank hosts")
        leaves, treedef = tree_flatten(grads)
        flags = [False] * len(leaves) if rows is None else [bool(r) for r in
                                                            tree_flatten(rows)[0]]
        shapes = [tuple(l.shape) for l in leaves]
        device = host.mesh.device
        marked = [i for i, f in enumerate(flags) if f]
        whole = host.gather([leaves[i] for i in marked]) if marked else []
        combined = None
        if host.leader:
            full = list(leaves)
            for i, w in zip(marked, whole):
                full[i] = w
            try:
                combined, _ = tree_flatten(self._exchange_tree(tree_unflatten(treedef, full)))
            except BaseException as e:
                host.fail(e, shapes, flags, device)
                raise
        else:
            self.exchanges += 1
        return tree_unflatten(treedef, host.send_back(combined, shapes, flags, device))

    def _exchange_tree(self, grads: Tree) -> Tree:
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
