"""Launching the ranks of a job, and the hosts of a gang (the port of
``parallel/multihost.py``).

The JAX package's control plane is ``jax.distributed`` and its data plane
XLA's collectives inside one SPMD program.  The port's control plane is
``torch.distributed.init_process_group`` (a TCP rendezvous at the
coordinator's address) and its data plane the collectives of the
data-parallel step: NCCL with one card a process on the card, gloo on the
CPU.  :func:`initialize` joins the group from the ``DL4J_TPU_*``
environment that :class:`LocalLauncher` sets for each process it starts.

A JAX process drives ``devices_per_process`` devices.  In the port that
process becomes a *host*: ``devices_per_process`` one-card ranks
(``LocalLauncher(n, d)`` starts ``n * d`` processes; rank ``(h, j)`` is
local rank ``j`` of host ``h``, on card ``h * d + j``).  The environment
keeps the JAX meaning of the process count and index (``n`` hosts, this
host ``h``), and adds the host's size and the local rank; inside a host
of more than one rank :func:`process_index` and :func:`process_count` are
the host's and the number of hosts, as JAX's are for processes.  Without a
gang, the ``n * d`` ranks form one process group.

A gradient-sharing gang (``parallel/hierarchical.py``) is a set of hosts
coupled only by the TCP gradient mesh: ``LocalLauncher(n, d, gang=True)``
starts one, each host with a rendezvous of its own, so the default process
group of a rank is its host's (its wrapper, ZeRO-1 and sharding rules run
over it); each host's local rank 0 leads it on the mesh, whose port
``run(..., gradient_port=)`` exports (``DL4J_TPU_GRADIENT_PORT``; the host
is ``DL4J_TPU_GRADIENT_HOST``, 127.0.0.1 by default).  The gang forms no
group across hosts, so on the card hosts may share the cards (rank ``(h,
j)`` on card ``(h * d + j) % cards``).

:class:`ElasticLocalRunner` supervises such launches.  ``run`` relaunches
the whole job after a retryable failure, each attempt on a fresh
rendezvous (and gradient-mesh) port, the workers resuming from
``DL4J_TPU_CHECKPOINT_DIR``.  ``torch.distributed`` has no coordination
service to stop the survivors of a dead rank (a survivor blocks in its
collective until the group's timeout), so the launcher stops them at the
first failure, and the failure taxonomy reads what the first failing rank
printed.  ``run_elastic`` supervises an elastic gang
(``HierarchicalGradientSharing(elastic=True)`` under
``train.resilience.ElasticTrainer``) process by process and starts a
replacement with ``DL4J_TPU_JOIN=1`` for a member that died (a gang of
one-rank hosts: ``elastic=True`` on a host of more than one rank raises).
:class:`MultiHostParallelInference` runs each process's own request rows
through the replicated model.
"""
from __future__ import annotations

import datetime
import os
import random
import shutil
import socket
import subprocess
import sys
import tempfile
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch.utils.devices import resolve_device

# environment the launcher sets and `initialize()` reads
ENV_COORD = "DL4J_TPU_COORDINATOR"
ENV_NPROC = "DL4J_TPU_NUM_PROCESSES"
ENV_PID = "DL4J_TPU_PROCESS_ID"
# a host of several ranks: its size, this rank's place in it, the card of
# this rank and whether the hosts are a gang (a process group each)
ENV_DPP = "DL4J_TPU_DEVICES_PER_PROCESS"
ENV_LOCAL = "DL4J_TPU_LOCAL_RANK"
ENV_CARD = "DL4J_TPU_CARD"
ENV_GANG = "DL4J_TPU_GANG"
ENV_PLATFORM = "DL4J_TPU_PLATFORM"
# the checkpoint directory a resilience-aware worker resumes from
ENV_CKPT = "DL4J_TPU_CHECKPOINT_DIR"
# the TCP gradient mesh of hierarchical gradient sharing (read by
# parallel/hierarchical.py; a gang needs no process group)
ENV_GRAD_PORT = "DL4J_TPU_GRADIENT_PORT"
ENV_GRAD_HOST = "DL4J_TPU_GRADIENT_HOST"


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None, device=None,
               timeout_s: Optional[float] = None) -> torch.device:
    """Join the job's process group and return this process's device.
    Arguments default to the ``DL4J_TPU_*`` environment the launcher sets
    (the platform too: ``DL4J_TPU_PLATFORM=cpu`` asks for the CPU): the
    group of a gang's host is its ``devices_per_process`` ranks, else all
    the job's ranks (:func:`group_of_env`).  On the card (``"cuda"``, the
    default) the group is NCCL's, bound to card ``DL4J_TPU_CARD`` (the
    rank by default) with its communicator made at once, so it exists
    before any CUDA-graph capture; on the CPU it is gloo's.  `timeout_s`
    bounds the rendezvous and each collective (torch's default, 10
    minutes, otherwise): a rank left waiting then fails instead of
    hanging."""
    import torch.distributed as dist
    coordinator_address = coordinator_address or os.environ.get(ENV_COORD)
    if coordinator_address is None:
        raise ValueError(f"no coordinator address: pass one or set {ENV_COORD}")
    env_size, env_rank = group_of_env()
    if num_processes is None:
        num_processes = env_size
    if process_id is None:
        process_id = env_rank
    if device is None:
        device = os.environ.get(ENV_PLATFORM)
    dev = resolve_device(device)
    init = f"tcp://{coordinator_address}"
    extra = {} if timeout_s is None else {"timeout": datetime.timedelta(seconds=timeout_s)}
    if dev.type == "cuda":
        card = int(os.environ.get(ENV_CARD, process_id)) if dev.index is None else dev.index
        dev = torch.device("cuda", card)
        torch.cuda.set_device(dev)
        dist.init_process_group("nccl", init_method=init, world_size=num_processes,
                                rank=process_id, device_id=dev, **extra)
    else:
        dist.init_process_group("gloo", init_method=init, world_size=num_processes,
                                rank=process_id, **extra)
    return dev


def _env_int(name: str, default: int) -> int:
    v = os.environ.get(name)
    return default if v in (None, "") else int(v)


def host_of_env() -> Tuple[int, int, int]:
    """(host index, local rank, ranks a host) of this process, from the
    launcher's environment ((0, 0, 1) where unset)."""
    return _env_int(ENV_PID, 0), _env_int(ENV_LOCAL, 0), _env_int(ENV_DPP, 1)


def group_of_env() -> Tuple[int, int]:
    """(size, rank) of this process's group from the environment: a gang's
    host is a group of its own (``DL4J_TPU_GANG=1``), else the job's ``n *
    d`` ranks form one, rank ``h * d + j``."""
    h, j, d = host_of_env()
    if os.environ.get(ENV_GANG) == "1":
        return d, j
    return _env_int(ENV_NPROC, 1) * d, h * d + j


def _in_a_host() -> bool:
    return _env_int(ENV_DPP, 1) > 1 and ENV_PID in os.environ


def process_index() -> int:
    """This process's host inside a host of more than one rank (JAX's
    process index), else its rank in the group."""
    if _in_a_host():
        return host_of_env()[0]
    import torch.distributed as dist
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    """The number of hosts where hosts hold more than one rank (JAX's
    process count), else the group's size."""
    if _in_a_host():
        return _env_int(ENV_NPROC, 1)
    import torch.distributed as dist
    return dist.get_world_size() if dist.is_initialized() else 1


def global_mesh(axes: Optional[Dict[str, int]] = None, device=None):
    """Mesh over every rank of the group (default: pure data parallel); in
    a gang that is this host's ranks."""
    from deeplearning4j_tpu_torch.parallel.mesh import make_mesh
    return make_mesh(axes, device=device)


def shard_host_local_batch(mesh, batch, axis: str = "data", batch_dim: int = 0):
    """Each process passes its own rows of the global batch, and they are
    already where the port computes them: every array is checked to have
    as many rows on every rank (``batch_dim``: 1 for ``[k, batch, ...]``
    blocks) and moved to this rank's device."""
    def place(leaf):
        t = torch.as_tensor(np.asarray(leaf) if not isinstance(leaf, torch.Tensor) else leaf)
        n = torch.tensor([t.shape[batch_dim]], device=mesh.device)
        if mesh.distributed and mesh.size > 1:
            import torch.distributed as dist
            lo, hi = n.clone(), n.clone()
            dist.all_reduce(lo, op=dist.ReduceOp.MIN, group=mesh.group_all)
            dist.all_reduce(hi, op=dist.ReduceOp.MAX, group=mesh.group_all)
            if int(lo) != int(hi):
                raise ValueError(f"host-local batches differ in size over the ranks: "
                                 f"{int(lo)} to {int(hi)} rows")
        return t.to(mesh.device)
    if isinstance(batch, (list, tuple)):
        return type(batch)(place(b) for b in batch)
    return place(batch)


def allgather_params(tree):
    """Every rank's copy of a tree of tensors gathered to this process as
    numpy, ``[ranks, ...]`` per leaf (the checkpoint and evaluation hook:
    equal rows show the ranks agree)."""
    import torch.distributed as dist

    def gather(t):
        t = t.detach().contiguous()
        if not dist.is_initialized() or dist.get_world_size() == 1:
            return t.cpu().numpy()[None]
        got = [torch.empty_like(t) for _ in range(dist.get_world_size())]
        dist.all_gather(got, t)
        return np.stack([g.cpu().numpy() for g in got])
    if isinstance(tree, dict):
        return {k: allgather_params(v) for k, v in tree.items()}
    return gather(tree)


# ---------------------------------------------------------------------------
# localhost launcher
# ---------------------------------------------------------------------------

def free_port(max_tries: int = 16) -> int:
    """A currently free localhost port, checked bindable a second time (the
    OS may hand a probed port to someone else before the caller binds)."""
    last_err: Optional[OSError] = None
    for _ in range(max_tries):
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        try:
            with socket.socket() as v:
                v.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
                v.bind(("127.0.0.1", port))
            return port
        except OSError as e:
            last_err = e
    raise OSError(f"free_port: no bindable port after {max_tries} probes") from last_err


def child_env(coordinator: str, num_processes: int, process_id: int,
              devices_per_process: int = 1, platform: str = "cuda",
              local_rank: int = 0, card: Optional[int] = None,
              gang: bool = False) -> Dict[str, str]:
    """Environment of one spawned rank, local rank `local_rank` of host
    `process_id` of `num_processes` hosts of `devices_per_process` ranks:
    the repository first on ``PYTHONPATH``, the rendezvous of its group
    (`coordinator`; with `gang` the host's own), the platform (``"cuda"``:
    card `card`, the rank ``h * d + j`` by default; ``"cpu"``: gloo) and
    one CPU thread a rank on the CPU."""
    env = dict(os.environ)
    repo_root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    inherited = [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]
    env["PYTHONPATH"] = os.pathsep.join([repo_root] + inherited)
    env[ENV_COORD] = coordinator
    env[ENV_NPROC] = str(num_processes)
    env[ENV_PID] = str(process_id)
    env[ENV_DPP] = str(devices_per_process)
    env[ENV_LOCAL] = str(local_rank)
    rank = process_id * devices_per_process + local_rank
    env[ENV_CARD] = str(rank if card is None else card)
    env[ENV_GANG] = "1" if gang else "0"
    env[ENV_PLATFORM] = platform
    if platform == "cpu":
        env.setdefault("OMP_NUM_THREADS", "1")
    return env


class LocalLauncher:
    """Start a script as `num_processes` localhost hosts of
    `devices_per_process` ranks each (one process a rank, ``n * d`` in
    all) and wait for them.  Each rank's stdout and stderr are captured; a
    rank that fails (or outlives `timeout`) makes `run` stop the others and
    raise with its output's tail.  ``platform="cuda"`` gives rank ``(h, j)``
    card ``h * d + j``; ``"cpu"`` runs gloo ranks.  Without a gang the
    ranks form one process group; ``gang=True`` starts the hosts of a
    gradient-sharing gang, each host a group of its own (its own
    rendezvous) and the hosts coupled by the TCP gradient mesh only: on
    the card they may outnumber the cards (rank ``(h, j)`` on card ``(h * d
    + j) % cards``)."""

    def __init__(self, num_processes: int, devices_per_process: int = 1,
                 platform: str = "cuda", gang: bool = False):
        if platform not in ("cpu", "cuda"):
            raise ValueError(f"platform {platform!r}: want 'cpu' or 'cuda'")
        if int(devices_per_process) < 1:
            raise ValueError(f"devices_per_process {devices_per_process}: want at least 1")
        ranks = int(num_processes) * int(devices_per_process)
        if platform == "cuda" and not gang and ranks > torch.cuda.device_count():
            raise ValueError(f"{ranks} ranks need {ranks} cards, "
                             f"this machine has {torch.cuda.device_count()}")
        self.num_processes = int(num_processes)
        self.devices_per_process = int(devices_per_process)
        self.platform = platform
        self.gang = bool(gang)

    def envs(self, extra_env: Optional[Dict[str, str]] = None,
             gradient_port: Optional[int] = None) -> List[Dict[str, str]]:
        """The environment of each rank, in ``(host, local)`` order: one
        rendezvous for the job, or one a host in a gang."""
        n, d = self.num_processes, self.devices_per_process
        cards = torch.cuda.device_count() if self.platform == "cuda" else 0
        shared = f"127.0.0.1:{free_port()}"
        out = []
        for h in range(n):
            coordinator = f"127.0.0.1:{free_port()}" if self.gang else shared
            for j in range(d):
                card = (h * d + j) % cards if self.gang and cards else None
                env = child_env(coordinator, n, h, d, self.platform, j, card, self.gang)
                if gradient_port is not None:
                    env[ENV_GRAD_PORT] = str(gradient_port)
                if extra_env:
                    env.update(extra_env)
                out.append(env)
        return out

    def run(self, script: str, args: Sequence[str] = (), timeout: float = 300.0,
            extra_env: Optional[Dict[str, str]] = None,
            gradient_port: Optional[int] = None) -> List[str]:
        """Each rank's output, in ``(host, local)`` order (rank ``h * d +
        j``).  The ranks are polled together: the first to fail, or the
        deadline, stops them all (a rank left waiting in a collective would
        otherwise hang).  `gradient_port` exports
        ``DL4J_TPU_GRADIENT_PORT`` so the hosts' leaders form their TCP
        gradient mesh on a known port (``free_port()`` for a fresh one a
        launch)."""
        procs, logs = [], []
        try:
            for env in self.envs(extra_env, gradient_port):
                log = tempfile.TemporaryFile(mode="w+")
                logs.append(log)
                procs.append(subprocess.Popen(
                    [sys.executable, "-u", script, *map(str, args)],
                    stdout=log, stderr=subprocess.STDOUT, text=True, env=env))
            deadline = time.monotonic() + timeout
            failed = None
            while failed is None and any(p.poll() is None for p in procs):
                failed = next(((r, p.returncode) for r, p in enumerate(procs)
                               if p.poll() not in (None, 0)), None)
                if failed is None and time.monotonic() > deadline:
                    failed = (next(r for r, p in enumerate(procs) if p.poll() is None), -9)
                time.sleep(0.05)
            if failed is None:
                failed = next(((r, p.returncode) for r, p in enumerate(procs)
                               if p.returncode != 0), None)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                p.wait()
        outs = []
        for log in logs:
            log.seek(0)
            outs.append(log.read())
            log.close()
        if failed is not None:
            rank, rc = failed
            tail = outs[rank] + ("\n<rank timed out>" if rc == -9 else "")
            raise RuntimeError(f"rank {rank} failed (rc={rc}):\n{tail[-4000:]}")
        return outs


# ---------------------------------------------------------------------------
# failure detection and elastic restart
# ---------------------------------------------------------------------------

#: what a rank prints when it fails because another rank died: a gloo or
#: NCCL collective losing its peer, the gang mesh losing its coordinator,
#: or a collective timing out (lower case)
PEER_LOSS_MARKERS = (
    "connection closed by peer", "connection reset by peer", "broken pipe",
    "peerunreachableerror", "gang coordinator", "peer dead or stalled",
    "remote process exited", "nccl communicator was aborted",
    "watchdog caught collective operation timeout", "timed out in call to",
    "gloo connectfullmesh failed")


class ElasticLocalRunner:
    """Failure detection and elastic restart (reference analog: Spark task
    retry around SharedTraining workers).

    ``run`` relaunches the whole job after a retryable failure, and the
    worker script resumes from its latest checkpoint
    (``train.resilience``).  ``torch.distributed`` has no coordination
    service to stop the survivors of a dead rank, so the launcher stops
    them at the first failure it sees (``LocalLauncher`` polls every
    rank).  ``run_elastic`` supervises an elastic gang member by member
    instead: the gang re-forms without the dead member and a replacement
    joins it.  The job is `num_processes` hosts of `devices_per_process`
    ranks, as ``LocalLauncher`` starts them; ``platform`` is where the
    ranks compute: ``"cuda"`` (the default) or ``"cpu"`` where the caller
    asks for it."""

    def __init__(self, num_processes: int, devices_per_process: int = 1,
                 platform: str = "cuda", max_restarts: int = 2,
                 backoff_base_s: float = 1.0, backoff_cap_s: float = 30.0,
                 jitter_seed: Optional[int] = None):
        self.num_processes = int(num_processes)
        self.devices_per_process = int(devices_per_process)
        self.platform = platform
        self.max_restarts = max_restarts
        self.restarts = 0
        self.backoff_base_s = backoff_base_s
        self.backoff_cap_s = backoff_cap_s
        # decorrelated-jitter state: a seeded PRNG (not the clock), so
        # tests are deterministic while real fleets still spread out
        self._rng = random.Random(jitter_seed)
        self._prev_backoff: Optional[float] = None
        #: (attempt, kind, message tail) a failure; kind is crash | hang |
        #: peer-loss | corrupt (see `_classify_failure`)
        self.failure_history: List[tuple] = []

    @staticmethod
    def _classify_failure(message: str) -> str:
        """Failure taxonomy of a failed rank's output: `corrupt` = a rank
        failed restoring a checkpoint whose bytes do not match their
        checksum (NOT retryable: a relaunch reads the same bytes); `hang`
        = a rank outlived the launch's timeout; `peer-loss` = a rank
        failed because another rank died (its collective or the gang mesh
        lost the peer, or timed out waiting for it: a secondary casualty);
        `crash` = a rank exited nonzero on its own."""
        low = message.lower()
        if "checksummismatch" in low.replace(" ", "") or "checksumerror" in low:
            return "corrupt"
        if "<rank timed out>" in message:
            return "hang"
        if any(m in low for m in PEER_LOSS_MARKERS):
            return "peer-loss"
        return "crash"

    def backoff_s(self, attempt: int) -> float:
        """Decorrelated-jitter backoff before restart `attempt` (1-based):
        sleep ~ U(base, 3 * previous sleep), capped.  Relaunches on one
        host draw different sleeps and stop stampeding one port; the
        jitter PRNG is seeded (`jitter_seed`)."""
        if attempt <= 1 or self._prev_backoff is None:
            self._prev_backoff = self.backoff_base_s
            return self._prev_backoff
        v = self._rng.uniform(self.backoff_base_s,
                              max(self._prev_backoff * 3.0, self.backoff_base_s))
        self._prev_backoff = min(v, self.backoff_cap_s)
        return self._prev_backoff

    def run(self, script: str, args: Sequence[str] = (), timeout: float = 300.0,
            checkpoint_dir: Optional[str] = None,
            gradient_mesh: bool = False) -> List[str]:
        """Run the job, relaunching after retryable failures.  Each attempt
        is a new `LocalLauncher` run, so a new rendezvous port; with
        `checkpoint_dir=` every attempt exports it as
        ``DL4J_TPU_CHECKPOINT_DIR`` so a resilience-aware worker resumes
        from the last committed checkpoint; with `gradient_mesh=True` the
        ranks are a gang (no process group) and every attempt exports a
        fresh ``DL4J_TPU_GRADIENT_PORT`` (the dead gang's socket may
        linger in TIME_WAIT).  A `corrupt` failure aborts at once."""
        extra_env = {} if checkpoint_dir is None else {ENV_CKPT: checkpoint_dir}
        last_error: Optional[RuntimeError] = None
        for attempt in range(self.max_restarts + 1):
            launcher = LocalLauncher(self.num_processes, self.devices_per_process,
                                     self.platform, gang=gradient_mesh)
            try:
                return launcher.run(script, args, timeout, extra_env=extra_env,
                                    gradient_port=free_port() if gradient_mesh else None)
            except RuntimeError as e:
                last_error = e
                kind = self._classify_failure(str(e))
                self.failure_history.append((attempt, kind, str(e)[-500:]))
                if kind == "corrupt":
                    raise RuntimeError(
                        "checkpoint restore failed with a checksum mismatch: not "
                        "retryable (a relaunch reads the same corrupt bytes); restore an "
                        "older intact checkpoint or repair storage") from e
                self.restarts = min(attempt + 1, self.max_restarts)
                if attempt < self.max_restarts:
                    time.sleep(self.backoff_s(attempt + 1))
        kinds = [k for _, k, _ in self.failure_history]
        raise RuntimeError(f"training failed after {self.max_restarts} restarts "
                           f"(failure kinds: {kinds})") from last_error

    def run_elastic(self, script: str, args: Sequence[str] = (), timeout: float = 600.0,
                    checkpoint_dir: Optional[str] = None, policy: str = "shrink",
                    heartbeat_s: float = 0.25, failure_deadline_s: float = 2.0,
                    max_replacements: int = 2, relaunch: bool = True,
                    extra_env: Optional[Dict[str, str]] = None
                    ) -> Dict[str, Tuple[int, str]]:
        """Supervise an ELASTIC gang process by process.

        Workers run ``HierarchicalGradientSharing(elastic=True)`` under
        ``ElasticTrainer``; when a member other than the coordinator dies
        the gang re-forms itself and trains on, and with `relaunch=True`
        this supervisor starts a REPLACEMENT after a jittered backoff with
        ``DL4J_TPU_JOIN=1`` on the same gradient port and checkpoint
        directory: it parks until admitted (at once under ``"block"``, at
        the next epoch boundary under ``"shrink"``) and enters at a fresh
        generation.  The coordinator's (rank 0's) death is fatal to the
        gang (the star has no other hub) and raises with its output's
        tail; wrap an elastic worker in :meth:`run` where a whole-gang
        restart is the recovery wanted for that.  On the card the members
        share the cards (rank r on card r % cards): a gang forms no NCCL
        group.

        Returns ``{label: (returncode, output)}``, labels ``"r<rank>"`` for
        the initial gang and ``"r<rank>+j<n>"`` for replacements.  The run
        succeeds when rank 0 exits 0; a member's death is recorded in
        `failure_history`, not raised."""
        if policy not in ("shrink", "block"):
            raise ValueError(f"policy must be 'shrink' or 'block', got {policy!r}")
        if self.devices_per_process > 1:
            raise NotImplementedError(
                "an elastic gang of hosts of several ranks (devices_per_process "
                f"{self.devices_per_process}) is not ported: run_elastic supervises "
                "one-rank hosts")
        port = free_port()
        base_env = {
            ENV_GRAD_PORT: str(port),
            "DL4J_TPU_HEARTBEAT_S": str(heartbeat_s),
            "DL4J_TPU_FAILURE_DEADLINE_S": str(failure_deadline_s),
            "DL4J_TPU_ELASTIC_POLICY": policy,
        }
        if checkpoint_dir is not None:
            base_env[ENV_CKPT] = checkpoint_dir
        if extra_env:
            base_env.update(extra_env)
        coordinator = f"127.0.0.1:{free_port()}"   # no process group in a gang
        cards = torch.cuda.device_count() if self.platform == "cuda" else 0
        logdir = tempfile.mkdtemp(prefix="elastic-gang-")

        def spawn(rank: int, label: str, join: bool):
            env = child_env(coordinator, self.num_processes, rank, 1, self.platform,
                            0, rank % cards if cards else None, gang=True)
            env.update(base_env)
            if join:
                env["DL4J_TPU_JOIN"] = "1"
            path = os.path.join(logdir, f"{label}.log")
            f = open(path, "w")
            p = subprocess.Popen([sys.executable, "-u", script, *map(str, args)],
                                 stdout=f, stderr=subprocess.STDOUT, text=True, env=env)
            return (p, f, path)

        alive: Dict[str, tuple] = {}
        for rank in range(self.num_processes):
            alive[f"r{rank}"] = spawn(rank, f"r{rank}", join=False)
        results: Dict[str, Tuple[int, str]] = {}
        replacements = 0
        rank0_rc: Optional[int] = None
        deadline = time.monotonic() + timeout
        grace_deadline: Optional[float] = None

        def reap(label: str, p, f, path) -> Tuple[int, str]:
            f.close()
            with open(path, "r") as rf:
                out = rf.read()
            results[label] = (p.returncode, out)
            return results[label]

        try:
            while alive:
                now = time.monotonic()
                if now > deadline or (grace_deadline is not None and now > grace_deadline):
                    for label, (p, f, path) in alive.items():
                        p.kill()
                        p.wait()
                        rc, out = reap(label, p, f, path)
                        results[label] = (rc, out + "\n<rank timed out>")
                    alive.clear()
                    if now > deadline:
                        raise RuntimeError(f"elastic gang timed out after {timeout:.0f}s "
                                           f"(results so far: {sorted(results)})")
                    break
                exited = [(label, t) for label, t in alive.items() if t[0].poll() is not None]
                for label, (p, f, path) in exited:
                    del alive[label]
                    rc, out = reap(label, p, f, path)
                    if label == "r0":
                        rank0_rc = rc
                        if rc != 0:
                            raise RuntimeError(f"elastic gang coordinator (rank 0) failed "
                                               f"(rc={rc}):\n{out[-4000:]}")
                        # the coordinator is done: the peers must wind down
                        # on their own within the failure deadline
                        grace_deadline = time.monotonic() + max(failure_deadline_s * 3, 5.0)
                    elif rc != 0:
                        kind = self._classify_failure(out)
                        self.failure_history.append((replacements, kind, out[-500:]))
                        if relaunch and rank0_rc is None and replacements < max_replacements:
                            replacements += 1
                            time.sleep(self.backoff_s(replacements))
                            base = label.split("+")[0]
                            jl = f"{base}+j{replacements}"
                            alive[jl] = spawn(int(base[1:]), jl, join=True)
                time.sleep(0.05)
        finally:
            for label, (p, f, path) in alive.items():
                p.kill()
                p.wait()
                reap(label, p, f, path)
            shutil.rmtree(logdir, ignore_errors=True)   # the outputs are in `results`
        self.restarts = replacements
        return results


# ---------------------------------------------------------------------------
# multi-process inference
# ---------------------------------------------------------------------------

class MultiHostParallelInference:
    """Inference over the processes of a job: every process submits its
    own request rows (the same count on every process), the replicated
    model runs them on this process's device, and each process receives
    exactly its own rows back; no result crosses between processes.  The
    model's parameters and layer state are made equal on every rank at
    construction (rank 0's, broadcast), the replication the JAX package
    states with a replicated sharding."""

    def __init__(self, model, mesh=None, data_axis: str = "data"):
        from deeplearning4j_tpu_torch.parallel.wrapper import _broadcast_tensors
        self.model = model
        self.mesh = mesh if mesh is not None else global_mesh(device=model.device)
        self.data_axis = data_axis
        if self.mesh.distributed and self.mesh.size > 1:
            from deeplearning4j_tpu_torch.train.updaters import tree_leaves
            tensors = [t for tree in (model.params_, model.state_)
                       for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]
            with torch.no_grad():
                _broadcast_tensors(tensors, self.mesh)

    def output(self, x_local):
        """x_local: this process's ``[b_local, ...]`` request batch (equal
        sizes on every process).  Returns this process's ``[b_local,
        ...]`` predictions as numpy."""
        x = shard_host_local_batch(self.mesh, np.asarray(x_local), self.data_axis)
        out = self.model.output(x)
        if isinstance(out, (list, tuple)):   # ComputationGraph
            out = out[0]
        return out.detach().cpu().numpy()
