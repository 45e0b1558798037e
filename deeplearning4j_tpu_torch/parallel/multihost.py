"""Launching the ranks of a data-parallel job (the port of
``parallel/multihost.py``, in part).

The JAX package's control plane is ``jax.distributed`` and its data plane
XLA's collectives inside one SPMD program.  The port's control plane is
``torch.distributed.init_process_group`` (a TCP rendezvous at the
coordinator's address) and its data plane the collectives of the
data-parallel step: NCCL with one card a process on the card, gloo on the
CPU.  :func:`initialize` joins the group from the ``DL4J_TPU_*``
environment that :class:`LocalLauncher` sets for each process it starts.

A gradient-sharing gang (``parallel/hierarchical.py``) is a set of
processes coupled only by the TCP gradient mesh: ``LocalLauncher(n,
gang=True)`` starts one, each rank told the mesh's port by
``run(..., gradient_port=)`` (``DL4J_TPU_GRADIENT_PORT``; the host is
``DL4J_TPU_GRADIENT_HOST``, 127.0.0.1 by default).  A gang forms no NCCL
group, so its ranks may share a card.

Not ported yet: ``ElasticLocalRunner`` and ``MultiHostParallelInference``
(the elastic runner).
"""
from __future__ import annotations

import datetime
import os
import socket
import subprocess
import sys
import tempfile
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from deeplearning4j_tpu_torch.utils.devices import resolve_device

# environment the launcher sets and `initialize()` reads
ENV_COORD = "DL4J_TPU_COORDINATOR"
ENV_NPROC = "DL4J_TPU_NUM_PROCESSES"
ENV_PID = "DL4J_TPU_PROCESS_ID"
ENV_LOCAL = "DL4J_TPU_LOCAL_RANK"
ENV_PLATFORM = "DL4J_TPU_PLATFORM"
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
    (the platform too: ``DL4J_TPU_PLATFORM=cpu`` asks for the CPU).  On the
    card (``"cuda"``, the default) the group is NCCL's, bound to card
    ``DL4J_TPU_LOCAL_RANK`` (the process id by default) with its
    communicator made at once, so it exists before any CUDA-graph capture;
    on the CPU it is gloo's.  `timeout_s` bounds the rendezvous and each
    collective (torch's default, 10 minutes, otherwise): a rank left
    waiting then fails instead of hanging."""
    import torch.distributed as dist
    coordinator_address = coordinator_address or os.environ.get(ENV_COORD)
    if coordinator_address is None:
        raise ValueError(f"no coordinator address: pass one or set {ENV_COORD}")
    if num_processes is None:
        num_processes = int(os.environ.get(ENV_NPROC, "1"))
    if process_id is None:
        process_id = int(os.environ.get(ENV_PID, "0"))
    if device is None:
        device = os.environ.get(ENV_PLATFORM)
    dev = resolve_device(device)
    init = f"tcp://{coordinator_address}"
    extra = {} if timeout_s is None else {"timeout": datetime.timedelta(seconds=timeout_s)}
    if dev.type == "cuda":
        local = int(os.environ.get(ENV_LOCAL, process_id)) if dev.index is None else dev.index
        dev = torch.device("cuda", local)
        torch.cuda.set_device(dev)
        dist.init_process_group("nccl", init_method=init, world_size=num_processes,
                                rank=process_id, device_id=dev, **extra)
    else:
        dist.init_process_group("gloo", init_method=init, world_size=num_processes,
                                rank=process_id, **extra)
    return dev


def process_index() -> int:
    import torch.distributed as dist
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    import torch.distributed as dist
    return dist.get_world_size() if dist.is_initialized() else 1


def global_mesh(axes: Optional[Dict[str, int]] = None, device=None):
    """Mesh over every rank of the group (default: pure data parallel)."""
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
            dist.all_reduce(lo, op=dist.ReduceOp.MIN)
            dist.all_reduce(hi, op=dist.ReduceOp.MAX)
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
              platform: str = "cpu", local_rank: Optional[int] = None) -> Dict[str, str]:
    """Environment of one spawned rank: the repository first on
    ``PYTHONPATH``, the rendezvous (coordinator, world size, rank), the
    platform (``"cuda"``: one card a rank, card = `local_rank`, the rank by
    default; ``"cpu"``: gloo) and one CPU thread a rank on the CPU."""
    env = dict(os.environ)
    repo_root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    inherited = [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]
    env["PYTHONPATH"] = os.pathsep.join([repo_root] + inherited)
    env[ENV_COORD] = coordinator
    env[ENV_NPROC] = str(num_processes)
    env[ENV_PID] = str(process_id)
    env[ENV_LOCAL] = str(process_id if local_rank is None else local_rank)
    env[ENV_PLATFORM] = platform
    if platform == "cpu":
        env.setdefault("OMP_NUM_THREADS", "1")
    return env


class LocalLauncher:
    """Start a script as N localhost ranks and wait for them.  Each rank's
    stdout and stderr are captured; a rank that fails (or outlives
    `timeout`) makes `run` stop the others and raise with its output's
    tail.  ``platform="cuda"`` gives each rank its own card (rank r on
    card r); ``"cpu"`` runs gloo ranks.  ``gang=True`` starts the ranks of
    a gradient-sharing gang, which form no NCCL group: on the card they may
    outnumber the cards (rank r on card r % cards)."""

    def __init__(self, num_processes: int, platform: str = "cpu", gang: bool = False):
        if platform not in ("cpu", "cuda"):
            raise ValueError(f"platform {platform!r}: want 'cpu' or 'cuda'")
        if platform == "cuda" and not gang and num_processes > torch.cuda.device_count():
            raise ValueError(f"{num_processes} ranks need {num_processes} cards, "
                             f"this machine has {torch.cuda.device_count()}")
        self.num_processes = int(num_processes)
        self.platform = platform
        self.gang = bool(gang)

    def run(self, script: str, args: Sequence[str] = (), timeout: float = 300.0,
            extra_env: Optional[Dict[str, str]] = None,
            gradient_port: Optional[int] = None) -> List[str]:
        """Each rank's output, in rank order.  The ranks are polled
        together: the first to fail, or the deadline, stops them all (a
        rank left waiting in a collective would otherwise hang).
        `gradient_port` exports ``DL4J_TPU_GRADIENT_PORT`` so the ranks
        form their TCP gradient mesh on a known port (``free_port()`` for a
        fresh one a launch)."""
        coordinator = f"127.0.0.1:{free_port()}"
        cards = torch.cuda.device_count() if self.platform == "cuda" else 0
        procs, logs = [], []
        try:
            for rank in range(self.num_processes):
                env = child_env(coordinator, self.num_processes, rank, self.platform,
                                rank % cards if self.gang and cards else None)
                if gradient_port is not None:
                    env[ENV_GRAD_PORT] = str(gradient_port)
                if extra_env:
                    env.update(extra_env)
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
