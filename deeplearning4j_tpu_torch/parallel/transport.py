"""TCP transport for the gradient exchange of hierarchical gradient
sharing (the port of ``parallel/transport.py``, its non-elastic part).

It ships ``parallel.compression`` streams, or dense f32 gradients, between
the processes of a gang: processes coupled only by this mesh, each with its
own card (or sharing one), the reference's Aeron mesh role.  Topology: a
star through rank 0, length-prefixed binary frames (an 8-byte ``<Q``
length), no pickling: streams are raw int32/float32 buffers exactly as the
C++ codec emits them, and the framing is the JAX package's byte for byte,
so a port process and a JAX process can share one mesh.

Failure posture (the Aeron liveness-timeout role): every socket carries a
timeout, a peer's connect retries with exponential backoff up to a
deadline, and a peer that dies mid-exchange surfaces as a
``PeerUnreachableError`` naming the rank and address, after the sockets
are closed, instead of hanging the gang on a silent recv.

:class:`ElasticGradientMesh` is the same star with elastic membership:
generation-fenced frames, heartbeats from a thread of their own (which
never touches CUDA, so they keep flowing while the training thread copies
or encodes), crash, partition and straggler detection, re-formation,
joiners parked until admitted, and eviction.  Its frames are the JAX
package's byte for byte too.

Pure sockets and numpy.
"""
from __future__ import annotations

import collections
import json
import select
import socket
import struct
import threading
import time
from typing import Any, Callable, Deque, Dict, List, Optional, Tuple

import numpy as np


class PeerUnreachableError(ConnectionError):
    """A gradient-mesh peer could not be reached (connect) or stopped
    responding (exchange).  The message names the rank and address."""


class GangEvictedError(ConnectionError):
    """This rank was declared lost by the coordinator (e.g. it straggled
    past the failure deadline, then woke up).  Its membership is gone; the
    only way back in is a fresh JOIN at the current generation."""


class GangReformed(RuntimeError):
    """The gang membership changed: raised out of `allgather` on every
    surviving rank so the training layer can rebuild codec state and
    resume from the coordinated checkpoint.  NOT an error condition —
    control flow for elastic membership.

    Attributes mirror the REFORM frame: `generation` (new), `world` (new),
    `rank` (this process's new rank), `rank_map` (old rank -> new rank for
    survivors), `lost` (old ranks removed), `cause`
    (crash|partition|straggler|join), `resume_step` (the checkpoint step
    every member restores), `detection_ms` (silence observed on the lost
    peer at declaration, None for joins)."""

    def __init__(self, info: Dict[str, Any]):
        self.generation = int(info["generation"])
        self.world = int(info["world"])
        self.rank = int(info["rank"])
        self.rank_map = {int(k): int(v)
                         for k, v in dict(info["rank_map"]).items()}
        self.lost = [int(r) for r in info.get("lost", [])]
        self.cause = str(info.get("cause", "unknown"))
        self.resume_step = int(info.get("resume_step", 0))
        self.detection_ms = info.get("detection_ms")
        super().__init__(
            f"gang reformed (cause={self.cause}): generation "
            f"{self.generation}, world {self.world}, this rank -> "
            f"{self.rank}, lost {self.lost}, resume from step "
            f"{self.resume_step}")


def _send_msg(sock: socket.socket, payload: bytes) -> int:
    sock.sendall(struct.pack("<Q", len(payload)) + payload)
    return len(payload) + 8


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("peer closed during receive")
        buf += chunk
    return bytes(buf)


def _recv_msg(sock: socket.socket) -> bytes:
    (n,) = struct.unpack("<Q", _recv_exact(sock, 8))
    return _recv_exact(sock, n)


def pack_streams(streams: List[np.ndarray],
                 thresholds: List[float]) -> bytes:
    """[count | per-leaf: len, threshold, int32 stream] — language-neutral
    framing (the FlatBuffers-message role in the reference's Aeron path)."""
    out = [struct.pack("<I", len(streams))]
    for s, t in zip(streams, thresholds):
        s = np.ascontiguousarray(s, dtype=np.int32)
        out.append(struct.pack("<If", s.size, float(t)))
        out.append(s.tobytes())
    return b"".join(out)


def unpack_streams(payload: bytes):
    (count,) = struct.unpack_from("<I", payload, 0)
    off = 4
    streams, thresholds = [], []
    for _ in range(count):
        n, t = struct.unpack_from("<If", payload, off)
        off += 8
        streams.append(np.frombuffer(payload, np.int32, n, off).copy())
        off += 4 * n
        thresholds.append(t)
    return streams, thresholds


def pack_dense(leaves: List[np.ndarray]) -> bytes:
    """Full-precision framing for the uncompressed A/B baseline:
    [count | per-leaf: ndim, dims..., raw f32] — self-describing, so
    `unpack_dense` needs no shape template."""
    out = [struct.pack("<I", len(leaves))]
    for a in leaves:
        # shape BEFORE ascontiguousarray: that call promotes 0-d to 1-d,
        # which would silently re-shape scalar leaves on the far side
        a = np.asarray(a, np.float32)
        out.append(struct.pack("<I", a.ndim))
        out.append(struct.pack(f"<{max(a.ndim, 1)}q",
                               *(a.shape if a.ndim else (1,))))
        out.append(np.ascontiguousarray(a).tobytes())
    return b"".join(out)


def unpack_dense(payload: bytes) -> List[np.ndarray]:
    (count,) = struct.unpack_from("<I", payload, 0)
    off = 4
    leaves = []
    for _ in range(count):
        (ndim,) = struct.unpack_from("<I", payload, off)
        off += 4
        dims = struct.unpack_from(f"<{max(ndim, 1)}q", payload, off)
        off += 8 * max(ndim, 1)
        shape = tuple(dims[:ndim]) if ndim else ()
        n = int(np.prod(shape)) if ndim else 1
        a = np.frombuffer(payload, np.float32, n, off).copy()
        off += 4 * n
        leaves.append(a.reshape(shape) if ndim else a[0].reshape(()))
    return leaves


class TcpGradientMesh:
    """All-gather of opaque byte payloads across ranks (star via rank 0).

    Rank 0 binds, accepts `world-1` peers (each identifies itself with its
    rank), gathers one payload per rank per round, and broadcasts the full
    list — every rank then holds every rank's compressed stream, mirroring
    the reference mesh where each worker applies every peer's encoded
    delta.

    `timeout` bounds every blocking socket op (accept, connect attempts,
    recv/send during an exchange); `bytes_sent`/`bytes_received` count the
    actual frames on the wire (the `comms_bytes_on_wire_total` source)."""

    def __init__(self, rank: int, world: int, port: int,
                 host: str = "127.0.0.1", timeout: float = 60.0,
                 connect_backoff_base: float = 0.05,
                 connect_backoff_cap: float = 2.0):
        self.rank = rank
        self.world = world
        self.host = host
        self.port = port
        self.timeout = timeout
        self.bytes_sent = 0
        self.bytes_received = 0
        self._peers: List[Optional[socket.socket]] = [None] * world
        self._peer_addr: List[str] = ["?"] * world
        self._server: Optional[socket.socket] = None
        self._closed = False
        if world == 1:
            return
        # any exception during formation must not leak the sockets opened
        # so far — a supervisor retrying elastic relaunches would otherwise
        # exhaust fds on repeatedly half-formed gangs
        try:
            if rank == 0:
                self._form_coordinator()
            else:
                self._form_peer(connect_backoff_base, connect_backoff_cap)
        except BaseException:
            self.close()
            raise

    def _form_coordinator(self) -> None:
        srv = socket.create_server((self.host, self.port),
                                   backlog=self.world)
        self._server = srv
        deadline = time.monotonic() + self.timeout
        connected: set = set()
        for _ in range(self.world - 1):
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                self._raise_formation_timeout(connected)
            srv.settimeout(remaining)
            try:
                conn, addr = srv.accept()
            except (socket.timeout, TimeoutError):
                self._raise_formation_timeout(connected)
            try:
                conn.settimeout(self.timeout)
                (peer_rank,) = struct.unpack("<I", _recv_exact(conn, 4))
                if peer_rank <= 0 or peer_rank >= self.world \
                        or peer_rank in connected:
                    raise ConnectionError(
                        f"rank 0: peer at {addr[0]}:{addr[1]} identified "
                        f"as invalid/duplicate rank {peer_rank} "
                        f"(world={self.world}, already connected: "
                        f"{sorted(connected)})")
            except BaseException:
                conn.close()
                raise
            self._peers[peer_rank] = conn
            self._peer_addr[peer_rank] = f"{addr[0]}:{addr[1]}"
            connected.add(peer_rank)

    def _form_peer(self, backoff_base: float, backoff_cap: float) -> None:
        deadline = time.monotonic() + self.timeout
        backoff = backoff_base
        attempts = 0
        last_err: Optional[Exception] = None
        while True:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                raise PeerUnreachableError(
                    f"rank {self.rank}: gradient-mesh coordinator (rank 0) "
                    f"at {self.host}:{self.port} unreachable after "
                    f"{self.timeout:.1f}s / {attempts} attempts: "
                    f"{last_err!r}")
            try:
                conn = socket.create_connection(
                    (self.host, self.port),
                    timeout=min(remaining, self.timeout))
                break
            except OSError as e:
                last_err = e
                attempts += 1
                time.sleep(min(backoff, max(remaining, 0.0)))
                backoff = min(backoff * 2, backoff_cap)
        try:
            conn.settimeout(self.timeout)
            conn.sendall(struct.pack("<I", self.rank))
        except BaseException:
            conn.close()
            raise
        self._peers[0] = conn
        self._peer_addr[0] = f"{self.host}:{self.port}"

    def _raise_formation_timeout(self, connected: set) -> None:
        missing = sorted(set(range(1, self.world)) - connected)
        raise PeerUnreachableError(
            f"rank 0: gradient mesh formation timed out after "
            f"{self.timeout:.1f}s on {self.host}:{self.port} — rank(s) "
            f"{missing} never connected ({len(connected)}/{self.world - 1} "
            "peers arrived)")

    def _peer_error(self, r: int, op: str,
                    e: Exception) -> PeerUnreachableError:
        return PeerUnreachableError(
            f"rank {self.rank}: gradient exchange {op} with rank {r} "
            f"({self._peer_addr[r]}) failed after {self.timeout:.1f}s — "
            f"peer dead or stalled: {e!r}")

    def allgather(self, payload: bytes) -> List[bytes]:
        # a mid-exchange failure means the gang is dead: release the
        # sockets before surfacing it, so the fds never outlive the
        # exchange that killed them (elastic relaunches would leak them)
        try:
            return self._allgather(payload)
        except PeerUnreachableError:
            self.close()
            raise

    def _allgather(self, payload: bytes) -> List[bytes]:
        if self.world == 1:
            return [payload]
        if self.rank == 0:
            gathered: List[bytes] = [b""] * self.world
            gathered[0] = payload
            for r in range(1, self.world):
                try:
                    gathered[r] = _recv_msg(self._peers[r])
                except (socket.timeout, TimeoutError, OSError,
                        ConnectionError) as e:
                    raise self._peer_error(r, "recv", e) from e
                self.bytes_received += len(gathered[r]) + 8
            blob = struct.pack("<I", self.world) + b"".join(
                struct.pack("<Q", len(g)) + g for g in gathered)
            for r in range(1, self.world):
                try:
                    self.bytes_sent += _send_msg(self._peers[r], blob)
                except (socket.timeout, TimeoutError, OSError,
                        ConnectionError) as e:
                    raise self._peer_error(r, "send", e) from e
            return gathered
        try:
            self.bytes_sent += _send_msg(self._peers[0], payload)
            blob = _recv_msg(self._peers[0])
        except (socket.timeout, TimeoutError, OSError,
                ConnectionError) as e:
            raise self._peer_error(0, "exchange", e) from e
        self.bytes_received += len(blob) + 8
        (world,) = struct.unpack_from("<I", blob, 0)
        off = 4
        gathered = []
        for _ in range(world):
            (n,) = struct.unpack_from("<Q", blob, off)
            off += 8
            gathered.append(blob[off: off + n])
            off += n
        return gathered

    def close(self) -> None:
        """Idempotent: safe to call repeatedly and from error paths mid-
        formation (partial peer lists, server bound but no peers)."""
        if getattr(self, "_closed", False):
            return
        self._closed = True
        for i, s in enumerate(self._peers):
            if s is not None:
                try:
                    s.close()
                except OSError:
                    pass
                self._peers[i] = None
        if self._server is not None:
            try:
                self._server.close()
            except OSError:
                pass
            self._server = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


# ---------------------------------------------------------------------------
# Elastic gang mesh: generation-fenced frames, heartbeats, coordinator-led
# re-formation
# ---------------------------------------------------------------------------

# Elastic frame: <Q payload-len><I generation><B kind> + payload.  EVERY
# frame carries the sender's generation; DATA from a stale generation is
# fenced (dropped + counted), never summed into gradients.  Heartbeats
# update liveness regardless of generation — a survivor that has not yet
# consumed the REFORM frame still proves it is alive.
#
# The JAX package's serving federation speaks the same framing (its SNAPSHOT
# kind); the port's serving side has no federation yet.
_ELASTIC_HDR = struct.Struct("<QIB")
KIND_DATA = 0        # gradient payload (gather leg or broadcast leg)
KIND_HB = 1          # heartbeat (empty payload)
KIND_REFORM = 2      # coordinator -> members: new (gen, world, rank map)
KIND_JOIN = 3        # member -> coordinator: formation / rejoin request
KIND_WELCOME = 4     # coordinator -> joiner: admission + resume point
KIND_SNAPSHOT = 5    # federation: replicated fleet-topology snapshot copy


def _send_all(sock: socket.socket, data: bytes, timeout: float) -> None:
    """``sendall`` that also works on a non-blocking socket (the elastic
    coordinator's, read by its reactor thread; a peer's, which its reader
    switches to non-blocking between rounds): a full send buffer waits up
    to `timeout` for the socket to drain instead of failing the send.
    ``socket.sendall`` raises there once a frame outgrows the kernel's
    buffer (a ResNet-50 gradient stream does), and the send would be taken
    for a dead peer."""
    view = memoryview(data)
    deadline = time.monotonic() + timeout
    while view:
        try:
            n = sock.send(view)
        except (BlockingIOError, InterruptedError, socket.timeout):
            n = 0
        view = view[n:]
        if view and n == 0:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                raise socket.timeout(f"send stalled for {timeout:.1f}s")
            select.select([], [sock], [], min(remaining, 0.05))


class _FrameReader:
    """Incremental elastic-frame parser over a byte stream (recv chunks
    in, complete (generation, kind, payload) frames out)."""

    def __init__(self):
        self._buf = bytearray()

    def feed(self, data: bytes) -> List[Tuple[int, int, bytes]]:
        self._buf += data
        frames = []
        while True:
            if len(self._buf) < _ELASTIC_HDR.size:
                break
            n, gen, kind = _ELASTIC_HDR.unpack_from(self._buf, 0)
            end = _ELASTIC_HDR.size + n
            if len(self._buf) < end:
                break
            frames.append((gen, kind,
                           bytes(self._buf[_ELASTIC_HDR.size:end])))
            del self._buf[:end]
        return frames


def _frame_bytes(generation: int, kind: int, payload: bytes) -> bytes:
    return _ELASTIC_HDR.pack(len(payload), int(generation),
                             int(kind)) + payload


class ElasticGradientMesh:
    """Star all-gather with elastic gang membership.

    Same wire role as :class:`TcpGradientMesh` — one opaque payload per
    rank per round, gathered and re-broadcast through rank 0 — but the
    gang survives member loss:

    * every frame carries a **generation id**; DATA from a previous
      generation is fenced (dropped and counted in
      ``gang_stale_frames_total``), so a straggler waking up after a
      re-formation can never leak its gradient into the new gang;
    * every member **heartbeats** (`heartbeat_interval`); the coordinator
      declares a peer lost after `failure_deadline` of silence
      (partition), on EOF (crash), or when the peer heartbeats but ships
      no data past the deadline during a round (straggler) — a bounded
      detection instead of a hung socket op;
    * on detection the coordinator **re-forms**: bumps the generation,
      compacts surviving ranks (rank 0 stays 0; survivors keep their
      relative order), and pushes a REFORM frame carrying the new
      ``(generation, world, rank_map)`` plus the checkpoint step everyone
      must resume from (`resume_step_provider`).  Survivors raise
      :class:`GangReformed` out of `allgather`; the training layer
      rebuilds codec state and restores the named checkpoint;
    * a replacement worker connects with ``join=True``; it is parked
      until the coordinator's training layer admits it at a safe point
      (`admit_joiners`), which re-forms upward the same way.

    Rank 0 death remains gang-fatal (the star has no other hub): peers
    surface `PeerUnreachableError` within the deadline and the supervisor
    relaunches the gang, resuming from the shared checkpoint directory.
    """

    def __init__(self, rank: int, world: int, port: int,
                 host: str = "127.0.0.1", timeout: float = 60.0,
                 heartbeat_interval: float = 0.25,
                 failure_deadline: float = 5.0,
                 join: bool = False, join_timeout: float = 120.0,
                 resume_step_provider: Optional[Callable[[], int]] = None,
                 connect_backoff_base: float = 0.05,
                 connect_backoff_cap: float = 2.0):
        self.rank = int(rank)
        self.world = int(world)
        self.host = host
        self.port = int(port)
        self.timeout = float(timeout)
        self.heartbeat_interval = float(heartbeat_interval)
        self.failure_deadline = float(failure_deadline)
        self.join_timeout = float(join_timeout)
        self.resume_step_provider = resume_step_provider
        self.generation = 1
        self.bytes_sent = 0
        self.bytes_received = 0
        self.stale_frames = 0          # local mirror of the fence counter
        self.reformations = 0
        self.join_info: Optional[Dict[str, Any]] = None
        self._closed = False
        self._stop = threading.Event()
        self._hb_paused = threading.Event()    # chaos: simulate partition
        self._lock = threading.RLock()
        self._cond = threading.Condition(self._lock)
        self._pending_reform: Optional[Dict[str, Any]] = None
        self._reactor_thread: Optional[threading.Thread] = None
        self._hb_thread: Optional[threading.Thread] = None
        self._server: Optional[socket.socket] = None
        # coordinator state (keyed by CURRENT rank)
        self._conns: Dict[int, socket.socket] = {}
        self._addr: Dict[int, str] = {}
        self._readers: Dict[int, _FrameReader] = {}
        self._send_locks: Dict[int, threading.Lock] = {}
        self._last_heard: Dict[int, float] = {}
        self._inbox: Dict[int, Deque[bytes]] = {}
        self._joiners: List[Tuple[socket.socket, str, _FrameReader]] = []
        self._handshaking: List[Tuple[socket.socket, str,
                                      _FrameReader]] = []
        # peer state
        self._sock: Optional[socket.socket] = None
        self._send_lock = threading.Lock()
        self._reader = _FrameReader()
        self._frames: Deque[Tuple[int, int, bytes]] = collections.deque()
        self._last_recv = time.monotonic()
        try:
            if join:
                self._join_gang(connect_backoff_base, connect_backoff_cap)
            elif self.rank == 0:
                self._form_coordinator()
            else:
                self._form_peer(connect_backoff_base, connect_backoff_cap)
        except BaseException:
            self.close()
            raise
        self._instr().record_membership(self.generation, self.world)

    # ------------------------------------------------------------------
    # formation
    # ------------------------------------------------------------------
    def _instr(self):
        from deeplearning4j_tpu_torch.monitor.instrument import gang_instruments
        return gang_instruments()

    def _count_stale(self, n: int = 1) -> None:
        self.stale_frames += n
        self._instr().stale_frames.inc(n)

    def _form_coordinator(self) -> None:
        self._server = socket.create_server((self.host, self.port),
                                            backlog=max(self.world, 4))
        deadline = time.monotonic() + self.timeout
        connected: set = set()
        while len(connected) < self.world - 1:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                missing = sorted(set(range(1, self.world)) - connected)
                raise PeerUnreachableError(
                    f"rank 0: elastic gang formation timed out after "
                    f"{self.timeout:.1f}s on {self.host}:{self.port} — "
                    f"rank(s) {missing} never joined")
            self._server.settimeout(remaining)
            try:
                conn, addr = self._server.accept()
            except (socket.timeout, TimeoutError):
                continue
            try:
                conn.settimeout(min(remaining, self.timeout))
                gen, kind, payload = self._read_frames(conn,
                                                       _FrameReader())[0]
                d = json.loads(payload.decode("utf-8")) if payload else {}
                peer_rank = d.get("rank")
                if kind != KIND_JOIN or peer_rank is None \
                        or not (0 < int(peer_rank) < self.world) \
                        or int(peer_rank) in connected:
                    raise ConnectionError(
                        f"rank 0: bad formation JOIN from "
                        f"{addr[0]}:{addr[1]} (kind={kind}, "
                        f"rank={peer_rank!r})")
                peer_rank = int(peer_rank)
                welcome = json.dumps({"generation": self.generation,
                                      "world": self.world,
                                      "rank": peer_rank}).encode("utf-8")
                conn.sendall(_frame_bytes(self.generation, KIND_WELCOME,
                                          welcome))
            except BaseException:
                conn.close()
                raise
            conn.setblocking(False)
            self._register_peer(peer_rank, conn,
                                f"{addr[0]}:{addr[1]}")
            connected.add(peer_rank)
        self._reactor_thread = threading.Thread(
            target=self._reactor, name="gang-reactor", daemon=True)
        self._reactor_thread.start()

    def _register_peer(self, rank: int, conn: socket.socket,
                       addr: str) -> None:
        with self._lock:
            self._conns[rank] = conn
            self._addr[rank] = addr
            self._readers[rank] = _FrameReader()
            self._send_locks[rank] = threading.Lock()
            self._last_heard[rank] = time.monotonic()
            self._inbox[rank] = collections.deque()

    def _connect(self, backoff_base: float, backoff_cap: float,
                 budget: float) -> socket.socket:
        deadline = time.monotonic() + budget
        backoff = backoff_base
        attempts = 0
        last_err: Optional[Exception] = None
        while True:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                raise PeerUnreachableError(
                    f"rank {self.rank}: gang coordinator at "
                    f"{self.host}:{self.port} unreachable after "
                    f"{budget:.1f}s / {attempts} attempts: {last_err!r}")
            try:
                return socket.create_connection(
                    (self.host, self.port), timeout=min(remaining,
                                                        budget))
            except OSError as e:
                last_err = e
                attempts += 1
                time.sleep(min(backoff, max(remaining, 0.0)))
                backoff = min(backoff * 2, backoff_cap)

    def _form_peer(self, backoff_base: float, backoff_cap: float) -> None:
        conn = self._connect(backoff_base, backoff_cap, self.timeout)
        try:
            conn.settimeout(self.timeout)
            hello = json.dumps({"rank": self.rank}).encode("utf-8")
            conn.sendall(_frame_bytes(0, KIND_JOIN, hello))
            frames = self._read_frames(conn, self._reader)
            gen, kind, payload = frames[0]
            self._frames.extend(frames[1:])
            if kind != KIND_WELCOME:
                raise ConnectionError(
                    f"rank {self.rank}: expected WELCOME, got kind {kind}")
            d = json.loads(payload.decode("utf-8"))
            self.generation = int(d["generation"])
            self.world = int(d["world"])
        except BaseException:
            conn.close()
            raise
        self._sock = conn
        self._last_recv = time.monotonic()
        self._start_heartbeats()

    def _join_gang(self, backoff_base: float, backoff_cap: float) -> None:
        """Replacement-worker path: connect, announce JOIN, and park until
        the coordinator's training layer admits us (safe point) — the
        WELCOME then carries our assigned rank, the new world and the
        checkpoint step to resume from."""
        conn = self._connect(backoff_base, backoff_cap, self.join_timeout)
        try:
            conn.settimeout(self.join_timeout)
            hello = json.dumps({"rank": None}).encode("utf-8")
            conn.sendall(_frame_bytes(0, KIND_JOIN, hello))
            d = None
            while d is None:
                for gen, kind, payload in self._read_frames(conn,
                                                            self._reader):
                    if kind in (KIND_HB, KIND_REFORM):
                        continue        # not a member yet
                    if kind != KIND_WELCOME:
                        raise ConnectionError(
                            f"joiner: expected WELCOME, got kind {kind}")
                    d = json.loads(payload.decode("utf-8"))
                    break
            self.generation = int(d["generation"])
            self.world = int(d["world"])
            self.rank = int(d["rank"])
            self.join_info = d
        except BaseException:
            conn.close()
            raise
        self._sock = conn
        self._last_recv = time.monotonic()
        self._start_heartbeats()

    @staticmethod
    def _read_frames(conn: socket.socket,
                     reader: _FrameReader) -> List[Tuple[int, int, bytes]]:
        """Blocking read of at least one complete frame (handshake paths
        — the socket still has a timeout set)."""
        while True:
            data = conn.recv(65536)
            if not data:
                raise ConnectionError("peer closed during handshake")
            frames = reader.feed(data)
            if frames:
                return frames

    # ------------------------------------------------------------------
    # heartbeats (member side)
    # ------------------------------------------------------------------
    def _start_heartbeats(self) -> None:
        self._hb_thread = threading.Thread(
            target=self._hb_loop, name="gang-heartbeat", daemon=True)
        self._hb_thread.start()

    def _hb_loop(self) -> None:
        while not self._stop.wait(self.heartbeat_interval):
            if self._hb_paused.is_set():
                continue
            try:
                self._peer_send(KIND_HB, b"")
            except OSError:
                return          # main thread will surface the death

    def pause_heartbeats(self, paused: bool = True) -> None:
        """Chaos hook: stop/resume heartbeating WITHOUT closing the
        socket — to the coordinator this is indistinguishable from a
        network partition."""
        if paused:
            self._hb_paused.set()
        else:
            self._hb_paused.clear()

    def _peer_send(self, kind: int, payload: bytes,
                   generation: Optional[int] = None) -> None:
        gen = self.generation if generation is None else generation
        frame = _frame_bytes(gen, kind, payload)
        with self._send_lock:
            _send_all(self._sock, frame, self.timeout)
        self.bytes_sent += len(frame)

    # ------------------------------------------------------------------
    # coordinator reactor: liveness, inbound frames, joiners
    # ------------------------------------------------------------------
    def _reactor(self) -> None:
        tick = min(0.005, self.heartbeat_interval / 4)
        next_hb = 0.0
        while not self._stop.wait(tick):
            now = time.monotonic()
            if now >= next_hb:
                self._coord_broadcast(KIND_HB, b"", best_effort=True)
                next_hb = now + self.heartbeat_interval
            self._pump_sockets()
            self._accept_new()
            self._check_deadlines()

    def _pump_sockets(self) -> None:
        with self._lock:
            socks = list(self._conns.items())
        dead: List[int] = []
        for r, conn in socks:
            try:
                while True:
                    data = conn.recv(1 << 16)
                    if not data:
                        dead.append(r)
                        break
                    self.bytes_received += len(data)
                    self._dispatch_frames(r, data)
            except (BlockingIOError, InterruptedError):
                continue
            except OSError:
                dead.append(r)
        if dead:
            self._reform(lost=set(dead), cause="crash")

    def _dispatch_frames(self, r: int, data: bytes) -> None:
        with self._lock:
            reader = self._readers.get(r)
            if reader is None:
                return
            for gen, kind, payload in reader.feed(data):
                self._last_heard[r] = time.monotonic()
                if kind == KIND_HB:
                    continue        # liveness only, any generation
                if kind == KIND_DATA:
                    if gen != self.generation:
                        self._count_stale()
                        continue
                    self._inbox[r].append(payload)
                    self._cond.notify_all()
                # REFORM/JOIN/WELCOME from an established peer: ignore

    def _accept_new(self) -> None:
        srv = self._server
        if srv is None:
            return
        srv.setblocking(False)
        try:
            while True:
                try:
                    conn, addr = srv.accept()
                except (BlockingIOError, InterruptedError):
                    break
                except OSError:
                    break
                conn.setblocking(False)
                with self._lock:
                    self._handshaking.append(
                        (conn, f"{addr[0]}:{addr[1]}", _FrameReader()))
        finally:
            pass
        # progress half-open handshakes: a JOIN frame parks the socket as
        # a pending joiner until the training layer admits it
        with self._lock:
            still = []
            for conn, addr, reader in self._handshaking:
                try:
                    data = conn.recv(1 << 16)
                except (BlockingIOError, InterruptedError):
                    still.append((conn, addr, reader))
                    continue
                except OSError:
                    conn.close()
                    continue
                if not data:
                    conn.close()
                    continue
                frames = reader.feed(data)
                joined = False
                for gen, kind, payload in frames:
                    if kind == KIND_JOIN:
                        self._joiners.append((conn, addr, reader))
                        self._cond.notify_all()
                        joined = True
                        break
                if not joined:
                    if frames:      # spoke, but not a JOIN: reject
                        conn.close()
                    else:
                        still.append((conn, addr, reader))
            self._handshaking = still

    def _check_deadlines(self) -> None:
        now = time.monotonic()
        with self._lock:
            silent = {r for r, t in self._last_heard.items()
                      if now - t > self.failure_deadline}
        if silent:
            self._reform(lost=silent, cause="partition")

    def _coord_broadcast(self, kind: int, payload: bytes,
                         best_effort: bool = False,
                         generation: Optional[int] = None) -> List[int]:
        """Send one frame to every connected peer; returns ranks whose
        send failed (empty when best_effort and all well)."""
        gen = self.generation if generation is None else generation
        frame = _frame_bytes(gen, kind, payload)
        with self._lock:
            targets = list(self._conns.items())
        failed = []
        for r, conn in targets:
            lock = self._send_locks.get(r)
            if lock is None:
                continue
            try:
                with lock:
                    _send_all(conn, frame, self.timeout)
                self.bytes_sent += len(frame)
            except OSError:
                failed.append(r)
        if failed and not best_effort:
            self._reform(lost=set(failed), cause="crash")
        return failed

    # ------------------------------------------------------------------
    # re-formation (coordinator)
    # ------------------------------------------------------------------
    def _resume_step(self) -> int:
        if self.resume_step_provider is None:
            return 0
        try:
            return int(self.resume_step_provider() or 0)
        except Exception:
            return 0

    def _reform(self, lost: set, cause: str,
                resume_step: Optional[int] = None) -> Dict[str, Any]:
        """Coordinator-side membership change: bump the generation,
        compact survivor ranks, fence stale inboxes, notify survivors.
        Thread-safe (reactor and allgather both call it)."""
        with self._lock:
            lost = {r for r in lost if r in self._conns}
            if not lost:
                return self._pending_reform or {}
            now = time.monotonic()
            detection_ms = max(
                (now - self._last_heard.get(r, now)) * 1000.0
                for r in lost)
            survivors = [0] + sorted(r for r in self._conns
                                     if r not in lost)
            rank_map = {old: new for new, old in enumerate(survivors)}
            self.generation += 1
            self.reformations += 1
            step = self._resume_step() if resume_step is None \
                else int(resume_step)
            info = {"generation": self.generation,
                    "world": len(survivors),
                    "rank": 0, "rank_map": rank_map,
                    "lost": sorted(lost), "cause": cause,
                    "resume_step": step, "detection_ms": detection_ms}
            # fence: anything buffered was sent under the old generation
            dropped = sum(len(q) for q in self._inbox.values())
            if dropped:
                self._count_stale(dropped)
            # eviction notice: a merely-partitioned/straggling peer whose
            # socket is still writable learns it was declared lost (its
            # rank is absent from the map -> GangEvictedError -> rejoin).
            # Best effort, one send on the non-blocking socket: a peer with
            # a full receive buffer must not hold the lock (and the
            # heartbeats)
            notice = json.dumps({**info,
                                 "rank_map": {str(k): v for k, v
                                              in rank_map.items()}
                                 }).encode("utf-8")
            for r in lost:
                try:
                    self._conns[r].send(_frame_bytes(
                        self.generation, KIND_REFORM, notice))
                except OSError:             # BlockingIOError included
                    pass
                try:
                    self._conns[r].close()
                except OSError:
                    pass
            old_conns, old_addr = self._conns, self._addr
            old_locks = self._send_locks
            old_readers = self._readers
            self._conns, self._addr, self._send_locks = {}, {}, {}
            self._readers, self._last_heard, self._inbox = {}, {}, {}
            for old in survivors[1:]:
                new = rank_map[old]
                self._conns[new] = old_conns[old]
                self._addr[new] = old_addr[old]
                self._send_locks[new] = old_locks[old]
                self._readers[new] = old_readers[old]
                self._last_heard[new] = now
                self._inbox[new] = collections.deque()
            self.world = len(survivors)
            self._pending_reform = info
            self._cond.notify_all()
        # REFORM frames carry the NEW generation; survivors' in-flight
        # old-generation data is already fenced above
        payload = json.dumps({**info,
                              "rank_map": {str(k): v for k, v
                                           in info["rank_map"].items()}
                              }).encode("utf-8")
        self._coord_broadcast(KIND_REFORM, payload, best_effort=True)
        self._instr().record_reform(cause, info["detection_ms"],
                                    self.generation, self.world)
        return info

    def _raise_pending_reform(self) -> None:
        """Surface a reformation to the coordinator's own training loop
        (must hold the lock)."""
        info, self._pending_reform = self._pending_reform, None
        if info is not None:
            raise GangReformed(info)

    # ---- joiner admission (training layer calls at a safe point) ----
    def has_pending_joiner(self) -> bool:
        with self._lock:
            return bool(self._joiners)

    def wait_for_joiner(self, timeout: float) -> bool:
        """Block (coordinator) until a replacement worker is parked or
        `timeout` elapses.  Heartbeats keep flowing from the reactor, so
        survivors blocked in `allgather` do NOT false-positive on rank 0
        while it waits."""
        deadline = time.monotonic() + timeout
        with self._cond:
            while not self._joiners:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return False
                self._cond.wait(min(remaining, 0.1))
            return True

    def admit_joiners(self, resume_step: int) -> Optional[Dict[str, Any]]:
        """Admit every parked joiner: bump the generation, grow the
        world, WELCOME the joiners with their new ranks and the resume
        step, and push REFORM to existing peers (who raise
        :class:`GangReformed` and restore the same checkpoint).  Returns
        the reform info (the coordinator handles its own rebuild inline —
        no exception), or None when no joiner is parked.  Coordinator
        only, between rounds."""
        if self.rank != 0:
            raise RuntimeError("admit_joiners is coordinator-only")
        with self._lock:
            joiners, self._joiners = self._joiners, []
            if not joiners:
                return None
            existing = list(self._conns.items())
            self.generation += 1
            self.reformations += 1
            base = self.world
            rank_map = {r: r for r in range(self.world)}
            new_ranks = []
            for i, (conn, addr, reader) in enumerate(joiners):
                new_ranks.append(base + i)
            self.world += len(joiners)
            info = {"generation": self.generation, "world": self.world,
                    "rank": 0, "rank_map": rank_map, "lost": [],
                    "cause": "join", "resume_step": int(resume_step),
                    "detection_ms": None, "joined": new_ranks}
            dropped = sum(len(q) for q in self._inbox.values())
            if dropped:
                self._count_stale(dropped)
            for q in self._inbox.values():
                q.clear()
            for (conn, addr, reader), nr in zip(joiners, new_ranks):
                welcome = json.dumps(
                    {"generation": self.generation, "world": self.world,
                     "rank": nr, "resume_step": int(resume_step),
                     "cause": "join"}).encode("utf-8")
                try:
                    _send_all(conn, _frame_bytes(self.generation, KIND_WELCOME,
                                                 welcome), self.timeout)
                except OSError:
                    conn.close()
                    self.world -= 1
                    info["world"] = self.world
                    continue
                self._conns[nr] = conn
                self._addr[nr] = addr
                self._readers[nr] = reader
                self._send_locks[nr] = threading.Lock()
                self._last_heard[nr] = time.monotonic()
                self._inbox[nr] = collections.deque()
        # REFORM goes to the PRE-EXISTING peers only — the joiners were
        # welcomed directly and must not see a reform for the generation
        # they just entered at
        payload = json.dumps({**info,
                              "rank_map": {str(k): v for k, v
                                           in info["rank_map"].items()}
                              }).encode("utf-8")
        frame = _frame_bytes(self.generation, KIND_REFORM, payload)
        for r, conn in existing:
            lock = self._send_locks.get(r)
            if lock is None:
                continue
            try:
                with lock:
                    _send_all(conn, frame, self.timeout)
                self.bytes_sent += len(frame)
            except OSError:
                pass        # reactor will reform on the dead socket
        self._instr().record_reform("join", None, self.generation,
                                    self.world)
        return info

    def request_evict(self, rank: int, resume_step: Optional[int] = None,
                      cause: str = "shrink") -> Dict[str, Any]:
        """Externally-initiated shrink (the pod arbiter reclaiming a
        slice): evict `rank` exactly as if it had crashed, but at a
        COORDINATED resume step — the caller checkpoints at that step
        first, so the evicted worker's slice can be handed off while the
        survivors bitwise-resume.  The evicted peer receives the same
        eviction-notice REFORM frame a partitioned straggler would
        (-> GangEvictedError -> park/rejoin); the coordinator's own loop
        sees GangReformed on its next collective.  Coordinator only."""
        if self.rank != 0:
            raise RuntimeError("request_evict is coordinator-only")
        if rank == 0:
            raise ValueError("cannot evict the coordinator (rank 0)")
        return self._reform(lost={rank}, cause=cause,
                            resume_step=resume_step)

    # ------------------------------------------------------------------
    # allgather
    # ------------------------------------------------------------------
    def allgather(self, payload: bytes) -> List[bytes]:
        if self.rank == 0:
            return self._allgather_coordinator(payload)
        return self._allgather_peer(payload)

    def _allgather_coordinator(self, payload: bytes) -> List[bytes]:
        with self._lock:
            self._raise_pending_reform()
            peer_ranks = sorted(self._conns)
        if not peer_ranks:
            return [payload]
        deadline = time.monotonic() + self.failure_deadline
        gathered: Dict[int, bytes] = {}
        with self._cond:
            while True:
                self._raise_pending_reform()
                missing = [r for r in sorted(self._conns)
                           if not self._inbox.get(r)]
                if not missing:
                    break
                if time.monotonic() > deadline:
                    # alive (heartbeating) but shipping no data: straggler
                    stragglers = set(missing)
                    self._lock.release()
                    try:
                        self._reform(lost=stragglers, cause="straggler")
                    finally:
                        self._lock.acquire()
                    self._raise_pending_reform()
                self._cond.wait(0.05)
            for r in sorted(self._conns):
                gathered[r] = self._inbox[r].popleft()
        out: List[bytes] = [b""] * self.world
        out[0] = payload
        for r, g in gathered.items():
            out[r] = g
        blob = struct.pack("<I", self.world) + b"".join(
            struct.pack("<Q", len(g)) + g for g in out)
        failed = self._coord_broadcast(KIND_DATA, blob, best_effort=True)
        if failed:
            self._reform(lost=set(failed), cause="crash")
            with self._lock:
                self._raise_pending_reform()
        return out

    def _allgather_peer(self, payload: bytes) -> List[bytes]:
        # consume anything that arrived mid-compute FIRST: a REFORM must
        # win over sending data that would only be fenced as stale
        self._drain_nonblocking()
        self._process_buffered(expect_data=False)
        try:
            self._peer_send(KIND_DATA, payload)
        except OSError as e:
            self.close()
            raise PeerUnreachableError(
                f"rank {self.rank}: gang coordinator at "
                f"{self.host}:{self.port} send failed: {e!r}") from e
        while True:
            blob = self._process_buffered(expect_data=True)
            if blob is not None:
                break
            self._recv_tick()
        (world,) = struct.unpack_from("<I", blob, 0)
        off = 4
        gathered = []
        for _ in range(world):
            (n,) = struct.unpack_from("<Q", blob, off)
            off += 8
            gathered.append(blob[off: off + n])
            off += n
        return gathered

    def _recv_tick(self) -> None:
        """One bounded blocking read on the coordinator socket; enforces
        the failure deadline on total silence (heartbeats reset it, so a
        healthy-but-busy coordinator never trips it)."""
        self._sock.settimeout(min(0.1, self.heartbeat_interval))
        try:
            data = self._sock.recv(1 << 16)
        except (socket.timeout, TimeoutError):
            silence = time.monotonic() - self._last_recv
            if silence > self.failure_deadline:
                self.close()
                raise PeerUnreachableError(
                    f"rank {self.rank}: gang coordinator at "
                    f"{self.host}:{self.port} silent for "
                    f"{silence:.2f}s (deadline "
                    f"{self.failure_deadline:.2f}s) — coordinator dead "
                    "or partitioned")
            return
        except OSError as e:
            self.close()
            raise PeerUnreachableError(
                f"rank {self.rank}: gang coordinator connection failed: "
                f"{e!r}") from e
        if not data:
            self.close()
            raise PeerUnreachableError(
                f"rank {self.rank}: gang coordinator at "
                f"{self.host}:{self.port} closed the connection")
        self.bytes_received += len(data)
        self._last_recv = time.monotonic()
        self._frames.extend(self._reader.feed(data))

    def _drain_nonblocking(self) -> None:
        eof = False
        if self._sock is None:
            eof = True
        else:
            self._sock.setblocking(False)
            try:
                while True:
                    data = self._sock.recv(1 << 16)
                    if not data:
                        eof = True
                        break
                    self.bytes_received += len(data)
                    self._last_recv = time.monotonic()
                    self._frames.extend(self._reader.feed(data))
            except (BlockingIOError, InterruptedError):
                pass
            except OSError:
                eof = True
            finally:
                if self._sock is not None:
                    self._sock.setblocking(True)
        if eof:
            # a buffered eviction/reform notice explains the close far
            # better than a bare connection error — surface it first
            self._process_buffered(expect_data=False)
            self.close()
            raise PeerUnreachableError(
                f"rank {self.rank}: gang coordinator at "
                f"{self.host}:{self.port} closed the connection")

    def _process_buffered(self,
                          expect_data: bool) -> Optional[bytes]:
        """Handle queued frames; returns the current-generation DATA
        broadcast when one is present (and `expect_data`)."""
        while self._frames:
            gen, kind, payload = self._frames.popleft()
            if kind == KIND_HB:
                continue
            if kind == KIND_REFORM:
                self._apply_reform(payload)        # raises
            if kind == KIND_DATA:
                if gen != self.generation:
                    self._count_stale()
                    continue
                if expect_data:
                    return payload
                self._count_stale()     # unexpected round data: fence it
        return None

    def _apply_reform(self, payload: bytes) -> None:
        d = json.loads(payload.decode("utf-8"))
        rank_map = {int(k): int(v) for k, v in d["rank_map"].items()}
        if self.rank not in rank_map:
            self.close()
            raise GangEvictedError(
                f"rank {self.rank}: declared lost in generation "
                f"{d['generation']} (cause={d.get('cause')}) — rejoin "
                "with join=True to re-enter the gang")
        self.generation = int(d["generation"])
        self.world = int(d["world"])
        self.rank = rank_map[self.rank]
        self._instr().record_membership(self.generation, self.world)
        raise GangReformed({**d, "rank": self.rank,
                            "rank_map": rank_map})

    # ------------------------------------------------------------------
    def stats(self) -> Dict[str, Any]:
        return {"rank": self.rank, "world": self.world,
                "generation": self.generation,
                "reformations": self.reformations,
                "stale_frames": self.stale_frames,
                "bytes_sent": self.bytes_sent,
                "bytes_received": self.bytes_received}

    def close(self) -> None:
        """Idempotent; stops the heartbeat/reactor threads and closes
        every socket (peers, server, parked joiners, half-open
        handshakes)."""
        if self._closed:
            return
        self._closed = True
        self._stop.set()
        for t in (self._reactor_thread, self._hb_thread):
            if t is not None and t is not threading.current_thread():
                t.join(timeout=2.0)
        with self._lock:
            socks = list(self._conns.values())
            socks += [c for c, _, _ in self._joiners]
            socks += [c for c, _, _ in self._handshaking]
            self._conns, self._joiners = {}, []
            self._handshaking = []
        for s in socks:
            try:
                s.close()
            except OSError:
                pass
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None
        if self._server is not None:
            try:
                self._server.close()
            except OSError:
                pass
            self._server = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
