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

Pure sockets and numpy.  ``ElasticGradientMesh`` (generation-fenced
frames, heartbeats, re-formation) is not ported yet.
"""
from __future__ import annotations

import socket
import struct
import time
from typing import List, Optional

import numpy as np


class PeerUnreachableError(ConnectionError):
    """A gradient-mesh peer could not be reached (connect) or stopped
    responding (exchange).  The message names the rank and address."""


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
