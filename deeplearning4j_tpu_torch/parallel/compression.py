"""Compressed gradient exchange between the processes of a gang (the port
of ``parallel/compression.py``).

Reference: ``EncodedGradientsAccumulator`` and the Aeron publish/receive
path: threshold-quantized deltas between nodes.  Here it is a host-side
exchange: encode locally (the C++ codec, ``native_ops.ThresholdCodec``),
ship the sparse streams over a transport (``parallel/transport.py``),
decode every rank's stream and sum.  The apply is synchronous; the
reference's asynchronous staleness is dropped, as in the JAX package.

A gradient tree is nested dicts (or tuples and lists) of arrays, flattened
in ``jax.tree_util`` order: dict keys sorted, so ``layer_10`` comes before
``layer_2``.  Callers hand the leaves in the JAX package's layouts (a conv
kernel HWIO), so a leaf's codec, its stream's indices and the bytes on the
wire are those of the JAX package for the same network.
"""
from __future__ import annotations

from typing import Any, List, Optional, Tuple

import numpy as np

from deeplearning4j_tpu_torch.native_ops import ThresholdCodec

_LEAF = object()


def _flatten(tree, leaves: list):
    if isinstance(tree, dict):
        return {k: _flatten(tree[k], leaves) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_flatten(v, leaves) for v in tree)
    if tree is None:
        return None
    leaves.append(tree)
    return _LEAF


def tree_flatten(tree) -> Tuple[list, Any]:
    """(leaves in ``jax.tree_util`` order, a skeleton for
    :func:`tree_unflatten`).  None is an empty subtree, as in JAX."""
    leaves: list = []
    return leaves, _flatten(tree, leaves)


def tree_unflatten(skeleton, leaves) -> Any:
    it = iter(leaves)

    def build(s):
        if s is _LEAF:
            return next(it)
        if isinstance(s, dict):
            return {k: build(v) for k, v in s.items()}
        if isinstance(s, (list, tuple)):
            return type(s)(build(v) for v in s)
        return s
    return build(skeleton)


def _host(a) -> np.ndarray:
    """A leaf as a numpy array (a tensor crosses to the host)."""
    if hasattr(a, "detach"):
        return a.detach().cpu().numpy()
    return np.asarray(a)


class CompressedGradientExchange:
    """Per-leaf threshold codecs over a gradient tree."""

    def __init__(self, params_template, threshold: float = 1e-3,
                 adaptive_target_density: float = 1e-2):
        leaves, self._treedef = tree_flatten(params_template)
        self._shapes = [np.shape(l) for l in leaves]
        self.codecs: List[ThresholdCodec] = [
            ThresholdCodec(int(np.prod(s) or 1), threshold) for s in self._shapes]
        self.target_density = adaptive_target_density

    def encode(self, grads) -> List[np.ndarray]:
        """Tree -> list of sparse int32 streams (residuals carried).

        The adaptive threshold (the ResidualPostProcessor role) moves after
        each encode by the density of the stream it emitted: up by 1.2 when
        denser than twice the target, down by 1.2 when sparser than half of
        it (and above 1e-6), in Python floats."""
        leaves, _ = tree_flatten(grads)
        out = []
        self._used_thresholds = []
        for codec, leaf in zip(self.codecs, leaves):
            self._used_thresholds.append(codec.threshold)
            stream = codec.encode(_host(leaf))
            out.append(stream)
            d = len(stream) / codec.size
            if d > 2 * self.target_density:
                codec.threshold *= 1.2
            elif d < self.target_density / 2 and codec.threshold > 1e-6:
                codec.threshold /= 1.2
        return out

    def thresholds(self) -> List[float]:
        """The thresholds the most recent encode used (what decode needs)."""
        return getattr(self, "_used_thresholds", [c.threshold for c in self.codecs])

    def decode(self, streams: List[np.ndarray],
               thresholds: Optional[List[float]] = None):
        """Sparse streams -> dense gradient tree.  `thresholds` defaults to
        the most recent encode's only when None; an explicit list (empty,
        for a tree without leaves) is taken as given, and it never changes
        the codecs' state."""
        if thresholds is None:
            thresholds = self.thresholds()
        dense = [codec.decode(enc, threshold=thr).reshape(shape)
                 for codec, enc, shape, thr in zip(self.codecs, streams, self._shapes,
                                                   thresholds)]
        return tree_unflatten(self._treedef, dense)

    def compression_ratio(self, streams: List[np.ndarray]) -> float:
        dense_bytes = sum(4 * int(np.prod(s) or 1) for s in self._shapes)
        sparse_bytes = sum(4 * (len(s) + 1) for s in streams)
        return dense_bytes / max(sparse_bytes, 1)

    # ---- error-feedback residual management ----
    def residuals(self) -> List[np.ndarray]:
        """Per-leaf error-feedback residuals (live views, not copies)."""
        return [c.residual for c in self.codecs]

    def residual_norm(self) -> float:
        """Total l2 mass parked in the residuals."""
        return float(np.sqrt(sum(float(np.dot(c.residual, c.residual))
                                 for c in self.codecs)))

    def reset_residuals(self) -> None:
        """Zero the error-feedback state (a rewind to a checkpoint: the
        parked residual came from steps the rewind discards)."""
        for c in self.codecs:
            c.residual[:] = 0.0

    def take_residuals(self) -> List[np.ndarray]:
        """Detach and return the residuals, zeroing the codecs' state."""
        out = [c.residual.copy() for c in self.codecs]
        self.reset_residuals()
        return out

    def flush_into(self, residuals: List[np.ndarray]) -> None:
        """Add residuals taken earlier into these codecs, so the next encode
        emits them (shapes checked leaf by leaf)."""
        for c, r in zip(self.codecs, residuals):
            if r.shape != c.residual.shape:
                raise ValueError(f"residual shape {r.shape} != codec {c.residual.shape}")
            c.residual += r.astype(np.float32, copy=False)


def allreduce_compressed(exchange: CompressedGradientExchange, transport, grads):
    """Sum a gradient tree over the ranks through the codec: encode locally
    (residuals carried), all-gather the streams over `transport` (a
    ``transport.TcpGradientMesh``), decode every rank's stream at its own
    thresholds and sum in rank order."""
    from deeplearning4j_tpu_torch.parallel.transport import pack_streams, unpack_streams
    streams = exchange.encode(grads)
    payload = pack_streams(streams, exchange.thresholds())
    total = None
    for peer_payload in transport.allgather(payload):
        peer_streams, peer_thr = unpack_streams(peer_payload)
        dense = exchange.decode(peer_streams, peer_thr)
        total = dense if total is None else _tree_add(total, dense)
    return total


def allreduce_dense(transport, grads):
    """Sum a gradient tree over the ranks shipping full-precision f32
    leaves: the uncompressed A/B baseline.  The same star all-gather, no
    codec, no residuals; peers are summed in rank order from rank 0's."""
    from deeplearning4j_tpu_torch.parallel.transport import pack_dense, unpack_dense
    leaves, treedef = tree_flatten(grads)
    payload = pack_dense([_host(l) for l in leaves])
    total = None
    for peer_payload in transport.allgather(payload):
        peer = unpack_dense(peer_payload)
        total = peer if total is None else [a + b for a, b in zip(total, peer)]
    return tree_unflatten(treedef, total)


def _tree_add(a, b):
    la, treedef = tree_flatten(a)
    lb, _ = tree_flatten(b)
    return tree_unflatten(treedef, [x + y for x, y in zip(la, lb)])
