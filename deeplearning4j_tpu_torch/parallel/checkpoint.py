"""Sharded checkpoints (the port of ``parallel/checkpoint.py``), in the JAX
package's format, so each package reads the other's.

Every rank writes only the chunks it owns, and a restore assembles each
leaf for whatever layout the new job wants, from whichever saved chunks
meet it (a checkpoint saved on 2 ranks loads on 1, and the reverse).  One
checkpoint is one directory on storage every rank reaches:

- ``shards-{rank}.npz``: the chunk payloads this rank wrote.  A replicated
  leaf is written once, by rank 0; a sharded leaf (a ZeRO-1 moment) by
  each rank, its own rows.
- ``index-{rank}.json``: for each chunk, the flat leaf id, the global
  window ``[[start, stop], ...]`` it covers and its crc32.
- ``manifest.json``: written by rank 0 after a barrier: the flat leaves'
  global shapes and dtypes, the tree structure as the JAX package prints
  it (``str(jax.tree_util.tree_flatten(tree)[1])``, :func:`treedef_str`),
  and the caller's metadata.  Its presence commits the checkpoint.

A tree is nested dicts (keys sorted, as JAX flattens them), lists, tuples
and None (no leaf), with leaves that are numpy arrays or tensors
(replicated) or :class:`ShardedLeaf` (this rank's window of a leaf).
:func:`save_model_sharded` / :func:`load_model_sharded` save and restore a
MultiLayerNetwork's or ComputationGraph's ``{"params", "state", "opt"}``
in the JAX package's layouts (``convert.py``), the ZeRO-1 moments as the
padded, sharded leaves the JAX package saves on the same mesh.
"""
from __future__ import annotations

import dataclasses
import json
import os
import zlib
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

MANIFEST = "manifest.json"
FORMAT = "deeplearning4j_tpu.sharded.v1"


class ChecksumError(ValueError):
    """A chunk's payload does not match the crc32 its index records: the
    bytes were corrupted after commit.  Restoring them again cannot
    succeed; fall back to an older intact checkpoint."""


@dataclasses.dataclass
class ShardedLeaf:
    """This rank's window of a leaf of global `shape`: `window` is
    ``[[start, stop], ...]`` per dim, `data` the window's values (None in a
    load template)."""

    shape: Tuple[int, ...]
    dtype: Any
    window: List[List[int]]
    data: Optional[np.ndarray] = None


def _crc32(arr: np.ndarray) -> int:
    return zlib.crc32(np.ascontiguousarray(arr).tobytes()) & 0xFFFFFFFF


def _window(index, shape) -> List[List[int]]:
    """A tuple of slices -> [[start, stop], ...]."""
    out = []
    for sl, dim in zip(index, shape):
        start = 0 if sl.start is None else int(sl.start)
        stop = dim if sl.stop is None else int(sl.stop)
        out.append([start, stop])
    return out


def _numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _leaves(tree) -> List[Any]:
    """The leaves of `tree` in ``jax.tree_util.tree_leaves`` order."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _unflatten(tree, leaves):
    it = iter(leaves)

    def build(t):
        if t is None:
            return None
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        if isinstance(t, (list, tuple)):
            return type(t)(build(v) for v in t)
        return next(it)
    return build(tree)


def treedef_str(tree) -> str:
    """The tree's structure as ``str(jax.tree_util.tree_flatten(tree)[1])``
    prints it: dicts with sorted keys, lists, tuples, None, ``*`` a leaf."""
    def render(t):
        if t is None:
            return "None"
        if isinstance(t, dict):
            return "{" + ", ".join(f"{k!r}: {render(t[k])}" for k in sorted(t)) + "}"
        if isinstance(t, list):
            return "[" + ", ".join(render(v) for v in t) + "]"
        if isinstance(t, tuple):
            inner = ", ".join(render(v) for v in t)
            return "(" + inner + ("," if len(t) == 1 else "") + ")"
        return "*"
    return f"PyTreeDef({render(tree)})"


def _rank_world(mesh=None) -> Tuple[int, int]:
    """This rank's place and the number of ranks: the mesh's where one is
    given (a mesh over part of the ranks, a host's), else the default
    group's."""
    if mesh is not None:
        return (mesh.rank, mesh.size) if mesh.distributed else (0, 1)
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _barrier(world: int, mesh=None) -> None:
    if world > 1:
        import torch.distributed as dist
        dist.barrier(group=None if mesh is None else mesh.group_all)


def save_sharded(directory: str, tree: Any, metadata: Optional[Dict[str, Any]] = None,
                 mesh=None) -> None:
    """Write `tree` as a sharded checkpoint; every rank of the process
    group (of `mesh`, where given) calls it with its own tree (its own
    windows of the sharded leaves); the files are numbered by the rank's
    place in that group."""
    rank, world = _rank_world(mesh)
    os.makedirs(directory, exist_ok=True)
    chunks: Dict[str, np.ndarray] = {}
    index: List[Dict[str, Any]] = []
    specs = []
    for i, leaf in enumerate(_leaves(tree)):
        if isinstance(leaf, ShardedLeaf):
            specs.append({"shape": list(leaf.shape), "dtype": str(np.dtype(leaf.dtype))})
            arr, window = np.asarray(leaf.data), leaf.window
        else:
            arr = _numpy(leaf)
            specs.append({"shape": list(arr.shape), "dtype": str(arr.dtype)})
            if rank != 0:
                continue
            window = _window((slice(None),) * arr.ndim, arr.shape)
        key = f"leaf{i}_chunk0"
        chunks[key] = arr
        index.append({"leaf": i, "key": key, "window": window, "crc32": _crc32(arr)})
    np.savez(os.path.join(directory, f"shards-{rank}.npz"), **chunks)
    with open(os.path.join(directory, f"index-{rank}.json"), "w") as f:
        json.dump(index, f)
    _barrier(world, mesh)
    if rank == 0:
        # leftovers of an earlier save on more ranks would merge stale chunks
        for name in os.listdir(directory):
            stale = None
            if name.startswith("index-") and name.endswith(".json"):
                stale = int(name[len("index-"):-len(".json")])
            elif name.startswith("shards-") and name.endswith(".npz"):
                stale = int(name[len("shards-"):-len(".npz")])
            if stale is not None and stale >= world:
                os.remove(os.path.join(directory, name))
        manifest = {"format": FORMAT, "num_ranks_at_save": world, "leaves": specs,
                    "treedef": treedef_str(tree), "metadata": metadata or {}}
        tmp = os.path.join(directory, MANIFEST + ".tmp")
        with open(tmp, "w") as f:
            json.dump(manifest, f)
        os.replace(tmp, os.path.join(directory, MANIFEST))
    _barrier(world, mesh)


def read_metadata(directory: str) -> Dict[str, Any]:
    with open(os.path.join(directory, MANIFEST)) as f:
        return json.load(f)["metadata"]


class _ChunkStore:
    """Lazy reader over every rank's chunk files at save time."""

    def __init__(self, directory: str, num_ranks: Optional[int] = None):
        self.directory = directory
        self.by_leaf: Dict[int, List[Dict[str, Any]]] = {}
        self._files: Dict[int, Any] = {}
        self._verified: set = set()
        for name in sorted(os.listdir(directory)):
            if not (name.startswith("index-") and name.endswith(".json")):
                continue
            rank = int(name[len("index-"):-len(".json")])
            if num_ranks is not None and rank >= num_ranks:
                continue  # stale leftover from a larger previous job
            with open(os.path.join(directory, name)) as f:
                for entry in json.load(f):
                    entry = dict(entry, rank=rank)
                    self.by_leaf.setdefault(entry["leaf"], []).append(entry)

    def _file(self, rank: int):
        if rank not in self._files:
            self._files[rank] = np.load(os.path.join(self.directory, f"shards-{rank}.npz"))
        return self._files[rank]

    def _chunk(self, entry: Dict[str, Any]) -> np.ndarray:
        """One chunk payload, crc32-checked against its index entry once."""
        data = self._file(entry["rank"])[entry["key"]]
        want = entry.get("crc32")
        ident = (entry["rank"], entry["key"])
        if want is not None and ident not in self._verified:
            got = _crc32(data)
            if got != int(want):
                raise ChecksumError(
                    f"checksum mismatch for chunk {entry['key']} of rank {entry['rank']} in "
                    f"{self.directory}: index records crc32={int(want):#010x}, payload "
                    f"hashes {got:#010x}: checkpoint bytes corrupted after commit")
            self._verified.add(ident)
        return data

    def assemble(self, leaf: int, window: Sequence[Sequence[int]], dtype) -> np.ndarray:
        """The global window [[start, stop], ...] of a leaf, from every
        saved chunk that meets it."""
        shape = tuple(stop - start for start, stop in window)
        out = np.empty(shape, dtype)
        filled = np.zeros(shape, bool)
        for entry in self.by_leaf.get(leaf, []):
            cw = entry["window"]
            inter = [(max(a0, b0), min(a1, b1)) for (a0, a1), (b0, b1) in zip(window, cw)]
            if any(lo >= hi for lo, hi in inter):
                continue
            data = self._chunk(entry)
            src = tuple(slice(lo - c0, hi - c0) for (lo, hi), (c0, _) in zip(inter, cw))
            dst = tuple(slice(lo - w0, hi - w0) for (lo, hi), (w0, _) in zip(inter, window))
            out[dst] = data[src]
            filled[dst] = True
        if not filled.all():
            raise ValueError(f"checkpoint is missing data for leaf {leaf} window {window}: "
                             "saved with an incompatible layout?")
        return out


def _manifest(directory: str) -> Dict[str, Any]:
    if not os.path.exists(os.path.join(directory, MANIFEST)):
        raise FileNotFoundError(f"{directory}: no committed checkpoint (manifest.json absent)")
    with open(os.path.join(directory, MANIFEST)) as f:
        return json.load(f)


def load_sharded(directory: str, like: Any) -> Any:
    """Restore a tree saved by `save_sharded` (either package's).  `like`
    gives the structure and, per leaf, what to read: a :class:`ShardedLeaf`
    template (its global shape, dtype and this rank's window) or an array
    (the whole leaf).  Returns `like`'s tree with numpy leaves (a
    ShardedLeaf's window only).  Structure, shapes and dtypes must match
    the manifest."""
    manifest = _manifest(directory)
    store = _ChunkStore(directory, num_ranks=manifest.get("num_ranks_at_save"))
    saved = manifest.get("treedef")
    mine = treedef_str(like)
    if saved is not None and mine != saved:
        raise ValueError(
            "template tree structure does not match the checkpoint: a same-shaped tree "
            f"in another structure would permute parameters.\n  saved:    {saved}\n"
            f"  template: {mine}")
    leaves = _leaves(like)
    if len(leaves) != len(manifest["leaves"]):
        raise ValueError(f"template has {len(leaves)} leaves but checkpoint has "
                         f"{len(manifest['leaves'])}")
    out = []
    for i, (leaf, spec) in enumerate(zip(leaves, manifest["leaves"])):
        shape, dtype = tuple(spec["shape"]), np.dtype(spec["dtype"])
        if isinstance(leaf, ShardedLeaf):
            t_shape, t_dtype, window = tuple(leaf.shape), np.dtype(leaf.dtype), leaf.window
        else:
            arr = leaf if isinstance(leaf, torch.Tensor) else np.asarray(leaf)
            t_shape = tuple(arr.shape)
            t_dtype = np.dtype(str(arr.dtype).replace("torch.", ""))
            window = [[0, d] for d in shape]
        if t_shape != shape:
            raise ValueError(f"leaf {i}: template shape {t_shape} != saved {shape}")
        if t_dtype != dtype:
            raise ValueError(f"leaf {i}: template dtype {t_dtype} != saved {dtype}: "
                             "cast after load for precision changes")
        out.append(store.assemble(i, window, dtype))
    return _unflatten(like, out)


def verify_checkpoint(directory: str) -> None:
    """Integrity check of a committed checkpoint without a template: parse
    the manifest, then crc32-check every indexed chunk.  Raises
    `FileNotFoundError` (uncommitted or missing), `ChecksumError`
    (corrupted payload) or `ValueError` (unreadable manifest, index or
    chunk file)."""
    manifest = _manifest(directory)
    try:
        store = _ChunkStore(directory, num_ranks=manifest.get("num_ranks_at_save"))
        for entries in store.by_leaf.values():
            for entry in entries:
                store._chunk(entry)
    except (ChecksumError, FileNotFoundError):
        raise
    except Exception as e:
        # a bad zip, bad JSON, a missing chunk key, a truncated payload
        raise ValueError(f"{directory}: unreadable checkpoint: {e!r}") from e


# ---------------------------------------------------------------------------
# Networks (MultiLayerNetwork / ComputationGraph)
# ---------------------------------------------------------------------------

def _marked_opt_state(net, zt) -> Dict[str, Any]:
    """Each layer's ZeRO-1 updater state with every tensor as (tensor,
    plan, tensor-parallel split): its parameter's `LeafPlan` where it
    mirrors one, None where not (a step count), and the parameter's
    ``LeafShard`` where the sharding rules split it (None elsewhere)."""
    from deeplearning4j_tpu_torch.parallel.zero import _map_paths
    from deeplearning4j_tpu_torch.train.updaters import tree_map_like_params
    tp = getattr(net, "_tp", None)

    def split(name, path):
        sub = tp.plans.get(name, {}) if tp is not None else {}
        for k in path:
            sub = sub.get(k) if isinstance(sub, dict) else None
        return sub if sub is not None and not isinstance(sub, dict) else None

    def mark(name):
        return lambda sub, plan_sub: _map_paths(
            lambda path, pl, t: (t, pl, split(name, path)), plan_sub, sub)
    return {name: tree_map_like_params(mark(name), sub, zt.plans[name],
                                       lambda t: t if isinstance(t, tuple) else (t, None, None),
                                       shape_of=lambda pl: pl.stored_shape)
            for name, sub in net.opt_state_.items()}


def _map_marked(fn, marked, *rest):
    """fn(tensor, plan, split, *rest leaves) over a marked tree's triples;
    empty states pass through."""
    if isinstance(marked, dict):
        return {k: _map_marked(fn, v, *(r[k] for r in rest)) for k, v in marked.items()}
    if not marked:
        return marked
    return fn(*marked, *rest)


def _opt_tree(net, template: bool):
    """The network's updater state in the JAX package's layouts: under
    ZeRO-1 each sharded moment is a :class:`ShardedLeaf` (this rank's rows
    of the padded leaf), as the JAX package saves it on the same mesh, and
    the moment of a leaf the sharding rules split is gathered whole (a
    chunk rank 0 writes)."""
    from deeplearning4j_tpu_torch import convert
    from deeplearning4j_tpu_torch.parallel.collectives import _gather
    zt = getattr(net, "_step_transform", None)
    if zt is None:
        return convert.opt_state_to_jax(net)

    def leaf(t, pl, ls):
        if pl is None:
            return _numpy(t)
        if pl.kind == "shard":
            lo = zt.coord * pl.rows
            window = [[lo, lo + pl.rows]] + [[0, d] for d in pl.shape[1:]]
            return ShardedLeaf(pl.padded_shape, _dtype(t), window,
                               None if template else _numpy(t))
        if ls is not None:
            t = _gather(t.contiguous(), net._tp.mesh, ls.axis, ls.dim)
        return _numpy(pl.to_jax(t).contiguous())
    return _map_marked(leaf, _marked_opt_state(net, zt))
def _dtype(t) -> np.dtype:
    return np.dtype(str(t.dtype).replace("torch.", ""))


def _model_tree(net, template: bool = False) -> Dict[str, Any]:
    from deeplearning4j_tpu_torch import convert
    return {"params": convert.params_to_jax(net), "state": convert.state_to_jax(net),
            "opt": _opt_tree(net, template)}


def _mesh_of(net):
    """The mesh of the network's data-parallel step (a wrapper's), or None."""
    dp = getattr(net, "_dp", None)
    return None if dp is None else dp.mesh


def save_model_sharded(net, directory: str) -> None:
    """Sharded save of a MultiLayerNetwork or ComputationGraph: parameters,
    layer state, updater state (ZeRO-1's shards as they are) and the
    counters; the configuration travels in the manifest.  Every rank of
    the network's wrapper mesh calls it (of the default group without a
    wrapper); a mesh over part of the ranks, or a host's, numbers the
    files and meets at its barriers by its own ranks."""
    save_sharded(directory, _model_tree(net), metadata={
        "config": net.conf.to_json(), "iteration": net.iteration, "epoch": net.epoch},
        mesh=_mesh_of(net))


@torch.no_grad()
def assign_model_tree(net, tree: Dict[str, Any]) -> None:
    """Write a loaded ``{"params", "state", "opt"}`` tree (numpy, the JAX
    package's layouts; under ZeRO-1 this rank's windows of the sharded
    moments) into the network's own tensors, in place, so a captured fused
    block keeps replaying them."""
    from deeplearning4j_tpu_torch import convert
    convert.params_from_jax(net, tree["params"])
    convert.state_from_jax(net, tree["state"])
    zt = getattr(net, "_step_transform", None)
    if zt is None:
        convert.opt_state_from_jax(net, tree["opt"])
    else:
        from deeplearning4j_tpu_torch.parallel.sharding import _block

        def put(t, pl, ls, arr):
            got = torch.from_numpy(np.asarray(arr))
            if pl is not None and pl.kind == "repl":
                got = pl.to_port(got)
                if ls is not None:
                    got = _block(got, ls, net._tp.mesh.coordinate(ls.axis))
            t.copy_(got)
        _map_marked(put, _marked_opt_state(net, zt), tree["opt"])


@torch.no_grad()
def load_model_sharded(net, directory: str):
    """Restore into an ``init()``-ed network (every rank calls it): the
    parameters, layer state and updater state are written into the
    network's tensors in place (a captured fused block keeps replaying
    them), each rank reading its own shards of a ZeRO-1 updater state.
    Returns `net`."""
    tree = load_sharded(directory, _model_tree(net, template=True))
    meta = read_metadata(directory)
    assign_model_tree(net, tree)
    net.iteration = meta["iteration"]
    net.epoch = meta["epoch"]
    return net
