"""ModelSerializer: checkpoint read/write (the port of
``utils/serialization.py``).

One zip, shared with the JAX package: ``configuration.json`` (the
configuration's JSON, the same string in both packages), ``manifest.json``
(format tag ``deeplearning4j_tpu.model.v1``, ``iteration``, ``epoch``, and
the shape and numpy dtype name of every leaf of ``params``, ``state`` and,
when saved, ``updater``), ``coefficients.bin``, ``layerState.bin`` and
``updaterState.bin`` (every leaf's raw little-endian bytes, one after
another), and an optional ``normalizer.bin``.  Members are
``ZIP_DEFLATED``.

Leaves go in the JAX package's ``jax.tree_util.tree_leaves`` order (dict
keys sorted as strings at every level) and in its layouts: a conv ``W`` and
each of its updater moments are HWIO in the zip, OIHW in the port
(``convert.layout_leaves``).  numpy has no bfloat16: a bf16 leaf is
written and read as the bits of a ``torch.uint16`` view, under the dtype
name ``"bfloat16"`` the JAX package writes.  A zip written by either
package loads in the other, and a model restored from it resumes training
exactly: parameters, layer state, updater state and the iteration and
epoch counters all come back.
"""
from __future__ import annotations

import json
import zipfile
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch import convert

CONFIG_JSON = "configuration.json"
COEFFICIENTS_BIN = "coefficients.bin"
UPDATER_BIN = "updaterState.bin"
STATE_BIN = "layerState.bin"
MANIFEST_JSON = "manifest.json"
NORMALIZER_BIN = "normalizer.bin"
FORMAT = "deeplearning4j_tpu.model.v1"

_BF16 = "bfloat16"


def _to_bytes(t: torch.Tensor):
    """(raw bytes, numpy dtype name) of one leaf, already in the JAX
    layout."""
    t = t.detach().contiguous().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.uint16).numpy().tobytes(), _BF16
    a = t.numpy()
    return a.tobytes(), str(a.dtype)


def _from_bytes(buf: bytes, offset: int, entry) -> Tuple[torch.Tensor, int]:
    """One leaf read from `buf` at `offset` per its manifest entry; returns
    it (a CPU tensor in the JAX layout) and the offset after it.  A leaf of
    shape [] holds one element."""
    shape = list(entry["shape"])
    n = int(np.prod(shape)) if shape else 1
    if entry["dtype"] == _BF16:
        raw = np.frombuffer(buf, np.uint16, count=n, offset=offset)
        t = torch.from_numpy(raw.copy()).view(torch.bfloat16)
        size = 2
    else:
        dt = np.dtype(entry["dtype"])
        t = torch.from_numpy(np.frombuffer(buf, dt, count=n, offset=offset).copy())
        size = dt.itemsize
    return t.reshape(shape), offset + n * size


def _tree_to_flat(net, tree):
    """The leaves of a network-keyed tree as one buffer and its manifest
    list."""
    chunks, manifest = [], []
    for t, perm in convert.layout_leaves(net, tree):
        jt = t.permute(*convert._inverse(perm)) if perm is not None else t
        data, dtype = _to_bytes(jt)
        chunks.append(data)
        manifest.append({"shape": list(jt.shape), "dtype": dtype})
    return b"".join(chunks), manifest


@torch.no_grad()
def _flat_to_tree(net, tree, buf: bytes, manifest: List[dict], what: str) -> None:
    """Copy the leaves of `buf` into the tensors of `tree`, in place."""
    leaves = convert.layout_leaves(net, tree)
    if len(leaves) != len(manifest):
        raise ValueError(f"{what}: the zip holds {len(manifest)} leaves, the "
                         f"model has {len(leaves)}")
    off = 0
    for (t, perm), entry in zip(leaves, manifest):
        a, off = _from_bytes(buf, off, entry)
        if perm is not None:
            a = a.permute(*perm)
        if tuple(a.shape) != tuple(t.shape):
            raise ValueError(f"{what}: leaf of shape {tuple(a.shape)} (port "
                             f"layout) where the model has {tuple(t.shape)}")
        t.copy_(a)
    if off != len(buf):
        raise ValueError(f"{what}: {len(buf) - off} bytes left over")


def write_model(net, path: str, save_updater: bool = True,
                normalizer=None) -> None:
    """Write a MultiLayerNetwork or ComputationGraph to `path`."""
    params_buf, params_manifest = _tree_to_flat(net, net.params_)
    state_buf, state_manifest = _tree_to_flat(net, net.state_)
    manifest = {
        "format": FORMAT,
        "iteration": int(net.iteration),
        "epoch": int(net.epoch),
        "params": params_manifest,
        "state": state_manifest,
    }
    upd_buf = b""
    if save_updater and net.opt_state_ is not None:
        upd_buf, upd_manifest = _tree_to_flat(net, net.opt_state_)
        manifest["updater"] = upd_manifest
    with zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED) as z:
        z.writestr(CONFIG_JSON, net.conf.to_json())
        z.writestr(MANIFEST_JSON, json.dumps(manifest))
        z.writestr(COEFFICIENTS_BIN, params_buf)
        z.writestr(STATE_BIN, state_buf)
        if upd_buf:
            z.writestr(UPDATER_BIN, upd_buf)
        if normalizer is not None:
            z.writestr(NORMALIZER_BIN, normalizer.to_bytes())


def read_model(path: str, load_updater: bool = True, device=None):
    """Restore a MultiLayerNetwork or a ComputationGraph, by the
    configuration's ``format`` tag, on `device` (``"cuda"`` by default,
    which raises without CUDA unless ``"cpu"`` is given)."""
    from deeplearning4j_tpu_torch.nn.graph import (
        ComputationGraph, ComputationGraphConfiguration)
    from deeplearning4j_tpu_torch.nn.multilayer import (
        MultiLayerConfiguration, MultiLayerNetwork)
    with zipfile.ZipFile(path, "r") as z:
        conf_json = z.read(CONFIG_JSON).decode()
        manifest = json.loads(z.read(MANIFEST_JSON).decode())
        if manifest.get("format") != FORMAT:
            raise ValueError(f"{path}: format {manifest.get('format')!r}, "
                             f"want {FORMAT!r}")
        if "ComputationGraphConfiguration" in json.loads(conf_json).get("format", ""):
            net = ComputationGraph(ComputationGraphConfiguration.from_json(conf_json),
                                   device=device).init()
        else:
            net = MultiLayerNetwork(MultiLayerConfiguration.from_json(conf_json),
                                    device=device).init()
        _flat_to_tree(net, net.params_, z.read(COEFFICIENTS_BIN),
                      manifest["params"], "params")
        _flat_to_tree(net, net.state_, z.read(STATE_BIN), manifest["state"], "state")
        net.iteration = manifest["iteration"]
        net.epoch = manifest["epoch"]
        if load_updater and UPDATER_BIN in z.namelist() and "updater" in manifest:
            _flat_to_tree(net, net.opt_state_, z.read(UPDATER_BIN),
                          manifest["updater"], "updater")
    return net


def read_normalizer(path: str, cls) -> Optional[Any]:
    """The normalizer saved beside the model (``cls.from_bytes``), or None."""
    with zipfile.ZipFile(path, "r") as z:
        if NORMALIZER_BIN not in z.namelist():
            return None
        return cls.from_bytes(z.read(NORMALIZER_BIN))
