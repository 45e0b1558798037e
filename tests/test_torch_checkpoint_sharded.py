"""Sharded checkpoints of the PyTorch port (``parallel/checkpoint.py``) in
the JAX package's format, across both packages (the rank pool of
``test_torch_parallel.py``: 2 gloo ranks; f64).

- A JAX-written ``save_model_sharded`` (2-device mesh, Adam) loads into
  the port on 1 rank and on 2 ranks, bit for bit.
- A port-written one from 2 ranks with ZeRO-1 on (padded, sharded Adam
  moments, each rank writing its rows) loads into the JAX package's
  ZeRO-1 network on 2 devices, bit for bit.
- Resuming from a checkpoint continues exactly as uninterrupted training.
- An uncommitted checkpoint or a flipped payload byte is refused.
- The manifest's tree structure is the string the JAX package writes.
"""
import torch_test_threads  # noqa: F401  (first: one torch thread a worker)
import json
import os

import numpy as np
import pytest

from deeplearning4j_tpu_torch import convert
from deeplearning4j_tpu_torch.parallel import (ChecksumError, ParallelWrapper, checkpoint,
                                               load_model_sharded, load_sharded,
                                               read_metadata, save_model_sharded, save_sharded,
                                               verify_checkpoint)
from test_torch_parallel import (RankPool, equal_trees, jax_snapshot, jax_start, jx,
                                 mlp_conf, mlp_data, port_net, ranks_equal, snapshot)


@pytest.fixture(scope="module")
def pool():
    p = RankPool()
    yield p
    p.close()


def _task_load(conf_json, directory, zero1=False):
    """A fresh port network restored from `directory` (under ZeRO-1: each
    rank reads its rows of the padded moments; gathered whole after)."""
    net = _fresh(conf_json)
    if zero1:
        ParallelWrapper.builder(net).optimizer_sharding(True).build()._place_model()
    load_model_sharded(net, directory)
    from deeplearning4j_tpu_torch.parallel import disable_zero1
    disable_zero1(net)
    return snapshot(net)


def _fresh(conf_json):
    from deeplearning4j_tpu_torch import nn as tnn
    return tnn.MultiLayerNetwork(tnn.MultiLayerConfiguration.from_json(conf_json),
                                 device="cpu").init()


def _task_save_zero(conf_json, params, state, x, y, directory):
    net = port_net(conf_json, params, state)
    pw = ParallelWrapper.builder(net).optimizer_sharding(True).build()
    for _ in range(3):
        pw.fit(x, y)
    save_model_sharded(net, directory)
    from deeplearning4j_tpu_torch.parallel import disable_zero1
    disable_zero1(net)
    return snapshot(net), sorted(os.listdir(directory))


def _task_resume(conf_json, params, state, x, y, directory):
    """2 steps, save, 2 more; a fresh network restored from the save takes
    the same 2 more steps.  Both under ZeRO-1."""
    a = port_net(conf_json, params, state)
    pa = ParallelWrapper.builder(a).optimizer_sharding(True).build()
    for _ in range(2):
        pa.fit(x, y)
    save_model_sharded(a, directory)
    b = _fresh(conf_json)
    pb = ParallelWrapper.builder(b).optimizer_sharding(True).build()
    pb._place_model()
    load_model_sharded(b, directory)
    for _ in range(2):
        pa.fit(x, y)
        pb.fit(x, y)
    return [(net.score(), convert.params_to_jax(net), net.iteration,
             [t.numpy().copy() for t in _moments(net)]) for net in (a, b)]


def _moments(net):
    from deeplearning4j_tpu_torch.train.updaters import tree_leaves
    return list(tree_leaves(net.opt_state_))


def _jax_checkpoint(J, tmp_path, zero1=False):
    conf = mlp_conf(J, J.upd.Adam(1e-2), n_in=9)
    jnet, conf_json, params, state = jax_start(J, conf)
    x, y = mlp_data(16, n_in=9)
    pw = J.par.ParallelWrapper(jnet, J.mesh2(), optimizer_sharding=zero1)
    for _ in range(2):
        pw.fit(x, y)
    return jnet, conf, conf_json, params, state, x, y


def test_jax_checkpoint_loads_into_the_port_on_one_and_two_ranks(pool, tmp_path):
    J = jx()
    jnet, _, conf_json, *_ = _jax_checkpoint(J, tmp_path)
    d = str(tmp_path / "jax")
    J.par.save_model_sharded(jnet, d)
    want = jax_snapshot(J, jnet)
    one = _fresh(conf_json)
    load_model_sharded(one, d)
    equal_trees(snapshot(one), want)
    got = pool.run(_task_load, conf_json, d)
    for snap in got:
        equal_trees(snap, want)
    # ZeRO-1 on 2 devices: sharded parameter chunks and padded moments
    jnet, *_ = _jax_checkpoint(J, tmp_path, zero1=True)
    dz = str(tmp_path / "jax_zero")
    J.par.save_model_sharded(jnet, dz)
    J.par.zero.disable_zero1(jnet)
    for snap in pool.run(_task_load, conf_json, dz, True):
        equal_trees(snap, jax_snapshot(J, jnet))


def test_port_zero1_checkpoint_loads_into_jax(pool, tmp_path):
    """Two ranks under ZeRO-1 write padded (10-row) Adam moments, 5 rows
    each; the JAX package's ZeRO-1 network on 2 devices reads them."""
    J = jx()
    conf = mlp_conf(J, J.upd.Adam(1e-2), n_in=9)
    _, conf_json, params, state = jax_start(J, conf)
    x, y = mlp_data(16, n_in=9)
    d = str(tmp_path / "port")
    got = pool.run(_task_save_zero, conf_json, params, state, x, y, d)
    ranks_equal([g[0] for g in got])
    assert got[0][1] == ["index-0.json", "index-1.json", "manifest.json",
                         "shards-0.npz", "shards-1.npz"]
    with open(os.path.join(d, "manifest.json")) as f:
        specs = json.load(f)["leaves"]
    assert [10, 16] in [s["shape"] for s in specs]          # a padded moment
    jnet = J.nn.MultiLayerNetwork(conf).init()
    J.par.zero.enable_zero1(jnet, J.mesh2())
    J.par.load_model_sharded(jnet, d)
    J.par.zero.disable_zero1(jnet)
    equal_trees(jax_snapshot(J, jnet), got[0][0])
    verify_checkpoint(d)


def test_resume_from_a_sharded_checkpoint_is_exact(pool, tmp_path):
    J = jx()
    _, conf_json, params, state = jax_start(J, mlp_conf(J, J.upd.Adam(1e-2), n_in=9))
    x, y = mlp_data(16, n_in=9, seed=4)
    for (la, pa, ia, ma), (lb, pb, ib, mb) in pool.run(
            _task_resume, conf_json, params, state, x, y, str(tmp_path / "resume")):
        assert la == lb and ia == ib == 4
        equal_trees(pb, pa)
        equal_trees(mb, ma)


def test_uncommitted_or_corrupted_checkpoint_is_refused(tmp_path):
    J = jx()
    jnet, _, conf_json, *_ = _jax_checkpoint(J, tmp_path)
    net = _fresh(conf_json)
    convert.params_from_jax(net, J.np(jnet.params_))
    d = str(tmp_path / "ck")
    save_model_sharded(net, d)
    assert read_metadata(d)["config"] == net.conf.to_json()
    verify_checkpoint(d)
    # a flipped byte in one chunk's payload
    path = os.path.join(d, "shards-0.npz")
    with np.load(path) as z:
        chunks = {k: z[k].copy() for k in z.files}
    key = sorted(chunks)[0]
    flat = chunks[key].reshape(-1).view(np.uint8)
    flat[3] ^= 0x10
    np.savez(path, **chunks)
    with pytest.raises(ChecksumError):
        verify_checkpoint(d)
    with pytest.raises(ChecksumError):
        load_model_sharded(_fresh(conf_json), d)
    # no manifest: not committed
    os.remove(os.path.join(d, "manifest.json"))
    with pytest.raises(FileNotFoundError):
        load_model_sharded(_fresh(conf_json), d)
    with pytest.raises(FileNotFoundError):
        verify_checkpoint(d)


def test_tree_structure_string_and_reshard_match_jax(tmp_path):
    """`treedef_str` is `str(tree_flatten(tree)[1])` for dicts, lists,
    tuples, None and empty containers; a leaf saved whole loads by any
    window, and a mismatched template is refused."""
    J = jx()
    trees = [{"b": np.zeros(2), "a": (), "c": [np.ones(1), (np.ones(2),)], "d": None,
              "e": {}, "f": (np.zeros(3), np.zeros(1))}, [()], (np.zeros(1),)]
    for tree in trees:
        assert checkpoint.treedef_str(tree) == str(J.jax.tree_util.tree_flatten(tree)[1])
    d = str(tmp_path / "t")
    w = np.arange(40.0).reshape(10, 4)
    save_sharded(d, {"w": w, "n": np.int64(3)}, metadata={"iteration": 7})
    half = checkpoint.ShardedLeaf((10, 4), np.float64, [[5, 10], [0, 4]])
    out = load_sharded(d, {"w": half, "n": np.int64(0)})
    np.testing.assert_array_equal(out["w"], w[5:])
    assert int(out["n"]) == 3 and read_metadata(d)["iteration"] == 7
    with pytest.raises(ValueError, match="structure"):
        load_sharded(d, {"w": w, "m": np.int64(0)})
    with pytest.raises(ValueError, match="shape"):
        load_sharded(d, {"w": np.zeros((4, 10)), "n": np.int64(0)})
