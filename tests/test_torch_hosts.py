"""Gang members of several ranks (hosts) in the PyTorch port
(``parallel/multihost.py``'s host layout, ``parallel/hierarchical.py``'s
``HostLink``, the split step of ``nn/multilayer.py`` through
``ParallelWrapper``) against the JAX package.

- The launchers take ``devices_per_process`` second by position, as the
  JAX package's do; a gang launch of n hosts x d ranks gives each host a
  rendezvous of its own and each rank its host, local rank and card, and
  ``run`` returns the outputs in (host, local) order.
- 2 hosts x 2 gloo ranks (``LocalLauncher(2, 2, gang=True)``,
  ``tests/mh_worker_torch_hosts.py``) against the JAX gang of 2 processes
  x 2 devices (``tests/mh_worker_comms.py`` under the JAX
  ``LocalLauncher(2, devices_per_process=2)``), 40 steps of 32 rows a
  host, from the JAX network's initial parameters: dense and threshold
  within f32 rounding of the JAX curves and w0 (rtol 1e-5, atol 1e-6: the
  port sums two 16-row means where JAX takes one 32-row mean; no value
  crossed a threshold differently).  All four ranks end bitwise equal; dense
  under ZeRO-1 (Sgd) is bitwise dense without it; only the two leaders
  open a gang socket; each leader's first frame is byte for byte the JAX
  framer's for the host gradient it held.
- A sharded checkpoint written by 2 hosts x 2 ranks under ZeRO-1 loads
  bitwise into 1 host x 4 ranks, and that one's save back into 2 x 2.
"""
import torch_test_threads  # noqa: F401  (first: one torch thread a worker)
import inspect
import json
import os
import pickle

import numpy as np
import pytest

from deeplearning4j_tpu_torch.parallel import multihost

HERE = os.path.dirname(os.path.abspath(__file__))
STEPS, ROWS, HOSTS, D = 40, 32, 2, 2
MODES = ("dense", "compressed", "dense_zero1", "compressed_zero1")


# ---------------------------------------------------------------------------
# the launchers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["LocalLauncher", "ElasticLocalRunner"])
def test_launchers_take_devices_per_process_second_as_jax_does(name):
    from deeplearning4j_tpu.parallel import multihost as jmh
    ours = list(inspect.signature(getattr(multihost, name)).parameters)
    theirs = list(inspect.signature(getattr(jmh, name)).parameters)
    assert ours[:3] == theirs[:3] == ["num_processes", "devices_per_process", "platform"]
    made = getattr(multihost, name)(3, 2, "cpu")
    assert (made.num_processes, made.devices_per_process, made.platform) == (3, 2, "cpu")


def test_gang_env_gives_each_host_its_rendezvous_and_each_rank_its_place():
    envs = multihost.LocalLauncher(2, 3, "cpu", gang=True).envs(gradient_port=4242)
    assert len(envs) == 6
    got = [(e[multihost.ENV_PID], e[multihost.ENV_LOCAL], e[multihost.ENV_CARD],
            e[multihost.ENV_NPROC], e[multihost.ENV_DPP], e[multihost.ENV_GANG],
            e[multihost.ENV_GRAD_PORT]) for e in envs]
    assert got == [(str(h), str(j), str(h * 3 + j), "2", "3", "1", "4242")
                   for h in range(2) for j in range(3)]
    coords = [e[multihost.ENV_COORD] for e in envs]
    assert len(set(coords[:3])) == len(set(coords[3:])) == 1 and coords[0] != coords[3]
    flat = multihost.LocalLauncher(2, 3, "cpu").envs()
    assert len({e[multihost.ENV_COORD] for e in flat}) == 1
    assert [e[multihost.ENV_GANG] for e in flat] == ["0"] * 6


def test_group_and_process_index_follow_the_host_layout(monkeypatch):
    for k, v in ((multihost.ENV_PID, "1"), (multihost.ENV_NPROC, "2"),
                 (multihost.ENV_DPP, "2"), (multihost.ENV_LOCAL, "1"),
                 (multihost.ENV_GANG, "1")):
        monkeypatch.setenv(k, v)
    assert multihost.group_of_env() == (2, 1)
    assert multihost.host_of_env() == (1, 1, 2)
    assert (multihost.process_index(), multihost.process_count()) == (1, 2)
    monkeypatch.setenv(multihost.ENV_GANG, "0")
    assert multihost.group_of_env() == (4, 3)
    monkeypatch.setenv(multihost.ENV_DPP, "1")
    monkeypatch.setenv(multihost.ENV_LOCAL, "0")
    assert multihost.group_of_env() == (2, 1)
    assert (multihost.process_index(), multihost.process_count()) == (0, 1)


def test_run_returns_outputs_in_host_then_local_order(tmp_path):
    script = tmp_path / "who.py"
    script.write_text("import os\nprint(os.environ['DL4J_TPU_PROCESS_ID'], "
                      "os.environ['DL4J_TPU_LOCAL_RANK'])\n")
    outs = multihost.LocalLauncher(2, 2, "cpu", gang=True).run(str(script), timeout=60)
    assert [o.split() for o in outs] == [["0", "0"], ["0", "1"], ["1", "0"], ["1", "1"]]


def test_an_elastic_gang_of_hosts_is_refused():
    with pytest.raises(NotImplementedError, match="devices_per_process 2"):
        multihost.ElasticLocalRunner(2, 2, "cpu").run_elastic("unused.py")


def test_a_rank_other_than_the_leader_never_joins_the_gang(monkeypatch):
    from deeplearning4j_tpu_torch.parallel import (HierarchicalAllReduce,
                                                   HierarchicalGradientSharing)
    monkeypatch.setenv(multihost.ENV_DPP, "2")
    monkeypatch.setenv(multihost.ENV_LOCAL, "1")
    rt = HierarchicalAllReduce(HierarchicalGradientSharing(world=2, rank=0, port=1))
    with pytest.raises(RuntimeError, match="only the host's leader joins the gang"):
        rt.exchange({"w": np.zeros(3, np.float32)})
    assert rt.mesh is None


# ---------------------------------------------------------------------------
# 2 hosts x 2 ranks against the JAX 2 x 2 gang
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def gangs(tmp_path_factory):
    from deeplearning4j_tpu import nn as jnn
    from deeplearning4j_tpu.parallel import multihost as jmh
    from deeplearning4j_tpu.train.updaters import Sgd as JSgd
    td = tmp_path_factory.mktemp("hosts")
    jconf = (jnn.NeuralNetConfiguration.builder().seed(7).updater(JSgd(0.1))
             .list([jnn.DenseLayer(n_out=32, activation="tanh"),
                    jnn.OutputLayer(n_out=3, loss="mcxent", activation="softmax")])
             .set_input_type(jnn.InputType.feed_forward(16)).build())
    np.save(td / "init.npy", np.asarray(jnn.MultiLayerNetwork(jconf).init().params(),
                                        np.float32))
    multihost.LocalLauncher(HOSTS, D, "cpu", gang=True).run(
        os.path.join(HERE, "mh_worker_torch_hosts.py"),
        [str(td), STEPS, ROWS] + [multihost.free_port() for _ in MODES], timeout=180,
        gradient_port=multihost.free_port())
    port = {}
    for mode in MODES:
        ranks = [(h, j) for h in range(HOSTS) for j in range(D)]
        port[mode] = {
            "runs": [np.load(td / f"{mode}_{h}_{j}.npz") for h, j in ranks],
            "info": [json.loads((td / f"{mode}_{h}_{j}.json").read_text()) for h, j in ranks],
            "record": [pickle.loads((td / f"{mode}_{h}_0.pkl").read_bytes())
                       for h in range(HOSTS)]}
    jax_dir = td / "jax"
    jax_dir.mkdir()
    worker = os.path.join(HERE, "mh_worker_comms.py")
    for mode in ("dense", "compressed"):
        jmh.LocalLauncher(HOSTS, D).run(worker, [str(jax_dir), mode, STEPS, ROWS],
                                        timeout=300, gradient_port=jmh.free_port())
    jax = {mode: [np.load(jax_dir / f"curve_{mode}_{r}.npz") for r in range(HOSTS)]
           for mode in ("dense", "compressed")}
    return port, jax, td


@pytest.mark.parametrize("mode", MODES)
def test_every_rank_of_every_host_ends_bitwise_equal(gangs, mode):
    runs = gangs[0][mode]["runs"]
    for r in runs[1:]:
        np.testing.assert_array_equal(r["params"], runs[0]["params"])
    # a host's two ranks report the host's loss
    np.testing.assert_array_equal(runs[0]["losses"], runs[1]["losses"])
    np.testing.assert_array_equal(runs[2]["losses"], runs[3]["losses"])


@pytest.mark.parametrize("mode", MODES)
def test_only_the_leaders_open_gang_sockets(gangs, mode):
    info = gangs[0][mode]["info"]
    assert [i["opened_socket"] for i in info] == [True, False, True, False]
    for i in info:
        st = i["stats"]
        assert (st["world"], st["exchanges"], st["compressed"]) == (
            HOSTS, STEPS, mode.startswith("compressed"))
    assert [i["stats"]["rank"] for i in info] == [0, 0, 1, 1]
    assert [i["stats"]["bytes_sent_total"] > 0 for i in info] == [True, False, True, False]


def test_dense_under_zero1_is_bitwise_dense(gangs):
    port = gangs[0]
    for a, b in zip(port["dense"]["runs"], port["dense_zero1"]["runs"]):
        np.testing.assert_array_equal(a["params"], b["params"])
        np.testing.assert_array_equal(a["losses"], b["losses"])


@pytest.mark.parametrize("mode", ["dense", "compressed"])
def test_the_gang_of_hosts_tracks_the_jax_gang(gangs, mode, rtol=1e-5, atol=1e-6):
    port, jax, _ = gangs
    runs = port[mode]["runs"]
    for h in range(HOSTS):
        np.testing.assert_allclose(runs[h * D]["losses"], jax[mode][h]["losses"],
                                   rtol=rtol, atol=1e-6)
    w0 = runs[0]["params"][:16 * 32].reshape(16, 32)
    np.testing.assert_allclose(w0, np.asarray(jax[mode][0]["w0"]), rtol=rtol, atol=atol)
    wire = {m: sum(i["stats"]["bytes_sent_total"] + i["stats"]["bytes_received_total"]
                   for i in port[m]["info"]) for m in ("dense", "compressed")}
    assert wire["dense"] > 2 * wire["compressed"]


@pytest.mark.parametrize("mode", MODES)
def test_a_leaders_frame_is_the_jax_framers_for_its_host_gradient(gangs, mode):
    from deeplearning4j_tpu.parallel import compression as jcomp
    from deeplearning4j_tpu.parallel import transport as jtr
    import jax
    for rec in gangs[0][mode]["record"]:
        g = rec["host_grads"]
        if mode.endswith("zero1"):
            # the leader gathered the output bias's shards into its padded
            # leaf, as a JAX host's sharded array holds it
            assert g["layer_1"]["b"].shape == (4,) and g["layer_1"]["b"][3] == 0
        leaves = jax.tree_util.tree_leaves(g)
        if mode.startswith("compressed"):
            ex = jcomp.CompressedGradientExchange(
                jax.tree_util.tree_map(np.zeros_like, g), threshold=5e-3,
                adaptive_target_density=1e-2)
            want = jtr.pack_streams(ex.encode(g), ex.thresholds())
        else:
            want = jtr.pack_dense([np.asarray(l) for l in leaves])
        assert rec["payload"] == want


def test_a_checkpoint_of_2_hosts_x_2_ranks_loads_bitwise_on_1_host_x_4_and_back(gangs):
    """The MLP (4 outputs) under ZeRO-1 and Adam(1e-2): host 0 of a 2 x 2 gang saves
    sharded after 3 dense steps (2 files, the moments' rows of a 2-rank
    host); 1 host x 4 ranks loads it, each rank its quarter of the
    moments, and saves it again (4 files); the 2 x 2 gang loads that.
    Every rank's parameters and whole moments, bitwise the saver's."""
    td = gangs[2]
    worker = os.path.join(HERE, "mh_worker_torch_hosts.py")
    multihost.LocalLauncher(2, 2, "cpu", gang=True).run(
        worker, ["ckpt", str(td), "save"], timeout=120, gradient_port=multihost.free_port())
    multihost.LocalLauncher(1, 4, "cpu").run(worker, ["ckpt", str(td), "load"], timeout=120)
    multihost.LocalLauncher(2, 2, "cpu", gang=True).run(
        worker, ["ckpt", str(td), "back"], timeout=120, gradient_port=multihost.free_port())
    assert len([n for n in os.listdir(td / "a") if n.startswith("shards-")]) == 2
    assert len([n for n in os.listdir(td / "b") if n.startswith("shards-")]) == 4
    want = np.load(td / "save_0_0.npz")
    assert int(want["iteration"]) == 3
    runs = ([np.load(td / f"save_{h}_{j}.npz") for h in range(2) for j in range(2)]
            + [np.load(td / f"load_0_{j}.npz") for j in range(4)]
            + [np.load(td / f"back_{h}_{j}.npz") for h in range(2) for j in range(2)])
    for r in runs:
        assert set(r.files) == set(want.files)
        for k in want.files:
            np.testing.assert_array_equal(r[k], want[k], err_msg=k)
