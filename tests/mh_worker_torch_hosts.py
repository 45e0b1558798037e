"""One rank of a port gang of hosts on the CPU (started by
``tests/test_torch_hosts.py`` through ``multihost.LocalLauncher(2, 2,
platform="cpu", gang=True)``; not a pytest file).  Imports nothing of JAX.

``python mh_worker_torch_hosts.py <out dir> <steps> <rows a host> <port>
<port> <port>``: the rank joins its host's gloo group (``initialize()``),
builds bench.py's ``--comms`` MLP (16-32-3, tanh, softmax, mcxent,
Sgd(0.1)) from the flat initial parameters in ``<out dir>/init.npy`` (the
JAX package's order and layouts) and trains it `steps` steps through
``ParallelWrapper`` over the host's ranks with gradient sharing over the
gang, once a mode: dense over the mesh on ``DL4J_TPU_GRADIENT_PORT``,
threshold (5e-3), dense under ZeRO-1 and threshold under ZeRO-1, each
over a mesh on its own port.  Each host takes its strided rows of one
global stream made from seed 0, as ``tests/mh_worker_comms.py`` does, and
the wrapper splits them over the host's ranks.  The leader records the
first step's host gradient and the payload it sent.  Per mode a rank
writes its losses, flat parameters, the exchange's stats and whether its
runtime opened a gang socket.

``python mh_worker_torch_hosts.py ckpt <dir> save|load|back``: the
sharded checkpoint across layouts, the MLP with 4 outputs (so that every
leaf's ZeRO-1 plan is the same over 2 ranks and over 4: the JAX format
stores a moment padded for its mesh) and Adam(1e-2), under ZeRO-1
through ``ParallelWrapper``, from its seeded initial parameters:
``save`` (2 hosts x 2 ranks) trains 3 steps with dense sharing and host
0 saves ``<dir>/a``; ``load`` (1 host x 4 ranks) loads ``<dir>/a`` and
saves ``<dir>/b``; ``back`` (2 x 2) loads ``<dir>/b``.  Each rank writes
its parameters and its whole moments after the step.
"""
import json
import os
import pickle
import sys

import numpy as np

from deeplearning4j_tpu_torch import nn
from deeplearning4j_tpu_torch.parallel import (HierarchicalGradientSharing, ParallelWrapper,
                                               hierarchical, multihost, transport)
from deeplearning4j_tpu_torch.train import Sgd

MODES = ("dense", "compressed", "dense_zero1", "compressed_zero1")


def mlp(init, n_in=16, updater=None, n_out=3):
    conf = (nn.NeuralNetConfiguration.builder().seed(7).updater(updater or Sgd(0.1))
            .list([nn.DenseLayer(n_out=32, activation="tanh"),
                   nn.OutputLayer(n_out=n_out, loss="mcxent", activation="softmax")])
            .set_input_type(nn.InputType.feed_forward(n_in)).build())
    net = nn.MultiLayerNetwork(conf, device="cpu").init()
    if init is not None:
        net.set_params(init)
    return net


def stream(steps, rows, hosts, n_in=16):
    """The global batches: `rows` rows for each host a step."""
    rng = np.random.RandomState(0)
    for _ in range(steps):
        xg = rng.randn(hosts * rows, n_in).astype(np.float32)
        labels = (xg[:, 0] > 0).astype(int) + (xg[:, 1] > 0).astype(int)
        yield xg, np.eye(3, dtype=np.float32)[labels]


_ALLGATHER = transport.TcpGradientMesh.allgather


def _recording(rt, record):
    """Wrap the runtime's tree exchange so the leader keeps its first host
    gradient (f32, JAX layouts) and its mesh's first payload."""
    inner = rt._exchange_tree

    def tree(grads):
        record.setdefault("host_grads", hierarchical._host_f32(grads))
        return inner(grads)
    rt._exchange_tree = tree

    def allgather(self, payload):
        record.setdefault("payload", bytes(payload))
        return _ALLGATHER(self, payload)
    transport.TcpGradientMesh.allgather = allgather


def main(out_dir, steps, rows, ports):
    host, local, d = multihost.host_of_env()
    hosts = int(os.environ[multihost.ENV_NPROC])
    multihost.initialize(device="cpu", timeout_s=60)
    init = np.load(os.path.join(out_dir, "init.npy"))
    for mode, port in zip(MODES, ports):
        cfg = HierarchicalGradientSharing(compressed=mode.startswith("compressed"),
                                          threshold=5e-3, port=port)
        net = mlp(init)
        pw = ParallelWrapper(net, optimizer_sharding=mode.endswith("zero1"),
                             gradient_sharing=cfg)
        pw._place_model()
        record = {}
        if local == 0:
            _recording(net.gradient_sharing, record)
        losses = []
        for xg, yg in stream(steps, rows, hosts):
            pw.fit(xg[host::hosts], yg[host::hosts])
            losses.append(net.score())
        rt = net.gradient_sharing
        stats = rt.stats()
        opened = rt.mesh is not None
        pw.gradient_sharing(None)
        if mode.endswith("zero1"):
            from deeplearning4j_tpu_torch.parallel import disable_zero1
            disable_zero1(net)
        tag = f"{mode}_{host}_{local}"
        np.savez(os.path.join(out_dir, f"{tag}.npz"), losses=np.asarray(losses),
                 params=net.params())
        with open(os.path.join(out_dir, f"{tag}.json"), "w") as f:
            json.dump({"stats": stats, "opened_socket": opened}, f)
        if local == 0 and "payload" in record:
            with open(os.path.join(out_dir, f"{tag}.pkl"), "wb") as f:
                pickle.dump(record, f)
        transport.TcpGradientMesh.allgather = _ALLGATHER
    print(f"host {host} rank {local}/{d}: done", flush=True)

def checkpoint_main(out_dir, step):
    from deeplearning4j_tpu_torch import convert
    from deeplearning4j_tpu_torch.parallel import (disable_zero1, load_model_sharded,
                                                   save_model_sharded)
    from deeplearning4j_tpu_torch.train import Adam
    host, local, _ = multihost.host_of_env()
    hosts = int(os.environ[multihost.ENV_NPROC])
    multihost.initialize(device="cpu", timeout_s=60)
    net = mlp(None, updater=Adam(1e-2), n_out=4)
    cfg = HierarchicalGradientSharing(compressed=False) if step != "load" else None
    pw = ParallelWrapper(net, optimizer_sharding=True, gradient_sharing=cfg)
    pw._place_model()
    if step == "save":
        for xg, yg in stream(3, 32, hosts):
            yg = np.pad(yg, ((0, 0), (0, 1)))
            pw.fit(xg[host::hosts], yg[host::hosts])
        if host == 0:
            save_model_sharded(net, os.path.join(out_dir, "a"))
    else:
        load_model_sharded(net, os.path.join(out_dir, "a" if step == "load" else "b"))
        if step == "load":
            save_model_sharded(net, os.path.join(out_dir, "b"))
    if cfg is not None:
        pw.gradient_sharing(None)
    disable_zero1(net)
    opt = [np.asarray(a) for a in jax_leaves(convert.opt_state_to_jax(net))]
    np.savez(os.path.join(out_dir, f"{step}_{host}_{local}.npz"), params=net.params(),
             iteration=net.iteration, *opt)


def jax_leaves(tree):
    if isinstance(tree, dict):
        return [l for k in sorted(tree) for l in jax_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [l for v in tree for l in jax_leaves(v)]
    return [] if tree is None else [tree]


if __name__ == "__main__":
    if sys.argv[1] == "ckpt":
        checkpoint_main(sys.argv[2], sys.argv[3])
    else:
        main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), [int(p) for p in sys.argv[4:8]])
