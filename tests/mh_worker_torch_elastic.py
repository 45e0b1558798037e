"""One rank of a port data-parallel job that crashes once (started by
``tests/test_torch_resilience.py`` through ``ElasticLocalRunner.run``; not
a pytest file).  Imports nothing of JAX.

The port of ``tests/mh_worker_elastic.py``: the ranks join a gloo group,
train an MLP (10-16-2, tanh, softmax, mcxent, Sgd(0.1), f64) data-parallel
on their rows of one global batch through ``ParallelWrapper.
fit_host_local`` and commit a sharded checkpoint after every step
(``CheckpointManager``, every rank, synchronous).  On the first launch
rank 1 exits at step `crash_at` (a marker file makes it one-shot); the
relaunch restores the last committed checkpoint and finishes.

argv: work_dir total_steps crash_at
"""
import os
import sys

import numpy as np

from deeplearning4j_tpu_torch import nn
from deeplearning4j_tpu_torch.parallel import ParallelWrapper, multihost
from deeplearning4j_tpu_torch.train import Sgd
from deeplearning4j_tpu_torch.train.resilience import CheckpointManager


def main(work_dir, total_steps, crash_at):
    multihost.initialize(device="cpu")
    rank, world = multihost.process_index(), multihost.process_count()
    rng = np.random.default_rng(0)
    x = rng.standard_normal((16, 10))
    y = np.eye(2)[(x.sum(1) > 0).astype(int)]
    per = x.shape[0] // world
    xl, yl = x[rank * per:(rank + 1) * per], y[rank * per:(rank + 1) * per]
    conf = (nn.NeuralNetConfiguration.builder().seed(7).updater(Sgd(0.1)).dtype("float64")
            .list([nn.DenseLayer(n_out=16, activation="tanh"),
                   nn.OutputLayer(n_out=2, loss="mcxent", activation="softmax")])
            .set_input_type(nn.InputType.feed_forward(10)).build())
    net = nn.MultiLayerNetwork(conf, device="cpu").init()
    manager = CheckpointManager(os.environ[multihost.ENV_CKPT], keep_last=2)
    pw = ParallelWrapper(net, multihost.global_mesh(device="cpu"))
    if manager.latest_step() is not None:
        pw._place_model()          # restore at the placed layout
        manager.restore(net)
        print(f"rank {rank}: resumed at iteration {net.iteration}", flush=True)
    marker = os.path.join(work_dir, "crashed_once")
    while net.iteration < total_steps:
        if net.iteration == crash_at and rank == 1 and not os.path.exists(marker):
            open(marker, "w").write("1")
            print(f"rank {rank}: simulating a crash at {net.iteration}", flush=True)
            os._exit(1)
        pw.fit_host_local(xl, yl)
        manager.save(net, block=True)     # every rank: the save's barrier
    if rank == 0:
        np.savez(os.path.join(work_dir, "final.npz"), params=net.params(),
                 iteration=np.int64(net.iteration))
    print(f"rank {rank}: done at iteration {net.iteration}", flush=True)


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]))
