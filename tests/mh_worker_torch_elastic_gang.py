"""One member of a port elastic gang on the CPU (started by
``tests/test_torch_elastic.py`` through
``multihost.ElasticLocalRunner.run_elastic``; not a pytest file).  Imports
nothing of JAX.

The port of ``tests/mh_worker_elastic_gang.py``: each process trains the
same seeded MLP (16-32-3, tanh, softmax, mcxent, Sgd(0.1)) under
``ElasticTrainer`` with ``HierarchicalGradientSharing(threshold=5e-3,
elastic=True)`` (heartbeat, deadline and join from the supervisor's
``DL4J_TPU_*`` environment).  The data is one global batch a step seeded
by (epoch, step) only; each member trains on the strided shard of its
LIVE gang rank, so a reformation re-shards the same stream at the new
world.  A ``PeerKiller`` armed from argv injects the fault on one rank; its
marker keeps a replacement from firing again.  Only the coordinator
writes checkpoints (every step); the peers restore from the same
directory.

argv: out_dir steps_per_epoch epochs kill_rank kill_step [kill_mode]
  kill_rank -1 disables the fault; kill_mode: kill | hang | partition | slow
"""
import json
import os
import sys
import time

import numpy as np

from deeplearning4j_tpu_torch import nn
from deeplearning4j_tpu_torch.data import DataSet
from deeplearning4j_tpu_torch.data.iterators import DataSetIterator
from deeplearning4j_tpu_torch.parallel import HierarchicalGradientSharing
from deeplearning4j_tpu_torch.parallel.multihost import ENV_CKPT, ENV_PID, ENV_PLATFORM
from deeplearning4j_tpu_torch.parallel.transport import GangEvictedError, PeerUnreachableError
from deeplearning4j_tpu_torch.train import Sgd
from deeplearning4j_tpu_torch.train.resilience import CheckpointManager, ElasticTrainer
from deeplearning4j_tpu_torch.utils.chaos import PeerKiller

N_IN, N_OUT, GLOBAL_BATCH = 16, 3, 12


class GangShardIterator(DataSetIterator):
    """The global stream, each member taking its live rank's strided rows
    (rank and world read per batch, so a reformed gang re-shards it)."""

    def __init__(self, model, steps: int):
        self.model = model
        self.steps = int(steps)

    def __iter__(self):
        for i in range(self.steps):
            rng = np.random.RandomState(1000 + int(self.model.epoch) * self.steps + i)
            xg = rng.randn(GLOBAL_BATCH, N_IN).astype(np.float32)
            labels = (xg[:, 0] > 0).astype(int) + (xg[:, 1] > 0).astype(int)
            yg = np.eye(N_OUT, dtype=np.float32)[labels]
            sharing = self.model.gradient_sharing
            r, w = sharing.rank, sharing.world
            yield DataSet(xg[r::w], yg[r::w])

    def __len__(self):
        return self.steps

    def batch_size(self) -> int:
        return GLOBAL_BATCH


def main(out_dir, steps_per_epoch, epochs, kill_rank, kill_step, kill_mode="kill"):
    rank = int(os.environ.get(ENV_PID, "0"))
    policy = os.environ.get("DL4J_TPU_ELASTIC_POLICY", "shrink")
    device = os.environ.get(ENV_PLATFORM, "cpu")
    conf = (nn.NeuralNetConfiguration.builder().seed(7).updater(Sgd(0.1))
            .list([nn.DenseLayer(n_out=32, activation="tanh"),
                   nn.OutputLayer(n_out=N_OUT, loss="mcxent", activation="softmax")])
            .set_input_type(nn.InputType.feed_forward(N_IN)).build())
    net = nn.MultiLayerNetwork(conf, device=device).init()
    net.set_gradient_sharing(HierarchicalGradientSharing(threshold=5e-3, elastic=True))
    # the coordinator writes every step; keep_last is high because the
    # comparator reruns from the reform step, which must survive the run
    manager = CheckpointManager(os.environ[ENV_CKPT], keep_last=200,
                                save_every_steps=1 if rank == 0 else None)
    hooks = []
    if kill_rank >= 0:
        hooks.append(PeerKiller(kill_rank, kill_step, mode=kill_mode, duration_s=6.0,
                                marker=os.path.join(out_dir, "killed_once")))
    trainer = ElasticTrainer(net, manager, policy=policy, rejoin_wait_s=60.0,
                             hooks=hooks, save_initial=(rank == 0))
    try:
        trainer.fit(GangShardIterator(net, steps_per_epoch), epochs=epochs)
    except (GangEvictedError, PeerUnreachableError) as e:
        print(f"rank {rank}: left the gang: {e}", flush=True)
        net.set_gradient_sharing(None)
        return 7
    stats = net.gradient_sharing.stats()
    np.savez(os.path.join(out_dir, f"final_{rank}.npz"), params=net.params(),
             iteration=np.int64(net.iteration), score=np.float64(net.score()))
    with open(os.path.join(out_dir, f"elastic_{rank}.json"), "w") as f:
        json.dump({"stats": stats, "reformations": trainer.reformations}, f)
    # a peer that closes its sockets while the coordinator still writes its
    # last checkpoint reads as a crash there and re-forms the gang once more:
    # leave only once the coordinator has read its stats
    deadline = time.monotonic() + 60.0
    while (rank != 0 and time.monotonic() < deadline
           and not os.path.exists(os.path.join(out_dir, "elastic_0.json"))):
        time.sleep(0.01)
    net.set_gradient_sharing(None)           # close the gang's sockets
    print(f"rank {rank}: done at iteration {net.iteration} "
          f"(world={stats['world']}, generation={stats['generation']})", flush=True)
    return 0


if __name__ == "__main__":
    a = sys.argv[1:]
    sys.exit(main(a[0], int(a[1]), int(a[2]), int(a[3]), int(a[4]),
                  a[5] if len(a) > 5 else "kill"))
