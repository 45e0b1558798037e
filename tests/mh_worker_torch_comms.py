"""One rank of a port gradient-sharing gang on the CPU (started by
``tests/test_torch_comms.py`` through ``multihost.LocalLauncher(gang=True)``;
not a pytest file).  Imports nothing of JAX.

``python mh_worker_torch_comms.py <out dir> <steps> <rows a rank>
<port of the second mesh>``: the rank builds bench.py's ``--comms`` MLP
(16-32-3, tanh, softmax, mcxent, Sgd(0.1)) from the flat initial
parameters in ``<out dir>/init.npy`` (the JAX package's order and
layouts; the test writes the JAX network's), trains it `steps` steps with
dense sharing over the mesh on ``DL4J_TPU_GRADIENT_PORT``, then a fresh
copy `steps` steps with threshold sharing (5e-3) over a second mesh on
the given port, each rank on its strided rows of one global stream made
from seed 0.  Per mode it writes its losses, its flat parameters and the
exchange's stats.
"""
import json
import os
import sys

import numpy as np

from deeplearning4j_tpu_torch import nn
from deeplearning4j_tpu_torch.parallel import HierarchicalGradientSharing
from deeplearning4j_tpu_torch.parallel.multihost import ENV_NPROC, ENV_PID
from deeplearning4j_tpu_torch.train import Sgd


def mlp(init, n_in=16):
    conf = (nn.NeuralNetConfiguration.builder().seed(7).updater(Sgd(0.1))
            .list([nn.DenseLayer(n_out=32, activation="tanh"),
                   nn.OutputLayer(n_out=3, loss="mcxent", activation="softmax")])
            .set_input_type(nn.InputType.feed_forward(n_in)).build())
    net = nn.MultiLayerNetwork(conf, device="cpu").init()
    net.set_params(init)
    return net


def stream(steps, rows, n_in=16):
    """The global batches: `rows` rows for each of the 2 ranks a step."""
    rng = np.random.RandomState(0)
    for _ in range(steps):
        xg = rng.randn(2 * rows, n_in).astype(np.float32)
        labels = (xg[:, 0] > 0).astype(int) + (xg[:, 1] > 0).astype(int)
        yield xg, np.eye(3, dtype=np.float32)[labels]


def main(out_dir, steps, rows, port2):
    rank, world = int(os.environ[ENV_PID]), int(os.environ[ENV_NPROC])
    init = np.load(os.path.join(out_dir, "init.npy"))
    for mode, cfg in (("dense", HierarchicalGradientSharing(compressed=False)),
                      ("compressed", HierarchicalGradientSharing(threshold=5e-3,
                                                                 port=port2))):
        net = mlp(init).set_gradient_sharing(cfg)
        losses = []
        for xg, yg in stream(steps, rows):
            net.fit(xg[rank::world], yg[rank::world])
            losses.append(net.score())
        stats = net.gradient_sharing.stats()
        net.set_gradient_sharing(None)
        np.savez(os.path.join(out_dir, f"{mode}_{rank}.npz"),
                 losses=np.asarray(losses), params=net.params())
        with open(os.path.join(out_dir, f"{mode}_{rank}.json"), "w") as f:
            json.dump(stats, f)


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]))
