"""Data-parallel training on the card (``cuda`` marker; each test skips
without a CUDA device, and the file imports no JAX).

A one-rank NCCL group in the test's process: ``ParallelWrapper.fit_steps``
(one CUDA-graph replay a block, the gradient-bucket and loss all-reduces
captured in it) equals the plain ``fit_steps`` of a twin bit for bit, for
a conv + BatchNorm network, replicated and with ZeRO-1.

Run on a machine with an H100: ``python -m pytest
tests/test_torch_parallel_card.py -q``.
"""
import torch_test_threads  # noqa: F401  (first: one torch thread a worker)
import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch import nn
from deeplearning4j_tpu_torch.parallel import ParallelWrapper, multihost
from deeplearning4j_tpu_torch.train import Adam


@pytest.fixture
def nccl_group():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (NCCL and the graph run only there)")
    import torch.distributed as dist
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    dev = multihost.initialize(f"127.0.0.1:{multihost.free_port()}", 1, 0,
                               device=torch.device("cuda", 0))
    yield dev
    dist.destroy_process_group()
    torch.backends.cudnn.deterministic = prev


def _net(dev):
    conf = (nn.NeuralNetConfiguration.builder().seed(3).updater(Adam(1e-2))
            .list([nn.ConvolutionLayer(n_out=8, kernel_size=3, activation="identity",
                                       convolution_mode="Same"),
                   nn.BatchNormalizationLayer(activation="relu"),
                   nn.DenseLayer(n_out=32, activation="relu"),
                   nn.OutputLayer(n_out=5, loss="mcxent", activation="softmax")])
            .set_input_type(nn.InputType.convolutional(8, 8, 4)).build())
    return nn.MultiLayerNetwork(conf, device=dev).init()


@pytest.mark.cuda
@pytest.mark.parametrize("zero1", [False, True])
def test_one_rank_nccl_fit_steps_equals_plain_fit_steps(nccl_group, zero1):
    dev, k = nccl_group, 3
    rs = np.random.RandomState(0)
    x = torch.as_tensor(rs.rand(16, 8, 8, 4).astype(np.float32), device=dev)
    y = torch.as_tensor(np.eye(5, dtype=np.float32)[rs.randint(0, 5, 16)], device=dev)
    xs, ys = x.broadcast_to((k,) + x.shape), y.broadcast_to((k,) + y.shape)
    plain, wrapped = _net(dev), _net(dev)
    wrapped.load_state_dict(plain.state_dict())
    pw = ParallelWrapper.builder(wrapped).optimizer_sharding(zero1).build()
    assert pw.mesh.distributed and pw.degree == 1
    got = [pw.fit_steps(xs, ys) for _ in range(2)]
    want = [plain.fit_steps(xs, ys) for _ in range(2)]
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    sp, sw = plain.state_dict(), wrapped.state_dict()
    for name in sp:
        assert torch.equal(sp[name], sw[name]), name
    assert wrapped._scan_step.captures == 1
    assert wrapped._dp.collectives > 0
