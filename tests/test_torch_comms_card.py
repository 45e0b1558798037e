"""Gradient sharing on the card (``cuda`` marker; each test skips without
a CUDA device, and the file imports no JAX).

Dense world-1 sharing on a conv + BatchNorm network equals the plain eager
``fit`` bit for bit on the card (the gradients cross to the host and back
as f32), through ``fit`` and through ``fit_steps``, which runs its steps
one by one while sharing is on and captures no graph; compressed sharing
runs the host codec on the card's gradients and moves the ``comms_*``
series.

Run on a machine with an H100: ``python -m pytest
tests/test_torch_comms_card.py -q``.
"""
import torch_test_threads  # noqa: F401  (first: one torch thread a worker)
import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch import nn
from deeplearning4j_tpu_torch.monitor.registry import registry
from deeplearning4j_tpu_torch.parallel import HierarchicalGradientSharing, ParallelWrapper
from deeplearning4j_tpu_torch.train import Nesterovs


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    yield torch.device("cuda", 0)
    torch.backends.cudnn.deterministic = prev


def _net(dev):
    conf = (nn.NeuralNetConfiguration.builder().seed(3).updater(Nesterovs(0.05, 0.9))
            .list([nn.ConvolutionLayer(n_out=8, kernel_size=3, activation="identity",
                                       convolution_mode="Same"),
                   nn.BatchNormalizationLayer(activation="relu"),
                   nn.DenseLayer(n_out=32, activation="relu"),
                   nn.OutputLayer(n_out=5, loss="mcxent", activation="softmax")])
            .set_input_type(nn.InputType.convolutional(8, 8, 4)).build())
    return nn.MultiLayerNetwork(conf, device=dev).init()


def _batch(dev, n=16):
    rs = np.random.RandomState(0)
    x = torch.as_tensor(rs.rand(n, 8, 8, 4).astype(np.float32), device=dev)
    y = torch.as_tensor(np.eye(5, dtype=np.float32)[rs.randint(0, 5, n)], device=dev)
    return x, y


@pytest.mark.cuda
def test_dense_world1_sharing_equals_the_plain_fit_on_the_card(card):
    dev, k = card, 3
    x, y = _batch(dev)
    plain, shared = _net(dev), _net(dev)
    shared.load_state_dict(plain.state_dict())
    pw = ParallelWrapper.builder(shared).gradient_sharing(
        HierarchicalGradientSharing(compressed=False, world=1)).build()
    want = []
    for _ in range(2 * k):
        plain.fit(x, y)
        want.append(plain.score())
    pw.fit(x, y)
    got = [shared.score()]
    got += pw.fit_steps(x.broadcast_to((2 * k - 1,) + x.shape),
                        y.broadcast_to((2 * k - 1,) + y.shape)).tolist()
    assert got == want
    sa, sb = plain.state_dict(), shared.state_dict()
    assert all(torch.equal(sa[n], sb[n]) for n in sa)
    assert shared._scan_step is None and shared.gradient_sharing.exchanges == 2 * k
    pw.gradient_sharing(None)


@pytest.mark.cuda
def test_compressed_sharing_runs_the_host_codec_on_card_gradients(card):
    dev = card
    x, y = _batch(dev)
    net = _net(dev)
    net.set_gradient_sharing(HierarchicalGradientSharing(threshold=1e-3, world=1))
    c = registry().get("comms_exchanges_total", {"codec": "threshold"})
    before = c.value if c is not None else 0
    losses = []
    for _ in range(5):
        net.fit(x, y)
        losses.append(net.score())
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]
    assert registry().get("comms_exchanges_total", {"codec": "threshold"}).value \
        == before + 5
    assert net.gradient_sharing.stats()["last_compression_ratio"] > 1.0
    assert all(p.device == dev for p in net.parameters())
    net.set_gradient_sharing(None)
