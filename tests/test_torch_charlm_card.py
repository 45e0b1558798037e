"""The recurrent and attention slice on the card (``cuda`` marker; each
test skips without a CUDA device, and the file imports no JAX).

- The char-LM's ``fit_steps`` block, one CUDA-graph replay, equals k
  eager ``fit`` steps of a twin bit for bit at a small width, with one
  capture for the shape.
- A SelfAttentionLayer given an int mask on the card casts it to q's
  dtype: the flash kernels launch (forward, dQ, dK/dV once a step) and
  the loss holds ``reference`` mode's.

Run on a machine with an H100: ``python -m pytest
tests/test_torch_charlm_card.py -q``.
"""
import torch_test_threads  # noqa: F401  (first: one torch thread a worker)
import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch import nn, zoo
from deeplearning4j_tpu_torch.ops.kernels import attention, dispatch
from deeplearning4j_tpu_torch.train import Adam


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the graph and the kernels run only there)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_charlm_graph_block_equals_eager_steps():
    dev = _card()
    V, T, B, k = 13, 10, 6, 3

    def make():
        return zoo.TextGenLSTM(n_classes=V, input_shape=(T, V), lstm_units=16).init_model(
            device=dev)

    idx = np.random.RandomState(0).randint(0, V, (B, T))
    eye = np.eye(V, dtype=np.float32)
    x = torch.as_tensor(eye[idx], device=dev)
    y = torch.as_tensor(eye[np.roll(idx, -1, 1)], device=dev)
    net, twin = make(), make()
    twin.load_state_dict(net.state_dict())
    got = net.fit_steps(x.broadcast_to((k,) + x.shape), y.broadcast_to((k,) + y.shape))
    got = got.tolist() + net.fit_steps(x.broadcast_to((k,) + x.shape),
                                       y.broadcast_to((k,) + y.shape)).tolist()
    want = []
    for _ in range(2 * k):
        twin.fit(x, y)
        want.append(twin.score())
    assert got == want
    assert all(torch.equal(a, b) for a, b in zip(net.parameters(), twin.parameters()))
    assert net._scan_step.captures == 1 and net.iteration == 2 * k


@pytest.mark.cuda
def test_self_attention_int_mask_runs_the_kernels():
    dev = _card()
    B, T, V = 4, 24, 9

    def make():
        conf = (nn.NeuralNetConfiguration.builder().seed(3).updater(Adam(1e-3))
                .list([nn.LSTM(n_out=32, activation="tanh"),
                       nn.SelfAttentionLayer(n_out=32, n_heads=2),
                       nn.GlobalPoolingLayer(pooling_type="AVG"),
                       nn.OutputLayer(n_out=3, loss="mcxent", activation="softmax")])
                .set_input_type(nn.InputType.recurrent(V, T)).build())
        return nn.MultiLayerNetwork(conf, device=dev).init()

    rng = np.random.RandomState(1)
    x = torch.as_tensor(np.eye(V, dtype=np.float32)[rng.randint(0, V, (B, T))], device=dev)
    y = torch.as_tensor(np.eye(3, dtype=np.float32)[rng.randint(0, 3, B)], device=dev)
    mask = torch.ones((B, T), dtype=torch.int32, device=dev)
    mask[::2, T - 7:] = 0
    net, ref = make(), make()
    ref.load_state_dict(net.state_dict())
    counters = (attention.LAUNCHES, attention.DQ_LAUNCHES, attention.DKV_LAUNCHES)
    for c in counters:
        c.reset()
    net.fit(x, y, features_mask=mask)
    torch.cuda.synchronize()
    assert [c.value for c in counters] == [1, 1, 1]
    prev = dispatch.set_dispatch_mode("reference")
    try:
        ref.fit(x, y, features_mask=mask)
    finally:
        dispatch.set_dispatch_mode(prev)
    assert abs(net.score() - ref.score()) <= 1e-4 * abs(ref.score())
