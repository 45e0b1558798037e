"""SameDiff on the card (``cuda`` marker; each test skips without a CUDA
device, and the file imports no JAX).

- chip_smoke's ``sd_kernels`` graph at a small width: in ``auto`` mode
  each step launches the flash forward, dQ and dK/dV kernels once a layer
  and the LayerNorm forward and backward kernels twice a layer; a twin
  built alike in ``reference`` mode launches none, and its losses agree.
- chip_smoke's ``bert_graph_def`` at a small width imports on the card:
  its output equals the plain forward, and a ``fit_steps`` block of 3 (one
  CUDA-graph replay) equals 3 eager steps bit for bit.

Run on a machine with an H100: ``python -m pytest
tests/test_torch_sd_card.py -q``.
"""
import torch_test_threads  # noqa: F401  (first: one torch thread a worker)
import numpy as np
import pytest
import torch

import chip_smoke
from deeplearning4j_tpu_torch import autodiff, modelimport
from deeplearning4j_tpu_torch.ops.kernels import attention, dispatch, layer_norm
from deeplearning4j_tpu_torch.train import Adam


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the graph and the kernels run only there)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _steps(sd, x, y, steps):
    counters = (attention.LAUNCHES, attention.DQ_LAUNCHES, attention.DKV_LAUNCHES,
                layer_norm.LAUNCHES, layer_norm.BWD_LAUNCHES)
    losses, counts = [], []
    for _ in range(steps):
        for c in counters:
            c.reset()
        sd.fit(x, y)
        losses.append(sd.score())
        counts.append(tuple(int(c.value) for c in counters))
    return losses, counts


@pytest.mark.cuda
def test_sd_kernels_graph_launches_and_holds_reference_mode():
    dev = _card()
    shape = (4, 64, 128, 4, 2, 3)        # batch, T, F, heads, layers, steps
    B, T, F, _, layers, steps = shape
    rs = np.random.RandomState(0)
    x = torch.as_tensor(rs.randn(B, T, F).astype(np.float32), device=dev)
    y = torch.as_tensor(rs.randn(B, T, F).astype(np.float32), device=dev)
    sd = chip_smoke.sd_kernels_graph(autodiff, Adam, dev, shape)
    twin = chip_smoke.sd_kernels_graph(autodiff, Adam, dev, shape)
    losses, counts = _steps(sd, x, y, steps)
    prev = dispatch.set_dispatch_mode("reference")
    try:
        ref, ref_counts = _steps(twin, x, y, steps)
    finally:
        dispatch.set_dispatch_mode(prev)
    assert counts == [(layers, layers, layers, 2 * layers, 2 * layers)] * steps
    assert ref_counts == [(0,) * 5] * steps
    np.testing.assert_allclose(losses, ref, rtol=1e-4)


@pytest.mark.cuda
def test_bert_graph_def_imports_on_the_card_and_replays_bitwise():
    dev = _card()
    B, T, L, H, NH, V = 2, 16, 2, 64, 4, 97
    data, w, enc = chip_smoke.bert_graph_def(B, T, L, H, NH, V)
    sd = modelimport.import_graph_def(data, device=dev)
    rs = np.random.RandomState(0)
    ids = torch.as_tensor(rs.randint(0, V, (B, T)).astype(np.int32), device=dev)
    lab = torch.as_tensor(rs.randint(0, V, (B, T)).astype(np.int32), device=dev)
    got = sd.output({"ids": ids}, enc)[enc]
    ref = chip_smoke.bert_plain_forward(w, ids, L, NH)
    assert (got - ref).abs().max().item() <= 1e-4 * ref.abs().max().item()
    head = sd.var("head_w", "XAVIER", H, V)
    sd.loss.sparse_softmax_cross_entropy(sd.placeholder("lab", (B, T)),
                                         sd.op("matmul", sd.get_variable(enc), head),
                                         name="loss")
    sd.set_loss_variables("loss")
    sd.set_training_config(autodiff.TrainingConfig(
        updater=Adam(1e-3), data_set_feature_mapping=["ids"], data_set_label_mapping=["lab"]))
    sd.fit(ids, lab)
    start = chip_smoke._sd_state(sd)
    eager = []
    for _ in range(3):
        sd.fit(ids, lab)
        eager.append(sd.score())
    want = sd.variables_["head_w"].clone()
    chip_smoke._sd_restore(sd, start)
    graph = sd.fit_steps({"ids": ids.broadcast_to((3, B, T)),
                          "lab": lab.broadcast_to((3, B, T))}).tolist()
    assert graph == eager
    assert torch.equal(sd.variables_["head_w"], want)
    assert sd._scan_step.captures == 1
