"""The port's SameDiff against the JAX package's, in f64 on the CPU.

Each graph is built in the JAX package and crossed into the port by
``convert.samediff_from_jax`` (nodes, variables, constants, training
configuration and updater state), so both start from the JAX package's
own values; everything then agrees within 1e-10 relative:

- ``output`` of a small MLP and of a conv net (with a bias, and a 3x3
  stride-1 SAME conv without one, which the port runs as
  ``conv3x3_same``);
- 5 ``fit`` steps with Adam on a ``FixedSchedule`` and on a
  ``StepSchedule``, with l2;
- ``fit_steps`` against k ``fit`` steps, and ``fit(iterator=...,
  fused_steps=3)`` with a tail;
- ``calculate_gradients``, and ``evaluate`` over an iterator (the same
  confusion matrix);
- ``cond`` and ``scan`` with their gradients, and ``while_loop`` forward;
- a Python-scalar constant in an f32 graph (it stays f32, as in JAX), and
  a 0-dim f64 array constant (it promotes to f64, as in JAX);
- dropout with retain probability 1, and with one keep mask injected into
  both packages;
- the shared zip: a JAX-saved graph loaded by the port and trained on
  equals the JAX package, and the port's zip loaded by the JAX package
  likewise.
"""
import torch_test_threads  # noqa: F401  (first: one torch thread a worker)
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deeplearning4j_tpu.autodiff import SameDiff as JSameDiff
from deeplearning4j_tpu.autodiff import TrainingConfig as JTrainingConfig
from deeplearning4j_tpu.train import schedules as jsched
from deeplearning4j_tpu.train.updaters import Adam as JAdam
from deeplearning4j_tpu_torch import convert
from deeplearning4j_tpu_torch.autodiff import NotPortedError, SameDiff
from deeplearning4j_tpu_torch.autodiff import ops as port_ops

RTOL = 1e-10


def _close(got, want, rtol=RTOL):
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=1e-13)


def _port(jsd):
    return convert.samediff_from_jax(jsd, device="cpu")


def _data(seed=0, n=6, f=5, c=3):
    rs = np.random.RandomState(seed)
    return rs.randn(n, f), np.eye(c)[rs.randint(0, c, n)]


def _mlp(lr=1e-2, l2=1e-3, dropout=None):
    rs = np.random.RandomState(1)
    sd = JSameDiff.create()
    x = sd.placeholder("x", (-1, 5), dtype="float64")
    y = sd.placeholder("y", (-1, 3), dtype="float64")
    w1, b1 = sd.var("w1", rs.randn(5, 7) * 0.4), sd.var("b1", rs.randn(7) * 0.1)
    w2, b2 = sd.var("w2", rs.randn(7, 3) * 0.4), sd.var("b2", np.zeros(3))
    h = sd.nn.tanh(sd.nn.linear(x, w1, b1))
    if dropout is not None:
        h = sd.nn.dropout(h, p=dropout)
    logits = sd.nn.linear(h, w2, b2, name="logits")
    sd.nn.softmax(logits, name="out")
    sd.loss.softmax_cross_entropy(y, logits, name="loss")
    sd.set_loss_variables("loss")
    sd.set_training_config(JTrainingConfig(
        updater=JAdam(lr), data_set_feature_mapping=["x"], data_set_label_mapping=["y"],
        l2=l2))
    return sd


def _conv():
    rs = np.random.RandomState(2)
    sd = JSameDiff.create()
    x = sd.placeholder("x", (-1, 6, 6, 3), dtype="float64")
    w = sd.var("w", rs.randn(3, 3, 3, 4) * 0.3)
    b = sd.var("b", rs.randn(4) * 0.1)
    w2 = sd.var("w2", rs.randn(3, 3, 4, 4) * 0.3)
    h = sd.nn.relu(sd.cnn.conv2d(x, w, b, padding="SAME"))
    h = sd.cnn.conv2d(h, w2, padding="SAME")           # 3x3 s1 SAME, no bias
    h = sd.cnn.max_pooling2d(h, kernel=(2, 2), stride=(2, 2))
    h = sd.cnn.avg_pooling2d(h, kernel=(3, 3), stride=(1, 1), padding="SAME")
    flat = sd.op("reshape", h, shape=[-1, 36])
    wd = sd.var("wd", rs.randn(36, 3) * 0.2)
    sd.nn.softmax(flat @ wd, name="out")
    return sd


@pytest.mark.parametrize("kind", ["mlp", "conv"])
def test_output_equals_the_jax_package(kind):
    rs = np.random.RandomState(3)
    jsd = _mlp() if kind == "mlp" else _conv()
    x = rs.randn(4, 5) if kind == "mlp" else rs.randn(2, 6, 6, 3)
    sd = _port(jsd)
    _close(sd.output({"x": x}, "out")["out"], jsd.output({"x": x}, "out")["out"])


@pytest.mark.parametrize("schedule", ["fixed", "step"])
def test_five_adam_steps_with_l2_and_a_schedule(schedule):
    lr = (jsched.FixedSchedule(0.02) if schedule == "fixed"
          else jsched.StepSchedule(0.02, 0.5, 2))
    jsd = _mlp(lr=lr, l2=1e-2)
    sd = _port(jsd)
    x, y = _data()
    for _ in range(5):
        jsd.fit(x, y)
        sd.fit(x, y)
        _close(sd.score(), jsd.score())
    for k in jsd.variables_:
        _close(sd.variables_[k], jsd.variables_[k])
    for got, want in zip(convert.samediff_to_jax(sd)["updater_leaves"],
                         jax.tree_util.tree_leaves(jsd.opt_state_)):
        _close(got, want)
    assert sd.iteration == jsd.iteration == 5


def test_fit_steps_and_fused_iterator():
    from deeplearning4j_tpu.data import DataSet as JDataSet
    from deeplearning4j_tpu_torch.data import DataSet
    jsd = _mlp()
    sd, eager = _port(jsd), _port(jsd)
    xs, ys = zip(*[_data(seed=s) for s in range(3)])
    feeds = {"x": np.stack(xs), "y": np.stack(ys)}
    losses = sd.fit_steps(feeds)
    want = jsd.fit_steps(feeds)
    _close(losses, want)
    for x, y in zip(xs, ys):
        eager.fit(x, y)
    for k in jsd.variables_:
        _close(sd.variables_[k], jsd.variables_[k])
        _close(eager.variables_[k], sd.variables_[k])
    # fit(iterator, fused_steps=3) over 7 batches: two blocks and a tail
    batches = [_data(seed=10 + s) for s in range(7)]
    jsd.fit(iterator=[JDataSet(x, y) for x, y in batches], fused_steps=3)
    sd.fit(iterator=[DataSet(x, y) for x, y in batches], fused_steps=3)
    assert sd.iteration == jsd.iteration == 10 and sd.epoch == jsd.epoch == 1
    _close(sd.score(), jsd.score())
    for k in jsd.variables_:
        _close(sd.variables_[k], jsd.variables_[k])


def test_calculate_gradients():
    jsd = _mlp()
    x, y = _data(seed=4)
    got = _port(jsd).calculate_gradients({"x": x, "y": y})
    want = jsd.calculate_gradients({"x": x, "y": y})
    assert sorted(got) == sorted(want)
    for k in want:
        _close(got[k], want[k])


def test_evaluate_equals_the_jax_package():
    from deeplearning4j_tpu.data import DataSet as JDataSet
    from deeplearning4j_tpu_torch.data import DataSet
    jsd = _mlp(lr=0.1)
    for _ in range(3):
        jsd.fit(*_data(seed=20))
    sd = _port(jsd)
    batches = [_data(seed=30 + s, n=16) for s in range(2)]
    got = sd.evaluate([DataSet(x, y) for x, y in batches], "out")
    want = jsd.evaluate([JDataSet(x, y) for x, y in batches], "out")
    np.testing.assert_array_equal(got.confusion, want.confusion)
    assert got.confusion.sum() == 32 and got.accuracy() == want.accuracy()


def _control_flow_graph():
    rs = np.random.RandomState(5)
    sd = JSameDiff.create()
    x = sd.placeholder("x", (3, 4), dtype="float64")
    xs = sd.placeholder("xs", (5, 3, 4), dtype="float64")
    w = sd.var("w", rs.randn(4, 4) * 0.5)
    u = sd.var("u", rs.randn(4, 4) * 0.5)
    pred = sd.op("greater", sd.op("sum", x), 0.0)
    c = sd.cond(pred, lambda s, a, ww: s.nn.tanh(a @ ww),
                lambda s, a, ww: (a @ ww) * 2.0, x, w, name="c")
    h0 = sd.op("zeros_like", x)
    hT, ys = sd.scan(lambda s, h, xt, ww, uu: (s.nn.tanh(xt @ ww + h @ uu),
                                               s.op("square", h)),
                     h0, xs, consts=(w, u), name="sc")
    sd.op("add", sd.op("sum", c), sd.op("add", sd.op("sum", hT), sd.op("sum", ys)),
          name="loss")
    sd.set_loss_variables("loss")
    i, acc = sd.while_loop(lambda s, i, a: s.op("less", i, 5),
                           lambda s, i, a: (i + 1, a * 1.5), sd.constant("i0", np.int32(0)),
                           sd.op("sum", x), name="wl")
    sd.op("identity", acc, name="acc")
    sd.op("identity", i, name="iters")
    return sd


@pytest.mark.parametrize("sign", [1.0, -1.0])
def test_cond_scan_gradients_and_while_forward(sign):
    rs = np.random.RandomState(6)
    x = sign * np.abs(rs.randn(3, 4))
    feeds = {"x": x, "xs": rs.randn(5, 3, 4)}
    jsd = _control_flow_graph()
    sd = _port(jsd)
    got = sd.output(feeds, "loss", "acc", "iters", "c")
    want = jsd.output(feeds, "loss", "acc", "iters", "c")
    for k in want:
        _close(got[k], want[k])
    assert got["iters"].dtype == torch.int32 and int(got["iters"]) == 5
    g, gj = sd.calculate_gradients(feeds), jsd.calculate_gradients(feeds)
    for k in gj:
        _close(g[k], gj[k])


def test_python_scalar_constant_keeps_the_graph_dtype():
    rs = np.random.RandomState(7)
    jsd = JSameDiff.create()
    x = jsd.placeholder("x", (2, 3))
    y = x * 2.0 + 1
    jsd.op("mul", y, np.float64(0.5), name="strong")
    jsd.op("identity", y, name="weak")
    sd = _port(jsd)
    xv = rs.randn(2, 3).astype(np.float32)
    got, want = sd.output({"x": xv}, "weak", "strong"), jsd.output({"x": xv}, "weak", "strong")
    assert got["weak"].dtype == torch.float32 and want["weak"].dtype == jnp.float32
    assert got["strong"].dtype == torch.float64 and want["strong"].dtype == jnp.float64
    for k in want:
        _close(got[k], want[k], rtol=1e-7)
    # built in the port directly, the scalar stays weak too
    p = SameDiff.create(device="cpu")
    px = p.placeholder("x", (2, 3))
    out = (px * 2.0 + 1).eval({"x": xv})
    assert out.dtype == torch.float32


def test_dropout_retain_one_and_an_injected_mask(monkeypatch):
    x, y = _data(seed=8)
    # p = 1 keeps everything: the same steps as without dropout
    jsd, ref = _mlp(dropout=1.0), _mlp()
    sd = _port(jsd)
    for _ in range(2):
        jsd.fit(x, y)
        sd.fit(x, y)
        ref.fit(x, y)
        _close(sd.score(), jsd.score())
        _close(sd.score(), ref.score())
    # one keep mask, injected into both packages
    mask = np.random.RandomState(9).rand(6, 7) < 0.6
    monkeypatch.setattr(jax.random, "bernoulli", lambda key, p, shape: jnp.asarray(mask))
    monkeypatch.setattr(port_ops, "keep_mask", lambda gen, p, x: torch.as_tensor(mask))
    jsd = _mlp(dropout=0.6)
    sd = _port(jsd)
    for _ in range(3):
        jsd.fit(x, y)
        sd.fit(x, y)
        _close(sd.score(), jsd.score())
    for k in jsd.variables_:
        _close(sd.variables_[k], jsd.variables_[k])
    # inference: no generator is fed, dropout is the identity
    _close(sd.output({"x": x}, "out")["out"], jsd.output({"x": x}, "out")["out"])


def test_zips_cross_both_ways(tmp_path):
    x, y = _data(seed=11)
    jsd = _mlp()
    jsd.fit(x, y)
    jsd.save(str(tmp_path / "jax.zip"))
    sd = SameDiff.load(str(tmp_path / "jax.zip"), device="cpu")
    assert sd.iteration == 1
    for _ in range(3):
        jsd.fit(x, y)
        sd.fit(x, y)
        _close(sd.score(), jsd.score())
    sd.save(str(tmp_path / "port.zip"))
    back = JSameDiff.load(str(tmp_path / "port.zip"))
    assert back.iteration == 4
    for _ in range(2):
        back.fit(x, y)
        sd.fit(x, y)
        _close(sd.score(), back.score())
    for k in back.variables_:
        _close(sd.variables_[k], back.variables_[k])


def test_entry_points_and_not_ported_namespaces():
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            SameDiff.create()
    sd = SameDiff.create(device="cpu")
    x = sd.placeholder("x", (2, 2))
    with pytest.raises(NotPortedError, match="not ported yet"):
        sd.random.normal(0.0, 1.0, (2, 2))
    with pytest.raises(NotPortedError, match="not ported yet"):
        sd.image.rgb_to_hsv(x)
    with pytest.raises(AttributeError):
        sd.image.not_an_op(x)
    assert sd.linalg.matmul(x, x).eval({"x": np.eye(2)}).shape == (2, 2)
    with pytest.raises(NotImplementedError, match="A6"):
        sd.set_executable_cache("somewhere")
    with pytest.raises(NotImplementedError, match="A6"):
        sd.apply_schedule(None)
    with pytest.raises(KeyError, match="Unmapped op"):
        sd.op("no_such_op", x)
