"""The zoo's SqueezeNet v1.1 and U-Net in the PyTorch port against the JAX
package.

Both configurations give the JAX package's JSON string, at the defaults
and at the published widths (SqueezeNet 224x224x3 with 1000 classes; U-Net
at `UNet.java`'s 64 base filters and 512x512x3), with equal parameter
counts.  At small inputs (SqueezeNet 48x48x3 with 10 classes, U-Net
16x16x3 with 4 base filters) nets configured in the JAX package cross to
the port as JSON, start from the JAX package's parameters (drawn with numpy, see
`numpy_init`) and run in f64
on the CPU: the forward, and one `fit` step's loss, parameters, BatchNorm
state and Adam state, agree within 1e-10 relative (max|diff| <= 1e-10 *
max|ref| per tensor).  SqueezeNet's dropout retains 1.0 in both packages
wherever a step is compared (their generators differ); with its 0.5 a
training step draws from the network's generator.  With dispatch forced
to the kernels and the conv launchers standing in as the plain versions,
a step launches the 3x3 conv wgrad once per stride-1 3x3 conv and dgrad
once per such conv whose input needs a gradient: SqueezeNet 8 and 8 (its
stride-2 stem is no kernel shape), U-Net 18 and 17 (its first conv reads
the data).
"""
import torch_test_threads  # noqa: F401  (first: one torch thread a worker)
import jax
import numpy as np
import pytest
import torch

from deeplearning4j_tpu import nn as jnn
from deeplearning4j_tpu.zoo.graphs import SqueezeNet as JSqueezeNet
from deeplearning4j_tpu.zoo.graphs import UNet as JUNet
from deeplearning4j_tpu_torch import convert
from deeplearning4j_tpu_torch import nn as tnn
from deeplearning4j_tpu_torch import zoo as tzoo
from deeplearning4j_tpu_torch.ops import conv_kernels as ck
from deeplearning4j_tpu_torch.ops.kernels import conv3x3, dispatch

RTOL = 1e-10
MODELS = {"SqueezeNet": (JSqueezeNet, tzoo.SqueezeNet), "UNet": (JUNet, tzoo.UNet)}
SMALL = {"SqueezeNet": dict(n_classes=10, input_shape=(48, 48, 3)),
         "UNet": dict(input_shape=(16, 16, 3), base_filters=4)}
KERNEL_LAUNCHES = {"SqueezeNet": (8, 8), "UNet": (18, 17)}


def _close(got, want, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    scale = max(float(np.abs(want).max()), 1e-300) if want.size else 1.0
    err = float(np.abs(got - want).max()) if want.size else 0.0
    assert err <= RTOL * scale, f"{what}: max|diff| {err} > {RTOL} * {scale}"


@pytest.mark.parametrize("kw", [dict(), dict(seed=5, compute_dtype="bfloat16")])
@pytest.mark.parametrize("name", sorted(MODELS))
def test_config_json_equals_jax(name, kw):
    jcls, tcls = MODELS[name]
    for extra in ({}, SMALL[name]) + (({"base_filters": 64, "input_shape": (512, 512, 3)},)
                                      if name == "UNet" else ()):
        jd = jcls(**kw, **extra).conf().to_json()
        assert tcls(**kw, **extra).conf().to_json() == jd
        assert tnn.ComputationGraphConfiguration.from_json(jd).to_json() == jd


PUBLISHED = {"SqueezeNet": {}, "UNet": {"base_filters": 64, "input_shape": (512, 512, 3)}}


@pytest.mark.parametrize("name", sorted(MODELS))
def test_published_width_parameter_count_equals_jax(name):
    jcls, tcls = MODELS[name]
    jconf = jcls(**PUBLISHED[name]).conf()
    want = sum(int(np.prod(s.shape)) for s in jax.tree_util.tree_leaves(
        jax.eval_shape(lambda: jnn.ComputationGraph(jconf).init().params_)))
    assert tcls(**PUBLISHED[name]).init_model(device="cpu").num_params() == want


def _no_dropout_f64(conf):
    conf.dtype = "float64"
    for v in conf.vertices.values():
        layer = getattr(v, "layer", None)
        if layer is not None and layer.dropout is not None:
            layer.dropout = 1.0
    return conf


@pytest.fixture
def numpy_init(monkeypatch):
    """The JAX package's weight initializer replaced, for these tests only,
    by He-scaled normals from numpy: its threefry draw compiles once per
    weight shape (~0.4 s each, 69 of them in U-Net), and the parity tests
    copy the JAX net's initial parameters into the port whatever they are."""
    import jax.numpy as jnp
    from deeplearning4j_tpu.nn import layers as jlayers
    rs = np.random.RandomState(0)

    def init(key, shape, scheme, dtype=jnp.float32, dist_params=None):
        fan_in = float(np.prod(shape[:-1]))
        return jnp.asarray(rs.randn(*shape) * np.sqrt(2.0 / fan_in), dtype)

    monkeypatch.setattr(jlayers, "init_weights", init)


def _twin(name):
    jcls, _ = MODELS[name]
    jconf = _no_dropout_f64(jcls(**SMALL[name]).conf())
    jnet = jnn.ComputationGraph(jconf).init()
    tnet = tnn.ComputationGraph(tnn.ComputationGraphConfiguration.from_json(jconf.to_json()),
                                device="cpu").init()
    assert tnet.conf.to_json() == jconf.to_json()
    convert.params_from_jax(tnet, jax.tree_util.tree_map(np.asarray, jnet.params_))
    convert.state_from_jax(tnet, jax.tree_util.tree_map(np.asarray, jnet.state_))
    return jnet, tnet


def _data(name, batch=2, seed=3, dtype=np.float64):
    rs = np.random.RandomState(seed)
    h, w, c = SMALL[name]["input_shape"]
    x = rs.rand(batch, h, w, c).astype(dtype)
    if name == "UNet":
        y = (rs.rand(batch, h, w, 1) > 0.5).astype(dtype)
    else:
        y = np.eye(10, dtype=dtype)[rs.randint(0, 10, batch)]
    return x, y


def _same_nets(jnet, tnet):
    jp = jax.tree_util.tree_map(np.asarray, jnet.params_)
    tp = convert.params_to_jax(tnet)
    for n in jp:
        for k in jp[n]:
            _close(tp[n][k], jp[n][k], f"params {n}.{k}")
    js = jax.tree_util.tree_map(np.asarray, jnet.state_)
    ts = convert.state_to_jax(tnet)
    for n in js:
        for k in js[n]:
            _close(ts[n][k], js[n][k], f"state {n}.{k}")
    jo = jax.tree_util.tree_map(np.asarray, jnet.opt_state_)
    to = convert.opt_state_to_jax(tnet)
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(jo),
                            jax.tree_util.tree_leaves(to)):
        _close(b, a, f"updater {jax.tree_util.keystr(path)}")


@pytest.mark.parametrize("name", sorted(MODELS))
def test_small_input_forward_and_one_step_match_jax(name, numpy_init):
    jnet, tnet = _twin(name)
    x, y = _data(name)
    _close(tnet.output(x)[0].numpy(), np.asarray(jnet.output(x)[0]), "output")
    jnet.fit(x, y)
    tnet.fit(x, y)
    _close(tnet.score(), jnet.score(), "loss")
    _same_nets(jnet, tnet)


def test_squeezenet_dropout_draws_from_the_network_generator():
    net = tzoo.SqueezeNet(**SMALL["SqueezeNet"]).init_model(device="cpu")
    x, y = _data("SqueezeNet", dtype=np.float32)
    state = {k: v.clone() for k, v in net.state_dict().items()}
    g0 = net._rng.get_state().clone() if net._rng is not None else None
    net.fit(x, y)
    assert net._rng is not None and (g0 is None or not torch.equal(net._rng.get_state(), g0))
    again = tzoo.SqueezeNet(**SMALL["SqueezeNet"]).init_model(device="cpu")
    again.load_state_dict(state)
    again.fit(x, y)
    assert again.score() == net.score()        # the same seed draws the same masks


@pytest.mark.parametrize("name", sorted(MODELS))
def test_a_step_takes_the_conv_kernel_route(name, monkeypatch):
    counts = {"wgrad": 0, "dgrad": 0}

    def fake_wgrad(x, dy):
        counts["wgrad"] += 1
        return ck.conv3x3_wgrad_reference(x, dy)

    def fake_dgrad(dy, w):
        counts["dgrad"] += 1
        return ck.conv3x3_dgrad_reference(dy, w)

    monkeypatch.setattr(dispatch, "resolve", lambda *a, **k: "kernel")
    monkeypatch.setattr(conv3x3, "launch_wgrad", fake_wgrad)
    monkeypatch.setattr(conv3x3, "launch_dgrad", fake_dgrad)
    net = MODELS[name][1](**SMALL[name]).init_model(device="cpu")
    x, y = _data(name, dtype=np.float32)
    for step in range(2):
        net.fit(x, y)
        want = KERNEL_LAUNCHES[name]
        assert (counts["wgrad"], counts["dgrad"]) == (want[0] * (step + 1),
                                                      want[1] * (step + 1))
    assert np.isfinite(net.score())


@pytest.mark.parametrize("loss", ["xent", "l1", "mean_absolute_error",
                                  "mean_squared_logarithmic_error",
                                  "mean_absolute_percentage_error"])
def test_loss_gradients_at_the_kinks_match_jax(loss):
    """Inputs exactly at max(x, 0)'s and |x|'s kinks (a U-Net sigmoid head
    on a zero input and zero bias has logits of exactly 0 there): the
    port's losses take the JAX package's gradients."""
    from deeplearning4j_tpu.ops import losses as jl
    from deeplearning4j_tpu_torch.ops import losses as tl
    labels = np.array([[0.0, 1.0, 0.5, 2.0], [1.0, 0.0, 0.0, 3.0]])
    preds = np.array([[0.0, 0.0, 0.5, -1.0], [1.0, 0.0, 0.7, 3.0]])
    want = np.asarray(jax.grad(lambda p: jl.get_loss(loss)(jax.numpy.asarray(labels), p))(
        jax.numpy.asarray(preds)))
    t = torch.tensor(preds, requires_grad=True)
    tl.LOSSES[loss](torch.tensor(labels), t).backward()
    _close(t.grad.numpy(), want, loss)
