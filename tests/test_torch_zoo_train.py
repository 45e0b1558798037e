"""The zoo's SimpleCNN, AlexNet and Darknet19 in the PyTorch port against
the JAX package, and the kernel route of a narrow VGG-shaped network
(Darknet19's small-input step is in `test_torch_zoo_darknet.py`).

Nets are configured in the JAX package, cross to the port as JSON, start
from the JAX package's parameters (`convert.params_from_jax`) and run in
f64 on the CPU; everything agrees within 1e-10 relative (max|diff| <=
1e-10 * max|ref| per tensor).  Dropout is set to retain 1.0 in both
packages wherever a step is compared (their generators differ).

SimpleCNN's convs keep a bias in front of each BatchNorm, so those biases
get a gradient that is zero in exact arithmetic: Adam turns its rounding
into steps of ~1e-12 that differ between the packages in relative terms.
They are held to 1e-9 absolute (their values are ~1e-11), and the
BatchNorm running means they shift by as much to 1e-9 absolute too.
"""
import math

import jax
import numpy as np
import pytest

from deeplearning4j_tpu import nn as jnn
from deeplearning4j_tpu import zoo as jzoo
from deeplearning4j_tpu_torch import convert
from deeplearning4j_tpu_torch import nn as tnn
from deeplearning4j_tpu_torch import zoo as tzoo
from deeplearning4j_tpu_torch.nn import MultiLayerConfiguration, MultiLayerNetwork
from deeplearning4j_tpu_torch.ops import conv_kernels as ck
from deeplearning4j_tpu_torch.ops.kernels import conv3x3, dispatch, matmul
from deeplearning4j_tpu_torch.train import Adam

RTOL = 1e-10
ATOL_ZERO_GRAD = 1e-9


def _close(got, want, what="", atol=0.0):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    scale = max(float(np.abs(want).max()), 1e-300) if want.size else 1.0
    err = float(np.abs(got - want).max()) if want.size else 0.0
    assert err <= max(RTOL * scale, atol), f"{what}: max|diff| {err} > {RTOL} * {scale}"


def _f64_no_dropout(conf):
    conf.dtype = "float64"
    for layer in conf.layers:
        if layer.dropout is not None:
            layer.dropout = 1.0
    return conf


def _twin(jconf):
    jnet = jnn.MultiLayerNetwork(jconf).init()
    tnet = MultiLayerNetwork(MultiLayerConfiguration.from_json(jconf.to_json()),
                             device="cpu").init()
    assert tnet.conf.to_json() == jconf.to_json()
    convert.params_from_jax(tnet, jax.tree_util.tree_map(np.asarray, jnet.params_))
    convert.state_from_jax(tnet, jax.tree_util.tree_map(np.asarray, jnet.state_))
    return jnet, tnet


def _zero_grad_biases(conf):
    """Names of conv layers whose bias feeds a BatchNorm directly."""
    out = set()
    for i, layer in enumerate(conf.layers[:-1]):
        if (type(layer).__name__ == "ConvolutionLayer" and layer.has_bias
                and type(conf.layers[i + 1]).__name__ == "BatchNormalizationLayer"):
            out.add(conf.layer_name(i))
    return out


def _same_nets(jnet, tnet, zero_grad=()):
    jp = jax.tree_util.tree_map(np.asarray, jnet.params_)
    tp = convert.params_to_jax(tnet)
    for n in jp:
        for k in jp[n]:
            atol = ATOL_ZERO_GRAD if (n in zero_grad and k == "b") else 0.0
            _close(tp[n][k], jp[n][k], f"params {n}.{k}", atol)
    js = jax.tree_util.tree_map(np.asarray, jnet.state_)
    ts = convert.state_to_jax(tnet)
    bn_after = {tnet.conf.layer_name(i + 1) for i in range(len(tnet.conf.layers) - 1)
                if tnet.conf.layer_name(i) in zero_grad}
    for n in js:
        for k in js[n]:
            atol = ATOL_ZERO_GRAD if (n in bn_after and k == "mean") else 0.0
            _close(ts[n][k], js[n][k], f"state {n}.{k}", atol)
    jo = jax.tree_util.tree_map(np.asarray, jnet.opt_state_)
    to = convert.opt_state_to_jax(tnet)
    for n in jo:
        for (path, a), (_, b) in zip(jax.tree_util.tree_leaves_with_path(to[n]),
                                     jax.tree_util.tree_leaves_with_path(jo[n])):
            key = jax.tree_util.keystr(path)
            if n in zero_grad and key.endswith("['b']"):
                continue        # moments of a zero gradient: rounding noise
            _close(a, b, f"updater {n}{key}")


def _images(b, h, w, c, classes, seed):
    rs = np.random.RandomState(seed)
    return rs.rand(b, h, w, c), np.eye(classes)[rs.randint(0, classes, b)]


def test_simplecnn_fit_steps_match_jax():
    jconf = _f64_no_dropout(jzoo.SimpleCNN().conf())
    zero = _zero_grad_biases(jconf)
    assert len(zero) == 6
    jnet, tnet = _twin(jconf)
    assert tnet.num_params() == jnet.num_params() == 665_178
    for step in range(3):
        x, y = _images(4, 48, 48, 3, 10, seed=step)
        jnet.fit(x, y)
        tnet.fit(x, y)
        _close(tnet.score(), jnet.score(), f"loss {step}")
    _same_nets(jnet, tnet, zero)


@pytest.mark.parametrize("name", ["AlexNet", "Darknet19"])
def test_published_width_config_and_parameter_count(name):
    jconf = getattr(jzoo, name)().conf()
    model = getattr(tzoo, name)()
    assert model.conf().to_json() == jconf.to_json()
    shapes = jax.eval_shape(lambda: jnn.MultiLayerNetwork(jconf).init().params_)
    jcount = sum(math.prod(s.shape) for s in jax.tree_util.tree_leaves(shapes))
    assert model.input_shape == (224, 224, 3) and model.n_classes == 1000
    net = model.init_model(device="cpu")
    assert net.num_params() == jcount == {"AlexNet": 50_844_008,
                                          "Darknet19": 21_843_376}[name]
    if name == "AlexNet":
        assert type(net.conf.updater).__name__ == "Nesterovs"
        assert net.conf.updater.to_json() == jconf.updater.to_json()
        assert net.conf.weight_init == "NORMAL"


def test_alexnet_small_input_output_gradient_and_step_match_jax():
    """AlexNet at 96x96x3, 10 classes, batch 2, its own Nesterovs(1e-2, 0.9)."""
    jconf = _f64_no_dropout(jzoo.AlexNet(n_classes=10, input_shape=(96, 96, 3)).conf())
    check_output_gradient_and_step(jconf, _images(2, 96, 96, 3, 10, seed=7))


def check_output_gradient_and_step(jconf, data):
    """`output`, `gradient_for` (the JAX package's, compiled) and one `fit`
    step of the port against the JAX package."""
    jnet, tnet = _twin(jconf)
    x, y = data
    _close(tnet.output(x), np.asarray(jnet.output(x)), "output")
    jg = jax.jit(jnet.gradient_for)(x, y)
    tg = tnet.gradient_for(x, y)
    for n in jg:
        for k in jg[n]:
            _close(convert.to_jax_layout(tnet.layer_by_name(n), k, tg[n][k]),
                   jg[n][k], f"gradient {n}.{k}")
    jnet.fit(x, y)
    tnet.fit(x, y)
    _close(tnet.score(), jnet.score(), "loss")
    _same_nets(jnet, tnet)


def test_narrow_vgg_takes_the_kernel_route(monkeypatch):
    """With dispatch forced to the kernels and the launchers standing in
    as the plain versions, a fit step launches fused_dense once for the
    relu Dense, wgrad once per 3x3 conv and dgrad once per conv after the
    first (whose input is the data); output and evaluate launch only
    fused_dense."""
    from deeplearning4j_tpu_torch.data import DataSet, ListDataSetIterator
    from deeplearning4j_tpu_torch.zoo.models import _vgg_blocks
    counts = {"dense": 0, "wgrad": 0, "dgrad": 0}

    def fake_dense(x, w, bias, activation):
        counts["dense"] += 1
        return matmul.fused_dense_reference(x, w, bias, activation)

    def fake_wgrad(x, dy):
        counts["wgrad"] += 1
        return ck.conv3x3_wgrad_reference(x, dy)

    def fake_dgrad(dy, w):
        counts["dgrad"] += 1
        return ck.conv3x3_dgrad_reference(dy, w)

    monkeypatch.setattr(dispatch, "resolve", lambda *a, **k: "kernel")
    monkeypatch.setattr(matmul, "_launch", fake_dense)
    monkeypatch.setattr(conv3x3, "launch_wgrad", fake_wgrad)
    monkeypatch.setattr(conv3x3, "launch_dgrad", fake_dgrad)
    conf = (tnn.NeuralNetConfiguration.builder().seed(1).updater(Adam(1e-3))
            .weight_init("XAVIER")
            .list(_vgg_blocks([(1, 4), (2, 8)]) + [
                tnn.DenseLayer(n_out=16, activation="relu", dropout=0.5),
                tnn.OutputLayer(n_out=3, loss="mcxent", activation="softmax")])
            .set_input_type(tnn.InputType.convolutional(8, 8, 3)).build())
    net = MultiLayerNetwork(conf, device="cpu").init()
    x, y = _images(4, 8, 8, 3, 3, seed=2)
    x, y = x.astype(np.float32), y.astype(np.float32)
    for step in range(2):
        net.fit(x, y)
        assert counts == {"dense": step + 1, "wgrad": 3 * (step + 1),
                          "dgrad": 2 * (step + 1)}
    net.output(x)
    net.evaluate(ListDataSetIterator([DataSet(x, y), DataSet(x, y)]))
    assert counts == {"dense": 5, "wgrad": 6, "dgrad": 4}
    assert np.isfinite(net.score())
