"""The rest of the layer set in the PyTorch port against the JAX package:
ElementWiseMultiplication, Embedding, EmbeddingSequence, Convolution1D,
DepthwiseConvolution2D, SeparableConvolution2D, Deconvolution2D,
Upsampling2D, ZeroPadding, LocalResponseNormalization and the shape layers
(Reshape, Permute, RepeatVector, Flatten, TimeDistributed).

Each case builds the layer in the JAX package, crosses its JSON to the
port (`Layer.from_json`, which must give the same `to_json()`), carries
the JAX-initialized params over (`convert.from_jax_layout`), perturbs
them, and runs both forwards on the same seeded input in f64; then the
gradients of sum(y * r), r a seeded cotangent, with respect to every
parameter and a floating input.  All within 1e-10 relative (max|diff| <=
1e-10 * max|ref|).  Small MLNs with these layers then take two `fit`
steps in both packages, and their zips cross both ways.
"""
import torch_test_threads  # noqa: F401  (first: one torch thread a worker)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu import nn as jnn
from deeplearning4j_tpu.train import updaters as jupd
from deeplearning4j_tpu_torch import convert
from deeplearning4j_tpu_torch import nn as tnn
from deeplearning4j_tpu_torch.ops.kernels import matmul

RTOL = 1e-10


def _close(got, want, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, f"{what}: {got.shape} vs {want.shape}"
    scale = max(float(np.abs(want).max()), 1e-300) if want.size else 1.0
    err = float(np.abs(got - want).max()) if want.size else 0.0
    assert err <= RTOL * scale, f"{what}: max|diff| {err} > {RTOL} * {scale}"


def _check_layer(jl, in_type, x, seed=0, float_input=True):
    """Forward, parameter and input gradients and JSON of JAX layer `jl`
    against its port."""
    tl = tnn.Layer.from_json(jl.to_json())
    assert tl.to_json() == jl.to_json()
    jit = getattr(jnn.InputType, in_type[0])(*in_type[1])
    tit = getattr(tnn.InputType, in_type[0])(*in_type[1])
    jp, js, jt = jl.initialize(jax.random.PRNGKey(seed), jit, jnp.float64)
    tp0, _, tt = tl.initialize(torch.Generator().manual_seed(seed), tit,
                               torch.float64)
    assert (jt.kind, tuple(jt.shape)) == (tt.kind, tuple(tt.shape))
    assert set(tp0) == set(jp) and all(tuple(tp0[k].shape) == tuple(
        convert.from_jax_layout(tl, k, np.asarray(v)).shape) for k, v in jp.items())
    rs = np.random.RandomState(seed + 1)
    jp = {k: jnp.asarray(np.asarray(v) + 0.3 * rs.randn(*v.shape)) for k, v in jp.items()}
    tp = {k: convert.from_jax_layout(tl, k, np.asarray(v)).requires_grad_(True)
          for k, v in jp.items()}
    out = jax.eval_shape(lambda p, xx: jl.apply(p, js, xx)[0], jp, jnp.asarray(x))
    r = rs.randn(*out.shape)

    def jloss(p, xx):
        y = jl.apply(p, js, xx)[0]
        return jnp.sum(y * r), y

    # one compiled forward and backward (eager JAX compiles op by op)
    argnums = (0, 1) if float_input else (0,)
    (_, want), jg = jax.jit(jax.value_and_grad(jloss, argnums=argnums, has_aux=True))(
        jp, jnp.asarray(x))
    tx = torch.from_numpy(np.array(x)).requires_grad_(float_input)
    got, _ = tl.apply(tp, {}, tx)
    _close(got.detach(), want, "forward")
    assert got.shape[1:] == tuple(tt.shape)
    wanted = list(tp.values()) + ([tx] if float_input else [])
    tg = torch.autograd.grad((got * torch.from_numpy(r)).sum(), wanted)
    for (k, v), g in zip(tp.items(), tg):
        _close(convert.to_jax_layout(tl, k, g), jg[0][k], f"d{k}")
    if float_input:
        _close(tg[-1], jg[1], "dx")
    return tl


def _x(*shape, seed=3):
    return np.random.RandomState(seed).randn(*shape)


def test_elementwise_multiplication():
    _check_layer(jnn.ElementWiseMultiplicationLayer(activation="tanh", bias_init=0.1),
                 ("feed_forward", (7,)), _x(4, 7))


@pytest.mark.parametrize("shape", [(8,), (8, 1)])
def test_embedding_wraps_negative_and_clamps_out_of_range_indices(shape):
    idx = np.array([0, 3, 9, -1, -10, -11, 12, 40], np.float64).reshape(shape)
    tl = _check_layer(jnn.EmbeddingLayer(n_in=10, n_out=4, has_bias=True,
                                         activation="relu"),
                      ("feed_forward", (1,)), idx, float_input=False)
    assert tl.to_json()["@layer"] == "EmbeddingLayer"


def test_embedding_sequence():
    idx = np.array([[0, 1, 9, -1, 15], [4, -12, 2, 2, 7]], np.float64)
    _check_layer(jnn.EmbeddingSequenceLayer(n_in=10, n_out=3, has_bias=True),
                 ("recurrent", (10, 5)), idx, float_input=False)


@pytest.mark.parametrize("mode,k,s,p,d", [
    ("Same", 3, 1, 0, 1), ("Same", 4, 2, 0, 1), ("Same", 3, 1, 0, 2),
    ("Truncate", 3, 2, 1, 1), ("Truncate", 3, 1, 0, 2), ("Truncate", 2, 1, 0, 1),
])
def test_convolution1d(mode, k, s, p, d):
    _check_layer(jnn.Convolution1DLayer(n_out=5, kernel_size=k, stride=s, padding=p,
                                        dilation=d, convolution_mode=mode,
                                        activation="relu"),
                 ("recurrent", (4, 9)), _x(2, 9, 4))


@pytest.mark.parametrize("mode,k,s,p,m", [
    ("Same", 3, 1, 0, 1), ("Same", 3, 2, 0, 2), ("Truncate", 3, 1, 1, 2),
    ("Truncate", (3, 2), (2, 1), (1, 0), 1),
])
def test_depthwise_convolution(mode, k, s, p, m):
    tl = _check_layer(jnn.DepthwiseConvolution2DLayer(
        depth_multiplier=m, kernel_size=k, stride=s, padding=p,
        convolution_mode=mode, activation="tanh"),
        ("convolutional", (7, 8, 3)), _x(2, 7, 8, 3))
    assert tl.TORCH_LAYOUT["W"] == (3, 2, 0, 1)


@pytest.mark.parametrize("mode,s,p,m", [
    ("Same", 1, 0, 2), ("Same", 2, 0, 1), ("Truncate", 1, 1, 2),
])
def test_separable_convolution(mode, s, p, m):
    _check_layer(jnn.SeparableConvolution2DLayer(
        n_out=4, depth_multiplier=m, stride=s, padding=p, convolution_mode=mode,
        activation="relu", l2=0.1),
        ("convolutional", (6, 7, 3)), _x(2, 6, 7, 3))


def test_separable_regularizes_both_filters():
    tl = tnn.SeparableConvolution2DLayer(n_out=2)
    p, _, _ = tl.initialize(torch.Generator().manual_seed(0),
                            tnn.InputType.convolutional(4, 4, 2))
    assert tl.regularizable_mask(p) == {"W_depth": True, "W_point": True, "b": False}


@pytest.mark.parametrize("mode,k,s,p", [
    ("Same", 3, 1, 0), ("Same", 3, 2, 0), ("Same", 4, 1, 0), ("Same", 4, 2, 0),
    ("Same", 2, 3, 0),
    ("Truncate", 3, 1, 0), ("Truncate", 3, 2, 1), ("Truncate", 4, 2, 1),
    ("Truncate", 4, 1, 0), ("Truncate", 2, 2, 0),
])
def test_deconvolution2d(mode, k, s, p):
    tl = _check_layer(jnn.Deconvolution2DLayer(
        n_out=4, kernel_size=k, stride=s, padding=p, convolution_mode=mode,
        activation="identity"),
        ("convolutional", (5, 6, 3)), _x(2, 5, 6, 3))
    assert tl.TORCH_LAYOUT["W"] == (2, 3, 0, 1)


def test_deconvolution2d_rectangular():
    _check_layer(jnn.Deconvolution2DLayer(n_out=2, kernel_size=(3, 4), stride=(2, 1),
                                          padding=(1, 0)),
                 ("convolutional", (4, 5, 3)), _x(2, 4, 5, 3))


def test_upsampling2d():
    _check_layer(jnn.Upsampling2DLayer(size=(2, 3)), ("convolutional", (3, 4, 2)),
                 _x(2, 3, 4, 2))


@pytest.mark.parametrize("padding", [1, (1, 2), ((1, 0), (2, 3))])
def test_zero_padding(padding):
    _check_layer(jnn.ZeroPaddingLayer(padding=padding), ("convolutional", (3, 4, 2)),
                 _x(2, 3, 4, 2))


@pytest.mark.parametrize("n", [5, 4, 1])
def test_local_response_normalization(n):
    _check_layer(jnn.LocalResponseNormalizationLayer(n=n, alpha=1e-2),
                 ("convolutional", (3, 4, 7)), 5.0 * _x(2, 3, 4, 7))


def test_reshape_permute_repeat_flatten():
    _check_layer(jnn.ReshapeLayer(target_shape=(6, 4)), ("convolutional", (4, 3, 2)),
                 _x(2, 4, 3, 2))
    _check_layer(jnn.ReshapeLayer(target_shape=(2, 3, 4)), ("recurrent", (6, 4)),
                 _x(2, 4, 6))
    _check_layer(jnn.PermuteLayer(dims=(2, 1)), ("recurrent", (6, 4)), _x(2, 4, 6))
    _check_layer(jnn.PermuteLayer(dims=(3, 1, 2)), ("convolutional", (4, 3, 2)),
                 _x(2, 4, 3, 2))
    _check_layer(jnn.RepeatVectorLayer(n=3), ("feed_forward", (5,)), _x(2, 5))
    _check_layer(jnn.FlattenLayer(), ("convolutional", (4, 3, 2)), _x(2, 4, 3, 2))
    assert tnn.input_type_from_shape((2, 3, 4, 5)).kind == "convolutional3d"
    with pytest.raises(ValueError, match="elements"):
        tnn.ReshapeLayer(target_shape=(5,)).initialize(
            torch.Generator(), tnn.InputType.feed_forward(4))
    with pytest.raises(ValueError, match="permutation"):
        tnn.PermuteLayer(dims=(1, 1)).initialize(
            torch.Generator(), tnn.InputType.recurrent(3, 2))


def test_time_distributed_dense_reaches_fused_dense_with_batch_times_time(monkeypatch):
    import deeplearning4j_tpu_torch.nn.layers as layers
    calls = []

    def spy(x, w, bias=None, activation=None):
        calls.append(tuple(x.shape))
        return matmul.fused_dense(x, w, bias=bias, activation=activation)

    monkeypatch.setattr(layers, "fused_dense", spy)
    jl = jnn.TimeDistributed(underlying=jnn.DenseLayer(n_out=5, activation="relu"))
    tl = _check_layer(jl, ("recurrent", (6, 4)), _x(3, 4, 6))
    assert calls == [(12, 6)]
    assert tl.to_json()["underlying"]["@layer"] == "DenseLayer"
    with pytest.raises(ValueError, match="underlying"):
        tnn.TimeDistributed()


# ---------------------------------------------------------------------------
# small networks: two fit steps and the zip, both ways
# ---------------------------------------------------------------------------

def _twin(jconf):
    jnet = jnn.MultiLayerNetwork(jconf).init()
    tnet = tnn.MultiLayerNetwork(tnn.MultiLayerConfiguration.from_json(jconf.to_json()),
                                 device="cpu").init()
    assert tnet.conf.to_json() == jconf.to_json()
    convert.params_from_jax(tnet, jax.tree_util.tree_map(np.asarray, jnet.params_))
    return jnet, tnet


def _same_params(jnet, tnet):
    jp = jax.tree_util.tree_map(np.asarray, jnet.params_)
    tp = convert.params_to_jax(tnet)
    for n in jp:
        for k in jp[n]:
            _close(tp[n][k], jp[n][k], f"{n}.{k}")


def _conv1d_conf():
    return (jnn.NeuralNetConfiguration.builder().seed(3).updater(jupd.Adam(1e-2))
            .dtype("float64")
            .list([jnn.EmbeddingSequenceLayer(n_in=12, n_out=5),
                   jnn.Convolution1DLayer(n_out=6, kernel_size=3, activation="elu"),
                   jnn.Convolution1DLayer(n_out=4, kernel_size=2, stride=2,
                                          convolution_mode="Truncate",
                                          activation="leakyrelu"),
                   jnn.GlobalPoolingLayer(pooling_type="AVG"),
                   jnn.OutputLayer(n_out=3, loss="mcxent", activation="softmax")])
            .set_input_type(jnn.InputType.recurrent(12, 8)).build())


def _conv2d_conf():
    return (jnn.NeuralNetConfiguration.builder().seed(4).updater(jupd.Adam(1e-2))
            .dtype("float64").l2(1e-3)
            .list([jnn.ZeroPaddingLayer(padding=((1, 0), (0, 1))),
                   jnn.DepthwiseConvolution2DLayer(depth_multiplier=2,
                                                   convolution_mode="Same",
                                                   activation="relu6"),
                   jnn.SeparableConvolution2DLayer(n_out=5, stride=2,
                                                   convolution_mode="Same",
                                                   activation="swish"),
                   jnn.LocalResponseNormalizationLayer(n=3),
                   jnn.Deconvolution2DLayer(n_out=3, kernel_size=3, stride=2,
                                            convolution_mode="Same",
                                            activation="softplus"),
                   jnn.Upsampling2DLayer(size=2),
                   jnn.GlobalPoolingLayer(pooling_type="MAX"),
                   jnn.OutputLayer(n_out=4, loss="mcxent", activation="softmax")])
            .set_input_type(jnn.InputType.convolutional(6, 7, 2)).build())


def _data(conf_name, seed=0):
    rs = np.random.RandomState(seed)
    if conf_name == "conv1d":
        x = rs.randint(0, 12, size=(4, 8)).astype(np.float64)
        return x, np.eye(3)[rs.randint(0, 3, 4)]
    return rs.randn(4, 6, 7, 2), np.eye(4)[rs.randint(0, 4, 4)]


@pytest.mark.parametrize("name,make", [("conv1d", _conv1d_conf), ("conv2d", _conv2d_conf)])
def test_small_networks_train_and_cross_the_zip(name, make, tmp_path):
    jnet, tnet = _twin(make())
    for step in range(2):
        x, y = _data(name, seed=step)
        jnet.fit(x, y)
        tnet.fit(x, y)
        _close(tnet.score(), jnet.score(), f"loss {step}")
    _same_params(jnet, tnet)
    x, _ = _data(name, seed=5)
    want = np.asarray(jnet.output(x))
    tnet.save(str(tmp_path / "port.zip"))
    back = jnn.MultiLayerNetwork.load(str(tmp_path / "port.zip"))
    _close(np.asarray(back.output(x)), want, "port zip in JAX")
    jnet.save(str(tmp_path / "jax.zip"))
    loaded = tnn.MultiLayerNetwork.load(str(tmp_path / "jax.zip"), device="cpu")
    _close(loaded.output(x), want, "JAX zip in the port")
    assert (loaded.iteration, back.iteration) == (2, 2)
