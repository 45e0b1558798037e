"""Layers of the PyTorch port against the JAX package's layers.

Each case builds the same layer config in both packages, initializes the
JAX one, carries its params across (`convert.from_jax_layout`: a conv W
goes HWIO -> OIHW) and runs both forwards on the same NHWC numpy input
made from a seed.  f32, atol 1e-5.  The pooling cases use odd sizes and
negative inputs, where lax's asymmetric SAME padding and its -inf fill
decide the answer.
"""
import torch_test_threads  # noqa: F401  (first: one torch thread a worker)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu import nn as jnn
from deeplearning4j_tpu_torch import convert
from deeplearning4j_tpu_torch import nn as tnn


def _run(name, kw, in_type, x, seed=0):
    jl = getattr(jnn, name)(**kw)
    tl = getattr(tnn, name)(**kw)
    jp, _, jt = jl.initialize(jax.random.PRNGKey(seed),
                              getattr(jnn.InputType, in_type[0])(*in_type[1]),
                              jnp.float32)
    _, _, tt = tl.initialize(torch.Generator().manual_seed(seed),
                             getattr(tnn.InputType, in_type[0])(*in_type[1]))
    assert tuple(jt.shape) == tuple(tt.shape) and jt.kind == tt.kind
    if "b" in jp:
        # non-zero biases, so a dropped or misplaced bias shows
        jp = dict(jp, b=jnp.asarray(np.random.RandomState(seed + 1)
                                    .randn(*jp["b"].shape).astype(np.float32)))
    tp = {k: convert.from_jax_layout(tl, k, np.asarray(v)) for k, v in jp.items()}
    want, _ = jl.apply(jp, {}, jnp.asarray(x))
    got, _ = tl.apply(tp, {}, torch.from_numpy(x))
    want = np.asarray(want)
    got = got.numpy()
    assert got.shape == want.shape
    assert got.shape[1:] == tuple(tt.shape)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    return got


def _x(*shape, seed=3):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


@pytest.mark.parametrize("act", ["identity", "relu", "tanh", "gelu"])
def test_dense(act):
    _run("DenseLayer", dict(n_out=6, activation=act), ("feed_forward", (7,)),
         _x(4, 7))


def test_dense_flattens_nhwc():
    _run("DenseLayer", dict(n_out=5, activation="relu"),
         ("convolutional", (3, 3, 4)), _x(2, 3, 3, 4))


def test_output_softmax():
    y = _run("OutputLayer", dict(n_out=5, activation="softmax", loss="mcxent"),
             ("feed_forward", (7,)), _x(4, 7))
    np.testing.assert_allclose(y.sum(-1), 1.0, rtol=1e-6)


def test_output_rejects_unknown_loss():
    with pytest.raises(ValueError, match="Unknown loss"):
        tnn.OutputLayer(n_out=3, loss="nope").initialize(
            torch.Generator(), tnn.InputType.feed_forward(4))


@pytest.mark.parametrize("mode,k,s,pad", [
    ("Same", 3, 1, 0), ("Same", 3, 2, 0), ("Same", 5, 2, 0),
    ("Truncate", 5, 1, 0), ("Truncate", 3, 2, 1), ("Truncate", 5, 2, 2),
])
def test_convolution(mode, k, s, pad):
    _run("ConvolutionLayer",
         dict(n_out=4, kernel_size=k, stride=s, padding=pad,
              convolution_mode=mode, activation="relu"),
         ("convolutional", (9, 11, 3)), _x(2, 9, 11, 3))


def test_convolution_dilated_same():
    _run("ConvolutionLayer",
         dict(n_out=4, kernel_size=3, dilation=2, convolution_mode="Same",
              activation="identity"),
         ("convolutional", (8, 7, 2)), _x(2, 8, 7, 2))


@pytest.mark.parametrize("ptype", ["MAX", "AVG", "SUM", "PNORM"])
@pytest.mark.parametrize("mode,k,s,pad", [
    ("Truncate", 2, 2, 0), ("Truncate", 3, 2, 0), ("Same", 2, 2, 0),
    ("Same", 3, 2, 0), ("Same", 3, 1, 0), ("Truncate", 3, 2, 1),
])
def test_subsampling(ptype, mode, k, s, pad):
    _run("SubsamplingLayer",
         dict(pooling_type=ptype, kernel_size=k, stride=s, padding=pad,
              convolution_mode=mode),
         ("convolutional", (7, 9, 3)), _x(2, 7, 9, 3) - 1.0)


def test_activation_and_dropout_layers():
    _run("ActivationLayer", dict(activation="softmax"),
         ("feed_forward", (7,)), _x(4, 7))
    _run("ActivationLayer", dict(activation="sigmoid"),
         ("convolutional", (3, 3, 2)), _x(2, 3, 3, 2))
    _run("DropoutLayer", dict(dropout=0.5), ("feed_forward", (7,)), _x(4, 7))


@pytest.mark.parametrize("name", ["DenseLayer", "OutputLayer",
                                  "ConvolutionLayer", "SubsamplingLayer",
                                  "ActivationLayer", "DropoutLayer"])
def test_layer_json_matches_jax(name):
    kw = {"DenseLayer": dict(n_out=3, dropout=0.5),
          "OutputLayer": dict(n_out=3, activation="softmax"),
          "ConvolutionLayer": dict(n_out=3, kernel_size=5, stride=2),
          "SubsamplingLayer": dict(pooling_type="AVG", kernel_size=3),
          "ActivationLayer": dict(activation="relu"),
          "DropoutLayer": dict(dropout=0.8)}[name]
    jd = getattr(jnn, name)(**kw).to_json()
    assert getattr(tnn, name)(**kw).to_json() == jd
    assert tnn.Layer.from_json(jd).to_json() == jd
