"""Activations and weight initializers of the PyTorch port against the JAX
package.

Activations: all 22 names of the JAX inventory, in f64, on a grid that
holds every kink (0, +-1, +-2.5, 6, the threshold 1) and large
arguments (+-30, where softplus(x) - x is 9.2e-14); the values and the
derivative (the gradient of sum f(x); softmax: of sum f(x) * r) against
`jax.grad`, element by element within 1e-12 * max(1, |ref|).

Initializers: ZERO, ONES, IDENTITY and CONSTANT draw nothing and equal the
JAX package's exactly.  The random schemes match by distribution only (the
two packages use different generators): mean, standard deviation and
bounds against the scheme's own formula, which the JAX package's sample
meets too, at a dense and a conv shape.  ORTHOGONAL gives orthonormal
columns (rows, when there are fewer rows) in the JAX layout.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.ops import activations as jact
from deeplearning4j_tpu.ops import initializers as jinit
from deeplearning4j_tpu_torch import convert
from deeplearning4j_tpu_torch import nn as tnn
from deeplearning4j_tpu_torch.ops import activations as tact
from deeplearning4j_tpu_torch.ops import initializers as tinit

KINKS = [0.0, 1.0, -1.0, 2.5, -2.5, 6.0, 30.0, -30.0, 20.0, 1e-300, -1e-300]
GRID = np.concatenate([np.linspace(-8.0, 8.0, 161), KINKS])


def _elementwise_close(got, want, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    bad = np.abs(got - want) > 1e-12 * np.maximum(1.0, np.abs(want))
    assert not bad.any(), (f"{what}: at x = {GRID.reshape(got.shape)[bad][:5]} got "
                           f"{got[bad][:5]} want {want[bad][:5]}")


def test_inventory_has_the_jax_names():
    assert sorted(tact.ACTIVATIONS) == sorted(jact.ACTIVATIONS)
    assert len(tact.ACTIVATIONS) == 22


@pytest.mark.parametrize("name", sorted(jact.ACTIVATIONS))
def test_activation_value_and_gradient_match_jax_at_the_kinks(name):
    jf, tf = jact.get_activation(name), tact.get_activation(name)
    x = GRID
    if name == "softmax":
        x = GRID.reshape(-1, 4)
        r = np.random.RandomState(0).randn(*x.shape)
        jg = jax.grad(lambda v: jnp.sum(jf(v) * r))(jnp.asarray(x))
        tx = torch.tensor(x, requires_grad=True)
        ty = tf(tx)
        (tg,) = torch.autograd.grad((ty * torch.from_numpy(r)).sum(), tx)
    else:
        jg = jax.grad(lambda v: jnp.sum(jf(v)))(jnp.asarray(x))
        tx = torch.tensor(x, requires_grad=True)
        ty = tf(tx)
        (tg,) = torch.autograd.grad(ty.sum(), tx)
    assert ty.dtype == torch.float64
    _elementwise_close(ty.detach(), jf(jnp.asarray(x)), f"{name} value")
    _elementwise_close(tg, jg, f"{name} gradient")


def test_softplus_keeps_its_tail_above_twenty():
    """softplus(x) - x is exp(-x) for large x: 9.4e-14 at 30 in JAX, where
    a threshold at 20 (``F.softplus``) would give 0; its slope is short of
    1 by as much."""
    x = np.array([20.0, 25.0, 30.0])
    want = np.asarray(jact.softplus(jnp.asarray(x))) - x
    jg = 1.0 - np.asarray(jax.vmap(jax.grad(jact.softplus))(jnp.asarray(x)))
    tx = torch.tensor(x, requires_grad=True)
    got = tact.softplus(tx)
    (tg,) = torch.autograd.grad(got.sum(), tx)
    assert (want > 0).all() and (jg > 0).all() and (1.0 - tg.numpy() > 0).all()
    np.testing.assert_allclose(got.detach().numpy() - x, want, rtol=1e-3)
    # the slope (exp(x - softplus(x))) carries the rounding of softplus(x)
    # near 30, up to half its ulp, 1.8e-15
    np.testing.assert_allclose(1.0 - tg.numpy(), jg, rtol=0, atol=2e-15)


@pytest.mark.parametrize("name,kw", [("leakyrelu", {"alpha": 0.2}),
                                     ("elu", {"alpha": 0.5}),
                                     ("thresholdedrelu", {"theta": 0.5})])
def test_activation_args(name, kw):
    x = GRID
    want = jact.get_activation(name)(jnp.asarray(x), **kw)
    jg = jax.grad(lambda v: jnp.sum(jact.get_activation(name)(v, **kw)))(jnp.asarray(x))
    layer = tnn.ActivationLayer(activation=name, activation_args=kw)
    tx = torch.tensor(x, requires_grad=True)
    got, _ = layer.apply({}, {}, tx)
    (tg,) = torch.autograd.grad(got.sum(), tx)
    _elementwise_close(got.detach(), want, f"{name} value")
    _elementwise_close(tg, jg, f"{name} gradient")


def test_dense_with_a_new_activation_takes_the_plain_product(monkeypatch):
    import deeplearning4j_tpu_torch.nn.layers as layers
    calls = []
    monkeypatch.setattr(layers, "fused_dense", lambda *a, **k: calls.append(a))
    layer = tnn.DenseLayer(n_out=3, activation="leakyrelu")
    p, _, _ = layer.initialize(torch.Generator().manual_seed(0),
                               tnn.InputType.feed_forward(4), torch.float64)
    x = torch.from_numpy(np.random.RandomState(1).randn(5, 4))
    y, _ = layer.apply(p, {}, x)
    assert calls == []
    np.testing.assert_array_equal(y.numpy(), tact.leakyrelu(x @ p["W"] + p["b"]).numpy())


def test_unknown_activation_raises():
    with pytest.raises(ValueError, match="Unknown activation"):
        tact.get_activation("nope")


# ---------------------------------------------------------------------------
# initializers
# ---------------------------------------------------------------------------

SHAPES = [(400, 300), (3, 3, 64, 32)]


@pytest.mark.parametrize("scheme,dist", [("ZERO", None), ("ONES", None),
                                         ("CONSTANT", {"value": 0.7}),
                                         ("CONSTANT", None)])
@pytest.mark.parametrize("shape", SHAPES)
def test_deterministic_schemes_are_exact(scheme, dist, shape):
    want = np.asarray(jinit.init_weights(jax.random.PRNGKey(0), shape, scheme,
                                         jnp.float64, dist_params=dist))
    got = tinit.init_weights(torch.Generator().manual_seed(0), shape, scheme,
                             torch.float64, dist_params=dist)
    assert got.dtype == torch.float64
    np.testing.assert_array_equal(got.numpy(), want)


def test_identity_is_exact_and_needs_a_square():
    want = np.asarray(jinit.init_weights(jax.random.PRNGKey(0), (5, 5), "IDENTITY"))
    got = tinit.init_weights(torch.Generator(), (5, 5), "IDENTITY")
    np.testing.assert_array_equal(got.numpy(), want)
    with pytest.raises(ValueError, match="square"):
        tinit.init_weights(torch.Generator(), (5, 4), "IDENTITY")


def _fans(shape):
    if len(shape) == 2:
        return shape[0], shape[1]
    rf = math.prod(shape[:-2])
    return rf * shape[-2], rf * shape[-1]


def _law(scheme, shape):
    """(kind, scale) of each scheme by its formula: a normal's standard
    deviation or a uniform's half-width."""
    fi, fo = _fans(shape)
    return {
        "NORMAL": ("normal", 1 / math.sqrt(fi)),
        "GAUSSIAN": ("normal", 1.0),
        "XAVIER": ("normal", math.sqrt(2 / (fi + fo))),
        "XAVIER_FAN_IN": ("normal", 1 / math.sqrt(fi)),
        "RELU": ("normal", math.sqrt(2 / fi)),
        "HE": ("normal", math.sqrt(2 / fi)),
        "HE_NORMAL": ("normal", math.sqrt(2 / fi)),
        "LECUN_NORMAL": ("normal", math.sqrt(1 / fi)),
        "VAR_SCALING_NORMAL_FAN_AVG": ("normal", math.sqrt(2 / (fi + fo))),
        "UNIFORM": ("uniform", math.sqrt(1 / fi)),
        "XAVIER_UNIFORM": ("uniform", math.sqrt(6 / (fi + fo))),
        "RELU_UNIFORM": ("uniform", math.sqrt(6 / fi)),
        "HE_UNIFORM": ("uniform", math.sqrt(6 / fi)),
        "LECUN_UNIFORM": ("uniform", math.sqrt(3 / fi)),
        "SIGMOID_UNIFORM": ("uniform", 4 * math.sqrt(6 / (fi + fo))),
    }[scheme]


def _meets_law(w, kind, scale, what):
    """Mean within 6 standard errors of 0, sample std within 6 standard
    errors of the law's, and a uniform's samples inside [-a, a] reaching
    within 0.1% of a."""
    w = np.asarray(w, np.float64).ravel()
    n = w.size
    std = scale if kind == "normal" else scale / math.sqrt(3)
    assert abs(w.mean()) <= 6 * std / math.sqrt(n), f"{what}: mean {w.mean()}"
    assert abs(w.std() / std - 1) <= 6 / math.sqrt(2 * n), f"{what}: std {w.std()} vs {std}"
    if kind == "uniform":
        assert np.abs(w).max() <= scale and np.abs(w).max() >= 0.999 * scale, what
    else:
        assert np.abs(w).max() <= 7 * std, what


@pytest.mark.parametrize("scheme", ["NORMAL", "GAUSSIAN", "XAVIER", "XAVIER_FAN_IN",
                                    "RELU", "HE", "HE_NORMAL", "LECUN_NORMAL",
                                    "VAR_SCALING_NORMAL_FAN_AVG", "UNIFORM",
                                    "XAVIER_UNIFORM", "RELU_UNIFORM", "HE_UNIFORM",
                                    "LECUN_UNIFORM", "SIGMOID_UNIFORM"])
@pytest.mark.parametrize("shape", SHAPES)
def test_random_schemes_match_by_distribution(scheme, shape):
    kind, scale = _law(scheme, shape)
    jw = jinit.init_weights(jax.random.PRNGKey(1), shape, scheme, jnp.float64)
    _meets_law(jw, kind, scale, f"JAX {scheme}")
    tw = tinit.init_weights(torch.Generator().manual_seed(1), shape, scheme, torch.float64)
    assert tuple(tw.shape) == shape and tw.dtype == torch.float64
    _meets_law(tw, kind, scale, f"port {scheme}")
    again = tinit.init_weights(torch.Generator().manual_seed(1), shape, scheme, torch.float64)
    assert torch.equal(tw, again)


def _orthonormal(w, what):
    cols = w.reshape(-1, w.shape[-1])
    m = cols.T @ cols if cols.shape[0] >= cols.shape[1] else cols @ cols.T
    np.testing.assert_allclose(m, np.eye(m.shape[0]), atol=1e-5, err_msg=what)


@pytest.mark.parametrize("shape", [(6, 4), (4, 6), (3, 3, 8, 16), (3, 3, 2, 32)])
def test_orthogonal_columns_are_orthonormal_in_the_jax_layout(shape):
    _orthonormal(np.asarray(jinit.init_weights(jax.random.PRNGKey(0), shape,
                                               "ORTHOGONAL")), "JAX")
    w = tinit.init_weights(torch.Generator().manual_seed(0), shape, "ORTHOGONAL")
    assert tuple(w.shape) == shape
    _orthonormal(w.numpy(), "port")


def test_orthogonal_conv_weight_crosses_in_the_jax_layout():
    layer = tnn.ConvolutionLayer(n_out=16, kernel_size=3, weight_init="ORTHOGONAL")
    p, _, _ = layer.initialize(torch.Generator().manual_seed(0),
                               tnn.InputType.convolutional(5, 5, 8))
    assert tuple(p["W"].shape) == (16, 8, 3, 3)
    _orthonormal(convert.to_jax_layout(layer, "W", p["W"]), "conv W, HWIO")


def test_unknown_scheme_raises():
    with pytest.raises(ValueError, match="Unknown weight init scheme"):
        tinit.init_weights(torch.Generator(), (3, 3), "NOPE")
    with pytest.raises(ValueError, match="at least 2"):
        tinit.init_weights(torch.Generator(), (3,), "ORTHOGONAL")
