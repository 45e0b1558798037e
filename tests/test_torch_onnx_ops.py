"""The 22 ops the ONNX importer brings into the port's SameDiff table,
against the JAX package's table on seeded f64 inputs.

- every op's forward within 1e-10 of the JAX op's (values and dtypes),
  at uneven pads, strides, dilations, negative slice steps, duplicate
  scatter indices and each pad mode;
- gradients through autograd against ``jax.grad`` at the kinks: the ties
  of ``clip_by_value`` at both bounds, ``prelu`` at 0, ``hard_swish`` at
  -3, 0 and 3, ``max_pool2d_nchw`` with ties inside its windows (JAX's
  select-and-scatter gives the first maximum in row-major order),
  ``fmod`` across the four sign pairs, and ``pad_mode``'s reflect and
  edge copies; ``avg_pool2d_nchw`` against ``jax.jacfwd`` (its JAX form
  has no reverse-mode rule);
- ``deconv2d_nchw`` with groups refuses in both packages, and the table
  holds 167 ops, all of them the JAX table's.
"""
import torch_test_threads  # noqa: F401  (first: one torch thread a worker)
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deeplearning4j_tpu.autodiff.ops import OP_TABLE as JAX_TABLE
from deeplearning4j_tpu_torch.autodiff.ops import OP_TABLE

RTOL = 1e-10
ONNX_OPS = ("conv2d_nchw", "max_pool2d_nchw", "avg_pool2d_nchw", "global_avg_pool_nchw",
            "reshape_onnx", "flatten2d", "gemm", "batch_norm_nchw", "deconv2d_nchw",
            "slice_onnx", "fmod", "tril", "triu", "scatter_nd_add", "scatter_nd_update",
            "broadcast_to", "prelu", "hard_swish", "clip_by_value", "pad_mode", "gru_layer",
            "lstm_layer_full")
INT64_MAX = np.iinfo(np.int64).max


def _rs(seed):
    return np.random.RandomState(seed)


def _cases():
    r = _rs(0)
    f = lambda *s: r.randn(*s)          # noqa: E731
    x = f(2, 3, 7, 6)
    seq, h0, c0 = f(2, 4, 3), f(2, 5), f(2, 5)
    yield "conv2d_nchw", (x, f(4, 3, 3, 3), f(4)), dict(stride=(2, 1), pads=(1, 0, 2, 1),
                                                        dilation=(1, 2))
    yield "conv2d_nchw-groups", (x, f(6, 1, 3, 3)), dict(pads=(1, 1, 1, 1), groups=3)
    yield "max_pool2d_nchw", (x,), dict(kernel=(3, 3), stride=(2, 2), pads=(1, 1, 0, 1))
    yield "max_pool2d_nchw-int", (r.randint(-9, 9, (2, 3, 7, 6)).astype(np.int64),), dict(
        kernel=(2, 3), stride=(2, 1), pads=(0, 1, 1, 1))
    yield "avg_pool2d_nchw", (x,), dict(kernel=(3, 2), stride=(2, 2), pads=(1, 0, 1, 1))
    yield "avg_pool2d_nchw-include", (x,), dict(kernel=(3, 2), stride=(2, 2),
                                                pads=(1, 0, 1, 1), count_include_pad=True)
    yield "avg_pool2d_nchw-nopads", (x,), dict(kernel=(2, 2), stride=(1, 2))
    yield "global_avg_pool_nchw", (x,), {}
    yield "reshape_onnx", (x,), dict(shape=[0, -1, 3])
    yield "flatten2d", (x,), dict(axis=2)
    yield "gemm", (f(5, 3), f(4, 5), f(4)), dict(alpha=0.5, beta=-2.0, trans_a=1, trans_b=1)
    yield "gemm-nobias", (f(3, 5), f(5, 4)), {}
    yield "batch_norm_nchw", (x, f(3), f(3), f(3), r.uniform(0.5, 1.5, 3)), dict(eps=1e-3)
    yield "deconv2d_nchw", (f(2, 3, 4, 5), f(3, 2, 3, 3), f(2)), dict(
        stride=(2, 2), pads=(1, 0, 1, 2), output_padding=(1, 0))
    yield "deconv2d_nchw-dilated", (f(1, 3, 4, 4), f(3, 2, 2, 3)), dict(dilation=(2, 1))
    yield "slice_onnx", (x,), dict(starts=[-1, 0, 1], ends=[-INT64_MAX, 100, -1],
                                   axes=[1, 3, -2], steps=[-2, 3, 2])
    yield "slice_onnx-default", (x,), dict(starts=[1], ends=[2])
    yield "fmod", (f(3, 4) * 5, r.choice([-1.0, 1.0], (3, 4)) * r.uniform(0.5, 2, (3, 4))), {}
    for k in (-1, 0, 1):
        yield f"tril-{k}", (f(2, 4, 5),), dict(k=k)
        yield f"triu-{k}", (f(2, 4, 5),), dict(k=k)
    yield "scatter_nd_add", (f(5, 3), np.asarray([[0], [3], [0]]), f(3, 3)), {}
    yield "scatter_nd_add-2d", (f(4, 3, 2), np.asarray([[0, 1], [2, 2], [0, 1]]), f(3, 2)), {}
    yield "scatter_nd_update", (f(5, 3), np.asarray([[4], [1]]), f(2, 3)), {}
    yield "broadcast_to", (f(3, 1),), dict(shape=[2, 3, 4])
    yield "prelu", (f(2, 3, 4), r.uniform(0, 0.5, (3, 1))), {}
    yield "hard_swish", (f(4, 5) * 4,), {}
    yield "clip_by_value", (f(4, 5),), dict(lo=-0.5, hi=0.7)
    yield "pad_mode-constant", (f(3, 4),), dict(paddings=[[1, 2], [0, 3]], mode="constant",
                                                value=1.5)
    for mode in ("reflect", "symmetric", "edge"):
        yield f"pad_mode-{mode}", (f(3, 4),), dict(paddings=[[2, 1], [3, 0]], mode=mode)
    yield "gru_layer", (seq, h0, f(3, 15), f(5, 15), f(15), f(15)), {}
    yield "gru_layer-nobias", (seq, h0, f(3, 15), f(5, 15)), {}
    yield "lstm_layer_full", (seq, f(3, 20), f(5, 20), f(20)), {}
    yield "lstm_layer_full-state", (seq, f(3, 20), f(5, 20), f(20), h0, c0), {}


CASES = list(_cases())


def _leaves(out):
    if isinstance(out, (tuple, list)):
        return [x for o in out for x in _leaves(o)]
    return [out]


def _port(op, args, kwargs):
    return OP_TABLE[op](*[torch.as_tensor(a) for a in args], **kwargs)


def _jax(op, args, kwargs):
    return JAX_TABLE[op](*[jnp.asarray(a) for a in args], **kwargs)


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_forward_matches_the_jax_op(case):
    name, args, kwargs = case
    op = name.split("-")[0]
    got, want = _leaves(_port(op, args, kwargs)), _leaves(_jax(op, args, kwargs))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w)
        g = g.numpy()
        assert g.shape == w.shape and g.dtype == w.dtype, (name, g.shape, w.shape, g.dtype)
        scale = max(float(np.abs(w).max()), 1.0) if w.size else 1.0
        assert float(np.abs(g.astype(np.float64) - w).max(initial=0.0)) <= RTOL * scale, name


def test_every_onnx_op_has_a_case_and_the_table_grew():
    assert {c[0].split("-")[0] for c in CASES} == set(ONNX_OPS)
    assert len(ONNX_OPS) == 22 and set(ONNX_OPS) <= set(OP_TABLE) <= set(JAX_TABLE)
    assert len(OP_TABLE) == 167


def _weights(shapes, seed=9):
    r = _rs(seed)
    return [r.uniform(0.5, 1.5, s) for s in shapes]


def _grads(op, args, argnums, kwargs):
    """(autograd through the port's op, jax.grad of the JAX op) of a
    weighted sum of the float outputs, wrt `argnums`."""
    out = _leaves(_jax(op, args, kwargs))
    w = _weights([np.shape(o) for o in out])
    t = [torch.as_tensor(a).clone().requires_grad_(i in argnums) for i, a in enumerate(args)]
    total = sum(torch.sum(o * torch.as_tensor(wi)) for o, wi in
                zip(_leaves(OP_TABLE[op](*t, **kwargs)), w))
    got = torch.autograd.grad(total, [t[i] for i in argnums])

    def f(*diff):
        full = [jnp.asarray(a) for a in args]
        for i, d in zip(argnums, diff):
            full[i] = d
        return sum(jnp.sum(o * wi) for o, wi in zip(_leaves(JAX_TABLE[op](*full, **kwargs)), w))
    want = jax.grad(f, argnums=tuple(range(len(argnums))))(*[jnp.asarray(args[i])
                                                              for i in argnums])
    return [g.numpy() for g in got], [np.asarray(x) for x in want]


def _kink_cases():
    r = _rs(4)
    ties = r.randint(0, 3, (2, 2, 6, 7)).astype(np.float64)      # ties in every window
    edge = np.asarray([[-0.5, 0.7, 0.0, 0.3, -0.5], [0.7, 0.7, -1.0, 2.0, -0.5]])
    yield "clip_by_value-ties", "clip_by_value", (edge,), (0,), dict(lo=-0.5, hi=0.7)
    yield "prelu-zero", "prelu", (np.asarray([[0.0, -1.0, 2.0], [0.0, 0.0, -3.0]]),
                                  np.asarray([0.25, 0.5, 0.1])), (0, 1), {}
    yield "hard_swish-kinks", "hard_swish", (np.asarray([-3.0, -4.0, 0.0, 3.0, 2.5, -3.0]),),\
        (0,), {}
    yield "max_pool2d_nchw-ties", "max_pool2d_nchw", (ties,), (0,), dict(
        kernel=(3, 3), stride=(2, 2), pads=(1, 1, 1, 0))
    yield "max_pool2d_nchw-overlap", "max_pool2d_nchw", (ties,), (0,), dict(
        kernel=(2, 3), stride=(1, 1), pads=(0, 0, 0, 0))
    a = np.asarray([5.5, -5.5, 5.5, -5.5, 0.3, -7.25])
    b = np.asarray([2.0, 2.0, -2.0, -2.0, 0.7, 1.5])
    yield "fmod-signs", "fmod", (a, b), (0, 1), {}
    for mode in ("reflect", "edge"):
        yield f"pad_mode-{mode}", "pad_mode", (r.randn(3, 4),), (0,), dict(
            paddings=[[2, 3], [3, 1]], mode=mode)


KINKS = list(_kink_cases())


@pytest.mark.parametrize("case", KINKS, ids=[c[0] for c in KINKS])
def test_gradients_at_kinks_match_jax_grad(case):
    _, op, args, argnums, kwargs = case
    got, want = _grads(op, args, argnums, kwargs)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=0, atol=RTOL * max(float(np.abs(w).max()), 1.0))


def test_max_pool_tie_goes_to_the_first_maximum():
    x = np.zeros((1, 1, 2, 2))
    got, want = _grads("max_pool2d_nchw", (x,), (0,), dict(kernel=(2, 2), stride=(2, 2)))
    w = _weights([(1, 1, 1, 1)])[0].item()
    np.testing.assert_array_equal(got[0], [[[[w, 0.0], [0.0, 0.0]]]])
    np.testing.assert_array_equal(got[0], want[0])


@pytest.mark.parametrize("count_include_pad", [False, True])
def test_avg_pool_gradient_matches_jax_jacfwd(count_include_pad):
    x = _rs(2).randn(1, 2, 5, 4)
    kw = dict(kernel=(3, 2), stride=(2, 1), pads=(1, 0, 1, 1),
              count_include_pad=count_include_pad)
    jac = np.asarray(jax.jacfwd(lambda v: JAX_TABLE["avg_pool2d_nchw"](v, **kw))(
        jnp.asarray(x)))
    out_shape = jac.shape[:4]
    w = _weights([out_shape])[0]
    want = np.tensordot(w, jac, axes=4)
    t = torch.as_tensor(x).requires_grad_(True)
    (got,) = torch.autograd.grad(torch.sum(OP_TABLE["avg_pool2d_nchw"](t, **kw)
                                           * torch.as_tensor(w)), [t])
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=RTOL)


def test_grouped_deconv_refuses_in_both():
    x, w = np.ones((1, 4, 3, 3)), np.ones((4, 1, 2, 2))
    with pytest.raises(NotImplementedError, match="group"):
        _port("deconv2d_nchw", (x, w), dict(groups=2))
    with pytest.raises(NotImplementedError, match="group"):
        _jax("deconv2d_nchw", (x, w), dict(groups=2))
