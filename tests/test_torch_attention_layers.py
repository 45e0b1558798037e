"""The attention layers of the PyTorch port against the JAX package.

``dot_product_attention`` and ``multi_head_attention`` (scaled or not, a
float, int or bool mask, a row whose every key is masked), and
SelfAttentionLayer, LearnedSelfAttentionLayer and RecurrentAttentionLayer:
forward and the gradients of a fixed projection of it, from the same numpy
parameters and inputs, within 1e-10 * max|ref| in f64.  Networks: an LSTM
under SelfAttentionLayer, global pooling and a softmax head (the card's
``seq_attention`` phase at a small size), trained by ``fit`` and
``fit_steps`` with a float and an int features mask; and a
LearnedSelfAttentionLayer, after which the MLN drops the sequence mask
(its output has ``n_queries`` steps).  SelfAttentionLayer and
LearnedSelfAttentionLayer reach the port's ``fused_attention`` (the flash
kernels on the card; with the dispatch forced to the kernel route here,
its launchers see a mask of q's dtype), RecurrentAttentionLayer does not.
"""
import torch_test_threads  # noqa: F401  (first: one torch thread a worker)
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu import nn as jnn
from deeplearning4j_tpu.nn import attention as jatt
from deeplearning4j_tpu.nn import recurrent as jrec
from deeplearning4j_tpu.train import updaters as jupd
from deeplearning4j_tpu_torch import convert
from deeplearning4j_tpu_torch import nn as tnn
from deeplearning4j_tpu_torch.nn import attention as tatt
from deeplearning4j_tpu_torch.nn import recurrent as trec
from deeplearning4j_tpu_torch.ops import attention_kernels as ak
from deeplearning4j_tpu_torch.ops.kernels import attention as ka
from deeplearning4j_tpu_torch.ops.kernels import dispatch
from deeplearning4j_tpu_torch.train import updaters as tupd

RTOL = 1e-10
B, T, F = 3, 7, 8


def _close(got, want, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, f"{what}: {got.shape} vs {want.shape}"
    scale = max(float(np.abs(want).max()), 1e-300)
    err = float(np.abs(got - want).max())
    assert err <= RTOL * scale, f"{what}: max|diff| {err} > {RTOL} * {scale}"


@pytest.fixture(autouse=True)
def numpy_init(monkeypatch):
    """The JAX package's weight initializer replaced, for these tests only,
    by scaled normals from numpy: its threefry draw compiles once per
    weight shape, and the parity tests copy the JAX net's initial
    parameters into the port whatever they are."""
    from deeplearning4j_tpu.nn import layers as jlayers
    rs = np.random.RandomState(0)

    def init(key, shape, scheme, dtype=jnp.float32, dist_params=None):
        return jnp.asarray(rs.randn(*shape) / np.sqrt(float(shape[0])), dtype)

    for mod in (jlayers, jrec, jatt):
        monkeypatch.setattr(mod, "init_weights", init)


def _masks():
    tail = np.ones((B, T))
    tail[1, 5:] = 0
    gap = np.ones((B, T), np.int32)
    gap[0, 2:4] = 0
    gap[2, 6] = 0
    dead = np.ones((B, T))
    dead[1] = 0                        # every key of row 1 masked
    return {"none": None, "float": tail, "int": gap, "bool": gap.astype(bool),
            "all_masked_row": dead}


MASKS = _masks()


@pytest.mark.parametrize("scaled", [True, False])
@pytest.mark.parametrize("mask", list(MASKS))
def test_dot_product_attention_matches_jax(mask, scaled):
    rng = np.random.RandomState(1)
    q, k, v = (rng.standard_normal((B, 2, n, 4)) for n in (5, T, T))
    m = MASKS[mask]
    jm = None if m is None else jnp.asarray(m)[:, None, None, :]
    want = jax.jit(lambda q, k, v, m: jatt.dot_product_attention(q, k, v, m, scaled=scaled))(
        q, k, v, jm)
    tm = None if m is None else torch.tensor(m)[:, None, None, :]
    got = tatt.dot_product_attention(*(torch.tensor(a) for a in (q, k, v)), tm, scaled=scaled)
    _close(got, want, "dot_product_attention")
    if mask == "all_masked_row":      # uniform weights over the keys
        _close(got[1], np.broadcast_to(v[1].mean(1, keepdims=True), got[1].shape), "uniform")


LAYERS = {
    "SelfAttentionLayer": lambda m: m.SelfAttentionLayer(n_out=6, n_heads=2),
    "SelfAttentionLayer-head_size": lambda m: m.SelfAttentionLayer(n_heads=2, head_size=3),
    "SelfAttentionLayer-no_projection": lambda m: m.SelfAttentionLayer(project_input=False),
    "LearnedSelfAttentionLayer": lambda m: m.LearnedSelfAttentionLayer(n_out=6, n_heads=2,
                                                                       n_queries=3),
    "RecurrentAttentionLayer": lambda m: m.RecurrentAttentionLayer(n_out=5, activation="tanh"),
}


def _params(jlayer):
    p = jax.eval_shape(lambda k: jlayer.initialize(k, jnn.InputType.recurrent(F, T),
                                                   jnp.float64)[0], jax.random.PRNGKey(0))
    rng = np.random.RandomState(2)
    return jax.tree_util.tree_map(lambda a: 0.5 * rng.standard_normal(a.shape), p)


@functools.lru_cache(maxsize=None)
def _jax_layer(kind):
    """(port layer, params, x, proj, {mask: (out, grads)}): one jitted JAX
    program for every mask."""
    jl, tl = LAYERS[kind](jatt), LAYERS[kind](tatt)
    p = _params(jl)
    rng = np.random.RandomState(3)
    x = rng.standard_normal((B, T, F))
    shape = jax.eval_shape(lambda p_: jl.apply(p_, {}, x)[0], p).shape
    proj = rng.standard_normal(shape)
    masks = [m for m in MASKS.values() if m is not None]

    def run(p_, x_, ms):
        res = []
        for m in [None] + list(ms):
            def out(q, xx):
                return jl.apply(q, {}, xx, mask=m)[0]
            res.append((out(p_, x_), jax.grad(lambda q, xx: jnp.sum(out(q, xx) * proj),
                                              argnums=(0, 1))(p_, x_)))
        return res

    res = jax.jit(run)(p, x, masks)
    return tl, p, x, proj, dict(zip(MASKS, res))


@pytest.mark.parametrize("mask", list(MASKS))
@pytest.mark.parametrize("kind", list(LAYERS))
def test_layer_forward_and_gradients_match_jax(kind, mask):
    tl, p, x, proj, want = _jax_layer(kind)
    tp = jax.tree_util.tree_map(lambda a: torch.tensor(a, requires_grad=True), p)
    tx = torch.tensor(x, requires_grad=True)
    m = MASKS[mask]
    got, _ = tl.apply(tp, {}, tx, mask=None if m is None else torch.tensor(m))
    out, (grads, gx) = want[mask]
    _close(got.detach(), out, f"{kind} forward")
    torch.sum(got * torch.tensor(proj)).backward()
    _close(tx.grad, gx, f"{kind} grad x")
    for k, g in grads.items():
        _close(tp[k].grad, g, f"{kind} grad {k}")


def test_self_attention_reaches_fused_attention_and_recurrent_attention_does_not(monkeypatch):
    calls = []
    real = ak.fused_attention

    def spy(q, k, v, mask=None, **kw):
        calls.append(None if mask is None else mask.dtype)
        return real(q, k, v, mask=mask, **kw)

    monkeypatch.setattr(ak, "fused_attention", spy)
    x = torch.randn(B, T, F, dtype=torch.float64)
    m = torch.tensor(MASKS["int"])
    for kind, want in (("SelfAttentionLayer", 1), ("LearnedSelfAttentionLayer", 1),
                       ("SelfAttentionLayer-no_projection", 0),
                       ("RecurrentAttentionLayer", 0)):
        tl = LAYERS[kind](tatt)
        p, _, _ = tl.initialize(torch.Generator().manual_seed(0),
                                tnn.InputType.recurrent(F, T), torch.float64, "cpu")
        del calls[:]
        tl.apply(p, {}, x, mask=m)
        assert len(calls) == want, kind
        assert all(dt == torch.float64 for dt in calls)      # cast to q's dtype


def _seq_conf(mod, updater, learned=False):
    rec, att = (jrec, jatt) if mod is jnn else (trec, tatt)
    layers = [rec.LSTM(n_out=8, activation="tanh"),
              att.LearnedSelfAttentionLayer(n_out=8, n_heads=2, n_queries=3) if learned
              else att.SelfAttentionLayer(n_out=8, n_heads=2),
              mod.GlobalPoolingLayer(pooling_type="AVG"),
              mod.OutputLayer(n_out=3, loss="mcxent", activation="softmax")]
    return (mod.NeuralNetConfiguration.builder().seed(6).dtype("float64").updater(updater)
            .list(layers).set_input_type(mod.InputType.recurrent(5, T)).build())


def _nets(learned):
    jnet = jnn.MultiLayerNetwork(_seq_conf(jnn, jupd.Sgd(0.1), learned)).init()
    tnet = tnn.MultiLayerNetwork(_seq_conf(tnn, tupd.Sgd(0.1), learned), device="cpu").init()
    assert tnet.conf.to_json() == jnet.conf.to_json()
    convert.params_from_jax(tnet, jax.tree_util.tree_map(np.asarray, jnet.params_))
    return jnet, tnet


def _same(jnet, tnet, what):
    jp = jax.tree_util.tree_map(np.asarray, jnet.params_)
    tp = convert.params_to_jax(tnet)
    for n in jp:
        for k in jp[n]:
            _close(tp[n][k], jp[n][k], f"{what} {n}.{k}")


def _seq_data(k=1):
    rng = np.random.RandomState(4)
    x = np.eye(5)[rng.randint(0, 5, (k, B, T))]
    y = np.eye(3)[rng.randint(0, 3, (k, B))]
    return x, y


@pytest.mark.parametrize("learned", [False, True])
def test_sequence_attention_net_trains_as_jax(learned):
    """fit with a float then an int features mask (the JAX net takes the
    same values as floats), then fit_steps over a block of 2 with the
    float mask: losses and parameters agree.  With
    LearnedSelfAttentionLayer the MLN drops the mask after it: the pooling
    averages all ``n_queries`` steps (with a stale [B, T] mask it would
    fail on the shapes)."""
    jnet, tnet = _nets(learned)
    xs, ys = _seq_data(3)
    fm = MASKS["float"]
    for i, m in enumerate((fm, MASKS["int"])):
        jnet.fit(xs[i], ys[i], features_mask=m.astype(np.float64))
        tnet.fit(xs[i], ys[i], features_mask=m)
        _close(tnet.score(), jnet.score(), f"step {i} loss")
    _same(jnet, tnet, "after fit")
    fms = np.broadcast_to(fm, (2,) + fm.shape)
    jl = np.asarray(jnet.fit_steps(xs[1:], ys[1:], features_masks=fms))
    tl = tnet.fit_steps(xs[1:], ys[1:], features_masks=fms).numpy()
    _close(tl, jl, "fit_steps losses")
    _same(jnet, tnet, "after fit_steps")


def test_kernel_route_sees_a_mask_of_q_dtype(monkeypatch):
    """Dispatch forced to the kernel route, the launchers replaced by their
    plain versions: a SelfAttentionLayer step with an int mask launches the
    forward once and the backward once, each with a mask of q's dtype, and
    gives the gradients of the plain path."""
    jnet, tnet = _nets(False)
    x, y = (a[0] for a in _seq_data())
    m = MASKS["int"]
    want = tnet.gradient_for(x, y, features_mask=m)
    seen = []

    def counted(name, fn):
        def wrapped(q, k, v, *rest):
            mask = rest[0] if name == "launch" else rest[3]
            seen.append((name, mask.dtype))
            return fn(q, k, v, *rest)
        return wrapped

    monkeypatch.setattr(dispatch, "resolve", lambda name, *a, **kw: "kernel")
    monkeypatch.setattr(ka, "launch", counted("launch", ak.flash_attention_plain))
    monkeypatch.setattr(ka, "launch_bwd", counted("launch_bwd", ak.flash_attention_bwd_plain))
    got = tnet.gradient_for(x, y, features_mask=m)
    assert seen == [("launch", torch.float64), ("launch_bwd", torch.float64)]
    for n in want:
        for k in want[n]:
            np.testing.assert_allclose(got[n][k].numpy(), want[n][k].numpy(),
                                       rtol=1e-9, atol=1e-12 * float(want[n][k].abs().max()))
