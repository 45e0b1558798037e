"""ComputationGraph of the PyTorch port against the JAX package.

The configuration JSON is the same string in both packages; `params()`
keeps JAX's flat order; parameters and BN running statistics cross both
ways through `convert`; each vertex computes what the JAX vertex computes;
a Dense-relu layer's gradient inside a graph equals the VJP of JAX's
`fused_dense` (its Pallas kernel forced in interpret mode); and the
full-depth ResNet50 at 32x32 gives the JAX forward and `gradient_for`.
f32 tolerance: 1e-5 relative (max|diff| <= 1e-5 * max|ref| per tensor).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu import nn as jnn
from deeplearning4j_tpu.ops.pallas import dispatch as jdispatch
from deeplearning4j_tpu.zoo.graphs import ResNet50 as JResNet50
from deeplearning4j_tpu_torch import convert
from deeplearning4j_tpu_torch import nn as tnn
from deeplearning4j_tpu_torch.nn import graph as tgraph
from deeplearning4j_tpu_torch.ops.kernels import dispatch, matmul
from deeplearning4j_tpu_torch.zoo.graphs import ResNet50 as TResNet50


def _rel_close(got, want, rtol=1e-5):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= rtol * scale, f"max|diff| {err} > {rtol} * {scale}"


class _JSmall(JResNet50):
    STAGES = ((1, 8), (1, 16))


class _TSmall(TResNet50):
    STAGES = ((1, 8), (1, 16))


@pytest.fixture(scope="module")
def small():
    kw = dict(n_classes=10, input_shape=(32, 32, 3))
    jnet = _JSmall(**kw).init_model()
    tnet = _TSmall(**kw).init_model(device="cpu")
    convert.params_from_jax(tnet, jax.tree_util.tree_map(np.asarray, jnet.params_))
    return jnet, tnet


@pytest.mark.parametrize("kw", [dict(), dict(n_classes=10, input_shape=(32, 32, 3),
                                             seed=7, compute_dtype="bfloat16")])
def test_resnet50_config_json_equals_jax(kw):
    jd = JResNet50(**kw).conf().to_json()
    assert TResNet50(**kw).conf().to_json() == jd
    assert tnn.ComputationGraphConfiguration.from_json(jd).to_json() == jd
    assert _TSmall(**kw).conf().to_json() == _JSmall(**kw).conf().to_json()


def test_topological_order_and_its_errors_match_jax():
    conf = TResNet50().conf()
    assert conf.topological_order() == JResNet50().conf().topological_order()
    for Builder, mod in ((tnn.GraphBuilder, tnn), (jnn.GraphBuilder, jnn)):
        b = (Builder().add_inputs("in")
             .set_input_types(mod.InputType.feed_forward(3)))
        b.add_vertex("a", mod.ElementWiseVertex(op="Add"), "in", "b")
        b.add_vertex("b", mod.ElementWiseVertex(op="Add"), "in", "a")
        with pytest.raises(ValueError, match="cycle"):
            b.set_outputs("b").build().topological_order()
        with pytest.raises(ValueError, match="Duplicate vertex"):
            b.add_vertex("a", mod.MergeVertex(), "in")


VERTICES = [
    ("MergeVertex", dict(), 2),
    ("ElementWiseVertex", dict(op="Add"), 3),
    ("ElementWiseVertex", dict(op="Subtract"), 2),
    ("ElementWiseVertex", dict(op="Product"), 2),
    ("ElementWiseVertex", dict(op="Average"), 3),
    ("ElementWiseVertex", dict(op="Max"), 2),
    ("SubsetVertex", dict(range_from=1, range_to=3), 1),
    ("L2NormalizeVertex", dict(), 1),
    ("ScaleVertex", dict(scale=2.5), 1),
    ("ShiftVertex", dict(shift=-0.5), 1),
    ("StackVertex", dict(), 2),
    ("UnstackVertex", dict(from_index=1, stack_size=2), 1),
    ("ReshapeVertex", dict(shape=(2, 3)), 1),
]


@pytest.mark.parametrize("cls,kw,n_in", VERTICES)
def test_vertex_apply_and_json_match_jax(cls, kw, n_in):
    rs = np.random.RandomState(n_in)
    xs = [rs.randn(4, 6).astype(np.float32) for _ in range(n_in)]
    jv = getattr(jnn.graph, cls)(**kw)
    tv = getattr(tgraph, cls)(**kw)
    assert tv.to_json() == jv.to_json()
    types = [jnn.InputType.feed_forward(6)] * n_in
    assert tv.output_type([tnn.InputType.feed_forward(6)] * n_in).to_json() == \
        jv.output_type(types).to_json()
    want, _ = jv.apply({}, {}, [jnp.asarray(x) for x in xs])
    got, _ = tv.apply({}, {}, [torch.from_numpy(x) for x in xs])
    _rel_close(got.numpy(), want)


def test_flat_params_order_and_set_params_round_trip(small):
    jnet, tnet = small
    flat = tnet.params()
    np.testing.assert_array_equal(flat, np.asarray(jnet.params()))
    assert tnet.num_params() == jnet.num_params() == flat.size
    assert "vertices.s0b0_b_conv.W" in tnet.state_dict()
    assert tuple(tnet.state_dict()["vertices.s0b0_b_conv.W"].shape) == (8, 8, 3, 3)
    tnet.set_params(flat[::-1].copy())
    np.testing.assert_array_equal(tnet.params(), flat[::-1])
    tnet.set_params(flat)
    np.testing.assert_array_equal(tnet.params(), flat)
    with pytest.raises(ValueError, match="Param count mismatch"):
        tnet.set_params(np.concatenate([flat, [0.0]]))


def test_params_and_bn_state_cross_both_ways(small):
    """JAX -> port and port -> JAX: the same params and running statistics
    give the same eval-mode output in both packages."""
    jnet, tnet = small
    rs = np.random.RandomState(5)
    x = rs.randn(3, 32, 32, 3).astype(np.float32)
    jstate = {n: {k: (rs.rand(*np.shape(v)) + (0.5 if k == "var" else -0.5)).astype(np.float32)
                  for k, v in s.items()} for n, s in jnet.state_.items()}
    convert.state_from_jax(tnet, jstate)
    back = convert.state_to_jax(tnet)
    assert set(back) == set(jstate)
    for n in jstate:
        assert set(back[n]) == set(jstate[n])
        for k in jstate[n]:
            np.testing.assert_array_equal(back[n][k], jstate[n][k])
    jnet.state_ = jax.tree_util.tree_map(jnp.asarray, jstate)
    _rel_close(tnet.output(x)[0].numpy(), jnet.output(x)[0])
    # port -> JAX: moved statistics come back into a fresh JAX net
    with torch.no_grad():
        tnet.state_["stem_bn"]["mean"].add_(0.25)
        tnet.params_["stem_bn"]["gamma"].mul_(1.5)
    fresh = _JSmall(n_classes=10, input_shape=(32, 32, 3)).init_model()
    fresh.params_ = jax.tree_util.tree_map(jnp.asarray, convert.params_to_jax(tnet))
    fresh.state_ = jax.tree_util.tree_map(jnp.asarray, convert.state_to_jax(tnet))
    _rel_close(tnet.output(x)[0].numpy(), fresh.output(x)[0])
    with pytest.raises(ValueError, match="state keys differ"):
        convert.state_from_jax(tnet, dict(jstate, stem_bn={"mean": jstate["stem_bn"]["mean"]}))


def _dense_graph(mod, **build_kw):
    b = (mod.GraphBuilder().seed(3).add_inputs("in")
         .set_input_types(mod.InputType.feed_forward(12)))
    b.add_layer("hidden", mod.DenseLayer(n_out=20, activation="relu"), "in")
    b.add_layer("out", mod.OutputLayer(n_out=5, loss="mcxent",
                                       activation="softmax"), "hidden")
    return b.set_outputs("out").build()


def test_dense_relu_gradient_matches_jax_fused_dense_vjp():
    rs = np.random.RandomState(9)
    x = rs.randn(8, 12).astype(np.float32)
    y = np.eye(5, dtype=np.float32)[rs.randint(0, 5, 8)]
    jnet = jnn.ComputationGraph(_dense_graph(jnn)).init()
    tnet = tnn.ComputationGraph(_dense_graph(tnn), device="cpu").init()
    assert tnet.conf.to_json() == jnet.conf.to_json()
    convert.params_from_jax(tnet, jax.tree_util.tree_map(np.asarray, jnet.params_))
    prev = jdispatch.set_dispatch_mode("pallas")     # interpret mode on the CPU
    try:
        jg = jnet.gradient_for(x, y)
    finally:
        jdispatch.set_dispatch_mode(prev)
    tg = tnet.gradient_for(x, y)
    for k in ("W", "b"):
        _rel_close(tg["hidden"][k].numpy(), jg["hidden"][k])
        _rel_close(tg["out"][k].numpy(), jg["out"][k])


def test_fused_dense_kernel_path_backward_is_the_plain_vjp(monkeypatch):
    """On a card fused_dense runs FusedDense; its backward must be the
    plain version's VJP.  Here the kernel launch is stood in for by the
    plain forward, so the Function's backward runs on the CPU."""
    monkeypatch.setattr(dispatch, "resolve", lambda *a, **k: "kernel")
    launched = []

    def fake_launch(x, w, bias, activation):
        launched.append(activation)
        return matmul.fused_dense_reference(x, w, bias, activation)

    monkeypatch.setattr(matmul, "_launch", fake_launch)
    rs = np.random.RandomState(1)
    for act in ("relu", "gelu", "sigmoid"):
        for with_bias in (True, False):
            x = torch.from_numpy(rs.randn(5, 7)).requires_grad_()
            w = torch.from_numpy(rs.randn(7, 4)).requires_grad_()
            b = torch.from_numpy(rs.randn(4)).requires_grad_() if with_bias else None
            g = torch.from_numpy(rs.randn(5, 4))
            y = matmul.fused_dense(x, w, b, act)
            got = torch.autograd.grad(y, [t for t in (x, w, b) if t is not None], g)
            yr = matmul.fused_dense_reference(x, w, b, act)
            want = torch.autograd.grad(yr, [t for t in (x, w, b) if t is not None], g)
            for a, r in zip(got, want):
                torch.testing.assert_close(a, r, rtol=1e-12, atol=1e-12)
    assert len(launched) == 6
    # only the inputs that need it get a gradient
    x = torch.from_numpy(rs.randn(5, 7))
    w = torch.from_numpy(rs.randn(7, 4)).requires_grad_()
    (gw,) = torch.autograd.grad(matmul.fused_dense(x, w, None, "tanh").sum(), [w])
    assert gw.shape == (7, 4)


def test_graph_entry_points_refuse_to_run_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a machine without CUDA")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tnn.ComputationGraph(_dense_graph(tnn))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TResNet50().init_model()
    assert tnn.ComputationGraph(_dense_graph(tnn), device="cpu").device.type == "cpu"
    with pytest.raises(NotImplementedError, match="iterator"):
        tnn.ComputationGraph(_dense_graph(tnn), device="cpu").init().fit([])


def test_full_depth_resnet50_forward_and_gradients_match_jax():
    kw = dict(n_classes=10, input_shape=(32, 32, 3))
    jnet = JResNet50(**kw).init_model()
    tnet = TResNet50(**kw).init_model(device="cpu")
    assert tnet.num_params() == jnet.num_params()
    # with running statistics at (0, 1) the body amplifies its input ~100x;
    # a smaller head keeps the softmax out of saturation, where the
    # gradient would be a difference of nearly equal numbers
    jnet.params_["output"]["W"] = jnet.params_["output"]["W"] * 0.01
    convert.params_from_jax(tnet, jax.tree_util.tree_map(np.asarray, jnet.params_))
    rs = np.random.RandomState(0)
    x = rs.randn(2, 32, 32, 3).astype(np.float32)
    y = np.eye(10, dtype=np.float32)[[3, 7]]
    _rel_close(tnet.output(x)[0].numpy(), jnet.output(x)[0])
    jg = jnet.gradient_for(x, y)
    tg = tnet.gradient_for(x, y)
    assert sum(1 for n in tg if n.endswith("_b_conv")) == 16
    for name in jg:
        for k in jg[name]:
            got = convert.to_jax_layout(tnet.layer_by_name(name), k, tg[name][k])
            _rel_close(got, jg[name][k])


def test_dropout_drops_the_input_in_train_mode_only():
    """`dropout` is the retain probability: in train mode a fraction p of
    the input survives, scaled by 1/p; eval mode is the identity.  The mask
    comes from the generator passed as `rng` (the graph's, seeded from the
    configuration), so it matches the JAX package in distribution only."""
    x = torch.ones(200, 50)
    layer = tnn.DropoutLayer(dropout=0.8)
    assert layer.STOCHASTIC and tnn.DenseLayer.STOCHASTIC
    y, _ = layer.apply({}, {}, x, train=False, rng=torch.Generator().manual_seed(0))
    assert torch.equal(y, x)
    y, _ = layer.apply({}, {}, x, train=True, rng=torch.Generator().manual_seed(0))
    kept = y != 0
    assert abs(kept.float().mean().item() - 0.8) < 0.02
    torch.testing.assert_close(y[kept], torch.full_like(y[kept], 1 / 0.8))
    again, _ = layer.apply({}, {}, x, train=True, rng=torch.Generator().manual_seed(0))
    assert torch.equal(again, y)
    y, _ = layer.apply({}, {}, x, train=True, rng=None)
    assert torch.equal(y, x)
