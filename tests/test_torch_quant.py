"""Quantized inference of the PyTorch port against the JAX package.

Same numpy inputs, made from seeds, through both packages:

- ``quantize_tensor``, ``range_hostility``, ``quantization_error`` and
  ``quantize_activation``: bitwise (the same numpy arithmetic, and
  divisions taken tensor by tensor in f32);
- ``q_matmul_plain`` against JAX's ``q_matmul`` (interpret mode) and
  ``q_matmul_reference``: f32 within 1e-5 of max|ref| (sums in another
  order); bf16 within 2 bf16 ulps of max|ref| of the reference (both round
  the product, the scaled product and the bias sum to bf16) and within 4
  ulps of the interpret-mode kernel (which rounds once, from f32);
- ``int8_matmul_plain``: bitwise against ``int8_matmul_reference``, and
  against the interpret-mode kernel too except with a bias in f32, where
  XLA:CPU contracts that kernel's epilogue into one FMA (two roundings of
  the largest product);
- ``calibrate``: minmax ranges exactly where the activation is the input,
  within 1e-5 relative behind layers (conv sums in another order), and the
  percentile observer within one histogram bin;
- ``quantize_model`` on a narrow conv+dense MLN (16x16x3, two convs, a
  pool, two Dense layers and an Output layer): every QTensor bitwise after
  ``convert.quant_params_to_jax``, the report equal, and the outputs of the
  weight-only and the static-activation configs within 1e-5 of max|ref|;
- ``register_quantized`` through a CPU ``ModelServer``;
- the ``samediff`` kind, on a graph imported from ONNX bytes by both
  packages (Gemm, Relu, a range-hostile Gemm for the bf16 fallback): the
  same report, every QTensor bitwise, the output within 1e-5 relative,
  ``parity_check`` within 0.01 in both, a JAX-quantized tree loaded by
  ``convert.quant_params_from_jax``; ``quantized_projection`` and
  ``quantized_mha`` against the JAX functions (f32, within 1e-5 of
  max|ref|); the quantized graph served by a CPU ``ModelServer``, and a
  raw ``deploy(onnx=)`` registering with source "onnx" and failing its
  first request with ``UnservableGraphError`` (the JAX package's raw graph
  fails there too, with an AttributeError).

The CUDA kernels are held to their plain versions by the ``cuda``-marked
test, which skips without a card.
"""
import torch_test_threads  # noqa: F401  (first: one torch thread a worker)
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu import nn as jnn
from deeplearning4j_tpu import quant as jquant
from deeplearning4j_tpu.ops import quant_kernels as jqk
from deeplearning4j_tpu.ops.pallas import matmul as pm
from deeplearning4j_tpu.ops.pallas.tiles import TileConfig as JaxTileConfig
from deeplearning4j_tpu_torch import convert
from deeplearning4j_tpu_torch import nn as tnn
from deeplearning4j_tpu_torch import quant as tquant
from deeplearning4j_tpu_torch.ops import quant_kernels as tqk
from deeplearning4j_tpu_torch.ops.kernels import dispatch, matmul
from deeplearning4j_tpu_torch.serving import ModelServer, UnservableGraphError

SMALL_MM = JaxTileConfig(block_m=8, block_n=128, block_k=128)


def _bf16_ulp(v):
    return 2.0 ** (math.floor(math.log2(v)) - 7)


@pytest.fixture(autouse=True)
def _auto_mode():
    prev = dispatch.set_dispatch_mode("auto")
    yield
    dispatch.set_dispatch_mode(prev)


def _qt_numpy(qt):
    return np.asarray(qt.q), np.asarray(qt.scale)


# ---------------------------------------------------------------------------
# primitives
# ---------------------------------------------------------------------------

QUANT_CASES = [((64, 48), -1), ((64, 48), 0), ((3, 3, 5, 7), -1),
               ((3, 3, 5, 7), 2), ((16, 33), 1), ((40,), 0)]


@pytest.mark.parametrize("shape,axis", QUANT_CASES)
def test_quantize_tensor_is_bitwise_jax(shape, axis):
    w = np.random.RandomState(1).randn(*shape).astype(np.float32) * 3.0
    if len(shape) > 1:
        w[(slice(None),) * (axis % len(shape)) + (0,)] = 0.0   # a zero channel
    got = tqk.quantize_tensor(torch.from_numpy(w), axis=axis)
    want = jqk.quantize_tensor(w, axis=axis)
    q, s = _qt_numpy(want)
    assert got.axis == want.axis
    assert got.q.dtype == torch.int8 and got.scale.dtype == torch.float32
    np.testing.assert_array_equal(got.q.numpy(), q)
    np.testing.assert_array_equal(got.scale.numpy(), s)
    np.testing.assert_array_equal(tqk.dequantize(got).numpy(),
                                  np.asarray(jqk.dequantize(want)))


def test_quantize_tensor_float64_and_ties_are_bitwise_jax():
    # values on exact .5 steps: round half to even in both
    w = np.array([[0.5, 1.5, 2.5, -0.5, -2.5, 127.0]], np.float64)
    got = tqk.quantize_tensor(torch.from_numpy(w), axis=0)
    q, s = _qt_numpy(jqk.quantize_tensor(w, axis=0))
    np.testing.assert_array_equal(got.q.numpy(), q)
    np.testing.assert_array_equal(got.scale.numpy(), s)


@pytest.mark.parametrize("shape,axis", QUANT_CASES)
def test_range_hostility_and_quantization_error_are_bitwise_jax(shape, axis):
    w = np.random.RandomState(2).randn(*shape).astype(np.float32)
    w.flat[::7] *= 300.0                                   # spiky channels
    assert tqk.range_hostility(torch.from_numpy(w), axis) == \
        jqk.range_hostility(w, axis)
    assert tqk.quantization_error(torch.from_numpy(w), axis) == \
        jqk.quantization_error(w, axis)


@pytest.mark.parametrize("scale", [0.0123, 1.0 / 127.0, 0.5, 3.0])
def test_quantize_activation_is_bitwise_jax(scale):
    x = np.random.RandomState(3).randn(7, 130).astype(np.float32) * 2.0
    x[0, :8] = np.array([0.5, 1.5, -0.5, -1.5, 2.5, 300.0, -300.0, 0.0]) * scale
    got = tqk.quantize_activation(torch.from_numpy(x), scale)
    want = np.asarray(jqk.quantize_activation(jnp.asarray(x), scale))
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), want)


def _qmm_case(M, K=200, N=150, seed=4):
    rng = np.random.RandomState(seed)
    x = rng.randn(M, K).astype(np.float32)
    w = rng.randn(K, N).astype(np.float32) * 0.1
    b = rng.randn(N).astype(np.float32)
    qt = jqk.quantize_tensor(w)
    q, s = _qt_numpy(qt)
    return x, q, s, b


@pytest.mark.parametrize("M", [1, 5, 37])
@pytest.mark.parametrize("bias", [False, True])
def test_q_matmul_plain_matches_jax_f32(M, bias):
    x, q, s, b = _qmm_case(M)
    jb = jnp.asarray(b) if bias else None
    got = matmul.q_matmul_plain(torch.from_numpy(x), torch.from_numpy(q),
                                torch.from_numpy(s),
                                torch.from_numpy(b) if bias else None).numpy()
    for want in (pm.q_matmul(jnp.asarray(x), jnp.asarray(q), jnp.asarray(s),
                             bias=jb, tile=SMALL_MM, interpret=True),
                 pm.q_matmul_reference(jnp.asarray(x), jnp.asarray(q),
                                       jnp.asarray(s), bias=jb)):
        want = np.asarray(want)
        assert got.shape == want.shape == (M, 150)
        assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


@pytest.mark.parametrize("bias", [False, True])
def test_q_matmul_plain_matches_jax_bf16(bias):
    x, q, s, b = _qmm_case(33, seed=5)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    got = matmul.q_matmul_plain(xt, torch.from_numpy(q), torch.from_numpy(s),
                                torch.from_numpy(b) if bias else None)
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    jx = jnp.asarray(x).astype(jnp.bfloat16)
    jb = jnp.asarray(b) if bias else None
    for want, ulps in ((pm.q_matmul_reference(jx, jnp.asarray(q), jnp.asarray(s),
                                              bias=jb), 2),
                       (pm.q_matmul(jx, jnp.asarray(q), jnp.asarray(s), bias=jb,
                                    tile=SMALL_MM, interpret=True), 4)):
        want = np.asarray(want, np.float32)
        assert np.abs(got - want).max() <= ulps * _bf16_ulp(np.abs(want).max())


@pytest.mark.parametrize("x_scale", [None, 0.037])
@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
def test_int8_matmul_plain_is_bitwise_jax(x_scale, bias, out_dtype):
    rng = np.random.RandomState(6)
    xq = rng.randint(-127, 128, (19, 300)).astype(np.int8)
    wq = rng.randint(-127, 128, (300, 70)).astype(np.int8)
    ws = (rng.rand(70) * 0.01).astype(np.float32)
    b = rng.randn(70).astype(np.float32)
    got = matmul.int8_matmul_plain(
        torch.from_numpy(xq), torch.from_numpy(wq), torch.from_numpy(ws),
        x_scale=x_scale, bias=torch.from_numpy(b) if bias else None,
        out_dtype=getattr(torch, out_dtype))
    want = pm.int8_matmul_reference(
        jnp.asarray(xq), jnp.asarray(wq), jnp.asarray(ws), x_scale=x_scale,
        bias=jnp.asarray(b) if bias else None, out_dtype=getattr(jnp, out_dtype))
    kern = pm.int8_matmul(
        jnp.asarray(xq), jnp.asarray(wq), jnp.asarray(ws), x_scale=x_scale,
        bias=jnp.asarray(b) if bias else None, out_dtype=getattr(jnp, out_dtype),
        tile=SMALL_MM, interpret=True)
    got = got.float().numpy()
    np.testing.assert_array_equal(got, np.asarray(want, np.float32))
    kern = np.asarray(kern, np.float32)
    if bias and out_dtype == "float32":
        # XLA:CPU contracts the interpret-mode kernel's scale-and-bias into
        # one FMA, where the reference (and the port) round the product
        # first: within two roundings of the largest product
        top = np.float32(np.abs(kern).max() + np.abs(b).max())
        assert np.abs(got - kern).max() <= 2 * np.spacing(top)
    else:
        np.testing.assert_array_equal(got, kern)


def test_quantized_entry_points_match_jax_on_cpu():
    x, q, s, b = _qmm_case(9, seed=8)
    w = np.random.RandomState(8).randn(200, 150).astype(np.float32) * 0.1
    jqt, tqt = jqk.quantize_tensor(w), tqk.quantize_tensor(torch.from_numpy(w))
    xt, bt = torch.from_numpy(x), torch.from_numpy(b)
    for got, want in (
            (tqk.quantized_matmul(xt, tqt), jqk.quantized_matmul(jnp.asarray(x), jqt)),
            (tqk.quantized_dense(xt, tqt, bt),
             jqk.quantized_dense(jnp.asarray(x), jqt, jnp.asarray(b)))):
        want = np.asarray(want)
        assert np.abs(got.numpy() - want).max() <= 1e-5 * np.abs(want).max()
    got = tqk.quantized_matmul_static(xt, tqt, 0.021)
    want = jqk.quantized_matmul_static(jnp.asarray(x), jqt, 0.021)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_cpu_quantized_products_count_no_launch():
    x, q, s, b = (torch.from_numpy(a) for a in _qmm_case(4))
    before = (matmul.Q_LAUNCHES.value, matmul.INT8_LAUNCHES.value)
    tqk.quantized_dense(x, tqk.QTensor(q, s.reshape(1, -1), axis=1), b)
    tqk.quantized_matmul_static(x, tqk.QTensor(q, s.reshape(1, -1), axis=1), 0.02)
    assert (matmul.Q_LAUNCHES.value, matmul.INT8_LAUNCHES.value) == before


def test_cuda_inputs_the_kernels_refuse_raise(monkeypatch):
    """A CUDA call the kernel does not take raises in dispatch: it never
    drops to the plain version.  The device lookup is patched so the rule
    is checked without a card."""
    x, q, s, b = (torch.from_numpy(a) for a in _qmm_case(4))
    monkeypatch.setattr(dispatch, "_devices",
                        lambda args, kwargs: {torch.device("cuda", 0)})
    bad = tqk.QTensor(q.float(), s.reshape(1, -1), axis=1)     # not int8
    with pytest.raises(ValueError, match="does not take these inputs"):
        tqk.quantized_dense(x, bad, b)
    with pytest.raises(ValueError, match="does not take these inputs"):
        tqk.quantized_dense(x.double(), tqk.QTensor(q, s.reshape(1, -1), axis=1), b)
    with pytest.raises(ValueError, match="does not take these inputs"):
        tqk.quantized_matmul_static(x, bad, 0.02)
    big = torch.zeros(2, matmul.INT8_MAX_K + 1, dtype=torch.int8)
    assert not matmul.int8_supports(big, torch.zeros(matmul.INT8_MAX_K + 1, 3,
                                                     dtype=torch.int8), torch.ones(3))


def test_axis_must_be_the_output_channel():
    x, q, s, _ = (torch.from_numpy(a) for a in _qmm_case(4))
    with pytest.raises(ValueError, match="per-output-channel"):
        tqk.quantized_matmul(x, tqk.QTensor(q, s.reshape(1, -1), axis=0))


# ---------------------------------------------------------------------------
# calibration
# ---------------------------------------------------------------------------

def test_observers_and_stats_equal_jax_on_the_same_arrays():
    rs = np.random.RandomState(9)
    data = [np.concatenate([rs.uniform(-1, 1, 5000), [40.0]]),
            rs.standard_normal(3000) * 0.7]
    for tcls, jcls, kw in ((tquant.MinMaxObserver, jquant.MinMaxObserver, {}),
                           (tquant.PercentileObserver, jquant.PercentileObserver,
                            dict(percentile=99.5, bins=512))):
        t, j = tcls(**kw), jcls(**kw)
        for phase in range(tcls.phases):
            for a in data:
                t.observe(a, phase=phase)
                j.observe(a, phase=phase)
        assert t.range() == j.range()
    ranges = {"l0:in": (-1.0, 1.0), "l1:in": (0.0, 2.5), "__output__": (0.1, 0.9)}
    ts, js = tquant.CalibrationStats(ranges, 2), jquant.CalibrationStats(ranges, 2)
    assert ts.crc32() == js.crc32()
    assert ts.scale("l1:in") == js.scale("l1:in")
    assert tquant.CalibrationStats.from_dict(ts.to_dict()).crc32() == ts.crc32()


def _conf(pkg):
    """The narrow conv+dense MLN in either package: 16x16x3, two convs, a
    max pool, two Dense layers and a softmax Output layer."""
    return (pkg.NeuralNetConfiguration.builder().seed(3)
            .list([pkg.ConvolutionLayer(n_out=8, kernel_size=3, stride=1,
                                        convolution_mode="Same", activation="relu"),
                   pkg.ConvolutionLayer(n_out=12, kernel_size=3, stride=1,
                                        convolution_mode="Same", activation="relu"),
                   pkg.SubsamplingLayer(pooling_type="MAX", kernel_size=2, stride=2),
                   pkg.DenseLayer(n_out=48, activation="relu"),
                   pkg.DenseLayer(n_out=32, activation="tanh"),
                   pkg.OutputLayer(n_out=10, loss="mcxent", activation="softmax")])
            .set_input_type(pkg.InputType.convolutional(16, 16, 3)).build())


@pytest.fixture(scope="module")
def nets():
    jnet = jnn.MultiLayerNetwork(_conf(jnn)).init()
    tnet = tnn.MultiLayerNetwork(_conf(tnn), device="cpu").init()
    convert.params_from_jax(tnet, jax.tree_util.tree_map(np.asarray, jnet.params_))
    x = np.random.RandomState(10).randn(24, 16, 16, 3).astype(np.float32)
    return jnet, tnet, x


def test_calibrate_matches_jax(nets):
    jnet, tnet, x = nets
    batches = [x[:12], x[12:]]
    for observer in ("minmax", "percentile"):
        ts = tquant.calibrate(tnet, batches, observer=observer, bins=256)
        js = jquant.calibrate(jnet, batches, observer=observer, bins=256)
        assert set(ts.ranges) == set(js.ranges) and ts.batches == js.batches == 2
        for name, (jlo, jhi) in js.ranges.items():
            lo, hi = ts.ranges[name]
            if observer == "minmax":
                if name == "layer_0:in":
                    assert (lo, hi) == (jlo, jhi)
                tol = 1e-5 * max(abs(jlo), abs(jhi), 1e-30)
            else:   # one bin of the histogram grid (the minmax range / bins)
                tol = (jhi - jlo) / 256 * 1.0001 + 1e-12
            assert abs(lo - jlo) <= tol and abs(hi - jhi) <= tol, name


@pytest.fixture(scope="module")
def quantized(nets):
    jnet, tnet, x = nets
    cal = [x[:12], x[12:]]
    js = jquant.calibrate(jnet, cal, observer="minmax")
    ts = tquant.CalibrationStats(js.ranges, js.batches, js.observer)
    out = {}
    for static in (False, True):
        jq = jquant.quantize_model(
            jnet, calibration=js, config=jquant.QuantConfig(quantize_activations=static))
        tq = tquant.quantize_model(
            tnet, calibration=ts, config=tquant.QuantConfig(quantize_activations=static))
        out[static] = (jq, tq)
    return out, x


def test_quantize_model_qtensors_and_report_equal_jax(quantized):
    out, _ = quantized
    jq, tq = out[False]
    assert tq.kind == "mln" and tq.report == jq.report
    assert tq.dominant_dtype() == jq.dominant_dtype() == "int8"
    # the first conv's W (216 values) is under min_size and stays f32
    assert sum(v == "int8" for v in tq.report.values()) == 4
    assert tq.report["['layer_0']['W']"] == "float32"
    tree = convert.quant_params_to_jax(tq)
    for name, sub in jq.params_.items():
        for k, leaf in sub.items():
            got = tree[name][k]
            if isinstance(leaf, jqk.QTensor):
                assert got["axis"] == leaf.axis
                np.testing.assert_array_equal(got["q"], np.asarray(leaf.q))
                np.testing.assert_array_equal(got["scale"], np.asarray(leaf.scale))
            else:
                np.testing.assert_array_equal(got, np.asarray(leaf))
    # the conv W's QTensor lies in the port's OIHW layout, channels on axis 0
    w1 = tq.params_["layer_1"]["W"]
    assert w1.shape == (12, 8, 3, 3) and w1.axis == 0 and w1.scale.shape == (12, 1, 1, 1)
    assert tq.bytes_resident() < sum(p.numel() * 4 for p in tq.base.parameters()) / 3
    assert tq.quant_fingerprint()["report"] == jq.quant_fingerprint()["report"]


@pytest.mark.parametrize("static", [False, True])
def test_quantized_outputs_match_jax(quantized, static):
    out, x = quantized
    jq, tq = out[static]
    want = np.asarray(jq.output(x))
    got = tq.output(x)
    assert got.device.type == "cpu" and got.shape == (24, 10)
    assert np.abs(got.numpy() - want).max() <= 1e-5 * np.abs(want).max()


def test_quant_params_cross_from_jax(quantized):
    out, x = quantized
    jq, _ = out[False]
    tnet = tnn.MultiLayerNetwork(_conf(tnn), device="cpu").init()   # other weights
    tq = tquant.quantize_model(tnet)
    tree = {n: {k: ({"q": np.asarray(v.q), "scale": np.asarray(v.scale), "axis": v.axis}
                    if isinstance(v, jqk.QTensor) else np.asarray(v))
                for k, v in sub.items()} for n, sub in jq.params_.items()}
    convert.quant_params_from_jax(tq, tree)
    want = np.asarray(jq.output(x))
    assert np.abs(tq.output(x).numpy() - want).max() <= 1e-5 * np.abs(want).max()


def test_bf16_fallback_for_a_range_hostile_layer(nets):
    _, tnet, _ = nets
    tq = tquant.quantize_model(tnet, config=tquant.QuantConfig(hostility_threshold=1.0))
    assert set(tq.report.values()) == {"bfloat16", "float32"}
    assert tq.dominant_dtype() == "bfloat16"
    assert tq.params_["layer_3"]["W"].dtype == torch.bfloat16


def test_graph_kind_and_unknown_models():
    conf = (tnn.GraphBuilder().seed(0).add_inputs("in")
            .add_layer("d1", tnn.DenseLayer(n_out=48, activation="relu"), "in")
            .add_layer("out", tnn.OutputLayer(n_out=5, loss="mcxent",
                                              activation="softmax"), "d1")
            .set_outputs("out").set_input_types(tnn.InputType.feed_forward(16)).build())
    cg = tnn.ComputationGraph(conf, device="cpu").init()
    x = np.random.RandomState(11).randn(8, 16).astype(np.float32)
    qm = tquant.quantize_model(cg)
    assert qm.kind == "graph"
    assert tquant.parity_check(cg, qm, x)["delta"] <= 0.01

    class SameDiffLike:
        _nodes = {}
        variables_ = {}
        device = torch.device("cpu")
    qs = tquant.quantize_model(SameDiffLike())
    assert qs.kind == "samediff"
    with pytest.raises(ValueError, match="one placeholder"):
        qs.output(np.zeros((1, 2), np.float32))
    with pytest.raises(TypeError, match="MultiLayerNetwork, ComputationGraph or SameDiff"):
        tquant.quantize_model(object())
    with pytest.raises(ValueError, match="already quantized"):
        tquant.quantize_model(qm)


def test_register_quantized_rolls_through_a_cpu_server(nets):
    _, tnet, x = nets
    srv = ModelServer(max_batch=8, device="cpu")
    try:
        srv.deploy("m", tnet, warmup=True)
        cal = tquant.calibrate(tnet, [x[:8], x[8:16]])
        e2 = srv.registry.register_quantized("m", calibration=cal)
        e3 = srv.registry.register_quantized(
            "m", calibration=cal, base_version=1,
            config=tquant.QuantConfig(quantize_activations=True))
        assert (e2.version, e3.version) == (2, 3)
        assert e2.source == e3.source == "quant"
        assert e2.input_shape == e3.input_shape == (16, 16, 3)
        assert srv.registry.get("m").version == 3
        assert srv.registry.get("m", 1).model is tnet
        for e in (e2, e3):
            assert srv.registry.warmup("m", srv.cache, version=e.version) == [1, 2, 4, 8]
            got = [srv.output("m", x[i:i + n], version=e.version, timeout=60)
                   for i, n in ((0, 3), (3, 8), (11, 1))]
            want = e.model.output(x[:12]).numpy()
            np.testing.assert_allclose(np.concatenate(got), want, rtol=1e-5, atol=1e-6)
            assert tquant.parity_check(tnet, e.model, x)["delta"] <= 0.25
        assert srv.stats()["failed"] == 0
    finally:
        srv.shutdown()


# ---------------------------------------------------------------------------
# the samediff kind: a graph imported from ONNX
# ---------------------------------------------------------------------------

def _onnx_mlp(seed=3):
    from deeplearning4j_tpu.modelimport.onnx_proto import attr_i
    from tests.test_onnx_import import _N, _model, _vi
    r = np.random.RandomState(seed)
    w2 = r.randn(160, 8).astype(np.float32) * 0.1
    w2[:, 3] = 0.01
    w2[0, 3] = 50.0                   # one spiky channel: range-hostile, bf16
    inits = {"w1": r.randn(16, 160).astype(np.float32) * 0.3, "b1": np.zeros(160, np.float32),
             "w2": w2, "b2": r.randn(8).astype(np.float32),
             "w3": r.randn(8, 40).astype(np.float32), "w0": r.randn(16, 4).astype(np.float32)}
    nodes = [_N("Gemm", ["x", "w1", "b1"], ["h"]), _N("Relu", ["h"], ["a"]),
             _N("Gemm", ["a", "w2", "b2"], ["z"], attr_i("transB", 0)),
             _N("MatMul", ["z", "w3"], ["y"])]
    return _model(nodes, [_vi("x", (None, 16))], [_vi("y", ())], inits).serialize()


@pytest.fixture(scope="module")
def sd_quantized():
    from deeplearning4j_tpu.modelimport.onnx_import import import_onnx_model as jimport
    from deeplearning4j_tpu_torch.modelimport import import_onnx_model
    b = _onnx_mlp()
    jsd, tsd = jimport(b), import_onnx_model(b, device="cpu")
    x = np.random.RandomState(4).randn(12, 16).astype(np.float32)
    return b, jsd, tsd, jquant.quantize_model(jsd), tquant.quantize_model(tsd), x


def test_samediff_kind_report_and_qtensors_equal_jax(sd_quantized):
    _, _, tsd, jq, tq, _ = sd_quantized
    assert tq.kind == jq.kind == "samediff"
    assert tq.report == jq.report
    assert set(tq.report.values()) == {"int8", "bfloat16", "float32"}
    tree = convert.quant_params_to_jax(tq)
    assert set(tree) == set(jq.params_)
    for name, leaf in jq.params_.items():
        got = tree[name]
        if isinstance(leaf, jqk.QTensor):
            assert got["axis"] == leaf.axis
            np.testing.assert_array_equal(got["q"], np.asarray(leaf.q))
            np.testing.assert_array_equal(got["scale"], np.asarray(leaf.scale))
        else:
            np.testing.assert_array_equal(got, np.asarray(leaf).astype(got.dtype))
    assert tq.bytes_resident() < sum(v.numel() * 4 for v in tsd.variables_.values())
    assert tq.quant_fingerprint()["report"] == jq.quant_fingerprint()["report"]


def test_samediff_output_and_parity_match_jax(sd_quantized):
    _, jsd, tsd, jq, tq, x = sd_quantized
    want = np.asarray(jq.output(x))
    got = tq.output(x)
    assert got.device.type == "cpu" and got.shape == (12, 40)
    assert np.abs(got.numpy() - want).max() <= 1e-5 * np.abs(want).max()
    tp, jp = tquant.parity_check(tsd, tq, x), jquant.parity_check(jsd, jq, x)
    assert (tp["task"], tp["delta"], tp["n"]) == (jp["task"], jp["delta"], jp["n"])


def test_samediff_parity_within_one_percent_as_the_jax_test():
    """The JAX package's test_onnx_import_parity_within_one_percent (Gemm,
    Relu, Gemm) through the port: the relative L2 error and the parity
    delta (top-1 disagreement) within 0.01."""
    from deeplearning4j_tpu_torch.modelimport import import_onnx_model
    from tests.test_onnx_import import _N, _model, _vi
    r = np.random.RandomState(3)
    w1, w2 = r.randn(16, 32).astype(np.float32) * 0.3, r.randn(32, 8).astype(np.float32) * 0.3
    x = r.randn(12, 16).astype(np.float32)
    nodes = [_N("Gemm", ["x", "w1", "b1"], ["h"]), _N("Relu", ["h"], ["a"]),
             _N("Gemm", ["a", "w2", "b2"], ["y"])]
    b = _model(nodes, [_vi("x", x.shape)], [_vi("y", ())],
               {"w1": w1, "b1": np.zeros(32, np.float32), "w2": w2,
                "b2": np.zeros(8, np.float32)}).serialize()
    sd = import_onnx_model(b, device="cpu")
    qm = tquant.quantize_model(sd)
    ref = sd.output({"x": x}, "y")["y"].numpy()
    rel = np.linalg.norm(qm.output(x).numpy() - ref) / np.linalg.norm(ref)
    assert qm.kind == "samediff" and rel <= 0.01
    assert tquant.parity_check(sd, qm, x)["delta"] <= 0.01


def test_samediff_quant_params_cross_from_jax(sd_quantized):
    from deeplearning4j_tpu_torch.modelimport import import_onnx_model
    _, _, _, jq, _, x = sd_quantized
    tq = tquant.quantize_model(import_onnx_model(_onnx_mlp(seed=9), device="cpu"))
    tree = {n: ({"q": np.asarray(v.q), "scale": np.asarray(v.scale), "axis": v.axis}
                if isinstance(v, jqk.QTensor) else np.asarray(v).astype(np.float32))
            for n, v in jq.params_.items()}
    convert.quant_params_from_jax(tq, tree)
    want = np.asarray(jq.output(x))
    assert np.abs(tq.output(x).numpy() - want).max() <= 1e-5 * np.abs(want).max()


def test_quantized_mha_and_projection_match_jax():
    from deeplearning4j_tpu.ops import attention_kernels as jak
    from deeplearning4j_tpu_torch.ops import attention_kernels as tak
    r = np.random.RandomState(6)
    B, T, F, NH = 2, 10, 32, 4
    x = r.randn(B, T, F).astype(np.float32)
    w_qkv, w_out = r.randn(F, 3 * F).astype(np.float32) * 0.2, r.randn(F, F).astype(np.float32)
    b_qkv, b_out = r.randn(3 * F).astype(np.float32), r.randn(F).astype(np.float32)
    mask = (np.arange(T)[None] < np.array([[T], [T - 3]])).astype(np.float32)
    jq = [jqk.quantize_tensor(w) for w in (w_qkv, w_out)]
    tq = [tqk.quantize_tensor(torch.from_numpy(w)) for w in (w_qkv, w_out)]
    got = tak.quantized_projection(torch.from_numpy(x), tq[0], b=torch.from_numpy(b_qkv))
    want = np.asarray(jak.quantized_projection(jnp.asarray(x), jq[0], b=jnp.asarray(b_qkv)))
    assert np.abs(got.numpy() - want).max() <= 1e-5 * np.abs(want).max()
    for kw in (dict(), dict(causal=True), dict(mask=mask)):
        tkw = {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v for k, v in kw.items()}
        got = tak.quantized_mha(torch.from_numpy(x), tq[0], tq[1], NH,
                                b_qkv=torch.from_numpy(b_qkv), b_out=torch.from_numpy(b_out),
                                **tkw)
        want = np.asarray(jak.quantized_mha(jnp.asarray(x), jq[0], jq[1], NH,
                                            b_qkv=jnp.asarray(b_qkv),
                                            b_out=jnp.asarray(b_out), **kw))
        assert got.shape == (B, T, F)
        assert np.abs(got.numpy() - want).max() <= 1e-5 * np.abs(want).max(), kw


def test_samediff_serves_and_a_raw_import_fails_its_first_request(sd_quantized):
    b, _, _, _, tq, x = sd_quantized
    srv = ModelServer(max_batch=8, device="cpu")
    try:
        e = srv.deploy("q", model=tq, input_shape=(16,), warmup=True)
        assert e.warmed_buckets == [1, 2, 4, 8]
        got = np.concatenate([srv.output("q", x[i:i + n], timeout=60)
                              for i, n in ((0, 3), (3, 8), (11, 1))])
        np.testing.assert_allclose(got, tq.output(x).numpy(), rtol=1e-5, atol=1e-6)
        raw = srv.deploy("raw", onnx=b)
        assert raw.source == "onnx" and not raw.model.variables_
        assert raw.model.device == srv.device
        with pytest.raises(UnservableGraphError, match="quantize_model"):
            srv.output("raw", x[:2], timeout=60)
        with pytest.raises(UnservableGraphError, match="quantize_model"):
            srv.registry.warmup("raw", srv.cache, input_shape=(16,))
        # the registry's quantized roll serves; the frozen import holds its
        # weights as constants, so, as in the JAX package, none is quantized
        from deeplearning4j_tpu.modelimport.onnx_import import import_onnx_model as jimport
        rolled = srv.registry.register_quantized("raw")
        assert (rolled.source, rolled.version) == ("quant", 2)
        jrolled = jquant.quantize_model(jimport(b, trainable=False))
        assert rolled.model.report == jrolled.report == {}
        np.testing.assert_allclose(srv.output("raw", x[:2], timeout=60),
                                   np.asarray(jrolled.output(x[:2])), rtol=1e-5, atol=1e-6)
        with pytest.raises(NotImplementedError, match="h5py"):
            srv.deploy("k", keras="model.h5")
        with pytest.raises(ValueError, match="exactly one of"):
            srv.deploy("two", model=tq, onnx=b)
    finally:
        srv.shutdown()


@pytest.mark.cuda
def test_quantized_kernels_match_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    shapes = ([(M, 4096, 4096) for M in (1, 2, 4, 8, 16)]
              + [(37, 70, 45), (1, 70, 45), (16, 800, 500)])
    for M, K, N in shapes:
        w = torch.randn(K, N, generator=gen, device="cuda")
        qt = tqk.quantize_tensor(w)
        x = torch.randn(M, K, generator=gen, device="cuda")
        b = torch.randn(N, generator=gen, device="cuda")
        before = matmul.Q_LAUNCHES.value
        y = matmul.q_matmul(x, qt.q, qt.scale, bias=b)
        torch.cuda.synchronize()
        assert matmul.Q_LAUNCHES.value == before + 1
        r = matmul.q_matmul_plain(x, qt.q, qt.scale, bias=b)
        assert (y - r).abs().max().item() <= 1e-4 * r.abs().max().item()
        # split-K sums in a fixed order: the same call gives the same bits
        assert torch.equal(matmul.q_matmul(x, qt.q, qt.scale, bias=b), y)
        xb = x.bfloat16()
        y = matmul.q_matmul(xb, qt.q, qt.scale, bias=b)
        r = matmul.q_matmul_plain(xb, qt.q, qt.scale, bias=b).float()
        ref = r.abs().max().item()
        assert (y.float() - r).abs().max().item() <= 3 * 2.0 ** (math.floor(math.log2(ref)) - 7)
        assert torch.equal(matmul.q_matmul(xb, qt.q, qt.scale, bias=b), y)
        xq = tqk.quantize_activation(x, 0.02)
        before = matmul.INT8_LAUNCHES.value
        y = matmul.int8_matmul(xq, qt.q, qt.scale, x_scale=0.02, bias=b)
        torch.cuda.synchronize()
        assert matmul.INT8_LAUNCHES.value == before + 1
        assert torch.equal(y, matmul.int8_matmul_plain(xq, qt.q, qt.scale, x_scale=0.02, bias=b))
        # int32 split-K partials: exact, and the same bits call after call
        assert torch.equal(matmul.int8_matmul(xq, qt.q, qt.scale, x_scale=0.02, bias=b), y)
        yb = matmul.int8_matmul(xq, qt.q, qt.scale, x_scale=0.02, bias=b, out_dtype=torch.bfloat16)
        assert torch.equal(yb, matmul.int8_matmul_plain(xq, qt.q, qt.scale, x_scale=0.02, bias=b,
                                                        out_dtype=torch.bfloat16))
