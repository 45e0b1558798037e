"""fused_dense of the PyTorch port against the JAX package.

The port's plain version (`fused_dense_reference`, what CPU tensors run)
is held against the JAX Pallas kernel run in interpret mode and against
the JAX reference, on the same numpy inputs made from a seed.  f32 at
rtol/atol 1e-5; bf16 at 2 bf16 ulps of max|ref| (the two frameworks round
the f32 result to bf16 once each, after sums taken in another order).
The dispatch rules are checked on CPU tensors; the CUDA kernel itself is
checked by the `cuda`-marked test, which skips without a card.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.ops.pallas import matmul as pm
from deeplearning4j_tpu.ops.pallas.tiles import TileConfig as JaxTileConfig
from deeplearning4j_tpu_torch.nn.layers import DenseLayer, OutputLayer
from deeplearning4j_tpu_torch.ops.kernels import dispatch, matmul, tiles

ACTS = ["identity", "linear", "relu", "tanh", "sigmoid", "gelu"]
SMALL_MM = JaxTileConfig(block_m=8, block_n=128, block_k=128)


def _case(M, K=70, N=45, seed=8):
    rng = np.random.RandomState(seed)
    x = rng.randn(M, K).astype(np.float32)
    w = (rng.randn(K, N) * 0.1).astype(np.float32)
    b = rng.randn(N).astype(np.float32)
    return x, w, b


def _bf16_ulp(v):
    return 2.0 ** (math.floor(math.log2(v)) - 7)


@pytest.fixture(autouse=True)
def _auto_mode():
    prev = dispatch.set_dispatch_mode("auto")
    yield
    dispatch.set_dispatch_mode(prev)


@pytest.mark.parametrize("M", [33, 37])
@pytest.mark.parametrize("act", ACTS)
def test_reference_matches_jax_kernel_and_reference_f32(act, M):
    x, w, b = _case(M)
    got = matmul.fused_dense_reference(torch.from_numpy(x), torch.from_numpy(w),
                                       torch.from_numpy(b), act).numpy()
    jx, jw, jb = jnp.asarray(x), jnp.asarray(w), jnp.asarray(b)
    kern = pm.fused_dense(jx, jw, bias=jb, activation=act, tile=SMALL_MM,
                          interpret=True)
    ref = pm.fused_dense_reference(jx, jw, bias=jb, activation=act)
    assert got.shape == (M, 45) and got.dtype == np.float32
    np.testing.assert_allclose(got, np.asarray(kern), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, np.asarray(ref), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("act", ACTS)
def test_reference_matches_jax_bf16_within_two_ulps(act):
    x, w, b = _case(33, seed=3)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    wt = torch.from_numpy(w).to(torch.bfloat16)
    got = matmul.fused_dense_reference(xt, wt, torch.from_numpy(b), act)
    assert got.dtype == torch.bfloat16
    jx = jnp.asarray(x).astype(jnp.bfloat16)
    jw = jnp.asarray(w).astype(jnp.bfloat16)
    want = [pm.fused_dense_reference(jx, jw, bias=jnp.asarray(b), activation=act),
            pm.fused_dense(jx, jw, bias=jnp.asarray(b), activation=act,
                           tile=SMALL_MM, interpret=True)]
    for ref in want:
        ref = np.asarray(ref, np.float32)
        tol = 2 * _bf16_ulp(np.abs(ref).max())
        assert np.abs(got.float().numpy() - ref).max() <= tol


def test_cpu_tensors_take_the_plain_version_and_count_no_launch():
    x, w, b = (torch.from_numpy(a) for a in _case(5))
    before = matmul.LAUNCHES.value
    assert dispatch.resolve("fused_dense", x, w, bias=b,
                            activation="relu") == "reference"
    got = matmul.fused_dense(x, w, b, "relu")
    torch.testing.assert_close(got, matmul.fused_dense_reference(x, w, b, "relu"),
                               rtol=0, atol=0)
    assert matmul.LAUNCHES.value == before


def test_kernel_mode_refuses_cpu_tensors():
    x, w, b = (torch.from_numpy(a) for a in _case(5))
    dispatch.set_dispatch_mode("kernel")
    with pytest.raises(RuntimeError, match="CUDA tensors"):
        matmul.fused_dense(x, w, b, "relu")


def test_reference_mode_and_bad_modes():
    x, w, b = (torch.from_numpy(a) for a in _case(5))
    dispatch.set_dispatch_mode("reference")
    assert dispatch.resolve("fused_dense", x, w, bias=b) == "reference"
    with pytest.raises(ValueError):
        dispatch.set_dispatch_mode("pallas")
    dispatch._mode = "bogus"          # what a bad DL4J_TORCH_KERNEL_TIER gives
    with pytest.raises(ValueError, match="DL4J_TORCH_KERNEL_TIER"):
        matmul.fused_dense(x, w, b, "relu")


def test_dense_supports_predicate():
    x, w, b = (torch.from_numpy(a) for a in _case(5))
    assert matmul.dense_supports(x, w, bias=b, activation="gelu")
    assert matmul.dense_supports(x.bfloat16(), w.bfloat16(), bias=b)
    assert not matmul.dense_supports(x, w, bias=b, activation="softmax")
    assert not matmul.dense_supports(x.double(), w.double())
    assert not matmul.dense_supports(x, w.bfloat16())
    assert not matmul.dense_supports(x[0], w)


def test_dense_layer_routes_epilogue_activations_through_fused_dense(monkeypatch):
    import deeplearning4j_tpu_torch.nn.layers as layers
    calls = []

    def spy(x, w, bias=None, activation=None):
        calls.append(activation)
        return matmul.fused_dense(x, w, bias=bias, activation=activation)

    monkeypatch.setattr(layers, "fused_dense", spy)
    x, w, b = (torch.from_numpy(a) for a in _case(4))
    params = {"W": w, "b": b}
    y, _ = DenseLayer(n_out=45, activation="relu").apply(params, {}, x)
    torch.testing.assert_close(y, torch.relu(x @ w + b))
    y, _ = OutputLayer(n_out=45, activation="softmax").apply(params, {}, x)
    torch.testing.assert_close(y, torch.softmax(x @ w + b, dim=-1))
    assert calls == ["relu"]            # the softmax head stays plain


def test_tiles_match_jax_record_and_table():
    from deeplearning4j_tpu.ops.pallas.tiles import shape_class as jax_shape_class
    cfg = tiles.DEFAULT_TILES["fused_dense"]
    assert (cfg.block_m, cfg.block_n, cfg.block_k) == (64, 64, 16)
    assert cfg.to_json() == JaxTileConfig(block_m=64, block_n=64,
                                          block_k=16).to_json()
    assert tiles.TileConfig.from_json(cfg.to_json()) == cfg
    assert cfg.config_key() == JaxTileConfig(block_m=64, block_n=64,
                                             block_k=16).config_key()
    for dims in (dict(m=16, k=25088, n=4096), dict(m=37, k=70, n=45),
                 dict(n=1, m=1, k=1)):
        assert tiles.shape_class(**dims) == jax_shape_class(**dims)
    assert tiles.shape_class(m=16, k=25088, n=4096) == "k32768-m16-n4096"


@pytest.mark.parametrize("dtype", [torch.float16, torch.float64])
def test_cuda_inputs_the_kernel_refuses_raise(monkeypatch, dtype):
    """A CUDA call the kernel does not take raises in dispatch: it never
    drops to the plain version.  The device lookup is patched so the rule
    is checked without a card."""
    x, w, b = (torch.from_numpy(a) for a in _case(4))
    monkeypatch.setattr(dispatch, "_devices",
                        lambda args, kwargs: {torch.device("cuda", 0)})
    with pytest.raises(ValueError, match="does not take these inputs"):
        matmul.fused_dense(x.to(dtype), w.to(dtype), b, "relu")
    with pytest.raises(ValueError, match="does not take these inputs"):
        matmul.fused_dense(x, w.bfloat16(), b, "relu")


@pytest.mark.parametrize("dtype", [torch.float16, torch.float64])
def test_dense_layer_sends_every_dtype_to_the_wrapper(monkeypatch, dtype):
    import deeplearning4j_tpu_torch.nn.layers as layers
    calls = []

    def spy(x, w, bias=None, activation=None):
        calls.append((x.dtype, activation))
        return matmul.fused_dense(x, w, bias=bias, activation=activation)

    monkeypatch.setattr(layers, "fused_dense", spy)
    x, w, b = (torch.from_numpy(a).to(dtype) for a in _case(4))
    y, _ = DenseLayer(n_out=45, activation="tanh").apply({"W": w, "b": b}, {}, x)
    assert calls == [(dtype, "tanh")] and y.dtype == dtype
    want = torch.tanh(x.double() @ w.double() + b.double())
    tol = 1e-12 if dtype == torch.float64 else 2e-3
    assert (y.double() - want).abs().max().item() <= tol


@pytest.mark.cuda
def test_kernel_matches_reference_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    for M, K, N in [(1, 4096, 4096), (37, 70, 45), (16, 800, 500)]:
        w = torch.randn(K, N, generator=gen, device="cuda") / math.sqrt(K)
        x = torch.randn(M, K, generator=gen, device="cuda")
        b = torch.randn(N, generator=gen, device="cuda")
        for act in ACTS:
            before = matmul.LAUNCHES.value
            y = matmul.fused_dense(x, w, b, act)
            torch.cuda.synchronize()
            assert matmul.LAUNCHES.value == before + 1
            r = matmul.fused_dense_reference(x, w, b, act)
            assert (y - r).abs().max().item() <= 1e-4 * r.abs().max().item()
