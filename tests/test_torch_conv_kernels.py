"""The 3x3 conv backward pair of the PyTorch port against the JAX package.

The plain versions (`conv3x3_wgrad_reference`, `conv3x3_dgrad_reference`,
what CPU tensors run) are held against the JAX Pallas kernels run in
interpret mode and against the JAX autodiff (`_xla`) versions, on the same
numpy inputs made from a seed, at the shapes of tests/test_conv_kernels.py
(even rows, the odd 7x7 tail, 14x14): f32 to 1e-5 relative; bf16 inputs
with the JAX test's budget (rtol 3e-2, atol 0.12: bf16 input rounding,
f32 accumulation).  The port's dW is OIHW and the JAX one HWIO.  The
autograd Function `conv3x3_same` passes `gradcheck` in f64, and the
max-pool backward gives a window's gradient to its first maximum, as JAX's
default does, on ReLU-zero ties.  The CUDA kernels themselves are checked
by the `cuda`-marked test, which skips without a card.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.ops import conv_kernels as jck
from deeplearning4j_tpu.ops import pool_kernels as jpk
from deeplearning4j_tpu_torch.nn.layers import ConvolutionLayer
from deeplearning4j_tpu_torch.ops import conv_kernels as ck
from deeplearning4j_tpu_torch.ops import pool_kernels as tpk
from deeplearning4j_tpu_torch.ops.kernels import conv3x3, dispatch

SHAPES = [(2, 8, 8, 8, 16), (1, 7, 7, 16, 8), (2, 14, 14, 8, 8)]


def _arrays(B, H, W, Ci, Co, seed=0):
    rs = np.random.RandomState(seed)
    x = (rs.randn(B, H, W, Ci) * 0.5).astype(np.float32)
    dy = (rs.randn(B, H, W, Co) * 0.5).astype(np.float32)
    w_hwio = (rs.randn(3, 3, Ci, Co) * 0.5).astype(np.float32)
    return x, dy, w_hwio


def _oihw(w_hwio):
    return torch.from_numpy(np.ascontiguousarray(w_hwio.transpose(3, 2, 0, 1)))


def _close(got, want, rtol=1e-5):
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * float(np.abs(want).max()))


@pytest.fixture(autouse=True)
def _auto_mode():
    prev = dispatch.set_dispatch_mode("auto")
    yield
    dispatch.set_dispatch_mode(prev)


@pytest.mark.parametrize("B,H,W,Ci,Co", SHAPES)
def test_wgrad_reference_matches_jax_kernel_and_xla(B, H, W, Ci, Co):
    x, dy, _ = _arrays(B, H, W, Ci, Co)
    got = ck.conv3x3_wgrad(torch.from_numpy(x), torch.from_numpy(dy))
    assert got.shape == (Co, Ci, 3, 3) and got.dtype == torch.float32
    got = got.permute(2, 3, 1, 0).numpy()           # OIHW -> HWIO
    _close(got, np.asarray(jck.conv3x3_wgrad_tpu(jnp.asarray(x), jnp.asarray(dy),
                                                 interpret=True)))
    _close(got, np.asarray(jck.conv3x3_wgrad_xla(jnp.asarray(x), jnp.asarray(dy))))


@pytest.mark.parametrize("B,H,W,Ci,Co", SHAPES)
def test_dgrad_reference_matches_jax_kernel_and_xla(B, H, W, Ci, Co):
    _, dy, w = _arrays(B, H, W, Ci, Co)
    got = ck.conv3x3_dgrad(torch.from_numpy(dy), _oihw(w))
    assert got.shape == (B, H, W, Ci) and got.dtype == torch.float32
    got = got.numpy()
    _close(got, np.asarray(jck.conv3x3_dgrad_tpu(jnp.asarray(dy), jnp.asarray(w),
                                                 interpret=True)))
    _close(got, np.asarray(jck.conv3x3_dgrad_xla(jnp.asarray(dy), jnp.asarray(w))))


def test_bf16_inputs_accumulate_f32_within_the_jax_budget():
    x, dy, w = _arrays(2, 8, 8, 8, 8, seed=3)
    tb = [torch.from_numpy(a).to(torch.bfloat16) for a in (x, dy)]
    dw = ck.conv3x3_wgrad(tb[0], tb[1])
    dx = ck.conv3x3_dgrad(tb[1], _oihw(w * 0.6).to(torch.bfloat16))
    assert dw.dtype == dx.dtype == torch.float32
    jb = [jnp.asarray(a).astype(jnp.bfloat16) for a in (x, dy)]
    np.testing.assert_allclose(
        dw.permute(2, 3, 1, 0).numpy(),
        np.asarray(jck.conv3x3_wgrad_tpu(jb[0], jb[1], interpret=True)),
        rtol=3e-2, atol=0.12)
    np.testing.assert_allclose(
        dx.numpy(),
        np.asarray(jck.conv3x3_dgrad_tpu(jb[1], jnp.asarray(w * 0.6).astype(jnp.bfloat16),
                                         interpret=True)),
        rtol=3e-2, atol=0.12)


def test_shape_errors():
    with pytest.raises(ValueError, match="mismatches"):
        ck.conv3x3_wgrad(torch.zeros(1, 8, 8, 4), torch.zeros(1, 4, 8, 4))
    with pytest.raises(ValueError, match="Ci, 3, 3"):
        ck.conv3x3_dgrad(torch.zeros(1, 8, 8, 4), torch.zeros(4, 4, 5, 5))


def test_conv3x3_same_gradcheck_f64():
    rs = np.random.RandomState(1)
    x = torch.from_numpy(rs.randn(2, 5, 4, 3)).requires_grad_()
    w = torch.from_numpy(rs.randn(2, 3, 3, 3)).requires_grad_()
    assert torch.autograd.gradcheck(ck.conv3x3_same, (x, w))


def test_conv3x3_same_matches_jax_custom_vjp_with_kernels_in_interpret_mode(monkeypatch):
    x, dy, w = _arrays(2, 8, 8, 4, 8, seed=5)
    monkeypatch.setitem(jck.CONV_BWD_PALLAS, "wgrad", True)
    monkeypatch.setitem(jck.CONV_BWD_PALLAS, "dgrad", True)
    monkeypatch.setitem(jck.CONV_BWD_PALLAS, "interpret", True)
    jy, vjp = jax.vjp(jck.conv3x3_same, jnp.asarray(x), jnp.asarray(w))
    jdx, jdw = vjp(jnp.asarray(dy))
    tx = torch.from_numpy(x).requires_grad_()
    tw = _oihw(w).requires_grad_()
    ty = ck.conv3x3_same(tx, tw)
    ty.backward(torch.from_numpy(dy))
    _close(ty.detach().numpy(), np.asarray(jy))
    _close(tx.grad.numpy(), np.asarray(jdx))
    _close(tw.grad.permute(2, 3, 1, 0).numpy(), np.asarray(jdw))


def test_cpu_tensors_take_the_plain_versions_and_count_no_launch():
    x, dy, w = (torch.from_numpy(a) for a in _arrays(1, 7, 7, 16, 8))
    before = (conv3x3.WGRAD_LAUNCHES.value, conv3x3.DGRAD_LAUNCHES.value)
    assert dispatch.resolve("conv3x3_wgrad", x, dy) == "reference"
    assert dispatch.resolve("conv3x3_dgrad", dy, _oihw(w.numpy())) == "reference"
    torch.testing.assert_close(ck.conv3x3_wgrad(x, dy),
                               ck.conv3x3_wgrad_reference(x, dy), rtol=0, atol=0)
    assert (conv3x3.WGRAD_LAUNCHES.value, conv3x3.DGRAD_LAUNCHES.value) == before
    dispatch.set_dispatch_mode("kernel")
    with pytest.raises(RuntimeError, match="CUDA tensors"):
        ck.conv3x3_wgrad(x, dy)


@pytest.mark.parametrize("dtype", [torch.float16, torch.float64])
def test_cuda_inputs_the_kernels_refuse_raise(monkeypatch, dtype):
    """A CUDA call the kernels do not take raises: it never drops to the
    plain version.  The device lookup is patched, so no card is needed."""
    x, dy, w = _arrays(1, 7, 7, 4, 4)
    monkeypatch.setattr(dispatch, "_devices",
                        lambda args, kwargs: {torch.device("cuda", 0)})
    tx, tdy = torch.from_numpy(x).to(dtype), torch.from_numpy(dy).to(dtype)
    with pytest.raises(ValueError, match="does not take these inputs"):
        ck.conv3x3_wgrad(tx, tdy)
    with pytest.raises(ValueError, match="does not take these inputs"):
        ck.conv3x3_dgrad(tdy, _oihw(w).to(dtype))
    with pytest.raises(ValueError, match="does not take these inputs"):
        ck.conv3x3_wgrad(torch.from_numpy(x), torch.from_numpy(dy).bfloat16())


@pytest.mark.parametrize("B,H,W,C", [(64, 56, 56, 64), (64, 28, 28, 128),
                                     (64, 14, 14, 256), (64, 7, 7, 512),
                                     (3, 13, 13, 24), (1, 1, 1, 1)])
def test_wgrad_split_covers_k_in_whole_steps(B, H, W, C):
    K = B * H * W
    splits, chunk = conv3x3.wgrad_split(K, C, C)
    assert chunk % 16 == 0 and splits * chunk >= K > (splits - 1) * chunk
    tiles = math.ceil(C / 64) ** 2 * 9
    assert 1 <= splits <= 65535 // 9
    assert tiles * splits >= min(528, tiles * math.ceil(K / 16))


@pytest.mark.parametrize("record", [True, False])
def test_convolution_layer_uses_conv3x3_same_only_when_autograd_records(
        monkeypatch, record):
    import deeplearning4j_tpu_torch.nn.layers as layers
    calls = []

    def spy(x, w):
        calls.append(tuple(x.shape))
        return ck.conv3x3_same(x, w)

    monkeypatch.setattr(layers, "conv3x3_same", spy)
    rs = np.random.RandomState(2)
    x = torch.from_numpy(rs.randn(2, 6, 6, 3).astype(np.float32))
    w = torch.from_numpy(rs.randn(4, 3, 3, 3).astype(np.float32)).requires_grad_(record)
    b = torch.from_numpy(rs.randn(4).astype(np.float32))
    conv = ConvolutionLayer(n_out=4, kernel_size=3, convolution_mode="Same",
                            activation="relu")
    y, _ = conv.apply({"W": w, "b": b}, {}, x)
    want = torch.relu(torch.nn.functional.conv2d(
        x.permute(0, 3, 1, 2), w.detach(), b, 1, 1).permute(0, 2, 3, 1))
    torch.testing.assert_close(y.detach(), want, rtol=1e-5, atol=1e-5)
    assert calls == ([(2, 6, 6, 3)] if record else [])
    strided = ConvolutionLayer(n_out=4, kernel_size=3, stride=2,
                               convolution_mode="Same")
    strided.apply({"W": w, "b": b}, {}, x)
    assert len(calls) == (1 if record else 0)


def test_max_pool_backward_gives_ties_to_the_first_max_as_jax():
    """ReLU zeros make whole windows of exact ties: the first maximum in
    window order takes the gradient, as XLA's select-and-scatter does."""
    rs = np.random.RandomState(4)
    x = np.maximum(rs.randn(2, 9, 9, 3), 0.0).astype(np.float32)
    x[0, :4, :4, :] = 0.0
    x[1, 2:5, 2:5, 1] = 0.75
    dy = rs.randn(2, 5, 5, 3).astype(np.float32)
    assert not jpk.POOL_BWD_TAPS["enabled"]

    def jloss(a):
        return jnp.sum(jpk.max_pool2d(a, (3, 3), (2, 2), "SAME") * dy)

    want = np.asarray(jax.grad(jloss)(jnp.asarray(x)))
    tx = torch.from_numpy(x).requires_grad_()
    y = tpk.max_pool2d(tx, (3, 3), (2, 2), "SAME")
    assert tuple(y.shape) == (2, 5, 5, 3)
    y.backward(torch.from_numpy(dy))
    np.testing.assert_array_equal(tx.grad.numpy(), want)


@pytest.mark.cuda
def test_kernels_match_plain_versions_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    gen = torch.Generator(device="cuda").manual_seed(0)
    for B, H, W, Ci, Co in [(3, 13, 13, 24, 40), (2, 7, 7, 96, 80)]:
        for dt in (torch.float32, torch.bfloat16):
            x = torch.randn(B, H, W, Ci, generator=gen, device="cuda").to(dt)
            dy = torch.randn(B, H, W, Co, generator=gen, device="cuda").to(dt)
            w = torch.randn(Co, Ci, 3, 3, generator=gen, device="cuda").to(dt)
            before = conv3x3.WGRAD_LAUNCHES.value
            got = ck.conv3x3_wgrad(x, dy)
            torch.cuda.synchronize()
            assert conv3x3.WGRAD_LAUNCHES.value == before + 1
            ref = ck.conv3x3_wgrad_reference(x, dy)
            assert (got - ref).abs().max() <= 1e-4 * ref.abs().max()
            got = ck.conv3x3_dgrad(dy, w)
            ref = ck.conv3x3_dgrad_reference(dy, w)
            assert (got - ref).abs().max() <= 1e-4 * ref.abs().max()
