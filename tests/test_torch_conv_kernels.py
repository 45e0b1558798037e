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


#: an H100 SXM's SMs, for the plans below
SM_COUNT = 132
BODY = {"s0": (64, 56, 56, 64), "s1": (64, 28, 28, 128),
        "s2": (64, 14, 14, 256), "s3": (64, 7, 7, 512)}


def _check_slices(plan, steps):
    """The slices tile the reduction steps in order, each non-empty."""
    assert plan.steps == steps and len(plan.slices) == plan.splits
    assert plan.slices[0][0] == 0 and plan.slices[-1][1] == steps
    assert all(a < b for a, b in plan.slices)
    assert all(p[1] == q[0] for p, q in zip(plan.slices, plan.slices[1:]))


@pytest.mark.parametrize("B,H,W,C", [(64, 56, 56, 64), (64, 28, 28, 128),
                                     (64, 14, 14, 256), (64, 7, 7, 512),
                                     (3, 13, 13, 24), (1, 1, 1, 1)])
def test_wgrad_split_covers_k_in_whole_steps(B, H, W, C):
    K = B * H * W
    plan = conv3x3.conv_plan("conv3x3_wgrad", B, H, W, C, C, SM_COUNT)
    bk = conv3x3.BLOCK_K
    _check_slices(plan, math.ceil(K / bk))
    # slice s covers positions [bk * begin, min(K, bk * end)): every one once
    assert sum(min(K, bk * b) - bk * a for a, b in plan.slices) == K
    n = math.ceil(C / 64)
    tiles = n * n * 9
    assert plan.tiles == tiles and plan.grid == (n, n, 9 * plan.splits)
    assert 1 <= plan.splits <= 65535 // 9
    assert tiles * plan.splits >= min(2 * SM_COUNT, tiles * plan.steps)
    assert plan.workspace_bytes == (plan.splits * tiles * 64 * 64 * 4
                                    if plan.splits > 1 else 0)
    assert plan.packed_w_bytes == 0


@pytest.mark.parametrize("B,H,W,Ci,Co", [(64, 56, 56, 64, 64), (64, 7, 7, 512, 512),
                                         (3, 13, 13, 24, 40), (2, 9, 11, 3, 5),
                                         (2, 16, 16, 3, 64), (1, 1, 1, 1, 1)])
@pytest.mark.parametrize("itemsize", [4, 2])
def test_dgrad_plan_covers_taps_and_channels(B, H, W, Ci, Co, itemsize):
    plan = conv3x3.conv_plan("conv3x3_dgrad", B, H, W, Ci, Co, SM_COUNT, itemsize)
    _check_slices(plan, 9 * math.ceil(Co / conv3x3.BLOCK_K))
    grid = (math.ceil(B * H * W / 64), math.ceil(Ci / 64), plan.splits)
    tiles = grid[0] * grid[1]
    assert plan.tiles == tiles and plan.grid == grid
    assert tiles * plan.splits >= min(2 * SM_COUNT, tiles * plan.steps)
    assert plan.workspace_bytes == (plan.splits * tiles * 64 * 64 * 4
                                    if plan.splits > 1 else 0)
    # the packed filter [9, Co, ci_ld] with rows padded to 16 bytes of bf16
    ci_ld = math.ceil(Ci / 8) * 8
    assert plan.packed_w_bytes == 9 * Co * ci_ld * itemsize
    assert (ci_ld * 2) % 16 == 0


@pytest.mark.parametrize("stage", sorted(BODY))
@pytest.mark.parametrize("kernel", ["conv3x3_wgrad", "conv3x3_dgrad"])
def test_conv_plan_fills_the_card_at_body_shapes(kernel, stage):
    """At least 2 blocks per SM at every ResNet-50 body shape, and the
    busiest SM's work (blocks on it times steps a block) within 6% of the
    even share (the plan's 5% slack over its best whole-block split, which
    is within 1% of the even share here): dgrad gets there without splitting; wgrad splits the
    positions (9 tiles at s0) into slices whose blocks spread evenly over
    the SMs (378 blocks at s0, not 270), with at most 20 MB of workspace."""
    B, H, W, C = BODY[stage]
    plan = conv3x3.conv_plan(kernel, B, H, W, C, C, SM_COUNT)
    blocks = plan.grid[0] * plan.grid[1] * plan.grid[2]
    assert blocks >= 2 * SM_COUNT
    busiest = math.ceil(blocks / SM_COUNT) * math.ceil(plan.steps / plan.splits)
    assert busiest <= 1.06 * plan.tiles * plan.steps / SM_COUNT
    if kernel == "conv3x3_dgrad":
        assert plan.splits == 1 and plan.workspace_bytes == 0
    else:
        assert plan.splits == {"s0": 42, "s1": 11, "s2": 7, "s3": 2}[stage]
        assert plan.workspace_bytes <= 20 << 20


def _tf32_rna(t):
    """Round f32 to TF32 (10 mantissa bits), to nearest with ties away from
    zero, as ``cvt.rna.tf32.f32``: add half a unit of the 13 dropped bits
    to the magnitude, then clear them."""
    bits = t.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _split(t):
    big = _tf32_rna(t)
    return big, _tf32_rna(t - big)


def _product_3xtf32(a, b):
    """a @ b as the f32 kernel forms it: small*big + big*small + big*big,
    each on TF32 operands, summed in f32."""
    (ab, as_), (bb, bs) = _split(a), _split(b)
    return as_ @ bb + ab @ bs + ab @ bb


def _dgrad_emulated(dy, w, product):
    B, H, W, Co = dy.shape
    dyp = torch.nn.functional.pad(dy, (0, 0, 1, 1, 1, 1))
    dx = torch.zeros((B * H * W, w.shape[1]), dtype=torch.float32)
    for i in range(3):
        for j in range(3):
            dx = dx + product(dyp[:, i:i + H, j:j + W, :].reshape(-1, Co),
                              w[:, :, 2 - i, 2 - j].contiguous())
    return dx.reshape(B, H, W, -1)


def _wgrad_emulated(x, dy, product):
    B, H, W, Ci = x.shape
    xp = torch.nn.functional.pad(x, (0, 0, 1, 1, 1, 1))
    d = dy.reshape(-1, dy.shape[-1]).t().contiguous()
    taps = [product(d, xp[:, i:i + H, j:j + W, :].reshape(-1, Ci))
            for i in range(3) for j in range(3)]
    return torch.stack(taps, dim=-1).reshape(dy.shape[-1], Ci, 3, 3)


def test_tf32_rounding_is_to_nearest_ties_away():
    one = 1.0
    v = torch.tensor([one, one + 2 ** -11, -(one + 2 ** -11), one + 2 ** -12,
                      one + 3 * 2 ** -11, 3.0e-3], dtype=torch.float32)
    got = _tf32_rna(v)
    want = torch.tensor([one, one + 2 ** -10, -(one + 2 ** -10), one,
                         one + 2 ** -9, float(np.float32(3.0e-3))], dtype=torch.float32)
    torch.testing.assert_close(got[:5], want[:5], rtol=0, atol=0)
    assert abs(got[5].item() - 3.0e-3) <= 3.0e-3 * 2 ** -11
    assert (got.view(torch.int32) & 0x1FFF == 0).all()


@pytest.mark.parametrize("kernel,shape", [
    ("conv3x3_dgrad", (1, 6, 6, 16, 512)),     # 9 * 512 = 4,608 terms a sum
    ("conv3x3_dgrad", (2, 5, 7, 8, 640)),      # 5,760
    ("conv3x3_wgrad", (2, 48, 48, 8, 8)),      # 4,608 positions
    ("conv3x3_wgrad", (4, 40, 40, 4, 16)),     # 6,400
])
def test_3xtf32_split_keeps_f32_accuracy(kernel, shape):
    """The f32 kernels' 3xTF32 product, emulated on the CPU, stays within
    the card checks' 1e-4 * max|ref| of the f64 reference at reductions of
    4,608 terms and more, and well inside one TF32 product's error."""
    B, H, W, Ci, Co = shape
    rs = np.random.RandomState(7)
    x = torch.from_numpy(rs.randn(B, H, W, Ci).astype(np.float32))
    dy = torch.from_numpy(rs.randn(B, H, W, Co).astype(np.float32))
    w = torch.from_numpy(rs.randn(Co, Ci, 3, 3).astype(np.float32))
    if kernel == "conv3x3_dgrad":
        ref = ck.conv3x3_dgrad_reference(dy.double(), w.double())
        got = _dgrad_emulated(dy, w, _product_3xtf32)
        one = _dgrad_emulated(dy, w, lambda a, b: _tf32_rna(a) @ _tf32_rna(b))
    else:
        ref = ck.conv3x3_wgrad_reference(x.double(), dy.double())
        got = _wgrad_emulated(x, dy, _product_3xtf32)
        one = _wgrad_emulated(x, dy, lambda a, b: _tf32_rna(a) @ _tf32_rna(b))
    rmax = ref.abs().max().item()
    err = (got.double() - ref).abs().max().item()
    err_one = (one.double() - ref).abs().max().item()
    assert err <= 1e-4 * rmax
    assert err * 10 < err_one


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
    for B, H, W, Ci, Co in [(3, 13, 13, 24, 40), (2, 7, 7, 96, 80), (2, 9, 11, 3, 5),
                            (2, 16, 16, 3, 64)]:
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
            assert torch.equal(got, ck.conv3x3_wgrad(x, dy))
            got = ck.conv3x3_dgrad(dy, w)
            ref = ck.conv3x3_dgrad_reference(dy, w)
            assert (got - ref).abs().max() <= 1e-4 * ref.abs().max()
            assert torch.equal(got, ck.conv3x3_dgrad(dy, w))
