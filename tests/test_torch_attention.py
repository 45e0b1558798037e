"""Attention of the PyTorch port against the JAX package.

`flash_attention_plain` (the kernel's plain version, what CPU tensors run
in `ops.kernels.attention.flash_attention`) is held against the JAX Pallas
kernel `flash_attention_tpu` in interpret mode with 64-row blocks (the
port kernel's tiles), at T = S = 128, causal or not, with and without a
keep-mask that cuts inside a block: out and lse, f32 to 1e-5 relative;
bf16 inputs with out within one bf16 ulp of max|ref| (the same tiling, so
the same rounding of p to bf16; sums in another order) and the f32 lse to
1e-5.  Ragged shapes are held against the JAX tier's `flash_attention` in
interpret mode, which pads T and S; the port does not.  `fused_attention`
on the CPU runs the JAX package's plain paths (`mha_reference`, or
`blockwise_attention` above 2 GB of scores), as the JAX dispatcher does off
the TPU: f32 to 1e-5, bf16 to 2 ulps of max|ref|.

The backward: `flash_attention_bwd_plain` (the dQ and dK/dV kernels' plain
version) against `flash_attention_bwd_tpu` in interpret mode with 64-row
blocks, on the JAX forward's out and lse, causal or not, with and without
the mask: dq, dk and dv in f32 to 1e-5 of max|ref|, in bf16 to 2 ulps of
max|ref| (ds and p round to bf16 alike; sums in another order).  Ragged
shapes against `jax.grad` through the JAX tier wrapper, which pads, to
1e-5.  `FlashAttention`, the kernel path's autograd wrapper, with both
launches replaced by the plain versions, against `jax.grad` of
`mha_reference` to 1e-5.  The CUDA kernels themselves are checked by the
`cuda`-marked tests, which skip without a card.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.ops import attention_kernels as jak
from deeplearning4j_tpu.ops.pallas import attention as jpa
from deeplearning4j_tpu_torch.ops import attention_kernels as ak
from deeplearning4j_tpu_torch.ops.kernels import attention as ka
from deeplearning4j_tpu_torch.ops.kernels import dispatch

DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _qkv(B, H, T, S, D, seed=0):
    rs = np.random.RandomState(seed)
    return (rs.randn(B, H, T, D).astype(np.float32),
            rs.randn(B, H, S, D).astype(np.float32),
            rs.randn(B, H, S, D).astype(np.float32))


def _mask(B, S, drop=28):
    m = np.ones((B, S), np.float32)
    m[: (B + 1) // 2, S - drop:] = 0.0      # the last positions of half the rows
    return m


def _bf16_ulp(a):
    return 2.0 ** (np.floor(np.log2(np.maximum(np.abs(a), 2.0 ** -126))) - 7)


def _f32(a):
    return np.asarray(a.float() if isinstance(a, torch.Tensor) else a.astype(jnp.float32),
                      dtype=np.float32)


def _close(got, want, rtol=1e-5):
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * float(np.abs(want).max()))


@pytest.fixture(autouse=True)
def _auto_mode():
    prev = dispatch.set_dispatch_mode("auto")
    yield
    dispatch.set_dispatch_mode(prev)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("causal", [False, True])
def test_plain_version_matches_jax_kernel_in_interpret_mode(causal, masked, dtype):
    tdt, jdt = DTYPES[dtype]
    q, k, v = _qkv(2, 2, 128, 128, 32)
    m = _mask(2, 128, drop=31) if masked else None
    jo, jlse = jak.flash_attention_tpu(
        *(jnp.asarray(a).astype(jdt) for a in (q, k, v)), causal=causal,
        block_q=64, block_k=64, interpret=True, return_lse=True,
        mask=None if m is None else jnp.asarray(m).astype(jdt))
    to, tlse = ka.flash_attention(
        *(torch.from_numpy(a).to(tdt) for a in (q, k, v)),
        mask=None if m is None else torch.from_numpy(m).to(tdt), causal=causal)
    assert to.dtype == tdt and tuple(to.shape) == q.shape
    assert tlse.dtype == torch.float32 and tuple(tlse.shape) == (4, 128)
    _close(tlse.numpy(), np.asarray(jlse))
    want, got = _f32(jo), _f32(to)
    if tdt == torch.float32:
        _close(got, want)
    else:
        assert np.abs(got - want).max() <= _bf16_ulp(np.abs(want).max())


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("B,H,T,S", [(2, 3, 77, 77), (1, 2, 37, 200)])
def test_ragged_shapes_match_the_jax_tier_wrapper(B, H, T, S, causal):
    q, k, v = _qkv(B, H, T, S, 32, seed=1)
    m = _mask(B, S)
    want = jpa.flash_attention(*(jnp.asarray(a) for a in (q, k, v)),
                               mask=jnp.asarray(m), causal=causal, interpret=True)
    got, lse = ak.flash_attention_plain(*(torch.from_numpy(a) for a in (q, k, v)),
                                        torch.from_numpy(m), causal)
    _close(got.numpy(), np.asarray(want))
    ref = np.asarray(jak.mha_reference(
        *(jnp.asarray(a) for a in (q, k, v)), mask=jnp.asarray(m), causal=causal))
    _close(got.numpy(), ref)
    assert tuple(lse.shape) == (B * H, T)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("masked,causal", [(False, False), (True, False), (True, True)])
def test_fused_attention_on_cpu_matches_jax_dispatcher(masked, causal, dtype):
    tdt, jdt = DTYPES[dtype]
    q, k, v = _qkv(2, 2, 48, 48, 16, seed=2)
    m = _mask(2, 48, drop=9) if masked else None
    want = _f32(jak.fused_attention(
        *(jnp.asarray(a).astype(jdt) for a in (q, k, v)),
        mask=None if m is None else jnp.asarray(m).astype(jdt), causal=causal))
    got = ak.fused_attention(*(torch.from_numpy(a).to(tdt) for a in (q, k, v)),
                             mask=None if m is None else torch.from_numpy(m).to(tdt),
                             causal=causal)
    assert got.dtype == tdt
    ref = float(np.abs(want).max())
    tol = 1e-5 * ref if tdt == torch.float32 else 2 * 2.0 ** (math.floor(math.log2(ref)) - 7)
    assert np.abs(_f32(got) - want).max() <= tol


@pytest.mark.parametrize("causal", [False, True])
def test_blockwise_attention_matches_jax_and_takes_over_above_the_score_budget(
        monkeypatch, causal):
    q, k, v = _qkv(1, 2, 64, 128, 16, seed=3)
    m = _mask(1, 128, drop=50)
    want = np.asarray(jak.blockwise_attention(
        *(jnp.asarray(a) for a in (q, k, v)), jnp.asarray(m), causal, None, 64))
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    got = ak.blockwise_attention(tq, tk, tv, torch.from_numpy(m), causal, None, 64)
    _close(got.numpy(), want)
    monkeypatch.setattr(ak, "_SCORE_BYTES_MAX", 0)
    _close(ak.fused_attention(tq, tk, tv, torch.from_numpy(m), causal).numpy(),
           np.asarray(jak.blockwise_attention(*(jnp.asarray(a) for a in (q, k, v)),
                                              jnp.asarray(m), causal)))


def test_fully_masked_row_comes_out_uniform_as_in_mha_reference():
    q, k, v = _qkv(2, 1, 16, 40, 8, seed=4)
    m = np.ones((2, 40), np.float32)
    m[1] = 0.0
    want = np.asarray(jak.mha_reference(*(jnp.asarray(a) for a in (q, k, v)),
                                        mask=jnp.asarray(m)))
    got, _ = ak.flash_attention_plain(*(torch.from_numpy(a) for a in (q, k, v)),
                                      torch.from_numpy(m))
    _close(got.numpy(), want)
    np.testing.assert_allclose(got[1, 0].numpy(), np.broadcast_to(v[1, 0].mean(0), (16, 8)),
                               rtol=1e-5, atol=1e-6)


def test_cpu_tensors_take_the_plain_version_and_count_no_launch():
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 2, 20, 20, 8))
    before = ka.LAUNCHES.value
    assert dispatch.resolve("attention", q, k, v) == "reference"
    out, lse = ka.flash_attention(q, k, v)
    want, want_lse = ak.flash_attention_plain(q, k, v)
    torch.testing.assert_close(out, want, rtol=0, atol=0)
    torch.testing.assert_close(lse, want_lse, rtol=0, atol=0)
    assert ka.LAUNCHES.value == before
    torch.testing.assert_close(ak.fused_attention(q, k, v),
                               ka.attention_reference(q, k, v), rtol=0, atol=0)
    dispatch.set_dispatch_mode("kernel")
    with pytest.raises(RuntimeError, match="CUDA tensors"):
        ak.fused_attention(q, k, v)


@pytest.mark.parametrize("case", ["float16", "mixed", "wide_head", "int_mask",
                                  "mask_shape", "strided_d", "kv_shape"])
def test_cuda_inputs_the_kernel_refuses_raise(monkeypatch, case):
    """A CUDA call the kernel does not take raises: it never drops to the
    plain path.  The device lookup is patched, so no card is needed."""
    monkeypatch.setattr(dispatch, "_devices",
                        lambda args, kwargs: {torch.device("cuda", 0)})
    D = 160 if case == "wide_head" else 8
    q, k, v = (torch.from_numpy(a) for a in _qkv(2, 2, 10, 12, D))
    mask = torch.ones(2, 12)
    if case == "float16":
        q, k, v = q.half(), k.half(), v.half()
    elif case == "mixed":
        v = v.bfloat16()
    elif case == "int_mask":
        mask = mask.int()
    elif case == "mask_shape":
        mask = torch.ones(2, 10)
    elif case == "strided_d":
        q = torch.from_numpy(_qkv(2, 2, 10, 12, 2 * D)[0])[..., ::2]
    elif case == "kv_shape":
        k = k[:, :, :-1]
    with pytest.raises(ValueError, match="does not take these inputs"):
        ak.fused_attention(q, k, v, mask=mask)


def test_supports_takes_bert_views_and_ragged_shapes():
    B, T, H, D = 2, 9, 3, 8
    qkv = torch.zeros(B, T, 3, H, D, dtype=torch.bfloat16)
    q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
    assert not q.is_contiguous()
    assert ka.attention_supports(q, k, v, mask=torch.ones(B, T, dtype=torch.bfloat16))
    assert ka.attention_supports(*(torch.zeros(1, 2, 37, 128) for _ in range(1)),
                                 torch.zeros(1, 2, 200, 128), torch.zeros(1, 2, 200, 128),
                                 mask=torch.ones(1, 200, dtype=torch.float64), causal=True)


def test_kernel_path_backward_is_the_plain_vjp_and_matches_jax_grad(monkeypatch):
    """`FlashAttention` (the kernel path's autograd wrapper) with both
    launches replaced by the plain versions: the backward runs on the
    forward's saved out and lse, and its gradients equal JAX's gradient of
    `mha_reference` within 1e-5 of max|ref|; lse is not differentiable."""
    monkeypatch.setattr(ka, "launch", ak.flash_attention_plain)
    monkeypatch.setattr(ka, "launch_bwd", ak.flash_attention_bwd_plain)
    q, k, v = _qkv(1, 2, 24, 30, 8, seed=5)
    m = _mask(1, 30, drop=7)
    g = np.random.RandomState(6).randn(*q.shape).astype(np.float32)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out, lse = ka.FlashAttention.apply(tq, tk, tv, torch.from_numpy(m), True, None)
    assert not lse.requires_grad
    out.backward(torch.from_numpy(g))

    def loss(q_, k_, v_):
        return jnp.sum(jak.mha_reference(q_, k_, v_, mask=jnp.asarray(m), causal=True) * g)

    want = jax.grad(loss, argnums=(0, 1, 2))(*(jnp.asarray(a) for a in (q, k, v)))
    for t, w in zip((tq, tk, tv), want):
        _close(t.grad.numpy(), np.asarray(w))


def _t(a, dtype):
    """A JAX array (or numpy) as a torch tensor of `dtype`; bf16 values
    cross exactly through f32."""
    return torch.tensor(_f32(a) if not isinstance(a, np.ndarray) else a).to(dtype)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("causal", [False, True])
def test_backward_plain_version_matches_jax_kernels_in_interpret_mode(causal, masked, dtype):
    tdt, jdt = DTYPES[dtype]
    q, k, v = _qkv(2, 2, 128, 128, 32, seed=7)
    g = np.random.RandomState(8).randn(*q.shape).astype(np.float32)
    m = _mask(2, 128, drop=31) if masked else None
    jq, jk, jv, jg = (jnp.asarray(a).astype(jdt) for a in (q, k, v, g))
    jm = None if m is None else jnp.asarray(m).astype(jdt)
    jo, jlse = jak.flash_attention_tpu(jq, jk, jv, causal=causal, block_q=64, block_k=64,
                                       interpret=True, return_lse=True, mask=jm)
    want = jak.flash_attention_bwd_tpu(jq, jk, jv, jo, jlse, jg, causal=causal, block_q=64,
                                       block_k=64, interpret=True, mask=jm)
    got = ak.flash_attention_bwd_plain(
        *(_t(a, tdt) for a in (jq, jk, jv, jo)), _t(np.asarray(jlse), torch.float32),
        _t(jg, tdt), mask=None if m is None else _t(m, tdt), causal=causal)
    for a, w in zip(got, want):
        assert a.dtype == tdt and tuple(a.shape) == q.shape
        a, w = _f32(a), _f32(w)
        if tdt == torch.float32:
            _close(a, w)
        else:
            assert np.abs(a - w).max() <= 2 * _bf16_ulp(np.abs(w).max())


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("B,H,T,S", [(2, 3, 77, 77), (1, 2, 37, 200)])
def test_backward_on_ragged_shapes_matches_jax_grad_through_the_tier_wrapper(B, H, T, S, causal):
    q, k, v = _qkv(B, H, T, S, 32, seed=9)
    g = np.random.RandomState(10).randn(*q.shape).astype(np.float32)
    m = _mask(B, S)

    def loss(q_, k_, v_):
        return jnp.sum(jpa.flash_attention(q_, k_, v_, mask=jnp.asarray(m), causal=causal,
                                           interpret=True) * g)

    want = jax.grad(loss, argnums=(0, 1, 2))(*(jnp.asarray(a) for a in (q, k, v)))
    tq, tk, tv, tg, tm = (torch.from_numpy(a) for a in (q, k, v, g, m))
    out, lse = ak.flash_attention_plain(tq, tk, tv, tm, causal)
    got = ak.flash_attention_bwd_plain(tq, tk, tv, out, lse, tg, tm, causal)
    for a, w in zip(got, want):
        _close(a.numpy(), np.asarray(w))


def test_backward_takes_head_split_views_and_counts_no_launch_on_cpu():
    """BERT's q, k, v and dO are head-split views of [B, T, H*D] tensors;
    the plain backward takes them as they are, and on CPU tensors the
    attention's backward runs no kernel."""
    B, T, H, D = 2, 9, 3, 8
    rs = np.random.RandomState(11)
    qkv, go = (torch.from_numpy(rs.randn(*shape).astype(np.float32))
               for shape in ((B, T, 3, H, D), (B, T, H, D)))
    q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
    g = go.transpose(1, 2)
    assert not (q.is_contiguous() or g.is_contiguous())
    out, lse = ak.flash_attention_plain(q, k, v)
    got = ak.flash_attention_bwd_plain(q, k, v, out, lse, g)
    dense = ak.flash_attention_bwd_plain(*(t.contiguous() for t in (q, k, v, out)), lse,
                                         g.contiguous())
    for a, w in zip(got, dense):
        torch.testing.assert_close(a, w, rtol=1e-5, atol=1e-6)
    before = (ka.DQ_LAUNCHES.value, ka.DKV_LAUNCHES.value)
    tq, tk, tv = (t.detach().requires_grad_() for t in (q, k, v))
    ak.fused_attention(tq, tk, tv).backward(g)
    for t, w in zip((tq, tk, tv), got):
        torch.testing.assert_close(t.grad, w, rtol=1e-5, atol=1e-5)
    assert (ka.DQ_LAUNCHES.value, ka.DKV_LAUNCHES.value) == before


@pytest.mark.parametrize("case", ["lse_shape", "lse_dtype", "g_dtype", "out_shape", "float16"])
def test_backward_cuda_inputs_the_kernels_refuse_raise(case):
    """A backward call the kernels do not take raises in the launcher,
    before any launch: there is no fallback to the plain version."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(2, 2, 10, 12, 8))
    out, lse, g = torch.zeros_like(q), torch.zeros(4, 10), torch.ones_like(q)
    if case == "lse_shape":
        lse = torch.zeros(2, 2, 10)
    elif case == "lse_dtype":
        lse = lse.double()
    elif case == "g_dtype":
        g = g.bfloat16()
    elif case == "out_shape":
        out = out[:, :, :-1]
    elif case == "float16":
        q, k, v, out, g = (t.half() for t in (q, k, v, out, g))
    with pytest.raises(ValueError, match="do not take these inputs"):
        ka.launch_bwd(q, k, v, out, lse, g)


@pytest.mark.cuda
def test_kernel_matches_plain_version_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    gen = torch.Generator(device="cuda").manual_seed(0)
    for B, H, T, S, D in [(2, 3, 77, 77, 64), (1, 2, 37, 200, 64), (2, 2, 130, 100, 128)]:
        for dt in (torch.float32, torch.bfloat16):
            q = torch.randn(B, H, T, D, generator=gen, device="cuda").to(dt)
            k = torch.randn(B, H, S, D, generator=gen, device="cuda").to(dt)
            v = torch.randn(B, H, S, D, generator=gen, device="cuda").to(dt)
            mask = torch.ones(B, S, device="cuda", dtype=dt)
            mask[0, -28:] = 0
            for causal in (False, True):
                before = ka.LAUNCHES.value
                out, lse = ka.flash_attention(q, k, v, mask, causal)
                torch.cuda.synchronize()
                assert ka.LAUNCHES.value == before + 1
                ro, rl = ak.flash_attention_plain(q, k, v, mask, causal)
                ref = ro.float().abs().max().item()
                tol = 1e-4 * ref if dt == torch.float32 else 2 * 2.0 ** (math.floor(math.log2(ref)) - 7)
                assert (out.float() - ro.float()).abs().max().item() <= tol
                assert (lse - rl).abs().max().item() <= 1e-4 * rl.abs().max().item()


@pytest.mark.cuda
def test_backward_kernels_match_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    gen = torch.Generator(device="cuda").manual_seed(1)
    for B, H, T, S, D in [(2, 3, 77, 77, 64), (1, 2, 37, 200, 64), (2, 2, 130, 100, 128)]:
        for dt in (torch.float32, torch.bfloat16):
            q = torch.randn(B, H, T, D, generator=gen, device="cuda").to(dt)
            k = torch.randn(B, H, S, D, generator=gen, device="cuda").to(dt)
            v = torch.randn(B, H, S, D, generator=gen, device="cuda").to(dt)
            g = torch.randn(B, H, T, D, generator=gen, device="cuda").to(dt)
            mask = torch.ones(B, S, device="cuda", dtype=dt)
            mask[0, -28:] = 0
            for causal in (False, True):
                out, lse = ka.flash_attention(q, k, v, mask, causal)
                before = (ka.DQ_LAUNCHES.value, ka.DKV_LAUNCHES.value)
                got = ka.launch_bwd(q, k, v, out, lse, g, mask, causal)
                torch.cuda.synchronize()
                assert (ka.DQ_LAUNCHES.value, ka.DKV_LAUNCHES.value) == (before[0] + 1,
                                                                         before[1] + 1)
                want = ak.flash_attention_bwd_plain(q, k, v, out, lse, g, mask, causal)
                for a, w in zip(got, want):
                    ref = w.float().abs().max().item()
                    tol = (1e-4 * ref if dt == torch.float32
                           else 2 * 2.0 ** (math.floor(math.log2(ref)) - 7))
                    assert a.dtype == dt and (a.float() - w.float()).abs().max().item() <= tol
