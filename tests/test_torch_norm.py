"""LayerNorm of the PyTorch port against the JAX package.

`layer_norm_plain` (the kernel's plain version, what CPU tensors run in
`layer_norm_fwd`) is held against the JAX Pallas kernel `layer_norm_tpu`
run in interpret mode, on the same numpy inputs made from a seed: y, mean
and rstd, f32 to 1e-5 relative; bf16 inputs with y within one bf16 ulp of
each element (both compute in f32 and round once; a sum taken in another
order may flip a rounding) and the f32 statistics to 1e-5.
`fused_layer_norm` on the CPU runs the JAX package's plain composition, as
the JAX dispatcher does off the TPU: f32 to 1e-5, bf16 to 2 ulps of
max|ref|.  `layer_norm_bwd_plain` (the backward kernel's plain version) is
held against `layer_norm_bwd_tpu` in interpret mode on the JAX forward's
mean and rstd: dx, dgain and dbias in f32 to 1e-5 of max|ref|, in bf16 to
2 ulps of max|ref| (one rounding each, after f32 sums in another order).
`FusedLayerNorm`, the kernel path's autograd wrapper, with both launches
replaced by the plain versions passes gradcheck in f64 and matches
`jax.grad` of the JAX reference in f32.  `LayerNormalizationLayer`
matches its JAX counterpart, JSON included.  `ln_fwd_plan`, the forward
kernel's grid, covers every row once in its grid-stride loop, fills the
card at BERT-base and picks the instance that holds a row, and the
wrapper hands the library that plan.  The CUDA kernels themselves are
checked by the `cuda`-marked tests, which skip without a card.
"""
import torch_test_threads  # noqa: F401  (first: one torch thread a worker)
import contextlib
import re
from pathlib import Path
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu import nn as jnn
from deeplearning4j_tpu.ops import norm_kernels as jnk
from deeplearning4j_tpu_torch import nn as tnn
from deeplearning4j_tpu_torch.ops import norm_kernels as nk
from deeplearning4j_tpu_torch.ops.kernels import build, dispatch, layer_norm

DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _arrays(shape, seed=0):
    rs = np.random.RandomState(seed)
    F = shape[-1]
    return ((rs.randn(*shape) * 2 + 0.5).astype(np.float32),
            rs.randn(F).astype(np.float32), rs.randn(F).astype(np.float32))


def _bf16_ulp(a):
    a = np.maximum(np.abs(a), 2.0 ** -126)
    return 2.0 ** (np.floor(np.log2(a)) - 7)


def _f32(a):
    return np.asarray(a.float() if isinstance(a, torch.Tensor) else a.astype(jnp.float32),
                      dtype=np.float32)


@pytest.fixture(autouse=True)
def _auto_mode():
    prev = dispatch.set_dispatch_mode("auto")
    yield
    dispatch.set_dispatch_mode(prev)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("eps", [1e-12, 1e-5])
@pytest.mark.parametrize("shape", [(4, 16, 96), (2, 128)])
def test_plain_version_matches_jax_kernel_in_interpret_mode(shape, eps, dtype):
    tdt, jdt = DTYPES[dtype]
    x, g, b = _arrays(shape)
    jy, jmean, jrstd = jnk.layer_norm_tpu(
        jnp.asarray(x).astype(jdt), jnp.asarray(g).astype(jdt),
        jnp.asarray(b).astype(jdt), eps, interpret=True)
    ty, tmean, trstd = nk.layer_norm_fwd(
        *(torch.from_numpy(a).to(tdt) for a in (x, g, b)), eps)
    assert ty.dtype == tdt and tuple(ty.shape) == shape
    rows = int(np.prod(shape[:-1]))
    assert tmean.dtype == trstd.dtype == torch.float32
    assert tuple(tmean.shape) == tuple(trstd.shape) == (rows,)
    np.testing.assert_allclose(tmean.numpy(), np.asarray(jmean), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(trstd.numpy(), np.asarray(jrstd), rtol=1e-5)
    want, got = _f32(jy), _f32(ty)
    if tdt == torch.float32:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())
    else:
        assert (np.abs(got - want) <= _bf16_ulp(want)).all()


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("with_bias", [True, False])
def test_fused_layer_norm_on_cpu_matches_jax_dispatcher(dtype, with_bias):
    tdt, jdt = DTYPES[dtype]
    x, g, b = _arrays((3, 5, 40), seed=1)
    jb = jnp.asarray(b).astype(jdt) if with_bias else None
    tb = torch.from_numpy(b).to(tdt) if with_bias else None
    want = _f32(jnk.fused_layer_norm(jnp.asarray(x).astype(jdt),
                                     jnp.asarray(g).astype(jdt), jb, 1e-12))
    got = nk.fused_layer_norm(torch.from_numpy(x).to(tdt),
                              torch.from_numpy(g).to(tdt), tb, 1e-12)
    assert got.dtype == tdt
    got = _f32(got)
    ref = float(np.abs(want).max())
    tol = 1e-5 * ref if tdt == torch.float32 else 2 * 2.0 ** (math.floor(math.log2(ref)) - 7)
    assert np.abs(got - want).max() <= tol


def test_layer_normalization_layer_matches_jax_and_its_json():
    import jax
    jl = jnn.LayerNormalizationLayer(eps=1e-6, name="ln")
    tl = tnn.LayerNormalizationLayer(eps=1e-6, name="ln")
    jp, _, jt = jl.initialize(jax.random.PRNGKey(0), jnn.InputType.feed_forward(24))
    tp, _, tt = tl.initialize(torch.Generator(), tnn.InputType.feed_forward(24))
    assert tuple(jt.shape) == tuple(tt.shape) == (24,)
    assert set(tp) == set(jp) == {"gamma", "beta"}
    _, g, b = _arrays((24,), seed=2)
    x = _arrays((6, 24), seed=3)[0]
    want, _ = jl.apply({"gamma": jnp.asarray(g), "beta": jnp.asarray(b)}, {}, jnp.asarray(x))
    got, _ = tl.apply({"gamma": torch.from_numpy(g), "beta": torch.from_numpy(b)}, {},
                      torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    jd = jl.to_json()
    assert tl.to_json() == jd
    assert tnn.Layer.from_json(jd).to_json() == jd


def test_cpu_tensors_take_the_plain_version_and_count_no_launch():
    x, g, b = (torch.from_numpy(a) for a in _arrays((8, 32)))
    before = layer_norm.LAUNCHES.value
    assert dispatch.resolve("layer_norm", x, g, bias=b) == "reference"
    y, mean, rstd = nk.layer_norm_fwd(x, g, b, 1e-5)
    torch.testing.assert_close(y, nk.layer_norm_plain(x, g, b, 1e-5)[0], rtol=0, atol=0)
    assert layer_norm.LAUNCHES.value == before
    dispatch.set_dispatch_mode("kernel")
    with pytest.raises(RuntimeError, match="CUDA tensors"):
        nk.fused_layer_norm(x, g, b)


@pytest.mark.parametrize("case", ["float16", "float64", "too_wide", "strided", "gain_shape"])
def test_cuda_inputs_the_kernel_refuses_raise(monkeypatch, case):
    """A CUDA call the kernel does not take raises: it never drops to the
    plain version.  The device lookup is patched, so no card is needed."""
    monkeypatch.setattr(dispatch, "_devices",
                        lambda args, kwargs: {torch.device("cuda", 0)})
    F = 9000 if case == "too_wide" else 16
    x, g, b = (torch.from_numpy(a) for a in _arrays((4, F)))
    if case in ("float16", "float64"):
        x = x.to(getattr(torch, case))
    elif case == "strided":
        x = torch.from_numpy(_arrays((4, 2 * F))[0])[:, ::2]
    elif case == "gain_shape":
        g = g[:-1]
    with pytest.raises(ValueError, match="does not take these inputs"):
        nk.fused_layer_norm(x, g, b)


def test_supports_takes_any_rows_and_width_up_to_8192():
    for shape in [(1, 1), (37, 1000), (4, 2048, 768), (3, 8192)]:
        x = torch.zeros(shape, dtype=torch.bfloat16)
        assert layer_norm.supports(x, torch.ones(shape[-1]), torch.zeros(shape[-1]))
    assert layer_norm.supports(torch.zeros(5, 64), torch.ones(64, dtype=torch.bfloat16))
    assert not layer_norm.supports(torch.zeros(2, 8193), torch.ones(8193))


def _plain_launchers(monkeypatch):
    monkeypatch.setattr(layer_norm, "launch", nk.layer_norm_plain)
    monkeypatch.setattr(layer_norm, "launch_bwd", nk.layer_norm_bwd_plain)


def test_kernel_path_backward_is_the_plain_vjp(monkeypatch):
    """`FusedLayerNorm` (the kernel path's autograd wrapper) with both
    launches replaced by the plain versions, with a bias and without: the
    backward that runs on the forward's saved mean and rstd passes
    gradcheck in f64, and in f32 it matches `jax.grad` of the JAX
    package's reference within 1e-5 of max|ref|."""
    import jax

    _plain_launchers(monkeypatch)
    x, g, b = _arrays((5, 12))
    dy = np.random.RandomState(7).randn(5, 12).astype(np.float32)
    for with_bias in (True, False):
        ins = [torch.from_numpy(a).double().requires_grad_() for a in (x, g, b)]
        ins = ins if with_bias else ins[:2]
        assert torch.autograd.gradcheck(
            lambda *a: nk.FusedLayerNorm.apply(*a, *([] if with_bias else [None]), 1e-5), ins)

        tx, tg, tb = (torch.from_numpy(a).requires_grad_() for a in (x, g, b))
        y = nk.FusedLayerNorm.apply(tx, tg, tb if with_bias else None, 1e-5)
        y.backward(torch.from_numpy(dy))

        def loss(x_, g_, b_):
            return jnp.sum(jnk.layer_norm_reference(x_, g_, b_ if with_bias else None, 1e-5)
                           * dy)

        want = jax.grad(loss, argnums=(0, 1, 2))(*(jnp.asarray(a) for a in (x, g, b)))
        got = (tx.grad, tg.grad, tb.grad if with_bias else torch.zeros(12))
        assert with_bias or tb.grad is None
        for t, w in zip(got, want):
            w = np.asarray(w)
            np.testing.assert_allclose(t.numpy(), w, rtol=1e-5, atol=1e-5 * np.abs(w).max())


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("shape", [(4, 16, 96), (2, 128), (256, 40), (3, 1152)])
def test_backward_plain_version_matches_jax_kernel_in_interpret_mode(shape, dtype):
    tdt, jdt = DTYPES[dtype]
    x, g, b = _arrays(shape, seed=8)
    dy = np.random.RandomState(9).randn(*shape).astype(np.float32)
    jx, jg, jb, jdy = (jnp.asarray(a).astype(jdt) for a in (x, g, b, dy))
    _, jmean, jrstd = jnk.layer_norm_tpu(jx, jg, jb, 1e-12, interpret=True)
    jdx, jdg, jdb = jnk.layer_norm_bwd_tpu(jx, jg, jmean, jrstd, jdy, interpret=True)
    t = lambda a: torch.tensor(_f32(a)).to(tdt)  # noqa: E731  (bf16 values are exact)
    mean, rstd = torch.tensor(np.asarray(jmean)), torch.tensor(np.asarray(jrstd))
    dx, dg, db = nk.layer_norm_bwd_plain(t(jx), t(jg), mean, rstd, t(jdy), tdt)
    assert (dx.dtype, dg.dtype, db.dtype) == (tdt, tdt, tdt) and tuple(dx.shape) == shape
    for got, want in ((dx, jdx), (dg, jdg), (db, jdb.astype(jdt))):
        got, want = _f32(got), _f32(want)
        ref = float(np.abs(want).max())
        tol = 1e-5 * ref if tdt == torch.float32 else 2 * 2.0 ** (math.floor(math.log2(ref)) - 7)
        assert np.abs(got - want).max() <= tol
    assert nk.layer_norm_bwd_plain(t(jx), t(jg), mean, rstd, t(jdy))[2] is None


def test_backward_takes_strided_dy_and_counts_no_launch_on_cpu():
    """The plain backward takes a non-contiguous dy as it is; on CPU
    tensors the layer norm's backward runs no kernel."""
    x, g, b = (torch.from_numpy(a) for a in _arrays((6, 20), seed=10))
    _, mean, rstd = nk.layer_norm_plain(x, g)
    wide = torch.from_numpy(np.random.RandomState(11).randn(20, 6).astype(np.float32))
    dy = wide.t()                                   # a non-contiguous view
    assert not dy.is_contiguous()
    got = nk.layer_norm_bwd_plain(x, g, mean, rstd, dy, torch.float32)
    dense = nk.layer_norm_bwd_plain(x, g, mean, rstd, dy.contiguous(), torch.float32)
    for a, d in zip(got, dense):
        torch.testing.assert_close(a, d, rtol=1e-5, atol=1e-6)
    before = layer_norm.BWD_LAUNCHES.value
    tx, tg, tb = (t.clone().requires_grad_() for t in (x, g, b))
    nk.fused_layer_norm(tx, tg, tb).backward(dy)
    torch.testing.assert_close(tx.grad, got[0], rtol=1e-5, atol=1e-5)
    assert layer_norm.BWD_LAUNCHES.value == before


@pytest.mark.parametrize("case", ["mean_dtype", "rstd_shape", "dy_dtype", "dy_shape",
                                  "too_wide"])
def test_backward_cuda_inputs_the_kernel_refuses_raise(case):
    """A backward call the kernel does not take raises in the launcher,
    before any launch: there is no fallback to the plain version."""
    F = 9000 if case == "too_wide" else 16
    x, g, _ = (torch.from_numpy(a) for a in _arrays((4, F)))
    mean, rstd, dy = torch.zeros(4), torch.ones(4), torch.ones(4, F)
    if case == "mean_dtype":
        mean = mean.double()
    elif case == "rstd_shape":
        rstd = torch.ones(5)
    elif case == "dy_dtype":
        dy = dy.bfloat16()
    elif case == "dy_shape":
        dy = torch.ones(4, 1, F)
    with pytest.raises(ValueError, match="does not take these inputs"):
        layer_norm.launch_bwd(x, g, mean, rstd, dy)


# ---------------------------------------------------------------------------
# ln_fwd_plan
# ---------------------------------------------------------------------------

H100_SMS = 132
LN_SHAPES = [(8192, 768), (512, 768), (37, 1000), (1, 64), (3, 4096), (8192, 1024),
             (5, 1025), (7, 8192), (4, 2048), (9, 3000), (100000, 128), (37, 100)]
_FWD_SRC = (Path(layer_norm.__file__).resolve().parent / "csrc" / "layer_norm_fwd.cu").read_text()


@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("rows,F", LN_SHAPES)
def test_ln_fwd_plan_covers_every_row_once_and_holds_the_row(rows, F, itemsize):
    tpr, nv, blocks = layer_norm.ln_fwd_plan(rows, F, itemsize, H100_SMS)
    assert tpr in (32, 64, 128, 256)
    assert tpr == 32 if F <= 1024 else tpr * 32 >= F > tpr * 16   # <= 32 elements a thread
    vw = 16 // itemsize
    chunks = -(-F // vw)                                      # 16-byte chunks a row
    need = -(-chunks // tpr)                                  # ... a thread
    instances = sorted({1, 2, 3, 4, min(6, 32 // vw), 32 // vw})
    assert nv == min(i for i in instances if i >= need)     # the smallest that holds it
    groups = 256 // tpr
    # block i, trip k, row group g takes row (i + k * blocks) * groups + g
    seen = np.zeros(rows, np.int64)
    for i in range(blocks):
        base = i * groups
        assert base < rows                                    # no block without a row
        while base < rows:
            seen[base:min(base + groups, rows)] += 1
            base += blocks * groups
    assert (seen == 1).all()
    assert blocks <= layer_norm.fwd_blocks_per_sm(nv) * H100_SMS       # one wave


@pytest.mark.parametrize("itemsize, nv", [(2, 3), (4, 6)])
def test_ln_fwd_plan_fills_the_card_at_bert_base(itemsize, nv):
    plan = layer_norm.ln_fwd_plan(8192, 768, itemsize, H100_SMS)
    assert plan == (32, nv, layer_norm.fwd_blocks_per_sm(nv) * H100_SMS)
    assert plan.blocks * 256 // 32 < 8192                     # rows in a loop: a next row in flight


def test_ln_fwd_plan_mirrors_the_kernels_launch_bound():
    """fwd_blocks_per_sm is the kernel's min_blocks, by its text."""
    expr = re.search(r"constexpr int min_blocks\(int nv\) \{ return (.*?); \}", _FWD_SRC).group(1)
    py = re.sub(r"(nv <= \d+) \? (\d+) :", r"\2 if \1 else", expr)
    for nv in range(1, 9):
        assert eval(py, {"nv": nv}) == layer_norm.fwd_blocks_per_sm(nv)


def test_ln_fwd_wrapper_hands_the_library_its_plan():
    calls = []

    class Lib:
        def dl4j_layer_norm_fwd(self, *args):
            calls.append(args)
            return 0

    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(build, "library", lambda: Lib())
        mp.setattr(layer_norm, "_sm_count", lambda i: H100_SMS)
        mp.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())

        class Stream:
            cuda_stream = 3
        mp.setattr(torch.cuda, "current_stream", lambda d=None: Stream())
        x = torch.zeros(64, 128, 776, dtype=torch.bfloat16)[..., :768]     # strided rows
        y, mean, rstd = layer_norm.launch(x, torch.ones(768, dtype=torch.bfloat16), None, 1e-12)
    finally:
        mp.undo()
    plan = layer_norm.ln_fwd_plan(8192, 768, 2, H100_SMS)
    (args,) = calls
    assert args[2] is None and args[6:13] == (8192, 768, 776, 1e-12, *plan)
    assert y.shape == x.shape and mean.shape == rstd.shape == (8192,)


@pytest.mark.cuda
def test_kernel_matches_plain_version_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    gen = torch.Generator(device="cuda").manual_seed(0)
    for rows, F, pad in [(8192, 768, 0), (37, 1000, 0), (1, 64, 0), (3, 4096, 0), (37, 100, 0),
                         (64, 768, 8), (37, 100, 8)]:
        for dt in (torch.float32, torch.bfloat16):
            # pad > 0: x is a [rows, F] view of [rows, F + pad]
            x = (torch.randn(rows, F + pad, generator=gen, device="cuda") * 2
                 + 0.5).to(dt)[:, :F]
            g = torch.randn(F, generator=gen, device="cuda").to(dt)
            b = torch.randn(F, generator=gen, device="cuda").to(dt)
            before = layer_norm.LAUNCHES.value
            y, mean, rstd = nk.layer_norm_fwd(x, g, b, 1e-12)
            torch.cuda.synchronize()
            assert layer_norm.LAUNCHES.value == before + 1
            # no atomics: the same call gives the same bits
            assert all(torch.equal(a, r) for a, r in
                       zip((y, mean, rstd), nk.layer_norm_fwd(x, g, b, 1e-12)))
            ry, rmean, rrstd = nk.layer_norm_plain(x, g, b, 1e-12)
            ref = ry.float().abs().max().item()
            tol = 1e-4 * ref if dt == torch.float32 else 2 * 2.0 ** (math.floor(math.log2(ref)) - 7)
            assert (y.float() - ry.float()).abs().max().item() <= tol
            assert (rstd - rrstd).abs().max().item() <= 1e-4 * rrstd.abs().max().item()


@pytest.mark.cuda
def test_backward_kernels_match_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    gen = torch.Generator(device="cuda").manual_seed(1)
    for rows, F in [(8192, 768), (37, 1000), (1, 64), (3, 4096), (5, 100)]:
        for dt, gdt in ((torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
                        (torch.bfloat16, torch.float32), (torch.float32, torch.bfloat16)):
            for bias_dtype in (gdt, None):
                x = (torch.randn(rows, F, generator=gen, device="cuda") * 2 + 0.5).to(dt)
                g = torch.randn(F, generator=gen, device="cuda").to(gdt)
                dy = torch.randn(rows, F, generator=gen, device="cuda").to(dt)
                _, mean, rstd = nk.layer_norm_fwd(x, g, None, 1e-12)
                before = layer_norm.BWD_LAUNCHES.value
                got = layer_norm.launch_bwd(x, g, mean, rstd, dy, bias_dtype)
                torch.cuda.synchronize()
                assert layer_norm.BWD_LAUNCHES.value == before + 1
                again = layer_norm.launch_bwd(x, g, mean, rstd, dy, bias_dtype)
                assert all((a is None and b is None) or torch.equal(a, b)
                           for a, b in zip(got, again))      # fixed-order column sums
                want = nk.layer_norm_bwd_plain(x, g, mean, rstd, dy, bias_dtype)
                for a, w in zip(got, want):
                    if w is None:
                        assert a is None
                        continue
                    assert a.dtype == w.dtype and a.shape == w.shape
                    ref = w.float().abs().max().item()
                    tol = (1e-4 * ref if w.dtype == torch.float32
                           else 2 * 2.0 ** (math.floor(math.log2(ref)) - 7))
                    assert (a.float() - w.float()).abs().max().item() <= tol
