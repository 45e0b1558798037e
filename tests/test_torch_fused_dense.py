"""fused_dense of the PyTorch port against the JAX package.

The port's plain version (`fused_dense_reference`, what CPU tensors run)
is held against the JAX Pallas kernel run in interpret mode and against
the JAX reference, on the same numpy inputs made from a seed.  f32 at
rtol/atol 1e-5; bf16 at 2 bf16 ulps of max|ref| (the two frameworks round
the f32 result to bf16 once each, after sums taken in another order).
The dispatch rules and the split-K planner (`gemm_plan`) of the GEMM that
`fused_dense`, `q_matmul` and `int8_matmul` share (`csrc/skinny_gemm.cuh`)
are checked on the CPU, and so is a numpy model of that GEMM's int8 route:
the W stage's 4 x 4 byte transpose, the m16n8k32 fragments its ldmatrix
reads hand each lane, and the int32 split-K sum, exactly against
`xq @ wq`, with every shared-memory access of a warp in distinct banks.
The CUDA kernel itself is checked by the `cuda`-marked test, which skips
without a card.
"""
import torch_test_threads  # noqa: F401  (first: one torch thread a worker)
import math
import re
from pathlib import Path

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


def _compiled_tile(name):
    """(BM, BN, BK) as the CUDA sources declare them: BM in the shared
    header, BN and BK in the kernel's own file."""
    csrc = Path(matmul.__file__).resolve().parent / "csrc"
    consts = {}
    for f in ("skinny_gemm.cuh", f"{name}.cu"):
        for k, v in re.findall(r"constexpr int (BM|BN|BK) = (\d+);",
                               (csrc / f).read_text()):
            consts[k] = int(v)
    return consts["BM"], consts["BN"], consts["BK"]


def test_tiles_match_jax_record_and_table():
    from deeplearning4j_tpu.ops.pallas.tiles import shape_class as jax_shape_class
    for name in ("fused_dense", "q_matmul", "int8_matmul"):
        cfg = tiles.DEFAULT_TILES[name]
        bm, bn, bk = _compiled_tile(name)
        assert (cfg.block_m, cfg.block_n, cfg.block_k) == (bm, bn, bk)
        assert bm == 16                  # every serving bucket, mma's M
        jax_cfg = JaxTileConfig(block_m=bm, block_n=bn, block_k=bk)
        assert cfg.to_json() == jax_cfg.to_json()
        assert tiles.TileConfig.from_json(cfg.to_json()) == cfg
        assert cfg.config_key() == jax_cfg.config_key()
    for dims in (dict(m=16, k=25088, n=4096), dict(m=37, k=70, n=45),
                 dict(n=1, m=1, k=1)):
        assert tiles.shape_class(**dims) == jax_shape_class(**dims)
    assert tiles.shape_class(m=16, k=25088, n=4096) == "k32768-m16-n4096"


#: VGG16's Dense layers (K, N) and a ragged shape
PLAN_SHAPES = {"fc6": (25088, 4096), "fc7": (4096, 4096),
               "output": (4096, 1000), "ragged": (800, 500)}


@pytest.mark.parametrize("kernel", ["fused_dense", "q_matmul", "int8_matmul"])
@pytest.mark.parametrize("layer", list(PLAN_SHAPES))
@pytest.mark.parametrize("M", [1, 2, 4, 8, 16, 37, 128])
def test_gemm_plan_covers_k_once_and_fills_the_card(kernel, layer, M):
    K, N = PLAN_SHAPES[layer]
    plan = matmul.gemm_plan(M, N, K, 132, kernel)
    t = tiles.DEFAULT_TILES[kernel]
    bk = plan.block_k
    assert (plan.block_m, plan.block_n, bk) == (t.block_m, t.block_n, t.block_k)
    S = plan.splits
    assert plan.grid == (-(-N // plan.block_n), S, -(-M // plan.block_m))
    assert len(plan.slices) == S >= 1
    # the slices cover [0, K) exactly once, in order, in whole K steps but
    # the last
    assert plan.slices[0][0] == 0 and plan.slices[-1][1] == K
    for (_, end), (start, _) in zip(plan.slices, plan.slices[1:]):
        assert end == start
    for start, end in plan.slices:
        assert end > start and start % bk == 0
    for start, end in plan.slices[:-1]:
        assert (end - start) % bk == 0
    if M <= 16 and layer != "ragged":
        # two blocks an SM, or one a K step where there are fewer (int8 at
        # the output layer: 8 column tiles x 32 steps of 128)
        ksteps = -(-K // bk)
        assert (plan.grid[0] * plan.grid[1] * plan.grid[2]
                >= min(2 * 132, plan.grid[0] * plan.grid[2] * ksteps))
    assert plan.workspace_bytes == S * M * N * 4


@pytest.mark.parametrize("K, slices", [(0, ((0, 0),)), (5, ((0, 5),)), (32, ((0, 32),)),
                                       (33, ((0, 32), (32, 33)))])
def test_gemm_plan_small_k(K, slices):
    # one SM, one tile: at most BLOCKS_PER_SM = 2 slices, never an empty one
    assert matmul.gemm_plan(3, 45, K, 1, "fused_dense").slices == slices
    # many SMs: one K step (64 rows) a slice
    plan = matmul.gemm_plan(3, 45, K, 132, "q_matmul")
    assert plan.splits == max(1, -(-K // 64)) and plan.slices[-1][1] == K


# ---------------------------------------------------------------------------
# int8 route of skinny_gemm.cuh, modelled in numpy
# ---------------------------------------------------------------------------

WARPS, BN, BM = 4, 128, 16


def _byte_perm(x, y, sel):
    """__byte_perm(x, y, sel) on uint32 arrays: result byte i is byte
    (sel >> 4i) & 7 of the eight bytes x (0-3), y (4-7)."""
    b = np.stack([(x >> (8 * i)) & 0xFF for i in range(4)]
                 + [(y >> (8 * i)) & 0xFF for i in range(4)])
    return sum(b[(sel >> (4 * i)) & 7].astype(np.uint32) << np.uint32(8 * i) for i in range(4))


def _t_offset(n, k, bk):
    """t_offset<BK>: byte of (column n, K byte k) in the transposed tile."""
    c = k >> 4
    return n * bk + ((((c ^ n) & 7) | (c & ~7)) * 16) + (k & 15)


def _distinct_banks(byte_addrs):
    """32 four-byte accesses of one warp instruction hit 32 banks."""
    return len({(a // 4) % 32 for a in byte_addrs}) == 32


def _ldmatrix_x4(mem, addrs):
    """ldmatrix.x4 (16-bit, no .trans) from a byte array: lanes 8m..8m+7
    give the row addresses of matrix m; register m of lane t is bytes
    4(t%4)..4(t%4)+3 of matrix m's row t/4.  Also checks that each
    matrix's 8 rows of 16 bytes sit in 8 bank groups."""
    lane = np.arange(32)
    regs = np.zeros((32, 4, 4), np.uint8)           # lane, register, byte
    for m in range(4):
        rows = addrs[8 * m:8 * m + 8]
        assert len({(a // 16) % 8 for a in rows}) == 8
        base = np.asarray(rows)[lane // 4] + 4 * (lane % 4)
        regs[:, m] = mem[base[:, None] + np.arange(4)]
    return regs.view(np.int8)


def _transpose_stage(stage, bk):
    """transpose_stage<C>: W stage [bk][128] bytes -> [128][bk], swizzled."""
    src = stage.reshape(-1).view(np.uint32)
    dst = np.zeros(BN * bk, np.uint8)
    kb_n, lane = bk // 4, np.arange(32)
    for warp in range(WARPS):
        for it in range(kb_n // WARPS):
            kb = (lane + warp + it * WARPS) & (kb_n - 1)
            r = []
            for j in range(4):
                words = (4 * kb + j) * (BN // 4) + lane
                assert _distinct_banks(4 * words)
                r.append(src[words])
            t0, t1 = _byte_perm(r[0], r[1], 0x5140), _byte_perm(r[2], r[3], 0x5140)
            t2, t3 = _byte_perm(r[0], r[1], 0x7362), _byte_perm(r[2], r[3], 0x7362)
            outs = (_byte_perm(t0, t1, 0x5410), _byte_perm(t0, t1, 0x7632),
                    _byte_perm(t2, t3, 0x5410), _byte_perm(t2, t3, 0x7632))
            for i, o in enumerate(outs):
                offs = _t_offset(4 * lane + i, 4 * kb, bk)
                assert _distinct_banks(offs)
                dst[offs[:, None] + np.arange(4)] = o[:, None].view(np.uint8).reshape(32, 4)
    return dst


def _imma_stage(wt, xs, x_ld, bk, acc):
    """imma_stage<C>: acc[warp][tile] += the m16n8k32 products of the x
    tile and the transposed W tile, as the fragments define them."""
    lane = np.arange(32)
    j, r, g, q = lane >> 3, lane & 7, lane >> 2, lane & 3
    for k32 in range(0, bk, 32):
        a = _ldmatrix_x4(xs, ((j & 1) * 8 + r) * x_ld + k32 + (j >> 1) * 16)
        # a0, a1, a2, a3: rows g, g+8, g, g+8; K bytes 4q.., 4q.., 16+4q.., 16+4q..
        A = np.zeros((16, 32), np.int64)
        for reg, (row, k) in enumerate(((0, 0), (8, 0), (0, 16), (8, 16))):
            A[(g + row)[:, None], (k + 4 * q)[:, None] + np.arange(4)] = a[:, reg]
        for warp in range(WARPS):
            for p in range(BN // WARPS // 16):
                n = warp * (BN // WARPS) + p * 16 + (j >> 1) * 8 + r
                b = _ldmatrix_x4(wt, _t_offset(n, k32 + (j & 1) * 16, bk))
                for h in range(2):
                    # b0, b1 of this n8 tile: column g, K bytes 4q.. and 16+4q..
                    B = np.zeros((32, 8), np.int64)
                    for reg, k in ((2 * h, 0), (2 * h + 1, 16)):
                        B[(k + 4 * q)[:, None] + np.arange(4), g[:, None]] = b[:, reg]
                    acc[warp, 2 * p + h] += A @ B


@pytest.mark.parametrize("M,K,N", [(16, 256, 128), (37, 300, 150), (1, 70, 45)])
def test_int8_route_model_is_exact(M, K, N):
    """The int8 route of skinny_gemm.cuh step by step on the CPU: stages of
    W rows and x columns as load_stage lands them (zero past K, M and N),
    the transpose, the fragments, the partials per K slice of gemm_plan and
    their int32 sum: xq @ wq exactly, ragged M, K and N included."""
    rng = np.random.default_rng(M + K + N)
    xq = rng.integers(-128, 128, size=(M, K), dtype=np.int8)
    wq = rng.integers(-128, 128, size=(K, N), dtype=np.int8)
    plan = matmul.gemm_plan(M, N, K, 4, "int8_matmul")
    bk = plan.block_k
    x_ld = bk + 16
    y = np.zeros((M, N), np.int64)
    for rt in range(plan.grid[2]):
        for ct in range(plan.grid[0]):
            parts = []
            for k0s, k_end in plan.slices:
                acc = np.zeros((WARPS, BN // WARPS // 8, 16, 8), np.int64)
                for k0 in range(k0s, k_end, bk):
                    stage = np.zeros((bk, BN), np.int8)
                    kk = min(k_end, k0 + bk) - k0
                    cols = min(N, (ct + 1) * BN) - ct * BN
                    stage[:kk, :cols] = wq[k0:k0 + kk, ct * BN:ct * BN + cols]
                    xs = np.zeros((BM, x_ld), np.int8)
                    rows = min(M, (rt + 1) * BM) - rt * BM
                    xs[:rows, :kk] = xq[rt * BM:rt * BM + rows, k0:k0 + kk]
                    wt = _transpose_stage(stage.view(np.uint8), bk)
                    _imma_stage(wt, xs.reshape(-1).view(np.uint8), x_ld, bk, acc)
                # acc[warp, tile] covers columns warp*32 + tile*8 .. + 8
                part = acc.transpose(2, 0, 1, 3).reshape(BM, BN)
                assert np.abs(part).max() < 2 ** 31           # an int32 partial
                parts.append(part)
            tile = np.sum(parts, axis=0)                      # s = 0..S-1
            rows = min(M, (rt + 1) * BM) - rt * BM
            cols = min(N, (ct + 1) * BN) - ct * BN
            y[rt * BM:rt * BM + rows, ct * BN:ct * BN + cols] = tile[:rows, :cols]
    np.testing.assert_array_equal(y, xq.astype(np.int64) @ wq.astype(np.int64))


def test_int8_tile_geometry_fits_three_blocks_an_sm():
    """The int8 tile's shared memory (a 3-stage ring of 16 KB W stages and
    padded x tiles, the transposed tile, 1 KB of alignment) lets three
    blocks share an SM's 228 KB, so gemm_plan's grid is resident at once."""
    csrc = Path(matmul.__file__).resolve().parent / "csrc" / "int8_matmul.cu"
    stages = int(re.search(r"constexpr int STAGES = (\d+);", csrc.read_text()).group(1))
    bk = tiles.DEFAULT_TILES["int8_matmul"].block_k
    stage = bk * BN + BM * (bk + 16)
    smem = stages * (-(-stage // 128) * 128) + BN * bk + 1024
    assert 3 * (smem + 1024) <= 228 * 1024
    plan = matmul.gemm_plan(16, 4096, 25088, 132, "int8_matmul")
    assert 2 * 132 <= plan.grid[0] * plan.grid[1] * plan.grid[2] <= 3 * 132


def test_variants_script_edits_the_sources_and_plans_as_the_wrapper(monkeypatch):
    """int8_ln_variants.py's replacements each find their text once in the
    current sources, its split with the chosen knobs is gemm_plan's (and
    leaves the knobs as they were), and it refuses to run without CUDA."""
    import importlib.util
    root = Path(__file__).resolve().parents[1]
    spec = importlib.util.spec_from_file_location("int8_ln_variants_under_test",
                                                  root / "int8_ln_variants.py")
    v = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(v)
    csrc = Path(matmul.__file__).resolve().parent / "csrc"
    for name, (compiled, edits, *_) in {**v.INT8_VARIANTS, **v.LN_VARIANTS}.items():
        assert (csrc / compiled).is_file()
        for fname, old, new in edits:
            assert (csrc / fname).read_text().count(old) == 1 and old != new, (name, fname)
    knobs = (matmul.BLOCKS_PER_SM, tiles.DEFAULT_TILES["int8_matmul"])
    for K, N in PLAN_SHAPES.values():
        want = matmul.gemm_plan(16, N, K, 132, "int8_matmul")
        assert v.int8_splits(matmul, tiles, 16, N, K, 132, matmul.BLOCKS_PER_SM,
                             want.block_k) == want.splits
        v.int8_splits(matmul, tiles, 16, N, K, 132, 4, 256)
        assert (matmul.BLOCKS_PER_SM, tiles.DEFAULT_TILES["int8_matmul"]) == knobs
        assert matmul.gemm_plan(16, N, K, 132, "int8_matmul") == want
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert v.main() == 2


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
    shapes = [(M, 4096, 4096) for M in (1, 2, 4, 8, 16)] + [(37, 70, 45), (16, 800, 500)]
    for M, K, N in shapes:
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
            # split-K sums in a fixed order: the same call gives the same bits
            assert torch.equal(matmul.fused_dense(x, w, b, act), y)
        xb, wb = x.bfloat16(), w.bfloat16()
        y = matmul.fused_dense(xb, wb, b, "relu")
        r = matmul.fused_dense_reference(xb, wb, b, "relu").float()
        assert (y.float() - r).abs().max().item() <= 2 * _bf16_ulp(r.abs().max().item())
        assert torch.equal(matmul.fused_dense(xb, wb, b, "relu"), y)
