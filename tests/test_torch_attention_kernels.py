"""The flash-attention kernels' tiling and f32 arithmetic, on the CPU.

The forward kernel (``csrc/flash_attn_fwd.cu``) and the dQ and dK/dV
kernels (``csrc/flash_attn_bwd.cu``) run only on a card.  What can be held
here:

- their schedules, written out below as the kernels walk them (a forward
  block of ``block_q`` query rows, a warp per 16, over ``block_kv``-row K/V
  tiles below the causal bound, a whole tile at a time; a dQ block of
  ``block_q`` query rows, a warp per 16, over ``block_kv``-row K/V tiles
  in chunks; a dK/dV block of ``block_kv`` keys, a warp per 16, over 64-row
  Q/dO tiles; the causal tile and chunk skips), visit every
  (query, key) pair that the causal triangle keeps exactly once;
- the forward's f32 route, emulated: both products on 3xTF32, the online
  softmax once per K/V tile, each tile's P.V in a fresh accumulator added
  to the rescaled output in f32, in the schedule's order: out and lse stay
  within the card checks' 1e-4 * max|ref| of the f64 plain version
  (``flash_attention_plain``), at a small ragged shape and at T = 512;
- the f32 route, emulated: every product on 3xTF32 (each operand split into
  big, rounded to TF32 to nearest with ties away, and small = the rest,
  truncated to TF32 as the tensor core reads it; small*big + big*small +
  big*big), each chunk's output product summed in a fresh accumulator and
  then added in f32, walked in the schedules' order.  dq, dk and dv stay
  within the card checks' 1e-4 * max|ref| of the f64 plain version
  (``flash_attention_bwd_plain``, itself held to the JAX kernels in
  ``test_torch_attention.py``), at a small ragged shape and at T = 512, and
  well inside the error of one TF32 product;
- the tile records ``DEFAULT_TILES["attention"]`` and
  ``DEFAULT_TILES["attention_bwd"]`` against the JAX package's record
  format and the constants the sources are compiled with;
- ``chip_smoke.py``'s bounds on each kernel's product route, and
  ``attn_variants.py``'s edits of the sources.
"""
import itertools
import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.ops.pallas.tiles import TileConfig as JaxTileConfig
from deeplearning4j_tpu_torch.ops import attention_kernels as ak
from deeplearning4j_tpu_torch.ops.kernels import attention as ka
from deeplearning4j_tpu_torch.ops.kernels import tiles

CSRC = Path(ka.__file__).resolve().parent / "csrc"
SRC = (CSRC / "flash_attn_bwd.cu").read_text()
FWD_SRC = (CSRC / "flash_attn_fwd.cu").read_text()
TILE = tiles.DEFAULT_TILES["attention_bwd"]
FWD_TILE = tiles.DEFAULT_TILES["attention"]
#: the source's tiles: query rows a dQ block (D <= 64), query rows a dK/dV
#: tile, key rows a dK/dV block and a dQ tile
DQ_ROWS, BQ, BK = (int(re.search(rf"constexpr int {name} = (\d+);", SRC).group(1))
                   for name in ("DQ_BLOCK_ROWS", "BQ", "BK"))
#: the forward's tiles: query rows a block (D <= 64), key/value rows a tile
FWD_BQ, FWD_BK = (int(re.search(rf"constexpr int {name} = (\d+);", FWD_SRC).group(1))
                  for name in ("BQ", "BK"))
#: keys (dQ) or queries (dK/dV) a pass of the score products: bf16, f32
CHUNKS = {"bf16": 32, "f32": 16}
NEG_INF = -1e30


def _dq_schedule(T, S, causal, chunk, bq=DQ_ROWS, bk=BK):
    """((row0, row1), (key0, key1)) in the dQ kernel's order: per block of
    bq query rows, per warp of 16 rows, per K/V tile below the causal bound,
    per chunk, stopping where the kernel stops."""
    for q0 in range(0, T, bq):
        nkv = -(-S // bk)
        if causal:
            nkv = min(nkv, (min(q0 + bq, T) - 1) // bk + 1)
        for m0 in range(0, bq, 16):
            row0 = q0 + m0
            for j in range(nkv):
                for kc in range(0, bk, chunk):
                    c0 = j * bk + kc
                    if c0 >= S or row0 >= T or (causal and c0 > row0 + 15):
                        break
                    yield (row0, min(row0 + 16, T)), (c0, min(c0 + chunk, S))


def _dkv_schedule(T, S, causal, chunk, bq=BQ, bk=BK):
    """((key0, key1), (row0, row1)) in the dK/dV kernel's order: per block
    of bk keys, per warp of 16 keys, per Q/dO tile from the causal first,
    per chunk, skipping where the kernel skips."""
    nq = -(-T // bq)
    for k0 in range(0, S, bk):
        first = min(k0 // bq, nq) if causal else 0
        for m0 in range(0, bk, 16):
            key0 = k0 + m0
            for i in range(first, nq):
                for qc in range(0, bq, chunk):
                    r0 = i * bq + qc
                    if r0 >= T or key0 >= S:
                        break
                    if causal and r0 + chunk - 1 < key0:
                        continue
                    yield (key0, min(key0 + 16, S)), (r0, min(r0 + chunk, T))


@pytest.mark.parametrize("route", sorted(CHUNKS))
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("T,S", [(128, 128), (2048, 2048), (77, 77), (37, 200),
                                 (130, 100), (1, 1), (200, 37)])
def test_schedules_visit_each_pair_of_the_triangle_once(T, S, causal, route):
    chunk = CHUNKS[route]
    keep = np.ones((T, S), bool)
    if causal:
        keep = np.arange(S)[None, :] <= np.arange(T)[:, None]
    for name, sched in (("dq", _dq_schedule(T, S, causal, chunk)),
                        ("dkv", _dkv_schedule(T, S, causal, chunk))):
        seen = np.zeros((T, S), np.int32)
        for a, b in sched:
            (r0, r1), (c0, c1) = (a, b) if name == "dq" else (b, a)
            seen[r0:r1, c0:c1] += 1
        assert seen.max() <= 1, name
        assert (seen[keep] == 1).all(), name


def _fwd_schedule(T, S, causal, bq=FWD_BQ, bk=FWD_BK):
    """((row0, row1), (key0, key1)) in the forward kernel's order: per block
    of bq query rows, per warp of 16 rows, per K/V tile below the block's
    causal bound, the tile's keys, skipping (causal) a tile whose keys all
    follow the warp's rows, as the kernel skips."""
    for q0 in range(0, T, bq):
        nkv = -(-S // bk)
        if causal:
            nkv = min(nkv, (min(q0 + bq, T) - 1) // bk + 1)
        for m0 in range(0, bq, 16):
            row0 = q0 + m0
            for j in range(nkv):
                k0 = j * bk
                if row0 >= T or (causal and k0 > row0 + 15):
                    continue
                yield (row0, min(row0 + 16, T)), (k0, min(k0 + bk, S))


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("T,S", [(128, 128), (2048, 2048), (77, 77), (37, 200), (130, 100)])
def test_forward_schedule_visits_each_pair_of_the_triangle_once(T, S, causal):
    keep = np.ones((T, S), bool)
    if causal:
        keep = np.arange(S)[None, :] <= np.arange(T)[:, None]
    seen = np.zeros((T, S), np.int32)
    for (r0, r1), (c0, c1) in _fwd_schedule(T, S, causal):
        seen[r0:r1, c0:c1] += 1
    assert seen.max() <= 1
    assert (seen[keep] == 1).all()


def _tf32_rna(t):
    """Round f32 to TF32 (10 mantissa bits), to nearest with ties away from
    zero, as ``cvt.rna.tf32.f32``."""
    bits = t.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _tf32_trunc(t):
    """f32 with its low 13 bits dropped, as the tensor core reads a TF32
    operand."""
    return (t.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def _split(t):
    """The kernels' split: big rounded to TF32 to nearest, ties away; small
    = t - big (exact), of which the tensor core keeps the top bits."""
    big = _tf32_rna(t)
    return big, _tf32_trunc(t - big)


def _product_3xtf32(a, b):
    """a @ b as the f32 kernels form it: small*big + big*small + big*big,
    each on TF32 operands, summed in f32."""
    (ab, as_), (bb, bs) = _split(a), _split(b)
    return as_ @ bb + ab @ bs + ab @ bb


def _product_1xtf32(a, b):
    return _tf32_rna(a) @ _tf32_rna(b)


def _bias(mask, B, H, S):
    """[B*H, S] key bias: NEG_INF where the keep-mask is 0."""
    if mask is None:
        return torch.zeros(B * H, S)
    return torch.where(mask > 0, 0.0, NEG_INF).to(torch.float32).repeat_interleave(H, 0)


def _emulated(q, k, v, out, lse, g, mask, causal, product):
    """(dq, dk, dv) of the f32 kernels on [B*H, T, D] views: products by
    `product`, p = exp(s - lse), each chunk's output product in a fresh
    accumulator added to the running sum in f32, in the schedules' order."""
    B, H, T, D = q.shape
    S = k.shape[2]
    scale = D ** -0.5
    q, k, v, out, g = (t.reshape(B * H, -1, D) for t in (q, k, v, out, g))
    lse = lse.reshape(B * H, T)
    bias = _bias(mask, B, H, S)
    delta = (g * out).sum(-1)
    chunk = CHUNKS["f32"]
    qi, ki = torch.arange(T), torch.arange(S)

    dq = torch.zeros(B * H, T, D)
    for (r0, r1), (c0, c1) in _dq_schedule(T, S, causal, chunk):
        s = product(q[:, r0:r1], k[:, c0:c1].transpose(1, 2)) * scale + bias[:, None, c0:c1]
        if causal:
            s = s.masked_fill(ki[None, c0:c1] > qi[r0:r1, None], float("-inf"))
        p = torch.exp(s - lse[:, r0:r1, None])
        ds = p * (product(g[:, r0:r1], v[:, c0:c1].transpose(1, 2)) - delta[:, r0:r1, None])
        dq[:, r0:r1] += product(ds, k[:, c0:c1])

    dk, dv = torch.zeros(B * H, S, D), torch.zeros(B * H, S, D)
    for (c0, c1), (r0, r1) in _dkv_schedule(T, S, causal, chunk):
        st = (product(k[:, c0:c1], q[:, r0:r1].transpose(1, 2)) * scale
              + bias[:, c0:c1, None])
        if causal:
            st = st.masked_fill(ki[c0:c1, None] > qi[None, r0:r1], float("-inf"))
        pt = torch.exp(st - lse[:, None, r0:r1])
        dst = pt * (product(v[:, c0:c1], g[:, r0:r1].transpose(1, 2)) - delta[:, None, r0:r1])
        dv[:, c0:c1] += product(pt, g[:, r0:r1])
        dk[:, c0:c1] += product(dst, q[:, r0:r1])
    return tuple(t.reshape(B, H, -1, D) for t in (dq * scale, dk * scale, dv))


@pytest.mark.parametrize("B,H,T,S,D,causal,masked", [
    (2, 2, 37, 70, 40, True, True),       # ragged T, S and D, S > T
    (2, 2, 77, 45, 24, False, True),      # S < T, the mask cuts a tile
    (1, 2, 512, 512, 64, False, True),    # 512-term sums over the keys and queries
    (1, 2, 512, 512, 64, True, False),
])
def test_3xtf32_emulation_keeps_f32_accuracy(B, H, T, S, D, causal, masked):
    rs = np.random.RandomState(12)
    q, k, v, g = (torch.from_numpy(rs.randn(B, H, n, D).astype(np.float32))
                  for n in (T, S, S, T))
    mask = None
    if masked:
        m = np.ones((B, S), np.float32)
        m[0, S - S // 3:] = 0.0
        mask = torch.from_numpy(m)
    out, lse = ak.flash_attention_plain(q, k, v, mask, causal)
    refs = ak.flash_attention_bwd_plain(*(t.double() for t in (q, k, v, out)), lse.double(),
                                        g.double(), None if mask is None else mask.double(),
                                        causal)
    got = _emulated(q, k, v, out, lse, g, mask, causal, _product_3xtf32)
    one = _emulated(q, k, v, out, lse, g, mask, causal, _product_1xtf32)
    for name, a, a1, r in zip(("dq", "dk", "dv"), got, one, refs):
        rmax = r.abs().max().item()
        err = (a.double() - r).abs().max().item()
        err_one = (a1.double() - r).abs().max().item()
        assert err <= 1e-4 * rmax, (name, err / rmax)
        assert err * 10 < err_one, (name, err, err_one)


def _emulated_fwd(q, k, v, mask, causal, product):
    """(out, lse) of the f32 forward kernel on [B*H, T, D] views: both
    products by `product`, each warp's online softmax once per K/V tile of
    the schedule, each tile's P.V in a fresh accumulator added to the
    rescaled output in f32."""
    B, H, T, D = q.shape
    S = k.shape[2]
    scale = D ** -0.5
    q, k, v = (t.reshape(B * H, -1, D) for t in (q, k, v))
    bias = _bias(mask, B, H, S)
    qi, ki = torch.arange(T), torch.arange(S)
    out, lse = torch.zeros(B * H, T, D), torch.zeros(B * H, T)
    for (r0, r1), visits in itertools.groupby(_fwd_schedule(T, S, causal), lambda w: w[0]):
        m = torch.full((B * H, r1 - r0), NEG_INF)
        l = torch.zeros(B * H, r1 - r0)
        acc = torch.zeros(B * H, r1 - r0, D)
        for _, (c0, c1) in visits:
            s = product(q[:, r0:r1], k[:, c0:c1].transpose(1, 2)) * scale + bias[:, None, c0:c1]
            if causal:
                s = s.masked_fill(ki[None, c0:c1] > qi[r0:r1, None], float("-inf"))
            m_new = torch.maximum(m, s.amax(-1))
            corr = torch.exp(m - m_new)
            p = torch.exp(s - m_new[..., None])
            l = corr * l + p.sum(-1)
            acc = acc * corr[..., None] + product(p, v[:, c0:c1])
            m = m_new
        out[:, r0:r1] = acc / l[..., None]
        lse[:, r0:r1] = m + torch.log(l)
    return out.reshape(B, H, T, D), lse


@pytest.mark.parametrize("B,H,T,S,D,causal,masked", [
    (2, 2, 37, 70, 40, True, True),       # ragged T, S and D, S > T
    (2, 2, 77, 45, 24, False, True),      # S < T, the mask cuts a tile
    (1, 2, 512, 512, 64, False, True),    # 512 keys over 8 tiles
    (1, 2, 512, 512, 64, True, False),
])
def test_forward_3xtf32_emulation_keeps_f32_accuracy(B, H, T, S, D, causal, masked):
    rs = np.random.RandomState(13)
    q, k, v = (torch.from_numpy(rs.randn(B, H, n, D).astype(np.float32)) for n in (T, S, S))
    mask = None
    if masked:
        m = np.ones((B, S), np.float32)
        m[0, S - S // 3:] = 0.0
        mask = torch.from_numpy(m)
    ro, rl = ak.flash_attention_plain(*(t.double() for t in (q, k, v)),
                                      None if mask is None else mask.double(), causal)
    got = _emulated_fwd(q, k, v, mask, causal, _product_3xtf32)
    one = _emulated_fwd(q, k, v, mask, causal, _product_1xtf32)
    for name, a, a1, r in zip(("out", "lse"), got, one, (ro, rl)):
        rmax = r.abs().max().item()
        err = (a.double() - r).abs().max().item()
        err_one = (a1.double() - r).abs().max().item()
        assert err <= 1e-4 * rmax, (name, err / rmax)
        assert err * 10 < err_one, (name, err, err_one)


def test_tf32_rounding_is_to_nearest_ties_away():
    one = 1.0
    v = torch.tensor([one, one + 2 ** -11, -(one + 2 ** -11), one + 2 ** -12,
                      one + 3 * 2 ** -11], dtype=torch.float32)
    want = torch.tensor([one, one + 2 ** -10, -(one + 2 ** -10), one, one + 2 ** -9],
                        dtype=torch.float32)
    torch.testing.assert_close(_tf32_rna(v), want, rtol=0, atol=0)


def test_attention_bwd_tile_record_round_trips_and_matches_the_source():
    assert TILE.block_q in (64, 128) and TILE.block_kv in (64, 128)
    assert tiles.TileConfig.from_json(TILE.to_json()) == TILE
    jax_cfg = JaxTileConfig(block_q=TILE.block_q, block_kv=TILE.block_kv)
    assert TILE.to_json() == jax_cfg.to_json()
    assert TILE.config_key() == jax_cfg.config_key()
    assert (DQ_ROWS, BK) == (TILE.block_q, TILE.block_kv)
    assert BQ in (64, 128)
    assert re.search(r"CHUNK = P::BF16 \? (\d+) : (\d+);", SRC).groups() == (
        str(CHUNKS["bf16"]), str(CHUNKS["f32"]))
    assert ka.ROUTES == {torch.float32: "3xtf32", torch.bfloat16: "mma_bf16"}


def test_attention_tile_record_round_trips_and_matches_the_forward_source():
    assert tiles.TileConfig.from_json(FWD_TILE.to_json()) == FWD_TILE
    jax_cfg = JaxTileConfig(block_q=FWD_TILE.block_q, block_kv=FWD_TILE.block_kv)
    assert FWD_TILE.to_json() == jax_cfg.to_json()
    assert FWD_TILE.config_key() == jax_cfg.config_key()
    assert (FWD_BQ, FWD_BK) == (FWD_TILE.block_q, FWD_TILE.block_kv)
    assert FWD_BQ % 16 == 0 and FWD_BK % 16 == 0
    # the tile the plain version's online softmax steps over
    assert re.search(r'bk = DEFAULT_TILES\["attention"\]\.block_kv',
                     Path(ak.__file__).read_text())


def test_forward_launcher_checks_the_compiled_tile_once(monkeypatch):
    """The forward's launcher holds the library's compiled tile to
    ``DEFAULT_TILES["attention"]`` once, and refuses another tile."""
    calls = []

    class Lib:
        def dl4j_flash_attn_tile(self, bq, bk):
            calls.append(1)
            bq._obj.value, bk._obj.value = self.tile

    lib = Lib()
    monkeypatch.setattr(ka, "_tiles_checked", set())
    lib.tile = (FWD_TILE.block_q, FWD_TILE.block_kv)
    ka._check_tile(lib)
    ka._check_tile(lib)
    assert len(calls) == 1
    monkeypatch.setattr(ka, "_tiles_checked", set())
    lib.tile = (FWD_TILE.block_q, FWD_TILE.block_kv * 2)
    with pytest.raises(RuntimeError, match="attention"):
        ka._check_tile(lib)


def test_launchers_check_the_compiled_tile_once(monkeypatch):
    """The backward launchers hold the library's compiled tile to the
    record before their first launch, and refuse a library built for
    another tile.  A stand-in library reports the tiles; no card is
    needed."""
    calls = []

    class Lib:
        def dl4j_flash_attn_bwd_tile(self, bq, bk):
            calls.append(1)
            bq._obj.value, bk._obj.value = self.tile

        dl4j_flash_attn_tile = dl4j_flash_attn_bwd_tile

    lib = Lib()
    monkeypatch.setattr(ka, "_tiles_checked", set())
    lib.tile = (TILE.block_q, TILE.block_kv)
    ka._check_tile(lib, "attention_bwd")
    ka._check_tile(lib, "attention_bwd")
    assert len(calls) == 1
    monkeypatch.setattr(ka, "_tiles_checked", set())
    lib.tile = (TILE.block_q * 2, TILE.block_kv)
    with pytest.raises(RuntimeError, match="attention_bwd"):
        ka._check_tile(lib, "attention_bwd")


def _bf16_ulp(v):
    return 2.0 ** (math.floor(math.log2(max(v, 2.0 ** -126))) - 7)


@pytest.mark.cuda
def test_backward_kernels_repeat_bitwise_and_take_unaligned_rows_on_card():
    """On the card: a base 2 bytes off 16 and a row pitch that is no
    multiple of 16 bytes take the kernels' element copies, within the same
    bounds as the aligned inputs; every call repeats bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    gen = torch.Generator(device="cuda").manual_seed(2)
    for D, dt in ((33, torch.float32), (64, torch.bfloat16), (100, torch.bfloat16)):
        B, H, T, S = 2, 3, 70, 90
        flat = torch.randn(B * H * T * D + 1, generator=gen, device="cuda").to(dt)
        q = flat[1:].view(B, H, T, D)
        k, v = (torch.randn(B, H, S, D, generator=gen, device="cuda").to(dt) for _ in range(2))
        g = torch.randn(B, H, T, D, generator=gen, device="cuda").to(dt)
        for causal in (False, True):
            out, lse = ka.flash_attention(q, k, v, None, causal)
            got = ka.launch_bwd(q, k, v, out, lse, g, None, causal)
            again = ka.launch_bwd(q, k, v, out, lse, g, None, causal)
            want = ak.flash_attention_bwd_plain(q, k, v, out, lse, g, None, causal)
            for a, b, w in zip(got, again, want):
                assert torch.equal(a, b)
                ref = w.float().abs().max().item()
                tol = 1e-4 * ref if dt == torch.float32 else 2 * _bf16_ulp(ref)
                assert (a.float() - w.float()).abs().max().item() <= tol


@pytest.mark.cuda
def test_forward_kernel_repeats_bitwise_and_takes_unaligned_rows_on_card():
    """On the card: a base 2 bytes off 16 and a row pitch that is no
    multiple of 16 bytes take the forward kernel's element copies, within
    the same bounds as aligned inputs; every call repeats bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    gen = torch.Generator(device="cuda").manual_seed(3)
    for D, dt in ((33, torch.float32), (64, torch.bfloat16), (100, torch.bfloat16)):
        B, H, T, S = 2, 3, 70, 90
        flat = torch.randn(B * H * T * D + 1, generator=gen, device="cuda").to(dt)
        q = flat[1:].view(B, H, T, D)
        k, v = (torch.randn(B, H, S, D, generator=gen, device="cuda").to(dt) for _ in range(2))
        mask = torch.ones(B, S, device="cuda", dtype=dt)
        mask[0, -28:] = 0
        for causal in (False, True):
            out, lse = ka.flash_attention(q, k, v, mask, causal)
            again = ka.flash_attention(q, k, v, mask, causal)
            ro, rl = ak.flash_attention_plain(q, k, v, mask, causal)
            assert torch.equal(out, again[0]) and torch.equal(lse, again[1])
            ref = ro.float().abs().max().item()
            tol = 1e-4 * ref if dt == torch.float32 else 2 * _bf16_ulp(ref)
            assert (out.float() - ro.float()).abs().max().item() <= tol
            assert (lse - rl).abs().max().item() <= 1e-4 * rl.abs().max().item()


def _root_module(name):
    import importlib.util

    path = Path(__file__).resolve().parents[1] / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chip_smoke_bounds_count_the_product_route():
    """chip_smoke.py's bound of each backward kernel: bf16 on the tensor
    cores, f32 on 3xTF32 (three TF32 products a product), and the f32 SIMT
    bound of the first design beside them; bytes bound BERT-base at T =
    128, operations at T = 2048."""
    cs = _root_module("chip_smoke")
    want = {  # (kernel, T, dtype, route) -> (ms, bound_by)
        ("flash_attn_bwd_dq", 2048, torch.bfloat16, "mma_bf16"): (0.0782, "operations"),
        ("flash_attn_bwd_dq", 2048, torch.float32, "3xtf32"): (0.4685, "operations"),
        ("flash_attn_bwd_dq", 2048, torch.float32, "simt"): (1.1539, "operations"),
        ("flash_attn_bwd_dkv", 2048, torch.bfloat16, "mma_bf16"): (0.1042, "operations"),
        ("flash_attn_bwd_dkv", 2048, torch.float32, "3xtf32"): (0.6247, "operations"),
        ("flash_attn_bwd_dq", 128, torch.bfloat16, "mma_bf16"): (0.0228, "bytes"),
        ("flash_attn_bwd_dkv", 128, torch.float32, "3xtf32"): (0.0453, "bytes"),
    }
    for (kernel, T, dt, route), (ms, by) in want.items():
        B = 4 if T == 2048 else 64
        got_ms, got_by = cs.attn_bwd_bound(B, 12, T, T, 64, dt, kernel, route)
        assert got_by == by and abs(got_ms - ms) < 1e-4, (kernel, T, dt, route, got_ms)


def test_chip_smoke_forward_bound_counts_the_product_route():
    """chip_smoke.py's bound of the forward kernel: two products, bf16 on
    the tensor cores, f32 on 3xTF32, and the f32 SIMT bound of the first
    design; bytes bound BERT-base at T = 128, operations at T = 2048."""
    cs = _root_module("chip_smoke")
    want = {  # (T, dtype, route) -> (ms, bound_by)
        (128, torch.bfloat16, "mma_bf16"): (0.0151, "bytes"),
        (128, torch.float32, "3xtf32"): (0.0302, "bytes"),
        (2048, torch.bfloat16, "mma_bf16"): (0.0521, "operations"),
        (2048, torch.float32, "3xtf32"): (0.3124, "operations"),
        (2048, torch.float32, "simt"): (0.7692, "operations"),
    }
    for (T, dt, route), (ms, by) in want.items():
        B = 4 if T == 2048 else 64
        got_ms, got_by = cs.attn_bound(B, 12, T, T, 64, dt, route)
        assert got_by == by and abs(got_ms - ms) < 1e-4, (T, dt, route, got_ms)


def test_variants_script_applies_to_the_kernel_source(monkeypatch):
    """attn_variants.py's replacements all find their text in the current
    sources (each variant differs from its file), the forward and the
    backward each have variants, and the script refuses to run without
    CUDA."""
    av = _root_module("attn_variants")
    for name, edits in av.VARIANTS.items():
        for fname, subs in edits:
            src = (CSRC / fname).read_text()
            assert av._source(src, subs) != av._source(src, []), (name, fname)
    assert {f for edits in av.VARIANTS.values() for f, _ in edits} == {av.FWD, av.BWD, av.COMMON}
    with pytest.raises(RuntimeError, match="not found"):
        av._source(SRC, [("no such line", "")])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert av.main() == 2
