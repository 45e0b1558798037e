"""The plans and the split arithmetic of the paged-attention and LayerNorm
backward kernels, on the CPU.

The kernels (``csrc/paged_attention.cu``, ``csrc/layer_norm_bwd.cu``) run
only on a card; what decides their grids and their order of sums is held
here:

- ``paged_plan`` covers every page of a block table exactly once, in
  splits that fall on page boundaries, from the shapes alone (the wrapper
  hands the library the same plan whatever the lengths hold), fills an
  H100's 132 SMs at [16, 12, 64] over 128 pages, and takes D = 16 to 256,
  one-page tables and the small decode configuration's 16 pages;
- the kernel's split-and-combine arithmetic, written out here over the
  plan's grid (q prescaled by sm_scale * log2(e); int8 widened as f32(x) *
  f32(scale); per block, ring tiles of the plan's ``tile_rows`` rows, each
  row group with its own online softmax in the log2 domain, the groups of
  a head merged in group order; an empty split as (-1e30, 0, 0); then the
  splits combined in split order), equals a dense softmax within 1e-12
  relative in f64 and the JAX ``paged_attention(..., interpret=True)``
  within 1e-5 in f32, for f32 and int8 pages, ragged lengths, a length
  that ends on a split boundary and splits that are wholly empty.  This
  holds the plan's grid and the order of the sums; the kernel itself is
  held on the card (``chip_smoke.py``'s paged_parity and the
  ``cuda``-marked test of ``tests/test_torch_decode.py``);
- ``ln_bwd_plan`` covers every row once and fills the card at BERT-base's
  8192 x 768, with each thread holding at most 32 elements of a row and
  the block's row groups fitting its column-sum buffer; the wrapper hands
  the library that plan and partials of its size;
- ``paged_variants.py``'s grids with the chosen knobs are ``paged_plan``'s,
  and each of its source variants edits the kernel's source.
"""
import torch_test_threads  # noqa: F401  (first: one torch thread a worker)
import contextlib
import importlib.util
import inspect
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.ops.pallas import paged_attention as jpa
from deeplearning4j_tpu.ops.quant_kernels import quantize_tensor as jquantize
from deeplearning4j_tpu_torch.ops.kernels import build, layer_norm
from deeplearning4j_tpu_torch.ops.kernels import paged_attention as pa

H100_SMS = 132
ROOT = Path(__file__).resolve().parents[1]


def _splits(plan, max_pages):
    return [(s * plan.pages_per_split, min((s + 1) * plan.pages_per_split, max_pages))
            for s in range(plan.splits)]


# ---------------------------------------------------------------------------
# paged_plan
# ---------------------------------------------------------------------------

PLAN_SHAPES = [(16, 12, 64, 16, 128), (8, 4, 16, 16, 16), (3, 2, 128, 16, 128),
               (1, 1, 256, 16, 1), (2, 12, 64, 8, 1000), (32, 8, 16, 64, 3),
               (1, 2, 64, 16, 4096)]


@pytest.mark.parametrize("kv_itemsize", [1, 2, 4])
@pytest.mark.parametrize("shape", PLAN_SHAPES)
def test_paged_plan_covers_every_page_once_on_page_boundaries(shape, kv_itemsize):
    B, H, D, page, max_pages = shape
    plan = pa.paged_plan(B, H, D, page, max_pages, kv_itemsize, H100_SMS)
    assert 1 <= plan.splits <= pa.MAX_SPLITS and plan.pages_per_split >= 1
    covered = [p for lo, hi in _splits(plan, max_pages) for p in range(lo, hi)]
    assert covered == list(range(max_pages))            # each page once, in order
    assert all(hi > lo for lo, hi in _splits(plan, max_pages))   # no empty split
    assert H % plan.heads == 0 and plan.heads & (plan.heads - 1) == 0
    assert plan.blocks == B * H // plan.heads * plan.splits
    assert plan.tile_rows == pa.tile_rows(D, kv_itemsize)


@pytest.mark.parametrize("kv_itemsize", [1, 2, 4])
def test_paged_plan_puts_two_blocks_on_every_sm_at_the_wide_decode_shape(kv_itemsize):
    plan = pa.paged_plan(16, 12, 64, 16, 128, kv_itemsize, H100_SMS)
    assert plan.blocks >= 2 * H100_SMS
    assert plan.splits > 1


@pytest.mark.parametrize("D", [16, 64, 128, 256])
def test_paged_plan_takes_every_head_dim_one_page_and_the_small_decode_tables(D):
    for itemsize in (1, 2, 4):
        one = pa.paged_plan(2, 3, D, 16, 1, itemsize, H100_SMS)
        assert (one.splits, one.pages_per_split) == (1, 1)
        small = pa.paged_plan(8, 4, D, 16, 16, itemsize, H100_SMS)    # DECODE_SMALL
        assert small.splits * small.pages_per_split >= 16
        rows = pa.tile_rows(D, itemsize)
        assert rows >= 8 and rows & (rows - 1) == 0
        # a row group's lanes hold the row's 16-byte pieces, at most 32 lanes
        lanes = 2 * 128 // rows
        assert lanes >= min(32, -(-D * itemsize // 16))


def test_paged_plan_reads_shapes_only():
    """The plan's arguments are shapes; the wrapper hands the library the
    same plan for two calls whose lengths differ."""
    assert list(inspect.signature(pa.paged_plan).parameters) == [
        "B", "H", "D", "page", "max_pages", "kv_itemsize", "sm_count"]
    calls = []

    class Lib:
        def dl4j_paged_attention_limits(self, *ptrs):
            for p, v in zip(ptrs, (pa.MAX_D, pa.MAX_PAGE, pa.MAX_SPLITS)):
                p._obj.value = v

        def dl4j_paged_attention(self, *args):
            calls.append(args)
            return 0

    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(build, "library", lambda: Lib())
        mp.setattr(pa, "_on_device", lambda d: contextlib.nullcontext())
        mp.setattr(pa, "_current_stream", lambda i: 1)
        mp.setattr(pa, "_sm_count", lambda i: H100_SMS)
        mp.setattr(pa, "_limits_checked", False)
        q = torch.zeros(16, 12, 64)
        k = torch.zeros(40, 16, 12, 64, dtype=torch.int8)
        s = torch.ones(40, 16, 12)
        bt = torch.zeros(16, 128, dtype=torch.int32)
        before = pa.LAUNCHES.value
        for lens in ([1] * 16, [2048] * 16):
            pa.paged_attention(q, k, k, bt, torch.tensor(lens, dtype=torch.int32),
                               k_scales=s, v_scales=s)
    finally:
        mp.undo()
    assert pa.LAUNCHES.value == before + 2
    plan = pa.paged_plan(16, 12, 64, 16, 128, 1, H100_SMS)
    for args in calls:       # B, H, D, page, max_pages, splits, per split, heads
        assert args[10:18] == (16, 12, 64, 16, 128, plan.splits, plan.pages_per_split,
                               plan.heads)
        assert args[8] is not None and args[9] is not None          # workspace, counters


# ---------------------------------------------------------------------------
# the split-and-combine arithmetic against a dense softmax and the JAX kernel
# ---------------------------------------------------------------------------

NEG_INF = -1e30
LOG2E = 1.4426950408889634
ROWS_PER_GROUP = 2       # rows a row group takes from each ring stage (the source's)


def _widen(x, s, dtype):
    """Page rows as the kernel widens them: int8 as f32(x) * f32(scale),
    rounded in f32 (``__fmul_rn``), other dtypes cast."""
    x = x if s is None else (x.astype(np.float32) * s[..., None]).astype(np.float32)
    return x.astype(dtype)


def _split_partial(qs, kb, vb, t0, t1, plan, dtype):
    """One block's (m, l, acc) per head of its group over tokens [t0, t1):
    ring tiles of ``plan.tile_rows`` rows (row r: token r // heads, head
    r % heads); row group g takes rows g + i * groups of each tile and keeps
    its own online softmax; then each head's groups merged in group order,
    scaled to their common max."""
    f = np.dtype(dtype).type
    G, rows = plan.heads, plan.tile_rows
    groups = rows // ROWS_PER_GROUP
    D = qs.shape[-1]
    m = np.full(groups, f(NEG_INF))
    l = np.zeros(groups, dtype)
    acc = np.zeros((groups, D), dtype)
    head = np.arange(groups) % G                               # a group's head
    for tok in range(t0, t1, rows // G):
        r = np.arange(rows).reshape(ROWS_PER_GROUP, groups)    # [i, group]
        t = tok + r // G
        valid = t < t1
        tc = np.minimum(t, t1 - 1)
        s = np.einsum("igd,gd->ig", kb[tc, head[None, :]], qs[head])
        m_new = np.maximum(m, np.where(valid, s, f(NEG_INF)).max(axis=0))
        corr = np.exp2(m - m_new)
        l *= corr
        acc *= corr[:, None]
        for i in range(ROWS_PER_GROUP):
            w = np.where(valid[i], np.exp2(np.where(valid[i], s[i], m_new) - m_new), f(0))
            l += w
            acc += w[:, None] * vb[tc[i], head]
        m = m_new
    parts = []
    for k in range(G):
        mine = np.arange(k, groups, G)                         # group order
        M = m[mine].max()
        L, a = f(0), np.zeros(D, dtype)
        for g in mine:
            c = np.exp2(m[g] - M)
            L += l[g] * c
            a += acc[g] * c
        parts.append((M, L, a))
    return parts


def _split_combine(q, k, v, bt, lens, plan, page, dtype, scales=None):
    """The kernel's arithmetic over the plan's grid, in `dtype`: q scaled
    by sm_scale * log2(e); per (b, head group, split) block the partials of
    `_split_partial`, an empty split (NEG_INF, 0, 0); then each head's
    splits combined in split order (one split: its partial divided
    out)."""
    B, H, D = q.shape
    max_pages = bt.shape[1]
    f = np.dtype(dtype).type
    ks, vs = scales or (None, None)
    kf = _widen(k, ks, dtype).reshape(-1, H, D)
    vf = _widen(v, vs, dtype).reshape(-1, H, D)
    qs = q.astype(dtype) * (f(1 / np.sqrt(D)) * f(LOG2E))
    out = np.zeros((B, H, D), dtype)
    for b in range(B):
        n = min(int(lens[b]), max_pages * page)
        rows = np.arange(max_pages * page)
        phys = bt[b, rows // page] * page + rows % page
        kb, vb = kf[phys], vf[phys]                            # [tokens, H, D]
        for h0 in range(0, H, plan.heads):
            hs = slice(h0, h0 + plan.heads)
            parts = []
            for lo, hi in _splits(plan, max_pages):
                t0, t1 = lo * page, min(hi * page, n)
                if t0 >= t1:
                    parts.append([(f(NEG_INF), f(0), np.zeros(D, dtype))] * plan.heads)
                else:
                    parts.append(_split_partial(qs[b, hs], kb[:, hs], vb[:, hs], t0, t1,
                                                plan, dtype))
            for k_ in range(plan.heads):
                if plan.splits == 1:
                    _, L, a = parts[0][k_]
                    out[b, h0 + k_] = a / max(L, f(1e-37))
                    continue
                M = max(p[k_][0] for p in parts)
                L, a = f(0), np.zeros(D, dtype)
                for p in parts:                                # split order
                    w = np.exp2(p[k_][0] - M)
                    L += p[k_][1] * w
                    a += p[k_][2] * w
                out[b, h0 + k_] = a / max(L, f(1e-37))
    return out


def _dense(q, k, v, bt, lens, page):
    """Softmax over each sequence's whole history, in f64."""
    B, H, D = q.shape
    out = np.zeros((B, H, D))
    for b in range(B):
        rows = np.arange(int(lens[b]))
        phys = bt[b, rows // page] * page + rows % page
        kb = k.reshape(-1, H, D)[phys].astype(np.float64)
        vb = v.reshape(-1, H, D)[phys].astype(np.float64)
        for h in range(H):
            s = kb[:, h] @ q[b, h].astype(np.float64) / np.sqrt(D)
            w = np.exp(s - s.max())
            out[b, h] = w @ vb[:, h] / w.sum()
    return out


def _inputs(B, H, D, page, max_pages, lens, int8, seed):
    rng = np.random.default_rng(seed)
    n_pages = sum(-(-n // page) for n in lens) + 2
    q = rng.standard_normal((B, H, D)).astype(np.float32)
    k = rng.standard_normal((n_pages, page, H, D)).astype(np.float32)
    v = rng.standard_normal((n_pages, page, H, D)).astype(np.float32)
    bt = np.zeros((B, max_pages), np.int32)
    used = iter(rng.permutation(n_pages))
    for b, n in enumerate(lens):
        bt[b, :-(-n // page)] = [next(used) for _ in range(-(-n // page))]
    scales = None
    if int8:
        qk, qv = jquantize(k.reshape(-1, D), axis=0), jquantize(v.reshape(-1, D), axis=0)
        k = np.asarray(qk.q).reshape(k.shape)
        v = np.asarray(qv.q).reshape(v.shape)
        scales = (np.asarray(qk.scale).reshape(n_pages, page, H),
                  np.asarray(qv.scale).reshape(n_pages, page, H))
    return q, k, v, bt, np.asarray(lens, np.int32), scales


# (B, H, D, page, max_pages, lengths): the plan's split length is
# pages_per_split * page tokens; `_edge_lens` puts lengths on a boundary
SPLIT_CASES = {
    "ragged": (4, 2, 64, 8, 12, [1, 17, 30, 48]),
    "edges_wide_table": (5, 2, 64, 16, 40, None),
    "d64_long": (2, 2, 64, 8, 32, [129, 256]),
}


def _case(name, int8):
    B, H, D, page, max_pages, lens = SPLIT_CASES[name]
    plan = pa.paged_plan(B, H, D, page, max_pages, 1 if int8 else 4, H100_SMS)
    if lens is None:      # on a split boundary, one past it, and whole splits empty
        per = plan.pages_per_split * page
        lens = [per, per + 1, 1, 2 * per - 1, page]
        assert plan.splits >= 3
    args = _inputs(B, H, D, page, max_pages, lens, int8, seed=len(name))
    return plan, page, args


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("name", sorted(SPLIT_CASES))
def test_split_combine_in_f64_equals_a_dense_softmax(name, int8):
    plan, page, (q, k, v, bt, lens, scales) = _case(name, int8)
    got = _split_combine(q, k, v, bt, lens, plan, page, np.float64, scales)
    ks, vs = scales or (None, None)
    want = _dense(q, _widen(k, ks, np.float64), _widen(v, vs, np.float64), bt, lens, page)
    assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max()
    if name == "edges_wide_table":   # some split of some sequence is wholly past its length
        assert any(lo * page >= n for n in lens for lo, _ in _splits(plan, bt.shape[1]))


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("name", sorted(SPLIT_CASES))
def test_split_combine_in_f32_matches_the_jax_kernel_in_interpret_mode(name, int8):
    plan, page, (q, k, v, bt, lens, scales) = _case(name, int8)
    ks, vs = scales or (None, None)
    want = np.asarray(jpa.paged_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(bt), jnp.asarray(lens),
        k_scales=None if ks is None else jnp.asarray(ks),
        v_scales=None if vs is None else jnp.asarray(vs), interpret=True))
    got = _split_combine(q, k, v, bt, lens, plan, page, np.float32, scales)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())
    # and the port's plain version, on the same inputs
    t = [None if a is None else torch.from_numpy(np.asarray(a)) for a in (q, k, v, bt, lens)]
    plain = pa.paged_attention_plain(*t, k_scales=None if ks is None else torch.from_numpy(ks),
                                     v_scales=None if vs is None else torch.from_numpy(vs))
    np.testing.assert_allclose(got, plain.numpy(), rtol=1e-5, atol=1e-5 * np.abs(want).max())


# ---------------------------------------------------------------------------
# ln_bwd_plan
# ---------------------------------------------------------------------------

LN_SHAPES = [(8192, 768), (512, 768), (37, 1000), (1, 64), (3, 4096), (8192, 1024),
             (5, 1025), (7, 8192), (4, 2048), (9, 3000), (100000, 128)]


@pytest.mark.parametrize("rows,F", LN_SHAPES)
def test_ln_bwd_plan_covers_every_row_once(rows, F):
    plan = layer_norm.ln_bwd_plan(rows, F, H100_SMS)
    tpr, per, blocks = plan
    assert tpr in (32, 64, 128, 256)
    assert tpr * 32 >= F                                  # <= 32 elements a thread
    assert (256 // tpr) * F <= 8192                       # the column-sum buffer
    assert per >= 256 // tpr                              # a row per row group at least
    starts = [i * per for i in range(blocks)]
    assert starts[-1] < rows <= blocks * per              # no empty block, none missing
    covered = sum(min(s + per, rows) - s for s in starts)
    assert covered == rows


def test_ln_bwd_plan_fills_the_card_at_bert_base():
    plan = layer_norm.ln_bwd_plan(8192, 768, H100_SMS)
    assert plan.threads_per_row == 32
    assert H100_SMS <= plan.blocks <= layer_norm.BWD_BLOCKS_PER_SM * H100_SMS


def test_ln_bwd_wrapper_hands_the_library_its_plan():
    calls = []

    class Lib:
        def dl4j_layer_norm_bwd(self, *args):
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
        x = torch.zeros(64, 128, 768)
        g = torch.ones(768)
        dx, dg, db = layer_norm.launch_bwd(x, g, torch.zeros(8192), torch.ones(8192),
                                           torch.zeros(64, 128, 768), torch.float32)
    finally:
        mp.undo()
    plan = layer_norm.ln_bwd_plan(8192, 768, H100_SMS)
    (args,) = calls
    assert args[9:16] == (8192, 768, 768, 768, plan.threads_per_row, plan.rows_per_block,
                          plan.blocks)
    assert dx.shape == x.shape and dg.shape == db.shape == (768,)


# ---------------------------------------------------------------------------
# chip_smoke.py's split-edge lengths
# ---------------------------------------------------------------------------

def test_chip_smoke_split_edge_lengths_sit_on_the_plans_boundaries():
    cs = _load("chip_smoke")
    for itemsize in (1, 2, 4):
        plan = pa.paged_plan(16, 12, 64, cs.PAGE, cs.ENGINE_MAX_PAGES, itemsize, H100_SMS)
        lens = cs._split_edge_lens(plan, 16)
        per = plan.pages_per_split * cs.PAGE
        assert len(lens) == 16 and all(1 <= n <= 2048 for n in lens)
        for k in range(1, plan.splits):
            assert {k * per - 1, k * per, k * per + 1} <= set(lens)
        # some sequence leaves its later splits wholly empty
        assert min(lens) <= per * (plan.splits - 1)


# ---------------------------------------------------------------------------
# paged_variants.py
# ---------------------------------------------------------------------------

def _load(name):
    spec = importlib.util.spec_from_file_location(f"{name}_under_test", ROOT / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("kv_itemsize", [1, 2, 4])
def test_variants_script_plan_with_the_chosen_knobs_is_paged_plan(kv_itemsize):
    pv = _load("paged_variants")
    for B, H, D, page, max_pages in PLAN_SHAPES:
        want = pa.paged_plan(B, H, D, page, max_pages, kv_itemsize, H100_SMS)
        got = pv.plan(pa, B, H, D, page, max_pages, kv_itemsize, H100_SMS,
                      pa.HEADS_PER_BLOCK, pa.BLOCKS_PER_SM)
        assert got == want
    grids = {pv.plan(pa, 16, 12, 64, 16, 128, kv_itemsize, H100_SMS, h, n)
             for h in pv.HEADS for n in pv.BLOCKS_PER_SM}
    assert len(grids) > 1                       # the knobs change the grid


def test_variants_script_edits_apply_to_the_kernel_source():
    pv = _load("paged_variants")
    text = (build.CSRC / pv.SOURCE).read_text()
    for name, subs in pv.VARIANTS.items():
        edited = pv.source(text, subs)
        assert edited != text, name
    with pytest.raises(RuntimeError):
        pv.source(text, [("no such line", "")])
