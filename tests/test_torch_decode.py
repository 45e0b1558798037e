"""Paged-KV decode of the PyTorch port against the JAX package.

Bottom up, each on the same numpy inputs made from seeds:

- ``KVBlockAllocator`` and ``PagedKVCache``: the JAX package's cases, and
  pages, scales and block tables equal to the JAX cache's after the same
  writes (int8 pages bitwise: the port quantizes a write's rows at once on
  the device, the JAX package token by token in numpy);
- ``paged_attention_plain`` against JAX's ``paged_attention`` in interpret
  mode and its reference: f32 ragged, int8 pages, a length-one sequence,
  and D = 64 over 1,024+ tokens, within 2e-5 (sums in another order);
- ``TinyDecodeModel``'s prefill, decode_qkv and decode_out from the same
  seed: the weights bitwise, the outputs within 1e-5 of max|ref|;
- ``DecodeEngine``: generated tokens equal to the JAX engine's for the
  same prompts with f32 and int8 KV, and the engine's own contracts
  (no new shape after warmup, mid-flight admit/retire, cancel,
  exhaustion sheds, oversize prompts refused).

The CUDA kernel is held to its plain version by the ``cuda``-marked test
(the cases above and lengths on its split boundaries, each call repeated
bit for bit), which skips without a card.
"""
import threading
import time
from concurrent.futures import Future

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.ops.pallas import paged_attention as jpa
from deeplearning4j_tpu.ops.quant_kernels import quantize_tensor as jquantize
from deeplearning4j_tpu.serving import decode as jdec
from deeplearning4j_tpu_torch import convert
from deeplearning4j_tpu_torch.ops.kernels import dispatch
from deeplearning4j_tpu_torch.ops.kernels import paged_attention as pa
from deeplearning4j_tpu_torch.serving import decode as tdec
from deeplearning4j_tpu_torch.serving.batcher import RejectedError


@pytest.fixture(autouse=True)
def _auto_mode():
    prev = dispatch.set_dispatch_mode("auto")
    yield
    dispatch.set_dispatch_mode(prev)


def _random_paged(B=3, H=2, D=64, page=8, n_pages=16, max_pages=4,
                  dtype="f32", seed=0, seq_lens=None):
    """Random paged-attention inputs with ragged lengths (the JAX test's)."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, D)).astype(np.float32)
    k = rng.standard_normal((n_pages, page, H, D)).astype(np.float32)
    v = rng.standard_normal((n_pages, page, H, D)).astype(np.float32)
    if seq_lens is None:
        seq_lens = [1, page * max_pages // 2 + 3, page * max_pages][:B]
    seq_lens = np.array(seq_lens, np.int32)
    bt = np.zeros((B, max_pages), np.int32)
    used = iter(rng.permutation(n_pages))      # distinct physical pages
    for b in range(B):
        n = -(-int(seq_lens[b]) // page)
        bt[b, :n] = [next(used) for _ in range(n)]
    if dtype == "int8":
        ks = np.ones((n_pages, page, H), np.float32)
        vs = np.ones((n_pages, page, H), np.float32)
        k8 = np.zeros((n_pages, page, H, D), np.int8)
        v8 = np.zeros((n_pages, page, H, D), np.int8)
        for p in range(n_pages):
            for s in range(page):
                for src, dq, ds in ((k, k8, ks), (v, v8, vs)):
                    qt = jquantize(src[p, s], axis=0)
                    dq[p, s] = np.asarray(qt.q)
                    ds[p, s] = np.asarray(qt.scale).reshape(-1)
        return q, k8, v8, bt, seq_lens, ks, vs
    return q, k, v, bt, seq_lens, None, None


def _both(args):
    t = [None if a is None else torch.from_numpy(np.asarray(a)) for a in args]
    j = [None if a is None else jnp.asarray(a) for a in args]
    return t, j


# ---------------------------------------------------------------------------
# Allocator and cache
# ---------------------------------------------------------------------------

class TestKVBlockAllocator:
    def test_alloc_free_roundtrip(self):
        a = tdec.KVBlockAllocator(8)
        blocks = a.alloc(5)
        assert len(blocks) == len(set(blocks)) == 5
        assert a.in_use == 5 and a.free_count == 3
        a.free(blocks[:2])
        assert a.in_use == 3 and a.free_count == 5 and a.high_water == 5

    def test_exhaustion_is_all_or_nothing(self):
        a = tdec.KVBlockAllocator(4)
        a.alloc(3)
        with pytest.raises(tdec.KVCacheExhausted):
            a.alloc(2)
        assert a.free_count == 1 and len(a.alloc(1)) == 1
        assert issubclass(tdec.KVCacheExhausted, RejectedError)

    def test_double_free_raises(self):
        a = tdec.KVBlockAllocator(4)
        b = a.alloc(2)
        a.free(b)
        with pytest.raises(ValueError, match="double free"):
            a.free([b[0]])

    def test_same_pages_as_jax_in_any_free_order(self):
        a, j = tdec.KVBlockAllocator(6), jdec.KVBlockAllocator(6)
        ba, bj = a.alloc(6), j.alloc(6)
        assert ba == bj
        for alloc in (a, j):
            alloc.free([ba[1], ba[4], ba[2]])
        assert a.alloc(3) == j.alloc(3)
        assert a.in_use == j.in_use == 6


class TestPagedKVCache:
    def test_write_append_and_block_tables(self):
        c = tdec.PagedKVCache(num_blocks=8, page_size=4, n_heads=2, head_dim=8,
                              device="cpu")
        c.allocate(7)
        kv = np.random.default_rng(0).standard_normal((6, 2, 8))
        c.write(7, kv, kv)
        assert c.seq_len(7) == 6 and c.blocks_in_use == 2
        c.write(7, kv[:2], kv[:2])       # fills page 2 exactly
        assert c.seq_len(7) == 8 and c.blocks_in_use == 2
        c.write(7, kv[:1], kv[:1])       # spills into a third page
        assert c.blocks_in_use == 3
        bt, sl = c.block_tables([7], rows=2, max_pages=4)
        assert bt.shape == (2, 4) and sl.tolist() == [9, 1]
        assert (bt[1] == 0).all()
        c.free_seq(7)
        assert c.blocks_in_use == 0

    def test_atomic_write_on_exhaustion(self):
        c = tdec.PagedKVCache(num_blocks=2, page_size=4, n_heads=2, head_dim=8,
                              device="cpu")
        c.allocate(1)
        kv = np.zeros((12, 2, 8), np.float32)
        with pytest.raises(tdec.KVCacheExhausted):
            c.write(1, kv, kv)
        assert c.seq_len(1) == 0
        c.write(1, kv[:8], kv[:8])
        assert c.seq_len(1) == 8

    @pytest.mark.parametrize("dtype", ["f32", "int8"])
    def test_pages_scales_and_tables_equal_jax(self, dtype):
        rng = np.random.default_rng(1)
        kw = dict(num_blocks=10, page_size=4, n_heads=3, head_dim=8, dtype=dtype)
        t, j = tdec.PagedKVCache(device="cpu", **kw), jdec.PagedKVCache(**kw)
        for c in (t, j):
            c.allocate(0)
            c.allocate(1)
        writes = [(0, 5), (1, 3), (0, 1), (1, 6), (0, 4)]
        for sid, n in writes:
            k = (rng.standard_normal((n, 3, 8)) * 2.5).astype(np.float32)
            v = (rng.standard_normal((n, 3, 8)) * 0.3).astype(np.float32)
            k[0, 1] = 0.0                                     # a zero row
            t.write(sid, k, v)
            j.write(sid, k, v)
        for got, want in zip(t.pages(), j.pages()):
            np.testing.assert_array_equal(got.numpy(), want)
        for args in (([0, 1], 3, 5), ([1], 2, 4)):
            for got, want in zip(t.block_tables(*args), j.block_tables(*args)):
                np.testing.assert_array_equal(got, want)
        assert t.bytes_per_block == j.bytes_per_block
        assert t.bytes_in_use == j.bytes_in_use

    def test_int8_block_costs_under_quarter_of_f32(self):
        f32 = tdec.PagedKVCache(4, page_size=16, n_heads=4, head_dim=64, device="cpu")
        i8 = tdec.PagedKVCache(4, page_size=16, n_heads=4, head_dim=64, dtype="int8",
                               device="cpu")
        assert i8.bytes_per_block < f32.bytes_per_block / 3.5
        assert i8.bytes_per_block == 2 * 16 * 4 * 64 + 2 * 16 * 4 * 4


# ---------------------------------------------------------------------------
# paged attention: the plain version against the JAX kernel and reference
# ---------------------------------------------------------------------------

PAGED_CASES = {
    "f32_ragged": dict(),
    "int8": dict(dtype="int8", seed=3),
    "length_one": dict(B=1, seed=7, seq_lens=[1]),
    "d64_long": dict(B=2, H=2, D=64, page=16, n_pages=150, max_pages=72,
                     seed=11, seq_lens=[1031, 1100]),
}


@pytest.mark.parametrize("case", sorted(PAGED_CASES))
def test_plain_matches_jax_kernel_and_reference(case):
    args = _random_paged(**PAGED_CASES[case])
    (q, k, v, bt, sl, ks, vs), (jq, jk, jv, jbt, jsl, jks, jvs) = _both(args)
    got = pa.paged_attention_plain(q, k, v, bt, sl, k_scales=ks, v_scales=vs)
    assert got.dtype == torch.float32 and got.shape == q.shape
    for want in (jpa.paged_attention_reference(jq, jk, jv, jbt, jsl,
                                               k_scales=jks, v_scales=jvs),
                 jpa.paged_attention(jq, jk, jv, jbt, jsl, k_scales=jks,
                                     v_scales=jvs, interpret=True)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)


def test_supports_and_dispatch_rules(monkeypatch):
    q, k, v, bt, sl, _, _ = _both(_random_paged())[0]
    assert pa.paged_supports(q, k, v, bt, sl)
    assert not pa.paged_supports(q[0], k, v, bt, sl)             # q is [B, H, D]
    assert not pa.paged_supports(q.double(), k, v, bt, sl)
    q8, k8, v8, bt8, sl8, ks, vs = _both(_random_paged(dtype="int8"))[0]
    assert pa.paged_supports(q8, k8, v8, bt8, sl8, k_scales=ks, v_scales=vs)
    assert not pa.paged_supports(q8, k8, v8, bt8, sl8)           # scaleless int8
    big = torch.zeros(2, 4, 2, pa.MAX_D + 1)
    assert not pa.paged_supports(big[:, 0], big, big, bt[:2], sl[:2])
    before = pa.LAUNCHES.value
    tdec.paged_attn(q, k, v, bt, sl)                             # CPU: plain
    assert pa.LAUNCHES.value == before
    monkeypatch.setattr(dispatch, "_devices",
                        lambda args, kwargs: {torch.device("cuda", 0)})
    with pytest.raises(ValueError, match="does not take these inputs"):
        tdec.paged_attn(q8, k8, v8, bt8, sl8)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

def _models(**kw):
    kw = dict(dict(vocab=48, d_model=32, n_heads=2, seed=0), **kw)
    return tdec.TinyDecodeModel(device="cpu", **kw), jdec.TinyDecodeModel(**kw)


def _close(got, want):
    want = np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got.detach().numpy() - want).max() <= 1e-5 * np.abs(want).max()


def test_tiny_model_weights_and_functions_equal_jax():
    tm, jm = _models()
    tree = convert.decode_params_to_jax(tm)
    for name, w in jm.params_.items():
        np.testing.assert_array_equal(tree[name], np.asarray(w))
    rng = np.random.default_rng(5)
    tokens = rng.integers(1, 48, size=(3, 16)).astype(np.int32)
    lens = np.array([16, 9, 1], np.int32)
    tokens[1, 9:] = 0
    tokens[2, 1:] = 0
    got = tm.prefill(torch.from_numpy(tokens), torch.from_numpy(lens))
    want = jm.prefill(jnp.asarray(tokens), jnp.asarray(lens))
    for i, (g, w) in enumerate(zip(got, want)):
        if i == 0:
            _close(g, w)
        else:       # k, v: only the rows inside each prompt are used
            for b, n in enumerate(lens):
                _close(g[b, :n], np.asarray(w)[b, :n])
    step = rng.integers(0, 48, size=5)
    for g, w in zip(tm.decode_qkv(torch.from_numpy(step)), jm.decode_qkv(jnp.asarray(step))):
        _close(g, w)
    attn = rng.standard_normal((5, 2, 16)).astype(np.float32)
    _close(tm.decode_out(torch.from_numpy(attn)), jm.decode_out(jnp.asarray(attn)))


def test_decode_params_cross_from_jax():
    tm, _ = _models(seed=1)
    _, jm = _models(seed=2)
    convert.decode_params_from_jax(tm, {k: np.asarray(v) for k, v in jm.params_.items()})
    tree = convert.decode_params_to_jax(tm)
    for name, w in jm.params_.items():
        np.testing.assert_array_equal(tree[name], np.asarray(w))


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

def _engine(model=None, **kw):
    kw.setdefault("num_blocks", 64)
    kw.setdefault("max_seq_len", 64)
    kw.setdefault("max_decode_batch", 4)
    kw.setdefault("model_label", "t")
    return tdec.DecodeEngine(model if model is not None else _models()[0], **kw)


@pytest.mark.parametrize("kv_dtype", ["f32", "int8"])
def test_engine_tokens_equal_jax(kv_dtype):
    tm, jm = _models()
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, 48, size=n) for n in (1, 2, 7, 9, 20, 33)]
    news = [5, 3, 8, 2, 6, 4]
    got, want = [], []
    for out, eng in ((got, _engine(tm, kv_dtype=kv_dtype)),
                     (want, jdec.DecodeEngine(jm, num_blocks=64, max_seq_len=64,
                                              max_decode_batch=4, kv_dtype=kv_dtype,
                                              model_label="j"))):
        try:
            futs = [eng.submit(p, max_new_tokens=n) for p, n in zip(prompts, news)]
            out += [f.result(timeout=120).tolist() for f in futs]
        finally:
            eng.shutdown(drain=False)
    assert got == want
    assert [len(g) for g in got] == news


def test_skewed_flood_meets_no_new_shape_after_warmup():
    eng = _engine()
    try:
        warm = eng.warmup()
        assert warm == eng.fresh_compiles() == len(eng.prompt_buckets) + len(eng.batch_buckets)
        rng = np.random.default_rng(0)
        futs = [eng.submit(rng.integers(1, 48, size=n), max_new_tokens=3)
                for n in (1, 2, 7, 8, 9, 20, 31, 33, 50)]
        for f in futs:
            f.result(timeout=60)
        assert eng.fresh_compiles() == warm
        assert eng.decode_steps >= 2 and eng.stats()["decode_steps"] == eng.decode_steps
        assert eng.prompt_buckets == [8, 16, 32, 64] and eng.batch_buckets == [1, 2, 4]
    finally:
        eng.shutdown(drain=False)


def test_mid_flight_admit_and_retire():
    eng = _engine(max_decode_batch=2)
    try:
        eng.warmup()
        futs = [eng.submit(np.arange(1, 4), max_new_tokens=n)
                for n in (2, 12, 3, 9, 2, 5)]
        outs = [f.result(timeout=60) for f in futs]
        assert [len(o) for o in outs] == [2, 12, 3, 9, 2, 5]
        assert eng.cache.blocks_in_use == 0 and eng.queue_depth == 0
        # same prompt, same greedy tokens, whatever the batch around it
        assert [o[:2].tolist() for o in outs[1:]] == [outs[0].tolist()] * 5
    finally:
        eng.shutdown(drain=False)


def test_cancel_waiting_and_active():
    eng = _engine(max_decode_batch=1)
    # The worker is held after its first decode step until both cancels are
    # in: `long` is then certain to be active, with tokens still to go, and
    # `waiting` to be queued behind it (a loaded host could otherwise finish
    # `long` first).  Waiting on the engine's condition releases its lock.
    stepped, release = threading.Event(), threading.Event()
    step = eng._step_locked

    def step_then_hold():
        step()
        stepped.set()
        while not release.is_set():
            eng._cond.wait(timeout=0.01)

    try:
        eng.warmup()
        eng._step_locked = step_then_hold
        long = eng.submit(np.arange(1, 4), max_new_tokens=40)
        assert stepped.wait(timeout=60)
        waiting = eng.submit(np.arange(1, 4), max_new_tokens=40)
        assert eng.cancel(waiting) is True and waiting.cancelled()
        assert eng.cancel(long) is True
        release.set()
        deadline = time.monotonic() + 5
        while eng.cache.blocks_in_use and time.monotonic() < deadline:
            time.sleep(0.01)
        assert eng.cache.blocks_in_use == 0
        assert eng.cancel(Future()) is False
    finally:
        release.set()
        eng.shutdown(drain=False)


def test_exhaustion_sheds_not_crashes():
    eng = _engine(num_blocks=2, page_size=16, max_seq_len=64, max_decode_batch=2)
    try:
        big = eng.submit(np.arange(1, 30), max_new_tokens=20)
        with pytest.raises(tdec.KVCacheExhausted):
            big.result(timeout=60)
        ok = eng.generate(np.arange(1, 5), max_new_tokens=3, timeout=60)
        assert len(ok) == 3 and eng.cache.blocks_in_use == 0
        assert eng.readyz()["ready"]
    finally:
        eng.shutdown(drain=False)


def test_oversized_prompt_rejected_and_shutdown_refuses():
    eng = _engine(max_seq_len=32)
    adapter = tdec.DecodeServerAdapter(eng)
    with pytest.raises(RejectedError):
        eng.submit(np.arange(1, 31), max_new_tokens=10)
    with pytest.raises(ValueError, match="empty prompt"):
        eng.submit([])
    assert adapter.batcher.accepting and adapter.healthz()["ok"]
    adapter.shutdown(drain=False)
    assert not adapter.readyz()["ready"]
    with pytest.raises(RejectedError):
        eng.submit(np.arange(1, 4))


def test_killed_engine_fails_in_flight_and_refuses():
    from deeplearning4j_tpu_torch.serving.resilience import FatalReplicaError
    eng = _engine(max_decode_batch=1)
    fut = eng.submit(np.arange(1, 4), max_new_tokens=60)
    eng.kill()
    with pytest.raises(FatalReplicaError):
        fut.result(timeout=30)
    with pytest.raises(FatalReplicaError):
        eng.submit(np.arange(1, 4))
    assert eng.cache.blocks_in_use == 0


def _split_edge_case(dtype, seed):
    """[5, 2, 64] over block tables 40 pages wide (page 8) with lengths on,
    one before and one after the kernel's split boundaries, and short
    ones that leave whole splits empty."""
    plan = pa.paged_plan(5, 2, 64, 8, 40, 1 if dtype == "int8" else 4,
                         torch.cuda.get_device_properties(0).multi_processor_count)
    per = plan.pages_per_split * 8
    lens = [min(n, 320) for n in (per, per - 1, per + 1, 1, 2 * per + 1)]
    return dict(B=5, H=2, D=64, page=8, n_pages=200, max_pages=40, dtype=dtype,
                seed=seed, seq_lens=lens)


@pytest.mark.cuda
def test_paged_kernel_matches_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    cases = [PAGED_CASES[c] for c in sorted(PAGED_CASES)]
    cases += [_split_edge_case("f32", 21), _split_edge_case("int8", 22)]
    for case in cases:
        args = [None if a is None else torch.from_numpy(np.asarray(a)).cuda()
                for a in _random_paged(**case)]
        q, k, v, bt, sl, ks, vs = args
        before = pa.LAUNCHES.value
        got = pa.paged_attention(q, k, v, bt, sl, k_scales=ks, v_scales=vs)
        torch.cuda.synchronize()
        assert pa.LAUNCHES.value == before + 1
        want = pa.paged_attention_plain(q, k, v, bt, sl, k_scales=ks, v_scales=vs)
        assert (got - want).abs().max().item() <= 1e-4 * want.abs().max().item()
        again = pa.paged_attention(q, k, v, bt, sl, k_scales=ks, v_scales=vs)
        assert torch.equal(got, again)              # the splits combine in a fixed order
