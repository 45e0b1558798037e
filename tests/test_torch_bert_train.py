"""BertModel training of the PyTorch port against the JAX package's.

`BertConfig.tiny` models in both packages start from the same parameters
(the JAX model's, carried by `convert.bert_params_from_jax`) and take 3
`fit_batch` steps with Adam(1e-3) on the same batches, made with numpy from
a seed: masked LM with sparse [B, T] and one-hot [B, T, V] labels, and
classification.  Each JAX run is compiled once per module.  Tolerances:

* f32 losses within 1e-5 relative (measured <= 1e-7).
* Adam's m and v per tensor within 1e-5 of max|ref| (measured <= 2.5e-6):
  they are linear and quadratic in the gradients, so they carry the
  gradients' agreement.
* Parameters per tensor within 1e-3 of the tensor's update size, max|p3 -
  p0| (measured <= 3.3e-4).  Not 1e-5: Adam divides each element's
  gradient by its own RMS, so an element whose gradient is small beside the
  terms summed into it carries that sum's rounding (another order in each
  framework) into a full-size step.
* ``layers.bk``: the gradient of the key bias is zero in exact arithmetic
  (softmax is invariant to a shift of a row's scores), so both frameworks
  hold rounding noise there, and Adam turns noise into steps.  It is held
  instead to be noise in both: max|m| within 1e-5 of ``layers.bq``'s
  (measured <= 5e-7) and its update within 1e-3 of ``layers.bq``'s
  (measured <= 2e-5).
* bf16 compute: losses within 1e-3 relative (measured <= 5e-5): both
  frameworks run their plain bf16 paths on the CPU and round at different
  points; 1e-3 is a quarter of one bf16 ulp of relative precision.

`fit_steps` equals sequential `fit_batch` bit for bit on the CPU, and
`fit(iterator)` gives JAX's losses, with `fused_steps=2` (blocks of 2
through `fit_steps`) as without.  A zip the JAX package
saved after 2 steps resumes in the port with JAX's third loss, and a port
zip resumes in JAX.  With the dispatch forced to the kernel path and the
launchers replaced by the plain versions, a step runs the autograd
wrappers of both kernels (the counts a card shows: per MLM step of the
2-block tiny model, 2 flash forward, 2 dQ, 2 dK/dV, 6 LayerNorm forward and
6 LayerNorm backward launches) and its gradients equal reference mode's.
The card itself is checked by the `cuda`-marked test, which skips here.
"""
import torch_test_threads  # noqa: F401  (first: one torch thread a worker)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.data.dataset import MultiDataSet as JaxMultiDataSet
from deeplearning4j_tpu.nlp import BertIterator as JaxBertIterator
from deeplearning4j_tpu.nlp import BertWordPieceTokenizer as JaxTokenizer
from deeplearning4j_tpu.train.updaters import Adam as JaxAdam
from deeplearning4j_tpu.zoo.bert import BertConfig as JaxBertConfig
from deeplearning4j_tpu.zoo.bert import BertModel as JaxBertModel
from deeplearning4j_tpu_torch import convert
from deeplearning4j_tpu_torch.data import MultiDataSet
from deeplearning4j_tpu_torch.nlp import BertIterator, BertWordPieceTokenizer
from deeplearning4j_tpu_torch.ops import attention_kernels as ak
from deeplearning4j_tpu_torch.ops import norm_kernels as nk
from deeplearning4j_tpu_torch.ops.kernels import attention as ka
from deeplearning4j_tpu_torch.ops.kernels import dispatch, layer_norm
from deeplearning4j_tpu_torch.train import Adam
from deeplearning4j_tpu_torch.zoo import BertConfig, BertModel

B, T, V, STEPS = 4, 16, 100, 3
LOSS_RTOL = 1e-5
OPT_RTOL = 1e-5
PARAM_RTOL = 1e-3
BK_RTOL = (1e-5, 1e-3)        # bk's m against bq's, bk's update against bq's
BF16_LOSS_RTOL = 1e-3
VOCAB = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"] + [f"w{i}" for i in range(95)]


@pytest.fixture(autouse=True)
def _auto_mode():
    prev = dispatch.set_dispatch_mode("auto")
    yield
    dispatch.set_dispatch_mode(prev)


def _arrays(kind, i):
    """(features, labels, labels_masks) of batch i: ids with a padded row,
    label masks over 30% of the kept positions."""
    rs = np.random.RandomState(10 + i)
    ids = rs.randint(0, V, (B, T)).astype(np.int32)
    mask = np.ones((B, T), np.float32)
    mask[1, 11:] = 0.0
    lmask = ((rs.rand(B, T) < 0.3) & (mask > 0)).astype(np.float32)
    if kind == "cls":
        return [ids, mask], [np.eye(2, dtype=np.float32)[rs.randint(0, 2, B)]], None
    labels = ids if kind == "sparse" else np.eye(V, dtype=np.float32)[ids]
    return [ids, mask], [labels], [lmask]


def _jax_mds(f, l, lm):
    return JaxMultiDataSet([jnp.asarray(a) for a in f], [jnp.asarray(a) for a in l],
                           labels_masks=None if lm is None else [jnp.asarray(a) for a in lm])


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def jax_runs():
    """(initial params, losses, final params, final Adam state) of a JAX run
    per (task, compute dtype), each compiled and run once."""
    cache = {}

    def run(kind, dtype="float32"):
        if (kind, dtype) not in cache:
            jm = JaxBertModel(JaxBertConfig.tiny(compute_dtype=dtype), seed=1,
                              updater=JaxAdam(1e-3))
            p0 = _np(jm.params_)
            losses = [float(jm.fit_batch(_jax_mds(*_arrays(kind, i)))) for i in range(STEPS)]
            cache[(kind, dtype)] = (p0, losses, _np(jm.params_), _np(jm.opt_state_))
        return cache[(kind, dtype)]

    return run


def _port(p0, dtype="float32"):
    tm = BertModel(BertConfig.tiny(compute_dtype=dtype), device="cpu", updater=Adam(1e-3))
    convert.bert_params_from_jax(tm, p0)
    return tm


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}.{k}" if path else k)
    else:
        yield path, tree


def _rel_diff(a, b, scale):
    return float(np.abs(a - b).max()) / max(float(scale), 1e-30)


def _check_params_and_state(got_p, got_opt, want_p, want_opt, p0):
    p0 = dict(_leaves(p0))
    gp, wp = dict(_leaves(got_p)), dict(_leaves(want_p))
    for name, w in wp.items():
        if name != "layers.bk":
            assert _rel_diff(gp[name], w, np.abs(w - p0[name]).max()) <= PARAM_RTOL, name
    for part in ("m", "v"):
        go, wo = dict(_leaves(got_opt[part])), dict(_leaves(want_opt[part]))
        for name, w in wo.items():
            if name != "layers.bk":
                assert _rel_diff(go[name], w, np.abs(w).max()) <= OPT_RTOL, f"{part} {name}"
    for params, opt in ((got_p, got_opt), (want_p, want_opt)):
        m = opt["m"]["layers"]
        assert np.abs(m["bk"]).max() <= BK_RTOL[0] * np.abs(m["bq"]).max()
        lp, l0 = params["layers"], p0
        bk_upd = np.abs(lp["bk"] - l0["layers.bk"]).max()
        assert bk_upd <= BK_RTOL[1] * np.abs(lp["bq"] - l0["layers.bq"]).max()


@pytest.mark.parametrize("kind", ["sparse", "onehot", "cls"])
def test_fit_batch_matches_jax_f32(jax_runs, kind):
    p0, want, want_p, want_opt = jax_runs(kind)
    tm = _port(p0)
    got = []
    for i in range(STEPS):
        loss = tm.fit_batch(MultiDataSet(*_arrays(kind, i)[:2],
                                         labels_masks=_arrays(kind, i)[2]))
        assert isinstance(loss, torch.Tensor) and loss.device.type == "cpu"
        got.append(float(loss))
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
    assert tm.iteration == STEPS and tm.score() == got[-1]
    _check_params_and_state(convert.bert_params_to_jax(tm), convert.bert_opt_state_to_jax(tm),
                            want_p, want_opt, p0)


@pytest.mark.parametrize("kind", ["sparse", "cls"])
def test_fit_batch_matches_jax_bf16_compute(jax_runs, kind):
    p0, want, _, _ = jax_runs(kind, "bfloat16")
    tm = _port(p0, "bfloat16")
    got = [float(tm.fit_batch(MultiDataSet(*_arrays(kind, i)[:2],
                                           labels_masks=_arrays(kind, i)[2])))
           for i in range(STEPS)]
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=BF16_LOSS_RTOL)
    assert all(p.dtype == torch.float32 for p in tm.parameters())


def test_gradient_for_matches_jax_grad():
    jm = JaxBertModel(JaxBertConfig.tiny(), seed=2)
    tm = _port(_np(jm.params_))
    f, l, lm = _arrays("sparse", 5)
    want = _np(jax.grad(lambda p: jm._mlm_loss(p, *(jnp.asarray(a) for a in (*f, *l, *lm))))(
        jm.params_))
    got = convert._numpy_tree(tm.gradient_for(MultiDataSet(f, l, labels_masks=lm)))
    assert tm.iteration == 0
    for name, w in _leaves(want):
        g = dict(_leaves(got))[name]
        if name == "layers.bk":       # zero in exact arithmetic: noise in both
            assert np.abs(g).max() <= 1e-5 * np.abs(dict(_leaves(want))["layers.bq"]).max()
        else:
            assert _rel_diff(g, w, np.abs(w).max() if np.abs(w).max() else 1.0) <= 1e-5, name


def test_fit_steps_equals_sequential_fit_batch_bitwise():
    rs = np.random.RandomState(3)
    k = 3
    ids = rs.randint(0, V, (k, B, T)).astype(np.int32)
    mask = np.ones((k, B, T), np.float32)
    lmask = (rs.rand(k, B, T) < 0.15).astype(np.float32)
    a = BertModel(BertConfig.tiny(), device="cpu", seed=4, updater=Adam(1e-3))
    b = BertModel(BertConfig.tiny(), device="cpu", seed=4, updater=Adam(1e-3))
    seq = [a.fit_batch(MultiDataSet([ids[i], mask[i]], [ids[i]], labels_masks=[lmask[i]]))
           for i in range(k)]
    losses = b.fit_steps(MultiDataSet([ids, mask], [ids], labels_masks=[lmask]))
    assert tuple(losses.shape) == (k,)
    torch.testing.assert_close(losses, torch.stack(seq), rtol=0, atol=0)
    for pa, pb in zip(a.parameters(), b.parameters()):
        torch.testing.assert_close(pa, pb, rtol=0, atol=0)
    assert a.iteration == b.iteration == k and a.score() == b.score()
    with pytest.raises(ValueError, match="steps axis mismatch"):
        b.fit_steps(MultiDataSet([ids, mask[:2]], [ids], labels_masks=[lmask]))


def _sentences(n=27, seed=0):
    rng = np.random.RandomState(seed)
    return [" ".join(f"w{(s + j) % 95}" for j in range(8)) for s in rng.randint(0, 95, n)]


def test_fit_iterator_with_fused_steps_matches_jax():
    """With `fused_steps=2` both packages train blocks of 2 (the port's
    as `fit_steps` blocks, tails alone), to the same losses."""
    kw = dict(batch_size=8, max_length=16, seed=1, sparse_labels=True)
    jm = JaxBertModel(JaxBertConfig.tiny(), seed=3, updater=JaxAdam(1e-3))
    tm = _port(_np(jm.params_))
    tm.fit(BertIterator(BertWordPieceTokenizer(VOCAB), _sentences(), **kw), epochs=2,
           fused_steps=2)
    jm.fit(JaxBertIterator(JaxTokenizer(VOCAB), _sentences(), **kw), epochs=2, fused_steps=2)
    assert (tm.iteration, tm.epoch) == (jm.iteration, jm.epoch) == (8, 2)
    np.testing.assert_allclose(tm.score(), jm.score(), rtol=LOSS_RTOL)


def test_fit_over_the_iterator_matches_jax():
    kw = dict(batch_size=8, max_length=16, seed=1, sparse_labels=True)
    jm = JaxBertModel(JaxBertConfig.tiny(), seed=3, updater=JaxAdam(1e-3))
    tm = _port(_np(jm.params_))
    tm.fit(BertIterator(BertWordPieceTokenizer(VOCAB), _sentences(), **kw))
    jm.fit(JaxBertIterator(JaxTokenizer(VOCAB), _sentences(), **kw))
    assert (tm.iteration, tm.epoch) == (jm.iteration, jm.epoch) == (4, 1)
    np.testing.assert_allclose(tm.score(), jm.score(), rtol=LOSS_RTOL)


def test_jax_zip_resumes_in_the_port_and_port_zip_resumes_in_jax(tmp_path):
    jm = JaxBertModel(JaxBertConfig.tiny(), seed=5, updater=JaxAdam(1e-3))
    for i in range(2):
        jm.fit_batch(_jax_mds(*_arrays("sparse", i)))
    jm.save(str(tmp_path / "jax.zip"))
    tm = BertModel.load(str(tmp_path / "jax.zip"), device="cpu")
    assert (tm.iteration, tm.epoch) == (2, 0)
    np.testing.assert_array_equal(convert.bert_opt_state_to_jax(tm)["v"]["tok_emb"],
                                  np.asarray(jm.opt_state_["v"]["tok_emb"]))
    f, l, lm = _arrays("sparse", 2)
    third = float(tm.fit_batch(MultiDataSet(f, l, labels_masks=lm)))
    np.testing.assert_allclose(third, float(jm.fit_batch(_jax_mds(f, l, lm))), rtol=LOSS_RTOL)
    tm.save(str(tmp_path / "port.zip"))
    back = JaxBertModel.load(str(tmp_path / "port.zip"))
    assert back.iteration == 3
    f, l, lm = _arrays("sparse", 3)
    np.testing.assert_allclose(float(back.fit_batch(_jax_mds(f, l, lm))),
                               float(tm.fit_batch(MultiDataSet(f, l, labels_masks=lm))),
                               rtol=LOSS_RTOL)


def test_opt_state_round_trips_through_convert():
    tm = BertModel(BertConfig.tiny(), device="cpu")
    tree = convert.bert_opt_state_to_jax(tm)
    assert set(tree) == {"m", "v"}
    tree["m"]["layers"]["Wq"] = tree["m"]["layers"]["Wq"] + 1.0
    convert.bert_opt_state_from_jax(tm, tree)
    assert float(tm.opt_state_["m"]["layers"]["Wq"].min()) == 1.0
    bad = {"m": tree["m"], "v": dict(tree["v"], tok_emb=tree["v"]["tok_emb"][:1])}
    with pytest.raises(ValueError, match="v.tok_emb"):
        convert.bert_opt_state_from_jax(tm, bad)


def test_score_is_nan_before_training():
    assert np.isnan(BertModel(BertConfig.tiny(), device="cpu").score())


def test_a_step_on_the_kernel_path_matches_reference_mode(monkeypatch):
    """The dispatch forced to the kernel path on CPU tensors, each launcher
    replaced by its plain version and counted: one MLM step of the tiny
    model makes the launches a card would, and its gradients equal
    reference mode's within 1e-5 of max|ref| (bk: noise in both)."""
    counts = {}

    def counted(name, fn):
        def wrapped(*a, **kw):
            counts[name] = counts.get(name, 0) + 1
            return fn(*a, **kw)
        return wrapped

    f, l, lm = _arrays("sparse", 6)
    mds = MultiDataSet(f, l, labels_masks=lm)
    tm = BertModel(BertConfig.tiny(), device="cpu", seed=7)
    want = convert._numpy_tree(tm.gradient_for(mds))
    monkeypatch.setattr(dispatch, "resolve", lambda name, *a, **kw: "kernel")
    for mod, name, fn in ((ka, "launch", ak.flash_attention_plain),
                          (ka, "launch_bwd", ak.flash_attention_bwd_plain),
                          (layer_norm, "launch", nk.layer_norm_plain),
                          (layer_norm, "launch_bwd", nk.layer_norm_bwd_plain)):
        monkeypatch.setattr(mod, name, counted(f"{mod.__name__.split('.')[-1]}.{name}", fn))
    got = convert._numpy_tree(tm.gradient_for(mds))
    assert counts == {"attention.launch": 2, "attention.launch_bwd": 2,
                      "layer_norm.launch": 6, "layer_norm.launch_bwd": 6}
    for name, w in _leaves(want):
        g = dict(_leaves(got))[name]
        scale = np.abs(dict(_leaves(want))["layers.bq" if name == "layers.bk" else name]).max()
        assert _rel_diff(g, w, scale if scale else 1.0) <= 1e-5, name


@pytest.mark.cuda
def test_training_launch_counts_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    tm = BertModel(BertConfig.tiny())
    f, l, lm = _arrays("sparse", 0)
    counters = (ka.LAUNCHES, ka.DQ_LAUNCHES, ka.DKV_LAUNCHES, layer_norm.LAUNCHES,
                layer_norm.BWD_LAUNCHES)
    for c in counters:
        c.reset()
    loss = tm.fit_batch(MultiDataSet(f, l, labels_masks=lm))
    torch.cuda.synchronize()
    assert [c.value for c in counters] == [2, 2, 2, 6, 6]
    assert np.isfinite(float(loss))
