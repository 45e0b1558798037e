"""BERT's fused training loop in the PyTorch port: `fit_steps` as one
`GraphStep` block and `fit(iterator, fused_steps=k)`.

On the CPU a block runs the same step body k times (the card replays it
as one CUDA graph, which `chip_smoke.py` holds to its eager twin), so:

* `fit_steps` equals k `fit_batch` calls bit for bit, in its three input
  forms (stacked `[k, batch, ...]` arrays, a stride-0 `broadcast_to`
  block, lists of k per-step arrays), for masked LM and classification;
  it keeps the address of every tensor it carries, advances the host
  counters by k, and `score()` reads the block's last loss.
* `fit(iterator, fused_steps=k)` keeps each batch's label mask: it equals
  the same batches through `fit_steps` and then `fit_batch` (tails and a
  shape change step alone), and the JAX package's fused `fit` over the
  same batches.  The JAX package's BERT is f32 by construction (its
  embeddings and hidden state are f32 whatever x64 says), so the JAX
  comparison is in f32: losses within 1e-5 relative, parameters within
  1e-3 of each tensor's update size, as `test_torch_bert_train.py` holds
  `fit_batch`.
* A block on the kernel path (dispatch forced, launchers replaced by
  their plain versions and counted) launches k times a step's kernels.
"""
import torch_test_threads  # noqa: F401  (first: one torch thread a worker)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.data.dataset import MultiDataSet as JaxMultiDataSet
from deeplearning4j_tpu.train.updaters import Adam as JaxAdam
from deeplearning4j_tpu.zoo.bert import BertConfig as JaxBertConfig
from deeplearning4j_tpu.zoo.bert import BertModel as JaxBertModel
from deeplearning4j_tpu_torch import convert
from deeplearning4j_tpu_torch.data import MultiDataSet
from deeplearning4j_tpu_torch.ops import attention_kernels as ak
from deeplearning4j_tpu_torch.ops import norm_kernels as nk
from deeplearning4j_tpu_torch.ops.kernels import attention as ka
from deeplearning4j_tpu_torch.ops.kernels import dispatch, layer_norm
from deeplearning4j_tpu_torch.train import Adam
from deeplearning4j_tpu_torch.zoo import BertConfig, BertModel

B, T, V = 4, 16, 100
LOSS_RTOL = 1e-5
PARAM_RTOL = 1e-3


@pytest.fixture(autouse=True)
def _auto_mode():
    prev = dispatch.set_dispatch_mode("auto")
    yield
    dispatch.set_dispatch_mode(prev)


def _batch(kind, seed, t=T):
    """(features, labels, labels_masks) numpy arrays of one batch: ids with
    a padded row, label masks over 30% of the kept positions."""
    rs = np.random.RandomState(seed)
    ids = rs.randint(0, V, (B, t)).astype(np.int32)
    mask = np.ones((B, t), np.float32)
    mask[1, t - 5:] = 0.0
    lmask = ((rs.rand(B, t) < 0.3) & (mask > 0)).astype(np.float32)
    if kind == "cls":
        return [ids, mask], [np.eye(2, dtype=np.float32)[rs.randint(0, 2, B)]], None
    return [ids, mask], [ids], [lmask]


def _mds(f, l, lm):
    return MultiDataSet(list(f), list(l), labels_masks=None if lm is None else list(lm))


def _model(seed=4):
    return BertModel(BertConfig.tiny(), device="cpu", seed=seed, updater=Adam(1e-3))


def _block(batches, form):
    """A MultiDataSet block of the batches in `form`."""
    def field(i):
        per = [b[i] for b in batches]
        if per[0] is None:
            return None
        cols = list(zip(*per))
        if form == "list":
            return [list(c) for c in cols]
        if form == "stride0":
            return [np.broadcast_to(c[0], (len(c),) + c[0].shape) for c in cols]
        return [np.stack(c) for c in cols]
    return MultiDataSet(field(0), field(1), labels_masks=field(2))


def _same_models(a, b):
    for (n, pa), (_, pb) in zip(a.named_parameters(), b.named_parameters()):
        assert torch.equal(pa, pb), n
    for x, y in zip(jax.tree_util.tree_leaves(convert._numpy_tree(a.opt_state_)),
                    jax.tree_util.tree_leaves(convert._numpy_tree(b.opt_state_))):
        assert np.array_equal(x, y)


@pytest.mark.parametrize("form", ["stacked", "stride0", "list"])
@pytest.mark.parametrize("kind", ["mlm", "cls"])
def test_fit_steps_equals_k_fit_batch_calls_bitwise(kind, form):
    k = 3
    batches = [_batch(kind, 20 + i) for i in range(k)]
    if form == "stride0":
        batches = [batches[0]] * k
    fused, stepped = _model(), _model()
    carried = [t.data_ptr() for t in fused._carry()]
    losses = fused.fit_steps(_block(batches, form))
    want = torch.stack([stepped.fit_batch(_mds(*b)) for b in batches])
    assert tuple(losses.shape) == (k,)
    assert torch.equal(losses, want)
    _same_models(fused, stepped)
    assert fused.iteration == stepped.iteration == k
    assert fused.score() == stepped.score() == float(losses[-1])
    assert [t.data_ptr() for t in fused._carry()] == carried
    assert list(fused._scan_steps) == [kind]


def test_fit_steps_rejects_blocks_of_unequal_steps():
    f, l, lm = _batch("mlm", 1)
    m = _model()
    with pytest.raises(ValueError, match="steps axis mismatch"):
        m.fit_steps(MultiDataSet([np.stack([f[0]] * 3), np.stack([f[1]] * 2)],
                                 [np.stack([l[0]] * 3)], labels_masks=[np.stack([lm[0]] * 3)]))


def _stream():
    """11 batches: 7 masked-LM at T = 16 (two blocks of 3 and a tail), a
    shape change to T = 12 (one batch), then 3 classification batches
    (their own block)."""
    return ([_batch("mlm", 40 + i) for i in range(7)] + [_batch("mlm", 60, t=12)]
            + [_batch("cls", 70 + i) for i in range(3)])


def test_fused_fit_keeps_label_masks_and_equals_fit_steps_then_fit_batch(monkeypatch):
    batches = _stream()
    fused, manual = _model(), _model()
    blocks = []
    real = BertModel.fit_steps

    def spy(self, mds):
        blocks.append(None if mds.labels_masks is None else len(mds.labels_masks[0]))
        return real(self, mds)

    monkeypatch.setattr(BertModel, "fit_steps", spy)
    fused.fit([_mds(*b) for b in batches], fused_steps=3)
    assert blocks == [3, 3, None]              # the masked blocks kept their masks
    monkeypatch.setattr(BertModel, "fit_steps", real)
    want = (manual.fit_steps(_block(batches[0:3], "stacked")).tolist()
            + manual.fit_steps(_block(batches[3:6], "stacked")).tolist()
            + [float(manual.fit_batch(_mds(*batches[6]))),
               float(manual.fit_batch(_mds(*batches[7])))]
            + manual.fit_steps(_block(batches[8:], "stacked")).tolist())
    _same_models(fused, manual)
    assert (fused.iteration, fused.epoch) == (11, 1) and manual.iteration == 11
    assert fused.score() == manual.score() == want[-1]
    assert sorted(fused._scan_steps) == ["cls", "mlm"]


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}.{k}" if path else k)
    else:
        yield path, tree


def test_fused_fit_with_tails_matches_jax():
    """Two blocks of 3 and a tail step (one JAX compile each kind)."""
    batches = _stream()
    jm = JaxBertModel(JaxBertConfig.tiny(), seed=3, updater=JaxAdam(1e-3))
    p0 = _np(jm.params_)
    tm = BertModel(BertConfig.tiny(), device="cpu", updater=Adam(1e-3))
    convert.bert_params_from_jax(tm, p0)
    jm.fit([JaxMultiDataSet([jnp.asarray(a) for a in f], [jnp.asarray(a) for a in l],
                            labels_masks=None if lm is None else [jnp.asarray(a) for a in lm])
            for f, l, lm in batches[:7]], fused_steps=3)
    tm.fit([_mds(*b) for b in batches[:7]], fused_steps=3)
    assert (tm.iteration, tm.epoch) == (jm.iteration, jm.epoch) == (7, 1)
    np.testing.assert_allclose(tm.score(), jm.score(), rtol=LOSS_RTOL)
    got, want, start = dict(_leaves(convert._numpy_tree(tm.params_))), \
        dict(_leaves(_np(jm.params_))), dict(_leaves(p0))
    for name, w in want.items():
        if name == "layers.bk":                 # zero in exact arithmetic: noise
            continue
        size = np.abs(w - start[name]).max()
        assert np.abs(got[name] - w).max() <= PARAM_RTOL * size, name


def test_a_block_on_the_kernel_path_launches_k_steps_of_kernels(monkeypatch):
    """Per MLM step of the 2-block tiny model: 2 flash forward, 2 dQ and
    dK/dV (one backward call each), 6 LayerNorm forward and 6 backward."""
    counts = {}

    def counted(name, fn):
        def wrapped(*a, **kw):
            counts[name] = counts.get(name, 0) + 1
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(dispatch, "resolve", lambda name, *a, **kw: "kernel")
    for mod, name, fn in ((ka, "launch", ak.flash_attention_plain),
                          (ka, "launch_bwd", ak.flash_attention_bwd_plain),
                          (layer_norm, "launch", nk.layer_norm_plain),
                          (layer_norm, "launch_bwd", nk.layer_norm_bwd_plain)):
        monkeypatch.setattr(mod, name, counted(f"{mod.__name__.split('.')[-1]}.{name}", fn))
    k = 3
    m = _model()
    losses = m.fit_steps(_block([_batch("mlm", 5 + i) for i in range(k)], "stacked"))
    assert torch.isfinite(losses).all()
    assert counts == {"attention.launch": 2 * k, "attention.launch_bwd": 2 * k,
                      "layer_norm.launch": 6 * k, "layer_norm.launch_bwd": 6 * k}
