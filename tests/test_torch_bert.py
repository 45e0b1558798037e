"""BertModel of the PyTorch port against the JAX package's.

`BertConfig.tiny` models in both packages, the port's parameters carried
from the JAX model by `convert.bert_params_from_jax`, the same ids and
masks made with numpy from a seed.  `output_hidden`, `output_mlm` and
`output_cls` in f32 within 1e-5 relative (of max|ref|) of JAX, with an
all-ones mask, a padded one, and segment ids; in bf16 compute within 4
bf16 ulps of max|ref| (the two frameworks' CPU reference ops round bf16 at
different points).  A zip the JAX package saved loads in the port with
equal outputs, and a port zip loads in JAX.  Each forward calls the
attention dispatcher once per block and the LayerNorm dispatcher 1 + 2 per
block (plus one for the MLM head), the calls that launch the kernels on
the card.  The model needs CUDA unless asked for the CPU.  BERT-base's
parameter count is the JAX tree's.  Training is held to the JAX package's
in `test_torch_bert_train.py`.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.zoo.bert import BertConfig as JaxBertConfig
from deeplearning4j_tpu.zoo.bert import BertModel as JaxBertModel
from deeplearning4j_tpu_torch import convert
from deeplearning4j_tpu_torch.ops.kernels import dispatch
from deeplearning4j_tpu_torch.zoo import BertConfig, BertModel
from deeplearning4j_tpu_torch.zoo import bert as tbert

B, T = 3, 16


@pytest.fixture(autouse=True)
def _auto_mode():
    prev = dispatch.set_dispatch_mode("auto")
    yield
    dispatch.set_dispatch_mode(prev)


def _pair(compute_dtype="float32"):
    jm = JaxBertModel(JaxBertConfig.tiny(compute_dtype=compute_dtype), seed=1)
    tm = BertModel(BertConfig.tiny(compute_dtype=compute_dtype), device="cpu")
    convert.bert_params_from_jax(tm, jax.tree_util.tree_map(np.asarray, jm.params_))
    return jm, tm


def _inputs(mask_kind, seed=0):
    rs = np.random.RandomState(seed)
    ids = rs.randint(0, 100, (B, T)).astype(np.int32)
    mask = np.ones((B, T), np.float32)
    if mask_kind == "padded":
        mask[1, 10:] = 0.0
        mask[2, 5:] = 0.0
    seg = rs.randint(0, 2, (B, T)).astype(np.int32) if mask_kind == "segments" else None
    return ids, mask, seg


def _jax_out(jm, head, ids, mask, seg):
    h = jm._encode(jm.params_, jnp.asarray(ids), jnp.asarray(mask),
                   None if seg is None else jnp.asarray(seg))
    if head == "output_mlm":
        return np.asarray(jm._mlm_logits(jm.params_, h))
    if head == "output_cls":
        return np.asarray(jax.nn.softmax(jm._cls_logits(jm.params_, h), -1))
    return np.asarray(h)


@pytest.mark.parametrize("mask_kind", ["ones", "padded", "segments"])
@pytest.mark.parametrize("head", ["output_hidden", "output_mlm", "output_cls"])
def test_outputs_match_jax_f32(head, mask_kind):
    jm, tm = _pair()
    ids, mask, seg = _inputs(mask_kind)
    want = _jax_out(jm, head, ids, mask, seg)
    got = getattr(tm, head)(ids, mask, seg)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                               atol=1e-5 * float(np.abs(want).max()))


@pytest.mark.parametrize("head", ["output_hidden", "output_mlm", "output_cls"])
def test_outputs_match_jax_bf16_compute(head):
    jm, tm = _pair("bfloat16")
    ids, mask, seg = _inputs("padded", seed=2)
    want = _jax_out(jm, head, ids, mask, seg)
    got = getattr(tm, head)(ids, mask).numpy()
    ref = float(np.abs(want).max())
    assert np.isfinite(got).all()
    assert np.abs(got - want).max() <= 4 * 2.0 ** (math.floor(math.log2(ref)) - 7)
    # master parameters stay f32
    assert all(p.dtype == torch.float32 for p in tm.parameters())


def test_jax_zip_loads_in_the_port_and_port_zip_loads_in_jax(tmp_path):
    jm, tm = _pair()
    ids, mask, _ = _inputs("padded", seed=3)
    jm.iteration, jm.epoch = 7, 2
    jm.save(str(tmp_path / "jax.zip"))
    loaded = BertModel.load(str(tmp_path / "jax.zip"), device="cpu")
    assert (loaded.iteration, loaded.epoch) == (7, 2)
    assert loaded.config == BertConfig.tiny()
    want = np.asarray(jm.output_mlm(ids, mask))
    np.testing.assert_allclose(loaded.output_mlm(ids, mask).numpy(), want,
                               rtol=1e-5, atol=1e-5 * float(np.abs(want).max()))
    tm.save(str(tmp_path / "port.zip"))
    back = JaxBertModel.load(str(tmp_path / "port.zip"))
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(back.params_),
                            jax.tree_util.tree_leaves(jm.params_)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=str(path))
    assert len(jax.tree_util.tree_leaves(back.opt_state_)) == 2 * len(
        jax.tree_util.tree_leaves(back.params_))


def test_params_round_trip_through_convert():
    jm, tm = _pair()
    tree = convert.bert_params_to_jax(tm)
    want = jax.tree_util.tree_map(np.asarray, jm.params_)
    assert jax.tree_util.tree_structure(tree) == jax.tree_util.tree_structure(want)
    for a, b in zip(jax.tree_util.tree_leaves(tree), jax.tree_util.tree_leaves(want)):
        np.testing.assert_array_equal(a, b)
    bad = dict(tree, layers=dict(tree["layers"], Wq=tree["layers"]["Wq"][:1]))
    with pytest.raises(ValueError, match="layers.Wq"):
        convert.bert_params_from_jax(tm, bad)


@pytest.mark.parametrize("head,attention,layer_norm",
                         [("output_hidden", 2, 5), ("output_mlm", 2, 6),
                          ("output_cls", 2, 5)])
def test_each_forward_calls_the_kernel_dispatchers(monkeypatch, head, attention, layer_norm):
    """tiny has 2 blocks: 2 attention calls and 1 + 2 * 2 LayerNorm calls
    a forward, one more LayerNorm for the MLM head (at base: 12 and 25)."""
    calls = {"attention": 0, "layer_norm": 0}

    def spy(name, fn):
        def wrapped(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(tbert, "fused_attention", spy("attention", tbert.fused_attention))
    monkeypatch.setattr(tbert, "fused_layer_norm", spy("layer_norm", tbert.fused_layer_norm))
    _, tm = _pair()
    ids, mask, _ = _inputs("ones")
    getattr(tm, head)(ids, mask)
    assert calls == {"attention": attention, "layer_norm": layer_norm}


def test_device_defaults_to_cuda_and_raises_without_it():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a machine without CUDA")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        BertModel(BertConfig.tiny())
    assert BertModel(BertConfig.tiny(), device="cpu").device.type == "cpu"


def test_generator_draws_the_parameters():
    a = BertModel(BertConfig.tiny(), device="cpu",
                  generator=torch.Generator().manual_seed(5))
    b = BertModel(BertConfig.tiny(), device="cpu",
                  generator=torch.Generator().manual_seed(5))
    c = BertModel(BertConfig.tiny(), device="cpu", seed=6)
    torch.testing.assert_close(a.layers.Wq, b.layers.Wq, rtol=0, atol=0)
    assert not torch.equal(a.layers.Wq, c.layers.Wq)
    assert float(a.tok_emb.std()) == pytest.approx(0.02, rel=0.1)


def test_base_parameter_count_is_the_jax_trees():
    def count(spec):
        return sum(count(v) if isinstance(v, dict) else math.prod(v[0])
                   for v in spec.values())
    assert count(tbert._shapes(BertConfig.base())) == 110_106_428
    jm, tm = _pair()
    assert tm.num_params() == jm.num_params()


@pytest.mark.cuda
def test_launch_counts_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    from deeplearning4j_tpu_torch.ops.kernels import attention, layer_norm
    tm = BertModel(BertConfig.tiny())
    ids, mask, _ = _inputs("padded")
    attention.LAUNCHES.reset()
    layer_norm.LAUNCHES.reset()
    got = tm.output_mlm(ids, mask)
    torch.cuda.synchronize()
    assert (attention.LAUNCHES.value, layer_norm.LAUNCHES.value) == (2, 6)
    dispatch.set_dispatch_mode("reference")
    want = tm.output_mlm(ids, mask)
    assert (got - want).abs().max() <= 1e-4 * want.abs().max()
