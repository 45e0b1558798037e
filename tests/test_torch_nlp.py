"""Tokenizers, BertIterator and the data containers of the PyTorch port
against the JAX package's.

The port keeps its own copies of ``nlp/tokenization.py``,
``nlp/bert_iterator.py``, ``data/dataset.py`` and ``utils/scan_fit.py``'s
``check_steps_axes``; here each is held to the JAX package's
on the same vocab, sentences and seeds: tokens, ids and decoded text equal,
and every array a BertIterator yields equal (masked LM with sparse and
one-hot labels, classification), also across ``reset()``.
"""
import numpy as np
import pytest

from deeplearning4j_tpu.data.dataset import MultiDataSet as JaxMultiDataSet
from deeplearning4j_tpu.nlp import BertIterator as JaxBertIterator
from deeplearning4j_tpu.nlp import BertWordPieceTokenizer as JaxTokenizer
from deeplearning4j_tpu.nlp import CommonPreprocessor as JaxPre
from deeplearning4j_tpu.nlp import DefaultTokenizerFactory as JaxFactory
from deeplearning4j_tpu.utils import scan_fit as jsf
from deeplearning4j_tpu_torch.data import DataSet, MultiDataSet
from deeplearning4j_tpu_torch.nlp import (BertIterator, BertWordPieceTokenizer,
                                          CommonPreprocessor, DefaultTokenizerFactory)
from deeplearning4j_tpu_torch.utils import scan_fit as tsf

VOCAB = (["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", "un", "##aff", "##able",
          "the", "cat", "sat", ",", "!", "##s"] + [f"w{i}" for i in range(90)])
TEXTS = ["The cat sat, unaffable!", "cats sat on the w3 w7", "zzz unaff", "",
         "W1 w2 w3 w4 w5 w6 w7 w8 w9 w10 w11 w12 w13 w14 w15 w16 w17 w18"]


def _sentences(n=21, seed=0):
    rng = np.random.RandomState(seed)
    return [" ".join(f"w{(s + j) % 90}" for j in range(rng.randint(3, 20)))
            for s in rng.randint(0, 90, n)]


def test_word_piece_tokenizer_matches_jax():
    jt, tt = JaxTokenizer(VOCAB), BertWordPieceTokenizer(VOCAB)
    for text in TEXTS:
        assert tt.tokenize(text) == jt.tokenize(text)
        assert tt.encode(text) == jt.encode(text)
        assert tt.decode(tt.encode(text)) == jt.decode(jt.encode(text))
    assert BertWordPieceTokenizer(VOCAB, lower_case=False).tokenize(TEXTS[0]) == \
        JaxTokenizer(VOCAB, lower_case=False).tokenize(TEXTS[0])
    with pytest.raises(ValueError, match="unknown-token"):
        BertWordPieceTokenizer(["a", "b"])


def test_default_tokenizer_factory_and_preprocessor_match_jax():
    for pre in (False, True):
        jf = JaxFactory(JaxPre() if pre else None)
        tf = DefaultTokenizerFactory(CommonPreprocessor() if pre else None)
        for text in TEXTS:
            assert tf.tokenize(text) == jf.tokenize(text) == tf.create(text)


def _assert_same_batches(port, ref):
    assert len(port) == len(ref) > 0
    for a, b in zip(port, ref):
        assert isinstance(a, MultiDataSet) and isinstance(b, JaxMultiDataSet)
        for name in ("features", "labels", "labels_masks"):
            xs, ys = getattr(a, name), getattr(b, name)
            assert (xs is None) == (ys is None)
            for x, y in zip(xs or [], ys or []):
                assert x.dtype == y.dtype and x.shape == y.shape
                np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("sparse", [True, False])
def test_bert_iterator_masked_lm_matches_jax_across_epochs(sparse):
    kw = dict(batch_size=8, max_length=16, seed=3, sparse_labels=sparse)
    port = BertIterator(BertWordPieceTokenizer(VOCAB), _sentences(), **kw)
    ref = JaxBertIterator(JaxTokenizer(VOCAB), _sentences(), **kw)
    for _ in range(3):
        _assert_same_batches(list(port), list(ref))
        port.reset()
        ref.reset()
    last = list(port)[-1]
    assert last.features[0].shape == (5, 16)           # the 21st..25th rows
    assert last.labels[0].shape == ((5, 16) if sparse else (5, 16, len(VOCAB)))


def test_bert_iterator_classification_matches_jax():
    labels = list(np.random.RandomState(4).randint(0, 3, 21))
    kw = dict(batch_size=8, max_length=12, task="SEQ_CLASSIFICATION", labels=labels,
              n_classes=3)
    port = BertIterator(BertWordPieceTokenizer(VOCAB), _sentences(), **kw)
    ref = JaxBertIterator(JaxTokenizer(VOCAB), _sentences(), **kw)
    _assert_same_batches(list(port), list(ref))
    assert all(b.labels_masks is None for b in port)
    with pytest.raises(ValueError, match="labels"):
        BertIterator(BertWordPieceTokenizer(VOCAB), _sentences(), 8, 12,
                     task="SEQ_CLASSIFICATION")


def test_check_steps_axes_matches_jax():
    arrays = [("a", np.zeros((3, 2))), ("b", None), ("c", np.zeros((3, 5)))]
    assert tsf.check_steps_axes(arrays) == jsf.check_steps_axes(arrays) == 3
    with pytest.raises(ValueError, match="'c' has 4 steps"):
        tsf.check_steps_axes([("a", np.zeros((3, 2))), ("c", np.zeros((4, 2)))])
    with pytest.raises(ValueError, match="at least one"):
        tsf.check_steps_axes([("a", None)])


def test_dataset_containers_behave_as_the_jax_ones():
    rs = np.random.RandomState(6)
    x, y = rs.rand(10, 3), rs.rand(10, 2)
    ds = DataSet(x.copy(), y.copy())
    assert ds.num_examples() == 10
    assert [b.num_examples() for b in ds.batch_by(4)] == [4, 4, 2]
    tr, te = ds.split_test_and_train(7)
    assert (tr.num_examples(), te.num_examples()) == (7, 3)
    ds.shuffle(seed=1)
    from deeplearning4j_tpu.data.dataset import DataSet as JaxDataSet
    jds = JaxDataSet(x.copy(), y.copy())
    jds.shuffle(seed=1)
    np.testing.assert_array_equal(ds.features, jds.features)
    assert MultiDataSet([x], [y]).num_examples() == 10
