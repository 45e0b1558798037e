"""BertIterator (the port of ``nlp/bert_iterator.py``; reference `deeplearning4j-nlp/.../iterator/
BertIterator.java`): sentences -> BERT training batches.

Two tasks, as in the reference:
- UNSUPERVISED: masked-LM — 15% of positions selected; of those 80% become
  [MASK], 10% a random token, 10% unchanged; labels are one-hot originals
  with a label-mask marking the selected positions.
- SEQ_CLASSIFICATION: features + per-sequence class label.

Features are (token_ids [B,T], input_mask [B,T]); fixed length T
(truncate/pad) — the reference's LengthHandling.FIXED_LENGTH.  Masking
draws from ``np.random.RandomState(seed + epoch)``, so the same vocab,
sentences and seed give the same arrays as the JAX package's iterator.
"""
from __future__ import annotations

from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np

from deeplearning4j_tpu_torch.data.dataset import MultiDataSet
from deeplearning4j_tpu_torch.nlp.tokenization import BertWordPieceTokenizer


class BertIterator:
    TASK_UNSUPERVISED = "UNSUPERVISED"
    TASK_SEQ_CLASSIFICATION = "SEQ_CLASSIFICATION"

    def __init__(self, tokenizer: BertWordPieceTokenizer,
                 sentences: Sequence, batch_size: int, max_length: int,
                 task: str = "UNSUPERVISED",
                 labels: Optional[Sequence[int]] = None,
                 n_classes: Optional[int] = None,
                 mask_token: str = "[MASK]", mask_prob: float = 0.15,
                 seed: int = 0, sparse_labels: bool = False):
        self.tok = tokenizer
        self.sentences = list(sentences)
        self.batch_size = batch_size
        self.max_length = max_length
        self.task = task
        self.labels = None if labels is None else list(labels)
        self.n_classes = n_classes
        self.mask_prob = mask_prob
        self.seed = seed
        self.sparse_labels = sparse_labels  # [B,T] int ids instead of
        # one-hot [B,T,V] — 4 bytes vs 4*V per position of H2D traffic
        self._epoch = 0
        if task == self.TASK_SEQ_CLASSIFICATION:
            if self.labels is None or n_classes is None:
                raise ValueError("SEQ_CLASSIFICATION needs labels+n_classes")
        if mask_token not in self.tok.vocab:
            raise ValueError(f"Tokenizer vocab lacks {mask_token}")
        self.mask_id = self.tok.vocab[mask_token]
        self.pad_id = self.tok.vocab.get("[PAD]", 0)
        self.vocab_size = len(self.tok.vocab)

    def reset(self):
        self._epoch += 1         # fresh masking pattern each epoch

    def _encode(self, text: str) -> Tuple[np.ndarray, np.ndarray]:
        ids = self.tok.encode(text)[: self.max_length]
        arr = np.full(self.max_length, self.pad_id, np.int32)
        mask = np.zeros(self.max_length, np.float32)
        arr[: len(ids)] = ids
        mask[: len(ids)] = 1.0
        return arr, mask

    def __iter__(self) -> Iterator[MultiDataSet]:
        rng = np.random.RandomState(self.seed + self._epoch)
        for start in range(0, len(self.sentences), self.batch_size):
            batch = self.sentences[start:start + self.batch_size]
            encoded = [self._encode(s) for s in batch]
            ids = np.stack([e[0] for e in encoded])
            input_mask = np.stack([e[1] for e in encoded])
            if self.task == self.TASK_SEQ_CLASSIFICATION:
                lab = np.asarray(
                    self.labels[start:start + self.batch_size])
                y = np.eye(self.n_classes, dtype=np.float32)[lab]
                yield MultiDataSet(features=[ids, input_mask], labels=[y])
                continue
            # masked LM
            masked = ids.copy()
            select = ((rng.rand(*ids.shape) < self.mask_prob)
                      & (input_mask > 0))
            action = rng.rand(*ids.shape)
            masked[select & (action < 0.8)] = self.mask_id
            rand_pos = select & (action >= 0.8) & (action < 0.9)
            masked[rand_pos] = rng.randint(0, self.vocab_size,
                                           rand_pos.sum())
            if self.sparse_labels:
                labels = ids.astype(np.int32)
            else:
                labels = np.zeros(ids.shape + (self.vocab_size,),
                                  np.float32)
                b_idx, t_idx = np.nonzero(select)
                labels[b_idx, t_idx, ids[b_idx, t_idx]] = 1.0
            yield MultiDataSet(
                features=[masked, input_mask],
                labels=[labels],
                labels_masks=[select.astype(np.float32)])
