"""RecordReader -> DataSet iterators (the port of ``data/rr_iterator.py``,
the whole module; a model moves each batch to its device in `fit`).

Reference: `deeplearning4j-core/.../datasets/datavec/
{RecordReaderDataSetIterator,SequenceRecordReaderDataSetIterator}.java` —
the bridge from DataVec records to training batches: split off the label
column, one-hot it for classification, batch the rest as features.
"""
from __future__ import annotations

from typing import Iterator, List, Optional

import numpy as np

from deeplearning4j_tpu_torch.data.dataset import DataSet
from deeplearning4j_tpu_torch.data.iterators import DataSetIterator
from deeplearning4j_tpu_torch.data.records import RecordReader


class RecordReaderDataSetIterator(DataSetIterator):
    """Classification: `label_index` column -> one-hot [N, num_classes];
    regression (`regression=True`): label columns taken as-is.  All other
    columns become float features (reference semantics)."""

    def __init__(self, reader: RecordReader, batch_size: int,
                 label_index: int = -1, num_classes: Optional[int] = None,
                 regression: bool = False,
                 label_index_to: Optional[int] = None):
        if not regression and num_classes is None:
            # per-batch inference would give inconsistent one-hot widths
            # (the reference likewise requires numPossibleLabels)
            raise ValueError("num_classes is required for classification")
        self.reader = reader
        self._bs = batch_size
        self.label_index = label_index
        self.num_classes = num_classes
        self.regression = regression
        self.label_index_to = label_index_to

    def batch_size(self) -> int:
        return self._bs

    def reset(self):
        self.reader.reset()

    def _split(self, rec) -> tuple:
        li = self.label_index if self.label_index >= 0 \
            else len(rec) + self.label_index
        hi = li if self.label_index_to is None else self.label_index_to
        feats, labels = [], []
        for i, v in enumerate(rec):
            if li <= i <= hi:
                labels.append(v)
            else:
                feats.append(v)
        if len(feats) == 1 and isinstance(feats[0], np.ndarray) \
                and feats[0].ndim >= 2:
            # single tensor feature (ImageRecordReader): keep its shape —
            # the reference likewise emits [N, C, H, W] batches for images
            return np.asarray(feats[0], np.float32), labels
        f = np.concatenate([np.asarray(x, np.float32).ravel()
                            if isinstance(x, np.ndarray)
                            else np.asarray([float(x)], np.float32)
                            for x in feats])
        return f, labels

    def __iter__(self) -> Iterator[DataSet]:
        feats: List[np.ndarray] = []
        labels: List = []
        for rec in self.reader:
            f, l = self._split(rec)
            feats.append(f)
            labels.append(l)
            if len(feats) == self._bs:
                yield self._emit(feats, labels)
                feats, labels = [], []
        if feats:
            yield self._emit(feats, labels)

    def _emit(self, feats, labels) -> DataSet:
        x = np.stack(feats)
        if self.regression:
            y = np.asarray(labels, np.float32)
        else:
            idx = np.asarray([int(float(l[0])) for l in labels])
            y = np.eye(self.num_classes, dtype=np.float32)[idx]
        return DataSet(x, y)


class SequenceRecordReaderDataSetIterator(DataSetIterator):
    """Sequence reader -> [B, T, F] batches with padding masks (reference
    `SequenceRecordReaderDataSetIterator` ALIGN_END=False/ALIGN_START
    semantics: pad at the end, mask marks real steps)."""

    def __init__(self, reader: RecordReader, batch_size: int,
                 label_index: int = -1, num_classes: Optional[int] = None,
                 regression: bool = False):
        if not regression and num_classes is None:
            raise ValueError("num_classes is required for classification")
        self.reader = reader
        self._bs = batch_size
        self.label_index = label_index
        self.num_classes = num_classes
        self.regression = regression

    def batch_size(self) -> int:
        return self._bs

    def reset(self):
        self.reader.reset()

    def __iter__(self) -> Iterator[DataSet]:
        seqs = []
        for seq in self.reader:
            seqs.append(seq)
            if len(seqs) == self._bs:
                yield self._emit(seqs)
                seqs = []
        if seqs:
            yield self._emit(seqs)

    def _emit(self, seqs) -> DataSet:
        T = max(len(s) for s in seqs)
        sample_f, sample_l = self._split_step(seqs[0][0])
        F = len(sample_f)
        B = len(seqs)
        x = np.zeros((B, T, F), np.float32)
        mask = np.zeros((B, T), np.float32)
        if self.regression:
            L = len(sample_l)
            y = np.zeros((B, T, L), np.float32)
        else:
            y = np.zeros((B, T, self.num_classes), np.float32)
        for b, seq in enumerate(seqs):
            for t, rec in enumerate(seq):
                f, l = self._split_step(rec)
                x[b, t] = f
                mask[b, t] = 1.0
                if self.regression:
                    y[b, t] = l
                else:
                    y[b, t, int(float(l[0]))] = 1.0
        return DataSet(x, y, features_mask=mask, labels_mask=mask)

    def _split_step(self, rec):
        li = self.label_index if self.label_index >= 0 \
            else len(rec) + self.label_index
        f = [float(v) for i, v in enumerate(rec) if i != li]
        return np.asarray(f, np.float32), [float(rec[li])]
