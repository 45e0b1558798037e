"""DataSet / MultiDataSet containers (the port of ``data/dataset.py``).

Reference: `org.nd4j.linalg.dataset.DataSet` / `MultiDataSet`
(`nd4j-api/.../dataset/`).  Host-side containers hold numpy arrays; a
model moves them to its device once per step.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np


@dataclasses.dataclass
class DataSet:
    features: np.ndarray
    labels: np.ndarray
    features_mask: Optional[np.ndarray] = None
    labels_mask: Optional[np.ndarray] = None

    def num_examples(self) -> int:
        return int(self.features.shape[0])

    def split_test_and_train(self, n_train: int):
        return (DataSet(self.features[:n_train], self.labels[:n_train]),
                DataSet(self.features[n_train:], self.labels[n_train:]))

    def shuffle(self, seed: Optional[int] = None):
        rng = np.random.default_rng(seed)
        idx = rng.permutation(self.num_examples())
        self.features = self.features[idx]
        self.labels = self.labels[idx]
        if self.features_mask is not None:
            self.features_mask = self.features_mask[idx]
        if self.labels_mask is not None:
            self.labels_mask = self.labels_mask[idx]

    def batch_by(self, batch_size: int) -> List["DataSet"]:
        out = []
        for i in range(0, self.num_examples(), batch_size):
            sl = slice(i, i + batch_size)
            out.append(DataSet(
                self.features[sl], self.labels[sl],
                None if self.features_mask is None else self.features_mask[sl],
                None if self.labels_mask is None else self.labels_mask[sl]))
        return out


@dataclasses.dataclass
class MultiDataSet:
    """Multiple feature/label arrays (reference `MultiDataSet`), used by
    ComputationGraph-style models and SameDiff training."""

    features: Sequence[np.ndarray]
    labels: Sequence[np.ndarray]
    features_masks: Optional[Sequence[Optional[np.ndarray]]] = None
    labels_masks: Optional[Sequence[Optional[np.ndarray]]] = None

    def num_examples(self) -> int:
        return int(self.features[0].shape[0])
