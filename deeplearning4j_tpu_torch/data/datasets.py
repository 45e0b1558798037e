"""Built-in dataset iterators (the port of ``data/datasets.py``, the whole
module: numpy, local files only; reference `deeplearning4j-datasets/.../
iterator/impl/{MnistDataSetIterator,EmnistDataSetIterator,...}.java`).

The reference downloads from a blob store; this environment has zero
egress, so `MnistDataSetIterator` reads already-present IDX files
(`MNIST_DIR` env or explicit path) and `SyntheticMnist` provides a
deterministic stand-in with the same shapes for tests/benchmarks.
"""
from __future__ import annotations

import gzip
import os
import struct
from typing import Iterator, Optional

import numpy as np

from deeplearning4j_tpu_torch.data.dataset import DataSet
from deeplearning4j_tpu_torch.data.iterators import DataSetIterator


def read_idx(path: str) -> np.ndarray:
    """Parse an IDX (MNIST) file, gzip or raw."""
    op = gzip.open if path.endswith(".gz") else open
    with op(path, "rb") as f:
        zero, dtype_code, ndim = struct.unpack(">HBB", f.read(4))
        if zero != 0:
            raise ValueError(f"{path}: bad IDX magic")
        dims = struct.unpack(">" + "I" * ndim, f.read(4 * ndim))
        # IDX payloads are big-endian
        dtypes = {0x08: np.uint8, 0x09: np.int8, 0x0B: np.dtype(">i2"),
                  0x0C: np.dtype(">i4"), 0x0D: np.dtype(">f4"),
                  0x0E: np.dtype(">f8")}
        data = np.frombuffer(f.read(), dtypes[dtype_code])
        return data.reshape(dims)



class _ArrayDataSetIterator(DataSetIterator):
    """Shared shuffled/drop-last batching over in-memory (x, y) arrays —
    the common substrate of the MNIST/EMNIST/CIFAR/IMDB iterators.  A
    subclass may set `self.mask` to emit per-batch features masks."""

    mask: Optional[np.ndarray] = None

    def _init_batching(self, batch_size: int, shuffle: bool, seed: int):
        self._bs = batch_size
        self._shuffle = shuffle
        self._rng = np.random.default_rng(seed)

    def batch_size(self) -> int:
        return self._bs

    def __iter__(self) -> Iterator[DataSet]:
        idx = np.arange(len(self.x))
        if self._shuffle:
            self._rng.shuffle(idx)
        for i in range(0, len(idx) - self._bs + 1, self._bs):
            sl = idx[i:i + self._bs]
            yield DataSet(self.x[sl], self.y[sl],
                          features_mask=None if self.mask is None
                          else self.mask[sl])


class MnistDataSetIterator(_ArrayDataSetIterator):
    """MNIST batches, NHWC [B, 28, 28, 1] in [0, 1], one-hot labels
    (reference `MnistDataSetIterator`)."""

    FILES = {
        True: ("train-images-idx3-ubyte", "train-labels-idx1-ubyte"),
        False: ("t10k-images-idx3-ubyte", "t10k-labels-idx1-ubyte"),
    }

    def __init__(self, batch_size: int, train: bool = True,
                 data_dir: Optional[str] = None, seed: int = 0,
                 shuffle: bool = True):
        data_dir = data_dir or os.environ.get("MNIST_DIR", "")
        img_name, lbl_name = self.FILES[train]
        img_path = self._find(data_dir, img_name)
        lbl_path = self._find(data_dir, lbl_name)
        x = read_idx(img_path).astype(np.float32) / 255.0
        self.x = x[..., None]
        self.y = np.eye(10, dtype=np.float32)[read_idx(lbl_path)]
        self._init_batching(batch_size, shuffle, seed)

    @staticmethod
    def _find(data_dir: str, name: str, dataset: str = "MNIST",
              env_var: str = "MNIST_DIR",
              synthetic: str = "SyntheticMnist") -> str:
        for cand in (os.path.join(data_dir, name),
                     os.path.join(data_dir, name + ".gz")):
            if os.path.exists(cand):
                return cand
        raise FileNotFoundError(
            f"{dataset} file {name}[.gz] not found in '{data_dir}' — no "
            f"download possible (zero egress); set {env_var}"
            + (f" or use {synthetic}" if synthetic else ""))



class SyntheticMnist(DataSetIterator):
    """Deterministic MNIST-shaped synthetic data: each class is a noisy
    fixed template, linearly separable enough for convergence tests."""

    def __init__(self, batch_size: int, n_batches: int = 10, seed: int = 0,
                 template_seed: int = 0):
        """`template_seed` fixes the class templates (shared across train/
        val splits); `seed` only drives sampling noise/labels."""
        self._bs = batch_size
        self._n = n_batches
        rng = np.random.RandomState(template_seed)
        self._templates = rng.rand(10, 28, 28, 1).astype(np.float32)
        self._seed = seed

    def batch_size(self) -> int:
        return self._bs

    def __iter__(self) -> Iterator[DataSet]:
        rng = np.random.RandomState(self._seed + 1)
        for _ in range(self._n):
            labels = rng.randint(0, 10, self._bs)
            x = (0.7 * self._templates[labels]
                 + 0.3 * rng.rand(self._bs, 28, 28, 1)).astype(np.float32)
            yield DataSet(x, np.eye(10, dtype=np.float32)[labels])


class IrisDataSetIterator(DataSetIterator):
    """The classic 150-sample Iris set, generated from the canonical values
    via a compact embedded table (reference `IrisDataSetIterator` ships the
    CSV in-jar; we embed a synthetic-but-separable equivalent)."""

    def __init__(self, batch_size: int = 150, seed: int = 0):
        self._bs = batch_size
        rng = np.random.RandomState(seed)
        centers = np.array([[5.0, 3.4, 1.5, 0.2],
                            [5.9, 2.8, 4.3, 1.3],
                            [6.6, 3.0, 5.6, 2.0]], np.float32)
        xs, ys = [], []
        for k in range(3):
            xs.append(centers[k] + rng.randn(50, 4).astype(np.float32) * 0.25)
            ys.append(np.full(50, k))
        self.x = np.concatenate(xs)
        self.y = np.eye(3, dtype=np.float32)[np.concatenate(ys)]
        idx = rng.permutation(150)
        self.x, self.y = self.x[idx], self.y[idx]

    def batch_size(self) -> int:
        return self._bs

    def __iter__(self) -> Iterator[DataSet]:
        for i in range(0, 150, self._bs):
            yield DataSet(self.x[i:i + self._bs], self.y[i:i + self._bs])


class Cifar10DataSetIterator(_ArrayDataSetIterator):
    """CIFAR-10 batches, NHWC [B, 32, 32, 3] in [0, 1], one-hot labels
    (reference `Cifar10DataSetIterator`).  Reads the canonical binary
    format: per record 1 label byte + 3072 CHW pixel bytes, files
    `data_batch_{1..5}.bin` / `test_batch.bin` (CIFAR_DIR env or explicit
    path) — the reference downloads the same files; zero egress here."""

    def __init__(self, batch_size: int, train: bool = True,
                 data_dir: Optional[str] = None, seed: int = 0,
                 shuffle: bool = True):
        data_dir = data_dir or os.environ.get("CIFAR_DIR", "")
        names = [f"data_batch_{i}.bin" for i in range(1, 6)] if train \
            else ["test_batch.bin"]
        xs, ys = [], []
        for name in names:
            path = os.path.join(data_dir, name)
            if not os.path.exists(path):
                raise FileNotFoundError(
                    f"CIFAR-10 file {name} not found in '{data_dir}' — no "
                    "download possible (zero egress); set CIFAR_DIR or use "
                    "SyntheticCifar10")
            raw = np.frombuffer(open(path, "rb").read(), np.uint8)
            rec = raw.reshape(-1, 3073)
            ys.append(rec[:, 0])
            # stored CHW -> NHWC
            xs.append(rec[:, 1:].reshape(-1, 3, 32, 32)
                      .transpose(0, 2, 3, 1))
        self.x = np.concatenate(xs).astype(np.float32) / 255.0
        self.y = np.eye(10, dtype=np.float32)[np.concatenate(ys)]
        self._init_batching(batch_size, shuffle, seed)



class SyntheticCifar10(DataSetIterator):
    """CIFAR-shaped deterministic stand-in (same role as SyntheticMnist)."""

    def __init__(self, batch_size: int, n_batches: int = 10, seed: int = 0):
        self._bs = batch_size
        self._n = n_batches
        rng = np.random.RandomState(0)
        self._templates = rng.rand(10, 32, 32, 3).astype(np.float32)
        self._seed = seed

    def batch_size(self) -> int:
        return self._bs

    def __iter__(self) -> Iterator[DataSet]:
        rng = np.random.RandomState(self._seed + 1)
        for _ in range(self._n):
            labels = rng.randint(0, 10, self._bs)
            x = (0.7 * self._templates[labels]
                 + 0.3 * rng.rand(self._bs, 32, 32, 3)).astype(np.float32)
            yield DataSet(x, np.eye(10, dtype=np.float32)[labels])


class EmnistDataSetIterator(_ArrayDataSetIterator):
    """EMNIST batches (reference `EmnistDataSetIterator` with its `Set`
    enum): same IDX format as MNIST, split-dependent class count.  Files
    `emnist-{split}-{train|test}-images-idx3-ubyte[.gz]` under EMNIST_DIR
    or `data_dir`."""

    NUM_CLASSES = {"byclass": 62, "bymerge": 47, "balanced": 47,
                   "letters": 26, "digits": 10, "mnist": 10}

    def __init__(self, split: str, batch_size: int, train: bool = True,
                 data_dir: Optional[str] = None, seed: int = 0,
                 shuffle: bool = True):
        split = split.lower()
        if split not in self.NUM_CLASSES:
            raise ValueError(f"Unknown EMNIST split '{split}'; one of "
                             f"{sorted(self.NUM_CLASSES)}")
        self.n_classes = self.NUM_CLASSES[split]
        data_dir = data_dir or os.environ.get("EMNIST_DIR", "")
        part = "train" if train else "test"
        img = MnistDataSetIterator._find(
            data_dir, f"emnist-{split}-{part}-images-idx3-ubyte",
            dataset="EMNIST", env_var="EMNIST_DIR", synthetic="")
        lbl = MnistDataSetIterator._find(
            data_dir, f"emnist-{split}-{part}-labels-idx1-ubyte",
            dataset="EMNIST", env_var="EMNIST_DIR", synthetic="")
        # official EMNIST IDX images are stored transposed relative to
        # MNIST orientation (NIST column-major conversion); flip them
        x = read_idx(img).transpose(0, 2, 1)
        self.x = (x.astype(np.float32) / 255.0)[..., None]
        labels = read_idx(lbl).astype(np.int64)
        if split == "letters":      # letters split is 1-indexed
            labels = labels - 1
        self.y = np.eye(self.n_classes, dtype=np.float32)[labels]
        self._init_batching(batch_size, shuffle, seed)


class ImdbReviewIterator(_ArrayDataSetIterator):
    """IMDB sentiment batches over the standard `aclImdb/` directory layout
    (`{train|test}/{pos|neg}/*.txt`) — the reference's IMDB path is
    `CnnSentenceDataSetIterator` over the aclImdb corpus
    (`deeplearning4j-nlp/.../iterator/CnnSentenceDataSetIterator.java` +
    dataset fetch in dl4j-examples).  Zero egress: reads an already-present
    tree (IMDB_DIR env or `data_dir`).

    Yields token-id features [B, T] (int32) with a [B, T] features mask and
    one-hot [B, 2] labels (pos=1).  Builds its vocabulary from the training
    text on first pass unless `vocab` is given."""

    def __init__(self, batch_size: int, train: bool = True,
                 data_dir: Optional[str] = None, max_len: int = 256,
                 vocab: Optional[dict] = None, vocab_size: int = 20000,
                 seed: int = 0, shuffle: bool = True):
        root = data_dir or os.environ.get("IMDB_DIR", "")
        part = os.path.join(root, "train" if train else "test")
        if not os.path.isdir(part):
            raise FileNotFoundError(
                f"IMDB directory '{part}' not found — set IMDB_DIR to an "
                "aclImdb/ tree (zero-egress environment: no auto-download; "
                "use SyntheticImdb for tests)")
        texts, labels = [], []
        for label, sub in ((1, "pos"), (0, "neg")):
            d = os.path.join(part, sub)
            for fn in sorted(os.listdir(d)):
                if fn.endswith(".txt"):
                    with open(os.path.join(d, fn), encoding="utf-8",
                              errors="replace") as f:
                        texts.append(f.read())
                    labels.append(label)
        tokenized = [self._tokenize(t) for t in texts]
        if vocab is None:
            # vocabulary always comes from the TRAIN split so train/test
            # token ids agree (pass the train iterator's .vocab explicitly
            # to skip the extra pass)
            if train:
                source = tokenized
            else:
                train_dir = os.path.join(root, "train")
                if not os.path.isdir(train_dir):
                    raise FileNotFoundError(
                        f"building a vocab for the test split needs "
                        f"'{train_dir}' (or pass vocab=train_iter.vocab)")
                source = []
                for sub in ("pos", "neg"):
                    d = os.path.join(train_dir, sub)
                    for fn in sorted(os.listdir(d)):
                        if fn.endswith(".txt"):
                            with open(os.path.join(d, fn), encoding="utf-8",
                                      errors="replace") as f:
                                source.append(self._tokenize(f.read()))
            from collections import Counter
            counts = Counter(w for toks in source for w in toks)
            # 0 = pad, 1 = unk
            vocab = {w: i + 2 for i, (w, _) in
                     enumerate(counts.most_common(vocab_size - 2))}
        self.vocab = vocab
        self.max_len = max_len
        n = len(tokenized)
        self.x = np.zeros((n, max_len), np.int32)
        self.mask = np.zeros((n, max_len), np.float32)
        for i, toks in enumerate(tokenized):
            ids = [vocab.get(w, 1) for w in toks[:max_len]]
            self.x[i, :len(ids)] = ids
            self.mask[i, :len(ids)] = 1.0
        self.y = np.eye(2, dtype=np.float32)[np.asarray(labels)]
        self._init_batching(batch_size, shuffle, seed)

    @staticmethod
    def _tokenize(text: str):
        import re
        return re.findall(r"[a-z0-9']+", text.lower())


class SyntheticImdb(DataSetIterator):
    """IMDB-shaped synthetic sentiment data: class-dependent token
    distributions over a small vocabulary (tests/benchmarks stand-in, same
    contract as ImdbReviewIterator)."""

    def __init__(self, batch_size: int, n_batches: int = 10,
                 max_len: int = 64, vocab_size: int = 500, seed: int = 0):
        self._bs = batch_size
        self._n = n_batches
        self._t = max_len
        self._v = vocab_size
        self._seed = seed

    def batch_size(self) -> int:
        return self._bs

    def __iter__(self) -> Iterator[DataSet]:
        rng = np.random.default_rng(self._seed)
        half = self._v // 2
        for _ in range(self._n):
            y_cls = rng.integers(0, 2, self._bs)
            lens = rng.integers(self._t // 4, self._t + 1, self._bs)
            x = np.zeros((self._bs, self._t), np.int32)
            mask = np.zeros((self._bs, self._t), np.float32)
            for i in range(self._bs):
                # positive reviews skew toward the upper half of the vocab
                lo, hi = (2, half) if y_cls[i] == 0 else (half, self._v)
                x[i, :lens[i]] = rng.integers(lo, hi, lens[i])
                mask[i, :lens[i]] = 1.0
            yield DataSet(x, np.eye(2, dtype=np.float32)[y_cls],
                          features_mask=mask)

