"""DataVec's record readers, TransformProcess, the record-reader iterators
and the built-in dataset iterators of the PyTorch port against the JAX
package's.

Both packages read the same tiny files, which each test writes into
`tmp_path` from a numpy seed (CSV, CSV sequences, JSON lines, SVMLight,
regex logs, `.npy` images and frame directories, IDX, CIFAR binary, an
aclImdb tree): every record, array and batch is equal, values and dtypes.
`TransformProcess.to_json()` gives the same string in both packages and
either package reads the other's.  `LocalTransformExecutor` runs its
workers as subprocesses: each test that starts one gives it its own time
limit.  Nothing here reads a file outside `tmp_path`.
"""
import torch_test_threads  # noqa: F401  (first: one torch thread a worker)
import gzip
import json
import os
import struct

import numpy as np
import pytest

from deeplearning4j_tpu.data import datasets as jds
from deeplearning4j_tpu.data import local_execution as jle
from deeplearning4j_tpu.data import records as jrec
from deeplearning4j_tpu.data import rr_iterator as jrr
from deeplearning4j_tpu.data import transform as jtf
from deeplearning4j_tpu_torch import data as tdata
from deeplearning4j_tpu_torch.data import datasets as tds
from deeplearning4j_tpu_torch.data import local_execution as tle
from deeplearning4j_tpu_torch.data import records as trec
from deeplearning4j_tpu_torch.data import rr_iterator as trr
from deeplearning4j_tpu_torch.data import transform as ttf

WORKER_TIMEOUT = 60.0


def _same(a, b, path="record"):
    """Deep equality of records: lists, scalars, strings, arrays (values,
    shapes and dtypes)."""
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        assert isinstance(a, np.ndarray) and isinstance(b, np.ndarray), path
        assert a.dtype == b.dtype and a.shape == b.shape, path
        assert np.array_equal(a, b), path
    elif isinstance(a, (list, tuple)):
        assert isinstance(b, (list, tuple)) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{path}[{i}]")
    else:
        assert type(a) is type(b) and a == b, f"{path}: {a!r} != {b!r}"


def _same_batches(jit, tit):
    jb, tb = list(jit), list(tit)
    assert len(jb) == len(tb) > 0
    for a, b in zip(jb, tb):
        for f in ("features", "labels", "features_mask", "labels_mask"):
            _same(getattr(a, f), getattr(b, f), f)


def _csv(tmp_path, rows=23, seed=0, name="data.csv"):
    rs = np.random.RandomState(seed)
    lines = ["a,b,c,cls"] + [f"{rs.randn():.6f},{rs.rand():.6f},{rs.randint(0, 9)},"
                             f"{['cat', 'dog', 'eel'][rs.randint(0, 3)]}"
                             for _ in range(rows)]
    p = tmp_path / name
    p.write_text("\n".join(lines) + "\n")
    return str(p)


def _schema(mod):
    return (mod.Schema.builder().add_column_string("a", "b").add_column_integer("c")
            .add_column_categorical("cls", ["cat", "dog", "eel"]).build())


def _tp(mod):
    return (mod.TransformProcess.builder(_schema(mod))
            .string_to_double("a", "b").categorical_to_integer("cls")
            .math_op_double("b", "Multiply", 10.0).rename_column("c", "count")
            .build())


# ---------------------------------------------------------------------------
# readers
# ---------------------------------------------------------------------------

def test_csv_line_and_collection_readers(tmp_path):
    path = _csv(tmp_path)
    for jr, tr in ((jrec.CSVRecordReader(path, skip_lines=1),
                    trec.CSVRecordReader(path, skip_lines=1)),
                   (jrec.CSVRecordReader(text="1;2\n3;4\n", delimiter=";"),
                    trec.CSVRecordReader(text="1;2\n3;4\n", delimiter=";")),
                   (jrec.LineRecordReader(path), trec.LineRecordReader(path)),
                   (jrec.CollectionRecordReader([[1, "x"], [2.5, "y"]]),
                    trec.CollectionRecordReader([[1, "x"], [2.5, "y"]]))):
        _same(list(jr), list(tr))
        tr.reset()
        assert tr.next_record() == list(tr)[0]
    with pytest.raises(ValueError, match="Exactly one"):
        trec.CSVRecordReader()


def test_sequence_and_regex_readers(tmp_path):
    paths = []
    rs = np.random.RandomState(1)
    for i in range(3):
        p = tmp_path / f"seq{i}.csv"
        p.write_text("".join(f"{rs.rand():.5f},{rs.randint(0, 2)}\n"
                             for _ in range(2 + i)))
        paths.append(str(p))
    _same(list(jrec.CSVSequenceRecordReader(paths)),
          list(trec.CSVSequenceRecordReader(paths)))
    log = tmp_path / "app.log"
    log.write_text("header\n10:01 INFO start\n10:02 WARN disk 91\n10:03 INFO stop\n")
    rx = r"(\d+:\d+) (\w+) (.*)"
    _same(list(jrec.RegexLineRecordReader(rx, 1, path=str(log))),
          list(trec.RegexLineRecordReader(rx, 1, path=str(log))))
    _same(list(jrec.RegexSequenceRecordReader(rx, [str(log)], 1)),
          list(trec.RegexSequenceRecordReader(rx, [str(log)], 1)))
    with pytest.raises(ValueError, match="does not match"):
        list(trec.RegexLineRecordReader(rx, 0, path=str(log)))


def test_jackson_and_svmlight_readers(tmp_path):
    js = tmp_path / "rows.jsonl"
    js.write_text("\n".join(json.dumps(o) for o in (
        {"a": 1, "b": {"c": "x"}}, {"a": 2.5}, {"b": {"c": "y"}, "z": 0})) + "\n")
    fields, defaults = ["a", "b/c"], [0, "none"]
    _same(list(jrec.JacksonLineRecordReader(fields, path=str(js), defaults=defaults)),
          list(trec.JacksonLineRecordReader(fields, path=str(js), defaults=defaults)))
    svm = tmp_path / "data.svm"
    svm.write_text("1 1:0.5 3:2 # a comment\n0 qid:4 2:-1.25\n\n2 4:7\n")
    for kw in (dict(), dict(append_label=False), dict(zero_based=True, num_features=5)):
        n = kw.pop("num_features", 4)
        _same(list(jrec.SVMLightRecordReader(n, path=str(svm), **kw)),
              list(trec.SVMLightRecordReader(n, path=str(svm), **kw)))
    multi = "1,3 1:1\n2 2:1\n"
    _same(list(jrec.LibSvmRecordReader(2, text=multi, multilabel=True)),
          list(trec.LibSvmRecordReader(2, text=multi, multilabel=True)))
    with pytest.raises(ValueError, match="multilabel"):
        list(trec.SVMLightRecordReader(2, text=multi))


def _images(tmp_path, n=6, shape=(4, 5, 3)):
    rs = np.random.RandomState(2)
    paths = []
    for i in range(n):
        d = tmp_path / "img" / ("ant" if i % 2 else "bee")
        d.mkdir(parents=True, exist_ok=True)
        p = d / f"{i}.npy"
        np.save(p, (rs.rand(*shape) * 255).astype(np.float32))
        paths.append(str(p))
    return paths


def test_image_and_video_readers_on_npy(tmp_path):
    paths = _images(tmp_path)
    _same(list(jrec.ImageRecordReader(paths, 4, 5, 3)),
          list(trec.ImageRecordReader(paths, 4, 5, 3)))
    assert trec.ImageRecordReader(paths, 4, 5, 3).labels == ["ant", "bee"]
    frames = tmp_path / "clip"
    frames.mkdir()
    rs = np.random.RandomState(3)
    for i in range(4):
        np.save(frames / f"f{i:02d}.npy", rs.rand(4, 5, 1).astype(np.float32))
    _same(list(jrec.VideoRecordReader([str(frames)], 4, 5, 1, max_frames=3)),
          list(trec.VideoRecordReader([str(frames)], 4, 5, 1, max_frames=3)))
    with pytest.raises(ValueError, match="shape"):
        list(trec.ImageRecordReader(paths, 4, 4, 3))


def test_image_reader_decodes_png_through_pil(tmp_path):
    pil = pytest.importorskip("PIL.Image")
    d = tmp_path / "png" / "cat"
    d.mkdir(parents=True)
    rs = np.random.RandomState(4)
    p = d / "0.png"
    pil.fromarray((rs.rand(6, 7, 3) * 255).astype(np.uint8)).save(p)
    _same(list(jrec.ImageRecordReader([str(p)], 3, 4, 3)),
          list(trec.ImageRecordReader([str(p)], 3, 4, 3)))


# ---------------------------------------------------------------------------
# TransformProcess
# ---------------------------------------------------------------------------

def test_transform_process_json_and_records(tmp_path):
    path = _csv(tmp_path)
    jtp, ttp = _tp(jtf), _tp(ttf)
    assert ttp.to_json() == jtp.to_json()
    assert ttf.TransformProcess.from_json(jtp.to_json()).to_json() == jtp.to_json()
    assert jtf.TransformProcess.from_json(ttp.to_json()).to_json() == jtp.to_json()
    assert ttp.final_schema().to_json() == jtp.final_schema().to_json()
    recs = list(trec.CSVRecordReader(path, skip_lines=1))
    _same(jtp.execute(recs), ttp.execute(recs))
    onehot = (ttf.TransformProcess.builder(_schema(ttf)).categorical_to_one_hot("cls")
              .keep_columns("cls[dog]", "a").remove_columns("a").build())
    jonehot = (jtf.TransformProcess.builder(_schema(jtf)).categorical_to_one_hot("cls")
               .keep_columns("cls[dog]", "a").remove_columns("a").build())
    assert onehot.to_json() == jonehot.to_json()
    _same(jonehot.execute(recs), onehot.execute(recs))
    keep = lambda s, r: r[s.index_of("c")] != "0"           # noqa: E731
    jf = jtf.TransformProcess.builder(_schema(jtf)).filter_by_condition(keep).build()
    tf = ttf.TransformProcess.builder(_schema(ttf)).filter_by_condition(keep).build()
    _same(jf.execute(recs), tf.execute(recs))
    with pytest.raises(ValueError, match="cannot be serialized"):
        tf.to_json()
    _same(list(jrec.TransformProcessRecordReader(jrec.CSVRecordReader(path, 1), jf)),
          list(trec.TransformProcessRecordReader(trec.CSVRecordReader(path, 1), tf)))


def test_transform_process_sequence_reader(tmp_path):
    p = tmp_path / "s.csv"
    p.write_text("1,cat\n0,dog\n3,eel\n")
    schema = lambda m: (m.Schema.builder().add_column_string("v")     # noqa: E731
                        .add_column_categorical("k", ["cat", "dog", "eel"]).build())
    tp = lambda m: (m.TransformProcess.builder(schema(m)).string_to_double("v")  # noqa: E731
                    .categorical_to_integer("k")
                    .filter_by_condition(lambda s, r: r[0] > 0).build())
    _same(list(jrec.TransformProcessSequenceRecordReader(
              jrec.CSVSequenceRecordReader([str(p)]), tp(jtf))),
          list(trec.TransformProcessSequenceRecordReader(
              trec.CSVSequenceRecordReader([str(p)]), tp(ttf))))


def test_local_transform_executor_matches_inline_and_jax(tmp_path):
    """Three worker processes, each killed (and the call failed) past
    WORKER_TIMEOUT seconds."""
    recs = list(trec.CSVRecordReader(_csv(tmp_path, rows=31), skip_lines=1))
    ttp, jtp = _tp(ttf), _tp(jtf)
    got = tle.LocalTransformExecutor(num_workers=3, timeout=WORKER_TIMEOUT).execute(recs, ttp)
    want = jle.LocalTransformExecutor(num_workers=0).execute(recs, jtp)
    _same(want, got)
    _same(ttp.execute(recs), got)


def test_local_transform_executor_worker_loads_no_package(tmp_path):
    """A worker runs transform.py by path with the package stubbed: it
    loads neither torch nor the package's __init__, and finishes well
    inside its limit."""
    import subprocess
    import sys
    code = ("import sys; "
            f"sys.path.insert(0, {os.path.dirname(tle.__file__)!r}); "
            "import local_execution as le; t = le._load_transform_module(); "
            "print('torch' in sys.modules, t.__name__)")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=WORKER_TIMEOUT, cwd=str(tmp_path))
    assert out.stdout.split() == ["False", "deeplearning4j_tpu_torch.data.transform"], \
        out.stderr


# ---------------------------------------------------------------------------
# record-reader iterators
# ---------------------------------------------------------------------------

def test_record_reader_dataset_iterator_classification_and_regression(tmp_path):
    path = _csv(tmp_path)
    for kw in (dict(batch_size=5, label_index=-1, num_classes=3),
               dict(batch_size=7, label_index=2, regression=True),
               dict(batch_size=4, label_index=0, label_index_to=1, regression=True)):
        jit = jrr.RecordReaderDataSetIterator(
            jrec.TransformProcessRecordReader(jrec.CSVRecordReader(path, 1), _tp(jtf)), **kw)
        tit = trr.RecordReaderDataSetIterator(
            trec.TransformProcessRecordReader(trec.CSVRecordReader(path, 1), _tp(ttf)), **kw)
        _same_batches(jit, tit)
        tit.reset()
        _same_batches(jit, tit)            # restartable
    paths = _images(tmp_path)
    _same_batches(jrr.RecordReaderDataSetIterator(jrec.ImageRecordReader(paths, 4, 5, 3), 4,
                                                  num_classes=2),
                  trr.RecordReaderDataSetIterator(trec.ImageRecordReader(paths, 4, 5, 3), 4,
                                                  num_classes=2))
    with pytest.raises(ValueError, match="num_classes"):
        trr.RecordReaderDataSetIterator(trec.CSVRecordReader(path), 4)


def test_sequence_record_reader_dataset_iterator(tmp_path):
    rs = np.random.RandomState(5)
    paths = []
    for i in range(5):
        p = tmp_path / f"s{i}.csv"
        p.write_text("".join(f"{rs.rand():.4f},{rs.rand():.4f},{rs.randint(0, 3)}\n"
                             for _ in range(1 + i % 3)))
        paths.append(str(p))
    for kw in (dict(num_classes=3), dict(regression=True, label_index=0)):
        _same_batches(jrr.SequenceRecordReaderDataSetIterator(
                          jrec.CSVSequenceRecordReader(paths), 2, **kw),
                      trr.SequenceRecordReaderDataSetIterator(
                          trec.CSVSequenceRecordReader(paths), 2, **kw))


def test_csv_to_normalized_batches_is_the_port_datasets_type(tmp_path):
    """The canonical CSV path ends in the port's own DataSet, which its
    normalizers and networks take."""
    it = tdata.RecordReaderDataSetIterator(
        tdata.TransformProcessRecordReader(tdata.CSVRecordReader(_csv(tmp_path), 1),
                                           _tp(ttf)), 8, num_classes=3)
    nz = tdata.NormalizerStandardize().fit(it)
    it.set_pre_processor(nz)
    b = next(iter(it))
    assert isinstance(b, tdata.DataSet) and b.features.shape == (8, 3)
    assert abs(float(np.mean(np.concatenate([d.features for d in it]), 0)[0])) < 1e-5


# ---------------------------------------------------------------------------
# built-in datasets, local files only
# ---------------------------------------------------------------------------

def _idx(path, arr, code, gz=False):
    header = struct.pack(">HBB", 0, code, arr.ndim) + struct.pack(
        ">" + "I" * arr.ndim, *arr.shape)
    payload = header + arr.astype(arr.dtype.newbyteorder(">")).tobytes()
    with (gzip.open if gz else open)(path, "wb") as f:
        f.write(payload)


def test_read_idx_every_dtype_raw_and_gzip(tmp_path):
    rs = np.random.RandomState(6)
    for code, dt in ((0x08, np.uint8), (0x09, np.int8), (0x0B, np.int16),
                     (0x0C, np.int32), (0x0D, np.float32), (0x0E, np.float64)):
        arr = (rs.randn(3, 4, 2) * 50).astype(dt)
        for gz in (False, True):
            p = str(tmp_path / f"a{code}.idx{'.gz' if gz else ''}")
            _idx(p, arr, code, gz)
            _same(jds.read_idx(p), tds.read_idx(p))
            assert np.array_equal(tds.read_idx(p), arr)
    bad = tmp_path / "bad.idx"
    bad.write_bytes(b"\x01\x00\x08\x01\x00\x00\x00\x01\x00")
    with pytest.raises(ValueError, match="magic"):
        tds.read_idx(str(bad))


def _mnist_dir(tmp_path, prefix="", n=10, labels=10, gz=True):
    rs = np.random.RandomState(7)
    d = tmp_path / "mnist"
    d.mkdir(exist_ok=True)
    for part in ("train", "t10k") if not prefix else ("train", "test"):
        img = f"{prefix}{part}-images-idx3-ubyte"
        lbl = f"{prefix}{part}-labels-idx1-ubyte"
        _idx(str(d / (img + (".gz" if gz else ""))),
             rs.randint(0, 256, (n, 28, 28)).astype(np.uint8), 0x08, gz)
        _idx(str(d / (lbl + (".gz" if gz else ""))),
             rs.randint(1 if prefix.endswith("letters-") else 0, labels, n).astype(np.uint8),
             0x08, gz)
    return str(d)


def test_mnist_and_emnist_from_local_idx(tmp_path, monkeypatch):
    d = _mnist_dir(tmp_path)
    for train in (True, False):
        _same_batches(jds.MnistDataSetIterator(3, train=train, data_dir=d, seed=1),
                      tds.MnistDataSetIterator(3, train=train, data_dir=d, seed=1))
    monkeypatch.setenv("MNIST_DIR", d)
    _same_batches(jds.MnistDataSetIterator(4, shuffle=False),
                  tds.MnistDataSetIterator(4, shuffle=False))
    monkeypatch.setenv("MNIST_DIR", str(tmp_path / "none"))
    with pytest.raises(FileNotFoundError, match="MNIST_DIR"):
        tds.MnistDataSetIterator(4)
    e = _mnist_dir(tmp_path, prefix="emnist-letters-", labels=27, gz=False)
    _same_batches(jds.EmnistDataSetIterator("letters", 5, data_dir=e),
                  tds.EmnistDataSetIterator("letters", 5, data_dir=e))
    monkeypatch.setenv("EMNIST_DIR", e)
    assert tds.EmnistDataSetIterator("letters", 5, train=False).n_classes == 26
    with pytest.raises(ValueError, match="Unknown EMNIST split"):
        tds.EmnistDataSetIterator("nope", 5)


def test_cifar10_from_local_binary(tmp_path, monkeypatch):
    rs = np.random.RandomState(8)
    for name in [f"data_batch_{i}.bin" for i in range(1, 6)] + ["test_batch.bin"]:
        rec = np.concatenate([rs.randint(0, 10, (4, 1)), rs.randint(0, 256, (4, 3072))], 1)
        (tmp_path / name).write_bytes(rec.astype(np.uint8).tobytes())
    monkeypatch.setenv("CIFAR_DIR", str(tmp_path))
    for train in (True, False):
        _same_batches(jds.Cifar10DataSetIterator(3, train=train, seed=2),
                      tds.Cifar10DataSetIterator(3, train=train, seed=2))
    with pytest.raises(FileNotFoundError, match="CIFAR_DIR"):
        tds.Cifar10DataSetIterator(3, data_dir=str(tmp_path / "none"))


def test_imdb_from_a_local_tree(tmp_path, monkeypatch):
    rs = np.random.RandomState(9)
    words = ["good", "bad", "movie", "plot", "it's", "great", "awful", "the"]
    for part in ("train", "test"):
        for sub in ("pos", "neg"):
            d = tmp_path / "aclImdb" / part / sub
            d.mkdir(parents=True)
            for i in range(3):
                (d / f"{i}_7.txt").write_text(
                    " ".join(words[j] for j in rs.randint(0, 8, rs.randint(3, 12))).title())
    monkeypatch.setenv("IMDB_DIR", str(tmp_path / "aclImdb"))
    for kw in (dict(train=True), dict(train=False, vocab_size=5)):
        j = jds.ImdbReviewIterator(2, max_len=8, seed=3, **kw)
        t = tds.ImdbReviewIterator(2, max_len=8, seed=3, **kw)
        assert t.vocab == j.vocab
        _same_batches(j, t)


def test_synthetic_and_iris_iterators():
    for j, t in ((jds.SyntheticMnist(4, n_batches=3, seed=2),
                  tds.SyntheticMnist(4, n_batches=3, seed=2)),
                 (jds.SyntheticCifar10(3, n_batches=2, seed=1),
                  tds.SyntheticCifar10(3, n_batches=2, seed=1)),
                 (jds.SyntheticImdb(4, n_batches=2, max_len=16, seed=5),
                  tds.SyntheticImdb(4, n_batches=2, max_len=16, seed=5)),
                 (jds.IrisDataSetIterator(40, seed=3), tds.IrisDataSetIterator(40, seed=3))):
        _same_batches(j, t)
        assert t.batch_size() == j.batch_size()
