"""The port's host codec (``deeplearning4j_tpu_torch/native_ops.py``)
against the JAX package's native one.

The port builds the repository's own C++ sources (``native/``) into
``build/torch_native/`` at first use; the JAX package loads
``native/libdl4jtpu_native.so``.  Over seeded gradients (max_fraction < 1
included, thresholds that f32 cannot hold exactly) the port's streams and
residuals equal the JAX package's native codec's bit for bit, encode
after encode, and so does the port's plain torch version; decodes,
densities and the staging gathers agree bitwise too.  SameDiff's
``encode_threshold``/``decode_threshold`` ops share the codec's wire
format in both packages.
"""
import torch_test_threads  # noqa: F401  (first: one torch thread a worker)
import numpy as np
import pytest
import torch

import deeplearning4j_tpu.native_ops as jnative
from deeplearning4j_tpu_torch import native_ops as tnative

CODEC_CASES = [  # (size, threshold, max_fraction, scale, seed)
    (1000, 0.01, 1.0, 0.01, 0),
    (777, 0.1, 1.0, 0.08, 1),
    (500, 0.02, 0.05, 0.03, 2),
    (4096, 3e-3, 0.2, 5e-3, 3),
    (1, 1e-3, 1.0, 1e-2, 4),
]


def test_library_builds_into_the_hashed_build_dir():
    assert tnative.native_available()
    path = tnative.library_path()
    assert path.parent == tnative.BUILD_DIR and path.exists()
    assert path.parent.parts[-2:] == ("build", "torch_native")
    assert path.name.startswith("libdl4j_torch_native-") and path.suffix == ".so"
    assert path != tnative.ROOT / "native" / "libdl4jtpu_native.so"


def test_a_failed_build_raises_with_the_compiler_output(tmp_path, monkeypatch):
    (tmp_path / "threshold_codec.cpp").write_text("this is not C++\n")
    (tmp_path / "host_staging.cpp").write_text("")
    monkeypatch.setattr(tnative, "NATIVE_DIR", tmp_path)
    monkeypatch.setattr(tnative, "BUILD_DIR", tmp_path / "out")
    with pytest.raises(RuntimeError, match="host codec build failed") as ei:
        tnative.build()
    assert "threshold_codec.cpp" in str(ei.value)
    assert not list((tmp_path / "out").glob("*.so"))
    monkeypatch.delenv("CXX", raising=False)
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="no C\\+\\+ compiler"):
        tnative.find_cxx()


def test_a_compiler_without_openmp_builds_without_it(tmp_path, monkeypatch):
    """The sources guard their parallel loops with _OPENMP: without it the
    staging gather runs on one thread and gives the same rows."""
    import ctypes
    monkeypatch.setattr(tnative, "_flags", None)
    monkeypatch.setattr(tnative, "_has_openmp", lambda cxx: False)
    monkeypatch.setattr(tnative, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(tnative, "last_build", {})
    assert "-fopenmp" not in tnative.flags() and "-O3" in tnative.flags()
    path = tnative.build()
    assert path.parent == tmp_path and tnative.last_build["openmp"] is False
    lib = ctypes.CDLL(str(path))
    base = np.arange(60, dtype=np.float32).reshape(12, 5)
    idx = np.array([3, 0, 11, 3], np.int64)
    out = np.empty((4, 5), np.float32)
    lib.staging_gather_indexed.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                                           ctypes.c_int64, ctypes.c_void_p]
    lib.staging_gather_indexed(tnative._ptr(base), tnative._ptr(idx), 4, 20,
                               tnative._ptr(out))
    np.testing.assert_array_equal(out, base[idx])


@pytest.mark.parametrize("size,thr,frac,scale,seed", CODEC_CASES)
def test_codec_streams_and_residuals_equal_the_jax_native_codec(size, thr, frac, scale, seed):
    assert jnative.native_available()
    rng = np.random.RandomState(seed)
    port = tnative.ThresholdCodec(size, thr, max_fraction=frac)
    jax_ = jnative.ThresholdCodec(size, thr, max_fraction=frac)
    assert port.max_elements == jax_.max_elements
    res = torch.zeros(size)
    for step in range(4):
        g = (rng.randn(size) * scale).astype(np.float32)
        if step == 3:
            g[:] = 0.0                      # flush: the residual alone
        want = jax_.encode(g)
        got = port.encode(g)
        plain, res = tnative.threshold_encode_reference(g, res, thr, port.max_elements)
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(plain.numpy(), want)
        np.testing.assert_array_equal(port.residual, jax_.residual)
        np.testing.assert_array_equal(res.numpy(), jax_.residual)
        assert port.density(g) == jax_.density(g)


def test_decode_equals_the_jax_native_codec_and_leaves_the_threshold():
    rng = np.random.RandomState(7)
    g = (rng.randn(300) * 0.05).astype(np.float32)
    port, jax_ = tnative.ThresholdCodec(300, 0.03), jnative.ThresholdCodec(300, 0.03)
    enc = jax_.encode(g)
    port.encode(g)
    for thr in (None, 0.1, 1e-7):
        want = jax_.decode(enc, threshold=thr)
        np.testing.assert_array_equal(port.decode(enc, threshold=thr), want)
        plain = tnative.threshold_decode_reference(enc, 300, 0.03 if thr is None else thr)
        np.testing.assert_array_equal(plain.numpy(), want)
    assert port.threshold == 0.03
    base = (rng.randn(300) * 0.01).astype(np.float32)
    want = jax_.decode(enc, out=base.copy())
    np.testing.assert_array_equal(port.decode(enc, out=base.copy()), want)
    np.testing.assert_array_equal(
        tnative.threshold_decode_reference(enc, 300, 0.03, out=base).numpy(), want)
    bad = np.array([0, 301, -302, 5, -6], np.int32)      # out of range: skipped
    np.testing.assert_array_equal(port.decode(bad), jax_.decode(bad))
    with pytest.raises(ValueError, match="size"):
        port.encode(np.zeros(299, np.float32))


def test_staging_gathers_equal_the_jax_package():
    rng = np.random.RandomState(0)
    base = rng.rand(64, 7, 5).astype(np.float32)
    idx = rng.permutation(64)[:33]
    np.testing.assert_array_equal(tnative.gather_indexed(base, idx),
                                  jnative.gather_indexed(base, idx))
    with pytest.raises(IndexError):
        tnative.gather_indexed(base, [0, 64])
    src = rng.randint(0, 256, (9, 31)).astype(np.uint8)
    for scale in (1.0 / 255.0, 0.3):
        np.testing.assert_array_equal(tnative.u8_to_f32(src, scale),
                                      jnative.u8_to_f32(src, scale))


@pytest.mark.parametrize("max_elements", [None, 7])
def test_samediff_threshold_ops_match_the_codec_and_the_jax_ops(max_elements):
    import jax.numpy as jnp
    from deeplearning4j_tpu.autodiff.ops import OP_TABLE as JAX_OPS
    from deeplearning4j_tpu_torch.autodiff.ops import OP_TABLE
    rng = np.random.RandomState(11)
    g = (rng.randn(200) * 0.05).astype(np.float32)
    thr = 0.07
    codes = OP_TABLE["encode_threshold"](torch.as_tensor(g), thr, max_elements)
    want = np.asarray(JAX_OPS["encode_threshold"](jnp.asarray(g), thr, max_elements))
    assert codes.dtype == torch.int32
    np.testing.assert_array_equal(codes.numpy(), want)
    frac = 1.0 if max_elements is None else max_elements / g.size
    stream = tnative.ThresholdCodec(g.size, thr, max_fraction=frac).encode(g)
    np.testing.assert_array_equal(codes.numpy()[codes.numpy() != 0], stream)
    dec = OP_TABLE["decode_threshold"](codes, g.size, thr)
    np.testing.assert_array_equal(
        dec.numpy(), np.asarray(JAX_OPS["decode_threshold"](jnp.asarray(want), g.size, thr)))
    np.testing.assert_array_equal(
        dec.numpy(), tnative.ThresholdCodec(g.size, thr).decode(stream))
