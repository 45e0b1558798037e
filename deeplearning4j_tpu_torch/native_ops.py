"""ctypes bindings for the repository's C++ host runtime (the port of
``native_ops.py``).

The sources are the repository's own, ``native/threshold_codec.cpp`` and
``native/host_staging.cpp``.  At first use (never at import) they are
compiled with ``g++ -O3 -fPIC -fopenmp -std=c++17 -shared`` into
``build/torch_native/`` at the root of the checkout, under a name that
carries a hash of the sources and the flags, and loaded with ``ctypes``.
A compiler without OpenMP (no ``libgomp``) builds without ``-fopenmp``:
the sources guard their parallel loops with ``_OPENMP``, so the staging
gathers then run on one thread with the same results, and ``last_build``
says so.  There is no fallback otherwise: a missing compiler or a failed
build raises with the compiler's output, as the kernel tier does
(``ops/kernels/build.py``).

Public surface:

- :class:`ThresholdCodec`: sparse threshold gradient encoding with the
  residual carried over (the reference's ``encode_threshold`` and
  ``EncodedGradientsAccumulator``).  A stream is int32 sign-in-index codes
  ``+(i + 1)`` / ``-(i + 1)``.  The threshold crosses into C as a float,
  so every compare and subtraction uses its f32 rounding.
- :func:`gather_indexed` and :func:`u8_to_f32`: parallel minibatch
  assembly and the fused uint8 decode (the staging-buffer role).
- :func:`threshold_encode_reference` and
  :func:`threshold_decode_reference`: the codec's plain versions in torch
  on the CPU, for the tests; nothing on the training path calls them.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
NATIVE_DIR = ROOT / "native"
SOURCES = ("threshold_codec.cpp", "host_staging.cpp")
BUILD_DIR = ROOT / "build" / "torch_native"
FLAGS = ["-O3", "-fPIC", "-fopenmp", "-std=c++17", "-shared"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_flags: Optional[list] = None
#: what the library in use was built with: compiler, flags, OpenMP or not
last_build: dict = {}


def find_cxx() -> str:
    """The C++ compiler: ``$CXX``, else ``g++`` on ``PATH``."""
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if not cxx:
        raise RuntimeError("no C++ compiler (set CXX or put g++ on PATH); the host "
                           "codec cannot be built")
    return cxx


def _has_openmp(cxx: str) -> bool:
    """The compiler links a shared object with ``-fopenmp``."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    probe = BUILD_DIR / f"openmp-probe-{os.getpid()}-{threading.get_ident()}.so"
    try:
        p = subprocess.run([cxx, "-fopenmp", "-fPIC", "-shared", "-x", "c++", "-",
                            "-o", str(probe)], input="int dl4j_probe() { return 0; }\n",
                           stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                           timeout=120)
        return p.returncode == 0
    finally:
        probe.unlink(missing_ok=True)


def flags() -> list:
    """FLAGS, less ``-fopenmp`` where the compiler has no OpenMP."""
    global _flags
    if _flags is None:
        _flags = FLAGS if _has_openmp(find_cxx()) else [f for f in FLAGS if f != "-fopenmp"]
    return _flags


def library_path() -> Path:
    h = hashlib.sha256(" ".join(flags()).encode())
    for name in SOURCES:
        h.update(name.encode())
        h.update((NATIVE_DIR / name).read_bytes())
    return BUILD_DIR / f"libdl4j_torch_native-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the sources into the hashed library unless it exists."""
    out = library_path()
    cxx = find_cxx()
    last_build.update(cxx=cxx, flags=flags(), openmp="-fopenmp" in flags(), path=str(out))
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}-{threading.get_ident()}.tmp")
    cmd = [cxx, *flags(), "-o", str(tmp), *(str(NATIVE_DIR / s) for s in SOURCES)]
    try:
        p = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                           text=True, timeout=300)
        if p.returncode != 0:
            raise RuntimeError(f"host codec build failed (exit {p.returncode}): "
                               f"{' '.join(cmd)}\n{p.stdout}")
        os.replace(tmp, out)
    finally:
        tmp.unlink(missing_ok=True)
    return out


def library() -> ctypes.CDLL:
    """The loaded library, built on first use (thread-safe)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            lib.threshold_encode.restype = ctypes.c_int64
            lib.threshold_encode.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_float,
                ctypes.c_void_p, ctypes.c_int64]
            lib.threshold_decode.restype = None
            lib.threshold_decode.argtypes = [
                ctypes.c_void_p, ctypes.c_int64, ctypes.c_float, ctypes.c_void_p,
                ctypes.c_int64]
            lib.threshold_density.restype = ctypes.c_double
            lib.threshold_density.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_float]
            lib.staging_gather_indexed.restype = None
            lib.staging_gather_indexed.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
                ctypes.c_void_p]
            lib.staging_u8_to_f32.restype = None
            lib.staging_u8_to_f32.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_float]
            _lib = lib
        return _lib


def native_available() -> bool:
    """True once the library is built and loaded; a failed build raises."""
    return library() is not None


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


def _f32_vector(a, size: int, what: str) -> np.ndarray:
    a = np.ascontiguousarray(np.asarray(a, np.float32).ravel())
    if a.size != size:
        raise ValueError(f"{what}: size {a.size} != {size}")
    return a


class ThresholdCodec:
    """Sparse threshold gradient compression with the residual carried over.

    ``encode(grad)`` returns an int32 stream of sign-in-index codes and
    keeps the unsent remainder in ``residual``, so repeated encodes emit
    what one cut (the reference's delta semantics); ``decode`` scatters a
    stream back to dense.  At most ``max_elements`` codes a stream: values
    past that keep their whole value in the residual."""

    def __init__(self, size: int, threshold: float = 1e-3,
                 max_fraction: float = 1.0):
        self.size = int(size)
        self.threshold = float(threshold)
        self.residual = np.zeros(self.size, np.float32)
        self.max_elements = max(1, int(self.size * max_fraction))

    def encode(self, grad) -> np.ndarray:
        grad = _f32_vector(grad, self.size, "encode")
        if self.residual.shape != (self.size,) or self.residual.dtype != np.float32 \
                or not self.residual.flags.c_contiguous:
            raise ValueError("residual must be a contiguous float32 vector of the "
                             "codec's size")
        out = np.empty(self.max_elements, np.int32)
        n = library().threshold_encode(_ptr(grad), _ptr(self.residual), self.size,
                                       self.threshold, _ptr(out), self.max_elements)
        return out[:n].copy()

    def decode(self, encoded, out: Optional[np.ndarray] = None,
               threshold: Optional[float] = None) -> np.ndarray:
        """Scatter a stream back to dense, adding into `out` (zeros by
        default).  `threshold` overrides the codec's own (a peer's stream
        decodes at the peer's threshold) without changing it, so a decode
        of peer streams may overlap an encode on another thread."""
        thr = self.threshold if threshold is None else float(threshold)
        if out is None:
            out = np.zeros(self.size, np.float32)
        elif out.shape != (self.size,) or out.dtype != np.float32 \
                or not out.flags.c_contiguous:
            raise ValueError("out must be a contiguous float32 vector of the codec's size")
        encoded = np.ascontiguousarray(np.asarray(encoded, np.int32))
        library().threshold_decode(_ptr(encoded), encoded.size, thr, _ptr(out), self.size)
        return out

    def density(self, grad) -> float:
        """Fraction of entries at or over the threshold (the adaptive
        threshold's hook)."""
        grad = _f32_vector(grad, self.size, "density")
        return float(library().threshold_density(_ptr(grad), _ptr(self.residual),
                                                 self.size, self.threshold))


def gather_indexed(base: np.ndarray, indices: np.ndarray) -> np.ndarray:
    """Parallel minibatch assembly: ``out[i] = base[indices[i]]`` (C++ with
    OpenMP over the rows)."""
    base = np.ascontiguousarray(base)
    indices = np.ascontiguousarray(np.asarray(indices, np.int64))
    if base.ndim < 1:
        raise ValueError("gather_indexed: base needs a leading row axis")
    # the C loop copies blindly, so an index out of range is checked here
    if indices.size and (indices.min() < 0 or indices.max() >= base.shape[0]):
        raise IndexError(f"gather_indexed: indices out of range [0, {base.shape[0]})")
    out = np.empty((indices.size,) + base.shape[1:], base.dtype)
    row_bytes = base.dtype.itemsize * int(np.prod(base.shape[1:], dtype=np.int64))
    library().staging_gather_indexed(_ptr(base), _ptr(indices), indices.size,
                                     row_bytes, _ptr(out))
    return out


def u8_to_f32(src, scale: float = 1.0 / 255.0) -> np.ndarray:
    """Fused uint8 -> float32 decode and scale (image pipelines)."""
    src = np.ascontiguousarray(np.asarray(src, np.uint8))
    out = np.empty(src.shape, np.float32)
    library().staging_u8_to_f32(_ptr(src), _ptr(out), src.size, ctypes.c_float(scale))
    return out


# ---------------------------------------------------------------------------
# plain versions (tests only)
# ---------------------------------------------------------------------------

def threshold_encode_reference(grad, residual, threshold: float,
                               max_elements: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The C encode in torch on the CPU: (stream, new residual).  ``v =
    grad + residual`` in f32; the first `max_elements` entries with ``v >=
    t`` or ``v <= -t`` (t the f32 rounding of `threshold`), in index order,
    become codes and keep ``v -/+ t``; every other entry keeps ``v``."""
    v = (torch.as_tensor(np.asarray(grad, np.float32)).reshape(-1)
         + torch.as_tensor(np.asarray(residual, np.float32)).reshape(-1))
    t = torch.tensor(threshold, dtype=torch.float32)
    pos, neg = v >= t, v <= -t
    idx = torch.nonzero(pos | neg).reshape(-1)[:max_elements]
    sign = torch.where(pos[idx], 1, -1).to(torch.int32)
    stream = sign * (idx.to(torch.int32) + 1)
    res = v.clone()
    res[idx] = torch.where(pos[idx], v[idx] - t, v[idx] + t)
    return stream, res


def threshold_decode_reference(encoded, size: int, threshold: float,
                               out=None) -> torch.Tensor:
    """The C decode in torch on the CPU: ``+t`` at ``code - 1`` for a
    positive code, ``-t`` at ``-code - 1`` for a negative one, added into
    `out` (zeros by default); codes out of range are skipped."""
    e = torch.as_tensor(np.asarray(encoded, np.int32)).reshape(-1).to(torch.int64)
    dense = (torch.zeros(size, dtype=torch.float32) if out is None
             else torch.as_tensor(np.asarray(out, np.float32)).clone())
    t = torch.tensor(threshold, dtype=torch.float32)
    ok = ((e > 0) & (e <= size)) | ((e < 0) & (-e <= size))
    e = e[ok]
    vals = torch.where(e > 0, t, -t)
    return dense.index_add_(0, e.abs() - 1, vals)
