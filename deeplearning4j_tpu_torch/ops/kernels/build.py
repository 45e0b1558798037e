"""Build and load the hand-written CUDA kernels of the port.

Every ``csrc/*.cu`` source is compiled by ``nvcc`` for ``sm_90a`` (one
``nvcc`` process per source, all started together), linked into one shared
library with a plain C interface, and loaded with ``ctypes``.  The library
lands in ``build/torch_kernels/`` at the root of the checkout, under a name
that carries a hash of the sources and the flags, so a stale library is
never loaded.  Nothing here runs at import: the first kernel launch calls
:func:`library`.

``nvcc`` is looked up under ``$CUDA_HOME/bin``, then on ``PATH``, then
under ``/usr/local/cuda/bin`` (the toolkit's default prefix, where PyTorch
also looks).  A missing compiler or a failed build raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import List, Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "torch_kernels"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
COMPILE_FLAGS = ARCH_FLAGS + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                              "-Xptxas", "-v"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
#: what the last build in this process did: seconds, library path, and the
#: compiler's register/shared-memory report (``-Xptxas -v``)
last_build: dict = {}


def find_nvcc() -> str:
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(Path(on_path))
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file() and os.access(c, os.X_OK):
            return str(c)
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, PATH and "
        "/usr/local/cuda/bin); the port's CUDA kernels cannot be built")


def sources() -> List[Path]:
    return sorted(CSRC.glob("*.cu"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(COMPILE_FLAGS).encode())
    for src in sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    for hdr in sorted(CSRC.glob("*.cuh")):
        h.update(hdr.name.encode())
        h.update(hdr.read_bytes())
    return BUILD_DIR / f"libdl4j_torch_kernels-{h.hexdigest()[:16]}.so"


def _run_all(cmds: List[List[str]]) -> str:
    """Start every command at once, wait for all, raise on the first
    failure with its output; returns the joined compiler output."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs, failed = [], None
    for cmd, p in zip(cmds, procs):
        out, _ = p.communicate()
        outs.append(out)
        if p.returncode != 0 and failed is None:
            failed = (cmd, p.returncode, out)
    if failed is not None:
        cmd, rc, out = failed
        raise RuntimeError(
            f"kernel build failed (exit {rc}): {' '.join(cmd)}\n{out}")
    return "".join(outs)


def build() -> Path:
    """Compile the sources into the hashed library unless it exists."""
    out = library_path()
    if out.exists():
        last_build.update(seconds=0.0, path=str(out), cached=True, ptxas="")
        return out
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.monotonic()
    tag = f"{os.getpid()}-{threading.get_ident()}"
    objs = [BUILD_DIR / f"{src.stem}-{tag}.o" for src in sources()]
    log = _run_all([[nvcc, *COMPILE_FLAGS, "-c", str(src), "-o", str(obj)]
                    for src, obj in zip(sources(), objs)])
    tmp = out.with_name(f"{out.name}.{tag}.tmp")
    try:
        _run_all([[nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp),
                   *map(str, objs)]])
        os.replace(tmp, out)
    finally:
        for p in objs + [tmp]:
            p.unlink(missing_ok=True)
    last_build.update(seconds=time.monotonic() - t0, path=str(out),
                      cached=False, ptxas=log)
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use (thread-safe)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            lib.dl4j_fused_dense.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
            lib.dl4j_fused_dense.restype = ctypes.c_int
            lib.dl4j_fused_dense_tile.argtypes = [
                ctypes.POINTER(ctypes.c_int)] * 3
            lib.dl4j_fused_dense_tile.restype = None
            lib.dl4j_conv3x3_wgrad.argtypes = (
                [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + [ctypes.c_void_p])
            lib.dl4j_conv3x3_wgrad.restype = ctypes.c_int
            lib.dl4j_conv3x3_dgrad.argtypes = (
                [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + [ctypes.c_void_p])
            lib.dl4j_conv3x3_dgrad.restype = ctypes.c_int
            lib.dl4j_layer_norm_fwd.argtypes = (
                [ctypes.c_void_p] * 6 + [ctypes.c_int] * 2
                + [ctypes.c_longlong, ctypes.c_float] + [ctypes.c_int] * 2
                + [ctypes.c_void_p])
            lib.dl4j_layer_norm_fwd.restype = ctypes.c_int
            lib.dl4j_flash_attn_fwd.argtypes = (
                [ctypes.c_void_p] * 6 + [ctypes.POINTER(ctypes.c_longlong)]
                + [ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
            lib.dl4j_flash_attn_fwd.restype = ctypes.c_int
            for name in ("dl4j_flash_attn_bwd_dq", "dl4j_flash_attn_bwd_dkv"):
                fn = getattr(lib, name)
                fn.argtypes = (
                    [ctypes.c_void_p] * 9 + [ctypes.POINTER(ctypes.c_longlong)]
                    + [ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
                fn.restype = ctypes.c_int
            lib.dl4j_layer_norm_bwd.argtypes = (
                [ctypes.c_void_p] * 9 + [ctypes.c_int] * 2 + [ctypes.c_longlong] * 2
                + [ctypes.c_int] * 4 + [ctypes.c_void_p])
            lib.dl4j_layer_norm_bwd.restype = ctypes.c_int
            lib.dl4j_layer_norm_bwd_blocks.argtypes = [ctypes.c_int] * 2
            lib.dl4j_layer_norm_bwd_blocks.restype = ctypes.c_int
            lib.dl4j_flash_attn_tile.argtypes = [ctypes.POINTER(ctypes.c_int)] * 2
            lib.dl4j_flash_attn_tile.restype = None
            lib.dl4j_error_string.argtypes = [ctypes.c_int]
            lib.dl4j_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def error_string(code: int) -> str:
    return library().dl4j_error_string(int(code)).decode()
