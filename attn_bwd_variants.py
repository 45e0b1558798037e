#!/usr/bin/env python3
"""Time the flash-attention backward kernels against variants of their
source on one NVIDIA Hopper card.

Run from the root of a checkout, on a machine with one H100:

    python3 attn_bwd_variants.py

Each variant is a copy of ``deeplearning4j_tpu_torch/ops/kernels/csrc/``
with a few lines of ``flash_attn_bwd.cu`` replaced (``VARIANTS``: 64-row
dQ blocks, 128-row dK/dV tiles or blocks, a third ring stage, the heads side by side in the grid, the split
of ``conv3x3_igemm.cuh``, no minimum-blocks bound, f32 chunks unrolled,
and one with the products skipped, the kernels' load-and-store floor).
All are compiled with ``nvcc`` at once under ``build/attn_bwd_variants/``
and loaded with ``ctypes`` beside the checkout's own library.  At the two
BERT-base shapes of ``chip_smoke.py`` (``BERT_ATTN_SHAPES``), bf16 and f32,
each prints one JSON line: SDPA's whole backward, and per library the dQ
and dK/dV kernels' median ms (``chip_smoke.time_ms``: L2 flushed, a device
spin before each window) and their largest error relative to max|ref| of
the plain version (1.0 for the floor, which computes nothing).  The last
line is nvidia-smi's name and power limit.  Exits non-zero without CUDA or
when a variant does not build.
"""
import ctypes
import json
import os
import re
import shutil
import subprocess
import sys

import torch

#: name -> [(text of flash_attn_bwd.cu, replacement)]
VARIANTS = {
    "dq_rows_64": [("constexpr int DQ_BLOCK_ROWS = 128;", "constexpr int DQ_BLOCK_ROWS = 64;")],
    "dkv_tile_128": [("constexpr int BQ = 64;", "constexpr int BQ = 128;")],
    "kv_rows_128": [("constexpr int BK = 64;", "constexpr int BK = 128;")],
    "stages_3": [("constexpr int STAGES = 2;", "constexpr int STAGES = 3;")],
    "heads_side_by_side": [
        ("const int bh = blockIdx.x / nqt;", "const int bh = blockIdx.x % (gridDim.x / nqt);"),
        ("const int q0 = (blockIdx.x % nqt) * C::DQ_ROWS;",
         "const int q0 = (blockIdx.x / (gridDim.x / nqt)) * C::DQ_ROWS;"),
        ("const int bh = blockIdx.x / nkt;", "const int bh = blockIdx.x % (gridDim.x / nkt);"),
        ("const int k0 = (blockIdx.x % nkt) * BK;",
         "const int k0 = (blockIdx.x / (gridDim.x / nkt)) * BK;")],
    "split_cvt": [(r"re:split_3xtf32\((?!float)", "conv_igemm::split_tf32(")],
    "no_min_blocks": [("DQ_MIN_BLOCKS = BF16 && DMAX == 64 ? 16 * 32 / DQ_THREADS : 1;",
                       "DQ_MIN_BLOCKS = 1;")],
    "f32_unrolled": [("#pragma unroll(C::BF16 ? 2 : 1)", "#pragma unroll")],
    "no_products": [("      float s[C::CT][4], dp[C::CT][4];",
                     "      break;\n      float s[C::CT][4], dp[C::CT][4];")],
}
SHARED_LIMIT = 'static_assert(DQ_SMEM <= 232448 && DKV_SMEM <= 232448, "shared memory");'


def _source(text, subs):
    # a variant with larger tiles may not fit an instance it is not timed at
    text = text.replace(SHARED_LIMIT, "")
    for old, new in subs:
        if old.startswith("re:"):
            text, n = re.subn(old[3:], new, text)
        else:
            n = text.count(old)
            text = text.replace(old, new)
        if n == 0:
            raise RuntimeError(f"variant text not found: {old!r}")
    return text


def build_variants(build, root):
    """{name: loaded library} for every variant, compiled in parallel."""
    nvcc = build.find_nvcc()
    procs = {}
    for name, subs in VARIANTS.items():
        d = os.path.join(root, name)
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(build.CSRC, d)
        src = os.path.join(d, "flash_attn_bwd.cu")
        with open(src) as f:
            text = _source(f.read(), subs)
        with open(src, "w") as f:
            f.write(text)
        procs[name] = subprocess.Popen(
            [nvcc, *build.ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-shared",
             "-o", os.path.join(d, "lib.so"), src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, p in procs.items():
        out, _ = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"variant {name} did not build:\n{out}")
        lib = ctypes.CDLL(os.path.join(root, name, "lib.so"))
        for fn in (lib.dl4j_flash_attn_bwd_dq, lib.dl4j_flash_attn_bwd_dkv):
            fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.POINTER(ctypes.c_longlong)]
                           + [ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_int,
                                                   ctypes.c_void_p])
            fn.restype = ctypes.c_int
        libs[name] = lib
    return libs


def _launcher(attention, lib, a, dev, kernel):
    """A no-argument call of one kernel of `lib` on the arguments `a`."""
    if kernel == "dq":
        fn, ts = lib.dl4j_flash_attn_bwd_dq, (a.q, a.k, a.v, a.out, a.g, a.lse, a.mask,
                                               a.dq, a.delta)
    else:
        fn, ts = lib.dl4j_flash_attn_bwd_dkv, (a.q, a.k, a.v, a.g, a.lse, a.delta, a.mask,
                                                a.dk, a.dv)
    ptrs = [attention._ptr(t) for t in ts]
    stream = torch.cuda.current_stream(dev).cuda_stream

    def run():
        rc = fn(*ptrs, a.strides, *a.shape, stream)
        if rc != 0:
            raise RuntimeError(f"{kernel} launch failed (code {rc})")
    return run


def main():
    if not torch.cuda.is_available():
        print("attn_bwd_variants: CUDA is not available", file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    import torch.nn.functional as F

    import chip_smoke as cs
    from deeplearning4j_tpu_torch.ops import attention_kernels as ak
    from deeplearning4j_tpu_torch.ops.kernels import attention, build

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    libs = {"checkout": build.library()}
    libs.update(build_variants(build, os.path.join(here, "build", "attn_bwd_variants")))
    for (B, H, T, D) in cs.BERT_ATTN_SHAPES.values():
        for dt in (torch.bfloat16, torch.float32):
            gen = torch.Generator(device=dev).manual_seed(9)
            q, k, v, g = (torch.randn(B, H, T, D, generator=gen, device=dev).to(dt)
                          for _ in range(4))
            mask = torch.ones(B, T, dtype=dt, device=dev)
            out, lse = attention.flash_attention(q, k, v, mask)
            want = ak.flash_attention_bwd_plain(q, k, v, out, lse, g, mask)
            ql, kl, vl = (t.detach().requires_grad_() for t in (q, k, v))
            lo = F.scaled_dot_product_attention(ql, kl, vl,
                                                attn_mask=mask[:, None, None, :] > 0)
            line = {"shape": [B, H, T, D], "dtype": str(dt), "sdpa_ms": cs.time_ms(
                lambda: torch.autograd.grad(lo, (ql, kl, vl), g, retain_graph=True), dev)}
            del lo
            for name, lib in libs.items():
                a = attention._BwdArgs(q, k, v, out, lse, g, mask, False, None)
                dq, dkv = (_launcher(attention, lib, a, dev, kern) for kern in ("dq", "dkv"))
                dq()
                dkv()
                torch.cuda.synchronize()
                err = max(((x.float() - w.float()).abs().max() / w.float().abs().max()).item()
                          for x, w in zip((a.dq, a.dk, a.dv), want))
                line[name] = {"dq_ms": cs.time_ms(dq, dev), "dkv_ms": cs.time_ms(dkv, dev),
                              "max_rel_err": err}
            print(json.dumps(line), flush=True)
            del q, k, v, g, out, lse, want
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
