#!/usr/bin/env python3
"""Time the flash-attention kernels against variants of their sources on
one NVIDIA Hopper card.

Run from the root of a checkout, on a machine with one H100:

    python3 attn_variants.py          # forward and backward variants
    python3 attn_variants.py fwd      # the forward's only (or: bwd)

Each variant is a copy of ``deeplearning4j_tpu_torch/ops/kernels/csrc/``
with a few lines of one or two files replaced (``VARIANTS``).  The forward's
(``flash_attn_fwd.cu``): 64-row blocks, 128-row K/V tiles, a third ring
stage, no minimum-blocks bound, keys a warp cannot see skipped 16 at a time
in both products (the first tensor-core version), and one with the two
products taken out (its loads, softmax and stores).  The backward's
(``flash_attn_bwd.cu``): 64-row dQ blocks, 128-row dK/dV tiles or blocks, a
third ring stage, the heads side by side in the grid, no minimum-blocks
bound, f32 chunks unrolled, no chunk skips (every chunk computed and
masked, as the forward does), and one with the products skipped, the
kernels' load-and-store floor.  Both's (``flash_attn_common.cuh``):
``conv3x3_igemm.cuh``'s TF32 split.  The attention sources that include a
variant's files are compiled with ``nvcc``, all at once, under
``build/attn_variants/`` and loaded with ``ctypes`` beside the checkout's
own library.  At the two
BERT-base shapes of ``chip_smoke.py`` (``BERT_ATTN_SHAPES``), bf16 and f32,
each prints one JSON line: SDPA's forward and its whole backward, and per
library the forward, dQ and dK/dV kernels' median ms (``chip_smoke.time_ms``:
L2 flushed, a device spin before each window) and their largest error
relative to max|ref| of the plain version (a floor computes no answer);
a launch the variant cannot make (a tile that outgrows shared memory)
reads as its error code.  The last line is nvidia-smi's name and power
limit.  Exits non-zero without CUDA or when a variant does not build.
"""
import ctypes
import json
import os
import re
import shutil
import subprocess
import sys

import torch

FWD, BWD, COMMON = "flash_attn_fwd.cu", "flash_attn_bwd.cu", "flash_attn_common.cuh"
#: name -> [(file of csrc/, [(its text, replacement)])]
VARIANTS = {
    "fwd_rows_64": [(FWD, [("constexpr int BQ = 128;", "constexpr int BQ = 64;")])],
    "fwd_kv_128": [(FWD, [("constexpr int BK = 64;", "constexpr int BK = 128;")])],
    "fwd_stages_3": [(FWD, [("constexpr int STAGES = 2;", "constexpr int STAGES = 3;")])],
    "fwd_no_min_blocks": [(FWD, [("MIN_BLOCKS = P::BF16 && DMAX == 64 ? 2 : 1;",
                                  "MIN_BLOCKS = 1;")])],
    "fwd_skip_16": [
        (FWD, [("const T* Ks, int m0, int lane) {", "const T* Ks, int m0, int lane, int kmax) {"),
               ("        uint32_t b[4];", "        if (np * 16 >= kmax) break;\n        uint32_t b[4];"),
               ("        uint32_t bb[2], bs[2];",
                "        if (nt * 8 >= kmax) break;\n        uint32_t bb[2], bs[2];"),
               ("      tile_scores<T, DMAX>(s, qa, qs, Qs, Ks, m0, lane);",
                "      const int kmax =\n"
                "          (min(min(BK, p.S - k0), p.causal ? row0 + 16 - k0 : BK) + 15) & ~15;\n"
                "      tile_scores<T, DMAX>(s, qa, qs, Qs, Ks, m0, lane, kmax);"),
               ("      output_product<T, DMAX>(acc, s, Vs, 0, buf, lane);",
                "      output_product<T, DMAX>(acc, s, Vs, 0, buf, lane, kmax);")]),
        (COMMON, [("int x0, float* buf, int lane) {", "int x0, float* buf, int lane,\n"
                   "                                               int kmax = 8 * CT) {"),
                  ("    for (int kk = 0; kk < CT / 2; ++kk) {",
                   "    for (int kk = 0; kk < CT / 2; ++kk) {\n      if (kk * 16 >= kmax) break;"),
                  ("      for (int kk = 0; kk < CT; ++kk) {",
                   "      for (int kk = 0; kk < CT; ++kk) {\n        if (kk * 8 >= kmax) break;")])],
    "fwd_no_products": [(FWD, [
        ("      tile_scores<T, DMAX>(s, qa, qs, Qs, Ks, m0, lane);", ""),
        ("      output_product<T, DMAX>(acc, s, Vs, 0, buf, lane);", "")])],
    "dq_rows_64": [(BWD, [("constexpr int DQ_BLOCK_ROWS = 128;",
                           "constexpr int DQ_BLOCK_ROWS = 64;")])],
    "dkv_tile_128": [(BWD, [("constexpr int BQ = 64;", "constexpr int BQ = 128;")])],
    "kv_rows_128": [(BWD, [("constexpr int BK = 64;", "constexpr int BK = 128;")])],
    "stages_3": [(BWD, [("constexpr int STAGES = 2;", "constexpr int STAGES = 3;")])],
    "heads_side_by_side": [(BWD, [
        ("const int bh = blockIdx.x / nqt;", "const int bh = blockIdx.x % (gridDim.x / nqt);"),
        ("const int q0 = (blockIdx.x % nqt) * C::DQ_ROWS;",
         "const int q0 = (blockIdx.x / (gridDim.x / nqt)) * C::DQ_ROWS;"),
        ("const int bh = blockIdx.x / nkt;", "const int bh = blockIdx.x % (gridDim.x / nkt);"),
        ("const int k0 = (blockIdx.x % nkt) * BK;",
         "const int k0 = (blockIdx.x / (gridDim.x / nkt)) * BK;")])],
    "no_min_blocks": [(BWD, [("DQ_MIN_BLOCKS = P::BF16 && DMAX == 64 ? 16 * 32 / DQ_THREADS : 1;",
                              "DQ_MIN_BLOCKS = 1;")])],
    "f32_unrolled": [(BWD, [("#pragma unroll(C::BF16 ? 2 : 1)", "#pragma unroll")])],
    "no_chunk_skips": [(BWD, [
        ("      if (k0 + kc >= p.S || row0 >= p.T || (p.causal && k0 + kc > row0 + 15)) break;\n",
         ""),
        ("      if (q0 + qc >= p.T || key0 >= p.S) break;\n"
         "      if (p.causal && q0 + qc + C::CHUNK - 1 < key0) continue;\n", "")])],
    "no_products": [(BWD, [("      float s[C::CT][4], dp[C::CT][4];",
                            "      break;\n      float s[C::CT][4], dp[C::CT][4];")])],
    "split_cvt": [(COMMON, [(r"re:split_3xtf32\((?!float)", "conv_igemm::split_tf32(")])],
}
#: a variant with larger tiles may not fit an instance it is not timed at
SHARED_LIMITS = ('static_assert(DQ_SMEM <= 232448 && DKV_SMEM <= 232448, "shared memory");',
                 'static_assert(SMEM <= 232448, "shared memory");')
#: the attention sources each file reaches, and the kernels a variant of it
#: is timed for
UNITS = {FWD: [FWD], BWD: [BWD], COMMON: [FWD, BWD]}
KINDS = {FWD: {"fwd"}, BWD: {"bwd"}, COMMON: {"fwd", "bwd"}}
_FWD_ARGS = ([ctypes.c_void_p] * 6 + [ctypes.POINTER(ctypes.c_longlong)]
             + [ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
_BWD_ARGS = ([ctypes.c_void_p] * 9 + [ctypes.POINTER(ctypes.c_longlong)]
             + [ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])


def _source(text, subs):
    for limit in SHARED_LIMITS:
        text = text.replace(limit, "")
    for old, new in subs:
        if old.startswith("re:"):
            text, n = re.subn(old[3:], new, text)
        else:
            n = text.count(old)
            text = text.replace(old, new)
        if n == 0:
            raise RuntimeError(f"variant text not found: {old!r}")
    return text


def _bind(lib):
    """The attention entries `lib` has, typed: {"fwd", "bwd"} of them."""
    has = set()
    if hasattr(lib, "dl4j_flash_attn_fwd"):
        lib.dl4j_flash_attn_fwd.argtypes = _FWD_ARGS
        lib.dl4j_flash_attn_fwd.restype = ctypes.c_int
        has.add("fwd")
    if hasattr(lib, "dl4j_flash_attn_bwd_dq"):
        for fn in (lib.dl4j_flash_attn_bwd_dq, lib.dl4j_flash_attn_bwd_dkv):
            fn.argtypes = _BWD_ARGS
            fn.restype = ctypes.c_int
        has.add("bwd")
    return has


def build_variants(build, root, names):
    """{name: (loaded library, its entries)} for the variants `names`,
    compiled in parallel."""
    nvcc = build.find_nvcc()
    procs = {}
    for name in names:
        d = os.path.join(root, name)
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(build.CSRC, d)
        edits = dict(VARIANTS[name])
        units = sorted({u for fname in edits for u in UNITS[fname]})
        for fname in sorted(set(edits) | set(units)):
            path = os.path.join(d, fname)
            with open(path) as f:
                text = _source(f.read(), edits.get(fname, []))
            with open(path, "w") as f:
                f.write(text)
        procs[name] = subprocess.Popen(
            [nvcc, *build.ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-shared",
             "-o", os.path.join(d, "lib.so"), *(os.path.join(d, u) for u in units)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, p in procs.items():
        out, _ = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"variant {name} did not build:\n{out}")
        lib = ctypes.CDLL(os.path.join(root, name, "lib.so"))
        libs[name] = (lib, _bind(lib))
    return libs


def _fwd_launcher(attention, lib, q, k, v, mask, out, lse):
    """A no-argument call of `lib`'s forward kernel; returns its code."""
    B, H, T, D = q.shape
    mask, mask_b, code = attention._mask_args(mask)
    strides = (ctypes.c_longlong * 13)(*q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                                       *out.stride()[:3], mask_b)
    ptrs = [attention._ptr(t) for t in (q, k, v, mask, out, lse)]
    args = (strides, B, H, T, k.shape[2], D, code, 0, D ** -0.5,
            attention._DTYPE_CODES[q.dtype], torch.cuda.current_stream(q.device).cuda_stream)
    return lambda: lib.dl4j_flash_attn_fwd(*ptrs, *args)


def _bwd_launcher(attention, lib, a, dev, kernel):
    """A no-argument call of one backward kernel of `lib` on the arguments
    `a`; returns its code."""
    if kernel == "dq":
        fn, ts = lib.dl4j_flash_attn_bwd_dq, (a.q, a.k, a.v, a.out, a.g, a.lse, a.mask,
                                               a.dq, a.delta)
    else:
        fn, ts = lib.dl4j_flash_attn_bwd_dkv, (a.q, a.k, a.v, a.g, a.lse, a.delta, a.mask,
                                                a.dk, a.dv)
    ptrs = [attention._ptr(t) for t in ts]
    stream = torch.cuda.current_stream(dev).cuda_stream
    return lambda: fn(*ptrs, a.strides, *a.shape, stream)


def _timed(cs, run, dev, outs, wants):
    """{ms, max_rel_err} of a launcher, or {error: code} if it cannot launch."""
    rc = run()
    torch.cuda.synchronize()
    if rc != 0:
        return {"error": rc}
    err = max(((x.float() - w.float()).abs().max() / w.float().abs().max()).item()
              for x, w in zip(outs, wants))
    return {"ms": cs.time_ms(run, dev), "max_rel_err": err}


def main(argv=()):
    if not torch.cuda.is_available():
        print("attn_variants: CUDA is not available", file=sys.stderr)
        return 2
    kinds = set(argv) & {"fwd", "bwd"} or {"fwd", "bwd"}
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    import torch.nn.functional as F

    import chip_smoke as cs
    from deeplearning4j_tpu_torch.ops import attention_kernels as ak
    from deeplearning4j_tpu_torch.ops.kernels import attention, build

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    names = [n for n, edits in VARIANTS.items() if KINDS[edits[0][0]] & kinds]
    checkout = build.library()
    libs = {"checkout": (checkout, _bind(checkout))}
    libs.update(build_variants(build, os.path.join(here, "build", "attn_variants"), names))
    for (B, H, T, D) in cs.BERT_ATTN_SHAPES.values():
        for dt in (torch.bfloat16, torch.float32):
            gen = torch.Generator(device=dev).manual_seed(9)
            q, k, v, g = (torch.randn(B, H, T, D, generator=gen, device=dev).to(dt)
                          for _ in range(4))
            mask = torch.ones(B, T, dtype=dt, device=dev)
            keep = mask[:, None, None, :] > 0
            line = {"shape": [B, H, T, D], "dtype": str(dt)}
            out, lse = attention.flash_attention(q, k, v, mask)
            if "fwd" in kinds:
                line["sdpa_fwd_ms"] = cs.time_ms(
                    lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=keep), dev)
                want_fwd = ak.flash_attention_plain(q, k, v, mask)
            if "bwd" in kinds:
                want = ak.flash_attention_bwd_plain(q, k, v, out, lse, g, mask)
                ql, kl, vl = (t.detach().requires_grad_() for t in (q, k, v))
                lo = F.scaled_dot_product_attention(ql, kl, vl, attn_mask=keep)
                line["sdpa_bwd_ms"] = cs.time_ms(
                    lambda: torch.autograd.grad(lo, (ql, kl, vl), g, retain_graph=True), dev)
                del lo
            for name, (lib, has) in libs.items():
                row = {}
                if "fwd" in kinds and "fwd" in has:
                    o, l = torch.empty_like(q), torch.empty_like(lse)
                    row["fwd"] = _timed(cs, _fwd_launcher(attention, lib, q, k, v, mask, o, l),
                                        dev, (o, l), want_fwd)
                if "bwd" in kinds and "bwd" in has:
                    a = attention._BwdArgs(q, k, v, out, lse, g, mask, False, None)
                    dq = _bwd_launcher(attention, lib, a, dev, "dq")
                    row["dq"] = _timed(cs, dq, dev, (a.dq,), want[:1])
                    dkv = _bwd_launcher(attention, lib, a, dev, "dkv")
                    row["dkv"] = _timed(cs, dkv, dev, (a.dk, a.dv), want[1:])
                line[name] = row
            print(json.dumps(line), flush=True)
            del q, k, v, g, out, lse
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
