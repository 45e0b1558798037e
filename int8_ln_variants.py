#!/usr/bin/env python3
"""Time int8_matmul and layer_norm_fwd against other grids and variants of
their sources on one NVIDIA Hopper card.

Run from the root of a checkout, on a machine with one H100:

    python3 int8_ln_variants.py

Prints one JSON line per kernel and shape:

- ``int8_matmul`` at VGG16's fc6, fc7 and output layer, M = 16, with an
  x_scale and a bias, f32 out: the checkout's kernel with the K split that
  ``gemm_plan`` gives for 1, 2, 3 or 4 blocks an SM (``splits``; the chosen
  knob is ``matmul.BLOCKS_PER_SM``), and copies of ``csrc/`` with a few
  lines replaced (``INT8_VARIANTS``), each on its own tile's plan: a ring
  of 2 or 4 stages, BK = 256 with 2 stages, and two floors that compute no
  answer, one with the W stage's byte transpose taken out and one with the
  products taken out;
- ``layer_norm_fwd`` at BERT-base's 8192 x 768, f32 and bf16: the
  checkout's kernel on grids of 1, 2, 4 or 8 blocks an SM (``plans``; 8 is
  a block for every 8 rows, no row loop; the chosen knob is
  ``layer_norm.fwd_blocks_per_sm``), and copies of ``csrc/`` with a few
  lines replaced (``LN_VARIANTS``), each on the grid its launch bound asks
  for: four blocks an SM up to NV = 4; gain and bias held packed across
  rows (no widened copies), on two and on three blocks an SM; and a floor
  with the two row sums taken out.  Beside them, ``device_copy``: one
  ``Tensor.copy_`` of x into y's shape (the same bytes read and written,
  a yardstick of what the card streams at this size).

The copies are compiled with ``nvcc``, all at once, under
``build/int8_ln_variants/`` and loaded with ``ctypes``.  Each entry is the
median ms of ``chip_smoke.time_ms`` (L2 flushed, a device spin before each
window) of the C entry alone, and whether its answer equals the plain
version's (int8: ``bitwise``; LayerNorm: ``max_rel_err`` of y); a launch that
is refused reads as its error code.  The last line is nvidia-smi's name and
power limit.  Exits non-zero without CUDA or when a variant does not build.
"""
import ctypes
import json
import os
import shutil
import subprocess
import sys

import torch

#: name -> (source compiled, [(file, its text there, replacement)])
INT8_VARIANTS = {
    "stages_2": ("int8_matmul.cu", [("int8_matmul.cu", "constexpr int STAGES = 3;",
                                     "constexpr int STAGES = 2;")]),
    "stages_4": ("int8_matmul.cu", [("int8_matmul.cu", "constexpr int STAGES = 3;",
                                     "constexpr int STAGES = 4;")]),
    "bk256_stages_2": ("int8_matmul.cu", [
        ("int8_matmul.cu", "constexpr int BK = 128;", "constexpr int BK = 256;"),
        ("int8_matmul.cu", "constexpr int STAGES = 3;", "constexpr int STAGES = 2;")]),
    "floor_no_transpose": ("int8_matmul.cu", [
        ("skinny_gemm.cuh",
         "      transpose_stage<C>(reinterpret_cast<const int8_t*>(stage), wt, tid);\n", "")]),
    "floor_no_products": ("int8_matmul.cu", [
        ("skinny_gemm.cuh", "      imma_stage<C>(wt, xs, acc, warp, lane);\n", "")]),
}
_LN_ROW = "    // the next row's loads go out before this row is reduced\n"
#: gain and bias kept packed across rows (an empty asm a row hides them from
#: loop-invariant code motion, which would hold them widened to f32)
_PACKED = ("layer_norm_fwd.cu", _LN_ROW,
           "#pragma unroll\n    for (int j = 0; j < NV; ++j)\n#pragma unroll\n"
           "      for (int i = 0; i < GChunk<T, G>::WORDS; ++i)\n"
           "        asm volatile(\"\" : \"+r\"(g[j].w[i]), \"+r\"(b[j].w[i]));\n" + _LN_ROW)
#: name -> (source compiled, edits, blocks an SM it is launched with)
LN_VARIANTS = {
    "four_blocks_to_nv4": ("layer_norm_fwd.cu", [
        ("layer_norm_fwd.cu", "return nv <= 2 ? 4 : nv <= 6 ? 2 : 1;",
         "return nv <= 4 ? 4 : nv <= 6 ? 2 : 1;")], 4),
    "packed_gain": ("layer_norm_fwd.cu", [_PACKED], 2),
    "packed_gain_three_blocks_to_nv4": ("layer_norm_fwd.cu", [
        _PACKED, ("layer_norm_fwd.cu", "return nv <= 2 ? 4 : nv <= 6 ? 2 : 1;",
                  "return nv <= 2 ? 4 : nv <= 4 ? 3 : nv <= 6 ? 2 : 1;")], 3),
    "floor_no_row_sums": ("layer_norm_fwd.cu", [
        ("layer_norm_fwd.cu", "const float mean = row_sum(s, red[0], tpr, group) / (float)F;",
         "const float mean = 0.0f;"),
        ("layer_norm_fwd.cu", "const float var = row_sum(q, red[1], tpr, group) / (float)F;",
         "const float var = 1.0f;")], 2),
}
SPLIT_BLOCKS_PER_SM = (1, 2, 3, 4)
LN_BLOCKS_PER_SM = (1, 2, 4, 8)
_INT8_ARGS = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 4
              + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
_LN_ARGS = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 2 + [ctypes.c_longlong, ctypes.c_float]
            + [ctypes.c_int] * 5 + [ctypes.c_void_p])


def build_variants(build, root, variants):
    """{name: loaded library} of every variant, compiled in parallel."""
    nvcc = build.find_nvcc()
    procs = {}
    for name, (compiled, subs, *_) in variants.items():
        d = os.path.join(root, name)
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(build.CSRC, d)
        for fname, old, new in subs:
            path = os.path.join(d, fname)
            with open(path) as f:
                text = f.read()
            if text.count(old) != 1:
                raise RuntimeError(f"variant text not found once in {fname}: {old!r}")
            with open(path, "w") as f:
                f.write(text.replace(old, new))
        procs[name] = subprocess.Popen(
            [nvcc, *build.ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-shared",
             "-o", os.path.join(d, "lib.so"), os.path.join(d, compiled)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, p in procs.items():
        out, _ = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"variant {name} did not build:\n{out}")
        libs[name] = ctypes.CDLL(os.path.join(root, name, "lib.so"))
    return libs


def bind(lib):
    for fn, args in (("dl4j_int8_matmul", _INT8_ARGS), ("dl4j_layer_norm_fwd", _LN_ARGS)):
        if hasattr(lib, fn):
            getattr(lib, fn).argtypes = args
            getattr(lib, fn).restype = ctypes.c_int
    return lib


def int8_splits(matmul, tiles, M, N, K, sm_count, per_sm, bk):
    """``gemm_plan``'s K splits for ``int8_matmul`` with BLOCKS_PER_SM =
    per_sm and a BK of bk (the module's knobs are put back after)."""
    saved = (matmul.BLOCKS_PER_SM, tiles.DEFAULT_TILES["int8_matmul"])
    matmul.BLOCKS_PER_SM = per_sm
    tiles.DEFAULT_TILES["int8_matmul"] = saved[1].replace(block_k=bk)
    matmul.gemm_plan.cache_clear()
    try:
        return matmul.gemm_plan(M, N, K, sm_count, "int8_matmul").splits
    finally:
        matmul.BLOCKS_PER_SM, tiles.DEFAULT_TILES["int8_matmul"] = saved
        matmul.gemm_plan.cache_clear()


def int8_launcher(lib, xq, wq, w_scale, x_scale, bias, y, S):
    M, K = xq.shape
    N = wq.shape[1]
    ws = torch.empty(S * M * N, dtype=torch.int32, device=xq.device)
    ctr = torch.zeros(-(-N // 128) * -(-M // 16), dtype=torch.int32, device=xq.device)
    stream = torch.cuda.current_stream(xq.device).cuda_stream
    ptrs = [t.data_ptr() for t in (xq, wq, w_scale, bias, y, ws, ctr)]
    return lambda: lib.dl4j_int8_matmul(*ptrs, M, N, K, S, x_scale, 0, stream)


def ln_launcher(lib, x, g, b, outs, tpr, nv, blocks):
    rows, F = x.shape
    code = 0 if x.dtype == torch.float32 else 1
    stream = torch.cuda.current_stream(x.device).cuda_stream
    ptrs = [t.data_ptr() for t in (x, g, b, *outs)]
    return lambda: lib.dl4j_layer_norm_fwd(*ptrs, rows, F, F, 1e-12, tpr, nv, blocks, code,
                                           code, stream)


def timed(cs, run, dev, check):
    rc = run()
    torch.cuda.synchronize()
    if rc != 0:
        return {"error": rc}
    return {"ms": cs.time_ms(run, dev), **check()}


def main():
    if not torch.cuda.is_available():
        print("int8_ln_variants: CUDA is not available", file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    import chip_smoke as cs
    from deeplearning4j_tpu_torch.ops import norm_kernels as nk
    from deeplearning4j_tpu_torch.ops import quant_kernels as qk
    from deeplearning4j_tpu_torch.ops.kernels import build, layer_norm, matmul, tiles

    dev = torch.device("cuda", 0)
    sm_count = torch.cuda.get_device_properties(dev).multi_processor_count
    checkout = bind(build.library())
    root = os.path.join(here, "build", "int8_ln_variants")
    libs = {n: bind(lib) for n, lib in
            build_variants(build, root, {**INT8_VARIANTS, **LN_VARIANTS}).items()}

    M = 16
    for layer, (K, N) in cs.VGG_DENSE.items():
        gen = torch.Generator(device=dev).manual_seed(4)
        qt = qk.quantize_tensor(torch.randn(K, N, generator=gen, device=dev) / K ** 0.5)
        b = torch.randn(N, generator=gen, device=dev)
        xq = qk.quantize_activation(torch.randn(M, K, generator=gen, device=dev), 0.05)
        want = matmul.int8_matmul_plain(xq, qt.q, qt.scale, x_scale=0.05, bias=b)
        line = {"kernel": "int8_matmul", "layer": layer, "M": M, "K": K, "N": N,
                "splits": {}, "variants": {}}

        def run(lib, S):
            y = torch.empty_like(want)
            return timed(cs, int8_launcher(lib, xq, qt.q, qt.scale, 0.05, b, y, S), dev,
                         lambda: {"S": S, "bitwise": bool(torch.equal(y, want))})
        for per_sm in SPLIT_BLOCKS_PER_SM:
            S = int8_splits(matmul, tiles, M, N, K, sm_count, per_sm, 128)
            line["splits"][f"sm{per_sm}"] = run(checkout, S)
        for name in INT8_VARIANTS:
            bm, bn, bk = (ctypes.c_int() for _ in range(3))
            libs[name].dl4j_int8_matmul_tile(ctypes.byref(bm), ctypes.byref(bn),
                                             ctypes.byref(bk))
            S = int8_splits(matmul, tiles, M, N, K, sm_count, matmul.BLOCKS_PER_SM, bk.value)
            line["variants"][name] = run(libs[name], S)
        print(json.dumps(line), flush=True)

    rows, F = 8192, 768
    for dt in (torch.float32, torch.bfloat16):
        gen = torch.Generator(device=dev).manual_seed(5)
        x = torch.randn(rows, F, generator=gen, device=dev).to(dt)
        g = torch.randn(F, generator=gen, device=dev).to(dt)
        b = torch.randn(F, generator=gen, device=dev).to(dt)
        want = nk.layer_norm_plain(x, g, b, 1e-12)[0].float()
        plan = layer_norm.ln_fwd_plan(rows, F, x.element_size(), sm_count)
        groups = 256 // plan.threads_per_row
        line = {"kernel": "layer_norm_fwd", "shape": [rows, F], "dtype": str(dt),
                "chosen": plan._asdict(), "plans": {}, "variants": {}}

        def run(lib, blocks):
            outs = (torch.empty_like(x), torch.empty(rows, device=dev),
                    torch.empty(rows, device=dev))
            err = lambda: {"blocks": blocks, "max_rel_err": (  # noqa: E731
                (outs[0].float() - want).abs().max() / want.abs().max()).item()}
            return timed(cs, ln_launcher(lib, x, g, b, outs, plan.threads_per_row, plan.nv,
                                         blocks), dev, err)
        for per_sm in LN_BLOCKS_PER_SM:
            line["plans"][f"sm{per_sm}"] = run(checkout, min(-(-rows // groups),
                                                             per_sm * sm_count))
        for name, (_, _, per_sm) in LN_VARIANTS.items():
            line["variants"][name] = run(libs[name], min(-(-rows // groups), per_sm * sm_count))
        y = torch.empty_like(x)
        line["device_copy"] = {"ms": cs.time_ms(lambda: y.copy_(x), dev)}
        print(json.dumps(line), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
