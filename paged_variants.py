#!/usr/bin/env python3
"""Time the paged-attention kernel against other grids and variants of its
source on one NVIDIA Hopper card.

Run from the root of a checkout, on a machine with one H100:

    python3 paged_variants.py

At ``chip_smoke.py``'s timing shape ([16, 12, 64] over 2,048-token
histories, page 16), for int8 pages under f32 q, bf16 pages and f32 pages,
each prints one JSON line:

- ``plans``: the checkout's kernel launched on grids that ``paged_plan``
  would give with other knobs, heads a block in {1, 2, 4} times blocks per
  SM in {2, 4, 8} (``plan``, below; the chosen knobs are
  ``HEADS_PER_BLOCK`` and ``BLOCKS_PER_SM``);
- ``variants``: on the chosen plan, copies of ``csrc/paged_attention.cu``
  with a few lines replaced (``VARIANTS``): a third ring stage, and two
  floors that compute no answer, one with the copies taken out (what the
  arithmetic and the barriers cost) and one with the arithmetic taken out
  (what the copies cost).  The sources are compiled with ``nvcc``, all at
  once, under ``build/paged_variants/`` and loaded with ``ctypes``.

Each entry is the median ms of ``chip_smoke.time_ms`` (L2 flushed, a device
spin before each window) and the largest error relative to max|ref| of the
plain version; a launch that is refused reads as its error code.  The last
line is nvidia-smi's name and power limit.  Exits non-zero without CUDA or
when a variant does not build.
"""
import ctypes
import json
import os
import shutil
import subprocess
import sys

import torch

SOURCE = "paged_attention.cu"
#: name -> [(its text in SOURCE, replacement)]
VARIANTS = {
    "stages_3": [("constexpr int STAGES = 2;", "constexpr int STAGES = 3;")],
    "no_copies": [("      if (t < n_tiles) load(t);\n", ""),
                  ("      if (t + STAGES - 1 < n_tiles) load(t + STAGES - 1);\n", "")],
    "no_arithmetic": [("      compute(t);\n", "")],
}
HEADS = (1, 2, 4)
BLOCKS_PER_SM = (2, 4, 8)
_ARGS = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 8 + [ctypes.c_float]
         + [ctypes.c_int] * 2 + [ctypes.c_void_p])


def source(text, subs):
    for old, new in subs:
        if text.count(old) != 1:
            raise RuntimeError(f"variant text not found once: {old!r}")
        text = text.replace(old, new)
    return text


def plan(pa, B, H, D, page, max_pages, kv_itemsize, sm_count, heads_per_block,
         blocks_per_sm):
    """``pa.paged_plan`` with its two knobs given."""
    rows = pa.tile_rows(D, kv_itemsize)
    heads = 1
    while (heads * 2 <= min(heads_per_block, rows // pa._ROWS_PER_GROUP)
           and H % (heads * 2) == 0):
        heads *= 2
    groups = B * H // heads
    min_pages = max(1, rows // heads // page)
    most = max(1, min(pa.MAX_SPLITS, max_pages // min_pages))
    splits = max(1, min(most, -(-blocks_per_sm * sm_count // groups)))
    per = -(-max_pages // splits)
    splits = -(-max_pages // per)
    return pa.PagedPlan(splits, per, heads, rows, groups * splits)


def build_variants(build, root):
    """{name: loaded library} of every variant, compiled in parallel."""
    nvcc = build.find_nvcc()
    procs = {}
    for name, subs in VARIANTS.items():
        d = os.path.join(root, name)
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(build.CSRC, d)
        path = os.path.join(d, SOURCE)
        with open(path) as f:
            text = source(f.read(), subs)
        with open(path, "w") as f:
            f.write(text)
        procs[name] = subprocess.Popen(
            [nvcc, *build.ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-shared",
             "-o", os.path.join(d, "lib.so"), path],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, p in procs.items():
        out, _ = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"variant {name} did not build:\n{out}")
        lib = ctypes.CDLL(os.path.join(root, name, "lib.so"))
        lib.dl4j_paged_attention.argtypes = _ARGS
        lib.dl4j_paged_attention.restype = ctypes.c_int
        libs[name] = lib
    return libs


def launcher(pa, lib, pl, args, kw, out):
    """A no-argument launch of `lib`'s kernel on the plan `pl`; returns
    its code."""
    q, k, v, bt, sl = args
    B, H, D = q.shape
    quantized = k.dtype == torch.int8
    ws = torch.empty(B * H * pl.splits * (D + 2), dtype=torch.float32, device=q.device)
    ctr = torch.zeros(B * H, dtype=torch.int32, device=q.device)
    ptrs = [t.data_ptr() for t in (q, k, v)]
    ptrs += [kw["k_scales"].data_ptr() if quantized else None,
             kw["v_scales"].data_ptr() if quantized else None]
    ptrs += [t.data_ptr() for t in (bt, sl, out, ws, ctr)]
    stream = torch.cuda.current_stream(q.device).cuda_stream
    ints = (B, H, D, k.shape[1], bt.shape[1], pl.splits, pl.pages_per_split, pl.heads)
    return lambda: lib.dl4j_paged_attention(*ptrs, *ints, D ** -0.5, pa._Q_CODES[q.dtype],
                                            int(quantized), stream)


def timed(cs, run, dev, out, want):
    """{ms, max_rel_err} of a launcher, or {error: code} if it cannot launch."""
    rc = run()
    torch.cuda.synchronize()
    if rc != 0:
        return {"error": rc}
    err = ((out.float() - want.float()).abs().max() / want.float().abs().max()).item()
    return {"ms": cs.time_ms(run, dev), "max_rel_err": err}


def main():
    if not torch.cuda.is_available():
        print("paged_variants: CUDA is not available", file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    import chip_smoke as cs
    from deeplearning4j_tpu_torch.ops.kernels import build
    from deeplearning4j_tpu_torch.ops.kernels import paged_attention as pa

    dev = torch.device("cuda", 0)
    sm_count = torch.cuda.get_device_properties(dev).multi_processor_count
    checkout = build.library()
    libs = build_variants(build, os.path.join(here, "build", "paged_variants"))
    B, H, D, L = 16, 12, 64, 2048
    for mode, dt, kv_int8 in cs.PAGED_MODES[:3]:
        args, kw = cs._paged_inputs(B, H, D, [L] * B, dt, kv_int8, dev, seed=30)
        want = pa.paged_attention_plain(*args, **kw)
        itemsize = args[1].element_size()
        chosen = pa.paged_plan(B, H, D, cs.PAGE, L // cs.PAGE, itemsize, sm_count)
        line = {"shape": [B, H, D], "history": L, "page": cs.PAGE, "kv": mode,
                "chosen": chosen._asdict(), "plans": {}, "variants": {}}
        for heads in HEADS:
            for per_sm in BLOCKS_PER_SM:
                pl = plan(pa, B, H, D, cs.PAGE, L // cs.PAGE, itemsize, sm_count, heads, per_sm)
                out = torch.empty_like(want)
                line["plans"][f"heads{heads}_sm{per_sm}"] = dict(
                    timed(cs, launcher(pa, checkout, pl, args, kw, out), dev, out, want),
                    heads=pl.heads, splits=pl.splits, blocks=pl.blocks)
        for name, lib in libs.items():
            out = torch.empty_like(want)
            line["variants"][name] = timed(cs, launcher(pa, lib, chosen, args, kw, out), dev,
                                           out, want)
        print(json.dumps(line), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
