#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA Hopper card and hold its kernels to
their plain versions.

Run from the root of a checkout, on a machine with one H100:

    python3 chip_smoke.py

Phases, one JSON line each; any failure raises and exits non-zero:

1. device  — nvidia-smi's name and power limit; compute capability (9, 0).
2. build   — compile the CUDA kernels from ``csrc/`` (``nvcc``, sm_90a).
3. parity  — ``fused_dense`` against ``fused_dense_reference`` on the card
   at M in {1, 2, 4, 8, 16} (every bucket the slice serves) and {37, 128}
   (ragged and multi-tile), and (K, N) in {(25088, 4096), (4096, 4096),
   (4096, 1000), (800, 500)}, every epilogue activation, f32 and bf16.
   f32 (TF32 off): max|diff| <= 1e-4 * max|ref| (summation order differs
   at K = 25088).  bf16: max|diff| <= 2 bf16 ulps of max|ref|.
4. slice   — the main path: ``ModelServer(max_batch=16, device="cuda")``
   deploys full-width VGG16 (224x224x3, 1000 classes, f32, random weights
   from the zoo seed) with warmup; 8 client threads send 12 requests of
   1-8 rows.  Every answer must equal the same model's forward in
   ``reference`` dispatch mode within the f32 tolerance, and the kernel's
   launch count must be 2 per warmup run and per dispatch (fc6 and fc7;
   the softmax head is plain).  Also times the whole forward at the top
   bucket (16 rows) with the kernel and in ``reference`` mode.
   profile — one bucket-16 forward under ``torch.profiler``: kernels by
   device time and the device's idle share of the window.
5. times   — fc6 and fc7 at M = 16 in f32 and bf16: the kernel, its plain
   version and ``torch.addmm`` + relu (a yardstick the port never calls),
   each the median of 25 launches timed with CUDA events, L2 flushed
   before each; beside the bound (bytes over 3.35 TB/s or operations over
   the type's peak, whichever is larger).

Then the kernels line, nvidia-smi's line, and the last line
``{"ok": true, "device": {...}}``.  Exits non-zero, printing no result,
without CUDA or outside a checkout of the repository.
"""
import json
import math
import os
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {torch.float32: 67e12, torch.bfloat16: 989e12}
REPLACES = "deeplearning4j_tpu/ops/pallas/matmul.py:79"
SOURCE = "deeplearning4j_tpu_torch/ops/kernels/csrc/fused_dense.cu"
ACTS = ("identity", "linear", "relu", "tanh", "sigmoid", "gelu")
F32_RTOL = 1e-4


def emit(phase, **kw):
    print(json.dumps({"phase": phase, **kw}), flush=True)


def require(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def bf16_ulp(v):
    return 2.0 ** (math.floor(math.log2(max(v, 2.0 ** -126))) - 7)


def tolerance(dtype, ref_max):
    if dtype == torch.float32:
        return F32_RTOL * ref_max
    return 2.0 * bf16_ulp(ref_max)


def phase_device():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60
    ).stdout.strip().splitlines()[0]
    cap = tuple(torch.cuda.get_device_capability(0))
    emit("device", name=torch.cuda.get_device_name(0), capability=cap,
         nvidia_smi=smi, count=torch.cuda.device_count(),
         torch=torch.__version__, cuda=torch.version.cuda)
    require(cap == (9, 0), f"compute capability {cap}, want (9, 0)")
    return smi


def phase_build(build):
    t0 = time.monotonic()
    build.library()
    info = build.last_build
    ptxas = [l.strip() for l in info.get("ptxas", "").splitlines()
             if "registers" in l or "spill" in l]
    emit("build", seconds=time.monotonic() - t0, cached=info["cached"],
         library=os.path.relpath(info["path"]), ptxas=sorted(set(ptxas)))


def phase_parity(matmul, dev):
    gen = torch.Generator(device=dev).manual_seed(0)
    worst = {}
    for K, N in [(25088, 4096), (4096, 4096), (4096, 1000), (800, 500)]:
        w32 = torch.randn(K, N, generator=gen, device=dev) / math.sqrt(K)
        b = torch.randn(N, generator=gen, device=dev)
        for M in (1, 2, 4, 8, 16, 37, 128):
            x32 = torch.randn(M, K, generator=gen, device=dev)
            for dt in (torch.float32, torch.bfloat16):
                x, w = x32.to(dt), w32.to(dt)
                errs = {}
                for act in ACTS:
                    before = matmul.LAUNCHES.value
                    y = matmul.fused_dense(x, w, b, act)
                    torch.cuda.synchronize()
                    require(matmul.LAUNCHES.value == before + 1,
                            "fused_dense did not launch its kernel")
                    r = matmul.fused_dense_reference(x, w, b, act)
                    require(y.dtype == dt and y.shape == (M, N),
                            f"kernel output {y.dtype} {tuple(y.shape)}")
                    err = (y.float() - r.float()).abs().max().item()
                    ref = r.float().abs().max().item()
                    errs[act] = {"abs": err, "rel": err / max(ref, 1e-30)}
                    require(err <= tolerance(dt, ref),
                            f"fused_dense M={M} K={K} N={N} {dt} {act}: "
                            f"max|diff| {err} > tol {tolerance(dt, ref)}")
                    worst[(M, K, N, str(dt), act)] = err
                emit("parity", M=M, K=K, N=N, dtype=str(dt), errors=errs)
    emit("parity_done", cases=len(worst), ok=True)
    return worst


def phase_slice(matmul, dispatch, ModelServer, dev):
    sizes = [1, 8, 3, 5, 2, 7, 4, 6, 1, 8, 2, 5]
    rng = np.random.default_rng(0)
    reqs = [rng.standard_normal((n, 224, 224, 3), dtype=np.float32)
            for n in sizes]
    matmul.LAUNCHES.reset()
    t0 = time.monotonic()
    srv = ModelServer(max_batch=16, device=dev)
    try:
        entry = srv.deploy("vgg16", zoo="VGG16", warmup=True)
        deploy_s = time.monotonic() - t0
        with ThreadPoolExecutor(max_workers=8) as ex:
            futs = [ex.submit(srv.output, "vgg16", r, timeout=600)
                    for r in reqs]
            outs = [f.result() for f in futs]
        launches = matmul.LAUNCHES.value
        stats = srv.stats()
        retries = srv.metrics.dispatch_retries.value
    finally:
        srv.shutdown()
    warm_runs = len(entry.warmed_buckets)
    dispatches = stats["dispatches"]
    require(retries == 0 and stats["failed"] == 0,
            f"dispatch retries {retries}, failures {stats['failed']}")
    require(launches > 0 and launches == 2 * (warm_runs + dispatches),
            f"fused_dense launches {launches} != 2 x ({warm_runs} warmup "
            f"runs + {dispatches} dispatches)")

    # the whole forward at the top bucket, with the kernel and with the
    # plain version: the kernel's share of a dispatch, end to end
    x16 = torch.as_tensor(rng.standard_normal((16, 224, 224, 3),
                                              dtype=np.float32), device=dev)
    forward_ms = time_ms(lambda: entry.model.output(x16), dev, n=5)
    prev = dispatch.set_dispatch_mode("reference")
    try:
        refs = [entry.model.output(r).float().cpu().numpy() for r in reqs]
        forward_ref_ms = time_ms(lambda: entry.model.output(x16), dev, n=5)
    finally:
        dispatch.set_dispatch_mode(prev)
    worst_rel = 0.0
    for n, o, r in zip(sizes, outs, refs):
        require(o.shape == (n, 1000) and np.isfinite(o).all(),
                f"answer shape {o.shape} or non-finite values")
        require(np.allclose(o.sum(axis=1), 1.0, atol=1e-4),
                "softmax rows do not sum to 1")
        err = float(np.abs(o - r).max())
        tol = F32_RTOL * float(np.abs(r).max())
        require(err <= tol, f"answer differs from reference: {err} > {tol}")
        worst_rel = max(worst_rel, err / float(np.abs(r).max()))
    lat = stats["latency_ms"]
    emit("slice", model="VGG16", input="224x224x3 f32", classes=1000,
         params=entry.model.num_params(), requests=len(reqs),
         rows=sum(sizes), deploy_s=deploy_s, warmup_runs=warm_runs,
         dispatches=dispatches, launches=launches,
         cache=stats["compile_cache"], latency_p50_ms=lat["p50"],
         latency_p99_ms=lat["p99"], dispatch_ms=stats["dispatch_ms"],
         batch_occupancy=stats["batch_occupancy"],
         max_rel_err_vs_reference=worst_rel,
         forward_ms_bucket16=forward_ms,
         forward_reference_ms_bucket16=forward_ref_ms)
    return launches, entry.model


def phase_profile(model, dev):
    """Where one bucket-16 forward's time goes on the card: kernels by
    device time (torch.profiler), and the device's idle share of the
    profiled window (host clock around the forward and a synchronize).
    Reports "not measured" if the profiler sees no device activity."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    x = torch.randn(16, 224, 224, 3, device=dev)
    model.output(x)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        model.output(x)
        torch.cuda.synchronize()
        window_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not kernels:
        emit("profile", bucket=16, window_ms=window_ms,
             device_busy_ms="not measured", idle_share="not measured")
        return
    spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    busy_us, end = 0.0, float("-inf")
    for a, b in spans:                  # union of kernel intervals
        if b > end:
            busy_us += b - max(a, end)
            end = b
    by_name = {}
    for e in kernels:
        ms, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (ms + e.time_range.elapsed_us() / 1e3, n + 1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    emit("profile", bucket=16, window_ms=window_ms,
         device_busy_ms=busy_us / 1e3,
         idle_share=max(0.0, 1.0 - busy_us / 1e3 / window_ms),
         kernels=len(kernels),
         fused_dense_ms=sum(ms for name, (ms, _) in by_name.items()
                            if "fused_dense_kernel" in name),
         top=[{"name": name[:100], "count": n, "ms": ms}
              for name, (ms, n) in top])


def time_ms(fn, dev, n=25):
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.float32, device=dev)
    fn()
    fn()
    ts = []
    for _ in range(n):
        flush.zero_()
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        ts.append(s.elapsed_time(e))
    return statistics.median(ts)


def bound(M, K, N, dt):
    es = torch.tensor([], dtype=dt).element_size()
    nbytes = (M * K + K * N + M * N) * es + N * 4
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = 2.0 * M * N * K / PEAK_OPS_PER_S[dt]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def phase_times(matmul, dev):
    rows = {}
    M = 16
    for layer, (K, N) in (("fc6", (25088, 4096)), ("fc7", (4096, 4096))):
        for dt in (torch.float32, torch.bfloat16):
            gen = torch.Generator(device=dev).manual_seed(1)
            x = torch.randn(M, K, generator=gen, device=dev).to(dt)
            w = (torch.randn(K, N, generator=gen, device=dev) / math.sqrt(K)).to(dt)
            b = torch.randn(N, generator=gen, device=dev)
            bl = b.to(dt)
            y = matmul.fused_dense(x, w, b, "relu")
            r = matmul.fused_dense_reference(x, w, b, "relu")
            err = (y.float() - r.float()).abs().max().item()
            ms = time_ms(lambda: matmul.fused_dense(x, w, b, "relu"), dev)
            plain = time_ms(lambda: matmul.fused_dense_reference(x, w, b, "relu"), dev)
            lib = time_ms(lambda: torch.relu(torch.addmm(bl, x, w)), dev)
            bound_ms, bound_by = bound(M, K, N, dt)
            rows[(layer, dt)] = dict(ms=ms, plain_ms=plain, library_ms=lib,
                                     bound_ms=bound_ms, bound_by=bound_by,
                                     max_abs_err=err)
            emit("times", layer=layer, M=M, K=K, N=N, dtype=str(dt),
                 activation="relu", **rows[(layer, dt)])
    return rows


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from deeplearning4j_tpu_torch.ops.kernels import build, dispatch, matmul
    from deeplearning4j_tpu_torch.serving import ModelServer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dispatch.set_dispatch_mode("auto")
    dev = torch.device("cuda", 0)
    t_start = time.monotonic()

    smi = phase_device()
    phase_build(build)
    phase_parity(matmul, dev)
    launches, model = phase_slice(matmul, dispatch, ModelServer, dev)
    phase_profile(model, dev)
    del model
    rows = phase_times(matmul, dev)

    emit("done", seconds=time.monotonic() - t_start)
    main_row = rows[("fc6", torch.float32)]
    print(json.dumps({"kernels": [{
        "name": "fused_dense", "route": "cuda", "source": SOURCE,
        "replaces": REPLACES, "launches": launches,
        "max_abs_err": main_row["max_abs_err"], "ms": main_row["ms"],
        "plain_ms": main_row["plain_ms"], "bound_ms": main_row["bound_ms"],
        "bound_by": main_row["bound_by"],
        "library_ms": main_row["library_ms"],
        "shape": "fc6 M=16 K=25088 N=4096 f32 relu"}]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
