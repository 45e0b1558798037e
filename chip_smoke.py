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
   The parity phase also takes one backward through the kernel
   (``FusedDense``) and holds its gradients to the plain version's.
5. times   — fc6 and fc7 at M = 16 in f32 and bf16: the kernel, its plain
   version and ``torch.addmm`` + relu (a yardstick the port never calls),
   each the median of 25 launches timed with CUDA events, L2 flushed
   before each; beside the bound (bytes over 3.35 TB/s or operations over
   the type's peak, whichever is larger).
6. conv_parity — ``conv3x3_wgrad`` and ``conv3x3_dgrad`` against their
   plain versions at ResNet-50's four body shapes at batch 64 (56x56x64,
   28x28x128, 14x14x256, 7x7x512) and at ragged shapes (3x13x13, Ci 24,
   Co 40; 5x7x7, Ci 96, Co 80), f32 and bf16; each call must add one to
   its launch count.  f32: max|diff| <= 1e-4 * max|ref| (K reaches 200k
   terms summed in another order); bf16 inputs: 2 bf16 ulps of max|ref|.
7. train — the training slice: full-width ResNet-50 (224x224x3, 1000
   classes, seed 123, Nesterovs(0.1, 0.9), f32, batch 64, inputs from
   numpy seed 0 as bench.py makes them).  ``gradient_for`` on the initial
   parameters in ``auto`` and in ``reference`` mode agrees per tensor
   within 1e-4 * max|ref|; then 3 ``fit`` steps in ``auto`` mode, with the
   launch counts set to 0 just before and read just after (exactly 16
   wgrad and 16 dgrad launches per step), and 3 steps of a second net
   with the same initial parameters in ``reference`` mode, run twice.
   The first step's update agrees within 1e-4 of its size; each step's
   loss within 1e-4 relative, or 1e-1 once the loss has risen above the
   first step's (the run diverges; ``DIVERGED_LOSS_RTOL`` says why).
   Step ms in each mode (host clock with a synchronize, median of the
   steps after the first) and peak memory.
8. train_bf16 — 2 steps with ``compute_dtype="bfloat16"``: finite losses,
   16 + 16 launches per step.
9. train_profile — one f32 step under ``torch.profiler``: device busy
   time, idle share, the top kernels and the conv kernels' share.
10. conv_times — each conv kernel at the four body shapes in f32 and
   bf16: kernel ms, plain ms and cuDNN's backward
   (``torch.nn.grad.conv2d_weight`` / ``conv2d_input``, TF32 off; a
   yardstick the port never calls), each the median of 25 runs with L2
   flushed, beside the bound.

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
CONV_KERNELS = {
    "conv3x3_wgrad": ("deeplearning4j_tpu/ops/conv_kernels.py:35",
                      "deeplearning4j_tpu_torch/ops/kernels/csrc/conv3x3_wgrad.cu"),
    "conv3x3_dgrad": ("deeplearning4j_tpu/ops/conv_kernels.py:115",
                      "deeplearning4j_tpu_torch/ops/kernels/csrc/conv3x3_dgrad.cu"),
}
#: ResNet-50's 3x3 stride-1 body convs at batch 64: (B, H, W, Ci, Co)
BODY_SHAPES = {"s0": (64, 56, 56, 64, 64), "s1": (64, 28, 28, 128, 128),
               "s2": (64, 14, 14, 256, 256), "s3": (64, 7, 7, 512, 512)}
RAGGED_SHAPES = [(3, 13, 13, 24, 40), (5, 7, 7, 96, 80)]
BODY_CONVS = 16
ACTS = ("identity", "linear", "relu", "tanh", "sigmoid", "gelu")
F32_RTOL = 1e-4
#: bound on a training step's loss against reference mode once the loss
#: rises above the first step's: ResNet-50 at Nesterovs(0.1, 0.9) with no
#: warmup diverges at step 3 (7.5 -> 16.5) and amplifies a 1e-6 difference
#: in step 2's update some 1e4-fold.  On an H100 two reference-mode runs of
#: the same code differed there by 1.7e-3 to 1.05e-2 (cuDNN's backward of
#: the 1x1 and 7x7 convs is not bitwise repeatable) and the kernels against
#: reference mode by 7e-4 to 7.6e-3, so 1e-4 cannot hold; 1e-1 leaves
#: tenfold room over the worst seen
DIVERGED_LOSS_RTOL = 1e-1


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
    # one backward through the kernel (FusedDense): the plain VJP
    for act in ("relu", "gelu"):
        x = torch.randn(16, 4096, generator=gen, device=dev, requires_grad=True)
        w = (torch.randn(4096, 1000, generator=gen, device=dev) / 64.0).requires_grad_()
        b = torch.randn(1000, generator=gen, device=dev, requires_grad=True)
        g = torch.randn(16, 1000, generator=gen, device=dev)
        before = matmul.LAUNCHES.value
        got = torch.autograd.grad(matmul.fused_dense(x, w, b, act), (x, w, b), g)
        require(matmul.LAUNCHES.value == before + 1,
                "fused_dense backward check did not launch the kernel")
        want = torch.autograd.grad(matmul.fused_dense_reference(x, w, b, act),
                                   (x, w, b), g)
        errs = []
        for name, a, r in zip("xwb", got, want):
            err = (a - r).abs().max().item()
            ref = r.abs().max().item()
            require(err <= F32_RTOL * ref,
                    f"fused_dense backward d{name} {act}: {err} > {F32_RTOL * ref}")
            errs.append(err / ref)
        emit("parity_backward", kernel="fused_dense", activation=act,
             rel_errors=dict(zip(("dx", "dW", "db"), errs)))
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


def conv_bound(kernel, B, H, W, Ci, Co, dt):
    """Least time for one call: the operations 2*9*Ci*Co*B*H*W over the
    type's peak, or the bytes (each input read once, the f32 output
    written once) over 3.35 TB/s, whichever is larger."""
    es = torch.tensor([], dtype=dt).element_size()
    K = B * H * W
    if kernel == "conv3x3_wgrad":
        nbytes = K * (Ci + Co) * es + 9 * Ci * Co * 4
    else:
        nbytes = K * Co * es + 9 * Ci * Co * es + K * Ci * 4
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = 2.0 * 9 * Ci * Co * K / PEAK_OPS_PER_S[dt]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def _conv_inputs(shape, dt, dev, seed):
    B, H, W, Ci, Co = shape
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(B, H, W, Ci, generator=gen, device=dev).to(dt)
    dy = torch.randn(B, H, W, Co, generator=gen, device=dev).to(dt)
    w = (torch.randn(Co, Ci, 3, 3, generator=gen, device=dev)
         / math.sqrt(9 * Ci)).to(dt)
    return x, dy, w


def phase_conv_parity(ck, conv3x3, dev):
    shapes = list(BODY_SHAPES.values()) + RAGGED_SHAPES
    cases = 0
    for i, shape in enumerate(shapes):
        for dt in (torch.float32, torch.bfloat16):
            x, dy, w = _conv_inputs(shape, dt, dev, seed=10 + i)
            errs = {}
            for name, counter, fn, ref_fn, args in (
                    ("conv3x3_wgrad", conv3x3.WGRAD_LAUNCHES, ck.conv3x3_wgrad,
                     ck.conv3x3_wgrad_reference, (x, dy)),
                    ("conv3x3_dgrad", conv3x3.DGRAD_LAUNCHES, ck.conv3x3_dgrad,
                     ck.conv3x3_dgrad_reference, (dy, w))):
                before = counter.value
                got = fn(*args)
                torch.cuda.synchronize()
                require(counter.value == before + 1, f"{name} did not launch its kernel")
                ref = ref_fn(*args)
                require(got.dtype == torch.float32 and got.shape == ref.shape,
                        f"{name} output {got.dtype} {tuple(got.shape)}")
                err = (got - ref).abs().max().item()
                rmax = ref.abs().max().item()
                require(err <= tolerance(dt, rmax),
                        f"{name} {shape} {dt}: max|diff| {err} > tol {tolerance(dt, rmax)}")
                errs[name] = {"abs": err, "rel": err / max(rmax, 1e-30)}
                cases += 1
            emit("conv_parity", shape=list(shape), dtype=str(dt), errors=errs)
    emit("conv_parity_done", cases=cases, ok=True)


def _resnet50(ResNet50, Nesterovs, dev, compute_dtype=None, image=224,
              classes=1000):
    return ResNet50(n_classes=classes, input_shape=(image, image, 3), seed=123,
                    updater=Nesterovs(0.1, 0.9),
                    compute_dtype=compute_dtype).init_model(device=dev)


def _fit_steps(net, x, y, steps):
    losses, ms = [], []
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        net.fit(x, y)
        losses.append(net.score())         # reads the loss: synchronizes
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    return losses, ms


def _flat_params(net):
    return torch.cat([p.detach().flatten() for p in net.parameters()])


def _launch_counts(conv3x3):
    return conv3x3.WGRAD_LAUNCHES.value, conv3x3.DGRAD_LAUNCHES.value


def phase_train(conv3x3, dispatch, ResNet50, Nesterovs, dev, steps=3,
                batch=64, image=224, classes=1000, expect_params=25_557_032):
    rng = np.random.RandomState(0)
    x = torch.as_tensor(rng.rand(batch, image, image, 3).astype(np.float32),
                        device=dev)
    y = torch.as_tensor(np.eye(classes, dtype=np.float32)[
        rng.randint(0, classes, batch)], device=dev)
    net = _resnet50(ResNet50, Nesterovs, dev, image=image, classes=classes)
    ref_net = _resnet50(ResNet50, Nesterovs, dev, image=image, classes=classes)
    ref_net.load_state_dict(net.state_dict())
    n_params = net.num_params()
    require(expect_params is None or n_params == expect_params,
            f"ResNet-50 has {n_params} parameters, want {expect_params}")

    # gradient_for on the initial parameters, kernel against plain
    g_auto = net.gradient_for(x, y)
    prev = dispatch.set_dispatch_mode("reference")
    try:
        g_ref = ref_net.gradient_for(x, y)
    finally:
        dispatch.set_dispatch_mode(prev)
    worst_grad = 0.0
    for name, sub in g_ref.items():
        for k, r in sub.items():
            err = (g_auto[name][k] - r).abs().max().item()
            rmax = r.abs().max().item()
            require(err <= F32_RTOL * rmax,
                    f"gradient_for {name}.{k}: max|diff| {err} > {F32_RTOL} * {rmax}")
            worst_grad = max(worst_grad, err / max(rmax, 1e-30))
    del g_auto, g_ref

    # the main path: fit in auto mode, counts set to 0 just before; the
    # parameters after the first step are kept to compare the step's
    # update with reference mode's
    theta0 = _flat_params(net)
    state0 = {k: v.clone() for k, v in net.state_dict().items()}
    torch.cuda.reset_peak_memory_stats()
    conv3x3.WGRAD_LAUNCHES.reset()
    conv3x3.DGRAD_LAUNCHES.reset()
    losses, ms = _fit_steps(net, x, y, 1)
    theta1 = _flat_params(net)
    more, more_ms = _fit_steps(net, x, y, steps - 1)
    launches = _launch_counts(conv3x3)
    losses, ms = losses + more, ms + more_ms
    peak = torch.cuda.max_memory_allocated()

    # reference mode, twice from the same initial parameters: the second
    # run shows how far two runs of the same code drift apart
    runs = []
    prev = dispatch.set_dispatch_mode("reference")
    try:
        for rep in range(2):
            if rep:
                ref_net = _resnet50(ResNet50, Nesterovs, dev, image=image,
                                    classes=classes)
                ref_net.load_state_dict(state0)
            r_losses, r_ms = _fit_steps(ref_net, x, y, 1)
            r_theta1 = _flat_params(ref_net)
            r_more, r_more_ms = _fit_steps(ref_net, x, y, steps - 1)
            runs.append((r_losses + r_more, r_ms + r_more_ms, r_theta1))
            del ref_net
    finally:
        dispatch.set_dispatch_mode(prev)
    del state0
    (ref_losses, ref_ms, ref_theta1), (rerun_losses, _, rerun_theta1) = runs
    update = (ref_theta1 - theta0).abs().max().item()
    update_diff = (theta1 - ref_theta1).abs().max().item() / update
    rerun_update_diff = (rerun_theta1 - ref_theta1).abs().max().item() / update
    rel = [abs(a - r) / abs(r) for a, r in zip(losses, ref_losses)]
    rerun_rel = [abs(a - r) / abs(r) for a, r in zip(rerun_losses, ref_losses)]
    emit("train", model="ResNet50", input=f"{image}x{image}x3 f32",
         classes=classes, batch=batch, params=n_params,
         updater="Nesterovs(0.1, 0.9)", steps=steps,
         losses=losses, reference_losses=ref_losses,
         reference_rerun_losses=rerun_losses,
         rel_loss_diff=rel, rerun_rel_loss_diff=rerun_rel,
         step1_update_rel_diff=update_diff,
         rerun_step1_update_rel_diff=rerun_update_diff,
         max_rel_grad_diff=worst_grad,
         wgrad_launches=launches[0], dgrad_launches=launches[1],
         step_ms=statistics.median(ms[1:]), step_ms_all=ms,
         reference_step_ms=statistics.median(ref_ms[1:]),
         reference_step_ms_all=ref_ms,
         samples_per_sec=batch * 1e3 / statistics.median(ms[1:]),
         max_memory_allocated_gb=peak / 1e9)
    require(launches == (BODY_CONVS * steps, BODY_CONVS * steps),
            f"conv launches (wgrad, dgrad) {launches} != {BODY_CONVS} x {steps} each")
    require(all(math.isfinite(v) for v in losses + ref_losses), "non-finite loss")
    require(rel[0] <= F32_RTOL,
            f"first-step loss {losses[0]} vs reference {ref_losses[0]}")
    require(update_diff <= F32_RTOL,
            f"first step's update differs from reference mode's by {update_diff}")
    for i, (a, r) in enumerate(zip(rel, ref_losses)):
        tol = DIVERGED_LOSS_RTOL if r > ref_losses[0] else F32_RTOL
        require(a <= tol, f"step {i + 1} loss rel diff {a} > {tol} "
                          f"(reference rerun: {rerun_rel[i]})")
    return net, x, y, launches[0]


def phase_train_bf16(conv3x3, ResNet50, Nesterovs, dev, x, y, steps=2):
    net = _resnet50(ResNet50, Nesterovs, dev, compute_dtype="bfloat16",
                    image=x.shape[1], classes=y.shape[1])
    conv3x3.WGRAD_LAUNCHES.reset()
    conv3x3.DGRAD_LAUNCHES.reset()
    losses, ms = _fit_steps(net, x, y, steps)
    launches = _launch_counts(conv3x3)
    require(all(math.isfinite(v) for v in losses), f"bf16 losses {losses}")
    require(launches == (BODY_CONVS * steps, BODY_CONVS * steps),
            f"bf16 conv launches {launches} != {BODY_CONVS} x {steps} each")
    require(net.params_["s0b0_b_conv"]["W"].dtype == torch.float32,
            "bf16 compute must keep f32 master parameters")
    emit("train_bf16", model="ResNet50", batch=x.shape[0], steps=steps, losses=losses,
         wgrad_launches=launches[0], dgrad_launches=launches[1],
         step_ms_all=ms, step_ms=ms[-1])


def phase_train_profile(net, x, y):
    """One f32 fit step under torch.profiler: device busy time (union of
    kernel intervals), idle share of the window, the top kernels, and the
    share of busy time in the two conv backward kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        net.fit(x, y)
        net.score()
        torch.cuda.synchronize()
        window_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not kernels:
        emit("train_profile", window_ms=window_ms,
             device_busy_ms="not measured", idle_share="not measured")
        return
    spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    busy_us, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            busy_us += b - max(a, end)
            end = b
    by_name = {}
    for e in kernels:
        ms, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (ms + e.time_range.elapsed_us() / 1e3, n + 1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:15]

    def share(tag):
        return sum(ms for name, (ms, _) in by_name.items() if tag in name)
    busy_ms = busy_us / 1e3
    wgrad_ms = share("conv3x3_wgrad")
    dgrad_ms = share("conv3x3_dgrad")
    emit("train_profile", window_ms=window_ms, device_busy_ms=busy_ms,
         idle_share=max(0.0, 1.0 - busy_ms / window_ms), kernels=len(kernels),
         conv3x3_wgrad_ms=wgrad_ms, conv3x3_dgrad_ms=dgrad_ms,
         conv3x3_share_of_busy=(wgrad_ms + dgrad_ms) / busy_ms,
         top=[{"name": name[:100], "count": n, "ms": ms}
              for name, (ms, n) in top])


def phase_conv_times(ck, dev):
    rows = {}
    for stage, shape in BODY_SHAPES.items():
        B, H, W, Ci, Co = shape
        for dt in (torch.float32, torch.bfloat16):
            x, dy, w = _conv_inputs(shape, dt, dev, seed=1)
            xc, dyc = x.permute(0, 3, 1, 2), dy.permute(0, 3, 1, 2)
            for name, fn, plain, lib in (
                    ("conv3x3_wgrad", lambda: ck.conv3x3_wgrad(x, dy),
                     lambda: ck.conv3x3_wgrad_reference(x, dy),
                     lambda: torch.nn.grad.conv2d_weight(xc, w.shape, dyc, padding=1)),
                    ("conv3x3_dgrad", lambda: ck.conv3x3_dgrad(dy, w),
                     lambda: ck.conv3x3_dgrad_reference(dy, w),
                     lambda: torch.nn.grad.conv2d_input(xc.shape, w, dyc, padding=1))):
                err = (fn() - plain()).abs().max().item()
                bound_ms, bound_by = conv_bound(name, B, H, W, Ci, Co, dt)
                rows[(name, stage, dt)] = dict(
                    ms=time_ms(fn, dev), plain_ms=time_ms(plain, dev),
                    library_ms=time_ms(lib, dev), bound_ms=bound_ms,
                    bound_by=bound_by, max_abs_err=err)
                emit("conv_times", kernel=name, stage=stage, shape=list(shape),
                     dtype=str(dt), **rows[(name, stage, dt)])
    return rows


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from deeplearning4j_tpu_torch.ops import conv_kernels as ck
    from deeplearning4j_tpu_torch.ops.kernels import build, conv3x3, dispatch, matmul
    from deeplearning4j_tpu_torch.serving import ModelServer
    from deeplearning4j_tpu_torch.train import Nesterovs
    from deeplearning4j_tpu_torch.zoo import ResNet50

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
    phase_conv_parity(ck, conv3x3, dev)
    net, x, y, conv_launches = phase_train(conv3x3, dispatch, ResNet50,
                                           Nesterovs, dev)
    phase_train_profile(net, x, y)
    del net
    phase_train_bf16(conv3x3, ResNet50, Nesterovs, dev, x, y)
    del x, y
    conv_rows = phase_conv_times(ck, dev)

    emit("done", seconds=time.monotonic() - t_start)
    main_row = rows[("fc6", torch.float32)]
    kernels = [{
        "name": "fused_dense", "route": "cuda", "source": SOURCE,
        "replaces": REPLACES, "launches": launches,
        "max_abs_err": main_row["max_abs_err"], "ms": main_row["ms"],
        "plain_ms": main_row["plain_ms"], "bound_ms": main_row["bound_ms"],
        "bound_by": main_row["bound_by"],
        "library_ms": main_row["library_ms"],
        "shape": "fc6 M=16 K=25088 N=4096 f32 relu"}]
    for name, (replaces, source) in CONV_KERNELS.items():
        row = conv_rows[(name, "s0", torch.float32)]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": conv_launches,
            "max_abs_err": row["max_abs_err"], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
            "shape": "ResNet-50 s0 B=64 56x56 Ci=Co=64 f32; launches over "
                     "3 fit steps"})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
