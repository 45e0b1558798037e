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
11. ln_parity — ``layer_norm_fwd`` against ``layer_norm_plain`` at rows
   8192 (as 64x128 and 4x2048), 37 and 1, F in {768, 1000, 64}, eps 1e-12
   and 1e-5, f32 and bf16; y, mean and rstd each held to the tolerance
   (mean and rstd are f32: 1e-4 * max|ref| in both dtypes); each call must
   add one to the launch count.
12. attn_parity — ``flash_attention`` (out, lse) against
   ``flash_attention_plain`` at [64,12,128,64], [4,12,2048,64] and the
   ragged [2,3,77,64] (S 77), [1,2,37,64] (S 200) and [2,2,130,128] (S
   100), causal or not,
   without a mask and with the last 28 positions dropped in half the
   batch rows, f32 and bf16; lse is f32: 1e-4 * max|ref| in both dtypes.
13. bert — the inference slice: full-width BERT-base (110,106,428
   parameters from a ``torch.Generator`` seeded 0), batch 64, T = 128, ids
   as bench.py makes them (``RandomState(0).randint(0, 30522)``), an
   all-ones mask and a padded one.  The launch counts are set to 0 just
   before ``output_hidden``, ``output_mlm`` and ``output_cls`` in ``auto``
   mode and read just after each: exactly 12 flash-attention and 25
   LayerNorm launches a forward, 26 for ``output_mlm``.  The MLM logits and
   class probabilities agree with ``reference`` mode within 1e-4 *
   max|ref| in f32 (TF32 off); in bf16 compute they are finite and agree
   within ``BERT_BF16_RTOL`` * max|ref| (reference mode runs bf16 scores
   and bf16 LayerNorm statistics, as the JAX package does off the TPU).
   Forward ms (host clock with a synchronize, median of 5) and tokens/s in
   each mode, and peak memory.
14. bert_long — the same at bench.py's long-sequence shape: batch 4,
   T = 2048, ``max_len`` 2048, f32 and bf16.
15. bert_profile — one T = 128 bf16 ``output_mlm`` under
   ``torch.profiler``: device busy time, idle share, the top kernels and
   the two kernels' share of busy time.
16. attn_times, ln_times — each kernel at the BERT shapes in f32 and bf16
   (attention [64,12,128,64] and [4,12,2048,64] with the all-ones mask;
   LayerNorm 8192 x 768): kernel ms, plain ms and one PyTorch call as a
   yardstick the port never calls (``scaled_dot_product_attention`` with
   the same mask, ``F.layer_norm``), each the median of 25 runs with L2
   flushed, beside the bound.
17. ln_bwd_parity — the backward kernel (``layer_norm.launch_bwd``)
   against ``layer_norm_bwd_plain`` at ln_parity's rows and F in {768,
   1000, 64, 4096} (a warp a row up to 1024, the block above), x and gain
   f32 or bf16 in each of the four pairs, with a bias and without, on the
   forward kernel's mean and rstd (and one dy whose rows are further apart
   than F); dx, dgain and dbias each held to the tolerance of its dtype;
   each call must add one to the backward's launch count.
18. attn_bwd_parity — the dQ and dK/dV kernels (``attention.launch_bwd``)
   against ``flash_attention_bwd_plain`` at attn_parity's shapes, causal or
   not, with no mask and with the padded one, f32 and bf16, on the forward
   kernel's out and lse, plus one case with head-split (strided) q, k, v
   and dO; dq, dk and dv each held to the tolerance; each call must add one
   dQ and one dK/dV launch.
19. bert_train — the training slice: full-width BERT-base (110,106,428
   parameters from a ``torch.Generator`` seeded 0), Adam(1e-4), batch 64,
   T = 128, inputs as bench.py makes them (``RandomState(0)`` ids, an
   all-ones mask, ``rand < 0.15`` label mask, sparse labels = the ids).
   f32, TF32 off: ``gradient_for`` on the initial parameters in ``auto``
   and in ``reference`` mode agrees per tensor within 1e-4 * max|ref|
   (``layers.bk``, whose gradient is zero in exact arithmetic, is held to
   be noise in both: within 1e-4 of ``layers.bq``'s max); then 3
   ``fit_batch`` steps in each mode from the same parameters, the launch
   counts set to 0 just before each step and read just after: exactly 12
   flash forward, 12 dQ, 12 dK/dV, 26 LayerNorm forward and 26 LayerNorm
   backward launches per step in ``auto`` mode, none in ``reference``
   mode.  Each loss agrees within 1e-4 relative; the first update within
   1e-4 of its size in the L2 norm over all parameters (``UPDATE_L2_RTOL``
   says why not element by element).  Step ms (host clock with a
   synchronize, median of the steps after the first), tokens/s and peak
   memory.  Then bf16 compute: ``gradient_for`` on the initial parameters
   per tensor within ``BERT_BF16_GRAD_RTOL`` * max|ref| of reference
   mode's; 3 steps in each mode, finite losses within
   ``BERT_BF16_LOSS_RTOL`` of reference mode's; ``fit_steps`` over a stack
   of 5 copies of the batch (as bench.py builds it) against 5 ``fit_batch``
   calls from the same start, losses within 1e-6 relative and 5 x the
   launch counts.
20. bert_train_iter — one ``fit(BertIterator(...))`` epoch of 2 batches of
   64 at T = 128 over a 30,522-word vocab the script makes (``[PAD]``,
   ``[UNK]``, ``[CLS]``, ``[SEP]``, ``[MASK]``, then ``w5`` ... ``w30521``)
   and sentences drawn with numpy from a seed: finite loss, iteration + 2.
21. bert_train_long — bf16 at batch 4, T = 2048, ``max_len`` 2048: 2
   ``fit_batch`` steps, finite losses, the same launch counts, step ms.
22. bert_train_profile — one bf16 T = 128 step under ``torch.profiler``:
   device busy time, idle share, the top kernels and each new kernel's
   share of busy time.
23. attn_bwd_times, ln_bwd_times — the backward kernels at the BERT shapes
   in f32 and bf16 (attention [64,12,128,64] and [4,12,2048,64] with the
   all-ones mask, dQ and dK/dV timed apart; LayerNorm 8192 x 768): kernel
   ms, plain ms and one PyTorch call as a yardstick the port never calls
   (``torch.autograd.grad`` through ``scaled_dot_product_attention`` with
   the same mask, its forward outside the timed region; the backward of
   ``F.layer_norm``), each the median of 25 runs with L2 flushed, beside
   the bound.

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
LN_KERNEL = ("deeplearning4j_tpu/ops/norm_kernels.py:40",
             "deeplearning4j_tpu_torch/ops/kernels/csrc/layer_norm_fwd.cu")
ATTN_KERNEL = ("deeplearning4j_tpu/ops/attention_kernels.py:148",
               "deeplearning4j_tpu_torch/ops/kernels/csrc/flash_attn_fwd.cu")
ATTN_BWD_KERNELS = {
    "flash_attn_bwd_dq": ("deeplearning4j_tpu/ops/attention_kernels.py:271",
                          "deeplearning4j_tpu_torch/ops/kernels/csrc/flash_attn_bwd.cu"),
    "flash_attn_bwd_dkv": ("deeplearning4j_tpu/ops/attention_kernels.py:322",
                           "deeplearning4j_tpu_torch/ops/kernels/csrc/flash_attn_bwd.cu"),
}
LN_BWD_KERNEL = ("deeplearning4j_tpu/ops/norm_kernels.py:55",
                 "deeplearning4j_tpu_torch/ops/kernels/csrc/layer_norm_bwd.cu")
BERT_BASE_PARAMS = 110_106_428
#: attention at bench.py's two BERT shapes, (B, H, T, D), and the parity
#: shapes: those two and two ragged ones, (B, H, T, S, D)
BERT_ATTN_SHAPES = {"t128": (64, 12, 128, 64), "t2048": (4, 12, 2048, 64)}
ATTN_PARITY_SHAPES = [(64, 12, 128, 128, 64), (4, 12, 2048, 2048, 64),
                      (2, 3, 77, 77, 64), (1, 2, 37, 200, 64), (2, 2, 130, 100, 128)]
#: LayerNorm backward parity: (x dtype, gain dtype); the kernel takes each
LN_BWD_DTYPES = [(torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
                 (torch.bfloat16, torch.float32), (torch.float32, torch.bfloat16)]
#: bound on bf16-compute BERT outputs against reference mode, relative to
#: max|ref|: reference mode runs the scores, the softmax and the LayerNorm
#: statistics in bf16 (as the JAX package does off the TPU) where the
#: kernels keep them in f32, and 12 blocks carry the difference on
BERT_BF16_RTOL = 5e-2
#: bound on a bf16-compute training loss against reference mode, relative:
#: the same reason as BERT_BF16_RTOL, but a loss is a mean over the ~1,200
#: masked tokens of a batch, which averages the logits' differences.  On an
#: H100 the three steps differed by 4.7e-5, 4.1e-5 and 2.6e-4; 1e-3 is
#: about 4x the largest
BERT_BF16_LOSS_RTOL = 1e-3
#: bound on a bf16-compute gradient at the initial parameters against
#: reference mode's, per tensor, relative to the tensor's max|ref| (and, for
#: layers.bk, its noise beside layers.bq's max): the same reason as
#: BERT_BF16_RTOL.  On an H100 the worst tensor (layers.Wk) differed by
#: 4.0e-2 of its max and layers.bk's noise was 2.5e-2 of layers.bq's max;
#: 0.12 is 3x the worst.  A backward kernel that drops or garbles its
#: output moves some tensor by ~1 of its max
BERT_BF16_GRAD_RTOL = 0.12
#: bound on the first Adam update's difference from reference mode's,
#: relative to the update's size in the L2 norm over all parameters; not
#: element by element: at step 1 Adam moves each element by lr * g /
#: (|g| + eps / sqrt(1 - beta2)), whose slope near g = 0 is lr / 3.2e-7, so
#: an element whose gradient sums cancel to nearly zero turns their
#: rounding (another summation order in the kernels) into a step of up to
#: lr.  On the CPU, the JAX package and the port, whose losses agreed to
#: 1e-7, differed by up to 2.9e-3 of the update in such elements (under
#: 0.1% of them) and by 6e-6 in the L2 norm
UPDATE_L2_RTOL = 1e-4
#: per MLM step at BERT-base: flash forward, dQ, dK/dV, LayerNorm forward,
#: LayerNorm backward launches (12 blocks; 1 + 2 * 12 + 1 LayerNorms)
BERT_STEP_LAUNCHES = (12, 12, 12, 26, 26)
BERT_TRAIN_VOCAB = 30522
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
    x = torch.randn(16, 224, 224, 3, device=dev)
    model.output(x)
    window_ms, busy_ms, by_name, n = _trace(lambda: model.output(x))
    if busy_ms is None:
        emit("profile", bucket=16, window_ms=window_ms,
             device_busy_ms="not measured", idle_share="not measured")
        return
    emit("profile", bucket=16, window_ms=window_ms, device_busy_ms=busy_ms,
         idle_share=max(0.0, 1.0 - busy_ms / window_ms), kernels=n,
         fused_dense_ms=_share(by_name, "fused_dense_kernel"),
         top=_top(by_name, 12))


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
    def step():
        net.fit(x, y)
        net.score()

    window_ms, busy_ms, by_name, n = _trace(step)
    if busy_ms is None:
        emit("train_profile", window_ms=window_ms,
             device_busy_ms="not measured", idle_share="not measured")
        return
    wgrad_ms = _share(by_name, "conv3x3_wgrad")
    dgrad_ms = _share(by_name, "conv3x3_dgrad")
    emit("train_profile", window_ms=window_ms, device_busy_ms=busy_ms,
         idle_share=max(0.0, 1.0 - busy_ms / window_ms), kernels=n,
         conv3x3_wgrad_ms=wgrad_ms, conv3x3_dgrad_ms=dgrad_ms,
         conv3x3_share_of_busy=(wgrad_ms + dgrad_ms) / busy_ms,
         top=_top(by_name, 15))


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


def phase_ln_parity(nk, layer_norm, dev):
    gen = torch.Generator(device=dev).manual_seed(2)
    cases = 0
    for lead in ((64, 128), (4, 2048), (37,), (1,)):
        for F in (768, 1000, 64):
            for dt in (torch.float32, torch.bfloat16):
                x = (torch.randn(*lead, F, generator=gen, device=dev) * 2 + 0.5).to(dt)
                g = torch.randn(F, generator=gen, device=dev).to(dt)
                b = torch.randn(F, generator=gen, device=dev).to(dt)
                errs = {}
                for eps in (1e-12, 1e-5):
                    before = layer_norm.LAUNCHES.value
                    got = nk.layer_norm_fwd(x, g, b, eps)
                    torch.cuda.synchronize()
                    require(layer_norm.LAUNCHES.value == before + 1,
                            "layer_norm_fwd did not launch its kernel")
                    want = nk.layer_norm_plain(x, g, b, eps)
                    require(got[0].dtype == dt and got[0].shape == x.shape,
                            f"layer_norm_fwd output {got[0].dtype} {tuple(got[0].shape)}")
                    errs[eps] = {}
                    for name, a, r, d in zip(("y", "mean", "rstd"), got, want,
                                             (dt, torch.float32, torch.float32)):
                        err = (a.float() - r.float()).abs().max().item()
                        rmax = r.float().abs().max().item()
                        require(err <= tolerance(d, rmax),
                                f"layer_norm_fwd {list(x.shape)} {dt} eps={eps} {name}: "
                                f"max|diff| {err} > tol {tolerance(d, rmax)}")
                        errs[eps][name] = err / max(rmax, 1e-30)
                    cases += 1
                emit("ln_parity", shape=list(x.shape), dtype=str(dt), rel_errors=errs)
    emit("ln_parity_done", cases=cases, ok=True)


def _keep_mask(B, S, dt, dev, drop=28):
    """[B, S] keep-mask dropping the last `drop` positions of half the rows."""
    m = torch.ones(B, S, dtype=dt, device=dev)
    m[: (B + 1) // 2, S - drop:] = 0
    return m


def phase_attn_parity(ak, attention, dev):
    gen = torch.Generator(device=dev).manual_seed(3)
    cases = 0
    for B, H, T, S, D in ATTN_PARITY_SHAPES:
        for dt in (torch.float32, torch.bfloat16):
            q = torch.randn(B, H, T, D, generator=gen, device=dev).to(dt)
            k = torch.randn(B, H, S, D, generator=gen, device=dev).to(dt)
            v = torch.randn(B, H, S, D, generator=gen, device=dev).to(dt)
            errs = {}
            for causal in (False, True):
                for mask in (None, _keep_mask(B, S, dt, dev)):
                    before = attention.LAUNCHES.value
                    out, lse = attention.flash_attention(q, k, v, mask, causal)
                    torch.cuda.synchronize()
                    require(attention.LAUNCHES.value == before + 1,
                            "flash_attention did not launch its kernel")
                    ro, rl = ak.flash_attention_plain(q, k, v, mask, causal)
                    require(out.dtype == dt and out.shape == q.shape
                            and lse.shape == (B * H, T) and torch.isfinite(out).all().item(),
                            f"flash_attention output {out.dtype} {tuple(out.shape)}")
                    case = f"causal={causal},mask={mask is not None}"
                    errs[case] = {}
                    for name, a, r, d in (("out", out, ro, dt), ("lse", lse, rl, torch.float32)):
                        err = (a.float() - r.float()).abs().max().item()
                        rmax = r.float().abs().max().item()
                        require(err <= tolerance(d, rmax),
                                f"flash_attention {[B, H, T, D]} S={S} {dt} {case} {name}: "
                                f"max|diff| {err} > tol {tolerance(d, rmax)}")
                        errs[case][name] = err / max(rmax, 1e-30)
                    cases += 1
            emit("attn_parity", shape=[B, H, T, D], S=S, dtype=str(dt), rel_errors=errs)
    emit("attn_parity_done", cases=cases, ok=True)


def _bert_inputs(batch, t, dev, padded):
    """ids as bench.py makes them; an all-ones mask, or one where row b
    keeps its first lengths[b] >= t/8 tokens."""
    ids = np.random.RandomState(0).randint(0, 30522, (batch, t)).astype(np.int32)
    mask = np.ones((batch, t), np.float32)
    if padded:
        lengths = np.random.RandomState(1).randint(t // 8, t + 1, batch)
        mask[np.arange(t)[None, :] >= lengths[:, None]] = 0.0
    return torch.as_tensor(ids, device=dev), torch.as_tensor(mask, device=dev)


def _forward_ms(fn, n=5):
    """Host clock around a forward ending in a synchronize; median of n
    after one warmup."""
    fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        ts.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(ts)


def _bert_run(model, dispatch, attention, layer_norm, batch, t, dev, rtol, tag):
    """The main path of the inference slice on one model: each head in
    ``auto`` mode with the launch counts set to 0 just before and read
    just after, the heads in ``reference`` mode, their agreement, forward
    times in both modes and peak memory."""
    L = model.config.n_layers
    want = {"output_hidden": (L, 1 + 2 * L), "output_mlm": (L, 2 + 2 * L),
            "output_cls": (L, 1 + 2 * L)}
    res = {"launches": {}, "rel_diff_vs_reference": {}}
    for padded in (False, True):
        ids, mask = _bert_inputs(batch, t, dev, padded)
        outs = {}
        for head, counts in want.items():
            attention.LAUNCHES.reset()
            layer_norm.LAUNCHES.reset()
            outs[head] = getattr(model, head)(ids, mask)
            torch.cuda.synchronize()
            got = (attention.LAUNCHES.value, layer_norm.LAUNCHES.value)
            require(got == counts, f"{tag} {head}: (flash, layer_norm) launches {got} != {counts}")
            require(torch.isfinite(outs[head]).all().item(), f"{tag} {head}: non-finite output")
            res["launches"][head] = got
        prev = dispatch.set_dispatch_mode("reference")
        try:
            refs = {h: getattr(model, h)(ids, mask) for h in ("output_mlm", "output_cls")}
        finally:
            dispatch.set_dispatch_mode(prev)
        for head, r in refs.items():
            key = head + ("_padded" if padded else "")
            err = (outs[head] - r).abs().max().item()
            rmax = r.abs().max().item()
            res["rel_diff_vs_reference"][key] = err / rmax
            require(err <= rtol * rmax, f"{tag} {key}: max|diff| {err} > {rtol} * {rmax}")
        del outs, refs
    ids, mask = _bert_inputs(batch, t, dev, False)
    torch.cuda.reset_peak_memory_stats()
    res["mlm_ms"] = _forward_ms(lambda: model.output_mlm(ids, mask))
    res["max_memory_allocated_gb"] = torch.cuda.max_memory_allocated() / 1e9
    res["hidden_ms"] = _forward_ms(lambda: model.output_hidden(ids, mask))
    prev = dispatch.set_dispatch_mode("reference")
    try:
        res["reference_mlm_ms"] = _forward_ms(lambda: model.output_mlm(ids, mask))
        res["reference_hidden_ms"] = _forward_ms(lambda: model.output_hidden(ids, mask))
    finally:
        dispatch.set_dispatch_mode(prev)
    res["mlm_tokens_per_sec"] = batch * t * 1e3 / res["mlm_ms"]
    res["reference_mlm_tokens_per_sec"] = batch * t * 1e3 / res["reference_mlm_ms"]
    return res


def phase_bert(BertModel, BertConfig, dispatch, attention, layer_norm, dev,
               phase="bert", batch=64, t=128, max_len=512):
    """f32 then bf16 compute; returns the f32 output_mlm launch counts and
    the bf16 model."""
    model = BertModel(BertConfig.base(max_len=max_len), device=dev,
                      generator=torch.Generator(device=dev).manual_seed(0))
    n_params = model.num_params()
    if max_len == 512:
        require(n_params == BERT_BASE_PARAMS,
                f"BERT-base has {n_params} parameters, want {BERT_BASE_PARAMS}")
    f32 = _bert_run(model, dispatch, attention, layer_norm, batch, t, dev,
                    F32_RTOL, f"{phase} f32")
    emit(phase, model="BERT-base", params=n_params, batch=batch, T=t,
         compute_dtype="float32", **f32)
    bf = BertModel(BertConfig.base(max_len=max_len, compute_dtype="bfloat16"), device=dev)
    bf.load_state_dict(model.state_dict())
    del model
    bf16 = _bert_run(bf, dispatch, attention, layer_norm, batch, t, dev,
                     BERT_BF16_RTOL, f"{phase} bf16")
    emit(phase, model="BERT-base", params=n_params, batch=batch, T=t,
         compute_dtype="bfloat16", bound_rel=BERT_BF16_RTOL, **bf16)
    return f32["launches"]["output_mlm"], bf


def _trace(fn):
    """fn once under torch.profiler: (window ms on the host clock, device
    busy ms as the union of kernel intervals or None if the profiler saw
    no device activity, {kernel name: (ms, launches)}, kernel launches)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        window_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not kernels:
        return window_ms, None, {}, 0
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
    return window_ms, busy_us / 1e3, by_name, len(kernels)


def _top(by_name, n):
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:n]
    return [{"name": name[:100], "count": c, "ms": ms} for name, (ms, c) in top]


def _share(by_name, tag):
    return sum(ms for name, (ms, _) in by_name.items() if tag in name)


def phase_bert_profile(model, dev):
    """One T = 128 bf16 output_mlm: device busy time, idle share, the top
    kernels and the two kernels' share of busy time."""
    ids, mask = _bert_inputs(64, 128, dev, False)
    model.output_mlm(ids, mask)
    window_ms, busy_ms, by_name, n = _trace(lambda: model.output_mlm(ids, mask))
    if busy_ms is None:
        emit("bert_profile", window_ms=window_ms, device_busy_ms="not measured",
             idle_share="not measured")
        return
    flash_ms = _share(by_name, "flash_attn_fwd_kernel")
    ln_ms = _share(by_name, "layer_norm_fwd_kernel")
    emit("bert_profile", batch=64, T=128, compute_dtype="bfloat16", window_ms=window_ms,
         device_busy_ms=busy_ms, idle_share=max(0.0, 1.0 - busy_ms / window_ms),
         kernels=n, flash_attn_fwd_ms=flash_ms, layer_norm_fwd_ms=ln_ms,
         flash_attn_fwd_share_of_busy=flash_ms / busy_ms,
         layer_norm_fwd_share_of_busy=ln_ms / busy_ms, top=_top(by_name, 15))


def attn_bound(B, H, T, S, D, dt):
    """Least time for one call: 4*B*H*T*S*D operations over the type's
    peak, or the bytes (q, k, v, the mask read once; out and lse written
    once) over 3.35 TB/s, whichever is larger."""
    es = torch.tensor([], dtype=dt).element_size()
    nbytes = (2 * T + 2 * S) * B * H * D * es + B * H * T * 4 + B * S * es
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = 4.0 * B * H * T * S * D / PEAK_OPS_PER_S[dt]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def ln_bound(rows, F, dt):
    """Least time for one call: the bytes (x read and y written once, gain
    and bias, mean and rstd) over 3.35 TB/s, or ~8 f32 operations an
    element over the f32 rate, whichever is larger."""
    es = torch.tensor([], dtype=dt).element_size()
    t_bytes = (2 * rows * F * es + 2 * F * es + 2 * rows * 4) / HBM_BYTES_PER_S
    t_ops = 8.0 * rows * F / PEAK_OPS_PER_S[torch.float32]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def phase_attn_times(ak, attention, dev):
    import torch.nn.functional as F

    rows = {}
    for name, (B, H, T, D) in BERT_ATTN_SHAPES.items():
        for dt in (torch.float32, torch.bfloat16):
            gen = torch.Generator(device=dev).manual_seed(4)
            q, k, v = (torch.randn(B, H, T, D, generator=gen, device=dev).to(dt)
                       for _ in range(3))
            mask = torch.ones(B, T, dtype=dt, device=dev)
            keep = mask[:, None, None, :] > 0
            fn = lambda: attention.flash_attention(q, k, v, mask)  # noqa: E731
            plain = lambda: ak.flash_attention_plain(q, k, v, mask)  # noqa: E731
            err = (fn()[0].float() - plain()[0].float()).abs().max().item()
            bound_ms, bound_by = attn_bound(B, H, T, T, D, dt)
            rows[(name, dt)] = dict(
                ms=time_ms(fn, dev), plain_ms=time_ms(plain, dev),
                library_ms=time_ms(lambda: F.scaled_dot_product_attention(
                    q, k, v, attn_mask=keep), dev),
                bound_ms=bound_ms, bound_by=bound_by, max_abs_err=err)
            emit("attn_times", shape=[B, H, T, D], dtype=str(dt), **rows[(name, dt)])
    return rows


def phase_ln_times(nk, dev, rows=8192, F=768):
    import torch.nn.functional as Fn

    out = {}
    for dt in (torch.float32, torch.bfloat16):
        gen = torch.Generator(device=dev).manual_seed(5)
        x = torch.randn(rows, F, generator=gen, device=dev).to(dt)
        g = torch.randn(F, generator=gen, device=dev).to(dt)
        b = torch.randn(F, generator=gen, device=dev).to(dt)
        fn = lambda: nk.layer_norm_fwd(x, g, b, 1e-12)  # noqa: E731
        plain = lambda: nk.layer_norm_plain(x, g, b, 1e-12)  # noqa: E731
        err = (fn()[0].float() - plain()[0].float()).abs().max().item()
        bound_ms, bound_by = ln_bound(rows, F, dt)
        out[dt] = dict(ms=time_ms(fn, dev), plain_ms=time_ms(plain, dev),
                       library_ms=time_ms(lambda: Fn.layer_norm(x, (F,), g, b, 1e-12), dev),
                       bound_ms=bound_ms, bound_by=bound_by, max_abs_err=err)
        emit("ln_times", shape=[rows, F], dtype=str(dt), **out[dt])
    return out


def phase_ln_bwd_parity(nk, layer_norm, dev):
    gen = torch.Generator(device=dev).manual_seed(6)
    cases = 0
    for lead in ((64, 128), (4, 2048), (37,), (1,)):
        for F in (768, 1000, 64, 4096):
            for dt, gdt in LN_BWD_DTYPES:
                x = (torch.randn(*lead, F, generator=gen, device=dev) * 2 + 0.5).to(dt)
                g = torch.randn(F, generator=gen, device=dev).to(gdt)
                _, mean, rstd = nk.layer_norm_fwd(x, g, None, 1e-12)
                dys = [torch.randn(*lead, F, generator=gen, device=dev).to(dt)]
                if lead == (37,):     # rows further apart than F
                    dys.append(torch.randn(37, F + 8, generator=gen, device=dev).to(dt)[:, :F])
                errs = {}
                for j, dy in enumerate(dys):
                    for bias_dtype in (gdt, None):
                        before = layer_norm.BWD_LAUNCHES.value
                        got = layer_norm.launch_bwd(x, g, mean, rstd, dy, bias_dtype)
                        torch.cuda.synchronize()
                        require(layer_norm.BWD_LAUNCHES.value == before + 1,
                                "layer_norm_bwd did not launch its kernel")
                        want = nk.layer_norm_bwd_plain(x, g, mean, rstd, dy, bias_dtype)
                        case = f"dy{j},bias={bias_dtype is not None}"
                        errs[case] = {}
                        for name, a, r in zip(("dx", "dgain", "dbias"), got, want):
                            if r is None:
                                require(a is None, "layer_norm_bwd: a dbias without a bias")
                                continue
                            require(a.dtype == r.dtype and a.shape == r.shape,
                                    f"layer_norm_bwd {name} {a.dtype} {tuple(a.shape)}")
                            err = (a.float() - r.float()).abs().max().item()
                            rmax = r.float().abs().max().item()
                            tol = tolerance(r.dtype, rmax)
                            require(err <= tol,
                                    f"layer_norm_bwd {list(x.shape)} {dt} gain {gdt} {case} "
                                    f"{name}: max|diff| {err} > tol {tol}")
                            errs[case][name] = err / max(rmax, 1e-30)
                        cases += 1
                emit("ln_bwd_parity", shape=list(x.shape), dtype=str(dt), gain_dtype=str(gdt),
                     rel_errors=errs)
                del x, dys
    emit("ln_bwd_parity_done", cases=cases, ok=True)


def _attn_bwd_case(ak, attention, q, k, v, g, mask, causal, dt, tag):
    """One backward call held to the plain version; {name: rel err}."""
    out, lse = attention.flash_attention(q, k, v, mask, causal)
    before = (attention.DQ_LAUNCHES.value, attention.DKV_LAUNCHES.value)
    got = attention.launch_bwd(q, k, v, out, lse, g, mask, causal)
    torch.cuda.synchronize()
    require((attention.DQ_LAUNCHES.value, attention.DKV_LAUNCHES.value)
            == (before[0] + 1, before[1] + 1),
            "launch_bwd did not launch the dQ and dK/dV kernels once each")
    want = ak.flash_attention_bwd_plain(q, k, v, out, lse, g, mask, causal)
    errs = {}
    for name, a, r, like in zip(("dq", "dk", "dv"), got, want, (q, k, v)):
        require(a.dtype == dt and a.shape == like.shape and torch.isfinite(a).all().item(),
                f"flash_attn_bwd {name} {a.dtype} {tuple(a.shape)}")
        err = (a.float() - r.float()).abs().max().item()
        rmax = r.float().abs().max().item()
        require(err <= tolerance(dt, rmax),
                f"flash_attn_bwd {tag} {name}: max|diff| {err} > tol {tolerance(dt, rmax)}")
        errs[name] = err / max(rmax, 1e-30)
    return errs


def phase_attn_bwd_parity(ak, attention, dev):
    gen = torch.Generator(device=dev).manual_seed(7)
    cases = 0
    for B, H, T, S, D in ATTN_PARITY_SHAPES:
        for dt in (torch.float32, torch.bfloat16):
            q = torch.randn(B, H, T, D, generator=gen, device=dev).to(dt)
            k = torch.randn(B, H, S, D, generator=gen, device=dev).to(dt)
            v = torch.randn(B, H, S, D, generator=gen, device=dev).to(dt)
            g = torch.randn(B, H, T, D, generator=gen, device=dev).to(dt)
            errs = {}
            for causal in (False, True):
                for mask in (None, _keep_mask(B, S, dt, dev)):
                    case = f"causal={causal},mask={mask is not None}"
                    errs[case] = _attn_bwd_case(ak, attention, q, k, v, g, mask, causal, dt,
                                                f"{[B, H, T, D]} S={S} {dt} {case}")
                    cases += 1
            emit("attn_bwd_parity", shape=[B, H, T, D], S=S, dtype=str(dt), rel_errors=errs)
            del q, k, v, g
    # BERT's layout: q, k, v split out of one [B, T, 3, H, D] tensor, dO a
    # head-split view of [B, T, H, D]
    B, T, H, D = 64, 128, 12, 64
    for dt in (torch.float32, torch.bfloat16):
        qkv = torch.randn(B, T, 3, H, D, generator=gen, device=dev).to(dt)
        q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
        g = torch.randn(B, T, H, D, generator=gen, device=dev).to(dt).transpose(1, 2)
        errs = _attn_bwd_case(ak, attention, q, k, v, g, _keep_mask(B, T, dt, dev), False,
                              dt, f"head-split {dt}")
        cases += 1
        emit("attn_bwd_parity", shape=[B, H, T, D], S=T, dtype=str(dt), layout="head-split",
             rel_errors=errs)
    emit("attn_bwd_parity_done", cases=cases, ok=True)


def _bert_train_batch(MultiDataSet, dev, batch=64, t=128):
    """bench.py's MLM batch: RandomState(0) ids, an all-ones mask, a
    ``rand < 0.15`` label mask, sparse labels = the ids; on the device."""
    rng = np.random.RandomState(0)
    ids = rng.randint(0, BERT_TRAIN_VOCAB, (batch, t)).astype(np.int32)
    mask = np.ones((batch, t), np.float32)
    lmask = (rng.rand(batch, t) < 0.15).astype(np.float32)
    ids, mask, lmask = (torch.as_tensor(a, device=dev) for a in (ids, mask, lmask))
    return MultiDataSet(features=[ids, mask], labels=[ids], labels_masks=[lmask])


def _train_counters(attention, layer_norm):
    return (attention.LAUNCHES, attention.DQ_LAUNCHES, attention.DKV_LAUNCHES,
            layer_norm.LAUNCHES, layer_norm.BWD_LAUNCHES)


def _train_steps(model, step, counters, steps):
    """`steps` calls of step(), each with the launch counts set to 0 just
    before and read just after: (losses, host ms per step, counts per step)."""
    losses, ms, counts = [], [], []
    for _ in range(steps):
        for c in counters:
            c.reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = step()
        losses.append(out.tolist() if out.ndim else float(out))   # synchronizes
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        counts.append(tuple(int(c.value) for c in counters))
    return losses, ms, counts


def _named_leaves(tree, path=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _named_leaves(tree[k], f"{path}.{k}" if path else k)
    else:
        yield path, tree


def _bert_train_model(BertModel, BertConfig, Adam, dev, **cfg):
    return BertModel(BertConfig.base(**cfg), updater=Adam(1e-4), device=dev,
                     generator=torch.Generator(device=dev).manual_seed(0))


def _flat(model):
    return torch.cat([p.detach().flatten() for p in model.parameters()])


def _grad_diffs(model, ref, mds, dispatch):
    """`gradient_for` of one batch in ``auto`` mode on `model` and in
    ``reference`` mode on `ref` (the same parameters): (worst per-tensor
    max|diff| / max|ref|, that per tensor, max|bk grad| / max|bq grad| in
    each mode).  ``layers.bk``'s gradient is zero in exact arithmetic, so
    it is held to be noise beside ``layers.bq``'s instead, and its
    difference is over ``layers.bq``'s max."""
    g_auto = dict(_named_leaves(model.gradient_for(mds)))
    prev = dispatch.set_dispatch_mode("reference")
    try:
        g_ref = dict(_named_leaves(ref.gradient_for(mds)))
    finally:
        dispatch.set_dispatch_mode(prev)
    bq_max = {mode: g["layers.bq"].abs().max().item()
              for mode, g in (("auto", g_auto), ("reference", g_ref))}
    bk_noise = {mode: g["layers.bk"].abs().max().item() / bq_max[mode]
                for mode, g in (("auto", g_auto), ("reference", g_ref))}
    rel = {}
    for name, r in g_ref.items():
        rmax = bq_max["reference"] if name == "layers.bk" else r.abs().max().item()
        rel[name] = (g_auto[name] - r).abs().max().item() / max(rmax, 1e-30)
    worst = max(v for name, v in rel.items() if name != "layers.bk")
    return worst, rel, bk_noise


def _require_grads(worst, rel, bk_noise, rtol, tag):
    require(worst <= rtol, f"{tag} gradient_for against reference mode: "
            f"{ {n: v for n, v in rel.items() if v > rtol} } > {rtol} of max|ref|")
    require(max(bk_noise.values()) <= rtol,
            f"{tag} layers.bk gradient is not noise beside layers.bq's: {bk_noise}")


def phase_bert_train(BertModel, BertConfig, Adam, MultiDataSet, dispatch, attention,
                     layer_norm, dev, steps=3, batch=64, t=128):
    """The f32 then the bf16 training runs; returns the f32 step's launch
    counts."""
    counters = _train_counters(attention, layer_norm)
    mds = _bert_train_batch(MultiDataSet, dev, batch, t)
    tokens = batch * t
    model = _bert_train_model(BertModel, BertConfig, Adam, dev)
    ref = _bert_train_model(BertModel, BertConfig, Adam, dev)
    ref.load_state_dict(model.state_dict())
    n_params = model.num_params()
    require(n_params == BERT_BASE_PARAMS,
            f"BERT-base has {n_params} parameters, want {BERT_BASE_PARAMS}")

    # the gradient at the initial parameters, kernels against plain
    worst_grad, grad_rel, bk_noise = _grad_diffs(model, ref, mds, dispatch)
    emit("bert_train_grad", compute_dtype="float32", bound_rel=F32_RTOL,
         max_rel_grad_diff=worst_grad, bk_noise_rel_bq=bk_noise, rel_grad_diff=grad_rel)
    _require_grads(worst_grad, grad_rel, bk_noise, F32_RTOL, "f32")

    # the main path: fit_batch in auto mode, then in reference mode
    theta0 = _flat(model)
    torch.cuda.reset_peak_memory_stats()
    losses, ms, counts = _train_steps(model, lambda: model.fit_batch(mds), counters, 1)
    theta1 = _flat(model)
    more = _train_steps(model, lambda: model.fit_batch(mds), counters, steps - 1)
    losses, ms, counts = losses + more[0], ms + more[1], counts + more[2]
    peak = torch.cuda.max_memory_allocated()
    prev = dispatch.set_dispatch_mode("reference")
    try:
        r_losses, r_ms, r_counts = _train_steps(ref, lambda: ref.fit_batch(mds), counters, 1)
        r_theta1 = _flat(ref)
        more = _train_steps(ref, lambda: ref.fit_batch(mds), counters, steps - 1)
        r_losses, r_ms, r_counts = r_losses + more[0], r_ms + more[1], r_counts + more[2]
    finally:
        dispatch.set_dispatch_mode(prev)
    upd = (r_theta1 - theta0).double()
    diff = (theta1 - r_theta1).double()
    update_l2 = (diff.norm() / upd.norm()).item()
    update_max = (diff.abs().max() / upd.abs().max()).item()
    del theta0, theta1, r_theta1, upd, diff, model, ref
    rel = [abs(a - r) / abs(r) for a, r in zip(losses, r_losses)]
    step_ms = statistics.median(ms[1:])
    emit("bert_train", model="BERT-base", params=n_params, batch=batch, T=t,
         compute_dtype="float32", updater="Adam(1e-4)", steps=steps, losses=losses,
         reference_losses=r_losses, rel_loss_diff=rel,
         step1_update_rel_diff_l2=update_l2, step1_update_rel_diff_max=update_max,
         launches_per_step=counts, reference_launches_per_step=r_counts,
         step_ms=step_ms, step_ms_all=ms, reference_step_ms=statistics.median(r_ms[1:]),
         reference_step_ms_all=r_ms, tokens_per_sec=tokens * 1e3 / step_ms,
         reference_tokens_per_sec=tokens * 1e3 / statistics.median(r_ms[1:]),
         max_memory_allocated_gb=peak / 1e9)
    require(all(c == BERT_STEP_LAUNCHES for c in counts),
            f"launches per step {counts} != {BERT_STEP_LAUNCHES}")
    require(all(c == (0,) * 5 for c in r_counts), f"reference mode launched {r_counts}")
    require(all(math.isfinite(v) for v in losses + r_losses), "non-finite loss")
    require(max(rel) <= F32_RTOL, f"f32 losses {losses} vs reference {r_losses}")
    require(update_l2 <= UPDATE_L2_RTOL,
            f"first update differs from reference mode's by {update_l2} of its L2 norm")

    # bf16 compute: auto against reference mode, then fit_steps against
    # fit_batch from the same start
    bf = _bert_train_model(BertModel, BertConfig, Adam, dev, compute_dtype="bfloat16")
    start = {k: v.clone() for k, v in bf.state_dict().items()}
    b_worst, b_grad_rel, b_bk_noise = _grad_diffs(bf, bf, mds, dispatch)
    emit("bert_train_grad", compute_dtype="bfloat16", bound_rel=BERT_BF16_GRAD_RTOL,
         max_rel_grad_diff=b_worst, bk_noise_rel_bq=b_bk_noise, rel_grad_diff=b_grad_rel)
    _require_grads(b_worst, b_grad_rel, b_bk_noise, BERT_BF16_GRAD_RTOL, "bf16")
    torch.cuda.reset_peak_memory_stats()
    b_losses, b_ms, b_counts = _train_steps(bf, lambda: bf.fit_batch(mds), counters, steps)
    b_peak = torch.cuda.max_memory_allocated()
    require(all(c == BERT_STEP_LAUNCHES for c in b_counts),
            f"bf16 launches per step {b_counts} != {BERT_STEP_LAUNCHES}")
    require(bf.layers.Wq.dtype == torch.float32, "bf16 compute must keep f32 master parameters")

    def restart():
        bf.load_state_dict(start)
        bf.opt_state_, bf.iteration = bf.updater.init_state(bf.params_), 0

    restart()
    prev = dispatch.set_dispatch_mode("reference")
    try:
        rb_losses, rb_ms, _ = _train_steps(bf, lambda: bf.fit_batch(mds), counters, steps)
    finally:
        dispatch.set_dispatch_mode(prev)
    b_rel = [abs(a - r) / abs(r) for a, r in zip(b_losses, rb_losses)]
    require(all(math.isfinite(v) for v in b_losses + rb_losses), f"bf16 losses {b_losses}")
    require(max(b_rel) <= BERT_BF16_LOSS_RTOL,
            f"bf16 losses {b_losses} vs reference {rb_losses} (bound {BERT_BF16_LOSS_RTOL})")

    k = 5
    stacked = MultiDataSet(
        features=[f.broadcast_to((k,) + tuple(f.shape)) for f in mds.features],
        labels=[l.broadcast_to((k,) + tuple(l.shape)) for l in mds.labels],
        labels_masks=[m.broadcast_to((k,) + tuple(m.shape)) for m in mds.labels_masks])
    restart()
    seq_losses, seq_ms, _ = _train_steps(bf, lambda: bf.fit_batch(mds), counters, k)
    restart()
    (fs_losses,), fs_ms, fs_counts = _train_steps(bf, lambda: bf.fit_steps(stacked), counters, 1)
    fs_rel = max(abs(a - r) / abs(r) for a, r in zip(fs_losses, seq_losses))
    require(fs_counts[0] == tuple(k * n for n in BERT_STEP_LAUNCHES),
            f"fit_steps launches {fs_counts[0]} != {k} x {BERT_STEP_LAUNCHES}")
    require(bf.iteration == k, f"fit_steps advanced iteration to {bf.iteration}")
    require(fs_rel <= 1e-6, f"fit_steps losses {fs_losses} vs fit_batch {seq_losses}")
    b_step_ms = statistics.median(b_ms[1:])
    emit("bert_train", model="BERT-base", params=n_params, batch=batch, T=t,
         compute_dtype="bfloat16", updater="Adam(1e-4)", steps=steps, losses=b_losses,
         reference_losses=rb_losses, rel_loss_diff=b_rel, bound_rel=BERT_BF16_LOSS_RTOL,
         launches_per_step=b_counts, step_ms=b_step_ms, step_ms_all=b_ms,
         reference_step_ms=statistics.median(rb_ms[1:]), reference_step_ms_all=rb_ms,
         tokens_per_sec=tokens * 1e3 / b_step_ms,
         reference_tokens_per_sec=tokens * 1e3 / statistics.median(rb_ms[1:]),
         max_memory_allocated_gb=b_peak / 1e9,
         fit_steps_k=k, fit_steps_losses=fs_losses, fit_batch_losses=seq_losses,
         fit_steps_max_rel_loss_diff=fs_rel, fit_steps_launches=fs_counts[0],
         fit_steps_ms=fs_ms[0], fit_batch_ms_sum=sum(seq_ms),
         fit_steps_tokens_per_sec=k * tokens * 1e3 / fs_ms[0])
    return counts[0], bf, mds


def phase_bert_train_iter(BertModel, BertConfig, Adam, BertIterator, BertWordPieceTokenizer,
                          attention, layer_norm, dev, batch=64, t=128, n_batches=2):
    vocab = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"] + [
        f"w{i}" for i in range(5, BERT_TRAIN_VOCAB)]
    rng = np.random.RandomState(8)
    sentences = [" ".join(f"w{w}" for w in rng.randint(5, BERT_TRAIN_VOCAB, rng.randint(64, 200)))
                 for _ in range(batch * n_batches)]
    it = BertIterator(BertWordPieceTokenizer(vocab), sentences, batch_size=batch, max_length=t,
                      seed=0, sparse_labels=True)
    model = _bert_train_model(BertModel, BertConfig, Adam, dev)
    counters = _train_counters(attention, layer_norm)
    for c in counters:
        c.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model.fit(it)
    loss = model.score()
    seconds = time.perf_counter() - t0
    counts = tuple(int(c.value) for c in counters)
    require(math.isfinite(loss), f"fit(BertIterator) loss {loss}")
    require((model.iteration, model.epoch) == (n_batches, 1),
            f"fit(BertIterator) iteration {model.iteration}, epoch {model.epoch}")
    require(counts == tuple(n_batches * n for n in BERT_STEP_LAUNCHES),
            f"fit(BertIterator) launches {counts}")
    emit("bert_train_iter", model="BERT-base", vocab=len(vocab), batch=batch, T=t,
         batches=n_batches, loss=loss, iteration=model.iteration, launches=counts,
         seconds=seconds)


def phase_bert_train_long(BertModel, BertConfig, Adam, MultiDataSet, attention, layer_norm,
                          dev, batch=4, t=2048, steps=2):
    model = _bert_train_model(BertModel, BertConfig, Adam, dev, max_len=t,
                              compute_dtype="bfloat16")
    mds = _bert_train_batch(MultiDataSet, dev, batch, t)
    torch.cuda.reset_peak_memory_stats()
    losses, ms, counts = _train_steps(model, lambda: model.fit_batch(mds),
                                      _train_counters(attention, layer_norm), steps)
    require(all(math.isfinite(v) for v in losses), f"long bf16 losses {losses}")
    require(all(c == BERT_STEP_LAUNCHES for c in counts),
            f"long launches per step {counts} != {BERT_STEP_LAUNCHES}")
    emit("bert_train_long", model="BERT-base", batch=batch, T=t, compute_dtype="bfloat16",
         losses=losses, launches_per_step=counts, step_ms=ms[-1], step_ms_all=ms,
         tokens_per_sec=batch * t * 1e3 / ms[-1],
         max_memory_allocated_gb=torch.cuda.max_memory_allocated() / 1e9)


def phase_bert_train_profile(model, mds):
    """One bf16 T = 128 fit_batch under torch.profiler: device busy time,
    idle share, the top kernels and each new kernel's share of busy time."""
    def step():
        model.fit_batch(mds)
        model.score()

    step()
    window_ms, busy_ms, by_name, n = _trace(step)
    if busy_ms is None:
        emit("bert_train_profile", window_ms=window_ms, device_busy_ms="not measured",
             idle_share="not measured")
        return
    shares = {name: _share(by_name, tag) for name, tag in (
        ("flash_attn_fwd", "flash_attn_fwd_kernel"),
        ("flash_attn_bwd_dq", "flash_attn_bwd_dq_kernel"),
        ("flash_attn_bwd_dkv", "flash_attn_bwd_dkv_kernel"),
        ("layer_norm_fwd", "layer_norm_fwd_kernel"),
        ("layer_norm_bwd", "layer_norm_bwd_kernel"),
        ("layer_norm_bwd_column_sum", "column_sum_kernel"))}
    emit("bert_train_profile", batch=64, T=128, compute_dtype="bfloat16",
         window_ms=window_ms, device_busy_ms=busy_ms,
         idle_share=max(0.0, 1.0 - busy_ms / window_ms), kernels=n,
         kernel_ms=shares, kernel_share_of_busy={k: v / busy_ms for k, v in shares.items()},
         top=_top(by_name, 20))


def attn_bwd_bound(B, H, T, S, D, dt, kernel):
    """Least time for one kernel: 2*B*H*T*S*D operations per product (3 in
    dQ, 4 in dK/dV) over the type's peak, or its bytes over 3.35 TB/s (dQ
    reads q, k, v, out, dO, lse and writes dq and delta; dK/dV reads q, k,
    v, dO, lse, delta, the mask and writes dk, dv), whichever is larger."""
    es = torch.tensor([], dtype=dt).element_size()
    qt, kv, stats = B * H * T * D * es, B * H * S * D * es, B * H * T * 4
    if kernel == "flash_attn_bwd_dq":
        products, nbytes = 3, 4 * qt + 2 * kv + 2 * stats + B * S * es
    else:
        products, nbytes = 4, 2 * qt + 4 * kv + 2 * stats + B * S * es
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = products * 2.0 * B * H * T * S * D / PEAK_OPS_PER_S[dt]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def ln_bwd_bound(rows, F, dt):
    """Least time for one call: the bytes (x and dy read, dx written, mean
    and rstd, gain read, dgain and dbias written) over 3.35 TB/s, or ~10
    f32 operations an element over the f32 rate, whichever is larger."""
    es = torch.tensor([], dtype=dt).element_size()
    t_bytes = (3 * rows * F * es + 3 * F * es + 2 * rows * 4) / HBM_BYTES_PER_S
    t_ops = 10.0 * rows * F / PEAK_OPS_PER_S[torch.float32]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def phase_attn_bwd_times(ak, attention, dev):
    import torch.nn.functional as F

    rows = {}
    for name, (B, H, T, D) in BERT_ATTN_SHAPES.items():
        for dt in (torch.float32, torch.bfloat16):
            gen = torch.Generator(device=dev).manual_seed(9)
            q, k, v, g = (torch.randn(B, H, T, D, generator=gen, device=dev).to(dt)
                          for _ in range(4))
            mask = torch.ones(B, T, dtype=dt, device=dev)
            keep = mask[:, None, None, :] > 0
            out, lse = attention.flash_attention(q, k, v, mask)
            args = attention._BwdArgs(q, k, v, out, lse, g, mask, False, None)
            attention.launch_bwd_dq(args)
            attention.launch_bwd_dkv(args)
            want = ak.flash_attention_bwd_plain(q, k, v, out, lse, g, mask)
            errs = [(a.float() - w.float()).abs().max().item()
                    for a, w in zip((args.dq, args.dk, args.dv), want)]
            del want
            plain = time_ms(lambda: ak.flash_attention_bwd_plain(q, k, v, out, lse, g, mask), dev)
            ql, kl, vl = (t.detach().requires_grad_() for t in (q, k, v))
            lo = F.scaled_dot_product_attention(ql, kl, vl, attn_mask=keep)
            lib = time_ms(lambda: torch.autograd.grad(lo, (ql, kl, vl), g, retain_graph=True),
                          dev)
            del lo
            for kernel, fn, err in (
                    ("flash_attn_bwd_dq", lambda: attention.launch_bwd_dq(args), errs[0]),
                    ("flash_attn_bwd_dkv", lambda: attention.launch_bwd_dkv(args),
                     max(errs[1:]))):
                bound_ms, bound_by = attn_bwd_bound(B, H, T, T, D, dt, kernel)
                rows[(kernel, name, dt)] = dict(
                    ms=time_ms(fn, dev), plain_ms=plain, library_ms=lib, bound_ms=bound_ms,
                    bound_by=bound_by, max_abs_err=err)
                emit("attn_bwd_times", kernel=kernel, shape=[B, H, T, D], dtype=str(dt),
                     **rows[(kernel, name, dt)])
    return rows


def phase_ln_bwd_times(nk, layer_norm, dev, rows=8192, F=768):
    import torch.nn.functional as Fn

    out = {}
    for dt in (torch.float32, torch.bfloat16):
        gen = torch.Generator(device=dev).manual_seed(10)
        x, dy = (torch.randn(rows, F, generator=gen, device=dev).to(dt) for _ in range(2))
        g, b = (torch.randn(F, generator=gen, device=dev).to(dt) for _ in range(2))
        _, mean, rstd = nk.layer_norm_fwd(x, g, b, 1e-12)
        fn = lambda: layer_norm.launch_bwd(x, g, mean, rstd, dy, dt)  # noqa: E731
        plain = lambda: nk.layer_norm_bwd_plain(x, g, mean, rstd, dy, dt)  # noqa: E731
        err = max((a.float() - w.float()).abs().max().item() for a, w in zip(fn(), plain()))
        xl, gl, bl = (t.detach().requires_grad_() for t in (x, g, b))
        y = Fn.layer_norm(xl, (F,), gl, bl, 1e-12)
        bound_ms, bound_by = ln_bwd_bound(rows, F, dt)
        out[dt] = dict(ms=time_ms(fn, dev), plain_ms=time_ms(plain, dev),
                       library_ms=time_ms(lambda: torch.autograd.grad(
                           y, (xl, gl, bl), dy, retain_graph=True), dev),
                       bound_ms=bound_ms, bound_by=bound_by, max_abs_err=err)
        emit("ln_bwd_times", shape=[rows, F], dtype=str(dt), **out[dt])
    return out


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from deeplearning4j_tpu_torch.ops import attention_kernels as ak
    from deeplearning4j_tpu_torch.ops import conv_kernels as ck
    from deeplearning4j_tpu_torch.ops import norm_kernels as nk
    from deeplearning4j_tpu_torch.ops.kernels import (attention, build, conv3x3, dispatch,
                                                      layer_norm, matmul)
    from deeplearning4j_tpu_torch.data import MultiDataSet
    from deeplearning4j_tpu_torch.nlp import BertIterator, BertWordPieceTokenizer
    from deeplearning4j_tpu_torch.serving import ModelServer
    from deeplearning4j_tpu_torch.train import Adam, Nesterovs
    from deeplearning4j_tpu_torch.zoo import BertConfig, BertModel, ResNet50

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
    phase_ln_parity(nk, layer_norm, dev)
    phase_attn_parity(ak, attention, dev)
    bert_launches, bert_bf16 = phase_bert(BertModel, BertConfig, dispatch,
                                          attention, layer_norm, dev)
    phase_bert_profile(bert_bf16, dev)
    del bert_bf16
    phase_bert(BertModel, BertConfig, dispatch, attention, layer_norm, dev,
               phase="bert_long", batch=4, t=2048, max_len=2048)
    attn_rows = phase_attn_times(ak, attention, dev)
    ln_rows = phase_ln_times(nk, dev)
    phase_ln_bwd_parity(nk, layer_norm, dev)
    phase_attn_bwd_parity(ak, attention, dev)
    train_launches, bert_bf16, mds = phase_bert_train(
        BertModel, BertConfig, Adam, MultiDataSet, dispatch, attention, layer_norm, dev)
    phase_bert_train_profile(bert_bf16, mds)
    del bert_bf16, mds
    phase_bert_train_iter(BertModel, BertConfig, Adam, BertIterator, BertWordPieceTokenizer,
                          attention, layer_norm, dev)
    phase_bert_train_long(BertModel, BertConfig, Adam, MultiDataSet, attention, layer_norm, dev)
    attn_bwd_rows = phase_attn_bwd_times(ak, attention, dev)
    ln_bwd_rows = phase_ln_bwd_times(nk, layer_norm, dev)

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
    for name, (replaces, source), row, n_launched, shape in (
            ("flash_attn_fwd", ATTN_KERNEL, attn_rows[("t128", torch.float32)],
             bert_launches[0], "BERT-base q/k/v [64,12,128,64] f32"),
            ("layer_norm_fwd", LN_KERNEL, ln_rows[torch.float32], bert_launches[1],
             "BERT-base 8192 x 768 f32")):
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": n_launched, "max_abs_err": row["max_abs_err"], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
            "shape": shape + "; launches in one f32 output_mlm at batch 64, T 128"})
    for name, (replaces, source), row, n_launched, shape in (
            ("flash_attn_bwd_dq", ATTN_BWD_KERNELS["flash_attn_bwd_dq"],
             attn_bwd_rows[("flash_attn_bwd_dq", "t128", torch.float32)], train_launches[1],
             "BERT-base q/k/v/dO [64,12,128,64] f32"),
            ("flash_attn_bwd_dkv", ATTN_BWD_KERNELS["flash_attn_bwd_dkv"],
             attn_bwd_rows[("flash_attn_bwd_dkv", "t128", torch.float32)], train_launches[2],
             "BERT-base q/k/v/dO [64,12,128,64] f32"),
            ("layer_norm_bwd", LN_BWD_KERNEL, ln_bwd_rows[torch.float32], train_launches[4],
             "BERT-base 8192 x 768 f32")):
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": n_launched, "max_abs_err": row["max_abs_err"], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
            "shape": shape + "; launches in one f32 MLM fit_batch step at batch 64, T 128"
                     + ("; plain and library compute dq, dk and dv together"
                        if name.startswith("flash") else "")})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
