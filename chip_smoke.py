#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA Hopper card and hold its kernels to
their plain versions.

Run from the root of a checkout, on a machine with one H100:

    python3 chip_smoke.py

Phases, one JSON line each; any failure raises and exits non-zero:

1. device  — nvidia-smi's name and power limit; compute capability (9, 0).
2. build   — compile the CUDA kernels from ``csrc/`` (``nvcc``, sm_90a);
   the registers and spills of ``fused_dense``, ``q_matmul``,
   ``int8_matmul`` and the two conv kernels by name (none may spill), of
   each instance of the attention forward and backward kernels (dtype x
   largest head dimension; each must be reported), of each
   ``int8_matmul`` instance (f32 or bf16 out x W by TMA or not; each must
   be reported) and each ``layer_norm_fwd`` instance, of the LayerNorm
   backward's two kernels, and of each ``paged_attention`` instance (each
   must be reported).
3. parity  — ``fused_dense`` against ``fused_dense_reference`` on the card
   at M in {1, 2, 4, 8, 16} (every bucket the slice serves) and {37, 128}
   (ragged and multi-tile), and (K, N) in {(25088, 4096), (4096, 4096),
   (4096, 1000), (800, 500)}, plus M = 256 at (800, 500) (LeNet's
   training Dense) and M = 32 at (25088, 4096) and (4096, 4096) (VGG16's
   fc6 and fc7 in training), every epilogue activation, f32 and bf16.
   f32 (TF32 off): max|diff| <= 1e-4 * max|ref| (summation order differs
   at K = 25088).  bf16: max|diff| <= 2 bf16 ulps of max|ref|.  At fc6
   (K = 25088) the same call twice gives the same bits in both dtypes (the
   split-K partials are summed in a fixed order).
4. slice   — the main path: ``ModelServer(max_batch=16, device="cuda")``
   deploys full-width VGG16 (224x224x3, 1000 classes, f32, random weights
   from the zoo seed) with warmup; 8 client threads send 12 requests of
   1-8 rows.  Every answer must equal the same model's forward in
   ``reference`` dispatch mode within the f32 tolerance, and the kernel's
   launch count must be 2 per warmup run and per dispatch (fc6 and fc7;
   the softmax head is plain).  Also times the whole forward at the top
   bucket (16 rows) with the kernel and in ``reference`` mode (median of
   ``FORWARD_REPS``).
   profile — one bucket-16 forward under ``torch.profiler``: kernels by
   device time and the device's idle share of the window.
   The parity phase also takes backwards through the kernel
   (``FusedDense``) at (16, 4096, 1000) with relu and gelu, at LeNet's
   (256, 800, 500) and at VGG16's fc6 in training (32, 25088, 4096) with
   relu, and holds the gradients to the plain version's.
5. times   — fc6, fc7 and the output layer at M = 16 in f32 and bf16: the
   kernel, its plain version and ``torch.addmm`` + relu (a yardstick the
   port never calls), each the median of 25 launches timed with CUDA
   events, L2 flushed before each and a device-side spin
   (``SPIN_CYCLES``) queued between the flush and the start event, so the
   timed call is queued before its window opens and the wrapper's host
   time stays out of it (every ``time_ms`` reading); beside the bound
   (bytes over 3.35 TB/s or operations over the type's peak, whichever is
   larger) and the share of it reached (``share_of_bound`` = bound_ms /
   ms).
6. conv_parity — ``conv3x3_wgrad`` and ``conv3x3_dgrad`` against their
   plain versions at ResNet-50's four body shapes at batch 64 (56x56x64,
   28x28x128, 14x14x256, 7x7x512) and at ragged shapes (3x13x13, Ci 24,
   Co 40; 5x7x7, Ci 96, Co 80; 2x9x11, Ci 3, Co 5; 2x16x16, Ci 3, Co 64:
   VGG16's first conv has Ci = 3) and at the zoo's training shapes at
   batch 32 (VGG16's 224x224 with Ci 64 and with Ci 3, Co 64; Darknet19's
   7x7 with Ci 512, Co 1024), f32 (3xTF32 products) and bf16; each
   call must add one to its launch count, and a second call must give the
   same bits.  f32: max|diff| <= 1e-4 * max|ref| (K reaches 200k terms
   summed in another order); bf16 inputs: 2 bf16 ulps of max|ref|.
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
9. train_profile, train_bf16_profile — one f32 step, then one step of the
   bf16-compute net, under ``torch.profiler``: device busy time, idle
   share, the top kernels, each conv kernel's device ms (dgrad's filter
   pack included) and their share of busy time.
10. conv_times — each conv kernel at the four body shapes in f32 and
   bf16: kernel ms, plain ms and cuDNN's backward
   (``torch.nn.grad.conv2d_weight`` / ``conv2d_input``, TF32 off; a
   yardstick the port never calls), each the median of 25 runs with L2
   flushed, beside the bound of the kernel's route (``route``: ``3xtf32``
   in f32, three TF32 products at 495 TFLOP/s; ``mma_bf16`` in bf16; the
   kernels line calls it ``product``, its ``route`` being ``cuda``) and
   the f32 SIMT bound (67 TFLOP/s) of the first design.
11. ln_parity — ``layer_norm_fwd`` against ``layer_norm_plain`` at rows
   8192 (as 64x128 and 4x2048), 37 and 1, F in {768, 1000, 64, 100, 1025}
   (bf16 rows of 200 bytes take the element copies; 1025 the first row of
   two warps), eps 1e-12 and 1e-5, f32 and bf16, with a bias and (F = 64)
   without; and x as a strided [rows, F] view of [rows, F + 8] at F = 768
   and 100; y, mean and rstd each held to the tolerance (mean and rstd are
   f32: 1e-4 * max|ref| in both dtypes); each call must add one to the
   launch count, and a second call must give the same bits.
12. attn_parity — ``flash_attention`` (out, lse) against
   ``flash_attention_plain`` at [64,12,128,64], [4,12,2048,64] and the
   ragged [2,3,77,64] (S 77), [1,2,37,64] (S 200) and [2,2,130,128] (S
   100), causal or not,
   without a mask and with the last 28 positions dropped in half the
   batch rows, f32 and bf16; lse is f32: 1e-4 * max|ref| in both dtypes.
   Also BERT's head-split (strided) q, k, v at [64,12,128,64], and q
   whose base is 2 bytes off 16 and whose rows are no multiple of 16
   bytes apart (D 33, 64 and 100 at [2,3,70,D], S 90; the kernel's
   element copies).  Each call adds one launch, and a second call gives
   the same bits.
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
   flushed, beside the bound; the attention forward's bound on its product
   route (``route``: ``mma_bf16`` in bf16, ``3xtf32`` in f32; the kernels
   line calls it ``product``) with ``share_of_bound`` and the f32 SIMT
   bound of the first design (``simt_bound_ms``).
17. ln_bwd_parity — the backward kernel (``layer_norm.launch_bwd``)
   against ``layer_norm_bwd_plain`` at ln_parity's rows and F in {768,
   1000, 64, 4096, 100} (a warp a row up to 1024, the block above), x and gain
   f32 or bf16 in each of the four pairs, with a bias and without, on the
   forward kernel's mean and rstd (and one dy whose rows are further apart
   than F); dx, dgain and dbias each held to the tolerance of its dtype;
   each call must add one to the backward's launch count, and a second
   call must give the same bits.
18. attn_bwd_parity — the dQ and dK/dV kernels (``attention.launch_bwd``)
   against ``flash_attention_bwd_plain`` at attn_parity's shapes, causal or
   not, with no mask and with the padded one, f32 and bf16, on the forward
   kernel's out and lse, plus one case with head-split (strided) q, k, v
   and dO; dq, dk and dv each held to the tolerance; each call must add one
   dQ and one dK/dV launch, and a second call must give the same bits.
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
   ``fit_batch`` steps, finite losses, the same launch counts, step ms;
   bert_train_long_profile — a third step under ``torch.profiler``, as in
   phase 22.
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
   the bound; the attention kernels' bound on their product route
   (``ROUTE_RATES``: bf16 tensor cores, or 3xTF32 for f32) beside the f32
   SIMT bound of the first design; ``share_of_bound`` = bound_ms / ms.
24. qmm_parity — ``q_matmul`` and ``int8_matmul`` against their plain
   versions at M in {1, 4, 16, 37} and (K, N) in {(25088, 4096), (4096,
   4096), (4096, 1000), (800, 500), (70, 45)} (K = 70: x rows off 16
   bytes): q_matmul in f32 (TF32 off, 1e-4 * max|ref|) and bf16
   (``Q_BF16_ULPS`` ulps of max|ref|), with and without a bias;
   int8_matmul with and without a bias and an x_scale, f32 out, and bf16
   out with both, bitwise; each call adds one launch; q_matmul at fc6
   gives the same bits twice in both dtypes.  ``quantize_tensor``,
   ``quantize_activation`` and the KV cache's ``quantize_rows`` on the card
   equal the CPU's bit for bit (the CPU's equal the JAX package's numpy,
   ``tests/test_torch_quant.py``).
25. quant_slice — the int8 serving path: ``ModelServer(max_batch=16)``
   deploys full-width VGG16 (f32, version 1), ``quant.calibrate`` runs over
   2 batches of 8 (numpy seed 0), and ``registry.register_quantized`` rolls
   it to version 2 (weight-only) and version 3 (static int8 activations),
   each warmed and serving 12 requests of 1-8 rows from 8 threads, the
   launch counts set to 0 just before each roll: exactly 3 ``q_matmul``
   (version 2) or 3 ``int8_matmul`` (version 3) launches per warmup run
   and per dispatch and none of ``fused_dense``.  Every bucket run is
   recorded and run again on the same padded batch in ``reference`` mode
   (within 1e-4 * max|ref|; a served batch's rows can depend on the batch
   cuDNN sees, and an int8 activation's rounding with them).  Also
   ``parity_check`` against f32, bucket-16 forward ms of each version and
   in reference mode, resident bytes.  quant_profile — one bucket-16
   forward of each int8 version under ``torch.profiler``: ``q_matmul``'s
   and ``int8_matmul``'s device time.
26. qmm_times — both kernels at VGG16's fc6, fc7 and output shapes, M = 16
   (q_matmul in f32 and bf16): kernel, plain, one PyTorch call as a
   yardstick (q_matmul: ``torch.addmm`` on the weight dequantized outside
   the timed region; int8_matmul: ``torch._int_mm``, whose smallest M is
   17, on x padded with zero rows to 32 outside the timed region, the
   int32 product only), bound (bytes over 3.35 TB/s, or operations over
   the f32, bf16 or int8 peak) and ``share_of_bound``.
27. paged_parity — ``paged_attention`` against its plain version at
   [8,4,16], [16,12,64] and [3,2,128], page 16, lengths from 1 to 2,048
   with partial last pages, and at [16,12,64] with block tables as wide
   as the engine's (128 pages) and lengths on, one before and one after
   each boundary of ``paged_plan``'s splits (short ones leave whole splits
   empty); f32 and bf16 pages, int8 pages under f32 and bf16 q (f32:
   within 1e-4 * max|ref|; bf16 out: 2 bf16 ulps); each call adds one
   launch, and a second call gives the same bits; ``tile_rows`` (the
   plan's mirror of the kernel's stage geometry) equals the library's.
28. decode — ``DecodeEngine`` at bench.py's decode configuration (vocab
   96, d_model 64, 4 heads, 192 pages, max_seq_len 256, max batch 8, 48
   prompts of the bench's skewed lengths, seed 0), int8 KV then f32 KV, in
   ``auto`` and in ``reference`` mode: tokens equal (a flip prints its step
   and the top-2 gap, and fails), ``paged_attention`` launches (set to 0
   just before the submits) equal to the decode steps, none in reference
   mode, no new shape after ``warmup()``; one step's logits from one pool
   and one set of block tables within 1e-4 * max|ref|; tokens/s,
   inter-token p50/p99, the pages' high water and bytes per page.
29. decode_wide — the same at head_dim 64 (vocab 30522, d_model 768, 12
   heads, max_seq_len 2048, max batch 16, 2,048 pages; 16 prompts of 1,024
   to 1,900 tokens, 16 to 32 new tokens each).  decode_profile — the int8
   flood of phase 28 under ``torch.profiler``.
30. paged_times — ``paged_attention`` at [16,12,64] over 2,048-token
   histories and over paged_parity's ragged lengths, f32, bf16 and int8
   pages: kernel, plain, and ``scaled_dot_product_attention`` over K/V
   already gathered to [B, H, L, D] in q's dtype with the length mask
   (the gather outside the timed region), beside the bound and
   ``share_of_bound``.

31. lenet_train — MultiLayerNetwork training: full-width LeNet (28x28x1,
   431,080 parameters, seed 123, Adam(1e-3), f32, TF32 off), batch 256
   from ``RandomState(0)`` as bench.py makes it; a twin net loaded from a
   ModelSerializer zip of the initial parameters runs in ``reference``
   mode.  ``gradient_for`` per tensor within 1e-4 * max|ref|; then the
   main path: the ``fused_dense`` count set to 0, 5 ``fit`` steps, one
   ``score_for`` and one ``output``, the count read just after (exactly
   one launch each: the 800 -> 500 relu Dense; the head and the 5x5 convs
   take no kernel); the twin's 5 losses within 1e-4 relative and the
   first Adam update within 1e-4 of its size in the L2 norm, both nets'
   updates compared.  ``fit(ListDataSetIterator(4 batches), epochs=2)``:
   epoch 2, iteration + 8, 8 launches.  ``save`` then ``load`` on the
   card: params, layer state and Adam state bitwise equal, ``output``
   bitwise equal, two more steps on both give the same bits (cuDNN held
   deterministic for them); ``load`` on the CPU gives ``output`` within
   1e-4 * max|ref|.  The end-to-end drive script (Dense 10 -> 32
   relu, Output 2, Adam(1e-2), 50 fits, save/load): the score drops and
   the loaded params are equal.  Median step ms over 20 steps after 3
   warm-up steps in each mode, samples/s; one step under
   ``torch.profiler`` (top kernels, idle share); and ``fused_dense`` at
   (256, 800, 500) f32 relu: kernel, plain and ``torch.addmm`` + relu ms
   beside the bound.
32. vgg16_train — MultiLayerNetwork training and evaluation at VGG16's
   published width (224x224x3, 1000 classes, 138,357,544 parameters,
   seed 123, Adam(1e-3), f32, TF32 off), batch 32 from ``RandomState(0)``
   as bench.py makes them; a twin net loaded from a zip of the initial
   parameters runs in ``reference`` mode, its dropout generator checked
   to be in the same state, so both draw the same dropout-0.5 masks.
   ``gradient_for`` per tensor within 1e-4 * max|ref|; then the main path,
   3 ``fit`` steps, the counts set to 0 just before each and read just
   after: exactly 2 ``fused_dense`` (fc6, fc7), 13 wgrad and 12 dgrad
   launches (the first conv's input needs no gradient); the twin's losses
   within 1e-4 relative (``DIVERGED_LOSS_RTOL`` once reference mode's loss
   rises above its first, with a second reference run from the zip to
   show how far two runs part) and the first Adam update within 1e-4 in
   the L2 norm.  ``fit(ListDataSetIterator(4 batches), epochs=1)`` with
   ``ScoreIterationListener``, ``CollectScoresListener``,
   ``PerformanceListener`` and ``CheckpointListener(every_n_iterations=2,
   keep_last=1)`` (the twin: the first three, in reference mode): epoch
   + 1, iteration + 4, 4 x the launches, the collected scores within the
   loss bound of the twin's, samples/s reported, exactly one zip kept,
   which ``MultiLayerNetwork.load`` restores bitwise to the parameters it
   was saved with.  ``evaluate`` over 2 batches: 2 ``fused_dense``
   launches a batch and no conv kernel; its confusion matrix equal to
   ``Evaluation`` over ``output`` batch by batch, and to the twin's on
   every row whose top-two margin in both nets is at least 1e-4 *
   max|output| (the near ties are counted).  Synchronizing CUDA calls a
   step (``torch.cuda.set_sync_debug_mode("warn")``) with the three
   listeners that never save (logger muted) equal those without
   listeners.  Median step ms over 10 steps after 2 warm-up in each mode,
   samples/s, peak memory; one step under ``torch.profiler``; and
   ``fused_dense`` at (32, 25088, 4096) and the conv pair at 32x224x224,
   Ci = Co = 64, f32: kernel, plain and library ms beside the bound.
33. zoo_train — SimpleCNN (48x48x3, 10 classes, Adam), AlexNet and
   Darknet19 (224x224x3, 1000 classes; Nesterovs(1e-2, 0.9) and Adam) at
   their published widths, batch 32, each against a twin loaded from its
   initial zip in ``reference`` mode: ``gradient_for`` per tensor within
   1e-4 * max|ref|, two ``fit`` steps with the launches exact a step
   (``ZOO_TRAIN``) and the losses held as in phase 32.

Then the kernels line (each entry with ``share_of_bound``; ``fused_dense``
and the conv pair carry ``vgg16_train`` and ``zoo_train`` entries), nvidia-smi's
line, and the last line ``{"ok": true, "device": {...}}``.  Exits
non-zero, printing no result, without CUDA or outside a checkout of the
repository.
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
#: the conv and attention-backward kernels' products by route, (tensor-core
#: or FMA products per product, peak rate): f32 SIMT FMA (the first designs'
#: route, kept as a yardstick), bf16 tensor cores, and 3xTF32, three TF32
#: tensor-core products per f32 product at the dense TF32 peak
ROUTE_RATES = {"simt": (1, 67e12), "mma_bf16": (1, 989e12), "3xtf32": (3, 495e12)}
#: cycles of the device-side spin queued before each timed run's start
#: event (about 0.5 ms at 1.98 GHz): it outlasts a wrapper's host time
#: (Python, ctypes, the launch), so the timed launch is queued before the
#: start event fires and no host time falls inside the window
SPIN_CYCLES = 1_000_000
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
RAGGED_SHAPES = [(3, 13, 13, 24, 40), (5, 7, 7, 96, 80), (2, 9, 11, 3, 5),
                 (2, 16, 16, 3, 64)]
#: training shapes of the zoo's MLNs at batch 32: VGG16's first block
#: (Ci = 64 and the data's Ci = 3) and Darknet19's last stage
ZOO_CONV_SHAPES = [(32, 224, 224, 64, 64), (32, 224, 224, 3, 64), (32, 7, 7, 512, 1024)]
BODY_CONVS = 16
ACTS = ("identity", "linear", "relu", "tanh", "sigmoid", "gelu")
#: runs in the median of a bucket-16 VGG16 forward: the kernels move it by
#: a few tenths of a ms out of ~18 ms, about the spread of 5 runs
FORWARD_REPS = 11
#: VGG16's three Dense layers, (K, N): fc6, fc7 and the softmax head
VGG_DENSE = {"fc6": (25088, 4096), "fc7": (4096, 4096), "output": (4096, 1000)}
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

#: LeNet (BASELINE.json config 1) as bench.py trains it
LENET_PARAMS = 431_080
LENET_BATCH = 256
LENET_DENSE = (800, 500)
LENET_STEPS = 5
LENET_TIMED_STEPS, LENET_WARMUP = 20, 3

#: VGG16 (the zoo's, published width) trained as bench.py's image models are
VGG16_PARAMS = 138_357_544
VGG_BATCH = 32
VGG_STEPS = 3
VGG_ITER_BATCHES, VGG_EVAL_BATCHES = 4, 2
VGG_TIMED_STEPS, VGG_WARMUP = 10, 2
#: launches per VGG16 fit step: fused_dense (fc6 and fc7; the softmax head
#: is a plain product), conv3x3_wgrad (13 3x3 Same convs) and
#: conv3x3_dgrad (12: the first conv's input is the data, which needs no
#: gradient)
VGG_STEP_LAUNCHES = (2, 13, 12)
#: the zoo_train models, (input, classes, per-step launches as above):
#: SimpleCNN's relu Dense and six 3x3 convs; AlexNet's two relu Dense and
#: three 3x3 convs, the first fed by a pool; Darknet19's twelve 3x3 convs
#: (its Dense-free head takes no kernel)
ZOO_TRAIN = {"SimpleCNN": ((48, 48, 3), 10, (1, 6, 5)),
             "AlexNet": ((224, 224, 3), 1000, (2, 3, 3)),
             "Darknet19": ((224, 224, 3), 1000, (0, 12, 11))}
ZOO_STEPS = 2


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


#: kernels whose registers and spills the build phase reports by name
GEMM_KERNELS = ("fused_dense_kernel", "q_matmul_kernel", "int8_matmul_kernel",
                "conv3x3_wgrad_kernel", "conv3x3_dgrad_kernel")
#: int8_matmul's instances: y f32 or bf16 x W by TMA or by cp.async
INT8_INSTANCES = 4
#: the LayerNorm backward's two kernels, reported over their instances
LN_BWD_KERNELS = ("layer_norm_bwd_kernel", "column_sum_kernel")
#: paged_attention's instances, (q, pages) x 16-byte copies or element
#: copies, as their mangled names spell them; the build phase reports each
PAGED_INSTANCES = tuple(f"paged_attention_kernelI{q}{kv}Lb{vec}E"
                        for q, kv in (("f", "f"), ("13__nv_bfloat16", "S1_"), ("f", "a"),
                                      ("13__nv_bfloat16", "a"))
                        for vec in (1, 0))


def _ptxas_instances(log, stem):
    """{instance: {"registers": n, "spill_bytes": b}} for every function
    whose mangled name holds `stem`, keyed by the name from `stem` to the
    end of its template arguments."""
    out, current = {}, None
    for line in log.splitlines():
        if "Function properties for" in line:
            fn = line.split()[-1]
            current = fn[fn.index(stem):].split("Ev")[0] if stem in fn else None
        elif current and "spill stores" in line:
            nums = [int(w) for w in line.replace(",", " ").split() if w.isdigit()]
            out[current] = {"spill_bytes": nums[1] + nums[2]}
        elif current and "Used" in line and "registers" in line:
            out.setdefault(current, {})["registers"] = int(line.split("Used")[1].split()[0])
            current = None
    return out


def _ptxas_by_kernel(log, names):
    """{name: {"registers": [min, max], "spill_bytes": total}} over every
    instantiation whose mangled name holds `name`, from ``-Xptxas -v``."""
    out, current = {}, None
    for line in log.splitlines():
        if "Function properties for" in line:
            fn = line.split()[-1]
            current = next((n for n in names if n in fn), None)
        elif current and "spill stores" in line:
            nums = [int(w) for w in line.replace(",", " ").split() if w.isdigit()]
            out.setdefault(current, {"registers": [], "spill_bytes": 0})
            out[current]["spill_bytes"] += nums[1] + nums[2]
        elif current and "Used" in line and "registers" in line:
            regs = int(line.split("Used")[1].split()[0])
            out[current]["registers"].append(regs)
            current = None
    return {n: {"registers": [min(v["registers"]), max(v["registers"])],
                "spill_bytes": v["spill_bytes"]} for n, v in out.items()}


#: the attention kernels' instances (f32 or bf16, largest head dimension
#: 64 or 128) as their mangled names spell them; the build phase reports
#: each
ATTN_FWD_INSTANCES = tuple(f"flash_attn_fwd_kernelI{t}Li{d}E"
                           for t in ("f", "13__nv_bfloat16") for d in (64, 128))
ATTN_BWD_INSTANCES = tuple(f"flash_attn_bwd_{k}_kernelI{t}Li{d}E" for k in ("dq", "dkv")
                           for t in ("f", "13__nv_bfloat16") for d in (64, 128))


def phase_build(build):
    t0 = time.monotonic()
    build.library()
    info = build.last_build
    ptxas = [l.strip() for l in info.get("ptxas", "").splitlines()
             if "registers" in l or "spill" in l]
    gemm = _ptxas_by_kernel(info.get("ptxas", ""), GEMM_KERNELS)
    attn_fwd = _ptxas_by_kernel(info.get("ptxas", ""), ATTN_FWD_INSTANCES)
    attn_bwd = _ptxas_by_kernel(info.get("ptxas", ""), ATTN_BWD_INSTANCES)
    ln_bwd = _ptxas_by_kernel(info.get("ptxas", ""), LN_BWD_KERNELS)
    paged = _ptxas_by_kernel(info.get("ptxas", ""), PAGED_INSTANCES)
    int8 = _ptxas_instances(info.get("ptxas", ""), "int8_matmul_kernel")
    ln_fwd = _ptxas_instances(info.get("ptxas", ""), "layer_norm_fwd_kernel")
    emit("build", seconds=time.monotonic() - t0, cached=info["cached"],
         library=os.path.relpath(info["path"]), ptxas=sorted(set(ptxas)),
         gemm_ptxas=gemm, int8_ptxas=int8, attn_fwd_ptxas=attn_fwd,
         attn_bwd_ptxas=attn_bwd, ln_fwd_ptxas=ln_fwd, ln_bwd_ptxas=ln_bwd,
         paged_ptxas=paged)
    require(info["cached"] or len(int8) == INT8_INSTANCES,
            f"int8_matmul: ptxas reports {sorted(int8)}")
    require(info["cached"] or len(paged) == len(PAGED_INSTANCES),
            f"paged_attention: ptxas reports {sorted(paged)}")
    require(info["cached"] or len(attn_fwd) == len(ATTN_FWD_INSTANCES),
            f"attention forward: ptxas reports {sorted(attn_fwd)}")
    require(info["cached"] or len(attn_bwd) == len(ATTN_BWD_INSTANCES),
            f"attention backward: ptxas reports {sorted(attn_bwd)}")
    for name in GEMM_KERNELS:
        require(info["cached"] or (name in gemm and gemm[name]["spill_bytes"] == 0),
                f"{name}: ptxas reports {gemm.get(name)} (no report, or spills)")


def phase_parity(matmul, dev):
    gen = torch.Generator(device=dev).manual_seed(0)
    worst = {}
    for K, N in [(25088, 4096), (4096, 4096), (4096, 1000), LENET_DENSE]:
        w32 = torch.randn(K, N, generator=gen, device=dev) / math.sqrt(K)
        b = torch.randn(N, generator=gen, device=dev)
        extra = {LENET_DENSE: (LENET_BATCH,), VGG_DENSE["fc6"]: (VGG_BATCH,),
                 VGG_DENSE["fc7"]: (VGG_BATCH,)}.get((K, N), ())
        for M in (1, 2, 4, 8, 16, 37, 128) + extra:
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
                repeat = None
                if K == VGG_DENSE["fc6"][0]:
                    y = matmul.fused_dense(x, w, b, "relu")
                    repeat = torch.equal(y, matmul.fused_dense(x, w, b, "relu"))
                    require(repeat, f"fused_dense fc6 M={M} {dt}: two calls differ")
                emit("parity", M=M, K=K, N=N, dtype=str(dt), errors=errs,
                     bitwise_repeat=repeat)
    # backwards through the kernel (FusedDense): the plain VJP
    for (M, K, N), act in (((16, 4096, 1000), "relu"), ((16, 4096, 1000), "gelu"),
                           ((LENET_BATCH,) + LENET_DENSE, "relu"),
                           ((VGG_BATCH,) + VGG_DENSE["fc6"], "relu")):
        x = torch.randn(M, K, generator=gen, device=dev, requires_grad=True)
        w = (torch.randn(K, N, generator=gen, device=dev) / math.sqrt(K)).requires_grad_()
        b = torch.randn(N, generator=gen, device=dev, requires_grad=True)
        g = torch.randn(M, N, generator=gen, device=dev)
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
        emit("parity_backward", kernel="fused_dense", M=M, K=K, N=N, activation=act,
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
    forward_ms = time_ms(lambda: entry.model.output(x16), dev, n=FORWARD_REPS)
    prev = dispatch.set_dispatch_mode("reference")
    try:
        refs = [entry.model.output(r).float().cpu().numpy() for r in reqs]
        forward_ref_ms = time_ms(lambda: entry.model.output(x16), dev, n=FORWARD_REPS)
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
        torch.cuda._sleep(SPIN_CYCLES)
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
    for layer, (K, N) in VGG_DENSE.items():
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
                                     share_of_bound=bound_ms / ms, max_abs_err=err)
            emit("times", layer=layer, M=M, K=K, N=N, dtype=str(dt),
                 activation="relu", **rows[(layer, dt)])
    return rows


def conv_bound(kernel, B, H, W, Ci, Co, dt, route):
    """Least time for one call on `route` (``ROUTE_RATES``): the
    operations 2*9*Ci*Co*B*H*W (times 3 for 3xTF32) over the route's peak,
    or the bytes (each input read once, the f32 output written once) over
    3.35 TB/s, whichever is larger."""
    es = torch.tensor([], dtype=dt).element_size()
    K = B * H * W
    if kernel == "conv3x3_wgrad":
        nbytes = K * (Ci + Co) * es + 9 * Ci * Co * 4
    else:
        nbytes = K * Co * es + 9 * Ci * Co * es + K * Ci * 4
    t_bytes = nbytes / HBM_BYTES_PER_S
    mult, rate = ROUTE_RATES[route]
    t_ops = mult * 2.0 * 9 * Ci * Co * K / rate
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
    shapes = list(BODY_SHAPES.values()) + RAGGED_SHAPES + ZOO_CONV_SHAPES
    cases = 0
    for i, shape in enumerate(shapes):
        for dt in (torch.float32, torch.bfloat16):
            x, dy, w = _conv_inputs(shape, dt, dev, seed=10 + i)
            errs, repeat = {}, {}
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
                repeat[name] = torch.equal(got, fn(*args))
                require(repeat[name], f"{name} {shape} {dt}: two calls differ")
                cases += 1
            emit("conv_parity", shape=list(shape), dtype=str(dt),
                 route=conv3x3.ROUTES[dt], errors=errs, bitwise_repeat=repeat)
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
    """2 bf16-compute steps; returns the net for train_bf16_profile."""
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
    return net


def phase_train_profile(net, x, y, phase="train_profile", compute_dtype="float32"):
    """One fit step (f32, or the bf16-compute net for train_bf16_profile)
    under torch.profiler: device busy time (union of kernel intervals),
    idle share of the window, the top kernels, and the share of busy time
    in the two conv backward kernels (dgrad's filter pack included)."""
    def step():
        net.fit(x, y)
        net.score()

    window_ms, busy_ms, by_name, n = _trace(step)
    if busy_ms is None:
        emit(phase, window_ms=window_ms,
             device_busy_ms="not measured", idle_share="not measured")
        return
    wgrad_ms = _share(by_name, "conv3x3_wgrad")
    dgrad_ms = _share(by_name, "conv3x3_dgrad")
    emit(phase, compute_dtype=compute_dtype, window_ms=window_ms, device_busy_ms=busy_ms,
         idle_share=max(0.0, 1.0 - busy_ms / window_ms), kernels=n,
         conv3x3_wgrad_ms=wgrad_ms, conv3x3_dgrad_ms=dgrad_ms,
         conv3x3_share_of_busy=(wgrad_ms + dgrad_ms) / busy_ms,
         top=_top(by_name, 15))


def phase_conv_times(ck, conv3x3, dev):
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
                route = conv3x3.ROUTES[dt]
                bound_ms, bound_by = conv_bound(name, B, H, W, Ci, Co, dt, route)
                ms = time_ms(fn, dev)
                rows[(name, stage, dt)] = dict(
                    ms=ms, plain_ms=time_ms(plain, dev),
                    library_ms=time_ms(lib, dev), route=route, bound_ms=bound_ms,
                    bound_by=bound_by, share_of_bound=bound_ms / ms,
                    simt_bound_ms=conv_bound(name, B, H, W, Ci, Co, dt, "simt")[0],
                    max_abs_err=err)
                emit("conv_times", kernel=name, stage=stage, shape=list(shape),
                     dtype=str(dt), **rows[(name, stage, dt)])
    return rows


#: LayerNorm forward parity: (F, x a strided view, with a bias): BERT's
#: 768, a ragged 1000, 64 without a bias, bf16 rows of 200 bytes (element
#: copies), the first row of two warps, and x as [rows, F] of [rows, F + 8]
LN_FWD_CASES = [(768, False, True), (1000, False, True), (64, False, False),
                (100, False, True), (1025, False, True), (768, True, True), (100, True, True)]


def phase_ln_parity(nk, layer_norm, dev):
    gen = torch.Generator(device=dev).manual_seed(2)
    cases = 0
    for lead in ((64, 128), (4, 2048), (37,), (1,)):
        for F, strided, with_bias in LN_FWD_CASES:
            for dt in (torch.float32, torch.bfloat16):
                x = (torch.randn(*lead, F + 8 * strided, generator=gen, device=dev) * 2
                     + 0.5).to(dt)[..., :F]
                g = torch.randn(F, generator=gen, device=dev).to(dt)
                b = torch.randn(F, generator=gen, device=dev).to(dt) if with_bias else None
                errs = {}
                for eps in (1e-12, 1e-5):
                    before = layer_norm.LAUNCHES.value
                    got = nk.layer_norm_fwd(x, g, b, eps)
                    torch.cuda.synchronize()
                    require(layer_norm.LAUNCHES.value == before + 1,
                            "layer_norm_fwd did not launch its kernel")
                    again = nk.layer_norm_fwd(x, g, b, eps)
                    require(all(torch.equal(a, r) for a, r in zip(got, again)),
                            f"layer_norm_fwd {list(x.shape)} {dt} eps={eps}: two calls differ")
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
                emit("ln_parity", shape=list(x.shape), dtype=str(dt), strided=strided,
                     bias=with_bias, rel_errors=errs, bitwise_repeat=True)
    emit("ln_parity_done", cases=cases, ok=True)


def _keep_mask(B, S, dt, dev, drop=28):
    """[B, S] keep-mask dropping the last `drop` positions of half the rows."""
    m = torch.ones(B, S, dtype=dt, device=dev)
    m[: (B + 1) // 2, S - drop:] = 0
    return m


def _attn_case(ak, attention, q, k, v, mask, causal, tag):
    """One forward call held to the plain version, and a second call to the
    first bit for bit; {name: rel err}."""
    dt = q.dtype
    B, H, T, _ = q.shape
    before = attention.LAUNCHES.value
    out, lse = attention.flash_attention(q, k, v, mask, causal)
    torch.cuda.synchronize()
    require(attention.LAUNCHES.value == before + 1, "flash_attention did not launch its kernel")
    ro, rl = ak.flash_attention_plain(q, k, v, mask, causal)
    require(out.dtype == dt and out.shape == q.shape
            and lse.shape == (B * H, T) and torch.isfinite(out).all().item(),
            f"flash_attention output {out.dtype} {tuple(out.shape)}")
    again = attention.flash_attention(q, k, v, mask, causal)
    errs = {}
    for name, a, r, d, b in (("out", out, ro, dt, again[0]),
                             ("lse", lse, rl, torch.float32, again[1])):
        err = (a.float() - r.float()).abs().max().item()
        rmax = r.float().abs().max().item()
        require(err <= tolerance(d, rmax),
                f"flash_attention {tag} {name}: max|diff| {err} > tol {tolerance(d, rmax)}")
        require(torch.equal(a, b), f"flash_attention {tag} {name}: two calls differ")
        errs[name] = err / max(rmax, 1e-30)
    return errs


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
                    case = f"causal={causal},mask={mask is not None}"
                    errs[case] = _attn_case(ak, attention, q, k, v, mask, causal,
                                            f"{[B, H, T, D]} S={S} {dt} {case}")
                    cases += 1
            emit("attn_parity", shape=[B, H, T, D], S=S, dtype=str(dt), rel_errors=errs,
                 bitwise_repeat=True)
            del q, k, v
    for dt in (torch.float32, torch.bfloat16):
        # BERT's layout: q, k, v split out of one [B, T, 3, H, D] tensor
        B, T, H, D = 64, 128, 12, 64
        qkv = torch.randn(B, T, 3, H, D, generator=gen, device=dev).to(dt)
        q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
        errs = _attn_case(ak, attention, q, k, v, _keep_mask(B, T, dt, dev), False,
                          f"head-split {dt}")
        cases += 1
        emit("attn_parity", shape=[B, H, T, D], S=T, dtype=str(dt), layout="head-split",
             rel_errors=errs, bitwise_repeat=True)
        # q's base 2 bytes off 16 and rows D elements apart: element copies
        B, H, T, S = 2, 3, 70, 90
        for D in (33, 64, 100):
            flat = torch.randn(B * H * T * D + 1, generator=gen, device=dev).to(dt)
            q = flat[1:].view(B, H, T, D)
            k, v = (torch.randn(B, H, S, D, generator=gen, device=dev).to(dt) for _ in range(2))
            errs = {}
            for causal in (False, True):
                errs[f"causal={causal}"] = _attn_case(
                    ak, attention, q, k, v, _keep_mask(B, S, dt, dev), causal,
                    f"unaligned D={D} {dt} causal={causal}")
                cases += 1
            emit("attn_parity", shape=[B, H, T, D], S=S, dtype=str(dt), layout="unaligned",
                 rel_errors=errs, bitwise_repeat=True)
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


def attn_bound(B, H, T, S, D, dt, route):
    """Least time for one forward call on `route` (``ROUTE_RATES``): two
    products of 2*B*H*T*S*D operations (times 3 for 3xTF32) over the
    route's peak, or the bytes (q, k, v, the mask read once; out and lse
    written once) over 3.35 TB/s, whichever is larger."""
    es = torch.tensor([], dtype=dt).element_size()
    nbytes = (2 * T + 2 * S) * B * H * D * es + B * H * T * 4 + B * S * es
    t_bytes = nbytes / HBM_BYTES_PER_S
    mult, rate = ROUTE_RATES[route]
    t_ops = mult * 4.0 * B * H * T * S * D / rate
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
            route = attention.ROUTES[dt]
            bound_ms, bound_by = attn_bound(B, H, T, T, D, dt, route)
            ms = time_ms(fn, dev)
            rows[(name, dt)] = dict(
                ms=ms, plain_ms=time_ms(plain, dev),
                library_ms=time_ms(lambda: F.scaled_dot_product_attention(
                    q, k, v, attn_mask=keep), dev),
                route=route, bound_ms=bound_ms, bound_by=bound_by,
                share_of_bound=bound_ms / ms,
                simt_bound_ms=attn_bound(B, H, T, T, D, dt, "simt")[0], max_abs_err=err)
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
        for F in (768, 1000, 64, 4096, 100):
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
                        again = layer_norm.launch_bwd(x, g, mean, rstd, dy, bias_dtype)
                        require(all((a is None and b is None) or torch.equal(a, b)
                                    for a, b in zip(got, again)),
                                f"layer_norm_bwd {list(x.shape)} {dt}: a second call "
                                "gave other bits")
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
    """One backward call held to the plain version, and a second call to
    the first bit for bit (the dQ kernel's dq and the dK/dV kernel's dk,
    dv); {name: rel err}."""
    out, lse = attention.flash_attention(q, k, v, mask, causal)
    before = (attention.DQ_LAUNCHES.value, attention.DKV_LAUNCHES.value)
    got = attention.launch_bwd(q, k, v, out, lse, g, mask, causal)
    torch.cuda.synchronize()
    require((attention.DQ_LAUNCHES.value, attention.DKV_LAUNCHES.value)
            == (before[0] + 1, before[1] + 1),
            "launch_bwd did not launch the dQ and dK/dV kernels once each")
    want = ak.flash_attention_bwd_plain(q, k, v, out, lse, g, mask, causal)
    again = attention.launch_bwd(q, k, v, out, lse, g, mask, causal)
    errs = {}
    for name, a, r, b, like in zip(("dq", "dk", "dv"), got, want, again, (q, k, v)):
        require(a.dtype == dt and a.shape == like.shape and torch.isfinite(a).all().item(),
                f"flash_attn_bwd {name} {a.dtype} {tuple(a.shape)}")
        err = (a.float() - r.float()).abs().max().item()
        rmax = r.float().abs().max().item()
        require(err <= tolerance(dt, rmax),
                f"flash_attn_bwd {tag} {name}: max|diff| {err} > tol {tolerance(dt, rmax)}")
        require(torch.equal(a, b), f"flash_attn_bwd {tag} {name}: two calls differ")
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
            emit("attn_bwd_parity", shape=[B, H, T, D], S=S, dtype=str(dt), rel_errors=errs,
                 bitwise_repeat=True)
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
             rel_errors=errs, bitwise_repeat=True)
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
    return model, mds


def phase_bert_train_profile(model, mds, phase="bert_train_profile", batch=64, t=128):
    """One bf16 fit_batch (T = 128; T = 2048 for bert_train_long_profile)
    under torch.profiler: device busy time, idle share, the top kernels and
    each new kernel's share of busy time."""
    def step():
        model.fit_batch(mds)
        model.score()

    step()
    window_ms, busy_ms, by_name, n = _trace(step)
    if busy_ms is None:
        emit(phase, window_ms=window_ms, device_busy_ms="not measured",
             idle_share="not measured")
        return
    shares = {name: _share(by_name, tag) for name, tag in (
        ("flash_attn_fwd", "flash_attn_fwd_kernel"),
        ("flash_attn_bwd_dq", "flash_attn_bwd_dq_kernel"),
        ("flash_attn_bwd_dkv", "flash_attn_bwd_dkv_kernel"),
        ("layer_norm_fwd", "layer_norm_fwd_kernel"),
        ("layer_norm_bwd", "layer_norm_bwd_kernel"),
        ("layer_norm_bwd_column_sum", "column_sum_kernel"))}
    emit(phase, batch=batch, T=t, compute_dtype="bfloat16",
         window_ms=window_ms, device_busy_ms=busy_ms,
         idle_share=max(0.0, 1.0 - busy_ms / window_ms), kernels=n,
         kernel_ms=shares, kernel_share_of_busy={k: v / busy_ms for k, v in shares.items()},
         top=_top(by_name, 20))


def attn_bwd_bound(B, H, T, S, D, dt, kernel, route):
    """Least time for one kernel on `route` (``ROUTE_RATES``): 2*B*H*T*S*D
    operations per product (3 in dQ, 4 in dK/dV; times 3 for 3xTF32) over
    the route's peak, or its bytes over 3.35 TB/s (dQ reads q, k, v, out,
    dO, lse and writes dq and delta; dK/dV reads q, k, v, dO, lse, delta,
    the mask and writes dk, dv), whichever is larger."""
    es = torch.tensor([], dtype=dt).element_size()
    qt, kv, stats = B * H * T * D * es, B * H * S * D * es, B * H * T * 4
    if kernel == "flash_attn_bwd_dq":
        products, nbytes = 3, 4 * qt + 2 * kv + 2 * stats + B * S * es
    else:
        products, nbytes = 4, 2 * qt + 4 * kv + 2 * stats + B * S * es
    t_bytes = nbytes / HBM_BYTES_PER_S
    mult, rate = ROUTE_RATES[route]
    t_ops = mult * products * 2.0 * B * H * T * S * D / rate
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
            route = attention.ROUTES[dt]
            for kernel, fn, err in (
                    ("flash_attn_bwd_dq", lambda: attention.launch_bwd_dq(args), errs[0]),
                    ("flash_attn_bwd_dkv", lambda: attention.launch_bwd_dkv(args),
                     max(errs[1:]))):
                bound_ms, bound_by = attn_bwd_bound(B, H, T, T, D, dt, kernel, route)
                ms = time_ms(fn, dev)
                rows[(kernel, name, dt)] = dict(
                    ms=ms, plain_ms=plain, library_ms=lib, route=route, bound_ms=bound_ms,
                    bound_by=bound_by, share_of_bound=bound_ms / ms,
                    simt_bound_ms=attn_bwd_bound(B, H, T, T, D, dt, kernel, "simt")[0],
                    max_abs_err=err)
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
        ms = time_ms(fn, dev)
        out[dt] = dict(ms=ms, plain_ms=time_ms(plain, dev),
                       library_ms=time_ms(lambda: torch.autograd.grad(
                           y, (xl, gl, bl), dy, retain_graph=True), dev),
                       bound_ms=bound_ms, bound_by=bound_by, share_of_bound=bound_ms / ms,
                       max_abs_err=err)
        emit("ln_bwd_times", shape=[rows, F], dtype=str(dt), **out[dt])
    return out


QMM_KERNELS = {
    "q_matmul": ("deeplearning4j_tpu/ops/pallas/matmul.py:232",
                 "deeplearning4j_tpu_torch/ops/kernels/csrc/q_matmul.cu"),
    "int8_matmul": ("deeplearning4j_tpu/ops/pallas/matmul.py:185",
                    "deeplearning4j_tpu_torch/ops/kernels/csrc/int8_matmul.cu"),
}
PAGED_KERNEL = ("deeplearning4j_tpu/ops/pallas/paged_attention.py:117",
                "deeplearning4j_tpu_torch/ops/kernels/csrc/paged_attention.cu")
INT8_PEAK_OPS_PER_S = 1979e12
#: bound on q_matmul against its plain version in bf16, in bf16 ulps of
#: max|ref|: the kernel rounds once, from f32 (as the TPU kernel does), the
#: plain version three times (the product, the scaled product and the bias
#: sum, as ``q_matmul_reference`` does), each within half an ulp of its
#: value; this phase read 1 ulp at worst on an H100 80GB HBM3 at 700 W
Q_BF16_ULPS = 3
#: paged-attention parity: [B, H, D] and the history lengths (page 16):
#: lengths 1, partial last pages, full pages and 2,048
PAGED_SHAPES = [(8, 4, 16, [1, 16, 17, 200, 31, 64, 129, 255]),
                (16, 12, 64, [2048, 1, 1031, 2047, 16, 700, 1900, 33,
                              2048, 5, 1024, 1025, 15, 640, 1999, 100]),
                (3, 2, 128, [37, 1, 2048])]
PAGE = 16
#: paged parity's (name, q dtype, int8 pages): pages in q's dtype (f32,
#: bf16) and int8 pages under f32 and bf16 q, every pair the kernel takes
PAGED_MODES = (("f32", torch.float32, False), ("bf16", torch.bfloat16, False),
               ("int8", torch.float32, True), ("int8_bf16q", torch.bfloat16, True))
#: the engine's block-table width at DECODE_WIDE (max_seq_len 2048 / PAGE):
#: split-edge cases use it, so most of their splits past a length are empty
ENGINE_MAX_PAGES = 2048 // PAGE
#: the decode configurations: bench.py:2807-2836's, and a head_dim-64 one
DECODE_SMALL = dict(vocab=96, d_model=64, n_heads=4, num_blocks=192,
                    max_seq_len=256, max_decode_batch=8)
DECODE_WIDE = dict(vocab=30522, d_model=768, n_heads=12, num_blocks=16 * 2048 // PAGE,
                   max_seq_len=2048, max_decode_batch=16)


def q_bound(M, K, N, dt):
    """Least time for one q_matmul: x, the int8 W, the scales and the bias
    read once, y written once, over 3.35 TB/s; or 2*M*N*K operations over
    the compute dtype's peak; whichever is larger."""
    es = torch.tensor([], dtype=dt).element_size()
    nbytes = M * K * es + K * N + 2 * N * 4 + M * N * es
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = 2.0 * M * N * K / PEAK_OPS_PER_S[dt]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def int8_bound(M, K, N, out_dt):
    """Least time for one int8_matmul: int8 x and W, the scales and the bias
    read once, y written once, over 3.35 TB/s; or 2*M*N*K int8 operations
    over 1,979 TOP/s; whichever is larger."""
    es = torch.tensor([], dtype=out_dt).element_size()
    nbytes = M * K + K * N + 2 * N * 4 + M * N * es
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = 2.0 * M * N * K / INT8_PEAK_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def paged_bound(B, H, D, seq_lens, q_dt, kv_int8):
    """Least time for one paged_attention: q, the K and V rows of the
    tokens each sequence holds (and their scales), the block tables, the
    lengths read once, out written once, over 3.35 TB/s; or 4*H*D
    operations per held token over the f32 rate; whichever is larger."""
    es = torch.tensor([], dtype=q_dt).element_size()
    tokens = int(sum(seq_lens))
    kv = 2 * tokens * H * D * (1 if kv_int8 else es) + (2 * tokens * H * 4 if kv_int8 else 0)
    pages = sum(-(-int(n) // PAGE) for n in seq_lens)
    nbytes = 2 * B * H * D * es + kv + 4 * (pages + B)
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = 4.0 * tokens * H * D / PEAK_OPS_PER_S[torch.float32]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def phase_qmm_parity(matmul, qk, dev):
    """q_matmul (f32 with TF32 off, bf16; with and without a bias) and
    int8_matmul (with and without a bias and an x_scale, held bitwise)
    against their plain versions; each call adds one launch.  The int8
    operands quantized on the card equal those quantized on the CPU, to the
    bit."""
    gen = torch.Generator(device=dev).manual_seed(3)
    cases = 0
    for K, N in [(25088, 4096), (4096, 4096), (4096, 1000), (800, 500), (70, 45)]:
        w = torch.randn(K, N, generator=gen, device=dev) / math.sqrt(K)
        qt = qk.quantize_tensor(w)
        host = qk.quantize_tensor(w.cpu())
        require(torch.equal(qt.q.cpu(), host.q) and torch.equal(qt.scale.cpu(), host.scale),
                f"quantize_tensor [{K},{N}] on the card differs from the CPU's")
        b = torch.randn(N, generator=gen, device=dev)
        for M in (1, 4, 16, 37):
            x32 = torch.randn(M, K, generator=gen, device=dev)
            errs = {}
            for dt in (torch.float32, torch.bfloat16):
                x = x32.to(dt)
                for bias in (None, b):
                    before = matmul.Q_LAUNCHES.value
                    y = matmul.q_matmul(x, qt.q, qt.scale, bias=bias)
                    torch.cuda.synchronize()
                    require(matmul.Q_LAUNCHES.value == before + 1,
                            "q_matmul did not launch its kernel")
                    r = matmul.q_matmul_plain(x, qt.q, qt.scale, bias=bias)
                    require(y.dtype == dt and y.shape == (M, N),
                            f"q_matmul output {y.dtype} {tuple(y.shape)}")
                    err = (y.float() - r.float()).abs().max().item()
                    ref = r.float().abs().max().item()
                    tol = (F32_RTOL * ref if dt == torch.float32
                           else Q_BF16_ULPS * bf16_ulp(ref))
                    require(err <= tol, f"q_matmul M={M} K={K} N={N} {dt} bias="
                            f"{bias is not None}: max|diff| {err} > tol {tol}")
                    errs[f"q_matmul {str(dt)[6:]} bias={bias is not None}"] = {
                        "abs": err, "rel": err / max(ref, 1e-30)}
                    cases += 1
                if K == VGG_DENSE["fc6"][0]:
                    y = matmul.q_matmul(x, qt.q, qt.scale, bias=b)
                    require(torch.equal(y, matmul.q_matmul(x, qt.q, qt.scale, bias=b)),
                            f"q_matmul fc6 M={M} {dt}: two calls differ")
                    errs[f"q_matmul {str(dt)[6:]} bitwise_repeat"] = True
            xq = qk.quantize_activation(x32, 0.05)
            require(torch.equal(xq.cpu(), qk.quantize_activation(x32.cpu(), 0.05)),
                    "quantize_activation on the card differs from the CPU's")
            for xs, bias, out in ((None, None, torch.float32), (None, b, torch.float32),
                                  (0.05, None, torch.float32), (0.05, b, torch.float32),
                                  (0.05, b, torch.bfloat16)):
                before = matmul.INT8_LAUNCHES.value
                y = matmul.int8_matmul(xq, qt.q, qt.scale, x_scale=xs, bias=bias, out_dtype=out)
                torch.cuda.synchronize()
                require(matmul.INT8_LAUNCHES.value == before + 1,
                        "int8_matmul did not launch its kernel")
                r = matmul.int8_matmul_plain(xq, qt.q, qt.scale, x_scale=xs, bias=bias,
                                             out_dtype=out)
                require(y.dtype == out and torch.equal(y, r),
                        f"int8_matmul M={M} K={K} N={N} x_scale={xs} bias={bias is not None} "
                        f"{out} is not bitwise equal to its plain version (max|diff| "
                        f"{(y.float() - r.float()).abs().max().item()})")
                cases += 1
            errs["int8_matmul"] = "bitwise, 5 cases (f32 out; bf16 out with x_scale and bias)"
            emit("qmm_parity", M=M, K=K, N=N, errors=errs)
    emit("qmm_parity_done", cases=cases, ok=True)


def _counts(matmul):
    return {"q_matmul": matmul.Q_LAUNCHES.value, "int8_matmul": matmul.INT8_LAUNCHES.value,
            "fused_dense": matmul.LAUNCHES.value}


def phase_quant_slice(matmul, dispatch, ModelServer, quant, dev, image=224, classes=1000):
    """The quantized serving path: VGG16 f32 deployed, calibrated, rolled to
    int8 twice (weight-only, then static activations), each version warmed
    and serving 12 requests from 8 threads; launch counts per version,
    every dispatch against reference mode on the same padded batch."""
    sizes = [1, 8, 3, 5, 2, 7, 4, 6, 1, 8, 2, 5]
    rng = np.random.default_rng(0)
    cal = [rng.standard_normal((8, image, image, 3), dtype=np.float32) for _ in range(2)]
    x16 = torch.as_tensor(rng.standard_normal((16, image, image, 3), dtype=np.float32),
                          device=dev)
    srv = ModelServer(max_batch=16, device=dev)
    runs = []
    plain_run = srv.cache.run

    def recording_run(key, model, x):
        out = plain_run(key, model, x)
        runs.append((key, model, np.array(x), out))
        return out

    srv.cache.run = recording_run
    res = {"versions": {}}
    models = {}
    try:
        t0 = time.monotonic()
        base = srv.deploy("vgg16", zoo="VGG16").model
        res["deploy_s"] = time.monotonic() - t0
        t0 = time.monotonic()
        stats = quant.calibrate(base, cal)
        res["calibrate_s"] = time.monotonic() - t0
        res["calibration"] = {"observer": stats.observer, "batches": stats.batches,
                              "activations": len(stats.ranges), "crc32": stats.crc32()}
        res["f32_bytes"] = sum(p.numel() * p.element_size() for p in base.parameters())
        res["forward_ms_bucket16_f32"] = time_ms(lambda: base.output(x16), dev, n=FORWARD_REPS)
        for tag, cfg, kernel in (
                ("weight_only", quant.QuantConfig(), "q_matmul"),
                ("static", quant.QuantConfig(quantize_activations=True), "int8_matmul")):
            reqs = [rng.standard_normal((n, image, image, 3), dtype=np.float32)
                    for n in sizes]
            for c in (matmul.Q_LAUNCHES, matmul.INT8_LAUNCHES, matmul.LAUNCHES):
                c.reset()
            runs.clear()
            d0 = srv.stats()["dispatches"]
            t0 = time.monotonic()
            entry = srv.registry.register_quantized("vgg16", calibration=stats, config=cfg,
                                                    base_version=1)
            roll_s = time.monotonic() - t0
            warmed = srv.registry.warmup("vgg16", srv.cache, version=entry.version)
            with ThreadPoolExecutor(max_workers=8) as ex:
                futs = [ex.submit(srv.output, "vgg16", r, timeout=600) for r in reqs]
                outs = [f.result() for f in futs]
            counts = _counts(matmul)
            dispatches = srv.stats()["dispatches"] - d0
            qm = entry.model
            require(counts[kernel] == 3 * (len(warmed) + dispatches) and counts["fused_dense"] == 0
                    and sum(counts.values()) == counts[kernel],
                    f"{tag}: launches {counts}, want {kernel} = 3 x ({len(warmed)} warmup runs + "
                    f"{dispatches} dispatches) and no other")
            require(len(runs) == len(warmed) + dispatches,
                    f"{tag}: {len(runs)} bucket runs recorded")
            for n, o in zip(sizes, outs):
                require(o.shape == (n, classes) and np.isfinite(o).all()
                        and np.allclose(o.sum(axis=1), 1.0, atol=1e-4),
                        f"{tag}: answer shape {o.shape}, non-finite or not a softmax")
            prev = dispatch.set_dispatch_mode("reference")
            try:
                worst, bitwise = 0.0, True
                for key, model, x, out in runs:
                    ref = plain_run(key, model, x)
                    err = float(np.abs(out - ref).max())
                    top = float(np.abs(ref).max())
                    require(err <= F32_RTOL * top,
                            f"{tag}: a dispatch of {x.shape[0]} rows differs from reference "
                            f"mode by {err} > {F32_RTOL * top}")
                    worst = max(worst, err / top)
                    bitwise = bitwise and err == 0.0
                ref_ms = time_ms(lambda: qm.output(x16), dev, n=FORWARD_REPS)
            finally:
                dispatch.set_dispatch_mode(prev)
            par = quant.parity_check(base, qm, x16)
            models[tag] = qm
            res["versions"][tag] = {
                "version": entry.version, "kernel": kernel, "roll_s": roll_s,
                "warmup_runs": len(warmed), "dispatches": dispatches, "launches": counts,
                "max_rel_err_vs_reference": worst, "bitwise_vs_reference": bitwise,
                "parity_check_vs_f32": par, "bytes_resident": qm.bytes_resident(),
                "dtypes": qm.describe()["dtypes"],
                "forward_ms_bucket16": time_ms(lambda: qm.output(x16), dev, n=FORWARD_REPS),
                "forward_reference_ms_bucket16": ref_ms}
        stats_all = srv.stats()
        res["latency_ms"] = stats_all["latency_ms"]
        res["failed"] = stats_all["failed"]
        require(stats_all["failed"] == 0 and srv.metrics.dispatch_retries.value == 0,
                f"failures {stats_all['failed']}")
    finally:
        srv.shutdown()
    emit("quant_slice", model="VGG16", input=f"{image}x{image}x3 f32", classes=classes,
         requests=len(sizes),
         rows=sum(sizes), **res)
    return res, models, x16


def phase_quant_profile(models, x16):
    """One bucket-16 forward of each int8 version under torch.profiler:
    busy time, idle share, the top kernels and the quantized product's
    share (q_matmul weight-only, int8_matmul static)."""
    for tag, kernel in (("weight_only", "q_matmul"), ("static", "int8_matmul")):
        qm = models[tag]
        qm.output(x16)
        window_ms, busy_ms, by_name, n = _trace(lambda: qm.output(x16))
        if busy_ms is None:
            emit("quant_profile", version=tag, window_ms=window_ms,
                 device_busy_ms="not measured", idle_share="not measured")
            continue
        emit("quant_profile", bucket=16, version=tag, window_ms=window_ms,
             device_busy_ms=busy_ms, idle_share=max(0.0, 1.0 - busy_ms / window_ms),
             kernels=n, **{f"{kernel}_ms": _share(by_name, f"{kernel}_kernel")},
             top=_top(by_name, 12))


def phase_qmm_times(matmul, qk, dev, M=16):
    """Each quantized kernel at VGG16's Dense shapes, M = 16: kernel, plain,
    one PyTorch call as a yardstick (``torch.addmm`` on the weight
    dequantized outside the timed region; ``torch._int_mm`` on x padded with
    zero rows to 32, its smallest M past 16, outside the timed region),
    bound."""
    rows = {}
    for layer, (K, N) in VGG_DENSE.items():
        gen = torch.Generator(device=dev).manual_seed(4)
        qt = qk.quantize_tensor(torch.randn(K, N, generator=gen, device=dev) / math.sqrt(K))
        b = torch.randn(N, generator=gen, device=dev)
        x32 = torch.randn(M, K, generator=gen, device=dev)
        for dt in (torch.float32, torch.bfloat16):
            x, wd, bl = x32.to(dt), qk.dequantize(qt, dt), b.to(dt)
            fn = lambda: matmul.q_matmul(x, qt.q, qt.scale, bias=b)  # noqa: E731
            plain = lambda: matmul.q_matmul_plain(x, qt.q, qt.scale, bias=b)  # noqa: E731
            err = (fn().float() - plain().float()).abs().max().item()
            bound_ms, bound_by = q_bound(M, K, N, dt)
            ms = time_ms(fn, dev)
            rows[("q_matmul", layer, dt)] = dict(
                ms=ms, plain_ms=time_ms(plain, dev),
                library_ms=time_ms(lambda: torch.addmm(bl, x, wd), dev),
                bound_ms=bound_ms, bound_by=bound_by, share_of_bound=bound_ms / ms,
                max_abs_err=err)
            emit("qmm_times", kernel="q_matmul", layer=layer, M=M, K=K, N=N, dtype=str(dt),
                 **rows[("q_matmul", layer, dt)])
        xq = qk.quantize_activation(x32, 0.05)
        fn = lambda: matmul.int8_matmul(xq, qt.q, qt.scale, x_scale=0.05, bias=b)  # noqa: E731
        plain = lambda: matmul.int8_matmul_plain(xq, qt.q, qt.scale, x_scale=0.05, bias=b)  # noqa: E731
        err = (fn() - plain()).abs().max().item()
        # torch._int_mm wants M > 16 and K, N multiples of 8
        xq32 = torch.cat([xq, xq.new_zeros(32 - M, K)]) if M < 32 else xq
        lib = time_ms(lambda: torch._int_mm(xq32, qt.q), dev)
        bound_ms, bound_by = int8_bound(M, K, N, torch.float32)
        ms = time_ms(fn, dev)
        rows[("int8_matmul", layer)] = dict(
            ms=ms, plain_ms=time_ms(plain, dev), library_ms=lib,
            library="torch._int_mm, x padded to 32 rows, int32 product only",
            bound_ms=bound_ms, bound_by=bound_by, share_of_bound=bound_ms / ms,
            max_abs_err=err)
        emit("qmm_times", kernel="int8_matmul", layer=layer, M=M, K=K, N=N,
             dtype="int8 -> torch.float32", **rows[("int8_matmul", layer)])
    return rows


def _paged_inputs(B, H, D, lens, dt, kv_int8, dev, seed, max_pages=None):
    """q, pages, scales, block tables, lengths: each sequence's pages are
    distinct, in a shuffled order, with 3 pages nobody owns; block tables
    ``max_pages`` wide (at least the longest length's pages), zero past a
    sequence's pages, as the engine pads them."""
    from deeplearning4j_tpu_torch.serving.decode import quantize_rows

    gen = torch.Generator(device=dev).manual_seed(seed)
    max_pages = max(max_pages or 0, -(-max(lens) // PAGE))
    n_pages = [-(-n // PAGE) for n in lens]
    P = sum(n_pages) + 3
    q = torch.randn(B, H, D, generator=gen, device=dev).to(dt)
    k = torch.randn(P, PAGE, H, D, generator=gen, device=dev)
    v = torch.randn(P, PAGE, H, D, generator=gen, device=dev)
    perm = torch.randperm(P, generator=torch.Generator().manual_seed(seed)).tolist()
    bt = torch.zeros(B, max_pages, dtype=torch.int32)
    off = 0
    for i, n in enumerate(n_pages):
        bt[i, :n] = torch.tensor(perm[off:off + n])
        off += n
    sl = torch.tensor(lens, dtype=torch.int32, device=dev)
    if kv_int8:
        (k8, ks), (v8, vs) = quantize_rows(k), quantize_rows(v)
        host = quantize_rows(k.cpu())
        require(torch.equal(k8.cpu(), host[0]) and torch.equal(ks.cpu(), host[1]),
                "quantize_rows on the card differs from the CPU's")
        k, v = k8, v8
    else:
        k, v, ks, vs = k.to(dt), v.to(dt), None, None
    return (q, k, v, bt.to(dev), sl), dict(k_scales=ks, v_scales=vs)


def _split_edge_lens(plan, B, L=2048):
    """B lengths at the plan's split boundaries (on, one before, one
    after), short ones that leave most splits empty, and 2,048."""
    per = plan.pages_per_split * PAGE
    edges = [n for k in range(1, plan.splits) for n in (k * per - 1, k * per, k * per + 1)]
    lens = edges + [1, 15, 16, 17, 100, 333, 1024, L]
    return [min(max(n, 1), L) for n in (lens * B)[:B]]


def phase_paged_parity(pa, dev):
    """paged_attention against its plain version: f32 and bf16 pages,
    int8 pages under f32 and bf16 q, ragged lengths, and lengths on the
    plan's split boundaries in block tables as wide as the engine's; each
    call adds one launch, and a second call gives the same bits."""
    from deeplearning4j_tpu_torch.ops.kernels import build

    lib = build.library()
    for D in (16, 33, 64, 128, 256):
        for itemsize in (1, 2, 4):
            require(pa.tile_rows(D, itemsize) == lib.dl4j_paged_attention_tile_rows(D, itemsize),
                    f"paged_attention: tile_rows({D}, {itemsize}) is not the library's")
    sm_count = torch.cuda.get_device_properties(dev).multi_processor_count
    cases = [(B, H, D, lens, None) for B, H, D, lens in PAGED_SHAPES]
    cases.append((16, 12, 64, None, ENGINE_MAX_PAGES))
    n = 0
    for i, (B, H, D, lens, max_pages) in enumerate(cases):
        errs = {}
        for mode, dt, kv_int8 in PAGED_MODES:
            plan, case_lens = None, lens
            if lens is None:     # the split-edge case
                plan = pa.paged_plan(B, H, D, PAGE, max_pages, 1 if kv_int8 else
                                     torch.tensor([], dtype=dt).element_size(), sm_count)
                case_lens = _split_edge_lens(plan, B)
            args, kw = _paged_inputs(B, H, D, case_lens, dt, kv_int8, dev, seed=20 + i,
                                     max_pages=max_pages)
            before = pa.LAUNCHES.value
            y = pa.paged_attention(*args, **kw)
            torch.cuda.synchronize()
            require(pa.LAUNCHES.value == before + 1, "paged_attention did not launch its kernel")
            again = pa.paged_attention(*args, **kw)
            r = pa.paged_attention_plain(*args, **kw)
            require(y.dtype == dt and y.shape == (B, H, D),
                    f"paged_attention output {y.dtype} {tuple(y.shape)}")
            err = (y.float() - r.float()).abs().max().item()
            ref = r.float().abs().max().item()
            tol = tolerance(dt, ref)
            require(err <= tol, f"paged_attention [{B},{H},{D}] {mode} lengths {case_lens}: "
                    f"max|diff| {err} > tol {tol}")
            require(torch.equal(y, again),
                    f"paged_attention [{B},{H},{D}] {mode}: a second call gave other bits")
            errs[mode] = {"abs": err, "rel": err / max(ref, 1e-30)}
            if plan is not None:
                errs[mode].update(seq_lens=case_lens, plan=plan._asdict())
            n += 1
        emit("paged_parity", shape=[B, H, D], page=PAGE, max_pages=args[3].shape[1],
             seq_lens=lens if lens is not None else "split edges, per mode", errors=errs)
    emit("paged_parity_done", cases=n, bitwise_repeat=True, ok=True)


def _decode_flood(cfg):
    """The prompts and new-token counts: bench.py's skewed lengths for the
    small configuration, 1,024 to 1,900-token prompts with 16 to 32 new
    tokens for the wide one; numpy seed 0."""
    rng = np.random.default_rng(0)
    if cfg is DECODE_SMALL:
        max_prompt = cfg["max_seq_len"] - 24
        pool = [p for p in [3, 5, 7, 9, 14, 20, 33, 60] if p < max_prompt] + [max_prompt]
        weights = np.array([4.0] * (len(pool) - 1) + [1.0])
        lens = rng.choice(pool, size=48, p=weights / weights.sum())
        return [(rng.integers(1, cfg["vocab"], size=int(n)), int(rng.integers(4, 20)))
                for n in lens]
    return [(rng.integers(1, cfg["vocab"], size=int(rng.integers(1024, 1901))),
             int(rng.integers(16, 33))) for _ in range(16)]


def _decode_run(dec, pa, dispatch, model, cfg, kv, mode, label):
    """One engine over the flood in a dispatch mode: warmup, launch count
    set to 0 just before the submits and read after the last token."""
    eng = dec.DecodeEngine(model, num_blocks=cfg["num_blocks"],
                           max_seq_len=cfg["max_seq_len"],
                           max_decode_batch=cfg["max_decode_batch"], kv_dtype=kv,
                           model_label=label)
    prev = dispatch.set_dispatch_mode(mode)
    try:
        warm = eng.warmup()
        pa.LAUNCHES.reset()
        t0 = time.monotonic()
        futs = [eng.submit(p, max_new_tokens=n) for p, n in _decode_flood(cfg)]
        peak_active = 0
        while not all(f.done() for f in futs):
            peak_active = max(peak_active, eng.cache.active_sequences)
            time.sleep(0.002)
        outs = [f.result(timeout=600) for f in futs]
        wall = time.monotonic() - t0
        launches = pa.LAUNCHES.value
        st = eng.stats()
    finally:
        dispatch.set_dispatch_mode(prev)
        eng.shutdown()
    tokens = sum(len(o) for o in outs)
    lat = eng.instruments.inter_token(label).percentiles((50, 99))
    return {"outs": outs, "warm_shapes": warm, "fresh_after": st["compile"]["fresh"],
            "launches": launches, "decode_steps": st["decode_steps"], "tokens": tokens,
            "wall_s": wall, "tokens_per_s": tokens / wall,
            "inter_token_p50_ms": lat["p50"], "inter_token_p99_ms": lat["p99"],
            "kv_high_water_pages": st["kv"]["high_water"],
            "bytes_per_block": st["kv"]["bytes_per_block"], "peak_active": peak_active}


def _first_flip(model, flood, got, want, dev):
    """The first token where two runs differ, and the reference-side top-2
    gap there (the prompt and the common prefix through the model's
    prefill)."""
    for s, (g, w) in enumerate(zip(got, want)):
        if list(g) != list(w):
            t = next(i for i in range(min(len(g), len(w))) if g[i] != w[i])
            seq = np.concatenate([flood[s][0], np.asarray(w[:t])]).astype(np.int64)
            with torch.inference_mode():
                last, _, _ = model.prefill(torch.as_tensor(seq[None], device=dev),
                                           torch.tensor([seq.size], device=dev))
            top2 = torch.topk(last[0].float(), 2).values.tolist()
            return {"sequence": s, "step": t, "auto": int(g[t]), "reference": int(w[t]),
                    "top2_gap": top2[0] - top2[1]}
    return None


def _decode_step_logits(dec, pa, dispatch, model, cfg, kv, dev, n_seqs=8):
    """One decode step's logits, kernel against plain version, from one
    pool and one set of block tables filled by the model's prefill."""
    flood = _decode_flood(cfg)[:n_seqs]
    cache = dec.PagedKVCache(cfg["num_blocks"], PAGE, model.n_heads, model.head_dim,
                             dtype=kv, device=dev)
    with torch.inference_mode():
        last_tok = []
        for i, (p, _) in enumerate(flood):
            _, k, v = model.prefill(torch.as_tensor(p[None].astype(np.int64), device=dev),
                                    torch.tensor([p.size], device=dev))
            cache.allocate(i)
            cache.write(i, k[0], v[0])
            last_tok.append(int(p[-1]))
        q, k, v = model.decode_qkv(torch.tensor(last_tok, device=dev))
        for i in range(n_seqs):
            cache.write(i, k[i:i + 1], v[i:i + 1])
        max_pages = -(-cfg["max_seq_len"] // PAGE)
        bt, sl = (torch.as_tensor(a, device=dev)
                  for a in cache.block_tables(list(range(n_seqs)), n_seqs, max_pages))
        pages = cache.pages()
        ks, vs = (pages[2], pages[3]) if kv == "int8" else (None, None)
        out = {}
        for mode in ("auto", "reference"):
            prev = dispatch.set_dispatch_mode(mode)
            try:
                out[mode] = model.decode_out(dec.paged_attn(q, pages[0], pages[1], bt, sl,
                                                            k_scales=ks, v_scales=vs))
            finally:
                dispatch.set_dispatch_mode(prev)
    err = (out["auto"] - out["reference"]).abs().max().item()
    top = out["reference"].abs().max().item()
    require(err <= F32_RTOL * top, f"decode step logits ({kv} KV): max|diff| {err} > "
            f"{F32_RTOL * top}")
    return err / top


def phase_decode(dec, pa, dispatch, dev, cfg, phase):
    """The decode path at one configuration, int8 KV then f32 KV: tokens in
    auto mode equal reference mode's, one paged_attention launch per decode
    step, no new shape after warmup; one step's logits against reference
    mode."""
    model = dec.TinyDecodeModel(vocab=cfg["vocab"], d_model=cfg["d_model"],
                                n_heads=cfg["n_heads"], seed=0, device=dev)
    flood = _decode_flood(cfg)
    res = {}
    for kv in ("int8", "f32"):
        auto = _decode_run(dec, pa, dispatch, model, cfg, kv, "auto", f"{phase}-{kv}-auto")
        ref = _decode_run(dec, pa, dispatch, model, cfg, kv, "reference", f"{phase}-{kv}-ref")
        flip = _first_flip(model, flood, auto["outs"], ref["outs"], dev)
        if flip is not None:
            emit(phase + "_token_flip", kv_dtype=kv, **flip)
        require(flip is None, f"{phase} {kv} KV: tokens differ from reference mode: {flip}")
        for r, tag in ((auto, "auto"), (ref, "reference")):
            require(r["fresh_after"] == r["warm_shapes"],
                    f"{phase} {kv} {tag}: {r['fresh_after'] - r['warm_shapes']} new shapes "
                    "after warmup")
        require(auto["launches"] == auto["decode_steps"] > 0 and ref["launches"] == 0,
                f"{phase} {kv}: paged_attention launches {auto['launches']} over "
                f"{auto['decode_steps']} decode steps (reference mode: {ref['launches']})")
        step_rel = _decode_step_logits(dec, pa, dispatch, model, cfg, kv, dev)
        res[kv] = {k: v for k, v in auto.items() if k != "outs"}
        res[kv]["reference"] = {k: ref[k] for k in ("tokens_per_s", "inter_token_p50_ms",
                                                    "inter_token_p99_ms", "decode_steps")}
        res[kv]["step_logits_rel_err_vs_reference"] = step_rel
        emit(phase, vocab=cfg["vocab"], d_model=cfg["d_model"], n_heads=cfg["n_heads"],
             head_dim=model.head_dim, page=PAGE, num_blocks=cfg["num_blocks"],
             max_seq_len=cfg["max_seq_len"], max_decode_batch=cfg["max_decode_batch"],
             prompts=len(flood), kv_dtype=kv, **res[kv])
    return res


def phase_decode_profile(dec, dev):
    """The small configuration's int8 flood under torch.profiler, in auto
    mode: busy time, idle share, the top kernels and paged_attention's
    share."""
    cfg = DECODE_SMALL
    model = dec.TinyDecodeModel(vocab=cfg["vocab"], d_model=cfg["d_model"],
                                n_heads=cfg["n_heads"], seed=0, device=dev)
    eng = dec.DecodeEngine(model, num_blocks=cfg["num_blocks"], max_seq_len=cfg["max_seq_len"],
                           max_decode_batch=cfg["max_decode_batch"], kv_dtype="int8",
                           model_label="decode-profile")
    try:
        eng.warmup()

        def flood():
            futs = [eng.submit(p, max_new_tokens=n) for p, n in _decode_flood(cfg)]
            for f in futs:
                f.result(timeout=600)

        window_ms, busy_ms, by_name, n = _trace(flood)
    finally:
        eng.shutdown()
    if busy_ms is None:
        emit("decode_profile", window_ms=window_ms, device_busy_ms="not measured",
             idle_share="not measured")
        return
    emit("decode_profile", kv_dtype="int8", window_ms=window_ms, device_busy_ms=busy_ms,
         idle_share=max(0.0, 1.0 - busy_ms / window_ms), kernels=n,
         paged_attention_ms=_share(by_name, "paged_attention_kernel"), top=_top(by_name, 12))


def phase_paged_times(pa, dev, B=16, H=12, D=64, L=2048):
    """paged_attention at [16, 12, 64] over 2,048-token histories and over
    PAGED_SHAPES[1]'s ragged lengths, f32, bf16 and int8 pages: kernel,
    plain and ``scaled_dot_product_attention`` over K/V already gathered
    to [B, H, L, D] in q's dtype with the length mask (the gather outside
    the timed region), beside the bound and the share of it reached."""
    import torch.nn.functional as F

    rows = {}
    ragged = next(lens for b, h, d, lens in PAGED_SHAPES if (b, h, d) == (B, H, D))
    for name, lens in (("full", [L] * B), ("ragged", ragged)):
        for mode, dt, kv_int8 in PAGED_MODES[:3]:
            args, kw = _paged_inputs(B, H, D, lens, dt, kv_int8, dev, seed=30)
            q, k, v, bt, sl = args
            fn = lambda: pa.paged_attention(*args, **kw)  # noqa: E731
            plain = lambda: pa.paged_attention_plain(*args, **kw)  # noqa: E731
            err = (fn().float() - plain().float()).abs().max().item()
            kd = pa.dequant_rows(k, kw["k_scales"], dt)[bt.long()].reshape(B, -1, H, D)
            vd = pa.dequant_rows(v, kw["v_scales"], dt)[bt.long()].reshape(B, -1, H, D)
            kd, vd = kd.transpose(1, 2).contiguous(), vd.transpose(1, 2).contiguous()
            keep = (torch.arange(kd.shape[2], device=dev)[None, :] < sl[:, None])[:, None, None, :]
            q4 = q[:, :, None, :]
            lib = time_ms(lambda: F.scaled_dot_product_attention(q4, kd, vd, attn_mask=keep), dev)
            del kd, vd
            bound_ms, bound_by = paged_bound(B, H, D, lens, dt, kv_int8)
            ms = time_ms(fn, dev)
            rows[(name, mode)] = dict(ms=ms, plain_ms=time_ms(plain, dev), library_ms=lib,
                                      bound_ms=bound_ms, bound_by=bound_by,
                                      share_of_bound=bound_ms / ms, max_abs_err=err)
            emit("paged_times", shape=[B, H, D], history=L if name == "full" else "ragged",
                 seq_lens=lens, page=PAGE, kv=mode, **rows[(name, mode)])
    return rows


def _image_batches(n_batches, batch, shape, classes, seed=0):
    """Images and one-hot labels as bench.py makes them (RandomState: rand
    images, randint labels), batch after batch from one stream."""
    rng = np.random.RandomState(seed)
    return [(rng.rand(batch, *shape).astype(np.float32),
             np.eye(classes, dtype=np.float32)[rng.randint(0, classes, batch)])
            for _ in range(n_batches)]


def _lenet_data(n_batches=1):
    """bench.py's LeNet batch, then more batches from the same stream."""
    return _image_batches(n_batches, LENET_BATCH, (28, 28, 1), 10)


def _trees_equal(a, b):
    """Every tensor of two nested dicts equal bit for bit (same keys)."""
    if isinstance(a, dict):
        return set(a) == set(b) and all(_trees_equal(a[k], b[k]) for k in a)
    if isinstance(a, torch.Tensor):
        return torch.equal(a, b)
    return a == b


def _step_ms(net, x, y, steps, warmup):
    """Median host ms of a fit step ending in a synchronize."""
    for _ in range(warmup):
        net.fit(x, y)
    torch.cuda.synchronize()
    ms = []
    for _ in range(steps):
        t0 = time.perf_counter()
        net.fit(x, y)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(ms), ms


def _grad_parity(net, twin, dispatch, x, y, tag):
    """gradient_for on both nets, `net` in auto mode and `twin` in
    reference mode: each tensor within 1e-4 * max|ref|; returns the worst
    relative difference."""
    g_auto = net.gradient_for(x, y)
    prev = dispatch.set_dispatch_mode("reference")
    try:
        g_ref = twin.gradient_for(x, y)
    finally:
        dispatch.set_dispatch_mode(prev)
    worst = 0.0
    for name, sub in g_ref.items():
        for k, r in sub.items():
            err = (g_auto[name][k] - r).abs().max().item()
            rmax = r.abs().max().item()
            require(err <= F32_RTOL * rmax,
                    f"{tag} gradient_for {name}.{k}: max|diff| {err} > {F32_RTOL} * {rmax}")
            worst = max(worst, err / max(rmax, 1e-30))
    return worst


def phase_lenet_train(matmul, dispatch, LeNet, Adam, MultiLayerNetwork, data, nn, dev):
    """MultiLayerNetwork training on the card (phase 31 of the module
    docstring).  Returns the main path's fused_dense launch count and the
    kernel's row at (256, 800, 500)."""
    import tempfile

    (xn, yn), = _lenet_data()
    x, y = torch.as_tensor(xn, device=dev), torch.as_tensor(yn, device=dev)
    net = LeNet(seed=123, updater=Adam(1e-3)).init_model(device=dev)
    require(net.num_params() == LENET_PARAMS,
            f"LeNet has {net.num_params()} parameters, want {LENET_PARAMS}")
    tmp = tempfile.mkdtemp(prefix="lenet_")
    net.save(os.path.join(tmp, "init.zip"))
    twin = MultiLayerNetwork.load(os.path.join(tmp, "init.zip"), device=dev)
    require(torch.equal(_flat_params(twin), _flat_params(net)),
            "the twin loaded from the initial zip differs")

    # gradient_for on the initial parameters, kernel against plain
    worst_grad = _grad_parity(net, twin, dispatch, x, y, "LeNet")

    # the main path: the count set to 0 just before, read just after
    theta0 = _flat_params(net)
    matmul.LAUNCHES.reset()
    losses, ms = _fit_steps(net, x, y, 1)
    theta1 = _flat_params(net)
    more, more_ms = _fit_steps(net, x, y, LENET_STEPS - 1)
    fit_launches = matmul.LAUNCHES.value
    net.score_for(x, y)
    out = net.output(x)
    launches = matmul.LAUNCHES.value
    losses, ms = losses + more, ms + more_ms
    require(fit_launches == LENET_STEPS and launches == LENET_STEPS + 2,
            f"fused_dense launches {fit_launches} in {LENET_STEPS} fit steps and "
            f"{launches} with score_for and output; want one a call")
    require(out.shape == (LENET_BATCH, 10) and bool(torch.isfinite(out).all()),
            f"LeNet output {tuple(out.shape)}")
    prev = dispatch.set_dispatch_mode("reference")
    try:
        ref_losses, _ = _fit_steps(twin, x, y, 1)
        ref_theta1 = _flat_params(twin)
        r_more, _ = _fit_steps(twin, x, y, LENET_STEPS - 1)
        ref_losses += r_more
    finally:
        dispatch.set_dispatch_mode(prev)
    rel = [abs(a - r) / abs(r) for a, r in zip(losses, ref_losses)]
    upd, ref_upd = theta1 - theta0, ref_theta1 - theta0
    update_l2 = ((upd - ref_upd).norm() / ref_upd.norm()).item()
    update_max = ((upd - ref_upd).abs().max() / ref_upd.abs().max()).item()
    final_rel = ((_flat_params(net) - _flat_params(twin)).norm()
                 / (_flat_params(twin) - theta0).norm()).item()
    require(all(math.isfinite(v) for v in losses + ref_losses), "non-finite LeNet loss")
    require(max(rel) <= F32_RTOL, f"LeNet losses {losses} vs reference {ref_losses}")
    require(update_l2 <= F32_RTOL,
            f"LeNet first Adam update differs from reference mode's by {update_l2} (L2)")

    # fit over an iterator: 4 batches, 2 epochs
    batches = _lenet_data(4)
    it0, before = net.iteration, matmul.LAUNCHES.value
    net.fit(data.ListDataSetIterator([data.DataSet(a, b) for a, b in batches]), epochs=2)
    iter_launches = matmul.LAUNCHES.value - before
    require(net.epoch == 2 and net.iteration == it0 + 8 and iter_launches == 8,
            f"fit(iterator, epochs=2): epoch {net.epoch}, iteration {net.iteration} "
            f"(from {it0}), {iter_launches} launches")
    iter_loss, iter_end = net.score(), net.iteration
    require(math.isfinite(iter_loss), "non-finite loss after fit(iterator)")

    # exact resume through the zip
    path = os.path.join(tmp, "lenet.zip")
    net.save(path)
    loaded = MultiLayerNetwork.load(path, device=dev)
    same_state = (_trees_equal(dict(net.params_), dict(loaded.params_))
                  and _trees_equal(net.state_, loaded.state_)
                  and _trees_equal(net.opt_state_, loaded.opt_state_)
                  and (loaded.iteration, loaded.epoch) == (net.iteration, net.epoch))
    require(same_state, "save/load on the card: params, state or Adam state differ")
    want = loaded.output(x)
    require(torch.equal(want, net.output(x)), "loaded output differs")
    cudnn_det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for _ in range(2):
            net.fit(x, y)
            loaded.fit(x, y)
        resumed = (torch.equal(_flat_params(net), _flat_params(loaded))
                   and net.score() == loaded.score())
    finally:
        torch.backends.cudnn.deterministic = cudnn_det
    require(resumed, "two steps after save/load differ from the original's")
    on_cpu = MultiLayerNetwork.load(path, device="cpu")
    want = want.cpu()
    got = on_cpu.output(xn)
    cpu_err = (got - want).abs().max().item()
    require(cpu_err <= F32_RTOL * want.abs().max().item(),
            f"load(device='cpu') output differs by {cpu_err}")

    drive = _drive_script(MultiLayerNetwork, nn, Adam, dev, tmp)

    # step times in each mode, samples/s; one step under the profiler
    step_ms, step_all = _step_ms(net, x, y, LENET_TIMED_STEPS, LENET_WARMUP)
    prev = dispatch.set_dispatch_mode("reference")
    try:
        ref_ms, ref_all = _step_ms(twin, x, y, LENET_TIMED_STEPS, LENET_WARMUP)
    finally:
        dispatch.set_dispatch_mode(prev)

    def step():
        net.fit(x, y)
        net.score()

    window_ms, busy_ms, by_name, n = _trace(step)
    profile = ({"window_ms": window_ms, "device_busy_ms": "not measured",
                "idle_share": "not measured"} if busy_ms is None else
               {"window_ms": window_ms, "device_busy_ms": busy_ms,
                "idle_share": max(0.0, 1.0 - busy_ms / window_ms), "kernels": n,
                "fused_dense_ms": _share(by_name, "fused_dense_kernel"),
                "top": _top(by_name, 10)})

    # the kernel at LeNet's shape
    M, (K, N) = LENET_BATCH, LENET_DENSE
    gen = torch.Generator(device=dev).manual_seed(2)
    xa = torch.randn(M, K, generator=gen, device=dev)
    wa = torch.randn(K, N, generator=gen, device=dev) / math.sqrt(K)
    ba = torch.randn(N, generator=gen, device=dev)
    ya = matmul.fused_dense(xa, wa, ba, "relu")
    err = (ya - matmul.fused_dense_reference(xa, wa, ba, "relu")).abs().max().item()
    bound_ms, bound_by = bound(M, K, N, torch.float32)
    row = dict(ms=time_ms(lambda: matmul.fused_dense(xa, wa, ba, "relu"), dev),
               plain_ms=time_ms(lambda: matmul.fused_dense_reference(xa, wa, ba, "relu"), dev),
               library_ms=time_ms(lambda: torch.relu(torch.addmm(ba, xa, wa)), dev),
               bound_ms=bound_ms, bound_by=bound_by, max_abs_err=err)
    row["share_of_bound"] = row["bound_ms"] / row["ms"]
    emit("lenet_train", model="LeNet", input="28x28x1 f32", classes=10,
         batch=LENET_BATCH, params=LENET_PARAMS, updater="Adam(1e-3)", steps=LENET_STEPS,
         losses=losses, reference_losses=ref_losses, rel_loss_diff=rel,
         step1_update_l2_rel_diff=update_l2, step1_update_max_rel_diff=update_max,
         final_params_l2_rel_diff=final_rel, max_rel_grad_diff=worst_grad,
         fused_dense_launches_fit=fit_launches, fused_dense_launches=launches,
         iterator={"batches": 4, "epochs": 2, "iteration": iter_end,
                   "launches": iter_launches, "loss": iter_loss},
         resume_bitwise=resumed, cpu_load_max_abs_err=cpu_err, drive_script=drive,
         step_ms=step_ms, step_ms_all=step_all, reference_step_ms=ref_ms,
         reference_step_ms_all=ref_all, samples_per_sec=LENET_BATCH * 1e3 / step_ms,
         reference_samples_per_sec=LENET_BATCH * 1e3 / ref_ms,
         profile=profile, fused_dense_256x800x500=row)
    return launches, row


def _drive_script(MultiLayerNetwork, nn, Adam, dev, tmp):
    """The end-to-end drive script on the card: a small MLN trained 50
    steps, saved and loaded."""
    rng = np.random.RandomState(1)
    x = rng.randn(256, 10).astype(np.float32)
    y = np.eye(2, dtype=np.float32)[(x.sum(1) > 0).astype(int)]
    conf = (nn.NeuralNetConfiguration.builder().seed(1).updater(Adam(1e-2))
            .list([nn.DenseLayer(n_out=32, activation="relu"),
                   nn.OutputLayer(n_out=2, loss="mcxent", activation="softmax")])
            .set_input_type(nn.InputType.feed_forward(10)).build())
    net = MultiLayerNetwork(conf, device=dev).init()
    before = net.score_for(x, y)
    for _ in range(50):
        net.fit(x, y)
    after = net.score_for(x, y)
    path = os.path.join(tmp, "drive.zip")
    net.save(path)
    loaded = MultiLayerNetwork.load(path, device=dev)
    equal = bool(np.array_equal(net.params(), loaded.params()))
    require(after < 0.5 * before, f"drive script: score {before} -> {after}")
    require(equal, "drive script: params differ after load")
    return {"score_before": before, "score_after": after, "params_equal_after_load": equal}


def _step_counts(matmul, conv3x3):
    return (matmul.LAUNCHES.value, conv3x3.WGRAD_LAUNCHES.value,
            conv3x3.DGRAD_LAUNCHES.value)


def _reset_counts(matmul, conv3x3):
    for c in (matmul.LAUNCHES, conv3x3.WGRAD_LAUNCHES, conv3x3.DGRAD_LAUNCHES):
        c.reset()


def _twin_of(net, MultiLayerNetwork, dev, tmp, tag):
    """A second net loaded from a zip of `net`'s initial parameters (the
    updater state is left out: at the start it is zeros, which `load`
    makes afresh), with its dropout generator in the same state, so both
    nets draw the same masks."""
    path = os.path.join(tmp, f"{tag}_init.zip")
    t0 = time.perf_counter()
    net.save(path, save_updater=False)
    save_s = time.perf_counter() - t0
    twin = MultiLayerNetwork.load(path, device=dev)
    require(torch.equal(_flat_params(twin), _flat_params(net)),
            f"{tag}: the twin loaded from the initial zip differs")
    require(torch.equal(twin._rng.get_state(), net._rng.get_state()),
            f"{tag}: the twin's dropout generator is in another state")
    return twin, path, save_s


def _main_steps(net, matmul, conv3x3, x, y, steps, per_step, tag):
    """The main path: `steps` fit steps, the counts set to 0 just before
    each and read just after, each equal to `per_step`.  Returns the
    losses, step ms, the parameters before and after the first step."""
    theta0 = _flat_params(net)
    losses, ms, theta1 = [], [], None
    for i in range(steps):
        _reset_counts(matmul, conv3x3)
        loss, t = _fit_steps(net, x, y, 1)
        got = _step_counts(matmul, conv3x3)
        require(got == per_step, f"{tag} step {i + 1}: launches (fused_dense, wgrad, "
                                 f"dgrad) {got}, want {per_step}")
        losses += loss
        ms += t
        if theta1 is None:
            theta1 = _flat_params(net)
    return losses, ms, theta0, theta1


def _reference_steps(twin, dispatch, x, y, steps):
    prev = dispatch.set_dispatch_mode("reference")
    try:
        losses, _ = _fit_steps(twin, x, y, 1)
        theta1 = _flat_params(twin)
        more, _ = _fit_steps(twin, x, y, steps - 1)
    finally:
        dispatch.set_dispatch_mode(prev)
    return losses + more, theta1


def _hold_losses(losses, ref_losses, rerun, tag):
    """Each loss within 1e-4 relative of reference mode's, or within
    DIVERGED_LOSS_RTOL once reference mode's loss has risen above its
    first (`rerun`: a second reference run's losses, or None)."""
    rel = [abs(a - r) / abs(r) for a, r in zip(losses, ref_losses)]
    require(all(math.isfinite(v) for v in losses + ref_losses), f"{tag}: non-finite loss")
    for i, (a, r) in enumerate(zip(rel, ref_losses)):
        tol = DIVERGED_LOSS_RTOL if r > ref_losses[0] else F32_RTOL
        require(a <= tol, f"{tag} step {i + 1} loss rel diff {a} > {tol} "
                          f"(losses {losses}, reference {ref_losses}, rerun {rerun})")
    return rel


def _rerun_if_diverged(ref_losses, init_zip, MultiLayerNetwork, dispatch, dev, x, y):
    """Where reference mode's loss rises above its first, a second
    reference run from the same zip: how far two runs of the same code
    part (relative to the first run's losses); None otherwise."""
    if max(ref_losses) <= ref_losses[0]:
        return None
    again = MultiLayerNetwork.load(init_zip, device=dev)
    losses, _ = _reference_steps(again, dispatch, x, y, len(ref_losses))
    del again
    return [abs(a - r) / abs(r) for a, r in zip(losses, ref_losses)]


def _syncs_per_step(net, x, y, steps=3, read_score=False):
    """Synchronizing CUDA calls a fit step (and a `score()` read after it,
    with `read_score`), counted by torch.cuda.set_sync_debug_mode("warn")
    over `steps` steps after one uncounted step (one-off work stays out),
    and their distinct messages."""
    import warnings
    net.fit(x, y)
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            for _ in range(steps):
                net.fit(x, y)
                if read_score:
                    net.score()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    # the mode's own one-off notice ("Synchronization debug mode is a
    # prototype feature ...") is not a synchronizing call
    msgs = [str(w.message) for w in caught if "synchroniz" in str(w.message)
            and "prototype feature" not in str(w.message)]
    return len(msgs) / steps, sorted(set(m[:160] for m in msgs))


class _ParamSnapshots:
    """Keeps a copy of the parameters at every `every`-th iteration (what a
    CheckpointListener with the same cadence has just saved)."""

    def __init__(self, every):
        self.every, self.kept = every, {}

    def iteration_done(self, model, iteration, epoch):
        if iteration % self.every == 0:
            self.kept[iteration] = {k: v.detach().clone()
                                    for k, v in model.state_dict().items()}


def _top2_margins(out):
    top = out.float().topk(2, dim=-1).values
    return (top[:, 0] - top[:, 1])


def phase_vgg16_train(matmul, conv3x3, dispatch, VGG16, Adam, MultiLayerNetwork, data,
                      train, dev, image=224, classes=1000, batch=VGG_BATCH,
                      expect_params=VGG16_PARAMS):
    """VGG16 training and evaluation through MultiLayerNetwork (phase 32 of
    the module docstring).  Returns the launches of the main path's steps
    and the kernels' rows at VGG16's largest training shapes."""
    import logging
    import shutil
    import tempfile

    logging.getLogger("deeplearning4j_tpu_torch").setLevel(logging.WARNING)
    shape = (image, image, 3)
    (xn, yn), = _image_batches(1, batch, shape, classes)
    x, y = torch.as_tensor(xn, device=dev), torch.as_tensor(yn, device=dev)
    net = VGG16(n_classes=classes, input_shape=shape, seed=123,
                updater=Adam(1e-3)).init_model(device=dev)
    require(expect_params is None or net.num_params() == expect_params,
            f"VGG16 has {net.num_params()} parameters, want {expect_params}")
    tmp = tempfile.mkdtemp(prefix="vgg16_")
    try:
        twin, init_zip, init_save_s = _twin_of(net, MultiLayerNetwork, dev, tmp, "vgg16")
        worst_grad = _grad_parity(net, twin, dispatch, x, y, "VGG16")

        # the main path: fit steps with dropout on, counts per step
        torch.cuda.reset_peak_memory_stats()
        losses, ms, theta0, theta1 = _main_steps(net, matmul, conv3x3, x, y, VGG_STEPS,
                                                 VGG_STEP_LAUNCHES, "VGG16")
        ref_losses, ref_theta1 = _reference_steps(twin, dispatch, x, y, VGG_STEPS)
        upd, ref_upd = theta1 - theta0, ref_theta1 - theta0
        update_l2 = ((upd - ref_upd).norm() / ref_upd.norm()).item()
        update_max = ((upd - ref_upd).abs().max() / ref_upd.abs().max()).item()
        del theta0, theta1, ref_theta1, upd, ref_upd
        rerun = _rerun_if_diverged(ref_losses, init_zip, MultiLayerNetwork, dispatch,
                                   dev, x, y)
        rel = _hold_losses(losses, ref_losses, rerun, "VGG16")
        require(update_l2 <= F32_RTOL,
                f"VGG16 first Adam update differs from reference mode's by {update_l2} (L2)")

        # fit over an iterator with the listeners of the path; the twin
        # hears the same listeners but the checkpoints
        ck_dir = os.path.join(tmp, "checkpoints")
        ck = train.CheckpointListener(ck_dir, every_n_iterations=2, keep_last=1)
        snaps = _ParamSnapshots(2)
        collect, perf = train.CollectScoresListener(1), train.PerformanceListener(1)
        net.set_listeners(train.ScoreIterationListener(1), collect, perf, ck, snaps)
        t_collect, t_perf = train.CollectScoresListener(1), train.PerformanceListener(1)
        twin.set_listeners(train.ScoreIterationListener(1), t_collect, t_perf)
        batches = _image_batches(VGG_ITER_BATCHES, batch, shape, classes, seed=1)
        it0, ep0 = net.iteration, net.epoch
        _reset_counts(matmul, conv3x3)
        t0 = time.perf_counter()
        net.fit(data.ListDataSetIterator([data.DataSet(a, b) for a, b in batches]), epochs=1)
        iter_s = time.perf_counter() - t0
        iter_launches = _step_counts(matmul, conv3x3)
        require(iter_launches == tuple(VGG_ITER_BATCHES * n for n in VGG_STEP_LAUNCHES),
                f"VGG16 fit(iterator): launches {iter_launches}")
        require((net.epoch, net.iteration) == (ep0 + 1, it0 + VGG_ITER_BATCHES),
                f"VGG16 fit(iterator): epoch {net.epoch}, iteration {net.iteration} "
                f"(from {ep0}, {it0})")
        prev = dispatch.set_dispatch_mode("reference")
        try:
            twin.fit(data.ListDataSetIterator([data.DataSet(a, b) for a, b in batches]),
                     epochs=1)
        finally:
            dispatch.set_dispatch_mode(prev)
        scores, t_scores = collect.scores, t_collect.scores
        require(collect.iterations == t_collect.iterations
                == list(range(it0 + 1, it0 + VGG_ITER_BATCHES + 1)),
                f"VGG16 CollectScoresListener iterations {collect.iterations}")
        score_rel = _hold_losses(scores, t_scores, None, "VGG16 CollectScoresListener")
        require(perf.last_samples_per_sec is not None and perf.last_samples_per_sec > 0,
                "VGG16 PerformanceListener reported no samples/s")
        kept = sorted(os.listdir(ck_dir))
        last_it = it0 + VGG_ITER_BATCHES - (it0 + VGG_ITER_BATCHES) % 2
        require(kept == [f"checkpoint_iter_{last_it}.zip"]
                and ck.last_checkpoint() == os.path.join(ck_dir, kept[0]),
                f"VGG16 CheckpointListener kept {kept}")
        t0 = time.perf_counter()
        loaded = MultiLayerNetwork.load(ck.last_checkpoint(), device=dev)
        load_s = time.perf_counter() - t0
        require(loaded.iteration == last_it
                and _trees_equal(dict(loaded.state_dict()), snaps.kept[last_it]),
                "VGG16 checkpoint does not load bitwise into the saved parameters")
        del loaded, snaps
        net.set_listeners()
        twin.set_listeners()

        # evaluate over 2 batches: output + Evaluation, and the twin
        ev_batches = _image_batches(VGG_EVAL_BATCHES, batch, shape, classes, seed=2)
        ev_iter = data.ListDataSetIterator([data.DataSet(a, b) for a, b in ev_batches])
        _reset_counts(matmul, conv3x3)
        ev = net.evaluate(ev_iter)
        ev_launches = _step_counts(matmul, conv3x3)
        require(ev_launches == (2 * VGG_EVAL_BATCHES, 0, 0),
                f"VGG16 evaluate launches {ev_launches}")
        prev = dispatch.set_dispatch_mode("reference")
        try:
            t_ev = twin.evaluate(ev_iter)
            t_outs = [twin.output(a) for a, _ in ev_batches]
        finally:
            dispatch.set_dispatch_mode(prev)
        outs = [net.output(a) for a, _ in ev_batches]
        by_output, t_by_output = train.Evaluation(), train.Evaluation()
        clear, t_clear = train.Evaluation(num_classes=classes), \
            train.Evaluation(num_classes=classes)
        near_ties = 0
        for (_, b), o, t in zip(ev_batches, outs, t_outs):
            by_output.eval(b, o)
            t_by_output.eval(b, t)
            tol = F32_RTOL * max(o.abs().max().item(), t.abs().max().item())
            keep = ((_top2_margins(o) >= tol) & (_top2_margins(t) >= tol)).cpu().numpy()
            near_ties += int((~keep).sum())
            clear.eval(b[keep], o[torch.as_tensor(keep, device=dev)])
            t_clear.eval(b[keep], t[torch.as_tensor(keep, device=dev)])
        require(np.array_equal(ev.confusion, by_output.confusion),
                "VGG16 evaluate differs from output + Evaluation")
        require(np.array_equal(t_ev.confusion, t_by_output.confusion),
                "VGG16 twin's evaluate differs from its output + Evaluation")
        require(np.array_equal(clear.confusion, t_clear.confusion),
                "VGG16 evaluate differs from reference mode's away from near ties")
        flips = int((ev.confusion != t_ev.confusion).sum())
        stats_lines = ev.stats().splitlines()
        del outs, t_outs

        # synchronizing calls a step (the nets part
        # here): listeners (logger muted) against none
        syncs_bare, sync_msgs = _syncs_per_step(net, x, y)
        net.set_listeners(train.ScoreIterationListener(1), train.CollectScoresListener(1),
                          train.PerformanceListener(1))
        syncs_listeners, listener_msgs = _syncs_per_step(net, x, y)
        net.set_listeners()
        require(syncs_listeners == syncs_bare,
                f"VGG16 listeners add synchronizing calls: {syncs_listeners} a step "
                f"({listener_msgs}) against {syncs_bare} ({sync_msgs})")
        # the count sees a sync where there is one: the loss read back
        syncs_read, read_msgs = _syncs_per_step(net, x, y, read_score=True)
        require(syncs_read >= syncs_bare + 1,
                f"VGG16 sync count saw {syncs_read} a step with score() read back")

        # step times in each mode, samples/s, peak memory; one profiled step
        torch.cuda.reset_peak_memory_stats()
        step_ms, step_all = _step_ms(net, x, y, VGG_TIMED_STEPS, VGG_WARMUP)
        peak = torch.cuda.max_memory_allocated()
        prev = dispatch.set_dispatch_mode("reference")
        try:
            torch.cuda.reset_peak_memory_stats()
            ref_ms, ref_all = _step_ms(twin, x, y, VGG_TIMED_STEPS, VGG_WARMUP)
            ref_peak = torch.cuda.max_memory_allocated()
        finally:
            dispatch.set_dispatch_mode(prev)
        del twin

        def step():
            net.fit(x, y)
            net.score()

        window_ms, busy_ms, by_name, n = _trace(step)
        profile = ({"window_ms": window_ms, "device_busy_ms": "not measured",
                    "idle_share": "not measured"} if busy_ms is None else
                   {"window_ms": window_ms, "device_busy_ms": busy_ms,
                    "idle_share": max(0.0, 1.0 - busy_ms / window_ms), "kernels": n,
                    "fused_dense_ms": _share(by_name, "fused_dense_kernel"),
                    "conv3x3_wgrad_ms": _share(by_name, "conv3x3_wgrad"),
                    "conv3x3_dgrad_ms": _share(by_name, "conv3x3_dgrad"),
                    "top": _top(by_name, 15)})
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    del net
    rows = _vgg_kernel_rows(matmul, conv3x3, dev, batch, image)
    emit("vgg16_train", model="VGG16", input=f"{image}x{image}x3 f32", classes=classes,
         batch=batch, params=expect_params, updater="Adam(1e-3)", steps=VGG_STEPS,
         losses=losses, reference_losses=ref_losses, rel_loss_diff=rel,
         reference_rerun_rel_loss_diff=rerun,
         step1_update_l2_rel_diff=update_l2, step1_update_max_rel_diff=update_max,
         max_rel_grad_diff=worst_grad,
         launches_per_step=dict(zip(("fused_dense", "conv3x3_wgrad", "conv3x3_dgrad"),
                                    VGG_STEP_LAUNCHES)),
         iterator={"batches": VGG_ITER_BATCHES, "epoch": ep0 + 1,
                   "iteration": it0 + VGG_ITER_BATCHES, "launches": iter_launches,
                   "seconds": iter_s, "scores": scores, "reference_scores": t_scores,
                   "rel_score_diff": score_rel,
                   "samples_per_sec": perf.last_samples_per_sec,
                   "checkpoint": kept[0], "checkpoint_load_s": load_s,
                   "init_zip_save_s": init_save_s},
         syncs_per_step={"listeners": syncs_listeners, "none": syncs_bare,
                         "calls": sync_msgs, "with_score_read": syncs_read,
                         "score_read_calls": read_msgs},
         evaluate={"batches": VGG_EVAL_BATCHES, "launches": ev_launches,
                   "accuracy": ev.accuracy(), "reference_accuracy": t_ev.accuracy(),
                   "near_tie_rows": near_ties, "confusion_cells_differing": flips,
                   "stats_head": stats_lines[:6]},
         step_ms=step_ms, step_ms_all=step_all, reference_step_ms=ref_ms,
         reference_step_ms_all=ref_all, samples_per_sec=batch * 1e3 / step_ms,
         reference_samples_per_sec=batch * 1e3 / ref_ms,
         max_memory_allocated_gb=peak / 1e9, reference_max_memory_allocated_gb=ref_peak / 1e9,
         profile=profile, kernels_at_largest_shape=rows)
    return VGG_STEP_LAUNCHES, rows


def _vgg_kernel_rows(matmul, conv3x3, dev, batch=VGG_BATCH, image=224):
    """fused_dense at fc6 (32, 25088, 4096) and the conv pair at the first
    block's 32x224x224, Ci = Co = 64, f32: kernel, plain and library ms
    (``torch.addmm`` + relu; cuDNN's ``conv2d_weight`` / ``conv2d_input``)
    beside the bound."""
    from deeplearning4j_tpu_torch.ops import conv_kernels as ck
    rows = {}
    M, N = batch, VGG_DENSE["fc6"][1]
    K = (image // 32) ** 2 * 512
    gen = torch.Generator(device=dev).manual_seed(3)
    xa = torch.randn(M, K, generator=gen, device=dev)
    wa = torch.randn(K, N, generator=gen, device=dev) / math.sqrt(K)
    ba = torch.randn(N, generator=gen, device=dev)
    err = (matmul.fused_dense(xa, wa, ba, "relu")
           - matmul.fused_dense_reference(xa, wa, ba, "relu")).abs().max().item()
    bound_ms, bound_by = bound(M, K, N, torch.float32)
    ms = time_ms(lambda: matmul.fused_dense(xa, wa, ba, "relu"), dev)
    rows["fused_dense"] = dict(
        shape=f"M={M} K={K} N={N} f32 relu", ms=ms,
        plain_ms=time_ms(lambda: matmul.fused_dense_reference(xa, wa, ba, "relu"), dev),
        library_ms=time_ms(lambda: torch.relu(torch.addmm(ba, xa, wa)), dev),
        bound_ms=bound_ms, bound_by=bound_by, share_of_bound=bound_ms / ms,
        max_abs_err=err)
    del xa, wa
    shape = (batch, image, image, 64, 64)
    B, H, W, Ci, Co = shape
    x, dy, w = _conv_inputs(shape, torch.float32, dev, seed=4)
    xc, dyc = x.permute(0, 3, 1, 2), dy.permute(0, 3, 1, 2)
    for name, fn, plain, lib in (
            ("conv3x3_wgrad", lambda: ck.conv3x3_wgrad(x, dy),
             lambda: ck.conv3x3_wgrad_reference(x, dy),
             lambda: torch.nn.grad.conv2d_weight(xc, w.shape, dyc, padding=1)),
            ("conv3x3_dgrad", lambda: ck.conv3x3_dgrad(dy, w),
             lambda: ck.conv3x3_dgrad_reference(dy, w),
             lambda: torch.nn.grad.conv2d_input(xc.shape, w, dyc, padding=1))):
        err = (fn() - plain()).abs().max().item()
        route = conv3x3.ROUTES[torch.float32]
        bound_ms, bound_by = conv_bound(name, B, H, W, Ci, Co, torch.float32, route)
        ms = time_ms(fn, dev)
        rows[name] = dict(
            shape=f"B={B} {H}x{W} Ci={Ci} Co={Co} f32", ms=ms,
            plain_ms=time_ms(plain, dev), library_ms=time_ms(lib, dev), route=route,
            bound_ms=bound_ms, bound_by=bound_by, share_of_bound=bound_ms / ms,
            simt_bound_ms=conv_bound(name, B, H, W, Ci, Co, torch.float32, "simt")[0],
            max_abs_err=err)
    return rows


def phase_zoo_train(matmul, conv3x3, dispatch, zoo, MultiLayerNetwork, dev,
                    models=ZOO_TRAIN, batch=VGG_BATCH):
    """SimpleCNN, AlexNet and Darknet19 training on the card (phase 33 of
    the module docstring).  Returns each model's launches per step."""
    import shutil
    import tempfile

    out = {}
    tmp = tempfile.mkdtemp(prefix="zoo_")
    try:
        for name, (shape, classes, per_step) in models.items():
            (xn, yn), = _image_batches(1, batch, shape, classes)
            x, y = torch.as_tensor(xn, device=dev), torch.as_tensor(yn, device=dev)
            net = getattr(zoo, name)(n_classes=classes, input_shape=shape,
                                     seed=123).init_model(device=dev)
            twin, init_zip, _ = _twin_of(net, MultiLayerNetwork, dev, tmp, name)
            worst_grad = _grad_parity(net, twin, dispatch, x, y, name)
            losses, ms, theta0, theta1 = _main_steps(net, matmul, conv3x3, x, y,
                                                     ZOO_STEPS, per_step, name)
            ref_losses, ref_theta1 = _reference_steps(twin, dispatch, x, y, ZOO_STEPS)
            upd, ref_upd = theta1 - theta0, ref_theta1 - theta0
            update_l2 = ((upd - ref_upd).norm() / ref_upd.norm()).item()
            del twin, theta0, theta1, ref_theta1, upd, ref_upd
            rerun = _rerun_if_diverged(ref_losses, init_zip, MultiLayerNetwork, dispatch,
                                       dev, x, y)
            rel = _hold_losses(losses, ref_losses, rerun, name)
            out[name] = {"input": "x".join(map(str, shape)), "classes": classes,
                         "batch": batch, "params": net.num_params(),
                         "updater": type(net.conf.updater).__name__,
                         "launches_per_step": dict(zip(
                             ("fused_dense", "conv3x3_wgrad", "conv3x3_dgrad"), per_step)),
                         "max_rel_grad_diff": worst_grad, "losses": losses,
                         "reference_losses": ref_losses, "rel_loss_diff": rel,
                         "reference_rerun_rel_loss_diff": rerun,
                         "step1_update_l2_rel_diff": update_l2, "step_ms_all": ms}
            del net
            emit("zoo_train", model=name, **out[name])
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return out


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from deeplearning4j_tpu_torch.ops import attention_kernels as ak
    from deeplearning4j_tpu_torch.ops import conv_kernels as ck
    from deeplearning4j_tpu_torch.ops import norm_kernels as nk
    from deeplearning4j_tpu_torch import quant
    from deeplearning4j_tpu_torch.ops import quant_kernels as qk
    from deeplearning4j_tpu_torch.ops.kernels import (attention, build, conv3x3, dispatch,
                                                      layer_norm, matmul)
    from deeplearning4j_tpu_torch.ops.kernels import paged_attention as pa
    from deeplearning4j_tpu_torch.serving import decode as dec
    from deeplearning4j_tpu_torch import data, nn, train, zoo
    from deeplearning4j_tpu_torch.data import MultiDataSet
    from deeplearning4j_tpu_torch.nlp import BertIterator, BertWordPieceTokenizer
    from deeplearning4j_tpu_torch.nn import MultiLayerNetwork
    from deeplearning4j_tpu_torch.serving import ModelServer
    from deeplearning4j_tpu_torch.train import Adam, Nesterovs
    from deeplearning4j_tpu_torch.zoo import BertConfig, BertModel, LeNet, ResNet50, VGG16

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
    lenet_launches, lenet_row = phase_lenet_train(matmul, dispatch, LeNet, Adam,
                                                  MultiLayerNetwork, data, nn, dev)
    vgg_launches, vgg_rows = phase_vgg16_train(matmul, conv3x3, dispatch, VGG16, Adam,
                                               MultiLayerNetwork, data, train, dev)
    zoo_res = phase_zoo_train(matmul, conv3x3, dispatch, zoo, MultiLayerNetwork, dev)
    phase_conv_parity(ck, conv3x3, dev)
    net, x, y, conv_launches = phase_train(conv3x3, dispatch, ResNet50,
                                           Nesterovs, dev)
    phase_train_profile(net, x, y)
    del net
    net = phase_train_bf16(conv3x3, ResNet50, Nesterovs, dev, x, y)
    phase_train_profile(net, x, y, phase="train_bf16_profile", compute_dtype="bfloat16")
    del net, x, y
    conv_rows = phase_conv_times(ck, conv3x3, dev)
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
    long_model, long_mds = phase_bert_train_long(BertModel, BertConfig, Adam, MultiDataSet,
                                                 attention, layer_norm, dev)
    phase_bert_train_profile(long_model, long_mds, "bert_train_long_profile", batch=4, t=2048)
    del long_model, long_mds
    attn_bwd_rows = phase_attn_bwd_times(ak, attention, dev)
    ln_bwd_rows = phase_ln_bwd_times(nk, layer_norm, dev)
    phase_qmm_parity(matmul, qk, dev)
    quant_res, qmodels, x16 = phase_quant_slice(matmul, dispatch, ModelServer, quant, dev)
    phase_quant_profile(qmodels, x16)
    del qmodels, x16
    qmm_rows = phase_qmm_times(matmul, qk, dev)
    phase_paged_parity(pa, dev)
    decode_res = phase_decode(dec, pa, dispatch, dev, DECODE_SMALL, "decode")
    phase_decode(dec, pa, dispatch, dev, DECODE_WIDE, "decode_wide")
    phase_decode_profile(dec, dev)
    paged_rows = phase_paged_times(pa, dev)

    emit("done", seconds=time.monotonic() - t_start)
    main_row = rows[("fc6", torch.float32)]
    kernels = [{
        "name": "fused_dense", "route": "cuda", "source": SOURCE,
        "replaces": REPLACES, "launches": launches,
        "max_abs_err": main_row["max_abs_err"], "ms": main_row["ms"],
        "plain_ms": main_row["plain_ms"], "bound_ms": main_row["bound_ms"],
        "bound_by": main_row["bound_by"],
        "library_ms": main_row["library_ms"],
        "shape": "fc6 M=16 K=25088 N=4096 f32 relu; launches over the VGG16 "
                 "serving slice's warmup and 12 requests",
        "lenet_train": {"launches": lenet_launches, **lenet_row,
                        "shape": "M=256 K=800 N=500 f32 relu; launches over 5 LeNet "
                                 "fit steps, one score_for and one output"},
        "vgg16_train": {"launches": vgg_launches[0] * VGG_STEPS, **vgg_rows["fused_dense"],
                        "shape": vgg_rows["fused_dense"]["shape"] + "; launches over "
                                 f"{VGG_STEPS} VGG16 fit steps at batch {VGG_BATCH}"},
        "zoo_train": {m: r["launches_per_step"]["fused_dense"] * ZOO_STEPS
                      for m, r in zoo_res.items()}}]
    for name, (replaces, source) in CONV_KERNELS.items():
        row = conv_rows[(name, "s0", torch.float32)]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": conv_launches,
            "max_abs_err": row["max_abs_err"], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
            "product": row["route"], "simt_bound_ms": row["simt_bound_ms"],
            "shape": "ResNet-50 s0 B=64 56x56 Ci=Co=64 f32; launches over "
                     "3 fit steps",
            "vgg16_train": {"launches": vgg_launches[1 if name == "conv3x3_wgrad" else 2]
                            * VGG_STEPS, **vgg_rows[name],
                            "shape": vgg_rows[name]["shape"] + "; launches over "
                                     f"{VGG_STEPS} VGG16 fit steps at batch {VGG_BATCH}"},
            "zoo_train": {m: r["launches_per_step"][name] * ZOO_STEPS
                          for m, r in zoo_res.items()}})
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
            **({"product": row["route"], "share_of_bound": row["share_of_bound"],
                "simt_bound_ms": row["simt_bound_ms"]} if "route" in row else {}),
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
            **({"product": row["route"], "simt_bound_ms": row["simt_bound_ms"]}
               if "route" in row else {}),
            "shape": shape + "; launches in one f32 MLM fit_batch step at batch 64, T 128"
                     + ("; plain and library compute dq, dk and dv together"
                        if name.startswith("flash") else "")})
    versions = quant_res["versions"]
    for name, row, n_launched, shape in (
            ("q_matmul", qmm_rows[("q_matmul", "fc6", torch.float32)],
             versions["weight_only"]["launches"]["q_matmul"],
             "fc6 M=16 K=25088 N=4096 f32 with bias; launches over the weight-only int8 "
             "VGG16 version's warmup and 12 requests"),
            ("int8_matmul", qmm_rows[("int8_matmul", "fc6")],
             versions["static"]["launches"]["int8_matmul"],
             "fc6 M=16 K=25088 N=4096 int8 -> f32 with x_scale and bias; launches over the "
             "static-activation VGG16 version's warmup and 12 requests; library: "
             "torch._int_mm, x padded to 32 rows, int32 product only")):
        replaces, source = QMM_KERNELS[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": n_launched, "max_abs_err": row["max_abs_err"], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"], "shape": shape})
    row = paged_rows[("full", "int8")]
    kernels.append({
        "name": "paged_attention", "route": "cuda", "source": PAGED_KERNEL[1],
        "replaces": PAGED_KERNEL[0], "launches": decode_res["int8"]["launches"],
        "max_abs_err": row["max_abs_err"], "ms": row["ms"], "plain_ms": row["plain_ms"],
        "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
        "library_ms": row["library_ms"],
        "shape": "[16,12,64] over 2,048-token histories, int8 pages; launches over the "
                 "decode phase's int8-KV flood (48 prompts, bench.py's configuration)"})
    for k in kernels:
        k["share_of_bound"] = k["bound_ms"] / k["ms"]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
