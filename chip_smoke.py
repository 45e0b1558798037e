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
   calls from the same start, losses within 1e-6 relative, and 6 x the
   launch counts counted at its first call (the warm-up body and the 5
   captured bodies of its CUDA graph; a replay ticks no Python count).
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

34. fused_resnet50 — bench.py's fused configuration: full-width ResNet-50,
   batch 64, Nesterovs(0.1, 0.9), bf16 compute then f32.  Two
   ``fit_steps`` blocks of k = 5 on ``broadcast_to(x, (5,) + x.shape)`` (as
   ``_time_train`` builds them), each one CUDA-graph replay, against a twin
   loaded from the same initial ``state_dict`` that runs ``fit(x, y)`` 10
   times eagerly in the same dispatch mode, and a second eager twin (the
   noise yardstick): the 10 losses held as phase 7 holds them (1e-4
   relative, 1e-3 in bf16, ``DIVERGED_LOSS_RTOL`` once the loss has risen
   above the first step's), and the first step's update of a third net
   that takes a k = 1 block, within 1e-4 of its size (1e-3 in bf16).
   The f32 runs take cuDNN's deterministic algorithms (its default
   backward of the 1x1 and 7x7 convs is not bitwise repeatable, and ten
   diverging steps amplify that past any bound).
   Exactly one capture for the shape, one dispatch a block.  The timed and
   traced graphs are the port's own ``torch.cuda.CUDAGraph``s; three
   replays under ``torch.profiler`` show each hand-written kernel run and
   none run more than it should (the profiler loses some kernel records
   of graph replays).  A second capture of the same block, made apart as
   a debug-mode graph that keeps its nodes, holds exactly 5 x 16
   ``conv3x3_wgrad`` and 5 x 16 ``conv3x3_dgrad`` kernel nodes and 5
   times an eager step's ``fused_dense`` launches (read from its DOT
   dump); a block captured in ``reference`` mode (a capture of its own)
   launches none of them in its trace, and its capture none at all.
   Step ms of the graph (the median block after the first, over 5) and
   eager (the median step after the first), samples/s, device busy and
   idle share of one block, capture seconds and peak memory.
35. fused_lenet — LeNet at bench.py's batch 256 with ``fused_steps=10``
   and Adam on a ``StepSchedule`` whose steps fall inside the first block:
   23 batches of an ``ArrayDataSetIterator`` from a seed through
   ``DevicePrefetchIterator(depth=2)`` with a fitted
   ``NormalizerStandardize`` set by ``set_normalizer`` (2 graph blocks and
   3 tail steps), against an eager twin fed the same batches with the host
   normalizer as its pre-processor: the losses the listeners see and the
   parameters within 1e-4 relative (the phase takes cuDNN's deterministic
   algorithms: Adam turns the default 5x5 conv backward's noise in
   near-zero gradients into whole steps).  The pipeline counters equal the
   batches staged and their bytes.  A second epoch of 2 blocks under
   ``torch.cuda.set_sync_debug_mode("warn")`` makes 0 synchronizing calls
   (``score()`` after it is the positive control).  The graph's kernel
   nodes hold 10 times an eager step's ``fused_dense`` (the profiler's
   count of three replays may fall short, never over).  Step ms of the
   graph and eager (an epoch of 20 batches each, and the median of 5
   replays of a staged block against 10 eager steps), idle share of one
   block and the prefetch wait.  The Python ``fused_dense`` count over the
   first epoch is 1 (the warm-up body) + 10 (the captured bodies) + 3 (the
   tail steps): replays do not tick it.
36. fused_dropout — a small MLN with dropout 0.5 and lr 0, the same batch
   at every step, one graph block of k = 4: where this PyTorch has
   ``CUDAGraph.register_generator_state`` the four losses are not all
   equal (fresh masks each step), and whether they equal an eager twin's
   drawn from the same generator state is reported; where it has not,
   the graph path must raise for this network.  The line says which was
   checked.
37. fused_bert — bench.py's fused BERT blocks (``bench.py:208-248``):
   BERT-base (110,106,428 parameters, vocab 30,522) in bf16 compute with
   f32 master parameters, Adam(1e-4), masked LM, ``fit_steps`` on a
   stride-0 block of k = 5 copies of bench.py's batch, at batch 64, T =
   128 and at batch 4, T = 2048.  Two replayed blocks against an eager
   twin from the same initial ``state_dict`` that runs ``fit_batch`` 10
   times: the 10 losses, every parameter and every Adam tensor equal bit
   for bit.  Exactly one capture for the shape; each later block is one
   ``replay()`` (counted on the graph) and ticks no Python launch count
   (the first block's count is the warm-up body and the 5 captured
   bodies).  A second capture of the block, made apart as a debug-mode
   graph, holds exactly 5 x (12 flash forward, 12 dQ, 12 dK/dV, 26
   LayerNorm forward, 26 LayerNorm backward) kernel nodes; three replays
   under ``torch.profiler`` show each kernel, none more than that; a
   block captured in ``reference`` mode holds none of those nodes and
   counts none.  Graph ms per step (the median of 3 timed blocks over
   k) and eager ms per step (the median step after the first), tokens/s
   of each, device busy and idle share of one replayed block, capture
   seconds and peak memory.  At T = 128 also ``fit(list of 11 MLM
   batches, fused_steps=5)``: its losses (two blocks, then one tail
   step) and parameters equal those of the same batches through
   ``fit_steps`` twice and ``fit_batch`` once, bit for bit, with one
   capture.
38. zoo_graphs — SqueezeNet v1.1 (224x224x3, 1000 classes, batch 32,
   Adam(1e-3), dropout 0.5) and U-Net at ``UNet.java``'s width (64 base
   filters, 512x512x3, one sigmoid class, batch 4) at seed 123, f32, each
   against a twin loaded from its initial zip in ``reference`` mode (the
   same dropout generator state): ``gradient_for`` per tensor within 1e-4
   * max|ref|, two ``fit`` steps with the launches exact a step
   (``ZOO_GRAPHS``: one wgrad per stride-1 3x3 conv, one dgrad per such
   conv whose input needs a gradient; SqueezeNet's stride-2 stem goes to
   cuDNN) and the losses held as in phase 32; step ms and peak memory.
39. records_train — DL4J's CSV path: a 4,096-row CSV (784 feature
   columns, a string class column of 10 classes, from numpy seed 0)
   written to a temporary directory, read by ``CSVRecordReader``, a
   ``TransformProcess`` that maps the class to an integer,
   ``RecordReaderDataSetIterator`` (batch 256) and a fitted
   ``NormalizerStandardize`` as its pre-processor, trains an MLN of Dense
   784 -> 500 relu and Output 500 -> 10 softmax (mcxent), Adam(1e-3),
   seed 123, through ``fit(iterator)`` for one epoch; a twin from the
   same initial ``state_dict`` trains over the same iterator in
   ``reference`` mode: each of the 16 losses within 1e-4 relative, and
   exactly one ``fused_dense`` launch a step (the relu Dense; the softmax
   head is plain).  Seconds of the CSV write, of one pass of the reader
   pipeline, and of the epoch.
40. charlm — bench.py's LSTM char-LM block (``bench.py:404-417``):
   ``TextGenLSTM(n_classes=77, input_shape=(64, 77))`` (two LSTM(256), a
   77-way RnnOutputLayer, Adam(1e-3), seed 123), f32, TF32 off, batch 64
   of ``RandomState(0)`` ids one-hot, labels the ids rolled by one step.
   ``fit_steps`` on a stride-0 block of k = 5 (as ``_time_train`` builds
   it): two blocks against an eager twin from the same initial
   ``state_dict`` that runs ``fit`` 10 times (losses and parameters equal
   bit for bit; the twin's losses within 1e-4 relative of a
   ``reference``-mode twin's: no kernel runs on this path), one capture,
   one ``replay()`` a block; then 3 timed blocks, one under
   ``torch.profiler`` (busy time, idle share), and the kernel nodes of a
   debug-mode capture of the block (its DOT dump).  A masked step at T =
   40, features and labels masks cutting half the rows to 20 steps,
   holds reference mode's loss within 1e-4.  Graph and eager ms a step,
   tokens/s as bench.py counts them (batch * T a step), capture seconds,
   peak memory.
41. seq_attention — the attention layers' kernels on a sequence net: an
   MLN of LSTM(256), ``SelfAttentionLayer(n_out=256, n_heads=4)`` (head
   size 64), ``GlobalPoolingLayer(AVG)`` and ``OutputLayer(10)``, one-hot
   inputs (vocab 77, T = 128, batch 64), a features mask that drops the
   last 32 steps of half the rows, as f32 and as int32.  Two eager ``fit``
   steps (one a mask dtype) with the counts set to 0 just before each:
   exactly one flash forward, one dQ and one dK/dV launch a step (derived
   from the configuration: one a projected attention layer) and no
   ``fused_dense`` (the head's loss and the LSTM are plain); each loss
   within 1e-4 relative of a ``reference``-mode twin's.  Then a
   ``fit_steps`` block of 3 with the f32 mask: its losses equal an eager
   twin's bit for bit and hold reference mode's, and a debug-mode capture
   of the block holds 3 + 3 + 3 flash kernel nodes.  Also one forward of
   ``LearnedSelfAttentionLayer(n_queries=4, n_heads=4)`` on the LSTM's
   output (T = 4 queries over S = 128) with the int32 mask: one forward
   launch, within 1e-4 * max|ref| of reference mode's.
42. sd_tf_bert — BASELINE config 3 as bench.py runs it
   (``bench.py:294-400``): ``bert_graph_def`` writes the frozen GraphDef of
   ``build_tf_bert_frozen`` at batch 32, T = 128, 12 layers, hidden 768, 12
   heads, vocab 30,522 (1,027 nodes, weights from ``RandomState(0)`` in
   bench.py's order) through the port's protobuf encoder, with no
   TensorFlow; ``modelimport.import_graph_def(bytes, device="cuda")``
   imports it.  The encoder output equals ``bert_plain_forward`` (the same
   function written out in plain PyTorch on the same weights, f32, TF32
   off) within 1e-4 * max|ref|.  bench.py's head (``head_w`` XAVIER,
   ``matmul``, ``sparse_softmax_cross_entropy``, Adam(1e-4)): the first
   step's loss within 1e-5 relative of an independent autograd-plus-Adam
   step on the plain forward, ``head_w`` after it within 1e-5 *
   max|head_w|.  Timed as bench.py times it: 2 warm-up and 5 timed ``fit``
   steps synced by ``score()``: ms a step, tokens/s (B * T * steps / dt),
   peak memory; one step under ``torch.profiler`` (busy, idle share, top
   kernels).  Then ``fit_steps`` on a stride-0 block of 5: its losses and
   ``head_w`` bit for bit those of 5 eager ``fit`` steps from the same
   state, one capture, one ``replay()`` a block, graph ms a step.  The
   path reaches none of the nine kernels (its LayerNorm is Mean /
   SquaredDifference / Rsqrt, its attention BatchMatMulV2 / Softmax).
43. sd_kernels — a SameDiff graph built through the API at BERT-base width
   (2 pre-LN layers of ``sd.nn.layer_norm`` twice, the
   ``multi_head_dot_product_attention`` op with 12 heads of 64 and a GELU
   MLP; batch 32, T = 128, f32, Adam(1e-4), MSE): 3 ``fit`` steps, the
   launch counts set to 0 just before each and read just after: exactly 2
   flash forward, 2 dQ, 2 dK/dV, 4 LayerNorm forward and 4 LayerNorm
   backward launches a step; a twin built alike (equal variables) in
   ``reference`` mode launches none, and each loss agrees within 1e-4
   relative.
44. dp_resnet50 — bench.py's ResNet-50 blocks data-parallel
   (``BASELINE.json`` config 5's path): full width, bf16 compute on f32
   masters, Nesterovs(0.1, 0.9), global batch 64, stride-0 blocks of 5,
   through ``ParallelWrapper.builder(net).build().fit_steps(xs, ys)`` at
   world = ``torch.cuda.device_count()`` over NCCL (one rank a card;
   cuDNN deterministic for bitwise twins).  At world 1 the script's own
   process is the rank (a one-rank NCCL group): two blocks, the launch and
   collective counts set to 0 just before them and read just after (the
   collectives at the warm-up and capture exactly (k + 1) x one all-reduce
   a gradient bucket and one of the loss), give the losses, parameters,
   BatchNorm statistics and updater state of a twin's plain
   ``fit_steps`` bit for bit; a debug-mode capture of the block holds
   exactly 80 + 80 conv nodes and the NCCL nodes the bucket count
   predicts (none: NCCL enqueues nothing for an in-place sum over one
   rank).  Above world 1, ``multihost.LocalLauncher`` starts one rank a
   card (``chip_smoke.py --dp-rank resnet50``): the losses hold the
   one-card run's on the same global batch (bf16 bound, or
   ``DIVERGED_LOSS_RTOL`` once it rises), and the parameters are bitwise
   equal over the ranks.  Step ms, samples/s (global and per card), NCCL
   ms a step from the profiler, capture seconds, idle share, peak memory.
   The line says that at world 1 multi-rank parity comes from the CPU
   tests only.
45. dp_checkpoint — ``save_model_sharded`` of phase 44's wrapped network
   after its blocks, ``load_model_sharded`` into a fresh wrapped network:
   one more block from each gives the same bits.  Save and load seconds,
   bytes written.
46. dp_zero1 — bench.py's ``bench_zero1`` A/B: MLP 256 -> 1024 -> 1024 ->
   10, Adam(1e-3), batch 256, stride-0 blocks of 8, one warm-up block and
   48 timed steps, replicated then with ``optimizer_sharding(True)``:
   ``max_param_diff`` 0 at world <= 2, 16 ``fused_dense`` nodes a block
   (the two relu Dense layers; the softmax head is plain), updater-state
   bytes a rank on each side and their ratio, samples/s of each side.  At
   world 1 the A/B is degenerate (the line says so).
47. gs_resnet50 — BASELINE config 5's GradientSharing ResNet-50: bench.py's
   bf16 ResNet-50 (global batch 64, Nesterovs(0.1, 0.9), 224 px, 1000
   classes, cuDNN deterministic), split steps with the host exchange
   between them (``parallel/hierarchical.py``), run eagerly step by step.
   (a) This process, no process group:
   ``ParallelWrapper.builder(net).gradient_sharing(
   HierarchicalGradientSharing(compressed=False, world=1)).build()
   .fit_steps`` on a stride-0 block of ``GS_R50_K``: the launch counts set
   to 0 just before it and read just after (exactly 16 + 16 conv launches
   a step, no ``fused_dense``), its losses, parameters and BatchNorm
   statistics bit for bit those of an eager plain ``fit`` twin from the
   same state; then the same with ``compressed=True`` (the default
   threshold): finite losses, a compression ratio above 1 and the four
   ``comms_*`` series moved by exactly k exchanges.  Each mode: ms a step
   (a timed block), the exchange's pieces (D2H, encode, TCP, decode, H2D;
   a block timed piece by piece with a synchronize around each),
   ``comms_exchange_ms`` as recorded, wire bytes a step, the compression
   ratio, peak memory and the idle share of one traced step.  (b) A gang
   of 2 processes (``multihost.LocalLauncher(2, platform="cuda",
   gang=True)`` running ``chip_smoke.py --gs-rank resnet50``: no process
   group, one card each where there are two, else both on card 0), each
   with its 32 rows of the same global batch, a fresh network a mode: k
   steps dense over the TCP mesh, then k steps compressed over a second
   mesh; the ranks' parameters bitwise equal after each mode (their
   BatchNorm statistics are their own rows'), the same numbers a rank.
48. gs_comms — bench.py's ``bench_comms`` A/B (``bench.py:829-886``,
   ``tests/mh_worker_comms.py``) on the card: 2 gang processes
   (``--gs-rank comms``), MLP 16-32-3 (tanh, softmax, mcxent), Sgd(0.1),
   threshold 5e-3, 150 ``fit`` steps of 32 rows a rank from one global
   stream (seed 0), dense then compressed.  Gates as ``bench.py:915``: at
   least 5x fewer bytes on the wire and the final loss within 1%, else the
   script fails; the ranks' first-layer W bitwise equal in each mode;
   ``fused_dense`` launches a step.
49. tp_vgg16 — tensor parallelism (``parallel/sharding.py``): zoo VGG16 at
   224x224x3, 1000 classes, f32, Adam(1e-3), global batch 32, through
   ``ParallelWrapper(mesh={data: w/m, model: m}, sharding_rules=
   ShardingRules())`` (m = 2 where w >= 2, else 1) at world w =
   ``device_count``, 3 steps, the launch counts set to 0 just before them
   and read just after (2 ``fused_dense`` + 13 wgrad + 12 dgrad a step,
   each ``fused_dense`` launch's (M, K, N)).  Rank 0 trains the plain
   one-rank ``fit`` twin: bitwise at m = 1; above it the losses within
   vgg16_train's f32 bound (1e-4, 1e-1 once the loss rises; dropout off,
   since each data rank would draw its own masks).  Then 8 timed steps
   (ms a step is their median) and 3 profiled ones (the idle share).  A
   second pair, wrapped and twin, takes 3 Sgd(1e-2) steps: each leaf
   within 1e-5 of its layer's largest parameter (bitwise at m = 1).  Each
   rank's resident parameter bytes (fc6's W whole is 411,041,792), peak
   memory; ``fused_dense`` at fc6's column-parallel shard (32, 25088,
   2048) against its plain version, with its bound and the library call.
50. ring_flash — ``ring_attention_flash`` over {seq: w} on q, k, v [4, 12,
   2048, 64] (BERT-base heads at bench.py's long T) split on T, f32 and
   bf16, causal and not: w ``flash_attn_fwd`` launches a call; the output
   against the plain ``ring_attention`` on the same ranks, and on rank 0
   the gathered output and its gradients (the plain ring's backward)
   against the full attention in f32, within the attention bounds; ms a
   call beside the plain ring's.
51. composed — ``ComposedParallel`` at BERT-base widths (D 768, 12 heads,
   F 3072, T 2048; weights at BERT's initializer std 0.02) on {data: 1,
   model: 1, pipe: 1} at w = 1 and {data: 1, model: 2, pipe: w/2} above,
   S = pipe stages, M = S microbatches, batch 4 S: 3 SGD steps (the lr the
   first of ``COMPOSED["lrs"]`` at which the oracle's loss falls) against
   ``composed_oracle`` on rank 0 (losses 1e-4, parameters 1e-3 of each
   leaf's max); the dense world-1 sharing facade and
   ``composed_train_steps(k=3)`` bitwise against the plain steps; ms a
   step and peak memory a rank.
   Phases 49 to 51 run inside the data-parallel block: at world 1 on its
   one-rank NCCL group, above it one rank a card through
   ``multihost.LocalLauncher`` (``chip_smoke.py --mp-rank <phase>``, an
   ``MP_RANK`` line a rank).
52. ft_resnet50 — ``FaultTolerantTrainer`` around bench.py's bf16
   ResNet-50 (batch 64, 224 px, 1000 classes, Nesterovs(0.1, 0.9), cuDNN
   deterministic) through ``fit(iterator, fused_steps=5)`` with
   ``CheckpointManager(async_save=True, save_every_steps=5)``, over 15
   batches of one seeded stream: U uninterrupted; K stopped by
   ``KillSwitch(7, "exception")``, then a fresh network and trainer on the
   same directory resume and finish; P stopped by ``"sigterm"``
   (``Preempted``), then resumed.  K's and P's parameters, BatchNorm
   statistics and moments are U's bit for bit.  The launch counts set to
   0 just before U and read just after: 96 + 96 conv launches (the
   warm-up step and the capture), and a debug-mode capture of a block
   holds 80 + 80.  A restore into U's live network keeps every carried
   tensor's address and its captured graph, and the block it replays
   equals a fresh network restored from the same checkpoint, bit for
   bit.  ms a step with and without a manager saving every block, the
   snapshot's ms on the step path, the background write's ms and the
   checkpoint's bytes (the ``resilience_*`` series), restore seconds,
   peak memory.
53. resilience_ab — bench.py's ``--resilience`` A/B (``bench.py:643-700``)
   in a fresh process (``chip_smoke.py --resilience-ab``, a ``RES_AB``
   line), as bench.py runs it: the MLP 784-512-256-10 over 256 batches of 64 staged by
   ``DevicePrefetchIterator`` through ``_fit_dataset``, with an async
   manager saving every 128 steps (keep 3; its ``wait()`` timed) and
   without, bench.py's epoch (a warm-up epoch a side).  Gate: the
   overhead under 5%, else the script fails, held on the median over 16
   pairs of whole epochs (the order alternating a pair) of each pair's
   overhead, as the host moves an epoch by more than the gate; 4 pairs
   without saves give its noise floor (``aa``), and bench.py's minimum of
   3 epochs a side is printed beside it.  Then
   ``EarlyStoppingTrainer`` on LeNet (4 batches of 64 a training epoch, 2
   validation batches, at most 3 epochs): ``fused_dense`` launches one a
   training step and one a validation batch, and the scores, best epoch
   and termination those of a ``reference``-mode twin (1e-4).
54. elastic_ab — bench.py's ``--elastic`` A/B (``bench.py:927-1040``):
   ``ElasticLocalRunner(3).run_elastic`` runs ``chip_smoke.py
   --elastic-rank mlp`` (the MLP 16-32-3 of
   ``tests/mh_worker_elastic_gang.py``, threshold 5e-3, 24 steps, rank 2
   killed at step 8; the members share the cards).  B: a clean world-2
   gang from A's resume checkpoint; C: a clean gang of 3.  bench.py's
   gates: detection within the failure deadline + 2 s, A's final loss B's
   within 1e-9 relative, the reformation within 15 s.  Then a
   ``"block"`` run with ``relaunch=True`` ends at world 3 after the
   replacement joins.  One ``fused_dense`` launch a step on every rank.
55. elastic_resnet50 — BASELINE config 5's GradientSharing ResNet-50 under
   ``ElasticTrainer`` (bf16, 224 px, 1000 classes, Nesterovs(0.1, 0.9),
   ``HierarchicalGradientSharing(elastic=True)`` at the default
   threshold): a gang of 3 (``--elastic-rank resnet50``), a global batch
   of 48 from one seeded stream, each member its live rank's strided
   rows.  C, a clean gang of 3 for 4 steps, gives the step time, and the
   failure deadline is max(5 s, 3 x its slowest median step) (a live
   member that ships no data for the deadline is reformed out as a
   straggler, so a clean run must show none).  A: 10 steps, rank 2
   killed at step 4 by ``PeerKiller``: exactly one ``crash`` reformation
   to world 2, and rank 0's parameters, BatchNorm statistics and moments
   those of B, a clean world-2 gang from A's resume checkpoint, bit for
   bit; B re-forms never; 16 + 16 conv launches every step of every rank.
   Detection and resume ms, ms a step before and after the reform, the
   coordinator's checkpoint ms a step, wire bytes a step, peak memory a
   rank.

56. gs_hosts_comms — bench.py's ``bench_comms`` as ``bench.py:829-900``
   defines it: 2 hosts (``LocalLauncher(2, d, "cuda", gang=True)``,
   ``--hosts-rank comms``), 32 rows a host split over the host's d ranks
   by ``ParallelWrapper``, 150 steps, threshold 5e-3, MLP 16-32-3,
   Sgd(0.1); d = 2 at 4 cards, 1 (both hosts on a shared card) below.
   Gates as phase 48: at least 5x fewer bytes on the wire (counted on the
   leaders) and the final loss within 1%; every rank of every host ends
   with the same first-layer W, bitwise; a rank other than its host's
   leader opens no gang socket; ``fused_dense`` launches on every rank.
57. gs_hosts_resnet50 — config 5's GradientSharing ResNet-50 (bf16, 224
   px, Nesterovs(0.1, 0.9)) as hosts: at 4 cards 2 hosts x 2 cards
   (``--hosts-rank resnet50``), a global batch of 64 (32 a host, 16 a
   rank), k steps dense, then threshold 1e-3, then dense under ZeRO-1;
   every rank's parameters bitwise equal after each mode, dense under
   ZeRO-1 bitwise dense, dense against a 1-host world-4
   ``ParallelWrapper`` twin from the same parameters (its BatchNorm
   statistics are over 64 rows, the hosts' over 32) as ``dp_resnet50``
   holds world 4 against world 1: the first loss within 1e-3, the second
   within 2e-2, the parameters' gap and the update's cosine reported; 16 + 16
   conv launches a step on every rank; ms a step by part (grad half, the
   leader's gather, D2H, exchange, H2D, broadcast or scatter).  At 1
   card 1 host x 1 card at k = 2 in this process, dense bitwise its plain
   wrapper twin.
58. tp_infer — ``ParallelInference`` over {data: w/2, model: 2} (at 1
   card {data: 1}) serving VGG16 f32 (outputs within the f32 bound of
   the one-card ``output``), and the weight-only int8 VGG16 with its
   leaves placed by ``shard_model_params`` on that mesh (q and scale
   split alike; the quantized ``q_matmul`` column-parallel), within
   phase ``quant_slice``'s bound of the unsharded quantized output;
   ``fused_dense`` and ``q_matmul`` launches a forward on every rank,
   with their (M, K, N).
59. dp_sd_zero1 — phase 43's SameDiff graph (BERT-base width, 2 layers,
   batch 32, T 128, Adam(1e-4)) under ``enable_zero1`` at world ranks
   (``--hosts-rank sd_zero1`` above 1), every rank feeding the whole
   batch: losses and variables within rtol 1e-5 of the replicated fit
   (bitwise at world 1), updater bytes a rank on each side, flash and
   LayerNorm launches a step on every rank.
60. onnx_bert — right after phase 42: its BERT-base encoder (the same
   weights, ``SD_BERT``) written as an ONNX export would write it
   (``bert_onnx_model``: 8 + 33 a layer nodes, opset-17
   LayerNormalization, GELU as the Erf composition) through the port's
   ``onnx_proto`` writer, imported by ``modelimport.import_onnx_model`` on
   the card (trainable initializers): the encoder within 1e-4 x max|ref|
   of ``bert_plain_forward`` (TF32 off), one ``layer_norm`` launch a
   LayerNormalization node in a forward; then phase 42's head, Adam(1e-4)
   and ``SD_BERT_K`` ``sd.fit`` steps: the first loss within 1e-5
   relative of phase 42's independent step, 24 + 24 LayerNorm launches a
   step, step ms, tokens/s and peak memory; write and import seconds.
61. onnx_resnet50 — after phase 43: the port's zoo ResNet-50 (224 px,
   1000 classes, seeded init; each residual branch's last BatchNorm scale
   drawn from [0.1, 0.3]; every BatchNorm's running statistics calibrated
   on the batch and perturbed from a seed, ``calibrate_bn_stats``; the
   head imprinted with the batch's 16 classes at logit 8,
   ``imprint_head``) written as an NCHW ONNX graph
   (``resnet50_onnx_model``: 'Same' windows as explicit, uneven pads),
   imported: batch 16's probabilities and logits within 1e-4 x max|ref|
   of the ComputationGraph's on the same images (NHWC there), its argmax
   the imprinted classes, no probability above 0.9; ``quantize_model``
   gives the ``samediff`` kind, ``parity_check`` delta <= 0.01, the int8
   logits within 10% (L2) of the f32 ones; ``ModelServer(max_batch=16)``
   deploys it warmed at ``input_shape=(3, 224, 224)`` and serves 64
   single-row requests through ``submit`` (p50/p99; each answer a softmax
   row with no probability above 0.9, the answers within 1e-4 x max of
   one batched ``output``); int8 against f32 resident bytes;
   ``deploy("raw", onnx=...)`` registers with source "onnx" and its first
   request raises ``UnservableGraphError``.
62. qmha — ``quantized_mha`` at BERT-base width (x [8, 128, 768], 12
   heads, int8 ``w_qkv`` [768, 2304] and ``w_out`` [768, 768], biases)
   against itself in ``reference`` mode: f32 within 1e-4 x max|ref|, bf16
   within ``Q_BF16_ULPS`` bf16 ulps; 2 ``q_matmul`` and 1 flash launches a
   call; ms a call in each mode.

Then the kernels line (each entry with ``share_of_bound``; ``fused_dense``
and the conv pair carry ``vgg16_train``, ``zoo_train``, ``fused_resnet50``
and ``fused_lenet`` entries, the conv pair ``zoo_graphs`` and
``fused_dense`` ``records_train`` ones, and the attention and LayerNorm
kernels ``fused_bert`` ones (their nodes in one replayed block at each
shape), the flash kernels ``seq_attention`` ones (``fused_dense`` one of
0: it is not on that path; the conv pair ``dp_resnet50`` entries and
``fused_dense`` a ``dp_zero1`` one, the conv pair ``gs_resnet50`` entries
and ``fused_dense`` ``gs_comms`` and ``gs_resnet50`` ones; ``fused_dense``
and the conv pair ``tp_vgg16`` entries, ``flash_attn_fwd`` a ``ring_flash``
one; the conv pair ``ft_resnet50`` and ``elastic_resnet50`` entries,
``fused_dense`` ``resilience_ab``, ``early_stopping`` and ``elastic_ab``
ones); ``dp_resnet50``
and ``dp_zero1`` count the launches of one
replayed block by the graph's kernel nodes, beside the profiler's counts
of traced replays and the Python counts made at the warm-up and the
capture; the attention and LayerNorm kernels also carry ``sd_kernels``
entries, their launches a step in phase 43; the LayerNorm pair
``onnx_bert`` entries, ``q_matmul`` and ``flash_attn_fwd`` ``qmha`` ones),
nvidia-smi's line, and the last line ``{"ok": true, "device": {...}}``.  Exits
non-zero, printing no result, without CUDA or outside a checkout of the
repository.
"""
import contextlib
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
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
#: phase 49: VGG16 steps under the wrapper's sharding rules; fc6's
#: column-parallel shard (M, K, N) at which fused_dense is held
TP_VGG_STEPS = 3
TP_SHARD = (32, 25088, 2048)
#: phase 49: steps timed after the held ones (the first steps of a run
#: pay for the communicators and the kernels' first launches), and a
#: profiled block of steps after those
TP_VGG_TIMED, TP_VGG_TRACED = 8, 3
#: phase 49's Sgd twin pair: lr, and each leaf's max|diff| after
#: TP_VGG_STEPS steps relative to the largest parameter of its layer
#: (an Sgd step moves a leaf by lr times its gradient, so a
#: rounding-sized gradient difference stays rounding-sized; Adam's
#: lr * m / sqrt(v) does not)
TP_SGD_LR, TP_SGD_COS, TP_SGD_SCALE = 1e-2, 0.999, 0.02
#: phase 50: q, k, v [B, H, T, D] (BERT-base heads at bench.py's long T)
RING_SHAPE = (4, 12, 2048, 64)
#: phase 51: ComposedParallel at BERT-base widths; the weight matrices
#: init_stage_params draws (std 0.2, sized for the JAX package's 8-wide
#: test model) scaled to BERT's initializer range, std 0.02: at width 768
#: std 0.2 saturates the softmax (losses ~2,700) and leaves the f32
#: gradients of the biases mostly rounding; the lrs tried, in order, for
#: one at which composed_oracle's loss falls each step
COMPOSED = dict(d_model=768, heads=12, d_ff=3072, t=2048, steps=3, k=3, init_scale=0.1,
                lrs=(0.1, 1e-2, 1e-3, 1e-4))
#: composed parameters after 3 steps against the oracle's, relative to
#: each leaf's max (the JAX package's own test: 1e-3)
COMPOSED_PARAM_RTOL = 1e-3
#: the zoo_train models, (input, classes, per-step launches as above):
#: SimpleCNN's relu Dense and six 3x3 convs; AlexNet's two relu Dense and
#: three 3x3 convs, the first fed by a pool; Darknet19's twelve 3x3 convs
#: (its Dense-free head takes no kernel)
ZOO_TRAIN = {"SimpleCNN": ((48, 48, 3), 10, (1, 6, 5)),
             "AlexNet": ((224, 224, 3), 1000, (2, 3, 3)),
             "Darknet19": ((224, 224, 3), 1000, (0, 12, 11))}
ZOO_STEPS = 2
#: bench.py's fused training blocks (`bench_resnet50`, `bench_lenet`)
FUSED_R50_K = 5
FUSED_R50_TIMED_BLOCKS = 5
#: the loss and first-update bound of a bf16-compute step against its eager
#: twin (bf16 rounds each product to 8 bits; the twins differ only in
#: accumulation order)
BF16_LOSS_RTOL = 1e-3
#: bench.py's data-parallel configurations through ParallelWrapper:
#: ResNet-50's fused bf16 blocks (`bench_resnet50`) and the ZeRO-1 A/B
#: (`bench_zero1`: MLP 256 -> 1024 -> 1024 -> 10, Adam(1e-3), batch 256,
#: stride-0 blocks of 8, 48 steps after one warm-up block)
DP_R50_K = 5
DP_R50_TIMED_BLOCKS = 3
#: above world 1 each rank's bf16 gradient is rounded before the ranks'
#: are summed, so the run parts from the one-card run after its first
#: update: at world 4 the second loss differed by 5.4e-3 relative and the
#: diverging run (DIVERGED_LOSS_RTOL's note) by 0.14 at step 6 (my 4-card
#: run of the path).  The first loss (the same parameters) is held to
#: BF16_LOSS_RTOL, the second to this, the rest reported
DP_BF16_STEP2_RTOL = 2e-2
ZERO1 = dict(batch=256, steps=48, fused_steps=8, n_in=256, hidden=1024)
#: gradient sharing: BASELINE config 5's GradientSharing ResNet-50 (bench.py's
#: bf16 ResNet-50, global batch 64) in blocks of GS_R50_K steps a mode, and
#: bench.py's `bench_comms` A/B (`bench.py:829-886`, `tests/mh_worker_comms.py`:
#: 2 processes, MLP 16-32-3 tanh/softmax/mcxent, Sgd(0.1), threshold 5e-3,
#: 150 steps of 32 rows a rank) with its gates (`bench.py:915`)
GS_R50_K = 3
GS_COMMS = dict(steps=150, rows=32, n_in=16, hidden=32, threshold=5e-3)
GS_MIN_BYTES_X = 5.0
GS_MAX_LOSS_REL = 0.01
# phase 57's steps at 1 card.  Its dense 2 x 2 hosts part from the 1-host
# world-4 twin as dp_resnet50's world 4 parts from world 1 (bf16 gradients
# rounded before the ranks' sum; here also BatchNorm over a host's 32 rows
# against the twin's 64): the first loss is held to BF16_LOSS_RTOL, the
# second to DP_BF16_STEP2_RTOL, the parameters and the update's direction
# reported (at world 1: bitwise)
GS_HOSTS_K1 = 2
# phase 59: ZeRO-1 against the replicated SameDiff fit (the JAX test's bound)
SD_ZERO1_RTOL = 1e-5
FUSED_LENET_K = 10
FUSED_LENET_BATCHES = 23
#: StepSchedule(1e-3, 0.5, 4): the lr halves at steps 4 and 8 of the first
#: block
FUSED_LENET_LR = (1e-3, 0.5, 4)
FUSED_DROPOUT_K = 4
#: bench.py's fused BERT blocks (`bench.py:208-248`): stride-0 blocks of 5
#: at (batch, T) = (64, 128) and the long-sequence (4, 2048)
FUSED_BERT_K = 5
FUSED_BERT_SHAPES = ((64, 128), (4, 2048))
FUSED_BERT_TIMED_BLOCKS = 3
FUSED_BERT_ITER_BATCHES = 11
#: the five kernels of a BERT MLM step, (launch name, kernel name) in
#: BERT_STEP_LAUNCHES' order
BERT_KERNEL_TAGS = (("flash_attn_fwd", "flash_attn_fwd_kernel"),
                    ("flash_attn_bwd_dq", "flash_attn_bwd_dq_kernel"),
                    ("flash_attn_bwd_dkv", "flash_attn_bwd_dkv_kernel"),
                    ("layer_norm_fwd", "layer_norm_fwd_kernel"),
                    ("layer_norm_bwd", "layer_norm_bwd_kernel"))
#: the zoo's graph models at their published widths, (config, batch,
#: launches a fit step as VGG_STEP_LAUNCHES counts them): SqueezeNet's 8
#: fire-module 3x3 expands (each fed by its squeeze conv; the stride-2 stem
#: is no kernel shape); U-Net's 18 double-conv 3x3s (the first reads the
#: data, so 17 dgrad).  No Dense layer in either.
ZOO_GRAPHS = {"SqueezeNet": (dict(n_classes=1000, input_shape=(224, 224, 3)), 32, (0, 8, 8)),
              "UNet": (dict(n_classes=1, input_shape=(512, 512, 3), base_filters=64), 4,
                       (0, 18, 17))}
#: the CSV of records_train: rows, feature columns, classes, batch
RECORDS_CSV = (4096, 784, 10, 256)
#: bench.py's LSTM char-LM block (``bench.py:404-417``): batch, T, vocab
CHARLM = (64, 64, 77)
CHARLM_K = 5
CHARLM_TIMED_BLOCKS = 3
#: the masked char-LM step: T, and the length half the rows are cut to
CHARLM_MASKED = (40, 20)
#: seq_attention: batch, T, vocab, LSTM units, heads, classes, the steps
#: the mask drops from half the rows, the fused block's k
SEQ_ATTN = (64, 128, 77, 256, 4, 10, 32, 3)
#: sd_tf_bert: bench.py's BERT-base TF-import fine-tune (batch, T, layers,
#: hidden, heads, vocab) and the fused block's k
SD_BERT = (32, 128, 12, 768, 12, 30522)
SD_BERT_K = 5
#: sd_kernels: batch, T, features, heads, encoder layers, Adam steps
SD_KERNELS = (32, 128, 768, 12, 2, 3)


_T0 = time.monotonic()


def emit(phase, **kw):
    """One phase's JSON line; `t_s` is the script's seconds so far."""
    print(json.dumps({"phase": phase, **kw, "t_s": round(time.monotonic() - _T0, 1)}),
          flush=True)


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
    # a CUDA graph: the warm-up body and the k captured bodies tick the
    # counts, the replay none
    require(fs_counts[0] == tuple((k + 1) * n for n in BERT_STEP_LAUNCHES),
            f"fit_steps launches {fs_counts[0]} != {k + 1} x {BERT_STEP_LAUNCHES}")
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


def _sync_calls(fn):
    """Synchronizing CUDA calls made by fn (torch.cuda.set_sync_debug_mode
    "warn"), and their distinct messages."""
    import warnings
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    # the mode's own one-off notice ("Synchronization debug mode is a
    # prototype feature ...") is not a synchronizing call
    msgs = [str(w.message) for w in caught if "synchroniz" in str(w.message)
            and "prototype feature" not in str(w.message)]
    return len(msgs), sorted(set(m[:160] for m in msgs))


def _syncs_per_step(net, x, y, steps=3, read_score=False):
    """Synchronizing CUDA calls a fit step (and a `score()` read after it,
    with `read_score`), counted by `_sync_calls` over `steps` steps after
    one uncounted step (one-off work stays out), and their distinct
    messages."""
    net.fit(x, y)

    def run():
        for _ in range(steps):
            net.fit(x, y)
            if read_score:
                net.score()

    n, msgs = _sync_calls(run)
    return n / steps, msgs


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


def _count_kernels(by_name, tag):
    return sum(n for name, (_, n) in by_name.items() if tag in name)


def _hand_launches(by_name):
    """Launches of the hand-written kernels on the training paths in a
    trace, by the profiler's kernel names (dgrad's filter pack is not
    counted)."""
    return {"fused_dense": _count_kernels(by_name, "fused_dense_kernel"),
            "conv3x3_wgrad": _count_kernels(by_name, "conv3x3_wgrad_kernel"),
            "conv3x3_dgrad": _count_kernels(by_name, "conv3x3_dgrad_kernel")}


class _KeptGraph(torch.cuda.CUDAGraph):
    """A CUDAGraph that keeps its graph after instantiation, with debug mode
    on, so that its kernel nodes (what every replay launches) can be read
    back: `_kept_launches`.  Never timed."""

    def __new__(cls, *args, **kwargs):
        return super().__new__(cls, keep_graph=True)

    def __init__(self, *args, **kwargs):
        super().__init__(keep_graph=True)
        self.enable_debug_mode()


class _keep_graphs:
    """Within the block, the port's CUDA graphs are `_KeptGraph`s."""

    def __enter__(self):
        self.prev, torch.cuda.CUDAGraph = torch.cuda.CUDAGraph, _KeptGraph

    def __exit__(self, *exc):
        torch.cuda.CUDAGraph = self.prev


def _kept_dot(owner, attr, fresh, block):
    """The DOT dump of a graph of `block()` captured afresh as a
    `_KeptGraph`: `owner.<attr>` (its graph step, or a dict of them) is set
    to `fresh` for the capture and put back after, so the owner's timed
    graphs stay the port's plain ones."""
    import tempfile
    own = getattr(owner, attr)
    setattr(owner, attr, fresh)
    try:
        with _keep_graphs():
            block()
        steps = getattr(owner, attr)
        (step,) = steps.values() if isinstance(steps, dict) else (steps,)
        (rec,) = step._graphs.values()
        path = os.path.join(tempfile.mkdtemp(prefix="graph_"), "g.dot")
        rec.graph.debug_dump(path)
    finally:
        setattr(owner, attr, own)
    with open(path) as f:
        txt = f.read()
    os.remove(path)
    return txt


def _kept_launches(net, block, want, tag):
    """A graph of `block()` (one ``fit_steps`` of `net`) captured afresh as
    a `_KeptGraph` (`_kept_dot`): ({kernel: nodes} of the hand-written
    kernels, all kernel nodes), what each replay of that block launches;
    the hand-written kernels' nodes must equal `want`."""
    txt = _kept_dot(net, "_scan_step", None, block)
    nodes = {"fused_dense": txt.count("fused_dense_kernel"),
             "conv3x3_wgrad": txt.count("conv3x3_wgrad_kernel"),
             "conv3x3_dgrad": txt.count("conv3x3_dgrad_kernel")}
    require(nodes == want, f"{tag}: the graph launches {nodes} a replay, want {want}")
    return nodes, txt.count("KERNEL")


def _traced_replays(fn, want, tag, tries=3, launches=_hand_launches):
    """fn (one replayed block) under the profiler `tries` times: the trace
    with the most kernel records, and every trace's (kernels, launches of
    the hand-written kernels by `launches`).  Each hand-written kernel of
    `want` shows in every trace, none more than `want`: the profiler loses
    kernel records of graph replays (LeNet: 9 of 10 `fused_dense` in every
    trace of three whole runs, plain and debug-mode graphs alike), so the
    exact count is `_kept_launches`'."""
    best, seen = None, []
    for _ in range(tries):
        got = _trace(fn)
        seen.append((got[3], launches(got[2])))
        if best is None or got[3] > best[3]:
            best = got
    require(all(0 < t[1][n] <= want[n] if want[n] else t[1][n] == 0
                for t in seen for n in want),
            f"{tag}: traced replays launched {seen}, want {want}")
    return best, seen


def _synced(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def _rel(got, want):
    return [abs(a - r) / max(abs(r), 1e-30) for a, r in zip(got, want)]


def _hold_fused_losses(losses, ref_losses, rerun, tol, tag):
    """Each loss within `tol` relative of the eager twin's, or within
    DIVERGED_LOSS_RTOL once the twin's loss has risen above its first; a
    step where both runs' losses have overflowed (after the rise) agrees."""
    rel = _rel(losses, ref_losses)
    require(math.isfinite(losses[0]) and math.isfinite(ref_losses[0]),
            f"{tag}: non-finite first loss")
    for i, (a, g, r) in enumerate(zip(rel, losses, ref_losses)):
        diverged = not math.isfinite(r) or r > ref_losses[0]
        if diverged and not math.isfinite(g) and not math.isfinite(r):
            continue                     # both runs overflowed at this step
        bound = DIVERGED_LOSS_RTOL if diverged else tol
        require(a <= bound, f"{tag} step {i + 1} loss rel diff {a} > {bound} "
                            f"(graph {losses}, eager {ref_losses}, eager rerun {rerun})")
    return rel


def _fused_resnet50_run(conv3x3, matmul, dispatch, ResNet50, Nesterovs, dev, x, y,
                        compute_dtype, k, image, classes):
    """One compute dtype of phase 34; returns its report."""
    cd = None if compute_dtype == "float32" else compute_dtype
    tol = F32_RTOL if cd is None else BF16_LOSS_RTOL
    tag = f"fused_resnet50 {compute_dtype}"
    steps = 2 * k
    net = _resnet50(ResNet50, Nesterovs, dev, compute_dtype=cd, image=image, classes=classes)
    state0 = {n: v.clone() for n, v in net.state_dict().items()}

    def fresh():
        twin = _resnet50(ResNet50, Nesterovs, dev, compute_dtype=cd, image=image,
                         classes=classes)
        twin.load_state_dict(state0)
        return twin

    # the eager twin: 10 fit steps, then a second one (the yardstick)
    twin = fresh()
    theta0 = _flat_params(twin)
    _reset_counts(matmul, conv3x3)
    eager, eager_ms = _fit_steps(twin, x, y, 1)
    theta1 = _flat_params(twin)
    more, more_ms = _fit_steps(twin, x, y, steps - 1)
    eager, eager_ms = eager + more, eager_ms + more_ms
    eager_counts = _step_counts(matmul, conv3x3)
    eager_per_step = tuple(c / steps for c in eager_counts)
    del twin
    again = fresh()
    rerun, _ = _fit_steps(again, x, y, steps)
    del again

    # a k = 1 block on a third net: the first step's update on the graph path
    one = fresh()
    one.fit_steps(x[None], y[None])
    update = (theta1 - theta0).abs().max().item()
    update_diff = (_flat_params(one) - theta1).abs().max().item() / update
    del one

    # the main path: bench.py's stride-0 blocks, counts set to 0 just before
    xs = torch.broadcast_to(x, (k,) + tuple(x.shape))
    ys = torch.broadcast_to(y, (k,) + tuple(y.shape))
    ins = net._instruments()
    step_dispatches0, compiles0 = ins.dispatches.value, ins.compiles.value
    torch.cuda.reset_peak_memory_stats()
    _reset_counts(matmul, conv3x3)
    first, first_ms = _synced(lambda: net.fit_steps(xs, ys))
    second, second_ms = _synced(lambda: net.fit_steps(xs, ys))
    capture_counts = _step_counts(matmul, conv3x3)
    dispatches = ins.dispatches.value - step_dispatches0
    compiles = ins.compiles.value - compiles0
    peak = torch.cuda.max_memory_allocated()
    step = net._scan_step
    captures = step.captures
    losses = first.tolist() + second.tolist()
    rel = _hold_fused_losses(losses, eager, rerun, tol, tag)
    rerun_rel = _rel(rerun, eager)
    require(update_diff <= tol,
            f"{tag}: the first step's update differs from the eager twin's by {update_diff}")
    require(captures == 1 and compiles == 1,
            f"{tag}: {captures} captures ({compiles} counted) for one shape, want 1")
    require(dispatches == 2, f"{tag}: {dispatches} dispatches for 2 blocks")
    require(isinstance(net.score_array(), torch.Tensor) and net.iteration == steps,
            f"{tag}: score_array / iteration after 2 blocks")

    # more blocks for the time, then one under the profiler
    block_ms = [second_ms]
    for _ in range(FUSED_R50_TIMED_BLOCKS - 2):
        block_ms.append(_synced(lambda: net.fit_steps(xs, ys))[1])
    want = {"fused_dense": round(k * eager_per_step[0]),
            "conv3x3_wgrad": k * BODY_CONVS, "conv3x3_dgrad": k * BODY_CONVS}
    (window_ms, busy_ms, by_name, n_kernels), traces = _traced_replays(
        lambda: net.fit_steps(xs, ys), want, tag)
    require(busy_ms is not None, f"{tag}: the profiler saw no device activity")
    replay, graph_kernels = _kept_launches(net, lambda: net.fit_steps(xs, ys), want, tag)

    # a block in reference mode: a capture of its own, no hand-written kernel
    prev = dispatch.set_dispatch_mode("reference")
    try:
        _reset_counts(matmul, conv3x3)
        _, _, ref_by_name, _ = _trace(lambda: net.fit_steps(xs, ys))
        ref_counts = _step_counts(matmul, conv3x3)
    finally:
        dispatch.set_dispatch_mode(prev)
    ref_traced = _hand_launches(ref_by_name)
    require(step.captures == 2, f"{tag}: the reference-mode block did not capture anew")
    require(not any(ref_traced.values()) and not any(ref_counts),
            f"{tag}: a reference-mode block launched {ref_traced} (counted at its "
            f"warm-up and capture {ref_counts})")
    graph_ms = statistics.median(block_ms) / k
    eager_step_ms = statistics.median(eager_ms[1:])
    report = dict(
        k=k, losses=losses, eager_losses=eager, eager_rerun_losses=rerun,
        rel_loss_diff=rel, rerun_rel_loss_diff=rerun_rel,
        step1_update_rel_diff=update_diff, captures=captures, dispatches=dispatches,
        capture_s=(step.capture_seconds or [None])[0], first_block_ms=first_ms,
        block_ms_all=block_ms, graph_step_ms=graph_ms, eager_step_ms=eager_step_ms,
        eager_step_ms_all=eager_ms, graph_samples_per_sec=x.shape[0] * 1e3 / graph_ms,
        eager_samples_per_sec=x.shape[0] * 1e3 / eager_step_ms,
        block_window_ms=window_ms, block_busy_ms=busy_ms,
        block_idle_share=max(0.0, 1.0 - busy_ms / window_ms), block_kernels=n_kernels,
        replay_launches=replay, graph_kernel_nodes=graph_kernels,
        replay_traces=traces, eager_launches_per_step=eager_per_step,
        launches_counted_at_capture=capture_counts,
        reference_block_launches=ref_traced, max_memory_allocated_gb=peak / 1e9,
        top=_top(by_name, 8))
    del net, step
    return report


def phase_fused_resnet50(conv3x3, matmul, dispatch, ResNet50, Nesterovs, dev,
                         k=FUSED_R50_K, batch=64, image=224, classes=1000):
    """bench.py's fused ResNet-50 blocks as CUDA graphs (phase 34 of the
    module docstring).  Returns {compute dtype: report}."""
    rng = np.random.RandomState(0)
    x = torch.as_tensor(rng.rand(batch, image, image, 3).astype(np.float32), device=dev)
    y = torch.as_tensor(np.eye(classes, dtype=np.float32)[
        rng.randint(0, classes, batch)], device=dev)
    out = {}
    for cd in ("bfloat16", "float32"):
        # f32: cuDNN's default backward of the 1x1 and 7x7 convs is not
        # bitwise repeatable, and ten steps of a diverging run amplify it
        # past any bound (two eager runs part by 0.28 at step 5), so the f32
        # runs take cuDNN's deterministic algorithms
        prev = torch.backends.cudnn.deterministic
        torch.backends.cudnn.deterministic = cd == "float32"
        try:
            out[cd] = _fused_resnet50_run(conv3x3, matmul, dispatch, ResNet50, Nesterovs,
                                          dev, x, y, cd, k, image, classes)
        finally:
            torch.backends.cudnn.deterministic = prev
        emit("fused_resnet50", model="ResNet50", compute_dtype=cd,
             input=f"{image}x{image}x3", classes=classes, batch=batch,
             updater="Nesterovs(0.1, 0.9)", cudnn_deterministic=cd == "float32",
             **out[cd])
    return out


def phase_fused_lenet(matmul, data, LeNet, Adam, StepSchedule, dev,
                      k=FUSED_LENET_K, n_batches=FUSED_LENET_BATCHES, batch=LENET_BATCH):
    """LeNet's fused blocks through the device pipeline (phase 35), under
    cuDNN's deterministic algorithms: the 5x5 convs' default backward is
    not bitwise repeatable, and Adam turns its noise in near-zero
    gradients into whole steps (one run parted the two nets by 5.6e-2 of
    a tensor's largest parameter)."""
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        return _fused_lenet(matmul, data, LeNet, Adam, StepSchedule, dev, k, n_batches,
                            batch)
    finally:
        torch.backends.cudnn.deterministic = prev


def _fused_lenet(matmul, data, LeNet, Adam, StepSchedule, dev, k, n_batches, batch):
    import tempfile

    rng = np.random.RandomState(0)
    xs_host = rng.rand(n_batches * batch, 28, 28, 1).astype(np.float32)
    ys_host = np.eye(10, dtype=np.float32)[rng.randint(0, 10, n_batches * batch)]

    def batches():
        return data.ArrayDataSetIterator(xs_host, ys_host, batch)

    nz = data.NormalizerStandardize().fit(batches())
    net = LeNet(seed=123, updater=Adam(StepSchedule(*FUSED_LENET_LR))).init_model(device=dev)
    tmp = tempfile.mkdtemp(prefix="fused_lenet_")
    path = os.path.join(tmp, "init.zip")
    net.save(path)
    twin = type(net).load(path, device=dev)
    net.set_normalizer(nz)

    class Scores:
        def __init__(self):
            self.seen = []

        def iteration_done(self, model, iteration, epoch):
            self.seen.append((iteration, model.score_array()))

    graph_seen, eager_seen = Scores(), Scores()
    net.set_listeners(graph_seen)
    twin.set_listeners(eager_seen)
    from deeplearning4j_tpu_torch.data import pipeline
    from deeplearning4j_tpu_torch.monitor.instrument import pipeline_instruments
    pins = pipeline_instruments()
    staged0, bytes0 = pins.batches.value, pins.h2d_bytes.value
    pf = data.DevicePrefetchIterator(batches(), depth=2, device=dev)
    matmul.LAUNCHES.reset()
    _, graph_epoch_ms = _synced(lambda: net.fit(pf, fused_steps=k))
    pf.close()
    # the Python counter ticks at the warm-up body, the k captured bodies
    # and the eager tail steps, never at a replay
    tails = n_batches % k
    epoch_counted = matmul.LAUNCHES.value
    require(epoch_counted == 1 + k + tails,
            f"fused_lenet: fused_dense counted {epoch_counted} times in the first epoch, "
            f"want 1 warm-up + {k} captured + {tails} tail steps")
    staged, staged_bytes = pins.batches.value - staged0, pins.h2d_bytes.value - bytes0
    host_it = batches().set_pre_processor(nz)
    _, eager_epoch_ms = _synced(lambda: twin.fit(host_it))
    require(net.iteration == twin.iteration == n_batches,
            f"fused_lenet: iterations {net.iteration} / {twin.iteration}")
    want_iters = [k, 2 * k] + list(range(2 * k + 1, n_batches + 1))
    require([i for i, _ in graph_seen.seen] == want_iters,
            f"fused_lenet: listener iterations {[i for i, _ in graph_seen.seen]}")
    eager_by_iter = {i: float(s) for i, s in eager_seen.seen}
    losses = [float(s) for _, s in graph_seen.seen]
    ref = [eager_by_iter[i] for i in want_iters]
    rel = _rel(losses, ref)
    require(all(r <= F32_RTOL for r in rel), f"fused_lenet: losses {losses} vs eager {ref}")
    worst_param, worst_name = 0.0, None
    for (name, a), (_, b) in zip(net.state_dict().items(), twin.state_dict().items()):
        if a.is_floating_point():
            err = (a - b).abs().max().item() / max(b.abs().max().item(), 1e-30)
            if err >= worst_param:
                worst_param, worst_name = err, name
    require(worst_param <= F32_RTOL,
            f"fused_lenet: {worst_name} differs by {worst_param} of its largest value")
    x_bytes = batch * 28 * 28 * 4 + batch * 10 * 4
    require(staged == n_batches and staged_bytes == n_batches * x_bytes,
            f"fused_lenet: staged {staged} batches / {staged_bytes} bytes, want "
            f"{n_batches} / {n_batches * x_bytes}")
    step = net._scan_step
    require(step.captures == 1, f"fused_lenet: {step.captures} captures for one shape")

    # an epoch of 2 blocks, synchronizing calls counted; score() the control
    two = lambda: data.ArrayDataSetIterator(xs_host[:2 * k * batch], ys_host[:2 * k * batch],
                                            batch)
    pf2 = data.DevicePrefetchIterator(two(), depth=2, device=dev)
    syncs, sync_msgs = _sync_calls(lambda: net.fit(pf2, fused_steps=k))
    pf2.close()
    control, _ = _sync_calls(lambda: net.score())
    require(syncs == 0, f"fused_lenet: {syncs} synchronizing calls in 2 blocks: {sync_msgs}")
    require(control >= 1, "fused_lenet: score() was not seen to synchronize (the control)")
    pf3 = data.DevicePrefetchIterator(two(), depth=2, device=dev)
    _, graph_epoch2_ms = _synced(lambda: net.fit(pf3, fused_steps=k))
    pf3.close()
    _, eager_epoch2_ms = _synced(lambda: twin.fit(two().set_pre_processor(nz)))

    # a staged block: replays timed, one traced; eager steps on device batches
    staged_block = [pipeline.ready(pipeline.stage(ds, device=dev))
                    for ds in list(batches())[:k]]
    xl = [ds.features for ds in staged_block]
    yl = [ds.labels for ds in staged_block]
    block_ms = [_synced(lambda: net.fit_steps(xl, yl))[1] for _ in range(5)]
    want = {"fused_dense": k, "conv3x3_wgrad": 0, "conv3x3_dgrad": 0}
    (window_ms, busy_ms, by_name, n_kernels), traces = _traced_replays(
        lambda: net.fit_steps(xl, yl), want, "fused_lenet")
    require(busy_ms is not None, "fused_lenet: the profiler saw no device activity")
    replay, graph_kernels = _kept_launches(net, lambda: net.fit_steps(xl, yl), want,
                                           "fused_lenet")
    xd = nz.transform(data.DataSet(xs_host[:batch].copy(), ys_host[:batch])).features
    x0 = torch.as_tensor(xd, device=dev)
    y0 = torch.as_tensor(ys_host[:batch], device=dev)
    eager_ms, _ = _step_ms(twin, x0, y0, 10, 2)
    wait = pins.producer_wait_ms
    report = dict(
        k=k, batches=n_batches, batch=batch, lr=f"StepSchedule{FUSED_LENET_LR}",
        cudnn_deterministic=True, listener_iterations=want_iters, losses=losses,
        eager_losses=ref, rel_loss_diff=rel, max_rel_param_diff=worst_param,
        worst_param=worst_name, staged_batches=staged,
        staged_bytes=staged_bytes, captures=step.captures,
        capture_s=(step.capture_seconds or [None])[0], sync_calls_in_2_blocks=syncs,
        score_sync_calls=control,
        graph_epoch_ms_per_step=graph_epoch_ms / n_batches,
        eager_epoch_ms_per_step=eager_epoch_ms / n_batches,
        graph_2block_epoch_ms_per_step=graph_epoch2_ms / (2 * k),
        eager_2block_epoch_ms_per_step=eager_epoch2_ms / (2 * k),
        graph_step_ms=statistics.median(block_ms) / k, block_ms_all=block_ms,
        eager_step_ms=eager_ms, block_window_ms=window_ms, block_busy_ms=busy_ms,
        block_idle_share=max(0.0, 1.0 - busy_ms / window_ms), block_kernels=n_kernels,
        replay_launches=replay, graph_kernel_nodes=graph_kernels, replay_traces=traces,
        launches_counted_in_first_epoch=epoch_counted,
        prefetch_wait_ms={"count": wait.count, "mean": wait.sum / max(wait.count, 1),
                          **wait.percentiles((50, 99))})
    emit("fused_lenet", model="LeNet", normalizer="NormalizerStandardize",
         pipeline="DevicePrefetchIterator(depth=2)", **report)
    return report


def phase_fused_dropout(nn, train, dev, k=FUSED_DROPOUT_K, batch=64, n_in=256):
    """Dropout masks drawn afresh on every replay (phase 36)."""
    import tempfile

    conf = (nn.NeuralNetConfiguration.builder().seed(7).updater(train.Sgd(0.0))
            .list([nn.DenseLayer(n_out=256, activation="relu", dropout=0.5),
                   nn.DenseLayer(n_out=256, activation="relu", dropout=0.5),
                   nn.OutputLayer(n_out=10, loss="mcxent", activation="softmax")])
            .set_input_type(nn.InputType.feed_forward(n_in)).build())
    net = nn.MultiLayerNetwork(conf, device=dev).init()
    rng = np.random.RandomState(0)
    x = torch.as_tensor(rng.randn(batch, n_in).astype(np.float32), device=dev)
    y = torch.as_tensor(np.eye(10, dtype=np.float32)[rng.randint(0, 10, batch)], device=dev)
    xs = torch.broadcast_to(x, (k,) + tuple(x.shape))
    ys = torch.broadcast_to(y, (k,) + tuple(y.shape))
    can = hasattr(torch.cuda.CUDAGraph, "register_generator_state")
    if not can:
        try:
            net.fit_steps(xs, ys)
        except RuntimeError as e:
            emit("fused_dropout", checked="raises without register_generator_state",
                 error=str(e)[:200])
            return {"checked": "raises"}
        raise AssertionError("fused_dropout: the graph path ran a dropout network "
                             "without register_generator_state")
    tmp = tempfile.mkdtemp(prefix="fused_dropout_")
    twin, _, _ = _twin_of(net, nn.MultiLayerNetwork, dev, tmp, "dropout")
    losses = net.fit_steps(xs, ys).tolist()
    eager, _ = _fit_steps(twin, x, y, k)
    second = net.fit_steps(xs, ys).tolist()
    require(len(set(losses)) > 1, f"fused_dropout: one mask replayed, losses {losses}")
    require(second != losses, f"fused_dropout: the second replay repeated the first {losses}")
    emit("fused_dropout", checked="fresh masks on each replay", k=k, losses=losses,
         second_block_losses=second, eager_losses=eager,
         equal_to_eager=[a == b for a, b in zip(losses, eager)],
         max_rel_diff_to_eager=max(_rel(losses, eager)))
    return {"checked": "fresh masks"}


def _bert_block(MultiDataSet, mds, k):
    """A stride-0 block of k copies of one batch, as bench.py builds it."""
    def b(t):
        return t.broadcast_to((k,) + tuple(t.shape))
    return MultiDataSet(features=[b(f) for f in mds.features],
                        labels=[b(l) for l in mds.labels],
                        labels_masks=[b(m) for m in mds.labels_masks])


def _bert_launches(by_name):
    """Launches of the BERT step's five kernels in a trace, by name."""
    return {name: _count_kernels(by_name, tag) for name, tag in BERT_KERNEL_TAGS}


def _bert_kept_launches(model, block, want, tag):
    """The BERT kernels' nodes of a debug-mode capture of `block()` (one
    ``fit_steps`` of `model`), made apart (`_kept_dot`); must equal `want`."""
    txt = _kept_dot(model, "_scan_steps", {}, block)
    nodes = {name: txt.count(kernel) for name, kernel in BERT_KERNEL_TAGS}
    require(nodes == want, f"{tag}: the graph launches {nodes} a replay, want {want}")
    return nodes, txt.count("KERNEL")


def _counting_replays(graph):
    """Wrap `graph.replay` with a counter: {"replays": n}."""
    seen = {"replays": 0}
    replay = graph.replay

    def counted():
        seen["replays"] += 1
        return replay()

    graph.replay = counted
    return seen


def _fused_bert_run(BertModel, BertConfig, Adam, MultiDataSet, dispatch, attention,
                    layer_norm, dev, batch, t, k):
    """One shape of phase 37; returns its report."""
    tag = f"fused_bert batch {batch} T {t}"
    cfg = {"compute_dtype": "bfloat16", **({"max_len": t} if t > 512 else {})}
    counters = _train_counters(attention, layer_norm)
    mds = _bert_train_batch(MultiDataSet, dev, batch, t)
    block = _bert_block(MultiDataSet, mds, k)
    steps = 2 * k
    model = _bert_train_model(BertModel, BertConfig, Adam, dev, **cfg)

    # the eager twin: 2k fit_batch calls from the same initial parameters
    twin = _bert_train_model(BertModel, BertConfig, Adam, dev, **cfg)
    twin.load_state_dict(model.state_dict())
    eager, eager_ms, eager_counts = _train_steps(twin, lambda: twin.fit_batch(mds),
                                                 counters, steps)
    require(all(c == BERT_STEP_LAUNCHES for c in eager_counts),
            f"{tag}: eager launches per step {eager_counts} != {BERT_STEP_LAUNCHES}")
    want_carry = [c.clone() for c in twin._carry()[:-1]]      # params, Adam state
    del twin

    # the main path: two replayed blocks, the counts set to 0 just before
    torch.cuda.reset_peak_memory_stats()
    for c in counters:
        c.reset()
    first, first_ms = _synced(lambda: model.fit_steps(block))
    step = model._scan_steps["mlm"]
    (rec,) = step._graphs.values()
    replays = _counting_replays(rec.graph)
    at_capture = tuple(int(c.value) for c in counters)
    second, second_ms = _synced(lambda: model.fit_steps(block))
    after_replay = tuple(int(c.value) for c in counters)
    peak = torch.cuda.max_memory_allocated()
    losses = first.tolist() + second.tolist()
    carry = model._carry()
    differ = [i for i, (a, b) in enumerate(zip(carry[:-1], want_carry)) if not torch.equal(a, b)]
    del want_carry
    require(losses == eager, f"{tag}: graph losses {losses} != eager {eager}")
    require(not differ, f"{tag}: {len(differ)} of {len(carry) - 1} parameter and Adam "
                        f"tensors differ from the eager twin's (first {differ[:5]})")
    require(model.iteration == steps and int(carry[-1]) == steps,
            f"{tag}: iteration {model.iteration} / {int(carry[-1])} after 2 blocks")
    require(model.score() == losses[-1], f"{tag}: score() is not the block's last loss")
    require(step.captures == 1 and list(model._scan_steps) == ["mlm"],
            f"{tag}: {step.captures} captures for one shape")
    require(at_capture == tuple((k + 1) * n for n in BERT_STEP_LAUNCHES)
            and after_replay == at_capture and replays["replays"] == 1,
            f"{tag}: counted {at_capture} at the capture, {after_replay} after a replay, "
            f"{replays['replays']} replays for one block")

    # more blocks for the time, one under the profiler, the graph's nodes
    block_ms = [second_ms]
    for _ in range(FUSED_BERT_TIMED_BLOCKS - 1):
        block_ms.append(_synced(lambda: model.fit_steps(block))[1])
    require(replays["replays"] == FUSED_BERT_TIMED_BLOCKS and step.captures == 1,
            f"{tag}: {replays['replays']} replays for {FUSED_BERT_TIMED_BLOCKS} blocks")
    want = {name: k * n for (name, _), n in zip(BERT_KERNEL_TAGS, BERT_STEP_LAUNCHES)}
    (window_ms, busy_ms, by_name, n_kernels), traces = _traced_replays(
        lambda: model.fit_steps(block), want, tag, launches=_bert_launches)
    require(busy_ms is not None, f"{tag}: the profiler saw no device activity")
    nodes, graph_kernels = _bert_kept_launches(model, lambda: model.fit_steps(block), want,
                                               tag)
    model._scan_steps = {}                 # the timed graph's pool goes
    torch.cuda.empty_cache()

    # a block captured in reference mode: none of the kernels' nodes
    prev = dispatch.set_dispatch_mode("reference")
    try:
        for c in counters:
            c.reset()
        ref_nodes, _ = _bert_kept_launches(model, lambda: model.fit_steps(block),
                                           {name: 0 for name, _ in BERT_KERNEL_TAGS}, tag)
        ref_counts = tuple(int(c.value) for c in counters)
    finally:
        dispatch.set_dispatch_mode(prev)
    require(not any(ref_counts), f"{tag}: a reference-mode block counted {ref_counts}")
    graph_ms = statistics.median(block_ms) / k
    eager_step_ms = statistics.median(eager_ms[1:])
    report = dict(
        k=k, losses=losses, eager_losses=eager, bitwise_equal=True,
        captures=step.captures, replays=replays["replays"],
        capture_s=step.capture_seconds[0], first_block_ms=first_ms,
        block_ms_all=block_ms, graph_step_ms=graph_ms, eager_step_ms=eager_step_ms,
        eager_step_ms_all=eager_ms, graph_tokens_per_sec=batch * t * 1e3 / graph_ms,
        eager_tokens_per_sec=batch * t * 1e3 / eager_step_ms,
        block_window_ms=window_ms, block_busy_ms=busy_ms,
        block_idle_share=max(0.0, 1.0 - busy_ms / window_ms), block_kernels=n_kernels,
        replay_launches=nodes, graph_kernel_nodes=graph_kernels, replay_traces=traces,
        launches_counted_at_capture=at_capture, reference_block_nodes=ref_nodes,
        max_memory_allocated_gb=peak / 1e9, top=_top(by_name, 8))
    del model, step, rec
    torch.cuda.empty_cache()
    return report


def _fused_bert_iter(BertModel, BertConfig, Adam, MultiDataSet, dev, batch, t, k, n):
    """`fit(list of n MLM batches, fused_steps=k)` against the same batches
    through `fit_steps` and `fit_batch` from the same start, bitwise."""
    rng = np.random.RandomState(5)
    batches = []
    for _ in range(n):
        ids = rng.randint(0, BERT_TRAIN_VOCAB, (batch, t)).astype(np.int32)
        lmask = (rng.rand(batch, t) < 0.15).astype(np.float32)
        batches.append(MultiDataSet([ids, np.ones((batch, t), np.float32)], [ids],
                                    labels_masks=[lmask]))
    fused = _bert_train_model(BertModel, BertConfig, Adam, dev, compute_dtype="bfloat16")
    manual = _bert_train_model(BertModel, BertConfig, Adam, dev, compute_dtype="bfloat16")
    manual.load_state_dict(fused.state_dict())
    got = []
    fit_steps, fit_batch = fused.fit_steps, fused.fit_batch
    fused.fit_steps = lambda m: got.append(fit_steps(m).tolist()) or None
    fused.fit_batch = lambda m: got.append([float(fit_batch(m))]) or None
    fused.fit(batches, fused_steps=k)
    want = []
    for lo in range(0, n - n % k, k):
        part = batches[lo:lo + k]
        want.append(manual.fit_steps(MultiDataSet(
            [np.stack([b.features[j] for b in part]) for j in range(2)],
            [np.stack([b.labels[0] for b in part])],
            labels_masks=[np.stack([b.labels_masks[0] for b in part])])).tolist())
    for b in batches[n - n % k:]:
        want.append([float(manual.fit_batch(b))])
    same = all(torch.equal(a, b) for a, b in zip(fused._carry(), manual._carry()))
    captures = fused._scan_steps["mlm"].captures
    require(got == want and same, f"fit(iterator, fused_steps={k}) losses {got} != "
                                  f"fit_steps / fit_batch {want} (parameters equal: {same})")
    require(captures == 1 and fused.iteration == n and fused.epoch == 1,
            f"fit(iterator): {captures} captures, iteration {fused.iteration}")
    del fused, manual
    torch.cuda.empty_cache()
    return {"batches": n, "blocks": [len(g) for g in got], "losses": got,
            "captures": captures}


def phase_fused_bert(BertModel, BertConfig, Adam, MultiDataSet, dispatch, attention,
                     layer_norm, dev, shapes=FUSED_BERT_SHAPES, k=FUSED_BERT_K):
    """bench.py's fused BERT blocks as CUDA graphs (phase 37 of the module
    docstring).  Returns {(batch, T): report}."""
    out = {}
    for batch, t in shapes:
        out[(batch, t)] = _fused_bert_run(BertModel, BertConfig, Adam, MultiDataSet, dispatch,
                                          attention, layer_norm, dev, batch, t, k)
        extra = {}
        if (batch, t) == shapes[0]:
            extra["fit_iterator"] = _fused_bert_iter(BertModel, BertConfig, Adam,
                                                     MultiDataSet, dev, batch, t, k,
                                                     FUSED_BERT_ITER_BATCHES)
        emit("fused_bert", model="BERT-base", params=BERT_BASE_PARAMS, batch=batch, T=t,
             compute_dtype="bfloat16", master_dtype="float32", updater="Adam(1e-4)",
             task="mlm", **out[(batch, t)], **extra)
    return out


def _zoo_graph_data(name, cfg, batch):
    """bench.py-style inputs: RandomState(0) images, and one-hot classes
    (SqueezeNet) or a per-pixel 0/1 mask (U-Net)."""
    rng = np.random.RandomState(0)
    h, w, c = cfg["input_shape"]
    x = rng.rand(batch, h, w, c).astype(np.float32)
    if name == "UNet":
        y = (rng.rand(batch, h, w, cfg["n_classes"]) > 0.5).astype(np.float32)
    else:
        y = np.eye(cfg["n_classes"], dtype=np.float32)[rng.randint(0, cfg["n_classes"], batch)]
    return x, y


def phase_zoo_graphs(matmul, conv3x3, dispatch, zoo, ComputationGraph, dev,
                     models=ZOO_GRAPHS):
    """SqueezeNet and U-Net training on the card (phase 38 of the module
    docstring).  Returns each model's report."""
    import shutil
    import tempfile

    out = {}
    tmp = tempfile.mkdtemp(prefix="zoo_graphs_")
    try:
        for name, (cfg, batch, per_step) in models.items():
            xn, yn = _zoo_graph_data(name, cfg, batch)
            x, y = torch.as_tensor(xn, device=dev), torch.as_tensor(yn, device=dev)
            net = getattr(zoo, name)(seed=123, **cfg).init_model(device=dev)
            twin, init_zip, _ = _twin_of(net, ComputationGraph, dev, tmp, name)
            worst_grad = _grad_parity(net, twin, dispatch, x, y, name)
            torch.cuda.reset_peak_memory_stats()
            losses, ms, theta0, theta1 = _main_steps(net, matmul, conv3x3, x, y,
                                                     ZOO_STEPS, per_step, name)
            peak = torch.cuda.max_memory_allocated()
            ref_losses, ref_theta1 = _reference_steps(twin, dispatch, x, y, ZOO_STEPS)
            upd, ref_upd = theta1 - theta0, ref_theta1 - theta0
            update_l2 = ((upd - ref_upd).norm() / ref_upd.norm()).item()
            del twin, theta0, theta1, ref_theta1, upd, ref_upd
            rerun = _rerun_if_diverged(ref_losses, init_zip, ComputationGraph, dispatch,
                                       dev, x, y)
            rel = _hold_losses(losses, ref_losses, rerun, name)
            out[name] = {"input": "x".join(map(str, cfg["input_shape"])),
                         "classes": cfg["n_classes"], "batch": batch,
                         **({"base_filters": cfg["base_filters"]}
                            if "base_filters" in cfg else {}),
                         "params": net.num_params(),
                         "updater": type(net.conf.updater).__name__,
                         "launches_per_step": dict(zip(
                             ("fused_dense", "conv3x3_wgrad", "conv3x3_dgrad"), per_step)),
                         "max_rel_grad_diff": worst_grad, "losses": losses,
                         "reference_losses": ref_losses, "rel_loss_diff": rel,
                         "reference_rerun_rel_loss_diff": rerun,
                         "step1_update_l2_rel_diff": update_l2, "step_ms_all": ms,
                         "step_ms": ms[-1], "max_memory_allocated_gb": peak / 1e9}
            del net, x, y
            torch.cuda.empty_cache()
            emit("zoo_graphs", model=name, **out[name])
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return out


class _StepLosses:
    """A listener that keeps each step's loss tensor and the `fused_dense`
    launches counted since the step before (the count is set to 0 just
    before `fit`)."""

    def __init__(self, counter):
        self.counter, self.losses, self.launches = counter, [], []

    def iteration_done(self, model, iteration, epoch):
        self.losses.append(model.score_array())
        self.launches.append(int(self.counter.value))
        self.counter.reset()


def phase_records_train(matmul, dispatch, data, nn, Adam, dev, shape=RECORDS_CSV):
    """DL4J's CSV path on the card (phase 39 of the module docstring)."""
    import shutil
    import tempfile

    rows, n_feat, classes, batch = shape
    rng = np.random.RandomState(0)
    labels = rng.randint(0, classes, rows)
    x = (rng.rand(rows, n_feat) + 0.05 * labels[:, None]).astype(np.float32)
    names = [f"class{i}" for i in range(classes)]
    tmp = tempfile.mkdtemp(prefix="records_")
    try:
        path = os.path.join(tmp, "train.csv")
        t0 = time.perf_counter()
        with open(path, "w") as f:
            for row, lab in zip(x.tolist(), labels):
                f.write(",".join("%.6f" % v for v in row) + "," + names[lab] + "\n")
        write_s = time.perf_counter() - t0
        schema = (data.Schema.builder().add_column_double(*[f"x{i}" for i in range(n_feat)])
                  .add_column_categorical("label", names).build())
        tp = data.TransformProcess.builder(schema).categorical_to_integer("label").build()
        it = data.RecordReaderDataSetIterator(
            data.TransformProcessRecordReader(data.CSVRecordReader(path), tp), batch,
            label_index=-1, num_classes=classes)
        t0 = time.perf_counter()
        nz = data.NormalizerStandardize().fit(it)
        read_s = time.perf_counter() - t0
        it.set_pre_processor(nz)
        conf = (nn.NeuralNetConfiguration.builder().seed(123).updater(Adam(1e-3))
                .list([nn.DenseLayer(n_out=500, activation="relu"),
                       nn.OutputLayer(n_out=classes, loss="mcxent", activation="softmax")])
                .set_input_type(nn.InputType.feed_forward(n_feat)).build())
        net = nn.MultiLayerNetwork(conf, device=dev).init()
        twin = nn.MultiLayerNetwork(nn.MultiLayerConfiguration.from_json(conf.to_json()),
                                    device=dev).init()
        twin.load_state_dict(net.state_dict())
        main = _StepLosses(matmul.LAUNCHES)
        net.set_listeners(main)
        matmul.LAUNCHES.reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        net.fit(it, epochs=1)
        losses = [float(v) for v in main.losses]
        epoch_s = time.perf_counter() - t0
        ref = _StepLosses(matmul.LAUNCHES)
        twin.set_listeners(ref)
        prev = dispatch.set_dispatch_mode("reference")
        try:
            matmul.LAUNCHES.reset()
            twin.fit(it, epochs=1)
            ref_losses = [float(v) for v in ref.losses]
        finally:
            dispatch.set_dispatch_mode(prev)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    steps = -(-rows // batch)
    rel = [abs(a - r) / abs(r) for a, r in zip(losses, ref_losses)]
    require(len(losses) == len(ref_losses) == steps and net.epoch == 1,
            f"records_train: {len(losses)} steps, {len(ref_losses)} in reference mode, "
            f"want {steps}")
    require(all(math.isfinite(v) for v in losses + ref_losses), "records_train: non-finite loss")
    require(max(rel) <= F32_RTOL, f"records_train losses {losses} vs reference {ref_losses}")
    require(main.launches == [1] * steps and ref.launches == [0] * steps,
            f"records_train: fused_dense launches a step {main.launches}, in reference mode "
            f"{ref.launches}")
    emit("records_train", rows=rows, feature_columns=n_feat, classes=classes, batch=batch,
         reader="CSVRecordReader -> TransformProcess(categorical_to_integer) -> "
                "RecordReaderDataSetIterator -> NormalizerStandardize",
         model="Dense 784->500 relu, Output 500->10 softmax", updater="Adam(1e-3)",
         steps=steps, losses=losses, reference_losses=ref_losses, rel_loss_diff=rel,
         launches_per_step=main.launches, csv_write_s=write_s, reader_pass_s=read_s,
         epoch_s=epoch_s)
    return {"launches": sum(main.launches), "steps": steps}


def _charlm_data(dev, batch, t, vocab, seed=0):
    """bench.py's char-LM batch: RandomState ids, one-hot x, y the ids
    rolled by one step."""
    idx = np.random.RandomState(seed).randint(0, vocab, (batch, t))
    eye = np.eye(vocab, dtype=np.float32)
    return (torch.as_tensor(eye[idx], device=dev),
            torch.as_tensor(eye[np.roll(idx, -1, 1)], device=dev))


def _eager_losses(net, x, y, steps, **masks):
    """`steps` fit calls, each read back: (losses, host ms a step)."""
    losses, ms = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        net.fit(x, y, **masks)
        losses.append(net.score())
        ms.append((time.perf_counter() - t0) * 1e3)
    return losses, ms


def _in_reference_mode(dispatch, fn):
    prev = dispatch.set_dispatch_mode("reference")
    try:
        return fn()
    finally:
        dispatch.set_dispatch_mode(prev)


def _twin(make, state):
    """A net built by `make()` with `state` loaded."""
    twin = make()
    twin.load_state_dict(state)
    return twin


def phase_charlm(zoo, dispatch, dev, shape=CHARLM, k=CHARLM_K):
    """bench.py's LSTM char-LM blocks as CUDA graphs (phase 40 of the
    module docstring)."""
    batch, t, vocab = shape
    tag = "charlm"
    steps = 2 * k

    def make():
        return zoo.TextGenLSTM(n_classes=vocab, input_shape=(t, vocab)).init_model(device=dev)

    x, y = _charlm_data(dev, batch, t, vocab)
    net = make()
    state = {n: v.clone() for n, v in net.state_dict().items()}
    # the eager twin and a reference-mode twin: 2k fit steps each
    twin = _twin(make, state)
    eager, eager_ms = _eager_losses(twin, x, y, steps)
    want_params = [p.clone() for p in twin.parameters()]
    del twin
    ref, _ = _in_reference_mode(
        dispatch, lambda: _eager_losses(_twin(make, state), x, y, steps))
    ref_rel = _rel(eager, ref)
    require(max(ref_rel) <= F32_RTOL,
            f"{tag}: eager losses {eager} part from reference mode's {ref} by {max(ref_rel)}")

    # the main path: stride-0 blocks of k, as bench.py's _time_train builds them
    xs, ys = x.broadcast_to((k,) + x.shape), y.broadcast_to((k,) + y.shape)
    torch.cuda.reset_peak_memory_stats()
    first, first_ms = _synced(lambda: net.fit_steps(xs, ys))
    step = net._scan_step
    (rec,) = step._graphs.values()
    replays = _counting_replays(rec.graph)
    second, second_ms = _synced(lambda: net.fit_steps(xs, ys))
    peak = torch.cuda.max_memory_allocated()
    losses = first.tolist() + second.tolist()
    differ = [i for i, (a, b) in enumerate(zip(net.parameters(), want_params))
              if not torch.equal(a, b)]
    require(losses == eager, f"{tag}: graph losses {losses} != eager {eager}")
    require(not differ, f"{tag}: parameters {differ} differ from the eager twin's")
    require(step.captures == 1 and replays["replays"] == 1 and net.iteration == steps,
            f"{tag}: {step.captures} captures, {replays['replays']} replays for one block, "
            f"iteration {net.iteration}")
    block_ms = []
    for _ in range(CHARLM_TIMED_BLOCKS):
        block_ms.append(_synced(lambda: net.fit_steps(xs, ys))[1])
    require(replays["replays"] == 1 + CHARLM_TIMED_BLOCKS and step.captures == 1,
            f"{tag}: {replays['replays']} replays, {step.captures} captures")
    window_ms, busy_ms, by_name, n_kernels = _trace(lambda: net.fit_steps(xs, ys))
    require(busy_ms is not None, f"{tag}: the profiler saw no device activity")
    dot = _kept_dot(net, "_scan_step", None, lambda: net.fit_steps(xs, ys))
    nodes = dot.count("KERNEL")
    require(nodes > 0, f"{tag}: the debug-mode capture holds no kernel node")
    net._scan_step = None
    torch.cuda.empty_cache()

    # a masked step at T = 40: features and labels masks cut half the rows
    mt, cut = CHARLM_MASKED
    xm, ym = _charlm_data(dev, batch, mt, vocab, seed=1)
    mask = torch.ones((batch, mt), device=dev)
    mask[::2, cut:] = 0
    masks = dict(features_mask=mask, labels_mask=mask)
    masked, _ = _eager_losses(_twin(make, state), xm, ym, 1, **masks)
    masked_ref, _ = _in_reference_mode(
        dispatch, lambda: _eager_losses(_twin(make, state), xm, ym, 1, **masks))
    masked_rel = _rel(masked, masked_ref)[0]
    require(math.isfinite(masked[0]) and masked_rel <= F32_RTOL,
            f"{tag}: masked loss {masked} against reference mode's {masked_ref}")
    graph_ms = statistics.median(block_ms) / k
    eager_step_ms = statistics.median(eager_ms[1:])
    report = dict(
        k=k, losses=losses, eager_losses=eager, reference_losses=ref,
        max_rel_diff_to_reference=max(ref_rel), bitwise_equal=True,
        captures=step.captures, replays=replays["replays"],
        capture_s=step.capture_seconds[0], first_block_ms=first_ms,
        block_ms_all=[second_ms] + block_ms, graph_step_ms=graph_ms,
        eager_step_ms=eager_step_ms, eager_step_ms_all=eager_ms,
        graph_tokens_per_sec=batch * t * 1e3 / graph_ms,
        eager_tokens_per_sec=batch * t * 1e3 / eager_step_ms,
        block_window_ms=window_ms, block_busy_ms=busy_ms,
        block_idle_share=max(0.0, 1.0 - busy_ms / window_ms), block_kernels=n_kernels,
        graph_kernel_nodes=nodes, max_memory_allocated_gb=peak / 1e9,
        masked_step={"T": mt, "rows_cut_to": cut, "loss": masked[0],
                     "reference_loss": masked_ref[0], "rel_diff": masked_rel},
        top=_top(by_name, 8))
    emit("charlm", model="TextGenLSTM", vocab=vocab, T=t, batch=batch, lstm_units=256,
         updater="Adam(1e-3)", dtype="float32", tf32=False, **report)
    del net
    torch.cuda.empty_cache()
    return report


def _seq_attention_conf(nn, train, vocab, t, units, heads, classes):
    return (nn.NeuralNetConfiguration.builder().seed(123).updater(train.Adam(1e-3))
            .weight_init("XAVIER")
            .list([nn.LSTM(n_out=units, activation="tanh"),
                   nn.SelfAttentionLayer(n_out=units, n_heads=heads),
                   nn.GlobalPoolingLayer(pooling_type="AVG"),
                   nn.OutputLayer(n_out=classes, loss="mcxent", activation="softmax")])
            .set_input_type(nn.InputType.recurrent(vocab, t)).build())


def _attn_counts(attention):
    return (attention.LAUNCHES.value, attention.DQ_LAUNCHES.value,
            attention.DKV_LAUNCHES.value)


def _reset_attn(attention):
    for c in (attention.LAUNCHES, attention.DQ_LAUNCHES, attention.DKV_LAUNCHES):
        c.reset()


def phase_seq_attention(nn, train, dispatch, attention, matmul, dev, shape=SEQ_ATTN):
    """The attention layers' kernels on a sequence net (phase 41 of the
    module docstring)."""
    batch, t, vocab, units, heads, classes, drop, k = shape
    tag = "seq_attention"
    conf = _seq_attention_conf(nn, train, vocab, t, units, heads, classes)
    # the kernels a step launches, from the configuration: one flash forward,
    # one dQ and one dK/dV for each projected attention layer
    n_attn = sum(isinstance(l, nn.SelfAttentionLayer) and l.project_input
                 for l in conf.layers)
    per_step = (n_attn, n_attn, n_attn)
    rng = np.random.RandomState(0)
    x = torch.as_tensor(np.eye(vocab, dtype=np.float32)[rng.randint(0, vocab, (batch, t))],
                        device=dev)
    y = torch.as_tensor(np.eye(classes, dtype=np.float32)[rng.randint(0, classes, batch)],
                        device=dev)
    fmask = torch.ones((batch, t), device=dev)
    fmask[::2, t - drop:] = 0
    masks = {"float32": fmask, "int32": fmask.to(torch.int32)}

    def make():
        return nn.MultiLayerNetwork(
            _seq_attention_conf(nn, train, vocab, t, units, heads, classes), device=dev).init()

    net = make()
    state = {n: v.clone() for n, v in net.state_dict().items()}
    twin = _twin(make, state)           # auto mode, eager: the replay's twin
    ref = _twin(make, state)            # reference mode
    losses, ref_losses, counts, step_ms = [], [], [], []
    for m in masks.values():
        _reset_attn(attention)
        matmul.LAUNCHES.reset()
        (_, ms) = _synced(lambda: net.fit(x, y, features_mask=m))
        counts.append(_attn_counts(attention) + (matmul.LAUNCHES.value,))
        losses.append(net.score())
        step_ms.append(ms)
        twin.fit(x, y, features_mask=m)
        require(twin.score() == losses[-1], f"{tag}: two auto-mode nets part at a step")
        _reset_attn(attention)
        _in_reference_mode(dispatch, lambda: ref.fit(x, y, features_mask=m))
        require(_attn_counts(attention) == (0, 0, 0), f"{tag}: reference mode launched")
        ref_losses.append(ref.score())
    require(all(c == per_step + (0,) for c in counts),
            f"{tag}: launches a step {counts}, want {per_step} and no fused_dense")
    rel = _rel(losses, ref_losses)
    require(max(rel) <= F32_RTOL, f"{tag}: losses {losses} against reference {ref_losses}")

    # one fit_steps block of k with the float mask, against k eager steps
    xs, ys = x.broadcast_to((k,) + x.shape), y.broadcast_to((k,) + y.shape)
    fms = fmask.broadcast_to((k,) + fmask.shape)
    _reset_attn(attention)
    block = net.fit_steps(xs, ys, features_masks=fms).tolist()
    at_capture = _attn_counts(attention)
    eager = _eager_losses(twin, x, y, k, features_mask=fmask)[0]
    ref_block = _in_reference_mode(
        dispatch, lambda: _eager_losses(ref, x, y, k, features_mask=fmask)[0])
    block_rel = _rel(block, ref_block)
    require(block == eager, f"{tag}: graph losses {block} != eager {eager}")
    require(max(block_rel) <= F32_RTOL, f"{tag}: block {block} against reference {ref_block}")
    require(at_capture == tuple((k + 1) * n for n in per_step),
            f"{tag}: counted {at_capture} at the warm-up and capture of a block of {k}")
    dot = _kept_dot(net, "_scan_step", None,
                    lambda: net.fit_steps(xs, ys, features_masks=fms))
    nodes = {name: dot.count(kernel) for name, kernel in BERT_KERNEL_TAGS[:3]}
    require(nodes == {name: k * n for (name, _), n in zip(BERT_KERNEL_TAGS, per_step)},
            f"{tag}: a replayed block holds {nodes} kernel nodes")
    net._scan_step = None

    # LearnedSelfAttentionLayer on the LSTM's output: T = 4 queries over S = 128
    h = net.feed_forward(x)[1]
    learned = nn.LearnedSelfAttentionLayer(n_queries=4, n_heads=heads, weight_init="XAVIER")
    p, _, _ = learned.initialize(torch.Generator(device=dev).manual_seed(1),
                                 nn.InputType.recurrent(units, t), torch.float32, dev)
    _reset_attn(attention)
    with torch.no_grad():
        got = learned.apply(p, {}, h, mask=masks["int32"])[0]
        learned_launches = _attn_counts(attention)[0]
        want = _in_reference_mode(dispatch, lambda: learned.apply(p, {}, h, mask=fmask)[0])
    err = (got - want).abs().max().item()
    rmax = want.abs().max().item()
    require(learned_launches == 1 and err <= F32_RTOL * rmax,
            f"{tag}: learned queries {learned_launches} launches, max|diff| {err} of {rmax}")
    report = dict(
        layers="LSTM(256) -> SelfAttentionLayer(256, 4 heads) -> GlobalPooling(AVG) -> "
               "Output(10)", head_size=units // heads, mask_dtypes=list(masks),
        losses=losses, reference_losses=ref_losses, max_rel_diff=max(rel),
        launches_per_step=dict(zip(("flash_attn_fwd", "flash_attn_bwd_dq",
                                    "flash_attn_bwd_dkv", "fused_dense"), counts[0])),
        derived_per_step=per_step, step_ms=step_ms, k=k, block_losses=block,
        block_eager_losses=eager, block_reference_losses=ref_block,
        block_max_rel_diff=max(block_rel), block_counted_at_capture=at_capture,
        replay_nodes=nodes, learned_queries={"T": 4, "S": t, "launches": learned_launches,
                                             "max_abs_err": err, "ref_max": rmax})
    emit(tag, batch=batch, T=t, vocab=vocab, **report)
    del net, twin, ref
    torch.cuda.empty_cache()
    return report


# ---------------------------------------------------------------------------
# SameDiff: bench.py's TF-import fine-tune, and graphs that reach the kernels
# ---------------------------------------------------------------------------

def bert_weights(t=128, layers=12, hidden=768, vocab=30522):
    """bench.py's BERT weights: ``RandomState(0)`` draws in its order, by its
    names (LayerNorm gains one, biases zero)."""
    rs = np.random.RandomState(0)
    H = hidden
    w = {"tok_emb": rs.randn(vocab, H).astype(np.float32) * 0.02,
         "pos_emb": rs.randn(t, H).astype(np.float32) * 0.02}
    for l in range(layers):
        for k in ["wq", "wk", "wv", "wo"]:
            w[f"{l}.{k}"] = rs.randn(H, H).astype(np.float32) * 0.02
        w[f"{l}.w1"] = rs.randn(H, 4 * H).astype(np.float32) * 0.02
        w[f"{l}.w2"] = rs.randn(4 * H, H).astype(np.float32) * 0.02
        w[f"{l}.g1"] = np.ones(H, np.float32)
        w[f"{l}.b1"] = np.zeros(H, np.float32)
        w[f"{l}.g2"] = np.ones(H, np.float32)
        w[f"{l}.b2"] = np.zeros(H, np.float32)
    return w


def bert_graph_def(batch=32, t=128, layers=12, hidden=768, heads=12, vocab=30522):
    """The frozen GraphDef of ``bench.py``'s ``build_tf_bert_frozen``, written
    without TensorFlow through the port's protobuf encoder: the same ops (a
    Placeholder, Consts, GatherV2, AddV2, Reshape, MatMul, Transpose,
    BatchMatMulV2 with ``adj_y``, RealDiv, Softmax, Mean, Sub,
    SquaredDifference, Rsqrt, Mul, Erf and a final Identity: 7 + 85 a layer
    nodes), the same shapes and the weights drawn from
    ``RandomState(0)`` in bench.py's order.  A one-valued Const (a LayerNorm
    gain or bias) is written as one typed value that TF's fill rule
    repeats, as TF's constant folding writes it.  Returns (the serialized
    GraphDef, the weights by bench.py's names, the output node's name)."""
    from deeplearning4j_tpu_torch.modelimport import tf_proto as tp

    H, NH, L, T, B = hidden, heads, layers, t, batch
    w = bert_weights(t, layers, hidden, vocab)
    nodes, counts = [], {}
    F32, I32 = tp.DT_FLOAT, tp.DT_INT32

    def fresh(base):
        n = counts.get(base, 0)
        counts[base] = n + 1
        return base if n == 0 else f"{base}_{n}"

    def node(op, base, inputs, **attrs):
        name = fresh(base)
        nodes.append(tp.NodeDef(name=name, op=op, input=list(inputs), attr=attrs))
        return name

    def const(name, value):
        a = np.asarray(value)
        if a.dtype == np.float32 and a.size > 1 and (a == a.reshape(-1)[0]).all():
            t_ = tp.TensorProto(dtype=tp.data_type(a.dtype), tensor_shape=tp.make_shape(a.shape))
            t_.float_val = [float(a.reshape(-1)[0])]
        else:
            t_ = tp.make_tensor_proto(a)
        nodes.append(tp.NodeDef(name=name, op="Const", input=[], attr={
            "dtype": tp.AttrValue(type=tp.data_type(a.dtype)), "value": tp.AttrValue(tensor=t_)}))
        return name

    def T_(dt=F32):
        return tp.AttrValue(type=dt)

    def b_(v):
        return tp.AttrValue(b=v)

    def binary(op, base, a, b):
        return node(op, base, [a, b], T=T_())

    def reshape(x, shape):
        name = fresh("Reshape")
        counts["Reshape"] -= 1
        s = const(f"{name}/shape", np.asarray(shape, np.int32))
        return node("Reshape", "Reshape", [x, s], T=T_(), Tshape=T_(I32))

    def matmul(x, wname):
        name = fresh("MatMul")
        counts["MatMul"] -= 1
        wc = const(f"{name}/b", w[wname])
        return node("MatMul", "MatMul", [x, wc], T=T_(), transpose_a=b_(False),
                    transpose_b=b_(False))

    def transpose(x):
        name = fresh("transpose")
        counts["transpose"] -= 1
        p = const(f"{name}/perm", np.asarray([0, 2, 1, 3], np.int32))
        return node("Transpose", "transpose", [x, p], T=T_(), Tperm=T_(I32))

    def bmm(a, b, adj_y):
        return node("BatchMatMulV2", "MatMul", [a, b], T=T_(), adj_x=b_(False),
                    adj_y=b_(adj_y))

    def with_const(op, base, x, value, const_first=False):
        name = fresh(base)
        counts[base] -= 1
        c = const(f"{name}/{'x' if const_first else 'y'}", np.asarray(value, np.float32))
        return binary(op, base, *((c, x) if const_first else (x, c)))

    def mean(x):
        name = fresh("Mean")
        counts["Mean"] -= 1
        ri = const(f"{name}/reduction_indices", np.int32(-1))
        return node("Mean", "Mean", [x, ri], T=T_(), Tidx=T_(I32), keep_dims=b_(True))

    def layer_norm(x, g, b):
        mu = mean(x)
        d = binary("Sub", "sub", x, mu)
        var = mean(binary("SquaredDifference", "SquaredDifference", x, mu))
        r = node("Rsqrt", "Rsqrt", [with_const("AddV2", "add", var, 1e-6)], T=T_())
        y = with_const("Mul", "mul", binary("Mul", "mul", d, r), w[g])
        return with_const("AddV2", "add", y, w[b])

    ids = node("Placeholder", "ids", [], dtype=T_(I32),
               shape=tp.AttrValue(shape=tp.make_shape((B, T))))
    params = const("GatherV2/params", w["tok_emb"])
    axis = const("GatherV2/axis", np.int32(0))
    x = node("GatherV2", "GatherV2", [params, ids, axis], Taxis=T_(I32), Tindices=T_(I32),
             Tparams=T_(), batch_dims=tp.AttrValue(i=0))
    x = with_const("AddV2", "add", x, w["pos_emb"])
    dh = H // NH
    for l in range(L):
        def heads_of(k):
            y = reshape(matmul(reshape(x, [B * T, H]), f"{l}.{k}"), [B, T, NH, dh])
            return transpose(y)
        q, k_ = heads_of("wq"), heads_of("wk")
        s = with_const("RealDiv", "truediv", bmm(q, k_, True), np.float32(np.sqrt(dh)))
        p = node("Softmax", "Softmax", [s], T=T_())
        ctx = bmm(p, heads_of("wv"), False)
        ctx = reshape(transpose(ctx), [B, T, H])
        a = reshape(matmul(reshape(ctx, [B * T, H]), f"{l}.wo"), [B, T, H])
        x = layer_norm(binary("AddV2", "add", x, a), f"{l}.g1", f"{l}.b1")
        h = matmul(reshape(x, [B * T, H]), f"{l}.w1")
        half = with_const("Mul", "mul", h, 0.5, const_first=True)
        e = node("Erf", "Erf", [with_const("RealDiv", "truediv", h,
                                           np.sqrt(2.0).astype(np.float32))], T=T_())
        h = binary("Mul", "mul", half, with_const("AddV2", "add", e, 1.0, const_first=True))
        h = reshape(matmul(h, f"{l}.w2"), [B, T, H])
        x = layer_norm(binary("AddV2", "add", x, h), f"{l}.g2", f"{l}.b2")
    out = node("Identity", "Identity", [x], T=T_())
    gd = tp.GraphDef(node=nodes, versions=tp.VersionDef(producer=1))
    return gd.SerializeToString(), w, out


def bert_plain_forward(w, ids, layers, heads):
    """bench.py's BERT encoder written out in plain PyTorch on the weights
    of `bert_graph_def` (a yardstick independent of the graph engine and
    the importer)."""
    dev = ids.device
    t = {k: torch.as_tensor(v, device=dev) for k, v in w.items()}
    B, T = ids.shape
    H = t["tok_emb"].shape[1]
    dh = H // heads

    def ln(x, g, b):
        mu = x.mean(-1, keepdim=True)
        var = ((x - mu) ** 2).mean(-1, keepdim=True)
        return (x - mu) * torch.rsqrt(var + 1e-6) * g + b

    x = t["tok_emb"][ids.long()] + t["pos_emb"]
    for l in range(layers):
        def heads_of(k):
            return (x.reshape(B * T, H) @ t[f"{l}.{k}"]).reshape(B, T, heads, dh).transpose(1, 2)
        q, k, v = heads_of("wq"), heads_of("wk"), heads_of("wv")
        p = torch.softmax(q @ k.transpose(-1, -2) / math.sqrt(dh), dim=-1)
        ctx = (p @ v).transpose(1, 2).reshape(B * T, H)
        x = ln(x + (ctx @ t[f"{l}.wo"]).reshape(B, T, H), t[f"{l}.g1"], t[f"{l}.b1"])
        h = x.reshape(B * T, H) @ t[f"{l}.w1"]
        h = 0.5 * h * (1.0 + torch.erf(h / math.sqrt(2.0)))
        x = ln(x + (h @ t[f"{l}.w2"]).reshape(B, T, H), t[f"{l}.g2"], t[f"{l}.b2"])
    return x


def _sd_state(sd):
    """The tensors a SameDiff step writes, cloned, with the iteration."""
    from deeplearning4j_tpu_torch.train.updaters import tree_leaves
    return ([v.clone() for v in sd.variables_.values()],
            [l.clone() for l in tree_leaves(sd.opt_state_)], sd.iteration)


def _sd_restore(sd, state):
    """Write `state` back into the same tensors (their addresses stay)."""
    from deeplearning4j_tpu_torch.train.updaters import tree_leaves
    vs, opt, it = state
    with torch.no_grad():
        for dst, src in zip(list(sd.variables_.values()) + list(tree_leaves(sd.opt_state_)),
                            vs + opt):
            dst.copy_(src)
    sd.iteration = it


def phase_sd_tf_bert(autodiff, modelimport, Adam, dev, shape=SD_BERT, k=SD_BERT_K):
    """BASELINE config 3 as bench.py runs it (phase 42 of the module
    docstring)."""
    tag = "sd_tf_bert"
    B, T, L, H, NH, V = shape
    t0 = time.perf_counter()
    graph_bytes, w, enc = bert_graph_def(B, T, L, H, NH, V)
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    sd = modelimport.import_graph_def(graph_bytes, device=dev)
    torch.cuda.synchronize()
    import_s = time.perf_counter() - t0
    gd_nodes = len(modelimport.tf_proto.GraphDef.FromString(graph_bytes).node)
    n_nodes = len(sd._nodes)
    require(gd_nodes == 7 + 85 * L, f"{tag}: the GraphDef has {gd_nodes} nodes, "
            f"want {7 + 85 * L}")
    rs = np.random.RandomState(0)
    ids = torch.as_tensor(rs.randint(0, V, (B, T)).astype(np.int32), device=dev)
    lab = torch.as_tensor(rs.randint(0, V, (B, T)).astype(np.int32), device=dev)

    # the imported encoder against the plain forward on the same weights
    got = sd.output({"ids": ids}, enc)[enc]
    ref = bert_plain_forward(w, ids, L, NH)
    enc_err = (got - ref).abs().max().item()
    enc_max = ref.abs().max().item()
    require(got.shape == (B, T, H) and got.dtype == torch.float32
            and bool(torch.isfinite(got).all()) and enc_err <= F32_RTOL * enc_max,
            f"{tag}: encoder {tuple(got.shape)} {got.dtype} max|diff| {enc_err} against "
            f"the plain forward's max {enc_max}")

    # bench.py's head: XAVIER head_w, matmul, sparse softmax CE, Adam(1e-4)
    w_head = sd.var("head_w", "XAVIER", H, V)
    logits = sd.op("matmul", sd.get_variable(enc), w_head, name="logits")
    labv = sd.placeholder("lab", (B, T))
    sd.loss.sparse_softmax_cross_entropy(labv, logits, name="loss")
    sd.set_loss_variables("loss")
    sd.set_training_config(autodiff.TrainingConfig(
        updater=Adam(1e-4), data_set_feature_mapping=["ids"],
        data_set_label_mapping=["lab"]))
    w0 = sd.variables_["head_w"].clone()
    sd.fit(ids, lab)
    loss1 = sd.score()
    # an independent step: autograd through the plain forward, Adam by hand
    wr = w0.clone().requires_grad_(True)
    ref_loss = torch.nn.functional.cross_entropy((ref @ wr).reshape(-1, V), lab.reshape(-1).long())
    (g,) = torch.autograd.grad(ref_loss, [wr])
    m, v = 0.1 * g, 0.001 * g * g
    alpha = 1e-4 * math.sqrt(1 - 0.999) / (1 - 0.9)
    w1_ref = w0 - alpha * m / (torch.sqrt(v) + 1e-8)
    w1 = sd.variables_["head_w"]
    loss_rel = abs(loss1 - ref_loss.item()) / abs(ref_loss.item())
    w_err = (w1 - w1_ref).abs().max().item()
    upd_err = ((w1 - w0) - (w1_ref - w0)).abs().max().item()
    upd_max = (w1_ref - w0).abs().max().item()
    require(loss_rel <= 1e-5 and w_err <= 1e-5 * w1_ref.abs().max().item(),
            f"{tag}: first step loss {loss1} against {ref_loss.item()} (rel {loss_rel}), "
            f"head_w max|diff| {w_err}")
    del wr, g, m, v, w1_ref, ref

    # timed as bench.py times it: 2 warm-up and 5 timed steps, synced by score()
    torch.cuda.reset_peak_memory_stats()
    for _ in range(2):
        sd.fit(ids, lab)
    sd.score()
    t0 = time.perf_counter()
    for _ in range(5):
        sd.fit(ids, lab)
    sd.score()
    dt = time.perf_counter() - t0
    step_ms = dt * 1e3 / 5
    peak = torch.cuda.max_memory_allocated()
    window_ms, busy_ms, by_name, n_kernels = _trace(lambda: sd.fit(ids, lab))
    require(busy_ms is not None, f"{tag}: the profiler saw no device activity")

    # fit_steps: one block of k as one replay, bitwise against k eager steps
    start = _sd_state(sd)
    eager = []
    for _ in range(k):
        sd.fit(ids, lab)
        eager.append(sd.score())
    want_w = sd.variables_["head_w"].clone()
    _sd_restore(sd, start)
    block = {"ids": ids.broadcast_to((k, B, T)), "lab": lab.broadcast_to((k, B, T))}
    graph_losses = sd.fit_steps(block).tolist()
    require(graph_losses == eager and torch.equal(sd.variables_["head_w"], want_w),
            f"{tag}: replayed losses {graph_losses} != eager {eager}, or head_w differs")
    step = sd._scan_step
    (rec,) = step._graphs.values()
    replays = _counting_replays(rec.graph)
    _sd_restore(sd, start)
    again = sd.fit_steps(block).tolist()
    require(again == eager and step.captures == 1 and replays["replays"] == 1,
            f"{tag}: second block {again}, {step.captures} captures, "
            f"{replays['replays']} replays")
    block_ms = [_synced(lambda: sd.fit_steps(block))[1] for _ in range(3)]
    graph_step_ms = statistics.median(block_ms) / k
    report = dict(
        graph_def_nodes=gd_nodes, samediff_nodes=n_nodes, graph_bytes=len(graph_bytes), build_s=build_s,
        import_s=import_s, encoder_max_abs_err=enc_err, encoder_max_abs_ref=enc_max,
        first_loss=loss1, first_loss_reference=ref_loss.item(), first_loss_rel=loss_rel,
        head_w_max_abs_err=w_err, head_update_max_abs_err=upd_err,
        head_update_max_abs=upd_max, step_ms=step_ms, tokens_per_sec=B * T * 5 / dt,
        max_memory_allocated_gb=peak / 1e9, step_window_ms=window_ms,
        step_busy_ms=busy_ms, step_idle_share=max(0.0, 1.0 - busy_ms / window_ms),
        step_kernels=n_kernels, top=_top(by_name, 10), k=k, eager_losses=eager,
        graph_losses=graph_losses, bitwise_equal=True, captures=step.captures,
        replays_a_block=1, capture_s=step.capture_seconds[0], block_ms_all=block_ms,
        graph_step_ms=graph_step_ms, graph_tokens_per_sec=B * T * 1e3 / graph_step_ms)
    emit(tag, model="BERT-base TF GraphDef (bench.py build_tf_bert_frozen)", batch=B, T=T,
         layers=L, hidden=H, heads=NH, vocab=V, dtype="float32", tf32=False,
         updater="Adam(1e-4)", tensorflow_installed=_has_module("tensorflow"), **report)
    del sd, block
    torch.cuda.empty_cache()
    return report


#: phase 60: nodes of ``bert_onnx_model`` (6 Constants and the embedding
#: pair, then 33 a layer, 2 of them LayerNormalization)
ONNX_BERT_NODES = (8, 33)
#: phase 61: the imported ResNet-50: batch and image of the parity check,
#: classes, and single-row requests through ``submit``
#: branch_gamma: the range of each residual branch's last BatchNorm scale;
#: imprint_logit: an imprinted class's logit on its image; int8_logits_rel_l2:
#: the bound on the int8 model's logits against the f32 ones, L2 relative
ONNX_R50 = dict(batch=16, image=224, classes=1000, requests=64, branch_gamma=(0.1, 0.3),
                imprint_logit=8.0, int8_logits_rel_l2=0.1)
#: phase 62: ``quantized_mha`` at BERT-base width: x [B, T, F], heads
QMHA = (8, 128, 768, 12)


def bert_onnx_model(batch=32, t=128, layers=12, hidden=768, heads=12, vocab=30522):
    """bench.py's BERT encoder (the weights of `bert_weights`, the math of
    `bert_plain_forward`) as an ONNX exporter writes it, through the port's
    ``onnx_proto`` writer: int64 ids, Gather, MatMul + Add projections (zero
    biases), Reshape (0 copies a dim) and Transpose into heads (keys to [B,
    H, dh, T]), MatMul, Div, Softmax, opset-17 LayerNormalization (axis -1,
    epsilon 1e-6, as bench.py's), GELU as the Erf composition, and the
    shapes and scalars as Constant nodes.  Returns (the serialized model,
    the weights, the output's name)."""
    from deeplearning4j_tpu_torch.modelimport import onnx_proto as op

    H, NH, L, T, B = hidden, heads, layers, t, batch
    dh = H // NH
    w = bert_weights(t, layers, hidden, vocab)
    inits = dict(w)
    nodes = []

    def node(op_type, ins, out, *attrs):
        nodes.append(op.NodeProto(op_type=op_type, name=out, input=list(ins), output=[out],
                                  attribute=list(attrs)))
        return out

    for name, value in (("heads_shape", np.asarray([0, 0, NH, dh], np.int64)),
                        ("merge_shape", np.asarray([0, 0, H], np.int64)),
                        ("sqrt_dh", np.float32(np.sqrt(dh))),
                        ("sqrt2", np.float32(np.sqrt(2.0))),
                        ("one", np.float32(1.0)), ("half", np.float32(0.5))):
        node("Constant", [], name, op.attr_t("value", value))

    def dense(x, wname, out):
        inits[f"{wname}.bias"] = np.zeros(inits[wname].shape[1], np.float32)
        return node("Add", [node("MatMul", [x, wname], f"{out}/MatMul"), f"{wname}.bias"], out)

    def layer_norm(x, g, b, out):
        return node("LayerNormalization", [x, g, b], out, op.attr_i("axis", -1),
                    op.attr_f("epsilon", 1e-6))

    x = node("Add", [node("Gather", ["tok_emb", "ids"], "emb", op.attr_i("axis", 0)),
                     "pos_emb"], "x0")
    for l in range(L):
        p = f"l{l}"

        def heads_of(k, perm):
            r = node("Reshape", [dense(x, f"{l}.{k}", f"{p}/{k}"), "heads_shape"],
                     f"{p}/{k}/heads")
            return node("Transpose", [r], f"{p}/{k}/t", op.attr_ints("perm", perm))
        q = heads_of("wq", [0, 2, 1, 3])
        kt = heads_of("wk", [0, 2, 3, 1])
        v = heads_of("wv", [0, 2, 1, 3])
        s = node("Div", [node("MatMul", [q, kt], f"{p}/scores"), "sqrt_dh"], f"{p}/scaled")
        pr = node("Softmax", [s], f"{p}/probs", op.attr_i("axis", -1))
        ctx = node("Transpose", [node("MatMul", [pr, v], f"{p}/ctx")], f"{p}/ctx/t",
                   op.attr_ints("perm", [0, 2, 1, 3]))
        ctx = node("Reshape", [ctx, "merge_shape"], f"{p}/ctx/merged")
        a = dense(ctx, f"{l}.wo", f"{p}/attn")
        x = layer_norm(node("Add", [x, a], f"{p}/res1"), f"{l}.g1", f"{l}.b1", f"{p}/ln1")
        h = dense(x, f"{l}.w1", f"{p}/ff1")
        e = node("Erf", [node("Div", [h, "sqrt2"], f"{p}/ff1/div")], f"{p}/ff1/erf")
        g = node("Mul", [h, node("Add", [e, "one"], f"{p}/ff1/add")], f"{p}/ff1/mul")
        h = dense(node("Mul", [g, "half"], f"{p}/gelu"), f"{l}.w2", f"{p}/ff2")
        x = layer_norm(node("Add", [x, h], f"{p}/res2"), f"{l}.g2", f"{l}.b2", f"{p}/ln2")
    graph = op.GraphProto(
        name="bert", node=nodes,
        initializer=[op.TensorProto.from_array(a, name=k) for k, a in inits.items()],
        input=[op.ValueInfoProto(name="ids", elem_type=op.INT64, shape=[B, T])],
        output=[op.ValueInfoProto(name=x, shape=[B, T, H])])
    return op.ModelProto(graph=graph).serialize(), w, x


def phase_onnx_bert(modelimport, autodiff, layer_norm, Adam, dev, sd_bert, shape=SD_BERT,
                    k=SD_BERT_K):
    """BERT-base imported from ONNX and fine-tuned (phase 60 of the module
    docstring); `sd_bert` is phase 42's report."""
    from deeplearning4j_tpu_torch.modelimport import onnx_proto
    tag = "onnx_bert"
    B, T, L, H, NH, V = shape
    t0 = time.perf_counter()
    model_bytes, w, enc = bert_onnx_model(B, T, L, H, NH, V)
    write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    sd = modelimport.import_onnx_model(model_bytes, device=dev)
    torch.cuda.synchronize()
    import_s = time.perf_counter() - t0
    graph = onnx_proto.load_model(model_bytes).graph
    n_nodes = len(graph.node)
    n_ln = sum(n.op_type == "LayerNormalization" for n in graph.node)
    want_nodes = ONNX_BERT_NODES[0] + ONNX_BERT_NODES[1] * L
    require(n_nodes == want_nodes and n_ln == 2 * L,
            f"{tag}: the model has {n_nodes} nodes ({n_ln} LayerNormalization), want "
            f"{want_nodes} ({2 * L})")
    del graph
    rs = np.random.RandomState(0)
    ids = torch.as_tensor(rs.randint(0, V, (B, T)).astype(np.int64), device=dev)
    lab = torch.as_tensor(rs.randint(0, V, (B, T)).astype(np.int32), device=dev)

    # the imported encoder against the plain forward on the same weights
    layer_norm.LAUNCHES.reset()
    got = sd.output({"ids": ids}, enc)[enc]
    torch.cuda.synchronize()
    fwd_launches = int(layer_norm.LAUNCHES.value)
    ref = bert_plain_forward(w, ids, L, NH)
    enc_err = (got - ref).abs().max().item()
    enc_max = ref.abs().max().item()
    require(got.shape == (B, T, H) and got.dtype == torch.float32
            and bool(torch.isfinite(got).all()) and enc_err <= F32_RTOL * enc_max,
            f"{tag}: encoder {tuple(got.shape)} {got.dtype} max|diff| {enc_err} against "
            f"the plain forward's max {enc_max}")
    require(fwd_launches == n_ln, f"{tag}: {fwd_launches} layer_norm launches in a forward, "
            f"want one a LayerNormalization node ({n_ln})")
    del got, ref

    # phase 42's head on the imported (trainable) encoder
    w_head = sd.var("head_w", "XAVIER", H, V)
    logits = sd.op("matmul", sd.get_variable(enc), w_head, name="logits")
    labv = sd.placeholder("lab", (B, T))
    sd.loss.sparse_softmax_cross_entropy(labv, logits, name="loss")
    sd.set_loss_variables("loss")
    sd.set_training_config(autodiff.TrainingConfig(
        updater=Adam(1e-4), data_set_feature_mapping=["ids"], data_set_label_mapping=["lab"]))
    torch.cuda.reset_peak_memory_stats()
    losses, ms, counts = _train_steps(sd, lambda: (sd.fit(ids, lab), sd._score)[1],
                                      (layer_norm.LAUNCHES, layer_norm.BWD_LAUNCHES), k)
    peak = torch.cuda.max_memory_allocated()
    ref_loss = sd_bert["first_loss_reference"]
    loss_rel = abs(losses[0] - ref_loss) / abs(ref_loss)
    require(loss_rel <= 1e-5 and all(math.isfinite(v) for v in losses),
            f"{tag}: first loss {losses[0]} against phase sd_tf_bert's independent step "
            f"{ref_loss} (rel {loss_rel}); losses {losses}")
    require(all(c == (n_ln, n_ln) for c in counts),
            f"{tag}: layer_norm launches a step (fwd, bwd) {counts}, want ({n_ln}, {n_ln})")
    steady = ms[1:]
    report = dict(
        onnx_nodes=n_nodes, onnx_nodes_formula=f"{ONNX_BERT_NODES[0]} + {ONNX_BERT_NODES[1]} x "
        f"{L} layers", layer_norm_nodes=n_ln, samediff_nodes=len(sd._nodes),
        model_bytes=len(model_bytes), write_s=write_s, import_s=import_s,
        trainable_variables=len(sd.variables_),
        trainable_params=sum(v.numel() for v in sd.variables_.values()),
        encoder_max_abs_err=enc_err, encoder_max_abs_ref=enc_max,
        layer_norm_fwd_launches_per_forward=fwd_launches,
        layer_norm_launches_per_step={"fwd": counts[0][0], "bwd": counts[0][1]},
        layer_norm_launches_each_step=[list(c) for c in counts],
        losses=losses, first_loss_reference=ref_loss, first_loss_rel=loss_rel,
        step_ms=statistics.median(steady), step_ms_all=ms,
        tokens_per_sec=B * T * len(steady) * 1e3 / sum(steady),
        max_memory_allocated_gb=peak / 1e9)
    emit(tag, model="BERT-base encoder as ONNX (bench.py's weights), + phase sd_tf_bert's head",
         batch=B, T=T, layers=L, hidden=H, heads=NH, vocab=V, dtype="float32", tf32=False,
         updater="Adam(1e-4)", **report)
    del sd, model_bytes, w
    torch.cuda.empty_cache()
    return report


def _same_pads(n, k, s):
    """(out, lo, hi) of a 'Same' window over n: TensorFlow's rule, the
    extra pad after."""
    out = -(-n // s)
    total = max((out - 1) * s + k - n, 0)
    return out, total // 2, total - total // 2


def calibrate_bn_stats(net, x, rs):
    """Set each BatchNorm's running mean and variance of a zoo ResNet
    (vertices ``<name>_conv`` -> ``<name>_bn``), in the graph's order, from
    the inference forward of `x` through the layers already set: the
    per-channel mean moved by up to half a standard deviation and the
    variance scaled by 0.5 to 2, both drawn from `rs`.  Each BatchNorm's
    output then has a mean within ~0.7 and a deviation within 0.7 to 1.4
    on `x`, so the activations stay O(1) and the softmax unsaturated
    (seeded statistics drawn without `x` let a random ResNet-50's logits
    grow to ~2e4).  Returns the number of forwards."""
    feeds = {"input": torch.as_tensor(x, device=net.device)}
    bns = [k for k, st in net.state_.items() if "mean" in st and k.endswith("_bn")]
    with torch.no_grad():
        for bn in bns:
            acts, _ = net._forward(net.params_, net.state_, feeds, train=False, rng=None)
            h = acts[bn[:-len("_bn")] + "_conv"]
            dims = tuple(range(h.ndim - 1))            # NHWC: over all but channels
            m, v = h.mean(dims), h.var(dims, unbiased=False)
            c = m.shape[0]
            st = net.state_[bn]
            st["mean"].copy_(m + v.sqrt() * torch.as_tensor(rs.uniform(-0.5, 0.5, c), dtype=m.dtype, device=m.device))
            st["var"].copy_(v * torch.as_tensor(rs.uniform(0.5, 2.0, c), dtype=m.dtype, device=m.device))
            del acts, h
    return len(bns)


def imprint_head(net, x, rs, scale):
    """Imprint the output layer of a zoo ResNet for the images `x` (Qi et
    al. 2018, imprinted weights): image i's class, drawn from `rs`, gets
    the direction of its centred pooled feature, and a bias that centres
    it, scaled so that its logit on image i is `scale`; the other classes
    keep their seeded weights.  Returns the classes."""
    out = net.params_["output"]
    with torch.no_grad():
        acts, _ = net._forward(net.params_, net.state_,
                               {"input": torch.as_tensor(x, device=net.device)},
                               train=False, rng=None)
        f = acts["avgpool"]
        centre = f.mean(0)
        d = f - centre
        w = scale * d / torch.linalg.vector_norm(d, dim=1, keepdim=True) ** 2
        classes = rs.choice(out["W"].shape[1], f.shape[0], replace=False)
        idx = torch.as_tensor(classes, device=f.device)
        out["W"][:, idx] = w.T
        out["b"][idx] = -(w @ centre)
    return classes


def resnet50_onnx_model(net, stages, image=224):
    """A zoo ResNet-50 ComputationGraph (the port's, NHWC) written as the
    NCHW ONNX graph an exporter gives: Conv (OIHW weights, no bias; 'Same'
    windows as explicit pads, uneven where the zoo pads unevenly),
    BatchNormalization in inference form (the running statistics), Relu,
    MaxPool, Add, GlobalAveragePool, Flatten, Gemm and Softmax.  Returns
    the serialized model; input "x" [B, 3, image, image], output "probs"."""
    from deeplearning4j_tpu_torch.modelimport import onnx_proto as op

    nodes, inits = [], {}

    def host(t):
        return t.detach().float().cpu().numpy()

    def node(op_type, ins, out, *attrs):
        nodes.append(op.NodeProto(op_type=op_type, name=out, input=list(ins), output=[out],
                                  attribute=list(attrs)))
        return out

    def conv_bn(name, x, n, stride, relu=True):
        wt = net.params_[f"{name}_conv"]["W"]
        k = int(wt.shape[2])
        out, lo, hi = _same_pads(n, k, stride)
        inits[f"{name}_conv.W"] = host(wt)
        y = node("Conv", [x, f"{name}_conv.W"], f"{name}_conv",
                 op.attr_ints("kernel_shape", [k, k]), op.attr_ints("strides", [stride] * 2),
                 op.attr_ints("pads", [lo, lo, hi, hi]))
        bn = f"{name}_bn"
        for key, src in (("gamma", net.params_), ("beta", net.params_),
                         ("mean", net.state_), ("var", net.state_)):
            inits[f"{bn}.{key}"] = host(src[bn][key])
        y = node("BatchNormalization", [y] + [f"{bn}.{key}" for key in
                                              ("gamma", "beta", "mean", "var")], bn,
                 op.attr_f("epsilon", net.layer_by_name(bn).eps))
        return (node("Relu", [y], f"{name}_relu") if relu else y), out

    x, n = conv_bn("stem", "x", image, 2)
    n, lo, hi = _same_pads(n, 3, 2)
    x = node("MaxPool", [x], "stem_pool", op.attr_ints("kernel_shape", [3, 3]),
             op.attr_ints("strides", [2, 2]), op.attr_ints("pads", [lo, lo, hi, hi]))
    for si, (blocks, _) in enumerate(stages):
        for bi in range(blocks):
            name, stride = f"s{si}b{bi}", 2 if (bi == 0 and si > 0) else 1
            y, m = conv_bn(f"{name}_a", x, n, stride)
            y, _ = conv_bn(f"{name}_b", y, m, 1)
            y, _ = conv_bn(f"{name}_c", y, m, 1, relu=False)
            short = conv_bn(f"{name}_proj", x, n, stride, relu=False)[0] if bi == 0 else x
            x = node("Relu", [node("Add", [y, short], f"{name}_add")], f"{name}_relu")
            n = m
    flat = node("Flatten", [node("GlobalAveragePool", [x], "avgpool")], "flat",
                op.attr_i("axis", 1))
    inits["output.W"], inits["output.b"] = (host(net.params_["output"][k]) for k in ("W", "b"))
    y = node("Softmax", [node("Gemm", [flat, "output.W", "output.b"], "logits")], "probs",
             op.attr_i("axis", -1))
    graph = op.GraphProto(
        name="resnet50", node=nodes,
        initializer=[op.TensorProto.from_array(a, name=k) for k, a in inits.items()],
        input=[op.ValueInfoProto(name="x", shape=[None, 3, image, image])],
        output=[op.ValueInfoProto(name=y, shape=[None, net.params_["output"]["b"].shape[0]])])
    return op.ModelProto(graph=graph).serialize()


def phase_onnx_resnet50(modelimport, quant, ModelServer, ResNet50, dev, cfg=ONNX_R50):
    """The port's zoo ResNet-50 through ONNX into a quantized server (phase
    61 of the module docstring)."""
    from deeplearning4j_tpu_torch.modelimport import onnx_proto
    from deeplearning4j_tpu_torch.serving import UnservableGraphError
    tag = "onnx_resnet50"
    B, image, classes = cfg["batch"], cfg["image"], cfg["classes"]
    zoo = ResNet50(n_classes=classes, input_shape=(image, image, 3))
    net = zoo.init_model(device=dev)
    x = np.random.default_rng(0).standard_normal((B, image, image, 3), dtype=np.float32)
    x_nchw = np.ascontiguousarray(x.transpose(0, 3, 1, 2))
    # a classifier the int8 parity bound means something for: each residual
    # branch's last BatchNorm scale drawn small (zero-gamma residual init,
    # Goyal et al. 2017: a random BatchNorm ResNet at unit gamma is chaotic,
    # and 1% of weight noise moves its logits as much as they are), running
    # statistics calibrated on x, and the head imprinted with x's classes
    rs = np.random.RandomState(5)
    with torch.no_grad():
        for name, p in net.params_.items():
            if name.endswith("_c_bn"):
                p["gamma"].copy_(torch.as_tensor(rs.uniform(*cfg["branch_gamma"], p["gamma"].shape)))
    t0 = time.perf_counter()
    bn_forwards = calibrate_bn_stats(net, x, rs)
    imprinted = imprint_head(net, x, rs, cfg["imprint_logit"])
    torch.cuda.synchronize()
    calibrate_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    model_bytes = resnet50_onnx_model(net, type(zoo).STAGES, image)
    write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    sd = modelimport.import_onnx_model(model_bytes, device=dev)
    torch.cuda.synchronize()
    import_s = time.perf_counter() - t0
    with torch.no_grad():
        acts, _ = net._forward(net.params_, net.state_, {"input": torch.as_tensor(x, device=dev)},
                               train=False, rng=None)
        out = net.params_["output"]
        refs = {"probs": acts["output"], "logits": acts["avgpool"] @ out["W"] + out["b"]}
        gots = sd.output({"x": x_nchw}, "probs", "logits")
    errs = {}
    for k, ref in refs.items():
        got = gots[k]
        errs[k] = ((got - ref).abs().max().item(), ref.abs().max().item())
        require(got.shape == (B, classes) and bool(torch.isfinite(got).all())
                and errs[k][0] <= F32_RTOL * errs[k][1],
                f"{tag}: imported {k} {tuple(got.shape)} max|diff| {errs[k][0]} against the "
                f"zoo graph's (max {errs[k][1]})")
    top = refs["probs"].max(-1)
    top_prob = top.values.max().item()
    require(bool((top.indices.cpu() == torch.as_tensor(imprinted)).all()) and top_prob <= 0.9,
            f"{tag}: argmax {top.indices.tolist()} against the imprinted classes "
            f"{imprinted.tolist()}, top probability {top_prob} (want <= 0.9: not one-hot)")
    del acts, refs, gots, net
    f32_bytes = sum(v.numel() * v.element_size() for v in sd.variables_.values())

    qm = quant.quantize_model(sd)
    require(qm.kind == "samediff", f"{tag}: quantized kind {qm.kind}")
    par = quant.parity_check(sd, qm, x_nchw)
    require(par["delta"] <= 0.01, f"{tag}: parity delta {par['delta']} > 0.01")
    with torch.no_grad():          # the int8 model's logits, beside the f32 ones
        feeds = {"x": torch.as_tensor(x_nchw, device=dev)}
        lq = sd._eval_graph(feeds, quant.ptq._deq_tree(qm.params_, torch.float32),
                            ["logits"])["logits"]
        lf = sd.output(feeds, "logits")["logits"]
        logits_rel_l2 = (torch.linalg.vector_norm(lq - lf)
                         / torch.linalg.vector_norm(lf)).item()
    require(logits_rel_l2 <= cfg["int8_logits_rel_l2"],
            f"{tag}: the int8 logits differ from the f32 ones by {logits_rel_l2} (L2), "
            f"over {cfg['int8_logits_rel_l2']}")
    srv = ModelServer(max_batch=16, device=dev)
    try:
        t0 = time.monotonic()
        entry = srv.deploy("r50_onnx", model=qm, input_shape=(3, image, image), warmup=True)
        deploy_s = time.monotonic() - t0
        reqs = np.random.default_rng(1).standard_normal(
            (cfg["requests"], 1, 3, image, image), dtype=np.float32)
        t0 = time.monotonic()
        futs = [srv.submit("r50_onnx", r) for r in reqs]
        outs = [f.result(timeout=600) for f in futs]
        serve_s = time.monotonic() - t0
        require(all(o.shape == (1, classes) and np.isfinite(o).all()
                    and abs(float(o.sum()) - 1.0) <= 1e-4 and float(o.max()) <= 0.9
                    for o in outs),
                f"{tag}: an answer is not a finite, unsaturated softmax row")
        want = qm.output(reqs[:, 0]).cpu().numpy()
        served_err = float(np.abs(np.concatenate(outs) - want).max())
        require(served_err <= F32_RTOL * float(np.abs(want).max()),
                f"{tag}: served rows differ from one batched output by {served_err}")
        stats = srv.stats()
        require(stats["failed"] == 0, f"{tag}: {stats['failed']} failed requests")
        raw = srv.deploy("raw", onnx=model_bytes)
        try:
            srv.output("raw", x_nchw[:1], timeout=600)
            raised = None
        except UnservableGraphError as e:
            raised = str(e)
        require(raw.source == "onnx" and raised is not None,
                f"{tag}: raw graph source {raw.source!r}, first request raised {raised!r}")
    finally:
        srv.shutdown()
    report = dict(
        onnx_nodes=len(onnx_proto.load_model(model_bytes).graph.node),
        model_bytes=len(model_bytes), write_s=write_s, import_s=import_s,
        max_abs_err_vs_zoo={k: e for k, (e, _) in errs.items()},
        max_abs_ref={k: t for k, (_, t) in errs.items()}, bn_calibration_forwards=bn_forwards,
        calibrate_s=calibrate_s, imprinted_classes=imprinted.tolist(), top_prob=top_prob,
        served_top_prob=float(max(o.max() for o in outs)), kind=qm.kind, dtypes=qm.describe()["dtypes"],
        bytes_resident_int8=qm.bytes_resident(), bytes_f32=f32_bytes,
        parity_check=par, int8_logits_rel_l2=logits_rel_l2, deploy_warmup_s=deploy_s, warmed_buckets=entry.warmed_buckets,
        requests=cfg["requests"], serve_s=serve_s, served_max_abs_err=served_err,
        latency_ms=stats["latency_ms"], dispatches=stats["dispatches"],
        raw_source=raw.source, raw_first_request="UnservableGraphError: " + raised)
    emit(tag, model="zoo ResNet-50 as NCHW ONNX", batch=B, image=image, classes=classes,
         dtype="float32", tf32=False, **report)
    del sd, qm, srv
    torch.cuda.empty_cache()
    return report


def phase_qmha(ak, qk, dispatch, attention, matmul, dev, shape=QMHA):
    """``quantized_mha`` at BERT-base width against its plain version in
    ``reference`` mode (phase 62 of the module docstring)."""
    tag = "qmha"
    B, T, F, NH = shape
    gen = torch.Generator(device=dev).manual_seed(11)
    w_qkv = qk.quantize_tensor(torch.randn(F, 3 * F, generator=gen, device=dev) / math.sqrt(F))
    w_out = qk.quantize_tensor(torch.randn(F, F, generator=gen, device=dev) / math.sqrt(F))
    b_qkv = 0.1 * torch.randn(3 * F, generator=gen, device=dev)
    b_out = 0.1 * torch.randn(F, generator=gen, device=dev)
    x32 = torch.randn(B, T, F, generator=gen, device=dev)
    res = {}
    for dt in (torch.float32, torch.bfloat16):
        x = x32.to(dt)

        def call():
            return ak.quantized_mha(x, w_qkv, w_out, NH, b_qkv=b_qkv, b_out=b_out)
        with torch.inference_mode():
            q0, f0 = matmul.Q_LAUNCHES.value, attention.LAUNCHES.value
            y = call()
            torch.cuda.synchronize()
            launches = (matmul.Q_LAUNCHES.value - q0, attention.LAUNCHES.value - f0)
            r = _in_reference_mode(dispatch, call)
            err = (y.float() - r.float()).abs().max().item()
            top = r.float().abs().max().item()
            tol = F32_RTOL * top if dt == torch.float32 else Q_BF16_ULPS * bf16_ulp(top)
            require(y.shape == (B, T, F) and y.dtype == dt and launches == (2, 1)
                    and err <= tol,
                    f"{tag} {dt}: {tuple(y.shape)} {y.dtype}, launches (q_matmul, flash) "
                    f"{launches}, max|diff| {err} > tol {tol}")
            ms = time_ms(call, dev)
            plain_ms = _in_reference_mode(dispatch, lambda: time_ms(call, dev))
        res[str(dt)[6:]] = dict(launches={"q_matmul": launches[0], "flash_attn_fwd": launches[1]},
                                max_abs_err=err, max_abs_ref=top, tol=tol, ms=ms,
                                plain_ms=plain_ms)
    emit(tag, x=[B, T, F], heads=NH, w_qkv=[F, 3 * F], w_out=[F, F], bias=True, **res)
    return res


def _has_module(name):
    import importlib.util
    return importlib.util.find_spec(name) is not None


def sd_kernels_graph(autodiff, Adam, dev, shape=SD_KERNELS):
    """A SameDiff graph through the API that reaches the five kernels:
    `layers` pre-LN encoder layers (``sd.nn.layer_norm`` twice, the
    ``multi_head_dot_product_attention`` op, a GELU MLP) on [B, T, F]
    inputs, a mean-squared-error loss, Adam(1e-4); weights drawn from the
    graph's seeded generator, so two graphs built alike are equal."""
    B, T, F, NH, layers, _ = shape
    dh = F // NH
    sd = autodiff.SameDiff.create(device=dev)
    x = sd.placeholder("x", (B, T, F))
    y = sd.placeholder("y", (B, T, F))
    for l in range(layers):
        g1, b1 = sd.one(f"{l}.g1", F), sd.zero(f"{l}.b1", F)
        g2, b2 = sd.one(f"{l}.g2", F), sd.zero(f"{l}.b2", F)
        wq, wk, wv = (sd.var(f"{l}.{n}", "XAVIER", NH, dh, F) for n in ("wq", "wk", "wv"))
        wo = sd.var(f"{l}.wo", "XAVIER", F, NH, dh)
        w1, w2 = sd.var(f"{l}.w1", "XAVIER", F, 4 * F), sd.var(f"{l}.w2", "XAVIER", 4 * F, F)
        bb1, bb2 = sd.zero(f"{l}.bb1", 4 * F), sd.zero(f"{l}.bb2", F)
        h = sd.nn.layer_norm(x, g1, b1)
        x = x + sd.op("multi_head_dot_product_attention", h, h, h, wq, wk, wv, wo)
        h = sd.nn.layer_norm(x, g2, b2)
        x = x + sd.nn.linear(sd.nn.gelu(sd.nn.linear(h, w1, bb1)), w2, bb2)
    sd.loss.mean_squared_error(y, x, name="loss")
    sd.set_loss_variables("loss")
    sd.set_training_config(autodiff.TrainingConfig(
        updater=Adam(1e-4), data_set_feature_mapping=["x"], data_set_label_mapping=["y"]))
    return sd


def phase_sd_kernels(autodiff, Adam, dispatch, attention, layer_norm, dev, shape=SD_KERNELS):
    """SameDiff reaching the kernels (phase 43 of the module docstring)."""
    tag = "sd_kernels"
    B, T, F, NH, layers, steps = shape
    rs = np.random.RandomState(0)
    x = torch.as_tensor(rs.randn(B, T, F).astype(np.float32), device=dev)
    y = torch.as_tensor(rs.randn(B, T, F).astype(np.float32), device=dev)
    counters = _train_counters(attention, layer_norm)
    sd = sd_kernels_graph(autodiff, Adam, dev, shape)
    twin = sd_kernels_graph(autodiff, Adam, dev, shape)
    require(all(torch.equal(a, b) for a, b in zip(sd.variables_.values(),
                                                  twin.variables_.values())),
            f"{tag}: two graphs built alike start from different variables")
    losses, ms, counts = _train_steps(sd, lambda: (sd.fit(x, y), sd._score)[1],
                                      counters, steps)
    ref, ref_ms, ref_counts = _in_reference_mode(
        dispatch, lambda: _train_steps(twin, lambda: (twin.fit(x, y), twin._score)[1],
                                       counters, steps))
    want = (layers, layers, layers, 2 * layers, 2 * layers)
    rel = _rel(losses, ref)
    require(all(c == want for c in counts) and all(c == (0,) * 5 for c in ref_counts),
            f"{tag}: launches a step {counts} (reference mode {ref_counts}), want {want}")
    require(all(math.isfinite(v) for v in losses) and max(rel) <= F32_RTOL,
            f"{tag}: losses {losses} against reference mode's {ref} (rel {rel})")
    report = dict(steps=steps, losses=losses, reference_losses=ref, max_rel_diff=max(rel),
                  launches_per_step=dict(zip(("flash_attn_fwd", "flash_attn_bwd_dq",
                                              "flash_attn_bwd_dkv", "layer_norm_fwd",
                                              "layer_norm_bwd"), want)),
                  step_ms=statistics.median(ms[1:]), reference_step_ms=statistics.median(ref_ms[1:]),
                  step_ms_all=ms, reference_step_ms_all=ref_ms)
    emit(tag, batch=B, T=T, features=F, heads=NH, head_dim=F // NH, layers=layers,
         dtype="float32", tf32=False, updater="Adam(1e-4)", **report)
    del sd, twin
    torch.cuda.empty_cache()
    return report


def _onnx_bert_entry(name, onnx_bert):
    """A LayerNorm kernel's launches in phase 60: a forward and a step."""
    fwd = name == "layer_norm_fwd"
    per = onnx_bert["layer_norm_launches_per_step"]["fwd" if fwd else "bwd"]
    each = [c[0 if fwd else 1] for c in onnx_bert["layer_norm_launches_each_step"]]
    steps = len(each)
    b, t, layers, h = SD_BERT[:4]
    return {"launches_per_step": per, "launches": sum(each),
            **({"launches_per_forward": onnx_bert["layer_norm_fwd_launches_per_forward"]}
               if fwd else {}),
            "shape": f"ONNX-imported BERT-base, {layers} layers, x [{b},{t},{h}] f32; "
                     f"launches over {steps} sd.fit steps"}


def _qmha_entry(name, qmha):
    """A kernel's launches a quantized_mha call in phase 62, and the call's
    ms."""
    b, t, f, nh = QMHA
    return {"launches_per_call": qmha["float32"]["launches"][name],
            "call_ms": {dt: r["ms"] for dt, r in qmha.items()},
            "call_plain_ms": {dt: r["plain_ms"] for dt, r in qmha.items()},
            "shape": f"quantized_mha x [{b},{t},{f}], {nh} heads, int8 w_qkv [{f},{3 * f}] "
                     f"and w_out [{f},{f}]; f32 and bf16"}


def _sd_kernels_entry(name, sd_kern):
    """A kernel's launches in phase 43: a step, and over its steps."""
    n = sd_kern["launches_per_step"][name]
    b, t, f, nh, layers, steps = SD_KERNELS
    return {"launches_per_step": n, "launches": n * steps, "steps": steps,
            "shape": f"SameDiff graph, {layers} pre-LN layers, x [{b},{t},{f}] f32, "
                     f"{nh} heads of {f // nh}"}


def _fused_entries(name, fused_r50, fused_lenet):
    """A kernel's launches in one replayed block of phases 34 and 35 (the
    profiler's kernel names), beside what the Python counter saw over the
    warm-up and the capture."""
    i = ("fused_dense", "conv3x3_wgrad", "conv3x3_dgrad").index(name)
    return {
        "fused_resnet50": {
            cd: {"launches_per_replayed_block": r["replay_launches"][name], "k": r["k"],
                 "profiled_replays": [t[1][name] for t in r["replay_traces"]],
                 "counted_at_warmup_and_capture": r["launches_counted_at_capture"][i]}
            for cd, r in fused_r50.items()},
        "fused_lenet": {"launches_per_replayed_block": fused_lenet["replay_launches"][name],
                        "profiled_replays": [t[1][name] for t in fused_lenet["replay_traces"]],
                        "k": fused_lenet["k"]}}


def _fused_bert_entries(name, fused_bert):
    """A kernel's nodes in one replayed block of phase 37 at each shape,
    beside the profiler's counts of traced replays."""
    return {f"batch{b}_T{t}": {"launches_per_replayed_block": r["replay_launches"][name],
                               "k": r["k"],
                               "profiled_replays": [tr[1][name] for tr in r["replay_traces"]]}
            for (b, t), r in fused_bert.items()}


def _seq_attention_entry(name, seq_attn):
    """A flash kernel's launches in phase 41: a step, a replayed block of k
    (graph nodes), and the learned-query forward."""
    entry = {"launches_per_step": seq_attn["launches_per_step"][name],
             "launches_per_replayed_block": seq_attn["replay_nodes"][name],
             "k": seq_attn["k"],
             "shape": "q/k/v [64,4,128,64] f32 with a [64,128] keep-mask (float and int32)"}
    if name == "flash_attn_fwd":
        entry["learned_queries"] = {"launches": seq_attn["learned_queries"]["launches"],
                                    "shape": "q [64,4,4,64], k/v [64,4,128,64] f32"}
    return entry


def _r50_batch(dev, batch, image, classes):
    """bench.py's ResNet-50 batch: numpy seed 0, as phase 34 makes it."""
    rng = np.random.RandomState(0)
    x = torch.as_tensor(rng.rand(batch, image, image, 3).astype(np.float32), device=dev)
    y = torch.as_tensor(np.eye(classes, dtype=np.float32)[
        rng.randint(0, classes, batch)], device=dev)
    return x, y


def _nccl_ms(by_name):
    return sum(ms for name, (ms, _) in by_name.items() if "nccl" in name.lower())


def _params_sha256(net):
    import hashlib
    h = hashlib.sha256()
    for t in list(net.state_dict().values()):
        h.update(t.detach().float().cpu().numpy().tobytes())
    return h.hexdigest()


def _bn_layers(net):
    from deeplearning4j_tpu_torch.nn import BatchNormalizationLayer
    return sum(isinstance(layer, BatchNormalizationLayer) for _, layer in net._named_layers())


def _dp_collectives_per_step(net, world):
    """The collectives of one data-parallel step, from the configuration:
    one all-reduce a gradient bucket and one of the loss; with more than
    one rank, two a BatchNorm layer (its statistics forward, its two
    gradient sums backward)."""
    return net._dp.last_buckets + 1 + (2 * _bn_layers(net) if world > 1 else 0)


def _dp_resnet50_rank(parallel, conv3x3, matmul, ResNet50, Nesterovs, dev, world, k, batch,
                      image, classes, ckpt_dir, state0=None):
    """One rank's part of phases 44 and 45: bench.py's bf16 ResNet-50
    through ``ParallelWrapper.fit_steps`` on stride-0 blocks of k of the
    global batch; then a sharded checkpoint round trip.  Returns (report,
    checkpoint report, net, wrapper, xs, ys, the net's state and updater
    tensors right after the two main-path blocks)."""
    x, y = _r50_batch(dev, batch, image, classes)
    xs = torch.broadcast_to(x, (k,) + tuple(x.shape))
    ys = torch.broadcast_to(y, (k,) + tuple(y.shape))
    net = _resnet50(ResNet50, Nesterovs, dev, compute_dtype="bfloat16", image=image,
                    classes=classes)
    if state0 is not None:
        net.load_state_dict(state0)
    pw = parallel.ParallelWrapper.builder(net).build()
    require(pw.degree == world, f"dp_resnet50: a mesh of {pw.degree} ranks, want {world}")
    pw._place_model()
    torch.cuda.reset_peak_memory_stats()
    # the main path, the counts set to 0 just before it and read just after
    _reset_counts(matmul, conv3x3)
    net._dp.collectives = 0
    first, first_ms = _synced(lambda: pw.fit_steps(xs, ys))
    second, second_ms = _synced(lambda: pw.fit_steps(xs, ys))
    counts = _step_counts(matmul, conv3x3)
    collectives = net._dp.collectives
    after_main = ({n: v.clone() for n, v in net.state_dict().items()},
                  [t.clone() for t in _opt_leaves(net)])
    per_step = _dp_collectives_per_step(net, world)
    require(collectives == (k + 1) * per_step,
            f"dp_resnet50: {collectives} collectives at the warm-up and capture, want "
            f"{k + 1} x {per_step}")
    require(counts[1] > 0 and counts[2] > 0, f"dp_resnet50: conv launches {counts}")
    step = net._scan_step
    require(step.captures == 1, f"dp_resnet50: {step.captures} captures for one shape")
    block_ms = [second_ms]
    for _ in range(DP_R50_TIMED_BLOCKS - 1):
        block_ms.append(_synced(lambda: pw.fit_steps(xs, ys))[1])
    want = {"fused_dense": 0, "conv3x3_wgrad": k * BODY_CONVS, "conv3x3_dgrad": k * BODY_CONVS}
    (window_ms, busy_ms, by_name, n_kernels), traces = _traced_replays(
        lambda: pw.fit_steps(xs, ys), want, "dp_resnet50")
    step_ms = statistics.median(block_ms) / k
    report = dict(
        world=world, k=k, global_batch=batch, losses=first.tolist() + second.tolist(),
        launches_counted_at_warmup_and_capture=dict(zip(
            ("fused_dense", "conv3x3_wgrad", "conv3x3_dgrad"), counts)),
        collectives_per_step=per_step, gradient_buckets=net._dp.last_buckets,
        bn_layers=_bn_layers(net), captures=step.captures,
        capture_s=(step.capture_seconds or [None])[0], first_block_ms=first_ms,
        block_ms_all=block_ms, step_ms=step_ms,
        samples_per_sec=batch * 1e3 / step_ms,
        samples_per_sec_per_card=batch * 1e3 / step_ms / world,
        collective_ms_per_step=_nccl_ms(by_name) / k, block_window_ms=window_ms,
        block_busy_ms=busy_ms,
        block_idle_share=None if busy_ms is None else max(0.0, 1.0 - busy_ms / window_ms),
        block_kernels=n_kernels, replay_traces=traces,
        max_memory_allocated_gb=torch.cuda.max_memory_allocated() / 1e9,
        top=_top(by_name, 6))
    ckpt = _dp_checkpoint(parallel, ResNet50, Nesterovs, net, pw, xs, ys, dev, image,
                          classes, ckpt_dir)
    return report, ckpt, net, pw, xs, ys, after_main


def _dp_checkpoint(parallel, ResNet50, Nesterovs, net, pw, xs, ys, dev, image, classes,
                   directory):
    """Phase 45 on one rank: save the wrapped net sharded, load it into a
    fresh wrapped net, and take one more block on both: bit for bit."""
    import shutil
    t0 = time.perf_counter()
    parallel.save_model_sharded(net, directory)
    save_s = time.perf_counter() - t0
    nbytes = sum(os.path.getsize(os.path.join(directory, f)) for f in os.listdir(directory))
    fresh = _resnet50(ResNet50, Nesterovs, dev, compute_dtype="bfloat16", image=image,
                      classes=classes)
    pf = parallel.ParallelWrapper.builder(fresh).build()
    pf._place_model()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    parallel.load_model_sharded(fresh, directory)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    require(fresh.iteration == net.iteration, "dp_checkpoint: iteration not restored")
    a = pw.fit_steps(xs, ys)
    b = pf.fit_steps(xs, ys)
    same_losses = torch.equal(a, b)
    sa, sb = net.state_dict(), fresh.state_dict()
    same_state = all(torch.equal(sa[n], sb[n]) for n in sa)
    require(same_losses and same_state,
            f"dp_checkpoint: the block after the load differs (losses {a.tolist()} vs "
            f"{b.tolist()}, state equal {same_state})")
    if getattr(pw.mesh, "rank", 0) == 0:
        shutil.rmtree(directory, ignore_errors=True)
    del fresh, pf
    return dict(save_s=save_s, load_s=load_s, bytes_written=nbytes,
                losses_after_load=b.tolist(), iteration=net.iteration)


def phase_dp_resnet50(parallel, multihost, conv3x3, matmul, ResNet50, Nesterovs, dev,
                      k=DP_R50_K, batch=64, image=224, classes=1000):
    """Phases 44 and 45: bench.py's ResNet-50 blocks data-parallel at world
    = device_count over NCCL, against the plain ``fit_steps`` of a twin
    with the same initial state on the same global batch."""
    import tempfile
    world = torch.cuda.device_count()
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True   # bitwise twins (phase 34's note)
    try:
        x, y = _r50_batch(dev, batch, image, classes)
        xs = torch.broadcast_to(x, (k,) + tuple(x.shape))
        ys = torch.broadcast_to(y, (k,) + tuple(y.shape))
        twin = _resnet50(ResNet50, Nesterovs, dev, compute_dtype="bfloat16", image=image,
                         classes=classes)
        state0 = {n: v.clone() for n, v in twin.state_dict().items()}
        plain = twin.fit_steps(xs, ys).tolist() + twin.fit_steps(xs, ys).tolist()
        plain_state = twin.state_dict()
        plain_opt = _opt_leaves(twin)
        del twin
        torch.cuda.empty_cache()
        ckpt_dir = tempfile.mkdtemp(prefix="dp_ckpt_")
        if world == 1:
            report, ckpt, net, pw, xs, ys, (state, opt) = _dp_resnet50_rank(
                parallel, conv3x3, matmul, ResNet50, Nesterovs, dev, world, k, batch, image,
                classes, ckpt_dir, state0)
            require(report["losses"] == plain,
                    f"dp_resnet50: losses {report['losses']} differ from the plain "
                    f"fit_steps' {plain}")
            require(all(torch.equal(plain_state[n], state[n]) for n in plain_state),
                    "dp_resnet50: parameters or BatchNorm statistics differ from the plain "
                    "twin's")
            require(len(opt) == len(plain_opt)
                    and all(torch.equal(a, b) for a, b in zip(plain_opt, opt)),
                    "dp_resnet50: updater state differs from the plain twin's")
            del state, opt, plain_state, plain_opt
            txt = _kept_dot(net, "_scan_step", None, lambda: pw.fit_steps(xs, ys))
            nodes = {"conv3x3_wgrad": txt.count("conv3x3_wgrad_kernel"),
                     "conv3x3_dgrad": txt.count("conv3x3_dgrad_kernel"),
                     "nccl": txt.lower().count("nccl")}
            # NCCL enqueues nothing for an in-place sum over one rank, so at
            # world 1 a collective adds no node (measured: my NCCL probe)
            want = {"conv3x3_wgrad": k * BODY_CONVS, "conv3x3_dgrad": k * BODY_CONVS,
                    "nccl": 0}
            require(nodes == want, f"dp_resnet50: the kept graph has {nodes}, want {want}")
            report.update(replay_nodes=nodes, graph_kernel_nodes=txt.count("KERNEL"),
                          bitwise_equal_to_plain_fit_steps=True, plain_losses=plain,
                          parity="world 1: the replayed block equals the plain fit_steps "
                                 "bit for bit; multi-rank parity against the JAX package "
                                 "comes from the CPU tests (2 gloo ranks) only")
            del net, pw
        else:
            del plain_state, plain_opt
            outs = multihost.LocalLauncher(world, platform="cuda").run(
                os.path.abspath(__file__), ["--dp-rank", "resnet50", ckpt_dir, str(k),
                                            str(batch), str(image), str(classes)],
                timeout=420)
            ranks = [_rank_report(o) for o in outs]
            report, ckpt = ranks[0]["report"], ranks[0]["ckpt"]
            hashes = {r["params_sha256"] for r in ranks}
            require(len(hashes) == 1, f"dp_resnet50: parameters differ over the ranks {hashes}")
            rel = _rel(report["losses"], plain)
            require(all(math.isfinite(v) for v in report["losses"])
                    and rel[0] <= BF16_LOSS_RTOL and rel[1] <= DP_BF16_STEP2_RTOL,
                    f"dp_resnet50: losses {report['losses']} against the one-card run's "
                    f"{plain} (rel {rel})")
            report.update(plain_losses=plain, rel_loss_diff=rel,
                          ranks_bitwise_equal=True,
                          per_rank_step_ms=[r["report"]["step_ms"] for r in ranks])
        emit("dp_resnet50", model="ResNet50", compute_dtype="bfloat16",
             input=f"{image}x{image}x3", classes=classes, updater="Nesterovs(0.1, 0.9)",
             backend="nccl", cudnn_deterministic=True, **report)
        emit("dp_checkpoint", world=world, model="ResNet50", **ckpt)
        return report
    finally:
        torch.backends.cudnn.deterministic = prev


def _opt_leaves(net):
    from deeplearning4j_tpu_torch.train.updaters import tree_leaves
    return [t for t in tree_leaves(net.opt_state_) if isinstance(t, torch.Tensor)]


def _rank_report(out, tag="DP_RANK"):
    for line in out.splitlines():
        if line.startswith(tag + " "):
            return json.loads(line[len(tag) + 1:])
    raise RuntimeError(f"chip_smoke: a rank printed no report:\n{out[-2000:]}")


def _zero1_side(parallel, nn, Adam, matmul, dev, sharded, cfg):
    """One side of bench.py's `bench_zero1` A/B: (net, seconds of the timed
    blocks, updater-state bytes a rank, fused_dense launches counted)."""
    conf = (nn.NeuralNetConfiguration.builder().seed(0).updater(Adam(1e-3))
            .list([nn.DenseLayer(n_out=cfg["hidden"], activation="relu"),
                   nn.DenseLayer(n_out=cfg["hidden"], activation="relu"),
                   nn.OutputLayer(n_out=10, loss="mcxent", activation="softmax")])
            .set_input_type(nn.InputType.feed_forward(cfg["n_in"])).build())
    net = nn.MultiLayerNetwork(conf, device=dev).init()
    rng = np.random.RandomState(0)
    x = torch.as_tensor(rng.randn(cfg["batch"], cfg["n_in"]).astype(np.float32), device=dev)
    y = torch.as_tensor(np.eye(10, dtype=np.float32)[rng.randint(0, 10, cfg["batch"])],
                        device=dev)
    k = cfg["fused_steps"]
    xs = torch.broadcast_to(x, (k,) + tuple(x.shape))
    ys = torch.broadcast_to(y, (k,) + tuple(y.shape))
    pw = parallel.ParallelWrapper.builder(net).optimizer_sharding(sharded).build()
    pw._place_model()
    matmul.LAUNCHES.reset()
    pw.fit_steps(xs, ys)                      # bench.py's warm-up block
    net.score()
    blocks = max(cfg["steps"] // k, 1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(blocks):
        pw.fit_steps(xs, ys)
    net.score()
    dt = time.perf_counter() - t0
    launches = matmul.LAUNCHES.value
    return (net, pw, xs, ys, dt, parallel.opt_state_bytes_per_replica(net.opt_state_),
            launches)


def _zero1_ab(parallel, nn, Adam, matmul, dev, cfg):
    net_a, _, _, _, t_repl, bytes_repl, launches_a = _zero1_side(
        parallel, nn, Adam, matmul, dev, False, cfg)
    net_b, pw_b, xs, ys, t_z1, bytes_z1, launches_b = _zero1_side(
        parallel, nn, Adam, matmul, dev, True, cfg)
    diff = max((a - b).abs().max().item() for a, b in zip(net_a.parameters(),
                                                          net_b.parameters()))
    k, blocks = cfg["fused_steps"], max(cfg["steps"] // cfg["fused_steps"], 1)
    n = cfg["batch"] * k * blocks
    out = dict(fused_steps=k, steps=k * blocks, global_batch=cfg["batch"],
               replicated_wall_s=t_repl, zero1_wall_s=t_z1,
               replicated_samples_per_sec=n / t_repl, zero1_samples_per_sec=n / t_z1,
               opt_bytes_replicated=bytes_repl, opt_bytes_zero1=bytes_z1,
               opt_bytes_ratio=bytes_repl / max(bytes_z1, 1), max_param_diff=diff,
               fused_dense_counted=[launches_a, launches_b],
               params_sha256=_params_sha256(net_b))
    return out, net_b, pw_b, xs, ys


def phase_dp_zero1(parallel, multihost, nn, Adam, matmul, dev, cfg=ZERO1):
    """Phase 46: bench.py's ZeRO-1 A/B at world = device_count."""
    world = torch.cuda.device_count()
    dense = 2                               # the relu Dense layers; the softmax head is plain
    if world == 1:
        report, net, pw, xs, ys = _zero1_ab(parallel, nn, Adam, matmul, dev, cfg)
        txt = _kept_dot(net, "_scan_step", None, lambda: pw.fit_steps(xs, ys))
        nodes = txt.count("fused_dense_kernel")
        want = dense * cfg["fused_steps"]
        require(nodes == want, f"dp_zero1: {nodes} fused_dense nodes a block, want {want}")
        report.update(fused_dense_nodes_per_block=nodes,
                      graph_kernel_nodes=txt.count("KERNEL"),
                      note="world 1: the A/B is degenerate (one shard holds every row, as "
                           "bench.py's docstring says of a one-device run)")
        del net, pw
    else:
        outs = multihost.LocalLauncher(world, platform="cuda").run(
            os.path.abspath(__file__), ["--dp-rank", "zero1"], timeout=240)
        ranks = [_rank_report(o) for o in outs]
        report = ranks[0]
        require(len({r["params_sha256"] for r in ranks}) == 1,
                "dp_zero1: parameters differ over the ranks")
    for side in report["fused_dense_counted"]:
        require(side > 0, "dp_zero1: fused_dense never launched on the main path")
    if world <= 2:
        require(report["max_param_diff"] == 0.0,
                f"dp_zero1: ZeRO-1 and replicated differ by {report['max_param_diff']}")
    emit("dp_zero1", world=world, model="MLP 256-1024-1024-10", updater="Adam(1e-3)",
         backend="nccl", **report)
    return report


def dp_rank_main(argv):
    """One rank of phases 44 to 46 at world > 1 (``--dp-rank resnet50
    <checkpoint dir> <k> <batch> <image> <classes>`` or ``--dp-rank
    zero1``), started by ``multihost.LocalLauncher``: prints its report
    as one ``DP_RANK`` line."""
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from deeplearning4j_tpu_torch import nn, parallel
    from deeplearning4j_tpu_torch.ops.kernels import conv3x3, dispatch, matmul
    from deeplearning4j_tpu_torch.parallel import multihost
    from deeplearning4j_tpu_torch.train import Adam, Nesterovs
    from deeplearning4j_tpu_torch.zoo import ResNet50
    import torch.distributed as dist
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    dispatch.set_dispatch_mode("auto")
    dev = multihost.initialize(timeout_s=180)     # a stuck collective fails the rank
    world = dist.get_world_size()
    if argv[0] == "resnet50":
        ckpt_dir, k, batch, image, classes = argv[1], *map(int, argv[2:6])
        report, ckpt, net, *_ = _dp_resnet50_rank(
            parallel, conv3x3, matmul, ResNet50, Nesterovs, dev, world, k, batch, image,
            classes, ckpt_dir)
        out = {"report": report, "ckpt": ckpt, "params_sha256": _params_sha256(net)}
    else:
        out, *_ = _zero1_ab(parallel, nn, Adam, matmul, dev, ZERO1)
    print("DP_RANK " + json.dumps(out), flush=True)
    # no teardown: destroying an NCCL group whose collectives live in
    # captured graphs hung every rank of a 4-card run; the process ends here
    os._exit(0)


# ---------------------------------------------------------------------------
# gradient sharing (phases 47 and 48)
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def _exchange_clock():
    """While open, the pieces of each split step's exchange are timed,
    each between two synchronizes: D2H (``hierarchical._host_f32``: the
    f32 cast, the concatenation and the copy), encode, the mesh's
    all-gather (TCP), decode, the runtime's whole ``exchange`` (those and
    the sum) and ``multilayer.exchange_gradients`` (that and the H2D with
    the layouts back).  Yields {piece: [ms, ...]}."""
    from deeplearning4j_tpu_torch.nn import multilayer
    from deeplearning4j_tpu_torch.parallel import compression, hierarchical, transport
    times = {}

    def timed(name, fn):
        def run(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            times.setdefault(name, []).append((time.perf_counter() - t0) * 1e3)
            return out
        return run
    spots = [(hierarchical, "_host_f32", "d2h"),
             (compression.CompressedGradientExchange, "encode", "encode"),
             (compression.CompressedGradientExchange, "decode", "decode"),
             (transport.TcpGradientMesh, "allgather", "tcp"),
             (hierarchical.HierarchicalAllReduce, "exchange", "exchange"),
             (multilayer, "exchange_gradients", "exchange_and_h2d")]
    saved = [getattr(owner, attr) for owner, attr, _ in spots]
    for (owner, attr, name), fn in zip(spots, saved):
        setattr(owner, attr, timed(name, fn))
    try:
        yield times
    finally:
        for (owner, attr, _), fn in zip(spots, saved):
            setattr(owner, attr, fn)


def _exchange_ms(times, steps):
    """Per step: each piece's ms; h2d is the split step's exchange less the
    runtime's (the copy back and the layouts)."""
    per = {k: sum(v) / steps for k, v in times.items()}
    per["h2d"] = per.get("exchange_and_h2d", 0.0) - per.get("exchange", 0.0)
    for k in ("encode", "decode", "tcp"):
        per.setdefault(k, 0.0)
    return per


def _comms_series(codec):
    from deeplearning4j_tpu_torch.monitor.registry import registry
    reg = registry()
    h = reg.get("comms_exchange_ms")
    return {"exchanges": getattr(reg.get("comms_exchanges_total", {"codec": codec}),
                                 "value", 0),
            "bytes": getattr(reg.get("comms_bytes_on_wire_total", {"codec": codec}),
                             "value", 0),
            "ratio": getattr(reg.get("comms_compression_ratio"), "value", None),
            "ms_count": h.count if h is not None else 0,
            "ms_sum": h.sum if h is not None else 0.0}


def _weights_sha256(net):
    import hashlib
    h = hashlib.sha256()
    for _, p in sorted(net.named_parameters()):
        h.update(p.detach().float().cpu().numpy().tobytes())
    return h.hexdigest()


def _gs_mode(pw, net, matmul, conv3x3, xs, ys, k, label, timed_block=True):
    """One sharing mode of phase 47 on one gang member: a block of k steps
    through ``pw.fit_steps`` (the main path: the launch counts set to 0
    just before it and read just after; it runs step by step), a timed
    block (without `timed_block`, ms a step comes from the next block), a
    block with the exchange's pieces timed, one traced step and the
    ``comms_*`` series' movement over the k main-path steps.  The
    report's ``state_after_main`` holds clones of the network's state
    right after the main-path block."""
    pw._place_model()
    rt = net.gradient_sharing
    codec = "threshold" if rt.config.compressed else "dense"
    before = _comms_series(codec)
    torch.cuda.reset_peak_memory_stats()
    _reset_counts(matmul, conv3x3)
    losses, first_ms = _synced(lambda: pw.fit_steps(xs, ys))
    counts = _step_counts(matmul, conv3x3)
    after = _comms_series(codec)
    stats = rt.stats()
    state_after_main = {n: v.clone() for n, v in net.state_dict().items()}
    require(counts[1] == k * BODY_CONVS and counts[2] == k * BODY_CONVS and counts[0] == 0,
            f"gs_resnet50 {label}: launches {counts} over {k} steps, want 0, "
            f"{k * BODY_CONVS}, {k * BODY_CONVS}")
    require(after["exchanges"] - before["exchanges"] == k and after["bytes"] > before["bytes"]
            and after["ms_count"] - before["ms_count"] == k,
            f"gs_resnet50 {label}: the comms series did not move by {k} exchanges "
            f"({before} -> {after})")
    if timed_block:
        _, block_ms = _synced(lambda: pw.fit_steps(xs, ys))
    with _exchange_clock() as times:
        _, clocked_ms = _synced(lambda: pw.fit_steps(xs, ys))
    if not timed_block:
        block_ms = clocked_ms
    window_ms, busy_ms, by_name, n_kernels = _trace(lambda: pw.fit_steps(xs[:1], ys[:1]))
    return dict(
        losses=[float(v) for v in losses.tolist()], first_block_ms=first_ms,
        step_ms=block_ms / k, exchange=_exchange_ms(times, k),
        exchange_ms_recorded=(after["ms_sum"] - before["ms_sum"]) / k,
        wire_bytes_per_step=stats["last_wire_bytes"],
        compression_ratio=stats["last_compression_ratio"],
        wire_bytes_main_path=after["bytes"] - before["bytes"],
        launches_per_step=dict(zip(("fused_dense", "conv3x3_wgrad", "conv3x3_dgrad"),
                                   (c / k for c in counts))),
        launches_counted=dict(zip(("fused_dense", "conv3x3_wgrad", "conv3x3_dgrad"),
                                  counts)),
        max_memory_allocated_gb=torch.cuda.max_memory_allocated() / 1e9,
        traced_step_window_ms=window_ms, traced_step_busy_ms=busy_ms,
        traced_step_idle_share=None if busy_ms is None
        else max(0.0, 1.0 - busy_ms / window_ms),
        traced_step_kernels=n_kernels, top=_top(by_name, 6), stats=stats,
        state_after_main=state_after_main)


def _gs_resnet50_rank(parallel, conv3x3, matmul, ResNet50, Nesterovs, dev, rank, world, k,
                      port, port2, batch=64, image=224, classes=1000):
    """One gang member of phase 47(b): its rows of the global batch through
    ``ParallelWrapper(...).gradient_sharing(...)``, a fresh network (the
    same seed on every rank) a mode: dense over the mesh on `port`, then
    threshold-compressed (the default threshold) over a new mesh on
    `port2`; the parameters' hash after each mode."""
    HGS = parallel.HierarchicalGradientSharing
    x, y = _r50_batch(dev, batch, image, classes)
    rows = slice(rank * batch // world, (rank + 1) * batch // world)
    xs = torch.broadcast_to(x[rows], (k,) + tuple(x[rows].shape))
    ys = torch.broadcast_to(y[rows], (k,) + tuple(y[rows].shape))
    out = {}
    for mode, cfg in (("dense", HGS(compressed=False, rank=rank, world=world, port=port)),
                      ("compressed", HGS(rank=rank, world=world, port=port2))):
        net = _resnet50(ResNet50, Nesterovs, dev, compute_dtype="bfloat16", image=image,
                        classes=classes)
        pw = parallel.ParallelWrapper.builder(net).gradient_sharing(cfg).build()
        try:
            # a gang step is seconds of host exchange: the clocked block's
            # synchronizes do not move it, so it gives ms a step too
            out[mode] = _gs_mode(pw, net, matmul, conv3x3, xs, ys, k, f"gang {mode}",
                                 timed_block=False)
            out[mode]["params_sha256"] = _weights_sha256(net)
            out[mode]["state_sha256"] = _params_sha256(net)
            del out[mode]["state_after_main"]
        finally:
            pw.gradient_sharing(None)            # closes the mesh's sockets
        del net, pw
        torch.cuda.empty_cache()
    return out


def phase_gs_resnet50(parallel, multihost, conv3x3, matmul, ResNet50, Nesterovs, dev,
                      k=GS_R50_K, batch=64, image=224, classes=1000, gang=None):
    """Phase 47: BASELINE config 5's GradientSharing ResNet-50.  (a) One
    process, ``ParallelWrapper.builder(net).gradient_sharing(
    HierarchicalGradientSharing(compressed=False, world=1)).build()
    .fit_steps``: bit for bit an eager plain ``fit`` twin's losses,
    parameters and BatchNorm statistics; then ``compressed=True``.  (b) A
    gang of 2 processes (``--gs-rank resnet50``), 32 rows each, dense then
    compressed: the ranks' parameters bitwise equal after each mode."""
    HGS = parallel.HierarchicalGradientSharing
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True   # bitwise twins (phase 34's note)
    try:
        x, y = _r50_batch(dev, batch, image, classes)
        xs = torch.broadcast_to(x, (k,) + tuple(x.shape))
        ys = torch.broadcast_to(y, (k,) + tuple(y.shape))
        twin = _resnet50(ResNet50, Nesterovs, dev, compute_dtype="bfloat16", image=image,
                         classes=classes)
        state0 = {n: v.clone() for n, v in twin.state_dict().items()}
        plain = []
        for _ in range(k):
            twin.fit(x, y)
            plain.append(twin.score())
        plain_state = {n: v.clone() for n, v in twin.state_dict().items()}
        del twin
        torch.cuda.empty_cache()
        report = {}
        for compressed in (False, True):
            net = _resnet50(ResNet50, Nesterovs, dev, compute_dtype="bfloat16", image=image,
                            classes=classes)
            net.load_state_dict(state0)
            pw = parallel.ParallelWrapper.builder(net).gradient_sharing(
                HGS(compressed=compressed, world=1)).build()
            label = "compressed" if compressed else "dense"
            side = _gs_mode(pw, net, matmul, conv3x3, xs, ys, k, f"world 1 {label}")
            if compressed:
                require(all(math.isfinite(v) for v in side["losses"])
                        and side["compression_ratio"] > 1.0,
                        f"gs_resnet50: compressed losses {side['losses']}, ratio "
                        f"{side['compression_ratio']}")
            else:
                state = side["state_after_main"]
                same = (side["losses"] == plain
                        and all(torch.equal(plain_state[n], state[n]) for n in plain_state))
                require(same, f"gs_resnet50: dense world-1 sharing {side['losses']} is not "
                              f"bit for bit the eager fit twin's {plain}")
                side.update(bitwise_equal_to_eager_fit=True, eager_losses=plain)
            del side["state_after_main"]
            report[label] = side
            pw.gradient_sharing(None)
            del net, pw, side
            torch.cuda.empty_cache()
        from deeplearning4j_tpu_torch import native_ops
        emit("gs_resnet50", model="ResNet50", compute_dtype="bfloat16",
             input=f"{image}x{image}x3", classes=classes, updater="Nesterovs(0.1, 0.9)",
             global_batch=batch, k=k, world=1, cudnn_deterministic=True,
             host_codec_build=dict(native_ops.last_build), **report)
        if gang is None:
            cards = torch.cuda.device_count()
            outs = multihost.LocalLauncher(2, platform="cuda", gang=True).run(
                os.path.abspath(__file__), ["--gs-rank", "resnet50", str(k),
                                            str(multihost.free_port())],
                timeout=400, gradient_port=multihost.free_port())
            ranks = [_rank_report(o, "GS_RANK") for o in outs]
        else:
            cards, ranks = 0, gang()
        for mode in ("dense", "compressed"):
            hashes = {r[mode]["params_sha256"] for r in ranks}
            require(len(hashes) == 1,
                    f"gs_resnet50 gang: {mode} parameters differ over the ranks {hashes}")
            for r in ranks:
                require(all(math.isfinite(v) for v in r[mode]["losses"]),
                        f"gs_resnet50 gang: {mode} losses {r[mode]['losses']}")
        emit("gs_resnet50_gang", model="ResNet50", compute_dtype="bfloat16", world=2,
             rows_per_rank=batch // 2, k=k, cards_used=min(cards, 2) or None,
             shared_card=cards < 2, ranks_params_bitwise_equal=True,
             bn_statistics_per_rank_differ=len({r["dense"]["state_sha256"]
                                                for r in ranks}) > 1,
             rank0=ranks[0], rank1_step_ms={m: ranks[1][m]["step_ms"]
                                             for m in ("dense", "compressed")})
        return report, ranks
    finally:
        torch.backends.cudnn.deterministic = prev


def _comms_mlp(nn, Sgd, dev, cfg):
    conf = (nn.NeuralNetConfiguration.builder().seed(7).updater(Sgd(0.1))
            .list([nn.DenseLayer(n_out=cfg["hidden"], activation="tanh"),
                   nn.OutputLayer(n_out=3, loss="mcxent", activation="softmax")])
            .set_input_type(nn.InputType.feed_forward(cfg["n_in"])).build())
    return nn.MultiLayerNetwork(conf, device=dev).init()


def _gs_comms_rank(nn, parallel, matmul, Sgd, dev, rank, world, port, port2, cfg=GS_COMMS):
    """One rank of phase 48: `tests/mh_worker_comms.py`'s loop, dense over
    the mesh on `port`, then compressed over a new one on `port2`: the
    losses, the first layer's W hash, the exchange's stats, fused_dense
    launches and wall seconds of each mode."""
    HGS = parallel.HierarchicalGradientSharing
    out = {}
    for mode, cfg_s in (("dense", HGS(compressed=False, threshold=cfg["threshold"],
                                      rank=rank, world=world, port=port)),
                        ("compressed", HGS(threshold=cfg["threshold"], rank=rank,
                                           world=world, port=port2))):
        net = _comms_mlp(nn, Sgd, dev, cfg).set_gradient_sharing(cfg_s)
        rng = np.random.RandomState(0)
        losses, step_ms = [], []
        matmul.LAUNCHES.reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(cfg["steps"]):
            t1 = time.perf_counter()
            xg = rng.randn(world * cfg["rows"], cfg["n_in"]).astype(np.float32)
            labels = (xg[:, 0] > 0).astype(int) + (xg[:, 1] > 0).astype(int)
            yg = np.eye(3, dtype=np.float32)[labels]
            net.fit(xg[rank::world], yg[rank::world])
            losses.append(net.score())           # reads the loss: synchronizes
            step_ms.append((time.perf_counter() - t1) * 1e3)
        dt = time.perf_counter() - t0
        launches = matmul.LAUNCHES.value
        stats = net.gradient_sharing.stats()
        net.set_gradient_sharing(None)
        import hashlib
        w0 = net.params_["layer_0"]["W"].detach().cpu().numpy()
        out[mode] = dict(losses=losses, wall_s=dt, steps_per_sec=cfg["steps"] / dt,
                         first_step_ms=step_ms[0], median_step_ms=statistics.median(step_ms),
                         stats=stats, fused_dense_launches=launches,
                         w0_sha256=hashlib.sha256(w0.tobytes()).hexdigest())
    return out


def phase_gs_comms(multihost, dev, cfg=GS_COMMS, ranks=None):
    """Phase 48: bench.py's ``bench_comms`` A/B on the card, 2 processes
    (``--gs-rank comms``), each on its own card where there are two, else
    both on card 0.  Gates as ``bench.py:915``: at least 5x fewer bytes on
    the wire and the final loss within 1%; the ranks' first-layer W
    bitwise equal in each mode."""
    if ranks is None:
        cards = torch.cuda.device_count()
        outs = multihost.LocalLauncher(2, platform="cuda", gang=True).run(
            os.path.abspath(__file__), ["--gs-rank", "comms", "0",
                                        str(multihost.free_port())],
            timeout=300, gradient_port=multihost.free_port())
        ranks = [_rank_report(o, "GS_RANK") for o in outs]
    else:
        cards = 0
    res = {}
    for mode in ("dense", "compressed"):
        require(len({r[mode]["w0_sha256"] for r in ranks}) == 1,
                f"gs_comms: the ranks' first-layer W differ ({mode})")
        curves = np.mean([r[mode]["losses"] for r in ranks], axis=0)
        res[mode] = dict(
            wire_bytes=sum(r[mode]["stats"]["bytes_sent_total"]
                           + r[mode]["stats"]["bytes_received_total"] for r in ranks),
            final_loss=float(curves[-1]),
            compression_ratio_last=max(r[mode]["stats"]["last_compression_ratio"]
                                       for r in ranks),
            wall_s=max(r[mode]["wall_s"] for r in ranks),
            steps_per_sec=min(r[mode]["steps_per_sec"] for r in ranks),
            first_step_ms=max(r[mode]["first_step_ms"] for r in ranks),
            median_step_ms=max(r[mode]["median_step_ms"] for r in ranks),
            fused_dense_launches_per_step=ranks[0][mode]["fused_dense_launches"]
            / cfg["steps"],
            loss_curve_every_10=[round(float(v), 5) for v in curves[::10]])
    reduction = res["dense"]["wire_bytes"] / max(res["compressed"]["wire_bytes"], 1)
    parity = (abs(res["compressed"]["final_loss"] - res["dense"]["final_loss"])
              / max(abs(res["dense"]["final_loss"]), 1e-9))
    for mode in ("dense", "compressed"):
        require(res[mode]["fused_dense_launches_per_step"] > 0,
                f"gs_comms: fused_dense never launched on the {mode} path")
    report = dict(procs=2, model="MLP 16-32-3 tanh/softmax mcxent", updater="Sgd(0.1)",
                  threshold=cfg["threshold"], steps=cfg["steps"], rows_per_rank=cfg["rows"],
                  shared_card=cards < 2, bytes_reduction_x=reduction,
                  loss_parity_rel=parity, gates={"bytes_reduction_x": GS_MIN_BYTES_X,
                                                 "loss_parity_rel": GS_MAX_LOSS_REL},
                  w0_bitwise_equal_over_ranks=True, **res)
    emit("gs_comms", **report)
    require(reduction >= GS_MIN_BYTES_X and parity <= GS_MAX_LOSS_REL,
            f"gs_comms: bytes reduction {reduction:.2f}x (want >= {GS_MIN_BYTES_X}), loss "
            f"parity {parity:.5f} (want <= {GS_MAX_LOSS_REL})")
    return report


def gs_rank_main(argv):
    """One gang member of phases 47 and 48 (``--gs-rank resnet50 <k> <port
    of the second mesh>`` or ``--gs-rank comms 0 <port>``), started by
    ``multihost.LocalLauncher(2, platform="cuda", gang=True)``: no process
    group; the first mesh's port comes from ``DL4J_TPU_GRADIENT_PORT``.
    Prints its report as one ``GS_RANK`` line."""
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from deeplearning4j_tpu_torch import nn, parallel
    from deeplearning4j_tpu_torch.ops.kernels import conv3x3, dispatch, matmul
    from deeplearning4j_tpu_torch.parallel import multihost
    from deeplearning4j_tpu_torch.train import Nesterovs, Sgd
    from deeplearning4j_tpu_torch.zoo import ResNet50
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    dispatch.set_dispatch_mode("auto")
    dev = torch.device("cuda", int(os.environ[multihost.ENV_CARD]))
    torch.cuda.set_device(dev)
    rank, world = int(os.environ[multihost.ENV_PID]), int(os.environ[multihost.ENV_NPROC])
    port = int(os.environ[multihost.ENV_GRAD_PORT])
    if argv[0] == "resnet50":
        out = _gs_resnet50_rank(parallel, conv3x3, matmul, ResNet50, Nesterovs, dev, rank,
                                world, int(argv[1]), port, int(argv[2]))
    else:
        out = _gs_comms_rank(nn, parallel, matmul, Sgd, dev, rank, world, port, int(argv[2]))
    print("GS_RANK " + json.dumps(out), flush=True)
    return 0


# ---------------------------------------------------------------------------
# model parallelism over the mesh's model, seq and pipe axes (phases 49-51)
# ---------------------------------------------------------------------------

def _mp_axes(world, kind):
    """The mesh of each phase at `world` ranks: tp_vgg16 {data: w/m,
    model: m} with m = 2 where w >= 2; ring_flash {seq: w}; composed
    {data: 1, model: 2, pipe: w/2} where w >= 2, else every axis 1."""
    m = 2 if world >= 2 and world % 2 == 0 else 1
    if kind == "tp":
        return {"data": world // m, "model": m}
    if kind == "ring":
        return {"seq": world}
    return {"data": 1, "model": m, "pipe": world // m}


def _record_dense_shapes(matmul):
    """Wrap ``matmul._launch`` so each fused_dense launch records its (M,
    K, N); returns (the list, a function that puts the launcher back)."""
    shapes, orig = [], matmul._launch

    def rec(x, w, bias, activation):
        shapes.append((int(x.numel() // x.shape[-1]), int(w.shape[0]), int(w.shape[1])))
        return orig(x, w, bias, activation)
    matmul._launch = rec
    return shapes, lambda: setattr(matmul, "_launch", orig)


def _tp_dense_row(matmul, dev, M=TP_SHARD[0], K=TP_SHARD[1], N=TP_SHARD[2]):
    """fused_dense at fc6's column-parallel shard (32, 25088, 2048), f32
    relu: the kernel against its plain version, and their times beside the
    bound and the library call (``addmm`` + relu)."""
    gen = torch.Generator(device=dev).manual_seed(5)
    xa = torch.randn(M, K, generator=gen, device=dev)
    wa = torch.randn(K, N, generator=gen, device=dev) / math.sqrt(K)
    ba = torch.randn(N, generator=gen, device=dev)
    got = matmul.fused_dense(xa, wa, ba, "relu")
    want = matmul.fused_dense_reference(xa, wa, ba, "relu")
    err = (got - want).abs().max().item()
    require(err <= tolerance(torch.float32, want.abs().max().item()),
            f"tp_vgg16: fused_dense at {(M, K, N)} differs from its plain version by {err}")
    bound_ms, bound_by = bound(M, K, N, torch.float32)
    ms = time_ms(lambda: matmul.fused_dense(xa, wa, ba, "relu"), dev)
    return dict(shape=f"M={M} K={K} N={N} f32 relu", ms=ms,
                plain_ms=time_ms(lambda: matmul.fused_dense_reference(xa, wa, ba, "relu"), dev),
                library_ms=time_ms(lambda: torch.relu(torch.addmm(ba, xa, wa)), dev),
                bound_ms=bound_ms, bound_by=bound_by, share_of_bound=bound_ms / ms,
                max_abs_err=err)


def _tp_vgg16_rank(parallel, matmul, conv3x3, VGG16, Adam, MultiLayerNetwork, dev, world,
                   image=224, classes=1000, batch=VGG_BATCH, steps=TP_VGG_STEPS):
    """One rank of phase 49: VGG16 through ``ParallelWrapper(mesh, sharding_
    rules=ShardingRules())``; rank 0 also trains the plain twin."""
    import torch.distributed as dist
    from deeplearning4j_tpu_torch.nn import DenseLayer, MultiLayerConfiguration
    axes = _mp_axes(world, "tp")
    from deeplearning4j_tpu_torch.train import Sgd
    rank = dist.get_rank()
    shape = (image, image, 3)
    (xn, yn), = _image_batches(1, batch, shape, classes)
    x, y = torch.as_tensor(xn, device=dev), torch.as_tensor(yn, device=dev)
    mesh = parallel.make_mesh(axes, device=dev)

    def build(updater, rules=True, with_twin=True):
        """The wrapped network (under the default sharding rules, or none)
        and, on rank 0, its plain twin."""
        conf = VGG16(n_classes=classes, input_shape=shape, seed=123, updater=updater).conf()
        if axes["data"] > 1:
            # each data rank draws its own dropout masks; the twin could not follow
            for layer in conf.layers:
                if isinstance(layer, DenseLayer):
                    layer.dropout = None
        net = MultiLayerNetwork(MultiLayerConfiguration.from_json(conf.to_json()),
                                device=dev).init()
        twin = None
        if rank == 0 and with_twin:
            twin = MultiLayerNetwork(MultiLayerConfiguration.from_json(conf.to_json()),
                                     device=dev).init()
            twin.load_state_dict(net.state_dict())
        return net, twin, parallel.ParallelWrapper(
            net, mesh, sharding_rules=parallel.ShardingRules() if rules else None)

    net, twin, pw = build(Adam(1e-3))
    pw._place_model()
    fc6 = net.params_["layer_18"]["W"]
    resident = sum(p.numel() * p.element_size() for p in net.parameters())
    opt_bytes = parallel.opt_state_bytes_per_replica(net.opt_state_)
    torch.cuda.reset_peak_memory_stats()
    shapes, restore = _record_dense_shapes(matmul)
    try:
        # the main path, the counts set to 0 just before it and read just after
        _reset_counts(matmul, conv3x3)
        losses, step_ms = [], []
        for _ in range(steps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            pw.fit(x, y)
            losses.append(net.score())
            step_ms.append((time.perf_counter() - t0) * 1e3)
        counts = _step_counts(matmul, conv3x3)
    finally:
        restore()
    peak = torch.cuda.max_memory_allocated()
    require(counts[0] == steps * 2 and counts[1] == steps * 13 and counts[2] == steps * 12,
            f"tp_vgg16: launches {counts} over {steps} steps, want 2 + 13 + 12 a step")
    state = net.state_dict()               # whole leaves (collective: every rank)
    report = dict(world=world, mesh=axes, steps=steps, global_batch=batch,
                  rows_per_rank=batch // axes["data"],
                  dropout="on" if axes["data"] == 1 else "off (each data rank would draw "
                                                         "its own masks)",
                  losses=losses, step_ms_held=step_ms,
                  resident_param_bytes=resident, fc6_W_shape=list(fc6.shape),
                  fc6_W_bytes=fc6.numel() * fc6.element_size(), fc6_W_whole_bytes=411041792,
                  opt_state_bytes=opt_bytes,
                  launches_per_step=dict(zip(("fused_dense", "conv3x3_wgrad", "conv3x3_dgrad"),
                                             (c // steps for c in counts))),
                  fused_dense_shapes_per_step=[list(s) for s in shapes[:len(shapes) // steps]],
                  max_memory_allocated_gb=peak / 1e9)
    if rank == 0:
        twin_losses = []
        for _ in range(steps):
            twin.fit(x, y)
            twin_losses.append(twin.score())
        tstate = twin.state_dict()
        if axes["model"] == 1:
            require(losses == twin_losses and all(torch.equal(state[n], tstate[n])
                                                  for n in tstate),
                    f"tp_vgg16: at model 1 the wrapper's losses {losses} or parameters differ "
                    f"from the plain twin's {twin_losses}")
            report["bitwise_equal_to_plain_fit"] = True
        rel = _hold_losses(losses, twin_losses, None, "tp_vgg16")
        diffs = {n: ((state[n] - tstate[n]).abs().max()
                     / tstate[n].abs().max().clamp_min(1e-30)).item() for n in tstate}
        worst = max(diffs, key=diffs.get)
        l2 = math.sqrt(sum(((state[n] - tstate[n]).double() ** 2).sum().item() for n in tstate)
                       / sum((tstate[n].double() ** 2).sum().item() for n in tstate))
        report.update(twin_losses=twin_losses, rel_loss_diff=rel,
                      max_rel_param_diff=diffs[worst], max_rel_param_diff_leaf=worst,
                      param_l2_rel_diff=l2)
        del twin, tstate
    del state

    def step():
        pw.fit(x, y)
        net.score()

    timed = []
    for _ in range(TP_VGG_TIMED):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step()
        timed.append((time.perf_counter() - t0) * 1e3)
    report.update(step_ms_timed=timed, step_ms=statistics.median(timed))

    def block():
        for _ in range(TP_VGG_TRACED):
            step()

    window_ms, busy_ms, by_name, n = _trace(block)
    report["profile"] = ({"steps": TP_VGG_TRACED, "window_ms": window_ms,
                          "device_busy_ms": "not measured",
                          "idle_share": "not measured"} if busy_ms is None else
                         {"steps": TP_VGG_TRACED, "window_ms": window_ms,
                          "device_busy_ms": busy_ms,
                          "idle_share": max(0.0, 1.0 - busy_ms / window_ms), "kernels": n,
                          "nccl_ms": _nccl_ms(by_name),
                          "fused_dense_ms": _share(by_name, "fused_dense_kernel"),
                          "top": _top(by_name, 8)})
    del pw, net
    torch.cuda.empty_cache()
    report["sgd_twin"] = _tp_vgg16_sgd(lambda *a: build(Sgd(TP_SGD_LR), *a), x, y, axes, steps)
    torch.cuda.empty_cache()
    if rank == 0:
        report["fused_dense_at_shard"] = _tp_dense_row(matmul, dev)
    return report


def _update_rows(state, tstate, start):
    """Each leaf's Sgd update (whole after the steps, less the start)
    against the twin's: cosine, least-squares scale, and max|diff| over the
    twin's max|update|."""
    rows = {}
    for n, t in tstate.items():
        u = (state[n] - start[n]).double().reshape(-1)
        ut = (t - start[n]).double().reshape(-1)
        den = (ut * ut).sum().item()
        rows[n] = dict(cos=((u * ut).sum() / (u.norm() * ut.norm()).clamp_min(1e-300)).item(),
                       scale=(u * ut).sum().item() / den if den else 1.0,
                       of_update=(u - ut).abs().max().item() / max(ut.abs().max().item(),
                                                                  1e-30))
    return rows


def _tp_vgg16_sgd(build, x, y, axes, steps):
    """Phase 49's Sgd pair: the wrapped VGG16 (`build(True, True)`) and,
    on rank 0, its plain twin take `steps` Sgd steps; above model 1 a
    data-parallel control (`build(False, False)`: the same mesh, no
    sharding rules) takes them too.  Bitwise at model 1; above it each leaf's update is held to the
    twin's by its cosine and least-squares scale, and its max|diff| over
    the twin's max|update| is reported beside the control's."""
    net, twin, pw = build(True, True)
    runs = {"tp": (net, pw)}
    start = {n: t.clone() for n, t in twin.state_dict().items()} if twin is not None else None
    if axes["model"] > 1:
        dnet, _, dpw = build(False, False)
        if start is not None:
            dnet.load_state_dict(start)    # rank 0's, broadcast at placement
        runs["dp"] = (dnet, dpw)
    states, losses = {}, {}
    for tag, (net, pw) in runs.items():
        losses[tag] = []
        for _ in range(steps):
            pw.fit(x, y)
            losses[tag].append(net.score())
        states[tag] = net.state_dict()     # whole leaves (collective: every rank)
    out = dict(updater=f"Sgd({TP_SGD_LR})", steps=steps, losses=losses["tp"],
               bound=f"every leaf's update against the twin's: cosine >= {TP_SGD_COS}, "
                     f"least-squares scale within {TP_SGD_SCALE} of 1")
    if twin is not None:
        twin_losses = []
        for _ in range(steps):
            twin.fit(x, y)
            twin_losses.append(twin.score())
        tstate = twin.state_dict()
        require(all(math.isfinite(v) for v in losses["tp"] + twin_losses),
                f"tp_vgg16 sgd: non-finite loss {losses['tp']} {twin_losses}")
        if axes["model"] == 1:
            require(losses["tp"] == twin_losses and all(torch.equal(states["tp"][n], tstate[n])
                                                        for n in tstate),
                    f"tp_vgg16 sgd: at model 1 the wrapper's losses {losses['tp']} or "
                    f"parameters differ from the plain twin's {twin_losses}")
        rows = _update_rows(states["tp"], tstate, start)
        bad = {n: r for n, r in rows.items()
               if not (r["cos"] >= TP_SGD_COS and abs(r["scale"] - 1) <= TP_SGD_SCALE)}
        require(not bad, f"tp_vgg16 sgd: updates unlike the plain twin's: {bad}")
        worst = max(rows, key=lambda n: rows[n]["of_update"])
        out.update(twin_losses=twin_losses,
                   rel_loss_diff=[abs(a - b) / abs(b) for a, b in zip(losses["tp"],
                                                                      twin_losses)],
                   bitwise_equal_to_plain_fit=axes["model"] == 1,
                   min_cos=min(r["cos"] for r in rows.values()),
                   max_scale_off=max(abs(r["scale"] - 1) for r in rows.values()),
                   worst_leaf=worst, worst=rows[worst],
                   leaves={n: rows[n] for n in sorted(rows, key=lambda n: -rows[n]["of_update"])
                           [:6]})
        if "dp" in states:
            dp = _update_rows(states["dp"], tstate, start)
            out["dp_control"] = dict(
                losses=losses["dp"], worst_leaf=max(dp, key=lambda n: dp[n]["of_update"]),
                worst_of_update=max(r["of_update"] for r in dp.values()),
                min_cos=min(r["cos"] for r in dp.values()),
                max_scale_off=max(abs(r["scale"] - 1) for r in dp.values()),
                leaves={n: dp[n] for n in out["leaves"]},
                tp_vs_dp_of_update=max(
                    (states["tp"][n] - states["dp"][n]).abs().max().item()
                    / max((states["dp"][n] - start[n]).abs().max().item(), 1e-30)
                    for n in tstate))
        del twin, tstate, start
    del states, runs, net, pw
    return out


def _ring_flash_rank(parallel, attention, dev, world, shape=RING_SHAPE):
    """One rank of phase 50: ``ring_attention_flash`` over {seq: w} on this
    rank's T chunk of q, k, v [4, 12, 2048, 64], f32 and bf16, causal and
    not: against the plain ring on the same ranks, and on rank 0 the whole
    outputs and gradients against the full attention's."""
    import torch.distributed as dist
    from deeplearning4j_tpu_torch.ops import attention_kernels as ak
    from deeplearning4j_tpu_torch.parallel.collectives import _gather
    B, H, T, D = shape
    mesh = parallel.make_mesh(_mp_axes(world, "ring"), device=dev)
    rank, r = dist.get_rank(), mesh.coordinate("seq")
    per = T // world
    cut = slice(r * per, (r + 1) * per)
    rng = np.random.RandomState(0)
    q, k, v, g = (torch.as_tensor(rng.randn(B, H, T, D).astype(np.float32), device=dev)
                  for _ in range(4))

    def whole(t):
        return _gather(t.contiguous(), mesh, "seq", 2) if world > 1 else t

    cases = {}
    for dt in (torch.float32, torch.bfloat16):
        for causal in (False, True):
            tag = f"{str(dt)[6:]} causal={causal}"
            ql, kl, vl = (t[:, :, cut].to(dt).contiguous().requires_grad_(True)
                          for t in (q, k, v))
            gl = g[:, :, cut].to(dt).contiguous()
            torch.cuda.synchronize()
            before = attention.LAUNCHES.value
            out = parallel.ring_attention_flash(ql, kl, vl, "seq", causal=causal, mesh=mesh)
            torch.cuda.synchronize()
            launches = attention.LAUNCHES.value - before
            require(launches == world, f"ring_flash {tag}: {launches} flash_attn_fwd launches "
                                       f"a call, want {world}")
            grads = torch.autograd.grad(out, (ql, kl, vl), gl)
            with torch.no_grad():
                plain = parallel.ring_attention(ql, kl, vl, "seq", causal=causal, mesh=mesh)
            err = (out.float() - plain.float()).abs().max().item()
            pmax = plain.float().abs().max().item()
            require(err <= tolerance(dt, pmax),
                    f"ring_flash {tag}: against the plain ring max|diff| {err}")
            case = {"launches": launches, "rel_err_vs_plain_ring": err / pmax}
            outs = [whole(out.detach())] + [whole(d) for d in grads]
            if rank == 0:
                qf, kf, vf = (t.to(dt).float().requires_grad_(True) for t in (q, k, v))
                ref = ak.mha_reference(qf, kf, vf, causal=causal)
                ref_g = torch.autograd.grad(ref, (qf, kf, vf), g.to(dt).float())
                for name, a, b in zip(("out", "dq", "dk", "dv"), outs, (ref.detach(),) + ref_g):
                    e = (a.float() - b).abs().max().item()
                    rmax = b.abs().max().item()
                    require(torch.isfinite(a).all().item() and e <= tolerance(dt, rmax),
                            f"ring_flash {tag} {name}: against the full attention max|diff| "
                            f"{e} > {tolerance(dt, rmax)}")
                    case[f"rel_err_{name}_vs_full"] = e / rmax
                del qf, kf, vf, ref, ref_g
            fl = lambda: parallel.ring_attention_flash(   # noqa: E731
                ql.detach(), kl.detach(), vl.detach(), "seq", causal=causal, mesh=mesh)
            pl = lambda: parallel.ring_attention(         # noqa: E731
                ql.detach(), kl.detach(), vl.detach(), "seq", causal=causal, mesh=mesh)
            with torch.no_grad():
                case["ms"] = time_ms(fl, dev, n=5)
                case["plain_ring_ms"] = time_ms(pl, dev, n=5)
            cases[tag] = case
            del out, grads, plain, outs
    torch.cuda.empty_cache()
    return dict(world=world, shape=list(shape), t_per_rank=per, cases=cases)


def _composed_rank(parallel, dev, world, cfg=COMPOSED):
    """One rank of phase 51: ComposedParallel at BERT-base widths, 3 SGD
    steps held on rank 0 to ``composed_oracle``; the dense world-1
    gradient-sharing facade and ``composed_train_steps(k)`` against the
    plain steps."""
    import torch.distributed as dist
    from deeplearning4j_tpu_torch.parallel import composed as C
    axes = _mp_axes(world, "composed")
    rank = dist.get_rank()
    S, D, H, F, T = axes["pipe"], cfg["d_model"], cfg["heads"], cfg["d_ff"], cfg["t"]
    B = 4 * S * axes["data"]
    mesh = parallel.make_mesh(axes, device=dev)
    full = {k: v * cfg["init_scale"] if v.ndim == 3 else v for k, v in
            C.init_stage_params(np.random.RandomState(7), S, D, H, F, device=dev).items()}
    rng = np.random.RandomState(0)
    x = torch.as_tensor((rng.randn(B, T, D) * 0.5).astype(np.float32), device=dev)
    y = torch.as_tensor((rng.randn(B, T, D) * 0.5).astype(np.float32), device=dev)

    def oracle_steps(lr, steps):
        p, out = {k: v.clone() for k, v in full.items()}, []
        for _ in range(steps):
            pp = {k: v.detach().requires_grad_(True) for k, v in p.items()}
            loss = torch.mean((C.composed_oracle(pp, x, H) - y) ** 2)
            grads = torch.autograd.grad(loss, list(pp.values()))
            p = {k: pp[k].detach() - lr * g for k, g in zip(pp, grads)}
            out.append(loss.item())
        return out, p

    # the lr: the first of the list at which the oracle's loss falls each step
    pick = torch.zeros(1, device=dev)
    if rank == 0:
        for i, lr in enumerate(cfg["lrs"]):
            ls, _ = oracle_steps(lr, cfg["steps"])
            if all(b < a for a, b in zip(ls, ls[1:])):
                pick.fill_(i)
                break
        else:
            pick.fill_(-1)
    dist.broadcast(pick, 0)
    require(pick.item() >= 0, f"composed: no lr of {cfg['lrs']} makes the oracle's loss fall")
    lr = cfg["lrs"][int(pick.item())]
    local = C.shard_stage_params(full, mesh)
    step = C.composed_train_step(mesh, H, lr=lr)
    step(local, x, y)[1].item()          # warm-up: first use of each group's communicators
    torch.cuda.reset_peak_memory_stats()
    p, losses, step_ms = local, [], []
    for _ in range(cfg["steps"]):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        p, loss = step(p, x, y)
        losses.append(loss.item())
        step_ms.append((time.perf_counter() - t0) * 1e3)
    peak = torch.cuda.max_memory_allocated()
    gathered = C.gather_stage_params(p, mesh)
    report = dict(world=world, mesh=axes, stages=S, microbatches=S, global_batch=B,
                  d_model=D, heads=H, d_ff=F, t=T, lr=lr,
                  init_std=round(0.2 * cfg["init_scale"], 6), losses=losses,
                  step_ms_all=step_ms, step_ms=statistics.median(step_ms),
                  max_memory_allocated_gb=peak / 1e9,
                  local_param_shapes={k: list(v.shape) for k, v in local.items()})
    if rank == 0:
        o_losses, o_params = oracle_steps(lr, cfg["steps"])
        rel = [abs(a - b) / abs(b) for a, b in zip(losses, o_losses)]
        prel = max(((gathered[k] - o_params[k]).abs().max()
                    / o_params[k].abs().max()).item() for k in o_params)
        require(all(r <= F32_RTOL for r in rel) and prel <= COMPOSED_PARAM_RTOL,
                f"composed: losses {losses} against the oracle's {o_losses} (rel {rel}), "
                f"params rel {prel}")
        require(all(b < a for a, b in zip(losses, losses[1:])), f"composed: losses {losses}")
        report.update(oracle_losses=o_losses, rel_loss_diff=rel, max_rel_param_diff=prel)
    del gathered
    plain = parallel.ComposedParallel(mesh, n_heads=H, lr=lr)
    shared = parallel.ComposedParallel(mesh, n_heads=H, lr=lr, gradient_sharing=
                                       parallel.HierarchicalGradientSharing(compressed=False,
                                                                            world=1))
    pa, la = plain.fit_batch(local, x, y)
    pb, lb = shared.fit_batch(local, x, y)
    require(torch.equal(la, lb) and all(torch.equal(pa[k], pb[k]) for k in pa),
            "composed: the dense world-1 sharing facade differs from the plain step")
    shared.close()
    k = cfg["k"]
    xs, ys = torch.broadcast_to(x, (k,) + tuple(x.shape)), torch.broadcast_to(y, (k,) +
                                                                             tuple(y.shape))
    p_f, fused = C.composed_train_steps(mesh, H, lr=lr)(local, xs, ys)
    p_s = local
    for _ in range(k):
        p_s, _ = step(p_s, x, y)
    require(fused.tolist() == losses[:k] and all(torch.equal(p_f[n], p_s[n]) for n in p_s),
            f"composed: composed_train_steps(k={k}) losses {fused.tolist()} differ from "
            f"{k} single steps' {losses[:k]}")
    report.update(sharing_facade_bitwise=True, fused_steps_bitwise=True)
    return report


def _mp_phase(kind, world, fn, multihost, timeout):
    """Phases 49-51 at `world`: in this process on its one-rank group at
    world 1, else one rank a card through ``chip_smoke.py --mp-rank``;
    returns rank 0's report and every rank's."""
    if world == 1:
        rep = fn()
        return rep, [rep]
    outs = multihost.LocalLauncher(world, platform="cuda").run(
        os.path.abspath(__file__), ["--mp-rank", kind], timeout=timeout)
    ranks = [_rank_report(o, "MP_RANK") for o in outs]
    return ranks[0], ranks


def phase_tp_vgg16(parallel, multihost, matmul, conv3x3, VGG16, Adam, MultiLayerNetwork, dev):
    world = torch.cuda.device_count()
    report, ranks = _mp_phase("tp_vgg16", world, lambda: _tp_vgg16_rank(
        parallel, matmul, conv3x3, VGG16, Adam, MultiLayerNetwork, dev, world),
        multihost, 600)
    report["resident_param_bytes_per_rank"] = [r["resident_param_bytes"] for r in ranks]
    report["fc6_W_bytes_per_rank"] = [r["fc6_W_bytes"] for r in ranks]
    report["step_ms_timed_per_rank"] = [r["step_ms_timed"] for r in ranks]
    emit("tp_vgg16", model="VGG16", input="224x224x3 f32", classes=1000, updater="Adam(1e-3)",
         rules="ShardingRules() (Megatron default)", backend="nccl", **report)
    return report


def phase_ring_flash(parallel, multihost, attention, dev):
    world = torch.cuda.device_count()
    report, ranks = _mp_phase("ring_flash", world, lambda: _ring_flash_rank(
        parallel, attention, dev, world), multihost, 400)
    emit("ring_flash", backend="nccl", bounds="tolerance(dtype, max|ref|): f32 1e-4 "
         "relative, bf16 2 ulp of the max", **report)
    return report


def phase_composed(parallel, multihost, dev):
    world = torch.cuda.device_count()
    report, ranks = _mp_phase("composed", world, lambda: _composed_rank(parallel, dev, world),
                              multihost, 400)
    report["step_ms_all_per_rank"] = [r["step_ms_all"] for r in ranks]
    report["max_memory_allocated_gb_per_rank"] = [r["max_memory_allocated_gb"] for r in ranks]
    emit("composed", dtype="float32", backend="nccl",
         bounds=f"losses {F32_RTOL} relative, parameters {COMPOSED_PARAM_RTOL} of the max",
         **report)
    return report


def mp_rank_main(argv):
    """One rank of phases 49-51 at world > 1 (``--mp-rank tp_vgg16 |
    ring_flash | composed``), started by ``multihost.LocalLauncher``:
    prints its report as one ``MP_RANK`` line."""
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from deeplearning4j_tpu_torch import parallel
    from deeplearning4j_tpu_torch.nn import MultiLayerNetwork
    from deeplearning4j_tpu_torch.ops.kernels import attention, conv3x3, dispatch, matmul
    from deeplearning4j_tpu_torch.parallel import multihost
    from deeplearning4j_tpu_torch.train import Adam
    from deeplearning4j_tpu_torch.zoo import VGG16
    import torch.distributed as dist
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dispatch.set_dispatch_mode("auto")
    dev = multihost.initialize(timeout_s=300)
    world = dist.get_world_size()
    if argv[0] == "tp_vgg16":
        out = _tp_vgg16_rank(parallel, matmul, conv3x3, VGG16, Adam, MultiLayerNetwork, dev,
                             world)
    elif argv[0] == "ring_flash":
        out = _ring_flash_rank(parallel, attention, dev, world)
    else:
        out = _composed_rank(parallel, dev, world)
    print("MP_RANK " + json.dumps(out), flush=True)
    os._exit(0)


# ---------------------------------------------------------------------------
# fault-tolerant and elastic training (phases 52-55)
# ---------------------------------------------------------------------------

FT_R50 = dict(batch=64, image=224, classes=1000, k=5, steps=15, save_every=5, kill_at=7,
              timed_blocks=3)
# bench.py's --resilience fixture and epoch; `pairs` of whole epochs for the
# gate and `aa_pairs` without saves for its noise floor (see phase_resilience_ab)
RES_AB = dict(n_batches=256, batch=64, n_in=784, save_every=128, keep_last=3, depth=2,
              repeats=3, pairs=16, aa_pairs=4)
RES_MAX_OVERHEAD_PCT = 5.0           # bench.py's --resilience gate
ES_LENET = dict(batch=64, train_batches=4, val_batches=2, max_epochs=3)
ELASTIC_AB = dict(steps=24, kill_step=8, heartbeat_s=0.1, failure_deadline_s=2.0)
ELASTIC_DETECT_SLACK_MS = 2000.0     # bench.py:1024-1030's gates
ELASTIC_LOSS_RTOL = 1e-9
ELASTIC_BUDGET_MS = 15000.0
EL_R50 = dict(procs=3, global_batch=48, steps=10, kill_step=4, image=224, classes=1000,
              clean_steps=4, heartbeat_s=0.25, deadline_floor_s=5.0, deadline_steps=3.0)


def _ft_state(net):
    """Clones of the parameters, layer state (BatchNorm statistics) and
    updater moments, in a fixed order."""
    return ([v.detach().clone() for _, v in sorted(net.state_dict().items())]
            + [t.detach().clone() for t in _opt_leaves(net)])


def _same_state(a, b):
    return len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))


def _resilience_series():
    from deeplearning4j_tpu_torch.monitor.registry import registry
    reg = registry()
    h = reg.get("resilience_checkpoint_save_ms")
    return {"saves": getattr(reg.get("resilience_checkpoints_total"), "value", 0),
            "write_ms_sum": h.sum if h is not None else 0.0,
            "write_count": h.count if h is not None else 0,
            "bytes": getattr(reg.get("resilience_checkpoint_bytes"), "value", None),
            "restores": getattr(reg.get("resilience_restores_total"), "value", 0)}


def _ft_fit(train, data, ResNet50, Nesterovs, dev, ckpt, batches, cfg, hooks=()):
    """One ``FaultTolerantTrainer`` fit of bf16 ResNet-50 over `batches` in
    fused blocks of k, with an async manager on `ckpt` saving every
    `save_every` steps; returns (net, trainer, manager, the exception it
    stopped on or None, seconds)."""
    from deeplearning4j_tpu_torch.utils.chaos import ChaosError
    res = train.resilience
    net = _resnet50(ResNet50, Nesterovs, dev, compute_dtype="bfloat16", image=cfg["image"],
                    classes=cfg["classes"])
    mgr = res.CheckpointManager(ckpt, keep_last=cfg["steps"] // cfg["save_every"] + 2,
                                save_every_steps=cfg["save_every"], async_save=True)
    tr = res.FaultTolerantTrainer(net, mgr, hooks=hooks)
    err = None
    t0 = time.perf_counter()
    try:
        tr.fit(data.ListDataSetIterator(batches), epochs=1, fused_steps=cfg["k"])
    except (res.Preempted, ChaosError) as e:
        err = e
    torch.cuda.synchronize()
    return net, tr, mgr, err, time.perf_counter() - t0


def phase_ft_resnet50(train, data, conv3x3, matmul, ResNet50, Nesterovs, dev, cfg=FT_R50):
    """Phase 52: ``FaultTolerantTrainer`` around bench.py's bf16 ResNet-50
    at full width: U uninterrupted, K killed in process
    (``KillSwitch(kill_at, "exception")``) then resumed by a fresh network
    and trainer on the same directory, P preempted (``"sigterm"`` ->
    ``Preempted``) then resumed: K's and P's parameters, BatchNorm
    statistics and moments are U's bit for bit.  Then a restore in place
    into U's live network (its captured graph kept) replays one more block
    bitwise against a fresh network restored from the same checkpoint."""
    import shutil
    import tempfile
    from deeplearning4j_tpu_torch.utils import chaos
    k, steps = cfg["k"], cfg["steps"]
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True   # bitwise twins (phase 34's note)
    root = tempfile.mkdtemp(prefix="ft_resnet50_")
    try:
        raw = _image_batches(steps, cfg["batch"], (cfg["image"], cfg["image"], 3),
                             cfg["classes"])
        batches = [data.DataSet(x, y) for x, y in raw]
        series0 = _resilience_series()
        torch.cuda.reset_peak_memory_stats()
        _reset_counts(matmul, conv3x3)
        net, tr, mgr, err, u_s = _ft_fit(train, data, ResNet50, Nesterovs, dev,
                                         os.path.join(root, "u"), batches, cfg)
        counts = _step_counts(matmul, conv3x3)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        series1 = _resilience_series()
        require(err is None and net.iteration == steps
                and mgr.steps() == list(range(0, steps + 1, cfg["save_every"])),
                f"ft_resnet50 U: stopped on {err!r} at {net.iteration}, saves {mgr.steps()}")
        want = (k + 1) * BODY_CONVS          # the warm-up step and the capture
        require(counts == (0, want, want),
                f"ft_resnet50 U: launches {counts} at the warm-up and capture, want 0, "
                f"{want}, {want}")
        u_state = _ft_state(net)
        saves = series1["saves"] - series0["saves"]
        write_ms = ((series1["write_ms_sum"] - series0["write_ms_sum"])
                    / max(series1["write_count"] - series0["write_count"], 1))

        # restore in place into the live network: its graph replays on
        step = net._scan_step
        captures0 = step.captures
        ptrs = [t.data_ptr() for t in net._carry()]
        t0 = time.perf_counter()
        meta = mgr.restore(net, step=steps - k)
        restore_s = time.perf_counter() - t0
        require(meta["step"] == steps - k and net.iteration == steps - k
                and [t.data_ptr() for t in net._carry()] == ptrs,
                f"ft_resnet50: the restore at {meta['step']} rebound a carried tensor")
        xs = torch.as_tensor(np.stack([x for x, _ in raw[steps - k:]]), device=dev)
        ys = torch.as_tensor(np.stack([y for _, y in raw[steps - k:]]), device=dev)
        net.fit_steps(xs, ys)
        torch.cuda.synchronize()
        require(step.captures == captures0,
                "ft_resnet50: the block after the restore was captured anew")
        live = _ft_state(net)
        fresh = _resnet50(ResNet50, Nesterovs, dev, compute_dtype="bfloat16",
                          image=cfg["image"], classes=cfg["classes"])
        mgr.restore(fresh, step=steps - k)
        fresh.fit_steps(xs, ys)
        torch.cuda.synchronize()
        in_place_bitwise = _same_state(live, _ft_state(fresh))
        require(in_place_bitwise and _same_state(live, u_state),
                "ft_resnet50: the block replayed after an in-place restore is not the "
                "fresh restore's (or U's last block) bit for bit")
        del fresh
        torch.cuda.empty_cache()
        replay, graph_kernels = _kept_launches(
            net, lambda: net.fit_steps(xs, ys),
            {"fused_dense": 0, "conv3x3_wgrad": k * BODY_CONVS,
             "conv3x3_dgrad": k * BODY_CONVS}, "ft_resnet50")

        # ms a step with and without the manager (the saves' stall and the
        # in-flight write charged, as bench.py's --resilience does)
        def blocks(manager):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(cfg["timed_blocks"]):
                net.fit_steps(xs, ys)
                if manager is not None:
                    manager.maybe_save(net)
            if manager is not None:
                manager.wait()
            torch.cuda.synchronize()
            return (time.perf_counter() - t0) * 1e3 / (cfg["timed_blocks"] * k)
        timed = train.resilience.CheckpointManager(os.path.join(root, "t"), keep_last=2,
                                                   save_every_steps=k, async_save=True)
        timed._last_save_step = net.iteration
        bare_ms = [blocks(None)]
        ckpt_ms = [blocks(timed)]
        snapshot_ms = [s * 1e3 for s in timed.snapshot_s]
        del net, step, tr, mgr, timed
        shutil.rmtree(os.path.join(root, "u"), ignore_errors=True)
        shutil.rmtree(os.path.join(root, "t"), ignore_errors=True)
        torch.cuda.empty_cache()

        runs = {}
        for label, mode, exc in (("K", "exception", chaos.ChaosError),
                                 ("P", "sigterm", train.resilience.Preempted)):
            d = os.path.join(root, label)
            ks = chaos.KillSwitch(cfg["kill_at"], mode)
            net, tr, mgr, err, first_s = _ft_fit(train, data, ResNet50, Nesterovs, dev, d,
                                                 batches, cfg, hooks=(ks,))
            stopped_at = net.iteration
            require(isinstance(err, exc) and stopped_at == 2 * k,
                    f"ft_resnet50 {label}: stopped on {err!r} at {stopped_at}")
            del net, tr, mgr
            torch.cuda.empty_cache()
            net, tr, mgr, err, second_s = _ft_fit(train, data, ResNet50, Nesterovs, dev, d,
                                                  batches, cfg)
            resumed = tr.resumed_from["step"]
            same = err is None and net.iteration == steps and _same_state(_ft_state(net),
                                                                          u_state)
            runs[label] = dict(mode=mode, stopped_at=stopped_at, resumed_from_step=resumed,
                               first_s=first_s, resumed_s=second_s, bitwise_u=same)
            require(same, f"ft_resnet50 {label}: resumed from {resumed}, not U's state bit "
                          "for bit")
            del net, tr, mgr
            shutil.rmtree(d, ignore_errors=True)
            torch.cuda.empty_cache()
        require(runs["K"]["resumed_from_step"] == k and runs["P"]["resumed_from_step"] == 2 * k,
                f"ft_resnet50: resume points {runs}")
        report = dict(
            model="ResNet50", compute_dtype="bfloat16",
            input=f"{cfg['image']}x{cfg['image']}x3", classes=cfg["classes"],
            batch=cfg["batch"], updater="Nesterovs(0.1, 0.9)", cudnn_deterministic=True,
            fused_steps=k, steps=steps, save_every_steps=cfg["save_every"], async_save=True,
            u_seconds=u_s, u_saves=saves, kill_at=cfg["kill_at"], runs=runs,
            k_and_p_bitwise_u=True, in_place_restore_bitwise=in_place_bitwise,
            restore_s=restore_s, restore_kept_the_graph=True,
            launches_counted_at_warmup_and_capture=dict(
                zip(("fused_dense", "conv3x3_wgrad", "conv3x3_dgrad"), counts)),
            launches_per_replayed_block=replay, graph_kernel_nodes=graph_kernels,
            step_ms_without_manager=min(bare_ms), step_ms_with_manager=min(ckpt_ms),
            step_ms_all={"bare": bare_ms, "ckpt": ckpt_ms},
            overhead_pct=(min(ckpt_ms) - min(bare_ms)) / min(bare_ms) * 100.0,
            snapshot_ms_on_step_path=snapshot_ms,
            background_write_ms=write_ms, checkpoint_bytes=series1["bytes"],
            max_memory_allocated_gb=peak_gb)
        emit("ft_resnet50", **report)
        return report
    finally:
        torch.backends.cudnn.deterministic = prev
        shutil.rmtree(root, ignore_errors=True)


def _etl_fixture(data, nn, dev, n_batches, batch, n_in):
    """bench.py's ``_pipeline_fixture``: an iterator that builds each batch
    from raw f64 rows on demand, the MLP 784-512-256-10 (seed 0, default
    updater) and a normalizer fitted on the stream."""

    class EtlIterator(data.DataSetIterator):
        def __init__(self, raw_x, raw_y, batch):
            self.raw_x, self.raw_y, self._batch = raw_x, raw_y, batch

        def __iter__(self):
            for i in range(0, len(self.raw_x), self._batch):
                x = (self.raw_x[i:i + self._batch] * 0.5 + 1.0).astype(np.float32)
                y = np.eye(10, dtype=np.float32)[self.raw_y[i:i + self._batch]]
                yield data.DataSet(x, y)

        def reset(self):
            pass

        def batch_size(self):
            return self._batch

        def __len__(self):
            return (len(self.raw_x) + self._batch - 1) // self._batch

    def make_net():
        conf = (nn.NeuralNetConfiguration.builder().seed(0)
                .list([nn.DenseLayer(n_out=512, activation="relu"),
                       nn.DenseLayer(n_out=256, activation="relu"),
                       nn.OutputLayer(n_out=10, loss="mcxent", activation="softmax")])
                .set_input_type(nn.InputType.feed_forward(n_in)).build())
        return nn.MultiLayerNetwork(conf, device=dev).init()

    rng = np.random.RandomState(0)
    raw_x = rng.rand(n_batches * batch, n_in) * 100.0
    raw_y = rng.randint(0, 10, n_batches * batch)
    nz = data.NormalizerStandardize().fit(EtlIterator(raw_x, raw_y, batch))
    return (lambda: EtlIterator(raw_x, raw_y, batch)), make_net, nz


def _resilience_ab_run(train, data, nn, matmul, LeNet, dev, cfg=RES_AB, es=ES_LENET):
    """Phase 53's measurements (run in a fresh process, as bench.py runs
    its ``--resilience`` mode): the A/B, its launch counts, and the early
    stopping run beside its ``reference``-mode twin (cuDNN deterministic).
    Returns {"ab": ..., "early_stopping": ...}; the holds are the
    caller's."""
    import shutil
    import tempfile
    from deeplearning4j_tpu_torch.ops.kernels import dispatch
    from deeplearning4j_tpu_torch.train import earlystopping as es_mod
    res = train.resilience
    make_it, make_net, nz = _etl_fixture(data, nn, dev, cfg["n_batches"], cfg["batch"],
                                         cfg["n_in"])
    root = tempfile.mkdtemp(prefix="resilience_ab_")
    series0 = _resilience_series()

    def side(with_ckpt):
        net = make_net()
        net.set_normalizer(nz)
        mgr = res.CheckpointManager(os.path.join(root, "ck"), keep_last=cfg["keep_last"],
                                    save_every_steps=cfg["save_every"],
                                    async_save=True) if with_ckpt else None
        return net, mgr

    def epoch(net, mgr):
        pf = data.DevicePrefetchIterator(make_it(), depth=cfg["depth"], device=dev)
        t0 = time.perf_counter()
        for ds in pf:
            net._fit_dataset(ds)
            if mgr is not None:
                mgr.maybe_save(net)
        if mgr is not None:
            mgr.wait()
        float(net.score())
        return time.perf_counter() - t0

    def pairs(n, manager):
        """`n` pairs of whole epochs, (checkpointing, bare) seconds each,
        the order alternating a pair (ABBA), so drift within a pair hits
        both sides alike; `manager` None: no saves (the A/A)."""
        runs = []
        for i in range(n):
            if i % 2 == 0:
                c = epoch(net_ck, manager)
                runs.append((c, epoch(net_bare, None)))
            else:
                b = epoch(net_bare, None)
                runs.append((epoch(net_ck, manager), b))
        return runs

    net_ck, mgr = side(True)
    net_bare, _ = side(False)
    try:
        matmul.LAUNCHES.reset()
        epoch(net_ck, mgr)
        epoch(net_bare, None)
        warm_launches = matmul.LAUNCHES.value
        ab_runs = pairs(cfg["pairs"], mgr)
        aa_runs = pairs(cfg["aa_pairs"], None)
    finally:
        mgr.wait()
        shutil.rmtree(root, ignore_errors=True)
    series1 = _resilience_series()
    n = cfg["n_batches"] * cfg["batch"]

    def paired(runs):
        pct = [(c - b) / b * 100.0 for c, b in runs]
        ck, bare = float(np.median([c for c, _ in runs])), float(np.median([b for _, b in runs]))
        return dict(overhead_pct=float(np.median(pct)), pair_pct=pct,
                    ckpt_s=[c for c, _ in runs], bare_s=[b for _, b in runs],
                    median_ckpt_s=ck, median_bare_s=bare,
                    ckpt_samples_per_sec=n / ck, bare_samples_per_sec=n / bare)
    first = ab_runs[:cfg["repeats"]]
    best_ck, best_bare = min(c for c, _ in first), min(b for _, b in first)
    gated = paired(ab_runs)
    ab = dict(overhead_pct=gated["overhead_pct"], ab=gated, aa=paired(aa_runs),
              bench_min_of_first=dict(epochs=cfg["repeats"], wall_ckpt_s=best_ck,
                                      wall_bare_s=best_bare,
                                      overhead_pct=(best_ck - best_bare) / best_bare * 100.0),
              checkpoints_committed=series1["saves"] - series0["saves"],
              checkpoint_bytes=series1["bytes"],
              background_write_ms=(series1["write_ms_sum"] - series0["write_ms_sum"])
              / max(series1["write_count"] - series0["write_count"], 1),
              snapshot_ms_on_step_path=[s * 1e3 for s in mgr.snapshot_s],
              fused_dense_launches_warmup_epochs=warm_launches,
              gate_pct=RES_MAX_OVERHEAD_PCT, **cfg)
    # early stopping on LeNet, against a reference-mode twin
    def es_run():
        raw = _image_batches(es["train_batches"] + es["val_batches"], es["batch"],
                             (28, 28, 1), 10, seed=5)
        tr_it = data.ListDataSetIterator([data.DataSet(x, y)
                                          for x, y in raw[:es["train_batches"]]])
        va_it = data.ListDataSetIterator([data.DataSet(x, y)
                                          for x, y in raw[es["train_batches"]:]])
        net = LeNet(n_classes=10, input_shape=(28, 28, 1)).init_model(device=dev)
        conf = es_mod.EarlyStoppingConfiguration(
            score_calculator=es_mod.DataSetLossCalculator(va_it),
            epoch_termination_conditions=[
                es_mod.MaxEpochsTerminationCondition(es["max_epochs"]),
                es_mod.ScoreImprovementEpochTerminationCondition(patience=2)],
            iteration_termination_conditions=[
                es_mod.MaxScoreIterationTerminationCondition(1e4)])
        return es_mod.EarlyStoppingTrainer(conf, net, tr_it).fit()

    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True     # a bitwise-repeatable twin
    try:
        matmul.LAUNCHES.reset()
        t0 = time.perf_counter()
        result = es_run()
        es_s = time.perf_counter() - t0
        es_launches = matmul.LAUNCHES.value
        prev = dispatch.set_dispatch_mode("reference")
        try:
            matmul.LAUNCHES.reset()
            ref = es_run()
            ref_launches = matmul.LAUNCHES.value
        finally:
            dispatch.set_dispatch_mode(prev)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    rel = [abs(result.score_vs_epoch[e] - ref.score_vs_epoch[e])
           / abs(ref.score_vs_epoch[e]) for e in ref.score_vs_epoch]
    early = dict(model="LeNet", batch=es["batch"], train_batches=es["train_batches"],
                 val_batches=es["val_batches"], total_epochs=result.total_epochs,
                 termination=result.termination_details, best_epoch=result.best_model_epoch,
                 scores=result.score_vs_epoch, reference_scores=ref.score_vs_epoch,
                 score_rel_diff=rel, seconds=es_s, fused_dense_launches=es_launches,
                 fused_dense_launches_reference_mode=ref_launches,
                 termination_reason=result.termination_reason,
                 reference_termination_reason=ref.termination_reason,
                 reference_best_epoch=ref.best_model_epoch)
    return dict(ab=ab, early_stopping=early)


def phase_resilience_ab(dev, cfg=RES_AB, report=None, timeout=600):
    """Phase 53: bench.py's ``--resilience`` A/B (``bench.py:643-700``) on
    the card, in a fresh process as bench.py runs it (``chip_smoke.py
    --resilience-ab``; `report` stands in for it in a rehearsal): the same
    loop over ``DevicePrefetchIterator``-staged batches through
    ``_fit_dataset``, with an async ``CheckpointManager`` saving every
    `save_every` steps and without.  bench.py's epoch, unchanged: the
    manager's final ``wait()`` inside it, so every write is charged to
    the checkpointing side, and one warm-up epoch a side.  bench.py takes
    the minimum of 3 epochs a side; on the card's host an epoch of this
    loop moves by 10% and more from one to the next, more than the gate,
    so the gate (overhead under 5%) is held on the median over `pairs`
    pairs of whole epochs, the order alternating a pair (ABBA), of each
    pair's overhead.  `aa_pairs` pairs with no saves on either side give
    the same statistic's noise floor (``aa``); bench.py's own reading,
    the minimum of the first `repeats` epochs a side, is printed beside
    it.  Then ``EarlyStoppingTrainer`` on LeNet (``fused_dense`` launches
    counted), held to a ``reference``-mode twin's scores."""
    if report is None:
        out = subprocess.run([sys.executable, "-u", os.path.abspath(__file__),
                              "--resilience-ab"], capture_output=True, text=True,
                             timeout=timeout)
        require(out.returncode == 0, f"resilience_ab: the process failed "
                                     f"(rc={out.returncode}):\n{out.stdout[-2000:]}"
                                     f"{out.stderr[-2000:]}")
        report = _rank_report(out.stdout, "RES_AB")
    ab, early = report["ab"], report["early_stopping"]
    emit("resilience_ab", **ab, early_stopping=early)
    require(ab["fused_dense_launches_warmup_epochs"] == 2 * 2 * cfg["n_batches"],
            f"resilience_ab: fused_dense launched {ab['fused_dense_launches_warmup_epochs']} "
            f"times over the two warm-up epochs, want {4 * cfg['n_batches']} (two relu "
            "Dense layers a step)")
    want = early["total_epochs"] * (early["train_batches"] + early["val_batches"])
    require(early["fused_dense_launches"] == want
            and early["fused_dense_launches_reference_mode"] == 0,
            f"early stopping: fused_dense launched {early['fused_dense_launches']} times "
            f"(want {want}: one a training step and one a validation batch), "
            f"{early['fused_dense_launches_reference_mode']} in reference mode")
    require(early["termination_reason"] == early["reference_termination_reason"]
            == "EpochTerminationCondition"
            and early["best_epoch"] == early["reference_best_epoch"]
            and sorted(early["scores"]) == sorted(early["reference_scores"])
            and max(early["score_rel_diff"]) <= F32_RTOL,
            f"early stopping: {early} against reference mode")
    require(ab["overhead_pct"] < RES_MAX_OVERHEAD_PCT and ab["checkpoints_committed"] > 0,
            f"resilience_ab: checkpoint overhead {ab['overhead_pct']:.3f}% (the median of "
            f"{cfg['pairs']} pairs; gate {RES_MAX_OVERHEAD_PCT}%; the A/A's "
            f"{ab['aa']['overhead_pct']:.3f}%), {ab['checkpoints_committed']} saves")
    return report


def resilience_ab_main(argv):
    """Phase 53's process (``--resilience-ab``): prints its report as one
    ``RES_AB`` line."""
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from deeplearning4j_tpu_torch import data, nn, train
    from deeplearning4j_tpu_torch.ops.kernels import dispatch, matmul
    from deeplearning4j_tpu_torch.zoo import LeNet
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dispatch.set_dispatch_mode("auto")
    dev = torch.device("cuda", 0)
    report = _resilience_ab_run(train, data, nn, matmul, LeNet, dev)
    print("RES_AB " + json.dumps(report), flush=True)
    return 0


# ---- the elastic gang's members (``chip_smoke.py --elastic-rank``) ----

class _GangShards:
    """One seeded global batch a step, keyed by (epoch, step) only; each
    member takes its LIVE gang rank's strided rows, so a reformed gang
    re-shards the same stream (``tests/mh_worker_elastic_gang.py``'s
    iterator).  `make(seed)` returns the global (x, y)."""

    def __init__(self, model, steps, make):
        self.model, self.steps, self.make = model, int(steps), make

    def reset(self):
        pass

    def __len__(self):
        return self.steps

    def __iter__(self):
        from deeplearning4j_tpu_torch.data import DataSet
        for i in range(self.steps):
            xg, yg = self.make(1000 + int(self.model.epoch) * self.steps + i)
            sharing = self.model.gradient_sharing
            r, w = sharing.rank, sharing.world
            yield DataSet(xg[r::w], yg[r::w])


class _StepLog:
    """An ElasticTrainer hook that marks each step's end, and (installed on
    the trainer) each reformation: the launches and host time of every
    window between two marks, so a step's counts exclude the grad half a
    reformation cut short.  `stats` is the sharing's at the last step's end
    (after it, members that finished leave the gang)."""

    def __init__(self, counters):
        self.counters = counters
        self.marks = []
        self.stats = None

    def mark(self, kind):
        self.marks.append((kind, time.perf_counter(), [c.value for c in self.counters]))

    def __call__(self, trainer):
        self.mark("step")
        self.stats = trainer.model.gradient_sharing.stats()

    def steps(self):
        out = []
        for (_, t0, c0), (kind, t1, c1) in zip(self.marks, self.marks[1:]):
            if kind == "step":
                out.append(dict(ms=(t1 - t0) * 1e3, launches=[b - a for a, b in zip(c0, c1)]))
        return out


def _elastic_member(kind, out_dir, steps, kill_rank, kill_step, dev, shape=None):
    """One member of an elastic gang (phases 54, 55): the MLP 16-32-3 of
    ``tests/mh_worker_elastic_gang.py`` (threshold 5e-3) or bench.py's bf16
    ResNet-50 (the default threshold; global batch 48), under
    ``ElasticTrainer`` with ``HierarchicalGradientSharing(elastic=True)``
    (heartbeat, deadline and join from the supervisor's environment); the
    coordinator writes a checkpoint every step.  `shape` (image, classes,
    global batch) narrows ResNet-50 for a rehearsal on the CPU.  Writes its
    final state and report into `out_dir`."""
    from deeplearning4j_tpu_torch import nn, parallel
    from deeplearning4j_tpu_torch.monitor.registry import registry
    from deeplearning4j_tpu_torch.ops.kernels import conv3x3, matmul
    from deeplearning4j_tpu_torch.parallel import multihost
    from deeplearning4j_tpu_torch.parallel.transport import GangEvictedError, PeerUnreachableError
    from deeplearning4j_tpu_torch.train import Nesterovs, Sgd
    from deeplearning4j_tpu_torch.train.resilience import CheckpointManager, ElasticTrainer
    from deeplearning4j_tpu_torch.utils.chaos import PeerKiller
    from deeplearning4j_tpu_torch.zoo import ResNet50
    rank = int(os.environ.get(multihost.ENV_PID, "0"))
    policy = os.environ.get("DL4J_TPU_ELASTIC_POLICY", "shrink")
    if kind == "mlp":
        conf = (nn.NeuralNetConfiguration.builder().seed(7).updater(Sgd(0.1))
                .list([nn.DenseLayer(n_out=32, activation="tanh"),
                       nn.OutputLayer(n_out=3, loss="mcxent", activation="softmax")])
                .set_input_type(nn.InputType.feed_forward(16)).build())
        net = nn.MultiLayerNetwork(conf, device=dev).init()
        sharing = parallel.HierarchicalGradientSharing(threshold=5e-3, elastic=True)

        def make(seed):
            rng = np.random.RandomState(seed)
            xg = rng.randn(12, 16).astype(np.float32)
            labels = (xg[:, 0] > 0).astype(int) + (xg[:, 1] > 0).astype(int)
            return xg, np.eye(3, dtype=np.float32)[labels]
    else:
        image, classes, gb = shape or (EL_R50["image"], EL_R50["classes"],
                                       EL_R50["global_batch"])
        net = _resnet50(ResNet50, Nesterovs, dev, compute_dtype="bfloat16", image=image,
                        classes=classes)
        sharing = parallel.HierarchicalGradientSharing(elastic=True)

        def make(seed):
            rng = np.random.RandomState(seed)
            x = rng.rand(gb, image, image, 3).astype(np.float32)
            y = np.eye(classes, dtype=np.float32)[rng.randint(0, classes, gb)]
            return x, y
    net.set_gradient_sharing(sharing)
    manager = CheckpointManager(os.environ[multihost.ENV_CKPT], keep_last=200,
                                save_every_steps=1 if rank == 0 else None,
                                async_save=kind == "resnet50")
    log = _StepLog([matmul.LAUNCHES, conv3x3.WGRAD_LAUNCHES, conv3x3.DGRAD_LAUNCHES])
    hooks = [log]
    if kill_rank >= 0:
        hooks.append(PeerKiller(kill_rank, kill_step, mode="kill", duration_s=6.0,
                                marker=os.path.join(out_dir, "killed_once")))
    trainer = ElasticTrainer(net, manager, policy=policy, rejoin_wait_s=60.0, hooks=hooks,
                             save_initial=rank == 0)
    on_reform = trainer._on_reform

    def marked(e):
        log.mark("reform")
        return on_reform(e)
    trainer._on_reform = marked
    for cnt in log.counters:
        cnt.reset()
    log.mark("start")
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    try:
        trainer.fit(_GangShards(net, steps, make), epochs=1)
    except (GangEvictedError, PeerUnreachableError) as e:
        print(f"rank {rank}: left the gang: {e}", flush=True)
        net.set_gradient_sharing(None)
        return 7
    wall = time.perf_counter() - t0
    stats = log.stats
    reg = registry()
    h = reg.get("resilience_checkpoint_save_ms")
    report = dict(
        rank=rank, stats=stats, reformations=trainer.reformations, wall_s=wall,
        steps=log.steps(), iteration=net.iteration, score=float(net.score()),
        checkpoint_snapshot_ms=[s * 1e3 for s in manager.snapshot_s],
        checkpoint_write_ms_mean=(h.sum / h.count) if h is not None and h.count else None,
        checkpoint_bytes=getattr(reg.get("resilience_checkpoint_bytes"), "value", None),
        max_memory_allocated_gb=(torch.cuda.max_memory_allocated(dev) / 1e9
                                 if dev.type == "cuda" else None),
        state_sha256=_params_sha256(net), opt_sha256=_opt_sha256(net))
    with open(os.path.join(out_dir, f"elastic_{rank}.json"), "w") as f:
        json.dump(report, f)
    net.set_gradient_sharing(None)            # close the gang's sockets
    print(f"rank {rank}: done at iteration {net.iteration} (world={stats['world']}, "
          f"generation={stats['generation']})", flush=True)
    return 0


def _opt_sha256(net):
    import hashlib
    h = hashlib.sha256()
    for t in _opt_leaves(net):
        h.update(t.detach().float().cpu().numpy().tobytes())
    return h.hexdigest()


def elastic_rank_main(argv):
    """One elastic gang member of phases 54 and 55 (``--elastic-rank
    mlp|resnet50 <out dir> <steps> <kill rank> <kill step> [<image> <classes>
    <global batch>]``), started by
    ``multihost.ElasticLocalRunner.run_elastic``: its card is
    ``DL4J_TPU_CARD`` (members share the cards: a gang forms no NCCL
    group); ``DL4J_TPU_PLATFORM=cpu`` runs it on the CPU."""
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from deeplearning4j_tpu_torch.ops.kernels import dispatch
    from deeplearning4j_tpu_torch.parallel import multihost
    if os.environ.get(multihost.ENV_PLATFORM) == "cpu":
        dev = torch.device("cpu")
    else:
        if not torch.cuda.is_available():
            print("chip_smoke: CUDA is not available", file=sys.stderr)
            return 2
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cudnn.deterministic = True
        dispatch.set_dispatch_mode("auto")
        dev = torch.device("cuda", int(os.environ.get(multihost.ENV_CARD, "0")))
        torch.cuda.set_device(dev)
    kind, out_dir, steps, kill_rank, kill_step = argv[:5]
    shape = tuple(int(v) for v in argv[5:8]) or None
    return _elastic_member(kind, out_dir, int(steps), int(kill_rank), int(kill_step), dev,
                           shape)


def _elastic_gang(multihost, kind, td, tag, procs, steps, kill_rank, kill_step, ckpt,
                  heartbeat_s, deadline_s, policy="shrink", relaunch=False, platform="cuda",
                  timeout=600.0, extra=()):
    """One run of an elastic gang of `procs` members (``--elastic-rank
    kind``): (wall seconds, {rank: report}, the runner's results)."""
    out = os.path.join(td, f"out_{tag}")
    os.makedirs(out)
    t0 = time.time()
    runner = multihost.ElasticLocalRunner(procs, platform=platform, backoff_base_s=0.2)
    res = runner.run_elastic(os.path.abspath(__file__),
                             ["--elastic-rank", kind, out, str(steps), str(kill_rank),
                              str(kill_step), *map(str, extra)],
                             timeout=timeout, checkpoint_dir=ckpt, policy=policy,
                             heartbeat_s=heartbeat_s, failure_deadline_s=deadline_s,
                             relaunch=relaunch)
    wall = time.time() - t0
    require(res["r0"][0] == 0, f"elastic {tag}: rank 0 failed:\n{res['r0'][1][-2000:]}")
    reports = {}
    for name in os.listdir(out):
        if name.startswith("elastic_") and name.endswith(".json"):
            with open(os.path.join(out, name)) as f:
                r = json.load(f)
            reports[r["rank"]] = r
    return wall, reports, res


def _copy_up_to(src, dst, step):
    """A copy of a checkpoint directory without the checkpoints above
    `step` (the clean comparator starts from the resume point)."""
    import shutil
    from deeplearning4j_tpu_torch.train.resilience import CheckpointManager
    shutil.copytree(src, dst)
    for name in os.listdir(dst):
        p = os.path.join(dst, name)
        if os.path.isdir(p) and name.startswith(CheckpointManager.PREFIX) \
                and int(name[len(CheckpointManager.PREFIX):]) > step:
            shutil.rmtree(p)


def _launches_per_step(report, index):
    return [s["launches"][index] for s in report["steps"]]


def phase_elastic_ab(multihost, dev, cfg=ELASTIC_AB, platform="cuda"):
    """Phase 54: bench.py's ``--elastic`` A/B (``bench.py:927-1040``) on the
    card.  A: a gang of 3 (``--elastic-rank mlp``) loses rank 2 at
    `kill_step` and shrinks; B: a clean world-2 gang from A's resume
    checkpoint; C: a clean gang of 3.  bench.py's gates: detection within
    the failure deadline + 2 s, A's final loss B's (1e-9 relative), the
    reformation (detection + resume) within 15 s.  Then a ``"block"`` run
    with ``relaunch=True`` ends at world 3 after the replacement joins."""
    import shutil
    import tempfile
    td = tempfile.mkdtemp(prefix="elastic_ab_")
    try:
        kw = dict(heartbeat_s=cfg["heartbeat_s"], deadline_s=cfg["failure_deadline_s"],
                  platform=platform)
        ck_a = os.path.join(td, "ck_a")
        wall_a, rep_a, res_a = _elastic_gang(multihost, "mlp", td, "a", 3, cfg["steps"], 2,
                                             cfg["kill_step"], ck_a, **kw)
        r0 = rep_a[0]
        require(len(r0["reformations"]) == 1, f"elastic_ab A: reformations "
                                              f"{r0['reformations']}, want 1")
        rf = r0["reformations"][0]
        require(rf["cause"] == "crash" and rf["world"] == 2 and res_a["r2"][0] == 9,
                f"elastic_ab A: {rf}, rank 2 rc {res_a['r2'][0]}")
        ck_b = os.path.join(td, "ck_b")
        _copy_up_to(ck_a, ck_b, rf["resume_step"])
        _, rep_b, _ = _elastic_gang(multihost, "mlp", td, "b", 2, cfg["steps"], -1, 0, ck_b,
                                    **kw)
        wall_c, rep_c, _ = _elastic_gang(multihost, "mlp", td, "c", 3, cfg["steps"], -1, 0,
                                         os.path.join(td, "ck_c"), **kw)
        require(rep_b[0]["reformations"] == [] and rep_c[0]["reformations"] == [],
                "elastic_ab: a clean run re-formed")
        loss_a, loss_b = rep_a[0]["score"], rep_b[0]["score"]
        delta = abs(loss_a - loss_b) / max(abs(loss_b), 1e-12)
        detect_ok = rf["detection_ms"] <= cfg["failure_deadline_s"] * 1e3 \
            + ELASTIC_DETECT_SLACK_MS
        reform_ms = rf["detection_ms"] + rf["resume_ms"]
        launches = {r: statistics.median(_launches_per_step(rep, 0))
                    for r, rep in rep_a.items()}
        # block policy: the replacement joins, the gang ends at world 3
        wall_d, rep_d, res_d = _elastic_gang(multihost, "mlp", td, "d", 3, cfg["steps"], 2,
                                             cfg["kill_step"], os.path.join(td, "ck_d"),
                                             policy="block", relaunch=True, **kw)
        causes = [r["cause"] for r in rep_d[0]["reformations"]]
        joined = [label for label in res_d if "+j" in label]
        require(rep_d[0]["stats"]["world"] == 3 and causes == ["crash"] and joined
                and res_d[joined[0]][0] == 0,
                f"elastic_ab block: world {rep_d[0]['stats']['world']}, causes {causes}, "
                f"replacements {joined}")
        report = dict(
            procs=3, model="MLP 16-32-3 tanh/softmax mcxent", updater="Sgd(0.1)",
            threshold=5e-3, global_batch=12, steps=cfg["steps"], kill_step=cfg["kill_step"],
            heartbeat_s=cfg["heartbeat_s"], failure_deadline_s=cfg["failure_deadline_s"],
            cause=rf["cause"], world_after=rf["world"],
            generation_after=r0["stats"]["generation"], resume_step=rf["resume_step"],
            detection_ms=rf["detection_ms"], resume_ms=rf["resume_ms"],
            reformation_ms=reform_ms, final_loss_chaos=loss_a,
            final_loss_uninterrupted=loss_b, loss_delta_rel=delta,
            params_bitwise_b=rep_a[0]["state_sha256"] == rep_b[0]["state_sha256"],
            wall_chaos_s=wall_a, wall_clean_s=wall_c, wall_overhead_s=wall_a - wall_c,
            stale_frames=r0["stats"]["stale_frames"],
            fused_dense_launches_per_step=launches,
            gates=dict(detect_ms=cfg["failure_deadline_s"] * 1e3 + ELASTIC_DETECT_SLACK_MS,
                       loss_delta_rel=ELASTIC_LOSS_RTOL, reformation_ms=ELASTIC_BUDGET_MS),
            block=dict(world_final=rep_d[0]["stats"]["world"],
                       generation_final=rep_d[0]["stats"]["generation"],
                       reformations=rep_d[0]["reformations"], replacements=joined,
                       wall_s=wall_d))
        emit("elastic_ab", **report)
        require(detect_ok and delta <= ELASTIC_LOSS_RTOL and reform_ms <= ELASTIC_BUDGET_MS,
                f"elastic_ab: detection {rf['detection_ms']:.1f} ms, loss delta {delta}, "
                f"reformation {reform_ms:.1f} ms against the gates")
        require(all(v == 1 for v in launches.values()),
                f"elastic_ab: fused_dense launches a step {launches}, want 1 on every rank")
        return report
    finally:
        shutil.rmtree(td, ignore_errors=True)


def phase_elastic_resnet50(multihost, dev, cfg=EL_R50, platform="cuda", timeout=900.0):
    """Phase 55: BASELINE config 5's GradientSharing ResNet-50 at full
    width under ``ElasticTrainer``: a gang of 3 (``--elastic-rank
    resnet50``; one card each where there are 3, else all on card 0), a
    global batch of 48, rank 2 killed at `kill_step` by ``PeerKiller``.
    The failure deadline comes from a clean world-3 run's step time (C,
    `clean_steps` steps); A must show exactly one ``crash`` reformation to
    world 2, and rank 0's parameters, BatchNorm statistics and moments
    equal those of B, a clean world-2 gang from A's resume checkpoint, bit
    for bit; B re-forms never; 16 + 16 conv launches every step of every
    rank."""
    import shutil
    import tempfile
    td = tempfile.mkdtemp(prefix="elastic_resnet50_")
    shape = (cfg["image"], cfg["classes"], cfg["global_batch"])
    try:
        hb = cfg["heartbeat_s"]
        wall_c, rep_c, _ = _elastic_gang(multihost, "resnet50", td, "c", cfg["procs"],
                                         cfg["clean_steps"], -1, 0, os.path.join(td, "ck_c"),
                                         heartbeat_s=hb, deadline_s=60.0, platform=platform,
                                         timeout=timeout, extra=shape)
        require(all(r["reformations"] == [] for r in rep_c.values()),
                "elastic_resnet50: the clean run re-formed")
        clean_ms = max(statistics.median([s["ms"] for s in r["steps"][1:]] or
                                         [s["ms"] for s in r["steps"]])
                       for r in rep_c.values())
        deadline = max(cfg["deadline_floor_s"],
                       math.ceil(cfg["deadline_steps"] * clean_ms / 1e3))
        ck_a = os.path.join(td, "ck_a")
        wall_a, rep_a, res_a = _elastic_gang(multihost, "resnet50", td, "a", cfg["procs"],
                                             cfg["steps"], 2, cfg["kill_step"], ck_a,
                                             heartbeat_s=hb, deadline_s=deadline,
                                             platform=platform, timeout=timeout, extra=shape)
        r0 = rep_a[0]
        require(len(r0["reformations"]) == 1, f"elastic_resnet50 A: reformations "
                                              f"{r0['reformations']}, want 1")
        rf = r0["reformations"][0]
        require(rf["cause"] == "crash" and rf["world"] == 2 and res_a["r2"][0] == 9,
                f"elastic_resnet50 A: {rf}, rank 2 rc {res_a['r2'][0]}")
        ck_b = os.path.join(td, "ck_b")
        _copy_up_to(ck_a, ck_b, rf["resume_step"])
        shutil.rmtree(ck_a, ignore_errors=True)
        wall_b, rep_b, _ = _elastic_gang(multihost, "resnet50", td, "b", 2, cfg["steps"], -1,
                                         0, ck_b, heartbeat_s=hb, deadline_s=deadline,
                                         platform=platform, timeout=timeout, extra=shape)
        require(all(r["reformations"] == [] for r in rep_b.values()),
                f"elastic_resnet50 B: re-formed {rep_b[0]['reformations']}")
        bitwise = (r0["state_sha256"] == rep_b[0]["state_sha256"]
                   and r0["opt_sha256"] == rep_b[0]["opt_sha256"])
        # each rank's distinct (wgrad, dgrad) launch counts over its steps
        conv = {tag: {r: sorted(set(zip(_launches_per_step(rep, 1), _launches_per_step(rep, 2))))
                      for r, rep in reps.items()}
                for tag, reps in (("a", rep_a), ("b", rep_b), ("c", rep_c))}
        conv_ok = all(v == [(BODY_CONVS, BODY_CONVS)] for per in conv.values()
                      for v in per.values())
        steps0 = r0["steps"]
        reform_at = rf["resume_step"]
        before = [s["ms"] for s in steps0[1:cfg["kill_step"]]]
        after = [s["ms"] for s in steps0[cfg["kill_step"] + 1:]]
        report = dict(
            model="ResNet50", compute_dtype="bfloat16",
            input=f"{cfg['image']}x{cfg['image']}x3", classes=cfg["classes"],
            updater="Nesterovs(0.1, 0.9)", sharing="threshold 1e-3 (default), elastic",
            procs=cfg["procs"], global_batch=cfg["global_batch"], steps=cfg["steps"],
            kill_step=cfg["kill_step"], cards=torch.cuda.device_count() if platform == "cuda"
            else 0, heartbeat_s=hb, clean_step_ms=clean_ms, failure_deadline_s=deadline,
            deadline_rule=f"max({cfg['deadline_floor_s']} s, ceil({cfg['deadline_steps']} x "
                          "the clean run's slowest median step))",
            cause=rf["cause"], world_after=rf["world"],
            generation_after=r0["stats"]["generation"], resume_step=reform_at,
            detection_ms=rf["detection_ms"], resume_ms=rf["resume_ms"],
            rank0_bitwise_b=bitwise, b_reformations=0, conv_launches_per_step=conv,
            step_ms_before_reform=before, step_ms_after_reform=after,
            step_ms_b=[s["ms"] for s in rep_b[0]["steps"]],
            checkpoint_snapshot_ms_per_step=r0["checkpoint_snapshot_ms"],
            checkpoint_write_ms_mean=r0["checkpoint_write_ms_mean"],
            checkpoint_bytes=r0["checkpoint_bytes"],
            wire_bytes_per_step={r: rep["stats"]["last_wire_bytes"]
                                 for r, rep in rep_a.items()},
            stale_frames=r0["stats"]["stale_frames"],
            max_memory_allocated_gb={r: rep["max_memory_allocated_gb"]
                                     for r, rep in rep_a.items()},
            wall_s=dict(a=wall_a, b=wall_b, c=wall_c))
        emit("elastic_resnet50", **report)
        require(bitwise, "elastic_resnet50: rank 0's state after the reform is not B's bit "
                         "for bit")
        require(conv_ok, f"elastic_resnet50: conv launches a step {conv}, want "
                         f"{BODY_CONVS} + {BODY_CONVS}")
        return report
    finally:
        shutil.rmtree(td, ignore_errors=True)


# ---------------------------------------------------------------------------
# gang members of several cards, SameDiff under ZeRO-1 (phases 56 to 59)
# ---------------------------------------------------------------------------

def _hosts_layout(cards, tag):
    """(hosts, ranks a host) of phases 56 and 57 at `cards` cards; prints
    the layout line."""
    if cards >= 4:
        hosts, d = 2, 2
    elif cards >= 2 or tag == "gs_hosts_comms":   # phase 56 shares one card at 1
        hosts, d = 2, 1
    else:
        hosts, d = 1, 1
    emit(f"{tag}_layout", hosts=hosts, devices_per_process=d, cards=cards,
         shared_card=hosts * d > cards)
    return hosts, d


def _gs_hosts_comms_rank(nn, parallel, matmul, Sgd, dev, hosts, ports, cfg=GS_COMMS):
    """One rank of phase 56: `tests/mh_worker_comms.py`'s loop as a host's
    rank, its host's strided rows of the stream through
    ``ParallelWrapper`` (which takes this rank's part of them), dense over
    the mesh on ``ports[0]`` then threshold over one on ``ports[1]``."""
    from deeplearning4j_tpu_torch.parallel import multihost
    host = multihost.host_of_env()[0]
    HGS = parallel.HierarchicalGradientSharing
    out = {}
    for mode, port in zip(("dense", "compressed"), ports):
        net = _comms_mlp(nn, Sgd, dev, cfg)
        pw = parallel.ParallelWrapper(net, gradient_sharing=HGS(
            compressed=mode == "compressed", threshold=cfg["threshold"], port=port))
        pw._place_model()
        rng = np.random.RandomState(0)
        losses, step_ms = [], []
        matmul.LAUNCHES.reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(cfg["steps"]):
            t1 = time.perf_counter()
            xg = rng.randn(hosts * cfg["rows"], cfg["n_in"]).astype(np.float32)
            labels = (xg[:, 0] > 0).astype(int) + (xg[:, 1] > 0).astype(int)
            yg = np.eye(3, dtype=np.float32)[labels]
            pw.fit(xg[host::hosts], yg[host::hosts])
            losses.append(net.score())           # reads the loss: synchronizes
            step_ms.append((time.perf_counter() - t1) * 1e3)
        dt = time.perf_counter() - t0
        launches = matmul.LAUNCHES.value
        rt = net.gradient_sharing
        stats, opened = rt.stats(), rt.mesh is not None
        pw.gradient_sharing(None)
        import hashlib
        w0 = net.params_["layer_0"]["W"].detach().cpu().numpy()
        out[mode] = dict(losses=losses, wall_s=dt, steps_per_sec=cfg["steps"] / dt,
                         first_step_ms=step_ms[0], median_step_ms=statistics.median(step_ms),
                         stats=stats, opened_gang_socket=opened,
                         fused_dense_launches=launches,
                         fused_dense_shape=[cfg["rows"] // pw.degree, cfg["n_in"],
                                            cfg["hidden"]],
                         w0_sha256=hashlib.sha256(w0.tobytes()).hexdigest())
    return out


def phase_gs_hosts_comms(multihost, dev, cfg=GS_COMMS, ranks=None, layout=None):
    """Phase 56 (the module docstring)."""
    tag = "gs_hosts_comms"
    cards = torch.cuda.device_count()
    hosts, d = layout or _hosts_layout(cards, tag)
    if ranks is None:
        outs = multihost.LocalLauncher(hosts, d, "cuda", gang=True).run(
            os.path.abspath(__file__), ["--hosts-rank", "comms", str(hosts),
                                        str(multihost.free_port())],
            timeout=300, gradient_port=multihost.free_port())
        ranks = [_rank_report(o, "HOSTS_RANK") for o in outs]
    leaders = ranks[::d]
    res = {}
    for mode in ("dense", "compressed"):
        require(len({r[mode]["w0_sha256"] for r in ranks}) == 1,
                f"{tag}: the ranks' first-layer W differ ({mode})")
        for i, r in enumerate(ranks):
            lead = i % d == 0
            require(r[mode]["opened_gang_socket"] == lead
                    and (r[mode]["stats"]["bytes_sent_total"] > 0) == (lead and hosts > 1),
                    f"{tag}: rank {i} ({'a leader' if lead else 'not a leader'}) opened a "
                    f"gang socket: {r[mode]['opened_gang_socket']}, stats {r[mode]['stats']}")
            require(r[mode]["fused_dense_launches"] > 0,
                    f"{tag}: fused_dense never launched on rank {i} ({mode})")
            require(r[mode]["losses"] == leaders[i // d][mode]["losses"],
                    f"{tag}: rank {i} reports another loss than its host's leader")
        curves = np.mean([r[mode]["losses"] for r in leaders], axis=0)
        res[mode] = dict(
            wire_bytes=sum(r[mode]["stats"]["bytes_sent_total"]
                           + r[mode]["stats"]["bytes_received_total"] for r in leaders),
            final_loss=float(curves[-1]),
            compression_ratio_last=max(r[mode]["stats"]["last_compression_ratio"]
                                       for r in leaders),
            wall_s=max(r[mode]["wall_s"] for r in ranks),
            steps_per_sec=min(r[mode]["steps_per_sec"] for r in ranks),
            first_step_ms=max(r[mode]["first_step_ms"] for r in ranks),
            median_step_ms=max(r[mode]["median_step_ms"] for r in ranks),
            fused_dense_launches_per_step=[r[mode]["fused_dense_launches"] / cfg["steps"]
                                           for r in ranks],
            fused_dense_shape=ranks[0][mode]["fused_dense_shape"],
            loss_curve_every_10=[round(float(v), 5) for v in curves[::10]])
    reduction = res["dense"]["wire_bytes"] / max(res["compressed"]["wire_bytes"], 1)
    parity = (abs(res["compressed"]["final_loss"] - res["dense"]["final_loss"])
              / max(abs(res["dense"]["final_loss"]), 1e-9))
    report = dict(hosts=hosts, devices_per_process=d, cards=cards,
                  shared_card=hosts * d > cards, model="MLP 16-32-3 tanh/softmax mcxent",
                  updater="Sgd(0.1)", threshold=cfg["threshold"], steps=cfg["steps"],
                  rows_per_host=cfg["rows"], bytes_reduction_x=reduction,
                  loss_parity_rel=parity, gates={"bytes_reduction_x": GS_MIN_BYTES_X,
                                                 "loss_parity_rel": GS_MAX_LOSS_REL},
                  w0_bitwise_equal_over_ranks=True, gang_sockets_on_leaders_only=True,
                  **res)
    emit(tag, **report)
    require(reduction >= GS_MIN_BYTES_X and parity <= GS_MAX_LOSS_REL,
            f"{tag}: bytes reduction {reduction:.2f}x (want >= {GS_MIN_BYTES_X}), loss "
            f"parity {parity:.5f} (want <= {GS_MAX_LOSS_REL})")
    return report


@contextlib.contextmanager
def _host_clock():
    """While open, the pieces of each split step on a host are timed, each
    between two synchronizes: the grad half (``_grads``), the leader's
    gather (``HostLink.gather``), D2H (``hierarchical._host_f32``), the
    gang exchange (``_exchange_tree``: D2H, codec, TCP), the send back
    (``HostLink.send_back``: H2D of the leader's buffers and the broadcast
    or scatter) and its collective alone (``HostLink._deliver``).  Yields
    {piece: [ms, ...]}."""
    from deeplearning4j_tpu_torch.nn import ComputationGraph, MultiLayerNetwork
    from deeplearning4j_tpu_torch.parallel import hierarchical
    times = {}

    def timed(name, fn):
        def run(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            times.setdefault(name, []).append((time.perf_counter() - t0) * 1e3)
            return out
        return run
    spots = [(ComputationGraph, "_grads", "grad_half"),
             (MultiLayerNetwork, "_grads", "grad_half"),
             (hierarchical.HostLink, "gather", "gather"),
             (hierarchical, "_host_f32", "d2h"),
             (hierarchical.HierarchicalAllReduce, "_exchange_tree", "exchange"),
             (hierarchical.HostLink, "send_back", "send_back"),
             (hierarchical.HostLink, "_deliver", "broadcast")]
    saved = [getattr(owner, attr) for owner, attr, _ in spots]
    for (owner, attr, name), fn in zip(spots, saved):
        setattr(owner, attr, timed(name, fn))
    try:
        yield times
    finally:
        for (owner, attr, _), fn in zip(spots, saved):
            setattr(owner, attr, fn)


def _host_parts_ms(times, steps):
    """Per step: each piece's ms; h2d is the send back less its
    collective, and the exchange is counted without its D2H."""
    per = {k: sum(v) / steps for k, v in times.items()}
    for k in ("gather", "d2h", "exchange", "send_back", "broadcast", "grad_half"):
        per.setdefault(k, 0.0)
    per["h2d"] = per["send_back"] - per["broadcast"]
    per["exchange_less_d2h"] = per["exchange"] - per["d2h"]
    return per


GS_HOSTS_MODES = (("dense", False, False), ("compressed", True, False),
                  ("dense_zero1", False, True))


def _gs_hosts_r50_rank(parallel, conv3x3, matmul, ResNet50, Nesterovs, dev, hosts, k, ports,
                       save_dir=None, batch=64, image=224, classes=1000):
    """One rank of phase 57 (or the whole phase at 1 card): its host's rows
    of the global batch through ``ParallelWrapper(net,
    optimizer_sharding=, gradient_sharing=)``, a fresh network (the same
    seed on every rank) a mode: a block of k steps through ``fit_steps``
    (the main path: launch counts set to 0 just before and read just
    after; it steps one by one), then a block with the step's parts
    timed.  Rank 0 of each host saves its dense parameters after the first
    block in `save_dir`."""
    from deeplearning4j_tpu_torch.parallel import multihost
    host, local, _ = multihost.host_of_env()
    HGS = parallel.HierarchicalGradientSharing
    x, y = _r50_batch(dev, batch, image, classes)
    rows = slice(host * batch // hosts, (host + 1) * batch // hosts)
    xs = torch.broadcast_to(x[rows], (k,) + tuple(x[rows].shape))
    ys = torch.broadcast_to(y[rows], (k,) + tuple(y[rows].shape))
    out = {}
    for (mode, compressed, z1), port in zip(GS_HOSTS_MODES, ports):
        net = _resnet50(ResNet50, Nesterovs, dev, compute_dtype="bfloat16", image=image,
                        classes=classes)
        pw = parallel.ParallelWrapper(net, optimizer_sharding=z1, gradient_sharing=HGS(
            compressed=compressed, port=port))
        try:
            pw._place_model()
            _reset_counts(matmul, conv3x3)
            losses, first_ms = _synced(lambda: pw.fit_steps(xs, ys))
            counts = _step_counts(matmul, conv3x3)
            rt = net.gradient_sharing
            stats, opened = rt.stats(), rt.mesh is not None
            if save_dir is not None and mode == "dense" and local == 0:
                # the parameters after the k steps the twin takes
                torch.save({n: p.detach().float().cpu() for n, p in net.named_parameters()},
                           os.path.join(save_dir, f"hosts_{host}.pt"))
            with _host_clock() as times:
                _, clocked_ms = _synced(lambda: pw.fit_steps(xs, ys))
            out[mode] = dict(
                losses=[float(v) for v in losses.tolist()], first_block_ms=first_ms,
                step_ms=clocked_ms / k, parts_ms=_host_parts_ms(times, k),
                launches_per_step=dict(zip(("fused_dense", "conv3x3_wgrad", "conv3x3_dgrad"),
                                           (c / k for c in counts))),
                wire_bytes_per_step=stats["last_wire_bytes"],
                compression_ratio=stats["last_compression_ratio"], stats=stats,
                opened_gang_socket=opened, params_sha256=_weights_sha256(net),
                state_sha256=_params_sha256(net), rows_per_rank=batch // hosts // pw.degree,
                max_memory_allocated_gb=torch.cuda.max_memory_allocated() / 1e9)
        finally:
            pw.gradient_sharing(None)            # closes the mesh's sockets
        del net, pw
        torch.cuda.empty_cache()
    return out


def _r50_twin_rank(parallel, ResNet50, Nesterovs, dev, k, save_dir, batch=64, image=224,
                   classes=1000):
    """The 1-host twin of phase 57: a plain ``ParallelWrapper`` over every
    rank of the group on the whole global batch, k eager steps; rank 0
    saves its initial and its final parameters in `save_dir`."""
    from deeplearning4j_tpu_torch.parallel import multihost
    x, y = _r50_batch(dev, batch, image, classes)
    net = _resnet50(ResNet50, Nesterovs, dev, compute_dtype="bfloat16", image=image,
                    classes=classes)
    pw = parallel.ParallelWrapper(net)
    pw._place_model()
    if multihost.process_index() == 0:
        torch.save({n: p.detach().float().cpu() for n, p in net.named_parameters()},
                   os.path.join(save_dir, "init.pt"))
    losses = []
    for _ in range(k):                  # eager steps, as the sharing steps are
        pw.fit(x, y)
        losses.append(net.score())
    if multihost.process_index() == 0:
        torch.save({n: p.detach().float().cpu() for n, p in net.named_parameters()},
                   os.path.join(save_dir, "twin.pt"))
    return dict(losses=losses, params_sha256=_weights_sha256(net))


def _max_param_diff(a, b):
    return max((a[n] - b[n]).abs().max().item() for n in a)


def _update_agreement(a, b, init):
    """(cosine, norm ratio a / b) of two runs' whole updates from `init`."""
    ua = torch.cat([(a[n] - init[n]).reshape(-1).double() for n in init])
    ub = torch.cat([(b[n] - init[n]).reshape(-1).double() for n in init])
    return (float(torch.dot(ua, ub) / (ua.norm() * ub.norm()).clamp_min(1e-300)),
            float(ua.norm() / ub.norm().clamp_min(1e-300)))


def phase_gs_hosts_resnet50(parallel, multihost, conv3x3, matmul, ResNet50, Nesterovs, dev,
                            k=GS_R50_K, batch=64, image=224, classes=1000):
    """Phase 57 (the module docstring)."""
    tag = "gs_hosts_resnet50"
    cards = torch.cuda.device_count()
    hosts, d = _hosts_layout(cards, tag)
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True   # bitwise twins (phase 34's note)
    tmp = tempfile.mkdtemp(prefix="gs_hosts_")
    try:
        if hosts * d == 1:
            k = GS_HOSTS_K1
            ranks = [_gs_hosts_r50_rank(parallel, conv3x3, matmul, ResNet50, Nesterovs, dev,
                                        1, k, [None] * 3, tmp, batch, image, classes)]
            twin = _r50_twin_rank(parallel, ResNet50, Nesterovs, dev, k, tmp, batch, image,
                                  classes)
        else:
            outs = multihost.LocalLauncher(hosts, d, "cuda", gang=True).run(
                os.path.abspath(__file__),
                ["--hosts-rank", "resnet50", str(hosts), str(k), tmp]
                + [str(multihost.free_port()) for _ in GS_HOSTS_MODES], timeout=600)
            ranks = [_rank_report(o, "HOSTS_RANK") for o in outs]
            outs = multihost.LocalLauncher(hosts * d, 1, "cuda").run(
                os.path.abspath(__file__), ["--hosts-rank", "r50twin", str(k), tmp],
                timeout=400)
            twin = _rank_report(outs[0], "HOSTS_RANK")
        for mode, _, _ in GS_HOSTS_MODES:
            hashes = {r[mode]["params_sha256"] for r in ranks}
            require(len(hashes) == 1, f"{tag}: {mode} parameters differ over the ranks")
            for i, r in enumerate(ranks):
                c = r[mode]["launches_per_step"]
                require(c["conv3x3_wgrad"] == BODY_CONVS and c["conv3x3_dgrad"] == BODY_CONVS,
                        f"{tag}: rank {i} {mode} launches a step {c}, want {BODY_CONVS} + "
                        f"{BODY_CONVS} conv")
                require(all(math.isfinite(v) for v in r[mode]["losses"]),
                        f"{tag}: rank {i} {mode} losses {r[mode]['losses']}")
                require(r[mode]["opened_gang_socket"] == (i % d == 0 and hosts > 1),
                        f"{tag}: rank {i} {mode} gang socket {r[mode]['opened_gang_socket']}")
        require(ranks[0]["dense_zero1"]["params_sha256"] == ranks[0]["dense"]["params_sha256"]
                and ranks[0]["dense_zero1"]["losses"] == ranks[0]["dense"]["losses"],
                f"{tag}: dense under ZeRO-1 is not bitwise dense")
        host_params = torch.load(os.path.join(tmp, "hosts_0.pt"))
        twin_params = torch.load(os.path.join(tmp, "twin.pt"))
        init = torch.load(os.path.join(tmp, "init.pt"))
        diff = _max_param_diff(host_params, twin_params)
        worst = max(host_params, key=lambda n: (host_params[n] - twin_params[n]).abs().max())
        scale = max(p.abs().max().item() for p in twin_params.values())
        cosine, norm_ratio = _update_agreement(host_params, twin_params, init)
        dense_losses = np.mean([r["dense"]["losses"] for r in ranks[::d]], axis=0).tolist()
        rel = _rel(dense_losses, twin["losses"])
        if hosts * d == 1:
            require(diff == 0.0 and rel == [0.0] * k,
                    f"{tag}: world-1 dense sharing is not bitwise its plain twin ({diff})")
        else:
            require(rel[0] <= BF16_LOSS_RTOL and rel[1] <= DP_BF16_STEP2_RTOL,
                    f"{tag}: dense hosts against the 1-host twin: losses rel {rel} (bounds "
                    f"{BF16_LOSS_RTOL} then {DP_BF16_STEP2_RTOL})")
        emit(tag, model="ResNet50", compute_dtype="bfloat16", input=f"{image}x{image}x3",
             classes=classes, updater="Nesterovs(0.1, 0.9)", global_batch=batch, k=k,
             hosts=hosts, devices_per_process=d, cards=cards, shared_card=hosts * d > cards,
             cudnn_deterministic=True, ranks_params_bitwise_equal=True,
             zero1_bitwise_dense=True, twin_losses=twin["losses"], dense_host_losses=dense_losses,
             twin_loss_rel=rel, twin_param_max_abs_diff=diff, twin_worst_leaf=worst,
             param_max_abs=scale, twin_update_cosine=cosine, twin_update_norm_ratio=norm_ratio,
             twin_bounds={"loss_rel_step1": BF16_LOSS_RTOL,
                          "loss_rel_step2": DP_BF16_STEP2_RTOL},
             rank0=ranks[0], other_ranks_step_ms=[{m: r[m]["step_ms"] for m, _, _ in
                                                   GS_HOSTS_MODES} for r in ranks[1:]])
        return ranks
    finally:
        torch.backends.cudnn.deterministic = prev
        shutil.rmtree(tmp, ignore_errors=True)


def _tp_infer_rank(parallel, quant, matmul, VGG16, dev, axes, rows=16, image=224,
                   classes=1000):
    """One rank of phase 58: VGG16 f32 through ``ParallelInference`` over a
    mesh of `axes` (its one-card ``output`` first), then its weight-only
    int8 version with the leaves placed by ``shard_model_params`` on that
    mesh, run inside ``with mesh:``; launches and (M, K, N) of the first
    forward of each, ms of a second."""
    from deeplearning4j_tpu_torch import convert
    rng = np.random.default_rng(0)
    x = rng.standard_normal((rows, image, image, 3), dtype=np.float32)
    xt = torch.as_tensor(x, device=dev)
    net = VGG16(input_shape=(image, image, 3), n_classes=classes).init_model(device=dev)
    mesh = parallel.make_mesh(axes, device=dev)
    pi = parallel.ParallelInference(net, mesh)      # rank 0's parameters everywhere
    with torch.inference_mode():
        plain = net.output(xt).float().cpu().numpy()
    shapes, put_back = _record_dense_shapes(matmul)
    try:
        matmul.LAUNCHES.reset()
        got = pi.output(x)
        f32_launches = matmul.LAUNCHES.value
    finally:
        put_back()
    f32_shapes = list(shapes)
    _, ms = _synced(lambda: pi.output(x))
    err = float(np.abs(got - plain).max())
    top = float(np.abs(plain).max())
    qm = quant.quantize_model(net)
    with torch.inference_mode():
        want = qm.output(xt).float().cpu().numpy()
    layouts = {name: convert._layer_or_layout(net, name).TORCH_LAYOUT or {}
               for name in net.params_}
    whole_params = qm.params_
    qm.params_ = parallel.shard_model_params(whole_params, mesh, parallel.ShardingRules(),
                                             layouts)
    fc = [n for n in qm.params_ if isinstance(qm.params_[n].get("W"), quant.QTensor)
          and qm.params_[n]["W"].q.dim() == 2]
    q_shapes, orig = [], matmul.q_matmul

    def rec(x, wq, w_scale, bias=None, acc_dtype=None):
        q_shapes.append((int(x.numel() // x.shape[-1]), int(wq.shape[0]), int(wq.shape[1])))
        return orig(x, wq, w_scale, bias=bias, acc_dtype=acc_dtype)
    matmul.q_matmul = rec
    try:
        for c in (matmul.Q_LAUNCHES, matmul.LAUNCHES):
            c.reset()
        with mesh:
            q_got = qm.output(xt).float().cpu().numpy()
        q_launches, q_fd = matmul.Q_LAUNCHES.value, matmul.LAUNCHES.value
    finally:
        matmul.q_matmul = orig
    with mesh:
        _, q_ms = _synced(lambda: qm.output(xt))
    blocks = {n: [list(qm.params_[n]["W"].q.shape), str(qm.params_[n]["W"].q.dtype),
                  list(qm.params_[n]["W"].scale.shape)] for n in fc}
    q_err = float(np.abs(q_got - want).max())
    q_top = float(np.abs(want).max())
    import hashlib
    return dict(axes=axes, rows=rows, max_abs_err=err, max_abs_ref=top, forward_ms=ms,
                fused_dense_launches=f32_launches, fused_dense_shapes=f32_shapes,
                quantized_max_abs_err=q_err, quantized_max_abs_ref=q_top,
                quantized_forward_ms=q_ms, q_matmul_launches=q_launches,
                q_matmul_shapes=q_shapes, quantized_fused_dense_launches=q_fd,
                fc_blocks=blocks, output_sha256=hashlib.sha256(got.tobytes()).hexdigest())


def phase_tp_infer(parallel, quant, multihost, matmul, VGG16, dev, ranks=None):
    """Phase 58 (the module docstring)."""
    tag = "tp_infer"
    world = torch.cuda.device_count()
    axes = {"data": world // 2, "model": 2} if world >= 2 and world % 2 == 0 \
        else {"data": 1}
    emit(f"{tag}_layout", hosts=1, devices_per_process=world, cards=world,
         shared_card=False, mesh=axes)
    if ranks is None:
        if world == 1:
            ranks = [_tp_infer_rank(parallel, quant, matmul, VGG16, dev, axes)]
        else:
            outs = multihost.LocalLauncher(world, 1, "cuda").run(
                os.path.abspath(__file__), ["--hosts-rank", "tp_infer", json.dumps(axes)],
                timeout=300)
            ranks = [_rank_report(o, "HOSTS_RANK") for o in outs]
    m = axes.get("model", 1)
    for i, r in enumerate(ranks):
        require(r["max_abs_err"] <= F32_RTOL * r["max_abs_ref"],
                f"{tag}: rank {i} ParallelInference differs from the one-card output by "
                f"{r['max_abs_err']} > {F32_RTOL * r['max_abs_ref']}")
        require(r["quantized_max_abs_err"] <= F32_RTOL * r["quantized_max_abs_ref"],
                f"{tag}: rank {i} sharded int8 differs from the unsharded by "
                f"{r['quantized_max_abs_err']} > {F32_RTOL * r['quantized_max_abs_ref']}")
        require(r["fused_dense_launches"] == 2 and r["q_matmul_launches"] == 3
                and r["quantized_fused_dense_launches"] == 0,
                f"{tag}: rank {i} launches a forward: fused_dense {r['fused_dense_launches']}"
                f" (want 2), q_matmul {r['q_matmul_launches']} (want 3), fused_dense in "
                f"the int8 forward {r['quantized_fused_dense_launches']} (want 0)")
        require(all(s[2] in (4096 // m, 1000 // m) for s in r["q_matmul_shapes"]),
                f"{tag}: rank {i} q_matmul shapes {r['q_matmul_shapes']}: not the "
                f"column-parallel blocks over model {m}")
        require(all(b[1] == "torch.int8" and b[0][1] == b[2][1] for b in r["fc_blocks"].values()),
                f"{tag}: rank {i} int8 q and scale not split alike: {r['fc_blocks']}")
    require(len({r["output_sha256"] for r in ranks}) == 1,
            f"{tag}: the ranks return different outputs")
    emit(tag, model="VGG16", input="224x224x3 f32", classes=1000, world=world, mesh=axes,
         rows=ranks[0]["rows"], bound=f"{F32_RTOL} x max|ref|", rank0=ranks[0],
         other_ranks=[{k: r[k] for k in ("max_abs_err", "quantized_max_abs_err",
                                         "forward_ms", "quantized_forward_ms")}
                      for r in ranks[1:]])
    return ranks[0]


def _sd_zero1_side(autodiff, Adam, parallel, attention, layer_norm, dev, sharded, shape):
    """Phase 59's graph trained `steps` steps replicated or under ZeRO-1
    over every rank (the one-rank mesh of `dev` without a group), the
    whole batch on every rank: losses, host ms, launch counts a step,
    updater bytes a rank and the variables."""
    B, T, F, NH, layers, steps = shape
    rs = np.random.RandomState(0)
    x = torch.as_tensor(rs.randn(B, T, F).astype(np.float32), device=dev)
    y = torch.as_tensor(rs.randn(B, T, F).astype(np.float32), device=dev)
    sd = sd_kernels_graph(autodiff, Adam, dev, shape)
    sd._ready()
    if sharded:
        parallel.enable_zero1(sd, parallel.make_mesh(device=dev))
    nbytes = parallel.opt_state_bytes_per_replica(sd.opt_state_)
    losses, ms, counts = _train_steps(sd, lambda: (sd.fit(x, y), sd._score)[1],
                                      _train_counters(attention, layer_norm), steps)
    return dict(losses=losses, ms=ms, counts=counts, opt_bytes=nbytes,
                vars={n: v.detach().clone() for n, v in sd.variables_.items()})


def _sd_zero1_rank(autodiff, Adam, parallel, attention, layer_norm, dev, shape=SD_KERNELS):
    repl = _sd_zero1_side(autodiff, Adam, parallel, attention, layer_norm, dev, False, shape)
    z1 = _sd_zero1_side(autodiff, Adam, parallel, attention, layer_norm, dev, True, shape)
    rel = max(max(_rel(z1["losses"], repl["losses"])),
              max(((z1["vars"][n] - v).abs().max()
                   / v.abs().max().clamp_min(1e-30)).item() for n, v in repl["vars"].items()))
    bitwise = (z1["losses"] == repl["losses"]
               and all(torch.equal(z1["vars"][n], v) for n, v in repl["vars"].items()))
    import hashlib
    h = hashlib.sha256()
    for n in sorted(z1["vars"]):
        h.update(z1["vars"][n].cpu().numpy().tobytes())
    return dict(losses=z1["losses"], replicated_losses=repl["losses"], max_rel_diff=rel,
                bitwise_replicated=bitwise, step_ms=statistics.median(z1["ms"][1:]),
                replicated_step_ms=statistics.median(repl["ms"][1:]),
                opt_bytes_zero1=z1["opt_bytes"], opt_bytes_replicated=repl["opt_bytes"],
                launches_per_step=z1["counts"], vars_sha256=h.hexdigest())


def phase_dp_sd_zero1(autodiff, Adam, parallel, multihost, attention, layer_norm, dev,
                      shape=SD_KERNELS):
    """Phase 59 (the module docstring)."""
    tag = "dp_sd_zero1"
    world = torch.cuda.device_count()
    B, T, F, NH, layers, steps = shape
    if world == 1:
        ranks = [_sd_zero1_rank(autodiff, Adam, parallel, attention, layer_norm, dev, shape)]
    else:
        outs = multihost.LocalLauncher(world, 1, "cuda").run(
            os.path.abspath(__file__), ["--hosts-rank", "sd_zero1"], timeout=300)
        ranks = [_rank_report(o, "HOSTS_RANK") for o in outs]
    want = [layers, layers, layers, 2 * layers, 2 * layers]
    for i, r in enumerate(ranks):
        require(all(list(c) == want for c in r["launches_per_step"]),
                f"{tag}: rank {i} launches a step {r['launches_per_step']}, want {want}")
        require(r["max_rel_diff"] <= SD_ZERO1_RTOL,
                f"{tag}: rank {i} ZeRO-1 against replicated: rel {r['max_rel_diff']}")
        require(r["opt_bytes_zero1"] <= r["opt_bytes_replicated"],
                f"{tag}: rank {i} keeps more updater bytes under ZeRO-1")
    require(len({r["vars_sha256"] for r in ranks}) == 1,
            f"{tag}: the variables differ over the ranks")
    if world == 1:
        require(ranks[0]["bitwise_replicated"],
                f"{tag}: at world 1 ZeRO-1 is not the plain fit bit for bit")
    emit(tag, world=world, batch=B, T=T, features=F, heads=NH, layers=layers, steps=steps,
         updater="Adam(1e-4)", rtol=SD_ZERO1_RTOL,
         launches_per_step=dict(zip(("flash_attn_fwd", "flash_attn_bwd_dq",
                                     "flash_attn_bwd_dkv", "layer_norm_fwd",
                                     "layer_norm_bwd"), want)),
         rank0=ranks[0], other_ranks=[{k: r[k] for k in ("max_rel_diff", "step_ms",
                                                         "opt_bytes_zero1")}
                                      for r in ranks[1:]])
    return ranks[0]


def _sd_zero1_entry(name, sd_z1):
    """A kernel's launches a step on rank 0 of phase 59."""
    i = ("flash_attn_fwd", "flash_attn_bwd_dq", "flash_attn_bwd_dkv", "layer_norm_fwd",
         "layer_norm_bwd").index(name)
    return {"launches_per_step": [c[i] for c in sd_z1["launches_per_step"]],
            "shape": "phase 43's SameDiff graph under ZeRO-1, rank 0, a step"}


def hosts_rank_main(argv):
    """One rank of phases 56 to 59 (``--hosts-rank comms <hosts> <port>``,
    ``--hosts-rank resnet50 <hosts> <k> <dir> <port> <port> <port>``,
    ``--hosts-rank r50twin <k> <dir>``, ``--hosts-rank tp_infer <axes
    json>`` or ``--hosts-rank sd_zero1``), started by
    ``multihost.LocalLauncher``: a host of more
    than one rank, or a job of more than one rank, joins its group over
    NCCL.  Prints its report as one ``HOSTS_RANK`` line."""
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from deeplearning4j_tpu_torch import autodiff, nn, parallel
    from deeplearning4j_tpu_torch.ops.kernels import (attention, conv3x3, dispatch,
                                                      layer_norm, matmul)
    from deeplearning4j_tpu_torch.parallel import multihost
    from deeplearning4j_tpu_torch.train import Adam, Nesterovs, Sgd
    from deeplearning4j_tpu_torch.zoo import ResNet50
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    dispatch.set_dispatch_mode("auto")
    size, _ = multihost.group_of_env()
    if size > 1:
        dev = multihost.initialize(timeout_s=300)   # a stuck collective fails the rank
    else:
        dev = torch.device("cuda", int(os.environ[multihost.ENV_CARD]))
        torch.cuda.set_device(dev)
    port = os.environ.get(multihost.ENV_GRAD_PORT)
    if argv[0] == "comms":
        out = _gs_hosts_comms_rank(nn, parallel, matmul, Sgd, dev, int(argv[1]),
                                   [int(port), int(argv[2])])
    elif argv[0] == "resnet50":
        out = _gs_hosts_r50_rank(parallel, conv3x3, matmul, ResNet50, Nesterovs, dev,
                                 int(argv[1]), int(argv[2]), [int(p) for p in argv[4:7]],
                                 argv[3])
    elif argv[0] == "r50twin":
        out = _r50_twin_rank(parallel, ResNet50, Nesterovs, dev, int(argv[1]), argv[2])
    elif argv[0] == "tp_infer":
        from deeplearning4j_tpu_torch import quant
        from deeplearning4j_tpu_torch.zoo import VGG16
        out = _tp_infer_rank(parallel, quant, matmul, VGG16, dev, json.loads(argv[1]))
    else:
        out = _sd_zero1_rank(autodiff, Adam, parallel, attention, layer_norm, dev)
    print("HOSTS_RANK " + json.dumps(out), flush=True)
    os._exit(0)       # no NCCL teardown (phase 44's note)


def _dp_resnet50_entry(name, r):
    """A conv kernel's launches in phase 44: a replayed data-parallel block
    (its graph's nodes at world 1, else the profiler's count), and the
    Python count at the warm-up and the capture."""
    entry = {"k": r["k"], "world": r["world"],
             "profiled_replays": [t[1][name] for t in r["replay_traces"]],
             "counted_at_warmup_and_capture":
                 r["launches_counted_at_warmup_and_capture"][name]}
    if "replay_nodes" in r:
        entry["launches_per_replayed_block"] = r["replay_nodes"][name]
    return entry


def _dp_zero1_entry(r):
    """fused_dense in phase 46: the Python count of each side (replicated,
    ZeRO-1) over its warm-up block's warm-up and capture, and the nodes of
    a replayed block."""
    return {"counted_at_warmup_and_capture": r["fused_dense_counted"],
            "launches_per_replayed_block": r.get("fused_dense_nodes_per_block"),
            "k": r["fused_steps"], "shape": "M=256 K=256 N=1024 and K=N=1024 f32 relu"}


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
    from deeplearning4j_tpu_torch import autodiff, data, modelimport, nn, parallel, train, zoo
    from deeplearning4j_tpu_torch.parallel import multihost
    from deeplearning4j_tpu_torch.data import MultiDataSet
    from deeplearning4j_tpu_torch.nlp import BertIterator, BertWordPieceTokenizer
    from deeplearning4j_tpu_torch.nn import ComputationGraph, MultiLayerNetwork
    from deeplearning4j_tpu_torch.serving import ModelServer
    from deeplearning4j_tpu_torch.train import Adam, Nesterovs
    from deeplearning4j_tpu_torch.train.schedules import StepSchedule
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
    graphs_res = phase_zoo_graphs(matmul, conv3x3, dispatch, zoo, ComputationGraph, dev)
    fused_lenet = phase_fused_lenet(matmul, data, LeNet, Adam, StepSchedule, dev)
    phase_fused_dropout(nn, train, dev)
    records_res = phase_records_train(matmul, dispatch, data, nn, Adam, dev)
    phase_conv_parity(ck, conv3x3, dev)
    net, x, y, conv_launches = phase_train(conv3x3, dispatch, ResNet50,
                                           Nesterovs, dev)
    phase_train_profile(net, x, y)
    del net
    net = phase_train_bf16(conv3x3, ResNet50, Nesterovs, dev, x, y)
    phase_train_profile(net, x, y, phase="train_bf16_profile", compute_dtype="bfloat16")
    del net, x, y
    fused_r50 = phase_fused_resnet50(conv3x3, matmul, dispatch, ResNet50, Nesterovs, dev)
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
    fused_bert = phase_fused_bert(BertModel, BertConfig, Adam, MultiDataSet, dispatch,
                                  attention, layer_norm, dev)
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
    phase_charlm(zoo, dispatch, dev)
    seq_attn = phase_seq_attention(nn, train, dispatch, attention, matmul, dev)
    sd_bert = phase_sd_tf_bert(autodiff, modelimport, Adam, dev)
    onnx_bert = phase_onnx_bert(modelimport, autodiff, layer_norm, Adam, dev, sd_bert)
    sd_kern = phase_sd_kernels(autodiff, Adam, dispatch, attention, layer_norm, dev)
    phase_onnx_resnet50(modelimport, quant, ModelServer, ResNet50, dev)
    qmha = phase_qmha(ak, qk, dispatch, attention, matmul, dev)
    # data parallel: one rank a card over NCCL; at world 1 this process is it
    import torch.distributed as dist
    if torch.cuda.device_count() == 1:
        multihost.initialize(f"127.0.0.1:{multihost.free_port()}", 1, 0, device=dev)
    try:
        dp_r50 = phase_dp_resnet50(parallel, multihost, conv3x3, matmul, ResNet50, Nesterovs,
                                   dev)
        dp_z1 = phase_dp_zero1(parallel, multihost, nn, Adam, matmul, dev)
        tp_vgg = phase_tp_vgg16(parallel, multihost, matmul, conv3x3, VGG16, Adam,
                                MultiLayerNetwork, dev)
        ring = phase_ring_flash(parallel, multihost, attention, dev)
        phase_composed(parallel, multihost, dev)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    # gradient sharing: a gang of processes joined by the TCP mesh only
    gs_r50, gs_r50_ranks = phase_gs_resnet50(parallel, multihost, conv3x3, matmul, ResNet50,
                                             Nesterovs, dev)
    gs_comms = phase_gs_comms(multihost, dev)
    # fault-tolerant and elastic training
    ft_r50 = phase_ft_resnet50(train, data, conv3x3, matmul, ResNet50, Nesterovs, dev)
    res_ab = phase_resilience_ab(dev)
    el_ab = phase_elastic_ab(multihost, dev)
    el_r50 = phase_elastic_resnet50(multihost, dev)
    # gang members of several cards; SameDiff under ZeRO-1
    gs_hosts = phase_gs_hosts_comms(multihost, dev)
    gs_hosts_r50 = phase_gs_hosts_resnet50(parallel, multihost, conv3x3, matmul, ResNet50,
                                           Nesterovs, dev)
    tp_inf = phase_tp_infer(parallel, quant, multihost, matmul, VGG16, dev)
    sd_z1 = phase_dp_sd_zero1(autodiff, Adam, parallel, multihost, attention, layer_norm, dev)

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
                      for m, r in zoo_res.items()},
        "records_train": {"launches": records_res["launches"],
                          "shape": f"M={RECORDS_CSV[3]} K={RECORDS_CSV[1]} N=500 f32 relu; "
                                   f"launches over one epoch of {records_res['steps']} "
                                   "steps from the CSV"},
        "seq_attention": {"launches_per_step": seq_attn["launches_per_step"]["fused_dense"],
                          "shape": "not on this path: the softmax head's loss and the LSTM "
                                   "are plain products"},
        **_fused_entries("fused_dense", fused_r50, fused_lenet),
        "dp_zero1": _dp_zero1_entry(dp_z1),
        "gs_comms": {"launches_per_step": gs_comms["dense"]["fused_dense_launches_per_step"],
                     "launches_per_step_compressed":
                         gs_comms["compressed"]["fused_dense_launches_per_step"],
                     "shape": f"M={GS_COMMS['rows']} K={GS_COMMS['n_in']} "
                              f"N={GS_COMMS['hidden']} f32 tanh; rank 0 over "
                              f"{GS_COMMS['steps']} steps a mode"},
        "gs_resnet50": {"launches_per_step": gs_r50["dense"]["launches_per_step"]["fused_dense"],
                        "shape": "not on this path: ResNet-50's head is a plain product"},
        "tp_infer": {"launches_per_forward": tp_inf["fused_dense_launches"],
                     "launch_shapes": tp_inf["fused_dense_shapes"], "mesh": tp_inf["axes"],
                     "shape": "VGG16 f32 through ParallelInference, rank 0, one forward of "
                              f"{tp_inf['rows']} rows"},
        "gs_hosts_comms": {"launches_per_step_each_rank": {
            m: gs_hosts[m]["fused_dense_launches_per_step"] for m in ("dense", "compressed")},
            "hosts": gs_hosts["hosts"], "devices_per_process": gs_hosts["devices_per_process"],
            "shape": "M={} K={} N={} f32 tanh; every rank over {} steps a mode".format(
                *gs_hosts["dense"]["fused_dense_shape"], GS_COMMS["steps"])},
        "resilience_ab": {"launches": res_ab["ab"]["fused_dense_launches_warmup_epochs"],
                          "shape": f"M={RES_AB['batch']} K={RES_AB['n_in']} N=512 and K=512 "
                                   "N=256 f32 relu; launches over the two sides' warm-up "
                                   f"epochs of {RES_AB['n_batches']} steps"},
        "early_stopping": {"launches": res_ab["early_stopping"]["fused_dense_launches"],
                           "shape": f"LeNet M={ES_LENET['batch']} K=800 N=500 f32 relu; "
                                    "launches over the EarlyStoppingTrainer run (a training "
                                    "step and a validation batch each one)"},
        "elastic_ab": {"launches_per_step": el_ab["fused_dense_launches_per_step"],
                       "shape": "M=4 (6 after the shrink) K=16 N=32 f32 tanh; the median "
                                "a step on each surviving rank of the gang of 3"},
        "ft_resnet50": {"launches": ft_r50["launches_counted_at_warmup_and_capture"][
                            "fused_dense"],
                        "shape": "not on this path: ResNet-50's head is a plain product"},
        "tp_vgg16": {"launches": tp_vgg["launches_per_step"]["fused_dense"] * TP_VGG_STEPS,
                     "launch_shapes_per_step": tp_vgg["fused_dense_shapes_per_step"],
                     "world": tp_vgg["world"], "mesh": tp_vgg["mesh"],
                     **tp_vgg["fused_dense_at_shard"],
                     "shape": tp_vgg["fused_dense_at_shard"]["shape"] + "; launches on rank "
                              f"0 over {TP_VGG_STEPS} tensor-parallel VGG16 steps"}}]
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
                          for m, r in zoo_res.items()},
            "zoo_graphs": {m: r["launches_per_step"][name] * ZOO_STEPS
                           for m, r in graphs_res.items()},
            **_fused_entries(name, fused_r50, fused_lenet),
            "dp_resnet50": _dp_resnet50_entry(name, dp_r50),
            "tp_vgg16": {"launches": tp_vgg["launches_per_step"][name] * TP_VGG_STEPS,
                         "world": tp_vgg["world"], "mesh": tp_vgg["mesh"],
                         "shape": f"rank 0 over {TP_VGG_STEPS} tensor-parallel VGG16 steps "
                                  "(the conv filters gathered at use)"},
            "gs_resnet50": {"launches_per_step_world1": {
                m: gs_r50[m]["launches_per_step"][name] for m in ("dense", "compressed")},
                "launches_per_step_gang_rank0": {
                m: gs_r50_ranks[0][m]["launches_per_step"][name]
                for m in ("dense", "compressed")}, "k": GS_R50_K},
            "gs_hosts_resnet50": {"launches_per_step_each_rank": [
                {m: r[m]["launches_per_step"][name] for m, _, _ in GS_HOSTS_MODES}
                for r in gs_hosts_r50], "rows_per_rank": gs_hosts_r50[0]["dense"]["rows_per_rank"],
                "shape": "bf16 ResNet-50 as hosts; every rank, dense, threshold and dense "
                         "under ZeRO-1"},
            "ft_resnet50": {
                "counted_at_warmup_and_capture":
                    ft_r50["launches_counted_at_warmup_and_capture"][name],
                "launches_per_replayed_block": ft_r50["launches_per_replayed_block"][name],
                "k": FT_R50["k"], "shape": "bf16 ResNet-50 batch 64 under "
                                           "FaultTolerantTrainer, fused blocks of 5"},
            "elastic_resnet50": {
                "launches_per_step": {tag: {r: sorted({p[0 if name == "conv3x3_wgrad" else 1]
                                                       for p in v})
                                            for r, v in per.items()}
                                      for tag, per in el_r50["conv_launches_per_step"].items()},
                "shape": f"bf16 ResNet-50, {EL_R50['global_batch']} global rows over a gang "
                         "of 3 then 2; every step of every rank"}})
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
            "fused_bert": _fused_bert_entries(name, fused_bert),
            "sd_kernels": _sd_kernels_entry(name, sd_kern),
            "dp_sd_zero1": _sd_zero1_entry(name, sd_z1),
            **({"onnx_bert": _onnx_bert_entry(name, onnx_bert)}
               if name == "layer_norm_fwd" else {"qmha": _qmha_entry(name, qmha)}),
            **({"seq_attention": _seq_attention_entry(name, seq_attn),
                "ring_flash": {"launches_per_call": {c: r["launches"]
                                                     for c, r in ring["cases"].items()},
                               "world": ring["world"], "t_per_rank": ring["t_per_rank"],
                               "ms": {c: r["ms"] for c, r in ring["cases"].items()},
                               "plain_ring_ms": {c: r["plain_ring_ms"]
                                                 for c, r in ring["cases"].items()},
                               "shape": f"q/k/v {ring['shape']} split on T over the seq "
                                        "axis; rank 0's launches a ring call"}}
               if name == "flash_attn_fwd" else {}),
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
            "fused_bert": _fused_bert_entries(name, fused_bert),
            "sd_kernels": _sd_kernels_entry(name, sd_kern),
            "dp_sd_zero1": _sd_zero1_entry(name, sd_z1),
            **({"seq_attention": _seq_attention_entry(name, seq_attn)}
               if name.startswith("flash") else {"onnx_bert": _onnx_bert_entry(name, onnx_bert)}),
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
            "bound_by": row["bound_by"], "library_ms": row["library_ms"], "shape": shape,
            **({"tp_infer": {"launches_per_forward": tp_inf["q_matmul_launches"],
                             "launch_shapes": tp_inf["q_matmul_shapes"],
                             "mesh": tp_inf["axes"],
                             "shape": "weight-only int8 VGG16, leaves placed by "
                                      "shard_model_params, rank 0, one forward"},
                "qmha": _qmha_entry(name, qmha)}
               if name == "q_matmul" else {})})
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
    if sys.argv[1:2] == ["--dp-rank"]:
        sys.exit(dp_rank_main(sys.argv[2:]))
    if sys.argv[1:2] == ["--gs-rank"]:
        sys.exit(gs_rank_main(sys.argv[2:]))
    if sys.argv[1:2] == ["--mp-rank"]:
        sys.exit(mp_rank_main(sys.argv[2:]))
    if sys.argv[1:2] == ["--hosts-rank"]:
        sys.exit(hosts_rank_main(sys.argv[2:]))
    if sys.argv[1:2] == ["--elastic-rank"]:
        sys.exit(elastic_rank_main(sys.argv[2:]))
    if sys.argv[1:2] == ["--resilience-ab"]:
        sys.exit(resilience_ab_main(sys.argv[2:]))
    sys.exit(main())
