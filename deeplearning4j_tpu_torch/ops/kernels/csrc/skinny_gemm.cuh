// skinny_gemm.cuh: the skinny-M, split-K GEMM that fused_dense.cu,
// q_matmul.cu and int8_matmul.cu share, for NVIDIA Hopper (sm_90a).
//
// The three kernels replace the TPU kernel deeplearning4j_tpu/ops/pallas/
// matmul.py:79 `_matmul_kernel` (reached through `fused_dense`, `q_matmul`
// and `int8_matmul`): y = epilogue(x @ W) with x [M, K] row-major (f32,
// bf16 or int8), W [K, N] row-major (x's dtype, or int8 widened on chip),
// an f32 accumulator (int32 for int8 x), and an epilogue that runs once,
// in f32, on the full sum.  This header holds the machinery; each .cu
// holds its epilogue, its __global__ kernel (so the profiler names them
// apart) and its extern "C" entry.
//
// The serving shapes (VGG16's Dense layers behind ModelServer(max_batch=16):
// M = 1, 2, 4, 8 or 16; fc6 K = 25088, N = 4096; fc7 4096 x 4096; output
// 4096 x 1000) are bytes-bound: W is read once and x is tiny.  Bound at
// 3.35 TB/s, M = 16: fc6 f32 0.123 ms, bf16 0.061, int8 W 0.031 (f32 x:
// operations, 0.049 ms at 67 TFLOP/s); fc7 f32 0.020, bf16 0.010, int8 W
// 0.005 (f32 x: 0.008, operations); output f32 0.0049, bf16 0.0025, int8 W
// 0.0013 (f32 x: 0.002, operations).
//
// What the first design (a 64x64 SIMT tile, K step 16) lost there: 64
// blocks for 132 SMs, three quarters of each A tile masked, scalar W loads
// (4 bytes, or 1 for int8), and no load in flight while a block computed,
// so about 4 KB of W was in flight per busy SM where the card needs about
// 20 KB per SM to cover its latency: 2.0 ms at fc6 in either kernel, 16x
// to 72x the bound.
//
// What this design does about it:
//
// * Skinny-M tile.  A block of 128 threads covers BM = 16 rows of x (every
//   serving bucket, and the M of mma.sync.m16n8k16) and BN = 128 columns
//   (each .cu picks BK and STAGES); M > 16 takes ceil(M/16) row tiles in
//   gridDim.z.
// * Split-K.  gridDim.y = S slices of K.  The wrapper's `gemm_plan`
//   (ops/kernels/matmul.py) picks S so the grid has at least 2 blocks per
//   SM, and slice s covers K steps [s*ksteps/S, (s+1)*ksteps/S) (integer
//   division, BK rows a step, the last slice clipped at K); `slice_bounds`
//   below is the same formula.
// * A ring of STAGES shared-memory stages, STAGES - 1 in flight while the
//   block computes on the last.  Where W's base and row stride are 16-byte
//   aligned (every VGG16 shape but the int8 output layer), W's [BK, BN]
//   tile comes by TMA: one cp.async.bulk.tensor copy a stage from a 2D
//   tensor map (encoded on the host through cudaGetDriverEntryPoint, so
//   nothing links libcuda), completing on the stage's mbarrier, rows past K
//   and columns past N filled with zeros by the copy; for bf16 it lands as
//   64-column boxes in TMA's 128-byte swizzle, which keeps ldmatrix free of
//   bank conflicts.  Elsewhere, and always for the x tile, 16-byte
//   cp.async.cg copies (float4, 8 x bf16, 16 x int8 a thread; neighbouring
//   threads on neighbouring addresses); rows only 8- or 4-byte aligned
//   (N = 1000 int8, N = 500 bf16) take 8- or 4-byte cp.async.ca copies,
//   ragged edges are zero-filled by the copy's src-size or, off 4-byte
//   alignment, byte by byte.  On an H100 the TMA copies stream W faster
//   than the per-thread copies (f32 fc6 0.18 against 0.21 ms; PERF.md).
// * The product.  f32 x: SIMT FMA (TF32 off).  Each thread owns 4 columns
//   (one float4 of W) for all 16 rows; KG groups of threads split each
//   stage's K rows, read x as a broadcast from shared memory, and their
//   partial sums are added in group order at the end.  int8 W widens to
//   f32 in registers.
//   bf16 x: tensor cores, mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16
//   .f32, A = the 16 x 16 x tile by ldmatrix, B from W's [K, N] row-major
//   (N-contiguous) tile by ldmatrix.trans, which hands each thread the
//   K-pairs of one column the fragment wants; each warp owns 32 columns.
//   int8 W first widens to bf16 (exact) in a shared-memory tile.
//   int8 x (with int8 W): int8 tensor cores, mma.sync.aligned.m16n8k32.row
//   .col.s32.s8.s8.s32, A = the 16 x 32-byte x tile by ldmatrix (each
//   32-bit register is four consecutive K bytes of a row, as the fragment
//   wants).  B wants four consecutive K bytes of one column in a register,
//   which ldmatrix .trans (16-bit elements) cannot make from W's
//   N-contiguous rows, so each landed W stage is rewritten in shared memory
//   as [BN][BK] (K-contiguous): a thread moves 4 x 4 byte blocks with
//   __byte_perm, lane l of a warp taking column block l and K block
//   (l + d) % (BK/4) on diagonal d, into rows whose 16-byte chunk c sits at
//   c ^ (n % 8).  The reads (one 128-byte W row a warp) and the writes
//   (8 chunks x 4 words) hit 32 banks, and so do the non-transposing
//   ldmatrix reads of B.  int32 sums are exact in any order.
// * A deterministic split-K reduction in the same launch.  Each block
//   stores its [16, 128] f32 (int8 x: int32) partial to the workspace
//   [S, M, N].  The last block of each (column tile, row tile) to arrive,
//   found by an integer arrival counter after __threadfence(), sums the S
//   partials in the fixed order s = 0..S-1 (ld.global.cg, past L1), runs
//   the epilogue and stores y (16-byte loads of the partials where
//   N % 4 == 0), then resets its counter to 0 for the next launch.  No float atomics:
//   the same inputs give the same bits on every call.  The workspace and
//   the counters are buffers the wrapper keeps per device and stream
//   (launches on one stream run in order); the counters are zeroed once.
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <type_traits>

namespace skinny {

constexpr int BM = 16;
constexpr int BN = 128;
// one output column a thread in the split-K tail
constexpr int THREADS = BN;
constexpr int WARPS = THREADS / 32;

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// One instantiation: x's and W's element types, BK K rows a stage, STAGES
// stages in the ring, W by TMA or not, y's element type, and the
// shared-memory layout.
template <typename XT_, typename WT_, int BK_, int STAGES_, bool TMA_ = false,
          typename YT_ = XT_>
struct Cfg {
  using XT = XT_;
  using WT = WT_;
  using YT = YT_;
  static constexpr int BK = BK_;
  static constexpr int STAGES = STAGES_;
  // W's tile arrives by one TMA copy a stage (2D tensor map, rows past K
  // and columns past N filled with zeros) instead of 16-byte cp.async
  static constexpr bool TMA = TMA_;
  // MMA: each warp owns WN columns, WN / 8 tiles of n8
  static constexpr int WN = BN / WARPS;
  // bf16 x runs on tensor cores; int8 W then widens to bf16 in shared memory
  static constexpr bool MMA = std::is_same<XT, __nv_bfloat16>::value;
  static constexpr bool WIDEN = MMA && std::is_same<WT, int8_t>::value;
  // int8 x runs on the int8 tensor cores with int32 sums (partials too);
  // each W stage is transposed to [BN][BK] in shared memory first
  static constexpr bool IMMA = std::is_same<XT, int8_t>::value;
  using AT = typename std::conditional<IMMA, int32_t, float>::type;
  // SIMT: CT threads across the columns (4 each), KG groups of them split
  // each stage's K rows
  static constexpr int CT = BN / 4;
  static constexpr int KG = THREADS / CT;
  // a bf16 W tile read by ldmatrix gets 8 columns of pad, so the 8 rows of
  // one 8x8 matrix fall in 8 different 16-byte bank groups
  static constexpr int W_LD = (MMA && !WIDEN && !TMA) ? BN + 8 : BN;
  // x rows read by ldmatrix get 16 bytes of pad (8 rows, 8 bank groups)
  static constexpr int X_LD = (MMA || IMMA) ? BK + 16 / (int)sizeof(XT) : BK;
  static constexpr int W_BYTES = BK * W_LD * (int)sizeof(WT);
  static constexpr int X_BYTES = BM * X_LD * (int)sizeof(XT);
  // TMA with bf16 (read by ldmatrix) lands W as BN/64 boxes of 64 columns
  // (128-byte rows) in TMA's 128-byte swizzle: 16-byte chunk c of row k sits
  // at chunk c ^ (k % 8), so ldmatrix's 8 rows hit 8 bank groups
  static constexpr bool SWZ = TMA && MMA && !WIDEN;
  static constexpr int SWZ_COLS = 64;
  static constexpr int STAGE_ALIGN = SWZ ? 1024 : 128;
  static constexpr int STAGE_BYTES =
      TMA ? (W_BYTES + X_BYTES + STAGE_ALIGN - 1) / STAGE_ALIGN * STAGE_ALIGN
          : W_BYTES + X_BYTES;
  static constexpr int CVT_LD = BN + 8;
  static constexpr int CVT_BYTES = WIDEN ? BK * CVT_LD * 2 : IMMA ? BN * BK : 0;
  static constexpr int RING_BYTES = STAGES * STAGE_BYTES + CVT_BYTES;
  // the SIMT path's sum over its K groups reuses the ring
  static constexpr int RED_BYTES = (MMA || IMMA) ? 0 : KG * BM * BN * 4;
  // + 1024: the ring starts at the first 1024-byte boundary (TMA's swizzle
  // atom)
  static constexpr int SMEM_BYTES = (RING_BYTES > RED_BYTES ? RING_BYTES : RED_BYTES) + 1024;
  static_assert(BK % 16 == 0 && STAGES >= 2, "tile");
  static_assert(CT % 32 == 0 && THREADS % CT == 0 && WN % 16 == 0, "threads");
  static_assert((BK * BN * (int)sizeof(WT)) % (16 * THREADS) == 0, "W chunks a thread");
  static_assert(W_BYTES % 16 == 0 && X_BYTES % 16 == 0, "16-byte stages");
  static_assert(!TMA || W_BYTES % STAGE_ALIGN == 0, "TMA stages");
  static_assert(!SWZ || BN % SWZ_COLS == 0, "swizzled boxes");
  // the transpose's lanes take BN / 4 = 32 column blocks, its rows are whole
  // 128-byte lines
  static_assert(!IMMA || (std::is_same<WT, int8_t>::value && BN == 128 && BK % 128 == 0),
                "int8 tile");
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n"
               :: "r"(smem_addr(dst)), "l"(src));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(smem_addr(dst)), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" :: "r"(smem_addr(bar)));
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t phase) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT_%=:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT_%=;\n"
      "}\n" :: "r"(smem_addr(bar)), "r"(phase) : "memory");
}
// W rows [k0, k0 + box rows) x columns [n0, n0 + box columns) into dst; the
// barrier's transaction count falls by the box's bytes when it lands.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int n0, int k0) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];\n"
      :: "r"(smem_addr(dst)), "l"(map), "r"(n0), "r"(k0), "r"(smem_addr(bar)) : "memory");
}

// Copy one 16-byte chunk of which the first `valid` bytes lie inside the
// array; the rest of the chunk is zero.
__device__ __forceinline__ void copy_chunk(char* dst, const char* src, int valid) {
  if (valid <= 0) {
    *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
    return;
  }
  const uintptr_t a = reinterpret_cast<uintptr_t>(src);
  if ((a & 15) == 0) {
    cp_async16(dst, src, valid);
  } else if (valid == 16 && (a & 7) == 0) {
    cp_async8(dst, src);
    cp_async8(dst + 8, src + 8);
  } else if (valid == 16 && (a & 3) == 0) {
#pragma unroll
    for (int i = 0; i < 16; i += 4) cp_async4(dst + i, src + i);
  } else {
#pragma unroll
    for (int i = 0; i < 16; ++i) dst[i] = i < valid ? src[i] : 0;
  }
}

// K rows [k_begin, k_end) of slice s of S: whole K steps of BK rows,
// [s*ksteps/S, (s+1)*ksteps/S) in integer division, clipped at K.  The
// wrapper's `gemm_plan` computes the same bounds.
template <int BK>
__device__ __forceinline__ void slice_bounds(int K, int S, int s, int* k_begin, int* k_end) {
  const int64_t ksteps = K > 0 ? (K + BK - 1) / BK : 1;
  *k_begin = (int)((int64_t)s * ksteps / S) * BK;
  const int e = (int)((int64_t)(s + 1) * ksteps / S) * BK;
  *k_end = e < K ? e : K;
}

// One stage: W rows [k0, k0 + BK) x columns [col0, col0 + BN), then x rows
// [row0, row0 + BM) x columns [k0, k0 + BK).  Rows of W and columns of x at
// or past k_end, columns of W past N and rows of x past M read as zero.
template <class C>
__device__ __forceinline__ void load_stage(char* stage, uint64_t* bar, const CUtensorMap* wmap,
                                           const typename C::XT* __restrict__ x,
                                           const typename C::WT* __restrict__ w, int M, int N,
                                           int K, int row0, int col0, int k0, int k_end,
                                           int tid) {
  using XT = typename C::XT;
  using WT = typename C::WT;
  constexpr int WE = 16 / (int)sizeof(WT);
  constexpr int W_ROW_CHUNKS = BN / WE;
  constexpr int W_CHUNKS = C::BK * W_ROW_CHUNKS;
  if constexpr (C::TMA) {
    if (tid == 0) {
      mbar_expect_tx(bar, C::W_BYTES);
      if constexpr (C::SWZ) {
#pragma unroll
        for (int h = 0; h < BN / C::SWZ_COLS; ++h)
          tma_load_2d(stage + h * C::BK * C::SWZ_COLS * (int)sizeof(WT), wmap, bar,
                      col0 + h * C::SWZ_COLS, k0);
      } else {
        tma_load_2d(stage, wmap, bar, col0, k0);
      }
    }
  } else {
#pragma unroll 2
  for (int i = 0; i < W_CHUNKS / THREADS; ++i) {
    const int c = tid + i * THREADS;
    const int r = c / W_ROW_CHUNKS;
    const int cn = (c % W_ROW_CHUNKS) * WE;
    const int k = k0 + r;
    const int n = col0 + cn;
    const int cols = N - n < WE ? N - n : WE;
    const int valid = (k < k_end && cols > 0) ? cols * (int)sizeof(WT) : 0;
    copy_chunk(stage + (r * C::W_LD + cn) * (int)sizeof(WT),
               reinterpret_cast<const char*>(w + (int64_t)k * N + n), valid);
  }
  }
  constexpr int XE = 16 / (int)sizeof(XT);
  constexpr int X_ROW_CHUNKS = C::BK / XE;
  constexpr int X_CHUNKS = BM * X_ROW_CHUNKS;
  char* xs = stage + C::W_BYTES;
  for (int c = tid; c < X_CHUNKS; c += THREADS) {
    const int r = c / X_ROW_CHUNKS;
    const int ck = (c % X_ROW_CHUNKS) * XE;
    const int m = row0 + r;
    const int k = k0 + ck;
    const int cols = k_end - k < XE ? k_end - k : XE;
    const int valid = (m < M && cols > 0) ? cols * (int)sizeof(XT) : 0;
    copy_chunk(xs + (r * C::X_LD + ck) * (int)sizeof(XT),
               reinterpret_cast<const char*>(x + (int64_t)m * K + k), valid);
  }
}

// The ring over one K slice: stage i + STAGES - 1 is copied in while
// `compute` runs on stage i.
template <class C, typename Compute>
__device__ __forceinline__ void pipeline(char* smem, uint64_t* bars, const CUtensorMap* wmap,
                                         const typename C::XT* __restrict__ x,
                                         const typename C::WT* __restrict__ w, int M, int N,
                                         int K, int row0, int col0, int k_begin, int k_end,
                                         int tid, Compute&& compute) {
  constexpr int BK = C::BK, STAGES = C::STAGES;
  const int nsteps = k_end > k_begin ? (k_end - k_begin + BK - 1) / BK : 0;
#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < nsteps)
      load_stage<C>(smem + st * C::STAGE_BYTES, bars + st, wmap, x, w, M, N, K, row0, col0,
                    k_begin + st * BK, k_end, tid);
    cp_async_commit();
  }
  for (int step = 0; step < nsteps; ++step) {
    cp_async_wait<STAGES - 2>();
    if constexpr (C::TMA) mbar_wait(bars + step % STAGES, (step / STAGES) & 1);
    __syncthreads();  // stage `step` landed; every thread left stage step - 1
    const int next = step + STAGES - 1;
    if (next < nsteps)
      load_stage<C>(smem + (next % STAGES) * C::STAGE_BYTES, bars + next % STAGES, wmap, x, w,
                    M, N, K, row0, col0, k_begin + next * BK, k_end, tid);
    cp_async_commit();
    compute(smem + (step % STAGES) * C::STAGE_BYTES);
  }
  cp_async_wait<0>();
  __syncthreads();
}

// ---- f32 x: SIMT ----------------------------------------------------------

__device__ __forceinline__ void load_w4(const float* p, float (&o)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
}
__device__ __forceinline__ void load_w4(const int8_t* p, float (&o)[4]) {
  const char4 v = *reinterpret_cast<const char4*>(p);
  o[0] = (float)v.x; o[1] = (float)v.y; o[2] = (float)v.z; o[3] = (float)v.w;
}

// K group kg takes the stage's K rows [kg*BK/KG, (kg+1)*BK/KG), four at a
// time; thread c4 of the group owns columns 4*c4 .. 4*c4+3 for all 16 rows.
template <class C>
__device__ __forceinline__ void simt_stage(const char* stage, float (&acc)[BM][4], int kg,
                                           int c4) {
  const auto* ws = reinterpret_cast<const typename C::WT*>(stage);
  const float* xs = reinterpret_cast<const float*>(stage + C::W_BYTES);
  constexpr int RPG = C::BK / C::KG;
  static_assert(RPG % 4 == 0, "K rows a group");
#pragma unroll 1
  for (int g = 0; g < RPG; g += 4) {
    const int kk = kg * RPG + g;
    float wv[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j) load_w4(ws + (kk + j) * C::W_LD + 4 * c4, wv[j]);
#pragma unroll
    for (int m = 0; m < BM; ++m) {
      const float4 xv = *reinterpret_cast<const float4*>(xs + m * C::X_LD + kk);
      const float xa[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[m][c] = fmaf(xa[j], wv[j][c], acc[m][c]);
    }
  }
}

// The block's partial sum over its K slice, stored to ws[s] (f32 x).
template <class C>
__device__ __forceinline__ void partial_simt(char* smem, uint64_t* bars, const CUtensorMap* wmap,
                                             const float* __restrict__ x,
                                             const typename C::WT* __restrict__ w, float* ws,
                                             int M, int N, int K, int row0, int col0, int s,
                                             int k_begin, int k_end) {
  const int tid = threadIdx.x, kg = tid / C::CT, c4 = tid % C::CT;
  float acc[BM][4];
#pragma unroll
  for (int m = 0; m < BM; ++m)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[m][c] = 0.0f;
  pipeline<C>(smem, bars, wmap, x, w, M, N, K, row0, col0, k_begin, k_end, tid,
              [&](const char* stage) { simt_stage<C>(stage, acc, kg, c4); });
  // the K groups' sums, added in group order
  float* red = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int m = 0; m < BM; ++m)
    *reinterpret_cast<float4*>(red + (kg * BM + m) * BN + 4 * c4) =
        make_float4(acc[m][0], acc[m][1], acc[m][2], acc[m][3]);
  __syncthreads();
  const int n = col0 + tid;
#pragma unroll
  for (int i = 0; i < BM; ++i) {
    float v = red[i * BN + tid];
#pragma unroll
    for (int q = 1; q < C::KG; ++q) v += red[(q * BM + i) * BN + tid];
    if (row0 + i < M && n < N) ws[((int64_t)s * M + row0 + i) * N + n] = v;
  }
}

// ---- bf16 x: tensor cores -------------------------------------------------

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)) : "memory");
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)) : "memory");
}
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Warp `warp` owns columns [WN*warp, WN*warp + WN): WN / 8 tiles.  Lane l
// addresses row l%8 of 8x8 matrix l/8.  A (x, [16][X_LD], K-contiguous):
// matrices (rows 0-7, k 0-7), (8-15, 0-7), (0-7, 8-15), (8-15, 8-15) are
// a0..a3.  B (W, [BK][w_ld], N-contiguous) through .trans: matrix (k 0-7,
// n 0-7) gives each lane W[2t, 2t+1][g] (t = lane%4, g = lane/4), the
// fragment's b0; (k 8-15, n 0-7) its b1; the next 8 columns the next tile's.
template <class C>
__device__ __forceinline__ void mma_stage(const __nv_bfloat16* wt, int w_ld,
                                          const __nv_bfloat16* xs, float (&acc)[C::WN / 8][4],
                                          int warp, int lane) {
  const int j = lane >> 3, r = lane & 7;
#pragma unroll
  for (int k16 = 0; k16 < C::BK; k16 += 16) {
    uint32_t a[4];
    ldmatrix_x4(a, xs + ((j & 1) * 8 + r) * C::X_LD + k16 + (j >> 1) * 8);
#pragma unroll
    for (int p = 0; p < C::WN / 16; ++p) {
      uint32_t b[4];
      const int k = k16 + (j & 1) * 8 + r, n = warp * C::WN + p * 16 + (j >> 1) * 8;
      if constexpr (C::SWZ) {
        const int h = n / C::SWZ_COLS, c = (n % C::SWZ_COLS) / 8;
        ldmatrix_x4_trans(b, wt + (h * C::BK + k) * C::SWZ_COLS + ((c ^ (k & 7)) << 3));
      } else {
        ldmatrix_x4_trans(b, wt + k * w_ld + n);
      }
      mma_bf16(acc[2 * p], a, b[0], b[1]);
      mma_bf16(acc[2 * p + 1], a, b[2], b[3]);
    }
  }
}

// int8 W stage [BK][BN] -> bf16 [BK][BN + 8] (exact), 16 values a thread.
template <class C>
__device__ __forceinline__ void widen_stage(const int8_t* src, __nv_bfloat16* dst, int tid) {
  constexpr int ROW_CHUNKS = BN / 16;
#pragma unroll
  for (int c = tid; c < C::BK * ROW_CHUNKS; c += THREADS) {
    const int r = c / ROW_CHUNKS, cn = (c % ROW_CHUNKS) * 16;
    const int4 v = *reinterpret_cast<const int4*>(src + r * BN + cn);
    const int words[4] = {v.x, v.y, v.z, v.w};
    uint32_t o[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int wd = words[i / 2], sh = 16 * (i % 2);
      const __nv_bfloat162 h = __floats2bfloat162_rn((float)(int8_t)(wd >> sh),
                                                     (float)(int8_t)(wd >> (sh + 8)));
      o[i] = *reinterpret_cast<const uint32_t*>(&h);
    }
    uint4* d = reinterpret_cast<uint4*>(dst + r * C::CVT_LD + cn);
    d[0] = make_uint4(o[0], o[1], o[2], o[3]);
    d[1] = make_uint4(o[4], o[5], o[6], o[7]);
  }
}

// ---- int8 x: int8 tensor cores ---------------------------------------------

__device__ __forceinline__ void mma_s8(int32_t (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Byte offset of (column n, K byte k) in the transposed [BN][BK] tile: row n
// holds BK bytes, its 16-byte chunk c at chunk c ^ (n % 8).
template <int BK>
__device__ __forceinline__ int t_offset(int n, int k) {
  return n * BK + ((((k >> 4) ^ n) & 7) | ((k >> 4) & ~7)) * 16 + (k & 15);
}

// int8 W stage [BK][BN] (N-contiguous) -> [BN][BK] (K-contiguous, chunks
// swizzled).  Block (kb, nb) is W rows 4kb..4kb+3 x columns 4nb..4nb+3,
// four words in and four out; on diagonal d lane l takes nb = l and
// kb = (l + d) % (BK/4), warp w the diagonals w, w + WARPS, ...
template <class C>
__device__ __forceinline__ void transpose_stage(const int8_t* src, int8_t* dst, int tid) {
  constexpr int KB = C::BK / 4, NB = BN / 4;
  static_assert(NB == 32 && KB % WARPS == 0, "diagonals");
  const int warp = tid >> 5, lane = tid & 31;
  const uint32_t* s = reinterpret_cast<const uint32_t*>(src);
#pragma unroll
  for (int it = 0; it < KB / WARPS; ++it) {
    const int kb = (lane + warp + it * WARPS) & (KB - 1);
    uint32_t r[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) r[j] = s[(4 * kb + j) * NB + lane];
    // t0 = W[k][n], W[k+1][n], W[k][n+1], W[k+1][n+1] (k = 4kb, n = 4l) ...
    const uint32_t t0 = __byte_perm(r[0], r[1], 0x5140), t1 = __byte_perm(r[2], r[3], 0x5140);
    const uint32_t t2 = __byte_perm(r[0], r[1], 0x7362), t3 = __byte_perm(r[2], r[3], 0x7362);
    // ... so column n + i's four K bytes are
    const uint32_t o[4] = {__byte_perm(t0, t1, 0x5410), __byte_perm(t0, t1, 0x7632),
                           __byte_perm(t2, t3, 0x5410), __byte_perm(t2, t3, 0x7632)};
#pragma unroll
    for (int i = 0; i < 4; ++i)
      *reinterpret_cast<uint32_t*>(dst + t_offset<C::BK>(4 * lane + i, 4 * kb)) = o[i];
  }
}

// Warp `warp` owns columns [WN*warp, WN*warp + WN): WN / 8 tiles of n8, K
// steps of 32 bytes.  Lane l addresses row l%8 of 8x8 (16-bit) matrix l/8.
// A (x, [16][X_LD] bytes): matrices (rows 0-7, k 0-15), (8-15, 0-15),
// (0-7, 16-31), (8-15, 16-31) are a0..a3, each register four K bytes of
// row l/4.  B (the transposed tile): (n 0-7, k 0-15) and (n 0-7, k 16-31)
// are b0, b1 of the first n8 tile, each register four K bytes of column
// l/4; the next 8 columns the next tile's.
template <class C>
__device__ __forceinline__ void imma_stage(const int8_t* wt, const int8_t* xs,
                                           int32_t (&acc)[C::WN / 8][4], int warp, int lane) {
  const int j = lane >> 3, r = lane & 7;
#pragma unroll
  for (int k32 = 0; k32 < C::BK; k32 += 32) {
    uint32_t a[4];
    ldmatrix_x4(a, xs + ((j & 1) * 8 + r) * C::X_LD + k32 + (j >> 1) * 16);
#pragma unroll
    for (int p = 0; p < C::WN / 16; ++p) {
      uint32_t b[4];
      const int n = warp * C::WN + p * 16 + (j >> 1) * 8 + r;
      ldmatrix_x4(b, wt + t_offset<C::BK>(n, k32 + (j & 1) * 16));
      mma_s8(acc[2 * p], a, b[0], b[1]);
      mma_s8(acc[2 * p + 1], a, b[2], b[3]);
    }
  }
}

// The block's partial sum over its K slice, stored to ws[s] (bf16 or int8
// x: tensor cores).
template <class C>
__device__ __forceinline__ void partial_mma(char* smem, uint64_t* bars, const CUtensorMap* wmap,
                                            const typename C::XT* __restrict__ x,
                                            const typename C::WT* __restrict__ w,
                                            typename C::AT* ws, int M, int N, int K, int row0,
                                            int col0, int s, int k_begin, int k_end) {
  using AT = typename C::AT;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  constexpr int NT = C::WN / 8;
  AT acc[NT][4];
#pragma unroll
  for (int t = 0; t < NT; ++t)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[t][c] = AT(0);
  pipeline<C>(smem, bars, wmap, x, w, M, N, K, row0, col0, k_begin, k_end, tid,
              [&](const char* stage) {
    const auto* xs = reinterpret_cast<const typename C::XT*>(stage + C::W_BYTES);
    if constexpr (C::IMMA) {
      auto* wt = reinterpret_cast<int8_t*>(smem + C::STAGES * C::STAGE_BYTES);
      transpose_stage<C>(reinterpret_cast<const int8_t*>(stage), wt, tid);
      __syncthreads();
      imma_stage<C>(wt, xs, acc, warp, lane);
    } else if constexpr (C::WIDEN) {
      auto* wt = reinterpret_cast<__nv_bfloat16*>(smem + C::STAGES * C::STAGE_BYTES);
      widen_stage<C>(reinterpret_cast<const int8_t*>(stage), wt, tid);
      __syncthreads();
      mma_stage<C>(wt, C::CVT_LD, xs, acc, warp, lane);
    } else {
      mma_stage<C>(reinterpret_cast<const __nv_bfloat16*>(stage), C::W_LD, xs, acc, warp,
                   lane);
    }
  });
  // c0, c1: row g, columns 2t, 2t+1 of the tile; c2, c3: row g + 8
  const int g = lane >> 2, t2 = 2 * (lane & 3);
#pragma unroll
  for (int jt = 0; jt < NT; ++jt) {
    const int n = col0 + warp * C::WN + jt * 8 + t2;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = row0 + g + 8 * h;
      if (m >= M) continue;
      AT* dst = ws + ((int64_t)s * M + m) * N + n;
      if (n < N) dst[0] = acc[jt][2 * h];
      if (n + 1 < N) dst[1] = acc[jt][2 * h + 1];
    }
  }
}

// ---- the split-K tail ------------------------------------------------------

// y = epi(ws[0] + ws[1] + ... + ws[S-1]) over the tile, summed in that order;
// one column a thread, two partials' loads in flight.
template <class C, typename Epi>
__device__ __forceinline__ void finish_tile(const typename C::AT* ws,
                                            typename C::YT* __restrict__ y, int M, int N, int S,
                                            int row0, int col0, int rows, int tid,
                                            const Epi& epi) {
  using AT = typename C::AT;
  const int n = col0 + tid;
  if (n < N) {
    AT v[BM];
    for (int q = 0; q < S; q += 2) {
      const bool two = q + 1 < S;
      AT a[BM], b[BM];
      const AT* p = ws + ((int64_t)q * M + row0) * N + n;
#pragma unroll
      for (int i = 0; i < BM; ++i) {
        a[i] = i < rows ? __ldcg(p + (int64_t)i * N) : AT(0);
        b[i] = (two && i < rows) ? __ldcg(p + ((int64_t)M + i) * N) : AT(0);
      }
#pragma unroll
      for (int i = 0; i < BM; ++i) {
        v[i] = q == 0 ? a[i] : v[i] + a[i];
        if (two) v[i] += b[i];
      }
    }
#pragma unroll
    for (int i = 0; i < BM; ++i)
      if (i < rows) y[(int64_t)(row0 + i) * N + n] = from_f32<typename C::YT>(epi(v[i], n));
  }
}

__device__ __forceinline__ void add4(float4& v, const float4& t) {
  v.x += t.x; v.y += t.y; v.z += t.z; v.w += t.w;
}
__device__ __forceinline__ void add4(int4& v, const int4& t) {
  v.x += t.x; v.y += t.y; v.z += t.z; v.w += t.w;
}
template <typename AT> struct Vec4;
template <> struct Vec4<float> { using type = float4; };
template <> struct Vec4<int32_t> { using type = int4; };

// The same sums when N % 4 == 0, with 16-byte loads: a thread takes 4
// columns of 4 rows, four partials' loads in flight.
template <class C, typename Epi>
__device__ __forceinline__ void finish_tile_vec4(const typename C::AT* ws,
                                                 typename C::YT* __restrict__ y, int M, int N,
                                                 int S, int row0, int col0, int rows, int tid,
                                                 const Epi& epi) {
  using V = typename Vec4<typename C::AT>::type;
  constexpr int QUADS = BN / 4, RB = 4;
  static_assert(QUADS * (BM / 4) == THREADS, "4 columns of 4 rows a thread");
  const int n = col0 + 4 * (tid % QUADS), r0 = 4 * (tid / QUADS);
  if (n < N) {
    V v[4];
    for (int q = 0; q < S; q += RB) {
      V t[RB][4];
#pragma unroll
      for (int r = 0; r < RB; ++r)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          t[r][i] = (q + r < S && r0 + i < rows)
                        ? __ldcg(reinterpret_cast<const V*>(
                              ws + ((int64_t)(q + r) * M + row0 + r0 + i) * N + n))
                        : V{};
#pragma unroll
      for (int r = 0; r < RB; ++r)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if (q + r >= S) continue;
          if (q + r == 0) v[i] = t[r][i];
          else add4(v[i], t[r][i]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (r0 + i >= rows) continue;
      typename C::YT* out = y + (int64_t)(row0 + r0 + i) * N + n;
      out[0] = from_f32<typename C::YT>(epi(v[i].x, n));
      out[1] = from_f32<typename C::YT>(epi(v[i].y, n + 1));
      out[2] = from_f32<typename C::YT>(epi(v[i].z, n + 2));
      out[3] = from_f32<typename C::YT>(epi(v[i].w, n + 3));
    }
  }
}

// ---- the kernel body ------------------------------------------------------

// y[row tile, column tile] = epi(sum over s of ws[s]), by the last block of
// the tile to arrive.  Epi: `float operator()(C::AT acc, int n) const`.
template <class C, typename Epi>
__device__ __forceinline__ void gemm_body(const typename C::XT* __restrict__ x,
                                          const typename C::WT* __restrict__ w,
                                          const CUtensorMap* wmap,
                                          typename C::YT* __restrict__ y, typename C::AT* ws,
                                          int* counters, int M, int N, int K, int S,
                                          const Epi& epi) {
  extern __shared__ __align__(16) char skinny_smem[];
  __shared__ int last;
  __shared__ __align__(8) uint64_t bars[C::STAGES];
  char* smem = reinterpret_cast<char*>((reinterpret_cast<uintptr_t>(skinny_smem) + 1023) &
                                       ~uintptr_t(1023));
  const int tid = threadIdx.x;
  const int col0 = blockIdx.x * BN, s = blockIdx.y, row0 = blockIdx.z * BM;
  if constexpr (C::TMA) {
    if (tid == 0) {
      for (int i = 0; i < C::STAGES; ++i) mbar_init(bars + i);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
  }
  int k_begin, k_end;
  slice_bounds<C::BK>(K, S, s, &k_begin, &k_end);
  if constexpr (C::MMA || C::IMMA)
    partial_mma<C>(smem, bars, wmap, x, w, ws, M, N, K, row0, col0, s, k_begin, k_end);
  else
    partial_simt<C>(smem, bars, wmap, x, w, ws, M, N, K, row0, col0, s, k_begin, k_end);

  int* counter = counters + blockIdx.z * gridDim.x + blockIdx.x;
  __threadfence();  // this block's partial is visible before it counts in
  __syncthreads();
  if (tid == 0) last = atomicAdd(counter, 1) == S - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();

  const int rows = M - row0 < BM ? M - row0 : BM;
  if ((N & 3) == 0) {
    finish_tile_vec4<C>(ws, y, M, N, S, row0, col0, rows, tid, epi);
  } else {
    finish_tile<C>(ws, y, M, N, S, row0, col0, rows, tid, epi);
  }
  if (tid == 0) *counter = 0;  // ready for the next launch on this stream
}

constexpr int MAX_DEVICES = 64;

// Set a kernel's dynamic shared-memory limit (which must be raised past
// 48 KB, static shared memory included) on the current device, once per
// device (`raised` is the caller's, one per kernel).
inline cudaError_t allow_smem(const void* kernel, int bytes, bool (&raised)[MAX_DEVICES]) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < MAX_DEVICES && raised[dev]) return cudaSuccess;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e == cudaSuccess && dev < MAX_DEVICES) raised[dev] = true;
  return e;
}

// (column tiles, K slices, row tiles); check shape_ok first.
inline dim3 grid(int M, int N, int S) {
  return dim3((N + BN - 1) / BN, S, (M + BM - 1) / BM);
}

// A 2D tensor map of W [K, N] (row-major, element `dtype`) with a
// BK x box_n box (128-byte swizzled if asked), for the TMA path; false
// where TMA cannot take W (a base or a row stride off 16 bytes, K = 0) or
// the CUDA driver has no encoder.
inline bool encode_w_map(CUtensorMap* map, const void* w, CUtensorMapDataType dtype, int es,
                         int N, int K, int box_n, int BK, bool swizzle) {
  using Encode = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                              const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                              const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                              CUtensorMapL2promotion, CUtensorMapFloatOOBfill);
  static Encode encode = nullptr;
  static bool looked = false;
  if (!looked) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &q) ==
            cudaSuccess && q == cudaDriverEntryPointSuccess)
      encode = reinterpret_cast<Encode>(fn);
    looked = true;
  }
  if (encode == nullptr || K <= 0 || (reinterpret_cast<uintptr_t>(w) & 15) != 0 ||
      ((int64_t)N * es) % 16 != 0)
    return false;
  const cuuint64_t dims[2] = {(cuuint64_t)N, (cuuint64_t)K};
  const cuuint64_t strides[1] = {(cuuint64_t)N * es};
  const cuuint32_t box[2] = {(cuuint32_t)box_n, (cuuint32_t)BK};
  const cuuint32_t elem[2] = {1, 1};
  return encode(map, dtype, 2, const_cast<void*>(w), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE,
                swizzle ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

inline bool shape_ok(int M, int N, int K, int S, const void* ws, const void* counters) {
  return M > 0 && N > 0 && K >= 0 && S >= 1 && S <= 65535 && (M + BM - 1) / BM <= 65535 &&
         ws != nullptr && counters != nullptr;
}

}  // namespace skinny
