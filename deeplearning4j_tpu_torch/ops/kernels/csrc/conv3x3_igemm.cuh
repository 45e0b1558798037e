// conv3x3_igemm.cuh: the tensor-core implicit GEMM that conv3x3_wgrad.cu
// and conv3x3_dgrad.cu share, for NVIDIA Hopper (sm_90a).
//
// Both backward products of a 3x3 stride-1 SAME NHWC conv are nine shifted
// products summed over one reduction (deeplearning4j_tpu/ops/
// conv_kernels.py `_wgrad_kernel` and `_dgrad_kernel`):
//
//   dgrad: dx[p, ci] = sum over tap, co of dy[p + shift(tap), co] * Wp[tap, co, ci]
//          M = B*H*W positions, N = Ci, the reduction tap-major over 9 * Co
//   wgrad: dW[co, ci, tap] = sum over p of x[p + shift(tap), ci] * dy[p, co]
//          per tap: M = Ci, N = Co, the reduction over the B*H*W positions
//
// where shift(i, j) moves a position by (i - 1) rows and (j - 1) columns and
// a shifted position outside the image reads zero.  This header holds the
// machinery; each .cu file holds its operand loads, its __global__ kernel
// (so the profiler names them apart), its output store and its extern "C"
// entry.
//
// What the first design (SIMT f32 FMA, 4x4 micro-tiles, synchronous
// scalar loads, bf16 widened to f32 on load) lost: in bf16 it ran 17x to
// 22x (wgrad) and 3x to 13x (dgrad) cuDNN's time, because the tensor cores
// sat idle; in f32 1.5x to 4x, at 0.8 to 1.1 ms against a 0.221 ms SIMT
// bound, because no load was in flight while a block computed and dgrad
// read W with a stride of 9 elements.
//
// What this design does about it:
//
// * One 64 x 64 output tile a block of 128 threads (4 warps, 2 x 2, a
//   32 x 32 warp tile: 2 x 4 mma tiles of 16 x 8), the reduction in steps
//   of BK = 32 (one tap, 32 channels, for dgrad; 32 positions for wgrad).
// * Operands by cp.async in 16-byte chunks of channels (8 bf16 or 4 f32)
//   into a ring of STAGES shared-memory stages, STAGES - 1 in flight while
//   the block computes on the oldest.  A thread copies chunks of one row of
//   each activation tile, so it decodes one position's image row and column
//   (where a tap's shift lands) a step, not one per chunk.  A shifted row that falls outside
//   the image, a row past the block's positions and a channel chunk past
//   the channel count are zero-fill copies (src-size 0), not branches
//   around the copy.  Where a channel count is not a multiple of 16 bytes
//   (VGG16's first conv, Ci = 3; odd channel counts) or a base pointer is
//   off 16 bytes, the same loops copy element by element with plain loads
//   (the VEC = false instances): slower, and only at such shapes.
// * bf16: mma.sync.m16n8k16 bf16 with f32 accumulators.  bf16 x bf16
//   products are exact in f32, as in the TPU kernel, which widens to f32
//   before its dot.  Operands are fed by ldmatrix: a K-contiguous A tile
//   (dgrad's dy rows) plainly, an M-contiguous one (wgrad's x rows) and
//   every B tile (N-contiguous) through .trans.
// * f32: 3xTF32 on mma.sync.m16n8k8 tf32.  Each operand value v splits into
//   big = cvt.rna.tf32(v) and small = cvt.rna.tf32(v - big); the product
//   accumulates small*big + big*small + big*big, in that order, which keeps
//   about 22 bits of each product: f32 accuracy (one TF32 product alone
//   keeps 11).  Each stage's products sum in a fresh accumulator that is
//   then added to the running sum in f32, since the tensor cores' own
//   accumulation drops low bits.  Fragments are read from shared memory
//   with 4-byte loads whose row pitches put the 32 lanes of a load in 32
//   banks.
// * Split reduction with a fixed-order sum.  Where the output tiles alone
//   are too few for the card (wgrad: 9 tiles at 56x56x64), the wrapper's
//   plan (ops/kernels/conv3x3.py `conv_plan`) splits the reduction steps
//   into S slices, [s*steps/S, (s+1)*steps/S) (`slice_bounds`); each block
//   stores its f32 partial tile to a workspace [S, tiles, 64 * 64] and the
//   last block of a tile to arrive (integer arrival counter after
//   __threadfence) sums the S partials in the order s = 0..S-1, stores the
//   output and resets the counter.  No float atomics: two calls give the
//   same bits.  S = 1 stores straight from the accumulators.
//
// Bound on an H100 SXM (989 TFLOP/s bf16 and 495 TF32 dense, 67 f32 SIMT,
// 3.35 TB/s): 2 * 9 * Ci * Co * B*H*W = 14.8 GFLOP at every ResNet-50 body
// shape at batch 64.  bf16: 0.015 ms of operations, 0.015 to 0.023 ms of
// bytes (x or dy in, the f32 output out).  f32 on this route: 3 x 14.8
// GFLOP at the TF32 rate, 0.090 ms (the f32 SIMT rate would give 0.221).
// What stays out of reach here: wgmma and TMA (64-row warpgroup tiles, no
// register-file operand traffic), and reuse of one dy / x tile across the
// nine taps (the shifted reloads are served by L2).
#pragma once

#include "skinny_gemm.cuh"

namespace conv_igemm {

using skinny::allow_smem;
using skinny::cp_async16;
using skinny::cp_async_commit;
using skinny::cp_async_wait;
using skinny::ldmatrix_x4;
using skinny::ldmatrix_x4_trans;
using skinny::MAX_DEVICES;
using skinny::mma_bf16;

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 32;
constexpr int THREADS = 128;
constexpr int WARPS_M = 2;
constexpr int WM = BM / WARPS_M;                    // 32 rows a warp
constexpr int WN = BN / (THREADS / 32 / WARPS_M);   // 32 columns a warp
constexpr int MT = WM / 16;                         // m16 tiles a warp
constexpr int NT = WN / 8;                          // n8 tiles a warp
constexpr int TILE = BM * BN;

// One instantiation: element type T and the layout of the A tile in shared
// memory, [BM][LDA] with k contiguous (A_KC: dgrad) or [BK][LDA] with m
// contiguous (wgrad); B is always [BK][LDB], n contiguous.
template <typename T, bool A_KC_>
struct Cfg {
  static constexpr bool A_KC = A_KC_;
  static constexpr bool BF16 = std::is_same<T, __nv_bfloat16>::value;
  static constexpr int VE = 16 / (int)sizeof(T);    // elements a 16-byte chunk
  // bf16 (ldmatrix): a row pitch of an odd number of 16-byte units puts the
  // 8 rows of an 8x8 matrix in 8 bank groups.  f32 (4-byte fragment loads):
  // a pitch of 4 mod 32 words for A [m][k] (lanes read rows g, columns t),
  // 8 mod 32 for [k][m] and [k][n] (rows t, columns g).
  static constexpr int LDA = A_KC ? BK + (BF16 ? 8 : 4) : BM + 8;
  static constexpr int LDB = BN + 8;
  static constexpr int A_ELEMS = (A_KC ? BM : BK) * LDA;
  static constexpr int B_ELEMS = BK * LDB;
  static constexpr int STAGES = BF16 ? 4 : 3;
  static constexpr int STAGE_BYTES = (A_ELEMS + B_ELEMS) * (int)sizeof(T);
  static constexpr int SMEM_BYTES = STAGES * STAGE_BYTES;
  static_assert(STAGE_BYTES % 16 == 0 && (A_ELEMS * (int)sizeof(T)) % 16 == 0, "16-byte rows");
  static_assert((LDA * (int)sizeof(T)) % 16 == 0 && (LDB * (int)sizeof(T)) % 16 == 0, "pitch");
};

template <typename T> __device__ __forceinline__ T zero();
template <> __device__ __forceinline__ float zero<float>() { return 0.0f; }
template <> __device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() {
  return __ushort_as_bfloat16((unsigned short)0);
}

// One chunk of VE elements of a row: a 16-byte cp.async (zero-filled where
// `ok` is false) or, for VEC = false, element copies of which those at
// index `valid` and beyond read zero.  `base` is any valid address of the
// array, read by no copy (src-size 0).
template <bool VEC, typename T>
__device__ __forceinline__ void copy_chunk(T* dst, const T* src, const T* base, bool ok,
                                           int valid) {
  constexpr int VE = 16 / (int)sizeof(T);
  if constexpr (VEC) {
    cp_async16(dst, ok ? src : base, ok ? 16 : 0);
  } else {
#pragma unroll
    for (int e = 0; e < VE; ++e) dst[e] = (ok && e < valid) ? src[e] : zero<T>();
  }
}

// Reduction steps [k_begin, k_end) of slice s of S:
// [s*steps/S, (s+1)*steps/S) in integer division; `conv_plan` computes the
// same bounds.
__device__ __forceinline__ void slice_bounds(int steps, int S, int s, int* k_begin, int* k_end) {
  *k_begin = (int)((int64_t)s * steps / S);
  *k_end = (int)((int64_t)(s + 1) * steps / S);
}

// The ring over `nsteps` reduction steps: load(stage, i) issues step i's
// copies, compute(stage) consumes a stage; step i + STAGES - 1 is copied in
// while step i is computed.
template <class C, typename Load, typename Compute>
__device__ __forceinline__ void pipeline(char* smem, int nsteps, Load&& load, Compute&& compute) {
#pragma unroll
  for (int st = 0; st < C::STAGES - 1; ++st) {
    if (st < nsteps) load(smem + st * C::STAGE_BYTES, st);
    cp_async_commit();
  }
  for (int step = 0; step < nsteps; ++step) {
    cp_async_wait<C::STAGES - 2>();
    __syncthreads();  // stage `step` landed; every thread left stage step - 1
    const int next = step + C::STAGES - 1;
    if (next < nsteps) load(smem + (next % C::STAGES) * C::STAGE_BYTES, next);
    cp_async_commit();
    compute(smem + (step % C::STAGES) * C::STAGE_BYTES);
  }
  cp_async_wait<0>();
  __syncthreads();
}

// ---- f32: 3xTF32 -----------------------------------------------------------

__device__ __forceinline__ void split_tf32(float v, uint32_t& big, uint32_t& small) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(big) : "f"(v));
  const float rest = v - __uint_as_float(big);
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(small) : "f"(rest));
}

// not volatile: the compiler may interleave independent products; each
// accumulator's own products keep their order through its operands
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// ---- one stage of the product ---------------------------------------------

// The warp's [WM, WN] sum over the stage's BK reduction rows; the warp's tile
// starts at row wm0, column wn0 of the block's.  Fragment layouts (PTX ISA,
// g = lane / 4, t = lane % 4): m16n8k16 bf16 A a0..a3 = (g, 2t..2t+1),
// (g+8, 2t..), (g, 2t+8..), (g+8, 2t+8..), B b0, b1 = (2t..2t+1, g),
// (2t+8.., g); m16n8k8 tf32 A = (g, t), (g+8, t), (g, t+4), (g+8, t+4),
// B = (t, g), (t+4, g); C c0..c3 = (g, 2t), (g, 2t+1), (g+8, 2t),
// (g+8, 2t+1) in both.
template <class C>
__device__ __forceinline__ void mma_stage(const char* stage, float (&acc)[MT][NT][4], int wm0,
                                          int wn0, int lane) {
  if constexpr (C::BF16) {
    const auto* As = reinterpret_cast<const __nv_bfloat16*>(stage);
    const auto* Bs = As + C::A_ELEMS;
    // lane l addresses row l % 8 of 8x8 matrix l / 8
    const int j = lane >> 3, r = lane & 7;
#pragma unroll
    for (int k16 = 0; k16 < BK; k16 += 16) {
      uint32_t a[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const int m = wm0 + mt * 16 + (j & 1) * 8, k = k16 + (j >> 1) * 8;
        if constexpr (C::A_KC)
          ldmatrix_x4(a[mt], As + (m + r) * C::LDA + k);
        else
          ldmatrix_x4_trans(a[mt], As + (k + r) * C::LDA + m);
      }
#pragma unroll
      for (int p = 0; p < NT / 2; ++p) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, Bs + (k16 + (j & 1) * 8 + r) * C::LDB + wn0 + p * 16 + (j >> 1) * 8);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma_bf16(acc[mt][2 * p], a[mt], b[0], b[1]);
          mma_bf16(acc[mt][2 * p + 1], a[mt], b[2], b[3]);
        }
      }
    }
  } else {
    const auto* As = reinterpret_cast<const float*>(stage);
    const auto* Bs = As + C::A_ELEMS;
    const int g = lane >> 2, t = lane & 3;
    // the stage's sum in a fresh accumulator, added to the running sum with
    // an f32 add: the tensor cores' accumulation drops low bits, and 3xTF32
    // accumulates three times per k8 step, so one chain over a long slice
    // of the reduction loses more than f32 accuracy allows
    float part[MT][NT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int c = 0; c < 4; ++c) part[mt][nt][c] = 0.0f;
#pragma unroll
    for (int k8 = 0; k8 < BK; k8 += 8) {
      uint32_t ab[MT][4], as[MT][4], bb[NT][2], bs[NT][2];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int m = wm0 + mt * 16 + g + (q & 1) * 8, k = k8 + t + (q >> 1) * 4;
          split_tf32(C::A_KC ? As[m * C::LDA + k] : As[k * C::LDA + m], ab[mt][q], as[mt][q]);
        }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int q = 0; q < 2; ++q)
          split_tf32(Bs[(k8 + t + q * 4) * C::LDB + wn0 + nt * 8 + g], bb[nt][q], bs[nt][q]);
      // small*big, then big*small, then big*big into every accumulator: the
      // MT * NT products of one pass are independent of each other
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) mma_tf32(part[mt][nt], as[mt], bb[nt]);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) mma_tf32(part[mt][nt], ab[mt], bs[nt]);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) mma_tf32(part[mt][nt], ab[mt], bb[nt]);
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[mt][nt][c] += part[mt][nt][c];
  }
}

// ---- the output ------------------------------------------------------------

// The block's sum over its slice s of S, in acc, for output tile `tile` of
// `tiles` (rows m0.., columns n0.. of the [M, N] product): stored by
// store(m, n, v) straight away when S == 1, else through the workspace and
// the last block of the tile to arrive, which sums the S partials in slice
// order.  Store: `void operator()(int m, int n, float v) const`.
template <typename Store>
__device__ __forceinline__ void finish(const float (&acc)[MT][NT][4], float* ws, int* counters,
                                       int tile, int tiles, int S, int s, int M, int N, int m0,
                                       int n0, int wm0, int wn0, const Store& store) {
  const int tid = threadIdx.x, lane = tid & 31;
  const int g = lane >> 2, t2 = 2 * (lane & 3);
  if (S == 1) {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = m0 + wm0 + mt * 16 + g + 8 * h, n = n0 + wn0 + nt * 8 + t2;
          if (m >= M) continue;
          if (n < N) store(m, n, acc[mt][nt][2 * h]);
          if (n + 1 < N) store(m, n + 1, acc[mt][nt][2 * h + 1]);
        }
    return;
  }
  float* part = ws + ((int64_t)s * tiles + tile) * TILE;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<float2*>(part + (wm0 + mt * 16 + g + 8 * h) * BN + wn0 + nt * 8 + t2) =
            make_float2(acc[mt][nt][2 * h], acc[mt][nt][2 * h + 1]);

  __shared__ int last;
  __threadfence();  // this block's partial is visible before it counts in
  __syncthreads();
  if (tid == 0) last = atomicAdd(counters + tile, 1) == S - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();

  // 16-byte loads past L1, 8 a thread in flight, summed in slice order
  constexpr int Q = TILE / 4 / THREADS;
  float4 v[Q];
  for (int q = 0; q < S; ++q) {
    const float4* p = reinterpret_cast<const float4*>(ws + ((int64_t)q * tiles + tile) * TILE);
#pragma unroll
    for (int i = 0; i < Q; ++i) {
      const float4 u = __ldcg(p + tid + i * THREADS);
      if (q == 0) {
        v[i] = u;
      } else {
        v[i].x += u.x; v[i].y += u.y; v[i].z += u.z; v[i].w += u.w;
      }
    }
  }
#pragma unroll
  for (int i = 0; i < Q; ++i) {
    const int e = 4 * (tid + i * THREADS);
    const int m = m0 + e / BN, n = n0 + e % BN;
    if (m >= M) continue;
    const float vals[4] = {v[i].x, v[i].y, v[i].z, v[i].w};
#pragma unroll
    for (int c = 0; c < 4; ++c)
      if (n + c < N) store(m, n + c, vals[c]);
  }
  if (tid == 0) counters[tile] = 0;  // ready for the next launch on this stream
}

}  // namespace conv_igemm
