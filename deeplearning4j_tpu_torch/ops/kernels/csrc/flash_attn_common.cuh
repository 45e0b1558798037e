// flash_attn_common.cuh: what the flash-attention forward
// (flash_attn_fwd.cu) and backward (flash_attn_bwd.cu) kernels share on
// NVIDIA Hopper (sm_90a): the masking, the shared-memory row pitches, the
// cp.async row loads and the warp-level products on the tensor cores.
//
// A warp owns 16 rows of a product.  bf16: mma.sync.m16n8k16 with f32
// accumulators, fragments by ldmatrix.  f32: 3xTF32 on mma.sync.m16n8k8
// (conv3x3_igemm.cuh's mma_tf32): big = v rounded to TF32, small = v - big,
// and small*big + big*small + big*big, which keeps f32 accuracy.  Fragment
// layouts (PTX ISA, g = lane / 4, t = lane % 4): the m16n8 accumulator holds
// (g, 2t..2t+1) and (g+8, 2t..2t+1), which is the m16n8k16 bf16 A layout,
// so a product's scores go to the next product's A fragments in registers;
// the m16n8k8 tf32 A layout is (g, t), (g+8, t), (g, t+4), (g+8, t+4), so
// in f32 they pass through a per-warp shared-memory buffer.
#pragma once

#include "conv3x3_igemm.cuh"  // mma_tf32, zero; it includes skinny_gemm.cuh

#include <cuda_fp16.h>
#include <math.h>

namespace flash_attn {

using conv_igemm::mma_tf32;
using conv_igemm::zero;
using skinny::allow_smem;
using skinny::cp_async16;
using skinny::cp_async_commit;
using skinny::cp_async_wait;
using skinny::ldmatrix_x4;
using skinny::ldmatrix_x4_trans;
using skinny::MAX_DEVICES;
using skinny::mma_bf16;
using skinny::smem_addr;

constexpr int MAX_D = 128;
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

enum MaskDtype { MASK_NONE = 0, MASK_F32 = 1, MASK_BF16 = 2, MASK_F16 = 3, MASK_F64 = 4 };

struct Strides {
  long long b, h, t;
};

// Rows of element type T and largest head dimension DMAX in shared memory.
template <typename T, int DMAX>
struct Pitch {
  static constexpr bool BF16 = std::is_same<T, __nv_bfloat16>::value;
  static constexpr int VE = 16 / (int)sizeof(T);   // elements a 16-byte chunk
  static constexpr int ROW_CHUNKS = DMAX / VE;
  // row pitch in elements: bf16 (ldmatrix) an odd number of 16-byte units,
  // so the 8 rows of an 8x8 matrix fall in 8 bank groups; f32 (4-byte
  // fragment loads of rows g, columns t) 4 mod 32 words
  static constexpr int LD = DMAX + (BF16 ? 8 : 4);
  static constexpr int NT = DMAX / 8;    // n8 tiles of the head dimension
  static_assert(DMAX % 16 == 0 && (LD * (int)sizeof(T)) % 16 == 0, "16-byte rows");
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// two values rounded to bf16 in one register, `lo` in the low half (the
// lower column of an mma fragment)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The 3xTF32 split of v: big = v rounded to TF32 (10 mantissa bits) to
// nearest, ties away from zero, as cvt.rna.tf32.f32 rounds it
// (conv3x3_igemm.cuh's split_tf32), here by an integer add and mask; small
// = v - big, exact in f32, whose low 13 bits the tensor core drops.  Two
// conversions a value fewer than split_tf32, which made the f32 kernels
// 1.16x to 1.37x slower on an H100 (attn_variants.py).
__device__ __forceinline__ void split_3xtf32(float v, uint32_t& big, uint32_t& small) {
  big = (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
  small = __float_as_uint(v - __uint_as_float(big));
}

// out[0] = a and, where `two`, out[1] = b: one 2-element store where out is
// aligned for it
template <typename T>
__device__ __forceinline__ void store2(T* out, float a, float b, bool two) {
  if (two && (reinterpret_cast<uintptr_t>(out) & (2 * sizeof(T) - 1)) == 0) {
    if constexpr (std::is_same<T, float>::value)
      *reinterpret_cast<float2*>(out) = make_float2(a, b);
    else
      *reinterpret_cast<__nv_bfloat162*>(out) = __floats2bfloat162_rn(a, b);
  } else {
    out[0] = from_f32<T>(a);
    if (two) out[1] = from_f32<T>(b);
  }
}

__device__ __forceinline__ float mask_value(const void* mask, int dtype, long long i) {
  switch (dtype) {
    case MASK_F32: return static_cast<const float*>(mask)[i];
    case MASK_BF16: return __bfloat162float(static_cast<const __nv_bfloat16*>(mask)[i]);
    case MASK_F16: return __half2float(static_cast<const __half*>(mask)[i]);
    default: return (float)static_cast<const double*>(mask)[i];
  }
}

// The bias of key `col` in batch row b: -inf beyond S, else 0 or NEG_INF
// from the keep-mask (P: a kernel's Params, with S, mask_dtype and mask_b).
template <class P>
__device__ __forceinline__ float key_bias_of(const P& p, const void* mask, int b, int col) {
  if (col >= p.S) return -INFINITY;
  if (p.mask_dtype == MASK_NONE) return 0.0f;
  return mask_value(mask, p.mask_dtype, (long long)b * p.mask_b + col) > 0.0f ? 0.0f : NEG_INF;
}

// Rows [t0, t0 + ROWS) of a [n, D] slice (rows `rs` elements apart) into
// dst [ROWS][LD], zero beyond n rows and D columns: 16-byte cp.async
// copies, or element copies where `vec` is false.
template <typename T, int DMAX, int ROWS, int THREADS>
__device__ __forceinline__ void load_rows(T* dst, const T* src, long long rs, int t0, int n,
                                          int D, bool vec, int tid) {
  using C = Pitch<T, DMAX>;
  static_assert((ROWS * C::ROW_CHUNKS) % THREADS == 0, "chunks a thread");
#pragma unroll
  for (int i = 0; i < ROWS * C::ROW_CHUNKS / THREADS; ++i) {
    const int c = tid + i * THREADS;
    const int r = c / C::ROW_CHUNKS, col = (c % C::ROW_CHUNKS) * C::VE;
    const int left = D - col;
    const int valid = t0 + r < n ? (left < C::VE ? (left > 0 ? left : 0) : C::VE) : 0;
    T* d = dst + r * C::LD + col;
    const T* s = src + (int64_t)(t0 + r) * rs + col;
    if (vec) {
      cp_async16(d, valid > 0 ? s : src, valid * (int)sizeof(T));
    } else {
#pragma unroll
      for (int e = 0; e < C::VE; ++e) d[e] = e < valid ? s[e] : zero<T>();
    }
  }
}

// s[16 x 8CT] += A[a0 .. a0 + 16) . B[b0 .. b0 + 8CT)^T and
// t[16 x 8CT] += A2[a0 ..) . B2[b0 ..)^T, over DMAX columns of [*][LD]
// tiles (zero past D), in the m16n8 accumulator layout.  bf16: A by
// ldmatrix, B (its rows are the product's columns) by ldmatrix, the two
// products' loads and mma interleaved.  f32: 3xTF32.  The backward's
// products; the forward keeps its Q fragments in registers and loads the
// same fragments through its own helpers.
template <typename T, int DMAX, int CT>
__device__ __forceinline__ void score_products(float (&s)[CT][4], float (&t)[CT][4], const T* A,
                                               const T* B, const T* A2, const T* B2, int a0,
                                               int b0, int lane) {
  using C = Pitch<T, DMAX>;
  if constexpr (C::BF16) {
    // lane l addresses row l % 8 of 8x8 matrix l / 8
    const int j = lane >> 3, r = lane & 7;
#pragma unroll
    for (int k16 = 0; k16 < DMAX; k16 += 16) {
      uint32_t a[4], a2[4];
      const int aoff = (a0 + (j & 1) * 8 + r) * C::LD + k16 + (j >> 1) * 8;
      ldmatrix_x4(a, A + aoff);
      ldmatrix_x4(a2, A2 + aoff);
#pragma unroll
      for (int np = 0; np < CT / 2; ++np) {
        uint32_t b[4], b2[4];
        const int boff = (b0 + np * 16 + (j >> 1) * 8 + r) * C::LD + k16 + (j & 1) * 8;
        ldmatrix_x4(b, B + boff);
        ldmatrix_x4(b2, B2 + boff);
        mma_bf16(s[2 * np], a, b[0], b[1]);
        mma_bf16(s[2 * np + 1], a, b[2], b[3]);
        mma_bf16(t[2 * np], a2, b2[0], b2[1]);
        mma_bf16(t[2 * np + 1], a2, b2[2], b2[3]);
      }
    }
  } else {
    const int g = lane >> 2, tq = lane & 3;
#pragma unroll 2
    for (int k8 = 0; k8 < DMAX; k8 += 8) {
      uint32_t ab[4], as[4], a2b[4], a2s[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int off = (a0 + g + (e & 1) * 8) * C::LD + k8 + tq + (e >> 1) * 4;
        split_3xtf32(A[off], ab[e], as[e]);
        split_3xtf32(A2[off], a2b[e], a2s[e]);
      }
#pragma unroll
      for (int nt = 0; nt < CT; ++nt) {
        uint32_t bb[2], bs[2], b2b[2], b2s[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int off = (b0 + nt * 8 + g) * C::LD + k8 + tq + e * 4;
          split_3xtf32(B[off], bb[e], bs[e]);
          split_3xtf32(B2[off], b2b[e], b2s[e]);
        }
        // small*big, big*small, big*big
        mma_tf32(s[nt], as, bb);
        mma_tf32(t[nt], a2s, b2b);
        mma_tf32(s[nt], ab, bs);
        mma_tf32(t[nt], a2b, b2s);
        mma_tf32(s[nt], ab, bb);
        mma_tf32(t[nt], a2b, b2b);
      }
    }
  }
}

// acc[16 x DMAX] += a[16 x 8CT] . X[x0 .. x0 + 8CT)[0 .. DMAX), with a in
// the m16n8 accumulator layout and X a [*][LD] tile.  bf16: a rounded to
// bf16 straight into A fragments, X by ldmatrix.trans.  f32: a through the
// warp's [16][8CT + 4] buffer into the A layout, 3xTF32, the products in a
// fresh accumulator added to acc in f32 (the tensor cores' accumulation
// drops low bits).
template <typename T, int DMAX, int CT>
__device__ __forceinline__ void output_product(float (&acc)[DMAX / 8][4], const float (&a)[CT][4],
                                               const T* X, int x0, float* buf, int lane) {
  using C = Pitch<T, DMAX>;
  if constexpr (C::BF16) {
    const int j = lane >> 3, r = lane & 7;
#pragma unroll
    for (int kk = 0; kk < CT / 2; ++kk) {
      const uint32_t af[4] = {pack_bf16(a[2 * kk][0], a[2 * kk][1]),
                              pack_bf16(a[2 * kk][2], a[2 * kk][3]),
                              pack_bf16(a[2 * kk + 1][0], a[2 * kk + 1][1]),
                              pack_bf16(a[2 * kk + 1][2], a[2 * kk + 1][3])};
#pragma unroll
      for (int np = 0; np < DMAX / 16; ++np) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, X + (x0 + kk * 16 + (j & 1) * 8 + r) * C::LD + np * 16 + (j >> 1) * 8);
        mma_bf16(acc[2 * np], af, b[0], b[1]);
        mma_bf16(acc[2 * np + 1], af, b[2], b[3]);
      }
    }
  } else {
    constexpr int LDC = 8 * CT + 4;  // 4 mod 32 words: a (g, t) load in 32 banks
    const int g = lane >> 2, tq = lane & 3;
#pragma unroll
    for (int nt = 0; nt < CT; ++nt) {
      *reinterpret_cast<float2*>(buf + g * LDC + nt * 8 + 2 * tq) = make_float2(a[nt][0], a[nt][1]);
      *reinterpret_cast<float2*>(buf + (g + 8) * LDC + nt * 8 + 2 * tq) =
          make_float2(a[nt][2], a[nt][3]);
    }
    __syncwarp();
    uint32_t ab[CT][4], as[CT][4];
#pragma unroll
    for (int kk = 0; kk < CT; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        split_3xtf32(buf[(g + (e & 1) * 8) * LDC + kk * 8 + tq + (e >> 1) * 4], ab[kk][e],
                     as[kk][e]);
    __syncwarp();  // the buffer is free for the next chunk
#pragma unroll
    for (int nt = 0; nt < C::NT; ++nt) {
      float part[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int kk = 0; kk < CT; ++kk) {
        uint32_t bb[2], bs[2];
#pragma unroll
        for (int e = 0; e < 2; ++e)
          split_3xtf32(X[(x0 + kk * 8 + tq + e * 4) * C::LD + nt * 8 + g], bb[e], bs[e]);
        mma_tf32(part, as[kk], bb);
        mma_tf32(part, ab[kk], bs);
        mma_tf32(part, ab[kk], bb);
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[nt][c] += part[c];
    }
  }
}

// A 16-byte aligned base, and (b, h, t) strides of 16 bytes where the
// dimension has more than one index.
inline bool aligned16(const void* base, const Strides& s, int nb, int nh, int nt, int es) {
  auto ok = [es](long long stride, int n) { return n <= 1 || (stride * es) % 16 == 0; };
  return (reinterpret_cast<uintptr_t>(base) & 15) == 0 && ok(s.b, nb) && ok(s.h, nh) &&
         ok(s.t, nt);
}

}  // namespace flash_attn
