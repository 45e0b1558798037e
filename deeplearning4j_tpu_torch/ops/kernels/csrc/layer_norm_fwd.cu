// layer_norm_fwd: row LayerNorm over the last axis for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel deeplearning4j_tpu/ops/norm_kernels.py:40
// `_ln_fwd_kernel` (pallas_call :95, reached through `layer_norm_tpu` :84),
// with its semantics: x is widened to f32, mean = sum(x) / F,
// var = mean((x - mean)^2) (the centred form, not E[x^2] - mean^2),
// rstd = 1 / sqrt(var + eps), y = (x - mean) * rstd * gain + bias in f32,
// stored in x's dtype; mean and rstd are written per row in f32 for the
// backward.
//
//   x    [rows, F] f32 or bf16, rows x_stride elements apart, unit stride in F
//   gain [F] f32 or bf16; bias [F] of gain's dtype, or null (no bias)
//   y    [rows, F] contiguous, x's dtype
//   mean, rstd [rows] f32
//
// Bound: bytes.  x read once and y written once, gain and bias once, 8
// bytes of statistics a row: at BERT-base's 8192 x 768 rows 50 MB in f32
// (15 us at 3.35 TB/s) and 25 MB in bf16 (7.5 us); the arithmetic (~8 f32
// operations an element) is far below the card's rate.
//
// What the first design lost (0.0266 ms f32, 0.0186 bf16: 0.57 and 0.40
// of the bound): one element per lane a load (a bf16 warp load moved 64
// bytes); three passes over the row (sum, centred variance, y), the second
// and third reading it again from L1/L2; a bias test per element.
//
// Design.
// * Rows.  tpr threads take a row: a warp up to F = 1024 (BERT's 768), 64,
//   128 or 256 threads above (256 threads a block, 256 / tpr rows in flight
//   a block).  Thread t of a row holds the NV 16-byte chunks t + tpr * j of
//   it (8 bf16 or 4 f32 each, layer_norm_common.cuh) in registers: the row
//   is loaded once, the mean comes from xor shuffles (across the row's
//   warps in warp order above 32 threads), the centred variance from the
//   registers, and y goes out in 16-byte stores.  NV is a template
//   argument, the smallest instance that holds the row (bf16 768: 3; f32
//   768: 6).  Where a row is not 16-byte aligned, F is no multiple of the
//   chunk width or a base is off 16 bytes, the same chunks are loaded and
//   stored element by element (VEC = false, one NV instance a dtype).
//   ln_fwd_plan in ops/kernels/layer_norm.py picks tpr, NV and the grid.
// * gain and bias are read once a thread, in their own dtype (16-byte
//   vectors where VEC), and kept in registers across its rows; a kernel
//   without a bias (BIAS = false) has no bias in its inner loop.
// * Rows in flight.  The grid is one wave (ln_fwd_plan: min_blocks blocks
//   an SM, the launch bound below); where the rows exceed it, a row group
//   takes rows in a grid-stride loop and issues the next row's loads before
//   it reduces the current one, so each warp keeps a row in flight while it
//   computes.
// * No atomics: the same call gives the same bits.
#include "layer_norm_common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_F = 8192;

// Blocks an SM the launch bound asks for (so registers are capped at
// 65536 / (256 * that)): x's chunks twice (the row and the next one) and
// gain and bias, 16 * NV registers of data a thread.  ln_fwd_plan mirrors it.
constexpr int min_blocks(int nv) { return nv <= 2 ? 4 : nv <= 6 ? 2 : 1; }

// The NV instance that holds `need` chunks a thread (need <= NV_MAX).
template <typename T> constexpr int nv_max() { return 32 / Chunk<T>::N; }
template <typename T> constexpr int pick_nv(int need) {
  return need <= 4 ? need : need <= 6 ? (nv_max<T>() >= 6 ? 6 : nv_max<T>()) : nv_max<T>();
}

// VW elements of G (gain or bias), the width of one chunk of T, as words
template <typename T, typename G> struct GChunk {
  static constexpr int WORDS = Chunk<T>::N * (int)sizeof(G) / 4;
  uint32_t w[WORDS];
};

template <typename G> __device__ __forceinline__ float g_elem(const uint32_t* w, int e);
template <> __device__ __forceinline__ float g_elem<float>(const uint32_t* w, int e) {
  return __uint_as_float(w[e]);
}
template <> __device__ __forceinline__ float g_elem<__nv_bfloat16>(const uint32_t* w, int e) {
  const uint32_t u = w[e >> 1];
  return __uint_as_float((e & 1) ? (u & 0xffff0000u) : (u << 16));
}

// gain or bias at columns [col, col + VW): 8- or 16-byte loads, or (VEC =
// false) element by element, zero past F
template <typename T, typename G, bool VEC>
__device__ __forceinline__ void load_g(GChunk<T, G>& c, const G* p, int col, int F) {
  constexpr int WORDS = GChunk<T, G>::WORDS, VW = Chunk<T>::N;
#pragma unroll
  for (int i = 0; i < WORDS; ++i) c.w[i] = 0u;
  if (VEC) {
    if (col >= F) return;
    if constexpr (WORDS == 2) {
      const uint2 u = __ldg(reinterpret_cast<const uint2*>(p + col));
      c.w[0] = u.x;
      c.w[1] = u.y;
    } else {
#pragma unroll
      for (int i = 0; i < WORDS; i += 4) {
        const uint4 u = __ldg(reinterpret_cast<const uint4*>(p + col) + i / 4);
        c.w[i] = u.x;
        c.w[i + 1] = u.y;
        c.w[i + 2] = u.z;
        c.w[i + 3] = u.w;
      }
    }
  } else {
#pragma unroll
    for (int e = 0; e < VW; ++e) {
      if (col + e >= F) continue;
      const uint32_t b = load_bits(p + col + e);
      if constexpr (sizeof(G) == 4) c.w[e] = b;
      else c.w[e >> 1] |= (e & 1) ? b << 16 : b;
    }
  }
}

// Sum of v over the row's tpr threads; every one of them gets it.  Above a
// warp the row's warps' sums are added in warp order through red (one of
// two buffers, used in turn, so one barrier a sum keeps them apart).
__device__ __forceinline__ float row_sum(float v, float* red, int tpr, int group) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  if (tpr > 32) {
    if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = v;
    __syncthreads();
    const int w0 = group * (tpr / 32);
    v = 0.0f;
    for (int w = 0; w < tpr / 32; ++w) v += red[w0 + w];
  }
  return v;
}

template <typename T, typename G, int NV, bool VEC, bool BIAS>
__global__ void __launch_bounds__(THREADS, min_blocks(NV))
layer_norm_fwd_kernel(const T* __restrict__ x, const G* __restrict__ gain,
                      const G* __restrict__ bias, T* __restrict__ y,
                      float* __restrict__ mean_out, float* __restrict__ rstd_out, int rows,
                      int F, long long x_stride, float eps, int tpr) {
  constexpr int VW = Chunk<T>::N;
  __shared__ float red[2][WARPS];
  const int groups = THREADS / tpr;
  const int group = threadIdx.x / tpr;
  const int t = threadIdx.x % tpr;

  GChunk<T, G> g[NV], b[NV];
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int col = (t + tpr * j) * VW;
    load_g<T, G, VEC>(g[j], gain, col, F);
    if (BIAS) load_g<T, G, VEC>(b[j], bias, col, F);
  }

  // every thread of the block takes the same trips (the barriers of a
  // multi-warp row need it); a group past the last row computes on zeros
  // and stores nothing
  const int64_t step = (int64_t)gridDim.x * groups;
  int64_t row = (int64_t)blockIdx.x * groups + group;
  uint4 cur[NV];
  {
    const bool live = row < rows;
    const T* xr = x + (live ? row : 0) * x_stride;
#pragma unroll
    for (int j = 0; j < NV; ++j)
      cur[j] = load_chunk<T, VEC>(xr, live ? (t + tpr * j) * VW : F, F);
  }
  for (int64_t base = (int64_t)blockIdx.x * groups; base < rows; base += step, row += step) {
    // the next row's loads go out before this row is reduced
    uint4 nxt[NV];
    const int64_t next = row + step;
    const bool next_live = next < rows;
    const T* xn = x + (next_live ? next : 0) * x_stride;
#pragma unroll
    for (int j = 0; j < NV; ++j)
      nxt[j] = load_chunk<T, VEC>(xn, next_live ? (t + tpr * j) * VW : F, F);

    float s = 0.0f;
#pragma unroll
    for (int j = 0; j < NV; ++j)
#pragma unroll
      for (int e = 0; e < VW; ++e) s += elem<T>(cur[j], e);  // zero past F
    const float mean = row_sum(s, red[0], tpr, group) / (float)F;
    float q = 0.0f;
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int col = (t + tpr * j) * VW;
#pragma unroll
      for (int e = 0; e < VW; ++e) {
        const float d = elem<T>(cur[j], e) - mean;
        if (col + e < F) q = fmaf(d, d, q);
      }
    }
    const float var = row_sum(q, red[1], tpr, group) / (float)F;
    const float rstd = 1.0f / sqrtf(var + eps);

    if (row < rows) {
      T* yr = y + row * F;
#pragma unroll
      for (int j = 0; j < NV; ++j) {
        uint4 o = make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
        for (int e = 0; e < VW; ++e) {
          float v = (elem<T>(cur[j], e) - mean) * rstd * g_elem<G>(g[j].w, e);
          if (BIAS) v += g_elem<G>(b[j].w, e);
          set_elem<T>(o, e, round_bits<T>(v));
        }
        store_chunk<T, VEC>(yr, (t + tpr * j) * VW, F, o);
      }
      if (t == 0) {
        mean_out[row] = mean;
        rstd_out[row] = rstd;
      }
    }
#pragma unroll
    for (int j = 0; j < NV; ++j) cur[j] = nxt[j];
  }
}

template <typename T, typename G>
cudaError_t launch(const void* x, const void* gain, const void* bias, void* y, float* mean,
                   float* rstd, int rows, int F, long long x_stride, float eps, int tpr, int nv,
                   int blocks, cudaStream_t stream) {
  constexpr int VW = Chunk<T>::N;
  constexpr int NV_MAX = nv_max<T>();
  const int need = ((F + VW - 1) / VW + tpr - 1) / tpr;
  if (need > NV_MAX || nv != pick_nv<T>(need)) return cudaErrorInvalidValue;
  const T* xt = static_cast<const T*>(x);
  const G* gt = static_cast<const G*>(gain);
  const G* bt = static_cast<const G*>(bias);
  T* yt = static_cast<T*>(y);
  const bool vec = F % VW == 0 && (x_stride * (long long)sizeof(T)) % 16 == 0 && aligned16(x)
                   && aligned16(y) && aligned16(gain) && (bias == nullptr || aligned16(bias));
#define DL4J_LN_FWD(NV, VEC)                                                               \
  do {                                                                                     \
    if (bias != nullptr)                                                                   \
      layer_norm_fwd_kernel<T, G, NV, VEC, true><<<(unsigned)blocks, THREADS, 0, stream>>>( \
          xt, gt, bt, yt, mean, rstd, rows, F, x_stride, eps, tpr);                        \
    else                                                                                   \
      layer_norm_fwd_kernel<T, G, NV, VEC, false><<<(unsigned)blocks, THREADS, 0, stream>>>( \
          xt, gt, bt, yt, mean, rstd, rows, F, x_stride, eps, tpr);                        \
  } while (0)
  if (!vec)
    DL4J_LN_FWD(NV_MAX, false);
  else if (nv == 1)
    DL4J_LN_FWD(1, true);
  else if (nv == 2)
    DL4J_LN_FWD(2, true);
  else if (nv == 3)
    DL4J_LN_FWD(3, true);
  else if (nv == 4)
    DL4J_LN_FWD(4, true);
  else if (nv == 6)
    DL4J_LN_FWD((NV_MAX >= 6 ? 6 : NV_MAX), true);
  else
    DL4J_LN_FWD(NV_MAX, true);
#undef DL4J_LN_FWD
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype, gain_dtype: 0 = f32, 1 = bf16.  threads_per_row (32, 64, 128 or
// 256), nv (the instance that holds a row) and blocks (at least one, at
// most one a row group) come from ln_fwd_plan.  Returns the launch's
// cudaError_t (0 = success).
int dl4j_layer_norm_fwd(const void* x, const void* gain, const void* bias, void* y,
                        void* mean, void* rstd, int rows, int F, long long x_stride,
                        float eps, int threads_per_row, int nv, int blocks, int dtype,
                        int gain_dtype, void* stream) {
  const int tpr = threads_per_row;
  if (rows <= 0 || F <= 0 || F > MAX_F || x_stride < F || gain == nullptr ||
      (tpr != 32 && tpr != 64 && tpr != 128 && tpr != THREADS) || blocks <= 0 ||
      (long long)blocks > ((long long)rows + THREADS / tpr - 1) / (THREADS / tpr) ||
      (unsigned)dtype > 1u || (unsigned)gain_dtype > 1u)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* m = static_cast<float*>(mean);
  float* r = static_cast<float*>(rstd);
  switch (dtype * 2 + gain_dtype) {
    case 0:
      return (int)launch<float, float>(x, gain, bias, y, m, r, rows, F, x_stride, eps, tpr, nv,
                                       blocks, s);
    case 1:
      return (int)launch<float, __nv_bfloat16>(x, gain, bias, y, m, r, rows, F, x_stride, eps,
                                               tpr, nv, blocks, s);
    case 2:
      return (int)launch<__nv_bfloat16, float>(x, gain, bias, y, m, r, rows, F, x_stride, eps,
                                               tpr, nv, blocks, s);
    default:
      return (int)launch<__nv_bfloat16, __nv_bfloat16>(x, gain, bias, y, m, r, rows, F,
                                                       x_stride, eps, tpr, nv, blocks, s);
  }
}

}  // extern "C"
