// layer_norm_bwd: row LayerNorm backward over the last axis for NVIDIA
// Hopper (sm_90a).
//
// Replaces the TPU kernel deeplearning4j_tpu/ops/norm_kernels.py
// `_ln_bwd_kernel` (reached through `layer_norm_bwd_tpu`), with its
// semantics: x and dy widened to f32, xhat = (x - mean) * rstd from the
// forward's f32 statistics, wdy = dy * gain, c1 = mean(wdy * xhat) and
// c2 = mean(wdy) over the row, dx = (wdy - xhat * c1 - c2) * rstd stored in
// x's dtype; dgain = sum over rows of dy * xhat and dbias = sum over rows of
// dy, in f32, stored in gain's and bias's dtypes.
//
//   x, dy [rows, F] f32 or bf16 (one dtype), rows x_stride / dy_stride
//     elements apart, unit stride in F
//   gain [F] f32 or bf16; mean, rstd [rows] f32 (the forward's)
//   dx [rows, F] contiguous, x's dtype
//   dgain [F] in gain's dtype; dbias [F] in bias's dtype, or null
//   partials [2, nblk, F] f32 scratch
//
// Design.  The forward's mapping: a row is reduced by one warp when F <=
// 1024 and by the whole block of 256 threads above that, so dx never needs
// another block.  Each block owns a contiguous chunk of ceil(rows / nblk)
// rows (nblk = dl4j_layer_norm_bwd_blocks(), which the wrapper calls to
// size the partials: 32 rows a block in warp mode, 8 in block mode, at most
// 1024 blocks) and keeps dgain and dbias for the columns of each thread in
// registers while it walks its rows, where the TPU kernel writes one (8, F)
// partial per 256-row grid step.  In warp mode the 8
// warps' column sums are added in shared memory in warp order, so a
// block's partial [F] is the same on every run; a second kernel sums the
// nblk partials of each column in block order and casts to gain's and
// bias's dtypes (the TPU caller's `dg_part.sum(0)`).  No atomics: the
// result repeats bit for bit.  The row pass reads x and dy twice (the two
// row sums, then dx); the second read hits L1/L2.
//
// Bound.  Bytes: x and dy read once, dx written once, mean and rstd read,
// gain read and dgain/dbias written.  At BERT-base's 8192 x 768 rows that
// is 75.5 MB in f32 (22.5 us at 3.35 TB/s) and 37.8 MB in bf16 (11.3 us);
// the arithmetic (~10 flops an element) is far below the card's rate.  The
// partials add 2 * nblk * F * 4 bytes written and read (1.6 MB at BERT's
// shape).  Known gap, left for a later change: scalar (not 16-byte) loads,
// and the second read of the row.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int WARP_ROW_MAX_F = 1024;  // one warp per row up to this width
constexpr int MAX_F = 8192;
constexpr int MAX_BLOCKS = 1024;
constexpr int SUM_THREADS = 256;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// Sum of v over the TPR threads of a row; every one of them gets the same
// value (the block's warp sums are added in one fixed order).
template <int TPR>
__device__ __forceinline__ float row_sum(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  if (TPR > 32) {
    const int warp = threadIdx.x / 32;
    if (threadIdx.x % 32 == 0) red[warp] = v;
    __syncthreads();
    v = 0.0f;
#pragma unroll
    for (int w = 0; w < TPR / 32; ++w) v += red[w];
    __syncthreads();  // red is reused by the next reduction
  }
  return v;
}

// TPR threads per row: 32 (a warp) or THREADS (the block); each thread
// owns the columns t + TPR * j, j < NC.
template <typename T, typename G, int TPR, int NC>
__global__ void __launch_bounds__(THREADS)
layer_norm_bwd_kernel(const T* __restrict__ x, const G* __restrict__ gain,
                      const float* __restrict__ mean, const float* __restrict__ rstd,
                      const T* __restrict__ dy, T* __restrict__ dx,
                      float* __restrict__ partials, int rows, int F, long long x_stride,
                      long long dy_stride, int nblk) {
  constexpr int GROUPS = THREADS / TPR;  // rows in flight in a block
  __shared__ float red[WARPS];
  __shared__ float colsum[TPR == 32 ? 2 * WARP_ROW_MAX_F : 1];
  const int group = threadIdx.x / TPR;
  const int t = threadIdx.x % TPR;
  const int chunk = (rows + nblk - 1) / nblk;
  const int r0 = blockIdx.x * chunk;
  const int r1 = min(r0 + chunk, rows);

  float dg[NC], db[NC];
#pragma unroll
  for (int j = 0; j < NC; ++j) {
    dg[j] = 0.0f;
    db[j] = 0.0f;
  }
  const float inv_f = 1.0f / (float)F;

  // in block mode (GROUPS == 1) every thread takes the same trip count,
  // as row_sum's barriers need
  for (int row = r0 + group; row < r1; row += GROUPS) {
    const T* xr = x + (int64_t)row * x_stride;
    const T* dyr = dy + (int64_t)row * dy_stride;
    const float mu = mean[row];
    const float rs = rstd[row];
    float s1 = 0.0f, s2 = 0.0f;
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const int c = t + TPR * j;
      if (c < F) {
        const float xh = (to_f32(xr[c]) - mu) * rs;
        const float d = to_f32(dyr[c]);
        const float w = d * to_f32(gain[c]);
        s1 = fmaf(w, xh, s1);
        s2 += w;
        dg[j] = fmaf(d, xh, dg[j]);
        db[j] += d;
      }
    }
    const float c1 = row_sum<TPR>(s1, red) * inv_f;
    const float c2 = row_sum<TPR>(s2, red) * inv_f;
    T* dxr = dx + (int64_t)row * F;
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const int c = t + TPR * j;
      if (c < F) {
        const float xh = (to_f32(xr[c]) - mu) * rs;
        const float w = to_f32(dyr[c]) * to_f32(gain[c]);
        dxr[c] = from_f32<T>((w - xh * c1 - c2) * rs);
      }
    }
  }

  float* pg = partials + (int64_t)blockIdx.x * F;           // [0][blk][:]
  float* pb = partials + ((int64_t)nblk + blockIdx.x) * F;  // [1][blk][:]
  if (TPR == THREADS) {
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const int c = t + TPR * j;
      if (c < F) {
        pg[c] = dg[j];
        pb[c] = db[j];
      }
    }
    return;
  }
  // warp mode: the warps' column sums, added in warp order
  for (int w = 0; w < GROUPS; ++w) {
    if (group == w) {
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        const int c = t + TPR * j;
        if (c < F) {
          colsum[c] = w == 0 ? dg[j] : colsum[c] + dg[j];
          colsum[WARP_ROW_MAX_F + c] = w == 0 ? db[j] : colsum[WARP_ROW_MAX_F + c] + db[j];
        }
      }
    }
    __syncthreads();
  }
  for (int c = threadIdx.x; c < F; c += THREADS) {
    pg[c] = colsum[c];
    pb[c] = colsum[WARP_ROW_MAX_F + c];
  }
}

// out[c] = sum over the nblk partials of column c, in block order, cast to
// f32 (bf16 == 0) or bf16; blockIdx.y picks dgain (0) or dbias (1).
__global__ void __launch_bounds__(SUM_THREADS)
column_sum_kernel(const float* __restrict__ partials, int nblk, int F, void* dgain,
                  int dgain_bf16, void* dbias, int dbias_bf16) {
  const int c = blockIdx.x * SUM_THREADS + threadIdx.x;
  const int which = blockIdx.y;
  void* out = which == 0 ? dgain : dbias;
  if (c >= F || out == nullptr) return;
  const float* p = partials + (int64_t)which * nblk * F + c;
  float s = 0.0f;
#pragma unroll 8
  for (int b = 0; b < nblk; ++b) s += p[(int64_t)b * F];
  if (which == 0 ? dgain_bf16 : dbias_bf16)
    static_cast<__nv_bfloat16*>(out)[c] = __float2bfloat16_rn(s);
  else
    static_cast<float*>(out)[c] = s;
}

template <typename T, typename G>
cudaError_t launch(const void* x, const void* gain, const float* mean, const float* rstd,
                   const void* dy, void* dx, float* partials, int rows, int F,
                   long long x_stride, long long dy_stride, int nblk, cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  const G* gt = static_cast<const G*>(gain);
  const T* dyt = static_cast<const T*>(dy);
  T* dxt = static_cast<T*>(dx);
#define DL4J_LN_BWD(TPR, NC)                                                               \
  layer_norm_bwd_kernel<T, G, TPR, NC><<<(unsigned)nblk, THREADS, 0, stream>>>(             \
      xt, gt, mean, rstd, dyt, dxt, partials, rows, F, x_stride, dy_stride, nblk)
  if (F <= 256)
    DL4J_LN_BWD(32, 8);
  else if (F <= 512)
    DL4J_LN_BWD(32, 16);
  else if (F <= WARP_ROW_MAX_F)
    DL4J_LN_BWD(32, 32);
  else
    DL4J_LN_BWD(THREADS, MAX_F / THREADS);
#undef DL4J_LN_BWD
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The number of blocks (and of partial rows) the kernel takes for `rows`
// rows of width F; the wrapper sizes the partials with it, and
// dl4j_layer_norm_bwd refuses any other nblk.
int dl4j_layer_norm_bwd_blocks(int rows, int F) {
  const int per_block = F <= WARP_ROW_MAX_F ? 32 : 8;
  const int n = (rows + per_block - 1) / per_block;
  return n < 1 ? 1 : (n > MAX_BLOCKS ? MAX_BLOCKS : n);
}

// dtype, gain_dtype, bias_dtype: 0 = f32, 1 = bf16 (bias_dtype is read only
// when dbias is not null).  Returns the first failing launch's cudaError_t
// (0 = success).
int dl4j_layer_norm_bwd(const void* x, const void* gain, const void* mean, const void* rstd,
                        const void* dy, void* dx, void* dgain, void* dbias, void* partials,
                        int rows, int F, long long x_stride, long long dy_stride, int nblk,
                        int dtype, int gain_dtype, int bias_dtype, void* stream) {
  if (rows <= 0 || F <= 0 || F > MAX_F || x_stride < F || dy_stride < F || gain == nullptr ||
      dgain == nullptr || nblk != dl4j_layer_norm_bwd_blocks(rows, F) || (unsigned)dtype > 1u ||
      (unsigned)gain_dtype > 1u || (unsigned)bias_dtype > 1u)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* m = static_cast<const float*>(mean);
  const float* r = static_cast<const float*>(rstd);
  float* part = static_cast<float*>(partials);
  cudaError_t e;
  switch (dtype * 2 + gain_dtype) {
    case 0:
      e = launch<float, float>(x, gain, m, r, dy, dx, part, rows, F, x_stride, dy_stride, nblk, s);
      break;
    case 1:
      e = launch<float, __nv_bfloat16>(x, gain, m, r, dy, dx, part, rows, F, x_stride, dy_stride,
                                       nblk, s);
      break;
    case 2:
      e = launch<__nv_bfloat16, float>(x, gain, m, r, dy, dx, part, rows, F, x_stride, dy_stride,
                                       nblk, s);
      break;
    default:
      e = launch<__nv_bfloat16, __nv_bfloat16>(x, gain, m, r, dy, dx, part, rows, F, x_stride,
                                               dy_stride, nblk, s);
  }
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((unsigned)((F + SUM_THREADS - 1) / SUM_THREADS), dbias == nullptr ? 1u : 2u);
  column_sum_kernel<<<grid, SUM_THREADS, 0, s>>>(part, nblk, F, dgain, gain_dtype, dbias,
                                                  bias_dtype);
  return (int)cudaGetLastError();
}

}  // extern "C"
