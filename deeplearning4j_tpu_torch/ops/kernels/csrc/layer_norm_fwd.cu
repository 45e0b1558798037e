// layer_norm_fwd: row LayerNorm over the last axis for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel deeplearning4j_tpu/ops/norm_kernels.py
// `_ln_fwd_kernel` (reached through `layer_norm_tpu`), with its semantics:
// x is widened to f32, mean = sum(x) / F, var = mean((x - mean)^2) (the
// centred form, not E[x^2] - mean^2), rstd = 1 / sqrt(var + eps),
// y = (x - mean) * rstd * gain + bias in f32, stored in x's dtype; mean and
// rstd are written per row in f32 for the backward.
//
//   x    [rows, F] f32 or bf16, rows x_stride elements apart, unit stride in F
//   gain [F] f32 or bf16; bias [F] of gain's dtype, or null (zeros)
//   y    [rows, F] contiguous, x's dtype
//   mean, rstd [rows] f32
//
// Design.  A row is reduced by one warp when F <= 1024 (eight rows to a
// block of 256 threads) and by the whole block above that, so a row never
// needs more than one block and nothing crosses blocks.  The TPU kernel's
// (256-row, F) VMEM tiles and its divisibility rules (rows % 256, F % 128)
// have no counterpart: each thread strides over its row, and any rows and
// 1 <= F <= 8192 are taken.  Two passes in f32 over the row (mean, then the
// centred variance), a third writes y; the second and third read the row
// again, from L1/L2 (a BERT row of 768 floats is 3 KB).
//
// Bound.  Bytes: x read once and y written once, gain and bias once, 8
// bytes of statistics a row.  At BERT-base's 8192 x 768 rows that is
// 50 MB in f32 (15 us at 3.35 TB/s) and 25 MB in bf16 (7.5 us); the
// arithmetic (~8 flops an element) is far below the card's rate.  Known
// gap, left for a later change: scalar (not 16-byte) loads, and the re-reads.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARP_ROW_MAX_F = 1024;  // one warp per row up to this width
constexpr int MAX_F = 8192;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// Sum of v over the TPR threads of a row; every one of them gets the same
// value (the block's partial sums are added in one fixed order).
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

// TPR threads per row: 32 (a warp) or THREADS (the block).
template <typename T, typename G, int TPR>
__global__ void __launch_bounds__(THREADS)
layer_norm_fwd_kernel(const T* __restrict__ x, const G* __restrict__ gain,
                      const G* __restrict__ bias, T* __restrict__ y,
                      float* __restrict__ mean_out, float* __restrict__ rstd_out,
                      int rows, int F, long long x_stride, float eps) {
  __shared__ float red[THREADS / 32];
  const int row = blockIdx.x * (THREADS / TPR) + threadIdx.x / TPR;
  const int t = threadIdx.x % TPR;
  // only with TPR == 32, where a whole warp leaves and none of the
  // remaining warps waits on it
  if (row >= rows) return;

  const T* xr = x + (int64_t)row * x_stride;
  float s = 0.0f;
  for (int i = t; i < F; i += TPR) s += to_f32(xr[i]);
  const float mean = row_sum<TPR>(s, red) / (float)F;

  float q = 0.0f;
  for (int i = t; i < F; i += TPR) {
    const float d = to_f32(xr[i]) - mean;
    q = fmaf(d, d, q);
  }
  const float var = row_sum<TPR>(q, red) / (float)F;
  const float rstd = 1.0f / sqrtf(var + eps);

  T* yr = y + (int64_t)row * F;
  for (int i = t; i < F; i += TPR) {
    float v = (to_f32(xr[i]) - mean) * rstd * to_f32(gain[i]);
    if (bias != nullptr) v += to_f32(bias[i]);
    yr[i] = from_f32<T>(v);
  }
  if (t == 0) {
    mean_out[row] = mean;
    rstd_out[row] = rstd;
  }
}

template <typename T, typename G>
cudaError_t launch(const void* x, const void* gain, const void* bias, void* y,
                   float* mean, float* rstd, int rows, int F, long long x_stride,
                   float eps, cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  const G* gt = static_cast<const G*>(gain);
  const G* bt = static_cast<const G*>(bias);
  T* yt = static_cast<T*>(y);
  if (F <= WARP_ROW_MAX_F) {
    constexpr int rows_per_block = THREADS / 32;
    const unsigned blocks = (unsigned)((rows + rows_per_block - 1) / rows_per_block);
    layer_norm_fwd_kernel<T, G, 32><<<blocks, THREADS, 0, stream>>>(
        xt, gt, bt, yt, mean, rstd, rows, F, x_stride, eps);
  } else {
    layer_norm_fwd_kernel<T, G, THREADS><<<(unsigned)rows, THREADS, 0, stream>>>(
        xt, gt, bt, yt, mean, rstd, rows, F, x_stride, eps);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype, gain_dtype: 0 = f32, 1 = bf16.  Returns the launch's cudaError_t
// (0 = success).
int dl4j_layer_norm_fwd(const void* x, const void* gain, const void* bias, void* y,
                        void* mean, void* rstd, int rows, int F, long long x_stride,
                        float eps, int dtype, int gain_dtype, void* stream) {
  if (rows <= 0 || F <= 0 || F > MAX_F || x_stride < F || gain == nullptr ||
      (unsigned)dtype > 1u || (unsigned)gain_dtype > 1u)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* m = static_cast<float*>(mean);
  float* r = static_cast<float*>(rstd);
  const int code = dtype * 2 + gain_dtype;
  switch (code) {
    case 0: return (int)launch<float, float>(x, gain, bias, y, m, r, rows, F, x_stride, eps, s);
    case 1: return (int)launch<float, __nv_bfloat16>(x, gain, bias, y, m, r, rows, F, x_stride, eps, s);
    case 2: return (int)launch<__nv_bfloat16, float>(x, gain, bias, y, m, r, rows, F, x_stride, eps, s);
    case 3:
      return (int)launch<__nv_bfloat16, __nv_bfloat16>(x, gain, bias, y, m, r, rows, F, x_stride, eps, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
