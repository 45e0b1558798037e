// fused_dense: y = act(x @ W + b) for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel deeplearning4j_tpu/ops/pallas/matmul.py
// `_matmul_kernel` as reached through `_tiled_matmul` / `fused_dense`:
// a float product accumulated in f32, with the bias add and the activation
// applied in f32 in the epilogue, stored in x's dtype.
//
//   x [M, K] row-major, f32 or bf16
//   W [K, N] row-major, same dtype as x
//   b [N] f32, or null
//   y [M, N] row-major, x's dtype
//
// Design.  A shared-memory tiled SIMT GEMM: each block owns a 64x64 tile of
// y, 256 threads each hold a 4x4 micro-tile of accumulators in registers,
// and the block walks K in steps of 16 inside its own loop.  That loop takes
// the place of the TPU's sequential K grid axis and its VMEM accumulator
// scratch: blocks run in parallel in no order on the card, so nothing may
// carry from one block to the next.  Ragged M, K and N are masked inside the
// kernel (out-of-range loads read 0, out-of-range stores are skipped); the
// TPU's zero padding to (8, 128) multiples has no counterpart here.
//
// Bound at the VGG16 serving shapes (M = bucket <= 16).  The product is
// bytes-bound there: fc6 (K = 25088, N = 4096) must read W once,
// 25088 * 4096 * 4 B = 411 MB in f32, which at 3.35 TB/s is about 123 us;
// fc7 (K = 4096, N = 4096) reads 67 MB, about 20 us.  In bf16 both halve.
// Known gap, left for a later change: with a 64x64 tile a 4096-wide output
// at M <= 16 gives only 64 blocks for 132 SMs, each block's loads are not
// overlapped with its arithmetic, and 3/4 of each A tile is masked rows.
// wgmma, TMA, split-K and a skinny-M tile are the ways out.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 16;
constexpr int TM = 4;
constexpr int TN = 4;
constexpr int THREADS = (BM / TM) * (BN / TN);  // 256

// Activation codes; the Python wrapper holds the same table.
enum Act { ACT_NONE = 0, ACT_RELU = 1, ACT_TANH = 2, ACT_SIGMOID = 3, ACT_GELU = 4 };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <int ACT>
__device__ __forceinline__ float activate(float y) {
  if (ACT == ACT_RELU) return fmaxf(y, 0.0f);
  if (ACT == ACT_TANH) return tanhf(y);
  if (ACT == ACT_SIGMOID) return 1.0f / (1.0f + expf(-y));
  if (ACT == ACT_GELU) return 0.5f * y * (1.0f + erff(y * 0.70710678118654752440f));
  return y;
}

template <typename T, int ACT>
__global__ void __launch_bounds__(THREADS)
fused_dense_kernel(const T* __restrict__ x, const T* __restrict__ w,
                   const float* __restrict__ bias, T* __restrict__ y,
                   int M, int N, int K) {
  // A is kept transposed so the inner loop reads a column of it; the +1
  // pad spreads the transposing stores over the 32 banks.
  __shared__ float As[BK][BM + 1];
  __shared__ float Bs[BK][BN];

  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN);
  const int ty = tid / (BN / TN);
  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * BN;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    // Neighbouring threads load neighbouring addresses of x and of W.
#pragma unroll
    for (int i = 0; i < (BM * BK) / THREADS; ++i) {
      const int idx = tid + i * THREADS;
      const int r = idx / BK, c = idx % BK;
      const int gr = row0 + r, gc = k0 + c;
      As[c][r] = (gr < M && gc < K) ? to_f32(x[(int64_t)gr * K + gc]) : 0.0f;
    }
#pragma unroll
    for (int i = 0; i < (BK * BN) / THREADS; ++i) {
      const int idx = tid + i * THREADS;
      const int r = idx / BN, c = idx % BN;
      const int gr = k0 + r, gc = col0 + c;
      Bs[r][c] = (gr < K && gc < N) ? to_f32(w[(int64_t)gr * N + gc]) : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = As[kk][ty + i * (BM / TM)];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = Bs[kk][tx + j * (BN / TN)];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = row0 + ty + i * (BM / TM);
    if (r >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int c = col0 + tx + j * (BN / TN);
      if (c >= N) continue;
      float v = acc[i][j];
      if (bias != nullptr) v += bias[c];
      y[(int64_t)r * N + c] = from_f32<T>(activate<ACT>(v));
    }
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* w, const float* bias, void* y,
                   int M, int N, int K, int act, cudaStream_t stream) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  const dim3 block(THREADS);
  const T* xt = static_cast<const T*>(x);
  const T* wt = static_cast<const T*>(w);
  T* yt = static_cast<T*>(y);
  switch (act) {
    case ACT_NONE:
      fused_dense_kernel<T, ACT_NONE><<<grid, block, 0, stream>>>(xt, wt, bias, yt, M, N, K);
      break;
    case ACT_RELU:
      fused_dense_kernel<T, ACT_RELU><<<grid, block, 0, stream>>>(xt, wt, bias, yt, M, N, K);
      break;
    case ACT_TANH:
      fused_dense_kernel<T, ACT_TANH><<<grid, block, 0, stream>>>(xt, wt, bias, yt, M, N, K);
      break;
    case ACT_SIGMOID:
      fused_dense_kernel<T, ACT_SIGMOID><<<grid, block, 0, stream>>>(xt, wt, bias, yt, M, N, K);
      break;
    case ACT_GELU:
      fused_dense_kernel<T, ACT_GELU><<<grid, block, 0, stream>>>(xt, wt, bias, yt, M, N, K);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Tile the kernel was compiled for, so the wrapper can refuse any other.
void dl4j_fused_dense_tile(int* bm, int* bn, int* bk) {
  *bm = BM;
  *bn = BN;
  *bk = BK;
}

// dtype: 0 = f32, 1 = bf16.  Returns the launch's cudaError_t (0 = success).
int dl4j_fused_dense(const void* x, const void* w, const void* bias, void* y,
                     int M, int N, int K, int dtype, int act, void* stream) {
  if (M <= 0 || N <= 0 || K < 0 || (M + BM - 1) / BM > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* b = static_cast<const float*>(bias);
  if (dtype == 0) return (int)launch<float>(x, w, b, y, M, N, K, act, s);
  if (dtype == 1) return (int)launch<__nv_bfloat16>(x, w, b, y, M, N, K, act, s);
  return (int)cudaErrorInvalidValue;
}

const char* dl4j_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
