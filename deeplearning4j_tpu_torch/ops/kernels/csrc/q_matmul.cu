// q_matmul: y = (x @ f(Wq)) * scale + b, weight-only int8, for NVIDIA
// Hopper (sm_90a).
//
// Replaces the TPU kernel deeplearning4j_tpu/ops/pallas/matmul.py
// `_matmul_kernel` as reached through `q_matmul`: the int8 weights widen to
// the compute dtype one K block at a time on chip (no dequantized copy of W
// in device memory), the product accumulates in f32, and the epilogue
// applies the per-output-channel scale and then the bias in f32 before one
// cast to the compute dtype.
//
//   x     [M, K] row-major, f32 or bf16 (already the compute dtype)
//   Wq    [K, N] row-major int8
//   scale [N] f32
//   b     [N] f32, or null
//   y     [M, N] row-major, x's dtype
//
// Design.  fused_dense.cu's shared-memory tiled SIMT GEMM: a block owns a
// 64x64 tile of y, 256 threads each hold a 4x4 micro-tile of f32
// accumulators, and the block walks K in steps of 16.  The int8 W tile is
// widened to f32 as it is stored to shared memory; int8 -> bf16 -> f32 is
// exact, so this equals the TPU kernel's widening to the compute dtype.
// Ragged M, K and N are masked in the kernel (loads past an edge read 0,
// stores past it are skipped).  The epilogue uses __fmul_rn / __fadd_rn so
// that nvcc cannot contract it into one FMA: scale, then bias, each
// rounded, as the JAX package's `dequant_epilogue`.
//
// Bound at the VGG16 serving shapes (M = bucket <= 16): bytes.  fc6 must
// read the int8 W once, 25088 * 4096 B = 102.8 MB, about 31 us at
// 3.35 TB/s; fc7 16.8 MB, 5 us.  Known gap, left for a later change: with
// a 64-row tile at M <= 16 three quarters of each A tile is masked rows, a
// 4096-wide output gives only 64 blocks for 132 SMs, and the byte loads of
// W are neither vectorised nor overlapped with the arithmetic.  A skinny-M
// split-K tiling with 16-byte loads (or int8 tensor-core paths) is the way
// out.
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

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
q_matmul_kernel(const T* __restrict__ x, const int8_t* __restrict__ w,
                const float* __restrict__ scale, const float* __restrict__ bias,
                T* __restrict__ y, int M, int N, int K) {
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
      Bs[r][c] = (gr < K && gc < N) ? static_cast<float>(w[(int64_t)gr * N + gc]) : 0.0f;
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
      float v = __fmul_rn(acc[i][j], scale[c]);
      if (bias != nullptr) v = __fadd_rn(v, bias[c]);
      y[(int64_t)r * N + c] = from_f32<T>(v);
    }
  }
}

template <typename T>
cudaError_t launch(const void* x, const int8_t* w, const float* scale,
                   const float* bias, void* y, int M, int N, int K,
                   cudaStream_t stream) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  q_matmul_kernel<T><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(x), w, scale, bias, static_cast<T*>(y), M, N, K);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Tile the kernel was compiled for, so the wrapper can refuse any other.
void dl4j_q_matmul_tile(int* bm, int* bn, int* bk) {
  *bm = BM;
  *bn = BN;
  *bk = BK;
}

// dtype (of x and y): 0 = f32, 1 = bf16.  Returns the launch's cudaError_t.
int dl4j_q_matmul(const void* x, const void* w, const void* scale,
                  const void* bias, void* y, int M, int N, int K, int dtype,
                  void* stream) {
  if (M <= 0 || N <= 0 || K < 0 || (M + BM - 1) / BM > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int8_t* wq = static_cast<const int8_t*>(w);
  const float* sc = static_cast<const float*>(scale);
  const float* b = static_cast<const float*>(bias);
  if (dtype == 0) return (int)launch<float>(x, wq, sc, b, y, M, N, K, s);
  if (dtype == 1) return (int)launch<__nv_bfloat16>(x, wq, sc, b, y, M, N, K, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
