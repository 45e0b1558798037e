// int8_matmul: y = f32(xq @ Wq) * scale + b, int8 x int8 with an int32
// accumulator, for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel deeplearning4j_tpu/ops/pallas/matmul.py
// `_matmul_kernel` as reached through `int8_matmul` (static activation
// quantization): the int8 x int8 -> int32 contraction over every K block,
// then the dequant epilogue (`quant_kernels.dequant_epilogue`) on the
// combined per-channel scale x_scale * w_scale, which the wrapper computes
// once in f32, as the JAX package's `_combined_scale` does.
//
//   xq    [M, K] row-major int8
//   Wq    [K, N] row-major int8
//   scale [N] f32 (x_scale * w_scale, already rounded to f32)
//   b     [N] f32, or null
//   y     [M, N] row-major, f32 or bf16
//
// Bitwise contract.  An int32 sum of int8 products is exact in any order
// (the wrapper refuses K above (2^31 - 1) / 127^2 = 133,144; VGG16's fc6
// has K = 25088, |acc| <= 404.6 M), and the epilogue is two correctly
// rounded f32 operations, __fmul_rn then __fadd_rn, which nvcc may not
// contract into an FMA, so y equals the plain version's
// `f32(acc) * scale + b` to the bit under any tiling.
//
// Design.  The 64x64 output tile and 4x4 micro-tiles of fused_dense.cu,
// with int32 accumulators and __dp4a (four int8 products and their sum per
// instruction).  A K step of 32: the x tile is stored K-contiguous per row
// and the W tile transposed, K-contiguous per column, so each thread reads
// four consecutive K values of a row or a column as one 32-bit word.  K is
// zero-padded in shared memory (loads past K read 0, never past the end of
// the arrays), as are ragged M and N.
//
// Bound at the VGG16 serving shapes (M <= 16): bytes.  fc6 reads the int8 W
// once, 102.8 MB, about 31 us at 3.35 TB/s.  Known gap, left for a later
// change: the same skinny-M waste as q_matmul.cu, byte-wide global loads,
// and no int8 tensor-core (mma.sync s8 / wgmma) path.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 32;
constexpr int TM = 4;
constexpr int TN = 4;
constexpr int THREADS = (BM / TM) * (BN / TN);  // 256

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
int8_matmul_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                   const float* __restrict__ scale, const float* __restrict__ bias,
                   T* __restrict__ y, int M, int N, int K) {
  __shared__ __align__(16) int8_t As[BM][BK];  // [row][k]
  __shared__ __align__(16) int8_t Bs[BN][BK];  // [col][k]: W transposed

  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN);
  const int ty = tid / (BN / TN);
  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * BN;

  int acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0;

  for (int k0 = 0; k0 < K; k0 += BK) {
    // Neighbouring threads load neighbouring addresses of x and of W.
#pragma unroll
    for (int i = 0; i < (BM * BK) / THREADS; ++i) {
      const int idx = tid + i * THREADS;
      const int r = idx / BK, c = idx % BK;
      const int gr = row0 + r, gc = k0 + c;
      As[r][c] = (gr < M && gc < K) ? x[(int64_t)gr * K + gc] : int8_t(0);
    }
#pragma unroll
    for (int i = 0; i < (BK * BN) / THREADS; ++i) {
      const int idx = tid + i * THREADS;
      const int r = idx / BN, c = idx % BN;
      const int gr = k0 + r, gc = col0 + c;
      Bs[c][r] = (gr < K && gc < N) ? w[(int64_t)gr * N + gc] : int8_t(0);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 4) {
      int a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i)
        a[i] = *reinterpret_cast<const int*>(&As[ty + i * (BM / TM)][kk]);
#pragma unroll
      for (int j = 0; j < TN; ++j)
        b[j] = *reinterpret_cast<const int*>(&Bs[tx + j * (BN / TN)][kk]);
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = __dp4a(a[i], b[j], acc[i][j]);
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
      float v = __fmul_rn(__int2float_rn(acc[i][j]), scale[c]);
      if (bias != nullptr) v = __fadd_rn(v, bias[c]);
      y[(int64_t)r * N + c] = from_f32<T>(v);
    }
  }
}

template <typename T>
cudaError_t launch(const int8_t* x, const int8_t* w, const float* scale,
                   const float* bias, void* y, int M, int N, int K,
                   cudaStream_t stream) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  int8_matmul_kernel<T><<<grid, THREADS, 0, stream>>>(
      x, w, scale, bias, static_cast<T*>(y), M, N, K);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Tile the kernel was compiled for, so the wrapper can refuse any other.
void dl4j_int8_matmul_tile(int* bm, int* bn, int* bk) {
  *bm = BM;
  *bn = BN;
  *bk = BK;
}

// out_dtype: 0 = f32, 1 = bf16.  Returns the launch's cudaError_t.
int dl4j_int8_matmul(const void* x, const void* w, const void* scale,
                     const void* bias, void* y, int M, int N, int K,
                     int out_dtype, void* stream) {
  if (M <= 0 || N <= 0 || K < 0 || K > 133144 || (M + BM - 1) / BM > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int8_t* xq = static_cast<const int8_t*>(x);
  const int8_t* wq = static_cast<const int8_t*>(w);
  const float* sc = static_cast<const float*>(scale);
  const float* b = static_cast<const float*>(bias);
  if (out_dtype == 0) return (int)launch<float>(xq, wq, sc, b, y, M, N, K, s);
  if (out_dtype == 1) return (int)launch<__nv_bfloat16>(xq, wq, sc, b, y, M, N, K, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
