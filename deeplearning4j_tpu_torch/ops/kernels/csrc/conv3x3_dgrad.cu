// conv3x3_dgrad: the input gradient of a 3x3 stride-1 SAME NHWC conv, for
// NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel deeplearning4j_tpu/ops/conv_kernels.py
// `_dgrad_kernel` as reached through `conv3x3_dgrad_tpu`:
//
//   dx[b, h, w, ci] = sum over i, j, co of
//                     dy[b, h + i - 1, w + j - 1, co] * W[co, ci, 2 - i, 2 - j]
//
// with dy read as zero outside the image: a SAME conv of dy with the filter
// rotated by 180 degrees and its channels swapped, i.e. nine [K, Co] x
// [Co, Ci] products over the positions K = B*H*W, one per tap, summed.
//
//   dy [B, H, W, Co] NHWC-contiguous, f32 or bf16
//   w  [Co, Ci, 3, 3] contiguous (the port's OIHW layout), same dtype as dy
//   dx [B, H, W, Ci] f32, NHWC
//
// Design.  A tiled SIMT product over output tiles of 64 positions x 64
// input channels (256 threads, a 4x4 micro-tile of f32 accumulators each).
// The block loops over the nine taps and, inside each, over Co in steps of
// 16 through shared memory; the whole sum stays in registers, so every
// output element is written once and no reduction crosses blocks.  The
// rotated, channel-swapped filter is never built: a tap reads
// W[co, ci, 2 - i, 2 - j] by index arithmetic (a stride of 9 elements
// across ci; the filter is at most 9.4 MB in f32 and stays in L2).  The
// halo is read in place: the block decodes its 64 positions' rows and
// columns once into shared memory, and a tap reads dy at the position's
// NHWC offset plus (i - 1) * W + (j - 1) only when the shifted row and
// column lie in the image.  Ragged K, Ci and Co are masked.
//
// Bound.  Operations bound it in f32: 2 * 9 * Ci * Co * B*H*W = 14.8 GFLOP
// at every ResNet-50 body shape at batch 64, 0.22 ms at 67 TFLOP/s; reading
// dy and writing dx is 103 MB at 56x56x64 (31 us).  SIMT f32 arithmetic
// with bf16 converted on load; wgmma, TMA and reuse of a dy tile across
// the taps (neighbouring taps overlap) are later work.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;   // positions per tile
constexpr int BN = 64;   // ci per tile
constexpr int BK = 16;   // co per step
constexpr int TM = 4;
constexpr int TN = 4;
constexpr int THREADS = (BM / TM) * (BN / TN);  // 256

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__global__ void __launch_bounds__(THREADS)
conv3x3_dgrad_kernel(const T* __restrict__ dy, const T* __restrict__ w,
                     float* __restrict__ dx, int B, int H, int W, int Ci,
                     int Co) {
  // dy tile kept transposed ([co][position]) so the inner loop reads a
  // column of it; the +1 pad spreads the transposing stores over the banks.
  __shared__ float As[BK][BM + 1];
  __shared__ float Bs[BK][BN];
  __shared__ int row_of[BM];
  __shared__ int col_of[BM];

  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN);
  const int ty = tid / (BN / TN);
  const int K = B * H * W;
  const int p0 = blockIdx.x * BM;
  const int ci0 = blockIdx.y * BN;

  if (tid < BM) {
    const int k = p0 + tid;
    const int q = k / W;
    row_of[tid] = k < K ? q % H : -H - 2;   // out of range for every tap
    col_of[tid] = k - q * W;
  }
  __syncthreads();

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;

  for (int tap = 0; tap < 9; ++tap) {
    const int di = tap / 3 - 1;
    const int dj = tap % 3 - 1;
    const int wtap = 8 - tap;   // W[.., 2 - i, 2 - j]
    for (int co0 = 0; co0 < Co; co0 += BK) {
      // dy: 16 neighbouring threads read 16 neighbouring channels of one
      // position
#pragma unroll
      for (int e = 0; e < (BM * BK) / THREADS; ++e) {
        const int idx = tid + e * THREADS;
        const int r = idx / BK, c = idx % BK;
        const int hs = row_of[r] + di, ws = col_of[r] + dj;
        const int co = co0 + c;
        float v = 0.0f;
        if (co < Co && hs >= 0 && hs < H && ws >= 0 && ws < W)
          v = to_f32(dy[((int64_t)(p0 + r) + di * W + dj) * Co + co]);
        As[c][r] = v;
      }
#pragma unroll
      for (int e = 0; e < (BK * BN) / THREADS; ++e) {
        const int idx = tid + e * THREADS;
        const int r = idx / BN, c = idx % BN;
        const int co = co0 + r, ci = ci0 + c;
        Bs[r][c] = (co < Co && ci < Ci)
                       ? to_f32(w[((int64_t)co * Ci + ci) * 9 + wtap]) : 0.0f;
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
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int k = p0 + ty + i * (BM / TM);
    if (k >= K) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int ci = ci0 + tx + j * (BN / TN);
      if (ci < Ci) dx[(int64_t)k * Ci + ci] = acc[i][j];
    }
  }
}

template <typename T>
cudaError_t launch(const void* dy, const void* w, float* dx, int B, int H,
                   int W, int Ci, int Co, cudaStream_t stream) {
  const int K = B * H * W;
  const dim3 grid((K + BM - 1) / BM, (Ci + BN - 1) / BN);
  conv3x3_dgrad_kernel<T><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(dy), static_cast<const T*>(w), dx, B, H, W, Ci, Co);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = f32, 1 = bf16.  B*H*W must fit in an int (the wrapper checks).
// Returns the launch's cudaError_t (0 = success).
int dl4j_conv3x3_dgrad(const void* dy, const void* w, void* dx, int B, int H,
                       int W, int Ci, int Co, int dtype, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || Ci <= 0 || Co <= 0 ||
      (Ci + BN - 1) / BN > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* out = static_cast<float*>(dx);
  if (dtype == 0) return (int)launch<float>(dy, w, out, B, H, W, Ci, Co, s);
  if (dtype == 1) return (int)launch<__nv_bfloat16>(dy, w, out, B, H, W, Ci, Co, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
