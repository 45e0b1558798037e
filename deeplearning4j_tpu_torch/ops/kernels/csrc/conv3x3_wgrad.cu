// conv3x3_wgrad: the filter gradient of a 3x3 stride-1 SAME NHWC conv, for
// NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel deeplearning4j_tpu/ops/conv_kernels.py
// `_wgrad_kernel` as reached through `conv3x3_wgrad_tpu`:
//
//   dW[co, ci, i, j] = sum over b, h, w of
//                      x[b, h + i - 1, w + j - 1, ci] * dy[b, h, w, co]
//
// with x read as zero outside the image, i.e. nine [Ci, K] x [K, Co]
// products over the same K = B*H*W positions, one per tap (i, j).
//
//   x  [B, H, W, Ci] NHWC-contiguous, f32 or bf16
//   dy [B, H, W, Co] NHWC-contiguous, same dtype as x
//   dw [Co, Ci, 3, 3] f32 (the port's OIHW layout), written by pass 2
//   partial [splits, 9, Ci, Co] f32 scratch, from the wrapper's torch.empty
//
// Design.  Blocks run in no order on the card, so the TPU's sum over a
// sequential grid into one resident output block does not carry over.
// Pass 1 tiles (tap, Ci, Co) into 64x64 output tiles and splits K across
// blocks: block z = tap * splits + split sums positions
// [split * chunk, (split + 1) * chunk) into registers (256 threads, a 4x4
// micro-tile each, K steps of 16 through shared memory) and stores its
// partial tile.  Pass 2 sums the `splits` partials of each element in a
// fixed order and writes dW in OIHW order.  No atomics: two runs give the
// same bits.  The wrapper picks `splits` so that pass 1 has at least about
// four blocks per SM (at ResNet-50's 56x56x64 stage the (tap, Ci, Co) tiles
// alone are 9 blocks for 132 SMs).
//
// No padded or shifted copies: the TPU kernel pads x and cuts three
// row-shifted views before its launch (a BlockSpec artefact).  Here a
// position's tap-shifted source is the NHWC offset of the position plus
// (i - 1) * W + (j - 1), read only when the shifted row and column lie in
// the image; everything outside reads 0.  Each thread tracks its load
// rows' image row and column incrementally.  Ragged Ci, Co and K are
// masked.
//
// Bound.  Operations bound it in f32: 2 * 9 * Ci * Co * B*H*W = 14.8 GFLOP
// at every ResNet-50 body shape at batch 64, 0.22 ms at 67 TFLOP/s, while
// reading x and dy once is 103 MB at 56x56x64 (31 us).  In bf16 the bytes
// (51 MB, 15 us) and the tensor-core rate (15 us) meet.  This first kernel
// is SIMT f32 arithmetic with bf16 converted on load; tensor cores (wgmma),
// TMA and a tap loop inside the block that reuses each dy tile nine times
// are later work.  Pass 2 reads the partials with a stride (its threads
// walk dW in OIHW order); it moves 9 * Ci * Co * splits floats, small
// beside pass 1.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;   // ci per tile
constexpr int BN = 64;   // co per tile
constexpr int BK = 16;   // positions per step
constexpr int TM = 4;
constexpr int TN = 4;
constexpr int THREADS = (BM / TM) * (BN / TN);  // 256
constexpr int REDUCE_THREADS = 256;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__global__ void __launch_bounds__(THREADS)
conv3x3_wgrad_partial(const T* __restrict__ x, const T* __restrict__ dy,
                      float* __restrict__ partial, int B, int H, int W,
                      int Ci, int Co, int splits, int chunk) {
  __shared__ float Xs[BK][BM];
  __shared__ float Ds[BK][BN];

  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN);
  const int ty = tid / (BN / TN);
  const int co0 = blockIdx.x * BN;
  const int ci0 = blockIdx.y * BM;
  const int tap = blockIdx.z / splits;
  const int split = blockIdx.z % splits;
  const int di = tap / 3 - 1;
  const int dj = tap % 3 - 1;
  const int K = B * H * W;
  const int k_begin = split * chunk;
  const int k_end = min(K, k_begin + chunk);

  // Loads: thread t fills column t % 64 of rows t / 64 + 4 * e; neighbouring
  // threads read neighbouring channels of one position.  Each of a
  // thread's rows keeps its position's image row and column in registers,
  // advanced by BK positions per step (no division in the loop).
  constexpr int ROWS = BK / (THREADS / BM);
  const int lc = tid % BM;
  const int lr = tid / BM;
  const int ci = ci0 + lc;
  const int co = co0 + lc;
  int row[ROWS], col[ROWS];
#pragma unroll
  for (int e = 0; e < ROWS; ++e) {
    const int k = k_begin + lr + e * (THREADS / BM);
    const int q = k / W;
    row[e] = q % H;
    col[e] = k - q * W;
  }

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;

  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
#pragma unroll
    for (int e = 0; e < ROWS; ++e) {
      const int kk = lr + e * (THREADS / BM);
      const int k = k0 + kk;
      float xv = 0.0f, dv = 0.0f;
      if (k < k_end) {
        const int hs = row[e] + di;
        const int ws = col[e] + dj;
        if (ci < Ci && hs >= 0 && hs < H && ws >= 0 && ws < W)
          xv = to_f32(x[((int64_t)k + di * W + dj) * Ci + ci]);
        if (co < Co) dv = to_f32(dy[(int64_t)k * Co + co]);
      }
      Xs[kk][lc] = xv;
      Ds[kk][lc] = dv;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = Xs[kk][ty + i * (BM / TM)];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = Ds[kk][tx + j * (BN / TN)];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
#pragma unroll
    for (int e = 0; e < ROWS; ++e) {
      col[e] += BK;
      while (col[e] >= W) {
        col[e] -= W;
        if (++row[e] == H) row[e] = 0;
      }
    }
  }

  float* out = partial + ((int64_t)split * 9 + tap) * Ci * Co;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = ci0 + ty + i * (BM / TM);
    if (r >= Ci) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int c = co0 + tx + j * (BN / TN);
      if (c < Co) out[(int64_t)r * Co + c] = acc[i][j];
    }
  }
}

// One thread per dW element, in OIHW order: sums its `splits` partials in
// split order (deterministic).
__global__ void __launch_bounds__(REDUCE_THREADS)
conv3x3_wgrad_reduce(const float* __restrict__ partial, float* __restrict__ dw,
                     int Ci, int Co, int splits) {
  const int64_t total = (int64_t)9 * Ci * Co;
  const int64_t idx = (int64_t)blockIdx.x * REDUCE_THREADS + threadIdx.x;
  if (idx >= total) return;
  const int tap = (int)(idx % 9);
  const int64_t t = idx / 9;
  const int ci = (int)(t % Ci);
  const int co = (int)(t / Ci);
  const int64_t stride = (int64_t)9 * Ci * Co;
  const float* p = partial + ((int64_t)tap * Ci + ci) * Co + co;
  float s = 0.0f;
  for (int sp = 0; sp < splits; ++sp) s += p[sp * stride];
  dw[idx] = s;
}

template <typename T>
cudaError_t launch(const void* x, const void* dy, float* partial, float* dw,
                   int B, int H, int W, int Ci, int Co, int splits, int chunk,
                   cudaStream_t stream) {
  const dim3 grid((Co + BN - 1) / BN, (Ci + BM - 1) / BM, 9 * splits);
  conv3x3_wgrad_partial<T><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy), partial, B, H, W,
      Ci, Co, splits, chunk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int64_t total = (int64_t)9 * Ci * Co;
  const unsigned blocks = (unsigned)((total + REDUCE_THREADS - 1) / REDUCE_THREADS);
  conv3x3_wgrad_reduce<<<blocks, REDUCE_THREADS, 0, stream>>>(partial, dw, Ci, Co,
                                                              splits);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = f32, 1 = bf16.  B*H*W must fit in an int (the wrapper checks);
// splits * chunk must cover B*H*W.  Returns the first launch's
// cudaError_t (0 = success).
int dl4j_conv3x3_wgrad(const void* x, const void* dy, void* partial, void* dw,
                       int B, int H, int W, int Ci, int Co, int splits,
                       int chunk, int dtype, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || Ci <= 0 || Co <= 0 || splits <= 0 ||
      chunk <= 0 || 9 * splits > 65535 || (Ci + BM - 1) / BM > 65535 ||
      (int64_t)splits * chunk < (int64_t)B * H * W)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* p = static_cast<float*>(partial);
  float* d = static_cast<float*>(dw);
  if (dtype == 0)
    return (int)launch<float>(x, dy, p, d, B, H, W, Ci, Co, splits, chunk, s);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(x, dy, p, d, B, H, W, Ci, Co, splits, chunk, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
