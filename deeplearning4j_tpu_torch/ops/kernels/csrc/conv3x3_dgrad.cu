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
// rotated by 180 degrees and its channels swapped.
//
//   dy [B, H, W, Co] NHWC-contiguous, f32 or bf16
//   w  [Co, Ci, 3, 3] contiguous (the port's OIHW layout), same dtype as dy
//   wp [9, Co, ci_ld] scratch of dy's dtype, ci_ld = Ci rounded up to 8
//   dx [B, H, W, Ci] f32, NHWC
//
// Design: one implicit GEMM (conv3x3_igemm.cuh) with M = B*H*W positions,
// N = Ci, and the reduction tap-major over 9 * Co in steps of one tap and
// 32 channels.  A is dy's rows at the positions shifted by the tap (16-byte
// copies of channels, zero-filled outside the image); B is the tap's
// rotated, channel-swapped [Co, Ci] filter slice.  A small pack kernel in
// the same entry builds it first, Wp[tap, co, ci] = W[co, ci, 8 - tap] in
// the compute dtype with rows padded to 16 bytes, as the JAX wrapper builds
// `wf` before its pallas_call, so B tiles load as 16-byte rows where the
// first design read W with a stride of 9 elements.  64-position tiles give
// at least 392 blocks at every ResNet-50 body shape (7x7x512 at batch 64:
// 49 x 8), so the plan splits the reduction only for small problems.
//
// Bound: 2 * 9 * Ci * Co * B*H*W = 14.8 GFLOP at every ResNet-50 body shape
// at batch 64; bf16 0.015 ms at 989 TFLOP/s, against reading dy and writing
// dx f32 (77 MB at 56x56x64, 0.023 ms); f32 through 3xTF32 0.090 ms at 495
// TFLOP/s (0.221 at the 67 TFLOP/s SIMT rate), against 103 MB (0.031 ms).
#include "conv3x3_igemm.cuh"

namespace {

using namespace conv_igemm;

constexpr int PACK_THREADS = 256;

// One thread per (co, ci < ci_ld): reads W[co, ci, 0..8] (contiguous across
// a warp) and writes Wp[8 - t, co, ci] for each t (coalesced across ci);
// the pad columns are zero.  U is the element's bit pattern: a plain copy.
template <typename U>
__global__ void __launch_bounds__(PACK_THREADS)
conv3x3_dgrad_pack_w(const U* __restrict__ w, U* __restrict__ wp, int Ci, int Co, int ci_ld) {
  const int64_t plane = (int64_t)Co * ci_ld;
  const int64_t idx = (int64_t)blockIdx.x * PACK_THREADS + threadIdx.x;
  if (idx >= plane) return;
  const int ci = (int)(idx % ci_ld);
  const int co = (int)(idx / ci_ld);
  if (ci < Ci) {
    const U* src = w + ((int64_t)co * Ci + ci) * 9;
#pragma unroll
    for (int t = 0; t < 9; ++t) wp[(8 - t) * plane + idx] = src[t];
  } else {
#pragma unroll
    for (int t = 0; t < 9; ++t) wp[t * plane + idx] = U(0);
  }
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(THREADS)
conv3x3_dgrad_kernel(const T* __restrict__ dy, const T* __restrict__ wp, float* __restrict__ dx,
                     float* ws, int* counters, int H, int W, int P, int Ci, int Co, int ci_ld,
                     int S) {
  using C = Cfg<T, true>;
  extern __shared__ __align__(16) char smem[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN, s = blockIdx.z;
  const int wm0 = (warp % WARPS_M) * WM, wn0 = (warp / WARPS_M) * WN;
  const int co_steps = (Co + BK - 1) / BK;
  int k_begin, k_end;
  slice_bounds(9 * co_steps, S, s, &k_begin, &k_end);

  // A [BM positions][BK channels]: the thread copies chunks (tid % TPR) +
  // TPR * j of row tid / TPR, whose position, image row and column are
  // decoded once (a row past P gets an image row no tap brings inside)
  constexpr int TPR = THREADS / BM;
  constexpr int CPT = BK / C::VE / TPR;
  static_assert(THREADS % BM == 0 && CPT >= 1, "A rows");
  const int ar = tid / TPR, pos = m0 + ar;
  const int pq = pos / W, pw = pos - pq * W, ph = pos < P ? pq % H : -2;
  // B [BK channels][BN input channels] from Wp: chunk column bc of rows
  // tid / CB + i * (THREADS / CB)
  constexpr int CB = BN / C::VE;
  constexpr int BR = BK * CB / THREADS;
  const int bc = (tid % CB) * C::VE;

  auto load = [&](char* stage, int step) {
    const int abs_step = k_begin + step;
    const int tap = abs_step / co_steps;
    const int co0 = (abs_step - tap * co_steps) * BK;
    const int di = tap / 3 - 1, dj = tap % 3 - 1;
    T* As = reinterpret_cast<T*>(stage);
    T* Bs = As + C::A_ELEMS;
    const int hs = ph + di, wsh = pw + dj;
    const bool in = hs >= 0 && hs < H && wsh >= 0 && wsh < W;
    const T* row = dy + (int64_t)(pos + di * W + dj) * Co;
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const int c = (tid % TPR + TPR * j) * C::VE, co = co0 + c;
      copy_chunk<VEC>(As + ar * C::LDA + c, row + co, dy, in && co < Co, Co - co);
    }
#pragma unroll
    for (int i = 0; i < BR; ++i) {
      const int r = tid / CB + i * (THREADS / CB);
      const int c = co0 + r, n = n0 + bc;
      const bool ok = c < Co && n < ci_ld;
      cp_async16(Bs + r * C::LDB + bc, ok ? wp + ((int64_t)tap * Co + c) * ci_ld + n : wp,
                 ok ? 16 : 0);
    }
  };

  float acc[MT][NT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[mt][nt][c] = 0.0f;
  pipeline<C>(smem, k_end - k_begin, load,
              [&](const char* stage) { mma_stage<C>(stage, acc, wm0, wn0, lane); });

  finish(acc, ws, counters, blockIdx.y * gridDim.x + blockIdx.x, gridDim.x * gridDim.y, S, s, P,
         Ci, m0, n0, wm0, wn0,
         [&](int m, int n, float v) { dx[(int64_t)m * Ci + n] = v; });
}

bool smem_raised[4][MAX_DEVICES];

template <typename T, bool VEC>
cudaError_t launch_kernel(int slot, const T* dy, const T* wp, float* dx, float* ws, int* counters,
                        int H, int W, int P, int Ci, int Co, int ci_ld, int S,
                        cudaStream_t stream) {
  using C = Cfg<T, true>;
  auto* kernel = conv3x3_dgrad_kernel<T, VEC>;
  cudaError_t err = allow_smem((const void*)kernel, C::SMEM_BYTES, smem_raised[slot]);
  if (err != cudaSuccess) return err;
  const dim3 grid((P + BM - 1) / BM, (Ci + BN - 1) / BN, S);
  kernel<<<grid, THREADS, C::SMEM_BYTES, stream>>>(dy, wp, dx, ws, counters, H, W, P, Ci, Co,
                                                   ci_ld, S);
  return cudaGetLastError();
}

template <typename T, typename U>
cudaError_t launch(const void* dy, const void* w, void* wp, float* dx, float* ws, int* counters,
                   int H, int W, int P, int Ci, int Co, int S, cudaStream_t stream) {
  const int ci_ld = (Ci + 7) / 8 * 8;
  const int64_t plane = (int64_t)Co * ci_ld;
  conv3x3_dgrad_pack_w<U><<<(unsigned)((plane + PACK_THREADS - 1) / PACK_THREADS), PACK_THREADS,
                            0, stream>>>(static_cast<const U*>(w), static_cast<U*>(wp), Ci, Co,
                                         ci_ld);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const T* d = static_cast<const T*>(dy);
  const T* p = static_cast<const T*>(wp);
  const bool vec = (reinterpret_cast<uintptr_t>(dy) & 15) == 0 &&
                   ((int64_t)Co * (int64_t)sizeof(T)) % 16 == 0;
  const int slot = 2 * (int)std::is_same<T, __nv_bfloat16>::value + (int)vec;
  if (vec) return launch_kernel<T, true>(slot, d, p, dx, ws, counters, H, W, P, Ci, Co, ci_ld, S, stream);
  return launch_kernel<T, false>(slot, d, p, dx, ws, counters, H, W, P, Ci, Co, ci_ld, S, stream);
}

}  // namespace

extern "C" {

// dtype: 0 = f32, 1 = bf16.  wp holds 9 * Co * ci_ld elements of dy's
// dtype (ci_ld = Ci rounded up to a multiple of 8); with S > 1, ws holds
// S * tiles * 64 * 64 floats and counters `tiles` zeroed ints (tiles =
// ceil(B*H*W / 64) * ceil(Ci / 64)), left zero again.  S must lie in
// [1, 9 * ceil(Co / 32)].  B*H*W must fit in an int (the wrapper checks).
// Returns the first failing launch's cudaError_t (0 = success).
int dl4j_conv3x3_dgrad(const void* dy, const void* w, void* wp, void* dx, void* ws,
                       void* counters, int B, int H, int W, int Ci, int Co, int S, int dtype,
                       void* stream) {
  const int64_t P = (int64_t)B * H * W;
  if (B <= 0 || H <= 0 || W <= 0 || Ci <= 0 || Co <= 0 || P > INT32_MAX || S < 1 ||
      S > 65535 || S > 9 * ((Co + BK - 1) / BK) || (Ci + BN - 1) / BN > 65535 ||
      wp == nullptr || (S > 1 && (ws == nullptr || counters == nullptr)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* out = static_cast<float*>(dx);
  float* wsf = static_cast<float*>(ws);
  int* ctr = static_cast<int*>(counters);
  if (dtype == 0)
    return (int)launch<float, uint32_t>(dy, w, wp, out, wsf, ctr, H, W, (int)P, Ci, Co, S, st);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16, uint16_t>(dy, w, wp, out, wsf, ctr, H, W, (int)P, Ci, Co,
                                                S, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
