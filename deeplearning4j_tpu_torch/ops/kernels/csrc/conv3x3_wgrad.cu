// conv3x3_wgrad: the filter gradient of a 3x3 stride-1 SAME NHWC conv, for
// NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel deeplearning4j_tpu/ops/conv_kernels.py
// `_wgrad_kernel` as reached through `conv3x3_wgrad_tpu`:
//
//   dW[co, ci, i, j] = sum over b, h, w of
//                      x[b, h + i - 1, w + j - 1, ci] * dy[b, h, w, co]
//
// with x read as zero outside the image.
//
//   x  [B, H, W, Ci] NHWC-contiguous, f32 or bf16
//   dy [B, H, W, Co] NHWC-contiguous, same dtype as x
//   dw [Co, Ci, 3, 3] f32 (the port's OIHW layout)
//
// Design: nine implicit GEMMs (conv3x3_igemm.cuh), one per tap (i, j) in
// gridDim.z, each with M = Ci, N = Co and the reduction over the B*H*W
// positions in steps of 32.  A is x's rows at the positions shifted by the
// tap, B is dy's rows (16-byte copies of channels, x zero-filled outside
// the image); both arrive position-major, so A goes through
// ldmatrix.trans too.  The output tiles alone are few (9 at 56x56x64, 36 at
// 28x28x128), so the plan splits the positions into S slices until the
// grid has at least 2 blocks per SM; the last block of each tile sums the
// S partials in slice order (no float atomics, the same bits every call)
// and writes dW in OIHW order.  The thread tracks its copy row's image row
// and column from one step to the next (one division a step, none per
// chunk).
//
// Bound: 2 * 9 * Ci * Co * B*H*W = 14.8 GFLOP at every ResNet-50 body shape
// at batch 64; bf16 0.015 ms at 989 TFLOP/s, against reading x and dy once
// (51 MB at 56x56x64, 0.015 ms); f32 through 3xTF32 0.090 ms at 495 TFLOP/s
// (0.221 at the 67 TFLOP/s SIMT rate), against 103 MB (0.031 ms).
#include "conv3x3_igemm.cuh"

namespace {

using namespace conv_igemm;

template <typename T, bool VEC>
__global__ void __launch_bounds__(THREADS)
conv3x3_wgrad_kernel(const T* __restrict__ x, const T* __restrict__ dy, float* __restrict__ dw,
                     float* ws, int* counters, int H, int W, int P, int Ci, int Co, int S) {
  using C = Cfg<T, false>;
  static_assert(BM == BN, "A and B copy rows coincide");
  extern __shared__ __align__(16) char smem[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int tap = blockIdx.z / S, s = blockIdx.z % S;
  const int di = tap / 3 - 1, dj = tap % 3 - 1;
  const int wm0 = (warp % WARPS_M) * WM, wn0 = (warp / WARPS_M) * WN;
  int k_begin, k_end;
  slice_bounds((P + BK - 1) / BK, S, s, &k_begin, &k_end);
  const int p_end = min(P, k_end * BK);

  // A [BK positions][BM input channels] and B [BK positions][BN output
  // channels]: the thread copies chunks (tid % TPR) + TPR * j of row
  // r = tid / TPR of both, and tracks that row's image row and column
  constexpr int TPR = THREADS / BK;
  constexpr int CPT = BM / C::VE / TPR;
  static_assert(THREADS % BK == 0 && CPT >= 1, "copy rows");
  const int r = tid / TPR;
  int pw, ph;
  {
    const int p = k_begin * BK + r;
    const int q = p / W;
    pw = p - q * W;
    ph = q % H;
  }

  auto load = [&](char* stage, int step) {
    const int p = (k_begin + step) * BK + r;
    T* As = reinterpret_cast<T*>(stage);
    T* Bs = As + C::A_ELEMS;
    const int hs = ph + di, wsh = pw + dj;
    const bool live = p < p_end;
    const bool in = live && hs >= 0 && hs < H && wsh >= 0 && wsh < W;
    const T* xrow = x + (int64_t)(p + di * W + dj) * Ci;
    const T* dyrow = dy + (int64_t)p * Co;
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const int c = (tid % TPR + TPR * j) * C::VE, ci = m0 + c, co = n0 + c;
      copy_chunk<VEC>(As + r * C::LDA + c, xrow + ci, x, in && ci < Ci, Ci - ci);
      copy_chunk<VEC>(Bs + r * C::LDB + c, dyrow + co, dy, live && co < Co, Co - co);
    }
    // the row's position BK steps on
    pw += BK;
    const int q = pw / W;
    pw -= q * W;
    ph = (ph + q) % H;
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

  const int tile = (tap * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x;
  finish(acc, ws, counters, tile, 9 * gridDim.x * gridDim.y, S, s, Ci, Co, m0, n0, wm0, wn0,
         [&](int m, int n, float v) { dw[((int64_t)n * Ci + m) * 9 + tap] = v; });
}

bool smem_raised[4][MAX_DEVICES];

template <typename T, bool VEC>
cudaError_t launch_kernel(int slot, const T* x, const T* dy, float* dw, float* ws, int* counters,
                       int H, int W, int P, int Ci, int Co, int S, cudaStream_t stream) {
  using C = Cfg<T, false>;
  auto* kernel = conv3x3_wgrad_kernel<T, VEC>;
  cudaError_t err = allow_smem((const void*)kernel, C::SMEM_BYTES, smem_raised[slot]);
  if (err != cudaSuccess) return err;
  const dim3 grid((Ci + BM - 1) / BM, (Co + BN - 1) / BN, 9 * S);
  kernel<<<grid, THREADS, C::SMEM_BYTES, stream>>>(x, dy, dw, ws, counters, H, W, P, Ci, Co, S);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* x, const void* dy, float* dw, float* ws, int* counters, int H,
                   int W, int P, int Ci, int Co, int S, cudaStream_t stream) {
  const bool vec = ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(dy)) & 15) == 0 &&
                   ((int64_t)Ci * (int64_t)sizeof(T)) % 16 == 0 &&
                   ((int64_t)Co * (int64_t)sizeof(T)) % 16 == 0;
  const int slot = 2 * (int)std::is_same<T, __nv_bfloat16>::value + (int)vec;
  const T* xt = static_cast<const T*>(x);
  const T* dt = static_cast<const T*>(dy);
  if (vec) return launch_kernel<T, true>(slot, xt, dt, dw, ws, counters, H, W, P, Ci, Co, S, stream);
  return launch_kernel<T, false>(slot, xt, dt, dw, ws, counters, H, W, P, Ci, Co, S, stream);
}

}  // namespace

extern "C" {

// The shared tile of both conv kernels (conv3x3_igemm.cuh), for the
// wrapper's plan to check against.
void dl4j_conv3x3_tile(int* bm, int* bn, int* bk) {
  *bm = BM;
  *bn = BN;
  *bk = BK;
}

// dtype: 0 = f32, 1 = bf16.  With S > 1, ws holds S * tiles * 64 * 64
// floats and counters `tiles` zeroed ints (tiles = 9 * ceil(Ci / 64) *
// ceil(Co / 64)), left zero again.  S must lie in [1, ceil(B*H*W / 32)].
// B*H*W must fit in an int (the wrapper checks).  Returns the launch's
// cudaError_t (0 = success).
int dl4j_conv3x3_wgrad(const void* x, const void* dy, void* dw, void* ws, void* counters, int B,
                       int H, int W, int Ci, int Co, int S, int dtype, void* stream) {
  const int64_t P = (int64_t)B * H * W;
  if (B <= 0 || H <= 0 || W <= 0 || Ci <= 0 || Co <= 0 || P > INT32_MAX || S < 1 ||
      9 * (int64_t)S > 65535 || S > (P + BK - 1) / BK || (Co + BN - 1) / BN > 65535 ||
      (S > 1 && (ws == nullptr || counters == nullptr)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* out = static_cast<float*>(dw);
  float* wsf = static_cast<float*>(ws);
  int* ctr = static_cast<int*>(counters);
  if (dtype == 0) return (int)launch<float>(x, dy, out, wsf, ctr, H, W, (int)P, Ci, Co, S, st);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(x, dy, out, wsf, ctr, H, W, (int)P, Ci, Co, S, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
