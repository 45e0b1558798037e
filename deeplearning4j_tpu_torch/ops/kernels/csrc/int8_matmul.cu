// int8_matmul: y = f32(xq @ Wq) * (x_scale * w_scale) + b, int8 x int8 with an int32
// accumulator, for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel deeplearning4j_tpu/ops/pallas/matmul.py:79
// `_matmul_kernel` as reached through `int8_matmul` (:185, static
// activation quantization): the int8 x int8 -> int32 contraction over
// every K block, then the dequant epilogue (`quant_kernels.dequant_epilogue`)
// on the combined per-channel scale x_scale * w_scale, rounded to f32 once,
// as the JAX package's `_combined_scale` does (here in the epilogue, so the
// wrapper launches nothing else).
//
//   xq      [M, K] row-major int8
//   Wq      [K, N] row-major int8
//   w_scale [N] f32; x_scale an f32 scalar (1 when there is none)
//   b       [N] f32, or null
//   y       [M, N] row-major, f32 or bf16
//   ws [S, M, N] int32 workspace, counters [ceil(N/128) * ceil(M/16)] int32
//   (zero before the first launch; every launch leaves them zero)
//
// Bitwise contract.  An int32 sum of int8 products is exact in any order
// (the wrapper refuses K above (2^31 - 1) / 127^2 = 133,144; VGG16's fc6
// has K = 25088, |acc| <= 404.6 M), the split-K partials stay int32 and are
// summed in int32, and the epilogue is correctly rounded f32 operations,
// __fmul_rn (x_scale * w_scale, then f32(acc) times that) then __fadd_rn,
// which nvcc may not contract into an FMA, then one cast; so y equals the
// plain version's `f32(acc) * scale + b` to the bit under any tiling and
// split.
//
// Bound at the VGG16 serving shapes (M <= 16): bytes.  fc6 reads the int8 W
// once, 102.8 MB, 0.031 ms at 3.35 TB/s; fc7 0.005 ms, output 0.0013 ms.
// The first design (a 64x64 SIMT __dp4a tile, byte-wide global loads, 64
// blocks for 132 SMs at fc6, no load in flight while a block computed) took
// 1.23 ms at fc6, 40x the bound and slower than its own plain version.
//
// Design: the skinny-M, split-K GEMM of skinny_gemm.cuh on its int8 route.
// BM = 16 rows (every serving bucket, the M of mma.sync.m16n8k32), BN = 128
// columns, 128 threads; BK = 128 K bytes a stage (a W stage is 16 KB, each
// W row a 128-byte line) in a ring of STAGES = 3, three blocks an SM (72 KB
// of shared memory each), so up to 96 KB of W is in flight per SM; W by TMA
// where its rows are 16-byte aligned (fc6, fc7), by 16/8-byte cp.async
// elsewhere (N = 1000), x rows by 16-byte cp.async (narrower copies with
// zero fill where K or the base is off 16 bytes).  Each landed W stage is
// transposed to [BN][BK] in shared memory by 4 x 4 byte blocks and feeds the
// int8 tensor cores (s32 accumulators) through non-transposing ldmatrix.
// The K split is the wrapper's `gemm_plan(..., "int8_matmul")`; the last
// block of a tile sums the int32 partials in the order s = 0..S-1 and runs
// the epilogue.
#include "skinny_gemm.cuh"

namespace {

using skinny::BM;
using skinny::BN;
constexpr int BK = 128;
constexpr int STAGES = 3;
template <typename Y, bool TMA>
using Tile = skinny::Cfg<int8_t, int8_t, BK, STAGES, TMA, Y>;

struct DequantEpilogue {
  const float* w_scale;
  float x_scale;
  const float* bias;
  __device__ __forceinline__ float operator()(int32_t acc, int n) const {
    float v = __fmul_rn(__int2float_rn(acc), __fmul_rn(x_scale, w_scale[n]));
    if (bias != nullptr) v = __fadd_rn(v, bias[n]);
    return v;
  }
};

template <typename Y, bool TMA>
__global__ void __launch_bounds__(skinny::THREADS)
int8_matmul_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                   const __grid_constant__ CUtensorMap wmap, const float* __restrict__ w_scale,
                   float x_scale, const float* __restrict__ bias, Y* __restrict__ y, int32_t* ws,
                   int* counters, int M, int N, int K, int S) {
  skinny::gemm_body<Tile<Y, TMA>>(x, w, &wmap, y, ws, counters, M, N, K, S,
                                  DequantEpilogue{w_scale, x_scale, bias});
}

template <typename Y, bool TMA>
cudaError_t launch_tma(const int8_t* x, const int8_t* w, const CUtensorMap& wmap,
                       const float* w_scale, float x_scale, const float* bias, void* y,
                       int32_t* ws, int* counters, int M, int N, int K, int S,
                       cudaStream_t stream) {
  using C = Tile<Y, TMA>;
  static bool raised[skinny::MAX_DEVICES];
  cudaError_t e = skinny::allow_smem(reinterpret_cast<const void*>(&int8_matmul_kernel<Y, TMA>),
                                     C::SMEM_BYTES, raised);
  if (e != cudaSuccess) return e;
  int8_matmul_kernel<Y, TMA><<<skinny::grid(M, N, S), skinny::THREADS, C::SMEM_BYTES, stream>>>(
      x, w, wmap, w_scale, x_scale, bias, static_cast<Y*>(y), ws, counters, M, N, K, S);
  return cudaGetLastError();
}

// W goes through TMA where its base and row stride allow (16 bytes), else
// through cp.async.
template <typename Y>
cudaError_t launch(const int8_t* x, const int8_t* w, const float* w_scale, float x_scale,
                   const float* bias, void* y, int32_t* ws, int* counters, int M, int N, int K,
                   int S, cudaStream_t stream) {
  CUtensorMap wmap = {};
  if (skinny::encode_w_map(&wmap, w, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, N, K, BN, BK, false))
    return launch_tma<Y, true>(x, w, wmap, w_scale, x_scale, bias, y, ws, counters, M, N, K,
                               S, stream);
  return launch_tma<Y, false>(x, w, wmap, w_scale, x_scale, bias, y, ws, counters, M, N, K, S,
                              stream);
}

}  // namespace

extern "C" {

// Tile the kernel was compiled for, so the wrapper can refuse any other.
void dl4j_int8_matmul_tile(int* bm, int* bn, int* bk) {
  *bm = BM;
  *bn = BN;
  *bk = BK;
}

// out_dtype: 0 = f32, 1 = bf16.  S: K slices (the wrapper's gemm_plan); ws
// holds [S, M, N] int32.  Returns the launch's cudaError_t.
int dl4j_int8_matmul(const void* x, const void* w, const void* w_scale, const void* bias,
                     void* y, void* ws, void* counters, int M, int N, int K, int S,
                     float x_scale, int out_dtype, void* stream) {
  if (!skinny::shape_ok(M, N, K, S, ws, counters) || K > 133144)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int8_t* xq = static_cast<const int8_t*>(x);
  const int8_t* wq = static_cast<const int8_t*>(w);
  const float* sc = static_cast<const float*>(w_scale);
  const float* b = static_cast<const float*>(bias);
  int32_t* wsi = static_cast<int32_t*>(ws);
  int* ctr = static_cast<int*>(counters);
  if (out_dtype == 0)
    return (int)launch<float>(xq, wq, sc, x_scale, b, y, wsi, ctr, M, N, K, S, s);
  if (out_dtype == 1)
    return (int)launch<__nv_bfloat16>(xq, wq, sc, x_scale, b, y, wsi, ctr, M, N, K, S, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
