// q_matmul: y = (x @ f(Wq)) * scale + b, weight-only int8, for NVIDIA
// Hopper (sm_90a).
//
// Replaces the TPU kernel deeplearning4j_tpu/ops/pallas/matmul.py:79
// `_matmul_kernel` as reached through `q_matmul` (:232): the int8 weights
// widen to the compute dtype on chip (no dequantized copy of W in device
// memory), the product accumulates in f32, and the epilogue applies the
// per-output-channel scale and then the bias in f32 before one cast to the
// compute dtype.
//
//   x     [M, K] row-major, f32 or bf16 (already the compute dtype)
//   Wq    [K, N] row-major int8
//   scale [N] f32
//   b     [N] f32, or null
//   y     [M, N] row-major, x's dtype
//   ws [S, M, N] f32 workspace, counters [ceil(N/128) * ceil(M/16)] int32
//   (zero before the first launch; every launch leaves them zero)
//
// Design: the skinny-M, split-K GEMM of skinny_gemm.cuh with BK = 64 K rows
// a stage (an int8 stage of W is 8 KB, so three stages in flight keep about
// 24 KB a block on the way), W by TMA where its rows are 16-byte aligned
// (fc6, fc7) and by cp.async elsewhere (N = 1000).  f32 x: SIMT FMA, each
// int8 widened to f32 in registers.  bf16 x: the stage's int8 tile widens
// to bf16 (exact) in shared memory and feeds mma.sync bf16 tensor cores
// with f32 accumulators.
// int8 -> bf16 -> f32 is exact, so both equal the TPU kernel's widening to
// the compute dtype.  The epilogue runs once on the full f32 sum with
// __fmul_rn / __fadd_rn, so nvcc cannot contract it into one FMA: scale,
// then bias, each rounded, as the JAX package's `dequant_epilogue`.
//
// Bound at VGG16's serving shapes, M = 16, 3.35 TB/s: fc6 reads the int8 W
// once, 102.8 MB, 0.031 ms (bf16 x: bytes); with f32 x the 2*M*N*K
// operations at 67 TFLOP/s bound it at 0.049 ms.  fc7 0.005 / 0.008 ms,
// output 0.0013 / 0.002 ms.  The first design (fused_dense.cu's 64x64 SIMT
// tile, K step 16, byte-wide W loads) took 2.0 ms at fc6 in f32 and 2.2 ms
// in bf16; the header says what this one does about it.
#include "skinny_gemm.cuh"

namespace {

using skinny::BM;
using skinny::BN;
constexpr int BK = 64;
constexpr int STAGES = 4;
template <typename T, bool TMA>
using Tile = skinny::Cfg<T, int8_t, BK, STAGES, TMA>;

struct DequantEpilogue {
  const float* scale;
  const float* bias;
  __device__ __forceinline__ float operator()(float acc, int n) const {
    float v = __fmul_rn(acc, scale[n]);
    if (bias != nullptr) v = __fadd_rn(v, bias[n]);
    return v;
  }
};

template <typename T, bool TMA>
__global__ void __launch_bounds__(skinny::THREADS)
q_matmul_kernel(const T* __restrict__ x, const int8_t* __restrict__ w,
                const __grid_constant__ CUtensorMap wmap, const float* __restrict__ scale,
                const float* __restrict__ bias, T* __restrict__ y, float* ws, int* counters,
                int M, int N, int K, int S) {
  skinny::gemm_body<Tile<T, TMA>>(x, w, &wmap, y, ws, counters, M, N, K, S,
                                  DequantEpilogue{scale, bias});
}

template <typename T, bool TMA>
cudaError_t launch_tma(const void* x, const int8_t* w, const CUtensorMap& wmap,
                       const float* scale, const float* bias, void* y, float* ws,
                       int* counters, int M, int N, int K, int S, cudaStream_t stream) {
  using C = Tile<T, TMA>;
  static bool raised[skinny::MAX_DEVICES];
  cudaError_t e = skinny::allow_smem(reinterpret_cast<const void*>(&q_matmul_kernel<T, TMA>),
                                     C::SMEM_BYTES, raised);
  if (e != cudaSuccess) return e;
  q_matmul_kernel<T, TMA><<<skinny::grid(M, N, S), skinny::THREADS, C::SMEM_BYTES, stream>>>(
      static_cast<const T*>(x), w, wmap, scale, bias, static_cast<T*>(y), ws, counters, M, N,
      K, S);
  return cudaGetLastError();
}

// W goes through TMA where its base and row stride allow (16 bytes), else
// through 16-byte cp.async.
template <typename T>
cudaError_t launch(const void* x, const int8_t* w, const float* scale, const float* bias,
                   void* y, float* ws, int* counters, int M, int N, int K, int S,
                   cudaStream_t stream) {
  CUtensorMap wmap = {};
  if (skinny::encode_w_map(&wmap, w, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, N, K, BN, BK, false))
    return launch_tma<T, true>(x, w, wmap, scale, bias, y, ws, counters, M, N, K, S, stream);
  return launch_tma<T, false>(x, w, wmap, scale, bias, y, ws, counters, M, N, K, S, stream);
}

}  // namespace

extern "C" {

// Tile the kernel was compiled for, so the wrapper can refuse any other.
void dl4j_q_matmul_tile(int* bm, int* bn, int* bk) {
  *bm = BM;
  *bn = BN;
  *bk = BK;
}

// dtype (of x and y): 0 = f32, 1 = bf16.  S: K slices (the wrapper's
// gemm_plan).  Returns the launch's cudaError_t.
int dl4j_q_matmul(const void* x, const void* w, const void* scale, const void* bias, void* y,
                  void* ws, void* counters, int M, int N, int K, int S, int dtype,
                  void* stream) {
  if (!skinny::shape_ok(M, N, K, S, ws, counters)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int8_t* wq = static_cast<const int8_t*>(w);
  const float* sc = static_cast<const float*>(scale);
  const float* b = static_cast<const float*>(bias);
  float* wsf = static_cast<float*>(ws);
  int* ctr = static_cast<int*>(counters);
  if (dtype == 0) return (int)launch<float>(x, wq, sc, b, y, wsf, ctr, M, N, K, S, s);
  if (dtype == 1) return (int)launch<__nv_bfloat16>(x, wq, sc, b, y, wsf, ctr, M, N, K, S, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
