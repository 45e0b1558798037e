// fused_dense: y = act(x @ W + b) for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel deeplearning4j_tpu/ops/pallas/matmul.py:79
// `_matmul_kernel` as reached through `_tiled_matmul` / `fused_dense`
// (:320): a float product accumulated in f32, with the bias add and the
// activation applied in f32 in the epilogue, stored in x's dtype.
//
//   x [M, K] row-major, f32 or bf16
//   W [K, N] row-major, same dtype as x
//   b [N] f32, or null
//   y [M, N] row-major, x's dtype
//   ws [S, M, N] f32 workspace, counters [ceil(N/128) * ceil(M/16)] int32
//   (zero before the first launch; every launch leaves them zero)
//
// Design: the skinny-M, split-K GEMM of skinny_gemm.cuh (a 16 x 128 tile,
// BK = 32 K rows a stage, a 3-stage ring fed by TMA where W is 16-byte
// aligned and by cp.async elsewhere, SIMT FMA in f32 and mma.sync bf16
// tensor cores in bf16, the split-K partials summed in a fixed order by the
// last block of each tile).  3 stages of 32 rows were chosen by timing fc6
// on an H100 against 2 to 6 stages, BK = 16 and 64, and 256-column tiles.
// This file adds the epilogue, which runs once on the full f32 sum: +
// bias, then the activation, then one cast.
//
// Bound at VGG16's serving shapes, M = 16, 3.35 TB/s: bytes.  fc6 (K =
// 25088, N = 4096) reads W once, 411 MB in f32, 0.123 ms; 0.061 ms in bf16.
// fc7 (4096 x 4096) 0.020 / 0.010 ms; the output layer (4096 x 1000)
// 0.0049 / 0.0025 ms.  The first design (a 64x64 SIMT tile at K step 16)
// took 2.0 ms at fc6 in f32 and 2.4 ms in bf16: 64 blocks for 132 SMs,
// three quarters of each A tile masked rows, scalar W loads and no load in
// flight during the arithmetic.  The header says what this one does about
// each.
#include "skinny_gemm.cuh"

namespace {

using skinny::BM;
using skinny::BN;
constexpr int BK = 32;
constexpr int STAGES = 3;
template <typename T, bool TMA>
using Tile = skinny::Cfg<T, T, BK, STAGES, TMA>;

// Activation codes; the Python wrapper holds the same table.
enum Act { ACT_NONE = 0, ACT_RELU = 1, ACT_TANH = 2, ACT_SIGMOID = 3, ACT_GELU = 4 };

template <int ACT>
__device__ __forceinline__ float activate(float y) {
  if (ACT == ACT_RELU) return fmaxf(y, 0.0f);
  if (ACT == ACT_TANH) return tanhf(y);
  if (ACT == ACT_SIGMOID) return 1.0f / (1.0f + expf(-y));
  if (ACT == ACT_GELU) return 0.5f * y * (1.0f + erff(y * 0.70710678118654752440f));
  return y;
}

template <int ACT>
struct DenseEpilogue {
  const float* bias;
  __device__ __forceinline__ float operator()(float acc, int n) const {
    float v = acc;
    if (bias != nullptr) v += bias[n];
    return activate<ACT>(v);
  }
};

template <typename T, int ACT, bool TMA>
__global__ void __launch_bounds__(skinny::THREADS)
fused_dense_kernel(const T* __restrict__ x, const T* __restrict__ w,
                   const __grid_constant__ CUtensorMap wmap, const float* __restrict__ bias,
                   T* __restrict__ y, float* ws, int* counters, int M, int N, int K, int S) {
  skinny::gemm_body<Tile<T, TMA>>(x, w, &wmap, y, ws, counters, M, N, K, S,
                                  DenseEpilogue<ACT>{bias});
}

template <typename T, int ACT, bool TMA>
cudaError_t launch_act(const void* x, const void* w, const CUtensorMap& wmap, const float* bias,
                       void* y, float* ws, int* counters, int M, int N, int K, int S,
                       cudaStream_t stream) {
  using C = Tile<T, TMA>;
  static bool raised[skinny::MAX_DEVICES];
  cudaError_t e = skinny::allow_smem(
      reinterpret_cast<const void*>(&fused_dense_kernel<T, ACT, TMA>), C::SMEM_BYTES, raised);
  if (e != cudaSuccess) return e;
  fused_dense_kernel<T, ACT, TMA><<<skinny::grid(M, N, S), skinny::THREADS, C::SMEM_BYTES,
                                   stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), wmap, bias, static_cast<T*>(y), ws,
      counters, M, N, K, S);
  return cudaGetLastError();
}

template <typename T, int ACT>
cudaError_t launch_any(bool tma, const void* x, const void* w, const CUtensorMap& wmap,
                       const float* bias, void* y, float* ws, int* counters, int M, int N,
                       int K, int S, cudaStream_t stream) {
  return tma ? launch_act<T, ACT, true>(x, w, wmap, bias, y, ws, counters, M, N, K, S, stream)
             : launch_act<T, ACT, false>(x, w, wmap, bias, y, ws, counters, M, N, K, S, stream);
}

// W goes through TMA where its base and row stride allow (16 bytes), else
// through 16-byte cp.async.
template <typename T>
cudaError_t launch(const void* x, const void* w, const float* bias, void* y, float* ws,
                   int* counters, int M, int N, int K, int S, int act, cudaStream_t stream) {
  CUtensorMap wmap = {};
  const bool tma = skinny::encode_w_map(
      &wmap, w,
      sizeof(T) == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
      (int)sizeof(T), N, K, Tile<T, true>::SWZ ? Tile<T, true>::SWZ_COLS : BN, BK,
      Tile<T, true>::SWZ);
  switch (act) {
    case ACT_NONE:
      return launch_any<T, ACT_NONE>(tma, x, w, wmap, bias, y, ws, counters, M, N, K, S, stream);
    case ACT_RELU:
      return launch_any<T, ACT_RELU>(tma, x, w, wmap, bias, y, ws, counters, M, N, K, S, stream);
    case ACT_TANH:
      return launch_any<T, ACT_TANH>(tma, x, w, wmap, bias, y, ws, counters, M, N, K, S, stream);
    case ACT_SIGMOID:
      return launch_any<T, ACT_SIGMOID>(tma, x, w, wmap, bias, y, ws, counters, M, N, K, S,
                                        stream);
    case ACT_GELU:
      return launch_any<T, ACT_GELU>(tma, x, w, wmap, bias, y, ws, counters, M, N, K, S, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Tile the kernel was compiled for, so the wrapper can refuse any other.
void dl4j_fused_dense_tile(int* bm, int* bn, int* bk) {
  *bm = BM;
  *bn = BN;
  *bk = BK;
}

// dtype: 0 = f32, 1 = bf16.  S: K slices (the wrapper's gemm_plan).
// Returns the launch's cudaError_t (0 = success).
int dl4j_fused_dense(const void* x, const void* w, const void* bias, void* y, void* ws,
                     void* counters, int M, int N, int K, int S, int dtype, int act,
                     void* stream) {
  if (!skinny::shape_ok(M, N, K, S, ws, counters)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* b = static_cast<const float*>(bias);
  float* wsf = static_cast<float*>(ws);
  int* ctr = static_cast<int*>(counters);
  if (dtype == 0) return (int)launch<float>(x, w, b, y, wsf, ctr, M, N, K, S, act, s);
  if (dtype == 1) return (int)launch<__nv_bfloat16>(x, w, b, y, wsf, ctr, M, N, K, S, act, s);
  return (int)cudaErrorInvalidValue;
}

const char* dl4j_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
