// flash_attn_fwd: flash-attention forward for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel deeplearning4j_tpu/ops/attention_kernels.py
// `_flash_kernel` (reached through `flash_attention_tpu`), with its
// semantics: scores q.k * scale in f32; a [B, S] keep-mask added as a bias
// of 0 (mask > 0) or NEG_INF = -1e30 (so a row whose every position is
// masked comes out uniform); an online softmax over KV tiles with running
// max m and sum l in f32; p cast to V's dtype before P.V, accumulated in
// f32; out = acc / l in q's dtype and lse = m + log(l) in f32.
//
//   q [B, H, T, D], k and v [B, H, S, D]: f32 or bf16, any strides over
//     (b, h, t), unit stride over D, D <= 128
//   mask [B, S] keep-mask (f32, bf16, f16 or f64), rows mask_b apart, or null
//   out [B, H, T, D] in q's dtype, any strides over (b, h, t)
//   lse [B*H, T] f32, contiguous
//
// Positions the kernel adds of its own (a ragged KV tail beyond S, and,
// under `causal`, keys after the query: col > row) get -inf, so they add
// exactly nothing whatever the tiling; JAX's dense reference gives them
// NEG_INF, which is the same answer wherever a row keeps one real score.
//
// Design.  One block of 256 threads per (b*h, 64-row query tile); nothing
// crosses blocks.  The TPU kernel's sequential KV grid axis and its VMEM
// scratch become a loop inside the block over 64-row K/V tiles staged in
// shared memory as f32 (bf16 is widened on load; the Q tile is loaded
// once).  The threads form a 16 x 16 grid: each computes a 4 x 4 patch of
// the 64 x 64 score tile (rows ty + 16i, columns tx + 16j), the row max
// and row sum are reduced over the 16 threads of a row with warp shuffles,
// p goes through shared memory to the P.V product, and each thread keeps
// its 4 rows' m, l and 4 x D/16 accumulators in registers.  The JAX
// wrapper's padding of T and S to block multiples, and the materialized
// [B, 1, S] bias, have no counterpart: the tails are masked here and the
// mask is read in place, per batch row b = (b*h) / H.  Under `causal`, KV
// tiles wholly after the query tile's last row are not visited.
//
// Bound.  Operations 4*B*H*T*S*D (halved under causal) against bytes
// (q, k, v and out once, lse).  BERT-base at [64, 12, 128, 64]: 3.2 GFLOP,
// 0.048 ms at the 67 TFLOP/s f32 rate, against about 101 MB of f32 bytes
// (0.030 ms) -> operations; in bf16 50 MB -> bytes, 0.015 ms.  At [4, 12,
// 2048, 64]: 51.5 GFLOP -> 0.77 ms at the f32 rate.  A SIMT kernel cannot
// use the tensor cores: in bf16 the bound there is 0.052 ms (989 TFLOP/s),
// far out of its reach.  Known
// gap, left for a later change: wgmma for both products, TMA or cp.async
// double buffering of the K/V tiles.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;        // query rows per block
constexpr int BK = 64;        // key/value rows per tile
constexpr int THREADS = 256;  // 16 x 16
constexpr int TR = 4;         // score rows per thread, 16 apart
constexpr int TC = 4;         // score columns per thread, 16 apart
constexpr int LDP = BK + 1;   // padded row of the P tile
constexpr int MAX_D = 128;
constexpr float NEG_INF = -1e30f;

enum MaskDtype { MASK_NONE = 0, MASK_F32 = 1, MASK_BF16 = 2, MASK_F16 = 3, MASK_F64 = 4 };

struct Strides {
  long long b, h, t;
};

struct Params {
  Strides q, k, v, o;
  long long mask_b;
  int H, T, S, D;
  int mask_dtype;
  int causal;
  float scale;
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// p rounded to V's dtype, as the TPU kernel's p.astype(v.dtype)
template <typename T> __device__ __forceinline__ float round_to(float v) {
  return to_f32(from_f32<T>(v));
}

__device__ __forceinline__ float mask_value(const void* mask, int dtype, long long i) {
  switch (dtype) {
    case MASK_F32: return static_cast<const float*>(mask)[i];
    case MASK_BF16: return __bfloat162float(static_cast<const __nv_bfloat16*>(mask)[i]);
    case MASK_F16: return __half2float(static_cast<const __half*>(mask)[i]);
    default: return (float)static_cast<const double*>(mask)[i];
  }
}

template <int DMAX>
constexpr size_t smem_floats() {
  // Q and K padded to DMAX + 1 (conflict-free column reads), V, P, key bias
  return (size_t)BQ * (DMAX + 1) + (size_t)BK * (DMAX + 1) + (size_t)BK * DMAX +
         (size_t)BQ * LDP + BK;
}

template <typename T, int DMAX>
__global__ void __launch_bounds__(THREADS)
flash_attn_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const void* __restrict__ mask,
                      T* __restrict__ out, float* __restrict__ lse, const Params p) {
  constexpr int LD = DMAX + 1;
  constexpr int DC = DMAX / 16;  // output columns per thread, 16 apart
  extern __shared__ float smem[];
  float* Qs = smem;                 // [BQ][LD]
  float* Ks = Qs + BQ * LD;         // [BK][LD]
  float* Vs = Ks + BK * LD;         // [BK][DMAX]
  float* Ps = Vs + BK * DMAX;       // [BQ][LDP]
  float* key_bias = Ps + BQ * LDP;  // [BK]

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int bh = blockIdx.x;
  const int b = bh / p.H;
  const int h = bh % p.H;
  const int q0 = blockIdx.y * BQ;
  const int D = p.D;
  const T* qb = q + b * p.q.b + h * p.q.h;
  const T* kb = k + b * p.k.b + h * p.k.h;
  const T* vb = v + b * p.v.b + h * p.v.h;

  for (int idx = tid; idx < BQ * DMAX; idx += THREADS) {
    const int r = idx / DMAX, c = idx % DMAX;
    const int t = q0 + r;
    Qs[r * LD + c] = (t < p.T && c < D) ? to_f32(qb[(int64_t)t * p.q.t + c]) : 0.0f;
  }

  float m[TR], l[TR], acc[TR][DC];
#pragma unroll
  for (int i = 0; i < TR; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.0f;
  }

  int nkv = (p.S + BK - 1) / BK;
  if (p.causal) {
    const int q_last = min(q0 + BQ, p.T) - 1;
    nkv = min(nkv, q_last / BK + 1);
  }

  for (int j = 0; j < nkv; ++j) {
    const int k0 = j * BK;
    __syncthreads();  // the Q tile is in; the last tile's K, V and P are read
    for (int idx = tid; idx < BK * DMAX; idx += THREADS) {
      const int r = idx / DMAX, c = idx % DMAX;
      const int s = k0 + r;
      const bool in = s < p.S && c < D;
      Ks[r * LD + c] = in ? to_f32(kb[(int64_t)s * p.k.t + c]) : 0.0f;
      Vs[r * DMAX + c] = in ? to_f32(vb[(int64_t)s * p.v.t + c]) : 0.0f;
    }
    if (tid < BK) {
      const int col = k0 + tid;
      float bias = 0.0f;
      if (col >= p.S)
        bias = -INFINITY;
      else if (p.mask_dtype != MASK_NONE)
        bias = mask_value(mask, p.mask_dtype, (long long)b * p.mask_b + col) > 0.0f ? 0.0f
                                                                                  : NEG_INF;
      key_bias[tid] = bias;
    }
    __syncthreads();

    float s[TR][TC];
#pragma unroll
    for (int i = 0; i < TR; ++i)
#pragma unroll
      for (int c = 0; c < TC; ++c) s[i][c] = 0.0f;
    // Q and K are zero beyond D, so the fixed trip count adds only zeros
#pragma unroll 8
    for (int d = 0; d < DMAX; ++d) {
      float a[TR], kk[TC];
#pragma unroll
      for (int i = 0; i < TR; ++i) a[i] = Qs[(ty + 16 * i) * LD + d];
#pragma unroll
      for (int c = 0; c < TC; ++c) kk[c] = Ks[(tx + 16 * c) * LD + d];
#pragma unroll
      for (int i = 0; i < TR; ++i)
#pragma unroll
        for (int c = 0; c < TC; ++c) s[i][c] = fmaf(a[i], kk[c], s[i][c]);
    }

#pragma unroll
    for (int i = 0; i < TR; ++i) {
      const int row = q0 + ty + 16 * i;
      float mx = -INFINITY;
#pragma unroll
      for (int c = 0; c < TC; ++c) {
        const int col = k0 + tx + 16 * c;
        float val = s[i][c] * p.scale + key_bias[tx + 16 * c];
        if (p.causal && col > row) val = -INFINITY;
        s[i][c] = val;
        mx = fmaxf(mx, val);
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m[i], mx);  // finite: m starts at NEG_INF
      const float corr = expf(m[i] - m_new);
      float rs = 0.0f;
#pragma unroll
      for (int c = 0; c < TC; ++c) {
        const float pv = expf(s[i][c] - m_new);
        rs += pv;
        Ps[(ty + 16 * i) * LDP + tx + 16 * c] = round_to<T>(pv);
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1) rs += __shfl_xor_sync(0xffffffffu, rs, o);
      l[i] = corr * l[i] + rs;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[i][c] *= corr;
    }
    __syncthreads();

#pragma unroll 8
    for (int kk = 0; kk < BK; ++kk) {
      float pr[TR], vv[DC];
#pragma unroll
      for (int i = 0; i < TR; ++i) pr[i] = Ps[(ty + 16 * i) * LDP + kk];
#pragma unroll
      for (int c = 0; c < DC; ++c) vv[c] = Vs[kk * DMAX + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < TR; ++i)
#pragma unroll
        for (int c = 0; c < DC; ++c) acc[i][c] = fmaf(pr[i], vv[c], acc[i][c]);
    }
  }

  T* ob = out + b * p.o.b + h * p.o.h;
#pragma unroll
  for (int i = 0; i < TR; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= p.T) continue;
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      const int col = tx + 16 * c;
      if (col < D) ob[(int64_t)row * p.o.t + col] = from_f32<T>(acc[i][c] / l[i]);
    }
    if (tx == 0) lse[(int64_t)bh * p.T + row] = m[i] + logf(l[i]);
  }
}

template <typename T, int DMAX>
cudaError_t launch(const void* q, const void* k, const void* v, const void* mask, void* out,
                   float* lse, const Params& p, int B, cudaStream_t stream) {
  const size_t smem = smem_floats<DMAX>() * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(flash_attn_fwd_kernel<T, DMAX>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((unsigned)(B * p.H), (unsigned)((p.T + BQ - 1) / BQ));
  flash_attn_fwd_kernel<T, DMAX><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), mask,
      static_cast<T*>(out), lse, p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Tiles the kernel was compiled for, so the wrapper can refuse any other.
void dl4j_flash_attn_tile(int* bq, int* bk) {
  *bq = BQ;
  *bk = BK;
}

// strides: 13 element strides, (b, h, t) of q, k, v and out, then the
// mask's row stride.  dtype: 0 = f32, 1 = bf16; mask_dtype: MaskDtype.
// Returns the launch's cudaError_t (0 = success).
int dl4j_flash_attn_fwd(const void* q, const void* k, const void* v, const void* mask,
                        void* out, void* lse, const long long* strides, int B, int H, int T,
                        int S, int D, int mask_dtype, int causal, float scale, int dtype,
                        void* stream) {
  if (B <= 0 || H <= 0 || T <= 0 || S <= 0 || D <= 0 || D > MAX_D ||
      (long long)B * H > 0x7fffffffLL || (T + BQ - 1) / BQ > 65535 ||
      mask_dtype < MASK_NONE || mask_dtype > MASK_F64 ||
      (mask_dtype != MASK_NONE && mask == nullptr))
    return (int)cudaErrorInvalidValue;
  Params p;
  p.q = {strides[0], strides[1], strides[2]};
  p.k = {strides[3], strides[4], strides[5]};
  p.v = {strides[6], strides[7], strides[8]};
  p.o = {strides[9], strides[10], strides[11]};
  p.mask_b = strides[12];
  p.H = H;
  p.T = T;
  p.S = S;
  p.D = D;
  p.mask_dtype = mask_dtype;
  p.causal = causal != 0;
  p.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  if (dtype == 0)
    return (int)(D <= 64 ? launch<float, 64>(q, k, v, mask, out, l, p, B, s)
                         : launch<float, 128>(q, k, v, mask, out, l, p, B, s));
  if (dtype == 1)
    return (int)(D <= 64 ? launch<__nv_bfloat16, 64>(q, k, v, mask, out, l, p, B, s)
                         : launch<__nv_bfloat16, 128>(q, k, v, mask, out, l, p, B, s));
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
