// flash_attn_bwd: flash-attention backward for NVIDIA Hopper (sm_90a), two
// kernels: dQ, then dK/dV.
//
// Replaces the TPU kernels deeplearning4j_tpu/ops/attention_kernels.py
// `_flash_bwd_dq_kernel` and `_flash_bwd_dkv_kernel` (reached through
// `flash_attention_bwd_tpu`), with their semantics (FlashAttention-2's
// backward): delta = rowsum(dO * out) in f32; the scores s = q.k * scale in
// f32 plus the keep-mask bias are rebuilt exactly as the forward kernel
// (csrc/flash_attn_fwd.cu) made them, and p = exp(s - lse) from the
// forward's lse, so no [T, S] matrix is stored; dP = dO.v in f32; dS =
// p * (dP - delta);
//   dq = sum over keys of (dS in k's dtype) . k * scale
//   dv = sum over queries of (p in dO's dtype)^T . dO
//   dk = sum over queries of (dS in q's dtype)^T . q * scale
// each accumulated in f32 and stored in its input's dtype.  The forward's
// masking is repeated: keep-mask zeros add NEG_INF = -1e30, keys beyond S
// (the ragged tail) and, under `causal`, keys after the query (col > row)
// get -inf, so p is 0 there.  As in the TPU kernels, a row whose every key
// is masked has lse = NEG_INF and rebuilds p = exp(0) = 1 there.
//
//   q, out, dO, dq [B, H, T, D]; k, v, dk, dv [B, H, S, D]: one dtype, f32
//     or bf16, any strides over (b, h, t), unit stride over D, D <= 128
//   lse, delta [B*H, T] f32, contiguous (delta is written by the dQ kernel
//     and read by the dK/dV kernel)
//   mask [B, S] keep-mask (f32, bf16, f16 or f64), rows mask_b apart, or null
//
// Design.  The forward's block and thread layout: 256 threads as a 16 x 16
// grid, each owning a 4 x 4 patch of a 64 x 64 score tile (rows ty + 16i,
// columns tx + 16j) and 4 x D/16 f32 accumulators in registers; tiles
// staged in shared memory as f32 (bf16 widened on load), rows padded to
// D + 1 for conflict-free column reads; nothing crosses blocks and there
// are no atomics, so the result repeats bit for bit.
// - dQ: one block per (b*h, 64 query rows).  The TPU kernel's sequential
//   kv grid axis and its VMEM dq scratch become a loop over 64-row K/V
//   tiles with dq in registers.  The block first computes delta for its
//   rows from dO (staged) and out (read once), keeps delta and lse in
//   registers and writes delta for the dK/dV kernel: the JAX wrapper's
//   separate XLA reduction is folded in.  Per KV tile it forms s and dP
//   (two products over D), p and dS, rounds dS to k's dtype into shared
//   memory and adds dS.K.  Under `causal` KV tiles wholly after the query
//   tile are not visited.
// - dK/dV: one block per (b*h, 64 key rows), with K and V staged once and
//   a loop over 64-row Q/dO tiles; p and dS are formed key-major, rounded
//   to dO's and q's dtypes into shared memory, and P^T.dO and dS^T.Q
//   accumulate in registers.  Under `causal` query tiles wholly before the
//   key tile are not visited.
// The JAX wrapper's padding of T and S and its materialized [B, 1, S] bias
// have no counterpart: tails are masked here and the mask is read in place,
// batch row b = (b*h) / H.
//
// Bound.  Operations: 2*B*H*T*S*D per product, 3 products in dQ (s, dP,
// dS.K) and 4 in dK/dV (s, dP, P^T.dO, dS^T.Q), halved under causal.
// Bytes: dQ reads q, k, v, out, dO, lse and writes dq and delta; dK/dV reads
// q, k, v, dO, lse, delta and writes dk, dv.  BERT-base at [64, 12, 128, 64]:
// dQ 4.8 GFLOP, 0.072 ms at the 67 TFLOP/s f32 rate (its 152 MB of f32
// bytes take 0.045 ms) -> operations; in bf16 76 MB -> bytes, 0.023 ms.  dK/dV
// 6.4 GFLOP, 0.096 ms in f32 (operations); 76 MB, 0.023 ms in bf16 (bytes).
// At [4, 12, 2048, 64] operations bound both: dQ 1.15 ms f32 and 0.078 ms
// bf16, dK/dV 1.54 and 0.104 ms.  A SIMT kernel cannot use the tensor
// cores, so the bf16 bounds are far out of its reach.  Known gap, left for
// a later change: wgmma for the products, TMA or cp.async double buffering
// of the tiles.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;        // query rows per tile
constexpr int BK = 64;        // key/value rows per tile
constexpr int THREADS = 256;  // 16 x 16
constexpr int TR = 4;         // tile rows per thread, 16 apart
constexpr int TC = 4;         // tile columns per thread, 16 apart
constexpr int LDP = 65;       // padded row of the p and dS tiles
constexpr int MAX_D = 128;
constexpr float NEG_INF = -1e30f;

enum MaskDtype { MASK_NONE = 0, MASK_F32 = 1, MASK_BF16 = 2, MASK_F16 = 3, MASK_F64 = 4 };

struct Strides {
  long long b, h, t;
};

struct Params {
  Strides q, k, v, o, g, dq, dk, dv;
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

// v rounded to T, as the TPU kernels' .astype(dtype) before a product
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

// The forward kernel's bias of key `col`: -inf beyond S, else 0 or NEG_INF
// from the keep-mask.
__device__ __forceinline__ float key_bias_of(const Params& p, const void* mask, int b, int col) {
  if (col >= p.S) return -INFINITY;
  if (p.mask_dtype == MASK_NONE) return 0.0f;
  return mask_value(mask, p.mask_dtype, (long long)b * p.mask_b + col) > 0.0f ? 0.0f : NEG_INF;
}

// rows [t0, t0 + 64) of a [*, D] slice into a [64][LD] f32 tile, zeros
// beyond `n` rows and D columns
template <typename T, int DMAX>
__device__ __forceinline__ void load_tile(float* dst, const T* src, long long row_stride, int t0,
                                          int n, int D) {
  constexpr int LD = DMAX + 1;
  for (int idx = threadIdx.x; idx < 64 * DMAX; idx += THREADS) {
    const int r = idx / DMAX, c = idx % DMAX;
    const int t = t0 + r;
    dst[r * LD + c] = (t < n && c < D) ? to_f32(src[(int64_t)t * row_stride + c]) : 0.0f;
  }
}

template <int DMAX>
constexpr size_t dq_smem_floats() {
  // Q, dO, K, V padded to DMAX + 1; dS; the key bias
  return 4 * (size_t)64 * (DMAX + 1) + (size_t)BQ * LDP + BK;
}

template <int DMAX>
constexpr size_t dkv_smem_floats() {
  // K, V, Q, dO padded to DMAX + 1; p and dS (key-major); lse, delta, key bias
  return 4 * (size_t)64 * (DMAX + 1) + 2 * (size_t)BK * LDP + BQ + BQ + BK;
}

template <typename T, int DMAX>
__global__ void __launch_bounds__(THREADS)
flash_attn_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ o,
                         const T* __restrict__ g, const float* __restrict__ lse,
                         const void* __restrict__ mask, T* __restrict__ dq,
                         float* __restrict__ delta, const Params p) {
  constexpr int LD = DMAX + 1;
  constexpr int DC = DMAX / 16;  // output columns per thread, 16 apart
  extern __shared__ float smem[];
  float* Qs = smem;                 // [BQ][LD]
  float* Gs = Qs + BQ * LD;         // [BQ][LD] dO
  float* Ks = Gs + BQ * LD;         // [BK][LD]
  float* Vs = Ks + BK * LD;         // [BK][LD]
  float* Ds = Vs + BK * LD;         // [BQ][LDP] dS in k's dtype
  float* key_bias = Ds + BQ * LDP;  // [BK]

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int bh = blockIdx.x;
  const int b = bh / p.H;
  const int h = bh % p.H;
  const int q0 = blockIdx.y * BQ;
  const int D = p.D;
  const T* kb = k + b * p.k.b + h * p.k.h;
  const T* vb = v + b * p.v.b + h * p.v.h;
  const T* ob = o + b * p.o.b + h * p.o.h;

  load_tile<T, DMAX>(Qs, q + b * p.q.b + h * p.q.h, p.q.t, q0, p.T, D);
  load_tile<T, DMAX>(Gs, g + b * p.g.b + h * p.g.h, p.g.t, q0, p.T, D);
  __syncthreads();

  // delta = rowsum(dO * out) for this thread's rows, reduced over the 16
  // threads of a row; lse beside it.  Rows beyond T take p = 0 below.
  float lse_r[TR], delta_r[TR];
#pragma unroll
  for (int i = 0; i < TR; ++i) {
    const int row = q0 + ty + 16 * i;
    float d = 0.0f;
    if (row < p.T) {
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        const int col = tx + 16 * c;
        if (col < D) d = fmaf(Gs[(ty + 16 * i) * LD + col], to_f32(ob[(int64_t)row * p.o.t + col]), d);
      }
    }
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) d += __shfl_xor_sync(0xffffffffu, d, off);
    delta_r[i] = d;
    lse_r[i] = row < p.T ? lse[(int64_t)bh * p.T + row] : 0.0f;
    if (tx == 0 && row < p.T) delta[(int64_t)bh * p.T + row] = d;
  }

  float acc[TR][DC];
#pragma unroll
  for (int i = 0; i < TR; ++i)
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.0f;

  int nkv = (p.S + BK - 1) / BK;
  if (p.causal) {
    const int q_last = min(q0 + BQ, p.T) - 1;
    nkv = min(nkv, q_last / BK + 1);
  }

  for (int j = 0; j < nkv; ++j) {
    const int k0 = j * BK;
    __syncthreads();  // the last tile's K and dS are read
    load_tile<T, DMAX>(Ks, kb, p.k.t, k0, p.S, D);
    load_tile<T, DMAX>(Vs, vb, p.v.t, k0, p.S, D);
    if (tid < BK) key_bias[tid] = key_bias_of(p, mask, b, k0 + tid);
    __syncthreads();

    float s[TR][TC], dp[TR][TC];
#pragma unroll
    for (int i = 0; i < TR; ++i)
#pragma unroll
      for (int c = 0; c < TC; ++c) {
        s[i][c] = 0.0f;
        dp[i][c] = 0.0f;
      }
    // the tiles are zero beyond D, so the fixed trip count adds only zeros
#pragma unroll 4
    for (int d = 0; d < DMAX; ++d) {
      float a[TR], gg[TR], kk[TC], vv[TC];
#pragma unroll
      for (int i = 0; i < TR; ++i) {
        a[i] = Qs[(ty + 16 * i) * LD + d];
        gg[i] = Gs[(ty + 16 * i) * LD + d];
      }
#pragma unroll
      for (int c = 0; c < TC; ++c) {
        kk[c] = Ks[(tx + 16 * c) * LD + d];
        vv[c] = Vs[(tx + 16 * c) * LD + d];
      }
#pragma unroll
      for (int i = 0; i < TR; ++i)
#pragma unroll
        for (int c = 0; c < TC; ++c) {
          s[i][c] = fmaf(a[i], kk[c], s[i][c]);
          dp[i][c] = fmaf(gg[i], vv[c], dp[i][c]);
        }
    }

#pragma unroll
    for (int i = 0; i < TR; ++i) {
      const int row = q0 + ty + 16 * i;
#pragma unroll
      for (int c = 0; c < TC; ++c) {
        const int col = k0 + tx + 16 * c;
        float sv = s[i][c] * p.scale + key_bias[tx + 16 * c];
        if (p.causal && col > row) sv = -INFINITY;
        const float pv = row < p.T ? expf(sv - lse_r[i]) : 0.0f;
        Ds[(ty + 16 * i) * LDP + tx + 16 * c] = round_to<T>(pv * (dp[i][c] - delta_r[i]));
      }
    }
    __syncthreads();

#pragma unroll 8
    for (int kk = 0; kk < BK; ++kk) {
      float dsr[TR], kc[DC];
#pragma unroll
      for (int i = 0; i < TR; ++i) dsr[i] = Ds[(ty + 16 * i) * LDP + kk];
#pragma unroll
      for (int c = 0; c < DC; ++c) kc[c] = Ks[kk * LD + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < TR; ++i)
#pragma unroll
        for (int c = 0; c < DC; ++c) acc[i][c] = fmaf(dsr[i], kc[c], acc[i][c]);
    }
  }

  T* dqb = dq + b * p.dq.b + h * p.dq.h;
#pragma unroll
  for (int i = 0; i < TR; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= p.T) continue;
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      const int col = tx + 16 * c;
      if (col < D) dqb[(int64_t)row * p.dq.t + col] = from_f32<T>(acc[i][c] * p.scale);
    }
  }
}

template <typename T, int DMAX>
__global__ void __launch_bounds__(THREADS)
flash_attn_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, const T* __restrict__ g,
                          const float* __restrict__ lse, const float* __restrict__ delta,
                          const void* __restrict__ mask, T* __restrict__ dk,
                          T* __restrict__ dv, const Params p) {
  constexpr int LD = DMAX + 1;
  constexpr int DC = DMAX / 16;
  extern __shared__ float smem[];
  float* Ks = smem;                 // [BK][LD]
  float* Vs = Ks + BK * LD;         // [BK][LD]
  float* Qs = Vs + BK * LD;         // [BQ][LD]
  float* Gs = Qs + BQ * LD;         // [BQ][LD] dO
  float* Ps = Gs + BQ * LD;         // [BK][LDP] p in dO's dtype, key-major
  float* Ds = Ps + BK * LDP;        // [BK][LDP] dS in q's dtype, key-major
  float* lse_s = Ds + BK * LDP;     // [BQ]
  float* delta_s = lse_s + BQ;      // [BQ]
  float* key_bias = delta_s + BQ;   // [BK]

  const int tid = threadIdx.x;
  const int tx = tid % 16;  // query columns of the score tile, output columns
  const int ty = tid / 16;  // key rows
  const int bh = blockIdx.x;
  const int b = bh / p.H;
  const int h = bh % p.H;
  const int k0 = blockIdx.y * BK;
  const int D = p.D;
  const T* qb = q + b * p.q.b + h * p.q.h;
  const T* gb = g + b * p.g.b + h * p.g.h;

  load_tile<T, DMAX>(Ks, k + b * p.k.b + h * p.k.h, p.k.t, k0, p.S, D);
  load_tile<T, DMAX>(Vs, v + b * p.v.b + h * p.v.h, p.v.t, k0, p.S, D);
  if (tid < BK) key_bias[tid] = key_bias_of(p, mask, b, k0 + tid);

  float dk_acc[TR][DC], dv_acc[TR][DC];
#pragma unroll
  for (int i = 0; i < TR; ++i)
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      dk_acc[i][c] = 0.0f;
      dv_acc[i][c] = 0.0f;
    }

  const int nq = (p.T + BQ - 1) / BQ;
  const int first = p.causal ? k0 / BQ : 0;
  for (int qi = first; qi < nq; ++qi) {
    const int q0 = qi * BQ;
    __syncthreads();  // K, V and the bias are in; the last tile's Q, dO, p, dS are read
    load_tile<T, DMAX>(Qs, qb, p.q.t, q0, p.T, D);
    load_tile<T, DMAX>(Gs, gb, p.g.t, q0, p.T, D);
    if (tid < BQ) {
      const int row = q0 + tid;
      lse_s[tid] = row < p.T ? lse[(int64_t)bh * p.T + row] : 0.0f;
      delta_s[tid] = row < p.T ? delta[(int64_t)bh * p.T + row] : 0.0f;
    }
    __syncthreads();

    float s[TR][TC], dp[TR][TC];
#pragma unroll
    for (int i = 0; i < TR; ++i)
#pragma unroll
      for (int c = 0; c < TC; ++c) {
        s[i][c] = 0.0f;
        dp[i][c] = 0.0f;
      }
#pragma unroll 4
    for (int d = 0; d < DMAX; ++d) {
      float kk[TR], vv[TR], qq[TC], gg[TC];
#pragma unroll
      for (int i = 0; i < TR; ++i) {
        kk[i] = Ks[(ty + 16 * i) * LD + d];
        vv[i] = Vs[(ty + 16 * i) * LD + d];
      }
#pragma unroll
      for (int c = 0; c < TC; ++c) {
        qq[c] = Qs[(tx + 16 * c) * LD + d];
        gg[c] = Gs[(tx + 16 * c) * LD + d];
      }
#pragma unroll
      for (int i = 0; i < TR; ++i)
#pragma unroll
        for (int c = 0; c < TC; ++c) {
          s[i][c] = fmaf(kk[i], qq[c], s[i][c]);
          dp[i][c] = fmaf(vv[i], gg[c], dp[i][c]);
        }
    }

#pragma unroll
    for (int i = 0; i < TR; ++i) {
      const int key = k0 + ty + 16 * i;
      const float bias = key_bias[ty + 16 * i];
#pragma unroll
      for (int c = 0; c < TC; ++c) {
        const int r = tx + 16 * c;
        const int row = q0 + r;
        float sv = s[i][c] * p.scale + bias;
        if (p.causal && key > row) sv = -INFINITY;
        const float pv = row < p.T ? expf(sv - lse_s[r]) : 0.0f;
        Ps[(ty + 16 * i) * LDP + r] = round_to<T>(pv);
        Ds[(ty + 16 * i) * LDP + r] = round_to<T>(pv * (dp[i][c] - delta_s[r]));
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int r = 0; r < BQ; ++r) {
      float pr[TR], dr[TR], gc[DC], qc[DC];
#pragma unroll
      for (int i = 0; i < TR; ++i) {
        pr[i] = Ps[(ty + 16 * i) * LDP + r];
        dr[i] = Ds[(ty + 16 * i) * LDP + r];
      }
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        gc[c] = Gs[r * LD + tx + 16 * c];
        qc[c] = Qs[r * LD + tx + 16 * c];
      }
#pragma unroll
      for (int i = 0; i < TR; ++i)
#pragma unroll
        for (int c = 0; c < DC; ++c) {
          dv_acc[i][c] = fmaf(pr[i], gc[c], dv_acc[i][c]);
          dk_acc[i][c] = fmaf(dr[i], qc[c], dk_acc[i][c]);
        }
    }
  }

  T* dkb = dk + b * p.dk.b + h * p.dk.h;
  T* dvb = dv + b * p.dv.b + h * p.dv.h;
#pragma unroll
  for (int i = 0; i < TR; ++i) {
    const int key = k0 + ty + 16 * i;
    if (key >= p.S) continue;
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      const int col = tx + 16 * c;
      if (col < D) {
        dkb[(int64_t)key * p.dk.t + col] = from_f32<T>(dk_acc[i][c] * p.scale);
        dvb[(int64_t)key * p.dv.t + col] = from_f32<T>(dv_acc[i][c]);
      }
    }
  }
}

template <typename T, int DMAX>
cudaError_t launch_dq(const void* q, const void* k, const void* v, const void* o, const void* g,
                      const float* lse, const void* mask, void* dq, float* delta,
                      const Params& p, int B, cudaStream_t stream) {
  const size_t smem = dq_smem_floats<DMAX>() * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(flash_attn_bwd_dq_kernel<T, DMAX>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((unsigned)(B * p.H), (unsigned)((p.T + BQ - 1) / BQ));
  flash_attn_bwd_dq_kernel<T, DMAX><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(o), static_cast<const T*>(g), lse, mask, static_cast<T*>(dq), delta,
      p);
  return cudaGetLastError();
}

template <typename T, int DMAX>
cudaError_t launch_dkv(const void* q, const void* k, const void* v, const void* g,
                       const float* lse, const float* delta, const void* mask, void* dk,
                       void* dv, const Params& p, int B, cudaStream_t stream) {
  const size_t smem = dkv_smem_floats<DMAX>() * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(flash_attn_bwd_dkv_kernel<T, DMAX>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((unsigned)(B * p.H), (unsigned)((p.S + BK - 1) / BK));
  flash_attn_bwd_dkv_kernel<T, DMAX><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(g), lse, delta, mask, static_cast<T*>(dk), static_cast<T*>(dv), p);
  return cudaGetLastError();
}

// Fills Params from the wrapper's 25 strides, or returns false on a shape
// the kernels do not take.
bool make_params(Params* p, const long long* strides, int B, int H, int T, int S, int D,
                 int mask_dtype, const void* mask, int causal, float scale) {
  if (B <= 0 || H <= 0 || T <= 0 || S <= 0 || D <= 0 || D > MAX_D ||
      (long long)B * H > 0x7fffffffLL || (T + BQ - 1) / BQ > 65535 ||
      (S + BK - 1) / BK > 65535 || mask_dtype < MASK_NONE || mask_dtype > MASK_F64 ||
      (mask_dtype != MASK_NONE && mask == nullptr))
    return false;
  Strides* s[8] = {&p->q, &p->k, &p->v, &p->o, &p->g, &p->dq, &p->dk, &p->dv};
  for (int i = 0; i < 8; ++i) *s[i] = {strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  p->mask_b = strides[24];
  p->H = H;
  p->T = T;
  p->S = S;
  p->D = D;
  p->mask_dtype = mask_dtype;
  p->causal = causal != 0;
  p->scale = scale;
  return true;
}

}  // namespace

extern "C" {

// strides: 25 element strides, (b, h, t) of q, k, v, out, dO, dq, dk and
// dv, then the mask's row stride.  dtype: 0 = f32, 1 = bf16; mask_dtype:
// MaskDtype.  Each returns the launch's cudaError_t (0 = success).

// dq and delta [B*H, T] (for dl4j_flash_attn_bwd_dkv) from q, k, v, out, dO
// and the forward's lse.
int dl4j_flash_attn_bwd_dq(const void* q, const void* k, const void* v, const void* out,
                           const void* dout, const void* lse, const void* mask, void* dq,
                           void* delta, const long long* strides, int B, int H, int T, int S,
                           int D, int mask_dtype, int causal, float scale, int dtype,
                           void* stream) {
  Params p;
  if (!make_params(&p, strides, B, H, T, S, D, mask_dtype, mask, causal, scale))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  if (dtype == 0)
    return (int)(D <= 64 ? launch_dq<float, 64>(q, k, v, out, dout, l, mask, dq, dl, p, B, s)
                         : launch_dq<float, 128>(q, k, v, out, dout, l, mask, dq, dl, p, B, s));
  if (dtype == 1)
    return (int)(D <= 64
                     ? launch_dq<__nv_bfloat16, 64>(q, k, v, out, dout, l, mask, dq, dl, p, B, s)
                     : launch_dq<__nv_bfloat16, 128>(q, k, v, out, dout, l, mask, dq, dl, p, B, s));
  return (int)cudaErrorInvalidValue;
}

// dk and dv from q, k, v, dO, the forward's lse and the dQ kernel's delta.
int dl4j_flash_attn_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                            const void* lse, const void* delta, const void* mask, void* dk,
                            void* dv, const long long* strides, int B, int H, int T, int S,
                            int D, int mask_dtype, int causal, float scale, int dtype,
                            void* stream) {
  Params p;
  if (!make_params(&p, strides, B, H, T, S, D, mask_dtype, mask, causal, scale))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  if (dtype == 0)
    return (int)(D <= 64 ? launch_dkv<float, 64>(q, k, v, dout, l, dl, mask, dk, dv, p, B, s)
                         : launch_dkv<float, 128>(q, k, v, dout, l, dl, mask, dk, dv, p, B, s));
  if (dtype == 1)
    return (int)(D <= 64
                     ? launch_dkv<__nv_bfloat16, 64>(q, k, v, dout, l, dl, mask, dk, dv, p, B, s)
                     : launch_dkv<__nv_bfloat16, 128>(q, k, v, dout, l, dl, mask, dk, dv, p, B,
                                                      s));
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
