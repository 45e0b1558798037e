// layer_norm_bwd: row LayerNorm backward over the last axis for NVIDIA
// Hopper (sm_90a).
//
// Replaces the TPU kernel deeplearning4j_tpu/ops/norm_kernels.py
// `_ln_bwd_kernel` (reached through `layer_norm_bwd_tpu`), with its
// semantics: x and dy widened to f32, xhat = (x - mean) * rstd from the
// forward's f32 statistics, wdy = dy * gain, c1 = mean(wdy * xhat) and
// c2 = mean(wdy) over the row, dx = (wdy - xhat * c1 - c2) * rstd stored in
// x's dtype; dgain = sum over rows of dy * xhat and dbias = sum over rows of
// dy, in f32, stored in gain's and bias's dtypes.
//
//   x, dy [rows, F] f32 or bf16 (one dtype), rows x_stride / dy_stride
//     elements apart, unit stride in F
//   gain [F] f32 or bf16; mean, rstd [rows] f32 (the forward's)
//   dx [rows, F] contiguous, x's dtype
//   dgain [F] in gain's dtype; dbias [F] in bias's dtype, or null
//   partials [2, nblk, F] f32 scratch
//
// Bound: bytes.  x and dy read once, dx written once, mean and rstd read,
// gain read and dgain/dbias written: at BERT-base's 8192 x 768 rows that
// is 75.5 MB in f32 (22.5 us at 3.35 TB/s) and 37.8 MB in bf16 (11.3 us);
// the arithmetic (~10 f32 operations an element) is far below the card's
// rate.
//
// What the first design lost (0.087 ms f32, 0.081 bf16, 1.06x and 1.32x
// the backward of F.layer_norm): one element per lane a load (a bf16 warp
// load moved 64 bytes); each row read twice (the row sums, then dx);
// accumulators sized for the widest row in its class (64 declared at F =
// 768 where 48 were live); the 8 warps' column sums added one warp at a
// time behind 8 barriers; and a tail kernel of 6 blocks at F = 768, each
// thread adding 256 partials one after another.
//
// Design.
// * Rows.  tpr threads take a row: a warp up to F = 1024 (BERT's 768), 64,
//   128 or 256 threads above (ln_bwd_plan in ops/kernels/layer_norm.py
//   picks tpr, rows_per_block and the block count; 256 threads a block, so
//   256 / tpr rows are in flight in a block).  Thread t of a row holds the
//   NV 16-byte chunks t + tpr * j of x and of dy (8 bf16 or 4 f32 each),
//   loaded once as 16-byte vectors and kept in registers through the two
//   row sums and dx; dx goes out in 16-byte stores.  NV is a template
//   argument, the smallest instance that holds the row actually launched
//   (bf16 768: 3; f32 768: 6).  Where a row is not 16-byte aligned, F is
//   no multiple of the vector width or a base is off 16 bytes, the same
//   chunks are loaded and stored element by element (VEC = false, one NV
//   instance per dtype).  gain sits in shared memory as f32.  The row sums
//   are xor shuffles within a warp, and across its warps in warp order
//   for tpr > 32.
// * dgain and dbias.  Each thread keeps f32 column sums of dy * xhat and
//   dy for its chunks in registers over the block's rows.  At the end the
//   block's row groups write them to shared memory and each column is
//   summed over the groups in a fixed pairwise tree; the block stores its
//   partial [F] for dgain, then for dbias.  A second kernel sums the nblk
//   partials: a block per 32 columns (and per dgain / dbias), whose 16
//   warps each add a fixed share of the partials in order, then a fixed
//   tree over the warps, cast to gain's and bias's dtypes.  No atomics:
//   the result repeats bit for bit.
#include "layer_norm_common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_F = 8192;
constexpr int SMEM_FLOATS = 8192;  // gain as f32, then groups x F column sums
constexpr int SUM_COLS = 32;       // columns a block of the column sum takes
constexpr int SUM_WARPS = 16;

// gain's f32 values at columns [col, col + VW) from shared memory
template <int VW>
__device__ __forceinline__ void gain_chunk(const float* buf, int col, float (&g)[VW]) {
#pragma unroll
  for (int i = 0; i < VW; i += 4) {
    const float4 v = *reinterpret_cast<const float4*>(buf + col + i);
    g[i] = v.x;
    g[i + 1] = v.y;
    g[i + 2] = v.z;
    g[i + 3] = v.w;
  }
}

// v's 8 entries added in one fixed pairwise order
__device__ __forceinline__ float tree8(const float (&v)[8]) {
  return ((v[0] + v[1]) + (v[2] + v[3])) + ((v[4] + v[5]) + (v[6] + v[7]));
}

// The block's column sums of acc (a thread's NV * VW columns) into
// partial [F]: every row group writes its sums, then each column is
// summed over the groups in tree8's order.  buf holds groups * F floats.
template <typename T, int NV>
__device__ __forceinline__ void block_column_sum(const float (&acc)[NV][Chunk<T>::N], float* buf,
                                                 float* partial, int F, int tpr, int group,
                                                 int t) {
  constexpr int VW = Chunk<T>::N;
  const int groups = THREADS / tpr;
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int col = (t + tpr * j) * VW;
    if (col + VW <= F && (F & 3) == 0) {  // 16-byte stores of a whole chunk
#pragma unroll
      for (int i = 0; i < VW; i += 4)
        *reinterpret_cast<float4*>(buf + group * F + col + i) =
            make_float4(acc[j][i], acc[j][i + 1], acc[j][i + 2], acc[j][i + 3]);
    } else {
#pragma unroll
      for (int e = 0; e < VW; ++e)
        if (col + e < F) buf[group * F + col + e] = acc[j][e];
    }
  }
  __syncthreads();
  for (int c = threadIdx.x; c < F; c += THREADS) {
    float v[8];
#pragma unroll
    for (int g = 0; g < 8; ++g) v[g] = g < groups ? buf[g * F + c] : 0.0f;
    partial[c] = tree8(v);
  }
  __syncthreads();  // buf is written again by the next sum
}

template <typename T, typename G, int NV, bool VEC>
__global__ void __launch_bounds__(THREADS, NV * Chunk<T>::N <= 24 ? 2 : 1)
layer_norm_bwd_kernel(const T* __restrict__ x, const G* __restrict__ gain,
                      const float* __restrict__ mean, const float* __restrict__ rstd,
                      const T* __restrict__ dy, T* __restrict__ dx,
                      float* __restrict__ partials, int rows, int F, long long x_stride,
                      long long dy_stride, int tpr, int rows_per_block, int nblk) {
  constexpr int VW = Chunk<T>::N;
  __shared__ __align__(16) float buf[SMEM_FLOATS];
  __shared__ float red[2][WARPS];
  const int groups = THREADS / tpr;
  const int group = threadIdx.x / tpr;
  const int t = threadIdx.x % tpr;
  const int warp = threadIdx.x / 32;
  const int r0 = blockIdx.x * rows_per_block;
  const int r1 = min(r0 + rows_per_block, rows);

  // gain as f32, zero past F up to the last chunk a thread reads
  // (tpr * NV * VW <= SMEM_FLOATS: 32 elements a thread at most)
  const int span = tpr * NV * VW;
  for (int c = threadIdx.x; c < span; c += THREADS)
    buf[c] = c < F ? to_f32(gain[c]) : 0.0f;
  __syncthreads();

  float dg[NV][VW], db[NV][VW];
#pragma unroll
  for (int j = 0; j < NV; ++j)
#pragma unroll
    for (int e = 0; e < VW; ++e) {
      dg[j][e] = 0.0f;
      db[j][e] = 0.0f;
    }
  const float inv_f = 1.0f / (float)F;

  // every thread takes the same trip count (the cross-warp row sums'
  // barriers need it); a group past r1 computes on zeros and stores nothing
  const int iters = (r1 - r0 + groups - 1) / groups;
  for (int it = 0; it < iters; ++it) {
    const int row = r0 + it * groups + group;
    const bool live = row < r1;
    const T* xr = x + (int64_t)(live ? row : r0) * x_stride;
    const T* dyr = dy + (int64_t)(live ? row : r0) * dy_stride;
    uint4 xc[NV], dc[NV];
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int col = (t + tpr * j) * VW;
      xc[j] = load_chunk<T, VEC>(xr, live ? col : F, F);
      dc[j] = load_chunk<T, VEC>(dyr, live ? col : F, F);
    }
    const float mu = live ? mean[row] : 0.0f;
    const float rs = live ? rstd[row] : 0.0f;
    float s1 = 0.0f, s2 = 0.0f;
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      float g[VW];
      gain_chunk<VW>(buf, (t + tpr * j) * VW, g);
#pragma unroll
      for (int e = 0; e < VW; ++e) {
        const float xh = (elem<T>(xc[j], e) - mu) * rs;
        const float d = elem<T>(dc[j], e);
        const float w = d * g[e];
        s1 = fmaf(w, xh, s1);
        s2 += w;
        dg[j][e] = fmaf(d, xh, dg[j][e]);
        db[j][e] += d;
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      s1 += __shfl_xor_sync(0xffffffffu, s1, o);
      s2 += __shfl_xor_sync(0xffffffffu, s2, o);
    }
    if (tpr > 32) {  // the row's warps, in warp order
      if (threadIdx.x % 32 == 0) {
        red[0][warp] = s1;
        red[1][warp] = s2;
      }
      __syncthreads();
      const int w0 = group * (tpr / 32);
      s1 = 0.0f;
      s2 = 0.0f;
      for (int w = 0; w < tpr / 32; ++w) {
        s1 += red[0][w0 + w];
        s2 += red[1][w0 + w];
      }
      __syncthreads();  // red is written again by the next row
    }
    const float c1 = s1 * inv_f;
    const float c2 = s2 * inv_f;
    if (live) {
      T* dxr = dx + (int64_t)row * F;
#pragma unroll
      for (int j = 0; j < NV; ++j) {
        const int col = (t + tpr * j) * VW;
        float g[VW];
        gain_chunk<VW>(buf, col, g);
        uint4 o = make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
        for (int e = 0; e < VW; ++e) {
          const float xh = (elem<T>(xc[j], e) - mu) * rs;
          const float w = elem<T>(dc[j], e) * g[e];
          set_elem<T>(o, e, round_bits<T>((w - xh * c1 - c2) * rs));
        }
        store_chunk<T, VEC>(dxr, col, F, o);
      }
    }
  }
  __syncthreads();  // gain's buffer becomes the column sums'

  block_column_sum<T, NV>(dg, buf, partials + (int64_t)blockIdx.x * F, F, tpr, group, t);
  block_column_sum<T, NV>(db, buf, partials + ((int64_t)nblk + blockIdx.x) * F, F, tpr,
                          group, t);
}

// out[c] = the sum over the nblk partials of column c, cast to f32
// (bf16 == 0) or bf16; blockIdx.y picks dgain (0) or dbias (1).  Warp w
// adds the partials [w * nblk / 16, (w + 1) * nblk / 16) in order, then
// the 16 warps' sums are added in a fixed tree.
__global__ void __launch_bounds__(SUM_COLS * SUM_WARPS)
column_sum_kernel(const float* __restrict__ partials, int nblk, int F, void* dgain,
                  int dgain_bf16, void* dbias, int dbias_bf16) {
  __shared__ float red[SUM_WARPS][SUM_COLS + 1];
  const int lane = threadIdx.x % SUM_COLS;
  const int w = threadIdx.x / SUM_COLS;
  const int c = blockIdx.x * SUM_COLS + lane;
  const int which = blockIdx.y;
  const float* p = partials + (int64_t)which * nblk * F;
  const int lo = (int)((int64_t)w * nblk / SUM_WARPS);
  const int hi = (int)((int64_t)(w + 1) * nblk / SUM_WARPS);
  float s = 0.0f;
  if (c < F) {
#pragma unroll 4
    for (int b = lo; b < hi; ++b) s += __ldg(p + (int64_t)b * F + c);
  }
  red[w][lane] = s;
  __syncthreads();
#pragma unroll
  for (int half = SUM_WARPS / 2; half > 0; half >>= 1) {
    if (w < half) red[w][lane] += red[w + half][lane];
    __syncthreads();
  }
  void* out = which == 0 ? dgain : dbias;
  if (w != 0 || c >= F) return;
  if (which == 0 ? dgain_bf16 : dbias_bf16)
    static_cast<__nv_bfloat16*>(out)[c] = __float2bfloat16_rn(red[0][lane]);
  else
    static_cast<float*>(out)[c] = red[0][lane];
}

template <typename T, typename G>
cudaError_t launch(const void* x, const void* gain, const float* mean, const float* rstd,
                   const void* dy, void* dx, float* partials, int rows, int F,
                   long long x_stride, long long dy_stride, int tpr, int rows_per_block,
                   int nblk, cudaStream_t stream) {
  constexpr int VW = Chunk<T>::N;
  constexpr int NV_MAX = 32 / VW;  // 32 elements a thread at most
  const T* xt = static_cast<const T*>(x);
  const G* gt = static_cast<const G*>(gain);
  const T* dyt = static_cast<const T*>(dy);
  T* dxt = static_cast<T*>(dx);
  const int chunks = (F + VW - 1) / VW;
  const int nv = (chunks + tpr - 1) / tpr;
  if (nv > NV_MAX) return cudaErrorInvalidValue;
  const bool vec = F % VW == 0 && (x_stride * (long long)sizeof(T)) % 16 == 0
                   && (dy_stride * (long long)sizeof(T)) % 16 == 0 && aligned16(x)
                   && aligned16(dy) && aligned16(dx);
#define DL4J_LN_BWD(NV, VEC)                                                                \
  layer_norm_bwd_kernel<T, G, NV, VEC><<<(unsigned)nblk, THREADS, 0, stream>>>(              \
      xt, gt, mean, rstd, dyt, dxt, partials, rows, F, x_stride, dy_stride, tpr,           \
      rows_per_block, nblk)
  if (!vec)
    DL4J_LN_BWD(NV_MAX, false);
  else if (nv <= 1)
    DL4J_LN_BWD(1, true);
  else if (nv <= 2)
    DL4J_LN_BWD(2, true);
  else if (nv <= 3)
    DL4J_LN_BWD(3, true);
  else if (nv <= 4)
    DL4J_LN_BWD(4, true);
  else if (nv <= 6)
    DL4J_LN_BWD((NV_MAX >= 6 ? 6 : NV_MAX), true);
  else
    DL4J_LN_BWD(NV_MAX, true);
#undef DL4J_LN_BWD
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype, gain_dtype, bias_dtype: 0 = f32, 1 = bf16 (bias_dtype is read only
// when dbias is not null).  threads_per_row (32, 64, 128 or 256),
// rows_per_block and nblk = ceil(rows / rows_per_block) come from
// ln_bwd_plan; partials holds [2, nblk, F] f32.  Returns the first failing
// launch's cudaError_t (0 = success).
int dl4j_layer_norm_bwd(const void* x, const void* gain, const void* mean, const void* rstd,
                        const void* dy, void* dx, void* dgain, void* dbias, void* partials,
                        int rows, int F, long long x_stride, long long dy_stride,
                        int threads_per_row, int rows_per_block, int nblk, int dtype,
                        int gain_dtype, int bias_dtype, void* stream) {
  const int tpr = threads_per_row;
  if (rows <= 0 || F <= 0 || F > MAX_F || x_stride < F || dy_stride < F || gain == nullptr ||
      dgain == nullptr || partials == nullptr || (tpr != 32 && tpr != 64 && tpr != 128 &&
      tpr != THREADS) || (long long)(THREADS / tpr) * F > SMEM_FLOATS ||
      rows_per_block <= 0 || nblk != (int)(((long long)rows + rows_per_block - 1) / rows_per_block) ||
      (unsigned)dtype > 1u || (unsigned)gain_dtype > 1u || (unsigned)bias_dtype > 1u)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* m = static_cast<const float*>(mean);
  const float* r = static_cast<const float*>(rstd);
  float* part = static_cast<float*>(partials);
  cudaError_t e;
  switch (dtype * 2 + gain_dtype) {
    case 0:
      e = launch<float, float>(x, gain, m, r, dy, dx, part, rows, F, x_stride, dy_stride, tpr,
                               rows_per_block, nblk, s);
      break;
    case 1:
      e = launch<float, __nv_bfloat16>(x, gain, m, r, dy, dx, part, rows, F, x_stride,
                                       dy_stride, tpr, rows_per_block, nblk, s);
      break;
    case 2:
      e = launch<__nv_bfloat16, float>(x, gain, m, r, dy, dx, part, rows, F, x_stride,
                                       dy_stride, tpr, rows_per_block, nblk, s);
      break;
    default:
      e = launch<__nv_bfloat16, __nv_bfloat16>(x, gain, m, r, dy, dx, part, rows, F, x_stride,
                                               dy_stride, tpr, rows_per_block, nblk, s);
  }
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((unsigned)((F + SUM_COLS - 1) / SUM_COLS), dbias == nullptr ? 1u : 2u);
  column_sum_kernel<<<grid, SUM_COLS * SUM_WARPS, 0, s>>>(part, nblk, F, dgain, gain_dtype,
                                                          dbias, bias_dtype);
  return (int)cudaGetLastError();
}

}  // extern "C"
