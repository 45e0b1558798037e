// paged_attention: one decode token per sequence attending over its history
// in a shared pool of KV pages, for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel deeplearning4j_tpu/ops/pallas/paged_attention.py
// `_paged_kernel` (via `paged_attention`): for each (sequence b, head h) it
// walks the sequence's pages in block-table order and folds each page into
// an online softmax kept in f32, in the TPU kernel's order:
//   m = -1e30 (NEG_INF, not -inf), l = 0, acc = 0;
//   for each page p with p * page < seq_len:
//     s_j = (q . k_j) * sm_scale, and s_j = -1e30 where p*page + j >= seq_len;
//     m_new = max(m, max_j s_j); corr = exp(m - m_new); w_j = exp(s_j - m_new);
//     acc = acc * corr + sum_j w_j v_j;  l = l * corr + sum_j w_j;  m = m_new;
//   out = acc / max(l, 1e-37), cast to q's dtype.
// int8 pages widen as f32(x) * f32(scale) with one scale per (token, head)
// (`dequant_rows`).
//
//   q            [B, H, D]         f32 or bf16
//   k/v pages    [P, page, H, D]   q's dtype, or int8 with
//   k/v scales   [P, page, H]      f32
//   block_tables [B, max_pages]    int32; only the first ceil(seq_len/page)
//                                  slots of a row are read
//   seq_lens     [B]               int32, >= 1
//   out          [B, H, D]         q's dtype
//
// Design.  One block of 128 threads (4 warps) per (b, h); the TPU's
// sequential page axis becomes a loop inside the block, and the block reads
// its own block-table row (the TPU prefetches it as scalars).  The loop
// takes a chunk of pages at a time (up to 64 rows, within a shared-memory
// budget): all 128 threads first copy the chunk's K and V rows for head h
// into shared memory, widened to f32 (int8 rows times their scale), each
// thread issuing 8 loads of K and 8 of V before it stores any, so many are
// in flight at once; rows at or past seq_len are not read (stored as 0).  Then each warp computes the
// scores of every 4th row of the chunk (lanes stride over D, a fixed-order
// shuffle sum), and the online softmax above runs page by page over the
// chunk, in the TPU kernel's order: every thread computes m, corr and l
// itself from the scores in shared memory, in the same order, so all agree
// to the bit, and thread t owns the output dims t and t + 128.  One head's
// rows are strided by H * D in the pool.
//
// Bound: bytes.  At [16, 12, 64] with 2,048-token histories f32 pages the
// kernel must read 16 * 2048 * 12 * 64 * 4 * 2 = 201 MB of K and V, about
// 60 us at 3.35 TB/s (int8 pages: a quarter of that plus the scales).
// Known gap, left for a later change: one block per (b, h) gives 192
// blocks at that shape, under two per SM, and each block walks its chunks
// one after another; splitting the history across blocks (split-K with a
// second pass), a copy pipeline (cp.async or TMA) and 16-byte loads are the
// way out.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_D = 256;
constexpr int MAX_PAGE = 64;
constexpr int CHUNK_ROWS = 64;                 // rows staged per chunk, at most
constexpr int SMEM_BUDGET = 96 * 1024;         // bytes of K/V staging, at most
constexpr int STAGE_UNROLL = 8;                // K and V loads in flight a thread
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(int8_t v) { return static_cast<float>(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// Pages per chunk: as many as fit in CHUNK_ROWS rows and the byte budget.
int pages_per_chunk(int page, int D) {
  int ppc = CHUNK_ROWS / page;
  while (ppc > 1 && 2 * ppc * page * D * 4 > SMEM_BUDGET) --ppc;
  return ppc < 1 ? 1 : ppc;
}

size_t smem_bytes(int page, int D) {
  const int rows = pages_per_chunk(page, D) * page;
  return (size_t)(D + rows + 2 * rows * D) * sizeof(float);
}

template <typename TQ, typename KV>
__global__ void __launch_bounds__(THREADS)
paged_attention_kernel(const TQ* __restrict__ q, const KV* __restrict__ kp,
                       const KV* __restrict__ vp, const float* __restrict__ ks,
                       const float* __restrict__ vs,
                       const int* __restrict__ block_tables,
                       const int* __restrict__ seq_lens, TQ* __restrict__ out,
                       int H, int D, int page, int max_pages, int ppc, float sm_scale) {
  extern __shared__ float smem[];
  const int rows = ppc * page;
  float* qs = smem;                 // [D]
  float* s = qs + D;                // [rows]
  float* Ks = s + rows;             // [rows][D]
  float* Vs = Ks + rows * D;        // [rows][D]

  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int seq_len = seq_lens[b];
  const int* bt = block_tables + (int64_t)b * max_pages;

  for (int d = tid; d < D; d += THREADS) qs[d] = to_f32(q[((int64_t)b * H + h) * D + d]);
  float acc0 = 0.0f, acc1 = 0.0f;  // output dims tid and tid + THREADS
  float m = NEG_INF, l = 0.0f;

  const int n_pages = min((seq_len + page - 1) / page, max_pages);
  for (int p0 = 0; p0 < n_pages; p0 += ppc) {
    const int np = min(ppc, n_pages - p0);
    // stage the chunk's K and V rows of head h, widened to f32: each thread
    // issues STAGE_UNROLL loads of K and of V before it stores any, so they
    // are in flight together (the loop bound is not known at compile time,
    // and a load followed by its store would otherwise wait one by one)
    const int total = np * page * D;
    for (int base = tid; base < total; base += THREADS * STAGE_UNROLL) {
      float kv[STAGE_UNROLL], vv[STAGE_UNROLL];
#pragma unroll
      for (int u = 0; u < STAGE_UNROLL; ++u) {
        const int i = base + u * THREADS;
        kv[u] = 0.0f;
        vv[u] = 0.0f;
        const int r = i / D, d = i - r * D;
        const int pg = p0 + r / page;
        if (i < total && pg * page + r % page < seq_len) {
          const int64_t row = ((int64_t)bt[pg] * page + r % page) * H + h;
          kv[u] = to_f32(kp[row * D + d]);
          vv[u] = to_f32(vp[row * D + d]);
          if (ks != nullptr) {
            kv[u] = __fmul_rn(kv[u], ks[row]);
            vv[u] = __fmul_rn(vv[u], vs[row]);
          }
        }
      }
#pragma unroll
      for (int u = 0; u < STAGE_UNROLL; ++u) {
        const int i = base + u * THREADS;
        if (i < total) {
          Ks[i] = kv[u];
          Vs[i] = vv[u];
        }
      }
    }
    __syncthreads();
    // scores of the chunk's rows: warp w takes rows w, w + 4, ...
    for (int r = warp; r < np * page; r += WARPS) {
      const bool valid = (p0 + r / page) * page + r % page < seq_len;
      float part = 0.0f;
      if (valid)
        for (int d = lane; d < D; d += 32) part = fmaf(qs[d], Ks[r * D + d], part);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) part += __shfl_xor_sync(0xffffffffu, part, off);
      if (lane == 0) s[r] = valid ? part * sm_scale : NEG_INF;
    }
    __syncthreads();
    // the online softmax, one page at a time
    for (int pp = 0; pp < np; ++pp) {
      const float* sp = s + pp * page;
      const int valid = min(page, seq_len - (p0 + pp) * page);
      float m_new = m;
      for (int j = 0; j < page; ++j) m_new = fmaxf(m_new, sp[j]);
      const float corr = expf(m - m_new);
      float wsum = 0.0f;
      acc0 *= corr;
      acc1 *= corr;
      for (int j = 0; j < page; ++j) {
        const float wj = expf(sp[j] - m_new);
        wsum += wj;
        if (j < valid) {
          const float* vrow = Vs + (pp * page + j) * D;
          if (tid < D) acc0 = fmaf(wj, vrow[tid], acc0);
          if (tid + THREADS < D) acc1 = fmaf(wj, vrow[tid + THREADS], acc1);
        }
      }
      l = l * corr + wsum;
      m = m_new;
    }
    __syncthreads();  // the next chunk overwrites Ks, Vs and s
  }

  const float norm = fmaxf(l, 1e-37f);
  TQ* o = out + ((int64_t)b * H + h) * D;
  if (tid < D) o[tid] = from_f32<TQ>(acc0 / norm);
  if (tid + THREADS < D) o[tid + THREADS] = from_f32<TQ>(acc1 / norm);
}

template <typename TQ, typename KV>
cudaError_t launch(const void* q, const void* k, const void* v, const float* ks,
                   const float* vs, const int* bt, const int* sl, void* out, int B,
                   int H, int D, int page, int max_pages, float sm_scale,
                   cudaStream_t stream) {
  const size_t smem = smem_bytes(page, D);
  auto kernel = paged_attention_kernel<TQ, KV>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  kernel<<<B * H, THREADS, smem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const KV*>(k), static_cast<const KV*>(v),
      ks, vs, bt, sl, static_cast<TQ*>(out), H, D, page, max_pages,
      pages_per_chunk(page, D), sm_scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Largest head dim and page size the kernel takes.
void dl4j_paged_attention_limits(int* max_d, int* max_page) {
  *max_d = MAX_D;
  *max_page = MAX_PAGE;
}

// q_dtype: 0 = f32, 1 = bf16; kv_int8: 0 = pages in q's dtype, 1 = int8
// pages with f32 scales.  Returns the launch's cudaError_t.
int dl4j_paged_attention(const void* q, const void* k_pages, const void* v_pages,
                         const void* k_scales, const void* v_scales,
                         const void* block_tables, const void* seq_lens, void* out,
                         int B, int H, int D, int page, int max_pages, float sm_scale,
                         int q_dtype, int kv_int8, void* stream) {
  if (B <= 0 || H <= 0 || D <= 0 || D > MAX_D || page <= 0 || page > MAX_PAGE
      || max_pages <= 0 || (int64_t)B * H > 2147483647)
    return (int)cudaErrorInvalidValue;
  if (kv_int8 && (k_scales == nullptr || v_scales == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* ks = static_cast<const float*>(kv_int8 ? k_scales : nullptr);
  const float* vs = static_cast<const float*>(kv_int8 ? v_scales : nullptr);
  const int* bt = static_cast<const int*>(block_tables);
  const int* sl = static_cast<const int*>(seq_lens);
  if (q_dtype == 0 && !kv_int8)
    return (int)launch<float, float>(q, k_pages, v_pages, ks, vs, bt, sl, out, B, H, D,
                                     page, max_pages, sm_scale, s);
  if (q_dtype == 1 && !kv_int8)
    return (int)launch<__nv_bfloat16, __nv_bfloat16>(q, k_pages, v_pages, ks, vs, bt, sl,
                                                     out, B, H, D, page, max_pages,
                                                     sm_scale, s);
  if (q_dtype == 0 && kv_int8)
    return (int)launch<float, int8_t>(q, k_pages, v_pages, ks, vs, bt, sl, out, B, H, D,
                                      page, max_pages, sm_scale, s);
  if (q_dtype == 1 && kv_int8)
    return (int)launch<__nv_bfloat16, int8_t>(q, k_pages, v_pages, ks, vs, bt, sl, out, B,
                                              H, D, page, max_pages, sm_scale, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
