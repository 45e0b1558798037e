// paged_attention: one decode token per sequence attending over its history
// in a shared pool of KV pages, for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel deeplearning4j_tpu/ops/pallas/paged_attention.py
// `_paged_kernel` (via `paged_attention`), which walks each (sequence b,
// head h)'s pages in block-table order and folds each page into an online
// softmax kept in f32:
//   m = -1e30 (NEG_INF, not -inf), l = 0, acc = 0;
//   for each page p with p * page < seq_len:
//     s_j = (q . k_j) * sm_scale, and s_j = -1e30 where p*page + j >= seq_len;
//     m_new = max(m, max_j s_j); corr = exp(m - m_new); w_j = exp(s_j - m_new);
//     acc = acc * corr + sum_j w_j v_j;  l = l * corr + sum_j w_j;  m = m_new;
//   out = acc / max(l, 1e-37), cast to q's dtype.
// int8 pages widen as f32(x) * f32(scale) with one scale per (token, head)
// (`dequant_rows`, rounded as __fmul_rn).  This kernel computes the same
// function; its sums run in another order (below).
//
//   q            [B, H, D]         f32 or bf16
//   k/v pages    [P, page, H, D]   q's dtype, or int8 with
//   k/v scales   [P, page, H]      f32
//   block_tables [B, max_pages]    int32; only the first ceil(seq_len/page)
//                                  slots of a row are read
//   seq_lens     [B]               int32, >= 1
//   out          [B, H, D]         q's dtype
//
// Bound: bytes.  One query row per (b, h) leaves no matrix product for the
// tensor cores: each K or V element is used in 2 to 3 operations.  At
// [16, 12, 64] over 2,048-token histories the kernel must read K and V
// once, 16 * 2048 * 12 * 64 * 2 bytes = 50.3 MB of int8 pages plus 3.1 MB
// of scales (16 us at 3.35 TB/s), or 201 MB of f32 pages (60 us).
//
// What the first design lost (0.98 ms on int8 pages, 0.63 on f32, 2.6x and
// 1.7x SDPA over K/V gathered beforehand): one block per (b, h), 192 blocks
// on 132 SMs, each walking its whole history alone; int8 widened to f32 on
// its way into shared memory (4x its bytes, the row's scale read again for
// every element); no copy in flight while a block computed; every thread
// recomputing each page's max and exponentials.
//
// Design.
// * Split over the history.  The grid is B * (H / heads) * splits blocks
//   of 128 threads, blockIdx.x = (b * (H / heads) + head group) * splits +
//   split: a block takes `heads` neighbouring heads (two in the plan: a
//   token's rows of both are 128 contiguous int8 bytes at D = 64) and the
//   pages [split * pages_per_split, (split + 1) * pages_per_split), so
//   splits fall on page boundaries.  `paged_plan` in
//   ops/kernels/paged_attention.py picks heads and splits from the shapes
//   alone (never from seq_lens: no host read per step).  A
//   block reads its own block-table row and seq_len; a split that starts
//   at or past seq_len writes empty partials (m = -1e30, l = 0, acc = 0)
//   and takes no copy.
// * Pages copied in their own dtype.  A block's tokens go through a ring
//   of STAGES = 2 shared-memory tiles of `tile_rows` (token, head) rows
//   (geometry(), below) by 16-byte cp.async: a token's rows of the block's
//   heads are heads * D contiguous elements, H * D from the next token's;
//   each thread keeps one 16-byte chunk of a token and steps over tokens
//   where the chunks divide the threads.  int8 stays int8 in shared
//   memory, and each row's two scales come once by 4-byte cp.async.
//   The next tile is in flight while the block computes on the current
//   one (a third stage times slower: paged_variants.py).  Where a row is
//   not a multiple of 16 bytes or a pool's base is off 16 bytes, the same
//   loops copy element by element with plain loads into zero-padded rows
//   (VEC = false).
// * Scores and softmax.  A row group of lpr lanes (the power of two >= the
//   row's 16-byte pieces, at most 32) takes rows of one head,
//   ROWS_PER_GROUP of each tile; its lanes read 16-byte pieces of a row
//   from shared memory, widen them in registers (int8 as f32(x) *
//   f32(scale)), dot them with their piece of q (held in registers, scaled
//   by sm_scale * log2(e)) and add the pieces by xor shuffles.  Each group
//   keeps its own online softmax (m, l, acc) in f32, in the log2 domain
//   with exp2; a row's max and exponentials are computed by its group's
//   lanes only.  At the end of the split the groups of each head are
//   merged in group order in shared memory.
// * Combine, in the same launch.  With more than one split each block
//   writes each head's (m, l, acc[D]) in f32 to the workspace [B * H,
//   splits, D + 2]; the last block of a (b, head group) to arrive, found by
//   an integer arrival counter after __threadfence(), combines the splits
//   in split order: M = max m_s, out = sum acc_s * 2^(m_s - M) / max(sum
//   l_s * 2^(m_s - M), 1e-37), cast to q's dtype, and resets its counter to
//   0 for the next launch.  No float atomics: two calls give the same
//   bits.  The workspace comes from the wrapper (torch.empty), the
//   counters from a zeroed buffer it keeps per device and stream.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <type_traits>

#include "skinny_gemm.cuh"  // cp.async helpers

namespace {

using skinny::cp_async16;
using skinny::cp_async4;
using skinny::cp_async_commit;
using skinny::cp_async_wait;

constexpr int THREADS = 128;
constexpr int MAX_D = 256;
constexpr int MAX_PAGE = 64;
constexpr int MAX_SPLITS = 128;
constexpr int STAGES = 2;  // the copy ring's depth
constexpr int ROWS_PER_GROUP = 2;  // rows a row group takes from each tile
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

struct Geometry {
  int pieces;     // 16-byte pieces of a row (the last zero-padded)
  int lpr;        // lanes of a row group: the power of two >= pieces, <= 32
  int ppl;        // pieces a lane holds
  int groups;     // row groups in a block
  int tile_rows;  // rows of a ring stage
};

__host__ __device__ inline Geometry geometry(int D, int es) {
  Geometry g;
  g.pieces = (D * es + 15) / 16;
  g.lpr = 1;
  while (g.lpr < g.pieces && g.lpr < 32) g.lpr *= 2;
  g.ppl = (g.pieces + g.lpr - 1) / g.lpr;
  g.groups = THREADS / g.lpr;
  g.tile_rows = ROWS_PER_GROUP * g.groups;
  return g;
}

// K tile, V tile, then (int8) the K and V scales of its rows
__host__ __device__ inline int stage_bytes(const Geometry& g, bool int8) {
  return 2 * g.tile_rows * g.pieces * 16 + (int8 ? 2 * g.tile_rows * 4 : 0);
}

size_t smem_bytes(const Geometry& g, int es, bool int8) {
  const size_t ring = (size_t)STAGES * stage_bytes(g, int8);
  const size_t merge = (size_t)g.groups * (2 + g.pieces * (16 / es)) * 4;
  return ring > merge ? ring : merge;
}

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const float* ks;
  const float* vs;
  const int* bt;
  const int* sl;
  void* out;
  float* ws;
  int* counters;
  int H, D, page, max_pages, splits, pages_per_split;
  int heads;     // heads a block takes, side by side
  float qscale;  // sm_scale * log2(e)
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// the 16 / sizeof(KV) elements of a 16-byte piece, widened to f32
template <typename KV> __device__ __forceinline__ void widen(const uint4& u, float* o);
template <> __device__ __forceinline__ void widen<float>(const uint4& u, float* o) {
  o[0] = __uint_as_float(u.x);
  o[1] = __uint_as_float(u.y);
  o[2] = __uint_as_float(u.z);
  o[3] = __uint_as_float(u.w);
}
template <> __device__ __forceinline__ void widen<__nv_bfloat16>(const uint4& u, float* o) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    o[2 * i] = __uint_as_float(w[i] << 16);
    o[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}
// int8 without a conversion instruction: x + 128 (the byte with its top
// bit flipped) goes into the low mantissa byte of 2^23, and 2^23 + 128 comes
// off again; both steps are exact
template <> __device__ __forceinline__ void widen<int8_t>(const uint4& u, float* o) {
  const uint32_t w[4] = {u.x ^ 0x80808080u, u.y ^ 0x80808080u, u.z ^ 0x80808080u,
                         u.w ^ 0x80808080u};
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      o[4 * i + j] = __uint_as_float(__byte_perm(w[i], 0x4b000000u, 0x7540u | j)) - 8388736.0f;
}

template <typename TQ, typename KV, bool VEC>
__global__ void __launch_bounds__(THREADS)
paged_attention_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int last_block;
  constexpr int ES = (int)sizeof(KV);
  constexpr int PE = 16 / ES;              // elements of a 16-byte piece
  constexpr int PPL = ES == 4 ? 2 : 1;     // pieces a lane may hold at D <= 256
  constexpr bool INT8 = std::is_same<KV, int8_t>::value;

  const Geometry g = geometry(p.D, ES);
  const int D = p.D;
  const int G = p.heads;                   // heads of the block, side by side
  const int HG = p.H / G;
  const int split = blockIdx.x % p.splits;
  const int bg = blockIdx.x / p.splits;    // (b, head group)
  const int b = bg / HG;
  const int h0 = (bg - b * HG) * G;        // the block's first head
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int li = lane & (g.lpr - 1);                        // lane in its row group
  const int grp = (tid >> 5) * (32 / g.lpr) + lane / g.lpr;  // row group in the block
  const int gi = grp % G;                                   // its head in the block
  const int* bt = p.bt + (int64_t)b * p.max_pages;
  const int seq_len = min(p.sl[b], p.max_pages * p.page);
  const int tok0 = split * p.pages_per_split * p.page;
  const int tok1 = min(tok0 + p.pages_per_split * p.page, seq_len);
  const int tile_tok = g.tile_rows / G;    // tokens of a ring stage
  const int dp = g.pieces * PE;
  float* red_m = reinterpret_cast<float*>(smem);  // the merge: [groups]
  float* red_l = red_m + g.groups;                // [groups]
  float* red_a = red_l + g.groups;                // [groups][dp]

  if (tok0 < tok1) {
    const int pitch = g.pieces * 16;
    const int sbytes = stage_bytes(g, INT8);
    const int n_tiles = (tok1 - tok0 + tile_tok - 1) / tile_tok;
    float qr[PPL][PE], acc[PPL][PE];
    const TQ* qv = static_cast<const TQ*>(p.q) + ((int64_t)b * p.H + h0 + gi) * D;
#pragma unroll
    for (int j = 0; j < PPL; ++j)
#pragma unroll
      for (int e = 0; e < PE; ++e) {
        const int d = (li + j * g.lpr) * PE + e;
        qr[j][e] = (j < g.ppl && d < D) ? to_f32(qv[d]) * p.qscale : 0.0f;
        acc[j][e] = 0.0f;
      }
    float m = NEG_INF, l = 0.0f;
    if (!VEC) {  // zero the rows' padding once; the copies never touch it
      for (int i = tid; i < STAGES * sbytes / 16; i += THREADS)
        reinterpret_cast<uint4*>(smem)[i] = make_uint4(0u, 0u, 0u, 0u);
      __syncthreads();
    }

    // a power-of-two page (the engine's 16) divides by a shift
    const int page_shift = (p.page & (p.page - 1)) == 0 ? __ffs(p.page) - 1 : -1;
    auto kv_row = [&](int tok) -> int64_t {  // the token's row of head h0 in the pool
      const int pg = page_shift >= 0 ? tok >> page_shift : tok / p.page;
      return ((int64_t)__ldg(bt + pg) * p.page + (tok - pg * p.page)) * p.H + h0;
    };
    // where a token's G * pieces 16-byte chunks divide the block's threads
    // (D a power of two), each thread keeps one chunk of a token and steps
    // over tokens
    const int per_tok = G * g.pieces;
    const bool fixed_chunk = VEC && THREADS % per_tok == 0;
    const int my_tok = tid / per_tok, my_rem = tid - my_tok * per_tok;
    const int tok_step = THREADS / per_tok;
    // tile t: tokens tok0 + t * tile_tok ..., shared-memory row i * G + head
    auto load = [&](int t) {
      unsigned char* st = smem + (t % STAGES) * sbytes;
      unsigned char* Ks = st;
      unsigned char* Vs = st + g.tile_rows * pitch;
      float* ksc = reinterpret_cast<float*>(st + 2 * g.tile_rows * pitch);
      float* vsc = ksc + g.tile_rows;
      const int r0 = tok0 + t * tile_tok;
      const int toks = min(tile_tok, tok1 - r0);
      if (fixed_chunk) {  // a token's G heads are G * D contiguous elements
        const char* kp = static_cast<const char*>(p.k);
        const char* vp = static_cast<const char*>(p.v);
        for (int i = my_tok; i < toks; i += tok_step) {
          const int64_t off = kv_row(r0 + i) * D * ES + my_rem * 16;
          cp_async16(Ks + i * G * pitch + my_rem * 16, kp + off, 16);
          cp_async16(Vs + i * G * pitch + my_rem * 16, vp + off, 16);
        }
      } else if (VEC) {
        const char* kp = static_cast<const char*>(p.k);
        const char* vp = static_cast<const char*>(p.v);
        for (int c = tid; c < toks * per_tok; c += THREADS) {
          const int i = c / per_tok;
          const int rem = c - i * per_tok;
          const int64_t off = kv_row(r0 + i) * D * ES + rem * 16;
          cp_async16(Ks + i * G * pitch + rem * 16, kp + off, 16);
          cp_async16(Vs + i * G * pitch + rem * 16, vp + off, 16);
        }
      } else {
        const KV* kp = static_cast<const KV*>(p.k);
        const KV* vp = static_cast<const KV*>(p.v);
        for (int c = tid; c < toks * G * D; c += THREADS) {
          const int r = c / D;  // shared-memory row: token r / G, head r % G
          const int d = c - r * D;
          const int64_t row = kv_row(r0 + r / G) + r % G;
          reinterpret_cast<KV*>(Ks + r * pitch)[d] = kp[row * D + d];
          reinterpret_cast<KV*>(Vs + r * pitch)[d] = vp[row * D + d];
        }
      }
      if (INT8)
        for (int r = tid; r < toks * G; r += THREADS) {
          const int64_t row = kv_row(r0 + r / G) + r % G;
          if (VEC) {
            cp_async4(ksc + r, p.ks + row);
            cp_async4(vsc + r, p.vs + row);
          } else {
            ksc[r] = p.ks[row];
            vsc[r] = p.vs[row];
          }
        }
    };
    auto compute = [&](int t) {
      const unsigned char* st = smem + (t % STAGES) * sbytes;
      const unsigned char* Ks = st;
      const unsigned char* Vs = st + g.tile_rows * pitch;
      const float* ksc = reinterpret_cast<const float*>(st + 2 * g.tile_rows * pitch);
      const float* vsc = ksc + g.tile_rows;
      const int r0 = tok0 + t * tile_tok;
      float s[ROWS_PER_GROUP];
      bool valid[ROWS_PER_GROUP];
#pragma unroll
      for (int rr = 0; rr < ROWS_PER_GROUP; ++rr) {
        const int r = grp + rr * g.groups;  // token r / G of the tile, head gi
        valid[rr] = r0 + r / G < tok1;
        const float sc = INT8 ? ksc[r] : 1.0f;
        float part = 0.0f;
#pragma unroll
        for (int j = 0; j < PPL; ++j) {
          const int pc = li + j * g.lpr;
          if (j < g.ppl && pc < g.pieces) {
            float kf[PE];
            widen<KV>(*reinterpret_cast<const uint4*>(Ks + r * pitch + pc * 16), kf);
#pragma unroll
            for (int e = 0; e < PE; ++e)
              part = fmaf(qr[j][e], INT8 ? __fmul_rn(kf[e], sc) : kf[e], part);
          }
        }
        for (int off = g.lpr >> 1; off > 0; off >>= 1)
          part += __shfl_xor_sync(0xffffffffu, part, off);
        s[rr] = part;
      }
      float m_new = m;
#pragma unroll
      for (int rr = 0; rr < ROWS_PER_GROUP; ++rr)
        if (valid[rr]) m_new = fmaxf(m_new, s[rr]);
      const float corr = exp2f(m - m_new);
      l *= corr;
#pragma unroll
      for (int j = 0; j < PPL; ++j)
#pragma unroll
        for (int e = 0; e < PE; ++e) acc[j][e] *= corr;
#pragma unroll
      for (int rr = 0; rr < ROWS_PER_GROUP; ++rr) {
        if (!valid[rr]) continue;
        const int r = grp + rr * g.groups;
        const float w = exp2f(s[rr] - m_new);
        const float sc = INT8 ? vsc[r] : 1.0f;
        l += w;
#pragma unroll
        for (int j = 0; j < PPL; ++j) {
          const int pc = li + j * g.lpr;
          if (j < g.ppl && pc < g.pieces) {
            float vf[PE];
            widen<KV>(*reinterpret_cast<const uint4*>(Vs + r * pitch + pc * 16), vf);
#pragma unroll
            for (int e = 0; e < PE; ++e)
              acc[j][e] = fmaf(w, INT8 ? __fmul_rn(vf[e], sc) : vf[e], acc[j][e]);
          }
        }
      }
      m = m_new;
    };

    for (int t = 0; t < STAGES - 1; ++t) {
      if (t < n_tiles) load(t);
      cp_async_commit();
    }
    for (int t = 0; t < n_tiles; ++t) {
      cp_async_wait<STAGES - 2>();  // tile t's copies (this thread's) landed
      __syncthreads();              // everyone's, and tile t - 1 is done with
      if (t + STAGES - 1 < n_tiles) load(t + STAGES - 1);
      cp_async_commit();
      compute(t);
    }
    cp_async_wait<0>();
    __syncthreads();

    // each group's state, scaled to its head's max, for the merge below
    if (li == 0) red_m[grp] = m;
    __syncthreads();
    float M = NEG_INF;
    for (int i = gi; i < g.groups; i += G) M = fmaxf(M, red_m[i]);
    const float c = exp2f(m - M);
    if (li == 0) red_l[grp] = l * c;
#pragma unroll
    for (int j = 0; j < PPL; ++j) {
      const int pc = li + j * g.lpr;
      if (j < g.ppl && pc < g.pieces)
#pragma unroll
        for (int e = 0; e < PE; ++e) red_a[grp * dp + pc * PE + e] = acc[j][e] * c;
    }
    __syncthreads();
  }

  // the split's (max, sum, acc[d]) of head h0 + k, its groups merged in
  // group order (log2 domain); an empty split's is (NEG_INF, 0, 0)
  const bool empty = tok0 >= tok1;
  auto merged = [&](int k, int d, float* Mk, float* Lk) -> float {
    float M = NEG_INF, L = 0.0f, a = 0.0f;
    if (!empty) {
      for (int i = k; i < g.groups; i += G) M = fmaxf(M, red_m[i]);
      for (int i = k; i < g.groups; i += G) {
        L += red_l[i];
        a += red_a[i * dp + d];
      }
    }
    *Mk = M;
    *Lk = L;
    return a;
  };
  if (p.splits == 1) {
    for (int x = tid; x < G * D; x += THREADS) {
      const int k = x / D, d = x - k * D;
      float Mk, Lk;
      const float a = merged(k, d, &Mk, &Lk);
      static_cast<TQ*>(p.out)[((int64_t)b * p.H + h0 + k) * D + d] =
          from_f32<TQ>(a / fmaxf(Lk, 1e-37f));
    }
    return;
  }
  for (int x = tid; x < G * D; x += THREADS) {
    const int k = x / D, d = x - k * D;
    float Mk, Lk;
    const float a = merged(k, d, &Mk, &Lk);
    float* part = p.ws + (((int64_t)b * p.H + h0 + k) * p.splits + split) * (D + 2);
    if (d == 0) {
      part[0] = Mk;
      part[1] = Lk;
    }
    part[2 + d] = a;
  }
  __threadfence();  // this block's partials are visible before it counts in
  __syncthreads();
  if (tid == 0) last_block = atomicAdd(p.counters + bg, 1) == p.splits - 1;
  __syncthreads();
  if (!last_block) return;
  __threadfence();

  // the last block of (b, head group): each head's splits in split order,
  // past L1
  for (int x = tid; x < G * D; x += THREADS) {
    const int k = x / D, d = x - k * D;
    const float* base = p.ws + ((int64_t)b * p.H + h0 + k) * p.splits * (D + 2);
    float Mx = NEG_INF;
    for (int s = 0; s < p.splits; ++s) Mx = fmaxf(Mx, __ldcg(base + (int64_t)s * (D + 2)));
    float Ls = 0.0f, a = 0.0f;
    for (int s = 0; s < p.splits; ++s) {
      const float* ps = base + (int64_t)s * (D + 2);
      const float w = exp2f(__ldcg(ps) - Mx);
      Ls = fmaf(__ldcg(ps + 1), w, Ls);
      a = fmaf(__ldcg(ps + 2 + d), w, a);
    }
    static_cast<TQ*>(p.out)[((int64_t)b * p.H + h0 + k) * D + d] =
        from_f32<TQ>(a / fmaxf(Ls, 1e-37f));
  }
  if (tid == 0) p.counters[bg] = 0;
}

template <typename TQ, typename KV>
cudaError_t launch(const Params& p, int B, cudaStream_t stream) {
  constexpr int ES = (int)sizeof(KV);
  constexpr bool INT8 = std::is_same<KV, int8_t>::value;
  const Geometry g = geometry(p.D, ES);
  const size_t smem = smem_bytes(g, ES, INT8);
  const bool vec = (p.D * ES) % 16 == 0 && reinterpret_cast<uintptr_t>(p.k) % 16 == 0
                   && reinterpret_cast<uintptr_t>(p.v) % 16 == 0;
  auto kernel = vec ? paged_attention_kernel<TQ, KV, true> : paged_attention_kernel<TQ, KV, false>;
  if (smem + sizeof(int) > 48 * 1024) {  // the dynamic part, and last_block
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) {
      cudaGetLastError();  // a refused request must not fail the next launch
      return e;
    }
  }
  kernel<<<(unsigned)((int64_t)B * (p.H / p.heads) * p.splits), THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Largest head dim, page size and split count the kernel takes.
void dl4j_paged_attention_limits(int* max_d, int* max_page, int* max_splits) {
  *max_d = MAX_D;
  *max_page = MAX_PAGE;
  *max_splits = MAX_SPLITS;
}

// Rows of a ring stage for head dim D and page elements of kv_itemsize
// bytes: two a row group (paged_plan mirrors geometry()).
int dl4j_paged_attention_tile_rows(int D, int kv_itemsize) {
  return geometry(D, kv_itemsize).tile_rows;
}

// q_dtype: 0 = f32, 1 = bf16; kv_int8: 0 = pages in q's dtype, 1 = int8
// pages with f32 scales.  splits blocks a (b, head group), pages_per_split
// pages each (splits * pages_per_split >= max_pages, every split
// non-empty); heads: a power of two dividing H, at most the row groups of
// a block (dl4j_paged_attention_tile_rows / 2); workspace: B * H * splits
// * (D + 2) floats, counters: B * H / heads ints, zero (both may be null
// when splits == 1).  Returns the launch's cudaError_t.
int dl4j_paged_attention(const void* q, const void* k_pages, const void* v_pages,
                         const void* k_scales, const void* v_scales,
                         const void* block_tables, const void* seq_lens, void* out,
                         void* workspace, void* counters, int B, int H, int D, int page,
                         int max_pages, int splits, int pages_per_split, int heads,
                         float sm_scale, int q_dtype, int kv_int8, void* stream) {
  if (B <= 0 || H <= 0 || D <= 0 || D > MAX_D || page <= 0 || page > MAX_PAGE
      || max_pages <= 0 || (int64_t)max_pages * page > 2147483647 || splits <= 0
      || splits > MAX_SPLITS || pages_per_split <= 0
      || (int64_t)splits * pages_per_split < max_pages
      || (int64_t)(splits - 1) * pages_per_split >= max_pages || heads <= 0
      || (heads & (heads - 1)) != 0 || H % heads != 0
      || heads > geometry(D, kv_int8 ? 1 : (q_dtype == 0 ? 4 : 2)).groups
      || (int64_t)B * H * splits > 2147483647)
    return (int)cudaErrorInvalidValue;
  if (kv_int8 && (k_scales == nullptr || v_scales == nullptr))
    return (int)cudaErrorInvalidValue;
  if (splits > 1 && (workspace == nullptr || counters == nullptr))
    return (int)cudaErrorInvalidValue;
  Params p;
  p.q = q;
  p.k = k_pages;
  p.v = v_pages;
  p.ks = static_cast<const float*>(kv_int8 ? k_scales : nullptr);
  p.vs = static_cast<const float*>(kv_int8 ? v_scales : nullptr);
  p.bt = static_cast<const int*>(block_tables);
  p.sl = static_cast<const int*>(seq_lens);
  p.out = out;
  p.ws = static_cast<float*>(workspace);
  p.counters = static_cast<int*>(counters);
  p.H = H;
  p.D = D;
  p.page = page;
  p.max_pages = max_pages;
  p.splits = splits;
  p.pages_per_split = pages_per_split;
  p.heads = heads;
  p.qscale = sm_scale * LOG2E;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (q_dtype == 0 && !kv_int8) return (int)launch<float, float>(p, B, s);
  if (q_dtype == 1 && !kv_int8) return (int)launch<__nv_bfloat16, __nv_bfloat16>(p, B, s);
  if (q_dtype == 0 && kv_int8) return (int)launch<float, int8_t>(p, B, s);
  if (q_dtype == 1 && kv_int8) return (int)launch<__nv_bfloat16, int8_t>(p, B, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
