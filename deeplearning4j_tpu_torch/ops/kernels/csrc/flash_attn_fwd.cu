// flash_attn_fwd: flash-attention forward for NVIDIA Hopper (sm_90a) on the
// tensor cores.
//
// Replaces the TPU kernel deeplearning4j_tpu/ops/attention_kernels.py:148
// `_flash_kernel` (reached through `flash_attention_tpu`), with its
// semantics: scores q.k * scale in f32; a [B, S] keep-mask added as a bias
// of 0 (mask > 0) or NEG_INF = -1e30 (so a row whose every position is
// masked comes out uniform, with lse = NEG_INF); an online softmax with
// running max m and sum l in f32, updated once per K/V tile of BK keys (as
// the TPU kernel and flash_attention_plain do, so p is rounded at the same
// points); l sums the unrounded p; p cast to V's dtype before P.V,
// accumulated in f32; out = acc / l in q's dtype and lse = m + log(l) in
// f32.
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
// Bound on an H100 SXM (989 TFLOP/s bf16 and 495 TF32 dense on the tensor
// cores, 67 f32 SIMT, 3.35 TB/s).  Two products of 2*B*H*T*S*D operations
// (halved under causal), three TF32 products for each on the 3xTF32 route;
// bytes: q, k, v and the mask read once, out and lse written once.
// BERT-base at [64, 12, 128, 64]: bytes bound it, 0.015 ms in bf16 (51 MB)
// and 0.030 ms in f32.  At [4, 12, 2048, 64] operations do: 0.052 ms in
// bf16, 0.312 ms in f32 on 3xTF32 (0.769 ms at the f32 SIMT rate).
//
// What the first design (a 256-thread block per 64 query rows, SIMT f32 FMA
// on a 4 x 4 micro-tile, K and V widened to f32 in shared memory by
// synchronous scalar loads, P through shared memory) lost: the tensor cores
// sat idle, so bf16 ran at the f32 FMA rate (2.16 ms at [4, 12, 2048, 64],
// 10.7x SDPA); the micro-tile read 8 shared-memory floats per 16 FMAs; no
// copy was in flight while a block computed; bf16 tiles took f32's bytes.
//
// What this design does about it (the backward's pieces, from
// flash_attn_common.cuh):
//
// * Warps own rows.  One block per (b*h, BQ = 128 query rows; 64 in f32 at
//   D > 64), a warp per 16 of them, looping over BK = 64-row K/V tiles.  A
//   warp loads its Q fragments once and keeps them in registers (f32: their
//   3xTF32 big and small parts; not at D > 64, where registers run out and
//   the fragments are read from shared memory each tile).  It forms its
//   whole 16 x 64 score tile, then the softmax step: the row max and row
//   sum reduce over the 4 lanes of a quad by shuffles; m, l and the 16 x D
//   output accumulator stay in registers.  Nothing crosses warps.  Under
//   causal a warp skips the tiles whose keys all follow its rows.  The grid
//   is one dimension with
//   the query tiles of a head side by side, so that they read the head's K
//   and V from L2 at about the same time.
// * K and V stay in their own dtype in shared memory (bf16 halves the old
//   bytes) and arrive by 16-byte cp.async copies, zero-filled past S and
//   past D, into a ring of STAGES = 2 tiles: the next tile is in flight
//   while the block computes on the current one.  Where a row or base
//   pointer of q, k or v is not 16-byte aligned the same loops copy element
//   by element (Params::vec = 0): slower, never the plain version.
// * bf16: mma.sync.m16n8k16 with f32 accumulators; S = Q.K^T with K
//   fragments by ldmatrix; P goes from the score accumulators straight into
//   A fragments, rounded to bf16 in registers (the m16n8 accumulator layout
//   is the m16n8k16 A layout), and V comes by ldmatrix.trans for O += P.V.
// * f32: 3xTF32 on mma.sync.m16n8k8.  P goes through the warp's own
//   shared-memory buffer into the tf32 A layout; each tile's P.V
//   sums in a fresh accumulator that is then added to the running output in
//   f32, which keeps f32 accuracy over 2,048 keys.
// * Deterministic: no atomics; each output element belongs to one warp and
//   is summed in a fixed order, so two calls give the same bits.
// * exp is the SFU's 2^x of ((s * scale + bias) - m) * log2(e): the
//   exponent is formed before the log2(e) factor, so a fully masked row's
//   (NEG_INF - NEG_INF) is exactly 0 and the row comes out uniform.  Only
//   tiles across a warp's diagonal (causal) test key against row.
//
// What the card showed against other choices (attn_variants.py, which
// times copies of this file with a few lines changed, on an H100 at the two
// BERT-base shapes; the ratios are time over this file's time, T = 128 then
// T = 2048):
// - 64-row blocks: bf16 1.32x, 1.40x; f32 1.04x, 1.05x;
// - 128-row K/V tiles: bf16 1.12x, 1.08x (in f32 they outgrow shared
//   memory);
// - a third ring stage: bf16 1.08x, 0.95x; f32 1.08x, 1.01x;
// - no minimum of two blocks an SM in bf16 (MIN_BLOCKS): 1.21x, 1.20x;
// - conv3x3_igemm.cuh's split_tf32: f32 1.16x, 1.22x;
// - keys skipped 16 at a time where a warp cannot see them (branches around
//   each 16 keys of both products): bf16 1.03x, 1.13x; f32 1.41x, 1.61x.
// With the products taken out the kernel still takes 1.05x (bf16) and 0.67x
// (f32) of its time at T = 128, 0.61x and 0.24x at T = 2048: at T = 128 the
// loads, the softmax and the stores are the floor.  Not tried: wgmma and
// TMA (64-row warpgroup tiles), and a softmax overlapped with the next
// tile's products.
//
// The JAX wrapper's padding of T and S to block multiples, and the
// materialized [B, 1, S] bias, have no counterpart: the tails are masked
// here and the mask is read in place, per batch row b = (b*h) / H.
#include "flash_attn_common.cuh"

namespace {

using namespace flash_attn;

constexpr int BQ = 128;     // query rows a block (Cfg::ROWS)
constexpr int BK = 64;      // key/value rows a tile
constexpr int STAGES = 2;   // tiles in the cp.async ring

static_assert(BQ % 16 == 0 && BK % 16 == 0 && STAGES >= 2, "tiles");

struct Params {
  Strides q, k, v, o;
  long long mask_b;
  int H, T, S, D;
  int mask_dtype;
  int causal;
  int vec;  // q, k and v rows and bases 16-byte aligned: cp.async copies
  float scale;
};

// One instantiation: element type T and the largest head dimension DMAX
// (row pitches: flash_attn_common.cuh's Pitch).
template <typename T, int DMAX>
struct Cfg : Pitch<T, DMAX> {
  using P = Pitch<T, DMAX>;
  // f32 at D > 64: 64 query rows a block, and Q fragments read from shared
  // memory each tile (their split parts would take 128 registers)
  static constexpr bool WIDE_F32 = !P::BF16 && DMAX > 64;
  static constexpr int ROWS = WIDE_F32 ? 64 : BQ;
  static constexpr int THREADS = 32 * (ROWS / 16);  // a warp per 16 query rows
  static constexpr bool Q_REGS = !WIDE_F32;
  static constexpr int QK = P::BF16 ? DMAX / 16 : DMAX / 8;  // k steps of Q
  static constexpr int CT = BK / 8;      // n8 tiles of a K/V tile
  static constexpr int TILE = BK * P::LD;
  // f32: the warp's [16][BK + 4] P buffer
  static constexpr int BUF_FLOATS = P::BF16 ? 0 : 16 * (BK + 4);
  // Q; STAGES x (K, V); STAGES x key bias [BK]; the warps' buffers
  static constexpr int SMEM = (ROWS * P::LD + STAGES * 2 * TILE) * (int)sizeof(T) +
                              (STAGES * BK + (ROWS / 16) * BUF_FLOATS) * 4;
  // bf16 at D <= 64: two blocks (16 warps) an SM, at most 128 registers a
  // thread (ptxas spills 100 bytes); ptxas's own choice was 1.20x to 1.21x
  // slower on an H100 (attn_variants.py)
  static constexpr int MIN_BLOCKS = P::BF16 && DMAX == 64 ? 2 : 1;
  static_assert(SMEM <= 232448, "shared memory");
  static_assert(BK <= THREADS, "one bias value a thread");
};

// bf16 A fragment of rows [a0, a0 + 16) and columns [k, k + 16) of a [*][LD]
// tile: lane l addresses row l % 8 of 8x8 matrix l / 8.
template <int DMAX>
__device__ __forceinline__ void a_frag(uint32_t (&a)[4], const __nv_bfloat16* A, int a0, int k,
                                       int lane) {
  const int j = lane >> 3, r = lane & 7;
  ldmatrix_x4(a, A + (a0 + (j & 1) * 8 + r) * Pitch<__nv_bfloat16, DMAX>::LD + k + (j >> 1) * 8);
}

// bf16 B fragments of two n8 tiles, the product's columns [b0, b0 + 16)
// being rows of a [*][LD] tile, over its columns [k, k + 16): b[0], b[1]
// for columns b0.., b[2], b[3] for b0 + 8..
template <int DMAX>
__device__ __forceinline__ void b_frags(uint32_t (&b)[4], const __nv_bfloat16* B, int b0, int k,
                                        int lane) {
  const int j = lane >> 3, r = lane & 7;
  ldmatrix_x4(b, B + (b0 + (j >> 1) * 8 + r) * Pitch<__nv_bfloat16, DMAX>::LD + k + (j & 1) * 8);
}

// f32 A fragment (m16n8k8) of rows [a0, a0 + 16), columns [k, k + 8), split
// for 3xTF32.
template <int DMAX>
__device__ __forceinline__ void a_frag(uint32_t (&big)[4], uint32_t (&small)[4], const float* A,
                                       int a0, int k, int lane) {
  const int g = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int e = 0; e < 4; ++e)
    split_3xtf32(A[(a0 + g + (e & 1) * 8) * Pitch<float, DMAX>::LD + k + tq + (e >> 1) * 4],
                 big[e], small[e]);
}

// f32 B fragment of one n8 tile, the product's columns [b0, b0 + 8) being
// rows of a [*][LD] tile, over its columns [k, k + 8), split for 3xTF32.
template <int DMAX>
__device__ __forceinline__ void b_frag(uint32_t (&big)[2], uint32_t (&small)[2], const float* B,
                                       int b0, int k, int lane) {
  const int g = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int e = 0; e < 2; ++e)
    split_3xtf32(B[(b0 + g) * Pitch<float, DMAX>::LD + k + tq + e * 4], big[e], small[e]);
}

// d += a . b on 3xTF32: small*big, big*small, big*big
__device__ __forceinline__ void mma_3xtf32(float (&d)[4], const uint32_t (&ab)[4],
                                           const uint32_t (&as)[4], const uint32_t (&bb)[2],
                                           const uint32_t (&bs)[2]) {
  mma_tf32(d, as, bb);
  mma_tf32(d, ab, bs);
  mma_tf32(d, ab, bb);
}

// s[16 x BK] += the warp's Q rows . K^T over the tile's keys: Q from the
// registers qa (bf16; f32: big) and qs (f32: small), or from the tile Qs
// where the fragments are not kept.
template <typename T, int DMAX, int QS>
__device__ __forceinline__ void tile_scores(float (&s)[Cfg<T, DMAX>::CT][4],
                                            const uint32_t (&qa)[Cfg<T, DMAX>::QK][4],
                                            const uint32_t (&qs)[QS][4], const T* Qs,
                                            const T* Ks, int m0, int lane) {
  using C = Cfg<T, DMAX>;
  if constexpr (C::BF16) {
#pragma unroll
    for (int k = 0; k < C::QK; ++k) {
#pragma unroll
      for (int np = 0; np < C::CT / 2; ++np) {
        uint32_t b[4];
        b_frags<DMAX>(b, Ks, np * 16, k * 16, lane);
        mma_bf16(s[2 * np], qa[k], b[0], b[1]);
        mma_bf16(s[2 * np + 1], qa[k], b[2], b[3]);
      }
    }
  } else {
#pragma unroll
    for (int k = 0; k < C::QK; ++k) {
      uint32_t ab[4], as[4];
      if constexpr (C::Q_REGS) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          ab[e] = qa[k][e];
          as[e] = qs[k][e];
        }
      } else {
        a_frag<DMAX>(ab, as, Qs, m0, k * 8, lane);
      }
#pragma unroll
      for (int nt = 0; nt < C::CT; ++nt) {
        uint32_t bb[2], bs[2];
        b_frag<DMAX>(bb, bs, Ks, nt * 8, k * 8, lane);
        mma_3xtf32(s[nt], ab, as, bb, bs);
      }
    }
  }
}

// s = s * scale + the key's bias for rows gr and gr + 8 (hr = e >> 1) over
// keys nt * 8 + 2 * tq + (e & 1) of the tile, and mx their row maxima;
// MASKED (causal, a tile across the warp's diagonal): -inf where the key is
// after the row, key - row > lim = (warp's first row) - (tile's first key).
template <bool MASKED, int CT>
__device__ __forceinline__ void bias_and_max(float (&s)[CT][4], float (&mx)[2], const float* bias,
                                             float scale, int lim, int lane) {
  const int gr = lane >> 2, tq = lane & 3;
  const int d = 2 * tq - gr - lim;
#pragma unroll
  for (int nt = 0; nt < CT; ++nt) {
    const float2 kbias = *reinterpret_cast<const float2*>(bias + nt * 8 + 2 * tq);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float sv = s[nt][e] * scale + ((e & 1) ? kbias.y : kbias.x);
      if (MASKED && nt * 8 + (e & 1) - 8 * (e >> 1) + d > 0) sv = -INFINITY;
      s[nt][e] = sv;
      mx[e >> 1] = fmaxf(mx[e >> 1], sv);
    }
  }
}

// 2^x on the SFU, results under 2^-126 flushed to 0: a p that small weighs
// nothing beside l >= 1
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

template <typename T, int DMAX>
__global__ void __launch_bounds__(Cfg<T, DMAX>::THREADS, Cfg<T, DMAX>::MIN_BLOCKS)
flash_attn_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const void* __restrict__ mask,
                      T* __restrict__ out, float* __restrict__ lse, const Params p) {
  using C = Cfg<T, DMAX>;
  extern __shared__ __align__(128) unsigned char smem[];
  T* Qs = reinterpret_cast<T*>(smem);   // [ROWS][LD]
  T* ring = Qs + C::ROWS * C::LD;       // STAGES x (K, V) [BK][LD]
  float* bias_s = reinterpret_cast<float*>(ring + STAGES * 2 * C::TILE);  // STAGES x [BK]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gr = lane >> 2, tq = lane & 3;  // fragment row and column group
  const int m0 = warp * 16;                 // the warp's rows in the tile
  float* buf = bias_s + STAGES * BK + warp * C::BUF_FLOATS;
  // the query tiles of one head are neighbours in the grid: they run side
  // by side and read the head's K and V from L2 once
  const int nqt = (p.T + C::ROWS - 1) / C::ROWS;
  const int bh = blockIdx.x / nqt;
  const int b = bh / p.H, h = bh % p.H;
  const int q0 = (blockIdx.x % nqt) * C::ROWS;
  const int row0 = q0 + m0;
  const bool vec = p.vec != 0;
  const T* kb = k + b * p.k.b + h * p.k.h;
  const T* vb = v + b * p.v.b + h * p.v.h;

  int nkv = (p.S + BK - 1) / BK;
  if (p.causal) nkv = min(nkv, (min(q0 + C::ROWS, p.T) - 1) / BK + 1);

  load_rows<T, DMAX, C::ROWS, C::THREADS>(Qs, q + b * p.q.b + h * p.q.h, p.q.t, q0, p.T, p.D,
                                          vec, tid);
  cp_async_commit();
  auto issue = [&](int j) {
    T* st = ring + (j % STAGES) * 2 * C::TILE;
    load_rows<T, DMAX, BK, C::THREADS>(st, kb, p.k.t, j * BK, p.S, p.D, vec, tid);
    load_rows<T, DMAX, BK, C::THREADS>(st + C::TILE, vb, p.v.t, j * BK, p.S, p.D, vec, tid);
  };
#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < nkv) {
      issue(st);
      if (tid < BK) bias_s[st * BK + tid] = key_bias_of(p, mask, b, st * BK + tid);
    }
    cp_async_commit();
  }

  // the warp's Q fragments, once (f32: split for 3xTF32)
  cp_async_wait<STAGES - 1>();
  __syncthreads();
  uint32_t qa[C::QK][4], qs[C::BF16 ? 1 : C::QK][4];
  if constexpr (C::Q_REGS) {
#pragma unroll
    for (int kq = 0; kq < C::QK; ++kq) {
      if constexpr (C::BF16)
        a_frag<DMAX>(qa[kq], Qs, m0, kq * 16, lane);
      else
        a_frag<DMAX>(qa[kq], qs[kq], Qs, m0, kq * 8, lane);
    }
  }

  float m_r[2] = {NEG_INF, NEG_INF}, l_r[2] = {0.0f, 0.0f};
  float acc[C::NT][4];
#pragma unroll
  for (int nt = 0; nt < C::NT; ++nt)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[nt][c] = 0.0f;

  for (int j = 0; j < nkv; ++j) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // tile j landed; every thread left tile j - 1
    const int nx = j + STAGES - 1;
    float next_bias = 0.0f;
    if (nx < nkv) {
      issue(nx);
      if (tid < BK) next_bias = key_bias_of(p, mask, b, nx * BK + tid);
    }
    cp_async_commit();

    const int k0 = j * BK;
    // a tile whose keys are all after the warp's last row (causal) adds
    // nothing; within a tile every key is computed, and those past S or
    // after the row are masked (skipping them 16 at a time was up to 1.61x
    // slower on an H100: the branches cost more than the products they save)
    if (row0 < p.T && !(p.causal && k0 > row0 + 15)) {
      const T* Ks = ring + (j % STAGES) * 2 * C::TILE;
      const T* Vs = Ks + C::TILE;
      const float* bias = bias_s + (j % STAGES) * BK;
      float s[C::CT][4];
#pragma unroll
      for (int nt = 0; nt < C::CT; ++nt)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[nt][c] = 0.0f;
      tile_scores<T, DMAX>(s, qa, qs, Qs, Ks, m0, lane);

      // the online softmax step; s takes p
      float mx[2] = {-INFINITY, -INFINITY};
      if (p.causal && k0 + BK - 1 > row0)
        bias_and_max<true>(s, mx, bias, p.scale, row0 - k0, lane);
      else
        bias_and_max<false>(s, mx, bias, p.scale, row0 - k0, lane);
      float corr[2], rs[2] = {0.0f, 0.0f};
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        mx[hr] = fmaxf(mx[hr], __shfl_xor_sync(0xffffffffu, mx[hr], 1));
        mx[hr] = fmaxf(mx[hr], __shfl_xor_sync(0xffffffffu, mx[hr], 2));
        const float m_new = fmaxf(m_r[hr], mx[hr]);  // finite: m starts at NEG_INF
        corr[hr] = exp2_ftz((m_r[hr] - m_new) * LOG2E);
        m_r[hr] = m_new;
      }
#pragma unroll
      for (int nt = 0; nt < C::CT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float pv = exp2_ftz((s[nt][e] - m_r[e >> 1]) * LOG2E);
          s[nt][e] = pv;
          rs[e >> 1] += pv;
        }
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        rs[hr] += __shfl_xor_sync(0xffffffffu, rs[hr], 1);
        rs[hr] += __shfl_xor_sync(0xffffffffu, rs[hr], 2);
        l_r[hr] = corr[hr] * l_r[hr] + rs[hr];
      }
#pragma unroll
      for (int nt = 0; nt < C::NT; ++nt)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[nt][c] *= corr[c >> 1];
      output_product<T, DMAX>(acc, s, Vs, 0, buf, lane);
    }
    if (nx < nkv && tid < BK) bias_s[(nx % STAGES) * BK + tid] = next_bias;
  }
  cp_async_wait<0>();

  if (row0 >= p.T) return;
  T* ob = out + b * p.o.b + h * p.o.h;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int row = row0 + gr + 8 * hr;
    if (row >= p.T) continue;
#pragma unroll
    for (int nt = 0; nt < C::NT; ++nt) {
      const int col = nt * 8 + 2 * tq;
      if (col < p.D)
        store2(ob + (int64_t)row * p.o.t + col, acc[nt][2 * hr] / l_r[hr],
               acc[nt][2 * hr + 1] / l_r[hr], col + 1 < p.D);
    }
    if (tq == 0) lse[(int64_t)bh * p.T + row] = m_r[hr] + logf(l_r[hr]);
  }
}

template <typename T, int DMAX>
cudaError_t launch(const void* q, const void* k, const void* v, const void* mask, void* out,
                   float* lse, const Params& p, int B, cudaStream_t stream) {
  using C = Cfg<T, DMAX>;
  static bool raised[MAX_DEVICES];
  auto* kernel = flash_attn_fwd_kernel<T, DMAX>;
  cudaError_t e = allow_smem((const void*)kernel, C::SMEM, raised);
  if (e != cudaSuccess) {
    cudaGetLastError();  // cleared, or the next launch's check would report it
    return e;
  }
  const dim3 grid((unsigned)((long long)B * p.H * ((p.T + C::ROWS - 1) / C::ROWS)));
  kernel<<<grid, C::THREADS, C::SMEM, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), mask,
      static_cast<T*>(out), lse, p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The tiles of the D <= 64 instances, for the wrapper to check against
// ``DEFAULT_TILES["attention"]``: query rows a block, key/value rows a tile.
void dl4j_flash_attn_tile(int* bq, int* bk) {
  *bq = Cfg<__nv_bfloat16, 64>::ROWS;
  *bk = BK;
}

// strides: 13 element strides, (b, h, t) of q, k, v and out, then the
// mask's row stride.  dtype: 0 = f32, 1 = bf16; mask_dtype: MaskDtype.
// Returns the launch's cudaError_t (0 = success).
int dl4j_flash_attn_fwd(const void* q, const void* k, const void* v, const void* mask,
                        void* out, void* lse, const long long* strides, int B, int H, int T,
                        int S, int D, int mask_dtype, int causal, float scale, int dtype,
                        void* stream) {
  if (B <= 0 || H <= 0 || T <= 0 || S <= 0 || D <= 0 || D > MAX_D || dtype < 0 || dtype > 1 ||
      (T + BQ - 1) / BQ > 65535 ||
      (long long)B * H * ((T + 63) / 64) > 0x7fffffffLL ||  // 64 <= every Cfg::ROWS
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
  const int es = dtype == 0 ? 4 : 2;
  p.vec = aligned16(q, p.q, B, H, T, es) && aligned16(k, p.k, B, H, S, es) &&
          aligned16(v, p.v, B, H, S, es);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  if (dtype == 0)
    return (int)(D <= 64 ? launch<float, 64>(q, k, v, mask, out, l, p, B, s)
                         : launch<float, 128>(q, k, v, mask, out, l, p, B, s));
  return (int)(D <= 64 ? launch<__nv_bfloat16, 64>(q, k, v, mask, out, l, p, B, s)
                       : launch<__nv_bfloat16, 128>(q, k, v, mask, out, l, p, B, s));
}

}  // extern "C"
