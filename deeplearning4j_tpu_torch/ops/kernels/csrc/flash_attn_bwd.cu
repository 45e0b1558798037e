// flash_attn_bwd: flash-attention backward for NVIDIA Hopper (sm_90a) on the
// tensor cores, two kernels: dQ, then dK/dV.
//
// Replaces the TPU kernels deeplearning4j_tpu/ops/attention_kernels.py:271
// `_flash_bwd_dq_kernel` and :322 `_flash_bwd_dkv_kernel` (reached through
// `flash_attention_bwd_tpu`), with their semantics (FlashAttention-2's
// backward): delta = rowsum(dO * out) in f32; the scores s = q.k * scale in
// f32 plus the keep-mask bias are rebuilt as the forward kernel
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
// Bound on an H100 SXM (989 TFLOP/s bf16 and 495 TF32 dense on the tensor
// cores, 67 f32 SIMT, 3.35 TB/s).  2*B*H*T*S*D operations a product, 3
// products in dQ (s, dP, dS.K) and 4 in dK/dV (s, dP, P^T.dO, dS^T.Q),
// halved under causal.  Bytes: dQ reads q, k, v, out, dO, lse and writes dq
// and delta; dK/dV reads q, k, v, dO, lse, delta and writes dk, dv.
// BERT-base at [64, 12, 128, 64]: bytes bound both kernels, 0.023 ms each in
// bf16 (76 MB) and 0.046 ms in f32 (152 MB).  At [4, 12, 2048, 64]
// operations bound them: dQ 0.078 ms in bf16 and, on the 3xTF32 route (three
// TF32 products per f32 product), 0.469 ms in f32; dK/dV 0.104 and 0.625 ms.
//
// What the first design (SIMT f32 FMA on a 4 x 4 micro-tile, tiles staged as
// f32 by synchronous scalar loads) lost: the tensor cores sat idle, so bf16
// ran at the f32 FMA rate (0.380 + 0.320 ms at T = 128, 4.258 + 4.140 at
// T = 2048: 55x and 40x the bf16 bounds, 6.7x and 16.9x SDPA's whole
// backward); the micro-tile read 16 shared-memory floats per 32 FMAs; no
// copy was in flight while a block computed; bf16 tiles took f32's bytes.
//
// What this design does about it:
//
// * Warps own rows.  dQ: one block per (b*h, 128 query rows; 64 in f32 at
//   D > 64), a warp per 16 of them, looping over 64-row K/V tiles; each
//   warp owns its rows of s, dP, dS and dq, so nothing is reduced across
//   warps.  dK/dV: one block per (b*h, 64 key rows), a warp per 16 keys,
//   looping over 64-row Q/dO tiles, with the scores formed key-major (S^T = K.Q^T) so that P^T
//   and dS^T come out with the keys as rows, the A operand of P^T.dO and
//   dS^T.Q.  dq, dk and dv accumulate in registers.  A tile is consumed in
//   chunks of CHUNK keys (dQ) or queries (dK/dV): the two score products
//   for the chunk, the elementwise step, then the chunk's share of the
//   output products; a warp skips chunks that its rows cannot see (causal,
//   or past T or S).  The grid is one dimension with the tiles of a head
//   side by side, so they read the head's K and V (dQ) or Q and dO (dK/dV)
//   from L2 at about the same time.
// * Operands stay in their own dtype in shared memory (bf16 halves the old
//   bytes) and arrive by 16-byte cp.async copies, zero-filled (src-size)
//   past T or S and past D, into a ring of STAGES = 2 tiles: the next K/V
//   tile (dQ) or Q/dO/lse/delta tile (dK/dV) is in flight while the block
//   computes on the current one.  Where a row or base pointer of q, k, v or
//   dO is not 16-byte aligned the same loops copy element by element
//   (Params::vec = 0): slower, never the plain version.
// * bf16: mma.sync.m16n8k16 bf16 with f32 accumulators; bf16 x bf16
//   products are exact in f32, so only the order of the sums changes.  The
//   score products take A (16 rows x D) and B (D x CHUNK, rows of the other
//   tile) by ldmatrix; dS (dQ) and P^T, dS^T (dK/dV) go from the score
//   accumulators straight into A fragments, rounded to bf16 in registers (the
//   m16n8 accumulator layout is the m16n8k16 A layout), and the second
//   operand of the output products (K, dO, Q: CHUNK rows x D) comes by
//   ldmatrix.trans.
// * f32: 3xTF32 on mma.sync.m16n8k8 (conv3x3_igemm.cuh's mma_tf32): big =
//   v rounded to TF32, small = v - big, and small*big + big*small +
//   big*big, which keeps f32 accuracy (flash_attn_common.cuh's
//   split_3xtf32 says how it differs from conv3x3_igemm.cuh's split_tf32,
//   and why).  Fragments are
//   read with 4-byte loads; a row pitch of D + 4 words puts the lanes of a
//   (row g, column t) load in 32 banks.  dS and P^T go through the warp's
//   own shared-memory buffer into the A layout (the m16n8k8 tf32 A layout
//   is not the accumulator layout).  Each chunk's output products sum in a
//   fresh accumulator that is then added to the running sum in f32: the
//   tensor cores' accumulation drops low bits, and dk, dv sum over every
//   query (2,048 at T = 2048).
// * Deterministic: no atomics; each output element belongs to one warp of
//   one block and is summed in a fixed order, so two calls give the same
//   bits.  delta is computed by the dQ block for its rows first (the JAX
//   wrapper's separate reduction is folded in) and written for dK/dV.
// * exp is exp2f((s - lse) * log2(e)): the hardware's exp2, in f32.
//
// What the card showed against other choices (attn_variants.py, which
// times copies of this file with a few lines changed, on an H100 at the two
// BERT-base shapes; the ratios are time over this file's time):
// - 64-row dQ blocks: dQ bf16 1.03x (T = 128) and 1.08x (T = 2048), f32
//   0.99x and 1.07x (the K/V tiles are read by half as many blocks);
// - 128-row dK/dV Q/dO tiles: dK/dV bf16 1.13x to 1.29x, f32 1.43x to
//   1.51x; 128-row dK/dV blocks and dQ K/V tiles: bf16 1.06x to 1.23x,
//   f32 dK/dV 1.25x to 1.32x (fewer blocks an SM);
// - a third ring stage: bf16 0.98x to 1.06x, f32 dK/dV 1.37x to 1.42x
//   (shared memory for one block an SM fewer);
// - the heads side by side in the grid instead of a head's tiles: 0.99x to
//   1.04x;
// - conv3x3_igemm.cuh's split_tf32: f32 1.22x to 1.37x (split_3xtf32);
// - no minimum of 16 dQ warps an SM in bf16 (DQ_MIN_BLOCKS): 1.26x (T =
//   128) and 1.43x (T = 2048);
// - f32 chunk loops unrolled: 1.01x to 1.04x.
// With the products taken out the kernels still take 0.29x to 0.81x of
// their time in bf16: their loads and stores are that floor.  Not tried:
// wgmma and TMA (64-row warpgroup tiles), and warps of 32 rows, which
// would halve the shared-memory reads of the other tile's fragments.
//
// The JAX wrapper's padding of T and S and its materialized [B, 1, S] bias
// have no counterpart: tails are masked here and the mask is read in place,
// batch row b = (b*h) / H.  The helpers the forward kernel shares (masking,
// pitches, row loads, the warp products) are in flash_attn_common.cuh.
#include "flash_attn_common.cuh"

namespace {

using namespace flash_attn;

constexpr int DQ_BLOCK_ROWS = 128;  // query rows a dQ block (Cfg::DQ_ROWS)
constexpr int BQ = 64;      // query rows a dK/dV tile
constexpr int BK = 64;      // key rows: a dK/dV block, a dQ tile
constexpr int STAGES = 2;   // tiles in the cp.async ring
constexpr int DKV_THREADS = 32 * (BK / 16);  // a warp per 16 key rows

static_assert(DQ_BLOCK_ROWS % 16 == 0 && BQ % 16 == 0 && BK % 16 == 0 && STAGES >= 2, "tiles");
static_assert(BQ <= DKV_THREADS, "one stat value a thread");

struct Params {
  Strides q, k, v, o, g, dq, dk, dv;
  long long mask_b;
  int H, T, S, D;
  int mask_dtype;
  int causal;
  int vec;  // q, k, v and dO rows and bases 16-byte aligned: cp.async copies
  float scale;
};

// One instantiation: element type T and the largest head dimension DMAX
// (row pitches: flash_attn_common.cuh's Pitch).
template <typename T, int DMAX>
struct Cfg : Pitch<T, DMAX> {
  using P = Pitch<T, DMAX>;
  // keys (dQ) or queries (dK/dV) a pass; f32 keeps it to 16 so the warps'
  // buffers leave room for two blocks an SM at D = 64
  static constexpr int CHUNK = P::BF16 ? 32 : 16;
  static constexpr int CT = CHUNK / 8;   // n8 tiles of a chunk
  // f32: the warp's [16][LDC] buffer; 20 words a row puts a (g, t) load in
  // 32 banks
  static constexpr int LDC = CHUNK + 4;
  static constexpr int BUF_FLOATS = P::BF16 ? 0 : 16 * LDC;
  // query rows a dQ block: 64 for f32 at D <= 128, where 128 rows of Q and
  // dO beside the K/V ring would outgrow shared memory
  static constexpr int DQ_ROWS = !P::BF16 && DMAX == 128 ? 64 : DQ_BLOCK_ROWS;
  static constexpr int DQ_THREADS = 32 * (DQ_ROWS / 16);  // a warp per 16 query rows
  static constexpr int TILE_Q = BQ * P::LD;   // elements of a BQ-row tile
  static constexpr int TILE_K = BK * P::LD;
  // dQ: Q, dO; STAGES x (K, V); STAGES x key bias [BK]; the warps' buffers
  static constexpr int DQ_SMEM = (2 * DQ_ROWS * P::LD + STAGES * 2 * TILE_K) * (int)sizeof(T) +
                                 (STAGES * BK + (DQ_ROWS / 16) * BUF_FLOATS) * 4;
  // dK/dV: K, V; STAGES x (Q, dO); STAGES x (lse, delta) [BQ]; key bias
  // [BK]; the warps' buffers
  static constexpr int DKV_SMEM = (2 * TILE_K + STAGES * 2 * TILE_Q) * (int)sizeof(T) +
                                  (STAGES * 2 * BQ + BK + (BK / 16) * BUF_FLOATS) * 4;
  // bf16 at D <= 64: 16 dQ warps an SM (at most 128 registers a thread;
  // ptxas spills 20 bytes); ptxas's own choice of registers, and fewer
  // warps, was 1.26x to 1.43x slower on an H100 (attn_variants.py)
  static constexpr int DQ_MIN_BLOCKS = P::BF16 && DMAX == 64 ? 16 * 32 / DQ_THREADS : 1;
  static_assert(DQ_SMEM <= 232448 && DKV_SMEM <= 232448, "shared memory");
  static_assert(BK <= DQ_THREADS, "one bias value a thread");
};

__device__ __forceinline__ void cp_async4(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <typename T, int DMAX>
__global__ void __launch_bounds__(Cfg<T, DMAX>::DQ_THREADS, Cfg<T, DMAX>::DQ_MIN_BLOCKS)
flash_attn_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ o,
                         const T* __restrict__ g, const float* __restrict__ lse,
                         const void* __restrict__ mask, T* __restrict__ dq,
                         float* __restrict__ delta, const Params p) {
  using C = Cfg<T, DMAX>;
  extern __shared__ __align__(128) unsigned char smem[];
  T* Qs = reinterpret_cast<T*>(smem);     // [DQ_ROWS][LD]
  T* Gs = Qs + C::DQ_ROWS * C::LD;        // [DQ_ROWS][LD] dO
  T* ring = Gs + C::DQ_ROWS * C::LD;      // STAGES x (K, V) [BK][LD]
  float* bias_s = reinterpret_cast<float*>(ring + STAGES * 2 * C::TILE_K);  // STAGES x [BK]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gr = lane >> 2, tq = lane & 3;  // fragment row and column group
  float* buf = bias_s + STAGES * BK + warp * C::BUF_FLOATS;
  // the query tiles of one head are neighbours in the grid: they run side
  // by side and read the head's K and V from L2 once
  const int nqt = (p.T + C::DQ_ROWS - 1) / C::DQ_ROWS;
  const int bh = blockIdx.x / nqt;
  const int b = bh / p.H, h = bh % p.H;
  const int q0 = (blockIdx.x % nqt) * C::DQ_ROWS;
  const int m0 = warp * 16;               // the warp's rows in the tile
  const int row0 = q0 + m0;
  const bool vec = p.vec != 0;
  const T* kb = k + b * p.k.b + h * p.k.h;
  const T* vb = v + b * p.v.b + h * p.v.h;
  const T* gb = g + b * p.g.b + h * p.g.h;
  const T* ob = o + b * p.o.b + h * p.o.h;

  int nkv = (p.S + BK - 1) / BK;
  if (p.causal) nkv = min(nkv, (min(q0 + C::DQ_ROWS, p.T) - 1) / BK + 1);

  load_rows<T, DMAX, C::DQ_ROWS, C::DQ_THREADS>(Qs, q + b * p.q.b + h * p.q.h, p.q.t, q0, p.T,
                                               p.D, vec, tid);
  load_rows<T, DMAX, C::DQ_ROWS, C::DQ_THREADS>(Gs, gb, p.g.t, q0, p.T, p.D, vec, tid);
  cp_async_commit();
  auto issue = [&](int j) {
    T* st = ring + (j % STAGES) * 2 * C::TILE_K;
    load_rows<T, DMAX, BK, C::DQ_THREADS>(st, kb, p.k.t, j * BK, p.S, p.D, vec, tid);
    load_rows<T, DMAX, BK, C::DQ_THREADS>(st + C::TILE_K, vb, p.v.t, j * BK, p.S, p.D, vec,
                                          tid);
  };
#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < nkv) {
      issue(st);
      if (tid < BK) bias_s[st * BK + tid] = key_bias_of(p, mask, b, st * BK + tid);
    }
    cp_async_commit();
  }

  // delta = rowsum(dO * out) in f32 for the warp's rows, while the copies
  // are in flight; lse beside it.  Rows past T and columns past D read an
  // element inside the slice and weigh it 0, so there is no branch and every
  // load is issued before the first product.  Rows past T take p = 0 below.
  float prod[16][DMAX / 32];
#pragma unroll
  for (int r = 0; r < 16; ++r) {
    const int64_t row = min(row0 + r, p.T - 1);
#pragma unroll
    for (int c0 = 0; c0 < DMAX; c0 += 32) {
      const int c = min(c0 + lane, p.D - 1);
      prod[r][c0 / 32] = to_f32(gb[row * p.g.t + c]) * to_f32(ob[row * p.o.t + c]);
    }
  }
  float lse_r[2], delta_r[2];
  bool row_ok[2];
#pragma unroll
  for (int r = 0; r < 16; ++r) {
    float d = 0.0f;
#pragma unroll
    for (int c0 = 0; c0 < DMAX; c0 += 32) d += c0 + lane < p.D ? prod[r][c0 / 32] : 0.0f;
    d = warp_sum(d);
    if (r == gr) delta_r[0] = d;
    if (r == gr + 8) delta_r[1] = d;
    if (lane == 0 && row0 + r < p.T) delta[(int64_t)bh * p.T + row0 + r] = d;
  }
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int row = row0 + gr + 8 * hr;
    row_ok[hr] = row < p.T;
    const float l = lse[(int64_t)bh * p.T + min(row, p.T - 1)];
    lse_r[hr] = row_ok[hr] ? l : 0.0f;
  }

  float acc[C::NT][4];
#pragma unroll
  for (int nt = 0; nt < C::NT; ++nt)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[nt][c] = 0.0f;

  for (int j = 0; j < nkv; ++j) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // tile j (and Q, dO) landed; every thread left tile j - 1
    const int nx = j + STAGES - 1;
    float next_bias = 0.0f;
    if (nx < nkv) {
      issue(nx);
      if (tid < BK) next_bias = key_bias_of(p, mask, b, nx * BK + tid);
    }
    cp_async_commit();

    const int k0 = j * BK;
    const T* Ks = ring + (j % STAGES) * 2 * C::TILE_K;
    const T* Vs = Ks + C::TILE_K;
    const float* bias = bias_s + (j % STAGES) * BK;
    // f32: a chunk at a time (fewer live registers; unrolled was 1.01x to
    // 1.04x slower on an H100)
#pragma unroll(C::BF16 ? 2 : 1)
    for (int kc = 0; kc < BK; kc += C::CHUNK) {
      // chunks wholly past S, rows wholly past T, or (causal) keys wholly
      // after the warp's rows add nothing
      if (k0 + kc >= p.S || row0 >= p.T || (p.causal && k0 + kc > row0 + 15)) break;
      float s[C::CT][4], dp[C::CT][4];
#pragma unroll
      for (int nt = 0; nt < C::CT; ++nt)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          s[nt][c] = 0.0f;
          dp[nt][c] = 0.0f;
        }
      score_products<T, DMAX>(s, dp, Qs, Ks, Gs, Vs, m0, kc, lane);
      // p and dS for (row gr + 8 * (e >> 1), key 2 * tq + (e & 1)) of each
      // n8 tile; s takes dS
#pragma unroll
      for (int nt = 0; nt < C::CT; ++nt) {
        const int kl = kc + nt * 8 + 2 * tq;
        const float2 kbias = *reinterpret_cast<const float2*>(bias + kl);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int hr = e >> 1;
          float sv = s[nt][e] * p.scale + ((e & 1) ? kbias.y : kbias.x);
          if (p.causal && k0 + kl + (e & 1) > row0 + gr + 8 * hr) sv = -INFINITY;
          const float pv = row_ok[hr] ? exp2f((sv - lse_r[hr]) * LOG2E) : 0.0f;
          s[nt][e] = pv * (dp[nt][e] - delta_r[hr]);
        }
      }
      output_product<T, DMAX>(acc, s, Ks, kc, buf, lane);
    }
    if (nx < nkv && tid < BK) bias_s[(nx % STAGES) * BK + tid] = next_bias;
  }
  cp_async_wait<0>();

  T* dqb = dq + b * p.dq.b + h * p.dq.h;
#pragma unroll
  for (int nt = 0; nt < C::NT; ++nt) {
    const int col = nt * 8 + 2 * tq;
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int row = row0 + gr + 8 * hr;
      if (row >= p.T) continue;
      if (col < p.D)
        store2(dqb + (int64_t)row * p.dq.t + col, acc[nt][2 * hr] * p.scale,
               acc[nt][2 * hr + 1] * p.scale, col + 1 < p.D);
    }
  }
}

template <typename T, int DMAX>
__global__ void __launch_bounds__(DKV_THREADS)
flash_attn_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, const T* __restrict__ g,
                          const float* __restrict__ lse, const float* __restrict__ delta,
                          const void* __restrict__ mask, T* __restrict__ dk,
                          T* __restrict__ dv, const Params p) {
  using C = Cfg<T, DMAX>;
  extern __shared__ __align__(128) unsigned char smem[];
  T* Ks = reinterpret_cast<T*>(smem);     // [BK][LD]
  T* Vs = Ks + C::TILE_K;                 // [BK][LD]
  T* ring = Vs + C::TILE_K;               // STAGES x (Q, dO) [BQ][LD]
  float* stats = reinterpret_cast<float*>(ring + STAGES * 2 * C::TILE_Q);  // STAGES x (lse, delta) [BQ]
  float* bias_s = stats + STAGES * 2 * BQ;  // [BK]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gr = lane >> 2, tq = lane & 3;
  float* buf = bias_s + BK + warp * C::BUF_FLOATS;
  const int nkt = (p.S + BK - 1) / BK;   // the key tiles of a head side by side
  const int bh = blockIdx.x / nkt;
  const int b = bh / p.H, h = bh % p.H;
  const int k0 = (blockIdx.x % nkt) * BK;
  const int m0 = warp * 16;               // the warp's keys in the block's
  const int key0 = k0 + m0;
  const bool vec = p.vec != 0;
  const T* qb = q + b * p.q.b + h * p.q.h;
  const T* gb = g + b * p.g.b + h * p.g.h;
  const float* lse_b = lse + (int64_t)bh * p.T;
  const float* delta_b = delta + (int64_t)bh * p.T;

  load_rows<T, DMAX, BK, DKV_THREADS>(Ks, k + b * p.k.b + h * p.k.h, p.k.t, k0, p.S, p.D, vec,
                                      tid);
  load_rows<T, DMAX, BK, DKV_THREADS>(Vs, v + b * p.v.b + h * p.v.h, p.v.t, k0, p.S, p.D, vec,
                                      tid);
  cp_async_commit();
  if (tid < BK) bias_s[tid] = key_bias_of(p, mask, b, k0 + tid);

  const int nq = (p.T + BQ - 1) / BQ;
  // causal: query tiles wholly before the key tile see none of its keys
  const int first = p.causal ? min(k0 / BQ, nq) : 0;
  auto issue = [&](int i) {
    T* st = ring + (i % STAGES) * 2 * C::TILE_Q;
    load_rows<T, DMAX, BQ, DKV_THREADS>(st, qb, p.q.t, i * BQ, p.T, p.D, vec, tid);
    load_rows<T, DMAX, BQ, DKV_THREADS>(st + C::TILE_Q, gb, p.g.t, i * BQ, p.T, p.D, vec, tid);
    if (tid < BQ) {
      const int row = i * BQ + tid;
      const bool ok = row < p.T;
      float* sl = stats + (i % STAGES) * 2 * BQ;
      cp_async4(sl + tid, ok ? lse_b + row : lse_b, ok ? 4 : 0);
      cp_async4(sl + BQ + tid, ok ? delta_b + row : delta_b, ok ? 4 : 0);
    }
  };
#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (first + st < nq) issue(first + st);
    cp_async_commit();
  }

  float dk_acc[C::NT][4], dv_acc[C::NT][4];
#pragma unroll
  for (int nt = 0; nt < C::NT; ++nt)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      dk_acc[nt][c] = 0.0f;
      dv_acc[nt][c] = 0.0f;
    }
  for (int i = first; i < nq; ++i) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // tile i (and K, V, the bias) landed; every thread left tile i - 1
    const int nx = i + STAGES - 1;
    if (nx < nq) issue(nx);
    cp_async_commit();

    const int q0 = i * BQ;
    const T* Qt = ring + (i % STAGES) * 2 * C::TILE_Q;
    const T* Gt = Qt + C::TILE_Q;
    const float* lse_t = stats + (i % STAGES) * 2 * BQ;
    const float* delta_t = lse_t + BQ;
#pragma unroll(C::BF16 ? 2 : 1)  // as in the dQ kernel
    for (int qc = 0; qc < BQ; qc += C::CHUNK) {
      // queries wholly past T, keys wholly past S, or (causal) queries
      // wholly before the warp's keys add nothing
      if (q0 + qc >= p.T || key0 >= p.S) break;
      if (p.causal && q0 + qc + C::CHUNK - 1 < key0) continue;
      float s[C::CT][4], dp[C::CT][4];
#pragma unroll
      for (int nt = 0; nt < C::CT; ++nt)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          s[nt][c] = 0.0f;
          dp[nt][c] = 0.0f;
        }
      score_products<T, DMAX>(s, dp, Ks, Qt, Vs, Gt, m0, qc, lane);
      // P^T and dS^T for (key gr + 8 * (e >> 1), query 2 * tq + (e & 1)) of
      // each n8 tile; s takes p, dp takes dS
#pragma unroll
      for (int nt = 0; nt < C::CT; ++nt) {
        const int ql = qc + nt * 8 + 2 * tq;
        const float2 l2 = *reinterpret_cast<const float2*>(lse_t + ql);
        const float2 d2 = *reinterpret_cast<const float2*>(delta_t + ql);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int hr = e >> 1;
          const int row = q0 + ql + (e & 1);
          float sv = s[nt][e] * p.scale + bias_s[m0 + gr + 8 * hr];
          if (p.causal && key0 + gr + 8 * hr > row) sv = -INFINITY;
          const float pv =
              row < p.T ? exp2f((sv - ((e & 1) ? l2.y : l2.x)) * LOG2E) : 0.0f;
          s[nt][e] = pv;
          dp[nt][e] = pv * (dp[nt][e] - ((e & 1) ? d2.y : d2.x));
        }
      }
      output_product<T, DMAX>(dv_acc, s, Gt, qc, buf, lane);
      output_product<T, DMAX>(dk_acc, dp, Qt, qc, buf, lane);
    }
  }
  cp_async_wait<0>();

  T* dkb = dk + b * p.dk.b + h * p.dk.h;
  T* dvb = dv + b * p.dv.b + h * p.dv.h;
#pragma unroll
  for (int nt = 0; nt < C::NT; ++nt) {
    const int col = nt * 8 + 2 * tq;
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int key = key0 + gr + 8 * hr;
      if (key >= p.S) continue;
      if (col >= p.D) continue;
      store2(dkb + (int64_t)key * p.dk.t + col, dk_acc[nt][2 * hr] * p.scale,
             dk_acc[nt][2 * hr + 1] * p.scale, col + 1 < p.D);
      store2(dvb + (int64_t)key * p.dv.t + col, dv_acc[nt][2 * hr], dv_acc[nt][2 * hr + 1],
             col + 1 < p.D);
    }
  }
}

template <typename T, int DMAX>
cudaError_t launch_dq(const void* q, const void* k, const void* v, const void* o, const void* g,
                      const float* lse, const void* mask, void* dq, float* delta,
                      const Params& p, int B, cudaStream_t stream) {
  using C = Cfg<T, DMAX>;
  static bool raised[MAX_DEVICES];
  auto* kernel = flash_attn_bwd_dq_kernel<T, DMAX>;
  cudaError_t e = allow_smem((const void*)kernel, C::DQ_SMEM, raised);
  if (e != cudaSuccess) return e;
  const dim3 grid((unsigned)((long long)B * p.H * ((p.T + C::DQ_ROWS - 1) / C::DQ_ROWS)));
  kernel<<<grid, C::DQ_THREADS, C::DQ_SMEM, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(o), static_cast<const T*>(g), lse, mask, static_cast<T*>(dq), delta,
      p);
  return cudaGetLastError();
}

template <typename T, int DMAX>
cudaError_t launch_dkv(const void* q, const void* k, const void* v, const void* g,
                       const float* lse, const float* delta, const void* mask, void* dk,
                       void* dv, const Params& p, int B, cudaStream_t stream) {
  static bool raised[MAX_DEVICES];
  auto* kernel = flash_attn_bwd_dkv_kernel<T, DMAX>;
  cudaError_t e = allow_smem((const void*)kernel, Cfg<T, DMAX>::DKV_SMEM, raised);
  if (e != cudaSuccess) return e;
  const dim3 grid((unsigned)((long long)B * p.H * ((p.S + BK - 1) / BK)));
  kernel<<<grid, DKV_THREADS, Cfg<T, DMAX>::DKV_SMEM, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(g), lse, delta, mask, static_cast<T*>(dk), static_cast<T*>(dv), p);
  return cudaGetLastError();
}

// Fills Params from the wrapper's 25 strides, or returns false on a shape
// the kernels do not take.
bool make_params(Params* p, const long long* strides, const void* q, const void* k,
                 const void* v, const void* g, int B, int H, int T, int S, int D,
                 int mask_dtype, const void* mask, int causal, float scale, int dtype) {
  if (B <= 0 || H <= 0 || T <= 0 || S <= 0 || D <= 0 || D > MAX_D || dtype < 0 || dtype > 1 ||
      (long long)B * H * ((T + BQ - 1) / BQ) > 0x7fffffffLL ||  // BQ <= every DQ_ROWS
      (long long)B * H * ((S + BK - 1) / BK) > 0x7fffffffLL || mask_dtype < MASK_NONE ||
      mask_dtype > MASK_F64 ||
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
  const int es = dtype == 0 ? 4 : 2;
  p->vec = aligned16(q, p->q, B, H, T, es) && aligned16(k, p->k, B, H, S, es) &&
           aligned16(v, p->v, B, H, S, es) && aligned16(g, p->g, B, H, T, es);
  return true;
}

}  // namespace

extern "C" {

// The tiles of the D <= 64 instances, for the wrapper to check against
// ``DEFAULT_TILES["attention_bwd"]``: query rows a dQ block, key rows a
// dK/dV block (and a dQ tile).
void dl4j_flash_attn_bwd_tile(int* bq, int* bk) {
  *bq = Cfg<__nv_bfloat16, 64>::DQ_ROWS;
  *bk = BK;
}

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
  if (!make_params(&p, strides, q, k, v, dout, B, H, T, S, D, mask_dtype, mask, causal, scale,
                   dtype))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  if (dtype == 0)
    return (int)(D <= 64 ? launch_dq<float, 64>(q, k, v, out, dout, l, mask, dq, dl, p, B, s)
                         : launch_dq<float, 128>(q, k, v, out, dout, l, mask, dq, dl, p, B, s));
  return (int)(D <= 64
                   ? launch_dq<__nv_bfloat16, 64>(q, k, v, out, dout, l, mask, dq, dl, p, B, s)
                   : launch_dq<__nv_bfloat16, 128>(q, k, v, out, dout, l, mask, dq, dl, p, B, s));
}

// dk and dv from q, k, v, dO, the forward's lse and the dQ kernel's delta.
int dl4j_flash_attn_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                            const void* lse, const void* delta, const void* mask, void* dk,
                            void* dv, const long long* strides, int B, int H, int T, int S,
                            int D, int mask_dtype, int causal, float scale, int dtype,
                            void* stream) {
  Params p;
  if (!make_params(&p, strides, q, k, v, dout, B, H, T, S, D, mask_dtype, mask, causal, scale,
                   dtype))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  if (dtype == 0)
    return (int)(D <= 64 ? launch_dkv<float, 64>(q, k, v, dout, l, dl, mask, dk, dv, p, B, s)
                         : launch_dkv<float, 128>(q, k, v, dout, l, dl, mask, dk, dv, p, B, s));
  return (int)(D <= 64
                   ? launch_dkv<__nv_bfloat16, 64>(q, k, v, dout, l, dl, mask, dk, dv, p, B, s)
                   : launch_dkv<__nv_bfloat16, 128>(q, k, v, dout, l, dl, mask, dk, dv, p, B,
                                                    s));
}

}  // extern "C"
