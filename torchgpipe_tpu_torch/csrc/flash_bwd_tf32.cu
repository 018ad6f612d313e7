// Float32 flash attention backward for Hopper (sm_90a) on the tensor cores,
// at float32 accuracy (3xTF32): dQ, and dK/dV summed over each kv head's
// query heads, of causal / windowed / unmasked GQA attention, recomputing
// the softmax from the natural-log logsumexp that flash_fwd_tf32.cu writes.
//
// Replaces: torchgpipe_tpu/ops/flash_attention.py:_dq_kernel and
// :_dkv_kernel (with their streaming forms and the group sum after them)
// at float32: the Pallas kernels take float32 operands
// (`.astype(jnp.float32)`), which flash_bwd.cu's bf16 wgmma does not.
// flash_simt.cu's dq_f32_kernel and dkv_f32_kernel (CUDA-core FMAs) stay
// for head dims TMA cannot map (d % 4 != 0).
//
// Bound on the H100: operations.  With P attended (query, key) pairs, dQ
// does three products (S = Q K^T, dP = dO V^T, dQ = dS K), 6 * b * h * d *
// P FLOPs, and dK/dV four (S^T, dP^T, dV = P^T dO, dK = dS^T Q), 8 * b * h
// * d * P; each float32-accurate product is three TF32 products
// (hopper_tiles.cuh: x = big + small, A B ~ As Bb + Ab Bs + Ab Bb) at 495
// TFLOP/s.  The design is flash_bwd.cu's with flash_fwd_tf32.cu's split:
//
// * tf32 wgmma reads A and B K-major only (no transpose bits).  S^T = K
//   Q^T, dP^T = V dO^T, S = Q K^T and dP = dO V^T take their operands as
//   stored (d contiguous).  dV += P^T dO, dK += dS^T Q and dQ += dS K take
//   P^T, dS^T and dS from the accumulator registers as the A operand, so
//   their B operands must have the reduction axis contiguous: Qt and dOt
//   [d, queries], Kt [d, keys].  Inside each aligned group of 8 positions
//   they hold positions 0 2 4 6 1 3 5 7, the order in which a thread's
//   accumulator columns (2c, 2c+1 of each 8) fall into an A fragment's k
//   positions (c, c+4), as flash_fwd_tf32.cu's Vt: no shuffle.
// * One prologue launch a backward call (tf32_bwd_split_kernel) writes
//   the big and small parts of Q, dO, K and V as stored, and of Qt, dOt
//   and Kt (zeros past the sequence, up to a multiple of 32).  Both
//   kernels then only TMA-load: ~4x the bytes of q/k/v/dO written once,
//   small beside the products.
// * flash_bwd_dkv_tf32: the work list of ops/flash_attention.py
//   dkv_schedule at TF32_DKV_TILES (128 keys at template dim 64, 64 at
//   128; 32 queries), one persistent block per SM.  An item holds its
//   key tile's K and V (big, small) resident; one producer thread streams
//   its (query head, 32-query tile) loop through a ring of slots, each
//   tile as two loads: Q, Qs, dO, dOs as stored (for S^T and dP^T, SS
//   wgmma m64n32k8), then Qt, dOt (big, small) (for dV and dK, RS wgmma
//   m64nDk8 with P^T and dS^T as A fragments).  Each consumer warpgroup
//   owns 64 keys and keeps their dK and dV in registers: two warpgroups
//   on 128 keys and three slots at template dim 64 (224 KB), one on 64
//   keys and one slot at 128 (192 KB; the tile's two loads follow each
//   other).  The Q-side tiles are most of the bytes this kernel moves
//   through L2 (64 KB a tile): 128 keys an item halve them per product.
//   An item holding its tile's whole loop writes dK (times the scale) and
//   dV itself; a cut item writes float32 partials to its slot, which
//   flash_bwd_dkv_tf32_sum_kernel adds in slot order.  No atomics: the
//   outputs are bitwise equal run to run.
// * flash_bwd_dq_tf32: the work list of fwd_schedule at (128 rows, 32
//   keys) with two consumer warpgroups at template dim 64, (64, 32) with
//   one at 128; Q and dO (big, small) resident a tile, a ring of 32-key
//   tiles holding K, V and Kt (big, small): two stages at 64, one at 128
//   (224 KB).  S and dP are SS wgmma m64n32k8; dQ += dS Kt is RS m64nDk8.
//   dQ stays in registers and is written once, times the scale.
// * Head dims: template 64 (d <= 64) and 128 (d <= 128), any d % 4 == 0.
//   Column blocks wholly past d are never loaded: the tile area is zeroed
//   once at the start, so K's (dK/dV) and Q's (dQ) are zero and add
//   nothing to a product; columns past d of a loaded block, and Qt/dOt/Kt
//   rows past d, arrive as zeros (TMA's out-of-bounds fill) and give zero
//   output columns, which are not stored.
// Element masks (the `visible` rule) run only on tiles that straddle an
// edge; a masked pair gets p = 0.  A row that sees no key (lse = -inf)
// gets p = 0 everywhere, so zero gradients.  Every big part is truncated
// explicitly, so the tensor core's own reading of the low bits does not
// matter.

#include <math_constants.h>

#include "hopper_tiles.cuh"

namespace {

using namespace hopper;

constexpr float LOG2E = 1.4426950408889634f;
constexpr int TILE = 32;            // queries of a dK/dV tile, keys of a dQ tile
constexpr int SPLIT_THREADS = 256;
constexpr int ITEM_INTS = 8;        // a dK/dV work item (see dkv_schedule)

__host__ __device__ __forceinline__ int round_up(int n, int m) { return (n + m - 1) / m * m; }

// The position held at p of a transposed operand's position axis: in each
// aligned group of 8, 0 2 4 6 1 3 5 7.
__device__ __forceinline__ int permuted_pos(int p) {
  const int j = p & 7;
  return (p & ~7) + (j < 4 ? 2 * j : 2 * j - 7);
}

// The prologue's output, one float32 buffer (ops/flash_attention.py
// tf32_bwd_split_shapes gives the same order): Qb Qs dOb dOs [b, s, h, d],
// Kb Ks Vb Vs [b, sk, g, d], Qtb Qts dOtb dOts [b, h, d, sp], Ktb Kts [b,
// g, d, skp] (sp, skp: s, sk rounded up to 32).
struct Split {
  float *qb, *qs, *dob, *dos, *kb, *ks, *vb, *vs, *qtb, *qts, *dotb, *dots, *ktb, *kts;
};

inline Split split_layout(float* p, int b, int s, int sk, int h, int g, int d) {
  const size_t nq = size_t(b) * s * h * d, nk = size_t(b) * sk * g * d;
  const size_t nqt = size_t(b) * h * d * round_up(s, TILE);
  const size_t nkt = size_t(b) * g * d * round_up(sk, TILE);
  Split x;
  x.qb = p;
  x.qs = x.qb + nq;
  x.dob = x.qs + nq;
  x.dos = x.dob + nq;
  x.kb = x.dos + nq;
  x.ks = x.kb + nk;
  x.vb = x.ks + nk;
  x.vs = x.vb + nk;
  x.qtb = x.vs + nk;
  x.qts = x.qtb + nqt;
  x.dotb = x.qts + nqt;
  x.dots = x.dotb + nqt;
  x.ktb = x.dots + nqt;
  x.kts = x.ktb + nkt;
  return x;
}

// blockIdx.z picks the tensor (0 q, 1 dO, 2 K, 3 V), blockIdx.y its
// (batch, head), blockIdx.x 32 of its positions: big and small parts as
// stored, and (q, dO, K) transposed with permuted positions, zeros past
// the sequence.  Grid (max(sp, skp) / 32, b * h, 4).
__global__ void __launch_bounds__(SPLIT_THREADS) tf32_bwd_split_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ dout, Split x, int b, int s, int sk, int h, int g, int d) {
  __shared__ float tile[TILE][128 + 1];
  const int z = blockIdx.z;
  const int n = z < 2 ? s : sk, heads = z < 2 ? h : g;
  const int np = round_up(n, TILE), p0 = blockIdx.x * TILE;
  if (p0 >= np || int(blockIdx.y) >= b * heads) return;
  const float* src = z == 0 ? q : z == 1 ? dout : z == 2 ? k : v;
  float* big = z == 0 ? x.qb : z == 1 ? x.dob : z == 2 ? x.kb : x.vb;
  float* small = z == 0 ? x.qs : z == 1 ? x.dos : z == 2 ? x.ks : x.vs;
  float* tb = z == 0 ? x.qtb : z == 1 ? x.dotb : z == 2 ? x.ktb : nullptr;
  float* ts = z == 0 ? x.qts : z == 1 ? x.dots : z == 2 ? x.kts : nullptr;
  const int bi = blockIdx.y / heads, hh = blockIdx.y % heads;
  for (int i = threadIdx.x; i < TILE * d; i += SPLIT_THREADS) {
    const int pp = i / d, dd = i - pp * d, pos = p0 + pp;
    float y = 0.f;
    if (pos < n) {
      const size_t off = ((size_t(bi) * n + pos) * heads + hh) * d + dd;
      y = src[off];
      big[off] = __uint_as_float(tf32_big(y));
      small[off] = __uint_as_float(tf32_small(y));
    }
    tile[pp][dd] = y;
  }
  if (tb == nullptr) return;   // uniform over the block
  __syncthreads();
  for (int i = threadIdx.x; i < d * TILE; i += SPLIT_THREADS) {
    const int dd = i / TILE, p = i % TILE;
    const float y = tile[permuted_pos(p)][dd];
    const size_t off = ((size_t(bi) * heads + hh) * d + dd) * np + p0 + p;
    tb[off] = __uint_as_float(tf32_big(y));
    ts[off] = __uint_as_float(tf32_small(y));
  }
}

// acc = As Bb + Ab Bs + Ab Bb over the reduction dim D, for 64 rows of A
// (column blocks of MA rows at ab / as) against the N rows of B (column
// blocks of N rows at bb / bs).  Not committed.
template <int D, int MA, int N>
__device__ __forceinline__ void ss3(float (&acc)[N / 2], uint32_t ab, uint32_t as, uint32_t bb,
                                    uint32_t bs) {
#pragma unroll
  for (int part = 0; part < 3; ++part) {
    const uint32_t a = part == 0 ? as : ab, bq = part == 1 ? bs : bb;
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk) {
      const uint32_t off = (kk % 4) * 32u;
      wgmma_tf32_ss<N>(acc, desc_k(a + (kk / 4) * MA * 128 + off),
                       desc_k(bq + (kk / 4) * N * 128 + off), part > 0 || kk > 0);
    }
  }
}

// Zeros over the first `bytes` of the tile area (a multiple of 16), so that
// column blocks past d, which are never loaded, add nothing to a product
// (and no stale bits of the allocation reach one).
__device__ __forceinline__ void zero_tiles(uint8_t* sm, int bytes, int threads) {
  float4* p = reinterpret_cast<float4*>(sm);
  for (int i = threadIdx.x; i < bytes / 16; i += threads) p[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  fence_proxy_async();
}

// acc += As Bb + Ab Bs + Ab Bb over 32 reduction positions: A (64 x 32)
// from registers (k8 step t in ab/as[4t .. 4t+3]), B K-major [N rows][32]
// at bb / bs (one column block).  Not committed.
template <int N>
__device__ __forceinline__ void rs3(float (&acc)[N / 2], const uint32_t (&ab)[TILE / 2],
                                    const uint32_t (&as)[TILE / 2], uint32_t bb, uint32_t bs) {
#pragma unroll
  for (int kk = 0; kk < TILE / 8; ++kk) {
    const uint32_t off = kk * 32u;
    wgmma_tf32_rs<N>(acc, as[4 * kk], as[4 * kk + 1], as[4 * kk + 2], as[4 * kk + 3],
                     desc_k(bb + off), 1);
    wgmma_tf32_rs<N>(acc, ab[4 * kk], ab[4 * kk + 1], ab[4 * kk + 2], ab[4 * kk + 3],
                     desc_k(bs + off), 1);
    wgmma_tf32_rs<N>(acc, ab[4 * kk], ab[4 * kk + 1], ab[4 * kk + 2], ab[4 * kk + 3],
                     desc_k(bb + off), 1);
  }
}

// An m64n32 accumulator as A fragments (big, small) of the next product:
// k8 step t takes columns 8t + 2c, +1 of rows r, r + 8 to k positions c,
// c + 4 (the permuted order of the B operand's positions).
__device__ __forceinline__ void to_frags(const float (&x)[TILE / 2], uint32_t (&fb)[TILE / 2],
                                         uint32_t (&fs)[TILE / 2]) {
#pragma unroll
  for (int t = 0; t < TILE / 8; ++t) {
    const float y[4] = {x[4 * t], x[4 * t + 2], x[4 * t + 1], x[4 * t + 3]};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      fb[4 * t + e] = tf32_big(y[e]);
      fs[4 * t + e] = tf32_small(y[e]);
    }
  }
}

// A row's lse in log2 units for exp2; a row that sees no key (lse = -inf)
// gets +inf, so that every p of it is 0.
__device__ __forceinline__ float lse_log2(float l) {
  return l == -CUDART_INF_F ? CUDART_INF_F : l * LOG2E;
}

// ---- flash_bwd_dq_tf32 -------------------------------------------------------

template <int D>
struct Dq {
  static constexpr int NWG = D == 64 ? 2 : 1;     // consumer warpgroups
  static constexpr int BQ = 64 * NWG;             // query rows of a tile
  static constexpr int BK = TILE;                 // keys of a K/V tile
  static constexpr int STAGES = D == 64 ? 2 : 1;
  static constexpr int THREADS = 128 * (NWG + 1);
  static constexpr int Q_PART = BQ * D * 4;       // one of Qb, Qs, dOb, dOs
  static constexpr int KV_PART = BK * D * 4;      // one of Kb Ks Vb Vs [32][D], Ktb Kts [D][32]
  static constexpr int STAGE = 6 * KV_PART;
  static constexpr int Q = 0;
  static constexpr int K = 4 * Q_PART;            // [stage][Kb, Ks, Vb, Vs, Ktb, Kts]
  static constexpr int BAR = K + STAGES * STAGE;
  // q_full, q_empty, kv_full[S], kv_empty[S]
  static constexpr int BYTES = BAR + (2 + 2 * STAGES) * 8;
  static constexpr int ALLOC = BYTES + 1024;
  static_assert(ALLOC <= 232448, "shared memory");
};

template <int D>
__global__ void __launch_bounds__(Dq<D>::THREADS, 1)
flash_bwd_dq_tf32_kernel(const __grid_constant__ CUtensorMap tqb,
                         const __grid_constant__ CUtensorMap tqs,
                         const __grid_constant__ CUtensorMap tdob,
                         const __grid_constant__ CUtensorMap tdos,
                         const __grid_constant__ CUtensorMap tkb,
                         const __grid_constant__ CUtensorMap tks,
                         const __grid_constant__ CUtensorMap tvb,
                         const __grid_constant__ CUtensorMap tvs,
                         const __grid_constant__ CUtensorMap tktb,
                         const __grid_constant__ CUtensorMap tkts, const float* __restrict__ lse,
                         const float* __restrict__ delta, const int* __restrict__ plan,
                         float* __restrict__ dq, int b, int s, int sk, int h, int g, int d,
                         float scale, int causal, int window) {
  typedef Dq<D> C;
  constexpr int BQ = C::BQ, BK = C::BK, STAGES = C::STAGES;
  typedef QueryTile<BQ, BK> T;   // n = 0: no key visible (dQ = 0)
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = align1024(smem_raw);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(sm + C::BAR);
  uint64_t* q_empty = q_full + 1;
  uint64_t* kv_full = q_empty + 1;
  uint64_t* kv_empty = kv_full + STAGES;
  const int bhn = b * h, nqt = (s + BQ - 1) / BQ;
  const int first = plan[blockIdx.x], last = plan[blockIdx.x + 1];
  const int* tiles = plan + gridDim.x + 1;
  const int tid = threadIdx.x, wg = tid >> 7;
  const int nblk = (d + 31) / 32;   // column blocks TMA loads

  zero_tiles(sm, C::BAR, C::THREADS);
  if (tid == 0) {
    mbar_init(q_full, 1);
    mbar_init(q_empty, 4 * C::NWG);   // one arrival per consumer warp
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(&kv_full[i], 1);
      mbar_init(&kv_empty[i], 4 * C::NWG);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == C::NWG) {
    // Producer: one thread.  A tile's Q and dO parts once the consumers'
    // last S and dP of the previous tile are done; the K/V ring runs on
    // across tiles over the live key tiles only.
    if constexpr (C::NWG == 2) reg_dealloc<24>();
    if (tid != C::NWG * 128) return;
    int it = 0;
    uint32_t qph = 0;
    for (int x = first; x < last; ++x) {
      const T t(tiles[x], bhn, nqt, h, g, s, sk, causal, window);
      if (t.n == 0) continue;
      mbar_wait(q_empty, qph ^ 1);
      qph ^= 1;
      mbar_arrive_tx(q_full, 4 * nblk * BQ * 128);
      for (int c = 0; c < nblk; ++c) {
        uint8_t* dst = sm + C::Q + c * BQ * 128;
        tma_load_4d(dst, &tqb, q_full, c * 32, t.hi, t.q0, t.bi);
        tma_load_4d(dst + C::Q_PART, &tqs, q_full, c * 32, t.hi, t.q0, t.bi);
        tma_load_4d(dst + 2 * C::Q_PART, &tdob, q_full, c * 32, t.hi, t.q0, t.bi);
        tma_load_4d(dst + 3 * C::Q_PART, &tdos, q_full, c * 32, t.hi, t.q0, t.bi);
      }
      for (int j = 0; j < t.n; ++j, ++it) {
        const int st = it % STAGES;
        const int k0 = (t.jt0 + j) * BK;
        uint8_t* kst = sm + C::K + st * C::STAGE;
        mbar_wait(&kv_empty[st], ((it / STAGES) & 1) ^ 1);
        mbar_arrive_tx(&kv_full[st], 4 * nblk * BK * 128 + 2 * D * 128);
        for (int c = 0; c < nblk; ++c) {
          uint8_t* dst = kst + c * BK * 128;
          tma_load_4d(dst, &tkb, &kv_full[st], c * 32, t.kvh, k0, t.bi);
          tma_load_4d(dst + C::KV_PART, &tks, &kv_full[st], c * 32, t.kvh, k0, t.bi);
          tma_load_4d(dst + 2 * C::KV_PART, &tvb, &kv_full[st], c * 32, t.kvh, k0, t.bi);
          tma_load_4d(dst + 3 * C::KV_PART, &tvs, &kv_full[st], c * 32, t.kvh, k0, t.bi);
        }
        tma_load_4d(kst + 4 * C::KV_PART, &tktb, &kv_full[st], k0, 0, t.kvh, t.bi);
        tma_load_4d(kst + 5 * C::KV_PART, &tkts, &kv_full[st], k0, 0, t.kvh, t.bi);
      }
    }
    return;
  }

  // Consumers: warpgroup w owns query rows q0 + 64w .. +63 of each tile.
  if constexpr (C::NWG == 2) reg_alloc<240>();
  const int w = wg;
  const int wtid = tid & 127, warp = wtid >> 5, lane = tid & 31;
  const int cq = (lane & 3) * 2;
  const float sl2 = scale * LOG2E;
  const uint32_t base = smem_u32(sm);
  const uint32_t qa = base + C::Q + w * 64 * 128;   // Qb; Qs, dOb, dOs one Q_PART apart
  const size_t qstride = size_t(h) * d;
  int it = 0;
  uint32_t qph = 0;

  for (int x = first; x < last; ++x) {
    const T t(tiles[x], bhn, nqt, h, g, s, sk, causal, window);
    const int qw0 = t.q0 + 64 * w;
    const int qpos0 = qw0 + warp * 16 + (lane >> 2);
    const size_t row = (size_t(t.bi) * h + t.hi) * s;
    float l2[2], dl[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qp = qpos0 + 8 * r;
      l2[r] = qp < s ? lse_log2(lse[row + qp]) : 0.f;
      dl[r] = qp < s ? delta[row + qp] : 0.f;
    }
    float dqa[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dqa[i] = 0.f;
    if (t.n > 0) {
      mbar_wait(q_full, qph);
      qph ^= 1;
      for (int j = 0; j < t.n; ++j) {
        const int cur = it + j, st = cur % STAGES;
        const int k0 = (t.jt0 + j) * BK;
        const uint32_t kst = base + C::K + st * C::STAGE;
        mbar_wait(&kv_full[st], (cur / STAGES) & 1);
        const bool dead = qw0 >= s || (causal && (k0 > qw0 + 63 ||
                                                 (window > 0 && qw0 - (k0 + BK - 1) >= window)));
        uint32_t dsb[BK / 2], dss[BK / 2];
        if (!dead) {
          const bool edge = k0 + BK > sk || qw0 + 64 > s ||
                            (causal && (k0 + BK - 1 > qw0 ||
                                        (window > 0 && qw0 + 63 - k0 >= window)));
          // S = Q K^T and dP = dO V^T: [64 rows x 32 keys] each.
          float sc[BK / 2], dp[BK / 2];
          fence_regs(sc);
          fence_regs(dp);
          wgmma_fence();
          ss3<D, BQ, BK>(sc, qa, qa + C::Q_PART, kst, kst + C::KV_PART);
          wgmma_commit();
          ss3<D, BQ, BK>(dp, qa + 2 * C::Q_PART, qa + 3 * C::Q_PART, kst + 2 * C::KV_PART,
                         kst + 3 * C::KV_PART);
          wgmma_commit();
          // P = exp2(S * scale * log2e - lse) while dP finishes.
          wgmma_wait<1>();
          fence_regs(sc);
          if (edge) {
#pragma unroll
            for (int t8 = 0; t8 < BK / 8; ++t8)
#pragma unroll
              for (int e = 0; e < 4; ++e)
                if (!visible(qpos0 + (e >> 1) * 8, k0 + t8 * 8 + cq + (e & 1), s, sk, causal,
                             window))
                  sc[4 * t8 + e] = -CUDART_INF_F;
          }
#pragma unroll
          for (int i = 0; i < BK / 2; ++i) sc[i] = exp2_fast(fmaf(sc[i], sl2, -l2[(i >> 1) & 1]));
          // dS = P * (dP - delta), as A fragments.
          wgmma_wait<0>();
          fence_regs(dp);
#pragma unroll
          for (int i = 0; i < BK / 2; ++i) dp[i] = sc[i] * (dp[i] - dl[(i >> 1) & 1]);
          to_frags(dp, dsb, dss);
        }
        __syncwarp();
        if (j + 1 == t.n && lane == 0) mbar_arrive(q_empty);   // the tile's last Q/dO read
        if (!dead) {
          // dQ += dS K (Kt: keys contiguous, permuted).
          fence_regs(dqa);
          fence_regs_u32(dsb);
          fence_regs_u32(dss);
          wgmma_fence();
          rs3<D>(dqa, dsb, dss, kst + 4 * C::KV_PART, kst + 5 * C::KV_PART);
          wgmma_commit();
          wgmma_wait<0>();
          fence_regs(dqa);
          fence_regs_u32(dsb);
          fence_regs_u32(dss);
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(&kv_empty[st]);
      }
      it += t.n;
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qpos = qpos0 + 8 * r;
      if (qpos >= s) continue;
      float* dst = dq + (size_t(t.bi) * s + qpos) * qstride + size_t(t.hi) * d + cq;
#pragma unroll
      for (int c = 0; c < D / 8; ++c)
        if (c * 8 + cq < d)
          *reinterpret_cast<float2*>(dst + c * 8) =
              make_float2(dqa[4 * c + 2 * r] * scale, dqa[4 * c + 2 * r + 1] * scale);
    }
  }
}

// ---- flash_bwd_dkv_tf32 ------------------------------------------------------

template <int D>
struct Dkv {
  static constexpr int NWG = D == 64 ? 2 : 1;     // consumer warpgroups, 64 keys each
  static constexpr int BK = 64 * NWG;             // keys of an item
  static constexpr int BQ = TILE;                 // queries of a tile
  static constexpr int NSLOT = D == 64 ? 3 : 1;   // ring slots
  static constexpr int THREADS = 128 * (NWG + 1);
  static constexpr int KV_PART = BK * D * 4;      // one of Kb, Ks, Vb, Vs
  // A slot holds one load of a tile: Qb Qs dOb dOs [32][D] (column blocks
  // of [32][32]), or Qtb Qts dOtb dOts [D][32]; either is 4 parts of PART.
  static constexpr int PART = BQ * D * 4;
  static constexpr int SLOT = 4 * PART;
  static constexpr int K = 0;                     // Kb, Ks, Vb, Vs
  static constexpr int RING = 4 * KV_PART;
  static constexpr int BAR = RING + NSLOT * SLOT;
  // full[NSLOT], empty[NSLOT], kv_full, kv_empty
  static constexpr int BYTES = BAR + (2 * NSLOT + 2) * 8;
  static constexpr int ALLOC = BYTES + 1024;
  static_assert(ALLOC <= 232448, "shared memory");
};

template <int D>
__global__ void __launch_bounds__(Dkv<D>::THREADS, 1)
flash_bwd_dkv_tf32_kernel(const __grid_constant__ CUtensorMap tqb,
                          const __grid_constant__ CUtensorMap tqs,
                          const __grid_constant__ CUtensorMap tdob,
                          const __grid_constant__ CUtensorMap tdos,
                          const __grid_constant__ CUtensorMap tkb,
                          const __grid_constant__ CUtensorMap tks,
                          const __grid_constant__ CUtensorMap tvb,
                          const __grid_constant__ CUtensorMap tvs,
                          const __grid_constant__ CUtensorMap tqtb,
                          const __grid_constant__ CUtensorMap tqts,
                          const __grid_constant__ CUtensorMap tdotb,
                          const __grid_constant__ CUtensorMap tdots,
                          const float* __restrict__ lse, const float* __restrict__ delta,
                          const int* __restrict__ items, const int* __restrict__ offsets,
                          float* __restrict__ partial, float* __restrict__ dk,
                          float* __restrict__ dv, int s, int sk, int h, int g, int d,
                          float scale, int causal, int window) {
  typedef Dkv<D> C;
  constexpr int NSLOT = C::NSLOT, BQ = C::BQ;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + C::BAR);
  uint64_t* empty = full + NSLOT;
  uint64_t* kv_full = empty + NSLOT;
  uint64_t* kv_empty = kv_full + 1;
  const int tid = threadIdx.x, wg = tid >> 7;
  const int first = offsets[blockIdx.x], last = offsets[blockIdx.x + 1];
  const int r = h / g;
  const int nblk = (d + 31) / 32;   // column blocks TMA loads

  zero_tiles(sm, C::BAR, C::THREADS);
  if (tid == 0) {
    for (int i = 0; i < NSLOT; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], 4 * C::NWG);   // one arrival per consumer warp
    }
    mbar_init(kv_full, 1);
    mbar_init(kv_empty, 4 * C::NWG);
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == C::NWG) {
    // Producer: one thread.  Per item the K/V tile once its slot is free,
    // then each (query head, query tile) of the item's range as two loads
    // (as stored, then transposed) into the next slots of the ring.
    if constexpr (C::NWG == 2) reg_dealloc<24>();
    if (tid != C::NWG * 128) return;
    int n = 0;   // tiles issued
    for (int i = first; i < last; ++i) {
      const int* it = items + ITEM_INTS * i;
      const int bi = it[0], kvh = it[1], kt = it[2], jq0 = it[3], ntile = it[4];
      mbar_wait(kv_empty, ((i - first) & 1) ^ 1);
      mbar_arrive_tx(kv_full, 4 * nblk * C::BK * 128);
      for (int c = 0; c < nblk; ++c) {
        uint8_t* dst = sm + C::K + c * C::BK * 128;
        tma_load_4d(dst, &tkb, kv_full, c * 32, kvh, kt * C::BK, bi);
        tma_load_4d(dst + C::KV_PART, &tks, kv_full, c * 32, kvh, kt * C::BK, bi);
        tma_load_4d(dst + 2 * C::KV_PART, &tvb, kv_full, c * 32, kvh, kt * C::BK, bi);
        tma_load_4d(dst + 3 * C::KV_PART, &tvs, kv_full, c * 32, kvh, kt * C::BK, bi);
      }
      for (int t = it[5]; t < it[6]; ++t, ++n) {
        const int hh = kvh * r + t / ntile, q0 = (jq0 + t % ntile) * BQ;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int ld = 2 * n + half, slot = ld % NSLOT;
          uint8_t* dst = sm + C::RING + slot * C::SLOT;
          mbar_wait(&empty[slot], ((ld / NSLOT) & 1) ^ 1);
          if (half == 0) {
            mbar_arrive_tx(&full[slot], 4 * nblk * BQ * 128);
            for (int c = 0; c < nblk; ++c) {
              uint8_t* cb = dst + c * BQ * 128;
              tma_load_4d(cb, &tqb, &full[slot], c * 32, hh, q0, bi);
              tma_load_4d(cb + C::PART, &tqs, &full[slot], c * 32, hh, q0, bi);
              tma_load_4d(cb + 2 * C::PART, &tdob, &full[slot], c * 32, hh, q0, bi);
              tma_load_4d(cb + 3 * C::PART, &tdos, &full[slot], c * 32, hh, q0, bi);
            }
          } else {
            mbar_arrive_tx(&full[slot], C::SLOT);
            tma_load_4d(dst, &tqtb, &full[slot], q0, 0, hh, bi);
            tma_load_4d(dst + C::PART, &tqts, &full[slot], q0, 0, hh, bi);
            tma_load_4d(dst + 2 * C::PART, &tdotb, &full[slot], q0, 0, hh, bi);
            tma_load_4d(dst + 3 * C::PART, &tdots, &full[slot], q0, 0, hh, bi);
          }
        }
      }
    }
    return;
  }

  // Consumers: warpgroup w owns keys k0 + 64w .. +63 of each item (the M
  // side); both read every tile of the item.
  if constexpr (C::NWG == 2) reg_alloc<240>();
  const int w = wg;
  const int wtid = tid & 127, warp = wtid >> 5, lane = tid & 31;
  const int cq = (lane & 3) * 2;
  const float sl2 = scale * LOG2E;
  const uint32_t base = smem_u32(sm);
  const uint32_t ka = base + C::K + w * 64 * 128;   // Kb; Ks, Vb, Vs one KV_PART apart
  int n = 0;
  for (int i = first; i < last; ++i) {
    const int* it = items + ITEM_INTS * i;
    const int bi = it[0], kvh = it[1], kt = it[2], jq0 = it[3], ntile = it[4];
    const int slot_out = it[7];
    const int kw0 = kt * C::BK + 64 * w;
    const int kpos0 = kw0 + warp * 16 + (lane >> 2), kpos1 = kpos0 + 8;
    float dka[D / 2], dva[D / 2];
#pragma unroll
    for (int e = 0; e < D / 2; ++e) dka[e] = dva[e] = 0.f;
    mbar_wait(kv_full, (i - first) & 1);

    for (int t = it[5]; t < it[6]; ++t, ++n) {
      const int hh = kvh * r + t / ntile, q0 = (jq0 + t % ntile) * BQ;
      const int ld = 2 * n, s0 = ld % NSLOT, s1 = (ld + 1) % NSLOT;
      // A tile none of this warpgroup's keys is attended by still waits
      // for its loads before releasing them, so that no arrival runs ahead
      // of the slot's fill.
      const bool dead = kw0 >= sk || (causal && (q0 + BQ - 1 < kw0 ||
                                                 (window > 0 && q0 - (kw0 + 63) >= window)));
      const uint32_t rm = base + C::RING + s0 * C::SLOT;   // Qb Qs dOb dOs
      const uint32_t tr = base + C::RING + s1 * C::SLOT;   // Qtb Qts dOtb dOts
      uint32_t pb[BQ / 2], ps[BQ / 2], dsb[BQ / 2], dss[BQ / 2];
      if (!dead) {
        // This thread's query columns: q0 + 8 t8 + cq (+1), lse in log2
        // units and delta, read while the tile arrives.
        const size_t row = (size_t(bi) * h + hh) * s;
        float l2[BQ / 4], dl[BQ / 4];
#pragma unroll
        for (int e = 0; e < BQ / 4; ++e) {
          const int qp = q0 + (e >> 1) * 8 + cq + (e & 1);
          l2[e] = qp < s ? lse_log2(lse[row + qp]) : 0.f;
          dl[e] = qp < s ? delta[row + qp] : 0.f;
        }
        const bool edge = q0 + BQ > s || kw0 + 64 > sk ||
                          (causal && (kw0 + 63 > q0 ||
                                      (window > 0 && q0 + BQ - 1 - kw0 >= window)));
        // S^T = K Q^T and dP^T = V dO^T: [64 keys x 32 queries] each.
        float st[BQ / 2], dpt[BQ / 2];
        mbar_wait(&full[s0], (ld / NSLOT) & 1);
        fence_regs(st);
        fence_regs(dpt);
        wgmma_fence();
        ss3<D, C::BK, BQ>(st, ka, ka + C::KV_PART, rm, rm + C::PART);
        wgmma_commit();
        ss3<D, C::BK, BQ>(dpt, ka + 2 * C::KV_PART, ka + 3 * C::KV_PART, rm + 2 * C::PART,
                          rm + 3 * C::PART);
        wgmma_commit();
        // P^T = exp2(S^T * scale * log2e - lse[q]) while dP^T finishes.
        wgmma_wait<1>();
        fence_regs(st);
        if (edge) {
#pragma unroll
          for (int t8 = 0; t8 < BQ / 8; ++t8)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              if (!visible(q0 + t8 * 8 + cq + (e & 1), e < 2 ? kpos0 : kpos1, s, sk, causal,
                           window))
                st[4 * t8 + e] = -CUDART_INF_F;
        }
#pragma unroll
        for (int e = 0; e < BQ / 2; ++e)
          st[e] = exp2_fast(fmaf(st[e], sl2, -l2[(e >> 2) * 2 + (e & 1)]));
        // dS^T = P^T * (dP^T - delta[q]); both as A fragments.
        wgmma_wait<0>();
        fence_regs(dpt);
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[s0]);
#pragma unroll
        for (int e = 0; e < BQ / 2; ++e) dpt[e] = st[e] * (dpt[e] - dl[(e >> 2) * 2 + (e & 1)]);
        to_frags(st, pb, ps);
        to_frags(dpt, dsb, dss);
      } else {
        mbar_wait(&full[s0], (ld / NSLOT) & 1);
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[s0]);
      }

      mbar_wait(&full[s1], ((ld + 1) / NSLOT) & 1);
      if (!dead) {
        // dV += P^T dO and dK += dS^T Q (dOt, Qt: queries contiguous, permuted).
        fence_regs(dva);
        fence_regs(dka);
        fence_regs_u32(pb);
        fence_regs_u32(ps);
        fence_regs_u32(dsb);
        fence_regs_u32(dss);
        wgmma_fence();
        rs3<D>(dva, pb, ps, tr + 2 * C::PART, tr + 3 * C::PART);
        rs3<D>(dka, dsb, dss, tr, tr + C::PART);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(dva);
        fence_regs(dka);
        fence_regs_u32(pb);
        fence_regs_u32(ps);
        fence_regs_u32(dsb);
        fence_regs_u32(dss);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s1]);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(kv_empty);

    if (slot_out < 0) {
      const size_t kstride = size_t(g) * d;
      const size_t col = size_t(kvh) * d + cq;
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int kpos = rr ? kpos1 : kpos0;
        if (kpos >= sk) continue;
        const size_t off = (size_t(bi) * sk + kpos) * kstride + col;
#pragma unroll
        for (int c = 0; c < D / 8; ++c)
          if (c * 8 + cq < d) {
            *reinterpret_cast<float2*>(dk + off + c * 8) =
                make_float2(dka[4 * c + 2 * rr] * scale, dka[4 * c + 2 * rr + 1] * scale);
            *reinterpret_cast<float2*>(dv + off + c * 8) =
                make_float2(dva[4 * c + 2 * rr], dva[4 * c + 2 * rr + 1]);
          }
      }
    } else {
      // Slot layout: [2 (dK, dV)][D/8 float4 columns][consumer threads].
      constexpr int CT = 128 * C::NWG;
      float4* pp = reinterpret_cast<float4*>(partial + size_t(slot_out) * 2 * C::BK * D);
#pragma unroll
      for (int c = 0; c < D / 8; ++c) {
        pp[c * CT + tid] = make_float4(dka[4 * c], dka[4 * c + 1], dka[4 * c + 2], dka[4 * c + 3]);
        pp[(D / 8 + c) * CT + tid] =
            make_float4(dva[4 * c], dva[4 * c + 1], dva[4 * c + 2], dva[4 * c + 3]);
      }
    }
  }
}

// One block per (batch, kv head, key tile) and float4 column j of the slot
// layout (j < D/8: dK columns 8j .. 8j+7 of the thread's two rows, else
// dV's): adds the tile's `count` slots from `first` in slot order (count
// 0: no query attends the tile, write zeros; count < 0: an item wrote
// it).  Threads map to rows as the consumers' accumulators do.
template <int D>
__global__ void __launch_bounds__(128 * Dkv<D>::NWG)
flash_bwd_dkv_tf32_sum_kernel(const float* __restrict__ partial, const int* __restrict__ combos,
                              float* __restrict__ dk, float* __restrict__ dv, int sk, int g, int d,
                              int nkt, float scale) {
  const int c = blockIdx.x, j = blockIdx.y, first = combos[2 * c], count = combos[2 * c + 1];
  if (count < 0) return;
  constexpr int CT = 128 * Dkv<D>::NWG;
  const int tid = threadIdx.x;
  float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int n = 0; n < count; ++n) {
    const float4 x = reinterpret_cast<const float4*>(
        partial + size_t(first + n) * 2 * Dkv<D>::BK * D)[j * CT + tid];
    a.x += x.x;
    a.y += x.y;
    a.z += x.z;
    a.w += x.w;
  }
  const bool is_v = j >= D / 8;
  float* out = is_v ? dv : dk;
  const float f = is_v ? 1.f : scale;
  const int kt = c % nkt, kvh = (c / nkt) % g, bi = c / nkt / g;
  const int w = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int kpos0 = kt * Dkv<D>::BK + 64 * w + warp * 16 + (lane >> 2), kpos1 = kpos0 + 8;
  const int colw = (is_v ? j - D / 8 : j) * 8 + (lane & 3) * 2;
  if (colw >= d) return;
  const size_t kstride = size_t(g) * d;
  const size_t col = size_t(kvh) * d + colw;
  if (kpos0 < sk)
    *reinterpret_cast<float2*>(out + (size_t(bi) * sk + kpos0) * kstride + col) =
        make_float2(a.x * f, a.y * f);
  if (kpos1 < sk)
    *reinterpret_cast<float2*>(out + (size_t(bi) * sk + kpos1) * kstride + col) =
        make_float2(a.z * f, a.w * f);
}

// ---- host ------------------------------------------------------------------

const CUtensorMapDataType F32 = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;

// A [b, n, heads, d] part read in boxes of 32 columns x `rows` positions.
int map_rows(CUtensorMap* m, const float* p, int b, int n, int heads, int d, int rows) {
  const int dims[4] = {d, heads, n, b}, box[4] = {32, 1, rows, 1};
  return make_map_box(m, p, F32, 4, dims, box);
}

// A [b, heads, d, np] transposed part read in boxes of 32 positions x D rows.
int map_t(CUtensorMap* m, const float* p, int b, int np, int heads, int d, int D) {
  const int dims[4] = {np, d, heads, b}, box[4] = {32, D, 1, 1};
  return make_map_box(m, p, F32, 4, dims, box);
}

// The shared-memory attribute once per device and kernel (a call captured
// into a CUDA graph then makes no attribute call).
template <typename K>
int set_smem(K kernel, int bytes, unsigned* done) {
  int dev = 0;
  cudaError_t ce = cudaGetDevice(&dev);
  if (ce != cudaSuccess) return int(ce);
  if (dev < 32 && (*done >> dev & 1u)) return 0;
  ce = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (ce != cudaSuccess) return int(ce);
  if (dev < 32) *done |= 1u << dev;
  return 0;
}

template <int D>
int launch_dq(const Split& x, const float* lse, const float* delta, float* dq, const int* plan,
              int nblocks, int b, int s, int sk, int h, int g, int d, float scale, int causal,
              int window, cudaStream_t stream) {
  typedef Dq<D> C;
  const int skp = round_up(sk, TILE);
  CUtensorMap m[10];
  int e;
  if ((e = map_rows(&m[0], x.qb, b, s, h, d, C::BQ)) ||
      (e = map_rows(&m[1], x.qs, b, s, h, d, C::BQ)) ||
      (e = map_rows(&m[2], x.dob, b, s, h, d, C::BQ)) ||
      (e = map_rows(&m[3], x.dos, b, s, h, d, C::BQ)) ||
      (e = map_rows(&m[4], x.kb, b, sk, g, d, C::BK)) ||
      (e = map_rows(&m[5], x.ks, b, sk, g, d, C::BK)) ||
      (e = map_rows(&m[6], x.vb, b, sk, g, d, C::BK)) ||
      (e = map_rows(&m[7], x.vs, b, sk, g, d, C::BK)) ||
      (e = map_t(&m[8], x.ktb, b, skp, g, d, D)) || (e = map_t(&m[9], x.kts, b, skp, g, d, D)))
    return e;
  static unsigned attr_set = 0;
  if ((e = set_smem(flash_bwd_dq_tf32_kernel<D>, C::ALLOC, &attr_set))) return e;
  flash_bwd_dq_tf32_kernel<D><<<nblocks, C::THREADS, C::ALLOC, stream>>>(
      m[0], m[1], m[2], m[3], m[4], m[5], m[6], m[7], m[8], m[9], lse, delta, plan, dq, b, s, sk,
      h, g, d, scale, causal, window);
  return int(cudaGetLastError());
}

template <int D>
int launch_dkv(const Split& x, const float* lse, const float* delta, float* dk, float* dv,
               const int* items, const int* offsets, const int* combos, float* partial,
               int nblocks, int b, int s, int sk, int h, int g, int d, float scale, int causal,
               int window, cudaStream_t stream) {
  typedef Dkv<D> C;
  if (nblocks > 0) {
    const int sp = round_up(s, TILE);
    CUtensorMap m[12];
    int e;
    if ((e = map_rows(&m[0], x.qb, b, s, h, d, C::BQ)) ||
        (e = map_rows(&m[1], x.qs, b, s, h, d, C::BQ)) ||
        (e = map_rows(&m[2], x.dob, b, s, h, d, C::BQ)) ||
        (e = map_rows(&m[3], x.dos, b, s, h, d, C::BQ)) ||
        (e = map_rows(&m[4], x.kb, b, sk, g, d, C::BK)) ||
        (e = map_rows(&m[5], x.ks, b, sk, g, d, C::BK)) ||
        (e = map_rows(&m[6], x.vb, b, sk, g, d, C::BK)) ||
        (e = map_rows(&m[7], x.vs, b, sk, g, d, C::BK)) ||
        (e = map_t(&m[8], x.qtb, b, sp, h, d, D)) || (e = map_t(&m[9], x.qts, b, sp, h, d, D)) ||
        (e = map_t(&m[10], x.dotb, b, sp, h, d, D)) ||
        (e = map_t(&m[11], x.dots, b, sp, h, d, D)))
      return e;
    static unsigned attr_set = 0;
    if ((e = set_smem(flash_bwd_dkv_tf32_kernel<D>, C::ALLOC, &attr_set))) return e;
    flash_bwd_dkv_tf32_kernel<D><<<nblocks, C::THREADS, C::ALLOC, stream>>>(
        m[0], m[1], m[2], m[3], m[4], m[5], m[6], m[7], m[8], m[9], m[10], m[11], lse, delta,
        items, offsets, partial, dk, dv, s, sk, h, g, d, scale, causal, window);
    const cudaError_t ce = cudaGetLastError();
    if (ce != cudaSuccess) return int(ce);
  }
  const int nkt = (sk + C::BK - 1) / C::BK;
  flash_bwd_dkv_tf32_sum_kernel<D><<<dim3(b * g * nkt, D / 4), 128 * C::NWG, 0, stream>>>(
      partial, combos, dk, dv, sk, g, d, nkt, scale);
  return int(cudaGetLastError());
}

bool dims_ok(int b, int s, int sk, int h, int g, int d) {
  return b > 0 && s > 0 && sk > 0 && g > 0 && h % g == 0 && d > 0 && d % 4 == 0 && d <= 128;
}

}  // namespace

// q, dout [b, s, h, d]; k, v [b, sk, g, d] f32 contiguous.  Writes the
// big/small parts of all four and the permuted transposes of q, dout and
// k into `split` (f32, 16-byte aligned; ops/flash_attention.py
// tf32_bwd_split_shapes gives its parts and size).  Returns 0 or a
// cudaError_t.
extern "C" int tgt_flash_bwd_tf32_split(const void* q, const void* k, const void* v,
                                        const void* dout, void* split, int b, int s, int sk,
                                        int h, int g, int d, void* stream) {
  if (!dims_ok(b, s, sk, h, g, d)) return int(cudaErrorInvalidValue);
  const Split x = split_layout(static_cast<float*>(split), b, s, sk, h, g, d);
  const int np = round_up(s > sk ? s : sk, TILE);
  tf32_bwd_split_kernel<<<dim3(np / TILE, b * h, 4), SPLIT_THREADS, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(dout), x, b, s, sk, h, g, d);
  return int(cudaGetLastError());
}

// dq [b, s, h, d] f32 = dS K * scale from the prologue's `split`, lse
// (natural log, as flash_fwd_tf32 writes it) and delta = rowsum(dO * O),
// both [b*h, s] f32.  `plan` int32: ops/flash_attention.py fwd_schedule's
// work list at TF32_DQ_TILES (Dq's BQ, BK), nblocks + 1 offsets then the
// tiles.  window <= 0 means none.  Returns 0 or a cudaError_t.
extern "C" int tgt_flash_bwd_dq_tf32(void* split, const void* lse, const void* delta, void* dq,
                                     const void* plan, int nblocks, int b, int s, int sk, int h,
                                     int g, int d, float scale, int causal, int window,
                                     void* stream) {
  if (!dims_ok(b, s, sk, h, g, d) || nblocks <= 0) return int(cudaErrorInvalidValue);
  const Split x = split_layout(static_cast<float*>(split), b, s, sk, h, g, d);
  const float *fl = static_cast<const float*>(lse), *fd = static_cast<const float*>(delta);
  float* fq = static_cast<float*>(dq);
  const int* pl = static_cast<const int*>(plan);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (d <= 64)
    return launch_dq<64>(x, fl, fd, fq, pl, nblocks, b, s, sk, h, g, d, scale, causal, window,
                         st);
  return launch_dq<128>(x, fl, fd, fq, pl, nblocks, b, s, sk, h, g, d, scale, causal, window,
                        st);
}

// dk = dS^T Q * scale and dv = P^T dO, summed over the h/g query heads of
// each kv head, [b, sk, g, d] f32, every row written (zeros where no
// query attends), from the same inputs as tgt_flash_bwd_dq_tf32.  The work
// list comes from ops/flash_attention.py dkv_schedule at TF32_DKV_TILES
// (Dkv's BK keys, 32 queries): `items` int32 [n, 8], `offsets` int32
// [nblocks + 1],
// `combos` int32 [b * g * nkt, 2] (first slot and slot count of each key
// tile, -1 when an item writes it), `partial` f32 [slots, 16384] (2 *
// keys * D: 128 keys at D = 64 for d <= 64, 64 at D = 128).  Returns 0 or
// a cudaError_t.
extern "C" int tgt_flash_bwd_dkv_tf32(void* split, const void* lse, const void* delta, void* dk,
                                      void* dv, const void* items, const void* offsets,
                                      const void* combos, void* partial, int nblocks, int b,
                                      int s, int sk, int h, int g, int d, float scale, int causal,
                                      int window, void* stream) {
  if (!dims_ok(b, s, sk, h, g, d) || nblocks < 0) return int(cudaErrorInvalidValue);
  const Split x = split_layout(static_cast<float*>(split), b, s, sk, h, g, d);
  const float *fl = static_cast<const float*>(lse), *fd = static_cast<const float*>(delta);
  float *fk = static_cast<float*>(dk), *fv = static_cast<float*>(dv);
  const int *it = static_cast<const int*>(items), *of = static_cast<const int*>(offsets),
            *co = static_cast<const int*>(combos);
  float* pp = static_cast<float*>(partial);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (d <= 64)
    return launch_dkv<64>(x, fl, fd, fk, fv, it, of, co, pp, nblocks, b, s, sk, h, g, d, scale,
                          causal, window, st);
  return launch_dkv<128>(x, fl, fd, fk, fv, it, of, co, pp, nblocks, b, s, sk, h, g, d, scale,
                         causal, window, st);
}

// Dynamic shared memory of one block at head dim d.
extern "C" int tgt_flash_bwd_dq_tf32_smem_bytes(int d) {
  return d <= 64 ? Dq<64>::ALLOC : Dq<128>::ALLOC;
}

extern "C" int tgt_flash_bwd_dkv_tf32_smem_bytes(int d) {
  return d <= 64 ? Dkv<64>::ALLOC : Dkv<128>::ALLOC;
}
