// Float32 flash attention forward for Hopper (sm_90a) on the tensor cores,
// at float32 accuracy (3xTF32): causal / windowed / unmasked GQA, online
// softmax, writes O and the per-row natural-log logsumexp exactly as
// flash_simt.cu's fwd_f32_kernel does (its dQ and dK/dV kernels read it).
//
// Replaces: torchgpipe_tpu/ops/flash_attention.py:_fwd_kernel (and
// :_fwd_stream_kernel) at float32: the Pallas kernels take float32
// operands (`.astype(jnp.float32)`), which flash_fwd.cu's bf16 wgmma does
// not.  fwd_f32_kernel (CUDA-core FMAs) stays for head dims TMA cannot
// map (d % 4 != 0).
//
// Bound on the H100: operations.  Causal attention over s tokens does
// about 4 * b * h * d * s^2 / 2 FLOPs.  On the CUDA cores that is 67
// TFLOP/s of f32 FMA; one TF32 product would run at 495 TFLOP/s but moves
// each product by ~2^-11 relative.  3xTF32 (hopper_tiles.cuh) keeps ~22
// bits a product at three TF32 products each: ~165 TFLOP/s of
// float32-accurate products.  The design is flash_fwd.cu's, at float32:
//
// * A small prologue (tf32_split_kernel) writes, once a call, K's big and
//   small parts [b, sk, g, d] and V transposed, big and small [b, g, d,
//   skp] (skp: sk rounded up to 64, zeros past sk).  tf32 wgmma reads A
//   and B K-major only, so O = P V needs V with keys contiguous.  Inside
//   each aligned group of 8 keys Vt holds keys 0 2 4 6 1 3 5 7: that is
//   the order in which a thread's S accumulator registers (columns 2c,
//   2c+1 of each 8) fall into the k positions (c, c+4) of an A fragment,
//   so P feeds O = P V from registers with no shuffle.  The extra bytes
//   (~3x K and V) are small beside the products.
// * A persistent grid (one block per SM) walks the (batch*head, query
//   tile) work list of ops/flash_attention.py fwd_schedule, longest first.
//   One producer warp issues TMA loads of each Q tile and of K (big,
//   small) and Vt (big, small) tiles into a two-stage ring, each on its
//   own mbarrier, K and V released separately.  Consumer warpgroups own
//   64 query rows each: two at d <= 64 (128-row tiles, 64-key tiles),
//   one at d <= 128 (64 rows, 32 keys), so the float32 tiles with their
//   small parts fit 227 KB with two stages.
// * Q's parts are made in shared memory by its consumer warpgroup when
//   the tile arrives (in place: Q's big part, and a small-part copy).
//   S = Qs Kb + Qb Ks + Qb Kb is three wgmma chains from shared memory;
//   the online softmax runs on the accumulator registers in float32; P is
//   split in registers and O += Ps Vb + Pb Vs + Pb Vb runs with P as the
//   register A operand.  PV of tile j and S of tile j+1 are issued
//   together, then waited on.
// * Head dims: template 64 (d <= 64) and 128 (d <= 128), any d % 4 == 0
//   (TMA needs 16-byte row strides).  Columns past d of a loaded 32-float
//   block arrive as zeros; blocks wholly past d are never loaded and are
//   zeroed once at the start, so they add nothing to S and give zero O
//   columns, which are not stored.
// Causal tiles above the diagonal and, with a window, tiles below the band
// are never loaded; element masks run only on tiles that straddle an edge
// (the `visible` rule of flash_simt.cu).  A masked score is -inf; a row
// with every key masked so far keeps m = -inf and takes its exponents
// relative to 0.

#include <math_constants.h>

#include "hopper_tiles.cuh"

namespace {

using namespace hopper;

constexpr int STAGES = 2;
constexpr int KEY_PAD = 64;          // Vt's key axis is padded to this
constexpr int SPLIT_KEYS = 32;       // keys per prologue block
constexpr int SPLIT_THREADS = 256;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// Tiles and shared-memory layout at template head dim D (offsets from a
// 1024-byte boundary).  Every tile is stored as 128-byte column blocks
// (32 floats): Q [BQ][D] and K [BK][D] as D/32 blocks of [rows][32], Vt
// [D][BK] as BK/32 blocks of [D][32].
template <int D>
struct Cfg {
  static constexpr int NWG = D == 64 ? 2 : 1;   // consumer warpgroups
  static constexpr int BQ = 64 * NWG;           // query rows of a tile
  static constexpr int BK = D == 64 ? 64 : 32;  // keys of a K/V tile
  static constexpr int THREADS = 128 * (NWG + 1);
  static constexpr int NB = D / 32;             // column blocks of a Q/K row
  static constexpr int Q_TILE = BQ * D * 4;
  static constexpr int K_TILE = BK * D * 4;     // one part (big or small)
  static constexpr int V_TILE = D * BK * 4;
  static constexpr int Q = 0;                   // Q's big part (in place)
  static constexpr int QS = Q_TILE;             // Q's small part
  static constexpr int K = 2 * Q_TILE;          // [stage][big, small]
  static constexpr int V = K + STAGES * 2 * K_TILE;
  static constexpr int BAR = V + STAGES * 2 * V_TILE;
  // q_full, q_empty, k_full[S], v_full[S], k_empty[S], v_empty[S]
  static constexpr int BYTES = BAR + (2 + 4 * STAGES) * 8;
  static constexpr int ALLOC = BYTES + 1024;   // room to align the base
  static_assert(ALLOC <= 232448, "shared memory");
  static_assert(BQ * 128 % 1024 == 0 && BK * 128 % 1024 == 0, "block alignment");
};

// The key at position p of Vt's key axis: in each aligned group of 8,
// positions 0..7 hold keys 0 2 4 6 1 3 5 7.
__device__ __forceinline__ int permuted_key(int p) {
  const int j = p & 7;
  return (p & ~7) + (j < 4 ? 2 * j : 2 * j - 7);
}

// K [b, sk, g, d] -> kb, ks (same layout); V [b, sk, g, d] -> vtb, vts
// [b, g, d, skp], keys permuted in groups of 8, zeros past sk.  Grid
// (skp / 32, b * g).
__global__ void __launch_bounds__(SPLIT_THREADS) tf32_split_kernel(
    const float* __restrict__ k, const float* __restrict__ v, float* __restrict__ kb,
    float* __restrict__ ks, float* __restrict__ vtb, float* __restrict__ vts, int sk, int skp,
    int g, int d) {
  __shared__ float tile[SPLIT_KEYS][128 + 1];
  const int bi = blockIdx.y / g, kvh = blockIdx.y % g;
  const int k0 = blockIdx.x * SPLIT_KEYS;
  for (int i = threadIdx.x; i < SPLIT_KEYS * d; i += SPLIT_THREADS) {
    const int kk = i / d, dd = i - kk * d, key = k0 + kk;
    float x = 0.f;
    if (key < sk) {
      const size_t off = ((size_t(bi) * sk + key) * g + kvh) * d + dd;
      const float y = k[off];
      kb[off] = __uint_as_float(tf32_big(y));
      ks[off] = __uint_as_float(tf32_small(y));
      x = v[off];
    }
    tile[kk][dd] = x;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < d * SPLIT_KEYS; i += SPLIT_THREADS) {
    const int dd = i / SPLIT_KEYS, p = i % SPLIT_KEYS;
    const float x = tile[permuted_key(p)][dd];
    const size_t off = ((size_t(bi) * g + kvh) * d + dd) * skp + k0 + p;
    vtb[off] = __uint_as_float(tf32_big(x));
    vts[off] = __uint_as_float(tf32_small(x));
  }
}

// S = Qs Kb + Qb Ks + Qb Kb for one warpgroup (64 rows of Q at qa / qsa,
// a K tile's parts at kb / ks), committed as one group.
template <int D, int BQ, int BK>
__device__ __forceinline__ void s_product(float (&sacc)[BK / 2], uint32_t qa, uint32_t qsa,
                                          uint32_t kb, uint32_t ks) {
#pragma unroll
  for (int part = 0; part < 3; ++part) {
    const uint32_t a = part == 0 ? qsa : qa, b = part == 1 ? ks : kb;
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk) {
      const uint32_t off = (kk % 4) * 32u;   // k8 step inside a 32-float block
      wgmma_tf32_ss<BK>(sacc, desc_k(a + (kk / 4) * BQ * 128 + off),
                        desc_k(b + (kk / 4) * BK * 128 + off), part > 0 || kk > 0);
    }
  }
  wgmma_commit();
}

// O += Ps Vb + Pb Vs + Pb Vb for Vt tiles at vb / vs; P's k8 step t as
// A fragments pb/ps[4t .. 4t+3].  Committed as one group.
template <int D, int BK>
__device__ __forceinline__ void pv_product(float (&o)[D / 2], const uint32_t (&pb)[BK / 2],
                                           const uint32_t (&ps)[BK / 2], uint32_t vb,
                                           uint32_t vs) {
#pragma unroll
  for (int kk = 0; kk < BK / 8; ++kk) {
    const uint32_t off = (kk / 4) * D * 128 + (kk % 4) * 32u;
    wgmma_tf32_rs<D>(o, ps[4 * kk], ps[4 * kk + 1], ps[4 * kk + 2], ps[4 * kk + 3],
                     desc_k(vb + off), 1);
    wgmma_tf32_rs<D>(o, pb[4 * kk], pb[4 * kk + 1], pb[4 * kk + 2], pb[4 * kk + 3],
                     desc_k(vs + off), 1);
    wgmma_tf32_rs<D>(o, pb[4 * kk], pb[4 * kk + 1], pb[4 * kk + 2], pb[4 * kk + 3],
                     desc_k(vb + off), 1);
  }
  wgmma_commit();
}

template <int D>
__global__ void __launch_bounds__(Cfg<D>::THREADS, 1)
flash_fwd_tf32_kernel(const __grid_constant__ CUtensorMap tq,
                      const __grid_constant__ CUtensorMap tkb,
                      const __grid_constant__ CUtensorMap tks,
                      const __grid_constant__ CUtensorMap tvb,
                      const __grid_constant__ CUtensorMap tvs, float* __restrict__ o,
                      float* __restrict__ lse, const int* __restrict__ plan, int b, int s,
                      int sk, int h, int g, int d, float scale, int causal, int window) {
  typedef Cfg<D> C;
  constexpr int BQ = C::BQ, BK = C::BK;
  typedef QueryTile<BQ, BK> T;   // n = 0: no key visible (a window ends before sk)
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = align1024(smem_raw);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(sm + C::BAR);
  uint64_t* q_empty = q_full + 1;
  uint64_t* k_full = q_empty + 1;
  uint64_t* v_full = k_full + STAGES;
  uint64_t* k_empty = v_full + STAGES;
  uint64_t* v_empty = k_empty + STAGES;
  const int bhn = b * h, nqt = (s + BQ - 1) / BQ;
  const int first = plan[blockIdx.x], last = plan[blockIdx.x + 1];
  const int* tiles = plan + gridDim.x + 1;
  const int tid = threadIdx.x, wg = tid >> 7;
  const int nblk = (d + 31) / 32;   // column blocks TMA loads

  if (tid == 0) {
    mbar_init(q_full, 1);
    mbar_init(q_empty, 4 * C::NWG);   // one arrival per consumer warp
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(&k_full[i], 1);
      mbar_init(&v_full[i], 1);
      mbar_init(&k_empty[i], 4 * C::NWG);
      mbar_init(&v_empty[i], 4 * C::NWG);
    }
    mbar_fence_init();
  }
  // Column blocks wholly past d are never loaded: zero them once (Q's
  // parts and every K stage's parts) so they add nothing to S.
  for (int c = nblk; c < C::NB; ++c) {
    float4* q4 = reinterpret_cast<float4*>(sm + C::Q + c * BQ * 128);
    float4* qs4 = reinterpret_cast<float4*>(sm + C::QS + c * BQ * 128);
    for (int i = tid; i < BQ * 8; i += C::THREADS) q4[i] = qs4[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int part = 0; part < 2 * STAGES; ++part) {
      float4* k4 = reinterpret_cast<float4*>(sm + C::K + part * C::K_TILE + c * BK * 128);
      for (int i = tid; i < BK * 8; i += C::THREADS) k4[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
  fence_proxy_async();
  __syncthreads();

  if (wg == C::NWG) {
    // Producer: one thread issues every copy.  The Q tile is reloaded once
    // the consumers' last S product of the previous tile is done, and the
    // K/V ring runs on across tiles (`it` counts the tiles it has held).
    if constexpr (C::NWG == 2) reg_dealloc<24>();
    if (tid != C::NWG * 128) return;
    int it = 0;
    uint32_t qph = 0;
    for (int x = first; x < last; ++x) {
      const T t(tiles[x], bhn, nqt, h, g, s, sk, causal, window);
      if (t.n == 0) continue;
      mbar_wait(q_empty, qph ^ 1);
      qph ^= 1;
      mbar_arrive_tx(q_full, nblk * BQ * 128);
      for (int c = 0; c < nblk; ++c)
        tma_load_4d(sm + C::Q + c * BQ * 128, &tq, q_full, c * 32, t.hi, t.q0, t.bi);
      for (int j = 0; j < t.n; ++j, ++it) {
        const int st = it % STAGES;
        const uint32_t ph = (it / STAGES) & 1;
        const int k0 = (t.jt0 + j) * BK;
        uint8_t* kdst = sm + C::K + st * 2 * C::K_TILE;
        mbar_wait(&k_empty[st], ph ^ 1);
        mbar_arrive_tx(&k_full[st], 2 * nblk * BK * 128);
        for (int c = 0; c < nblk; ++c) {
          tma_load_4d(kdst + c * BK * 128, &tkb, &k_full[st], c * 32, t.kvh, k0, t.bi);
          tma_load_4d(kdst + C::K_TILE + c * BK * 128, &tks, &k_full[st], c * 32, t.kvh, k0,
                      t.bi);
        }
        uint8_t* vdst = sm + C::V + st * 2 * C::V_TILE;
        mbar_wait(&v_empty[st], ph ^ 1);
        mbar_arrive_tx(&v_full[st], 2 * C::V_TILE);
        for (int c = 0; c < BK / 32; ++c) {
          tma_load_4d(vdst + c * D * 128, &tvb, &v_full[st], k0 + c * 32, 0, t.kvh, t.bi);
          tma_load_4d(vdst + C::V_TILE + c * D * 128, &tvs, &v_full[st], k0 + c * 32, 0,
                      t.kvh, t.bi);
        }
      }
    }
    return;
  }

  // Consumers: warpgroup w owns query rows q0 + 64w .. +63 of each tile.
  if constexpr (C::NWG == 2) reg_alloc<240>();
  const int w = wg;
  const int wtid = tid & 127, warp = wtid >> 5, lane = tid & 31;
  const int cq = (lane & 3) * 2;
  const float sl2 = scale * LOG2E;   // scores to the log2 domain
  const uint32_t base = smem_u32(sm);
  const uint32_t qa = base + C::Q + w * 64 * 128, qsa = base + C::QS + w * 64 * 128;
  const size_t qstride = size_t(h) * d;

  float oacc[D / 2], sacc[BK / 2];
  uint32_t pb[BK / 2], ps[BK / 2];
  float m[2], l[2];
  int it = 0;
  uint32_t qph = 0;

  for (int x = first; x < last; ++x) {
    const T t(tiles[x], bhn, nqt, h, g, s, sk, causal, window);
    const int qw0 = t.q0 + 64 * w;
    const int qpos0 = qw0 + warp * 16 + (lane >> 2);
#pragma unroll
    for (int i = 0; i < D / 2; ++i) oacc[i] = 0.f;
    m[0] = m[1] = -CUDART_INF_F;
    l[0] = l[1] = 0.f;
    if (t.n > 0) {
      mbar_wait(q_full, qph);
      qph ^= 1;
      // This warpgroup's 64 rows of Q: big part in place, small part beside.
      for (int c = 0; c < nblk; ++c) {
        float4* q4 = reinterpret_cast<float4*>(sm + C::Q + c * BQ * 128 + w * 64 * 128);
        float4* qs4 = reinterpret_cast<float4*>(sm + C::QS + c * BQ * 128 + w * 64 * 128);
#pragma unroll
        for (int i = wtid; i < 64 * 8; i += 128) {
          const float4 v = q4[i];
          q4[i] = make_float4(__uint_as_float(tf32_big(v.x)), __uint_as_float(tf32_big(v.y)),
                              __uint_as_float(tf32_big(v.z)), __uint_as_float(tf32_big(v.w)));
          qs4[i] = make_float4(__uint_as_float(tf32_small(v.x)), __uint_as_float(tf32_small(v.y)),
                               __uint_as_float(tf32_small(v.z)),
                               __uint_as_float(tf32_small(v.w)));
        }
      }
      fence_proxy_async();
      bar_sync(1 + w, 128);

      {  // S_0 = Q K_0^T.
        const int st = it % STAGES;
        const uint32_t kb = base + C::K + st * 2 * C::K_TILE;
        mbar_wait(&k_full[st], (it / STAGES) & 1);
        fence_regs(sacc);
        wgmma_fence();
        s_product<D, BQ, BK>(sacc, qa, qsa, kb, kb + C::K_TILE);
        wgmma_wait<0>();
        fence_regs(sacc);
        __syncwarp();
        if (lane == 0) {
          mbar_arrive(&k_empty[st]);
          if (t.n == 1) mbar_arrive(q_empty);
        }
      }

      for (int j = 0; j < t.n; ++j) {
        const int k0 = (t.jt0 + j) * BK;
        const bool edge = k0 + BK > sk ||
                          (causal && (k0 + BK - 1 > qw0 ||
                                      (window > 0 && qw0 + 63 - k0 >= window)));
        // Online softmax of this tile on the accumulator registers.
        if (edge) {
#pragma unroll
          for (int tt = 0; tt < BK / 8; ++tt)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              if (!visible(qpos0 + (e >> 1) * 8, k0 + tt * 8 + cq + (e & 1), s, sk, causal,
                           window))
                sacc[4 * tt + e] = -CUDART_INF_F;
        }
        float mx0 = m[0], mx1 = m[1];
#pragma unroll
        for (int tt = 0; tt < BK / 8; ++tt) {
          mx0 = fmaxf(mx0, fmaxf(sacc[4 * tt], sacc[4 * tt + 1]));
          mx1 = fmaxf(mx1, fmaxf(sacc[4 * tt + 2], sacc[4 * tt + 3]));
        }
#pragma unroll
        for (int off = 1; off <= 2; off <<= 1) {
          mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
          mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
        }
        const float ms0 = mx0 == -CUDART_INF_F ? 0.f : mx0 * sl2;
        const float ms1 = mx1 == -CUDART_INF_F ? 0.f : mx1 * sl2;
        const float c0 = exp2_fast(fmaf(m[0], sl2, -ms0));
        const float c1 = exp2_fast(fmaf(m[1], sl2, -ms1));
        m[0] = mx0;
        m[1] = mx1;
        float l0 = l[0] * c0, l1 = l[1] * c1;
#pragma unroll
        for (int tt = 0; tt < D / 8; ++tt) {
          oacc[4 * tt] *= c0;
          oacc[4 * tt + 1] *= c0;
          oacc[4 * tt + 2] *= c1;
          oacc[4 * tt + 3] *= c1;
        }
        // P's k8 step tt: this thread holds keys 8tt + cq, +1 of rows r and
        // r + 8, which go to k positions cq/2 and cq/2 + 4 (Vt's order).
#pragma unroll
        for (int tt = 0; tt < BK / 8; ++tt) {
          const float p0 = exp2_fast(fmaf(sacc[4 * tt], sl2, -ms0));
          const float p1 = exp2_fast(fmaf(sacc[4 * tt + 1], sl2, -ms0));
          const float p2 = exp2_fast(fmaf(sacc[4 * tt + 2], sl2, -ms1));
          const float p3 = exp2_fast(fmaf(sacc[4 * tt + 3], sl2, -ms1));
          l0 += p0 + p1;
          l1 += p2 + p3;
          pb[4 * tt] = tf32_big(p0);
          pb[4 * tt + 1] = tf32_big(p2);
          pb[4 * tt + 2] = tf32_big(p1);
          pb[4 * tt + 3] = tf32_big(p3);
          ps[4 * tt] = tf32_small(p0);
          ps[4 * tt + 1] = tf32_small(p2);
          ps[4 * tt + 2] = tf32_small(p1);
          ps[4 * tt + 3] = tf32_small(p3);
        }
        l[0] = l0;
        l[1] = l1;

        // O += P_j V_j, and S_{j+1} = Q K_{j+1}^T with it.
        const int cur = it + j, st = cur % STAGES;
        const uint32_t vb = base + C::V + st * 2 * C::V_TILE;
        mbar_wait(&v_full[st], (cur / STAGES) & 1);
        if (j + 1 < t.n) {
          const int st1 = (cur + 1) % STAGES;
          const uint32_t kb = base + C::K + st1 * 2 * C::K_TILE;
          mbar_wait(&k_full[st1], ((cur + 1) / STAGES) & 1);
          fence_regs(oacc);
          fence_regs(sacc);
          fence_regs_u32(pb);
          fence_regs_u32(ps);
          wgmma_fence();
          pv_product<D, BK>(oacc, pb, ps, vb, vb + C::V_TILE);
          s_product<D, BQ, BK>(sacc, qa, qsa, kb, kb + C::K_TILE);
          wgmma_wait<0>();
          fence_regs(oacc);
          fence_regs(sacc);
          fence_regs_u32(pb);
          fence_regs_u32(ps);
          __syncwarp();
          if (lane == 0) {
            mbar_arrive(&v_empty[st]);
            mbar_arrive(&k_empty[st1]);
            if (j + 2 == t.n) mbar_arrive(q_empty);   // the tile's last S is done
          }
        } else {
          fence_regs(oacc);
          fence_regs_u32(pb);
          fence_regs_u32(ps);
          wgmma_fence();
          pv_product<D, BK>(oacc, pb, ps, vb, vb + C::V_TILE);
          wgmma_wait<0>();
          fence_regs(oacc);
          fence_regs_u32(pb);
          fence_regs_u32(ps);
          __syncwarp();
          if (lane == 0) mbar_arrive(&v_empty[st]);
        }
      }
      it += t.n;
    }

    float l0 = l[0], l1 = l[1];
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, off);
      l1 += __shfl_xor_sync(0xffffffffu, l1, off);
    }
    const size_t bh = size_t(t.bi) * h + t.hi;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qpos = qpos0 + 8 * r;
      if (qpos >= s) continue;
      const float lr = r ? l1 : l0;
      const float inv = lr > 0.f ? 1.f / lr : 0.f;
      float* dst = o + (size_t(t.bi) * s + qpos) * qstride + size_t(t.hi) * d + cq;
#pragma unroll
      for (int c = 0; c < D / 8; ++c)
        if (c * 8 + cq < d)
          *reinterpret_cast<float2*>(dst + c * 8) =
              make_float2(oacc[4 * c + 2 * r] * inv, oacc[4 * c + 2 * r + 1] * inv);
      if ((lane & 3) == 0)
        lse[bh * s + qpos] = lr > 0.f ? (m[r] * sl2 + log2f(lr)) * LN2 : -CUDART_INF_F;
    }
  }
}

template <int D>
int launch(const float* q, const float* k, const float* v, float* o, float* lse, float* split,
           const int* plan, int nblocks, int b, int s, int sk, int h, int g, int d, float scale,
           int causal, int window, cudaStream_t stream) {
  typedef Cfg<D> C;
  const int skp = (sk + KEY_PAD - 1) / KEY_PAD * KEY_PAD;
  const size_t kn = size_t(b) * sk * g * d, vn = size_t(b) * g * d * skp;
  float* kb = split;
  float* ks = kb + kn;
  float* vtb = ks + kn;
  float* vts = vtb + vn;
  tf32_split_kernel<<<dim3(skp / SPLIT_KEYS, b * g), SPLIT_THREADS, 0, stream>>>(
      k, v, kb, ks, vtb, vts, sk, skp, g, d);
  cudaError_t ce = cudaGetLastError();
  if (ce != cudaSuccess) return int(ce);
  CUtensorMap tq, tkb, tks, tvb, tvs;
  const CUtensorMapDataType F32 = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  int e;
  const int nq[4] = {d, h, s, b}, bq[4] = {32, 1, C::BQ, 1};
  const int nk[4] = {d, g, sk, b}, bk[4] = {32, 1, C::BK, 1};
  const int nv[4] = {skp, d, g, b}, bv[4] = {32, D, 1, 1};
  if ((e = make_map_box(&tq, q, F32, 4, nq, bq)) || (e = make_map_box(&tkb, kb, F32, 4, nk, bk)) ||
      (e = make_map_box(&tks, ks, F32, 4, nk, bk)) || (e = make_map_box(&tvb, vtb, F32, 4, nv, bv)) ||
      (e = make_map_box(&tvs, vts, F32, 4, nv, bv)))
    return e;
  // The shared-memory attribute once per device (a call captured into a
  // CUDA graph then makes no attribute call).
  static unsigned attr_set = 0;
  int dev = 0;
  ce = cudaGetDevice(&dev);
  if (ce != cudaSuccess) return int(ce);
  if (dev >= 32 || !(attr_set >> dev & 1u)) {
    ce = cudaFuncSetAttribute(flash_fwd_tf32_kernel<D>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize, C::ALLOC);
    if (ce != cudaSuccess) return int(ce);
    if (dev < 32) attr_set |= 1u << dev;
  }
  flash_fwd_tf32_kernel<D><<<nblocks, C::THREADS, C::ALLOC, stream>>>(
      tq, tkb, tks, tvb, tvs, o, lse, plan, b, s, sk, h, g, d, scale, causal, window);
  return int(cudaGetLastError());
}

}  // namespace

// q [b, s, h, d], k/v [b, sk, g, d], o [b, s, h, d] f32 contiguous (16-byte
// aligned); lse [b*h, s] f32 (natural log; -inf for a row that sees no
// key).  d % 4 == 0, d <= 128.  `split`: f32 scratch of 2 * b*sk*g*d +
// 2 * b*g*d*skp floats (skp = sk rounded up to 64), 16-byte aligned.
// `plan` int32: ops/flash_attention.py fwd_schedule's work list at
// TF32_TILES (Cfg's BQ, BK), nblocks + 1 offsets then the tiles.
// window <= 0 means none.  Returns 0 or a cudaError_t.
extern "C" int tgt_flash_fwd_tf32(const void* q, const void* k, const void* v, void* o,
                                  void* lse, void* split, const void* plan, int nblocks, int b,
                                  int s, int sk, int h, int g, int d, float scale, int causal,
                                  int window, void* stream) {
  if (s == 0 || b == 0) return 0;
  if (sk <= 0 || g <= 0 || h % g != 0 || nblocks <= 0 || d <= 0 || d % 4 != 0 || d > 128)
    return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float *fq = static_cast<const float*>(q), *fk = static_cast<const float*>(k),
              *fv = static_cast<const float*>(v);
  float *fo = static_cast<float*>(o), *fl = static_cast<float*>(lse),
        *fs = static_cast<float*>(split);
  const int* pl = static_cast<const int*>(plan);
  if (d <= 64)
    return launch<64>(fq, fk, fv, fo, fl, fs, pl, nblocks, b, s, sk, h, g, d, scale, causal,
                      window, st);
  return launch<128>(fq, fk, fv, fo, fl, fs, pl, nblocks, b, s, sk, h, g, d, scale, causal,
                     window, st);
}

// Dynamic shared memory of one block at head dim d.
extern "C" int tgt_flash_fwd_tf32_smem_bytes(int d) {
  return d <= 64 ? Cfg<64>::ALLOC : Cfg<128>::ALLOC;
}
