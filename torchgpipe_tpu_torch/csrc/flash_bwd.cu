// Flash attention backward for Hopper (sm_90a): dQ, and dK/dV, of causal /
// windowed GQA attention, recomputing the softmax from the forward's
// per-row logsumexp.
//
// Replaces: torchgpipe_tpu/ops/flash_attention.py
//   flash_bwd_dq  <- _dq_kernel (K/V row resident in VMEM) and
//                    _dq_stream_kernel (K/V tiles streamed on a grid axis);
//   flash_bwd_dkv <- _dkv_kernel (Q/dO row resident) and
//                    _dkv_stream_kernel (Q/dO tiles streamed), plus the
//                    group sum the JAX wrappers run after them.
// The resident/streaming split exists on the TPU because of VMEM size;
// here one tile loop serves every sequence length, as in flash_fwd.cu.
//
// Bound on the H100: operations.  With P attended (query, key) pairs
// (P = s(s+1)/2 causal), flash_bwd_dq does three products (S = Q K^T,
// dP = dO V^T, dQ = dS K): 6 * b * h * d * P FLOPs; flash_bwd_dkv does four
// (S^T, dP^T, dV = P^T dO, dK = dS^T Q): 8 * b * h * d * P FLOPs; against
// 989 TFLOP/s bf16 on the tensor cores.  The bytes (q, k, v, dO, lse and
// delta in; dq, dk, dv out) are small beside that for s >= 1024.
//
// No atomics in either kernel, so the results are bitwise equal run to run.
//
// * flash_bwd_dq (FlashAttention-2's dQ pass on mma.sync, mma_tiles.cuh):
//   one block of 4 warps per (batch*head, 64-row query tile), each warp 16
//   query rows.  Q and dO stay in shared memory; K/V tiles of 64 keys
//   stream through a two-stage cp.async ring over the live tiles only (the
//   window's first tile .. the diagonal).  Per tile S and dP accumulate in
//   registers, P = exp(S*scale - lse) and dS = P * (dP - delta) are formed
//   in place and packed straight into A fragments for dQ += dS K (K's B
//   fragments via ldmatrix.trans).
// * flash_bwd_dkv (wgmma on swizzled tiles fed by TMA, hopper_tiles.cuh).
//   - The schedule.  The causal work of a 128-key tile grows with its
//     distance from the end, so one block per key tile leaves the launch
//     waiting on its heaviest block.  The wrapper (ops/flash_attention.py,
//     dkv_schedule) cuts each (batch, kv head, key tile)'s loop over
//     (query head, 64-row query tile) into items and deals them to one
//     persistent block per SM, longest first, filling each SM to the mean
//     (McNaughton's wrap-around rule), so no SM carries more than the mean
//     work of a launch.
//   - The block: warpgroups 0 and 1 are consumers, 64 keys each (the
//     wgmma M side); warpgroup 2's first warp is the producer.  Per item
//     the producer TMA-loads the 128-key K and V tiles once (two slots, so
//     the next item's arrive during this one), then keeps a three-stage
//     ring of 64-query Q and dO tiles in flight across items, its lanes
//     copying the tiles' lse (in log2 units) and delta rows beside them.
//     S^T = K Q^T and dP^T = V dO^T run from shared memory (both operands
//     K-major); P^T = exp2(S^T*scale*log2e - lse) and dS^T = P^T * (dP^T -
//     delta) are formed on the accumulators and packed as A fragments, so
//     dV += P^T dO and dK += dS^T Q run from registers with dO and Q read
//     MN-major (the transpose bit).  dK and dV ([64, d] f32 each) stay in
//     registers across the item: 128 a thread at d = 128, with S^T and dP^T
//     64 more, so the consumers take 240 registers (setmaxnreg) and the
//     producer 24.  A warpgroup skips a query tile that none of its keys
//     attends.
//   - The sum stays deterministic.  An item that holds its key tile's whole
//     loop writes bf16 dK/dV itself.  Otherwise each item writes its f32
//     partials to its own slot of a scratch tensor, in the accumulators'
//     register layout (coalesced float4 rows), and a second kernel,
//     flash_bwd_dkv_sum, adds a key tile's slots in item order and writes
//     bf16 [b, s_k, g, d]; it also writes the zeros of key tiles that no
//     query attends.  This replaces the TPU's expanded [b*h, s_k, d]
//     outputs and the group sum after them.
// Element masks (causal, window, ragged query and key edges) run only on
// tiles that straddle an edge; rows and keys past the end arrive as zeros
// (cp.async zero-fill in flash_bwd_dq, TMA's out-of-bounds fill in
// flash_bwd_dkv) and are masked.  GQA: query head i reads kv head i / (h/g).

#include <math_constants.h>

#include "hopper_tiles.cuh"
#include "mma_tiles.cuh"

namespace {

using namespace tiles;
using namespace hopper;

constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr float LOG2E = 1.4426950408889634f;

// flash_bwd_dq: 64 query rows per block, 64-key K/V tiles.
constexpr int DQ_BQ = 16 * WARPS;
constexpr int DQ_BK = 64;

template <int D>
struct DqLayout {
  static constexpr int LD = D + 8;   // row pitch (bf16): ldmatrix conflict-free
  static constexpr int TILE = DQ_BK * LD;
  // Q, dO [BQ][LD]; K, V [2][BK][LD]
  static constexpr size_t BYTES = size_t(2 * DQ_BQ * LD + 4 * TILE) * sizeof(bf16);
};

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    bf16* __restrict__ dq, int s, int sk, int h, int g, float scale,
                    int causal, int window) {
  typedef DqLayout<D> L;
  constexpr int BQ = DQ_BQ, BK = DQ_BK;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);
  bf16* sO = sQ + BQ * L::LD;        // dO
  bf16* sK = sO + BQ * L::LD;        // [2][BK][LD]
  bf16* sV = sK + 2 * L::TILE;       // [2][BK][LD]

  const int bh = blockIdx.x;
  const int qt = gridDim.y - 1 - blockIdx.y;  // heaviest causal tiles first
  const int bi = bh / h, hi = bh % h;
  const int kvh = hi / (h / g);
  const int q0 = qt * BQ;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  int nkt = (sk + BK - 1) / BK, jt0 = 0;
  if (causal) {
    nkt = min(nkt, (min(q0 + BQ, s) - 1) / BK + 1);
    if (window > 0) jt0 = max(q0 - (window - 1), 0) / BK;
  }
  const size_t qstride = size_t(h) * D, kstride = size_t(g) * D;
  const size_t qoff = (size_t(bi) * s + q0) * qstride + size_t(hi) * D;
  const bf16* kbase = k + size_t(bi) * sk * kstride + size_t(kvh) * D;
  const bf16* vbase = v + size_t(bi) * sk * kstride + size_t(kvh) * D;

  auto load_kv = [&](int jt, int stage) {
    const int k0 = jt * BK;
    load_tile<D, L::LD, BK, THREADS>(sK + stage * L::TILE, kbase + size_t(k0) * kstride,
                                     kstride, sk - k0, tid);
    load_tile<D, L::LD, BK, THREADS>(sV + stage * L::TILE, vbase + size_t(k0) * kstride,
                                     kstride, sk - k0, tid);
  };

  load_tile<D, L::LD, BQ, THREADS>(sQ, q + qoff, qstride, s - q0, tid);
  load_tile<D, L::LD, BQ, THREADS>(sO, dout + qoff, qstride, s - q0, tid);
  load_kv(jt0, 0);
  cp_async_commit();

  // Per-thread rows of the warp's 16: r0 = lane/4 and r0 + 8; per n-tile
  // of 8 keys/dims, columns 2*(lane%4) and +1.
  const int r0 = lane >> 2, cq = (lane & 3) * 2;
  const int qpos0 = q0 + warp * 16 + r0, qpos1 = qpos0 + 8;
  const float sl2 = scale * LOG2E;   // scores in the log2 domain
  const float* lrow = lse + size_t(bh) * s;
  const float* drow = delta + size_t(bh) * s;
  const float lse0 = qpos0 < s ? lrow[qpos0] * LOG2E : 0.f;
  const float lse1 = qpos1 < s ? lrow[qpos1] * LOG2E : 0.f;
  const float dl0 = qpos0 < s ? drow[qpos0] : 0.f;
  const float dl1 = qpos1 < s ? drow[qpos1] : 0.f;
  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  // ldmatrix lane addressing: matrix i = lane/8, row lane%8.
  const int li = lane >> 3, lr = lane & 7;
  const int arow = (warp * 16 + (li & 1) * 8 + lr) * L::LD + (li >> 1) * 8;

  for (int jt = jt0; jt < nkt; ++jt) {
    const int stage = (jt - jt0) & 1;
    if (jt + 1 < nkt) {
      load_kv(jt + 1, stage ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* tK = sK + stage * L::TILE;
    const bf16* tV = sV + stage * L::TILE;

    // S = Q K^T and dP = dO V^T, [16 rows x BK keys] per warp.
    float sc[BK / 8][4], dp[BK / 8][4];
#pragma unroll
    for (int t = 0; t < BK / 8; ++t) {
      sc[t][0] = sc[t][1] = sc[t][2] = sc[t][3] = 0.f;
      dp[t][0] = dp[t][1] = dp[t][2] = dp[t][3] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t qa[4], da[4];
      ldmatrix_x4(qa, sQ + arow + kk * 16);
      ldmatrix_x4(da, sO + arow + kk * 16);
#pragma unroll
      for (int j = 0; j < BK / 16; ++j) {
        const int boff = (j * 16 + (li >> 1) * 8 + lr) * L::LD + kk * 16 + (li & 1) * 8;
        uint32_t kb[4], vb[4];
        ldmatrix_x4(kb, tK + boff);
        mma16816(sc[2 * j], qa, kb[0], kb[1]);
        mma16816(sc[2 * j + 1], qa, kb[2], kb[3]);
        ldmatrix_x4(vb, tV + boff);
        mma16816(dp[2 * j], da, vb[0], vb[1]);
        mma16816(dp[2 * j + 1], da, vb[2], vb[3]);
      }
    }

    // P = exp(S*scale - lse); dS = P * (dP - delta), packed as A fragments.
    const int k0 = jt * BK;
    const bool edge = k0 + BK > sk || q0 + BQ > s ||
                      (causal && (k0 + BK - 1 > q0 ||
                                  (window > 0 && q0 + BQ - 1 - k0 >= window)));
    uint32_t dsa[BK / 16][4];
#pragma unroll
    for (int t = 0; t < BK / 8; ++t) {
      float ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool lo = e < 2;
        float p = exp2f(sc[t][e] * sl2 - (lo ? lse0 : lse1));
        if (edge && !attends(lo ? qpos0 : qpos1, k0 + t * 8 + cq + (e & 1), s, sk,
                             causal, window))
          p = 0.f;
        ds[e] = p * (dp[t][e] - (lo ? dl0 : dl1));
      }
      dsa[t >> 1][(t & 1) * 2] = pack_bf16(ds[0], ds[1]);
      dsa[t >> 1][(t & 1) * 2 + 1] = pack_bf16(ds[2], ds[3]);
    }

    // dQ += dS K (K as [keys, d]: B fragments by ldmatrix.trans).
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
#pragma unroll
      for (int np = 0; np < D / 16; ++np) {
        uint32_t kb[4];
        ldmatrix_x4_trans(kb, tK + (kk * 16 + (li & 1) * 8 + lr) * L::LD + np * 16 + (li >> 1) * 8);
        mma16816(acc[2 * np], dsa[kk], kb[0], kb[1]);
        mma16816(acc[2 * np + 1], dsa[kk], kb[2], kb[3]);
      }
    }
    __syncthreads();  // the next prefetch overwrites this stage
  }

  if (qpos0 < s) {
    bf16* dst = dq + qoff + size_t(warp * 16 + r0) * qstride + cq;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<__nv_bfloat162*>(dst + n * 8) =
          __floats2bfloat162_rn(acc[n][0] * scale, acc[n][1] * scale);
  }
  if (qpos1 < s) {
    bf16* dst = dq + qoff + size_t(warp * 16 + r0 + 8) * qstride + cq;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<__nv_bfloat162*>(dst + n * 8) =
          __floats2bfloat162_rn(acc[n][2] * scale, acc[n][3] * scale);
  }
}

template <int D>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const void* lse, const void* delta, void* dq, int b, int s, int sk, int h,
              int g, float scale, int causal, int window, cudaStream_t stream) {
  const size_t bytes = DqLayout<D>::BYTES;
  cudaError_t e = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, int(bytes));
  if (e != cudaSuccess) return int(e);
  dim3 grid(b * h, (s + DQ_BQ - 1) / DQ_BQ);
  flash_bwd_dq_kernel<D><<<grid, THREADS, bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<bf16*>(dq), s, sk, h, g, scale, causal, window);
  return int(cudaGetLastError());
}

// ---- flash_bwd_dkv ---------------------------------------------------------

constexpr int KV_BK = 128;       // keys per item: two consumer warpgroups of 64
constexpr int KV_BQ = 64;        // queries per Q/dO tile
constexpr int KV_STAGES = 3;
constexpr int KV_THREADS = 384;
// An item: batch, kv head, key tile, first live query tile, live query
// tiles per head, iterations [it0, it1) of the loop over (query head,
// query tile), scratch slot (-1: write bf16 directly).
constexpr int ITEM_INTS = 8;

// K and V have two slots each (consecutive items alternate), so the next
// item's K/V and first Q tiles load while the current item finishes.  At
// d = 128 the layout takes 232016 of the 232448 bytes a block may have.
template <int D>
struct DkvSmem {
  static constexpr int KV_TILE = KV_BK * D * 2;  // bytes of K (or V)
  static constexpr int Q_TILE = KV_BQ * D * 2;   // bytes of a Q (or dO) tile
  static constexpr int K = 0;                    // [slot][KV_TILE]
  static constexpr int V = 2 * KV_TILE;
  static constexpr int Q = 4 * KV_TILE;
  static constexpr int DO = Q + KV_STAGES * Q_TILE;
  static constexpr int LSE = DO + KV_STAGES * Q_TILE;    // [stage][KV_BQ] f32
  static constexpr int DELTA = LSE + KV_STAGES * KV_BQ * 4;
  static constexpr int BAR = DELTA + KV_STAGES * KV_BQ * 4;
  // full[S], empty[S], kv_full[2], kv_empty[2]
  static constexpr int BYTES = BAR + (2 * KV_STAGES + 4) * 8;
  static constexpr int ALLOC = BYTES + 1024;  // room to align the base
};

template <int D>
__global__ void __launch_bounds__(KV_THREADS, 1)
flash_bwd_dkv_kernel(const __grid_constant__ CUtensorMap tq,
                     const __grid_constant__ CUtensorMap tdo,
                     const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv, const float* __restrict__ lse,
                     const float* __restrict__ delta, const int* __restrict__ items,
                     const int* __restrict__ offsets, float* __restrict__ partial,
                     bf16* __restrict__ dk, bf16* __restrict__ dv, int s, int sk, int h, int g,
                     float scale, int causal, int window) {
  typedef DkvSmem<D> L;
  constexpr int NB = D / 64;         // 64-column blocks of a row
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + L::BAR);
  uint64_t* empty = full + KV_STAGES;
  uint64_t* kv_full = empty + KV_STAGES;   // [slot]
  uint64_t* kv_empty = kv_full + 2;
  float* s_lse = reinterpret_cast<float*>(sm + L::LSE);
  float* s_delta = reinterpret_cast<float*>(sm + L::DELTA);
  const int tid = threadIdx.x, wg = tid >> 7, lane = tid & 31;
  const int first = offsets[blockIdx.x], last = offsets[blockIdx.x + 1];
  const int r = h / g;

  if (tid == 0) {
    for (int i = 0; i < KV_STAGES; ++i) {
      mbar_init(&full[i], 32);       // the producer warp's lanes, lane 0 with the bytes
      mbar_init(&empty[i], 8);       // one arrival per consumer warp
    }
    for (int i = 0; i < 2; ++i) {
      mbar_init(&kv_full[i], 1);
      mbar_init(&kv_empty[i], 8);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 2) {
    // Producer: the first warp of warpgroup 2.
    reg_dealloc<24>();
    if (tid >= 2 * 128 + 32) return;
    int stage = 0;
    uint32_t phase = 0;
    for (int i = first; i < last; ++i) {
      const int* it = items + ITEM_INTS * i;
      const int bi = it[0], kvh = it[1], kt = it[2], jq0 = it[3], ntile = it[4];
      const int slot = (i - first) & 1;
      mbar_wait(&kv_empty[slot], (((i - first) >> 1) & 1) ^ 1);
      if (lane == 0) {
        uint64_t* bar = &kv_full[slot];
        mbar_arrive_tx(bar, 2 * L::KV_TILE);
        for (int c = 0; c < NB; ++c) {
          const int off = slot * L::KV_TILE + c * KV_BK * 128;
          tma_load_4d(sm + L::K + off, &tk, bar, c * 64, kvh, kt * KV_BK, bi);
          tma_load_4d(sm + L::V + off, &tv, bar, c * 64, kvh, kt * KV_BK, bi);
        }
      }
      for (int t = it[5]; t < it[6]; ++t) {
        const int hh = kvh * r + t / ntile, q0 = (jq0 + t % ntile) * KV_BQ;
        mbar_wait(&empty[stage], phase ^ 1);
        const size_t row = (size_t(bi) * h + hh) * s;
        for (int c = lane; c < KV_BQ; c += 32) {
          const int qp = q0 + c;
          s_lse[stage * KV_BQ + c] = qp < s ? lse[row + qp] * LOG2E : 0.f;
          s_delta[stage * KV_BQ + c] = qp < s ? delta[row + qp] : 0.f;
        }
        if (lane == 0) {
          mbar_arrive_tx(&full[stage], 2 * L::Q_TILE);
          for (int c = 0; c < NB; ++c) {
            tma_load_4d(sm + L::Q + stage * L::Q_TILE + c * KV_BQ * 128, &tq, &full[stage],
                        c * 64, hh, q0, bi);
            tma_load_4d(sm + L::DO + stage * L::Q_TILE + c * KV_BQ * 128, &tdo, &full[stage],
                        c * 64, hh, q0, bi);
          }
        } else {
          mbar_arrive(&full[stage]);
        }
        if (++stage == KV_STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  // Consumers: warpgroup w owns keys kt*128 + 64w .. +63 of each item.
  reg_alloc<240>();
  const int w = wg, warp = (tid >> 5) & 3;
  const int rq = lane >> 2, cq = (lane & 3) * 2;
  const float sl2 = scale * LOG2E;
  const uint32_t base = smem_u32(sm);
  int stage = 0;
  uint32_t phase = 0;
  for (int i = first; i < last; ++i) {
    const int* it = items + ITEM_INTS * i;
    const int bi = it[0], kvh = it[1], kt = it[2], jq0 = it[3], ntile = it[4];
    const int slot = it[7];
    const int kw0 = kt * KV_BK + 64 * w;
    const int kpos0 = kw0 + warp * 16 + rq, kpos1 = kpos0 + 8;
    const int kv_slot = (i - first) & 1;
    const uint32_t ka = base + L::K + kv_slot * L::KV_TILE + w * 64 * 128;
    const uint32_t va = base + L::V + kv_slot * L::KV_TILE + w * 64 * 128;
    float dka[D / 2], dva[D / 2];
#pragma unroll
    for (int n = 0; n < D / 2; ++n) dka[n] = dva[n] = 0.f;
    mbar_wait(&kv_full[kv_slot], ((i - first) >> 1) & 1);

    for (int t = it[5]; t < it[6]; ++t) {
      const int q0 = (jq0 + t % ntile) * KV_BQ;
      mbar_wait(&full[stage], phase);
      const bool dead = kw0 >= sk || (causal && (q0 + KV_BQ - 1 < kw0 ||
                                                 (window > 0 && q0 - (kw0 + 63) >= window)));
      if (!dead) {
        const bool edge = q0 + KV_BQ > s || kw0 + 64 > sk ||
                          (causal && (kw0 + 63 > q0 ||
                                      (window > 0 && q0 + KV_BQ - 1 - kw0 >= window)));
        const uint32_t qa = base + L::Q + stage * L::Q_TILE;
        const uint32_t oa = base + L::DO + stage * L::Q_TILE;
        const float* sl = s_lse + stage * KV_BQ;
        const float* sd = s_delta + stage * KV_BQ;

        // S^T = K Q^T and dP^T = V dO^T: [64 keys x 64 queries] each.
        float st[KV_BQ / 2], dpt[KV_BQ / 2];
        fence_regs(st);
        fence_regs(dpt);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const uint32_t off = (kk / 4) * KV_BK * 128 + (kk % 4) * 32;
          wgmma_ss<KV_BQ, 0>(st, desc_k(ka + off),
                             desc_k(qa + (kk / 4) * KV_BQ * 128 + (kk % 4) * 32), kk > 0);
        }
        wgmma_commit();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const uint32_t off = (kk / 4) * KV_BK * 128 + (kk % 4) * 32;
          wgmma_ss<KV_BQ, 0>(dpt, desc_k(va + off),
                             desc_k(oa + (kk / 4) * KV_BQ * 128 + (kk % 4) * 32), kk > 0);
        }
        wgmma_commit();

        // P^T = exp2(S^T * scale * log2e - lse[q]) while dP^T finishes;
        // masked pairs (only on tiles that straddle an edge) get p = 0.
        wgmma_wait<1>();
        fence_regs(st);
        if (edge) {
#pragma unroll
          for (int t8 = 0; t8 < KV_BQ / 8; ++t8)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              if (!visible(q0 + t8 * 8 + cq + (e & 1), e < 2 ? kpos0 : kpos1, s, sk, causal,
                           window))
                st[4 * t8 + e] = -CUDART_INF_F;
        }
#pragma unroll
        for (int t8 = 0; t8 < KV_BQ / 8; ++t8) {
          const float2 l2 = *reinterpret_cast<const float2*>(sl + t8 * 8 + cq);
#pragma unroll
          for (int e = 0; e < 4; ++e)
            st[4 * t8 + e] = exp2_fast(fmaf(st[4 * t8 + e], sl2, (e & 1) ? -l2.y : -l2.x));
        }
        // dS^T = P^T * (dP^T - delta[q]); both packed as A fragments.
        wgmma_wait<0>();
        fence_regs(dpt);
        uint32_t pa[KV_BQ / 16][4], dsa[KV_BQ / 16][4];
#pragma unroll
        for (int t8 = 0; t8 < KV_BQ / 8; ++t8) {
          const float2 dl = *reinterpret_cast<const float2*>(sd + t8 * 8 + cq);
          float ds[4];
#pragma unroll
          for (int e = 0; e < 4; ++e)
            ds[e] = st[4 * t8 + e] * (dpt[4 * t8 + e] - ((e & 1) ? dl.y : dl.x));
          pa[t8 >> 1][(t8 & 1) * 2] = bf16x2(st[4 * t8], st[4 * t8 + 1]);
          pa[t8 >> 1][(t8 & 1) * 2 + 1] = bf16x2(st[4 * t8 + 2], st[4 * t8 + 3]);
          dsa[t8 >> 1][(t8 & 1) * 2] = bf16x2(ds[0], ds[1]);
          dsa[t8 >> 1][(t8 & 1) * 2 + 1] = bf16x2(ds[2], ds[3]);
        }

        // dV += P^T dO and dK += dS^T Q (dO, Q as [queries, d]: MN-major).
        fence_regs(dva);
        fence_regs(dka);
        wgmma_fence();
#pragma unroll
        for (int kq = 0; kq < KV_BQ / 16; ++kq)
          wgmma_rs<D, 1>(dva, pa[kq], desc_mn(oa + kq * 2048, KV_BQ * 128), 1);
#pragma unroll
        for (int kq = 0; kq < KV_BQ / 16; ++kq)
          wgmma_rs<D, 1>(dka, dsa[kq], desc_mn(qa + kq * 2048, KV_BQ * 128), 1);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(dva);
        fence_regs(dka);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[stage]);
      if (++stage == KV_STAGES) {
        stage = 0;
        phase ^= 1;
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&kv_empty[kv_slot]);

    if (slot < 0) {
      const size_t kstride = size_t(g) * D;
      const size_t col = size_t(kvh) * D + cq;
      if (kpos0 < sk) {
        const size_t off = (size_t(bi) * sk + kpos0) * kstride + col;
#pragma unroll
        for (int t8 = 0; t8 < D / 8; ++t8) {
          *reinterpret_cast<__nv_bfloat162*>(dk + off + t8 * 8) =
              __floats2bfloat162_rn(dka[4 * t8] * scale, dka[4 * t8 + 1] * scale);
          *reinterpret_cast<__nv_bfloat162*>(dv + off + t8 * 8) =
              __floats2bfloat162_rn(dva[4 * t8], dva[4 * t8 + 1]);
        }
      }
      if (kpos1 < sk) {
        const size_t off = (size_t(bi) * sk + kpos1) * kstride + col;
#pragma unroll
        for (int t8 = 0; t8 < D / 8; ++t8) {
          *reinterpret_cast<__nv_bfloat162*>(dk + off + t8 * 8) =
              __floats2bfloat162_rn(dka[4 * t8 + 2] * scale, dka[4 * t8 + 3] * scale);
          *reinterpret_cast<__nv_bfloat162*>(dv + off + t8 * 8) =
              __floats2bfloat162_rn(dva[4 * t8 + 2], dva[4 * t8 + 3]);
        }
      }
    } else {
      // Slot layout: [2 (dK, dV)][D/8 float4 columns][256 consumer threads].
      float4* pp = reinterpret_cast<float4*>(partial + size_t(slot) * 256 * D);
#pragma unroll
      for (int c = 0; c < D / 8; ++c) {
        pp[c * 256 + tid] = make_float4(dka[4 * c], dka[4 * c + 1], dka[4 * c + 2], dka[4 * c + 3]);
        pp[(D / 8 + c) * 256 + tid] =
            make_float4(dva[4 * c], dva[4 * c + 1], dva[4 * c + 2], dva[4 * c + 3]);
      }
    }
  }
}

// One block per (batch, kv head, key tile) and float4 column j of the slot
// layout (j < D/8: dK columns 8j .. 8j+7 of the thread's two rows, else
// dV's): adds the tile's `count` slots from `first` in item order (count
// 0: no query attends the tile, write zeros; count < 0: an item wrote it
// directly).  Threads map to rows as the consumers' accumulators do.
template <int D>
__global__ void __launch_bounds__(256)
flash_bwd_dkv_sum_kernel(const float* __restrict__ partial, const int* __restrict__ combos,
                         bf16* __restrict__ dk, bf16* __restrict__ dv, int sk, int g, int nkt,
                         float scale) {
  const int c = blockIdx.x, j = blockIdx.y, first = combos[2 * c], count = combos[2 * c + 1];
  if (count < 0) return;
  const int tid = threadIdx.x;
  float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int n = 0; n < count; ++n) {
    const float4 x =
        reinterpret_cast<const float4*>(partial + size_t(first + n) * 256 * D)[j * 256 + tid];
    a.x += x.x;
    a.y += x.y;
    a.z += x.z;
    a.w += x.w;
  }
  const bool is_v = j >= D / 8;
  bf16* out = is_v ? dv : dk;
  const float f = is_v ? 1.f : scale;
  const int kt = c % nkt, kvh = (c / nkt) % g, bi = c / nkt / g;
  const int w = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int kpos0 = kt * KV_BK + 64 * w + warp * 16 + (lane >> 2), kpos1 = kpos0 + 8;
  const size_t kstride = size_t(g) * D;
  const size_t col = size_t(kvh) * D + (is_v ? j - D / 8 : j) * 8 + (lane & 3) * 2;
  if (kpos0 < sk)
    *reinterpret_cast<__nv_bfloat162*>(out + (size_t(bi) * sk + kpos0) * kstride + col) =
        __floats2bfloat162_rn(a.x * f, a.y * f);
  if (kpos1 < sk)
    *reinterpret_cast<__nv_bfloat162*>(out + (size_t(bi) * sk + kpos1) * kstride + col) =
        __floats2bfloat162_rn(a.z * f, a.w * f);
}

template <int D>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout, const void* lse,
               const void* delta, void* dk, void* dv, const int* items, const int* offsets,
               const int* combos, float* partial, int nblocks, int b, int s, int sk, int h,
               int g, float scale, int causal, int window, cudaStream_t stream) {
  if (nblocks > 0) {
    CUtensorMap tq, tdo, tk, tv;
    int e;
    if ((e = make_map(&tq, q, D, h, s, b, KV_BQ)) || (e = make_map(&tdo, dout, D, h, s, b, KV_BQ)) ||
        (e = make_map(&tk, k, D, g, sk, b, KV_BK)) || (e = make_map(&tv, v, D, g, sk, b, KV_BK)))
      return e;
    const int bytes = DkvSmem<D>::ALLOC;
    cudaError_t ce = cudaFuncSetAttribute(flash_bwd_dkv_kernel<D>,
                                          cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (ce != cudaSuccess) return int(ce);
    flash_bwd_dkv_kernel<D><<<nblocks, KV_THREADS, bytes, stream>>>(
        tq, tdo, tk, tv, static_cast<const float*>(lse), static_cast<const float*>(delta), items,
        offsets, partial, static_cast<bf16*>(dk), static_cast<bf16*>(dv), s, sk, h, g, scale,
        causal, window);
    ce = cudaGetLastError();
    if (ce != cudaSuccess) return int(ce);
  }
  const int nkt = (sk + KV_BK - 1) / KV_BK;
  flash_bwd_dkv_sum_kernel<D><<<dim3(b * g * nkt, D / 4), 256, 0, stream>>>(
      partial, combos, static_cast<bf16*>(dk), static_cast<bf16*>(dv), sk, g, nkt, scale);
  return int(cudaGetLastError());
}

}  // namespace

// q, dout, dq [b, s, h, d]; k, v [b, sk, g, d] bf16 contiguous; lse, delta
// [b*h, s] f32 (lse in scaled-score units, as flash_fwd writes it; delta =
// rowsum(dO * O)).  dq = dS K * scale.  window <= 0 means none.  Returns
// cudaGetLastError().
extern "C" int tgt_flash_bwd_dq_bf16(const void* q, const void* k, const void* v,
                                     const void* dout, const void* lse, const void* delta,
                                     void* dq, int b, int s, int sk, int h, int g, int d,
                                     float scale, int causal, int window, void* stream) {
  if (s == 0 || b == 0) return 0;
  if (sk == 0 || g <= 0 || h % g != 0) return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (d == 128)
    return launch_dq<128>(q, k, v, dout, lse, delta, dq, b, s, sk, h, g, scale, causal, window, st);
  if (d == 64)
    return launch_dq<64>(q, k, v, dout, lse, delta, dq, b, s, sk, h, g, scale, causal, window, st);
  return int(cudaErrorInvalidValue);
}

// Same inputs; dk = dS^T Q * scale and dv = P^T dO, summed over the h/g
// query heads of each kv head, written as [b, sk, g, d] bf16.  Every row
// is written (zeros where no query attends).  The work list comes from
// the wrapper (ops/flash_attention.py, dkv_schedule): `items` int32
// [n, 8] (see ITEM_INTS), `offsets` int32 [nblocks + 1] (block i runs
// items offsets[i] .. offsets[i+1]-1), `combos` int32 [b * g * nkt, 2]
// (first slot and slot count of each key tile, -1 when an item writes it
// directly), `partial` f32 [slots, 256 * d].  Returns 0 or a cudaError_t.
extern "C" int tgt_flash_bwd_dkv_bf16(const void* q, const void* k, const void* v,
                                      const void* dout, const void* lse, const void* delta,
                                      void* dk, void* dv, const void* items,
                                      const void* offsets, const void* combos, void* partial,
                                      int nblocks, int b, int s, int sk, int h, int g, int d,
                                      float scale, int causal, int window, void* stream) {
  if (sk == 0 || b == 0) return 0;
  if (g <= 0 || h % g != 0) return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* it = static_cast<const int*>(items);
  const int* of = static_cast<const int*>(offsets);
  const int* co = static_cast<const int*>(combos);
  float* pp = static_cast<float*>(partial);
  if (d == 128)
    return launch_dkv<128>(q, k, v, dout, lse, delta, dk, dv, it, of, co, pp, nblocks, b, s, sk,
                           h, g, scale, causal, window, st);
  if (d == 64)
    return launch_dkv<64>(q, k, v, dout, lse, delta, dk, dv, it, of, co, pp, nblocks, b, s, sk,
                          h, g, scale, causal, window, st);
  return int(cudaErrorInvalidValue);
}

// Dynamic shared memory of one flash_bwd_dkv block at head dim d (0: d
// not taken).
extern "C" int tgt_flash_bwd_dkv_smem_bytes(int d) {
  return d == 128 ? DkvSmem<128>::ALLOC : d == 64 ? DkvSmem<64>::ALLOC : 0;
}
