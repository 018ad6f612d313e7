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
// Element type E: bf16 (the _bf16 entry points) or float16 (_f16), the
// same kernels with wgmma's f16 form and f16 tensor maps; P and dS are
// packed to E as the products' A operands, everything else stays f32.
//
// * flash_bwd_dq (wgmma on swizzled tiles fed by TMA, hopper_tiles.cuh,
//   the design of flash_fwd).  One persistent block per SM walks a
//   longest-first list of 128-row query tiles (ops/flash_attention.py
//   fwd_schedule with rows=128, keys=64: a tile's cost is its live key
//   tiles, which grow along a causal sequence, so one block per tile left
//   the launch waiting on its heaviest blocks).  Warpgroups 0 and 1 are
//   consumers, 64 query rows each, reading their rows' lse and delta from
//   device memory; one thread of warpgroup 2 is the producer: it TMA-loads
//   each tile's Q and dO once, into one of two slots so that the next
//   tile's arrive while this one runs, and keeps a three-stage ring of
//   64-key K/V tiles in flight over the live key tiles only (the window's
//   first tile .. the diagonal), across tiles.  Each consumer warp reads
//   its 16 rows of Q and dO once per tile into registers as wgmma A
//   fragments (then frees the slot), so S = Q K^T and dP = dO V^T run as RS
//   wgmma reading only K and V from shared memory (an SS m64n64 product
//   reads as many operand bytes as the tensor cores consume).  P =
//   exp2(S * scale * log2e - lse) and dS = P * (dP - delta) are formed on
//   the accumulators (branch-free masks on edge tiles only) and packed as
//   A fragments, so dQ += dS K runs from registers too, with K read
//   MN-major (the transpose bit).  The two consumers take turns to start S
//   and dP (named barriers, as flash_fwd's ping-pong).  dQ ([64, d] f32)
//   stays in registers across the key loop and is written once, as bf16
//   times the scale: no atomics, no partials.  The consumers take 240
//   registers (setmaxnreg), the producer 24.  A warpgroup skips a key tile
//   that none of its rows attends.
//   Head dim 256 (Gemma's; bf16/f16, routed here by ops/flash_attention.py
//   wide_kernel) changes two choices.  Q and dO as register fragments
//   would be 128 registers a thread beside dQ's 128 f32 accumulators, over
//   the 240 a consumer has, so S and dP read Q and dO from shared memory
//   (SS, K-major; RS is off, as at d = 64).  Two Q/dO slots would be 256
//   KB, so there is one (128 KB: the next tile's Q/dO load waits for this
//   tile's last S and dP) and a three-stage ring of 32-key K/V tiles (96
//   KB): S and dP are m64n32k16 chains of 16 k16 steps, dQ += dS K one
//   m64n256k16 product a k16 step (hopper_tiles.cuh wgmma_rs_n256), and the
//   work list is fwd_schedule's at keys=32 (ops/flash_attention.py
//   dq_tile).
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
//   - Head dim 256 (Gemma's; bf16/f16, routed here by ops/flash_attention.py
//     wide_kernel).  dK and dV of 64 keys would be 256 f32 accumulators a
//     thread, over the 240 a consumer has, and the 128-key K/V slots alone
//     256 KB.  So the two consumers split the work by product instead of
//     by keys: an item is 64 keys (dkv_tile), which both take; warpgroup 0
//     runs S^T = K Q^T, forms P^T and owns dV += P^T dO, warpgroup 1 runs
//     dP^T = V dO^T and owns dK += dS^T Q (128 accumulators each, one
//     m64n256k16 product a k16 step), and P^T passes from 0 to 1 through
//     shared memory (f32, two 16 KB buffers on named barriers), so nothing
//     is computed twice.  One K/V slot (64 KB) and a two-stage ring of
//     64-query Q/dO tiles (128 KB) fit beside it.
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
// (TMA's out-of-bounds fill) and are masked.  GQA: query head i reads kv head i / (h/g).

#include <math_constants.h>

#include "hopper_tiles.cuh"

namespace {

using namespace hopper;

constexpr float LOG2E = 1.4426950408889634f;

// ---- flash_bwd_dq ----------------------------------------------------------

constexpr int DQ_BQ = 128;       // query rows per tile: two consumer warpgroups of 64
constexpr int DQ_STAGES = 3;
constexpr int DQ_THREADS = 384;
constexpr int DQ_TURN = 1;       // named barriers 1, 2: consumer w's turn to start products

// Up to d = 128: Q and dO in two slots (the next tile's load while this
// one runs) and a three-stage ring of 64-key K/V tiles, 225 KB at d = 128.
// At d = 256 two slots alone would be 256 KB: one Q/dO slot (128 KB) and
// a three-stage ring of 32-key K/V tiles (96 KB), 225 KB again.
template <int D>
struct DqSmem {
  static constexpr int BK = D == 256 ? 32 : 64;    // keys per K/V tile
  static constexpr int SLOTS = D == 256 ? 1 : 2;   // Q/dO slots
  static constexpr int Q_TILE = DQ_BQ * D * 2;     // bytes of Q (or dO)
  static constexpr int KV_TILE = BK * D * 2;       // bytes of K (or V)
  static constexpr int Q = 0;                      // [slot][Q_TILE]
  static constexpr int DO = SLOTS * Q_TILE;
  static constexpr int K = 2 * SLOTS * Q_TILE;     // [stage][KV_TILE]
  static constexpr int V = K + DQ_STAGES * KV_TILE;
  static constexpr int BAR = V + DQ_STAGES * KV_TILE;
  // q_full[SLOTS], q_empty[SLOTS], kv_full[S], kv_empty[S]
  static constexpr int BYTES = BAR + (2 * SLOTS + 2 * DQ_STAGES) * 8;
  static constexpr int ALLOC = BYTES + 1024;       // room to align the base
};

template <int D, typename E>
__global__ void __launch_bounds__(DQ_THREADS, 1)
flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap tq,
                    const __grid_constant__ CUtensorMap tdo,
                    const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv, const float* __restrict__ lse,
                    const float* __restrict__ delta, const int* __restrict__ plan,
                    E* __restrict__ dq, int b, int s, int sk, int h, int g, float scale,
                    int causal, int window) {
  typedef DqSmem<D> L;
  constexpr int NB = D / 64;         // 64-column blocks of a row
  constexpr int BK = L::BK, SLOTS = L::SLOTS;
  // One 128-row query tile of a dQ launch: tile i is query tile
  // nqt-1-i/bhn of head i%bhn (ops/flash_attention.py fwd_schedule with
  // dq_tile(d)).  Its live key tiles are jt0 .. jt0+n-1 (n = 0: a windowed
  // tile past the keys, dQ = 0).
  typedef QueryTile<DQ_BQ, BK> DqTile;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = align1024(smem_raw);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(sm + L::BAR);   // [slot]
  uint64_t* q_empty = q_full + SLOTS;
  uint64_t* kv_full = q_empty + SLOTS;
  uint64_t* kv_empty = kv_full + DQ_STAGES;
  const int bhn = b * h, nqt = (s + DQ_BQ - 1) / DQ_BQ;
  const int first = plan[blockIdx.x], last = plan[blockIdx.x + 1];
  const int* tiles = plan + gridDim.x + 1;
  const int tid = threadIdx.x, wg = tid >> 7, lane = tid & 31;

  if (tid == 0) {
    for (int i = 0; i < SLOTS; ++i) {
      mbar_init(&q_full[i], 1);
      mbar_init(&q_empty[i], 8);     // one arrival per consumer warp
    }
    for (int i = 0; i < DQ_STAGES; ++i) {
      mbar_init(&kv_full[i], 1);
      mbar_init(&kv_empty[i], 8);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 2) {
    // Producer: one thread.  Per tile it TMA-loads Q and dO into the
    // tile's slot (freed SLOTS tiles earlier), then keeps the K/V ring
    // running over the tile's live key tiles, across tiles.
    reg_dealloc<24>();
    if (tid != 2 * 128) return;
    int it = 0;
    for (int x = first; x < last; ++x) {
      const DqTile t(tiles[x], bhn, nqt, h, g, s, sk, causal, window);
      const int xi = x - first, slot = xi % SLOTS;
      mbar_wait(&q_empty[slot], ((xi / SLOTS) & 1) ^ 1);
      mbar_arrive_tx(&q_full[slot], 2 * L::Q_TILE);
      for (int c = 0; c < NB; ++c) {
        const int off = slot * L::Q_TILE + c * DQ_BQ * 128;
        tma_load_4d(sm + L::Q + off, &tq, &q_full[slot], c * 64, t.hi, t.q0, t.bi);
        tma_load_4d(sm + L::DO + off, &tdo, &q_full[slot], c * 64, t.hi, t.q0, t.bi);
      }
      for (int j = 0; j < t.n; ++j) {
        const int cur = it + j, st = cur % DQ_STAGES;
        const int k0 = (t.jt0 + j) * BK;
        mbar_wait(&kv_empty[st], ((cur / DQ_STAGES) & 1) ^ 1);
        mbar_arrive_tx(&kv_full[st], 2 * L::KV_TILE);
        for (int c = 0; c < NB; ++c) {
          const int off = st * L::KV_TILE + c * BK * 128;
          tma_load_4d(sm + L::K + off, &tk, &kv_full[st], c * 64, t.kvh, k0, t.bi);
          tma_load_4d(sm + L::V + off, &tv, &kv_full[st], c * 64, t.kvh, k0, t.bi);
        }
      }
      it += t.n;
    }
    return;
  }

  // Consumers: warpgroup w owns query rows q0 + 64w .. +63 of each tile.
  reg_alloc<240>();
  const int w = wg, warp = (tid >> 5) & 3;
  const int rq = lane >> 2, cq = (lane & 3) * 2;
  const float sl2 = scale * LOG2E;
  const uint32_t base = smem_u32(sm);
  const size_t qstride = size_t(h) * D;
  // Ping-pong: the two consumers take turns to start S and dP (one turn per
  // key tile, dead tiles included, so both take the same number), so one
  // warpgroup's exponentials run while the other's products hold the
  // tensor cores.  Warpgroup 1 gives warpgroup 0 its first turn and arrives
  // after every turn but its last of the launch.
  const int me = DQ_TURN + w, other = DQ_TURN + (w ^ 1);
  if (w == 1) bar_arrive(DQ_TURN, 256);
  int it = 0;
  for (int x = first; x < last; ++x) {
    const DqTile t(tiles[x], bhn, nqt, h, g, s, sk, causal, window);
    const int xi = x - first, slot = xi % SLOTS;
    const int qw0 = t.q0 + 64 * w;
    const int qpos0 = qw0 + warp * 16 + rq;
    // This thread's two rows of lse (log2 units) and delta, read while the
    // tile's Q/dO arrive.
    const float* lrow = lse + (size_t(t.bi) * h + t.hi) * s;
    const float* drow = delta + (size_t(t.bi) * h + t.hi) * s;
    const float lse0 = qpos0 < s ? lrow[qpos0] * LOG2E : 0.f;
    const float lse1 = qpos0 + 8 < s ? lrow[qpos0 + 8] * LOG2E : 0.f;
    const float dl0 = qpos0 < s ? drow[qpos0] : 0.f;
    const float dl1 = qpos0 + 8 < s ? drow[qpos0 + 8] : 0.f;
    mbar_wait(&q_full[slot], (xi / SLOTS) & 1);
    // At d = 128, this warp's 16 rows of Q and dO as A fragments of every
    // k16 step, read once per tile through the swizzle; S and dP then read
    // only K and V from shared memory, and the slot goes back to the
    // producer at once.  (At d = 64 the same fragments gave wrong dQ on the
    // H100, not understood yet; d = 64 reads Q and dO from shared memory.
    // At d = 256 they would be 128 registers a thread beside dQ's 128
    // accumulators, over the 240 a consumer has: read from shared memory.)
    constexpr bool RS = D == 128;
    const uint32_t qa = base + L::Q + slot * L::Q_TILE + w * 64 * 128;
    const uint32_t oa = base + L::DO + slot * L::Q_TILE + w * 64 * 128;
    uint32_t qf[D / 16][4], of[D / 16][4];
    if constexpr (RS) {
      const int li = lane >> 3, lr = lane & 7;
      const int row = w * 64 + warp * 16 + (li & 1) * 8 + lr;   // of the 128-row tile
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t o = (kk / 4) * DQ_BQ * 128 +
                           swizzle<7>(row * 128 + ((kk % 4) * 16 + (li >> 1) * 8) * 2);
        ldmatrix_x4(qf[kk], base + L::Q + slot * L::Q_TILE + o);
        ldmatrix_x4(of[kk], base + L::DO + slot * L::Q_TILE + o);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&q_empty[slot]);
    }
    float dqa[D / 2];
#pragma unroll
    for (int n = 0; n < D / 2; ++n) dqa[n] = 0.f;
    for (int j = 0; j < t.n; ++j) {
      const int cur = it + j, st = cur % DQ_STAGES;
      const int k0 = (t.jt0 + j) * BK;
      mbar_wait(&kv_full[st], (cur / DQ_STAGES) & 1);
      const bool dead = qw0 >= s || (causal && (k0 > qw0 + 63 ||
                                               (window > 0 && qw0 - (k0 + BK - 1) >= window)));
      const bool edge = k0 + BK > sk || qw0 + 64 > s ||
                        (causal && (k0 + BK - 1 > qw0 || (window > 0 && qw0 + 63 - k0 >= window)));
      const uint32_t ka = base + L::K + st * L::KV_TILE;
      const uint32_t va = base + L::V + st * L::KV_TILE;
      uint32_t dsa[BK / 16][4];
      const bool pass = w == 0 || x + 1 < last || j + 1 < t.n;   // arrive after this turn
      bar_sync(me, 256);
      if (!dead) {
        // S = Q K^T and dP = dO V^T: [64 rows x BK keys] each.
        float sc[BK / 2], dp[BK / 2];
        fence_regs(sc);
        fence_regs(dp);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const uint32_t off = (kk % 4) * 32u;
          if constexpr (RS)
            wgmma_rs<BK, 0, E>(sc, qf[kk], desc_k(ka + (kk / 4) * BK * 128 + off), kk > 0);
          else
            wgmma_ss<BK, 0, E>(sc, desc_k(qa + (kk / 4) * DQ_BQ * 128 + off),
                            desc_k(ka + (kk / 4) * BK * 128 + off), kk > 0);
        }
        wgmma_commit();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const uint32_t off = (kk % 4) * 32u;
          if constexpr (RS)
            wgmma_rs<BK, 0, E>(dp, of[kk], desc_k(va + (kk / 4) * BK * 128 + off), kk > 0);
          else
            wgmma_ss<BK, 0, E>(dp, desc_k(oa + (kk / 4) * DQ_BQ * 128 + off),
                            desc_k(va + (kk / 4) * BK * 128 + off), kk > 0);
        }
        wgmma_commit();
        if (pass) bar_arrive(other, 256);

        // P = exp2(S * scale * log2e - lse) while dP finishes; masked
        // pairs (only on tiles that straddle an edge) get p = 0.
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
        for (int t8 = 0; t8 < BK / 8; ++t8)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            sc[4 * t8 + e] = exp2_fast(fmaf(sc[4 * t8 + e], sl2, e < 2 ? -lse0 : -lse1));
        // dS = P * (dP - delta), packed as A fragments.
        wgmma_wait<0>();
        fence_regs(dp);
#pragma unroll
        for (int t8 = 0; t8 < BK / 8; ++t8) {
          float ds[4];
#pragma unroll
          for (int e = 0; e < 4; ++e)
            ds[e] = sc[4 * t8 + e] * (dp[4 * t8 + e] - (e < 2 ? dl0 : dl1));
          dsa[t8 >> 1][(t8 & 1) * 2] = pack2<E>(ds[0], ds[1]);
          dsa[t8 >> 1][(t8 & 1) * 2 + 1] = pack2<E>(ds[2], ds[3]);
        }
      } else if (pass) {
        bar_arrive(other, 256);
      }
      if constexpr (!RS) {
        __syncwarp();
        if (j + 1 == t.n && lane == 0) mbar_arrive(&q_empty[slot]);   // the tile's last Q/dO read
      }
      if (!dead) {
        // dQ += dS K (K as [keys, d]: MN-major, the transpose bit; at d = 256
        // one m64n256k16 product a k16 step).
        fence_regs(dqa);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk)
          wgmma_rs<D, 1, E>(dqa, dsa[kk], desc_mn(ka + kk * 2048, BK * 128), 1);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(dqa);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&kv_empty[st]);
    }
    it += t.n;
    if constexpr (!RS) {
      __syncwarp();
      if (t.n == 0 && lane == 0) mbar_arrive(&q_empty[slot]);
    }

#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int qpos = qpos0 + 8 * rr;
      if (qpos >= s) continue;
      E* dst = dq + (size_t(t.bi) * s + qpos) * qstride + size_t(t.hi) * D + cq;
#pragma unroll
      for (int c = 0; c < D / 8; ++c)
        store2<E>(dst + c * 8, dqa[4 * c + 2 * rr] * scale, dqa[4 * c + 2 * rr + 1] * scale);
    }
  }
}

template <int D, typename E>
int launch_dq(const void* q, const void* k, const void* v, const void* dout, const void* lse,
              const void* delta, void* dq, const int* plan, int nblocks, int b, int s, int sk,
              int h, int g, float scale, int causal, int window, cudaStream_t stream) {
  CUtensorMap tq, tdo, tk, tv;
  int e;
  constexpr int BK = DqSmem<D>::BK;
  if ((e = make_map<E>(&tq, q, D, h, s, b, DQ_BQ)) ||
      (e = make_map<E>(&tdo, dout, D, h, s, b, DQ_BQ)) ||
      (e = make_map<E>(&tk, k, D, g, sk, b, BK)) || (e = make_map<E>(&tv, v, D, g, sk, b, BK)))
    return e;
  const int bytes = DqSmem<D>::ALLOC;
  cudaError_t ce = cudaFuncSetAttribute(flash_bwd_dq_kernel<D, E>,
                                        cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (ce != cudaSuccess) return int(ce);
  flash_bwd_dq_kernel<D, E><<<nblocks, DQ_THREADS, bytes, stream>>>(
      tq, tdo, tk, tv, static_cast<const float*>(lse), static_cast<const float*>(delta), plan,
      static_cast<E*>(dq), b, s, sk, h, g, scale, causal, window);
  return int(cudaGetLastError());
}

// ---- flash_bwd_dkv ---------------------------------------------------------

constexpr int KV_BQ = 64;        // queries per Q/dO tile
constexpr int KV_THREADS = 384;
constexpr int PX_FULL = 1;       // named barriers 1, 2: a P^T buffer written (d = 256)
constexpr int PX_EMPTY = 3;      // named barriers 3, 4: a P^T buffer read
// An item: batch, kv head, key tile, first live query tile, live query
// tiles per head, iterations [it0, it1) of the loop over (query head,
// query tile), scratch slot (-1: write bf16 directly).
constexpr int ITEM_INTS = 8;

// Up to d = 128: an item is 128 keys, 64 per consumer warpgroup, each
// holding dK and dV for its keys; K and V have two slots each (consecutive
// items alternate), so the next item's K/V and first Q tiles load while
// the current item finishes, and Q/dO run in a three-stage ring.  At d =
// 128 the layout takes 232016 of the 232448 bytes a block may have.
// At d = 256 (SPLIT) dK and dV of 64 keys would be 256 accumulators a
// thread, over the 240 a consumer has, and two 128-key K/V slots alone
// 256 KB: an item is 64 keys that both warpgroups take, warpgroup 0
// forming P^T and owning dV, warpgroup 1 forming dS^T and owning dK (128
// accumulators each), with P^T passed through shared memory (two f32
// buffers); one K/V slot (64 KB) and a two-stage Q/dO ring (128 KB):
// 231472 bytes.
template <int D>
struct DkvSmem {
  static constexpr bool SPLIT = D == 256;
  static constexpr int BK = SPLIT ? 64 : 128;         // keys per item
  static constexpr int KV_SLOTS = SPLIT ? 1 : 2;
  static constexpr int STAGES = SPLIT ? 2 : 3;        // Q/dO ring
  static constexpr int KV_TILE = BK * D * 2;          // bytes of K (or V)
  static constexpr int Q_TILE = KV_BQ * D * 2;        // bytes of a Q (or dO) tile
  static constexpr int K = 0;                         // [slot][KV_TILE]
  static constexpr int V = KV_SLOTS * KV_TILE;
  static constexpr int Q = 2 * KV_SLOTS * KV_TILE;    // [stage][Q_TILE]
  static constexpr int DO = Q + STAGES * Q_TILE;
  static constexpr int PX = DO + STAGES * Q_TILE;     // f32 [2][KV_BQ / 8][128] float4
  static constexpr int PX_BUF = 128 * KV_BQ / 2 * 4;  // bytes of one P^T buffer
  static constexpr int LSE = PX + (SPLIT ? 2 * PX_BUF : 0);   // [stage][KV_BQ] f32
  static constexpr int DELTA = LSE + STAGES * KV_BQ * 4;
  static constexpr int BAR = DELTA + STAGES * KV_BQ * 4;
  // full[S], empty[S], kv_full[slots], kv_empty[slots]
  static constexpr int BYTES = BAR + (2 * STAGES + 2 * KV_SLOTS) * 8;
  static constexpr int ALLOC = BYTES + 1024;  // room to align the base
  static_assert(ALLOC <= 232448, "a block's shared memory");
};

template <int D, typename E>
__global__ void __launch_bounds__(KV_THREADS, 1)
flash_bwd_dkv_kernel(const __grid_constant__ CUtensorMap tq,
                     const __grid_constant__ CUtensorMap tdo,
                     const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv, const float* __restrict__ lse,
                     const float* __restrict__ delta, const int* __restrict__ items,
                     const int* __restrict__ offsets, float* __restrict__ partial,
                     E* __restrict__ dk, E* __restrict__ dv, int s, int sk, int h, int g,
                     float scale, int causal, int window) {
  typedef DkvSmem<D> L;
  constexpr int NB = D / 64;         // 64-column blocks of a row
  constexpr int BK = L::BK, STAGES = L::STAGES, SLOTS = L::KV_SLOTS;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + L::BAR);
  uint64_t* empty = full + STAGES;
  uint64_t* kv_full = empty + STAGES;   // [slot]
  uint64_t* kv_empty = kv_full + SLOTS;
  float* s_lse = reinterpret_cast<float*>(sm + L::LSE);
  float* s_delta = reinterpret_cast<float*>(sm + L::DELTA);
  const int tid = threadIdx.x, wg = tid >> 7, lane = tid & 31;
  const int first = offsets[blockIdx.x], last = offsets[blockIdx.x + 1];
  const int r = h / g;

  if (tid == 0) {
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(&full[i], 32);       // the producer warp's lanes, lane 0 with the bytes
      mbar_init(&empty[i], 8);       // one arrival per consumer warp
    }
    for (int i = 0; i < SLOTS; ++i) {
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
      const int slot = (i - first) % SLOTS;
      auto load_kv = [&]() {
        mbar_wait(&kv_empty[slot], (((i - first) / SLOTS) & 1) ^ 1);
        if (lane == 0) {
          uint64_t* bar = &kv_full[slot];
          mbar_arrive_tx(bar, 2 * L::KV_TILE);
          for (int c = 0; c < NB; ++c) {
            const int off = slot * L::KV_TILE + c * BK * 128;
            tma_load_4d(sm + L::K + off, &tk, bar, c * 64, kvh, kt * BK, bi);
            tma_load_4d(sm + L::V + off, &tv, bar, c * 64, kvh, kt * BK, bi);
          }
        }
      };
      // With one K/V slot (d = 256) a later item's K/V waits until the
      // last item is done with the slot: its first Q/dO tiles go ahead.
      const int kv_at = SLOTS > 1 || i == first ? -1 : min(it[5] + STAGES, it[6]) - 1;
      if (kv_at < 0) load_kv();
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
        if (++stage == STAGES) {
          stage = 0;
          phase ^= 1;
        }
        if (t == kv_at) load_kv();
      }
    }
    return;
  }

  reg_alloc<240>();
  const int w = wg, warp = (tid >> 5) & 3;
  const int rq = lane >> 2, cq = (lane & 3) * 2;
  const float sl2 = scale * LOG2E;
  const uint32_t base = smem_u32(sm);
  int stage = 0;
  uint32_t phase = 0;

  if constexpr (L::SPLIT) {
    // Both warpgroups take the item's 64 keys.  Warpgroup 0: S^T = K Q^T,
    // P^T, dV += P^T dO; warpgroup 1: dP^T = V dO^T, dS^T = P^T * (dP^T -
    // delta) with P^T read from warpgroup 0's buffer (the same register
    // layout: thread t reads what thread t wrote), dK += dS^T Q.  The
    // buffers alternate; warpgroup 0 waits until a buffer has been read
    // before writing it again (warpgroup 1 frees both at the start, and
    // warpgroup 0 takes those two frees back at the end, so every named
    // barrier completes as often as it is begun).
    const int t = tid & 127;
    float4* px = reinterpret_cast<float4*>(sm + L::PX);
    if (w == 1) {
      bar_arrive(PX_EMPTY, 256);
      bar_arrive(PX_EMPTY + 1, 256);
    }
    int nx = 0;   // P^T exchanges so far
    for (int i = first; i < last; ++i) {
      const int* it = items + ITEM_INTS * i;
      const int bi = it[0], kvh = it[1], kt = it[2], jq0 = it[3], ntile = it[4];
      const int slot = it[7];
      const int k0 = kt * BK;
      const int kpos0 = k0 + warp * 16 + rq, kpos1 = kpos0 + 8;
      // The product's A operand: K (S^T) or V (dP^T).
      const uint32_t ka = base + (w == 0 ? L::K : L::V);
      float acc[D / 2];   // dV (warpgroup 0) or dK (warpgroup 1): [64 keys x d]
#pragma unroll
      for (int n = 0; n < D / 2; ++n) acc[n] = 0.f;
      mbar_wait(&kv_full[0], (i - first) & 1);

      for (int tt = it[5]; tt < it[6]; ++tt) {
        const int q0 = (jq0 + tt % ntile) * KV_BQ;
        mbar_wait(&full[stage], phase);
        const bool dead = k0 >= sk || (causal && (q0 + KV_BQ - 1 < k0 ||
                                                  (window > 0 && q0 - (k0 + 63) >= window)));
        if (!dead) {
          const bool edge = q0 + KV_BQ > s || k0 + 64 > sk ||
                            (causal && (k0 + 63 > q0 ||
                                        (window > 0 && q0 + KV_BQ - 1 - k0 >= window)));
          const uint32_t qa = base + L::Q + stage * L::Q_TILE;
          const uint32_t oa = base + L::DO + stage * L::Q_TILE;
          // S^T = K Q^T (warpgroup 0) or dP^T = V dO^T (1): [64 keys x 64 queries].
          const uint32_t ba = w == 0 ? qa : oa;
          float st[KV_BQ / 2];
          fence_regs(st);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < D / 16; ++kk) {
            const uint32_t off = (kk / 4) * BK * 128 + (kk % 4) * 32;
            wgmma_ss<KV_BQ, 0, E>(st, desc_k(ka + off),
                               desc_k(ba + (kk / 4) * KV_BQ * 128 + (kk % 4) * 32), kk > 0);
          }
          wgmma_commit();
          wgmma_wait<0>();
          fence_regs(st);
          const int buf = nx & 1;
          float4* xb = px + buf * (KV_BQ / 8) * 128;
          uint32_t fa[KV_BQ / 16][4];   // P^T or dS^T as A fragments
          if (w == 0) {
            // P^T = exp2(S^T * scale * log2e - lse[q]); masked pairs (only
            // on tiles that straddle an edge) get p = 0.
            const float* sl = s_lse + stage * KV_BQ;
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
            bar_sync(PX_EMPTY + buf, 256);
#pragma unroll
            for (int t8 = 0; t8 < KV_BQ / 8; ++t8)
              xb[t8 * 128 + t] = make_float4(st[4 * t8], st[4 * t8 + 1], st[4 * t8 + 2],
                                             st[4 * t8 + 3]);
            bar_arrive(PX_FULL + buf, 256);
#pragma unroll
            for (int t8 = 0; t8 < KV_BQ / 8; ++t8) {
              fa[t8 >> 1][(t8 & 1) * 2] = pack2<E>(st[4 * t8], st[4 * t8 + 1]);
              fa[t8 >> 1][(t8 & 1) * 2 + 1] = pack2<E>(st[4 * t8 + 2], st[4 * t8 + 3]);
            }
          } else {
            // dS^T = P^T * (dP^T - delta[q]).
            const float* sd = s_delta + stage * KV_BQ;
            bar_sync(PX_FULL + buf, 256);
#pragma unroll
            for (int t8 = 0; t8 < KV_BQ / 8; ++t8) {
              const float4 p = xb[t8 * 128 + t];
              const float2 dl = *reinterpret_cast<const float2*>(sd + t8 * 8 + cq);
              fa[t8 >> 1][(t8 & 1) * 2] =
                  pack2<E>(p.x * (st[4 * t8] - dl.x), p.y * (st[4 * t8 + 1] - dl.y));
              fa[t8 >> 1][(t8 & 1) * 2 + 1] =
                  pack2<E>(p.z * (st[4 * t8 + 2] - dl.x), p.w * (st[4 * t8 + 3] - dl.y));
            }
            bar_arrive(PX_EMPTY + buf, 256);
          }
          ++nx;
          // dV += P^T dO or dK += dS^T Q (dO, Q as [queries, d]: MN-major;
          // one m64n256k16 product a k16 step).
          const uint32_t ma = w == 0 ? oa : qa;
          fence_regs(acc);
          wgmma_fence();
#pragma unroll
          for (int kq = 0; kq < KV_BQ / 16; ++kq)
            wgmma_rs<D, 1, E>(acc, fa[kq], desc_mn(ma + kq * 2048, KV_BQ * 128), 1);
          wgmma_commit();
          wgmma_wait<0>();
          fence_regs(acc);
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[stage]);
        if (++stage == STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&kv_empty[0]);

      const float f = w == 0 ? 1.f : scale;
      if (slot < 0) {
        E* out = w == 0 ? dv : dk;
        const size_t kstride = size_t(g) * D;
        const size_t col = size_t(kvh) * D + cq;
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          const int kpos = rr ? kpos1 : kpos0;
          if (kpos >= sk) continue;
          E* dst = out + (size_t(bi) * sk + kpos) * kstride + col;
#pragma unroll
          for (int t8 = 0; t8 < D / 8; ++t8)
            store2<E>(dst + t8 * 8, acc[4 * t8 + 2 * rr] * f, acc[4 * t8 + 2 * rr + 1] * f);
        }
      } else {
        // Slot layout: [2 (dK, dV)][D/8 float4 columns][128 threads].
        float4* pp = reinterpret_cast<float4*>(partial + size_t(slot) * 2 * BK * D) +
                     (w == 0 ? D / 8 : 0) * 128;
#pragma unroll
        for (int c = 0; c < D / 8; ++c)
          pp[c * 128 + t] = make_float4(acc[4 * c], acc[4 * c + 1], acc[4 * c + 2], acc[4 * c + 3]);
      }
    }
    if (w == 0) {
      bar_sync(PX_EMPTY + (nx & 1), 256);
      bar_sync(PX_EMPTY + ((nx + 1) & 1), 256);
    }
    return;
  } else {
    // Consumers: warpgroup w owns keys kt*128 + 64w .. +63 of each item.
    for (int i = first; i < last; ++i) {
      const int* it = items + ITEM_INTS * i;
      const int bi = it[0], kvh = it[1], kt = it[2], jq0 = it[3], ntile = it[4];
      const int slot = it[7];
      const int kw0 = kt * BK + 64 * w;
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
            const uint32_t off = (kk / 4) * BK * 128 + (kk % 4) * 32;
            wgmma_ss<KV_BQ, 0, E>(st, desc_k(ka + off),
                               desc_k(qa + (kk / 4) * KV_BQ * 128 + (kk % 4) * 32), kk > 0);
          }
          wgmma_commit();
#pragma unroll
          for (int kk = 0; kk < D / 16; ++kk) {
            const uint32_t off = (kk / 4) * BK * 128 + (kk % 4) * 32;
            wgmma_ss<KV_BQ, 0, E>(dpt, desc_k(va + off),
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
            pa[t8 >> 1][(t8 & 1) * 2] = pack2<E>(st[4 * t8], st[4 * t8 + 1]);
            pa[t8 >> 1][(t8 & 1) * 2 + 1] = pack2<E>(st[4 * t8 + 2], st[4 * t8 + 3]);
            dsa[t8 >> 1][(t8 & 1) * 2] = pack2<E>(ds[0], ds[1]);
            dsa[t8 >> 1][(t8 & 1) * 2 + 1] = pack2<E>(ds[2], ds[3]);
          }

          // dV += P^T dO and dK += dS^T Q (dO, Q as [queries, d]: MN-major).
          fence_regs(dva);
          fence_regs(dka);
          wgmma_fence();
#pragma unroll
          for (int kq = 0; kq < KV_BQ / 16; ++kq)
            wgmma_rs<D, 1, E>(dva, pa[kq], desc_mn(oa + kq * 2048, KV_BQ * 128), 1);
#pragma unroll
          for (int kq = 0; kq < KV_BQ / 16; ++kq)
            wgmma_rs<D, 1, E>(dka, dsa[kq], desc_mn(qa + kq * 2048, KV_BQ * 128), 1);
          wgmma_commit();
          wgmma_wait<0>();
          fence_regs(dva);
          fence_regs(dka);
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[stage]);
        if (++stage == STAGES) {
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
            store2<E>(dk + off + t8 * 8, dka[4 * t8] * scale, dka[4 * t8 + 1] * scale);
            store2<E>(dv + off + t8 * 8, dva[4 * t8], dva[4 * t8 + 1]);
          }
        }
        if (kpos1 < sk) {
          const size_t off = (size_t(bi) * sk + kpos1) * kstride + col;
#pragma unroll
          for (int t8 = 0; t8 < D / 8; ++t8) {
            store2<E>(dk + off + t8 * 8, dka[4 * t8 + 2] * scale, dka[4 * t8 + 3] * scale);
            store2<E>(dv + off + t8 * 8, dva[4 * t8 + 2], dva[4 * t8 + 3]);
          }
        }
      } else {
        // Slot layout: [2 (dK, dV)][D/8 float4 columns][256 consumer threads].
        float4* pp = reinterpret_cast<float4*>(partial + size_t(slot) * 2 * BK * D);
#pragma unroll
        for (int c = 0; c < D / 8; ++c) {
          pp[c * 256 + tid] =
              make_float4(dka[4 * c], dka[4 * c + 1], dka[4 * c + 2], dka[4 * c + 3]);
          pp[(D / 8 + c) * 256 + tid] =
              make_float4(dva[4 * c], dva[4 * c + 1], dva[4 * c + 2], dva[4 * c + 3]);
        }
      }
    }
  }
}

// One block per (batch, kv head, key tile) and float4 column j of the slot
// layout (j < D/8: dK columns 8j .. 8j+7 of the thread's two rows, else
// dV's): adds the tile's `count` slots from `first` in item order (count
// 0: no query attends the tile, write zeros; count < 0: an item wrote it
// directly).  Threads map to rows as the consumers' accumulators do: 2 *
// BK of them, 128 for each 64 keys (d = 256: one warpgroup's layout, which
// dK and dV share).
template <int D, typename E>
__global__ void __launch_bounds__(256)
flash_bwd_dkv_sum_kernel(const float* __restrict__ partial, const int* __restrict__ combos,
                         E* __restrict__ dk, E* __restrict__ dv, int sk, int g, int nkt,
                         float scale) {
  constexpr int BK = DkvSmem<D>::BK, T = 2 * BK;
  const int c = blockIdx.x, j = blockIdx.y, first = combos[2 * c], count = combos[2 * c + 1];
  if (count < 0) return;
  const int tid = threadIdx.x;
  float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int n = 0; n < count; ++n) {
    const float4 x =
        reinterpret_cast<const float4*>(partial + size_t(first + n) * T * D)[j * T + tid];
    a.x += x.x;
    a.y += x.y;
    a.z += x.z;
    a.w += x.w;
  }
  const bool is_v = j >= D / 8;
  E* out = is_v ? dv : dk;
  const float f = is_v ? 1.f : scale;
  const int kt = c % nkt, kvh = (c / nkt) % g, bi = c / nkt / g;
  const int w = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int kpos0 = kt * BK + 64 * w + warp * 16 + (lane >> 2), kpos1 = kpos0 + 8;
  const size_t kstride = size_t(g) * D;
  const size_t col = size_t(kvh) * D + (is_v ? j - D / 8 : j) * 8 + (lane & 3) * 2;
  if (kpos0 < sk) store2<E>(out + (size_t(bi) * sk + kpos0) * kstride + col, a.x * f, a.y * f);
  if (kpos1 < sk) store2<E>(out + (size_t(bi) * sk + kpos1) * kstride + col, a.z * f, a.w * f);
}

template <int D, typename E>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout, const void* lse,
               const void* delta, void* dk, void* dv, const int* items, const int* offsets,
               const int* combos, float* partial, int nblocks, int sum, int b, int s, int sk,
               int h, int g, float scale, int causal, int window, cudaStream_t stream) {
  constexpr int BK = DkvSmem<D>::BK;
  if (nblocks > 0) {
    CUtensorMap tq, tdo, tk, tv;
    int e;
    if ((e = make_map<E>(&tq, q, D, h, s, b, KV_BQ)) ||
        (e = make_map<E>(&tdo, dout, D, h, s, b, KV_BQ)) ||
        (e = make_map<E>(&tk, k, D, g, sk, b, BK)) ||
        (e = make_map<E>(&tv, v, D, g, sk, b, BK)))
      return e;
    const int bytes = DkvSmem<D>::ALLOC;
    cudaError_t ce = cudaFuncSetAttribute(flash_bwd_dkv_kernel<D, E>,
                                          cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (ce != cudaSuccess) return int(ce);
    flash_bwd_dkv_kernel<D, E><<<nblocks, KV_THREADS, bytes, stream>>>(
        tq, tdo, tk, tv, static_cast<const float*>(lse), static_cast<const float*>(delta), items,
        offsets, partial, static_cast<E*>(dk), static_cast<E*>(dv), s, sk, h, g, scale,
        causal, window);
    ce = cudaGetLastError();
    if (ce != cudaSuccess) return int(ce);
  }
  if (!sum) return 0;   // every key tile written by its one item
  const int nkt = (sk + BK - 1) / BK;
  flash_bwd_dkv_sum_kernel<D, E><<<dim3(b * g * nkt, D / 4), 2 * BK, 0, stream>>>(
      partial, combos, static_cast<E*>(dk), static_cast<E*>(dv), sk, g, nkt, scale);
  return int(cudaGetLastError());
}

template <typename E>
int dq_entry(const void* q, const void* k, const void* v, const void* dout, const void* lse,
             const void* delta, void* dq, const void* plan, int nblocks, int b, int s, int sk,
             int h, int g, int d, float scale, int causal, int window, void* stream) {
  if (s == 0 || b == 0) return 0;
  if (sk == 0 || g <= 0 || h % g != 0 || nblocks <= 0) return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* pl = static_cast<const int*>(plan);
  if (d == 128)
    return launch_dq<128, E>(q, k, v, dout, lse, delta, dq, pl, nblocks, b, s, sk, h, g, scale,
                             causal, window, st);
  if (d == 64)
    return launch_dq<64, E>(q, k, v, dout, lse, delta, dq, pl, nblocks, b, s, sk, h, g, scale,
                            causal, window, st);
  if (d == 256)
    return launch_dq<256, E>(q, k, v, dout, lse, delta, dq, pl, nblocks, b, s, sk, h, g, scale,
                             causal, window, st);
  return int(cudaErrorInvalidValue);
}

template <typename E>
int dkv_entry(const void* q, const void* k, const void* v, const void* dout, const void* lse,
              const void* delta, void* dk, void* dv, const void* items, const void* offsets,
              const void* combos, void* partial, int nblocks, int sum, int b, int s, int sk,
              int h, int g, int d, float scale, int causal, int window, void* stream) {
  if (sk == 0 || b == 0) return 0;
  if (g <= 0 || h % g != 0) return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* it = static_cast<const int*>(items);
  const int* of = static_cast<const int*>(offsets);
  const int* co = static_cast<const int*>(combos);
  float* pp = static_cast<float*>(partial);
  if (d == 128)
    return launch_dkv<128, E>(q, k, v, dout, lse, delta, dk, dv, it, of, co, pp, nblocks, sum,
                              b, s, sk, h, g, scale, causal, window, st);
  if (d == 64)
    return launch_dkv<64, E>(q, k, v, dout, lse, delta, dk, dv, it, of, co, pp, nblocks, sum,
                             b, s, sk, h, g, scale, causal, window, st);
  if (d == 256)
    return launch_dkv<256, E>(q, k, v, dout, lse, delta, dk, dv, it, of, co, pp, nblocks, sum,
                              b, s, sk, h, g, scale, causal, window, st);
  return int(cudaErrorInvalidValue);
}

}  // namespace

// q, dout, dq [b, s, h, d]; k, v [b, sk, g, d] bf16 contiguous (16-byte
// aligned); lse, delta [b*h, s] f32 (lse in scaled-score units, as
// flash_fwd writes it; delta = rowsum(dO * O)).  dq = dS K * scale.
// window <= 0 means none; d = 64, 128 or 256.  `plan` int32: the work
// list of ops/flash_attention.py fwd_schedule at dq_tile(d) (rows=128,
// keys=64; keys=32 at d = 256), nblocks + 1 offsets then the tiles.
// Returns 0 or a cudaError_t.
extern "C" int tgt_flash_bwd_dq_bf16(const void* q, const void* k, const void* v,
                                     const void* dout, const void* lse, const void* delta,
                                     void* dq, const void* plan, int nblocks, int b, int s,
                                     int sk, int h, int g, int d, float scale, int causal,
                                     int window, void* stream) {
  return dq_entry<bf16>(q, k, v, dout, lse, delta, dq, plan, nblocks, b, s, sk, h, g, d, scale,
                        causal, window, stream);
}

// The same with q, k, v, dout and dq float16.
extern "C" int tgt_flash_bwd_dq_f16(const void* q, const void* k, const void* v,
                                    const void* dout, const void* lse, const void* delta,
                                    void* dq, const void* plan, int nblocks, int b, int s,
                                    int sk, int h, int g, int d, float scale, int causal,
                                    int window, void* stream) {
  return dq_entry<f16>(q, k, v, dout, lse, delta, dq, plan, nblocks, b, s, sk, h, g, d, scale,
                       causal, window, stream);
}

// Same inputs; dk = dS^T Q * scale and dv = P^T dO, summed over the h/g
// query heads of each kv head, written as [b, sk, g, d] bf16.  Every row
// is written (zeros where no query attends).  The work list comes from
// the wrapper (ops/flash_attention.py, dkv_schedule): `items` int32
// [n, 8] (see ITEM_INTS), `offsets` int32 [nblocks + 1] (block i runs
// items offsets[i] .. offsets[i+1]-1), `combos` int32 [b * g * nkt, 2]
// (first slot and slot count of each key tile, -1 when an item writes it
// directly), `partial` f32 [slots, 2 * keys * d].  Key tiles of 128 keys
// (64 at d = 256: ops/flash_attention.py dkv_tile).  `sum` = 0 when every
// combo is written by its one item (no slots, no unattended key tile):
// the sum kernel is not launched (the wrapper passes 0 only at d = 256).  d = 64, 128 or 256.  Returns 0 or a
// cudaError_t.
extern "C" int tgt_flash_bwd_dkv_bf16(const void* q, const void* k, const void* v,
                                      const void* dout, const void* lse, const void* delta,
                                      void* dk, void* dv, const void* items,
                                      const void* offsets, const void* combos, void* partial,
                                      int nblocks, int sum, int b, int s, int sk, int h, int g,
                                      int d, float scale, int causal, int window, void* stream) {
  return dkv_entry<bf16>(q, k, v, dout, lse, delta, dk, dv, items, offsets, combos, partial,
                         nblocks, sum, b, s, sk, h, g, d, scale, causal, window, stream);
}

// The same with q, k, v, dout, dk and dv float16.
extern "C" int tgt_flash_bwd_dkv_f16(const void* q, const void* k, const void* v,
                                     const void* dout, const void* lse, const void* delta,
                                     void* dk, void* dv, const void* items,
                                     const void* offsets, const void* combos, void* partial,
                                     int nblocks, int sum, int b, int s, int sk, int h, int g,
                                     int d, float scale, int causal, int window, void* stream) {
  return dkv_entry<f16>(q, k, v, dout, lse, delta, dk, dv, items, offsets, combos, partial,
                        nblocks, sum, b, s, sk, h, g, d, scale, causal, window, stream);
}

// Dynamic shared memory of one flash_bwd_dq block at head dim d (0: d
// not taken).
extern "C" int tgt_flash_bwd_dq_smem_bytes(int d) {
  return d == 128   ? DqSmem<128>::ALLOC
         : d == 64  ? DqSmem<64>::ALLOC
         : d == 256 ? DqSmem<256>::ALLOC
                    : 0;
}

// Dynamic shared memory of one flash_bwd_dkv block at head dim d (0: d
// not taken).
extern "C" int tgt_flash_bwd_dkv_smem_bytes(int d) {
  return d == 128   ? DkvSmem<128>::ALLOC
         : d == 64  ? DkvSmem<64>::ALLOC
         : d == 256 ? DkvSmem<256>::ALLOC
                    : 0;
}
