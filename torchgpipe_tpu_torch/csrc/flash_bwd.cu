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
// here one tile loop inside the block serves every sequence length, as in
// flash_fwd.cu.
//
// Bound on the H100: operations.  With P attended (query, key) pairs
// (P = s(s+1)/2 causal), flash_bwd_dq does three products (S = Q K^T,
// dP = dO V^T, dQ = dS K): 6 * b * h * d * P FLOPs; flash_bwd_dkv does four
// (S^T, dP^T, dV = P^T dO, dK = dS^T Q): 8 * b * h * d * P FLOPs; against
// 989 TFLOP/s bf16 on the tensor cores.  The bytes (q, k, v, dO, lse and
// delta in; dq, dk, dv out) are small beside that for s >= 1024.
//
// Design (FlashAttention-2's backward split into two kernels, on mma.sync
// with f32 accumulation; no atomics, so the result is deterministic run
// to run):
// * flash_bwd_dq: one block of 4 warps per (batch*head, 64-row query
//   tile), each warp 16 query rows.  Q and dO stay in shared memory; K/V
//   tiles of 64 keys stream through a two-stage cp.async ring over the
//   live tiles only (the window's first tile .. the diagonal).  Per tile
//   S and dP accumulate in registers, P = exp(S*scale - lse) and
//   dS = P * (dP - delta) are formed in place and packed straight into
//   A fragments for dQ += dS K (K's B fragments via ldmatrix.trans).
// * flash_bwd_dkv: one block of 4 warps per (batch*kv head, 64-key tile),
//   each warp 16 keys, with K and V held in shared memory.  It loops over
//   the h/g query heads of the group and, for each, over the live 32-row
//   query tiles (the diagonal .. the window's last tile), streaming Q/dO
//   through a two-stage ring.  The transposed products are computed with
//   keys on the MMA's row side: S^T = K Q^T and dP^T = V dO^T land with
//   the same register layout that P^T and dS^T need as A fragments, so
//   dV += P^T dO and dK += dS^T Q run from registers with no trip through
//   shared memory.  dK and dV accumulate in f32 over the whole group and
//   are written once, at kv-head granularity: the TPU's expanded
//   [b*h, s_k, d] f32 outputs and the group sum after them are gone.
//   Register pressure is the limit here: the two f32 [16, d] accumulators
//   of a warp take 2 * 16 * d / 32 = 128 registers a thread at d = 128, so
//   the query tile is 32 rows (S^T and dP^T take 16 registers each) and K/V
//   fragments are re-read from shared memory rather than held.
// Element masks (causal, window, ragged query and key edges) run only on
// tiles that straddle an edge; rows and keys past the end are zero-filled
// by cp.async and masked.  GQA: query head i reads kv head i / (h/g).
// Not yet done (later work): wgmma and TMA, a persistent schedule.

#include "mma_tiles.cuh"

namespace {

using namespace tiles;

constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr float LOG2E = 1.4426950408889634f;

// flash_bwd_dq: 64 query rows per block, 64-key K/V tiles.
constexpr int DQ_BQ = 16 * WARPS;
constexpr int DQ_BK = 64;
// flash_bwd_dkv: 64 keys per block, 32-row Q/dO tiles.
constexpr int KV_BK = 16 * WARPS;
constexpr int KV_BQ = 32;

template <int D>
struct DqLayout {
  static constexpr int LD = D + 8;   // row pitch (bf16): ldmatrix conflict-free
  static constexpr int TILE = DQ_BK * LD;
  // Q, dO [BQ][LD]; K, V [2][BK][LD]
  static constexpr size_t BYTES = size_t(2 * DQ_BQ * LD + 4 * TILE) * sizeof(bf16);
};

template <int D>
struct DkvLayout {
  static constexpr int LD = D + 8;
  static constexpr int TILE = KV_BQ * LD;
  // K, V [BK][LD]; Q, dO [2][BQ][LD]
  static constexpr size_t BYTES = size_t(2 * KV_BK * LD + 4 * TILE) * sizeof(bf16);
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
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const bf16* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     bf16* __restrict__ dk, bf16* __restrict__ dv, int s, int sk, int h,
                     int g, float scale, int causal, int window) {
  typedef DkvLayout<D> L;
  constexpr int BQ = KV_BQ, BK = KV_BK;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* sK = reinterpret_cast<bf16*>(smem_raw);
  bf16* sV = sK + BK * L::LD;
  bf16* sQ = sV + BK * L::LD;        // [2][BQ][LD]
  bf16* sO = sQ + 2 * L::TILE;       // dO, [2][BQ][LD]

  const int bg = blockIdx.x;
  const int kt = blockIdx.y;         // low key tiles carry the most causal work
  const int bi = bg / g, kvh = bg % g;
  const int r = h / g;
  const int k0 = kt * BK;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  // Live query tiles [jq0, jq1): from the diagonal (the first query that
  // sees key k0 is qpos = k0) to the window's last (the newest query that
  // sees key k0+BK-1 is k0+BK-1 + window-1).
  const int nq = (s + BQ - 1) / BQ;
  int jq0 = 0, jq1 = nq;
  if (causal) {
    jq0 = k0 / BQ;
    if (window > 0) jq1 = min((k0 + BK - 1 + window - 1) / BQ + 1, nq);
  }
  const int ntile = max(jq1 - jq0, 0);
  const int niter = r * ntile;

  const size_t qstride = size_t(h) * D, kstride = size_t(g) * D;
  const size_t koff = (size_t(bi) * sk + k0) * kstride + size_t(kvh) * D;

  auto load_q = [&](int it, int stage) {
    const int hh = kvh * r + it / ntile;
    const int qs = (jq0 + it % ntile) * BQ;
    const size_t off = (size_t(bi) * s + qs) * qstride + size_t(hh) * D;
    load_tile<D, L::LD, BQ, THREADS>(sQ + stage * L::TILE, q + off, qstride, s - qs, tid);
    load_tile<D, L::LD, BQ, THREADS>(sO + stage * L::TILE, dout + off, qstride, s - qs, tid);
  };

  load_tile<D, L::LD, BK, THREADS>(sK, k + koff, kstride, sk - k0, tid);
  load_tile<D, L::LD, BK, THREADS>(sV, v + koff, kstride, sk - k0, tid);
  if (niter > 0) load_q(0, 0);
  cp_async_commit();

  // Per-thread rows (keys) of the warp's 16: r0 = lane/4 and r0 + 8; per
  // n-tile of 8 queries/dims, columns 2*(lane%4) and +1.
  const int r0 = lane >> 2, cq = (lane & 3) * 2;
  const int kpos0 = k0 + warp * 16 + r0, kpos1 = kpos0 + 8;
  const float sl2 = scale * LOG2E;
  float dka[D / 8][4], dva[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    dka[n][0] = dka[n][1] = dka[n][2] = dka[n][3] = 0.f;
    dva[n][0] = dva[n][1] = dva[n][2] = dva[n][3] = 0.f;
  }
  const int li = lane >> 3, lr = lane & 7;
  const int arow = (warp * 16 + (li & 1) * 8 + lr) * L::LD + (li >> 1) * 8;

  for (int it = 0; it < niter; ++it) {
    const int stage = it & 1;
    if (it + 1 < niter) {
      load_q(it + 1, stage ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int hh = kvh * r + it / ntile;
    const int q0 = (jq0 + it % ntile) * BQ;
    const bf16* tQ = sQ + stage * L::TILE;
    const bf16* tO = sO + stage * L::TILE;

    // S^T = K Q^T and dP^T = V dO^T, [16 keys x BQ queries] per warp.
    float st[BQ / 8][4], dpt[BQ / 8][4];
#pragma unroll
    for (int t = 0; t < BQ / 8; ++t) {
      st[t][0] = st[t][1] = st[t][2] = st[t][3] = 0.f;
      dpt[t][0] = dpt[t][1] = dpt[t][2] = dpt[t][3] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t ka[4], va[4];
      ldmatrix_x4(ka, sK + arow + kk * 16);
      ldmatrix_x4(va, sV + arow + kk * 16);
#pragma unroll
      for (int j = 0; j < BQ / 16; ++j) {
        const int boff = (j * 16 + (li >> 1) * 8 + lr) * L::LD + kk * 16 + (li & 1) * 8;
        uint32_t qb[4], ob[4];
        ldmatrix_x4(qb, tQ + boff);
        mma16816(st[2 * j], ka, qb[0], qb[1]);
        mma16816(st[2 * j + 1], ka, qb[2], qb[3]);
        ldmatrix_x4(ob, tO + boff);
        mma16816(dpt[2 * j], va, ob[0], ob[1]);
        mma16816(dpt[2 * j + 1], va, ob[2], ob[3]);
      }
    }

    // P^T = exp(S^T*scale - lse[q]); dS^T = P^T * (dP^T - delta[q]).
    const float* lrow = lse + (size_t(bi) * h + hh) * s;
    const float* drow = delta + (size_t(bi) * h + hh) * s;
    const bool edge = q0 + BQ > s || k0 + BK > sk ||
                      (causal && (k0 + BK - 1 > q0 ||
                                  (window > 0 && q0 + BQ - 1 - k0 >= window)));
    uint32_t pa[BQ / 16][4], dsa[BQ / 16][4];
#pragma unroll
    for (int t = 0; t < BQ / 8; ++t) {
      float p[4], ds[4];
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int qp = q0 + t * 8 + cq + c;
        const float l2 = qp < s ? lrow[qp] * LOG2E : 0.f;
        const float dl = qp < s ? drow[qp] : 0.f;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int e = half * 2 + c;
          float pv = exp2f(st[t][e] * sl2 - l2);
          if (edge && !attends(qp, half ? kpos1 : kpos0, s, sk, causal, window)) pv = 0.f;
          p[e] = pv;
          ds[e] = pv * (dpt[t][e] - dl);
        }
      }
      pa[t >> 1][(t & 1) * 2] = pack_bf16(p[0], p[1]);
      pa[t >> 1][(t & 1) * 2 + 1] = pack_bf16(p[2], p[3]);
      dsa[t >> 1][(t & 1) * 2] = pack_bf16(ds[0], ds[1]);
      dsa[t >> 1][(t & 1) * 2 + 1] = pack_bf16(ds[2], ds[3]);
    }

    // dV += P^T dO and dK += dS^T Q (dO, Q as [queries, d]: ldmatrix.trans).
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
#pragma unroll
      for (int np = 0; np < D / 16; ++np) {
        const int toff = (kk * 16 + (li & 1) * 8 + lr) * L::LD + np * 16 + (li >> 1) * 8;
        uint32_t ob[4], qb[4];
        ldmatrix_x4_trans(ob, tO + toff);
        mma16816(dva[2 * np], pa[kk], ob[0], ob[1]);
        mma16816(dva[2 * np + 1], pa[kk], ob[2], ob[3]);
        ldmatrix_x4_trans(qb, tQ + toff);
        mma16816(dka[2 * np], dsa[kk], qb[0], qb[1]);
        mma16816(dka[2 * np + 1], dsa[kk], qb[2], qb[3]);
      }
    }
    __syncthreads();  // the next prefetch overwrites this stage
  }
  cp_async_wait<0>();  // an empty loop leaves the K/V copies in flight

  if (kpos0 < sk) {
    const size_t off = koff + size_t(warp * 16 + r0) * kstride + cq;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      *reinterpret_cast<__nv_bfloat162*>(dk + off + n * 8) =
          __floats2bfloat162_rn(dka[n][0] * scale, dka[n][1] * scale);
      *reinterpret_cast<__nv_bfloat162*>(dv + off + n * 8) =
          __floats2bfloat162_rn(dva[n][0], dva[n][1]);
    }
  }
  if (kpos1 < sk) {
    const size_t off = koff + size_t(warp * 16 + r0 + 8) * kstride + cq;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      *reinterpret_cast<__nv_bfloat162*>(dk + off + n * 8) =
          __floats2bfloat162_rn(dka[n][2] * scale, dka[n][3] * scale);
      *reinterpret_cast<__nv_bfloat162*>(dv + off + n * 8) =
          __floats2bfloat162_rn(dva[n][2], dva[n][3]);
    }
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

template <int D>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* delta, void* dk, void* dv, int b, int s, int sk,
               int h, int g, float scale, int causal, int window, cudaStream_t stream) {
  const size_t bytes = DkvLayout<D>::BYTES;
  cudaError_t e = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, int(bytes));
  if (e != cudaSuccess) return int(e);
  dim3 grid(b * g, (sk + KV_BK - 1) / KV_BK);
  flash_bwd_dkv_kernel<D><<<grid, THREADS, bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), s, sk, h, g, scale, causal, window);
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
// is written (zeros where no query attends).
extern "C" int tgt_flash_bwd_dkv_bf16(const void* q, const void* k, const void* v,
                                      const void* dout, const void* lse, const void* delta,
                                      void* dk, void* dv, int b, int s, int sk, int h, int g,
                                      int d, float scale, int causal, int window,
                                      void* stream) {
  if (sk == 0 || b == 0) return 0;
  if (g <= 0 || h % g != 0) return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (d == 128)
    return launch_dkv<128>(q, k, v, dout, lse, delta, dk, dv, b, s, sk, h, g, scale, causal,
                           window, st);
  if (d == 64)
    return launch_dkv<64>(q, k, v, dout, lse, delta, dk, dv, b, s, sk, h, g, scale, causal,
                          window, st);
  return int(cudaErrorInvalidValue);
}
