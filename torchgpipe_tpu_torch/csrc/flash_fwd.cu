// Flash attention forward for Hopper (sm_90a): causal / windowed GQA,
// online softmax, writes O and the per-row logsumexp.
//
// Replaces: torchgpipe_tpu/ops/flash_attention.py:_fwd_kernel (K/V
// resident in VMEM) and :_fwd_stream_kernel (K/V streamed on a third grid
// axis).  The two compute one function; the TPU split exists only
// because of VMEM size.  Here one K/V-tile loop inside the block serves
// every sequence length.
//
// Bound on the H100: operations.  Causal attention over s tokens does
// about 4 * b * h * d * s^2 / 2 FLOPs (QK^T and PV), against 989 TFLOP/s
// in bf16 on the tensor cores; the bytes (q, k, v, o once each) are
// small beside that for s >= 1024.
//
// Design (FlashAttention-2's forward, on mma.sync): one block of 4 warps
// per (batch*head, 64-row query tile); each warp owns 16 query rows.  Q
// is copied into shared memory once and held in registers as MMA
// fragments.  K/V tiles of 64 keys stream through a two-stage shared
// memory ring with cp.async, so the next tile's load overlaps this
// tile's math.  S = Q K^T, the online softmax (row max and sum, with the
// rows' four lanes reducing by shuffles) and O += P V all stay in
// registers: S accumulators become P's A-fragments directly, and V's
// B-fragments come from ldmatrix.trans.  Tensor-core products are
// m16n8k16 bf16 with f32 accumulation.  Causal tiles above the diagonal
// and, with a window, tiles below the band are never loaded; element
// masks run only on tiles that straddle an edge.  A ragged last tile is
// zero-filled by cp.async and masked.  GQA: query head i reads kv head
// i / (h/g).  Not yet done (later work): wgmma and TMA, which the card's
// full rate needs, and a persistent schedule.

#include "mma_tiles.cuh"

namespace {

using namespace tiles;

constexpr int BQ = 64;               // query rows per block
constexpr int BK = 64;               // keys per K/V tile
constexpr int WARPS = BQ / 16;
constexpr int THREADS = WARPS * 32;
constexpr float NEG = -1e30f;        // the reference kernels' mask value
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

template <int D>
struct Layout {
  static constexpr int LD = D + 8;   // row pitch (bf16): ldmatrix conflict-free
  static constexpr int TILE = BK * LD;
  static constexpr size_t BYTES = size_t(BQ * LD + 4 * TILE) * sizeof(bf16);
};

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ o,
                 float* __restrict__ lse, int s, int sk, int h, int g,
                 float scale, int causal, int window) {
  typedef Layout<D> L;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);
  bf16* sK = sQ + BQ * L::LD;        // [2][BK][LD]
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
  const bf16* qsrc = q + (size_t(bi) * s + q0) * qstride + size_t(hi) * D;
  const bf16* kbase = k + size_t(bi) * sk * kstride + size_t(kvh) * D;
  const bf16* vbase = v + size_t(bi) * sk * kstride + size_t(kvh) * D;

  auto load_kv = [&](int jt, int stage) {
    const int k0 = jt * BK;
    load_tile<D, L::LD, BK, THREADS>(sK + stage * L::TILE, kbase + size_t(k0) * kstride, kstride, sk - k0, tid);
    load_tile<D, L::LD, BK, THREADS>(sV + stage * L::TILE, vbase + size_t(k0) * kstride, kstride, sk - k0, tid);
  };

  load_tile<D, L::LD, BQ, THREADS>(sQ, qsrc, qstride, s - q0, tid);
  load_kv(jt0, 0);
  cp_async_commit();

  // Per-thread rows of the warp's 16: r0 = lane/4 and r0 + 8; per n-tile
  // of 8 keys/dims, columns 2*(lane%4) and +1.
  const int r0 = lane >> 2, cq = (lane & 3) * 2;
  const int qpos0 = q0 + warp * 16 + r0, qpos1 = qpos0 + 8;
  const float sl2 = scale * LOG2E;   // scores in the log2 domain
  float m0 = NEG, m1 = NEG, l0 = 0.f, l1 = 0.f;
  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  uint32_t qa[D / 16][4];
  // ldmatrix lane addressing: matrix i = lane/8, row lane%8.
  const int li = lane >> 3, lr = lane & 7;

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
    if (jt == jt0) {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        ldmatrix_x4(qa[kk], sQ + (warp * 16 + (li & 1) * 8 + lr) * L::LD + kk * 16 + (li >> 1) * 8);
    }
    const bf16* tK = sK + stage * L::TILE;
    const bf16* tV = sV + stage * L::TILE;

    float sc[BK / 8][4];
#pragma unroll
    for (int t = 0; t < BK / 8; ++t) sc[t][0] = sc[t][1] = sc[t][2] = sc[t][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
      for (int j = 0; j < BK / 16; ++j) {
        uint32_t kb[4];
        ldmatrix_x4(kb, tK + (j * 16 + (li >> 1) * 8 + lr) * L::LD + kk * 16 + (li & 1) * 8);
        mma16816(sc[2 * j], qa[kk], kb[0], kb[1]);
        mma16816(sc[2 * j + 1], qa[kk], kb[2], kb[3]);
      }
    }

    const int k0 = jt * BK;
    const bool edge = k0 + BK > sk ||
                      (causal && (k0 + BK - 1 > q0 ||
                                  (window > 0 && q0 + BQ - 1 - k0 >= window)));
    float mx0 = NEG, mx1 = NEG;
#pragma unroll
    for (int t = 0; t < BK / 8; ++t) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = sc[t][e] * sl2;
        if (edge) {
          const int kpos = k0 + t * 8 + cq + (e & 1);
          const int qp = e < 2 ? qpos0 : qpos1;
          bool ok = kpos < sk;
          if (causal) ok = ok && kpos <= qp && (window <= 0 || qp - kpos < window);
          x = ok ? x : NEG;
        }
        sc[t][e] = x;
      }
      mx0 = fmaxf(mx0, fmaxf(sc[t][0], sc[t][1]));
      mx1 = fmaxf(mx1, fmaxf(sc[t][2], sc[t][3]));
    }
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float c0 = exp2f(m0 - mn0), c1 = exp2f(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    l0 *= c0;
    l1 *= c1;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      acc[n][0] *= c0; acc[n][1] *= c0;
      acc[n][2] *= c1; acc[n][3] *= c1;
    }
    uint32_t pa[BK / 16][4];
#pragma unroll
    for (int t = 0; t < BK / 8; ++t) {
      const float p0 = exp2f(sc[t][0] - mn0), p1 = exp2f(sc[t][1] - mn0);
      const float p2 = exp2f(sc[t][2] - mn1), p3 = exp2f(sc[t][3] - mn1);
      l0 += p0 + p1;
      l1 += p2 + p3;
      pa[t >> 1][(t & 1) * 2] = pack_bf16(p0, p1);
      pa[t >> 1][(t & 1) * 2 + 1] = pack_bf16(p2, p3);
    }

#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
#pragma unroll
      for (int np = 0; np < D / 16; ++np) {
        uint32_t vb[4];
        ldmatrix_x4_trans(vb, tV + (kk * 16 + (li & 1) * 8 + lr) * L::LD + np * 16 + (li >> 1) * 8);
        mma16816(acc[2 * np], pa[kk], vb[0], vb[1]);
        mma16816(acc[2 * np + 1], pa[kk], vb[2], vb[3]);
      }
    }
    __syncthreads();  // the next prefetch overwrites this stage
  }

#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float i0 = 1.f / l0, i1 = 1.f / l1;
  if (qpos0 < s) {
    bf16* dst = o + (size_t(bi) * s + qpos0) * qstride + size_t(hi) * D + cq;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<__nv_bfloat162*>(dst + n * 8) =
          __floats2bfloat162_rn(acc[n][0] * i0, acc[n][1] * i0);
    if ((lane & 3) == 0) lse[size_t(bh) * s + qpos0] = (m0 + log2f(l0)) * LN2;
  }
  if (qpos1 < s) {
    bf16* dst = o + (size_t(bi) * s + qpos1) * qstride + size_t(hi) * D + cq;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<__nv_bfloat162*>(dst + n * 8) =
          __floats2bfloat162_rn(acc[n][2] * i1, acc[n][3] * i1);
    if ((lane & 3) == 0) lse[size_t(bh) * s + qpos1] = (m1 + log2f(l1)) * LN2;
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, void* lse,
           int b, int s, int sk, int h, int g, float scale, int causal,
           int window, cudaStream_t stream) {
  const size_t bytes = Layout<D>::BYTES;
  cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, int(bytes));
  if (e != cudaSuccess) return int(e);
  dim3 grid(b * h, (s + BQ - 1) / BQ);
  flash_fwd_kernel<D><<<grid, THREADS, bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o),
      static_cast<float*>(lse), s, sk, h, g, scale, causal, window);
  return int(cudaGetLastError());
}

}  // namespace

// q [b, s, h, d], k/v [b, sk, g, d], o [b, s, h, d] bf16 contiguous;
// lse [b*h, s] f32.  window <= 0 means none.  Returns cudaGetLastError().
extern "C" int tgt_flash_fwd_bf16(const void* q, const void* k, const void* v,
                                  void* o, void* lse, int b, int s, int sk,
                                  int h, int g, int d, float scale, int causal,
                                  int window, void* stream) {
  if (s == 0 || b == 0) return 0;
  if (sk == 0 || g <= 0 || h % g != 0) return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (d == 128) return launch<128>(q, k, v, o, lse, b, s, sk, h, g, scale, causal, window, st);
  if (d == 64) return launch<64>(q, k, v, o, lse, b, s, sk, h, g, scale, causal, window, st);
  return int(cudaErrorInvalidValue);
}
