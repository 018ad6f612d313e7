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
// small beside that for s >= 1024.  Only wgmma reaches that rate, and
// only when its operands arrive without the threads spending issue slots
// on copies, so the design is FlashAttention-3's forward:
//
// * A persistent grid (one block per SM) walks the (batch*head, 128-row
//   query tile) tiles, so no block pays a launch, a barrier set-up or a
//   cold Q load per tile, and the next tile's Q arrives while the current
//   one finishes.  The wrapper deals the tiles out longest first onto the
//   least loaded block (ops/flash_attention.py fwd_schedule): a long causal
//   sequence has tiles of 1 .. s/128 key tiles, and a plain round robin
//   left its busiest block 1.34x the mean at s = 12288.  Three
//   warpgroups: warpgroup 2 is the producer, one thread issuing TMA loads
//   (hopper_tiles.cuh) of each Q tile and of 128-key (d = 256: 64-key) K
//   and V tiles into a two-stage ring, each on its own mbarrier, with its registers given
//   back (setmaxnreg).  Warpgroups 0 and 1 are the consumers, 64 query
//   rows each, with 240 registers a thread.
// * S = Q K^T is one wgmma m64nBKk16 chain from shared memory (Q and K
//   K-major).  The online softmax runs on the accumulator registers (row
//   max and sum over a row's four lanes by shuffles); P is packed to bf16
//   A fragments in place and O += P V runs from registers with V read
//   MN-major (the transpose bit), so S, P and O never touch shared memory.
// * Ping-pong: the two consumers take turns to issue their products
//   (named barriers 1 and 2), each turn being O += P_j V_j followed by
//   S_{j+1} = Q K_{j+1}^T, so one warpgroup's softmax runs while the
//   other's products occupy the tensor cores.
// * K and V stages are released separately (K once S is done, V once PV
//   is), so the producer refills K a whole softmax earlier.
// * Element type E: bf16 (tgt_flash_fwd_bf16) or float16 (tgt_flash_fwd_f16),
//   the same kernel with wgmma's f16 form, f16 tensor maps and P packed to
//   f16; m, l, O and the LSE stay f32 for both.
// * Head dims 64, 128 and 256 (Gemma's; ops/flash_attention.py routes
//   bf16/f16 d = 256 here through wide_kernel, other wide dims to
//   flash_simt.cu).  At d = 256 the K/V tiles are 64 keys (BK_OF): a
//   128-row Q tile is 64 KB and two stages of 64-key K and V 128 KB, 192 KB
//   of the 227 KB a block may have, where 128-key tiles would need 320 KB.
//   Each consumer thread then holds 128 f32 accumulators of O, 32 of S and
//   16 registers of P under setmaxnreg 240; S = Q K^T is 16 k16 steps of
//   m64n64k16 across Q's and K's four 64-column blocks, and O += P V one
//   m64n256k16 product a k16 step (hopper_tiles.cuh wgmma_rs_n256; it
//   timed within 2% of two m64n128k16 halves, PERF.md).
// Causal tiles above the diagonal and, with a window, tiles below the band
// are never loaded; element masks run only on tiles that straddle an edge.
// Rows and keys past the end arrive as zeros from TMA and are masked.  A
// masked score is -inf; a row whose keys are all masked so far keeps
// m = -inf and takes its exponents relative to 0, so its P is 0 and
// nothing needs wiping later (FlashAttention-2's rule).  The exponentials
// are single MUFU.EX2 instructions on FFMA-scaled scores.  GQA: query
// head i reads kv head i / (h/g).

#include <math_constants.h>

#include "hopper_tiles.cuh"

namespace {

using namespace hopper;

constexpr int BQ = 128;              // query rows per block (two warpgroups)
// Keys per K/V tile: 128 up to d = 128; 64 at d = 256, where 128-key
// tiles in two stages would need 320 KB of shared memory.
template <int D>
constexpr int BK_OF = D == 256 ? 64 : 128;
constexpr int STAGES = 2;
constexpr int THREADS = 384;
constexpr int BAR_TURN = 1;          // named barriers 1, 2: consumer w's turn
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// d = 128: Q 32 KB + 2 x (K 32 KB + V 32 KB) = 160 KB; d = 256: Q 64 KB
// + 2 x (K 32 KB + V 32 KB) = 192 KB.
template <int D>
struct FwdSmem {
  static constexpr int BK = BK_OF<D>;
  static constexpr int Q_TILE = BQ * D * 2;   // bytes
  static constexpr int KV_TILE = BK * D * 2;
  static constexpr int Q = 0;
  static constexpr int K = Q_TILE;
  static constexpr int V = K + STAGES * KV_TILE;
  static constexpr int BAR = V + STAGES * KV_TILE;
  // q_full, q_empty, k_full[S], v_full[S], k_empty[S], v_empty[S]
  static constexpr int BYTES = BAR + (2 + 4 * STAGES) * 8;
  static constexpr int ALLOC = BYTES + 1024;  // room to align the base
};

// sacc = Q K^T for one warpgroup: Q rows at `qa`, a K tile at `ka`, both
// K-major; committed as one group.
template <int D, int BK, typename E>
__device__ __forceinline__ void qk_product(float (&sacc)[BK / 2], uint32_t qa, uint32_t ka) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t off = (kk % 4) * 32u;   // k16 step inside a 64-column block
    wgmma_ss<BK, 0, E>(sacc, desc_k(qa + (kk / 4) * BQ * 128 + off),
                    desc_k(ka + (kk / 4) * BK * 128 + off), kk > 0);
  }
  wgmma_commit();
}

// One consumer warpgroup's online-softmax state: the O accumulator, the
// row max m (raw scores) and sum l of its thread's two rows, and P of the
// current tile as A fragments.
template <int D, int BK, typename E>
struct Softmax {
  float o[D / 2];
  float m[2], l[2];
  uint32_t pa[BK / 16][4];

  __device__ __forceinline__ void reset() {
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    m[0] = m[1] = -CUDART_INF_F;
    l[0] = l[1] = 0.f;
  }

  // Masks S (keys k0 .. k0+BK-1, rows qpos0 and +8) where `edge`, updates
  // m and l, rescales O and packs P = exp2(S * sl2 - m * sl2) to E.
  // A masked score is -inf (p = 0); a row with every key masked so far
  // keeps m = -inf and its exponent offset at 0 (FlashAttention-2's rule).
  __device__ __forceinline__ void tile(float (&sacc)[BK / 2], bool edge, int k0, int qpos0,
                                       int cq, int s, int sk, int causal, int window,
                                       float sl2) {
    if (edge) {
#pragma unroll
      for (int t = 0; t < BK / 8; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (!visible(qpos0 + (e >> 1) * 8, k0 + t * 8 + cq + (e & 1), 0x7fffffff, sk,
                       causal, window))
            sacc[4 * t + e] = -CUDART_INF_F;
    }
    float mx0 = m[0], mx1 = m[1];
#pragma unroll
    for (int t = 0; t < BK / 8; ++t) {
      mx0 = fmaxf(mx0, fmaxf(sacc[4 * t], sacc[4 * t + 1]));
      mx1 = fmaxf(mx1, fmaxf(sacc[4 * t + 2], sacc[4 * t + 3]));
    }
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float ms0 = mx0 == -CUDART_INF_F ? 0.f : mx0 * sl2;
    const float ms1 = mx1 == -CUDART_INF_F ? 0.f : mx1 * sl2;
    const float c0 = exp2_fast(fmaf(m[0], sl2, -ms0)), c1 = exp2_fast(fmaf(m[1], sl2, -ms1));
    m[0] = mx0;
    m[1] = mx1;
    float l0 = l[0] * c0, l1 = l[1] * c1;
#pragma unroll
    for (int t = 0; t < D / 8; ++t) {
      o[4 * t] *= c0;
      o[4 * t + 1] *= c0;
      o[4 * t + 2] *= c1;
      o[4 * t + 3] *= c1;
    }
#pragma unroll
    for (int t = 0; t < BK / 8; ++t) {
      const float p0 = exp2_fast(fmaf(sacc[4 * t], sl2, -ms0));
      const float p1 = exp2_fast(fmaf(sacc[4 * t + 1], sl2, -ms0));
      const float p2 = exp2_fast(fmaf(sacc[4 * t + 2], sl2, -ms1));
      const float p3 = exp2_fast(fmaf(sacc[4 * t + 3], sl2, -ms1));
      l0 += p0 + p1;
      l1 += p2 + p3;
      pa[t >> 1][(t & 1) * 2] = pack2<E>(p0, p1);
      pa[t >> 1][(t & 1) * 2 + 1] = pack2<E>(p2, p3);
    }
    l[0] = l0;
    l[1] = l1;
  }

  // O += P V for a V tile at `va` (MN-major), committed as one group; at
  // d = 256 one m64n256k16 product a k16 step, 128 accumulators a thread.
  __device__ __forceinline__ void pv_product(uint32_t va) {
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      wgmma_rs<D, 1, E>(o, pa[kk], desc_mn(va + kk * 2048, BK * 128), 1);
    wgmma_commit();
  }

  __device__ __forceinline__ void fence() { fence_regs(o); }
};

template <int D, typename E>
__global__ void __launch_bounds__(THREADS, 1)
flash_fwd_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv, E* __restrict__ o,
                 float* __restrict__ lse, const int* __restrict__ plan, int b, int s, int sk,
                 int h, int g, float scale, int causal, int window) {
  typedef FwdSmem<D> L;
  constexpr int BK = L::BK;
  constexpr int NB = D / 64;         // 64-column blocks of a row
  // One 128-row query tile of a launch (n >= 1: the diagonal tile is live).
  typedef QueryTile<BQ, BK> Tile;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = align1024(smem_raw);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(sm + L::BAR);
  uint64_t* q_empty = q_full + 1;
  uint64_t* k_full = q_empty + 1;
  uint64_t* v_full = k_full + STAGES;
  uint64_t* k_empty = v_full + STAGES;
  uint64_t* v_empty = k_empty + STAGES;
  const int bhn = b * h, nqt = (s + BQ - 1) / BQ;
  // This block's tiles: plan[first .. last) index the tile list after the
  // gridDim.x + 1 offsets.
  const int first = plan[blockIdx.x], last = plan[blockIdx.x + 1];
  const int* tiles = plan + gridDim.x + 1;
  const int tid = threadIdx.x, wg = tid >> 7;

  if (tid == 0) {
    mbar_init(q_full, 1);
    mbar_init(q_empty, 8);           // one arrival per consumer warp
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(&k_full[i], 1);
      mbar_init(&v_full[i], 1);
      mbar_init(&k_empty[i], 8);
      mbar_init(&v_empty[i], 8);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 2) {
    // Producer: one thread issues every copy.  The Q tile is reloaded once
    // the consumers' last S product of the previous tile is done, and the
    // K/V ring runs on across tiles (`it` counts the tiles it has held).
    reg_dealloc<24>();
    if (tid != 256) return;
    int it = 0;
    uint32_t qph = 0;
    for (int x = first; x < last; ++x) {
      const Tile t(tiles[x], bhn, nqt, h, g, s, sk, causal, window);
      mbar_wait(q_empty, qph ^ 1);
      qph ^= 1;
      mbar_arrive_tx(q_full, L::Q_TILE);
      for (int c = 0; c < NB; ++c)
        tma_load_4d(sm + L::Q + c * BQ * 128, &tq, q_full, c * 64, t.hi, t.q0, t.bi);
      for (int j = 0; j < t.n; ++j, ++it) {
        const int st = it % STAGES;
        const uint32_t ph = (it / STAGES) & 1;
        const int k0 = (t.jt0 + j) * BK;
        mbar_wait(&k_empty[st], ph ^ 1);
        mbar_arrive_tx(&k_full[st], L::KV_TILE);
        for (int c = 0; c < NB; ++c)
          tma_load_4d(sm + L::K + st * L::KV_TILE + c * BK * 128, &tk, &k_full[st], c * 64,
                      t.kvh, k0, t.bi);
        mbar_wait(&v_empty[st], ph ^ 1);
        mbar_arrive_tx(&v_full[st], L::KV_TILE);
        for (int c = 0; c < NB; ++c)
          tma_load_4d(sm + L::V + st * L::KV_TILE + c * BK * 128, &tv, &v_full[st], c * 64,
                      t.kvh, k0, t.bi);
      }
    }
    return;
  }

  // Consumers: warpgroup w owns query rows q0 + 64w .. +63 of each tile.
  reg_alloc<240>();
  const int w = wg;
  const int warp = (tid >> 5) & 3, lane = tid & 31;
  const int cq = (lane & 3) * 2;
  const float sl2 = scale * LOG2E;   // scores to the log2 domain
  const uint32_t base = smem_u32(sm);
  const uint32_t qa = base + L::Q + w * 64 * 128;   // this warpgroup's 64 rows
  const int me = BAR_TURN + w, other = BAR_TURN + (w ^ 1);
  const size_t qstride = size_t(h) * D;

  Softmax<D, BK, E> sm_state;
  float sacc[BK / 2];
  int it = 0;
  uint32_t qph = 0;

  if (w == 1) bar_arrive(BAR_TURN, 256);   // warpgroup 0 takes the first turn
  for (int x = first; x < last; ++x) {
    const Tile t(tiles[x], bhn, nqt, h, g, s, sk, causal, window);
    // Warpgroup 1 arrives after every turn but its last of the launch:
    // warpgroup 0 syncs once per turn and got one arrival up front.
    const bool last_tile = x + 1 == last;
    const int qw0 = t.q0 + 64 * w;
    const int qpos0 = qw0 + warp * 16 + (lane >> 2);
    sm_state.reset();
    mbar_wait(q_full, qph);
    qph ^= 1;

    {  // First turn: S_0 = Q K_0^T.
      const int st = it % STAGES;
      mbar_wait(&k_full[st], (it / STAGES) & 1);
      bar_sync(me, 256);
      fence_regs(sacc);
      wgmma_fence();
      qk_product<D, BK, E>(sacc, qa, base + L::K + st * L::KV_TILE);
      bar_arrive(other, 256);
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
      sm_state.tile(sacc, edge, k0, qpos0, cq, s, sk, causal, window, sl2);

      // This warpgroup's turn: O += P_j V_j, then S_{j+1} = Q K_{j+1}^T.
      // Each branch holds whole wgmma pipelines (fence .. wait), which
      // keeps ptxas from serialising them.
      const int cur = it + j, st = cur % STAGES;
      const uint32_t va = base + L::V + st * L::KV_TILE;
      mbar_wait(&v_full[st], (cur / STAGES) & 1);
      if (j + 1 < t.n) {
        const int st1 = (cur + 1) % STAGES;
        mbar_wait(&k_full[st1], ((cur + 1) / STAGES) & 1);
        bar_sync(me, 256);
        sm_state.fence();
        fence_regs(sacc);
        wgmma_fence();
        sm_state.pv_product(va);
        qk_product<D, BK, E>(sacc, qa, base + L::K + st1 * L::KV_TILE);
        bar_arrive(other, 256);
        wgmma_wait<0>();
        sm_state.fence();
        fence_regs(sacc);
        __syncwarp();
        if (lane == 0) {
          mbar_arrive(&v_empty[st]);
          mbar_arrive(&k_empty[st1]);
          if (j + 2 == t.n) mbar_arrive(q_empty);   // the tile's last S is done
        }
      } else {
        bar_sync(me, 256);
        sm_state.fence();
        wgmma_fence();
        sm_state.pv_product(va);
        wgmma_wait<0>();
        sm_state.fence();
        if (w == 0 || !last_tile) bar_arrive(other, 256);
        __syncwarp();
        if (lane == 0) mbar_arrive(&v_empty[st]);
      }
    }
    it += t.n;

    const float(&oacc)[D / 2] = sm_state.o;
    float l0 = sm_state.l[0], l1 = sm_state.l[1];
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, off);
      l1 += __shfl_xor_sync(0xffffffffu, l1, off);
    }
    const float i0 = 1.f / l0, i1 = 1.f / l1;
    const size_t bh = size_t(t.bi) * h + t.hi;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qpos = qpos0 + 8 * r;
      if (qpos >= s) continue;
      const float inv = r ? i1 : i0;
      E* dst = o + (size_t(t.bi) * s + qpos) * qstride + size_t(t.hi) * D + cq;
#pragma unroll
      for (int c = 0; c < D / 8; ++c)
        store2<E>(dst + c * 8, oacc[4 * c + 2 * r] * inv, oacc[4 * c + 2 * r + 1] * inv);
      if ((lane & 3) == 0)
        lse[bh * s + qpos] = (sm_state.m[r] * sl2 + log2f(r ? l1 : l0)) * LN2;
    }
  }
}

template <int D, typename E>
int launch(const void* q, const void* k, const void* v, void* o, void* lse, const int* plan,
           int nblocks, int b, int s, int sk, int h, int g, float scale, int causal, int window,
           cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  int e;
  constexpr int BK = BK_OF<D>;
  if ((e = make_map<E>(&tq, q, D, h, s, b, BQ)) || (e = make_map<E>(&tk, k, D, g, sk, b, BK)) ||
      (e = make_map<E>(&tv, v, D, g, sk, b, BK)))
    return e;
  const int bytes = FwdSmem<D>::ALLOC;
  cudaError_t ce = cudaFuncSetAttribute(flash_fwd_kernel<D, E>,
                                        cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (ce != cudaSuccess) return int(ce);
  flash_fwd_kernel<D, E><<<nblocks, THREADS, bytes, stream>>>(
      tq, tk, tv, static_cast<E*>(o), static_cast<float*>(lse), plan, b, s, sk, h, g, scale,
      causal, window);
  return int(cudaGetLastError());
}

template <typename E>
int forward(const void* q, const void* k, const void* v, void* o, void* lse, const void* plan,
            int nblocks, int b, int s, int sk, int h, int g, int d, float scale, int causal,
            int window, void* stream) {
  if (s == 0 || b == 0) return 0;
  if (sk == 0 || g <= 0 || h % g != 0 || nblocks <= 0) return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* pl = static_cast<const int*>(plan);
  if (d == 128)
    return launch<128, E>(q, k, v, o, lse, pl, nblocks, b, s, sk, h, g, scale, causal, window, st);
  if (d == 64)
    return launch<64, E>(q, k, v, o, lse, pl, nblocks, b, s, sk, h, g, scale, causal, window, st);
  if (d == 256)
    return launch<256, E>(q, k, v, o, lse, pl, nblocks, b, s, sk, h, g, scale, causal, window, st);
  return int(cudaErrorInvalidValue);
}

}  // namespace

// q [b, s, h, d], k/v [b, sk, g, d], o [b, s, h, d] bf16 contiguous (16-byte
// aligned); lse [b*h, s] f32.  window <= 0 means none.  `plan` int32: the
// work list of ops/flash_attention.py fwd_schedule, nblocks + 1 offsets
// then the tiles (block i runs tiles offsets[i] .. offsets[i+1]-1).
// Returns 0 or a cudaError_t.
extern "C" int tgt_flash_fwd_bf16(const void* q, const void* k, const void* v, void* o,
                                  void* lse, const void* plan, int nblocks, int b, int s, int sk,
                                  int h, int g, int d, float scale, int causal, int window,
                                  void* stream) {
  return forward<bf16>(q, k, v, o, lse, plan, nblocks, b, s, sk, h, g, d, scale, causal, window,
                       stream);
}

// The same with q, k, v and o float16.
extern "C" int tgt_flash_fwd_f16(const void* q, const void* k, const void* v, void* o,
                                 void* lse, const void* plan, int nblocks, int b, int s, int sk,
                                 int h, int g, int d, float scale, int causal, int window,
                                 void* stream) {
  return forward<f16>(q, k, v, o, lse, plan, nblocks, b, s, sk, h, g, d, scale, causal, window,
                      stream);
}

// Dynamic shared memory of one block at head dim d (0: d not taken).
extern "C" int tgt_flash_fwd_smem_bytes(int d) {
  return d == 128   ? FwdSmem<128>::ALLOC
         : d == 64  ? FwdSmem<64>::ALLOC
         : d == 256 ? FwdSmem<256>::ALLOC
                    : 0;
}
