// Flash decode for Hopper (sm_90a): g consecutive queries against the
// live prefix of a KV cache, GQA, causal, optional sliding window, f32 out.
// The cache is bf16, float16 or f32 (queries of the same type), or int8
// with f32 per-(position, kv head) scales (bf16, float16 or f32 queries).
//
// Replaces: torchgpipe_tpu/ops/flash_attention.py:_decode_kernel, both its
// float-cache variant and its int8-cache variant (quant=True).
//
// Bound on the H100: bytes.  One call reads the live K and V prefix,
// 2 * b * len * nkv * hd * sizeof(cache element) bytes (len = pos0 + g, or
// the window band), plus, for an int8 cache, two f32 scales per (row,
// position, kv head), against 3.35 TB/s; its FLOPs (4 * b * g * nh * hd *
// len) are a few per byte, far below the ridge.  So the design is about
// keeping enough bytes in flight and spending few instructions per byte:
//
// * The live length comes from the device.  `pos0` is read by every block
//   from a device int32 (or taken from a host int; the two give the same
//   bits), clamped to [0, max_len - g] as the reference's index maps clamp.
//   The grid and the scratch depend only on max_len, b, nkv and the SM
//   count: grid (nkv x row groups, b, zmax).  Each block derives the split
//   of the live keys [first, pos0 + g) with decode_split (mirrored in
//   ops/flash_attention.py, where the CPU tests check it): 64-key tiles
//   dealt in equal runs to at most `want` = wave * SMs / (b * nkv * groups)
//   chunks, so one wave covers the call: one block per SM for a bf16 or
//   f32 cache (bytes set the pace), two for int8 (the per-tile work does;
//   the wrapper picks `want`).  Blocks past
//   the live split exit before reading anything, so a decode step can be
//   captured once in a CUDA graph and replayed at any length.
// * Staged loads.  A producer warp streams the chunk's K and V tiles of
//   one (batch row, kv head) through a ring in shared memory with TMA (a
//   tensor map over the [b, max_len, nkv, hd] cache, boxes of 64 keys by
//   one 128- or 64-byte column block, swizzled), each stage on an
//   mbarrier; its lanes copy an int8 cache's scales beside each tile.  The
//   ring holds 96 KB (3 to 8 stages at bf16/int8), so ~64 KB per block are
//   in flight (Little's law at 3.35 TB/s asks for tens of KB per SM); two
//   blocks fit on an SM.  At head dim 256 a bf16 tile is 32 KB: the ring
//   holds 128 KB (two stages of K and V; four for int8) and one block
//   takes an SM, so the split aims at one block an SM for every cache
//   type.  An int8 cache moves as int8 and is widened in registers.
// * Scores on the tensor cores.  A kv head's g*r query rows (row i is
//   position pos0 + i / r, query head kvh*r + i % r, the reference's
//   head-folded order) are the M side of mma.sync.m16n8k16 (padded to 16,
//   two m-tiles up to 32 rows), keys the N side, head dims the K side;
//   each consumer warp takes 16 keys of a tile.  wgmma would waste 48-60 of
//   its 64 rows here, and bytes, not the tensor rate, set the pace, so
//   mma.sync is the right tool.  bf16 x bf16 products are exact in f32;
//   int8 widens exactly to bf16 and the score is scaled by s_k per key;
//   float16 queries take mma.sync's f16 form against an f16 cache, and
//   against an int8 cache widened exactly to f16;
//   f32 queries against an int8 cache are split into three bf16 parts
//   (hi + mid + lo carries all 24 bits).  The 1/sqrt(hd) scale (times
//   log2 e) goes on the f32 score.  An f32 cache keeps full f32 products:
//   its scores run on the CUDA cores (no TF32).
// * Softmax per tile through shared memory: each warp owns a quarter of
//   the rows (row max and sum over the tile by shuffles, once per tile,
//   not per key), writes P and the rescale factor, and keeps the rows'
//   running max and sum.
// * P V in f32 on the CUDA cores, from V in shared memory: a thread owns
//   up to 8 head dims (one 16-byte load of a bf16 row) of every row over
//   one slice of the tile's keys, so each key costs it one V load, one
//   load of the rows' weights and RP x 8 FMAs, with no shuffles; the
//   slices' sums meet once, at the end of the chunk.  Rounding P to bf16
//   for a tensor-core P V would move each weight by up to 2^-9 relative,
//   against a 2e-4 tolerance on the f32 output; in f32 the kernel and the
//   plain version differ only in summation order and the one-instruction
//   exp2 (~2^-22 relative).  int8 widens exactly (a byte permute into the
//   mantissa of 2^23 and one subtraction); an int8 V row's scale s_v
//   multiplies its weights ((p * s_v) * v, where the plain version forms
//   p * (v * s_v): one f32 rounding apart, ~1e-7 relative).
// * A second kernel merges the chunks of each row in chunk order (one
//   online pass: running max, sums rescaled by powers of 2); where the live
//   keys make a single chunk, the chunk kernel writes the output itself and
//   the merge returns at once.  (Merging in the block that finishes last,
//   behind an atomic count, measured ~7 us slower at a 1088-key cache.)
// * Any head dim hd <= 128 whose cache row is a multiple of 16 bytes (TMA's
//   stride rule: bf16 hd % 8, f32 hd % 4, int8 hd % 16), with no padded
//   copy of the cache, and hd = 256 (Gemma's) for a bf16, f16 or int8
//   cache.  The tile layout is the template dim HD (64 for hd <= 64, 128
//   up to 128, else 256); the tensor maps take the real hd as the row, so
//   TMA reads hd columns from HBM and fills the rest of a column block
//   with zeros (blocks wholly past hd, which only an f32 cache has, are
//   not loaded and its score loop stops at hd).  Zero columns of q (zeroed
//   too) and K add nothing to a score and give P V columns that are never
//   stored; q, the output and the chunks' scratch use the real hd for
//   strides.  Only the ring's tiles are HD wide, so the bytes bound is the
//   real cache's.
// * Keys past the live length, and padded rows, are masked with -inf (a
//   select, so stale cache contents past the live length never reach the
//   output), on tiles that meet an edge only; P V stops at the live
//   length.

#include "hopper_tiles.cuh"

#include <math_constants.h>

namespace {

using namespace hopper;

constexpr int KT = 64;                   // keys per tile (one ring stage)
constexpr int CWARPS = 4;                // consumer warps; warp 4 is the producer
constexpr int CTHREADS = CWARPS * 32;
constexpr int THREADS = CTHREADS + 32;
constexpr int MAX_ROWS = 32;             // query rows a block holds (two m16 tiles)
constexpr int RING_BYTES = 96 * 1024;
constexpr int RING_BYTES_D256 = 128 * 1024;   // head dim 256: one block an SM
constexpr int BAR_CONSUMERS = 1;         // named barrier of the consumer warps
constexpr float LOG2E = 1.4426950408889634f;

template <typename T>
struct Elem;
template <>
struct Elem<bf16> {
  static constexpr CUtensorMapDataType TYPE = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
};
template <>
struct Elem<f16> {
  static constexpr CUtensorMapDataType TYPE = CU_TENSOR_MAP_DATA_TYPE_FLOAT16;
};
template <>
struct Elem<float> {
  static constexpr CUtensorMapDataType TYPE = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
};
template <>
struct Elem<int8_t> {
  static constexpr CUtensorMapDataType TYPE = CU_TENSOR_MAP_DATA_TYPE_UINT8;  // raw bytes
};

constexpr int clampi(int x, int lo, int hi) { return x < lo ? lo : x > hi ? hi : x; }

// Shared-memory layout of one block (offsets from a 1024-byte boundary).
// RP: the group's query rows padded to 4, 8, 16 or 32.  BLOCKS: blocks an
// SM, the launch bound (one at HD = 256, whose ring is 128 KB;
// ops/flash_attention.py DECODE_WAVE_D256).
template <typename TQ, typename TK, int HD, int RP>
struct Cfg {
  static constexpr bool QUANT = sizeof(TK) == 1;
  static constexpr bool MMA = sizeof(TK) <= 2;         // scores on the tensor cores
  static constexpr int NQ = MMA && sizeof(TQ) == 4 ? 3 : 1;  // 16-bit parts of q
  typedef std::conditional_t<is_f16<TQ>, f16, bf16> ME;     // the mma operands' type
  static constexpr int ES = sizeof(TK);
  static constexpr int RB = HD * ES;                   // bytes of a tile row
  static constexpr int CBW = RB < 128 ? RB : 128;      // column block width
  static constexpr int MASK = CBW == 128 ? 7 : 3;      // its swizzle
  static constexpr int TILE = KT * RB;                 // bytes of a K (or V) tile
  static constexpr int BLOCKS = HD <= 128 && sizeof(TK) <= 2 ? 2 : 1;   // an SM
  static constexpr int RING = HD <= 128 ? RING_BYTES : RING_BYTES_D256;
  static constexpr int STAGES = clampi(RING / (2 * TILE), 2, 8);
  static constexpr int MT = (RP + 15) / 16;            // m16 tiles of the rows
  static constexpr int QLD = HD + 8;                   // ME pitch of the q parts
  static constexpr int PP = RP + 4;                    // pitch of P's key rows
  // P V: a thread owns DPT head dims of every row over one of KS key
  // slices (keys ks, ks + KS, ...), RP * DPT <= 64 accumulators.
  static constexpr int DPT = RP <= 8 ? 8 : RP == 16 ? 4 : 2;
  static constexpr int NDG = HD / DPT;                 // dim groups
  static constexpr int KS = CTHREADS / NDG;            // key slices
  static constexpr int K = 0;                          // [stage][TILE]
  static constexpr int V = STAGES * TILE;
  static constexpr int Q = 2 * STAGES * TILE;          // ME [NQ][MT*16][QLD] or f32 [RP][HD]
  static constexpr int Q_BYTES = MMA ? NQ * MT * 16 * QLD * 2 : RP * HD * 4;
  static constexpr int S = Q + Q_BYTES;                // f32 [RP][KT] scores (log2 units)
  static constexpr int P = S + RP * KT * 4;            // f32 [KT][PP] weights
  static constexpr int CORR = P + KT * PP * 4;         // f32 [RP] rescale factors
  static constexpr int SC = CORR + RP * 4;                // f32 [stage][2][KT] scales
  static constexpr int BAR = (SC + (QUANT ? STAGES * 2 * KT * 4 : 0) + 7) / 8 * 8;
  static constexpr int BYTES = BAR + 2 * STAGES * 8;   // full[S], empty[S]
  static constexpr int ALLOC = BYTES + 1024;           // room to align the base
  static_assert(TILE % 1024 == 0 && Q % 16 == 0, "tile alignment");
  static_assert(RP % 4 == 0 && KS >= 1 && KT % KS == 0, "row layout");
  // The key slices' sums meet in the ring once the last tile is read.
  static_assert(KS * RP * HD * 4 <= 2 * STAGES * TILE, "reduction space");
};

struct Args {
  const int* pos_dev;   // device int32 pos0, or null: take pos_host
  int pos_host, g, nh, nkv, hd, max_len, window, rows, group_rows, ngroups, want, zmax;
};

struct Split {
  int first, chunk, nsplit;
};

// The live keys [first, pos0 + g) in 64-key tiles, dealt in equal runs to
// at most `want` chunks (ops/flash_attention.py decode_split mirrors it).
__device__ __forceinline__ Split decode_split(int pos0, int g, int window, int want) {
  const int first = window > 0 ? max(pos0 - window + 1, 0) : 0;
  const int ntiles = (pos0 + g - first + KT - 1) / KT;
  const int m = min(ntiles, want);
  const int per = (ntiles + m - 1) / m;
  return Split{first, per * KT, (ntiles + per - 1) / per};
}

__device__ __forceinline__ int live_pos0(const Args& a) {
  const int p = a.pos_dev != nullptr ? *a.pos_dev : a.pos_host;
  return min(max(p, 0), a.max_len - a.g);
}

__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f(f16 x) { return __half2float(x); }
__device__ __forceinline__ float to_f(float x) { return x; }

// A float rounded to nearest as an mma operand element (bf16 or f16).
template <typename E>
__device__ __forceinline__ E to_e(float x) {
  if constexpr (is_f16<E>) return __float2half_rn(x);
  else return __float2bfloat16_rn(x);
}

// A bf16 is the high half of the float with the same bits.
__device__ __forceinline__ float bf16_lo(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }

// Byte e of u (an int8 word with 0x80 XORed into each byte, so u's byte is
// x + 128) as a float, exactly: the bits 0x4B0000uu are 2^23 + x + 128.
__device__ __forceinline__ float ubyte(uint32_t u, int e) {
  return __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7640 | e)) - 8388736.f;
}

// Two int8 (the low 16 bits of w) as a bf16 (or f16: E) pair, exactly.
template <typename E>
__device__ __forceinline__ uint32_t int8x2(uint32_t w) {
  const uint32_t u = w ^ 0x8080u;
  return pack2<E>(ubyte(u, 0), ubyte(u, 1));
}

// N consecutive elements of a cache row (one 16-byte chunk or less, or
// whole chunks for f32) in shared memory, as floats.
template <int N>
__device__ __forceinline__ void widen(const bf16*, const uint8_t* p, float* out) {
  if constexpr (N == 8) {
    const uint4 w = *reinterpret_cast<const uint4*>(p);
    const uint32_t x[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) { out[2 * i] = bf16_lo(x[i]); out[2 * i + 1] = bf16_hi(x[i]); }
  } else if constexpr (N == 4) {
    const uint2 w = *reinterpret_cast<const uint2*>(p);
    out[0] = bf16_lo(w.x); out[1] = bf16_hi(w.x); out[2] = bf16_lo(w.y); out[3] = bf16_hi(w.y);
  } else {
    const uint32_t w = *reinterpret_cast<const uint32_t*>(p);
    out[0] = bf16_lo(w); out[1] = bf16_hi(w);
  }
}
template <int N>
__device__ __forceinline__ void widen(const f16*, const uint8_t* p, float* out) {
  uint32_t x[4];
  if constexpr (N == 8) {
    const uint4 w = *reinterpret_cast<const uint4*>(p);
    x[0] = w.x; x[1] = w.y; x[2] = w.z; x[3] = w.w;
  } else if constexpr (N == 4) {
    const uint2 w = *reinterpret_cast<const uint2*>(p);
    x[0] = w.x; x[1] = w.y;
  } else {
    x[0] = *reinterpret_cast<const uint32_t*>(p);
  }
#pragma unroll
  for (int i = 0; i < N / 2; ++i) {
    const float2 f = __half22float2(*reinterpret_cast<const __half2*>(&x[i]));
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}
template <int N>
__device__ __forceinline__ void widen(const float*, const uint8_t* p, float* out) {
  if constexpr (N >= 4) {
    const float4 w = *reinterpret_cast<const float4*>(p);
    out[0] = w.x; out[1] = w.y; out[2] = w.z; out[3] = w.w;
  } else {
    const float2 w = *reinterpret_cast<const float2*>(p);
    out[0] = w.x; out[1] = w.y;
  }
}
template <int N>
__device__ __forceinline__ void widen(const int8_t*, const uint8_t* p, float* out) {
  uint32_t x[2];
  if constexpr (N == 8) {
    const uint2 w = *reinterpret_cast<const uint2*>(p);
    x[0] = w.x; x[1] = w.y;
  } else if constexpr (N == 4) {
    x[0] = *reinterpret_cast<const uint32_t*>(p);
  } else {
    x[0] = *reinterpret_cast<const uint16_t*>(p);
  }
#pragma unroll
  for (int i = 0; i < (N + 3) / 4; ++i) {
    const uint32_t u = x[i] ^ 0x80808080u;
#pragma unroll
    for (int e = 0; e < 4 && 4 * i + e < N; ++e) out[4 * i + e] = ubyte(u, e);
  }
}

// Byte offset of byte `b` of row `key` in a [KT][row] tile of column blocks.
template <class C>
__device__ __forceinline__ uint32_t tile_off(int key, int b) {
  return (b / C::CBW) * (KT * C::CBW) + swizzle<C::MASK>(key * C::CBW + b % C::CBW);
}

// One chunk of one (batch row, kv head, row group) per block.  part:
// [b][nkv][zmax][rows][2 + HD] f32 = (m, l, acc) per chunk, m in log2
// units; out: [b][g][nh * HD] f32, written here only when the live keys
// make one chunk.  ks/vs: the int8 cache's scales, f32
// [b][nkv][max_len] (unused for a float cache).
template <typename TQ, typename TK, int HD, int RP>
__global__ void __launch_bounds__(THREADS, (Cfg<TQ, TK, HD, RP>::BLOCKS))
flash_decode_kernel(const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv,
               const TQ* __restrict__ q, const float* __restrict__ ks,
               const float* __restrict__ vs, float* __restrict__ part,
               float* __restrict__ out, Args a) {
  typedef Cfg<TQ, TK, HD, RP> C;
  const int kvh = blockIdx.x / a.ngroups, grp = blockIdx.x % a.ngroups;
  const int bi = blockIdx.y, sp = blockIdx.z;
  const int pos0 = live_pos0(a);
  const Split sl = decode_split(pos0, a.g, a.window, a.want);
  if (sp >= sl.nsplit) return;   // past the live keys: read nothing
  const int kbeg = sl.first + sp * sl.chunk;
  const int kend = min(kbeg + sl.chunk, pos0 + a.g);
  const int ntile = (kend - kbeg + KT - 1) / KT;

  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + C::BAR);
  uint64_t* empty = full + C::STAGES;
  float* s_s = reinterpret_cast<float*>(sm + C::S);
  float* s_p = reinterpret_cast<float*>(sm + C::P);
  float* s_c = reinterpret_cast<float*>(sm + C::CORR);
  const float* s_sc = reinterpret_cast<const float*>(sm + C::SC);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int r = a.nh / a.nkv;
  const int row0 = grp * a.group_rows;
  const int nrows = min(a.group_rows, a.rows - row0);

  if (tid == 0) {
    for (int i = 0; i < C::STAGES; ++i) {
      mbar_init(&full[i], 32);       // the producer's lanes, lane 0 with the bytes
      mbar_init(&empty[i], CWARPS);  // one arrival per consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == CWARPS) {
    // Producer: the chunk's K/V tiles through the ring; the lanes copy an
    // int8 cache's scales of the tile (0 past the chunk).
    const size_t srow = (size_t(bi) * a.nkv + kvh) * a.max_len;
    const int nblk = (a.hd * C::ES + C::CBW - 1) / C::CBW;   // blocks past hd stay unread
    for (int j = 0; j < ntile; ++j) {
      const int st = j % C::STAGES;
      const int k0 = kbeg + j * KT;
      mbar_wait(&empty[st], ((j / C::STAGES) & 1) ^ 1);
      if (C::QUANT) {
        float* sc = reinterpret_cast<float*>(sm + C::SC) + st * 2 * KT;
        for (int c = lane; c < KT; c += 32) {
          const bool in = k0 + c < kend;
          sc[c] = in ? ks[srow + k0 + c] : 0.f;
          sc[KT + c] = in ? vs[srow + k0 + c] : 0.f;
        }
      }
      if (lane == 0) {
        mbar_arrive_tx(&full[st], 2 * nblk * KT * C::CBW);
        for (int cb = 0; cb < nblk; ++cb) {
          const int off = st * C::TILE + cb * KT * C::CBW, c0 = cb * (C::CBW / C::ES);
          tma_load_4d(sm + C::K + off, &tk, &full[st], c0, kvh, k0, bi);
          tma_load_4d(sm + C::V + off, &tv, &full[st], c0, kvh, k0, bi);
        }
      } else {
        mbar_arrive(&full[st]);
      }
    }
    return;
  }

  // Consumers.  The group's rows of q into shared memory (zeros past nrows):
  // bf16 (f16 for f16 queries) parts for the tensor cores, or f32 for an
  // f32 cache.
  constexpr int QROWS = C::MMA ? C::MT * 16 : RP;
  const int hd = a.hd;
  for (int idx = tid; idx < QROWS * HD; idx += CTHREADS) {
    const int i = idx / HD, d = idx % HD;
    float x = 0.f;
    if (i < nrows && d < hd) {
      const int gi = row0 + i;
      x = to_f(q[((size_t(bi) * a.g + gi / r) * a.nh + kvh * r + gi % r) * hd + d]);
    }
    if constexpr (C::MMA) {
      typedef typename C::ME ME;
      ME* sq = reinterpret_cast<ME*>(sm + C::Q);
#pragma unroll
      for (int p = 0; p < C::NQ; ++p) {
        const ME hi = to_e<ME>(x);
        sq[(p * QROWS + i) * C::QLD + d] = hi;
        x -= to_f(hi);
      }
    } else {
      reinterpret_cast<float*>(sm + C::Q)[i * HD + d] = x;
    }
  }

  const float sl2 = rsqrtf(float(hd)) * LOG2E;   // scores to log2 units
  const uint32_t base = smem_u32(sm);
  const int li = lane >> 3, lr = lane & 7, cq = (lane & 3) * 2;
  // Softmax state of the rows this warp owns: warp, warp + 4, ...
  float m[RP / 4], l[RP / 4];
#pragma unroll
  for (int i = 0; i < RP / 4; ++i) {
    m[i] = -CUDART_INF_F;
    l[i] = 0.f;
  }
  // P V: this thread's DPT head dims of every row, over key slice kslice.
  const int dg = tid % C::NDG, kslice = tid / C::NDG;
  float o[RP][C::DPT];
#pragma unroll
  for (int i = 0; i < RP; ++i)
#pragma unroll
    for (int e = 0; e < C::DPT; ++e) o[i][e] = 0.f;
  // Rows' positions: a tile needs element masks only where it meets the
  // live end, the diagonal of its first row or the window of its last.
  const int qmin = pos0 + row0 / r, qmax = pos0 + (row0 + nrows - 1) / r;

  auto masked = [&](float x, int row, int key, int k0) {
    const int t = k0 + key, qpos = pos0 + (row0 + row) / r;
    const bool ok = row < nrows && t < kend && t <= qpos && (a.window <= 0 || t > qpos - a.window);
    return ok ? x : -CUDART_INF_F;
  };

  bar_sync(BAR_CONSUMERS, CTHREADS);   // q is in shared memory
  for (int j = 0; j < ntile; ++j) {
    const int st = j % C::STAGES;
    const int k0 = kbeg + j * KT;
    const uint32_t kt = base + C::K + st * C::TILE;
    const float* ksc = s_sc + st * 2 * KT;
    mbar_wait(&full[st], (j / C::STAGES) & 1);
    const bool edge = k0 + KT > kend || k0 + KT - 1 > qmin ||
                      (a.window > 0 && k0 <= qmax - a.window);

    // S = q K^T for 16 keys a warp (tensor cores), or one key and half the
    // rows a thread (f32 cache), scaled to log2 units and masked.
    if constexpr (C::MMA) {
      float acc[C::MT][2][4];
#pragma unroll
      for (int mt = 0; mt < C::MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        uint32_t kb[4];
        if constexpr (C::QUANT) {
#pragma unroll
          for (int nt = 0; nt < 2; ++nt) {
            const int key = warp * 16 + nt * 8 + (lane >> 2);
            const uint8_t* row = sm + C::K + st * C::TILE;
            kb[2 * nt] = int8x2<typename C::ME>(
                *reinterpret_cast<const uint16_t*>(row + tile_off<C>(key, kk * 16 + cq)));
            kb[2 * nt + 1] = int8x2<typename C::ME>(
                *reinterpret_cast<const uint16_t*>(row + tile_off<C>(key, kk * 16 + cq + 8)));
          }
        } else {
          const int key = warp * 16 + (li >> 1) * 8 + lr;
          ldmatrix_x4(kb, kt + tile_off<C>(key, (kk * 16 + (li & 1) * 8) * 2));
        }
#pragma unroll
        for (int mt = 0; mt < C::MT; ++mt)
#pragma unroll
          for (int p = 0; p < C::NQ; ++p) {
            uint32_t qa[4];
            const int qrow = p * C::MT * 16 + mt * 16 + (li & 1) * 8 + lr;
            ldmatrix_x4(qa, base + C::Q + (qrow * C::QLD + kk * 16 + (li >> 1) * 8) * 2);
            mma16816<typename C::ME>(acc[mt][0], qa, kb[0], kb[1]);
            mma16816<typename C::ME>(acc[mt][1], qa, kb[2], kb[3]);
          }
      }
#pragma unroll
      for (int mt = 0; mt < C::MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int row = mt * 16 + (lane >> 2) + (e >> 1) * 8;
            const int key = warp * 16 + nt * 8 + cq + (e & 1);
            float x = acc[mt][nt][e] * sl2;
            if (C::QUANT) x *= ksc[key];
            if (row < RP) s_s[row * KT + key] = edge ? masked(x, row, key, k0) : x;
          }
    } else {
      const int key = tid & (KT - 1), half = tid / KT;
      const float* sq = reinterpret_cast<const float*>(sm + C::Q) + half * (RP / 2) * HD;
      const uint8_t* krow = sm + C::K + st * C::TILE;
      float acc[RP / 2];
#pragma unroll
      for (int i = 0; i < RP / 2; ++i) acc[i] = 0.f;
#pragma unroll 4
      for (int c = 0; c < hd / 4; ++c) {
        const float4 kv = *reinterpret_cast<const float4*>(krow + tile_off<C>(key, c * 16));
#pragma unroll
        for (int i = 0; i < RP / 2; ++i) {
          const float4 qv = *reinterpret_cast<const float4*>(sq + i * HD + c * 4);
          acc[i] = fmaf(qv.x, kv.x, fmaf(qv.y, kv.y, fmaf(qv.z, kv.z, fmaf(qv.w, kv.w, acc[i]))));
        }
      }
#pragma unroll
      for (int i = 0; i < RP / 2; ++i) {
        const int row = half * (RP / 2) + i;
        s_s[row * KT + key] = edge ? masked(acc[i] * sl2, row, key, k0) : acc[i] * sl2;
      }
    }
    bar_sync(BAR_CONSUMERS, CTHREADS);

    // Online softmax over the tile, a row per warp at a time; a row with
    // every key masked so far keeps m = -inf and offsets by 0 (p = 0).
#pragma unroll
    for (int i = 0; i < RP / 4; ++i) {
      const int row = warp + 4 * i;
      const float x0 = s_s[row * KT + lane], x1 = s_s[row * KT + lane + 32];
      float mx = fmaxf(m[i], fmaxf(x0, x1));
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float off0 = mx == -CUDART_INF_F ? 0.f : mx;
      const float p0 = exp2_fast(x0 - off0), p1 = exp2_fast(x1 - off0);
      s_p[lane * C::PP + row] = p0;
      s_p[(lane + 32) * C::PP + row] = p1;
      float sum = p0 + p1;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      const float corr = exp2_fast(m[i] - off0);
      l[i] = l[i] * corr + sum;
      m[i] = mx;
      if (lane == 0) s_c[row] = corr;
    }
    bar_sync(BAR_CONSUMERS, CTHREADS);

    // O = O * corr + P V over this thread's keys of the tile.
    {
      const uint8_t* vrow = sm + C::V + st * C::TILE;
      const int nk = min(KT, kend - k0);
#pragma unroll
      for (int i = 0; i < RP; ++i) {
        const float c = s_c[i];
#pragma unroll
        for (int e = 0; e < C::DPT; ++e) o[i][e] *= c;
      }
#pragma unroll 2
      for (int key = kslice; key < nk; key += C::KS) {
        constexpr int CH = (C::DPT * C::ES + 15) / 16, EPC = C::DPT / CH;  // 16-byte chunks
        float v[C::DPT];
#pragma unroll
        for (int c = 0; c < CH; ++c)
          widen<EPC>(static_cast<const TK*>(nullptr),
                     vrow + tile_off<C>(key, (dg * C::DPT + c * EPC) * C::ES), v + c * EPC);
        float p[RP];
#pragma unroll
        for (int i = 0; i < RP; i += 4) {
          const float4 x = *reinterpret_cast<const float4*>(s_p + key * C::PP + i);
          p[i] = x.x; p[i + 1] = x.y; p[i + 2] = x.z; p[i + 3] = x.w;
        }
        if (C::QUANT) {   // an int8 V row's scale goes on its weights
          const float sv = ksc[KT + key];
#pragma unroll
          for (int i = 0; i < RP; ++i) p[i] *= sv;
        }
#pragma unroll
        for (int i = 0; i < RP; ++i)
#pragma unroll
          for (int e = 0; e < C::DPT; ++e) o[i][e] = fmaf(p[i], v[e], o[i][e]);
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[st]);
  }

  // The key slices' partial sums meet in the (now idle) ring and are added
  // in slice order.
  float* red = reinterpret_cast<float*>(sm + C::K);   // [KS][RP][HD]
  auto dst_row = [&](int i) {   // output row of the group's row i
    const int gi = row0 + i;
    return out + ((size_t(bi) * a.g + gi / r) * a.nh + kvh * r + gi % r) * hd;
  };
  bar_sync(BAR_CONSUMERS, CTHREADS);
#pragma unroll
  for (int i = 0; i < RP; ++i)
#pragma unroll
    for (int e = 0; e < C::DPT; e += 2)
      *reinterpret_cast<float2*>(red + (kslice * RP + i) * HD + dg * C::DPT + e) =
          make_float2(o[i][e], o[i][e + 1]);
#pragma unroll
  for (int i = 0; i < RP / 4; ++i)
    if (lane == 0) s_c[warp + 4 * i] = l[i];
  bar_sync(BAR_CONSUMERS, CTHREADS);
  if (sl.nsplit == 1) {   // one chunk: the output itself
    for (int idx = tid; idx < nrows * hd; idx += CTHREADS) {
      const int i = idx / hd, d = idx % hd;
      float sum = 0.f;
#pragma unroll
      for (int k = 0; k < C::KS; ++k) sum += red[(k * RP + i) * HD + d];
      dst_row(i)[d] = sum / s_c[i];
    }
    return;
  }

  // This chunk's (m, l, acc) per live row.
  float* mine = part + (((size_t(bi) * a.nkv + kvh) * a.zmax + sp) * a.rows + row0) * (2 + hd);
#pragma unroll
  for (int i = 0; i < RP / 4; ++i) {
    const int row = warp + 4 * i;
    if (lane == 0 && row < nrows)
      *reinterpret_cast<float2*>(mine + size_t(row) * (2 + hd)) = make_float2(m[i], l[i]);
  }
  for (int idx = tid; idx < nrows * hd; idx += CTHREADS) {
    const int i = idx / hd, d = idx % hd;
    float sum = 0.f;
#pragma unroll
    for (int k = 0; k < C::KS; ++k) sum += red[(k * RP + i) * HD + d];
    mine[size_t(i) * (2 + hd) + 2 + d] = sum;
  }
}

// Merge pass: one block per (kv head, batch row) folds the live chunks,
// one warp per query row, each lane HD/32 of its dims (nothing to do when
// the live keys make one chunk: the chunk kernel wrote the output).  One
// online pass over the chunks in order (running max, rescaled sums): the
// loads of the chunks do not depend on each other, so unrolled they are
// in flight together.
template <int HD>
__global__ void __launch_bounds__(CTHREADS)
flash_decode_merge(const float* __restrict__ part, float* __restrict__ out, Args a) {
  constexpr int EPL = HD / 32;
  const int nsplit = decode_split(live_pos0(a), a.g, a.window, a.want).nsplit;
  if (nsplit == 1) return;
  const int kvh = blockIdx.x, bi = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r = a.nh / a.nkv;
  const int hd = a.hd;
  // A lane's EPL columns lie wholly inside or past hd (a multiple of 4 for
  // every cache type); a lane past it has nothing to merge.
  if (lane * EPL >= hd) return;
  const float* base = part + (size_t(bi) * a.nkv + kvh) * a.zmax * a.rows * (2 + hd);
  const size_t sstride = size_t(a.rows) * (2 + hd);
  for (int i = warp; i < a.rows; i += CWARPS) {
    const float* row = base + size_t(i) * (2 + hd);
    float mx = -CUDART_INF_F, lsum = 0.f, o[EPL];
#pragma unroll
    for (int e = 0; e < EPL; ++e) o[e] = 0.f;
#pragma unroll 8
    for (int c = 0; c < nsplit; ++c) {
      const float* pr = row + c * sstride;
      const float2 ml = *reinterpret_cast<const float2*>(pr);
      float v[EPL];
#pragma unroll
      for (int e = 0; e < EPL; e += 2) {
        const float2 x = *reinterpret_cast<const float2*>(pr + 2 + lane * EPL + e);
        v[e] = x.x;
        v[e + 1] = x.y;
      }
      const float mn = fmaxf(mx, ml.x);
      const float off = mn == -CUDART_INF_F ? 0.f : mn;   // no live key yet: weights 0
      const float s0 = exp2f(mx - off), s1 = exp2f(ml.x - off);
      mx = mn;
      lsum = fmaf(lsum, s0, ml.y * s1);
#pragma unroll
      for (int e = 0; e < EPL; ++e) o[e] = fmaf(o[e], s0, v[e] * s1);
    }
    float* dst = out + ((size_t(bi) * a.g + i / r) * a.nh + kvh * r + i % r) * hd + lane * EPL;
#pragma unroll
    for (int e = 0; e < EPL; ++e) dst[e] = o[e] / lsum;
  }
}

struct Ptrs {
  const void *q, *ck, *cv;
  const float *ks, *vs;
  float *part, *out;
};

template <typename TQ, typename TK, int HD, int RP>
int launch(const Ptrs& p, int b, const Args& a, cudaStream_t stream) {
  typedef Cfg<TQ, TK, HD, RP> C;
  CUtensorMap tk, tv;
  int e;
  if ((e = make_map_typed(&tk, p.ck, Elem<TK>::TYPE, C::ES, a.hd, a.nkv, a.max_len, b, KT, C::CBW)) ||
      (e = make_map_typed(&tv, p.cv, Elem<TK>::TYPE, C::ES, a.hd, a.nkv, a.max_len, b, KT, C::CBW)))
    return e;
  // The shared-memory attribute once per device (a call captured into a
  // CUDA graph then makes no attribute call).
  static unsigned attr_set = 0;
  int dev = 0;
  cudaError_t ce = cudaGetDevice(&dev);
  if (ce != cudaSuccess) return int(ce);
  if (dev >= 32 || !(attr_set >> dev & 1u)) {
    ce = cudaFuncSetAttribute(flash_decode_kernel<TQ, TK, HD, RP>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize, C::ALLOC);
    if (ce != cudaSuccess) return int(ce);
    if (dev < 32) attr_set |= 1u << dev;
  }
  flash_decode_kernel<TQ, TK, HD, RP><<<dim3(a.nkv * a.ngroups, b, a.zmax), THREADS, C::ALLOC, stream>>>(
      tk, tv, static_cast<const TQ*>(p.q), p.ks, p.vs, p.part, p.out, a);
  ce = cudaGetLastError();
  if (ce != cudaSuccess) return int(ce);
  flash_decode_merge<HD><<<dim3(a.nkv, b), CTHREADS, 0, stream>>>(p.part, p.out, a);
  return int(cudaGetLastError());
}

template <typename TQ, typename TK, int HD>
int by_rows(const Ptrs& p, int b, const Args& a, cudaStream_t st) {
  if (a.group_rows <= 4) return launch<TQ, TK, HD, 4>(p, b, a, st);
  if (a.group_rows <= 8) return launch<TQ, TK, HD, 8>(p, b, a, st);
  if (a.group_rows <= 16) return launch<TQ, TK, HD, 16>(p, b, a, st);
  if (a.group_rows <= MAX_ROWS) return launch<TQ, TK, HD, MAX_ROWS>(p, b, a, st);
  return int(cudaErrorInvalidValue);
}

// The tile dim: 64 for hd <= 64, 128 for hd <= 128, 256 for hd = 256
// (Gemma's; 16-bit and int8 caches).  TMA needs the cache's row (hd
// elements) to be a multiple of 16 bytes.
template <typename TQ, typename TK>
int by_head_dim(const Ptrs& p, int b, int hd, const Args& a, cudaStream_t st) {
  if (hd <= 0 || hd * int(sizeof(TK)) % 16 != 0) return int(cudaErrorInvalidValue);
  if (hd <= 64) return by_rows<TQ, TK, 64>(p, b, a, st);
  if (hd <= 128) return by_rows<TQ, TK, 128>(p, b, a, st);
  if constexpr (sizeof(TK) <= 2) {
    if (hd == 256) return by_rows<TQ, TK, 256>(p, b, a, st);
  }
  return int(cudaErrorInvalidValue);
}

}  // namespace

// q [b, g, nh, hd]; ck/cv [b, max_len, nkv, hd], contiguous, 16-byte
// aligned, hd <= 128 with hd * sizeof(cache element) a multiple of 16, or
// hd = 256 with a bf16, f16 or int8 cache;
// out [b, g, nh*hd] f32.  Element types by code (0 bf16, 1 f32,
// 2 int8, 3 f16): q_type 0, 1 or 3; kv_type equal to q_type, or 2 with
// k_scale/v_scale f32 [b, nkv, max_len].  pos0: the int32 at `pos_dev`
// (device memory) or, when it is null, `pos_host`; clamped to [0,
// max_len - g].  window <= 0 means none.  `want`: the most chunks a
// (kv head, row group) is cut into; `zmax` = min(ceil(max_len / 64),
// want), the grid's split axis.  Row groups: ceil(rows / 32) groups of
// equal size, rows = g * nh / nkv.  scratch: f32 [b, nkv, zmax, rows,
// 2 + hd].  Returns 0 or a cudaError_t.
extern "C" int tgt_flash_decode(const void* q, const void* ck, const void* cv,
                                const void* k_scale, const void* v_scale, void* out,
                                void* scratch, const void* pos_dev, int pos_host, int b, int g,
                                int nh, int nkv, int hd, int max_len, int window, int want,
                                int zmax, int q_type, int kv_type, void* stream) {
  if (b == 0 || g == 0) return 0;
  if (nkv <= 0 || nh % nkv != 0 || want <= 0 || zmax <= 0 || max_len < g)
    return int(cudaErrorInvalidValue);
  const int rows = g * (nh / nkv);
  const int ngroups = (rows + MAX_ROWS - 1) / MAX_ROWS;
  const int group_rows = (rows + ngroups - 1) / ngroups;
  const Args a{static_cast<const int*>(pos_dev), pos_host, g, nh, nkv, hd, max_len, window, rows,
               group_rows, ngroups, want, zmax};
  const Ptrs p{q, ck, cv, static_cast<const float*>(k_scale), static_cast<const float*>(v_scale),
               static_cast<float*>(scratch), static_cast<float*>(out)};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (kv_type == 2) {
    if (k_scale == nullptr || v_scale == nullptr) return int(cudaErrorInvalidValue);
    if (q_type == 0) return by_head_dim<bf16, int8_t>(p, b, hd, a, st);
    if (q_type == 1) return by_head_dim<float, int8_t>(p, b, hd, a, st);
    if (q_type == 3) return by_head_dim<f16, int8_t>(p, b, hd, a, st);
  } else if (kv_type == q_type) {
    if (q_type == 0) return by_head_dim<bf16, bf16>(p, b, hd, a, st);
    if (q_type == 1) return by_head_dim<float, float>(p, b, hd, a, st);
    if (q_type == 3) return by_head_dim<f16, f16>(p, b, hd, a, st);
  }
  return int(cudaErrorInvalidValue);
}

// Dynamic shared memory of one flash_decode_kernel block at the main path's
// instantiation (bf16 cache, hd 128, up to 4 rows a group).
extern "C" int tgt_flash_decode_smem_bytes() { return Cfg<bf16, bf16, 128, 4>::ALLOC; }

// The same at head dim 256 (Gemma's generate: bf16 cache, up to 4 rows).
extern "C" int tgt_flash_decode_d256_smem_bytes() { return Cfg<bf16, bf16, 256, 4>::ALLOC; }
