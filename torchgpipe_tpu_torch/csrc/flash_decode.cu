// Flash decode for Hopper (sm_90a): g consecutive queries against the
// live prefix of a KV cache, GQA, causal, optional sliding window, f32 out.
// The cache is bf16 or f32 (queries of the same type), or int8 with f32
// per-(position, kv head) scales (bf16 or f32 queries).
//
// Replaces: torchgpipe_tpu/ops/flash_attention.py:_decode_kernel, both its
// float-cache variant and its int8-cache variant (quant=True).
//
// Bound on the H100: bytes.  One call reads the live K and V prefix,
// 2 * b * len * nkv * hd * sizeof(cache element) bytes (len = pos0 + g, or
// the window band), plus, for an int8 cache, two f32 scales per (row,
// position, kv head), against 3.35 TB/s; its FLOPs (4 * b * g * nh * hd *
// len) are a few per byte, far below the 295 FLOP/byte ridge of bf16.  The
// int8 cache halves the bytes of a bf16 one: K/V move through device memory
// as int8 and are widened to f32 in registers, never stored wider.
//
// Design (split-key "flash decoding"): the live keys [first, pos0 + g) are
// cut into chunks of `chunk` keys, and one block of 4 warps runs per
// (kv head x row group, batch row, chunk), so a decode step at b=4, nkv=8
// fills the card's 132 SMs instead of 32 of them.  A kv head's g*r query
// rows (row i is position pos0 + i / r, query head kvh*r + i % r, the
// reference's head-folded order) are cut into groups of at most
// GROUP_ELEMS / hd rows (8 at hd 128, 16 at hd 64); a block holds one
// group in registers, each lane holding hd/32 dims, and the groups of a
// head re-read the same K/V chunk (from L2).  So speculative verification
// at hd 128 (g = gamma + 1 = 5 at r = 4, 20 rows) runs as three groups of
// 7 instead of one block of 32 rows whose per-thread arrays (qr, acc:
// 2 x 32 x 4 floats) would spill; 16 rows at hd 128 already took 255
// registers and spilled.  Warps stride over the chunk UNROLL keys
// at a time, keeping 2 * UNROLL coalesced K/V row loads in flight, held
// raw (as few registers as the element type needs) and widened at use.
// Scores reduce across the warp with shuffles; each warp keeps an online
// softmax (max, sum, weighted V), the warps merge through shared memory,
// and the block writes its (max, sum, partial output) to a scratch
// buffer.  A second kernel merges the chunks per row.  Keys past the live
// length are never read: the cost follows the prefix, not max_len (the
// host passes the live length and sizes the chunk grid to it: 64-key
// chunks, grown on long caches so the grid stays near a thousand blocks
// and the merge pass reads few chunks).
//
// int8 rounding: the reference dequantizes every element (k * s_k, v * s_v
// in f32) before its products.  Here the scale multiplies the reduced
// score (s_k * sum(q * k)) and the softmax weight before the V update
// ((p * s_v) * v), which is the same real number; the f32 results differ
// by the rounding of one product per key instead of one per element,
// ~1e-7 relative of each score and each V term: far inside the 2e-4
// tolerance the plain version holds it to.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
// Both kernels declare a minimum of one block per SM: without it ptxas
// kept a few instantiations near 56-96 registers and spilled 4-20 bytes.
constexpr int GROUP_ELEMS = 1024;    // query rows x head dims a block holds
constexpr float NEG = -1e30f;

// One lane's EPL consecutive elements of a row: `load` reads them raw,
// `widen` converts them to float.
template <typename T, int EPL>
struct Lane;

// A bf16 is the high half of the float with the same bits; the element
// at the lower address is the low half of a little-endian word.
__device__ __forceinline__ float bf16_lo(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }

template <>
struct Lane<bf16, 4> {
  typedef uint2 raw;
  __device__ __forceinline__ static raw load(const bf16* p) {
    return *reinterpret_cast<const uint2*>(p);
  }
  __device__ __forceinline__ static void widen(raw r, float* out) {
    out[0] = bf16_lo(r.x); out[1] = bf16_hi(r.x); out[2] = bf16_lo(r.y); out[3] = bf16_hi(r.y);
  }
};

template <>
struct Lane<bf16, 2> {
  typedef uint32_t raw;
  __device__ __forceinline__ static raw load(const bf16* p) {
    return *reinterpret_cast<const uint32_t*>(p);
  }
  __device__ __forceinline__ static void widen(raw r, float* out) {
    out[0] = bf16_lo(r); out[1] = bf16_hi(r);
  }
};

template <>
struct Lane<float, 4> {
  typedef float4 raw;
  __device__ __forceinline__ static raw load(const float* p) {
    return *reinterpret_cast<const float4*>(p);
  }
  __device__ __forceinline__ static void widen(raw r, float* out) {
    out[0] = r.x; out[1] = r.y; out[2] = r.z; out[3] = r.w;
  }
};

template <>
struct Lane<float, 2> {
  typedef float2 raw;
  __device__ __forceinline__ static raw load(const float* p) {
    return *reinterpret_cast<const float2*>(p);
  }
  __device__ __forceinline__ static void widen(raw r, float* out) {
    out[0] = r.x; out[1] = r.y;
  }
};

// Byte e of a little-endian word, sign-extended.
__device__ __forceinline__ float sbyte(uint32_t w, int e) {
  return float(int(w << (24 - 8 * e)) >> 24);
}

template <>
struct Lane<int8_t, 4> {
  typedef uint32_t raw;
  __device__ __forceinline__ static raw load(const int8_t* p) {
    return *reinterpret_cast<const uint32_t*>(p);
  }
  __device__ __forceinline__ static void widen(raw r, float* out) {
    out[0] = sbyte(r, 0); out[1] = sbyte(r, 1); out[2] = sbyte(r, 2); out[3] = sbyte(r, 3);
  }
};

template <>
struct Lane<int8_t, 2> {
  typedef uint16_t raw;
  __device__ __forceinline__ static raw load(const int8_t* p) {
    return *reinterpret_cast<const uint16_t*>(p);
  }
  __device__ __forceinline__ static void widen(raw r, float* out) {
    out[0] = sbyte(r, 0); out[1] = sbyte(r, 1);
  }
};

template <typename T>
struct IsInt8 { static constexpr bool value = false; };
template <>
struct IsInt8<int8_t> { static constexpr bool value = true; };

struct Args {
  int pos0, g, nh, nkv, max_len, window, rows, chunk, nsplit;
  int group_rows, ngroups;   // row groups of one kv head: ngroups * group_rows >= rows
};

__device__ __forceinline__ int first_key(const Args& a) {
  return a.window > 0 ? max(a.pos0 - a.window + 1, 0) : 0;
}

// Partial pass.  part: [b][nkv][nsplit][rows][2 + HD] f32 = (m, l, acc).
// R: the group's query rows padded up to a power of two; rows past the
// group's count are inert.  ks/vs: the int8 cache's scales, f32
// [b][nkv][max_len] (unused for a float cache).
template <typename TQ, typename TK, int EPL, int R, int UNROLL>
__global__ void __launch_bounds__(THREADS, 1)
decode_partial(const TQ* __restrict__ q, const TK* __restrict__ ck,
               const TK* __restrict__ cv, const float* __restrict__ ks,
               const float* __restrict__ vs, float* __restrict__ part, Args a) {
  constexpr int HD = EPL * 32;
  constexpr bool QUANT = IsInt8<TK>::value;
  typedef typename Lane<TK, EPL>::raw raw_t;
  const int kvh = blockIdx.x / a.ngroups, grp = blockIdx.x % a.ngroups;
  const int bi = blockIdx.y, sp = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r = a.nh / a.nkv;
  const int row0 = grp * a.group_rows;
  const int nrows = min(a.group_rows, a.rows - row0);
  const int pos0 = a.pos0;
  const int length = pos0 + a.g;
  const int kbeg = first_key(a) + sp * a.chunk;
  const int kend = min(kbeg + a.chunk, length);
  const float scale = 1.0f / sqrtf(float(HD));

  float qr[R][EPL], acc[R][EPL], m[R], l[R];
  int qpos[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int gi = row0 + i;
    m[i] = NEG;
    l[i] = 0.f;
    qpos[i] = pos0 + gi / r;
#pragma unroll
    for (int e = 0; e < EPL; ++e) { qr[i][e] = 0.f; acc[i][e] = 0.f; }
    if (i < nrows && kbeg < kend) {
      const TQ* src = q + ((size_t(bi) * a.g + gi / r) * a.nh + kvh * r + gi % r) * HD + lane * EPL;
      Lane<TQ, EPL>::widen(Lane<TQ, EPL>::load(src), qr[i]);
#pragma unroll
      for (int e = 0; e < EPL; ++e) qr[i][e] *= scale;
    }
  }

  const size_t row_stride = size_t(a.nkv) * HD;
  const TK* kbase = ck + (size_t(bi) * a.max_len * a.nkv + kvh) * HD + lane * EPL;
  const TK* vbase = cv + (size_t(bi) * a.max_len * a.nkv + kvh) * HD + lane * EPL;
  const size_t srow = (size_t(bi) * a.nkv + kvh) * a.max_len;
  for (int t0 = kbeg + warp * UNROLL; t0 < kend; t0 += WARPS * UNROLL) {
    raw_t kr[UNROLL], vr[UNROLL];
    float ksc[UNROLL], vsc[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const bool in = t0 + u < kend;
      kr[u] = in ? Lane<TK, EPL>::load(kbase + size_t(t0 + u) * row_stride) : raw_t{};
      vr[u] = in ? Lane<TK, EPL>::load(vbase + size_t(t0 + u) * row_stride) : raw_t{};
      ksc[u] = QUANT && in ? __ldg(ks + srow + t0 + u) : 1.f;
      vsc[u] = QUANT && in ? __ldg(vs + srow + t0 + u) : 1.f;
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int t = t0 + u;
      if (t >= kend) continue;  // warp-uniform
      float kf[EPL], vf[EPL];
      Lane<TK, EPL>::widen(kr[u], kf);
      Lane<TK, EPL>::widen(vr[u], vf);
#pragma unroll
      for (int i = 0; i < R; ++i) {
        float sc = 0.f;
#pragma unroll
        for (int e = 0; e < EPL; ++e) sc = fmaf(qr[i][e], kf[e], sc);
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          sc += __shfl_xor_sync(0xffffffffu, sc, off);
        if (QUANT) sc *= ksc[u];
        const bool ok = i < nrows && t <= qpos[i] &&
                        (a.window <= 0 || t > qpos[i] - a.window);
        if (ok) {  // warp-uniform
          float p;
          if (sc > m[i]) {
            const float corr = __expf(m[i] - sc);
            l[i] *= corr;
#pragma unroll
            for (int e = 0; e < EPL; ++e) acc[i][e] *= corr;
            m[i] = sc;
            p = 1.f;
          } else {
            p = __expf(sc - m[i]);
          }
          l[i] += p;
          const float pv = QUANT ? p * vsc[u] : p;
#pragma unroll
          for (int e = 0; e < EPL; ++e) acc[i][e] = fmaf(pv, vf[e], acc[i][e]);
        }
      }
    }
  }

  // Merge the warps, then write this chunk's (m, l, acc) per row.
  __shared__ float sm_m[WARPS][R], sm_l[WARPS][R];
  __shared__ float sm_acc[WARPS][R][HD];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    if (lane == 0) {
      sm_m[warp][i] = m[i];
      sm_l[warp][i] = l[i];
    }
#pragma unroll
    for (int e = 0; e < EPL; ++e) sm_acc[warp][i][lane * EPL + e] = acc[i][e];
  }
  __syncthreads();
  float* out = part + (((size_t(bi) * a.nkv + kvh) * a.nsplit + sp) * a.rows + row0) * (2 + HD);
  for (int idx = threadIdx.x; idx < nrows * HD; idx += THREADS) {
    const int i = idx / HD, d = idx % HD;
    float mx = NEG;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) mx = fmaxf(mx, sm_m[w][i]);
    float lsum = 0.f, o = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float c = __expf(sm_m[w][i] - mx);
      lsum += sm_l[w][i] * c;
      o += sm_acc[w][i][d] * c;
    }
    float* row = out + size_t(i) * (2 + HD);
    row[2 + d] = o;
    if (d == 0) {
      row[0] = mx;
      row[1] = lsum;
    }
  }
}

// Merge pass: one block per (kv head, batch row) folds the chunks, one
// warp per query row.  Lanes stride over the chunks for the row's max and
// weights exp(m_chunk - max); then each lane owns EPL of the row's dims
// and walks the chunks, taking each chunk's weight from the lane that
// computed it, so the chunk loads are independent of each other.
template <int EPL>
__global__ void __launch_bounds__(THREADS, 1)
decode_combine(const float* __restrict__ part, float* __restrict__ out, Args a) {
  constexpr int HD = EPL * 32;
  const int kvh = blockIdx.x, bi = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r = a.nh / a.nkv;
  const float* base = part + (size_t(bi) * a.nkv + kvh) * a.nsplit * a.rows * (2 + HD);
  const size_t sstride = size_t(a.rows) * (2 + HD);
  for (int i = warp; i < a.rows; i += WARPS) {
    const float* row = base + size_t(i) * (2 + HD);
    float mx = NEG;
    for (int sp = lane; sp < a.nsplit; sp += 32) mx = fmaxf(mx, row[sp * sstride]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    float lsum = 0.f, o[EPL];
#pragma unroll
    for (int e = 0; e < EPL; ++e) o[e] = 0.f;
    for (int sp0 = 0; sp0 < a.nsplit; sp0 += 32) {
      const int sp = sp0 + lane;
      float c = 0.f;
      if (sp < a.nsplit) {
        c = __expf(row[sp * sstride] - mx);
        lsum = fmaf(row[sp * sstride + 1], c, lsum);
      }
      const int n = min(32, a.nsplit - sp0);
#pragma unroll 4
      for (int j = 0; j < n; ++j) {
        const float cj = __shfl_sync(0xffffffffu, c, j);
        const float* pr = row + size_t(sp0 + j) * sstride + 2 + lane * EPL;
#pragma unroll
        for (int e = 0; e < EPL; ++e) o[e] = fmaf(cj, pr[e], o[e]);
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      lsum += __shfl_xor_sync(0xffffffffu, lsum, off);
    float* dst = out + ((size_t(bi) * a.g + i / r) * a.nh + kvh * r + i % r) * HD + lane * EPL;
#pragma unroll
    for (int e = 0; e < EPL; ++e) dst[e] = o[e] / lsum;
  }
}

struct Ptrs {
  const void *q, *ck, *cv;
  const float *ks, *vs;
  float *part, *out;
};

template <typename TQ, typename TK, int EPL, int R>
int launch(const Ptrs& p, int b, const Args& a, cudaStream_t stream) {
  constexpr int UNROLL = IsInt8<TK>::value ? 8 : 4;  // int8 rows are 4x smaller loads
  decode_partial<TQ, TK, EPL, R, UNROLL>
      <<<dim3(a.nkv * a.ngroups, b, a.nsplit), THREADS, 0, stream>>>(
          static_cast<const TQ*>(p.q), static_cast<const TK*>(p.ck),
          static_cast<const TK*>(p.cv), p.ks, p.vs, p.part, a);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return int(e);
  decode_combine<EPL><<<dim3(a.nkv, b), THREADS, 0, stream>>>(p.part, p.out, a);
  return int(cudaGetLastError());
}

template <typename TQ, typename TK, int EPL>
int by_rows(const Ptrs& p, int b, const Args& a, cudaStream_t st) {
#define TGT_ROWS(R) \
  if (a.group_rows <= R) return launch<TQ, TK, EPL, R>(p, b, a, st);
  TGT_ROWS(1) TGT_ROWS(2) TGT_ROWS(4) TGT_ROWS(8)
  if constexpr (EPL * 32 * 16 <= GROUP_ELEMS) {
    TGT_ROWS(16)
  }
#undef TGT_ROWS
  return int(cudaErrorInvalidValue);
}

template <typename TQ, typename TK>
int by_head_dim(const Ptrs& p, int b, int hd, const Args& a, cudaStream_t st) {
  if (hd == 128) return by_rows<TQ, TK, 4>(p, b, a, st);
  if (hd == 64) return by_rows<TQ, TK, 2>(p, b, a, st);
  return int(cudaErrorInvalidValue);
}

}  // namespace

// q [b, g, nh, hd]; ck/cv [b, max_len, nkv, hd], contiguous; out [b, g,
// nh*hd] f32.  Element types by code (0 bf16, 1 f32, 2 int8): q_type 0 or
// 1; kv_type equal to q_type, or 2 with k_scale/v_scale f32 [b, nkv,
// max_len].  window <= 0 means none.  scratch: f32 [b, nkv, nsplit,
// g*nh/nkv, 2 + hd], with nsplit * chunk covering the live keys.  Returns
// cudaGetLastError().
extern "C" int tgt_flash_decode(const void* q, const void* ck, const void* cv,
                                const void* k_scale, const void* v_scale,
                                void* out, void* scratch,
                                int pos0, int b, int g, int nh, int nkv, int hd,
                                int max_len, int window, int chunk, int nsplit,
                                int q_type, int kv_type, void* stream) {
  if (b == 0 || g == 0) return 0;
  if (nkv <= 0 || nh % nkv != 0 || chunk <= 0 || nsplit <= 0)
    return int(cudaErrorInvalidValue);
  if (hd != 64 && hd != 128) return int(cudaErrorInvalidValue);
  const int rows = g * (nh / nkv);
  const int max_rows = GROUP_ELEMS / hd;
  const int ngroups = (rows + max_rows - 1) / max_rows;
  const int group_rows = (rows + ngroups - 1) / ngroups;
  Args a{pos0, g, nh, nkv, max_len, window, rows, chunk, nsplit, group_rows, ngroups};
  const Ptrs p{q, ck, cv, static_cast<const float*>(k_scale),
               static_cast<const float*>(v_scale), static_cast<float*>(scratch),
               static_cast<float*>(out)};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (kv_type == 2) {
    if (k_scale == nullptr || v_scale == nullptr) return int(cudaErrorInvalidValue);
    if (q_type == 0) return by_head_dim<bf16, int8_t>(p, b, hd, a, st);
    if (q_type == 1) return by_head_dim<float, int8_t>(p, b, hd, a, st);
  } else if (kv_type == q_type) {
    if (q_type == 0) return by_head_dim<bf16, bf16>(p, b, hd, a, st);
    if (q_type == 1) return by_head_dim<float, float>(p, b, hd, a, st);
  }
  return int(cudaErrorInvalidValue);
}
