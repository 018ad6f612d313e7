// Flash decode for Hopper (sm_90a): g consecutive queries against the
// live prefix of a KV cache, GQA, causal, optional sliding window, f32 out.
//
// Replaces: torchgpipe_tpu/ops/flash_attention.py:_decode_kernel (the
// bf16/f32 cache variant; the int8-cache variant is not ported yet).
//
// Bound on the H100: bytes.  One call reads the live K and V prefix,
// 2 * b * len * nkv * hd * sizeof(T) bytes (len = pos0 + g, or the window
// band), against 3.35 TB/s; its FLOPs (4 * b * g * nh * hd * len) are a
// few per byte, far below the 295 FLOP/byte ridge of bf16.
//
// Design (split-key "flash decoding"): the live keys [first, pos0 + g) are
// cut into chunks of `chunk` keys, and one block of 4 warps runs per
// (kv head, batch row, chunk), so a decode step at b=4, nkv=8 fills the
// card's 132 SMs instead of 32 of them.  In a block, the g*r query rows
// of the kv head (row i is position pos0 + i / r, query head kvh*r + i % r,
// the reference's head-folded order) sit in registers, each lane holding
// hd/32 dims; warps stride over the chunk four keys at a time, so every
// warp keeps eight coalesced 256-byte K/V row loads in flight.  Scores
// reduce across the warp with shuffles; each warp keeps an online softmax
// (max, sum, weighted V), the warps merge through shared memory, and the
// block writes its (max, sum, partial output) to a scratch buffer.  A
// second kernel merges the chunks per row.  Keys past the live length
// are never read: the cost follows the prefix, not max_len (the host
// passes the live length and sizes the chunk grid to it).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int UNROLL = 4;            // keys in flight per warp
constexpr float NEG = -1e30f;

template <typename T, int EPL>
__device__ __forceinline__ void load_row(const T* p, float* out);

template <>
__device__ __forceinline__ void load_row<bf16, 4>(const bf16* p, float* out) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  out[0] = a.x; out[1] = a.y; out[2] = b.x; out[3] = b.y;
}

template <>
__device__ __forceinline__ void load_row<bf16, 2>(const bf16* p, float* out) {
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
  out[0] = a.x; out[1] = a.y;
}

template <>
__device__ __forceinline__ void load_row<float, 4>(const float* p, float* out) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
}

template <>
__device__ __forceinline__ void load_row<float, 2>(const float* p, float* out) {
  const float2 a = *reinterpret_cast<const float2*>(p);
  out[0] = a.x; out[1] = a.y;
}

struct Args {
  int pos0, g, nh, nkv, max_len, window, rows, chunk, nsplit;
};

__device__ __forceinline__ int first_key(const Args& a) {
  return a.window > 0 ? max(a.pos0 - a.window + 1, 0) : 0;
}

// Partial pass.  part: [b][nkv][nsplit][rows][2 + HD] f32 = (m, l, acc).
// R: query rows padded up to a power of two; rows >= a.rows are inert.
template <typename T, int EPL, int R>
__global__ void __launch_bounds__(THREADS)
decode_partial(const T* __restrict__ q, const T* __restrict__ ck,
               const T* __restrict__ cv, float* __restrict__ part, Args a) {
  constexpr int HD = EPL * 32;
  const int kvh = blockIdx.x, bi = blockIdx.y, sp = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r = a.nh / a.nkv;
  const int pos0 = a.pos0;
  const int length = pos0 + a.g;
  const int kbeg = first_key(a) + sp * a.chunk;
  const int kend = min(kbeg + a.chunk, length);
  const float scale = 1.0f / sqrtf(float(HD));

  float qr[R][EPL], acc[R][EPL], m[R], l[R];
  int qpos[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    m[i] = NEG;
    l[i] = 0.f;
    qpos[i] = pos0 + i / r;
#pragma unroll
    for (int e = 0; e < EPL; ++e) { qr[i][e] = 0.f; acc[i][e] = 0.f; }
    if (i < a.rows && kbeg < kend) {
      const T* src = q + ((size_t(bi) * a.g + i / r) * a.nh + kvh * r + i % r) * HD + lane * EPL;
      load_row<T, EPL>(src, qr[i]);
#pragma unroll
      for (int e = 0; e < EPL; ++e) qr[i][e] *= scale;
    }
  }

  const size_t row_stride = size_t(a.nkv) * HD;
  const T* kbase = ck + (size_t(bi) * a.max_len * a.nkv + kvh) * HD + lane * EPL;
  const T* vbase = cv + (size_t(bi) * a.max_len * a.nkv + kvh) * HD + lane * EPL;
  for (int t0 = kbeg + warp * UNROLL; t0 < kend; t0 += WARPS * UNROLL) {
    float kf[UNROLL][EPL], vf[UNROLL][EPL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      if (t0 + u < kend) {
        load_row<T, EPL>(kbase + size_t(t0 + u) * row_stride, kf[u]);
        load_row<T, EPL>(vbase + size_t(t0 + u) * row_stride, vf[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int t = t0 + u;
      if (t >= kend) break;
#pragma unroll
      for (int i = 0; i < R; ++i) {
        float sc = 0.f;
#pragma unroll
        for (int e = 0; e < EPL; ++e) sc = fmaf(qr[i][e], kf[u][e], sc);
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          sc += __shfl_xor_sync(0xffffffffu, sc, off);
        const bool ok = i < a.rows && t <= qpos[i] &&
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
#pragma unroll
          for (int e = 0; e < EPL; ++e) acc[i][e] = fmaf(p, vf[u][e], acc[i][e]);
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
  float* out = part + ((size_t(bi) * a.nkv + kvh) * a.nsplit + sp) * a.rows * (2 + HD);
  for (int idx = threadIdx.x; idx < a.rows * HD; idx += THREADS) {
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

// Merge pass: one block per (kv head, batch row) folds the chunks.
template <int HD>
__global__ void __launch_bounds__(THREADS)
decode_combine(const float* __restrict__ part, float* __restrict__ out, Args a) {
  const int kvh = blockIdx.x, bi = blockIdx.y;
  const int r = a.nh / a.nkv;
  const float* base = part + (size_t(bi) * a.nkv + kvh) * a.nsplit * a.rows * (2 + HD);
  const size_t sstride = size_t(a.rows) * (2 + HD);
  for (int idx = threadIdx.x; idx < a.rows * HD; idx += THREADS) {
    const int i = idx / HD, d = idx % HD;
    const float* row = base + size_t(i) * (2 + HD);
    float mx = NEG;
    for (int sp = 0; sp < a.nsplit; ++sp) mx = fmaxf(mx, row[sp * sstride]);
    float lsum = 0.f, o = 0.f;
    for (int sp = 0; sp < a.nsplit; ++sp) {
      const float* pr = row + sp * sstride;
      const float c = __expf(pr[0] - mx);
      lsum += pr[1] * c;
      o += pr[2 + d] * c;
    }
    out[((size_t(bi) * a.g + i / r) * a.nh + kvh * r + i % r) * HD + d] = o / lsum;
  }
}

template <typename T, int EPL, int R>
int launch(const void* q, const void* ck, const void* cv, float* part, float* out,
           int b, const Args& a, cudaStream_t stream) {
  decode_partial<T, EPL, R><<<dim3(a.nkv, b, a.nsplit), THREADS, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(ck), static_cast<const T*>(cv),
      part, a);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return int(e);
  decode_combine<EPL * 32><<<dim3(a.nkv, b), THREADS, 0, stream>>>(part, out, a);
  return int(cudaGetLastError());
}

template <typename T, int EPL>
int by_rows(const void* q, const void* ck, const void* cv, float* part, float* out,
            int b, const Args& a, cudaStream_t st) {
#define TGT_ROWS(R) \
  if (a.rows <= R) return launch<T, EPL, R>(q, ck, cv, part, out, b, a, st);
  TGT_ROWS(1) TGT_ROWS(2) TGT_ROWS(4) TGT_ROWS(8) TGT_ROWS(16)
#undef TGT_ROWS
  return int(cudaErrorInvalidValue);
}

}  // namespace

// q [b, g, nh, hd], ck/cv [b, max_len, nkv, hd] of one type (bf16, or f32
// when is_f32), contiguous; out [b, g, nh*hd] f32.  window <= 0 means
// none.  scratch: f32 [b, nkv, nsplit, g*nh/nkv, 2 + hd], with
// nsplit * chunk covering the live keys.  Returns cudaGetLastError().
extern "C" int tgt_flash_decode(const void* q, const void* ck, const void* cv,
                                void* out, void* scratch,
                                int pos0, int b, int g, int nh, int nkv, int hd,
                                int max_len, int window, int chunk, int nsplit,
                                int is_f32, void* stream) {
  if (b == 0 || g == 0) return 0;
  if (nkv <= 0 || nh % nkv != 0 || chunk <= 0 || nsplit <= 0)
    return int(cudaErrorInvalidValue);
  Args a{pos0, g, nh, nkv, max_len, window,
         g * (nh / nkv), chunk, nsplit};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* o = static_cast<float*>(out);
  float* part = static_cast<float*>(scratch);
  if (is_f32) {
    if (hd == 128) return by_rows<float, 4>(q, ck, cv, part, o, b, a, st);
    if (hd == 64) return by_rows<float, 2>(q, ck, cv, part, o, b, a, st);
  } else {
    if (hd == 128) return by_rows<bf16, 4>(q, ck, cv, part, o, b, a, st);
    if (hd == 64) return by_rows<bf16, 2>(q, ck, cv, part, o, b, a, st);
  }
  return int(cudaErrorInvalidValue);
}
