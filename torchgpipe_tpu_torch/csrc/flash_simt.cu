// Flash attention on the CUDA cores (sm_90a), for what the tensor-core
// kernels (flash_fwd.cu, flash_bwd.cu, flash_decode.cu) have no
// instantiation for:
//
// * float32 q/k/v at any head dim up to 128: the forward (O and the
//   per-row logsumexp), dQ, and dK/dV summed over each kv head's query
//   heads.  Replaces: torchgpipe_tpu/ops/flash_attention.py:_fwd_kernel,
//   :_dq_kernel and :_dkv_kernel at float32 (the Pallas kernels take
//   float32 operands, `.astype(jnp.float32)`), which the bf16 wgmma
//   kernels do not.
// * decode at a head dim the tensor-core decode has no instantiation for
//   (below 128, other than 64): g consecutive queries against the live
//   prefix of a bf16, f32 or int8 cache.  Replaces :_decode_kernel at
//   those dims; the reference routes them to XLA's dense read, and no
//   padded copy of the cache is made here either.
//
// The design is the plain one, to be right first: every product in f32
// FMAs, so the kernels agree with the plain PyTorch versions up to the
// order of summation.
//
// * Forward and dQ: a block takes 32 query rows of one (batch, head),
//   four threads a row.  K and V stream through shared memory 32 keys at
//   a time (row pitch d + 1, so the four rows and the four keys a warp
//   reads at one step fall on distinct banks).  A thread scores 8 keys of
//   its row (keys c, c + 4, ...), the row's max and sum meet by two
//   shuffles, and the thread owns head dims c, c + 4, ... of the output
//   (at most 32 accumulators).  Causal tiles above the diagonal and
//   tiles below a window's band are never visited.
// * dK/dV: a block takes 32 keys of one (batch, kv head), four threads a
//   key, and walks the query tiles (and query heads of the group) that
//   see them, accumulating dK and dV in registers: no atomics.
// * Decode: a block per (query head, query row, batch row).  The live keys
//   go by in tiles of 128, one key a thread; the tile's max and sum meet
//   through shared memory; thread t owns head dim t of the output.  The
//   live length is read from the device (`pos_dev`) or taken from the
//   host, as flash_decode.cu does, so a captured call replays at any
//   length.
//
// Bounds (H100): the forward and backward do ~4 (fwd) and ~10 (bwd)
// FLOPs per (query, key, dim) against 67 TFLOP/s of f32 FMA; decode reads
// the live K and V prefix once per query head and row, against 3.35 TB/s
// for the bytes it must move (once).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int BQ = 32;       // query rows of a forward / dQ block
constexpr int BK = 32;       // keys of a K/V tile, and of a dK/dV block
constexpr int THREADS = 128; // four threads a row (or a key)
constexpr int DMAX = 128;    // largest head dim
constexpr int ACC = DMAX / 4;
constexpr int DEC_TILE = 128;  // decode keys per tile: one a thread
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ bool visible(int qi, int kj, int sk, int causal, int window) {
  if (kj >= sk) return false;
  if (!causal) return true;
  return kj <= qi && (window <= 0 || kj > qi - window);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(FULL, x, 1));
  return fmaxf(x, __shfl_xor_sync(FULL, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(FULL, x, 1);
  return x + __shfl_xor_sync(FULL, x, 2);
}

// Rows [r0, r0 + n) of a [rows, heads, d] slice (row stride heads * d)
// into shared memory at pitch `pitch`, zeros past `limit`.
__device__ __forceinline__ void load_rows(float* dst, int pitch, const float* src, int r0, int n,
                                          int limit, int stride, int d) {
  for (int i = threadIdx.x; i < n * d; i += THREADS) {
    const int rr = i / d, dd = i - rr * d;
    const int row = r0 + rr;
    dst[rr * pitch + dd] = row < limit ? src[(size_t)row * stride + dd] : 0.f;
  }
}

// The keys [lo, hi) the query rows [q0, q0 + BQ) can see.
__device__ __forceinline__ void key_range(int q0, int s, int sk, int causal, int window, int* lo,
                                          int* hi) {
  *lo = 0;
  *hi = sk;
  if (causal) {
    *hi = min(sk, min(s, q0 + BQ));
    if (window > 0) *lo = max(0, q0 - window + 1);
  }
}

// q [b, s, h, d], k/v [b, sk, g, d], o [b, s, h, d], lse [b*h, s].
__global__ void __launch_bounds__(THREADS) fwd_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    float* __restrict__ o, float* __restrict__ lse, int s, int sk, int h, int g, int d,
    float scale, int causal, int window) {
  extern __shared__ float sm[];
  const int P = d + 1;
  float* Qs = sm;             // [BQ][P]
  float* Ks = Qs + BQ * P;    // [BK][P]
  float* Vs = Ks + BK * P;    // [BK][P]
  float* Ps = Vs + BK * P;    // [BQ][BK + 1]
  const int tid = threadIdx.x, r = tid >> 2, c = tid & 3;
  const int q0 = blockIdx.x * BQ;
  const int bi = blockIdx.y / h, hi = blockIdx.y % h, kvh = hi / (h / g);
  const int qi = q0 + r;
  load_rows(Qs, P, q + ((size_t)bi * s * h + hi) * d, q0, BQ, s, h * d, d);
  int lo, hiq;
  key_range(q0, s, sk, causal, window, &lo, &hiq);
  float m = -CUDART_INF_F, l = 0.f;
  float acc[ACC];
#pragma unroll
  for (int j = 0; j < ACC; ++j) acc[j] = 0.f;
  const float* kb = k + ((size_t)bi * sk * g + kvh) * d;
  const float* vb = v + ((size_t)bi * sk * g + kvh) * d;
  for (int k0 = lo - lo % BK; k0 < hiq; k0 += BK) {
    __syncthreads();
    load_rows(Ks, P, kb, k0, BK, sk, g * d, d);
    load_rows(Vs, P, vb, k0, BK, sk, g * d, d);
    __syncthreads();
    float sv[BK / 4];
    float mt = -CUDART_INF_F;
#pragma unroll
    for (int jj = 0; jj < BK / 4; ++jj) {
      const int kk = c + 4 * jj;
      float dot = 0.f;
      for (int t = 0; t < d; ++t) dot = fmaf(Qs[r * P + t], Ks[kk * P + t], dot);
      sv[jj] = visible(qi, k0 + kk, sk, causal, window) ? dot * scale : -CUDART_INF_F;
      mt = fmaxf(mt, sv[jj]);
    }
    const float mn = fmaxf(m, quad_max(mt));
    const float base = mn == -CUDART_INF_F ? 0.f : mn;  // an all-masked row keeps p = 0
    const float alpha = expf(m - base);
    float ls = 0.f;
#pragma unroll
    for (int jj = 0; jj < BK / 4; ++jj) {
      const float p = expf(sv[jj] - base);
      Ps[r * (BK + 1) + c + 4 * jj] = p;
      ls += p;
    }
    l = l * alpha + quad_sum(ls);
    m = mn;
    __syncwarp();
#pragma unroll
    for (int j = 0; j < ACC; ++j) acc[j] *= alpha;
    for (int kk = 0; kk < BK; ++kk) {
      const float p = Ps[r * (BK + 1) + kk];
#pragma unroll
      for (int j = 0; j < ACC; ++j)
        if (c + 4 * j < d) acc[j] = fmaf(p, Vs[kk * P + c + 4 * j], acc[j]);
    }
  }
  if (qi >= s) return;
  const float inv = l > 0.f ? 1.f / l : 0.f;
  float* orow = o + (((size_t)bi * s + qi) * h + hi) * d;
#pragma unroll
  for (int j = 0; j < ACC; ++j)
    if (c + 4 * j < d) orow[c + 4 * j] = acc[j] * inv;
  if (c == 0) lse[(size_t)blockIdx.y * s + qi] = l > 0.f ? m + logf(l) : -CUDART_INF_F;
}

// dq [b, s, h, d] from do [b, s, h, d], lse and delta [b*h, s].
__global__ void __launch_bounds__(THREADS) dq_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, float* __restrict__ dq, int s, int sk, int h, int g, int d,
    float scale, int causal, int window) {
  extern __shared__ float sm[];
  const int P = d + 1;
  float* Qs = sm;             // [BQ][P]
  float* Ds = Qs + BQ * P;    // dO [BQ][P]
  float* Ks = Ds + BQ * P;    // [BK][P]
  float* Vs = Ks + BK * P;    // [BK][P]
  float* Ss = Vs + BK * P;    // dS [BQ][BK + 1]
  const int tid = threadIdx.x, r = tid >> 2, c = tid & 3;
  const int q0 = blockIdx.x * BQ;
  const int bi = blockIdx.y / h, hi = blockIdx.y % h, kvh = hi / (h / g);
  const int qi = q0 + r;
  const size_t qoff = ((size_t)bi * s * h + hi) * d;
  load_rows(Qs, P, q + qoff, q0, BQ, s, h * d, d);
  load_rows(Ds, P, dout + qoff, q0, BQ, s, h * d, d);
  const float lr = qi < s ? lse[(size_t)blockIdx.y * s + qi] : 0.f;
  const float dr = qi < s ? delta[(size_t)blockIdx.y * s + qi] : 0.f;
  int lo, hiq;
  key_range(q0, s, sk, causal, window, &lo, &hiq);
  float acc[ACC];
#pragma unroll
  for (int j = 0; j < ACC; ++j) acc[j] = 0.f;
  const float* kb = k + ((size_t)bi * sk * g + kvh) * d;
  const float* vb = v + ((size_t)bi * sk * g + kvh) * d;
  for (int k0 = lo - lo % BK; k0 < hiq; k0 += BK) {
    __syncthreads();
    load_rows(Ks, P, kb, k0, BK, sk, g * d, d);
    load_rows(Vs, P, vb, k0, BK, sk, g * d, d);
    __syncthreads();
#pragma unroll
    for (int jj = 0; jj < BK / 4; ++jj) {
      const int kk = c + 4 * jj;
      float ds = 0.f;
      if (qi < s && visible(qi, k0 + kk, sk, causal, window)) {
        float sc = 0.f, dp = 0.f;
        for (int t = 0; t < d; ++t) {
          sc = fmaf(Qs[r * P + t], Ks[kk * P + t], sc);
          dp = fmaf(Ds[r * P + t], Vs[kk * P + t], dp);
        }
        const float p = expf(sc * scale - lr);
        ds = p * (dp - dr);
      }
      Ss[r * (BK + 1) + kk] = ds;
    }
    __syncwarp();
    for (int kk = 0; kk < BK; ++kk) {
      const float ds = Ss[r * (BK + 1) + kk];
#pragma unroll
      for (int j = 0; j < ACC; ++j)
        if (c + 4 * j < d) acc[j] = fmaf(ds, Ks[kk * P + c + 4 * j], acc[j]);
    }
  }
  if (qi >= s) return;
  float* row = dq + (((size_t)bi * s + qi) * h + hi) * d;
#pragma unroll
  for (int j = 0; j < ACC; ++j)
    if (c + 4 * j < d) row[c + 4 * j] = acc[j] * scale;
}

// dk, dv [b, sk, g, d]: a block per 32 keys of one (batch, kv head).
__global__ void __launch_bounds__(THREADS) dkv_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, float* __restrict__ dk, float* __restrict__ dv, int s,
    int sk, int h, int g, int d, float scale, int causal, int window) {
  extern __shared__ float sm[];
  const int P = d + 1;
  float* Ks = sm;                  // [BK][P]
  float* Vs = Ks + BK * P;         // [BK][P]
  float* Qs = Vs + BK * P;         // [BQ][P]
  float* Ds = Qs + BQ * P;         // dO [BQ][P]
  float* Pt = Ds + BQ * P;         // P^T [BK][BQ + 1]
  float* St = Pt + BK * (BQ + 1);  // dS^T [BK][BQ + 1]
  float* Ls = St + BK * (BQ + 1);  // lse [BQ]
  float* Es = Ls + BQ;             // delta [BQ]
  const int tid = threadIdx.x, kr = tid >> 2, c = tid & 3;
  const int k0 = blockIdx.x * BK;
  const int bi = blockIdx.y / g, kvh = blockIdx.y % g, rep = h / g;
  const int kj = k0 + kr;
  const size_t koff = ((size_t)bi * sk * g + kvh) * d;
  load_rows(Ks, P, k + koff, k0, BK, sk, g * d, d);
  load_rows(Vs, P, v + koff, k0, BK, sk, g * d, d);
  // The queries that see keys [k0, k0 + BK).
  int qlo = 0, qhi = s;
  if (causal) {
    qlo = k0;
    if (window > 0) qhi = min(s, k0 + BK - 1 + window);
  }
  float ak[ACC], av[ACC];
#pragma unroll
  for (int j = 0; j < ACC; ++j) ak[j] = av[j] = 0.f;
  for (int hi = kvh * rep; hi < (kvh + 1) * rep; ++hi) {
    const size_t qoff = ((size_t)bi * s * h + hi) * d;
    const float* lrow = lse + ((size_t)bi * h + hi) * s;
    const float* erow = delta + ((size_t)bi * h + hi) * s;
    for (int q0 = qlo - qlo % BQ; q0 < qhi; q0 += BQ) {
      __syncthreads();
      load_rows(Qs, P, q + qoff, q0, BQ, s, h * d, d);
      load_rows(Ds, P, dout + qoff, q0, BQ, s, h * d, d);
      if (tid < BQ) {
        Ls[tid] = q0 + tid < s ? lrow[q0 + tid] : 0.f;
        Es[tid] = q0 + tid < s ? erow[q0 + tid] : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int jj = 0; jj < BQ / 4; ++jj) {
        const int qq = c + 4 * jj, qi = q0 + qq;
        float p = 0.f, ds = 0.f;
        if (qi < s && visible(qi, kj, sk, causal, window)) {
          float sc = 0.f, dp = 0.f;
          for (int t = 0; t < d; ++t) {
            sc = fmaf(Qs[qq * P + t], Ks[kr * P + t], sc);
            dp = fmaf(Ds[qq * P + t], Vs[kr * P + t], dp);
          }
          p = expf(sc * scale - Ls[qq]);
          ds = p * (dp - Es[qq]);
        }
        Pt[kr * (BQ + 1) + qq] = p;
        St[kr * (BQ + 1) + qq] = ds;
      }
      __syncwarp();
      for (int qq = 0; qq < BQ; ++qq) {
        const float p = Pt[kr * (BQ + 1) + qq], ds = St[kr * (BQ + 1) + qq];
#pragma unroll
        for (int j = 0; j < ACC; ++j) {
          if (c + 4 * j < d) {
            av[j] = fmaf(p, Ds[qq * P + c + 4 * j], av[j]);
            ak[j] = fmaf(ds, Qs[qq * P + c + 4 * j], ak[j]);
          }
        }
      }
    }
  }
  if (kj >= sk) return;
  const size_t out = (((size_t)bi * sk + kj) * g + kvh) * d;
#pragma unroll
  for (int j = 0; j < ACC; ++j) {
    if (c + 4 * j < d) {
      dk[out + c + 4 * j] = ak[j] * scale;
      dv[out + c + 4 * j] = av[j];
    }
  }
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(int8_t x) { return float(x); }

// Max (or sum) of one value a thread over the block, through `red`.
template <bool MAX>
__device__ __forceinline__ float block_reduce(float x, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float y = __shfl_xor_sync(FULL, x, o);
    x = MAX ? fmaxf(x, y) : x + y;
  }
  const int w = threadIdx.x >> 5;
  __syncthreads();  // the previous reduction's reads of `red` are done
  if ((threadIdx.x & 31) == 0) red[w] = x;
  __syncthreads();
  x = red[0];
#pragma unroll
  for (int i = 1; i < THREADS / 32; ++i) x = MAX ? fmaxf(x, red[i]) : x + red[i];
  return x;
}

// q [b, g, nh, hd]; ck/cv [b, max_len, nkv, hd]; scales [b, nkv, max_len]
// (int8 only); out [b, g, nh*hd] f32.  Grid (nh, g, b).
template <typename TQ, typename TK>
__global__ void __launch_bounds__(THREADS) decode_simt_kernel(
    const TQ* __restrict__ q, const TK* __restrict__ ck, const TK* __restrict__ cv,
    const float* __restrict__ ks, const float* __restrict__ vs, float* __restrict__ out,
    const int* __restrict__ pos_dev, int pos_host, int g, int nh, int nkv, int hd, int max_len,
    int window, float scale) {
  __shared__ float qs[DMAX];
  __shared__ float ps[DEC_TILE];
  __shared__ float red[THREADS / 32];
  const int tid = threadIdx.x;
  const int head = blockIdx.x, i = blockIdx.y, bi = blockIdx.z;
  const int kvh = head / (nh / nkv);
  int pos0 = pos_dev != nullptr ? *pos_dev : pos_host;
  pos0 = min(max(pos0, 0), max_len - g);
  const int qpos = pos0 + i;
  const int lo = window > 0 ? max(0, qpos - window + 1) : 0, end = qpos + 1;
  const size_t qrow = (((size_t)bi * g + i) * nh + head) * hd;
  if (tid < hd) qs[tid] = to_f32(q[qrow + tid]);
  __syncthreads();
  const size_t stride = (size_t)nkv * hd;  // between positions
  const TK* kb = ck + ((size_t)bi * max_len * nkv + kvh) * hd;
  const TK* vb = cv + ((size_t)bi * max_len * nkv + kvh) * hd;
  const float* ksr = ks != nullptr ? ks + ((size_t)bi * nkv + kvh) * max_len : nullptr;
  const float* vsr = vs != nullptr ? vs + ((size_t)bi * nkv + kvh) * max_len : nullptr;
  float m = -CUDART_INF_F, l = 0.f, acc = 0.f;
  for (int k0 = lo; k0 < end; k0 += DEC_TILE) {
    const int kj = k0 + tid;
    float sc = -CUDART_INF_F;
    if (kj < end) {
      const TK* kr = kb + (size_t)kj * stride;
      const float s_k = ksr != nullptr ? ksr[kj] : 1.f;
      float dot = 0.f;
      for (int t = 0; t < hd; ++t) {
        const float kv = ksr != nullptr ? to_f32(kr[t]) * s_k : to_f32(kr[t]);
        dot = fmaf(qs[t], kv, dot);
      }
      sc = dot * scale;
    }
    const float mn = fmaxf(m, block_reduce<true>(sc, red));  // finite: key k0 is live
    const float alpha = expf(m - mn);
    const float p = expf(sc - mn);
    ps[tid] = p;
    l = l * alpha + block_reduce<false>(p, red);  // its barriers publish ps
    m = mn;
    if (tid < hd) {
      acc *= alpha;
      const int n = min(DEC_TILE, end - k0);
      for (int kk = 0; kk < n; ++kk) {
        const float vv = to_f32(vb[(size_t)(k0 + kk) * stride + tid]);
        acc = fmaf(ps[kk], vsr != nullptr ? vv * vsr[k0 + kk] : vv, acc);
      }
    }
  }
  if (tid < hd) out[qrow + tid] = acc / l;
}

// Shared memory of one block (bytes) at head dim d: 0 forward, 1 dQ,
// 2 dK/dV.
int smem_bytes(int which, int d) {
  const int P = d + 1;
  if (which == 0) return (BQ * P + 2 * BK * P + BQ * (BK + 1)) * 4;
  if (which == 1) return (2 * BQ * P + 2 * BK * P + BQ * (BK + 1)) * 4;
  return (2 * BK * P + 2 * BQ * P + 2 * BK * (BQ + 1) + 2 * BQ) * 4;
}

// The kernel's dynamic shared memory limit raised to its d = 128 size,
// once per device (a call captured into a CUDA graph then makes no
// attribute call).
template <typename K>
int allow_smem(K* kernel, int which, unsigned* done) {
  int dev = 0;
  cudaError_t ce = cudaGetDevice(&dev);
  if (ce != cudaSuccess) return int(ce);
  if (dev < 32 && (*done >> dev & 1u)) return 0;
  ce = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                            smem_bytes(which, DMAX));
  if (ce != cudaSuccess) return int(ce);
  if (dev < 32) *done |= 1u << dev;
  return 0;
}

bool shape_ok(int b, int s, int sk, int h, int g, int d) {
  return b > 0 && s > 0 && sk > 0 && g > 0 && h % g == 0 && d > 0 && d <= DMAX;
}

template <typename TQ, typename TK>
int launch_decode(const void* q, const void* ck, const void* cv, const void* k_scale,
                  const void* v_scale, void* out, const void* pos_dev, int pos_host, int b, int g,
                  int nh, int nkv, int hd, int max_len, int window, float scale,
                  cudaStream_t st) {
  decode_simt_kernel<TQ, TK><<<dim3(nh, g, b), THREADS, 0, st>>>(
      static_cast<const TQ*>(q), static_cast<const TK*>(ck), static_cast<const TK*>(cv),
      static_cast<const float*>(k_scale), static_cast<const float*>(v_scale),
      static_cast<float*>(out), static_cast<const int*>(pos_dev), pos_host, g, nh, nkv, hd,
      max_len, window, scale);
  return int(cudaGetLastError());
}

}  // namespace

// Shared memory of one block (bytes) at head dim d: forward, dQ, dK/dV.
extern "C" int tgt_flash_simt_smem_bytes(int which, int d) { return smem_bytes(which, d); }

// q [b, s, h, d], k/v [b, sk, g, d], o [b, s, h, d] f32 contiguous; lse
// [b*h, s] f32.  d <= 128.  window <= 0 means none.  Returns 0 or a
// cudaError_t.
extern "C" int tgt_flash_fwd_f32(const void* q, const void* k, const void* v, void* o,
                                 void* lse, int b, int s, int sk, int h, int g, int d,
                                 float scale, int causal, int window, void* stream) {
  if (!shape_ok(b, s, sk, h, g, d)) return int(cudaErrorInvalidValue);
  static unsigned done = 0;
  const int bytes = smem_bytes(0, d);
  int e = allow_smem(fwd_f32_kernel, 0, &done);
  if (e) return e;
  fwd_f32_kernel<<<dim3((s + BQ - 1) / BQ, b * h), THREADS, bytes,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), static_cast<float*>(lse), s, sk, h, g, d, scale, causal, window);
  return int(cudaGetLastError());
}

// dq [b, s, h, d] from do [b, s, h, d] and lse, delta [b*h, s], all f32.
extern "C" int tgt_flash_bwd_dq_f32(const void* q, const void* k, const void* v,
                                    const void* dout, const void* lse, const void* delta,
                                    void* dq, int b, int s, int sk, int h, int g, int d,
                                    float scale, int causal, int window, void* stream) {
  if (!shape_ok(b, s, sk, h, g, d)) return int(cudaErrorInvalidValue);
  static unsigned done = 0;
  const int bytes = smem_bytes(1, d);
  int e = allow_smem(dq_f32_kernel, 1, &done);
  if (e) return e;
  dq_f32_kernel<<<dim3((s + BQ - 1) / BQ, b * h), THREADS, bytes,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<float*>(dq), s, sk, h, g, d, scale, causal,
      window);
  return int(cudaGetLastError());
}

// dk, dv [b, sk, g, d] (summed over each kv head's h/g query heads).
extern "C" int tgt_flash_bwd_dkv_f32(const void* q, const void* k, const void* v,
                                     const void* dout, const void* lse, const void* delta,
                                     void* dk, void* dv, int b, int s, int sk, int h, int g,
                                     int d, float scale, int causal, int window, void* stream) {
  if (!shape_ok(b, s, sk, h, g, d)) return int(cudaErrorInvalidValue);
  static unsigned done = 0;
  const int bytes = smem_bytes(2, d);
  int e = allow_smem(dkv_f32_kernel, 2, &done);
  if (e) return e;
  dkv_f32_kernel<<<dim3((sk + BK - 1) / BK, b * g), THREADS, bytes,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<float*>(dk), static_cast<float*>(dv), s, sk,
      h, g, d, scale, causal, window);
  return int(cudaGetLastError());
}

// Decode: q [b, g, nh, hd]; ck/cv [b, max_len, nkv, hd] contiguous; out
// [b, g, nh*hd] f32.  Type codes as flash_decode.cu's (0 bf16, 1 f32, 2
// int8 with k_scale/v_scale f32 [b, nkv, max_len]).  pos0: the int32 at
// `pos_dev` or, when it is null, `pos_host`; clamped to [0, max_len - g].
extern "C" int tgt_flash_decode_simt(const void* q, const void* ck, const void* cv,
                                     const void* k_scale, const void* v_scale, void* out,
                                     const void* pos_dev, int pos_host, int b, int g, int nh,
                                     int nkv, int hd, int max_len, int window, float scale,
                                     int q_type, int kv_type, void* stream) {
  if (b == 0 || g == 0) return 0;
  if (nkv <= 0 || nh % nkv != 0 || hd <= 0 || hd > DMAX || max_len < g)
    return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define TGT_DECODE(TQ, TK)                                                                  \
  launch_decode<TQ, TK>(q, ck, cv, k_scale, v_scale, out, pos_dev, pos_host, b, g, nh, nkv, \
                        hd, max_len, window, scale, st)
  if (kv_type == 2) {
    if (k_scale == nullptr || v_scale == nullptr) return int(cudaErrorInvalidValue);
    if (q_type == 0) return TGT_DECODE(__nv_bfloat16, int8_t);
    if (q_type == 1) return TGT_DECODE(float, int8_t);
  } else if (kv_type == q_type) {
    if (q_type == 0) return TGT_DECODE(__nv_bfloat16, __nv_bfloat16);
    if (q_type == 1) return TGT_DECODE(float, float);
  }
#undef TGT_DECODE
  return int(cudaErrorInvalidValue);
}
