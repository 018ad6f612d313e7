// Flash attention on the CUDA cores (sm_90a), for what the tensor-core
// kernels (flash_fwd.cu, flash_bwd.cu, flash_decode.cu) have no
// instantiation for:
//
// * float32 q/k/v at a head dim TMA cannot map (d % 4 != 0, up to 128),
//   and wide head dims: the forward (O and the per-row logsumexp) and dQ
//   in bf16 or float16 at head dims 129 to 255 and in float32 at 129 to
//   256 (bf16 and float16 at exactly 256, Gemma's, run flash_fwd.cu's and
//   flash_bwd.cu's d = 256 instantiations: ops/flash_attention.py
//   wide_kernel), and dK/dV summed over each kv head's query heads at
//   every wide head dim in all three types.  Replaces:
//   torchgpipe_tpu/ops/flash_attention.py:_fwd_kernel, :_dq_kernel and
//   :_dkv_kernel at those shapes (the Pallas kernels take any d % 128 == 0
//   and load their operands `.astype(jnp.float32)`), which the wgmma
//   kernels have no tile for.
// * decode at a head dim the tensor-core decode cannot map (a cache row
//   not a multiple of 16 bytes, or hd from 129 to 256): g consecutive
//   queries against the live prefix of a bf16, float16, f32 or int8 cache.
//   Replaces :_decode_kernel at those dims; no padded copy of the cache
//   is made.
//
// The design is the plain one, to be right first: every element is
// widened to f32 as it is loaded and every product is an f32 FMA, so the
// kernels agree with the plain PyTorch versions (which compute in f32 from
// the same elements) up to the order of summation; outputs are rounded
// once to the element type.
//
// * Forward and dQ: a block takes 32 query rows of one (batch, head), L
//   threads a row (L = 4 up to d = 128, 8 up to d = 256: 128 or 256
//   threads).  K and V stream through shared memory 32 keys at a time (row
//   pitch d + 1, so the rows and the keys a warp reads at one step fall on
//   distinct banks).  A thread scores 32/L keys of its row (keys c, c + L,
//   ...), the row's max and sum meet by shuffles among the row's L lanes,
//   and the thread owns head dims c, c + L, ... of the output (at most 32
//   accumulators at either L).  Causal tiles above the diagonal and tiles
//   below a window's band are never visited.  At d = 256 the tiles take
//   103-140 KB of shared memory, above the 48 KB default, so each kernel
//   opts in to its largest size once per device.
// * dK/dV: a block takes 32 keys of one (batch, kv head), L threads a key,
//   and walks the query tiles (and query heads of the group) that see
//   them, accumulating dK and dV in registers: no atomics.
// * Decode: a block per (query head, query row, batch row).  The live keys
//   go by in tiles of 128, one key a thread; the tile's max and sum meet
//   through shared memory; thread t owns head dims t and t + 128 of the
//   output.  The live length is read from the device (`pos_dev`) or taken
//   from the host, as flash_decode.cu does, so a captured call replays at
//   any length.
//
// Bounds (H100): the forward and backward do ~4 (fwd) and ~10 (bwd)
// FLOPs per (query, key, dim) against 67 TFLOP/s of f32 FMA; decode reads
// the live K and V prefix once per query head and row, against 3.35 TB/s
// for the bytes it must move (once).  Tensor-core designs of dK/dV and the
// decode at d = 256 are later steps (ROADMAP B follow-up 11).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int BQ = 32;       // query rows of a forward / dQ block
constexpr int BK = 32;       // keys of a K/V tile, and of a dK/dV block
constexpr int ACC = 32;      // head dims a thread owns (d <= 32 * L)
constexpr int DMAX = 256;    // largest head dim
constexpr int THREADS = 128; // decode block
constexpr int DEC_TILE = 128;  // decode keys per tile: one a thread
constexpr int DEC_ACC = DMAX / THREADS;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }
__device__ __forceinline__ float to_f32(int8_t x) { return float(x); }

__device__ __forceinline__ void from_f32(float* p, float x) { *p = x; }
__device__ __forceinline__ void from_f32(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }
__device__ __forceinline__ void from_f32(__half* p, float x) { *p = __float2half_rn(x); }

__device__ __forceinline__ bool visible(int qi, int kj, int sk, int causal, int window) {
  if (kj >= sk) return false;
  if (!causal) return true;
  return kj <= qi && (window <= 0 || kj > qi - window);
}

// Max (or sum) over the L consecutive lanes of a row.
template <int L>
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int o = 1; o < L; o <<= 1) x = fmaxf(x, __shfl_xor_sync(FULL, x, o));
  return x;
}

template <int L>
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int o = 1; o < L; o <<= 1) x += __shfl_xor_sync(FULL, x, o);
  return x;
}

// Rows [r0, r0 + n) of a [rows, heads, d] slice (row stride heads * d)
// into shared memory as f32 at pitch `pitch`, zeros past `limit`, by NT
// threads (a compile-time stride: with the block size read at run time
// the forward took 141 registers and ran slower).
template <int NT, typename T>
__device__ __forceinline__ void load_rows(float* dst, int pitch, const T* src, int r0, int n,
                                          int limit, int stride, int d) {
  for (int i = threadIdx.x; i < n * d; i += NT) {
    const int rr = i / d, dd = i - rr * d;
    const int row = r0 + rr;
    dst[rr * pitch + dd] = row < limit ? to_f32(src[(size_t)row * stride + dd]) : 0.f;
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

// q [b, s, h, d], k/v [b, sk, g, d], o [b, s, h, d] in T; lse [b*h, s] f32.
// At four lanes a row, five blocks an SM: ptxas then fits the forward in
// 94 registers without spilling (left alone it chose 96 and spilled).
template <typename T, int L>
__global__ void __launch_bounds__(32 * L, L == 4 ? 5 : 1) fwd_simt_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ o, float* __restrict__ lse, int s, int sk, int h, int g, int d,
    float scale, int causal, int window) {
  extern __shared__ float sm[];
  const int P = d + 1;
  float* Qs = sm;             // [BQ][P]
  float* Ks = Qs + BQ * P;    // [BK][P]
  float* Vs = Ks + BK * P;    // [BK][P]
  float* Ps = Vs + BK * P;    // [BQ][BK + 1]
  const int tid = threadIdx.x, r = tid / L, c = tid % L;
  const int q0 = blockIdx.x * BQ;
  const int bi = blockIdx.y / h, hi = blockIdx.y % h, kvh = hi / (h / g);
  const int qi = q0 + r;
  load_rows<32 * L>(Qs, P, q + ((size_t)bi * s * h + hi) * d, q0, BQ, s, h * d, d);
  int lo, hiq;
  key_range(q0, s, sk, causal, window, &lo, &hiq);
  float m = -CUDART_INF_F, l = 0.f;
  float acc[ACC];
#pragma unroll
  for (int j = 0; j < ACC; ++j) acc[j] = 0.f;
  const T* kb = k + ((size_t)bi * sk * g + kvh) * d;
  const T* vb = v + ((size_t)bi * sk * g + kvh) * d;
  for (int k0 = lo - lo % BK; k0 < hiq; k0 += BK) {
    __syncthreads();
    load_rows<32 * L>(Ks, P, kb, k0, BK, sk, g * d, d);
    load_rows<32 * L>(Vs, P, vb, k0, BK, sk, g * d, d);
    __syncthreads();
    float sv[BK / L];
    float mt = -CUDART_INF_F;
#pragma unroll
    for (int jj = 0; jj < BK / L; ++jj) {
      const int kk = c + L * jj;
      float dot = 0.f;
      for (int t = 0; t < d; ++t) dot = fmaf(Qs[r * P + t], Ks[kk * P + t], dot);
      sv[jj] = visible(qi, k0 + kk, sk, causal, window) ? dot * scale : -CUDART_INF_F;
      mt = fmaxf(mt, sv[jj]);
    }
    const float mn = fmaxf(m, row_max<L>(mt));
    const float base = mn == -CUDART_INF_F ? 0.f : mn;  // an all-masked row keeps p = 0
    const float alpha = expf(m - base);
    float ls = 0.f;
#pragma unroll
    for (int jj = 0; jj < BK / L; ++jj) {
      const float p = expf(sv[jj] - base);
      Ps[r * (BK + 1) + c + L * jj] = p;
      ls += p;
    }
    l = l * alpha + row_sum<L>(ls);
    m = mn;
    __syncwarp();
#pragma unroll
    for (int j = 0; j < ACC; ++j) acc[j] *= alpha;
    for (int kk = 0; kk < BK; ++kk) {
      const float p = Ps[r * (BK + 1) + kk];
#pragma unroll
      for (int j = 0; j < ACC; ++j)
        if (c + L * j < d) acc[j] = fmaf(p, Vs[kk * P + c + L * j], acc[j]);
    }
  }
  if (qi >= s) return;
  const float inv = l > 0.f ? 1.f / l : 0.f;
  T* orow = o + (((size_t)bi * s + qi) * h + hi) * d;
#pragma unroll
  for (int j = 0; j < ACC; ++j)
    if (c + L * j < d) from_f32(orow + c + L * j, acc[j] * inv);
  if (c == 0) lse[(size_t)blockIdx.y * s + qi] = l > 0.f ? m + logf(l) : -CUDART_INF_F;
}

// dq [b, s, h, d] from do [b, s, h, d] (T), lse and delta [b*h, s] (f32).
template <typename T, int L>
__global__ void __launch_bounds__(32 * L) dq_simt_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, T* __restrict__ dq, int s, int sk, int h, int g, int d,
    float scale, int causal, int window) {
  extern __shared__ float sm[];
  const int P = d + 1;
  float* Qs = sm;             // [BQ][P]
  float* Ds = Qs + BQ * P;    // dO [BQ][P]
  float* Ks = Ds + BQ * P;    // [BK][P]
  float* Vs = Ks + BK * P;    // [BK][P]
  float* Ss = Vs + BK * P;    // dS [BQ][BK + 1]
  const int tid = threadIdx.x, r = tid / L, c = tid % L;
  const int q0 = blockIdx.x * BQ;
  const int bi = blockIdx.y / h, hi = blockIdx.y % h, kvh = hi / (h / g);
  const int qi = q0 + r;
  const size_t qoff = ((size_t)bi * s * h + hi) * d;
  load_rows<32 * L>(Qs, P, q + qoff, q0, BQ, s, h * d, d);
  load_rows<32 * L>(Ds, P, dout + qoff, q0, BQ, s, h * d, d);
  const float lr = qi < s ? lse[(size_t)blockIdx.y * s + qi] : 0.f;
  const float dr = qi < s ? delta[(size_t)blockIdx.y * s + qi] : 0.f;
  int lo, hiq;
  key_range(q0, s, sk, causal, window, &lo, &hiq);
  float acc[ACC];
#pragma unroll
  for (int j = 0; j < ACC; ++j) acc[j] = 0.f;
  const T* kb = k + ((size_t)bi * sk * g + kvh) * d;
  const T* vb = v + ((size_t)bi * sk * g + kvh) * d;
  for (int k0 = lo - lo % BK; k0 < hiq; k0 += BK) {
    __syncthreads();
    load_rows<32 * L>(Ks, P, kb, k0, BK, sk, g * d, d);
    load_rows<32 * L>(Vs, P, vb, k0, BK, sk, g * d, d);
    __syncthreads();
#pragma unroll
    for (int jj = 0; jj < BK / L; ++jj) {
      const int kk = c + L * jj;
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
        if (c + L * j < d) acc[j] = fmaf(ds, Ks[kk * P + c + L * j], acc[j]);
    }
  }
  if (qi >= s) return;
  T* row = dq + (((size_t)bi * s + qi) * h + hi) * d;
#pragma unroll
  for (int j = 0; j < ACC; ++j)
    if (c + L * j < d) from_f32(row + c + L * j, acc[j] * scale);
}

// dk, dv [b, sk, g, d]: a block per 32 keys of one (batch, kv head).
template <typename T, int L>
__global__ void __launch_bounds__(32 * L) dkv_simt_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv, int s,
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
  const int tid = threadIdx.x, kr = tid / L, c = tid % L;
  const int k0 = blockIdx.x * BK;
  const int bi = blockIdx.y / g, kvh = blockIdx.y % g, rep = h / g;
  const int kj = k0 + kr;
  const size_t koff = ((size_t)bi * sk * g + kvh) * d;
  load_rows<32 * L>(Ks, P, k + koff, k0, BK, sk, g * d, d);
  load_rows<32 * L>(Vs, P, v + koff, k0, BK, sk, g * d, d);
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
      load_rows<32 * L>(Qs, P, q + qoff, q0, BQ, s, h * d, d);
      load_rows<32 * L>(Ds, P, dout + qoff, q0, BQ, s, h * d, d);
      if (tid < BQ) {
        Ls[tid] = q0 + tid < s ? lrow[q0 + tid] : 0.f;
        Es[tid] = q0 + tid < s ? erow[q0 + tid] : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int jj = 0; jj < BQ / L; ++jj) {
        const int qq = c + L * jj, qi = q0 + qq;
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
          if (c + L * j < d) {
            av[j] = fmaf(p, Ds[qq * P + c + L * j], av[j]);
            ak[j] = fmaf(ds, Qs[qq * P + c + L * j], ak[j]);
          }
        }
      }
    }
  }
  if (kj >= sk) return;
  const size_t out = (((size_t)bi * sk + kj) * g + kvh) * d;
#pragma unroll
  for (int j = 0; j < ACC; ++j) {
    if (c + L * j < d) {
      from_f32(dk + out + c + L * j, ak[j] * scale);
      from_f32(dv + out + c + L * j, av[j]);
    }
  }
}

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
  for (int t = tid; t < hd; t += THREADS) qs[t] = to_f32(q[qrow + t]);
  __syncthreads();
  const size_t stride = (size_t)nkv * hd;  // between positions
  const TK* kb = ck + ((size_t)bi * max_len * nkv + kvh) * hd;
  const TK* vb = cv + ((size_t)bi * max_len * nkv + kvh) * hd;
  const float* ksr = ks != nullptr ? ks + ((size_t)bi * nkv + kvh) * max_len : nullptr;
  const float* vsr = vs != nullptr ? vs + ((size_t)bi * nkv + kvh) * max_len : nullptr;
  float m = -CUDART_INF_F, l = 0.f, acc[DEC_ACC];
#pragma unroll
  for (int e = 0; e < DEC_ACC; ++e) acc[e] = 0.f;
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
    const int n = min(DEC_TILE, end - k0);
#pragma unroll
    for (int e = 0; e < DEC_ACC; ++e) {
      const int t = tid + e * THREADS;
      if (t < hd) {
        float a = acc[e] * alpha;
        for (int kk = 0; kk < n; ++kk) {
          const float vv = to_f32(vb[(size_t)(k0 + kk) * stride + t]);
          a = fmaf(ps[kk], vsr != nullptr ? vv * vsr[k0 + kk] : vv, a);
        }
        acc[e] = a;
      }
    }
  }
#pragma unroll
  for (int e = 0; e < DEC_ACC; ++e) {
    const int t = tid + e * THREADS;
    if (t < hd) out[qrow + t] = acc[e] / l;
  }
}

// Shared memory of one block (bytes) at head dim d: 0 forward, 1 dQ,
// 2 dK/dV.
int smem_bytes(int which, int d) {
  const int P = d + 1;
  if (which == 0) return (BQ * P + 2 * BK * P + BQ * (BK + 1)) * 4;
  if (which == 1) return (2 * BQ * P + 2 * BK * P + BQ * (BK + 1)) * 4;
  return (2 * BK * P + 2 * BQ * P + 2 * BK * (BQ + 1) + 2 * BQ) * 4;
}

// The kernel's dynamic shared memory limit raised to its largest size (d =
// 32 * L), once per device (a call captured into a CUDA graph then makes
// no attribute call).
template <typename K>
int allow_smem(K* kernel, int which, int dmax, unsigned* done) {
  int dev = 0;
  cudaError_t ce = cudaGetDevice(&dev);
  if (ce != cudaSuccess) return int(ce);
  if (dev < 32 && (*done >> dev & 1u)) return 0;
  ce = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                            smem_bytes(which, dmax));
  if (ce != cudaSuccess) return int(ce);
  if (dev < 32) *done |= 1u << dev;
  return 0;
}

bool shape_ok(int b, int s, int sk, int h, int g, int d) {
  return b > 0 && s > 0 && sk > 0 && g > 0 && h % g == 0 && d > 0 && d <= DMAX;
}

struct Attn {
  const void *q, *k, *v, *dout, *lse, *delta;
  void *o, *out_lse, *dq, *dk, *dv;
  int b, s, sk, h, g, d;
  float scale;
  int causal, window;
  cudaStream_t st;
};

// which: 0 forward, 1 dQ, 2 dK/dV.
template <typename T, int L>
int run(int which, const Attn& a) {
  static unsigned done[3] = {0, 0, 0};
  const int bytes = smem_bytes(which, a.d);
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  int e;
  if (which == 0) {
    if ((e = allow_smem(fwd_simt_kernel<T, L>, 0, 32 * L, &done[0]))) return e;
    fwd_simt_kernel<T, L><<<dim3((a.s + BQ - 1) / BQ, a.b * a.h), 32 * L, bytes, a.st>>>(
        q, k, v, static_cast<T*>(a.o), static_cast<float*>(a.out_lse), a.s, a.sk, a.h, a.g, a.d,
        a.scale, a.causal, a.window);
  } else if (which == 1) {
    if ((e = allow_smem(dq_simt_kernel<T, L>, 1, 32 * L, &done[1]))) return e;
    dq_simt_kernel<T, L><<<dim3((a.s + BQ - 1) / BQ, a.b * a.h), 32 * L, bytes, a.st>>>(
        q, k, v, static_cast<const T*>(a.dout), static_cast<const float*>(a.lse),
        static_cast<const float*>(a.delta), static_cast<T*>(a.dq), a.s, a.sk, a.h, a.g, a.d,
        a.scale, a.causal, a.window);
  } else {
    if ((e = allow_smem(dkv_simt_kernel<T, L>, 2, 32 * L, &done[2]))) return e;
    dkv_simt_kernel<T, L><<<dim3((a.sk + BK - 1) / BK, a.b * a.g), 32 * L, bytes, a.st>>>(
        q, k, v, static_cast<const T*>(a.dout), static_cast<const float*>(a.lse),
        static_cast<const float*>(a.delta), static_cast<T*>(a.dk), static_cast<T*>(a.dv), a.s,
        a.sk, a.h, a.g, a.d, a.scale, a.causal, a.window);
  }
  return int(cudaGetLastError());
}

// Element type by code (0 bf16, 1 f32, 3 f16, as flash_decode.cu's), and
// four lanes a row up to d = 128, eight above.
int dispatch(int which, int type, const Attn& a) {
  if (!shape_ok(a.b, a.s, a.sk, a.h, a.g, a.d)) return int(cudaErrorInvalidValue);
  const bool wide = a.d > 128;
  if (type == 1) return wide ? run<float, 8>(which, a) : run<float, 4>(which, a);
  if (type == 0) return wide ? run<__nv_bfloat16, 8>(which, a) : run<__nv_bfloat16, 4>(which, a);
  if (type == 3) return wide ? run<__half, 8>(which, a) : run<__half, 4>(which, a);
  return int(cudaErrorInvalidValue);
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

// q [b, s, h, d], k/v [b, sk, g, d], o [b, s, h, d] contiguous, all of the
// element type `type` (0 bf16, 1 f32, 3 f16); lse [b*h, s] f32.  d <= 256.
// window <= 0 means none.  Returns 0 or a cudaError_t.
extern "C" int tgt_flash_fwd_simt(const void* q, const void* k, const void* v, void* o,
                                  void* lse, int b, int s, int sk, int h, int g, int d,
                                  float scale, int causal, int window, int type, void* stream) {
  Attn a{q, k, v, nullptr, nullptr, nullptr, o, lse, nullptr, nullptr, nullptr,
         b, s, sk, h, g, d, scale, causal, window, static_cast<cudaStream_t>(stream)};
  return dispatch(0, type, a);
}

// dq [b, s, h, d] from do [b, s, h, d] (the element type) and lse, delta
// [b*h, s] f32.
extern "C" int tgt_flash_bwd_dq_simt(const void* q, const void* k, const void* v,
                                     const void* dout, const void* lse, const void* delta,
                                     void* dq, int b, int s, int sk, int h, int g, int d,
                                     float scale, int causal, int window, int type,
                                     void* stream) {
  Attn a{q, k, v, dout, lse, delta, nullptr, nullptr, dq, nullptr, nullptr,
         b, s, sk, h, g, d, scale, causal, window, static_cast<cudaStream_t>(stream)};
  return dispatch(1, type, a);
}

// dk, dv [b, sk, g, d] (summed over each kv head's h/g query heads).
extern "C" int tgt_flash_bwd_dkv_simt(const void* q, const void* k, const void* v,
                                      const void* dout, const void* lse, const void* delta,
                                      void* dk, void* dv, int b, int s, int sk, int h, int g,
                                      int d, float scale, int causal, int window, int type,
                                      void* stream) {
  Attn a{q, k, v, dout, lse, delta, nullptr, nullptr, nullptr, dk, dv,
         b, s, sk, h, g, d, scale, causal, window, static_cast<cudaStream_t>(stream)};
  return dispatch(2, type, a);
}

// Decode: q [b, g, nh, hd]; ck/cv [b, max_len, nkv, hd] contiguous; out
// [b, g, nh*hd] f32; hd <= 256.  Type codes as flash_decode.cu's (0 bf16,
// 1 f32, 2 int8 with k_scale/v_scale f32 [b, nkv, max_len], 3 f16).
// pos0: the int32 at `pos_dev` or, when it is null, `pos_host`; clamped to
// [0, max_len - g].
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
    if (q_type == 3) return TGT_DECODE(__half, int8_t);
  } else if (kv_type == q_type) {
    if (q_type == 0) return TGT_DECODE(__nv_bfloat16, __nv_bfloat16);
    if (q_type == 1) return TGT_DECODE(float, float);
    if (q_type == 3) return TGT_DECODE(__half, __half);
  }
#undef TGT_DECODE
  return int(cudaErrorInvalidValue);
}
