// Flash attention on the CUDA cores (sm_90a), for what the tensor-core
// kernels (flash_fwd.cu, flash_bwd.cu, flash_decode.cu) have no
// instantiation for:
//
// * float32 q/k/v at a head dim TMA cannot map (d % 4 != 0, up to 128),
//   and wide head dims: the forward (O and the per-row logsumexp), dQ
//   and dK/dV (summed over each kv head's query heads) in bf16, float16
//   or float32 at head dims 129 to 255 and at the multiples of 128 above
//   256 (any d runs: up to DMAX on the row kernels, above it on the
//   chunked ones), and in float32 at 256 (bf16 and float16 at exactly 256,
//   Gemma's, run the d = 256 instantiations of flash_fwd.cu and
//   flash_bwd.cu: ops/flash_attention.py wide_kernel).  Replaces:
//   torchgpipe_tpu/ops/flash_attention.py:_fwd_kernel, :_dq_kernel and
//   :_dkv_kernel at those shapes (the Pallas kernels take any d % 128 == 0
//   and load their operands `.astype(jnp.float32)`), which the wgmma
//   kernels have no tile for.
// * decode at a head dim the tensor-core decode cannot map (a cache row
//   not a multiple of 16 bytes, hd from 129 to 255, a multiple of 128
//   above 256, or a float32 cache at 256): g consecutive
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
//   threads a row (L = 4 up to d = 128, 8 up to d = 256, 16 up to d =
//   512: 128, 256 or 512 threads).  K and V stream through shared memory
//   32 keys at a time (16 in dQ at sixteen lanes; row pitch d + 1, so the
//   rows and the keys a warp reads at one step fall on distinct banks).
//   A thread scores keys c, c + L, ... of its row, the row's max and sum
//   meet by shuffles among the row's L lanes, and the thread owns head
//   dims c, c + L, ... of the output (at most 32 accumulators at any L).
//   Causal tiles above the diagonal and tiles below a window's band are
//   never visited.  From d = 256 the tiles take 103-202 KB of shared
//   memory, above the 48 KB default, so each kernel opts in to its
//   largest size once per device; at d = 512 whole 32-key K/V tiles and
//   32-query Q/dO tiles together would pass the 227 KB opt-in, so dQ
//   takes 16-key tiles and dK/dV 16-query tiles there (inner_tile).
// * dK/dV: a block takes 32 keys of one (batch, kv head), L threads a key,
//   and walks the query tiles (and query heads of the group) that see
//   them, accumulating dK and dV in registers: no atomics.
// * Above DMAX (the chunked kernels, sixteen lanes a row): a row no
//   longer fits registers and shared memory whole, so the output head dim
//   is split over the grid (blockIdx.z) in chunks of DC = DMAX columns.
//   A block owns one chunk of O, dQ, dK or dV.  It still forms the scores
//   S = Q K^T (and dP = dO V^T) over the whole head dim, streaming DS =
//   128 columns of Q, K (dO, V) at a time through shared memory, and then
//   reads only its chunk's columns of V (K, Q, dO) for the products that
//   make its output.  Every chunk's block forms S and dP in the same order
//   of sums, so each gets the same max, sum and logsumexp bit for bit;
//   only chunk 0 writes the logsumexp.  The extra S/dP work a chunk (d /
//   DC times that of one block) is the price of a simple kernel.
// * Decode: a block per (query head, query row, batch row).  The live keys
//   go by in tiles of 128, one key a thread; the tile's max and sum meet
//   through shared memory; thread t owns head dims t, t + 128, ... of
//   the output (above DMAX the grid splits the output dims in chunks of
//   DMAX, as the chunked kernels do, and q streams through shared memory
//   DMAX dims at a time).  The live length is read from the device (`pos_dev`) or taken
//   from the host, as flash_decode.cu does, so a captured call replays at
//   any length.
//
// Bounds (H100): the forward and backward do ~4 (fwd) and ~10 (bwd)
// FLOPs per (query, key, dim) against 67 TFLOP/s of f32 FMA; decode reads
// the live K and V prefix once per query head and row, against 3.35 TB/s
// for the bytes it must move (once).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int BQ = 32;       // query rows of a forward / dQ block
constexpr int BK = 32;       // keys of a K/V tile, and of a dK/dV block
constexpr int ACC = 32;      // head dims a thread owns (d <= 32 * L)
constexpr int DMAX = 512;    // largest head dim of the row kernels (and a chunk's width)
constexpr int DS = 128;      // head dims a chunked kernel streams at a time for S and dP
constexpr int DC = DMAX;     // output head dims of a chunked kernel's block
constexpr int LC = 16;       // lanes a row in the chunked kernels (ACC * LC == DC)
constexpr int THREADS = 128; // decode block
constexpr int DEC_TILE = 128;  // decode keys per tile: one a thread
constexpr int DEC_ACC = DMAX / THREADS;
constexpr unsigned FULL = 0xffffffffu;

// Lanes a row (or key) at head dim d: 4 up to 128, 8 up to 256, 16 above.
__host__ __device__ constexpr int lanes(int d) { return d > 256 ? 16 : d > 128 ? 8 : 4; }

// The dQ kernel's key tile and the dK/dV kernel's query tile at L lanes:
// 16 at sixteen lanes, so that both fit the 227 KB opt-in at d = 512.
__host__ __device__ constexpr int inner_tile(int L) { return L == 16 ? 16 : 32; }

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

// Columns [c0, c0 + nc) of rows [r0, r0 + n) of a [rows, heads, d] slice
// into shared memory as f32 at pitch `pitch` (load_rows for a chunk of
// the head dim).
template <int NT, typename T>
__device__ __forceinline__ void load_cols(float* dst, int pitch, const T* src, int r0, int n,
                                          int limit, int stride, int c0, int nc) {
  for (int i = threadIdx.x; i < n * nc; i += NT) {
    const int rr = i / nc, cc = i - rr * nc;
    const int row = r0 + rr;
    dst[rr * pitch + cc] = row < limit ? to_f32(src[(size_t)row * stride + c0 + cc]) : 0.f;
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
  constexpr int KT = inner_tile(L);  // keys a tile
  extern __shared__ float sm[];
  const int P = d + 1;
  float* Qs = sm;             // [BQ][P]
  float* Ds = Qs + BQ * P;    // dO [BQ][P]
  float* Ks = Ds + BQ * P;    // [KT][P]
  float* Vs = Ks + KT * P;    // [KT][P]
  float* Ss = Vs + KT * P;    // dS [BQ][KT + 1]
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
  for (int k0 = lo - lo % KT; k0 < hiq; k0 += KT) {
    __syncthreads();
    load_rows<32 * L>(Ks, P, kb, k0, KT, sk, g * d, d);
    load_rows<32 * L>(Vs, P, vb, k0, KT, sk, g * d, d);
    __syncthreads();
#pragma unroll
    for (int jj = 0; jj < KT / L; ++jj) {
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
      Ss[r * (KT + 1) + kk] = ds;
    }
    __syncwarp();
    for (int kk = 0; kk < KT; ++kk) {
      const float ds = Ss[r * (KT + 1) + kk];
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
  constexpr int QT = inner_tile(L);  // queries a tile
  extern __shared__ float sm[];
  const int P = d + 1;
  float* Ks = sm;                  // [BK][P]
  float* Vs = Ks + BK * P;         // [BK][P]
  float* Qs = Vs + BK * P;         // [QT][P]
  float* Ds = Qs + QT * P;         // dO [QT][P]
  float* Pt = Ds + QT * P;         // P^T [BK][QT + 1]
  float* St = Pt + BK * (QT + 1);  // dS^T [BK][QT + 1]
  float* Ls = St + BK * (QT + 1);  // lse [QT]
  float* Es = Ls + QT;             // delta [QT]
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
    for (int q0 = qlo - qlo % QT; q0 < qhi; q0 += QT) {
      __syncthreads();
      load_rows<32 * L>(Qs, P, q + qoff, q0, QT, s, h * d, d);
      load_rows<32 * L>(Ds, P, dout + qoff, q0, QT, s, h * d, d);
      if (tid < QT) {
        Ls[tid] = q0 + tid < s ? lrow[q0 + tid] : 0.f;
        Es[tid] = q0 + tid < s ? erow[q0 + tid] : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int jj = 0; jj < QT / L; ++jj) {
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
        Pt[kr * (QT + 1) + qq] = p;
        St[kr * (QT + 1) + qq] = ds;
      }
      __syncwarp();
      for (int qq = 0; qq < QT; ++qq) {
        const float p = Pt[kr * (QT + 1) + qq], ds = St[kr * (QT + 1) + qq];
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

// ------------------------------------------------------------------------
// Head dims above DMAX: the chunked kernels (see the note at the top).
// Sixteen lanes a row (LC), blockIdx.z the output chunk [c0, c0 + dc).

constexpr int CQT = 16;  // queries a tile of the chunked dK/dV

// q [b, s, h, d], k/v [b, sk, g, d], o [b, s, h, d] in T; lse [b*h, s] f32.
template <typename T>
__global__ void __launch_bounds__(32 * LC) fwd_chunk_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ o, float* __restrict__ lse, int s, int sk, int h, int g, int d,
    float scale, int causal, int window) {
  extern __shared__ float sm[];
  float* Qs = sm;                  // [BQ][DS + 1]
  float* Ks = Qs + BQ * (DS + 1);  // [BK][DS + 1]
  float* Vs = Ks + BK * (DS + 1);  // [BK][DC + 1]: this chunk's columns
  float* Ps = Vs + BK * (DC + 1);  // [BQ][BK + 1]
  const int tid = threadIdx.x, r = tid / LC, c = tid % LC;
  const int q0 = blockIdx.x * BQ;
  const int bi = blockIdx.y / h, hi = blockIdx.y % h, kvh = hi / (h / g);
  const int c0 = blockIdx.z * DC, dc = min(DC, d - c0);
  const int qi = q0 + r;
  int lo, hiq;
  key_range(q0, s, sk, causal, window, &lo, &hiq);
  float m = -CUDART_INF_F, l = 0.f;
  float acc[ACC];
#pragma unroll
  for (int j = 0; j < ACC; ++j) acc[j] = 0.f;
  const T* qb = q + ((size_t)bi * s * h + hi) * d;
  const T* kb = k + ((size_t)bi * sk * g + kvh) * d;
  const T* vb = v + ((size_t)bi * sk * g + kvh) * d;
  for (int k0 = lo - lo % BK; k0 < hiq; k0 += BK) {
    float sv[BK / LC];
#pragma unroll
    for (int jj = 0; jj < BK / LC; ++jj) sv[jj] = 0.f;
    for (int t0 = 0; t0 < d; t0 += DS) {
      const int n = min(DS, d - t0);
      __syncthreads();
      load_cols<32 * LC>(Qs, DS + 1, qb, q0, BQ, s, h * d, t0, n);
      load_cols<32 * LC>(Ks, DS + 1, kb, k0, BK, sk, g * d, t0, n);
      __syncthreads();
#pragma unroll
      for (int jj = 0; jj < BK / LC; ++jj) {
        const int kk = c + LC * jj;
        for (int t = 0; t < n; ++t)
          sv[jj] = fmaf(Qs[r * (DS + 1) + t], Ks[kk * (DS + 1) + t], sv[jj]);
      }
    }
    load_cols<32 * LC>(Vs, DC + 1, vb, k0, BK, sk, g * d, c0, dc);
    float mt = -CUDART_INF_F;
#pragma unroll
    for (int jj = 0; jj < BK / LC; ++jj) {
      sv[jj] = visible(qi, k0 + c + LC * jj, sk, causal, window) ? sv[jj] * scale
                                                                  : -CUDART_INF_F;
      mt = fmaxf(mt, sv[jj]);
    }
    const float mn = fmaxf(m, row_max<LC>(mt));
    const float base = mn == -CUDART_INF_F ? 0.f : mn;  // an all-masked row keeps p = 0
    const float alpha = expf(m - base);
    float ls = 0.f;
#pragma unroll
    for (int jj = 0; jj < BK / LC; ++jj) {
      const float p = expf(sv[jj] - base);
      Ps[r * (BK + 1) + c + LC * jj] = p;
      ls += p;
    }
    l = l * alpha + row_sum<LC>(ls);
    m = mn;
    __syncthreads();  // Vs (all rows) and Ps (this row's lanes) are written
#pragma unroll
    for (int j = 0; j < ACC; ++j) acc[j] *= alpha;
    for (int kk = 0; kk < BK; ++kk) {
      const float p = Ps[r * (BK + 1) + kk];
#pragma unroll
      for (int j = 0; j < ACC; ++j)
        if (c + LC * j < dc) acc[j] = fmaf(p, Vs[kk * (DC + 1) + c + LC * j], acc[j]);
    }
  }
  if (qi >= s) return;
  const float inv = l > 0.f ? 1.f / l : 0.f;
  T* orow = o + (((size_t)bi * s + qi) * h + hi) * d + c0;
#pragma unroll
  for (int j = 0; j < ACC; ++j)
    if (c + LC * j < dc) from_f32(orow + c + LC * j, acc[j] * inv);
  if (blockIdx.z == 0 && c == 0)
    lse[(size_t)blockIdx.y * s + qi] = l > 0.f ? m + logf(l) : -CUDART_INF_F;
}

// dq [b, s, h, d] from do [b, s, h, d] (T), lse and delta [b*h, s] (f32).
template <typename T>
__global__ void __launch_bounds__(32 * LC) dq_chunk_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, T* __restrict__ dq, int s, int sk, int h, int g, int d,
    float scale, int causal, int window) {
  extern __shared__ float sm[];
  float* Qs = sm;                  // [BQ][DS + 1]
  float* Ds = Qs + BQ * (DS + 1);  // dO [BQ][DS + 1]
  float* Ks = Ds + BQ * (DS + 1);  // [BK][DS + 1]
  float* Vs = Ks + BK * (DS + 1);  // [BK][DS + 1]
  float* Kc = Vs + BK * (DS + 1);  // [BK][DC + 1]: this chunk's columns of K
  float* Ss = Kc + BK * (DC + 1);  // dS [BQ][BK + 1]
  const int tid = threadIdx.x, r = tid / LC, c = tid % LC;
  const int q0 = blockIdx.x * BQ;
  const int bi = blockIdx.y / h, hi = blockIdx.y % h, kvh = hi / (h / g);
  const int c0 = blockIdx.z * DC, dc = min(DC, d - c0);
  const int qi = q0 + r;
  const size_t qoff = ((size_t)bi * s * h + hi) * d;
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
    float sc[BK / LC], dp[BK / LC];
#pragma unroll
    for (int jj = 0; jj < BK / LC; ++jj) sc[jj] = dp[jj] = 0.f;
    for (int t0 = 0; t0 < d; t0 += DS) {
      const int n = min(DS, d - t0);
      __syncthreads();
      load_cols<32 * LC>(Qs, DS + 1, q + qoff, q0, BQ, s, h * d, t0, n);
      load_cols<32 * LC>(Ds, DS + 1, dout + qoff, q0, BQ, s, h * d, t0, n);
      load_cols<32 * LC>(Ks, DS + 1, kb, k0, BK, sk, g * d, t0, n);
      load_cols<32 * LC>(Vs, DS + 1, vb, k0, BK, sk, g * d, t0, n);
      __syncthreads();
#pragma unroll
      for (int jj = 0; jj < BK / LC; ++jj) {
        const int kk = c + LC * jj;
        for (int t = 0; t < n; ++t) {
          sc[jj] = fmaf(Qs[r * (DS + 1) + t], Ks[kk * (DS + 1) + t], sc[jj]);
          dp[jj] = fmaf(Ds[r * (DS + 1) + t], Vs[kk * (DS + 1) + t], dp[jj]);
        }
      }
    }
    load_cols<32 * LC>(Kc, DC + 1, kb, k0, BK, sk, g * d, c0, dc);
#pragma unroll
    for (int jj = 0; jj < BK / LC; ++jj) {
      const int kk = c + LC * jj;
      float ds = 0.f;
      if (qi < s && visible(qi, k0 + kk, sk, causal, window)) {
        const float p = expf(sc[jj] * scale - lr);
        ds = p * (dp[jj] - dr);
      }
      Ss[r * (BK + 1) + kk] = ds;
    }
    __syncthreads();  // Kc and Ss are written
    for (int kk = 0; kk < BK; ++kk) {
      const float ds = Ss[r * (BK + 1) + kk];
#pragma unroll
      for (int j = 0; j < ACC; ++j)
        if (c + LC * j < dc) acc[j] = fmaf(ds, Kc[kk * (DC + 1) + c + LC * j], acc[j]);
    }
  }
  if (qi >= s) return;
  T* row = dq + (((size_t)bi * s + qi) * h + hi) * d + c0;
#pragma unroll
  for (int j = 0; j < ACC; ++j)
    if (c + LC * j < dc) from_f32(row + c + LC * j, acc[j] * scale);
}

// dk, dv [b, sk, g, d]: a block per 32 keys of one (batch, kv head) and
// one chunk of the head dim.
template <typename T>
__global__ void __launch_bounds__(32 * LC) dkv_chunk_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv, int s,
    int sk, int h, int g, int d, float scale, int causal, int window) {
  extern __shared__ float sm[];
  float* Ks = sm;                   // [BK][DS + 1]
  float* Vs = Ks + BK * (DS + 1);   // [BK][DS + 1]
  float* Qs = Vs + BK * (DS + 1);   // [CQT][DS + 1]
  float* Ds = Qs + CQT * (DS + 1);  // dO [CQT][DS + 1]
  float* Qc = Ds + CQT * (DS + 1);  // [CQT][DC + 1]: this chunk's columns of Q
  float* Dc = Qc + CQT * (DC + 1);  // [CQT][DC + 1]: and of dO
  float* Pt = Dc + CQT * (DC + 1);  // P^T [BK][CQT + 1]
  float* St = Pt + BK * (CQT + 1);  // dS^T [BK][CQT + 1]
  float* Ls = St + BK * (CQT + 1);  // lse [CQT]
  float* Es = Ls + CQT;             // delta [CQT]
  const int tid = threadIdx.x, kr = tid / LC, c = tid % LC;
  const int k0 = blockIdx.x * BK;
  const int bi = blockIdx.y / g, kvh = blockIdx.y % g, rep = h / g;
  const int c0 = blockIdx.z * DC, dc = min(DC, d - c0);
  const int kj = k0 + kr;
  const size_t koff = ((size_t)bi * sk * g + kvh) * d;
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
    for (int q0 = qlo - qlo % CQT; q0 < qhi; q0 += CQT) {
      float sc[CQT / LC], dp[CQT / LC];
#pragma unroll
      for (int jj = 0; jj < CQT / LC; ++jj) sc[jj] = dp[jj] = 0.f;
      for (int t0 = 0; t0 < d; t0 += DS) {
        const int n = min(DS, d - t0);
        __syncthreads();
        load_cols<32 * LC>(Ks, DS + 1, k + koff, k0, BK, sk, g * d, t0, n);
        load_cols<32 * LC>(Vs, DS + 1, v + koff, k0, BK, sk, g * d, t0, n);
        load_cols<32 * LC>(Qs, DS + 1, q + qoff, q0, CQT, s, h * d, t0, n);
        load_cols<32 * LC>(Ds, DS + 1, dout + qoff, q0, CQT, s, h * d, t0, n);
        __syncthreads();
#pragma unroll
        for (int jj = 0; jj < CQT / LC; ++jj) {
          const int qq = c + LC * jj;
          for (int t = 0; t < n; ++t) {
            sc[jj] = fmaf(Qs[qq * (DS + 1) + t], Ks[kr * (DS + 1) + t], sc[jj]);
            dp[jj] = fmaf(Ds[qq * (DS + 1) + t], Vs[kr * (DS + 1) + t], dp[jj]);
          }
        }
      }
      load_cols<32 * LC>(Qc, DC + 1, q + qoff, q0, CQT, s, h * d, c0, dc);
      load_cols<32 * LC>(Dc, DC + 1, dout + qoff, q0, CQT, s, h * d, c0, dc);
      if (tid < CQT) {
        Ls[tid] = q0 + tid < s ? lrow[q0 + tid] : 0.f;
        Es[tid] = q0 + tid < s ? erow[q0 + tid] : 0.f;
      }
      __syncthreads();  // Qc, Dc, Ls and Es are written
#pragma unroll
      for (int jj = 0; jj < CQT / LC; ++jj) {
        const int qq = c + LC * jj, qi = q0 + qq;
        float p = 0.f, ds = 0.f;
        if (qi < s && visible(qi, kj, sk, causal, window)) {
          p = expf(sc[jj] * scale - Ls[qq]);
          ds = p * (dp[jj] - Es[qq]);
        }
        Pt[kr * (CQT + 1) + qq] = p;
        St[kr * (CQT + 1) + qq] = ds;
      }
      __syncwarp();
      for (int qq = 0; qq < CQT; ++qq) {
        const float p = Pt[kr * (CQT + 1) + qq], ds = St[kr * (CQT + 1) + qq];
#pragma unroll
        for (int j = 0; j < ACC; ++j) {
          if (c + LC * j < dc) {
            av[j] = fmaf(p, Dc[qq * (DC + 1) + c + LC * j], av[j]);
            ak[j] = fmaf(ds, Qc[qq * (DC + 1) + c + LC * j], ak[j]);
          }
        }
      }
    }
  }
  if (kj >= sk) return;
  const size_t out = (((size_t)bi * sk + kj) * g + kvh) * d + c0;
#pragma unroll
  for (int j = 0; j < ACC; ++j) {
    if (c + LC * j < dc) {
      from_f32(dk + out + c + LC * j, ak[j] * scale);
      from_f32(dv + out + c + LC * j, av[j]);
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
// (int8 only); out [b, g, nh*hd] f32.  Up to DMAX (CHUNKED false) a block
// per (query head, query row, batch row) holds q in shared memory whole.
// Above it (CHUNKED) the grid is (nh, g, b * chunks): a block owns output
// dims [c0, c0 + DMAX) and forms the scores over all hd, streaming q
// through shared memory DMAX dims at a time.  Two instantiations: with
// the streaming loop folded into the whole-q one, the decode at d <= 512
// ran 1.4-1.8x slower on the H100.
template <typename TQ, typename TK, bool CHUNKED>
__global__ void __launch_bounds__(THREADS) decode_simt_kernel(
    const TQ* __restrict__ q, const TK* __restrict__ ck, const TK* __restrict__ cv,
    const float* __restrict__ ks, const float* __restrict__ vs, float* __restrict__ out,
    const int* __restrict__ pos_dev, int pos_host, int g, int nh, int nkv, int hd, int max_len,
    int window, float scale) {
  __shared__ float qs[DMAX];
  __shared__ float ps[DEC_TILE];
  __shared__ float red[THREADS / 32];
  const int tid = threadIdx.x;
  const int nch = CHUNKED ? (hd + DMAX - 1) / DMAX : 1;
  const int head = blockIdx.x, i = blockIdx.y, bi = blockIdx.z / nch;
  const int c0 = CHUNKED ? (blockIdx.z % nch) * DMAX : 0;
  const int dc = CHUNKED ? min(DMAX, hd - c0) : hd;
  const int kvh = head / (nh / nkv);
  int pos0 = pos_dev != nullptr ? *pos_dev : pos_host;
  pos0 = min(max(pos0, 0), max_len - g);
  const int qpos = pos0 + i;
  const int lo = window > 0 ? max(0, qpos - window + 1) : 0, end = qpos + 1;
  const size_t qrow = (((size_t)bi * g + i) * nh + head) * hd;
  if (!CHUNKED) {
    for (int t = tid; t < hd; t += THREADS) qs[t] = to_f32(q[qrow + t]);
    __syncthreads();
  }
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
    if (!CHUNKED) {
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
    } else {
      float dot = 0.f;
      for (int t0 = 0; t0 < hd; t0 += DMAX) {  // uniform: every thread takes part
        const int n = min(DMAX, hd - t0);
        __syncthreads();
        for (int t = tid; t < n; t += THREADS) qs[t] = to_f32(q[qrow + t0 + t]);
        __syncthreads();
        if (kj < end) {
          const TK* kr = kb + (size_t)kj * stride + t0;
          const float s_k = ksr != nullptr ? ksr[kj] : 1.f;
          for (int t = 0; t < n; ++t) {
            const float kv = ksr != nullptr ? to_f32(kr[t]) * s_k : to_f32(kr[t]);
            dot = fmaf(qs[t], kv, dot);
          }
        }
      }
      if (kj < end) sc = dot * scale;
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
      const int t = c0 + tid + e * THREADS;
      if (t < c0 + dc) {
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
    const int t = c0 + tid + e * THREADS;
    if (t < c0 + dc) out[qrow + t] = acc[e] / l;
  }
}

// Shared memory of one block (bytes) at head dim d: 0 forward, 1 dQ,
// 2 dK/dV.
int smem_bytes(int which, int d) {
  if (d > DMAX) {  // the chunked kernels: the same at every such d
    if (which == 0) return (BQ * (DS + 1) + BK * (DS + 1) + BK * (DC + 1) + BQ * (BK + 1)) * 4;
    if (which == 1)
      return (2 * BQ * (DS + 1) + 2 * BK * (DS + 1) + BK * (DC + 1) + BQ * (BK + 1)) * 4;
    return (2 * BK * (DS + 1) + 2 * CQT * (DS + 1) + 2 * CQT * (DC + 1) + 2 * BK * (CQT + 1) +
            2 * CQT) * 4;
  }
  const int P = d + 1, T = inner_tile(lanes(d));
  if (which == 0) return (BQ * P + 2 * BK * P + BQ * (BK + 1)) * 4;
  if (which == 1) return (2 * BQ * P + 2 * T * P + BQ * (T + 1)) * 4;
  return (2 * BK * P + 2 * T * P + 2 * BK * (T + 1) + 2 * T) * 4;
}

// The kernel's dynamic shared memory limit raised to its largest size (d =
// 32 * L; any d above DMAX for a chunked kernel), once per device (a call captured into a CUDA graph then makes
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
  return b > 0 && s > 0 && sk > 0 && g > 0 && h % g == 0 && d > 0;
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

// Above DMAX: the chunked kernels, one block per (rows, head, chunk).
template <typename T>
int run_chunked(int which, const Attn& a) {
  static unsigned done[3] = {0, 0, 0};
  const int bytes = smem_bytes(which, a.d), nch = (a.d + DC - 1) / DC;
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  int e;
  if (which == 0) {
    if ((e = allow_smem(fwd_chunk_kernel<T>, 0, DMAX + 1, &done[0]))) return e;
    fwd_chunk_kernel<T><<<dim3((a.s + BQ - 1) / BQ, a.b * a.h, nch), 32 * LC, bytes, a.st>>>(
        q, k, v, static_cast<T*>(a.o), static_cast<float*>(a.out_lse), a.s, a.sk, a.h, a.g, a.d,
        a.scale, a.causal, a.window);
  } else if (which == 1) {
    if ((e = allow_smem(dq_chunk_kernel<T>, 1, DMAX + 1, &done[1]))) return e;
    dq_chunk_kernel<T><<<dim3((a.s + BQ - 1) / BQ, a.b * a.h, nch), 32 * LC, bytes, a.st>>>(
        q, k, v, static_cast<const T*>(a.dout), static_cast<const float*>(a.lse),
        static_cast<const float*>(a.delta), static_cast<T*>(a.dq), a.s, a.sk, a.h, a.g, a.d,
        a.scale, a.causal, a.window);
  } else {
    if ((e = allow_smem(dkv_chunk_kernel<T>, 2, DMAX + 1, &done[2]))) return e;
    dkv_chunk_kernel<T><<<dim3((a.sk + BK - 1) / BK, a.b * a.g, nch), 32 * LC, bytes, a.st>>>(
        q, k, v, static_cast<const T*>(a.dout), static_cast<const float*>(a.lse),
        static_cast<const float*>(a.delta), static_cast<T*>(a.dk), static_cast<T*>(a.dv), a.s,
        a.sk, a.h, a.g, a.d, a.scale, a.causal, a.window);
  }
  return int(cudaGetLastError());
}

// The lanes a row of head dim a.d (lanes), or the chunked kernels above
// DMAX.
template <typename T>
int run_lanes(int which, const Attn& a) {
  if (a.d > DMAX) return run_chunked<T>(which, a);
  const int L = lanes(a.d);
  if (L == 16) return run<T, 16>(which, a);
  if (L == 8) return run<T, 8>(which, a);
  return run<T, 4>(which, a);
}

// Element type by code (0 bf16, 1 f32, 3 f16, as flash_decode.cu's).
int dispatch(int which, int type, const Attn& a) {
  if (!shape_ok(a.b, a.s, a.sk, a.h, a.g, a.d)) return int(cudaErrorInvalidValue);
  if (type == 1) return run_lanes<float>(which, a);
  if (type == 0) return run_lanes<__nv_bfloat16>(which, a);
  if (type == 3) return run_lanes<__half>(which, a);
  return int(cudaErrorInvalidValue);
}

template <typename TQ, typename TK>
int launch_decode(const void* q, const void* ck, const void* cv, const void* k_scale,
                  const void* v_scale, void* out, const void* pos_dev, int pos_host, int b, int g,
                  int nh, int nkv, int hd, int max_len, int window, float scale,
                  cudaStream_t st) {
  const int nch = (hd + DMAX - 1) / DMAX;
  auto kernel = nch > 1 ? decode_simt_kernel<TQ, TK, true> : decode_simt_kernel<TQ, TK, false>;
  kernel<<<dim3(nh, g, b * nch), THREADS, 0, st>>>(
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
// element type `type` (0 bf16, 1 f32, 3 f16); lse [b*h, s] f32; any d
// (above 512 the chunked kernels).
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
// [b, g, nh*hd] f32; any hd (above 512 in chunks of 512).  Type codes as flash_decode.cu's (0 bf16,
// 1 f32, 2 int8 with k_scale/v_scale f32 [b, nkv, max_len], 3 f16).
// pos0: the int32 at `pos_dev` or, when it is null, `pos_host`; clamped to
// [0, max_len - g].
extern "C" int tgt_flash_decode_simt(const void* q, const void* ck, const void* cv,
                                     const void* k_scale, const void* v_scale, void* out,
                                     const void* pos_dev, int pos_host, int b, int g, int nh,
                                     int nkv, int hd, int max_len, int window, float scale,
                                     int q_type, int kv_type, void* stream) {
  if (b == 0 || g == 0) return 0;
  if (nkv <= 0 || nh % nkv != 0 || hd <= 0 || max_len < g)
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
