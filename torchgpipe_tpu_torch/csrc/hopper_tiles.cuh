// Hopper (sm_90a) building blocks shared by flash_fwd.cu, flash_fwd_tf32.cu,
// flash_bwd.cu and flash_decode.cu: 128-byte-swizzled tiles in shared
// memory, loaded by the Tensor Memory Accelerator (TMA) and read by
// warpgroup matrix multiplies (wgmma, bf16, f16 and tf32), or by ldmatrix and
// mma.sync where a product has too few rows for wgmma; mbarriers that tie
// the two together; named barriers; register rebalancing between producer
// and consumer warpgroups; the persistent kernels' query tile; and the
// host-side tensor maps.
//
// Tile layout.  TMA with CU_TENSOR_MAP_SWIZZLE_128B takes at most 128 bytes
// (64 bf16) of a row per box, so a [rows][d] tile is stored as d/64
// column blocks, each [rows][64] with a 128-byte pitch: block c of a tile
// at byte offset c * rows * 128.  Inside a block, the 16-byte chunk j of
// row r sits at chunk j ^ (r % 8) (the swizzle), which needs the block to
// start on a 1024-byte boundary.
//
// Descriptors (PTX ISA, "matrix descriptor"; CUTLASS make_gmma_desc):
// * K-major (the reduction dimension contiguous, e.g. Q or K as [rows][d]
//   for S = Q K^T): SBO = 1024 bytes (the next 8 rows), LBO unused (16);
//   one k16 step moves the start address by 32 bytes inside a column
//   block, and the step past column 64 moves to the next block.
// * MN-major (the output dimension contiguous, e.g. V as [keys][d] for
//   O += P V, read with the transpose bit tnspB = 1): SBO = 1024 bytes (the
//   next 8 rows of the reduction dimension), LBO = the column block stride
//   (rows * 128 bytes, the next 64 output columns); one k16 step moves the
//   start by 16 rows = 2048 bytes.
//
// Fragments.  An m64nN accumulator gives warp w of the warpgroup rows
// 16w + lane/4 and +8; for each 8-column group t it holds columns
// 8t + 2*(lane%4) and +1 in d[4t], d[4t+1] (first row) and d[4t+2],
// d[4t+3] (second row).  An A operand from registers (k16 step k) takes
// the same layout, packed to bf16 pairs: {d[8k..8k+1], d[8k+2..8k+3],
// d[8k+4..8k+5], d[8k+6..8k+7]}, so a product's output feeds the next
// product without a trip through shared memory.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

typedef __nv_bfloat16 bf16;
typedef __half f16;

namespace hopper {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The dynamic shared memory window rounded up to 1024 bytes (allocate
// 1024 bytes more than the layout needs).
__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  const uint32_t a = smem_u32(p);
  return p + (((a + 1023u) & ~1023u) - a);
}

// 2^x in one MUFU.EX2 (ex2.approx.ftz: relative error ~2^-22; -inf gives
// +0).  exp2f's accurate path costs two more instructions and a range
// check per element.
__device__ __forceinline__ float exp2_fast(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Whether query qpos attends key kpos (both from 0): inside the sequence
// and, when causal, 0 <= qpos - kpos < window (window <= 0: no band).
// Branch-free, for masks applied element by element.
__device__ __forceinline__ bool visible(int qpos, int kpos, int s, int sk, int causal,
                                           int window) {
  const int gap = qpos - kpos;
  const int band = window > 0 ? window : 0x7fffffff;
  return (qpos < s) & (kpos < sk) & ((causal == 0) | ((gap >= 0) & (gap < band)));
}

// One query tile of a persistent attention kernel's work list
// (ops/flash_attention.py fwd_schedule): tile i is query tile
// nqt-1-i/bhn of head i%bhn (bhn = b*h), BQ rows; its live BK-key tiles
// are jt0 .. jt0+n-1, up to the diagonal and from the window's first
// (n = 0: a windowed tile past the keys, which sees none).
template <int BQ, int BK>
struct QueryTile {
  int bi, hi, kvh, q0, jt0, n;
  __device__ __forceinline__ QueryTile(int i, int bhn, int nqt, int h, int g, int s, int sk,
                                       int causal, int window) {
    const int bh = i % bhn;
    bi = bh / h;
    hi = bh % h;
    kvh = hi / (h / g);
    q0 = (nqt - 1 - i / bhn) * BQ;
    int nkt = (sk + BK - 1) / BK;
    jt0 = 0;
    if (causal) {
      nkt = min(nkt, (min(q0 + BQ, s) - 1) / BK + 1);
      if (window > 0) jt0 = max(q0 - (window - 1), 0) / BK;
    }
    n = max(nkt - jt0, 0);
  }
};

// Two floats as one register of a bf16 pair (an A fragment's element).
__device__ __forceinline__ uint32_t bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The same for an f16 pair.
__device__ __forceinline__ uint32_t f16x2(float lo, float hi) {
  __half2 v = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The tensor-core kernels' 16-bit element type E is bf16 or f16: wgmma and
// mma.sync take either with f32 accumulation at the same rate, and the
// tile layouts, descriptors and fragments are the same.  What differs is
// the instruction's type name (below), how two floats pack into a pair,
// and the tensor maps' type code.
template <typename E>
constexpr bool is_f16 = std::is_same<E, f16>::value;

template <typename E>
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  if constexpr (is_f16<E>) return f16x2(lo, hi);
  else return bf16x2(lo, hi);
}

// Two floats rounded to nearest into dst[0], dst[1] (4-byte aligned).
template <typename E>
__device__ __forceinline__ void store2(E* dst, float lo, float hi) {
  *reinterpret_cast<uint32_t*>(dst) = pack2<E>(lo, hi);
}

template <typename E>
constexpr CUtensorMapDataType map_type() {
  return is_f16<E> ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
}

// ---- mbarrier ------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

// After the inits, before any other thread uses the barriers (then a
// __syncthreads).
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// Arrive, and expect `bytes` more from TMA before the phase completes.
__device__ __forceinline__ void mbar_arrive_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// Wait until the phase of parity `parity` has completed.  A fresh barrier
// is in phase 0: waiting on parity 1 passes at once (a producer's first
// wait on an empty slot), waiting on parity 0 blocks until the first
// completion.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  } while (!done);
}

// ---- TMA -----------------------------------------------------------------

// One box of a 4-D tensor map into shared memory; completion counts its
// bytes on `bar`.  Coordinates innermost first; rows past the tensor's
// edge arrive as zeros.
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3),
      "r"(smem_u32(bar))
      : "memory");
}

// ---- named barriers and register rebalancing -----------------------------

__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

template <int R>
__device__ __forceinline__ void reg_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}

template <int R>
__device__ __forceinline__ void reg_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}

// ---- wgmma ---------------------------------------------------------------

__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return uint64_t((addr & 0x3FFFFu) >> 4) | (uint64_t(lbo >> 4) << 16) |
         (uint64_t(sbo >> 4) << 32) | (1ull << 62);
}

// K-major operand whose k16 step starts at byte `addr` (see the header).
__device__ __forceinline__ uint64_t desc_k(uint32_t addr) { return desc_sw128(addr, 16, 1024); }

// MN-major operand: `block` = bytes between 64-column blocks.
__device__ __forceinline__ uint64_t desc_mn(uint32_t addr, uint32_t block) {
  return desc_sw128(addr, block, 1024);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of accumulator registers
// across an asynchronous product (CUTLASS warpgroup_fence_operand).
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d[64 x N] (+)= A[64 x 16] B[16 x N] with f32 accumulation; acc = 0
// overwrites d.  _ss: A and B from shared memory; _rs: A from registers.
// TB = 1 reads B MN-major (transposed).

#define TGT_WGMMA_SS_N32(TY) \
  asm volatile( \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n" \
      "wgmma.mma_async.sync.aligned.m64n32k16.f32." TY "." TY " {" \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15" \
      "}, %16, %17, p, 1, 1, 0, %19;\n}\n" \
      : \
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]) \
      : "l"(da), "l"(db), "r"(acc), "n"(TB))

template <int TB, typename E = bf16>
__device__ __forceinline__ void wgmma_ss_n32(float (&d)[16], uint64_t da, uint64_t db, int acc) {
  if constexpr (is_f16<E>) TGT_WGMMA_SS_N32("f16");
  else TGT_WGMMA_SS_N32("bf16");
}

#define TGT_WGMMA_SS_N64(TY) \
  asm volatile( \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n" \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " {" \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15," \
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31" \
      "}, %32, %33, p, 1, 1, 0, %35;\n}\n" \
      : \
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]) \
      : "l"(da), "l"(db), "r"(acc), "n"(TB))

template <int TB, typename E = bf16>
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da, uint64_t db, int acc) {
  if constexpr (is_f16<E>) TGT_WGMMA_SS_N64("f16");
  else TGT_WGMMA_SS_N64("bf16");
}

#define TGT_WGMMA_RS_N64(TY) \
  asm volatile( \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n" \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " {" \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15," \
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31" \
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n" \
      : \
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]) \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc), "n"(TB))

template <int TB, typename E = bf16>
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t db, int acc) {
  if constexpr (is_f16<E>) TGT_WGMMA_RS_N64("f16");
  else TGT_WGMMA_RS_N64("bf16");
}

#define TGT_WGMMA_SS_N128(TY) \
  asm volatile( \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n" \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " {" \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15," \
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31," \
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47," \
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63" \
      "}, %64, %65, p, 1, 1, 0, %67;\n}\n" \
      : \
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), \
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), \
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), \
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), \
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]) \
      : "l"(da), "l"(db), "r"(acc), "n"(TB))

template <int TB, typename E = bf16>
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da, uint64_t db, int acc) {
  if constexpr (is_f16<E>) TGT_WGMMA_SS_N128("f16");
  else TGT_WGMMA_SS_N128("bf16");
}

#define TGT_WGMMA_RS_N128(TY) \
  asm volatile( \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n" \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " {" \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15," \
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31," \
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47," \
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63" \
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n" \
      : \
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), \
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), \
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), \
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), \
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]) \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc), "n"(TB))

template <int TB, typename E = bf16>
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4], uint64_t db, int acc) {
  if constexpr (is_f16<E>) TGT_WGMMA_RS_N128("f16");
  else TGT_WGMMA_RS_N128("bf16");
}

#define TGT_WGMMA_RS_N256(TY) \
  asm volatile( \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n" \
      "wgmma.mma_async.sync.aligned.m64n256k16.f32." TY "." TY " {" \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15," \
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31," \
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47," \
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63," \
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79," \
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95," \
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111," \
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127" \
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, %134;\n}\n" \
      : \
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), \
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), \
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), \
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), \
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), \
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), \
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), \
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), \
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), \
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), \
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), \
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), \
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127]) \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc), "n"(TB))

template <int TB, typename E = bf16>
__device__ __forceinline__ void wgmma_rs_n256(float (&d)[128], const uint32_t (&a)[4], uint64_t db, int acc) {
  if constexpr (is_f16<E>) TGT_WGMMA_RS_N256("f16");
  else TGT_WGMMA_RS_N256("bf16");
}

template <int N, int TB, typename E = bf16>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da, uint64_t db, int acc) {
  if constexpr (N == 32) wgmma_ss_n32<TB, E>(d, da, db, acc);
  else if constexpr (N == 64) wgmma_ss_n64<TB, E>(d, da, db, acc);
  else wgmma_ss_n128<TB, E>(d, da, db, acc);
}

template <int N, int TB, typename E = bf16>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t db,
                                         int acc) {
  if constexpr (N == 64) wgmma_rs_n64<TB, E>(d, a, db, acc);
  else if constexpr (N == 128) wgmma_rs_n128<TB, E>(d, a, db, acc);
  else wgmma_rs_n256<TB, E>(d, a, db, acc);
}

// ---- tf32 wgmma (3xTF32 float32 products) --------------------------------
//
// A 32-bit operand's k8 step is 32 bytes, as a bf16 k16 step is, so the
// K-major descriptors above step the same way inside a 128-byte column
// block (32 floats).  tf32 wgmma has no transpose bits: A and B are both
// K-major.  The tensor core reads a float's sign, exponent and top 10
// mantissa bits; 3xTF32 splits x = big + small with big = x with its low
// 13 bits cleared (exactly a tf32) and small = x - big (exact in f32, at
// most 2^-10 |x|), and forms A B ~ As Bb + Ab Bs + Ab Bb in f32: about 22
// bits a product (As Bs, ~2^-20 relative, is left out).  An A fragment
// from registers (m64k8, 32-bit elements) gives warp w of the warpgroup
// rows 16w + lane/4 (a0, a2) and +8 (a1, a3), columns lane%4 (a0, a1)
// and lane%4 + 4 (a2, a3).

// x with its low 13 mantissa bits cleared: the tf32 the tensor core reads.
__device__ __forceinline__ uint32_t tf32_big(float x) { return __float_as_uint(x) & 0xffffe000u; }

// x - tf32_big(x), exact.
__device__ __forceinline__ uint32_t tf32_small(float x) {
  return __float_as_uint(x - __uint_as_float(tf32_big(x)));
}

// Generic-proxy writes to shared memory made visible to the async proxy
// (wgmma operand reads, TMA), before a barrier.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// fence_regs for 32-bit A fragments: keeps registers an asynchronous
// product reads from being reused before its wait.
template <int N>
__device__ __forceinline__ void fence_regs_u32(uint32_t (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// d[64 x N] (+)= A[64 x 8] B[8 x N], tf32 in, f32 accumulate; acc = 0
// overwrites d.  _ss: A and B K-major in shared memory; _rs: A from
// registers.

__device__ __forceinline__ void wgmma_tf32_ss_n32(float (&d)[16], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(acc));
}

__device__ __forceinline__ void wgmma_tf32_ss_n64(float (&d)[32], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(acc));
}

__device__ __forceinline__ void wgmma_tf32_rs_n64(float (&d)[32], uint32_t a0, uint32_t a1,
                                                   uint32_t a2, uint32_t a3, uint64_t db,
                                                   int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(acc));
}

__device__ __forceinline__ void wgmma_tf32_rs_n128(float (&d)[64], uint32_t a0, uint32_t a1,
                                                   uint32_t a2, uint32_t a3, uint64_t db,
                                                   int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(acc));
}

template <int N>
__device__ __forceinline__ void wgmma_tf32_ss(float (&d)[N / 2], uint64_t da, uint64_t db, int acc) {
  if constexpr (N == 32) wgmma_tf32_ss_n32(d, da, db, acc);
  else wgmma_tf32_ss_n64(d, da, db, acc);
}

template <int N>
__device__ __forceinline__ void wgmma_tf32_rs(float (&d)[N / 2], uint32_t a0, uint32_t a1,
                                              uint32_t a2, uint32_t a3, uint64_t db, int acc) {
  if constexpr (N == 64) wgmma_tf32_rs_n64(d, a0, a1, a2, a3, db, acc);
  else wgmma_tf32_rs_n128(d, a0, a1, a2, a3, db, acc);
}

// ---- mma.sync (for products too narrow for wgmma's 64 rows) --------------

// Byte offset of byte `o` of a column block whose rows are 128 (mask 7) or
// 64 (mask 3) bytes wide, under TMA's swizzle of that width: the 16-byte
// chunk index is XORed with bits 7.. of the offset (the row, or the row
// pair at 64 bytes).  Needs the block on a 1024-byte boundary.
template <int MASK>
__device__ __forceinline__ uint32_t swizzle(uint32_t o) {
  return o ^ (((o >> 7) & MASK) << 4);
}

// Four 8x8 b16 matrices from shared memory; lane l gives the address of
// row l%8 of matrix l/8.  The memory clobber keeps the load after the
// mbarrier wait that says its tile has arrived.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// d += a (16x16, row-major) b (16x8, col-major): E (bf16 or f16) in, f32
// accumulate.  Fragments (PTX ISA, mma.m16n8k16): lane l holds rows l/4
// and l/4 + 8, columns 2*(l%4) and +1 of d; a = {a[r][2c..], a[r+8][2c..],
// a[r][2c+8..], a[r+8][2c+8..]}; b = {b[2c..2c+1][l/4], b[2c+8..2c+9][l/4]}
// (c = l%4).
#define TGT_MMA16816(TY)                                                      \
  asm volatile(                                                               \
      "mma.sync.aligned.m16n8k16.row.col.f32." TY "." TY ".f32 "              \
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"               \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])                        \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1))

template <typename E = bf16>
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  if constexpr (is_f16<E>) TGT_MMA16816("f16");
  else TGT_MMA16816("bf16");
}

// ---- host: tensor maps ---------------------------------------------------

// cuTensorMapEncodeTiled is a driver-API function; it is fetched through
// the runtime so that the build links no -lcuda.
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                     cudaEnableDefault, &q);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (e != cudaSuccess || q != cudaDriverEntryPointSuccess) return nullptr;
    fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// A tensor [n3][n2][n1][n0] (contiguous; for attention n0 = d, n1 = heads,
// n2 = positions, n3 = batch) of `elem` bytes an element, read in boxes of
// (row_bytes / elem) x 1 x rows x 1 with the swizzle of that row width
// (128 or 64 bytes: one column block of the tile layout above).  Returns 0
// or a cudaError_t.
inline int make_map_typed(CUtensorMap* map, const void* base, CUtensorMapDataType type,
                          int elem, int n0, int n1, int n2, int n3, int rows,
                          int row_bytes = 128) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return int(cudaErrorNotSupported);
  const cuuint64_t e = cuuint64_t(elem);
  const cuuint64_t dims[4] = {cuuint64_t(n0), cuuint64_t(n1), cuuint64_t(n2), cuuint64_t(n3)};
  const cuuint64_t strides[3] = {cuuint64_t(n0) * e, cuuint64_t(n0) * n1 * e,
                                 cuuint64_t(n0) * n1 * n2 * e};
  const cuuint32_t box[4] = {cuuint32_t(row_bytes / elem), 1, cuuint32_t(rows), 1};
  const cuuint32_t step[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, type, 4, const_cast<void*>(base), dims, strides, box, step,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        row_bytes == 64 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : int(cudaErrorInvalidValue);
}

// A contiguous 4-D tensor of `elem`-byte elements, dims innermost first,
// read in boxes of box[0..3] elements with a 128-byte swizzle (box[0] *
// elem = 128: one column block).  Box elements past the tensor's edge
// arrive as zeros; a box must start inside the tensor.  Returns 0 or a
// cudaError_t.
inline int make_map_box(CUtensorMap* map, const void* base, CUtensorMapDataType type, int elem,
                        const int (&n)[4], const int (&box)[4]) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return int(cudaErrorNotSupported);
  const cuuint64_t e = cuuint64_t(elem);
  const cuuint64_t dims[4] = {cuuint64_t(n[0]), cuuint64_t(n[1]), cuuint64_t(n[2]),
                              cuuint64_t(n[3])};
  const cuuint64_t strides[3] = {dims[0] * e, dims[0] * dims[1] * e,
                                 dims[0] * dims[1] * dims[2] * e};
  const cuuint32_t bx[4] = {cuuint32_t(box[0]), cuuint32_t(box[1]), cuuint32_t(box[2]),
                            cuuint32_t(box[3])};
  const cuuint32_t step[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, type, 4, const_cast<void*>(base), dims, strides, bx, step,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : int(cudaErrorInvalidValue);
}

// A bf16 (or f16: E) tensor in boxes of 64 x 1 x rows x 1, 128-byte swizzle.
template <typename E = bf16>
inline int make_map(CUtensorMap* map, const void* base, int n0, int n1, int n2, int n3,
                    int rows) {
  return make_map_typed(map, base, map_type<E>(), 2, n0, n1, n2, n3, rows);
}

}  // namespace hopper
