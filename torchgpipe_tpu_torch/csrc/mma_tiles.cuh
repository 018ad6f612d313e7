// Tile helpers shared by the flash-attention kernels (sm_80+ instructions,
// built for sm_90a): cp.async copies into padded shared tiles, ldmatrix
// fragment loads and the m16n8k16 bf16 tensor-core product with f32
// accumulation.
//
// Fragment layout (PTX ISA, mma.m16n8k16): in a warp, lane l holds rows
// l/4 and l/4 + 8 of a 16-row accumulator tile, columns 2*(l%4) and +1 of
// each 8-column n-tile.  Two neighbouring n-tiles of an accumulator, packed
// to bf16 pairs, are exactly one 16x16 A fragment, so a product's output
// feeds the next product from registers.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace tiles {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// d += a (16x16 row-major) * b (16x8 col-major), bf16 in, f32 accumulate.
__device__ __forceinline__ void mma16816(float* d, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Copy `rows` rows of D bf16 (row r at src + r * stride) into a [ROWS][LD]
// shared tile with cp.async; rows at or past `valid` are zero-filled.
template <int D, int LD, int ROWS, int THREADS>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, size_t stride,
                                          int valid, int tid) {
  constexpr int CH = D / 8;
#pragma unroll
  for (int c = tid; c < ROWS * CH; c += THREADS) {
    const int row = c / CH, col = (c % CH) * 8;
    const bool ok = row < valid;
    cp_async16(dst + row * LD + col, ok ? src + row * stride + col : src, ok);
  }
}

// Whether query qpos attends key kpos (both count from 0), as the
// reference kernels' _mask_causal plus the ragged edges.
__device__ __forceinline__ bool attends(int qpos, int kpos, int s, int sk, int causal,
                                        int window) {
  bool ok = qpos < s && kpos < sk;
  if (causal) ok = ok && kpos <= qpos && (window <= 0 || qpos - kpos < window);
  return ok;
}

}  // namespace tiles
