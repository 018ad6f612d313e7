// One-tile self-test of hopper_tiles.cuh: each operand form the attention
// kernels use, run once on TMA-loaded 128-byte-swizzled tiles, for a test
// to hold against torch.matmul.  Not on any model path.
//
//   mode 0, 1: C[64, N] = A[64, 128] B[N, 128]^T, N = 64 / 128, A and B
//              K-major from shared memory (S = Q K^T, S^T = K Q^T); the
//              reduction crosses the two 64-column blocks of a d = 128 row.
//   mode 2, 3: C[64, N] = A[64, 64] B[64, N], N = 64 / 128, A from
//              registers, B MN-major from shared memory with the transpose
//              bit (O += P V, dV += P^T dO); `block` is the descriptor's
//              column block stride (64 rows x 128 bytes in the kernels).
// A and B are bf16 row-major, C float32 row-major.

#include "hopper_tiles.cuh"

namespace {

using namespace hopper;

template <int N>
__device__ void store_acc(float* c, const float (&d)[N / 2]) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = warp * 16 + (lane >> 2), col = (lane & 3) * 2;
#pragma unroll
  for (int t = 0; t < N / 8; ++t) {
    c[row * N + t * 8 + col] = d[4 * t];
    c[row * N + t * 8 + col + 1] = d[4 * t + 1];
    c[(row + 8) * N + t * 8 + col] = d[4 * t + 2];
    c[(row + 8) * N + t * 8 + col + 1] = d[4 * t + 3];
  }
}

template <int N>
__global__ void __launch_bounds__(128)
selftest_ss(const __grid_constant__ CUtensorMap ta, const __grid_constant__ CUtensorMap tb,
            float* c) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = align1024(smem_raw);
  uint8_t* sa = sm;                    // [2][64][64]
  uint8_t* sb = sm + 2 * 64 * 128;     // [2][N][64]
  uint64_t* bar = reinterpret_cast<uint64_t*>(sb + 2 * N * 128);
  if (threadIdx.x == 0) {
    mbar_init(bar, 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    mbar_arrive_tx(bar, 2 * (64 + N) * 128);
    for (int hf = 0; hf < 2; ++hf) {
      tma_load_4d(sa + hf * 64 * 128, &ta, bar, hf * 64, 0, 0, 0);
      tma_load_4d(sb + hf * N * 128, &tb, bar, hf * 64, 0, 0, 0);
    }
  }
  mbar_wait(bar, 0);
  float d[N / 2];
  fence_regs(d);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    wgmma_ss<N, 0>(d, desc_k(smem_u32(sa) + (kk / 4) * 64 * 128 + (kk % 4) * 32),
                   desc_k(smem_u32(sb) + (kk / 4) * N * 128 + (kk % 4) * 32), kk > 0);
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(d);
  store_acc<N>(c, d);
}

template <int N>
__global__ void __launch_bounds__(128)
selftest_rs(const __nv_bfloat16* a, const __grid_constant__ CUtensorMap tb, float* c,
            int block) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sb = align1024(smem_raw);   // [N/64][64][64]
  uint64_t* bar = reinterpret_cast<uint64_t*>(sb + (N / 64) * 64 * 128);
  if (threadIdx.x == 0) {
    mbar_init(bar, 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    mbar_arrive_tx(bar, (N / 64) * 64 * 128);
    for (int hf = 0; hf < N / 64; ++hf) tma_load_4d(sb + hf * 64 * 128, &tb, bar, hf * 64, 0, 0, 0);
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = warp * 16 + (lane >> 2), col = (lane & 3) * 2;
  uint32_t frag[4][4];
  auto ld = [&](int r, int k) {
    __nv_bfloat162 v;
    v.x = a[r * 64 + k];
    v.y = a[r * 64 + k + 1];
    return *reinterpret_cast<uint32_t*>(&v);
  };
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    frag[kk][0] = ld(row, kk * 16 + col);
    frag[kk][1] = ld(row + 8, kk * 16 + col);
    frag[kk][2] = ld(row, kk * 16 + 8 + col);
    frag[kk][3] = ld(row + 8, kk * 16 + 8 + col);
  }
  mbar_wait(bar, 0);
  float d[N / 2];
  fence_regs(d);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_rs<N, 1>(d, frag[kk], desc_mn(smem_u32(sb) + kk * 2048, block), kk > 0);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(d);
  store_acc<N>(c, d);
}

template <typename K>
int smem_attr(K kernel, int bytes) {
  return int(cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes));
}

}  // namespace

// a, b bf16 and c float32 (shapes per mode, above); block: the MN-major
// descriptor's column block stride in bytes (modes 2, 3).  Returns
// cudaGetLastError().
extern "C" int tgt_hopper_selftest(int mode, const void* a, const void* b, void* c, int block,
                                   void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* out = static_cast<float*>(c);
  CUtensorMap ta, tb;
  const int n = (mode % 2) ? 128 : 64;
  int e = 0;
  if (mode < 2) {
    const int bytes = 1024 + 2 * (64 + n) * 128 + 8;
    if ((e = make_map(&ta, a, 128, 1, 64, 1, 64)) || (e = make_map(&tb, b, 128, 1, n, 1, n)))
      return e;
    if (n == 64) {
      if ((e = smem_attr(selftest_ss<64>, bytes))) return e;
      selftest_ss<64><<<1, 128, bytes, st>>>(ta, tb, out);
    } else {
      if ((e = smem_attr(selftest_ss<128>, bytes))) return e;
      selftest_ss<128><<<1, 128, bytes, st>>>(ta, tb, out);
    }
  } else if (mode < 4) {
    const int bytes = 1024 + n * 128 + 8;
    if ((e = make_map(&tb, b, n, 1, 64, 1, 64))) return e;
    const __nv_bfloat16* pa = static_cast<const __nv_bfloat16*>(a);
    if (n == 64) {
      if ((e = smem_attr(selftest_rs<64>, bytes))) return e;
      selftest_rs<64><<<1, 128, bytes, st>>>(pa, tb, out, block);
    } else {
      if ((e = smem_attr(selftest_rs<128>, bytes))) return e;
      selftest_rs<128><<<1, 128, bytes, st>>>(pa, tb, out, block);
    }
  } else {
    return int(cudaErrorInvalidValue);
  }
  return int(cudaGetLastError());
}
