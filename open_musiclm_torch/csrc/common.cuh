// Shared device helpers for the open_musiclm_torch kernels.
//
// Activations arrive as float32 (dtype code 0) or bfloat16 (code 1); every
// kernel converts to float on load and accumulates in float32.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace omt {

constexpr float kNegInf = -1e9f;  // the JAX package's NEG_INF mask value

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(int8_t x) { return static_cast<float>(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// ---- asynchronous copies global -> shared (sm_80+) ----
__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
// 16 bytes; with src_bytes 0 the destination is zero-filled and nothing is read
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes = 16) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}
// 4 bytes, of which src_bytes are read and the rest zero-filled
__device__ __forceinline__ void cp_async4_n(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most N committed groups of this thread are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// One BM x BN output tile of  A[rows, K] @ W[K, N]  with W int8 row-major
// ([in, out], the JAX package's layout), 256 threads, float32 accumulation.
// ``a(r, k)`` returns the float A element for global row r < rows and
// k < K (the caller's loader fuses any normalisation into the load).
// Thread t owns row (t / (BN / TN)) of the tile and TN adjacent columns.
// Rows >= rows and columns >= N load zeros; the caller masks the store.
template <int BM, int BN, int BK, typename ALoad>
__device__ __forceinline__ void int8_tile_gemm(
    const ALoad& a, const int8_t* __restrict__ w, int rows, int K, int N,
    int row0, int col0, float (&acc)[BM * BN / 256],
    float (*xs)[BK + 1], float (*ws)[BN + 1]) {
  constexpr int TN = BM * BN / 256;
  static_assert(BM * BN % 256 == 0 && BN % TN == 0, "tile must cover 256 threads");
  const int tid = threadIdx.x;
  const int tr = tid / (BN / TN);
  const int tc = (tid % (BN / TN)) * TN;
  for (int k0 = 0; k0 < K; k0 += BK) {
    for (int i = tid; i < BM * BK; i += 256) {
      const int r = i / BK, k = i % BK;
      const int gr = row0 + r, gk = k0 + k;
      xs[r][k] = (gr < rows && gk < K) ? a(gr, gk) : 0.f;
    }
    for (int i = tid; i < BK * BN; i += 256) {
      const int k = i / BN, c = i % BN;
      const int gk = k0 + k, gc = col0 + c;
      ws[k][c] = (gk < K && gc < N) ? static_cast<float>(w[(size_t)gk * N + gc]) : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < BK; ++k) {
      const float av = xs[tr][k];
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[j] = fmaf(av, ws[k][tc + j], acc[j]);
    }
    __syncthreads();
  }
}

}  // namespace omt

extern "C" const char* omt_error_string(int code);
