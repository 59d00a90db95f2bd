// Kernel 4: weight-only int8 matmul,  out[B, N] = (x[B, K] @ W[K, N]) * scale[N].
//
// Replaces the Pallas kernel open_musiclm_tpu/ops/quant.py:int8_matmul
// (pallas_call at ops/quant.py:80, body _kernel :36-43). On the serving path
// it is the logit head of every decode step: x [b, 1024], W [1024, 1025]
// int8 with a ragged output width of 1025.
//
// What bounds it on the H100: bytes. The head is 1 MB of int8 weights read
// once per token against 2*b*K*N FLOPs, far below the card's ~295 FLOP/byte
// balance point at decode batch sizes. The design therefore streams the
// weights as int8 (half the bytes of bf16), dequantizes them in shared memory
// and accumulates in float32 FMA. Column tiles are 16 wide so the 1025
// columns spread over 65 blocks (64-wide tiles gave 17 blocks on 132 SMs and
// ran 1.7x slower on an H100 80GB HBM3 at 700 W); a second 16-row block
// re-reads its column tile from L2, which holds the whole 1 MB head. The
// ragged last column tile is masked in the loads and the store; the
// per-column scale is applied once in the epilogue, as the TPU kernel does.
#include "common.cuh"

namespace {

constexpr int BM = 16, BN = 16, BK = 64;

template <typename T>
struct RowLoad {
  const T* x;
  int K;
  __device__ float operator()(int r, int k) const { return omt::to_f32(x[(size_t)r * K + k]); }
};

template <typename T>
__global__ void __launch_bounds__(256) int8_matmul_kernel(
    const T* __restrict__ x, const int8_t* __restrict__ w, const float* __restrict__ scale,
    T* __restrict__ out, int B, int K, int N) {
  __shared__ float xs[BM][BK + 1];
  __shared__ float ws[BK][BN + 1];
  constexpr int TN = BM * BN / 256;
  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;
  float acc[TN] = {};
  omt::int8_tile_gemm<BM, BN, BK>(RowLoad<T>{x, K}, w, B, K, N, row0, col0, acc, xs, ws);
  const int r = row0 + threadIdx.x / (BN / TN);
  const int c = col0 + (threadIdx.x % (BN / TN)) * TN;
  if (r >= B) return;
#pragma unroll
  for (int j = 0; j < TN; ++j)
    if (c + j < N) out[(size_t)r * N + c + j] = omt::from_f32<T>(acc[j] * scale[c + j]);
}

}  // namespace

extern "C" const char* omt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

extern "C" int omt_int8_matmul(const void* x, const void* w, const void* scale, void* out,
                               int B, int K, int N, int dtype, void* stream) {
  const dim3 grid((N + BN - 1) / BN, (B + BM - 1) / BM);
  auto s = static_cast<cudaStream_t>(stream);
  auto wq = static_cast<const int8_t*>(w);
  auto sc = static_cast<const float*>(scale);
  if (dtype == 0) {
    int8_matmul_kernel<float><<<grid, 256, 0, s>>>(
        static_cast<const float*>(x), wq, sc, static_cast<float*>(out), B, K, N);
  } else {
    int8_matmul_kernel<__nv_bfloat16><<<grid, 256, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), wq, sc, static_cast<__nv_bfloat16*>(out), B, K, N);
  }
  return static_cast<int>(cudaGetLastError());
}
