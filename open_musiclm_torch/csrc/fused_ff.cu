// Kernel 3: the int8 conv-feed-forward block of one decode step.
//
// Replaces the Pallas kernel open_musiclm_tpu/ops/fused_ff.py:fused_ff_apply
// (pallas_call at ops/fused_ff.py:204, body _kernel :55-114), which computes,
// for x [b, dim] and the [b, 2, 2*inner] conv state:
//   1. h = LN(x) * gin
//   2. u_v = (h @ Wv) * sv,  u_g = (h @ Wg) * sg          (int8, per-column scales)
//   3. causal 3-tap conv over (state[:, 0], state[:, 1], u)
//   4. g = GELU(conv_g) * conv_v                          (exact erf)
//   5. mid-LN over the true `inner` with variance E[g^2] - mu^2, times gmid
//   6. (gn @ Wout) * so                                    (int8)
//   7. y = x + that
//   8. new state = (state[:, 1], u)
//
// The mid-LN needs the whole `inner` row before step 6 can start, and on the
// H100 blocks cannot wait for each other inside one launch. So the wrapper
// makes two launches: ff_in (steps 1-4 and 8, writing g [b, inner] float32)
// and ff_out (steps 5-7). The g intermediate is b*inner*4 bytes (87 KB at
// b = 8), tiny next to the 8.4 MB of int8 weights per layer.
//
// What bounds it on the H100: bytes. musiclm_small's layer holds
// 2 * 1024 * 2730 + 2730 * 1024 = 8.4 MB of int8 FF weights, read once per
// decode token against 6 * b * 1024 * 2730 FLOPs: below the FLOP/byte balance
// point at any decode batch this repo serves. The design streams the weights
// as int8 (half of bf16), fuses the LayerNorm into the A-tile loads (each
// block recomputes its rows' statistics: 1024 or 2730 floats a row), and
// keeps the value/gate halves of one column tile in the same block so the
// GELU gate and the conv taps are applied in registers. Column tiles are 16
// wide so that ff_out's 1024 columns make 64 blocks (32-wide tiles: 32
// blocks on 132 SMs, 1.3x slower for the whole FF at batch 8 on an H100
// 80GB HBM3 at 700 W).
#include "common.cuh"

namespace {

constexpr int BM = 16, BN = 16, BK = 64;
constexpr int TN = BM * BN / 256;

// Per-row mean and 1/sqrt(var + eps) of x[row0 .. row0 + BM) over `width`.
// ``two_pass`` selects var = E[(x - mu)^2] (the LayerNorm of step 1, as
// jnp.var computes it) or var = E[x^2] - mu^2 (the mid-LN of step 5).
template <typename T>
__device__ void row_stats(const T* __restrict__ x, int rows, int width, int row0,
                          bool two_pass, float* mean, float* rstd) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < BM; r += 8) {
    const int gr = row0 + r;
    if (gr >= rows) {
      if (lane == 0) { mean[r] = 0.f; rstd[r] = 0.f; }
      continue;
    }
    const T* xr = x + (size_t)gr * width;
    float s = 0.f, s2 = 0.f;
    for (int k = lane; k < width; k += 32) {
      const float v = omt::to_f32(xr[k]);
      s += v;
      s2 += v * v;
    }
    const float mu = omt::warp_sum(s) / width;
    float var;
    if (two_pass) {
      float d2 = 0.f;
      for (int k = lane; k < width; k += 32) {
        const float d = omt::to_f32(xr[k]) - mu;
        d2 += d * d;
      }
      var = omt::warp_sum(d2) / width;
    } else {
      var = omt::warp_sum(s2) / width - mu * mu;
    }
    if (lane == 0) { mean[r] = mu; rstd[r] = rsqrtf(var + 1e-5f); }
  }
}

template <typename T>
struct NormLoad {  // A(r, k) = (x[r, k] - mean[r]) * rstd[r] * gamma[k]
  const T* x;
  const float* gamma;
  const float* mean;
  const float* rstd;
  int width, row0;
  __device__ float operator()(int r, int k) const {
    return (omt::to_f32(x[(size_t)r * width + k]) - mean[r - row0]) * rstd[r - row0] * gamma[k];
  }
};

template <typename T>
__global__ void __launch_bounds__(256) ff_in_kernel(
    const T* __restrict__ x, const float* __restrict__ gin,
    const int8_t* __restrict__ wv, const float* __restrict__ sv,
    const int8_t* __restrict__ wg, const float* __restrict__ sg,
    const float* __restrict__ conv_v, const float* __restrict__ conv_g,
    const T* __restrict__ state, float* __restrict__ g_out, T* __restrict__ new_state,
    int B, int dim, int inner) {
  __shared__ float xs[BM][BK + 1];
  __shared__ float ws[BK][BN + 1];
  __shared__ float mean[BM], rstd[BM];
  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;
  row_stats(x, B, dim, row0, true, mean, rstd);
  __syncthreads();
  const NormLoad<T> a{x, gin, mean, rstd, dim, row0};
  float acc_v[TN] = {}, acc_g[TN] = {};
  omt::int8_tile_gemm<BM, BN, BK>(a, wv, B, dim, inner, row0, col0, acc_v, xs, ws);
  omt::int8_tile_gemm<BM, BN, BK>(a, wg, B, dim, inner, row0, col0, acc_g, xs, ws);

  const int r = row0 + threadIdx.x / (BN / TN);
  const int c0 = col0 + (threadIdx.x % (BN / TN)) * TN;
  if (r >= B) return;
  const size_t width = 2 * (size_t)inner;
  const T* s0 = state + (size_t)r * 2 * width;  // state[r, 0, :]
  const T* s1 = s0 + width;                      // state[r, 1, :]
  T* n0 = new_state + (size_t)r * 2 * width;
  T* n1 = n0 + width;
#pragma unroll
  for (int j = 0; j < TN; ++j) {
    const int c = c0 + j;
    if (c >= inner) break;
    const float uv = acc_v[j] * sv[c];
    const float ug = acc_g[j] * sg[c];
    const float cv = omt::to_f32(s0[c]) * conv_v[c] + omt::to_f32(s1[c]) * conv_v[inner + c] +
                     uv * conv_v[2 * inner + c];
    const float cg = omt::to_f32(s0[inner + c]) * conv_g[c] +
                     omt::to_f32(s1[inner + c]) * conv_g[inner + c] + ug * conv_g[2 * inner + c];
    const float gelu = 0.5f * cg * (1.f + erff(cg * 0.7071067811865476f));
    g_out[(size_t)r * inner + c] = gelu * cv;
    n0[c] = s1[c];
    n0[inner + c] = s1[inner + c];
    n1[c] = omt::from_f32<T>(uv);
    n1[inner + c] = omt::from_f32<T>(ug);
  }
}

template <typename T>
__global__ void __launch_bounds__(256) ff_out_kernel(
    const float* __restrict__ g, const float* __restrict__ gmid,
    const int8_t* __restrict__ wo, const float* __restrict__ so,
    const T* __restrict__ x, T* __restrict__ y, int B, int inner, int dim) {
  __shared__ float xs[BM][BK + 1];
  __shared__ float ws[BK][BN + 1];
  __shared__ float mean[BM], rstd[BM];
  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;
  row_stats(g, B, inner, row0, false, mean, rstd);
  __syncthreads();
  const NormLoad<float> a{g, gmid, mean, rstd, inner, row0};
  float acc[TN] = {};
  omt::int8_tile_gemm<BM, BN, BK>(a, wo, B, inner, dim, row0, col0, acc, xs, ws);

  const int r = row0 + threadIdx.x / (BN / TN);
  const int c0 = col0 + (threadIdx.x % (BN / TN)) * TN;
  if (r >= B) return;
#pragma unroll
  for (int j = 0; j < TN; ++j) {
    const int c = c0 + j;
    if (c >= dim) break;
    const size_t i = (size_t)r * dim + c;
    y[i] = omt::from_f32<T>(omt::to_f32(x[i]) + acc[j] * so[c]);
  }
}

template <typename T>
void launch_in(const void* x, const void* gin, const void* wv, const void* sv, const void* wg,
               const void* sg, const void* conv_v, const void* conv_g, const void* state,
               void* g_out, void* new_state, int B, int dim, int inner, cudaStream_t s) {
  const dim3 grid((inner + BN - 1) / BN, (B + BM - 1) / BM);
  ff_in_kernel<T><<<grid, 256, 0, s>>>(
      static_cast<const T*>(x), static_cast<const float*>(gin),
      static_cast<const int8_t*>(wv), static_cast<const float*>(sv),
      static_cast<const int8_t*>(wg), static_cast<const float*>(sg),
      static_cast<const float*>(conv_v), static_cast<const float*>(conv_g),
      static_cast<const T*>(state), static_cast<float*>(g_out), static_cast<T*>(new_state),
      B, dim, inner);
}

template <typename T>
void launch_out(const void* g, const void* gmid, const void* wo, const void* so, const void* x,
                void* y, int B, int inner, int dim, cudaStream_t s) {
  const dim3 grid((dim + BN - 1) / BN, (B + BM - 1) / BM);
  ff_out_kernel<T><<<grid, 256, 0, s>>>(
      static_cast<const float*>(g), static_cast<const float*>(gmid),
      static_cast<const int8_t*>(wo), static_cast<const float*>(so),
      static_cast<const T*>(x), static_cast<T*>(y), B, inner, dim);
}

}  // namespace

extern "C" int omt_fused_ff_in(const void* x, const void* gin, const void* wv, const void* sv,
                               const void* wg, const void* sg, const void* conv_v,
                               const void* conv_g, const void* state, void* g_out,
                               void* new_state, int B, int dim, int inner, int dtype,
                               void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    launch_in<float>(x, gin, wv, sv, wg, sg, conv_v, conv_g, state, g_out, new_state, B, dim,
                     inner, s);
  else
    launch_in<__nv_bfloat16>(x, gin, wv, sv, wg, sg, conv_v, conv_g, state, g_out, new_state,
                             B, dim, inner, s);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int omt_fused_ff_out(const void* g, const void* gmid, const void* wo, const void* so,
                                const void* x, void* y, int B, int inner, int dim, int dtype,
                                void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    launch_out<float>(g, gmid, wo, so, x, y, B, inner, dim, s);
  else
    launch_out<__nv_bfloat16>(g, gmid, wo, so, x, y, B, inner, dim, s);
  return static_cast<int>(cudaGetLastError());
}
