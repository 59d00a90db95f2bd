// Kernel 1: prefill attention with one K/V head shared by all query heads.
//
// Replaces the Pallas kernel open_musiclm_tpu/ops/pallas_attention.py:
// shared_kv_attention_pallas (pallas_call at ops/pallas_attention.py:155,
// body _attn_kernel :32-78). For q [b, h, n, 64], k and v [b, m, 64]:
//   sim = q . k^T * scale + bias[h, n, m],  masked entries set to -1e9
//   (key mask, and the causal mask with offset m - n and an optional
//   bidirectional prefix), then an exact softmax over the keys and  . v.
// Output [b, n, h * 64]. Float32 accumulation throughout.
//
// Masked scores are set to -1e9, not -inf, exactly as the plain version does
// (ops/attention.py:shared_kv_attention): a row whose every key is masked
// then softmaxes to the same uniform row over all m keys.
//
// What bounds it on the H100: neither bytes nor FLOPs at these sizes, but
// the TPU design does not carry over: the TPU kernel loads all of K and V
// (and a [Bn, m] bias block) into VMEM per grid step, which does not fit a
// block's shared memory at m ~ 700. Here each block owns 128 (head, query)
// rows, one thread per row with its query and output accumulator in
// registers, and walks the keys in tiles of 32 with an online softmax. The
// single shared K/V head means each K/V tile, staged once in shared memory,
// serves all heads of the block's queries. Without a key mask, tiles beyond
// the last key any of the block's rows may see are skipped (their weights
// are exactly 0); with a key mask every tile is visited, so a fully masked
// row still averages over all m keys as the plain version does.
#include "common.cuh"

namespace {

constexpr int D = 64;
constexpr int ROWS = 128;  // (head, query) rows per block == threads per block
constexpr int KT = 32;     // keys per tile

template <typename T>
__global__ void __launch_bounds__(ROWS) prefill_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const float* __restrict__ bias, const uint8_t* __restrict__ key_mask, T* __restrict__ out,
    int heads, int n, int m, int causal, int ncp, float scale) {
  __shared__ float ks[KT][D];
  __shared__ float vs[KT][D];
  const int bq = ROWS / heads;  // query positions per block
  const int bi = blockIdx.y;
  const int i0 = blockIdx.x * bq;
  const int h = threadIdx.x / bq;
  const int i = i0 + threadIdx.x % bq;
  const bool active = i < n;
  const int off = m - n;

  float qr[D], acc[D];
  if (active) {
    const T* qp = q + (((size_t)bi * heads + h) * n + i) * D;
#pragma unroll
    for (int e = 0; e < D; ++e) qr[e] = omt::to_f32(qp[e]);
  }
#pragma unroll
  for (int e = 0; e < D; ++e) acc[e] = 0.f;
  float mx = -INFINITY, l = 0.f;

  int kv_end = m;
  if (causal && key_mask == nullptr) {
    const int i_last = min(i0 + bq, n) - 1;
    kv_end = i_last + off + 1;
    if (i0 < ncp) kv_end = max(kv_end, ncp + off);
    kv_end = min(kv_end, m);
  }
  const T* kb = k + (size_t)bi * m * D;
  const T* vb = v + (size_t)bi * m * D;
  const float* brow = bias ? bias + ((size_t)h * n + i) * m : nullptr;

  for (int j0 = 0; j0 < kv_end; j0 += KT) {
    const int nk = min(KT, kv_end - j0);
    __syncthreads();
    for (int t = threadIdx.x; t < nk * D; t += ROWS) {
      ks[t / D][t % D] = omt::to_f32(kb[(size_t)j0 * D + t]);
      vs[t / D][t % D] = omt::to_f32(vb[(size_t)j0 * D + t]);
    }
    __syncthreads();
    if (!active) continue;

    float s[KT];
    float tile_max = -INFINITY;
#pragma unroll
    for (int jj = 0; jj < KT; ++jj) {
      if (jj < nk) {
        const int j = j0 + jj;
        float dot = 0.f;
#pragma unroll
        for (int e = 0; e < D; ++e) dot = fmaf(qr[e], ks[jj][e], dot);
        float sv = dot * scale;
        if (brow) sv += brow[j];
        bool allowed = key_mask == nullptr || key_mask[(size_t)bi * m + j] != 0;
        if (causal) {
          bool ok = j <= i + off;
          if (ncp > 0) ok = ok || (i < ncp && j < ncp + off);
          allowed = allowed && ok;
        }
        s[jj] = allowed ? sv : omt::kNegInf;
        tile_max = fmaxf(tile_max, s[jj]);
      }
    }
    const float m_new = fmaxf(mx, tile_max);
    const float alpha = expf(mx - m_new);
    l *= alpha;
#pragma unroll
    for (int e = 0; e < D; ++e) acc[e] *= alpha;
#pragma unroll
    for (int jj = 0; jj < KT; ++jj) {
      if (jj < nk) {
        const float p = expf(s[jj] - m_new);
        l += p;
#pragma unroll
        for (int e = 0; e < D; ++e) acc[e] = fmaf(p, vs[jj][e], acc[e]);
      }
    }
    mx = m_new;
  }
  if (!active) return;
  const float inv = 1.f / fmaxf(l, 1e-30f);
  T* op = out + ((size_t)bi * n + i) * heads * D + (size_t)h * D;
#pragma unroll
  for (int e = 0; e < D; ++e) op[e] = omt::from_f32<T>(acc[e] * inv);
}

template <typename T>
void launch(const void* q, const void* k, const void* v, const void* bias, const void* key_mask,
            void* out, int b, int heads, int n, int m, int causal, int ncp, float scale,
            cudaStream_t s) {
  const int bq = ROWS / heads;
  const dim3 grid((n + bq - 1) / bq, b);
  prefill_attention_kernel<T><<<grid, ROWS, 0, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const float*>(bias), static_cast<const uint8_t*>(key_mask),
      static_cast<T*>(out), heads, n, m, causal, ncp, scale);
}

}  // namespace

extern "C" int omt_prefill_attention(const void* q, const void* k, const void* v,
                                     const void* bias, const void* key_mask, void* out, int b,
                                     int heads, int n, int m, int causal, int ncp, float scale,
                                     int dtype, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    launch<float>(q, k, v, bias, key_mask, out, b, heads, n, m, causal, ncp, scale, s);
  else
    launch<__nv_bfloat16>(q, k, v, bias, key_mask, out, b, heads, n, m, causal, ncp, scale, s);
  return static_cast<int>(cudaGetLastError());
}
