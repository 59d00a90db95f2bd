// Kernel 2: flash-decode attention of one query row against the packed K|V cache.
//
// Replaces the Pallas kernel open_musiclm_tpu/ops/decode_attention.py:
// flash_decode_step (pallas_call at ops/decode_attention.py:195, body _kernel
// :60-160). Per batch row and head h:
//   sim[j] = (q[h] . K[j]) * ks[j] * scale + bias_row[j, h] + add_mask[j]   (j <= pos)
//   out[h] = softmax(sim) @ (V * vs)
// with the cache packed as [b, N, 2*64] (K in lanes 0:64, V in 64:128), rows
// in int8 with per-row float32 scales [2, b, N] (K row 0, V row 1) or in
// float32 or bf16 without scales, whatever the activations' dtype (the
// "f32" mode keeps float32 rows under bf16 activations). As in the TPU kernel, the K scale is
// applied after the dot and the V scale is folded into p after p has been
// added to the softmax denominator (ops/decode_attention.py:135-151).
//
// What bounds it on the H100: bytes. The step reads the live cache rows,
// (pos + 1) * 128 bytes a batch row in int8 (plus 8 bytes of scales), for
// 4 * heads * 64 FLOPs a row. The design keeps the TPU kernel's two byte
// savings: it stops at row `pos` (the early exit; the rest of the N-row
// buffer is never read) and reads int8 rows. One block serves one batch
// row and all heads, because the single shared K/V head makes one cache
// tile serve every query head: warp w is head w, K/V tiles of 64 rows are
// staged in shared memory once, and each warp runs its own online softmax.
#include "common.cuh"

namespace {

constexpr int D = 64;   // dim_head
constexpr int CH = 64;  // cache rows staged per tile

template <typename T, typename KV, bool QUANT>
__global__ void flash_decode_kernel(
    const T* __restrict__ q, const KV* __restrict__ kv, const float* __restrict__ scales,
    const float* __restrict__ bias_row, const float* __restrict__ add_mask, T* __restrict__ out,
    int b, int heads, int N, int pos, float scale) {
  __shared__ float ks[CH][D + 1];
  __shared__ float vs[CH][D + 1];
  __shared__ float ksc[CH], vsc[CH];
  __shared__ float qs[16][D];
  __shared__ float ps[16][CH];
  const int bi = blockIdx.x;
  const int w = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int nthreads = blockDim.x;

  for (int i = threadIdx.x; i < heads * D; i += nthreads)
    qs[i / D][i % D] = omt::to_f32(q[(size_t)bi * heads * D + i]);

  float m = -INFINITY, l = 0.f, acc0 = 0.f, acc1 = 0.f;
  const KV* kvb = kv + (size_t)bi * N * 2 * D;
  for (int c0 = 0; c0 <= pos; c0 += CH) {
    const int nk = min(CH, pos + 1 - c0);
    __syncthreads();  // previous tile fully consumed (and qs written, first time)
    for (int i = threadIdx.x; i < nk * 2 * D; i += nthreads) {
      const int r = i / (2 * D), e = i % (2 * D);
      const float v = omt::to_f32(kvb[(size_t)(c0 + r) * 2 * D + e]);
      if (e < D) ks[r][e] = v; else vs[r][e - D] = v;
    }
    if (QUANT) {
      for (int i = threadIdx.x; i < nk; i += nthreads) {
        ksc[i] = scales[(size_t)bi * N + c0 + i];
        vsc[i] = scales[((size_t)b + bi) * N + c0 + i];
      }
    }
    __syncthreads();

    // lane owns keys lane and lane + 32 of the tile
    float s[2];
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      const int j = lane + 32 * t;
      if (j < nk) {
        float dot = 0.f;
#pragma unroll 16
        for (int e = 0; e < D; ++e) dot = fmaf(qs[w][e], ks[j][e], dot);
        if (QUANT) dot *= ksc[j];
        s[t] = dot * scale + bias_row[(size_t)(c0 + j) * heads + w] +
               add_mask[(size_t)bi * N + c0 + j];
      } else {
        s[t] = -INFINITY;
      }
    }
    const float m_new = fmaxf(m, omt::warp_max(fmaxf(s[0], s[1])));
    const float alpha = expf(m - m_new);
    float p0 = lane < nk ? expf(s[0] - m_new) : 0.f;
    float p1 = lane + 32 < nk ? expf(s[1] - m_new) : 0.f;
    l = l * alpha + omt::warp_sum(p0 + p1);
    if (QUANT) {
      if (lane < nk) p0 *= vsc[lane];
      if (lane + 32 < nk) p1 *= vsc[lane + 32];
    }
    ps[w][lane] = p0;
    ps[w][lane + 32] = p1;
    __syncwarp();
    acc0 *= alpha;
    acc1 *= alpha;
    for (int j = 0; j < nk; ++j) {
      const float p = ps[w][j];
      acc0 = fmaf(p, vs[j][lane], acc0);
      acc1 = fmaf(p, vs[j][lane + 32], acc1);
    }
    m = m_new;
  }
  const float inv = 1.f / fmaxf(l, 1e-30f);
  T* o = out + ((size_t)bi * heads + w) * D;
  o[lane] = omt::from_f32<T>(acc0 * inv);
  o[lane + 32] = omt::from_f32<T>(acc1 * inv);
}

template <typename T, typename KV, bool QUANT>
void launch_rows(const void* q, const void* kv, const void* scales, const void* bias_row,
                 const void* add_mask, void* out, int b, int heads, int N, int pos, float scale,
                 cudaStream_t s) {
  flash_decode_kernel<T, KV, QUANT><<<b, 32 * heads, 0, s>>>(
      static_cast<const T*>(q), static_cast<const KV*>(kv), static_cast<const float*>(scales),
      static_cast<const float*>(bias_row), static_cast<const float*>(add_mask),
      static_cast<T*>(out), b, heads, N, pos, scale);
}

// kv_dtype: 0 float32 rows, 1 bf16 rows, 2 int8 rows with scales
template <typename T>
void launch(const void* q, const void* kv, const void* scales, const void* bias_row,
            const void* add_mask, void* out, int b, int heads, int N, int pos, float scale,
            int kv_dtype, cudaStream_t s) {
  if (kv_dtype == 2)
    launch_rows<T, int8_t, true>(q, kv, scales, bias_row, add_mask, out, b, heads, N, pos, scale, s);
  else if (kv_dtype == 0)
    launch_rows<T, float, false>(q, kv, scales, bias_row, add_mask, out, b, heads, N, pos, scale, s);
  else
    launch_rows<T, __nv_bfloat16, false>(q, kv, scales, bias_row, add_mask, out, b, heads, N, pos,
                                         scale, s);
}

}  // namespace

extern "C" int omt_flash_decode(const void* q, const void* kv, const void* scales,
                                const void* bias_row, const void* add_mask, void* out, int b,
                                int heads, int N, int pos, float scale, int dtype, int kv_dtype,
                                void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    launch<float>(q, kv, scales, bias_row, add_mask, out, b, heads, N, pos, scale, kv_dtype, s);
  else
    launch<__nv_bfloat16>(q, kv, scales, bias_row, add_mask, out, b, heads, N, pos, scale,
                          kv_dtype, s);
  return static_cast<int>(cudaGetLastError());
}
