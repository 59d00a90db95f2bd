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
// What bounds it on the H100: bytes in principle (the live rows, (pos + 1) *
// 128 bytes a batch row in int8), but at decode sizes (a few MB) latency:
// one block walking a batch row's whole live cache alone leaves 124 of the
// 132 SMs idle at b 8. So the design is split-cache flash-decoding:
//   * the grid is (split, batch row); a split covers a run of 64-row chunks
//     of rows <= pos (the early exit: rows past pos are never read), as
//     ops/decode_attention.py:decode_splits chooses them;
//   * warp w is head w: the single shared K/V head makes one staged chunk
//     serve every query head, and the lanes map over the chunk's keys (two
//     each) for the scores and over the 64 output dims (two each) for p.V,
//     so no lane waits on a cross-lane reduction per key;
//   * chunks are staged with 16-byte cp.async copies, double buffered, each
//     16-byte unit of a row XOR-swizzled by the row's index so that lanes
//     reading eight different rows hit eight different bank groups; the
//     chunk's scales, bias rows and mask are staged with it (4-byte copies);
//   * each split writes its (max, denominator, 64 accumulators) per head to
//     a float32 scratch; the last block of a batch row to finish (a
//     __threadfence and an atomic ticket per row, reset to 0 by that block)
//     folds the row's partials and writes the output, in the same launch.
//     A single split writes its output straight from registers.
#include "common.cuh"

namespace {

constexpr int D = 64;        // dim_head
constexpr int CH = 64;       // cache rows a chunk
constexpr int PW = 2 + D;    // a partial record: max, denominator, 64 accumulators

template <typename KV>
struct Layout {
  static constexpr int kUnits = 2 * D * sizeof(KV) / 16;  // 16-byte units a cache row
  static constexpr int kKUnits = kUnits / 2;               // of which K
  static constexpr int kPerUnit = 16 / sizeof(KV);         // elements a unit
  static constexpr int kRowBytes = 2 * D * sizeof(KV);
};

// byte offset of unit u of row j in a staged chunk
template <typename KV>
__device__ __forceinline__ int unit_off(int j, int u) {
  return (j * Layout<KV>::kUnits + (u ^ (j & 7))) * 16;
}

// elements t of a 16-byte unit as floats
__device__ __forceinline__ void unpack(const int4& w, float (&x)[16]) {
  const int words[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    const char4 c = *reinterpret_cast<const char4*>(&words[t]);
    x[4 * t] = c.x;
    x[4 * t + 1] = c.y;
    x[4 * t + 2] = c.z;
    x[4 * t + 3] = c.w;
  }
}
__device__ __forceinline__ void unpack(const int4& w, float (&x)[8]) {
  const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&w);
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    const float2 f = __bfloat1622float2(p[t]);
    x[2 * t] = f.x;
    x[2 * t + 1] = f.y;
  }
}
__device__ __forceinline__ void unpack(const int4& w, float (&x)[4]) {
  x[0] = __int_as_float(w.x);
  x[1] = __int_as_float(w.y);
  x[2] = __int_as_float(w.z);
  x[3] = __int_as_float(w.w);
}

// V elements d, d + 1 of a staged row (d even)
__device__ __forceinline__ float2 v_pair(const int8_t* p) {
  const char2 c = *reinterpret_cast<const char2*>(p);
  return make_float2(c.x, c.y);
}
__device__ __forceinline__ float2 v_pair(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ float2 v_pair(const float* p) { return *reinterpret_cast<const float2*>(p); }

struct Args {
  const void* q;
  const void* kv;
  const float* scales;
  const float* bias_row;
  const float* add_mask;
  void* out;
  float* part;  // [b, splits, heads, PW]
  int* ticket;  // [b], 0 between launches
  int b, heads, N, pos, per;
  float scale;
};

// dynamic shared memory: two stages of [rows | ksc | vsc | mask | bias (head-major)]
template <typename KV>
__host__ __device__ constexpr int stage_bytes(int heads) {
  return CH * Layout<KV>::kRowBytes + (3 + heads) * CH * 4;
}

template <typename T, typename KV, bool QUANT>
__global__ void __launch_bounds__(512) flash_decode_kernel(Args a) {
  using L = Layout<KV>;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float qs[16][D];
  __shared__ int last;
  const int split = blockIdx.x, splits = gridDim.x, bi = blockIdx.y;
  const int heads = a.heads, nthreads = blockDim.x;
  const int w = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int sbytes = stage_bytes<KV>(heads);
  const int c_begin = split * a.per;
  const int c_end = min(c_begin + a.per, a.pos / CH + 1);

  const T* q = static_cast<const T*>(a.q) + (size_t)bi * heads * D;
  for (int i = threadIdx.x; i < heads * D; i += nthreads) qs[i / D][i % D] = omt::to_f32(q[i]);

  const unsigned char* kvb =
      static_cast<const unsigned char*>(a.kv) + (size_t)bi * a.N * L::kRowBytes;
  auto load_chunk = [&](int c, int stage) {
    unsigned char* s = smem + stage * sbytes;
    const int c0 = c * CH, nk = min(CH, a.pos + 1 - c0);
    for (int i = threadIdx.x; i < nk * L::kUnits; i += nthreads) {
      const int j = i / L::kUnits, u = i % L::kUnits;
      omt::cp_async16(s + unit_off<KV>(j, u), kvb + (size_t)(c0 + j) * L::kRowBytes + u * 16);
    }
    float* f = reinterpret_cast<float*>(s + CH * L::kRowBytes);
    for (int i = threadIdx.x; i < nk * (heads + 1); i += nthreads) {
      if (i < nk) {
        omt::cp_async4(f + 2 * CH + i, a.add_mask + (size_t)bi * a.N + c0 + i);
      } else {  // bias_row [N, heads] -> head-major [heads][CH]
        const int t = i - nk, j = t / heads, h = t % heads;
        omt::cp_async4(f + (3 + h) * CH + j, a.bias_row + (size_t)(c0 + j) * heads + h);
      }
    }
    if (QUANT) {
      for (int i = threadIdx.x; i < 2 * nk; i += nthreads) {
        const int r = i / nk, j = i % nk;
        omt::cp_async4(f + r * CH + j, a.scales + ((size_t)r * a.b + bi) * a.N + c0 + j);
      }
    }
    omt::cp_async_commit();
  };

  load_chunk(c_begin, 0);
  __syncthreads();  // qs
  float qr[D];
#pragma unroll
  for (int e = 0; e < D; ++e) qr[e] = qs[w][e];

  float m = -INFINITY, l = 0.f, acc0 = 0.f, acc1 = 0.f;  // acc: dims 2 lane, 2 lane + 1
  for (int c = c_begin; c < c_end; ++c) {
    const int stage = (c - c_begin) & 1;
    if (c + 1 < c_end) {
      load_chunk(c + 1, stage ^ 1);
      omt::cp_async_wait<1>();
    } else {
      omt::cp_async_wait<0>();
    }
    __syncthreads();  // chunk c staged by every thread
    const unsigned char* s = smem + stage * sbytes;
    const float* f = reinterpret_cast<const float*>(s + CH * L::kRowBytes);
    const int nk = min(CH, a.pos + 1 - c * CH);
    float sc[2];
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      const int j = lane + 32 * t;
      sc[t] = -INFINITY;
      if (j < nk) {
        float dot = 0.f;
#pragma unroll
        for (int u = 0; u < L::kKUnits; ++u) {
          float x[L::kPerUnit];
          unpack(*reinterpret_cast<const int4*>(s + unit_off<KV>(j, u)), x);
#pragma unroll
          for (int e = 0; e < L::kPerUnit; ++e) dot = fmaf(qr[u * L::kPerUnit + e], x[e], dot);
        }
        if (QUANT) dot *= f[j];
        sc[t] = dot * a.scale + f[(3 + w) * CH + j] + f[2 * CH + j];
      }
    }
    const float m_new = fmaxf(m, omt::warp_max(fmaxf(sc[0], sc[1])));
    const float alpha = expf(m - m_new);
    float p0 = expf(sc[0] - m_new), p1 = expf(sc[1] - m_new);  // 0 past nk
    l = l * alpha + omt::warp_sum(p0 + p1);
    if (QUANT) {
      if (lane < nk) p0 *= f[CH + lane];
      if (lane + 32 < nk) p1 *= f[CH + lane + 32];
    }
    acc0 *= alpha;
    acc1 *= alpha;
    // V element d of row j: unit (D + d) / per-unit, swizzled
    const int vu = (D + 2 * lane) / L::kPerUnit, vo = ((D + 2 * lane) % L::kPerUnit) * sizeof(KV);
    const int n0 = min(nk, 32);
    for (int j = 0; j < n0; ++j) {
      const float p = __shfl_sync(0xffffffffu, p0, j);
      const float2 vv = v_pair(reinterpret_cast<const KV*>(s + unit_off<KV>(j, vu) + vo));
      acc0 = fmaf(p, vv.x, acc0);
      acc1 = fmaf(p, vv.y, acc1);
    }
    for (int j = 32; j < nk; ++j) {
      const float p = __shfl_sync(0xffffffffu, p1, j - 32);
      const float2 vv = v_pair(reinterpret_cast<const KV*>(s + unit_off<KV>(j, vu) + vo));
      acc0 = fmaf(p, vv.x, acc0);
      acc1 = fmaf(p, vv.y, acc1);
    }
    m = m_new;
    __syncthreads();  // this stage is free for chunk c + 2
  }

  T* out = static_cast<T*>(a.out) + (size_t)bi * heads * D;
  if (splits == 1) {
    const float inv = 1.f / fmaxf(l, 1e-30f);
    out[w * D + 2 * lane] = omt::from_f32<T>(acc0 * inv);
    out[w * D + 2 * lane + 1] = omt::from_f32<T>(acc1 * inv);
    return;
  }

  float* row_part = a.part + (size_t)bi * splits * heads * PW;
  float* rec = row_part + ((size_t)split * heads + w) * PW;
  if (lane == 0) {
    rec[0] = m;
    rec[1] = l;
  }
  reinterpret_cast<float2*>(rec + 2)[lane] = make_float2(acc0, acc1);
  __threadfence();  // the partials are visible before the ticket is taken
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(a.ticket + bi, 1) == splits - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  // fold head w: lanes take the splits' (max, denominator) 32 at a time, and
  // each split's accumulators weighted by its factor, loads kept in flight
  const float* rec0 = row_part + (size_t)w * PW;
  float mx = -INFINITY;
  for (int s = lane; s < splits; s += 32) mx = fmaxf(mx, __ldcg(rec0 + (size_t)s * heads * PW));
  mx = omt::warp_max(mx);
  float den = 0.f, o0 = 0.f, o1 = 0.f;
  for (int s0 = 0; s0 < splits; s0 += 32) {
    float f = 0.f;
    if (s0 + lane < splits) {
      const float* r = rec0 + (size_t)(s0 + lane) * heads * PW;
      f = expf(__ldcg(r) - mx);
      den = fmaf(__ldcg(r + 1), f, den);
    }
    const int ns = min(32, splits - s0);
#pragma unroll 4
    for (int j = 0; j < ns; ++j) {
      const float fj = __shfl_sync(0xffffffffu, f, j);
      const float2 acc = __ldcg(reinterpret_cast<const float2*>(rec0 + (size_t)(s0 + j) * heads * PW + 2) + lane);
      o0 = fmaf(acc.x, fj, o0);
      o1 = fmaf(acc.y, fj, o1);
    }
  }
  const float inv = 1.f / fmaxf(omt::warp_sum(den), 1e-30f);
  out[w * D + 2 * lane] = omt::from_f32<T>(o0 * inv);
  out[w * D + 2 * lane + 1] = omt::from_f32<T>(o1 * inv);
  if (threadIdx.x == 0) a.ticket[bi] = 0;  // ready for the next launch
}

template <typename T, typename KV, bool QUANT>
int launch_rows(const Args& a, int splits, cudaStream_t s) {
  const int smem = 2 * stage_bytes<KV>(a.heads);
  auto kernel = flash_decode_kernel<T, KV, QUANT>;
  static int configured = 0;  // the largest dynamic shared memory this kernel was allowed
  if (smem > configured) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = smem;
  }
  kernel<<<dim3(splits, a.b), 32 * a.heads, smem, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// kv_dtype: 0 float32 rows, 1 bf16 rows, 2 int8 rows with scales
template <typename T>
int launch(const Args& a, int splits, int kv_dtype, cudaStream_t s) {
  if (kv_dtype == 2) return launch_rows<T, int8_t, true>(a, splits, s);
  if (kv_dtype == 0) return launch_rows<T, float, false>(a, splits, s);
  return launch_rows<T, __nv_bfloat16, false>(a, splits, s);
}

}  // namespace

extern "C" int omt_flash_decode(const void* q, const void* kv, const void* scales,
                                const void* bias_row, const void* add_mask, void* out, void* part,
                                void* ticket, int b, int heads, int N, int pos, int splits,
                                int per, float scale, int dtype, int kv_dtype, void* stream) {
  const Args a{q, kv, static_cast<const float*>(scales), static_cast<const float*>(bias_row),
               static_cast<const float*>(add_mask), out, static_cast<float*>(part),
               static_cast<int*>(ticket), b, heads, N, pos, per, scale};
  auto s = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? launch<float>(a, splits, kv_dtype, s)
                    : launch<__nv_bfloat16>(a, splits, kv_dtype, s);
}
