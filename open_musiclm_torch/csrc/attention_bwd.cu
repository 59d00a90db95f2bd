// Kernels 5 and 6: the backward of the shared-KV prefill attention (kernel 1).
//
// Replaces the two Pallas kernels of open_musiclm_tpu/ops/pallas_attention.py:
// _fused_bwd -> _bwd_kernel (pallas_call at :420, body :181-255; dq, dk, dv)
// and _fused_bwd -> _dbias_kernel (pallas_call at :475, body :258-312; dbias).
// For q [b, h, n, 64], k and v [b, m, 64] (one K/V head shared by the h query
// heads), bias [h, n, m] and dO [b, n, h, 64] (the layout of the forward
// output), with p the forward's softmax:
//   dp = dO . v^T,  ds = p * (dp - rowsum(dp * p)),
//   dq = ds . k * scale,  dk = sum_h ds^T . q * scale,  dv = sum_h p^T . dO,
//   dbias = sum_b ds.
// Float32 accumulation; dq, dk, dv in the input type. The bias is read in its
// own type (float32 or bf16, as the caller holds it) and dbias is written in
// that type, so the wrapper makes no float32 copy of either.
//
// What bounds it on the H100: FLOPs. At coarse training (b 2, n = m = 1116)
// the three products per score entry and the recomputed q.k and dO.v make
// ~13 GFLOP per layer against ~10 MB of inputs; dbias adds the [8, n, m]
// bias read and its gradient written (20 MB each in bf16). These kernels use
// the CUDA cores in float32, not the tensor cores, so they run far from the
// bf16 bound (PERF.md).
//
// One entry point, omt_attention_bwd, runs the delta pass once and then
// kernel 5 (dq, then dk/dv) and, when the caller asks for dbias, kernel 6.
//
// The TPU design does not carry over, for two reasons, and this is what
// the design does about each:
//  * The TPU grid runs in order and carries sums from step to step: dk/dv
//    accumulate over (head, query block) in the output block, dbias over the
//    batch. Blocks here run in parallel and in no order, and no atomics are
//    used, so the gradients are the same from run to run: each output tile
//    is owned by one block that loops over what the TPU grid walked. dk/dv
//    are first summed per head by one block per (batch, head, key tile) into
//    float32 partials [h, b, m, 64], then a small pass sums the h partials;
//    dbias is one block per (head, query tile, key tile) looping over b.
//  * The TPU recomputes the whole-row softmax from all m keys in VMEM; a
//    [32, m] float32 score block does not fit shared memory at m ~ 1200.
//    Kernel 1 writes each row's softmax statistics (max, denominator) in
//    the training forward, so a 32 x 32 tile of p is computed on its own:
//    p = exp(s - max) / denominator, and rowsum(dp * p) = rowsum(dO * O) is
//    one cheap pass over the forward output (delta).
// Masking is exact: a masked score is -1e9, as in kernel 1 and the plain
// version. Tiles that the causal mask hides entirely are skipped, unless a
// row of the query tile is masked entirely (row max -1e9): such a row
// spreads its weight over all m keys, as the plain version does.
//
// Every block holds one 32-query x 32-key tile pair in shared memory and
// runs 128 threads; thread (warp w, lane l) scores key l against queries
// 8w..8w+7, and in the products owns dims l and l + 32 of 8 rows.
#include "common.cuh"

namespace {

constexpr int D = 64;
constexpr int TQ = 32;       // queries per tile
constexpr int TK = 32;       // keys per tile
constexpr int THREADS = 128;
constexpr int RPT = TQ * TK / THREADS;  // score entries per thread (8 rows of one key)
constexpr float kDeadRow = -5e8f;       // a row max below this: every key masked

struct Geometry {
  int heads, n, m, causal, ncp;
  float scale;
};

// One (batch, head, query tile) x (batch, key tile) pair. The key rows are
// padded to D + 1 floats: in the score pass the 32 lanes of a warp read 32
// different key rows at one dim, and the padding puts them in 32 banks.
struct __align__(16) Tiles {
  float q[TQ][D];
  float dout[TQ][D];
  float p[TQ][TK];
  float ds[TQ][TK];
  float k[TK][D + 1];
  float v[TK][D + 1];
  float mx[TQ];
  float inv_l[TQ];
  float delta[TQ];
};

// Row statistics of the query tile; thread r < TQ writes row r, so it may
// read its own row before any barrier. Rows past n get p = 0.
__device__ void load_stats(Tiles& s, const float* __restrict__ stats,
                           const float* __restrict__ delta, int bi, int h, int i0,
                           const Geometry& g) {
  const int r = threadIdx.x;
  if (r >= TQ) return;
  const int i = i0 + r;
  if (i < g.n) {
    const size_t row = ((size_t)bi * g.heads + h) * g.n + i;
    s.mx[r] = stats[2 * row];
    s.inv_l[r] = 1.f / fmaxf(stats[2 * row + 1], 1e-30f);
    s.delta[r] = delta[row];
  } else {
    s.mx[r] = 0.f;
    s.inv_l[r] = 0.f;
    s.delta[r] = 0.f;
  }
}

// True on every thread when a row of the tile has every key masked.
__device__ bool tile_has_dead_row(const Tiles& s) {
  return __syncthreads_or(threadIdx.x < TQ && s.mx[threadIdx.x] < kDeadRow);
}

// Whether the query tile [i0, i0 + TQ) sees any key of [j0, j0 + TK).
__device__ bool tile_visible(const Geometry& g, int i0, int j0, bool dead) {
  if (!g.causal || dead) return true;
  const int off = g.m - g.n;
  const int i_last = min(i0 + TQ, g.n) - 1;
  if (j0 <= i_last + off) return true;
  return g.ncp > 0 && i0 < g.ncp && j0 < g.ncp + off;
}

template <typename T>
__device__ void load_query_tile(Tiles& s, const T* __restrict__ q, const T* __restrict__ dout,
                                int bi, int h, int i0, const Geometry& g) {
  for (int t = threadIdx.x; t < TQ * D; t += THREADS) {
    const int r = t / D, e = t % D, i = i0 + r;
    float qv = 0.f, dv = 0.f;
    if (i < g.n) {
      qv = omt::to_f32(q[(((size_t)bi * g.heads + h) * g.n + i) * D + e]);
      dv = omt::to_f32(dout[(((size_t)bi * g.n + i) * g.heads + h) * D + e]);
    }
    s.q[r][e] = qv;
    s.dout[r][e] = dv;
  }
}

template <typename T>
__device__ void load_key_tile(Tiles& s, const T* __restrict__ k, const T* __restrict__ v,
                              int bi, int j0, int m) {
  for (int t = threadIdx.x; t < TK * D; t += THREADS) {
    const int r = t / D, e = t % D, j = j0 + r;
    const size_t at = ((size_t)bi * m + j) * D + e;
    s.k[r][e] = j < m ? omt::to_f32(k[at]) : 0.f;
    s.v[r][e] = j < m ? omt::to_f32(v[at]) : 0.f;
  }
}

// The score pass: p and ds of the tile into s.p / s.ds, and this thread's
// eight ds values (key lane, rows 8w..8w+7) into ds_out.
template <typename B>
__device__ void score_tile(Tiles& s, const B* __restrict__ bias,
                           const uint8_t* __restrict__ key_mask, int bi, int h, int i0, int j0,
                           const Geometry& g, float (&ds_out)[RPT]) {
  const int c = threadIdx.x % 32;
  const int r0 = (threadIdx.x / 32) * RPT;
  float dot[RPT], dpv[RPT];
#pragma unroll
  for (int rr = 0; rr < RPT; ++rr) dot[rr] = dpv[rr] = 0.f;
#pragma unroll 4
  for (int e = 0; e < D; e += 4) {
    const float k0 = s.k[c][e], k1 = s.k[c][e + 1], k2 = s.k[c][e + 2], k3 = s.k[c][e + 3];
    const float v0 = s.v[c][e], v1 = s.v[c][e + 1], v2 = s.v[c][e + 2], v3 = s.v[c][e + 3];
#pragma unroll
    for (int rr = 0; rr < RPT; ++rr) {
      const float4 qv = *reinterpret_cast<const float4*>(&s.q[r0 + rr][e]);
      const float4 ov = *reinterpret_cast<const float4*>(&s.dout[r0 + rr][e]);
      dot[rr] = fmaf(qv.x, k0, fmaf(qv.y, k1, fmaf(qv.z, k2, fmaf(qv.w, k3, dot[rr]))));
      dpv[rr] = fmaf(ov.x, v0, fmaf(ov.y, v1, fmaf(ov.z, v2, fmaf(ov.w, v3, dpv[rr]))));
    }
  }
  const int j = j0 + c;
  const int off = g.m - g.n;
  const bool key_ok = j < g.m && (key_mask == nullptr || key_mask[(size_t)bi * g.m + j] != 0);
#pragma unroll
  for (int rr = 0; rr < RPT; ++rr) {
    const int r = r0 + rr, i = i0 + r;
    float p = 0.f, d = 0.f;
    if (i < g.n && j < g.m) {
      float sv = dot[rr] * g.scale;
      if (bias) sv += omt::to_f32(bias[((size_t)h * g.n + i) * g.m + j]);
      bool allowed = key_ok;
      if (g.causal) {
        bool ok = j <= i + off;
        if (g.ncp > 0) ok = ok || (i < g.ncp && j < g.ncp + off);
        allowed = allowed && ok;
      }
      if (!allowed) sv = omt::kNegInf;
      p = expf(sv - s.mx[r]) * s.inv_l[r];
      d = p * (dpv[rr] - s.delta[r]);
    }
    s.p[r][c] = p;
    s.ds[r][c] = d;
    ds_out[rr] = d;
  }
}

// delta[b, h, i] = dO[b, i, h, :] . O[b, i, h, :], one thread per row.
template <typename T>
__global__ void delta_kernel(const T* __restrict__ out, const T* __restrict__ dout,
                             float* __restrict__ delta, int rows, int heads, int n) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= rows) return;
  const T* o = out + (size_t)t * D;
  const T* d = dout + (size_t)t * D;
  float acc = 0.f;
#pragma unroll 8
  for (int e = 0; e < D; ++e) acc = fmaf(omt::to_f32(o[e]), omt::to_f32(d[e]), acc);
  const int hh = t % heads, i = (t / heads) % n, bi = t / (heads * n);
  delta[((size_t)bi * heads + hh) * n + i] = acc;
}

// Kernel 5b: dq. One block per (query tile, head, batch), looping over key tiles.
template <typename T, typename B>
__global__ void __launch_bounds__(THREADS) dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const B* __restrict__ bias, const uint8_t* __restrict__ key_mask,
    const T* __restrict__ dout, const float* __restrict__ stats,
    const float* __restrict__ delta, T* __restrict__ dq, Geometry g) {
  __shared__ Tiles s;
  const int i0 = blockIdx.x * TQ, h = blockIdx.y, bi = blockIdx.z;
  const int lane = threadIdx.x % 32, r0 = (threadIdx.x / 32) * RPT;
  load_stats(s, stats, delta, bi, h, i0, g);
  const bool dead = tile_has_dead_row(s);
  load_query_tile(s, q, dout, bi, h, i0, g);
  float acc[RPT][2];
#pragma unroll
  for (int rr = 0; rr < RPT; ++rr) acc[rr][0] = acc[rr][1] = 0.f;
  float ds_reg[RPT];
  for (int j0 = 0; j0 < g.m; j0 += TK) {
    if (!tile_visible(g, i0, j0, dead)) continue;
    load_key_tile(s, k, v, bi, j0, g.m);
    __syncthreads();
    score_tile(s, bias, key_mask, bi, h, i0, j0, g, ds_reg);
    __syncthreads();
#pragma unroll 2
    for (int c = 0; c < TK; c += 4) {
      float ka[4], kb[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        ka[u] = s.k[c + u][lane];
        kb[u] = s.k[c + u][lane + 32];
      }
#pragma unroll
      for (int rr = 0; rr < RPT; ++rr) {
        const float4 d = *reinterpret_cast<const float4*>(&s.ds[r0 + rr][c]);
        acc[rr][0] = fmaf(d.x, ka[0], fmaf(d.y, ka[1], fmaf(d.z, ka[2], fmaf(d.w, ka[3], acc[rr][0]))));
        acc[rr][1] = fmaf(d.x, kb[0], fmaf(d.y, kb[1], fmaf(d.z, kb[2], fmaf(d.w, kb[3], acc[rr][1]))));
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int rr = 0; rr < RPT; ++rr) {
    const int i = i0 + r0 + rr;
    if (i >= g.n) continue;
    T* row = dq + (((size_t)bi * g.heads + h) * g.n + i) * D;
    row[lane] = omt::from_f32<T>(acc[rr][0] * g.scale);
    row[lane + 32] = omt::from_f32<T>(acc[rr][1] * g.scale);
  }
}

// Kernel 5a: per-head partial dk, dv [h, b, m, D] in float32. One block per
// (key tile, head, batch), looping over query tiles.
template <typename T, typename B>
__global__ void __launch_bounds__(THREADS) dkdv_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const B* __restrict__ bias, const uint8_t* __restrict__ key_mask,
    const T* __restrict__ dout, const float* __restrict__ stats,
    const float* __restrict__ delta, float* __restrict__ dk_part,
    float* __restrict__ dv_part, int batch, Geometry g) {
  __shared__ Tiles s;
  const int j0 = blockIdx.x * TK, h = blockIdx.y, bi = blockIdx.z;
  const int lane = threadIdx.x % 32, c0 = (threadIdx.x / 32) * RPT;
  load_key_tile(s, k, v, bi, j0, g.m);
  float dk[RPT][2], dv[RPT][2];
#pragma unroll
  for (int cc = 0; cc < RPT; ++cc) dk[cc][0] = dk[cc][1] = dv[cc][0] = dv[cc][1] = 0.f;
  float ds_reg[RPT];
  for (int i0 = 0; i0 < g.n; i0 += TQ) {
    load_stats(s, stats, delta, bi, h, i0, g);
    const bool dead = tile_has_dead_row(s);
    if (!tile_visible(g, i0, j0, dead)) continue;
    load_query_tile(s, q, dout, bi, h, i0, g);
    __syncthreads();
    score_tile(s, bias, key_mask, bi, h, i0, j0, g, ds_reg);
    __syncthreads();
#pragma unroll 2
    for (int r = 0; r < TQ; ++r) {
      const float qa = s.q[r][lane], qb = s.q[r][lane + 32];
      const float oa = s.dout[r][lane], ob = s.dout[r][lane + 32];
#pragma unroll
      for (int cc = 0; cc < RPT; cc += 4) {
        const float4 d = *reinterpret_cast<const float4*>(&s.ds[r][c0 + cc]);
        const float4 p = *reinterpret_cast<const float4*>(&s.p[r][c0 + cc]);
        const float dd[4] = {d.x, d.y, d.z, d.w}, pp[4] = {p.x, p.y, p.z, p.w};
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          dk[cc + u][0] = fmaf(dd[u], qa, dk[cc + u][0]);
          dk[cc + u][1] = fmaf(dd[u], qb, dk[cc + u][1]);
          dv[cc + u][0] = fmaf(pp[u], oa, dv[cc + u][0]);
          dv[cc + u][1] = fmaf(pp[u], ob, dv[cc + u][1]);
        }
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int cc = 0; cc < RPT; ++cc) {
    const int j = j0 + c0 + cc;
    if (j >= g.m) continue;
    const size_t at = (((size_t)h * batch + bi) * g.m + j) * D;
    dk_part[at + lane] = dk[cc][0] * g.scale;
    dk_part[at + lane + 32] = dk[cc][1] * g.scale;
    dv_part[at + lane] = dv[cc][0];
    dv_part[at + lane + 32] = dv[cc][1];
  }
}

// dk, dv [b, m, D] = sum over heads of the partials, in the input type.
template <typename T>
__global__ void sum_heads_kernel(const float* __restrict__ dk_part,
                                 const float* __restrict__ dv_part, T* __restrict__ dk,
                                 T* __restrict__ dv, int heads, size_t count) {
  const size_t t = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= count) return;
  float a = 0.f, b = 0.f;
  for (int h = 0; h < heads; ++h) {
    a += dk_part[(size_t)h * count + t];
    b += dv_part[(size_t)h * count + t];
  }
  dk[t] = omt::from_f32<T>(a);
  dv[t] = omt::from_f32<T>(b);
}

// Kernel 6: dbias [h, n, m] = sum over the batch of ds, in the bias's type. One block per
// (key tile, query tile, head), looping over b; every element is written.
template <typename T, typename B>
__global__ void __launch_bounds__(THREADS) dbias_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const B* __restrict__ bias, const uint8_t* __restrict__ key_mask,
    const T* __restrict__ dout, const float* __restrict__ stats,
    const float* __restrict__ delta, B* __restrict__ dbias, int batch, Geometry g) {
  __shared__ Tiles s;
  const int j0 = blockIdx.x * TK, i0 = blockIdx.y * TQ, h = blockIdx.z;
  const int lane = threadIdx.x % 32, r0 = (threadIdx.x / 32) * RPT;
  float acc[RPT], ds_reg[RPT];
#pragma unroll
  for (int rr = 0; rr < RPT; ++rr) acc[rr] = 0.f;
  for (int bi = 0; bi < batch; ++bi) {
    load_stats(s, stats, delta, bi, h, i0, g);
    const bool dead = tile_has_dead_row(s);
    if (!tile_visible(g, i0, j0, dead)) continue;
    load_query_tile(s, q, dout, bi, h, i0, g);
    load_key_tile(s, k, v, bi, j0, g.m);
    __syncthreads();
    score_tile(s, bias, key_mask, bi, h, i0, j0, g, ds_reg);
#pragma unroll
    for (int rr = 0; rr < RPT; ++rr) acc[rr] += ds_reg[rr];
    __syncthreads();
  }
  const int j = j0 + lane;
  if (j >= g.m) return;
#pragma unroll
  for (int rr = 0; rr < RPT; ++rr) {
    const int i = i0 + r0 + rr;
    if (i < g.n) dbias[((size_t)h * g.n + i) * g.m + j] = omt::from_f32<B>(acc[rr]);
  }
}

template <typename T, typename B>
cudaError_t launch_bwd(const void* q, const void* k, const void* v, const void* bias,
                       const uint8_t* key_mask, const void* out, const float* stats,
                       const void* dout, float* delta, float* dk_part, float* dv_part, void* dq,
                       void* dk, void* dv, void* dbias, int b, const Geometry& g,
                       cudaStream_t st) {
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* dot = static_cast<const T*>(dout);
  const B* bt = static_cast<const B*>(bias);
  const int rows = b * g.n * g.heads;
  delta_kernel<T><<<(rows + 127) / 128, 128, 0, st>>>(static_cast<const T*>(out), dot, delta,
                                                       rows, g.heads, g.n);
  cudaError_t rc;
  if ((rc = cudaGetLastError()) != cudaSuccess) return rc;
  dq_kernel<T, B><<<dim3((g.n + TQ - 1) / TQ, g.heads, b), THREADS, 0, st>>>(
      qt, kt, vt, bt, key_mask, dot, stats, delta, static_cast<T*>(dq), g);
  if ((rc = cudaGetLastError()) != cudaSuccess) return rc;
  dkdv_kernel<T, B><<<dim3((g.m + TK - 1) / TK, g.heads, b), THREADS, 0, st>>>(
      qt, kt, vt, bt, key_mask, dot, stats, delta, dk_part, dv_part, b, g);
  if ((rc = cudaGetLastError()) != cudaSuccess) return rc;
  const size_t count = (size_t)b * g.m * D;
  sum_heads_kernel<T><<<(unsigned)((count + 255) / 256), 256, 0, st>>>(
      dk_part, dv_part, static_cast<T*>(dk), static_cast<T*>(dv), g.heads, count);
  if ((rc = cudaGetLastError()) != cudaSuccess || dbias == nullptr) return rc;
  dbias_kernel<T, B><<<dim3((g.m + TK - 1) / TK, (g.n + TQ - 1) / TQ, g.heads), THREADS, 0, st>>>(
      qt, kt, vt, bt, key_mask, dot, stats, delta, static_cast<B*>(dbias), b, g);
  return cudaGetLastError();
}

}  // namespace

// Kernels 5 and 6. dq [b, h, n, 64], dk, dv [b, m, 64] in the input type
// (dtype); dbias [h, n, m] in the bias's type (bias_dtype), or null to skip
// kernel 6. delta [b, h, n] and dk_part, dv_part [h, b, m, 64] are float32
// scratch from the caller.
extern "C" int omt_attention_bwd(const void* q, const void* k, const void* v, const void* bias,
                                 const void* key_mask, const void* out, const void* stats,
                                 const void* dout, void* delta, void* dk_part, void* dv_part,
                                 void* dq, void* dk, void* dv, void* dbias, int b, int heads,
                                 int n, int m, int causal, int ncp, float scale, int dtype,
                                 int bias_dtype, void* stream) {
  const Geometry g{heads, n, m, causal, ncp, scale};
  auto st = static_cast<cudaStream_t>(stream);
  auto run = [&](auto t_tag, auto b_tag) {
    using T = decltype(t_tag);
    using B = decltype(b_tag);
    return launch_bwd<T, B>(q, k, v, bias, static_cast<const uint8_t*>(key_mask), out,
                            static_cast<const float*>(stats), dout, static_cast<float*>(delta),
                            static_cast<float*>(dk_part), static_cast<float*>(dv_part), dq, dk,
                            dv, dbias, b, g, st);
  };
  auto with_bias = [&](auto t_tag) {
    return bias_dtype == 0 ? run(t_tag, float{}) : run(t_tag, __nv_bfloat16{});
  };
  const cudaError_t rc = dtype == 0 ? with_bias(float{}) : with_bias(__nv_bfloat16{});
  return static_cast<int>(rc);
}
