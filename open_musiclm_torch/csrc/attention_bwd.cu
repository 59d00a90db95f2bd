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
// The TPU recomputes the whole-row softmax from all m keys in VMEM; here
// kernel 1 writes each row's softmax statistics (max, denominator) in the
// training forward, so any tile of p is computed on its own: p = exp(s -
// max) / denominator, and rowsum(dp * p) = rowsum(dO * O) is one pass over
// the forward output (delta). Masking is exact: a masked score is -1e9, as in
// kernel 1 and the plain version. Key tiles that the causal mask hides from
// a query tile are skipped, unless a row of the query tile is masked
// entirely (row max -1e9): such a row spreads its weight over all m keys, as
// the plain version does. The TPU grid runs in order and carries dk/dv and
// dbias from step to step; blocks here run in parallel, so each output tile
// is owned by one block, and every cross-block sum is folded in a fixed
// order: the gradients are the same from run to run.
//
// One entry point, omt_attention_bwd: the delta pass, then kernel 5 (dq, dk,
// dv) and, when the caller asks for dbias, kernel 6.
//
// Delta pass (both types): a thread per (query, head) row with 16-byte
// loads, the float32 fmaf chain over the 64 dims in order (so kernel 6's
// inputs are bit-identical to the earlier one-thread-a-row pass), a block per
// (64-query tile, batch row); it also writes each row's 1 / denominator and
// flags each (batch, head, query tile) that holds a fully masked row, which
// kernel 5's bf16 blocks read.
//
// Kernel 5, bf16 (the training path): FlashAttention-2's backward on the
// tensor cores. What bounds it on the H100: FLOPs in principle (coarse b 2
// n 1116: ~5.4 GFLOP of causal, key-masked products against ~30 MB), in
// practice the latency of each block's chain of tiles, so the design cuts
// the longest chains. One launch holds two kinds of 128-thread blocks, dq
// blocks first (the longest first), then dk/dv blocks:
//  * dk/dv: a block owns a 64-key tile of a batch row, warp w keys
//    16 w..16 w + 15, and one split of the (head, query tile) pairs that see
//    the tile: split s of S takes the visible pairs of rank s, s + S, ...
//    (ops/attention.py:bwd_kv_splits chooses S for each key tile and passes
//    the running sums of S; a block takes at most 12 pairs). All heads
//    share K and V, so every pair reuses the one K/V tile;
//    Q, dO, the row statistics and the bias tile (4-byte words, rows off
//    alignment shifted by one element) arrive by cp.async one pair ahead.
//    S^T = K Q^T and dP^T = V dO^T (mma.sync m16n8k16 bf16, ldmatrix from
//    XOR-swizzled tiles, mma.cuh), P^T and dS^T in the C fragments, then
//    dV += P^T dO and dK += dS^T Q with those fragments as A operands (p and
//    ds rounded to bf16 only there), summed over the heads in registers.
//    With one split the block writes dk/dv; with more, each writes float32
//    partials [split, b, 64, 64] and the last block of the key tile (an
//    atomic ticket after __threadfence, reset by that block) sums them in
//    split order and writes them.
//  * dq: a block owns 64 (head, query) rows, 64 / h queries x h heads (as
//    kernel 1), and walks the key tiles its queries see (all of them when a
//    row is fully masked): S = Q K^T and dP = dO V^T, then dq += dS K; dq is
//    written once, no atomics. The key mask is held as bits in shared memory.
//
// Kernel 6, bf16 (the training path): the tensor cores, one block per
// (head, 64-query tile, 64-key tile) looping over the batch; see its section.
//
// Kernels 5 and 6, float32, stay on the CUDA cores in float32 (the training
// gradient gate holds float32 gradients to float64, which bf16 or TF32
// products would fail): 32-query x 32-key tile pairs in shared memory, 128
// threads; thread (warp w, lane l) scores key l against queries 8w..8w+7, and
// in the products owns dims l and l + 32 of 8 rows. float32 dk/dv are summed
// per head by one block per (batch, head, key tile) into float32 partials
// [h, b, m, 64], then a small pass sums the h partials; dbias is one block
// per (head, query tile, key tile) looping over b.
#include <algorithm>
#include <type_traits>

#include "mma.cuh"

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

// 16 bytes of a row as floats
__device__ __forceinline__ void unpack16(const int4& w, float (&x)[8]) {
  const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&w);
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    const float2 f = __bfloat1622float2(p[t]);
    x[2 * t] = f.x;
    x[2 * t + 1] = f.y;
  }
}
__device__ __forceinline__ void unpack16(const int4& w, float (&x)[4]) {
  x[0] = __int_as_float(w.x);
  x[1] = __int_as_float(w.y);
  x[2] = __int_as_float(w.z);
  x[3] = __int_as_float(w.w);
}

constexpr int QT = 64;  // queries a tile of the delta pass's dead-row flags (kernel 5 bf16's tile)
constexpr int MAX_HEADS = 64;  // heads divide a bf16 block's 64 rows

// delta[b, h, i] = dO[b, i, h, :] . O[b, i, h, :], inv_l[b, h, i] = 1 / the
// row's softmax denominator, and tile_dead[b, h, it] = 1 when a row of query
// tile it of head h has every key masked. One block per
// (query tile, batch row), a thread per (query, head) row.
template <typename T>
__global__ void __launch_bounds__(256) delta_kernel(
    const T* __restrict__ out, const T* __restrict__ dout, const float* __restrict__ stats,
    float* __restrict__ delta, float* __restrict__ inv_l, uint8_t* __restrict__ tile_dead,
    int heads, int n) {
  constexpr int PER = 16 / sizeof(T);
  __shared__ int dead[MAX_HEADS];
  const int it = blockIdx.x, bi = blockIdx.y, i0 = it * QT;
  if (threadIdx.x < heads) dead[threadIdx.x] = 0;
  __syncthreads();
  const int rows = min(QT, n - i0) * heads;
  for (int t = threadIdx.x; t < rows; t += blockDim.x) {
    const int i = i0 + t / heads, hh = t % heads;
    const size_t row = ((size_t)bi * n + i) * heads + hh;
    const int4* o = reinterpret_cast<const int4*>(out + row * D);
    const int4* d = reinterpret_cast<const int4*>(dout + row * D);
    float acc = 0.f;
#pragma unroll
    for (int u = 0; u < D / PER; ++u) {
      float a[PER], c[PER];
      unpack16(__ldg(o + u), a);
      unpack16(__ldg(d + u), c);
#pragma unroll
      for (int e = 0; e < PER; ++e) acc = fmaf(a[e], c[e], acc);
    }
    const size_t srow = ((size_t)bi * heads + hh) * n + i;
    delta[srow] = acc;
    inv_l[srow] = 1.f / fmaxf(stats[2 * srow + 1], 1e-30f);
    if (stats[2 * srow] < kDeadRow) atomicOr(&dead[hh], 1);
  }
  __syncthreads();
  if (threadIdx.x < heads)
    tile_dead[((size_t)bi * heads + threadIdx.x) * gridDim.x + it] = dead[threadIdx.x] != 0;
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

// Kernel 6, float32: dbias [h, n, m] = sum over the batch of ds, in the bias's type. One
// block per (key tile, query tile, head), looping over b; every element is written.
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

// ---- kernel 5, bf16: tensor cores ----
using bf16 = __nv_bfloat16;
constexpr int BT = 64;   // keys a dk/dv block and a key tile; queries a query tile; dq rows a block
constexpr int NT = 128;  // threads a block, 16 tile rows a warp
constexpr int TILE_BYTES = BT * D * 2;

struct Bf16Args {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  const void* bias;
  const uint8_t* key_mask;
  const bf16* dout;
  const float* stats;
  const float* delta;
  const float* inv_l;        // [b, h, n]: 1 / the softmax denominator
  const uint8_t* tile_dead;  // [b, h, query tiles]
  bf16* dq;
  bf16* dk;
  bf16* dv;
  float* dk_part;  // [sum of the key tiles' splits, b, BT, D]
  float* dv_part;
  int* tickets;    // [b, key tiles], 0 between launches
  const int* kv_split_prefix;  // [key tiles + 1]: tile jt's splits are prefix[jt] .. prefix[jt + 1] - 1
  int batch, dq_blocks, bias_paired;
};

// 64 rows of 64 bf16 into a swizzled tile; row r from src(r), zeros where src is null
template <typename Src>
__device__ __forceinline__ void stage_rows(unsigned char* tile, const Src& src) {
  for (int c = threadIdx.x; c < BT * 8; c += NT) {
    const int r = c / 8, u = c % 8;
    const bf16* row = src(r);
    omt::cp_async16(tile + omt::swz(r, u * 8), (row ? row : src(0)) + u * 8, row ? 16 : 0);
  }
}

// bias words of a 64-key row in shared memory: bf16 rows may start off a
// 4-byte boundary, so a row holds one element more, and the row's first
// element sits at its parity
template <typename B>
struct BiasRow {
  static constexpr int kWords = sizeof(B) == 4 ? BT : BT / 2 + 1;
};

// dk, dv of one key tile over split s of its visible (head, query tile) pairs.
template <typename B>
__device__ __forceinline__ void dkdv_block(const Bf16Args& a, const Geometry& g, int jt, int s,
                                           int splits, int part0, int bi, unsigned char* smem) {
  constexpr int BW = BiasRow<B>::kWords;
  unsigned char* ks = smem;
  unsigned char* vs = ks + TILE_BYTES;
  unsigned char* qs = vs + TILE_BYTES;            // [2] stages
  unsigned char* dos = qs + 2 * TILE_BYTES;       // [2]
  float* st = reinterpret_cast<float*>(dos + 2 * TILE_BYTES);  // [2][3][BT]: max, 1/denominator, delta
  unsigned* bs = reinterpret_cast<unsigned*>(st + 2 * 3 * BT);  // [2][BT][BW]: the bias tile
  uint8_t* dead_s = reinterpret_cast<uint8_t*>(bs + 2 * BT * BW);
  __shared__ int last;

  const int j0 = jt * BT, n_kt = (g.m + BT - 1) / BT, n_qt = (g.n + BT - 1) / BT;
  const int pairs = g.heads * n_qt, kn = min(BT, g.m - j0);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, gq = lane / 4, tq = lane % 4;
  const int off = g.m - g.n;
  const B* bias = static_cast<const B*>(a.bias);
  const size_t bias_total = (size_t)g.heads * g.n * g.m;

  const bf16* kb = a.k + (size_t)bi * g.m * D;
  const bf16* vb = a.v + (size_t)bi * g.m * D;
  stage_rows(ks, [&](int r) { return j0 + r < g.m ? kb + (size_t)(j0 + r) * D : nullptr; });
  stage_rows(vs, [&](int r) { return j0 + r < g.m ? vb + (size_t)(j0 + r) * D : nullptr; });
  omt::cp_async_commit();
  for (int t = tid; t < pairs; t += NT)
    dead_s[t] = a.tile_dead[(size_t)bi * pairs + t];

  // this thread's two keys (fragment rows gq, gq + 8 of warp's 16)
  int jr[2];
  bool kok[2];
#pragma unroll
  for (int x = 0; x < 2; ++x) {
    jr[x] = j0 + warp * 16 + gq + 8 * x;
    kok[x] = jr[x] < g.m && (a.key_mask == nullptr || a.key_mask[(size_t)bi * g.m + jr[x]] != 0);
  }
  __syncthreads();  // dead_s

  // pair p: head p / n_qt, query tile p % n_qt; visible when a query of the
  // tile sees a key of this tile or the tile holds a fully masked row. This
  // block takes the visible pairs whose rank among them is s mod splits.
  auto visible = [&](int p) {
    if (!g.causal) return true;
    const int i0 = (p % n_qt) * BT, i_last = min(i0 + BT, g.n) - 1;
    if (j0 <= i_last + off) return true;
    if (g.ncp > 0 && i0 < g.ncp && j0 < g.ncp + off) return true;
    return dead_s[p] != 0;
  };
  int rank = 0;
  auto next = [&](int p) {
    for (; p < pairs; ++p)
      if (visible(p) && rank++ % splits == s) return p;
    return pairs;
  };
  auto load_pair = [&](int p, int stage) {
    const int hh = p / n_qt, i0 = (p % n_qt) * BT;
    const bf16* qh = a.q + ((size_t)bi * g.heads + hh) * g.n * D;
    stage_rows(qs + stage * TILE_BYTES,
               [&](int r) { return i0 + r < g.n ? qh + (size_t)(i0 + r) * D : nullptr; });
    stage_rows(dos + stage * TILE_BYTES, [&](int r) {
      return i0 + r < g.n ? a.dout + (((size_t)bi * g.n + i0 + r) * g.heads + hh) * D : nullptr;
    });
    const size_t row0 = ((size_t)bi * g.heads + hh) * g.n;
    float* sm = st + stage * 3 * BT;
    for (int c = tid; c < BT; c += NT) {
      const size_t row = row0 + min(i0 + c, g.n - 1);
      omt::cp_async4(sm + c, a.stats + 2 * row);
      omt::cp_async4(sm + BT + c, a.inv_l + row);
      omt::cp_async4(sm + 2 * BT + c, a.delta + row);
    }
    if (bias != nullptr) {  // rows i0.. of bias[hh], keys j0..j0 + kn, by 4-byte words
      unsigned* bt = bs + stage * BT * BW;
      for (int c = tid; c < BT * BW; c += NT) {
        const int r = c / BW, w = c % BW, i = i0 + r;
        const size_t e = ((size_t)hh * g.n + i) * g.m + j0;  // the row's first element
        const size_t e_word = sizeof(B) == 4 ? e + w : (e & ~(size_t)1) + 2 * w;
        const int first = sizeof(B) == 4 ? w : 2 * w - (int)(e & 1);  // key of its first element
        if (i < g.n && first < kn)
          omt::cp_async4_n(bt + r * BW + w, bias + e_word,
                           (e_word + 4 / sizeof(B) <= bias_total ? 4 : 2));
      }
    }
    omt::cp_async_commit();
  };

  float dk[8][4], dv[8][4];
#pragma unroll
  for (int dn = 0; dn < 8; ++dn)
#pragma unroll
    for (int c = 0; c < 4; ++c) dk[dn][c] = dv[dn][c] = 0.f;

  int p = next(0), stage = 0;
  if (p < pairs) load_pair(p, 0);
  while (p < pairs) {
    const int pn = next(p + 1);
    omt::cp_async_wait<0>();
    __syncthreads();  // pair p staged; the other stage is free
    if (pn < pairs) load_pair(pn, stage ^ 1);
    const int hh = p / n_qt, i0 = (p % n_qt) * BT;
    const unsigned qt = omt::smem_addr(qs + stage * TILE_BYTES);
    const unsigned dt = omt::smem_addr(dos + stage * TILE_BYTES);
    const float* sm = st + stage * 3 * BT;
    const B* bt = reinterpret_cast<const B*>(bs + stage * BT * BW);
    // the parity of bias row i0's first element: row i0 + col starts at
    // parity ^ (col * m odd), and holds key j0 + jl at element parity + jl
    const int par = sizeof(B) == 4 ? 0 : (int)((((size_t)hh * g.n + i0) * g.m) & 1);
    constexpr int par_step = sizeof(B) == 4 ? 0 : 1;

    // S^T = K Q^T and dP^T = V dO^T: 16 keys x 64 queries a warp
    float s[8][4], dp[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[nt][c] = dp[nt][c] = 0.f;
    {
      unsigned fa[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) omt::load_a(omt::smem_addr(ks), warp, kk, fa[kk]);
      omt::mma_a_bt(s, fa, qt);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) omt::load_a(omt::smem_addr(vs), warp, kk, fa[kk]);
      omt::mma_a_bt(dp, fa, dt);
    }

    // P^T and dS^T in place: element (key jr[c >> 1], query 8 nt + 2 tq + (c & 1)).
    // On a tile inside the tensors that the causal mask leaves whole and
    // that holds no fully masked row, only the key mask and the bias remain.
    const bool whole = i0 + BT <= g.n && j0 + BT <= g.m && !dead_s[p] &&
                       (!g.causal || j0 + BT - 1 <= i0 + off);
    auto bias_at = [&](int col, int x) {
      return bias == nullptr ? 0.f
                             : omt::to_f32(bt[col * (BW * 4 / sizeof(B)) +
                                              (par ^ (col & g.m & par_step)) + jr[x] - j0]);
    };
    if (whole) {
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int col = nt * 8 + 2 * tq + (c & 1), x = c >> 1;
          const float pv = kok[x] ? __expf(s[nt][c] * g.scale + bias_at(col, x) - sm[col]) * sm[BT + col]
                                  : 0.f;
          s[nt][c] = pv;
          dp[nt][c] = pv * (dp[nt][c] - sm[2 * BT + col]);
        }
      }
    } else {
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int col = nt * 8 + 2 * tq + (c & 1), i = i0 + col, x = c >> 1;
          float pv = 0.f;
          if (i < g.n && jr[x] < g.m) {
            const bool allowed = kok[x] && omt::causal_ok(i, jr[x], off, g.causal, g.ncp);
            const float sv = allowed ? s[nt][c] * g.scale + bias_at(col, x) : omt::kNegInf;
            pv = __expf(sv - sm[col]) * sm[BT + col];
          }
          s[nt][c] = pv;
          dp[nt][c] = pv * (dp[nt][c] - sm[2 * BT + col]);
        }
      }
    }
    // dV += P^T dO, dK += dS^T Q
    omt::mma_c_b(dv, s, dt);
    omt::mma_c_b(dk, dp, qt);
    p = pn;
    stage ^= 1;
  }

  const int kd = 2 * tq;  // this thread's dims 8 dn + kd, + 1
  if (splits == 1) {
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      if (jr[x] >= g.m) continue;
      const size_t at = ((size_t)bi * g.m + jr[x]) * D + kd;
#pragma unroll
      for (int dn = 0; dn < 8; ++dn) {
        *reinterpret_cast<__nv_bfloat162*>(a.dk + at + dn * 8) =
            __floats2bfloat162_rn(dk[dn][2 * x] * g.scale, dk[dn][2 * x + 1] * g.scale);
        *reinterpret_cast<__nv_bfloat162*>(a.dv + at + dn * 8) =
            __floats2bfloat162_rn(dv[dn][2 * x], dv[dn][2 * x + 1]);
      }
    }
    return;
  }
  // partial [part0 + split][bi][key jl][D]
  auto part_at = [&](int ss, int jl) {
    return (((size_t)(part0 + ss) * a.batch + bi) * BT + jl) * D;
  };
#pragma unroll
  for (int x = 0; x < 2; ++x) {
    const size_t at = part_at(s, jr[x] - j0) + kd;
#pragma unroll
    for (int dn = 0; dn < 8; ++dn) {
      *reinterpret_cast<float2*>(a.dk_part + at + dn * 8) = make_float2(dk[dn][2 * x], dk[dn][2 * x + 1]);
      *reinterpret_cast<float2*>(a.dv_part + at + dn * 8) = make_float2(dv[dn][2 * x], dv[dn][2 * x + 1]);
    }
  }
  __threadfence();  // the partials are visible before the ticket is taken
  __syncthreads();
  int* ticket = a.tickets + (size_t)bi * n_kt + jt;
  if (tid == 0) last = atomicAdd(ticket, 1) == splits - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  // fold: the splits' partials in order 0, 1, ..., four dims a thread at a time
  for (int e = tid * 4; e < kn * D; e += NT * 4) {
    const int jl = e / D, d = e % D;
    float4 sk = make_float4(0.f, 0.f, 0.f, 0.f), sv = sk;
    for (int ss = 0; ss < splits; ++ss) {
      const float4 pk = __ldcg(reinterpret_cast<const float4*>(a.dk_part + part_at(ss, jl) + d));
      const float4 pv = __ldcg(reinterpret_cast<const float4*>(a.dv_part + part_at(ss, jl) + d));
      sk.x += pk.x; sk.y += pk.y; sk.z += pk.z; sk.w += pk.w;
      sv.x += pv.x; sv.y += pv.y; sv.z += pv.z; sv.w += pv.w;
    }
    const size_t at = ((size_t)bi * g.m + j0 + jl) * D + d;
    __nv_bfloat162* k2 = reinterpret_cast<__nv_bfloat162*>(a.dk + at);
    __nv_bfloat162* v2 = reinterpret_cast<__nv_bfloat162*>(a.dv + at);
    k2[0] = __floats2bfloat162_rn(sk.x * g.scale, sk.y * g.scale);
    k2[1] = __floats2bfloat162_rn(sk.z * g.scale, sk.w * g.scale);
    v2[0] = __floats2bfloat162_rn(sv.x, sv.y);
    v2[1] = __floats2bfloat162_rn(sv.z, sv.w);
  }
  if (tid == 0) *ticket = 0;  // ready for the next launch
}

// dq of 64 (head, query) rows: 64 / h queries x h heads.
template <typename B>
__device__ __forceinline__ void dq_block(const Bf16Args& a, const Geometry& g, int blk,
                                         int n_blocks, unsigned char* smem) {
  using BP = omt::BiasPair<B>;
  unsigned char* qs = smem;
  unsigned char* dos = qs + TILE_BYTES;
  unsigned char* ks = dos + TILE_BYTES;  // [2] stages
  unsigned char* vs = ks + 2 * TILE_BYTES;
  unsigned* kbits = reinterpret_cast<unsigned*>(vs + 2 * TILE_BYTES);  // the key mask, a bit a key
  const int qb = BT / g.heads;
  const int bi = blk % a.batch;
  const int i0 = (n_blocks / a.batch - 1 - blk / a.batch) * qb;  // the last queries first
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, gq = lane / 4, tq = lane % 4;
  const int off = g.m - g.n;

  auto row_of = [&](int r) { return i0 + r % qb; };
  stage_rows(qs, [&](int r) {
    const int i = row_of(r);
    return i < g.n ? a.q + (((size_t)bi * g.heads + r / qb) * g.n + i) * D : nullptr;
  });
  stage_rows(dos, [&](int r) {
    const int i = row_of(r);
    return i < g.n ? a.dout + (((size_t)bi * g.n + i) * g.heads + r / qb) * D : nullptr;
  });
  const bf16* kb = a.k + (size_t)bi * g.m * D;
  const bf16* vb = a.v + (size_t)bi * g.m * D;
  auto load_kv = [&](int t, int stage) {
    const int j0 = t * BT;
    stage_rows(ks + stage * TILE_BYTES,
               [&](int r) { return j0 + r < g.m ? kb + (size_t)(j0 + r) * D : nullptr; });
    stage_rows(vs + stage * TILE_BYTES,
               [&](int r) { return j0 + r < g.m ? vb + (size_t)(j0 + r) * D : nullptr; });
    omt::cp_async_commit();
  };

  // this thread's two rows: A = 16 warp + gq, B = A + 8
  int ri[2], rh[2];
  bool rv[2], dead = false;
  float mx[2], inv[2], dl[2];
#pragma unroll
  for (int x = 0; x < 2; ++x) {
    const int r = warp * 16 + gq + 8 * x;
    rh[x] = r / qb;
    ri[x] = row_of(r);
    rv[x] = ri[x] < g.n;
    mx[x] = inv[x] = dl[x] = 0.f;
    if (rv[x]) {
      const size_t row = ((size_t)bi * g.heads + rh[x]) * g.n + ri[x];
      mx[x] = a.stats[2 * row];
      inv[x] = a.inv_l[row];
      dl[x] = a.delta[row];
      dead = dead || mx[x] < kDeadRow;
    }
  }
  // a fully masked row spreads its weight over every key: walk them all
  dead = __syncthreads_or(dead);
  const bool whole_rows = !dead && i0 + qb <= g.n;
  const int kv_end = dead ? g.m : omt::visible_end(i0, i0 + qb, g.n, g.m, g.causal, g.ncp);
  const int n_tiles = (kv_end + BT - 1) / BT;
  load_kv(0, 0);  // one group with Q and dO

  const B* bias = static_cast<const B*>(a.bias);
  const B* brow[2];
#pragma unroll
  for (int x = 0; x < 2; ++x)
    brow[x] = bias && rv[x] ? bias + ((size_t)rh[x] * g.n + ri[x]) * g.m : nullptr;
  if (a.key_mask != nullptr) {  // keys [0, kv_end) as bits, a word of 32 per warp at a time
    const uint8_t* km = a.key_mask + (size_t)bi * g.m;
#pragma unroll 4
    for (int w0 = warp * 32; w0 < kv_end; w0 += NT) {
      const int j = w0 + lane;
      const unsigned word = __ballot_sync(0xffffffffu, j < kv_end && __ldg(km + j) != 0);
      if (lane == 0) kbits[w0 / 32] = word;
    }
  }
  typename BP::T bfr[8][2];
  omt::load_bias_frag<B>(bfr, brow, 0, g.m, a.bias_paired);

  float acc[8][4];
#pragma unroll
  for (int dn = 0; dn < 8; ++dn)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[dn][c] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    const int stage = t & 1;
    omt::cp_async_wait<0>();
    __syncthreads();  // tile t (and Q, dO) staged; the other stage is free
    if (t + 1 < n_tiles) load_kv(t + 1, stage ^ 1);
    const unsigned kt = omt::smem_addr(ks + stage * TILE_BYTES);

    // S = Q K^T and dP = dO V^T: 16 rows x 64 keys a warp
    float s[8][4], dp[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[nt][c] = dp[nt][c] = 0.f;
    {
      unsigned fa[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) omt::load_a(omt::smem_addr(qs), warp, kk, fa[kk]);
      omt::mma_a_bt(s, fa, kt);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) omt::load_a(omt::smem_addr(dos), warp, kk, fa[kk]);
      omt::mma_a_bt(dp, fa, omt::smem_addr(vs + stage * TILE_BYTES));
    }

    // dS in place of S. On a tile inside the tensors that the causal mask
    // leaves whole, of a block with no fully masked row, only the key mask
    // and the bias remain.
    const bool whole = whole_rows && (t + 1) * BT <= g.m &&
                       (!g.causal || (t + 1) * BT - 1 <= i0 + off);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const unsigned kw = a.key_mask != nullptr ? kbits[(t * BT + nt * 8) >> 5] : ~0u;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int x = c >> 1, j = t * BT + nt * 8 + 2 * tq + (c & 1);
        const float2 bv = BP::f32(bfr[nt][x]);
        const float sb = s[nt][c] * g.scale + ((c & 1) ? bv.y : bv.x);
        float pv = 0.f;
        if (whole) {
          pv = (kw >> (j & 31)) & 1u ? __expf(sb - mx[x]) * inv[x] : 0.f;
        } else if (rv[x] && j < g.m) {
          const bool allowed = ((kw >> (j & 31)) & 1u) && omt::causal_ok(ri[x], j, off, g.causal, g.ncp);
          pv = __expf((allowed ? sb : omt::kNegInf) - mx[x]) * inv[x];
        }
        s[nt][c] = pv * (dp[nt][c] - dl[x]);
      }
    }
    if (t + 1 < n_tiles) omt::load_bias_frag<B>(bfr, brow, (t + 1) * BT, g.m, a.bias_paired);
    omt::mma_c_b(acc, s, kt);  // dQ += dS K
  }

#pragma unroll
  for (int x = 0; x < 2; ++x) {
    if (!rv[x]) continue;
    bf16* row = a.dq + (((size_t)bi * g.heads + rh[x]) * g.n + ri[x]) * D + 2 * tq;
#pragma unroll
    for (int dn = 0; dn < 8; ++dn)
      *reinterpret_cast<__nv_bfloat162*>(row + dn * 8) =
          __floats2bfloat162_rn(acc[dn][2 * x] * g.scale, acc[dn][2 * x + 1] * g.scale);
  }
}

// Kernel 5, bf16: blocks [0, dq_blocks) are dq blocks (the longest, the last
// queries', first), the rest dk/dv blocks, key tile 0 (the longest) first,
// each key tile's splits over the batch rows.
// Three blocks an SM (at most 168 registers a thread): the blocks' chains of
// tiles are latency-bound, and the third block hides more of it than the
// registers it costs (a few bytes of spills) lose.
template <typename B>
__global__ void __launch_bounds__(NT, 3) bwd_bf16_kernel(Bf16Args a, Geometry g) {
  extern __shared__ __align__(128) unsigned char smem[];
  int blk = blockIdx.x;
  if (blk < a.dq_blocks) {
    dq_block<B>(a, g, blk, a.dq_blocks, smem);
    return;
  }
  blk -= a.dq_blocks;
  int jt = 0;  // the key tile whose blocks [prefix[jt] b, prefix[jt + 1] b) hold blk
  while (blk >= a.kv_split_prefix[jt + 1] * a.batch) ++jt;
  const int part0 = a.kv_split_prefix[jt], splits = a.kv_split_prefix[jt + 1] - part0;
  blk -= part0 * a.batch;
  dkdv_block<B>(a, g, jt, blk / a.batch, splits, part0, blk % a.batch, smem);
}

// ---- kernel 6, bf16: tensor cores ----
//
// Replaces _fused_bwd -> _dbias_kernel (open_musiclm_tpu/ops/
// pallas_attention.py:258-312, pallas_call :475), whose grid walks the
// batch innermost and carries dbias in VMEM from step to step. What bounds
// it on the H100: bytes in principle (coarse b 2 n 1116: the bias read and
// dbias written once, ~40 MB in bf16, against ~2 GFLOP of score products on
// the tensor cores), in practice each block's chain of staging rounds. A
// block owns one (key tile, query tile, head) of 64 x 64 and loops over the
// batch inside, the TPU grid's b turned into a loop: the bias tile is read
// once, into registers in the score fragment's layout (rows off a pair
// boundary load element by element), and dbias is summed over b in float32
// registers and written once, with no atomics, so the result is the same
// bits every run. The next batch row's Q, dO, K and V tiles arrive by
// cp.async (XOR-swizzled, as kernel 5's) while the current row computes, and
// its row statistics and key mask bits by plain loads. S = Q K^T and
// dP = dO V^T are mma.sync m16n8k16 (16 queries x 64 keys a warp); P and dS
// stay in the C fragments. A tile that the causal mask hides from every
// query of every batch row (and that holds no fully masked row) writes its
// zeros with 16-byte stores and exits without reading Q, K or V; a batch row
// whose query tile holds a fully masked row (the delta pass's tile_dead) is
// visited wherever its tile lies, since such a row spreads its weight over
// all m keys.
struct DbiasArgs {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  const void* bias;
  const uint8_t* key_mask;
  const bf16* dout;
  const float* stats;
  const float* delta;
  const float* inv_l;
  const uint8_t* tile_dead;  // [b, h, query tiles]
  void* dbias;
  int batch, bias_paired, dbias_paired;  // bias / dbias rows load / store pairs as one
};

// dbias elements j, j + 1 of a row (j + 1 only when second), as one store when paired
__device__ __forceinline__ void store_pair(float* p, float a, float b, bool paired, bool second) {
  if (paired) {
    *reinterpret_cast<float2*>(p) = make_float2(a, b);
    return;
  }
  p[0] = a;
  if (second) p[1] = b;
}
__device__ __forceinline__ void store_pair(bf16* p, float a, float b, bool paired, bool second) {
  if (paired) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
    return;
  }
  p[0] = __float2bfloat16(a);
  if (second) p[1] = __float2bfloat16(b);
}

// zeros over rows [i0, i0 + rows) x keys [j0, j0 + kn) of dbias [h]: a warp a
// row, 16-byte stores between the row's unaligned ends
template <typename B>
__device__ __forceinline__ void zero_tile(B* db, const Geometry& g, int h, int i0, int j0) {
  constexpr int PER = 16 / sizeof(B);
  const int kn = min(BT, g.m - j0), rows = min(BT, g.n - i0);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const B zero = omt::from_f32<B>(0.f);
  for (int r = warp; r < rows; r += NT / 32) {
    B* row = db + ((size_t)h * g.n + i0 + r) * g.m + j0;
    const int head = min(kn, (int)(((16 - (reinterpret_cast<uintptr_t>(row) & 15)) & 15) / sizeof(B)));
    const int body = (kn - head) / PER;
    for (int e = lane; e < head; e += 32) row[e] = zero;
    for (int u = lane; u < body; u += 32) reinterpret_cast<uint4*>(row + head)[u] = make_uint4(0, 0, 0, 0);
    for (int e = head + body * PER + lane; e < kn; e += 32) row[e] = zero;
  }
}

// Kernel 6, bf16: block (key tile x, query tile y, head z), 4 warps of 16
// queries each; dynamic shared memory: two stages of the Q, dO, K and V tiles.
// Two blocks an SM: the registers hold S, dP, dbias and the bias fragments
// without spilling (with three blocks and 168 registers it spilled and ran
// slower on the H100).
template <typename B>
__global__ void __launch_bounds__(NT, 2) dbias_bf16_kernel(DbiasArgs a, Geometry g) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ unsigned kbits[2][BT / 32];  // a stage's key mask over the tile's keys, a bit a key
  using BP = omt::BiasPair<B>;
  const int j0 = blockIdx.x * BT, it = blockIdx.y, i0 = it * BT, h = blockIdx.z;
  const int n_qt = gridDim.y;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, gq = lane / 4, tq = lane % 4;
  const int off = g.m - g.n;
  B* db = static_cast<B*>(a.dbias);

  // batch row bi sees a score of the tile when the causal mask leaves one to
  // the tile's queries, or when its query tile holds a fully masked row
  const int i_last = min(i0 + BT, g.n) - 1;
  const bool seen = !g.causal || j0 <= i_last + off || (g.ncp > 0 && i0 < g.ncp && j0 < g.ncp + off);
  auto dead = [&](int bi) { return a.tile_dead[((size_t)bi * g.heads + h) * n_qt + it] != 0; };
  auto next = [&](int bi) {
    for (; bi < a.batch; ++bi)
      if (seen || dead(bi)) return bi;
    return a.batch;
  };
  if (!seen) {  // every batch row's flag at once; zeros unless one holds a dead row
    bool any = false;
    for (int b0 = 0; b0 < a.batch; b0 += NT) any |= b0 + tid < a.batch && dead(b0 + tid);
    if (!__syncthreads_or(any)) {
      zero_tile<B>(db, g, h, i0, j0);
      return;
    }
  }
  int bi = next(0);

  auto stage = [&](int b, int st) {
    unsigned char* base = smem + st * 4 * TILE_BYTES;
    const bf16* qh = a.q + ((size_t)b * g.heads + h) * g.n * D;
    const bf16* kb = a.k + (size_t)b * g.m * D;
    const bf16* vb = a.v + (size_t)b * g.m * D;
    stage_rows(base, [&](int r) { return i0 + r < g.n ? qh + (size_t)(i0 + r) * D : nullptr; });
    stage_rows(base + TILE_BYTES, [&](int r) {
      return i0 + r < g.n ? a.dout + (((size_t)b * g.n + i0 + r) * g.heads + h) * D : nullptr;
    });
    stage_rows(base + 2 * TILE_BYTES,
               [&](int r) { return j0 + r < g.m ? kb + (size_t)(j0 + r) * D : nullptr; });
    stage_rows(base + 3 * TILE_BYTES,
               [&](int r) { return j0 + r < g.m ? vb + (size_t)(j0 + r) * D : nullptr; });
    omt::cp_async_commit();
  };
  stage(bi, 0);

  // this thread's two queries (fragment rows gq, gq + 8 of the warp's 16)
  int ri[2];
  bool rv[2];
  const B* bias = static_cast<const B*>(a.bias);
  const B* brow[2];
#pragma unroll
  for (int x = 0; x < 2; ++x) {
    ri[x] = i0 + warp * 16 + gq + 8 * x;
    rv[x] = ri[x] < g.n;
    brow[x] = rv[x] ? bias + ((size_t)h * g.n + ri[x]) * g.m : nullptr;
  }
  // row statistics, the dead flag and (threads < 64) the key mask byte of batch row b
  float mx[2], inv[2], dl[2];
  bool dead_b = false;
  uint8_t key = 1;
  auto fetch = [&](int b) {
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      const size_t row = ((size_t)b * g.heads + h) * g.n + (rv[x] ? ri[x] : 0);
      mx[x] = a.stats[2 * row];
      inv[x] = a.inv_l[row];
      dl[x] = a.delta[row];
    }
    dead_b = dead(b);
    if (a.key_mask != nullptr && tid < BT)
      key = j0 + tid < g.m ? a.key_mask[(size_t)b * g.m + j0 + tid] : 0;
  };
  auto mask_bits = [&](int st) {  // warps 0 and 1: the fetched key mask bytes as bits
    if (a.key_mask != nullptr && tid < BT) {
      const unsigned word = __ballot_sync(0xffffffffu, key != 0);
      if (lane == 0) kbits[st][warp] = word;
    }
  };
  fetch(bi);
  mask_bits(0);
  typename BP::T bfr[8][2];
  omt::load_bias_frag<B>(bfr, brow, j0, g.m, a.bias_paired);
  // a tile inside the tensors that the causal mask leaves whole: only the
  // key mask and the bias remain, unless the batch row's tile holds a dead row
  const bool whole_tile = i0 + BT <= g.n && j0 + BT <= g.m && (!g.causal || j0 + BT - 1 <= i0 + off);

  float acc[8][4];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[nt][c] = 0.f;

  for (int st = 0; bi < a.batch; st ^= 1) {
    const int bn = next(bi + 1);
    omt::cp_async_wait<0>();
    __syncthreads();  // row bi staged, its key bits written; the other stage is free
    if (bn < a.batch) stage(bn, st ^ 1);
    const float cmx[2] = {mx[0], mx[1]}, cinv[2] = {inv[0], inv[1]}, cdl[2] = {dl[0], dl[1]};
    const bool whole = whole_tile && !dead_b;
    if (bn < a.batch) fetch(bn);  // in flight while row bi computes
    unsigned char* base = smem + st * 4 * TILE_BYTES;

    // S = Q K^T and dP = dO V^T: 16 queries x 64 keys a warp
    float s[8][4], dp[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[nt][c] = dp[nt][c] = 0.f;
    {
      unsigned fa[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) omt::load_a(omt::smem_addr(base), warp, kk, fa[kk]);
      omt::mma_a_bt(s, fa, omt::smem_addr(base + 2 * TILE_BYTES));
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) omt::load_a(omt::smem_addr(base + TILE_BYTES), warp, kk, fa[kk]);
      omt::mma_a_bt(dp, fa, omt::smem_addr(base + 3 * TILE_BYTES));
    }

    // dS = P (dP - delta), summed over the batch rows in acc
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const unsigned kw = a.key_mask != nullptr ? kbits[st][nt >> 2] : ~0u;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int x = c >> 1, jl = nt * 8 + 2 * tq + (c & 1), j = j0 + jl;
        const float2 bv = BP::f32(bfr[nt][x]);
        const float sb = s[nt][c] * g.scale + ((c & 1) ? bv.y : bv.x);
        const bool kok = (kw >> (jl & 31)) & 1u;
        float pv = 0.f;
        if (whole) {
          pv = kok ? __expf(sb - cmx[x]) * cinv[x] : 0.f;
        } else if (rv[x] && j < g.m) {
          const bool allowed = kok && omt::causal_ok(ri[x], j, off, g.causal, g.ncp);
          pv = __expf((allowed ? sb : omt::kNegInf) - cmx[x]) * cinv[x];
        }
        acc[nt][c] += pv * (dp[nt][c] - cdl[x]);
      }
    }
    if (bn < a.batch) mask_bits(st ^ 1);  // read after the next barrier
    bi = bn;
  }

  // dbias rows ri, keys j0 + 8 nt + 2 tq, + 1, written once
#pragma unroll
  for (int x = 0; x < 2; ++x) {
    if (!rv[x]) continue;
    B* row = db + ((size_t)h * g.n + ri[x]) * g.m;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const int j = j0 + nt * 8 + 2 * tq;
      if (j < g.m) store_pair(row + j, acc[nt][2 * x], acc[nt][2 * x + 1], a.dbias_paired != 0, j + 1 < g.m);
    }
  }
}

struct Ptrs {
  const void *q, *k, *v, *bias;
  const uint8_t* key_mask;
  const void *out, *dout;
  const float* stats;
  float* delta;
  float* inv_l;
  uint8_t* tile_dead;
  float *dk_part, *dv_part;
  int* tickets;
  const int* kv_split_prefix;
  int kv_splits;  // prefix[key tiles]: dk/dv blocks a batch row
  void *dq, *dk, *dv, *dbias;
};

// whether pairs of elements j, j + 1 (j even) of every [.., m] row of B at ptr load as one
template <typename B>
int pairs_aligned(const void* ptr, int m) {
  return m % 2 == 0 && reinterpret_cast<uintptr_t>(ptr) % (2 * sizeof(B)) == 0;
}

template <typename B>
cudaError_t launch_dbias_bf16(const Ptrs& p, int b, const Geometry& g, cudaStream_t st) {
  const DbiasArgs a{static_cast<const bf16*>(p.q), static_cast<const bf16*>(p.k),
                    static_cast<const bf16*>(p.v), p.bias, p.key_mask,
                    static_cast<const bf16*>(p.dout), p.stats, p.delta, p.inv_l, p.tile_dead,
                    p.dbias, b, pairs_aligned<B>(p.bias, g.m), pairs_aligned<B>(p.dbias, g.m)};
  const int smem = 8 * TILE_BYTES;
  auto kernel = dbias_bf16_kernel<B>;
  static bool configured = false;
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  const dim3 grid((g.m + BT - 1) / BT, (g.n + BT - 1) / BT, g.heads);
  kernel<<<grid, NT, smem, st>>>(a, g);
  return cudaGetLastError();
}

template <typename B>
cudaError_t launch_bf16(const Ptrs& p, int b, const Geometry& g, cudaStream_t st) {
  Bf16Args a{static_cast<const bf16*>(p.q), static_cast<const bf16*>(p.k),
             static_cast<const bf16*>(p.v), p.bias, p.key_mask, static_cast<const bf16*>(p.dout),
             p.stats, p.delta, p.inv_l, p.tile_dead, static_cast<bf16*>(p.dq),
             static_cast<bf16*>(p.dk), static_cast<bf16*>(p.dv), p.dk_part, p.dv_part, p.tickets,
             p.kv_split_prefix};
  const int n_kt = (g.m + BT - 1) / BT, n_qt = (g.n + BT - 1) / BT, qb = BT / g.heads;
  a.batch = b;
  a.dq_blocks = (g.n + qb - 1) / qb * b;
  // pairs of bias elements load as one when every row starts aligned for it
  a.bias_paired = pairs_aligned<B>(p.bias, g.m);
  const int kv_blocks = p.kv_splits * b;
  const int smem_kv = 6 * TILE_BYTES + 2 * 3 * BT * 4 + 2 * BT * BiasRow<B>::kWords * 4 +
                      (g.heads * n_qt + 15) / 16 * 16;
  const int smem_q = 6 * TILE_BYTES + (p.key_mask ? n_kt * 2 * 4 : 0);  // a mask word per 32 keys
  const int smem = std::max(smem_kv, smem_q);
  auto kernel = bwd_bf16_kernel<B>;
  static int configured = 0;  // the largest dynamic shared memory this kernel was allowed
  if (smem > configured) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    configured = smem;
  }
  kernel<<<a.dq_blocks + kv_blocks, NT, smem, st>>>(a, g);
  return cudaGetLastError();
}

template <typename T, typename B>
cudaError_t launch_bwd(const Ptrs& p, int b, const Geometry& g, cudaStream_t st) {
  const T* qt = static_cast<const T*>(p.q);
  const T* kt = static_cast<const T*>(p.k);
  const T* vt = static_cast<const T*>(p.v);
  const T* dot = static_cast<const T*>(p.dout);
  const B* bt = static_cast<const B*>(p.bias);
  delta_kernel<T><<<dim3((g.n + QT - 1) / QT, b), 256, 0, st>>>(
      static_cast<const T*>(p.out), dot, p.stats, p.delta, p.inv_l, p.tile_dead, g.heads, g.n);
  cudaError_t rc;
  if ((rc = cudaGetLastError()) != cudaSuccess) return rc;
  if constexpr (std::is_same<T, bf16>::value) {
    if ((rc = launch_bf16<B>(p, b, g, st)) != cudaSuccess) return rc;
  } else {
    dq_kernel<T, B><<<dim3((g.n + TQ - 1) / TQ, g.heads, b), THREADS, 0, st>>>(
        qt, kt, vt, bt, p.key_mask, dot, p.stats, p.delta, static_cast<T*>(p.dq), g);
    if ((rc = cudaGetLastError()) != cudaSuccess) return rc;
    dkdv_kernel<T, B><<<dim3((g.m + TK - 1) / TK, g.heads, b), THREADS, 0, st>>>(
        qt, kt, vt, bt, p.key_mask, dot, p.stats, p.delta, p.dk_part, p.dv_part, b, g);
    if ((rc = cudaGetLastError()) != cudaSuccess) return rc;
    const size_t count = (size_t)b * g.m * D;
    sum_heads_kernel<T><<<(unsigned)((count + 255) / 256), 256, 0, st>>>(
        p.dk_part, p.dv_part, static_cast<T*>(p.dk), static_cast<T*>(p.dv), g.heads, count);
    if ((rc = cudaGetLastError()) != cudaSuccess) return rc;
  }
  if (p.dbias == nullptr) return cudaSuccess;
  if constexpr (std::is_same<T, bf16>::value) {
    return launch_dbias_bf16<B>(p, b, g, st);
  } else {
    dbias_kernel<T, B><<<dim3((g.m + TK - 1) / TK, (g.n + TQ - 1) / TQ, g.heads), THREADS, 0, st>>>(
        qt, kt, vt, bt, p.key_mask, dot, p.stats, p.delta, static_cast<B*>(p.dbias), b, g);
    return cudaGetLastError();
  }
}

}  // namespace

// Kernels 5 and 6. dq [b, h, n, 64], dk, dv [b, m, 64] in the input type
// (dtype); dbias [h, n, m] in the bias's type (bias_dtype), or null to skip
// kernel 6. Scratch from the caller: delta and inv_l [b, h, n] float32 and
// tile_dead [b, h, ceil(n / 64)] bytes, written anew each call; in float32,
// dk_part and dv_part [h, b, m, 64]; in bf16, where a key tile has more than
// one dk/dv block, dk_part and dv_part [sum of the key tiles' splits, b, 64,
// 64] float32 and tickets [b, ceil(m / 64)] int32, 0 between launches (the
// launch leaves them 0). In bf16, kv_split_prefix [ceil(m / 64) + 1] int32 on
// the device: the running sums of each key tile's dk/dv splits
// (ops/attention.py:bwd_kv_splits), kv_splits its last entry.
extern "C" int omt_attention_bwd(const void* q, const void* k, const void* v, const void* bias,
                                 const void* key_mask, const void* out, const void* stats,
                                 const void* dout, void* delta, void* inv_l, void* tile_dead,
                                 void* dk_part, void* dv_part, void* tickets,
                                 const void* kv_split_prefix, void* dq, void* dk, void* dv,
                                 void* dbias, int b, int heads, int n, int m, int causal, int ncp,
                                 float scale, int dtype, int bias_dtype, int kv_splits,
                                 void* stream) {
  const Geometry g{heads, n, m, causal, ncp, scale};
  const Ptrs p{q, k, v, bias, static_cast<const uint8_t*>(key_mask), out, dout,
               static_cast<const float*>(stats), static_cast<float*>(delta),
               static_cast<float*>(inv_l), static_cast<uint8_t*>(tile_dead),
               static_cast<float*>(dk_part), static_cast<float*>(dv_part),
               static_cast<int*>(tickets), static_cast<const int*>(kv_split_prefix), kv_splits,
               dq, dk, dv, dbias};
  auto st = static_cast<cudaStream_t>(stream);
  auto run = [&](auto t_tag, auto b_tag) {
    using T = decltype(t_tag);
    using B = decltype(b_tag);
    return launch_bwd<T, B>(p, b, g, st);
  };
  auto with_bias = [&](auto t_tag) {
    return bias_dtype == 0 ? run(t_tag, float{}) : run(t_tag, __nv_bfloat16{});
  };
  const cudaError_t rc = dtype == 0 ? with_bias(float{}) : with_bias(__nv_bfloat16{});
  return static_cast<int>(rc);
}
