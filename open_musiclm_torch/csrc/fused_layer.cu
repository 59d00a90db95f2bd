// Kernel 7: one whole decode layer for one token, in one launch.
//
// Replaces the Pallas kernel open_musiclm_tpu/ops/fused_layer.py:
// fused_layer_decode_step (pallas_call at ops/fused_layer.py:348, body
// _kernel :107-291). For x [b, dim] and one layer, all weights int8 with
// per-output-column float32 scales:
//   1. q = (LN(x) @ Wq) * sq, k|v = (x @ Wkv) * skv (K/V from the UN-normed x)
//   2. q = l2norm(q) * q_scale per head, k = l2norm(k) * k_scale
//   3. attention over the cached int8 rows j < pos (K scale after the dot,
//      V scale folded into p, rel-pos bias row, additive key mask) plus the
//      fresh unquantized row with the bias at distance 0
//   4. x2 = x + (attn @ Wo) * so                  (rounded to x's dtype)
//   5. the conv-FF block of kernel 3 on x2: LN -> Wv/Wg -> 3-tap conv ->
//      GEGLU (exact erf) -> mid-LN (E[g^2] - mu^2 over the true inner) ->
//      Wout, y = x2 + that
// and, beyond the TPU kernel, it writes the fresh K/V row quantized as
// quantize_kv_row does (absmax / 127 clamped at 1e-12, round half to even)
// into the cache at `pos`, and the new conv state in place (each (row,
// column) of the state is read and written by one thread only).
//
// What bounds it on the H100: bytes. A musiclm_small layer holds 9.6 MB of
// int8 weights, read once per token; at b 8 the cache rows add 1.3 MB at
// pos 1279, against ~0.17 GFLOP. The TPU kernel's point is one launch per
// layer, with the weights resident in VMEM across its batch grid. An H100
// block cannot hold them (227 KB of shared memory), and its blocks cannot
// wait for each other inside an ordinary launch. So this is a cooperative,
// persistent launch (as many blocks as fit on the SMs at once) whose five
// phases are separated by grid-wide barriers (cooperative_groups grid.sync):
//   B  q and k|v projections     C  attention partials per 64-row cache chunk
//   D  combine chunks + fresh row, quantized row write
//   E  out-projection + residual G  FF in-projections, conv, GEGLU
//   I  FF out-projection + residual
// In every product phase a warp owns output columns and loops over the
// batch in 8-row tiles, so each weight byte leaves device memory once per
// tile of rows (once for b <= 8), read as 16-byte runs from output-major
// [out, in] weights. The 8 rows' activations (normalised while they are
// staged: each warp stages one row and computes its LayerNorm statistics)
// sit in shared memory in a lane-interleaved order, so that a warp's float4
// reads hit 32 different banks. Intermediates (q, k|v, chunk partials, the
// attention output, x2, g) go to small float32 scratch tensors the wrapper
// allocates. Float32 CUDA-core FMAs throughout; no tensor cores or TMA yet.
#include "common.cuh"

#include <cooperative_groups.h>

namespace cg = cooperative_groups;

namespace {

constexpr int D = 64;         // dim_head
constexpr int NT = 256;       // threads a block
constexpr int NW = NT / 32;   // warps a block
constexpr int RT = NW;        // activation rows staged per pass, one warp each
constexpr int CH = 64;        // cache rows per attention work item
constexpr int PW = D + 2;     // partial record: max, denominator, 64 sums
constexpr int MAXH = 16;      // heads the attention phases take
constexpr int NC = 2;         // output columns a warp computes together
// shared floats of the attention phase: K and V tiles, their scales, q, p
constexpr int ATTN_SMEM = 2 * CH * (D + 1) + 2 * CH + MAXH * D + NW * CH;

template <typename T>
struct Params {
  const T* x;
  const float *gamma, *sq, *skv, *q_scale, *k_scale, *so;
  const int8_t *wqT, *wkvT, *woT;
  int8_t* kv;
  float* kv_scale;
  const float *bias_row, *add_mask;
  const float *gin, *sv, *sg, *conv_v, *conv_g, *gmid, *ff_so;
  const int8_t *wvT, *wgT, *ff_woT;
  T* state;
  T* y;
  float *krow, *q_raw, *kv_raw, *part, *attn, *x2, *g;
  int b, heads, dim, inner, inner_p, N, pos, n_chunks;
  float scale;
};

// Position of element k of a staged row of width K (a multiple of 16): in
// each 512-wide block, k = 16 L + 4 j + e goes to j * W + 4 L + e, W being
// a quarter of the block's width, so lane L's j-th float4 is contiguous
// with lane L + 1's.
__device__ __forceinline__ int perm(int k, int K) {
  const int blk = k & ~511;
  const int w = min(128, (K - blk) >> 2);
  const int r = k - blk;
  return blk + ((r & 15) >> 2) * w + ((r >> 4) << 2) + (r & 3);
}

enum Norm { kRaw, kLayerNorm, kMidNorm };

// One warp stages one row src[0 .. K) into As[0 .. KP), zero beyond K (and
// the whole row when !valid), reading src once, then normalises it in place
// from the staged values. kLayerNorm: (v - mu) / sqrt(E[(v - mu)^2] + eps) *
// gamma; kMidNorm: the same with var = E[v^2] - mu^2. Each lane reads back
// only the elements it wrote, so no barrier is needed.
template <int NORM, typename S>
__device__ void stage_row(float* __restrict__ As, const S* __restrict__ src, int K, int KP,
                          const float* __restrict__ gamma, bool valid) {
  const int lane = threadIdx.x & 31;
  float s = 0.f, s2 = 0.f;
#pragma unroll 4
  for (int k = lane; k < KP; k += 32) {
    const float v = valid && k < K ? omt::to_f32(src[k]) : 0.f;
    s += v;
    s2 += v * v;
    As[perm(k, KP)] = v;
  }
  if (NORM == kRaw || !valid) return;
  const float mu = omt::warp_sum(s) / K;
  float var;
  if (NORM == kLayerNorm) {
    float d2 = 0.f;
    for (int k = lane; k < K; k += 32) {
      const float dv = As[perm(k, KP)] - mu;
      d2 += dv * dv;
    }
    var = omt::warp_sum(d2) / K;
  } else {
    var = omt::warp_sum(s2) / K - mu * mu;
  }
  const float rstd = rsqrtf(var + 1e-5f);
#pragma unroll 4
  for (int k = lane; k < K; k += 32) {
    float& a = As[perm(k, KP)];
    a = (a - mu) * rstd * gamma[k];
  }
}

// acc[c][r] += sum_k As[r][k] * w[c][k] over this lane's share of k; the
// caller reduces over the warp. As holds RT staged rows of width KP.
__device__ __forceinline__ void dot_tile(const float* __restrict__ As, int KP,
                                         const int8_t* const (&w)[NC], float (&acc)[NC][RT]) {
  const int lane = threadIdx.x & 31;
  int4 wv[NC], next[NC];
  if (lane * 16 < KP) {
#pragma unroll
    for (int c = 0; c < NC; ++c) next[c] = __ldg(reinterpret_cast<const int4*>(w[c] + lane * 16));
  }
  for (int k0 = 0; k0 < KP; k0 += 512) {
    const int kl = k0 + lane * 16;
    if (kl >= KP) break;
    const int W = min(128, (KP - k0) >> 2);
#pragma unroll
    for (int c = 0; c < NC; ++c) wv[c] = next[c];
    if (kl + 512 < KP) {  // the next block's weights load while this one is used
#pragma unroll
      for (int c = 0; c < NC; ++c) next[c] = __ldg(reinterpret_cast<const int4*>(w[c] + kl + 512));
    }
#pragma unroll
    for (int r = 0; r < RT; ++r) {
      const float* a = As + r * KP + k0 + lane * 4;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float4 av = *reinterpret_cast<const float4*>(a + j * W);
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const int word = j == 0 ? wv[c].x : j == 1 ? wv[c].y : j == 2 ? wv[c].z : wv[c].w;
          const char4 q = *reinterpret_cast<const char4*>(&word);
          float s = acc[c][r];
          s = fmaf(av.x, static_cast<float>(q.x), s);
          s = fmaf(av.y, static_cast<float>(q.y), s);
          s = fmaf(av.z, static_cast<float>(q.z), s);
          s = fmaf(av.w, static_cast<float>(q.w), s);
          acc[c][r] = s;
        }
      }
    }
  }
}

// Reduces acc over the warp; lane r < RT gets row r's NC column sums.
__device__ __forceinline__ void reduce_tile(float (&acc)[NC][RT], float (&mine)[NC]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int r = 0; r < RT; ++r) {
      const float s = omt::warp_sum(acc[c][r]);
      if (lane == r) mine[c] = s;
    }
}

// One product phase: for every 8-row tile of the batch, the block stages
// the rows (stage(smem, warp, row, valid)), then each warp computes groups
// of NC output columns (weights(group, w, smem) fills the weight runs and
// returns the staged matrix to read; epi(group, row, sums) stores row's NC
// outputs, one lane a row).
template <typename Stage, typename Weights, typename Epi>
__device__ void product_phase(float* smem, int b, int groups, int KP, Stage stage, Weights weights,
                              Epi epi) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;
  if (blockIdx.x * NW >= groups) return;  // no column group for this block
  for (int r0 = 0; r0 < b; r0 += RT) {
    __syncthreads();
    stage(smem, warp, r0 + warp, r0 + warp < b);
    __syncthreads();
    for (int grp = blockIdx.x * NW + warp; grp < groups; grp += gridDim.x * NW) {
      const int8_t* w[NC];
      const float* As = weights(grp, w, smem);
      float acc[NC][RT] = {};
      dot_tile(As, KP, w, acc);
      float sums[NC] = {};
      reduce_tile(acc, sums);
      if (lane < RT && r0 + lane < b) epi(grp, r0 + lane, sums);
    }
  }
}

// q of row r, head h: l2norm(q_raw) * q_scale, two elements a lane
__device__ __forceinline__ void unit_rows(const float* __restrict__ raw, const float* __restrict__ mul,
                                          float& v0, float& v1) {
  const int lane = threadIdx.x & 31;
  v0 = raw[lane];
  v1 = raw[lane + 32];
  const float n = fmaxf(sqrtf(omt::warp_sum(v0 * v0 + v1 * v1)), 1e-12f);
  v0 = v0 / n * mul[lane];
  v1 = v1 / n * mul[lane + 32];
}

__device__ __forceinline__ int8_t quant(float v, float s) {
  return static_cast<int8_t>(fminf(fmaxf(rintf(v / s), -127.f), 127.f));
}

template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return omt::to_f32(omt::from_f32<T>(v));
}

template <typename T>
__global__ void __launch_bounds__(NT, 2) fused_layer_kernel(const Params<T> p) {
  extern __shared__ __align__(16) float smem[];
  cg::grid_group grid = cg::this_grid();
  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;
  const int b = p.b, heads = p.heads, dim = p.dim, hd = p.heads * D;

  // ---- B: q = LN(x) @ Wq * sq, k|v = x @ Wkv * skv ----
  product_phase(
      smem, b, (hd + 2 * D) / NC, dim,
      [&](float* s, int w, int row, bool valid) {
        stage_row<kLayerNorm>(s + w * dim, p.x + (size_t)row * dim, dim, dim, p.gamma, valid);
        stage_row<kRaw>(s + (RT + w) * dim, p.x + (size_t)row * dim, dim, dim, p.gamma, valid);
      },
      [&](int grp, const int8_t* (&w)[NC], float* s) -> const float* {
        const int col = grp * NC;
        const int8_t* base = col < hd ? p.wqT + (size_t)col * dim : p.wkvT + (size_t)(col - hd) * dim;
        for (int c = 0; c < NC; ++c) w[c] = base + (size_t)c * dim;
        return col < hd ? s : s + RT * dim;
      },
      [&](int grp, int row, const float (&sums)[NC]) {
        for (int c = 0; c < NC; ++c) {
          const int col = grp * NC + c;
          if (col < hd) p.q_raw[(size_t)row * hd + col] = sums[c] * p.sq[col];
          else p.kv_raw[(size_t)row * 2 * D + col - hd] = sums[c] * p.skv[col - hd];
        }
      });
  grid.sync();

  // ---- C: attention partials of each (row, 64-row chunk of rows < pos) ----
  {
    float(*ks)[D + 1] = reinterpret_cast<float(*)[D + 1]>(smem);
    float(*vs)[D + 1] = reinterpret_cast<float(*)[D + 1]>(smem + CH * (D + 1));
    float* ksc = smem + 2 * CH * (D + 1);
    float* vsc = ksc + CH;
    float(*qs)[D] = reinterpret_cast<float(*)[D]>(vsc + CH);
    float(*ps)[CH] = reinterpret_cast<float(*)[CH]>(vsc + CH + MAXH * D);
    for (int item = blockIdx.x; item < b * p.n_chunks; item += gridDim.x) {
      const int r = item / p.n_chunks, c = item % p.n_chunks;
      const int c0 = c * CH, nk = min(CH, p.pos - c0);
      __syncthreads();
      for (int h = warp; h < heads; h += NW) {
        float q0, q1;
        unit_rows(p.q_raw + (size_t)r * hd + h * D, p.q_scale, q0, q1);
        qs[h][lane] = q0;
        qs[h][lane + 32] = q1;
      }
      // 16-byte loads: a cache row is 8 of them, K in the first 4
      const int4* kvb = reinterpret_cast<const int4*>(p.kv + ((size_t)r * p.N + c0) * 2 * D);
      for (int i = threadIdx.x; i < nk * 8; i += NT) {
        const int4 v4 = __ldg(kvb + i);
        const int j = i / 8, e0 = (i % 8) * 16;
        float* dst = e0 < D ? &ks[j][e0] : &vs[j][e0 - D];
        const int words[4] = {v4.x, v4.y, v4.z, v4.w};
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          const char4 q = *reinterpret_cast<const char4*>(&words[t]);
          dst[4 * t] = q.x;
          dst[4 * t + 1] = q.y;
          dst[4 * t + 2] = q.z;
          dst[4 * t + 3] = q.w;
        }
      }
      for (int i = threadIdx.x; i < nk; i += NT) {
        ksc[i] = p.kv_scale[(size_t)r * p.N + c0 + i];
        vsc[i] = p.kv_scale[((size_t)b + r) * p.N + c0 + i];
      }
      __syncthreads();
      for (int h = warp; h < heads; h += NW) {
        float s[2];
#pragma unroll
        for (int t = 0; t < 2; ++t) {
          const int j = lane + 32 * t;
          s[t] = -INFINITY;
          if (j < nk) {
            float dot = 0.f;
#pragma unroll 16
            for (int e = 0; e < D; ++e) dot = fmaf(qs[h][e], ks[j][e], dot);
            s[t] = dot * ksc[j] * p.scale + p.bias_row[(size_t)(c0 + j) * heads + h] +
                   p.add_mask[(size_t)r * p.N + c0 + j];
          }
        }
        const float m = omt::warp_max(fmaxf(s[0], s[1]));
        float p0 = lane < nk ? expf(s[0] - m) : 0.f;
        float p1 = lane + 32 < nk ? expf(s[1] - m) : 0.f;
        const float l = omt::warp_sum(p0 + p1);
        if (lane < nk) p0 *= vsc[lane];
        if (lane + 32 < nk) p1 *= vsc[lane + 32];
        __syncwarp();  // the previous head's reads of ps are done
        ps[warp][lane] = p0;
        ps[warp][lane + 32] = p1;
        __syncwarp();
        float a0 = 0.f, a1 = 0.f;
        for (int j = 0; j < nk; ++j) {
          a0 = fmaf(ps[warp][j], vs[j][lane], a0);
          a1 = fmaf(ps[warp][j], vs[j][lane + 32], a1);
        }
        float* rec = p.part + (((size_t)r * p.n_chunks + c) * heads + h) * PW;
        if (lane == 0) {
          rec[0] = m;
          rec[1] = l;
        }
        rec[2 + lane] = a0;
        rec[2 + 32 + lane] = a1;
      }
    }
  }
  grid.sync();

  // ---- D: each (row, head) folds its chunks and the fresh row together ----
  for (int it = blockIdx.x * NW + warp; it < b * heads; it += gridDim.x * NW) {
    const int r = it / heads, h = it % heads;
    float k0, k1, q0, q1;
    unit_rows(p.kv_raw + (size_t)r * 2 * D, p.k_scale, k0, k1);
    unit_rows(p.q_raw + (size_t)r * hd + h * D, p.q_scale, q0, q1);
    const float v0 = p.kv_raw[(size_t)r * 2 * D + D + lane];
    const float v1 = p.kv_raw[(size_t)r * 2 * D + D + lane + 32];
    const float self = omt::warp_sum(q0 * k0 + q1 * k1) * p.scale + p.bias_row[(size_t)p.pos * heads + h];
    const float* rec0 = p.part + (size_t)r * p.n_chunks * heads * PW + h * PW;
    float m = self;
    for (int c = lane; c < p.n_chunks; c += 32) m = fmaxf(m, rec0[(size_t)c * heads * PW]);
    m = omt::warp_max(m);
    const float ps = expf(self - m);
    float l = ps, a0 = ps * v0, a1 = ps * v1;
#pragma unroll 4
    for (int c = 0; c < p.n_chunks; ++c) {
      const float* rec = rec0 + (size_t)c * heads * PW;
      const float f = expf(rec[0] - m);
      l = fmaf(rec[1], f, l);
      a0 = fmaf(rec[2 + lane], f, a0);
      a1 = fmaf(rec[2 + 32 + lane], f, a1);
    }
    l = fmaxf(l, 1e-30f);
    p.attn[(size_t)r * hd + h * D + lane] = a0 / l;
    p.attn[(size_t)r * hd + h * D + lane + 32] = a1 / l;
    if (h == 0) {
      float* kr = p.krow + (size_t)r * 2 * D;
      kr[lane] = k0;
      kr[lane + 32] = k1;
      kr[D + lane] = v0;
      kr[D + lane + 32] = v1;
      const float ksc = fmaxf(omt::warp_max(fmaxf(fabsf(k0), fabsf(k1))) / 127.f, 1e-12f);
      const float vsc = fmaxf(omt::warp_max(fmaxf(fabsf(v0), fabsf(v1))) / 127.f, 1e-12f);
      int8_t* row = p.kv + ((size_t)r * p.N + p.pos) * 2 * D;
      row[lane] = quant(k0, ksc);
      row[lane + 32] = quant(k1, ksc);
      row[D + lane] = quant(v0, vsc);
      row[D + lane + 32] = quant(v1, vsc);
      if (lane == 0) {
        p.kv_scale[(size_t)r * p.N + p.pos] = ksc;
        p.kv_scale[((size_t)b + r) * p.N + p.pos] = vsc;
      }
    }
  }
  grid.sync();

  // ---- E: x2 = x + (attn @ Wo) * so, rounded to x's dtype ----
  product_phase(
      smem, b, dim / NC, hd,
      [&](float* s, int w, int row, bool valid) {
        stage_row<kRaw>(s + w * hd, p.attn + (size_t)row * hd, hd, hd, nullptr, valid);
      },
      [&](int grp, const int8_t* (&w)[NC], float* s) -> const float* {
        for (int c = 0; c < NC; ++c) w[c] = p.woT + (size_t)(grp * NC + c) * hd;
        return s;
      },
      [&](int grp, int row, const float (&sums)[NC]) {
        for (int c = 0; c < NC; ++c) {
          const int col = grp * NC + c;
          const size_t i = (size_t)row * dim + col;
          p.x2[i] = round_to<T>(omt::to_f32(p.x[i]) + sums[c] * p.so[col]);
        }
      });
  grid.sync();

  // ---- G: u = LN(x2) @ Wv|Wg * sv|sg, conv over the state, GEGLU ----
  const int inner = p.inner;
  product_phase(
      smem, b, inner, dim,
      [&](float* s, int w, int row, bool valid) {
        stage_row<kLayerNorm>(s + w * dim, p.x2 + (size_t)row * dim, dim, dim, p.gin, valid);
      },
      [&](int grp, const int8_t* (&w)[NC], float* s) -> const float* {
        w[0] = p.wvT + (size_t)grp * dim;  // value column grp
        w[1] = p.wgT + (size_t)grp * dim;  // gate column grp
        return s;
      },
      [&](int c, int row, const float (&sums)[NC]) {
        const float uv = sums[0] * p.sv[c], ug = sums[1] * p.sg[c];
        T* s0 = p.state + (size_t)row * 4 * inner;  // state[row, 0, :]
        T* s1 = s0 + 2 * inner;                     // state[row, 1, :]
        const float s0v = omt::to_f32(s0[c]), s1v = omt::to_f32(s1[c]);
        const float s0g = omt::to_f32(s0[inner + c]), s1g = omt::to_f32(s1[inner + c]);
        const float cv = s0v * p.conv_v[c] + s1v * p.conv_v[inner + c] + uv * p.conv_v[2 * inner + c];
        const float cg = s0g * p.conv_g[c] + s1g * p.conv_g[inner + c] + ug * p.conv_g[2 * inner + c];
        const float gelu = 0.5f * cg * (1.f + erff(cg * 0.7071067811865476f));
        p.g[(size_t)row * inner + c] = gelu * cv;
        s0[c] = s1[c];
        s0[inner + c] = s1[inner + c];
        s1[c] = omt::from_f32<T>(uv);
        s1[inner + c] = omt::from_f32<T>(ug);
      });
  grid.sync();

  // ---- I: y = x2 + (midLN(g) @ Wout) * so ----
  product_phase(
      smem, b, dim / NC, p.inner_p,
      [&](float* s, int w, int row, bool valid) {
        stage_row<kMidNorm>(s + w * p.inner_p, p.g + (size_t)row * inner, inner, p.inner_p, p.gmid,
                            valid);
      },
      [&](int grp, const int8_t* (&w)[NC], float* s) -> const float* {
        for (int c = 0; c < NC; ++c) w[c] = p.ff_woT + (size_t)(grp * NC + c) * p.inner_p;
        return s;
      },
      [&](int grp, int row, const float (&sums)[NC]) {
        for (int c = 0; c < NC; ++c) {
          const int col = grp * NC + c;
          const size_t i = (size_t)row * dim + col;
          p.y[i] = omt::from_f32<T>(p.x2[i] + sums[c] * p.ff_so[col]);
        }
      });
}

template <typename T>
int launch(const Params<T>& p, cudaStream_t s) {
  // the grid: as many blocks as fit on the SMs at once at this shared
  // memory size, found once per size and device (host calls cost tens of us)
  static size_t cached_smem = 0;
  static int cached_dev = -1, cached_blocks = 0;
  const int hd = p.heads * D;
  const int floats = max(max(2 * RT * p.dim, RT * p.inner_p), max(RT * hd, ATTN_SMEM));
  const size_t smem = sizeof(float) * floats;
  auto fn = fused_layer_kernel<T>;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess && (smem != cached_smem || dev != cached_dev)) {
    int sms = 0, per_sm = 0;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e == cudaSuccess) e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, NT, smem);
    if (e == cudaSuccess && per_sm < 1) e = cudaErrorInvalidConfiguration;
    if (e == cudaSuccess) {
      cached_smem = smem;
      cached_dev = dev;
      cached_blocks = per_sm * sms;
    }
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  Params<T> args = p;
  void* argv[] = {&args};
  e = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(fn), dim3(cached_blocks), dim3(NT),
                                  argv, smem, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// Weights in the order of ops/fused_layer.py:_packed_specs; ``work`` is the
// float32 scratch of ops/fused_layer.py:workspace_floats, carved in its order.
template <typename T>
int run(const void* x, const void* const* w, void* kv, void* kv_scale, const void* bias_row,
        const void* add_mask, void* state, void* y, float* work, long long work_floats, int b,
        int heads, int dim, int inner, int N, int pos, float scale, cudaStream_t s) {
  auto f = [&](int i) { return static_cast<const float*>(w[i]); };
  auto i8 = [&](int i) { return static_cast<const int8_t*>(w[i]); };
  Params<T> p;
  p.x = static_cast<const T*>(x);
  p.gamma = f(0); p.wqT = i8(1); p.sq = f(2); p.wkvT = i8(3); p.skv = f(4);
  p.woT = i8(5); p.so = f(6); p.q_scale = f(7); p.k_scale = f(8);
  p.gin = f(9); p.wvT = i8(10); p.sv = f(11); p.wgT = i8(12); p.sg = f(13);
  p.conv_v = f(14); p.conv_g = f(15); p.gmid = f(16); p.ff_woT = i8(17); p.ff_so = f(18);
  p.kv = static_cast<int8_t*>(kv);
  p.kv_scale = static_cast<float*>(kv_scale);
  p.bias_row = static_cast<const float*>(bias_row);
  p.add_mask = static_cast<const float*>(add_mask);
  p.state = static_cast<T*>(state);
  p.y = static_cast<T*>(y);
  p.b = b; p.heads = heads; p.dim = dim; p.inner = inner; p.inner_p = (inner + 15) / 16 * 16;
  p.N = N; p.pos = pos; p.n_chunks = (pos + CH - 1) / CH; p.scale = scale;
  const size_t hd = (size_t)heads * D;
  p.krow = work;
  p.q_raw = p.krow + (size_t)b * 2 * D;
  p.kv_raw = p.q_raw + (size_t)b * hd;
  p.part = p.kv_raw + (size_t)b * 2 * D;
  p.attn = p.part + (size_t)b * p.n_chunks * heads * PW;
  p.x2 = p.attn + (size_t)b * hd;
  p.g = p.x2 + (size_t)b * dim;
  if (p.g + (size_t)b * inner > work + work_floats) return static_cast<int>(cudaErrorInvalidValue);
  return launch(p, s);
}

}  // namespace

extern "C" int omt_fused_layer(
    const void* x, const void* gamma, const void* wqT, const void* sq, const void* wkvT,
    const void* skv, const void* woT, const void* so, const void* q_scale, const void* k_scale,
    const void* gin, const void* wvT, const void* sv, const void* wgT, const void* sg,
    const void* conv_v, const void* conv_g, const void* gmid, const void* ff_woT,
    const void* ff_so, void* kv, void* kv_scale, const void* bias_row, const void* add_mask,
    void* state, void* y, void* work, long long work_floats, int b, int heads, int dim,
    int inner, int N, int pos, float scale, int dtype, void* stream) {
  const void* const w[] = {gamma, wqT, sq, wkvT, skv, woT, so, q_scale, k_scale, gin,
                           wvT, sv, wgT, sg, conv_v, conv_g, gmid, ff_woT, ff_so};
  auto s = static_cast<cudaStream_t>(stream);
  auto ws = static_cast<float*>(work);
  if (dtype == 0)
    return run<float>(x, w, kv, kv_scale, bias_row, add_mask, state, y, ws, work_floats, b, heads,
                      dim, inner, N, pos, scale, s);
  return run<__nv_bfloat16>(x, w, kv, kv_scale, bias_row, add_mask, state, y, ws, work_floats, b,
                            heads, dim, inner, N, pos, scale, s);
}
