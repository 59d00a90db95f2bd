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
// What bounds it on the H100: bytes. musiclm_small's layer holds
// 2 * 1024 * 2730 + 2730 * 1024 = 8.4 MB of int8 FF weights, read once per
// decode token against 6 * b * 1024 * 2730 FLOPs: below the FLOP/byte balance
// point at any decode batch this repo serves (2.65 us at 3.35 TB/s). So each
// launch is a weight stream in the weights' own [in, out] layout:
//   * a block owns `cols` (<= 128) consecutive output columns and one split
//     of the k rows (ops/fused_ff.py:ff_grid chooses both, so that the
//     blocks fill the card). A warp takes 16 rows at a time, each row's
//     128-byte segment as 32 aligned 4-byte words (a lane the words of
//     columns 4 g + 32 t, so that every load instruction reads whole
//     sectors), two such steps in flight, no barrier inside the k loop.
//     Rows that start off 4-byte alignment (inner 2730) are shifted into
//     place by a shuffle and a byte permute; such blocks own at most 124
//     columns;
//   * the products run on the tensor cores: mma.sync m16n8k8 tf32 with the
//     weights as A (int8 -> float by a byte permute into a float's mantissa
//     and one subtract, exact in tf32) and the 8 staged activation rows of a
//     pass as B, float32 accumulation. float32 activations are split into
//     tf32 hi + lo (two products), bf16 ones take hi alone. More rows than 8:
//     further passes, whose weights come from L2;
//   * ff_in's warps 0-3 stream Wv and warps 4-7 Wg over the same staged
//     rows; ff_out's 8 warps stream Wout;
//   * LayerNorm is computed once per row. ff_in's block 0 computes LN(x)'s
//     mean and 1/sqrt(var + eps) (two passes over x, as jnp.var does) while
//     the other blocks stream x * gin and, as a second B tile, gin itself;
//     the fold applies the statistics:
//     h @ W = rs * ((x * gin) @ W - mu * gin @ W).
//     ff_out stages mid-LN(g) * gmid from the statistics ff_in left;
//   * a block sums its warps in order in shared memory and writes a float32
//     partial for its (pass, column block, split). The last block of a
//     column block (an atomic ticket after __threadfence, reset by that
//     block) sums the splits in order 0, 1, ... and runs the epilogue: in
//     ff_in, the column scales, conv taps, exact-erf GELU, the new state
//     row, g and the column block's sums of g and g^2; the last column
//     block (a second ticket) folds those in order into the mid-LN's mean
//     and 1/sqrt(var + eps) per row. ff_in's block 0 counts in every column
//     block's ticket, so the fold never waits: whichever block comes last
//     folds. In ff_out the fold writes y = x + sum * so. No sum's order
//     depends on which block finishes last, so the results are the same
//     from run to run.
// The mid-LN needs the whole `inner` row, and blocks cannot wait for each
// other inside one launch, hence two launches. Tickets and partials are the
// caller's scratch (per device and stream); each launch leaves its tickets 0.
#include <type_traits>

#include "mma.cuh"

namespace {

constexpr int NT = 256;      // threads a block
constexpr int NW = NT / 32;  // warps a block
constexpr int RB = 8;        // activation rows a pass
constexpr int KC = 256;      // k rows staged at a time
constexpr int KS = 16;       // k rows a warp step
constexpr int SEG = 128;     // columns a block at most: 16 bytes of a row for each of 8 lanes
constexpr int NJ = SEG / 16;  // m-tiles of a warp step
constexpr int DEPTH = 2;      // warp steps whose words are in flight at once
constexpr int REC_IN = 2 * (RB + 1) * SEG;  // an ff_in block's partial: Wv, Wg x (8 rows, gin)
constexpr int REC_OUT = RB * SEG;           // an ff_out block's partial
constexpr unsigned FULL = 0xffffffffu;
enum { ALIGNED = 0, SHIFTED = 1 };  // rows start on 4-byte boundaries, or not

// The 4 bytes at w[a] (a a multiple of 4); bytewise past the array's end.
__device__ __forceinline__ unsigned load_word(const int8_t* __restrict__ w, size_t a,
                                              size_t total) {
  if (a + 4 <= total) return __ldg(reinterpret_cast<const unsigned*>(w + a));
  unsigned r = 0;
  for (int e = 0; e < 4; ++e)
    if (a + e < total) r |= static_cast<unsigned>(static_cast<uint8_t>(w[a + e])) << (8 * e);
  return r;
}

// four signed bytes as floats: byte + 128 into the low mantissa bits of
// 2^23, less 2^23 + 128 (exact)
__device__ __forceinline__ void i8x4_to_f32(unsigned w, float (&f)[4]) {
  const unsigned u = w ^ 0x80808080u;
  f[0] = __int_as_float(__byte_perm(u, 0x4B000000u, 0x7440)) - 8388736.f;
  f[1] = __int_as_float(__byte_perm(u, 0x4B000000u, 0x7441)) - 8388736.f;
  f[2] = __int_as_float(__byte_perm(u, 0x4B000000u, 0x7442)) - 8388736.f;
  f[3] = __int_as_float(__byte_perm(u, 0x4B000000u, 0x7443)) - 8388736.f;
}

// A block's columns [c0, c0 + lim) of an int8 [rows, ld] matrix of `total` bytes.
struct Seg {
  const int8_t* w;
  int ld;
  size_t total;
  int c0, lim;
};

// A warp step: rows r = k16 + tq + 4 i (i = 0..3, those below k1) of the
// segment, 16 bytes a row: lane (g, tq) the words of columns c0 + 4 g + 32 t
// (t = 0..3), so that each load instruction reads whole 32-byte sectors,
// starting `off` bytes early when rows start off 4-byte alignment (off
// depends only on r mod 4, so it is the lane's for the whole stream);
// words past the columns the block needs are not read.
__device__ __forceinline__ void load_step(const Seg& s, int k16, int k1, int off,
                                          unsigned (&w)[4][4]) {
  const int lane = threadIdx.x % 32, g = lane / 4, tq = lane % 4;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = k16 + tq + 4 * i;
    const size_t a = static_cast<size_t>(r) * s.ld + s.c0 + 4 * g - off;
#pragma unroll
    for (int t = 0; t < 4; ++t)
      w[i][t] = r < k1 && 4 * g + 32 * t < s.lim + off ? load_word(s.w, a + 32 * t, s.total) : 0u;
  }
}

// the columns of a lane's bytes 2 j and 2 j + 1 of a row: col_of(g, j) and the next
__device__ __forceinline__ int col_of(int g, int j) { return 4 * g + 32 * (j / 2) + 2 * (j % 2); }

// The products of one warp step on the tensor cores, as two m16n8k8 k-steps
// (rows i = 0, 1 and i = 2, 3 of load_step): A = W^T, 16 of the segment's
// columns x 8 k rows, m-tile j's rows g and g + 8 being the lane's bytes 2 j
// and 2 j + 1 (columns col_of(g, j) and col_of(g, j) + 1), so that a lane's
// A fragments come from its own words; B = the staged activation rows
// (hs[k][batch row g]) split into tf32 hi + lo (SPLIT: float32 activations;
// bf16 ones take hi alone), and with Q the gin row (hg) as batch row 0 of a
// second tile. int8 values are exact in tf32. acc[j] is a C fragment:
// columns col_of(g, j) (0, 1) and col_of(g, j) + 1 (2, 3), batch rows 2 tq
// (0, 2) and 2 tq + 1 (1, 3).
template <int MODE, bool Q, bool SPLIT>
__device__ __forceinline__ void mma_step(const unsigned (&w)[4][4], int off, int k16, int kc0,
                                         int kc1, const float* hs, const float* hg,
                                         float (&acc)[NJ][4], float (&accq)[NJ][4]) {
  const int lane = threadIdx.x % 32, g = lane / 4, tq = lane % 4;
  const unsigned sel = 0x3210 + 0x1111 * off;
#pragma unroll
  for (int ks = 0; ks < 2; ++ks) {
    float f[2][16];  // rows 2 ks, 2 ks + 1: the lane's 16 columns
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = 2 * ks + h;
      unsigned v[4];
      if (MODE == SHIFTED) {  // each word with the next one in memory: lane g + 1's word,
                              // for g = 7 lane 0's next word
        unsigned nb[4];
#pragma unroll
        for (int t = 0; t < 4; ++t) nb[t] = __shfl_sync(FULL, w[i][t], (lane + 4) % 32);
#pragma unroll
        for (int t = 0; t < 4; ++t)
          v[t] = __byte_perm(w[i][t], g < 7 ? nb[t] : nb[t < 3 ? t + 1 : t], sel);
      } else {
#pragma unroll
        for (int t = 0; t < 4; ++t) v[t] = w[i][t];
      }
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        float q4[4];
        i8x4_to_f32(v[t], q4);
#pragma unroll
        for (int e = 0; e < 4; ++e) f[h][4 * t + e] = q4[e];
      }
    }
    const int r0 = k16 + 8 * ks + tq, r1 = r0 + 4;
    unsigned b0h, b0l, b1h, b1l;
    omt::split_tf32(r0 < kc1 ? hs[(r0 - kc0) * RB + g] : 0.f, b0h, b0l);
    omt::split_tf32(r1 < kc1 ? hs[(r1 - kc0) * RB + g] : 0.f, b1h, b1l);
    unsigned q0h = 0, q0l = 0, q1h = 0, q1l = 0;
    if constexpr (Q) {
      omt::split_tf32(g == 0 && r0 < kc1 ? hg[r0 - kc0] : 0.f, q0h, q0l);
      omt::split_tf32(g == 0 && r1 < kc1 ? hg[r1 - kc0] : 0.f, q1h, q1l);
    }
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const unsigned a[4] = {__float_as_uint(f[0][2 * j]), __float_as_uint(f[0][2 * j + 1]),
                             __float_as_uint(f[1][2 * j]), __float_as_uint(f[1][2 * j + 1])};
      omt::mma_tf32(acc[j], a, b0h, b1h);
      if constexpr (SPLIT) omt::mma_tf32(acc[j], a, b0l, b1l);
      if constexpr (Q) {
        omt::mma_tf32(accq[j], a, q0h, q1h);
        if constexpr (SPLIT) omt::mma_tf32(accq[j], a, q0l, q1l);
      }
    }
  }
}

// The warp's steps k16 = kc0 + 16 (wi + n WPM) below kc1. buf[d] holds the
// words of step n = d (mod DEPTH), loaded by the caller (first_steps) before
// it staged hs; a step's buffer is refilled with the step DEPTH later as
// soon as it is used, so that DEPTH steps are in flight.
__device__ __forceinline__ void first_steps(const Seg& s, int kc0, int kc1, int wi, int wpm,
                                            int off, unsigned (&buf)[DEPTH][4][4]) {
#pragma unroll
  for (int d = 0; d < DEPTH; ++d) load_step(s, kc0 + KS * (wi + d * wpm), kc1, off, buf[d]);
}

template <int MODE, int WPM, bool Q, bool SPLIT>
__device__ __forceinline__ void stream_steps(const Seg& s, int kc0, int kc1, int wi, int off,
                                             unsigned (&buf)[DEPTH][4][4], const float* hs,
                                             const float* hg, float (&acc)[NJ][4],
                                             float (&accq)[NJ][4]) {
  for (int k16 = kc0 + KS * wi; k16 < kc1; k16 += DEPTH * KS * WPM) {
#pragma unroll
    for (int d = 0; d < DEPTH; ++d) {
      const int kd = k16 + d * KS * WPM;
      if (kd >= kc1) break;
      mma_step<MODE, Q, SPLIT>(buf[d], off, kd, kc0, kc1, hs, hg, acc, accq);
      load_step(s, kd + DEPTH * KS * WPM, kc1, off, buf[d]);
    }
  }
}

// the 8 activation rows of one k into the staged chunk (two 16-byte stores)
__device__ __forceinline__ void store_row(float* dst, const float (&h)[RB]) {
  reinterpret_cast<float4*>(dst)[0] = make_float4(h[0], h[1], h[2], h[3]);
  reinterpret_cast<float4*>(dst)[1] = make_float4(h[4], h[5], h[6], h[7]);
}

// The block's partial, out[m][r][column] (r = RB: the gin row): the sums of
// matrix m's NW / NM warps, in warp order.
template <int NM, bool Q>
__device__ __forceinline__ void block_partial(const float (&acc)[NJ][4],
                                              const float (&accq)[NJ][4], float* red,
                                              float* __restrict__ out) {
  constexpr int NR = Q ? RB + 1 : RB, WPM = NW / NM;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32, g = lane / 4, tq = lane % 4;
  float* mine = red + warp * NR * SEG;
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const int col = col_of(g, j);
    *reinterpret_cast<float2*>(mine + 2 * tq * SEG + col) = make_float2(acc[j][0], acc[j][2]);
    *reinterpret_cast<float2*>(mine + (2 * tq + 1) * SEG + col) = make_float2(acc[j][1], acc[j][3]);
    if (Q && tq == 0)
      *reinterpret_cast<float2*>(mine + RB * SEG + col) = make_float2(accq[j][0], accq[j][2]);
  }
  __syncthreads();
  for (int e = threadIdx.x; e < NM * NR * SEG; e += NT) {
    const int m = e / (NR * SEG), i = e % (NR * SEG);
    float v = 0.f;
#pragma unroll
    for (int w = 0; w < WPM; ++w) v += red[(m * WPM + w) * NR * SEG + i];
    out[e] = v;
  }
  __syncthreads();
}

// v[i] += p[i][s * stride] over the splits s = 0 .. S - 1 in order, for the
// i with p[i] set. A fold thread loads SC splits of every i before it adds
// them, so that their L2 round trips overlap.
template <int SC, int NV>
__device__ __forceinline__ void sum_splits(const float* const (&p)[NV], size_t stride, int S,
                                           float (&v)[NV]) {
  for (int s0 = 0; s0 < S; s0 += SC) {
    float t[NV][SC];
#pragma unroll
    for (int i = 0; i < NV; ++i)
#pragma unroll
      for (int j = 0; j < SC; ++j)
        t[i][j] = p[i] != nullptr && s0 + j < S ? __ldcg(p[i] + (s0 + j) * stride) : 0.f;
#pragma unroll
    for (int i = 0; i < NV; ++i)
#pragma unroll
      for (int j = 0; j < SC; ++j) v[i] += t[i][j];
  }
}

struct InArgs {
  const void* x;
  const float* gin;
  const int8_t* wv;
  const float* sv;
  const int8_t* wg;
  const float* sg;
  const float* conv_v;
  const float* conv_g;
  const void* state;
  float* g_out;  // [B, inner]
  void* new_state;
  float* xstats;      // [B, 2]: LN(x)'s mean and 1/sqrt(var + eps)
  float* part;        // [passes, col_blocks, splits, REC_IN]
  float* part_stats;  // [col_blocks, B, 2]: sums of g and g^2 over a column block
  float* midstats;    // [B, 2]: the mid-LN's mean and 1/sqrt(var + eps)
  int* tickets;       // [col_blocks + 1], 0 between launches
  int B, dim, inner, cols, col_blocks, splits, per;
};

// LN(x)'s statistics, a warp a row, var = E[(x - mu)^2] as jnp.var. A lane
// loads its 32 values of a 1024-wide chunk at once and keeps them for the
// second pass (longer rows load each chunk again).
template <typename T>
__device__ void x_stats(const InArgs& a) {
  constexpr int PER = 32;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  for (int row = warp; row < a.B; row += NW) {
    const T* xr = static_cast<const T*>(a.x) + static_cast<size_t>(row) * a.dim;
    float v[PER];
    auto load = [&](int k0) {
#pragma unroll
      for (int i = 0; i < PER; ++i) {
        const int k = k0 + lane + 32 * i;
        v[i] = k < a.dim ? omt::to_f32(__ldg(xr + k)) : 0.f;
      }
    };
    float s = 0.f;
    for (int k0 = 0; k0 < a.dim; k0 += 32 * PER) {
      load(k0);
#pragma unroll
      for (int i = 0; i < PER; ++i) s += v[i];
    }
    const float mu = omt::warp_sum(s) / a.dim;
    float d2 = 0.f;
    for (int k0 = 0; k0 < a.dim; k0 += 32 * PER) {
      if (a.dim > 32 * PER) load(k0);
#pragma unroll
      for (int i = 0; i < PER; ++i) {
        const float d = k0 + lane + 32 * i < a.dim ? v[i] - mu : 0.f;
        d2 += d * d;
      }
    }
    const float rs = rsqrtf(omt::warp_sum(d2) / a.dim + 1e-5f);
    if (lane == 0) {
      a.xstats[2 * row] = mu;
      a.xstats[2 * row + 1] = rs;
    }
  }
}

// Column block cb of ff_in, once all its splits and the statistics are in:
// the splits summed in order, LN applied, the epilogue, the block's mid-LN
// sums; then, if it is the last column block, the mid-LN statistics.
template <typename T>
__device__ void fold_in(const InArgs& a, int cb, float (*ms)[4][2], int* last) {
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int cc = tid % SEG, rh = tid / SEG;  // column; rows rh, rh + 2, rh + 4, rh + 6
  const int c = cb * a.cols + cc, inner = a.inner, S = a.splits;
  const bool ok = cc < a.cols && c < inner;
  const size_t width = 2 * static_cast<size_t>(inner);
  float sv = 0.f, sg = 0.f, cv[3] = {}, cg[3] = {};  // the column's scales and conv taps
  float q[2] = {};  // gin @ Wv, gin @ Wg: pass 0's row RB, summed with pass 0's rows
  if (ok) {
    sv = a.sv[c];
    sg = a.sg[c];
#pragma unroll
    for (int t = 0; t < 3; ++t) {
      cv[t] = a.conv_v[t * inner + c];
      cg[t] = a.conv_g[t * inner + c];
    }
  }
  for (int p = 0; p * RB < a.B; ++p) {
    // rows rh + 2 i of this pass: their state words, then their splits' sums
    const float* pp[10] = {};
    float st[4][4] = {}, mu[4] = {}, rs[4] = {};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = rh + 2 * i, row = p * RB + r;
      if (!ok || row >= a.B) continue;
      mu[i] = __ldcg(a.xstats + 2 * row);
      rs[i] = __ldcg(a.xstats + 2 * row + 1);
      pp[i] = a.part + static_cast<size_t>(p * a.col_blocks + cb) * S * REC_IN + r * SEG + cc;
      pp[4 + i] = pp[i] + (RB + 1) * SEG;
      const T* s0 = static_cast<const T*>(a.state) + static_cast<size_t>(row) * 2 * width;
      st[i][0] = omt::to_f32(s0[c]);
      st[i][1] = omt::to_f32(s0[width + c]);
      st[i][2] = omt::to_f32(s0[inner + c]);
      st[i][3] = omt::to_f32(s0[width + inner + c]);
    }
    if (p == 0 && ok) {
      pp[8] = a.part + static_cast<size_t>(cb) * S * REC_IN + RB * SEG + cc;
      pp[9] = pp[8] + (RB + 1) * SEG;
    }
    float u[10] = {};
    sum_splits<6, 10>(pp, REC_IN, S, u);
    if (p == 0) {
      q[0] = u[8];
      q[1] = u[9];
    }
    float s1[4], s2[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = p * RB + rh + 2 * i;
      float gval = 0.f;
      if (pp[i] != nullptr) {
        const float uv = (u[i] - mu[i] * q[0]) * rs[i] * sv;
        const float ug = (u[4 + i] - mu[i] * q[1]) * rs[i] * sg;
        const float conv_v = st[i][0] * cv[0] + st[i][1] * cv[1] + uv * cv[2];
        const float conv_g = st[i][2] * cg[0] + st[i][3] * cg[1] + ug * cg[2];
        const float gelu = 0.5f * conv_g * (1.f + erff(conv_g * 0.7071067811865476f));
        gval = gelu * conv_v;
        a.g_out[static_cast<size_t>(row) * inner + c] = gval;
        // state[:, 1] moves to new_state[:, 0] from the words already read
        // (exact in float32): no load after a store that may alias it
        T* n0 = static_cast<T*>(a.new_state) + static_cast<size_t>(row) * 2 * width;
        T* n1 = n0 + width;
        n0[c] = omt::from_f32<T>(st[i][1]);
        n0[inner + c] = omt::from_f32<T>(st[i][3]);
        n1[c] = omt::from_f32<T>(uv);
        n1[inner + c] = omt::from_f32<T>(ug);
      }
      s1[i] = gval;
      s2[i] = gval * gval;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {  // each row's sums over the block's columns, warps in order
      const float v1 = omt::warp_sum(s1[i]), v2 = omt::warp_sum(s2[i]);
      if (lane == 0) {
        ms[warp][i][0] = v1;
        ms[warp][i][1] = v2;
      }
    }
    __syncthreads();
    if (tid < RB && p * RB + tid < a.B) {
      const int r = tid, w0 = (r % 2) * (NW / 2), i = r / 2;
      float t1 = 0.f, t2 = 0.f;
      for (int w = w0; w < w0 + NW / 2; ++w) {
        t1 += ms[w][i][0];
        t2 += ms[w][i][1];
      }
      float* ps = a.part_stats + (static_cast<size_t>(cb) * a.B + p * RB + r) * 2;
      ps[0] = t1;
      ps[1] = t2;
    }
    __syncthreads();
  }
  if (tid == 0) a.tickets[cb] = 0;  // ready for the next launch

  // the last column block folds the mid-LN statistics of every row, blocks in order
  __threadfence();
  __syncthreads();
  if (tid == 0) *last = atomicAdd(a.tickets + a.col_blocks, 1) == a.col_blocks - 1;
  __syncthreads();
  if (!*last) return;
  __threadfence();
  for (int row = warp; row < a.B; row += NW) {
    float t1 = 0.f, t2 = 0.f;
    for (int b = lane; b < a.col_blocks; b += 32) {
      const float2 v = __ldcg(reinterpret_cast<const float2*>(a.part_stats) +
                              static_cast<size_t>(b) * a.B + row);
      t1 += v.x;
      t2 += v.y;
    }
    t1 = omt::warp_sum(t1);
    t2 = omt::warp_sum(t2);
    if (lane == 0) {
      const float mu = t1 / inner;
      a.midstats[2 * row] = mu;
      a.midstats[2 * row + 1] = rsqrtf(t2 / inner - mu * mu + 1e-5f);
    }
  }
  if (tid == 0) a.tickets[a.col_blocks] = 0;
}

// Block 0: LN(x)'s statistics, then one arrival at every column block's
// ticket. Blocks 1..: column block (b - 1) / splits, split (b - 1) % splits.
template <typename T, int MODE>
__global__ void __launch_bounds__(NT, 1) ff_in_kernel(InArgs a) {
  constexpr bool SPLIT = std::is_same<T, float>::value;
  __shared__ __align__(16) float hs[KC * RB];
  __shared__ float hg[KC];
  __shared__ __align__(16) float red[NW * (RB + 1) * SEG];
  __shared__ float ms[NW][4][2];
  __shared__ int flags[NT];
  __shared__ int last;
  const int tid = threadIdx.x;
  if (blockIdx.x == 0) {
    x_stats<T>(a);
    __threadfence();
    __syncthreads();
    for (int cb0 = 0; cb0 < a.col_blocks; cb0 += NT) {
      const int cb = cb0 + tid;
      flags[tid] = cb < a.col_blocks && atomicAdd(a.tickets + cb, 1) == a.splits;
      __syncthreads();
      for (int i = 0; i < NT && cb0 + i < a.col_blocks; ++i) {
        if (!flags[i]) continue;
        __threadfence();
        fold_in<T>(a, cb0 + i, ms, &last);
      }
      __syncthreads();
    }
    return;
  }
  constexpr int WPM = NW / 2;  // warps 0-3 stream Wv, 4-7 Wg
  const int j = blockIdx.x - 1, cb = j / a.splits, s = j % a.splits;
  const int warp = tid / 32, tq = tid % 4, c0 = cb * a.cols;
  const Seg seg{warp < WPM ? a.wv : a.wg, a.inner, static_cast<size_t>(a.dim) * a.inner, c0,
                min(a.cols, a.inner - c0)};
  const int k0 = s * a.per, k1 = min(a.dim, k0 + a.per);
  const T* x = static_cast<const T*>(a.x);
  for (int p = 0; p * RB < a.B; ++p) {
    float acc[NJ][4] = {}, accq[NJ][4] = {};
    for (int kc0 = k0; kc0 < k1; kc0 += KC) {
      const int kc1 = min(k1, kc0 + KC);
      const int off =
          MODE == SHIFTED ? static_cast<int>((static_cast<size_t>(kc0 + tq) * a.inner + c0) & 3) : 0;
      unsigned buf[DEPTH][4][4];
      first_steps(seg, kc0, kc1, warp % WPM, WPM, off, buf);  // in flight while the rows are staged
      for (int k = kc0 + tid; k < kc1; k += NT) {  // hs[k][r] = x * gin, rows past B zero
        const float gk = __ldg(a.gin + k);
        float h[RB];
#pragma unroll
        for (int r = 0; r < RB; ++r) {
          const int row = p * RB + r;
          h[r] = row < a.B ? omt::to_f32(__ldg(x + static_cast<size_t>(row) * a.dim + k)) * gk : 0.f;
        }
        store_row(hs + (k - kc0) * RB, h);
        hg[k - kc0] = gk;
      }
      __syncthreads();
      stream_steps<MODE, WPM, true, SPLIT>(seg, kc0, kc1, warp % WPM, off, buf, hs, hg, acc, accq);
      __syncthreads();
    }
    block_partial<2, true>(
        acc, accq, red, a.part + (static_cast<size_t>(p * a.col_blocks + cb) * a.splits + s) * REC_IN);
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicAdd(a.tickets + cb, 1) == a.splits;  // splits + block 0 arrive
  __syncthreads();
  if (!last) return;
  __threadfence();
  fold_in<T>(a, cb, ms, &last);
}

struct OutArgs {
  const float* g;         // [B, inner]
  const float* midstats;  // [B, 2]
  const float* gmid;
  const int8_t* wo;
  const float* so;
  const void* x;
  void* y;
  float* part;   // [passes, col_blocks, splits, REC_OUT]
  int* tickets;  // [col_blocks], 0 between launches
  int B, inner, dim, cols, col_blocks, splits, per;
};

// Block b: column block b / splits, split b % splits; the last split of a
// column block to finish sums the splits in order and writes y.
template <typename T, int MODE>
__global__ void __launch_bounds__(NT, 1) ff_out_kernel(OutArgs a) {
  constexpr bool SPLIT = std::is_same<T, float>::value;
  __shared__ __align__(16) float hs[KC * RB];
  __shared__ __align__(16) float red[NW * RB * SEG];
  __shared__ int last;
  const int tid = threadIdx.x, warp = tid / 32, tq = tid % 4;
  const int cb = blockIdx.x / a.splits, s = blockIdx.x % a.splits, c0 = cb * a.cols;
  const Seg seg{a.wo, a.dim, static_cast<size_t>(a.inner) * a.dim, c0, min(a.cols, a.dim - c0)};
  const int k0 = s * a.per, k1 = min(a.inner, k0 + a.per);
  for (int p = 0; p * RB < a.B; ++p) {
    float mu[RB], rs[RB];
#pragma unroll
    for (int r = 0; r < RB; ++r) {
      const int row = min(p * RB + r, a.B - 1);
      mu[r] = __ldg(a.midstats + 2 * row);
      rs[r] = __ldg(a.midstats + 2 * row + 1);
    }
    float acc[NJ][4] = {};
    for (int kc0 = k0; kc0 < k1; kc0 += KC) {
      const int kc1 = min(k1, kc0 + KC);
      const int off =
          MODE == SHIFTED ? static_cast<int>((static_cast<size_t>(kc0 + tq) * a.dim + c0) & 3) : 0;
      unsigned buf[DEPTH][4][4];
      first_steps(seg, kc0, kc1, warp, NW, off, buf);
      for (int k = kc0 + tid; k < kc1; k += NT) {  // hs[k][r] = mid-LN(g) * gmid, rows past B zero
        const float gk = __ldg(a.gmid + k);
        float h[RB];
#pragma unroll
        for (int r = 0; r < RB; ++r) {
          const int row = p * RB + r;
          h[r] = row < a.B
              ? (__ldg(a.g + static_cast<size_t>(row) * a.inner + k) - mu[r]) * rs[r] * gk
              : 0.f;
        }
        store_row(hs + (k - kc0) * RB, h);
      }
      __syncthreads();
      stream_steps<MODE, NW, false, SPLIT>(seg, kc0, kc1, warp, off, buf, hs, nullptr, acc, acc);
      __syncthreads();
    }
    block_partial<1, false>(
        acc, acc, red, a.part + (static_cast<size_t>(p * a.col_blocks + cb) * a.splits + s) * REC_OUT);
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicAdd(a.tickets + cb, 1) == a.splits - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  const int cc = tid % SEG, rh = tid / SEG, c = c0 + cc;
  const bool ok = cc < a.cols && c < a.dim;
  const T* x = static_cast<const T*>(a.x);
  T* y = static_cast<T*>(a.y);
  const float so = ok ? a.so[c] : 0.f;
  for (int p = 0; p * RB < a.B; ++p) {  // rows rh + 2 i of each pass
    const float* pp[4] = {};
    float xv[4] = {}, v[4] = {};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = rh + 2 * i, row = p * RB + r;
      if (!ok || row >= a.B) continue;
      pp[i] = a.part + static_cast<size_t>(p * a.col_blocks + cb) * a.splits * REC_OUT + r * SEG + cc;
      xv[i] = omt::to_f32(x[static_cast<size_t>(row) * a.dim + c]);
    }
    sum_splits<8, 4>(pp, REC_OUT, a.splits, v);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (pp[i] != nullptr)
        y[static_cast<size_t>(p * RB + rh + 2 * i) * a.dim + c] = omt::from_f32<T>(xv[i] + v[i] * so);
  }
  if (tid == 0) a.tickets[cb] = 0;  // ready for the next launch
}

// The grid the caller chose fits the loaders: cols a multiple of 4 within
// a warp's segment (124 columns when rows start off 4-byte alignment), the
// column blocks and splits covering the matrix.
bool grid_ok(int rows, int ld, int cols, int col_blocks, int splits, int per) {
  const int max_cols = ld % 4 == 0 ? SEG : SEG - 4;
  return cols > 0 && cols % 4 == 0 && cols <= max_cols && per > 0 &&
         static_cast<long long>(col_blocks) * cols >= ld &&
         static_cast<long long>(splits) * per >= rows;
}

}  // namespace

// ff_in: g_out [B, inner] float32, new_state, and the mid-LN's per-row mean
// and 1/sqrt(var + eps) in midstats [B, 2]. The grid (ops/fused_ff.py:
// ff_in_grid): col_blocks blocks of `cols` columns of Wv and Wg, each split
// over `splits` ranges of `per` k rows, and one block for LN(x)'s
// statistics. Scratch: xstats [B, 2], part [ceil(B / 8), col_blocks,
// splits, 2 * 9 * 128] and part_stats [col_blocks, B, 2] float32, and
// tickets [col_blocks + 1] int32 (0, and left 0).
extern "C" int omt_fused_ff_in(const void* x, const void* gin, const void* wv, const void* sv,
                               const void* wg, const void* sg, const void* conv_v,
                               const void* conv_g, const void* state, void* g_out,
                               void* new_state, void* xstats, void* part, void* part_stats,
                               void* midstats, void* tickets, int B, int dim, int inner, int cols,
                               int col_blocks, int splits, int per, int dtype, void* stream) {
  if (!grid_ok(dim, inner, cols, col_blocks, splits, per)) return cudaErrorInvalidValue;
  const InArgs a{x, static_cast<const float*>(gin), static_cast<const int8_t*>(wv),
                 static_cast<const float*>(sv), static_cast<const int8_t*>(wg),
                 static_cast<const float*>(sg), static_cast<const float*>(conv_v),
                 static_cast<const float*>(conv_g), state, static_cast<float*>(g_out), new_state,
                 static_cast<float*>(xstats), static_cast<float*>(part),
                 static_cast<float*>(part_stats), static_cast<float*>(midstats),
                 static_cast<int*>(tickets), B, dim, inner, cols, col_blocks, splits, per};
  auto s = static_cast<cudaStream_t>(stream);
  const unsigned blocks = 1 + col_blocks * splits;
  const bool aligned = inner % 4 == 0;
  if (dtype == 0 && aligned)
    ff_in_kernel<float, ALIGNED><<<blocks, NT, 0, s>>>(a);
  else if (dtype == 0)
    ff_in_kernel<float, SHIFTED><<<blocks, NT, 0, s>>>(a);
  else if (aligned)
    ff_in_kernel<__nv_bfloat16, ALIGNED><<<blocks, NT, 0, s>>>(a);
  else
    ff_in_kernel<__nv_bfloat16, SHIFTED><<<blocks, NT, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// ff_out: y [B, dim] = x + (mid-LN(g) * gmid) @ Wout * so. The grid
// (ops/fused_ff.py:ff_out_grid): col_blocks blocks of `cols` columns of
// Wout, each split over `splits` ranges of `per` k rows. Scratch: part
// [ceil(B / 8), col_blocks, splits, 8 * 128] float32 and tickets
// [col_blocks] int32 (0, and left 0).
extern "C" int omt_fused_ff_out(const void* g, const void* midstats, const void* gmid,
                                const void* wo, const void* so, const void* x, void* y,
                                void* part, void* tickets, int B, int inner, int dim, int cols,
                                int col_blocks, int splits, int per, int dtype, void* stream) {
  if (!grid_ok(inner, dim, cols, col_blocks, splits, per)) return cudaErrorInvalidValue;
  const OutArgs a{static_cast<const float*>(g), static_cast<const float*>(midstats),
                  static_cast<const float*>(gmid), static_cast<const int8_t*>(wo),
                  static_cast<const float*>(so), x, y, static_cast<float*>(part),
                  static_cast<int*>(tickets), B, inner, dim, cols, col_blocks, splits, per};
  auto s = static_cast<cudaStream_t>(stream);
  const unsigned blocks = col_blocks * splits;
  const bool aligned = dim % 4 == 0;
  if (dtype == 0 && aligned)
    ff_out_kernel<float, ALIGNED><<<blocks, NT, 0, s>>>(a);
  else if (dtype == 0)
    ff_out_kernel<float, SHIFTED><<<blocks, NT, 0, s>>>(a);
  else if (aligned)
    ff_out_kernel<__nv_bfloat16, ALIGNED><<<blocks, NT, 0, s>>>(a);
  else
    ff_out_kernel<__nv_bfloat16, SHIFTED><<<blocks, NT, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}
