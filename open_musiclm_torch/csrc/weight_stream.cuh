// The int8 weight stream shared by kernel 3 (fused_ff.cu) and kernel 4
// (int8_matmul.cu): a block's products of up to 8 staged activation rows
// with `cols` (<= 128) consecutive columns of an int8 [rows, ld] matrix in
// its [in, out] layout, over one split of the k rows.
//
// A warp takes 16 rows at a time, each row's 128-byte segment as 32 aligned
// 4-byte words (a lane the words of columns 4 g + 32 t, so that every load
// instruction reads whole sectors), DEPTH such steps in flight, no barrier
// inside the k loop. Rows that start off 4-byte alignment are shifted into
// place by a shuffle and a byte permute (SHIFTED). The products run on the
// tensor cores (mma.sync m16n8k8 tf32, the weights as A, exact after the
// byte permute; the staged rows as B, split into tf32 hi + lo for float32
// activations). block_partial sums the block's warps in order into a float32
// partial; sum_splits adds a column block's partials in split order, so a
// fold's result does not depend on which block finishes last.
//
// Everything here has internal linkage: each kernel source that includes it
// gets its own copy.
#pragma once

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
