// Tensor-core building blocks shared by the bf16 attention kernels
// (prefill_attention.cu: kernel 1; attention_bwd.cu: kernel 5) and, for
// mma_tf32, the int8 weight stream of kernel 3 (fused_ff.cu).
//
// Tiles of 64 rows x 64 bf16 columns (128 bytes a row) sit in shared memory
// with each 16-byte unit XOR-swizzled by its row, so that ldmatrix reads of
// eight rows at one column hit eight different bank groups. Products are
// mma.sync m16n8k16 bf16 -> float32; a warp's 16 x 8 C fragment holds rows
// g = lane / 4 and g + 8, columns 2 (lane % 4) and 2 (lane % 4) + 1.
#pragma once

#include "common.cuh"

namespace omt {

// byte offset of element (row, col) in a [64][64] bf16 tile whose 16-byte
// units are XOR-swizzled by row (col a multiple of 8)
__device__ __forceinline__ unsigned swz(int row, int col) {
  return row * 128 + ((((col >> 3) ^ row) & 7) << 4);
}

__device__ __forceinline__ void ldmatrix_x4(unsigned addr, unsigned (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldmatrix_x4_trans(unsigned addr, unsigned (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
// d += a (16x16 bf16, row) * b (16x8 bf16, col), float32 accumulators
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// d += a (16x8 tf32, row) * b (8x8 tf32, col), float32 accumulators; a
// thread's a holds rows g, g + 8 at columns tq, tq + 4 (a0 a1 at tq), b rows
// tq and tq + 4 of column g (g = lane / 4, tq = lane % 4)
__device__ __forceinline__ void mma_tf32(float (&d)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// x as hi + lo, two tf32 operands that hold 22 of its significant bits
__device__ __forceinline__ void split_tf32(float x, unsigned& hi, unsigned& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(x));
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(lo) : "f"(x - __uint_as_float(hi)));
}
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

// The A fragment of rows [16 w, 16 w + 16) x columns [16 ks, 16 ks + 16) of a
// swizzled tile (w: the calling warp's row block).
__device__ __forceinline__ void load_a(unsigned tile, int w, int ks, unsigned (&a)[4]) {
  const int lane = threadIdx.x % 32;
  ldmatrix_x4(tile + swz(w * 16 + (lane & 15), ks * 16 + (lane >> 4) * 8), a);
}

// acc[8][4] += A (16 x 64, four A fragments) . T^T, for a tile T stored
// [64 rows (the product's columns)][64] (the k dim along T's columns): the
// shape of q.k^T with K staged by key.
__device__ __forceinline__ void mma_a_bt(float (&acc)[8][4], const unsigned (&a)[4][4],
                                         unsigned tile) {
  const int lane = threadIdx.x % 32, mi = lane >> 3;
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      unsigned r[4];
      ldmatrix_x4(tile + swz(np * 16 + (mi >> 1) * 8 + (lane & 7), ks * 16 + (mi & 1) * 8), r);
      mma_bf16(acc[2 * np], a[ks], r[0], r[1]);
      mma_bf16(acc[2 * np + 1], a[ks], r[2], r[3]);
    }
  }
}

// acc[8][4] += P . T for P (16 x 64) given as C fragments p[8][4] (rounded
// to bf16 here) and a tile T stored [64 rows (the k dim)][64 columns]: the
// shape of p.v with V staged by key. C fragments of column groups 2 ks and
// 2 ks + 1 are the A fragment of k step ks.
__device__ __forceinline__ void mma_c_b(float (&acc)[8][4], const float (&p)[8][4],
                                        unsigned tile) {
  const int lane = threadIdx.x % 32, mi = lane >> 3;
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    const unsigned pa[4] = {pack_bf16(p[2 * ks][0], p[2 * ks][1]),
                            pack_bf16(p[2 * ks][2], p[2 * ks][3]),
                            pack_bf16(p[2 * ks + 1][0], p[2 * ks + 1][1]),
                            pack_bf16(p[2 * ks + 1][2], p[2 * ks + 1][3])};
#pragma unroll
    for (int dp = 0; dp < 4; ++dp) {
      unsigned r[4];
      ldmatrix_x4_trans(tile + swz(ks * 16 + (mi & 1) * 8 + (lane & 7), dp * 16 + (mi >> 1) * 8), r);
      mma_bf16(acc[2 * dp], pa, r[0], r[1]);
      mma_bf16(acc[2 * dp + 1], pa, r[2], r[3]);
    }
  }
}

// a pair of bias elements j, j + 1 of a row, kept in the bias's own type;
// load(): one load when paired, else j and (if ``second``) j + 1
template <typename B>
struct BiasPair;
template <>
struct BiasPair<float> {
  using T = float2;
  static __device__ __forceinline__ T zero() { return make_float2(0.f, 0.f); }
  static __device__ __forceinline__ T load(const float* p, bool paired, bool second) {
    if (paired) return __ldg(reinterpret_cast<const float2*>(p));
    return make_float2(__ldg(p), second ? __ldg(p + 1) : 0.f);
  }
  static __device__ __forceinline__ float2 f32(T v) { return v; }
};
template <>
struct BiasPair<__nv_bfloat16> {
  using T = __nv_bfloat162;
  static __device__ __forceinline__ T zero() { return __float2bfloat162_rn(0.f); }
  static __device__ __forceinline__ T load(const __nv_bfloat16* p, bool paired, bool second) {
    if (paired) return __ldg(reinterpret_cast<const __nv_bfloat162*>(p));
    return __halves2bfloat162(__ldg(p), second ? __ldg(p + 1) : __float2bfloat16(0.f));
  }
  static __device__ __forceinline__ float2 f32(T v) { return __bfloat1622float2(v); }
};

// The bias of one 64-key tile in the score fragment's layout (rows = the
// fragment's rows A and B, brow[x] their bias rows or null): [8 key groups
// of 8][row A, row B], keys 8 nt + 2 tq and 8 nt + 2 tq + 1.
template <typename B>
__device__ __forceinline__ void load_bias_frag(typename BiasPair<B>::T (&bfr)[8][2],
                                               const B* const (&brow)[2], int j0, int m,
                                               bool paired) {
  const int tq = threadIdx.x % 4;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    const int j = j0 + nt * 8 + 2 * tq;
#pragma unroll
    for (int x = 0; x < 2; ++x)
      bfr[nt][x] = brow[x] != nullptr && j < m ? BiasPair<B>::load(brow[x] + j, paired, j + 1 < m)
                                               : BiasPair<B>::zero();
  }
}

// ---- the causal mask with offset m - n and a bidirectional prefix ----

// one past the last key any row of queries [i0, i1) may see
__device__ __forceinline__ int visible_end(int i0, int i1, int n, int m, int causal, int ncp) {
  if (!causal) return m;
  int end = min(i1, n) - 1 + (m - n) + 1;
  if (i0 < ncp) end = max(end, ncp + (m - n));
  return min(end, m);
}

__device__ __forceinline__ bool causal_ok(int i, int j, int off, int causal, int ncp) {
  return !causal || j <= i + off || (i < ncp && j < ncp + off);
}

}  // namespace omt
