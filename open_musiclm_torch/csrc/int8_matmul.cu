// Kernel 4: weight-only int8 matmul,  out[B, N] = (x[B, K] @ W[K, N]) * scale[N].
//
// Replaces the Pallas kernel open_musiclm_tpu/ops/quant.py:int8_matmul
// (pallas_call at ops/quant.py:80, body _kernel :36-43). On the serving path
// it is the logit head of every decode step (x [B, 1024], W [1024, 1025]
// int8, a ragged output width of 1025); in the decode step with
// fused_ff=False it is every projection (1024 -> 512, 128 and 5460; 512 and
// 2730 -> 1024). x is float32 or bf16, the sums float32, the output x's type.
//
// What bounds it on the H100: bytes. The head is 1.05 MB of int8 weights
// read once a token against 2 * B * K * N FLOPs: at the decode batches (B up
// to 256 rows) below the card's ~295 FLOP/byte balance point, so the least
// time is the weights over 3.35 TB/s (0.31 us for the head), and what a
// design must avoid is a chain of dependent load -> barrier -> product
// rounds. Two routes, chosen by the wrapper (ops/quant.py:int8_route):
//   * stream (up to a few 8-row passes): kernel 3's int8 weight stream
//     (weight_stream.cuh). A block owns <= 128 consecutive columns (124 where
//     rows start off 4-byte alignment) and one split of the k rows, as
//     ops/weight_stream.py:stream_grid cuts them to fill the 132 SMs (the
//     head: 9 column blocks x 13 splits = 117 blocks). Warps read
//     whole-sector 4-byte words, two 16-row steps in flight and no barrier
//     in the k loop; the products run on the tensor cores (mma.sync m16n8k8
//     tf32, the weights as A, exact after a byte permute; 8 staged x rows as
//     B, float32 x split into tf32 hi + lo). Each block writes a float32
//     partial for its (pass, column block, split); the last block of a column
//     block (an atomic ticket after __threadfence, reset by that block) sums
//     the splits in split order and applies the scale, so the result is the
//     same bits every run. Rows beyond 8 take further passes over the same
//     weights (from L2).
//   * tiled (more rows): the stream's passes, partials and folds grow with
//     B, so 64-row x 64-column output tiles of 128 threads instead, k split
//     so that about two blocks an SM are busy (ops/quant.py:int8_tiled_grid;
//     the splits folded by ticket in split order, as the stream's): x as A
//     (bf16, or float32 as three bf16 parts hi + mid + lo, which hold its 24
//     significant bits), W dequantized to bf16 (exact) in a swizzled shared
//     tile as B, mma.sync m16n8k16, each 16-row k slice's sums added to the
//     total in float32; the next 64-row step's x and W are loaded into
//     registers while the current one computes.
// W's pointer may sit off a 4-byte boundary (a view into a stacked tensor):
// the wrapper passes the aligned base and the offset, and both routes
// address W's bytes from that base by aligned words.
#include <type_traits>

#include "weight_stream.cuh"

namespace {

struct Args {
  const void* x;
  const int8_t* w;  // 4-byte aligned; W[k][c] is byte w_off + k * N + c
  const float* scale;
  void* out;
  float* part;   // stream: [passes, col_blocks, splits, RB * SEG]; tiled: [splits, tiles, 64 * 64]
  int* tickets;  // [col_blocks] (stream) or [tiles] (tiled), 0 between launches
  int B, K, N, w_off, cols, col_blocks, splits, per, x_vec;
};

constexpr int REC = RB * SEG;  // floats of a stream block's partial

// Block b: column block b / splits, split b % splits; the last split of a
// column block to finish sums the splits in order and writes the output.
template <typename T, int MODE>
__global__ void __launch_bounds__(NT, 1) stream_kernel(Args a) {
  constexpr bool SPLIT = std::is_same<T, float>::value;
  __shared__ __align__(16) float hs[KC * RB];
  __shared__ __align__(16) float red[NW * RB * SEG];
  __shared__ int last;
  const int tid = threadIdx.x, warp = tid / 32, tq = tid % 4;
  const int cb = blockIdx.x / a.splits, s = blockIdx.x % a.splits, c0 = cb * a.cols;
  const Seg seg{a.w, a.N, a.w_off + static_cast<size_t>(a.K) * a.N, a.w_off + c0,
                min(a.cols, a.N - c0)};
  const int k0 = s * a.per, k1 = min(a.K, k0 + a.per);
  const T* x = static_cast<const T*>(a.x);
  for (int p = 0; p * RB < a.B; ++p) {
    float acc[NJ][4] = {};
    for (int kc0 = k0; kc0 < k1; kc0 += KC) {
      const int kc1 = min(k1, kc0 + KC);
      const int off =
          MODE == SHIFTED ? static_cast<int>((static_cast<size_t>(kc0 + tq) * a.N + seg.c0) & 3) : 0;
      unsigned buf[DEPTH][4][4];
      first_steps(seg, kc0, kc1, warp, NW, off, buf);  // in flight while the rows are staged
      for (int k = kc0 + tid; k < kc1; k += NT) {  // hs[k][r] = x[row][k], rows past B zero
        float h[RB];
#pragma unroll
        for (int r = 0; r < RB; ++r) {
          const int row = p * RB + r;
          h[r] = row < a.B ? omt::to_f32(__ldg(x + static_cast<size_t>(row) * a.K + k)) : 0.f;
        }
        store_row(hs + (k - kc0) * RB, h);
      }
      __syncthreads();
      stream_steps<MODE, NW, false, SPLIT>(seg, kc0, kc1, warp, off, buf, hs, nullptr, acc, acc);
      __syncthreads();
    }
    block_partial<1, false>(
        acc, acc, red, a.part + (static_cast<size_t>(p * a.col_blocks + cb) * a.splits + s) * REC);
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicAdd(a.tickets + cb, 1) == a.splits - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  const int cc = tid % SEG, rh = tid / SEG, c = c0 + cc;
  const bool ok = cc < a.cols && c < a.N;
  T* out = static_cast<T*>(a.out);
  const float sc = ok ? a.scale[c] : 0.f;
  for (int p = 0; p * RB < a.B; ++p) {  // rows rh + 2 i of each pass
    const float* pp[4] = {};
    float v[4] = {};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = p * RB + rh + 2 * i;
      if (!ok || row >= a.B) continue;
      pp[i] = a.part + static_cast<size_t>(p * a.col_blocks + cb) * a.splits * REC +
              (rh + 2 * i) * SEG + cc;
    }
    sum_splits<8, 4>(pp, REC, a.splits, v);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (pp[i] != nullptr)
        out[static_cast<size_t>(p * RB + rh + 2 * i) * a.N + c] = omt::from_f32<T>(v[i] * sc);
  }
  if (tid == 0) a.tickets[cb] = 0;  // ready for the next launch
}

// ---- the tiled route ----
constexpr int TT = 128;            // threads a tiled block, 16 output rows a warp
constexpr int TD = 64;             // rows, columns and k rows of a tile step
constexpr int TILE = TD * TD * 2;  // bytes of a swizzled 64 x 64 bf16 tile
constexpr int UNITS = TD * TD / 8 / TT;  // 8-element units of a tile a thread stages

// 8 consecutive x values of one row (rows ld apart), as loaded (zeros past
// row B or column K)
template <typename T>
struct XUnit;
template <>
struct XUnit<__nv_bfloat16> {
  uint4 u;  // bf16 bits
};
template <>
struct XUnit<float> {
  float4 a, b;
};

__device__ __forceinline__ void load_x(const __nv_bfloat16* x, int B, int K, int row, int k,
                                       bool vec, XUnit<__nv_bfloat16>& xu, int ld) {
  const __nv_bfloat16* p = x + static_cast<size_t>(row) * ld + k;
  if (row < B && vec && k + 8 <= K) {
    xu.u = __ldg(reinterpret_cast<const uint4*>(p));
    return;
  }
  unsigned h[8];
#pragma unroll
  for (int e = 0; e < 8; ++e)
    h[e] = row < B && k + e < K ? __bfloat16_as_ushort(__ldg(p + e)) : 0u;
  xu.u = make_uint4(h[0] | h[1] << 16, h[2] | h[3] << 16, h[4] | h[5] << 16, h[6] | h[7] << 16);
}

__device__ __forceinline__ void load_x(const float* x, int B, int K, int row, int k, bool vec,
                                       XUnit<float>& xu, int ld) {
  const float* p = x + static_cast<size_t>(row) * ld + k;
  if (row < B && vec && k + 8 <= K) {
    xu.a = __ldg(reinterpret_cast<const float4*>(p));
    xu.b = __ldg(reinterpret_cast<const float4*>(p) + 1);
    return;
  }
  float f[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) f[e] = row < B && k + e < K ? __ldg(p + e) : 0.f;
  xu.a = make_float4(f[0], f[1], f[2], f[3]);
  xu.b = make_float4(f[4], f[5], f[6], f[7]);
}

// a unit into its 16 bytes of the x tile(s): bf16 as it is; float32 as
// hi + mid + lo, three bf16 tiles TILE bytes apart, each part the bf16
// rounding of what the earlier parts leave (exact differences in float32)
__device__ __forceinline__ void store_x(unsigned char* at, const XUnit<__nv_bfloat16>& xu) {
  *reinterpret_cast<uint4*>(at) = xu.u;
}

__device__ __forceinline__ void store_x(unsigned char* at, const XUnit<float>& xu) {
  float r[8] = {xu.a.x, xu.a.y, xu.a.z, xu.a.w, xu.b.x, xu.b.y, xu.b.z, xu.b.w};
#pragma unroll
  for (int part = 0; part < 3; ++part) {
    unsigned u[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const __nv_bfloat162 v = __floats2bfloat162_rn(r[2 * e], r[2 * e + 1]);
      const float2 f = __bfloat1622float2(v);
      r[2 * e] -= f.x;
      r[2 * e + 1] -= f.y;
      u[e] = *reinterpret_cast<const unsigned*>(&v);
    }
    *reinterpret_cast<uint4*>(at + part * TILE) = make_uint4(u[0], u[1], u[2], u[3]);
  }
}

// The 8 bytes of W from byte e (of the aligned base), by aligned words.
__device__ __forceinline__ void load_w(const int8_t* w, size_t total, size_t e, unsigned (&u)[2]) {
  const size_t a0 = e & ~static_cast<size_t>(3);
  const unsigned sh = static_cast<unsigned>(e & 3), sel = 0x3210 + 0x1111 * sh;
  const unsigned w0 = load_word(w, a0, total), w1 = load_word(w, a0 + 4, total);
  const unsigned w2 = sh != 0 ? load_word(w, a0 + 8, total) : 0u;
  u[0] = __byte_perm(w0, w1, sel);
  u[1] = __byte_perm(w1, w2, sel);
}

// 8 int8 weights as 8 bf16 (exact) into their 16 bytes of the W tile
__device__ __forceinline__ void store_w(unsigned char* at, const unsigned (&u)[2]) {
  float f[8], g[4];
  i8x4_to_f32(u[0], g);
#pragma unroll
  for (int e = 0; e < 4; ++e) f[e] = g[e];
  i8x4_to_f32(u[1], g);
#pragma unroll
  for (int e = 0; e < 4; ++e) f[4 + e] = g[e];
  *reinterpret_cast<uint4*>(at) = make_uint4(omt::pack_bf16(f[0], f[1]), omt::pack_bf16(f[2], f[3]),
                                             omt::pack_bf16(f[4], f[5]), omt::pack_bf16(f[6], f[7]));
}

// Output rows [64 y, 64 y + 64) x columns [64 x, 64 x + 64) over split z of
// k (rows [z per, (z + 1) per)). Unit q = tid + 128 i of a step: x tile row
// q / 8, k 8 (q % 8); W tile k row q / 8, columns 8 (q % 8). With one split
// the block writes its tile; with more, each writes a float32 partial and
// the last of a tile's splits (an atomic ticket after __threadfence, reset
// by that block) sums them in split order and writes the tile.
template <typename T>
__global__ void __launch_bounds__(TT) tiled_kernel(Args a) {
  constexpr int PARTS = std::is_same<T, float>::value ? 3 : 1;
  __shared__ __align__(128) unsigned char xs[PARTS * TILE];  // [part][row][k]
  __shared__ __align__(128) unsigned char ws[TILE];          // [k][column]
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, mi = lane >> 3;
  const int r0 = blockIdx.y * TD, c0 = blockIdx.x * TD;
  const int k_begin = blockIdx.z * a.per, k_end = min(a.K, k_begin + a.per);
  const T* x = static_cast<const T*>(a.x);
  const size_t total = a.w_off + static_cast<size_t>(a.K) * a.N;
  XUnit<T> xr[UNITS];
  unsigned wr[UNITS][2];
  auto fetch = [&](int k0) {
#pragma unroll
    for (int i = 0; i < UNITS; ++i) {
      const int q = tid + TT * i, row = q / 8, col = (q % 8) * 8;
      load_x(x, a.B, k_end, r0 + row, k0 + col, a.x_vec != 0, xr[i], a.K);
      if (k0 + row < k_end)
        load_w(a.w, total, a.w_off + static_cast<size_t>(k0 + row) * a.N + c0 + col, wr[i]);
      else
        wr[i][0] = wr[i][1] = 0u;
    }
  };
  float acc[8][4] = {};
  fetch(k_begin);
  for (int k0 = k_begin; k0 < k_end; k0 += TD) {
#pragma unroll
    for (int i = 0; i < UNITS; ++i) {
      const int q = tid + TT * i, row = q / 8, col = (q % 8) * 8;
      store_x(xs + omt::swz(row, col), xr[i]);
      store_w(ws + omt::swz(row, col), wr[i]);
    }
    __syncthreads();
    if (k0 + TD < k_end) fetch(k0 + TD);  // in flight while this step computes
    const unsigned wt = omt::smem_addr(ws);
    // each 16-row k slice's products in an accumulator of their own, added
    // to acc in float32: the tensor cores' sums truncate, and a long chain
    // of them into one accumulator loses more than float32 rounding does
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      unsigned fa[PARTS][4];
#pragma unroll
      for (int part = 0; part < PARTS; ++part)
        omt::load_a(omt::smem_addr(xs + part * TILE), warp, ks, fa[part]);
      float slice[8][4] = {};
#pragma unroll
      for (int dp = 0; dp < 4; ++dp) {
        unsigned r[4];
        omt::ldmatrix_x4_trans(wt + omt::swz(ks * 16 + (mi & 1) * 8 + (lane & 7), dp * 16 + (mi >> 1) * 8),
                               r);
#pragma unroll
        for (int part = 0; part < PARTS; ++part) {
          omt::mma_bf16(slice[2 * dp], fa[part], r[0], r[1]);
          omt::mma_bf16(slice[2 * dp + 1], fa[part], r[2], r[3]);
        }
      }
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[nt][c] += slice[nt][c];
    }
    __syncthreads();
  }
  // C fragment: rows g and g + 8 of the warp's 16, columns 8 nt + 2 tq, + 1
  T* out = static_cast<T*>(a.out);
  const int g = lane / 4, tq = lane % 4;
  if (a.splits == 1) {
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int row = r0 + warp * 16 + g + 8 * (c >> 1), col = c0 + nt * 8 + 2 * tq + (c & 1);
        if (row < a.B && col < a.N)
          out[static_cast<size_t>(row) * a.N + col] = omt::from_f32<T>(acc[nt][c] * a.scale[col]);
      }
    }
    return;
  }
  // partial [split][tile][64 rows][64 columns]
  const int tile = blockIdx.y * a.col_blocks + blockIdx.x, tiles = gridDim.y * a.col_blocks;
  auto part_of = [&](int z) { return a.part + (static_cast<size_t>(z) * tiles + tile) * TD * TD; };
  float* mine = part_of(blockIdx.z);
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf)  // rows g and g + 8
      *reinterpret_cast<float2*>(mine + (warp * 16 + g + 8 * hf) * TD + nt * 8 + 2 * tq) =
          make_float2(acc[nt][2 * hf], acc[nt][2 * hf + 1]);
  __shared__ int last;
  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicAdd(a.tickets + tile, 1) == a.splits - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (int e = tid * 4; e < TD * TD; e += TT * 4) {  // four columns of a row at a time
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int z = 0; z < a.splits; ++z) {
      const float4 p = __ldcg(reinterpret_cast<const float4*>(part_of(z) + e));
      v.x += p.x;
      v.y += p.y;
      v.z += p.z;
      v.w += p.w;
    }
    const int row = r0 + e / TD, col = c0 + e % TD;
    const float f[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (row < a.B && col + u < a.N)
        out[static_cast<size_t>(row) * a.N + col + u] = omt::from_f32<T>(f[u] * a.scale[col + u]);
  }
  if (tid == 0) a.tickets[tile] = 0;  // ready for the next launch
}

template <typename T>
cudaError_t launch(const Args& a, int route, cudaStream_t s) {
  if (route == 1) {
    const dim3 grid(a.col_blocks, (a.B + TD - 1) / TD, a.splits);
    tiled_kernel<T><<<grid, TT, 0, s>>>(a);
  } else if (a.N % 4 == 0 && a.w_off == 0) {
    stream_kernel<T, ALIGNED><<<a.col_blocks * a.splits, NT, 0, s>>>(a);
  } else {
    stream_kernel<T, SHIFTED><<<a.col_blocks * a.splits, NT, 0, s>>>(a);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" const char* omt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// out [B, N] in x's type (dtype). W: the 4-byte aligned base `w` and the
// offset w_off (0-3) of W[0][0] from it. route 0, the stream: the grid from
// ops/weight_stream.py:stream_grid (col_blocks of `cols` columns, each split
// over `splits` ranges of `per` k rows; at most 124 columns when rows start
// off 4-byte alignment); scratch part [ceil(B / 8), col_blocks, splits,
// 8 * 128] float32 and tickets [col_blocks] int32 (0, and left 0). route 1,
// the tiled route (ops/quant.py:int8_tiled_grid): col_blocks tiles of 64
// columns x ceil(B / 64) of 64 rows, each split over `splits` ranges of `per`
// k rows (a multiple of 64); with more than one split, scratch part
// [splits, tiles, 64, 64] float32 and tickets [tiles] int32 (0, and left 0).
// x_vec when x's rows start 16-byte aligned (K a multiple of 8), so that 8
// values load as one.
extern "C" int omt_int8_matmul(const void* x, const void* w, int w_off, const void* scale, void* out,
                               void* part, void* tickets, int B, int K, int N, int cols,
                               int col_blocks, int splits, int per, int route, int x_vec,
                               int dtype, void* stream) {
  const bool aligned = N % 4 == 0 && w_off == 0;
  if (B <= 0 || K <= 0 || N <= 0 || w_off < 0 || w_off > 3 || (route != 0 && route != 1))
    return cudaErrorInvalidValue;
  if (route == 0 && (!grid_ok(K, N, cols, col_blocks, splits, per) || (!aligned && cols > SEG - 4)))
    return cudaErrorInvalidValue;
  if (route == 1 && (per <= 0 || per % TD != 0 || static_cast<long long>(splits) * per < K ||
                     static_cast<long long>(col_blocks) * TD < N))
    return cudaErrorInvalidValue;
  const Args a{x, static_cast<const int8_t*>(w), static_cast<const float*>(scale), out,
               static_cast<float*>(part), static_cast<int*>(tickets), B, K, N, w_off, cols,
               col_blocks, splits, per, x_vec};
  auto s = static_cast<cudaStream_t>(stream);
  const cudaError_t rc = dtype == 0 ? launch<float>(a, route, s) : launch<__nv_bfloat16>(a, route, s);
  return static_cast<int>(rc);
}
