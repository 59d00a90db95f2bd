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
// rounds. One route at every row count, so that a row's sums fold in the
// same order whatever batch it rides in (ops/quant.py:int8_matmul): kernel
// 3's int8 weight stream (weight_stream.cuh). A block owns <= 128
// consecutive columns (124 where rows start off 4-byte alignment) and one
// split of the k rows, as ops/weight_stream.py:stream_grid cuts them to fill
// the 132 SMs (the head: 9 column blocks x 13 splits = 117 blocks). Warps
// read whole-sector 4-byte words, two 16-row steps in flight and no barrier
// in the k loop; the products run on the tensor cores (mma.sync m16n8k8
// tf32, the weights as A, exact after a byte permute; 8 staged x rows as B,
// float32 x split into tf32 hi + lo). Each block writes a float32 partial
// for its (pass, column block, split); the last block of a column block (an
// atomic ticket after __threadfence, reset by that block) sums the splits in
// split order and applies the scale, so the result is the same bits every
// run. Rows beyond 8 take further passes over the same weights (from L2).
// W's pointer may sit off a 4-byte boundary (a view into a stacked tensor):
// the wrapper passes the aligned base and the offset, and the kernel
// addresses W's bytes from that base by aligned words.
#include <type_traits>

#include "weight_stream.cuh"

namespace {

struct Args {
  const void* x;
  const int8_t* w;  // 4-byte aligned; W[k][c] is byte w_off + k * N + c
  const float* scale;
  void* out;
  float* part;   // [passes, col_blocks, splits, RB * SEG]
  int* tickets;  // [col_blocks], 0 between launches
  int B, K, N, w_off, cols, col_blocks, splits, per;
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

template <typename T>
cudaError_t launch(const Args& a, cudaStream_t s) {
  if (a.N % 4 == 0 && a.w_off == 0)
    stream_kernel<T, ALIGNED><<<a.col_blocks * a.splits, NT, 0, s>>>(a);
  else
    stream_kernel<T, SHIFTED><<<a.col_blocks * a.splits, NT, 0, s>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" const char* omt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// out [B, N] in x's type (dtype). W: the 4-byte aligned base `w` and the
// offset w_off (0-3) of W[0][0] from it. The grid from
// ops/weight_stream.py:stream_grid (col_blocks of `cols` columns, each split
// over `splits` ranges of `per` k rows; at most 124 columns when rows start
// off 4-byte alignment); scratch part [ceil(B / 8), col_blocks, splits,
// 8 * 128] float32 and tickets [col_blocks] int32 (0, and left 0).
extern "C" int omt_int8_matmul(const void* x, const void* w, int w_off, const void* scale, void* out,
                               void* part, void* tickets, int B, int K, int N, int cols,
                               int col_blocks, int splits, int per, int dtype, void* stream) {
  const bool aligned = N % 4 == 0 && w_off == 0;
  if (B <= 0 || K <= 0 || N <= 0 || w_off < 0 || w_off > 3)
    return cudaErrorInvalidValue;
  if (!grid_ok(K, N, cols, col_blocks, splits, per) || (!aligned && cols > SEG - 4))
    return cudaErrorInvalidValue;
  const Args a{x, static_cast<const int8_t*>(w), static_cast<const float*>(scale), out,
               static_cast<float*>(part), static_cast<int*>(tickets), B, K, N, w_off, cols,
               col_blocks, splits, per};
  const cudaError_t rc =
      dtype == 0 ? launch<float>(a, static_cast<cudaStream_t>(stream))
                 : launch<__nv_bfloat16>(a, static_cast<cudaStream_t>(stream));
  return static_cast<int>(rc);
}
