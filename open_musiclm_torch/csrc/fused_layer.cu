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
// What bounds it on the H100: latency, not bytes. A musiclm_small layer
// holds 9.6 MB of int8 weights (2.9 us at 3.35 TB/s) and ~0.17 GFLOP; but
// the layer is a chain of dependent phases, and its blocks must wait for
// each other between them. So this is one cooperative launch of one block
// an SM, its phases separated by four grid barriers (cooperative_groups
// grid.sync):
//   B  q and k|v projections
//   C  attention partials per chunk of cache rows; the block that finishes a
//      batch row's last chunk (atomic ticket after __threadfence, as kernel
//      2 does) folds the row's chunks and the fresh row (D) and writes the
//      quantized row
//   E  out-projection + residual   G  FF in-projections, conv, GEGLU
//   I  FF out-projection + residual
// The weights depend on no activation, and one layer's fit in the card's
// shared memory (72.5 KB a block for musiclm_small, 80.5 KB for
// musiclm_large). So each block asks at once, with 16-byte cp.async copies
// in four commit groups (one a product phase, in phase order; x's first
// rows are loaded between B's group and the others, so that they do not
// queue behind the stream), for its whole share of every product phase's
// weights and the LayerNorm gains; a phase waits for its own group only, and
// the stream runs under the barriers, the attention and the staging. Which
// output rows each block holds, where in shared memory, and how its warps
// cut them come from Python (ops/fused_layer.py: layer_plan) as an int32
// table; the kernel computes none of it. In a product phase the block
// stages the RT activation rows (one 1-D bulk copy a row, all asked for at
// once; a warp a row then takes its LayerNorm in a fixed order), then its
// warps take (group of NC output columns, k slice) items of the resident
// share so that every warp has work: a lane reads 4 weight bytes of each
// column and the RT rows' matching float4s, converts the bytes by a byte
// permute, and the item's NC x RT sums meet in a butterfly; the slices are
// summed in slice order, so every call gives the same bits. Rows beyond RT
// take further passes over the same resident share: no weight byte is read
// twice from device memory. The attention cuts each batch row's live cache
// into chunks sized (in Python) from pos alone, so that 8 rows' chunks fill
// the grid once and a row's chunks fold in one order in any batch.
// Intermediates (q, k|v, chunk partials, the attention output, x2, g) go to
// a float32 scratch the wrapper keeps per stream. Float32 CUDA-core FMAs
// throughout.
//
// Measured on the card (phase timestamps, PERF.md): the weights are in
// shared memory before every phase needs them; what is left is the chain
// itself (the four barriers, ~1.3 us each, the staging round trips, the
// attention's fold) and instruction fetch: each block runs most of this
// code once a launch, and code run once costs its fetch, ~0.1 us a 128-byte
// line. So the phases share short helpers that are not inlined (staging,
// LayerNorm, the product), and the staging is bulk copies, not unrolled
// loads.
#include "common.cuh"

#include <cooperative_groups.h>

namespace cg = cooperative_groups;

// the block's dynamic shared memory, named at file scope so that the phases'
// shared helpers (not inlined: one copy of their code serves every phase)
// still address it as shared memory
extern __shared__ __align__(16) unsigned char layer_smem[];

namespace {

template <typename V = float>
__device__ __forceinline__ V* sh(int off) {
  return reinterpret_cast<V*>(layer_smem + off);
}

// ops/fused_layer.py holds the same constants (LAYER_*, DIM_HEAD, MAX_HEADS,
// ATTN_MAX_CHUNK, PLAN_HEADER, PLAN_PER_BLOCK)
constexpr int D = 64;          // dim_head
constexpr int NT = 256;        // threads a block, one block an SM
constexpr int NW = NT / 32;    // warps a block
constexpr int RT = 8;          // activation rows a pass
constexpr int NC = 4;          // output columns of one warp item
constexpr int STEP = 128;      // bytes of a weight row a warp reads at a time
constexpr int CHMAX = 128;     // cache rows of one attention item at most
constexpr int PW = D + 2;      // partial record: max, denominator, 64 sums
constexpr int MAXH = 16;       // heads the attention phases take
constexpr int NPH = 4;         // product phases B, E, G, I
constexpr int HDR = 11;        // plan header: share, gain, stage, part, mbarrier offsets, smem
constexpr int PER_BLOCK = 3 * NPH;  // (first unit, units, k slices) a phase
constexpr int KV_LOADS = CHMAX * 8 / NT;     // 16-byte cache loads a thread, attention item
constexpr int BIAS_LOADS = CHMAX * MAXH / NT;  // bias loads a thread, attention item
static_assert(NC * RT == 32, "a warp item's sums are one value a lane");
static_assert(NW == RT, "one warp a staged row for its LayerNorm");
static_assert(KV_LOADS * NT == CHMAX * 8 && BIAS_LOADS * NT == CHMAX * MAXH, "item loads");
static_assert(CHMAX <= NT, "one thread a cache row for scales and mask");

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
  float* krow;
  float *q_raw, *kv_raw, *attn, *x2, *g, *part;
  const int* plan;
  int* tickets;  // [b], 0 between launches
  int b, heads, dim, inner, inner_p, N, pos, chunk, n_chunks;
  float scale;
};

// One product phase's resident share: R rows of K int8 bytes (output-major)
// at byte w of shared memory; columns < split read the activations A0, the
// rest A1 (phase B: q from LN(x), k|v from x); slices k slices a column group.
struct Share {
  int w, K, R, split, slices;
};

// bytes [0, bytes) of src into dst, 16 at a time, spread over the block
__device__ __forceinline__ void prefetch(int8_t* dst, const int8_t* src, int bytes) {
  for (int i = threadIdx.x * 16; i < bytes; i += NT * 16) omt::cp_async16(dst + i, src + i);
}

// n floats of src into dst (a last partial run zero-filled)
__device__ __forceinline__ void prefetch_f32(float* dst, const float* src, int n) {
  for (int i = threadIdx.x * 4; i < n; i += NT * 4) omt::cp_async16(dst + i, src + i, min(16, 4 * (n - i)));
}

// the block's mbarrier for the staging copies (1-D bulk copies, which
// complete on it and not in the weights' cp.async groups)
__device__ __forceinline__ void mbar_init(unsigned bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_expect(unsigned bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void bulk_copy(unsigned dst, const void* src, int bytes, unsigned bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}
__device__ __forceinline__ void mbar_wait(unsigned bar, int parity) {
  asm volatile(
      "{\n .reg .pred P1;\n LAB_WAIT:\n"
      " mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      " @P1 bra DONE;\n bra LAB_WAIT;\n DONE:\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// Stages rows r0 .. r0 + RT of src (bf16 or float32 elements, row stride
// ld elements, K elements a row) into As [RT][K] float, zero at k >= width
// and at rows >= b. One thread asks for all the pass's rows at once, one
// 1-D bulk copy a row (bf16 rows land beyond As and the block widens them);
// the block waits on the mbarrier at bar_off (parity: its uses so far, mod
// 2), then zero-fills.
__device__ __noinline__ void stage(int as, const void* __restrict__ src, bool bf16, int ld,
                                   int width, int K, int r0, int b, int bar_off, int parity) {
  float* As = sh(as);
  const int esize = bf16 ? 2 : 4, rows = min(RT, b - r0);
  const int dst = bf16 ? as + 4 * RT * K : as;
  const unsigned bar = omt::smem_addr(sh<char>(bar_off));
  if (threadIdx.x == 0) {
    // the rows were written by other blocks (generic stores) before a grid
    // barrier, and the staging region was last used by generic accesses
    asm volatile("fence.proxy.async;\n" ::: "memory");
    mbar_expect(bar, rows * K * esize);
    for (int r = 0; r < rows; ++r)
      bulk_copy(omt::smem_addr(sh<char>(dst + r * K * esize)),
                static_cast<const char*>(src) + (size_t)(r0 + r) * ld * esize, K * esize, bar);
  }
  mbar_wait(bar, parity);
  if (bf16) {
    const unsigned* raw = sh<const unsigned>(dst);
    for (int i = threadIdx.x; i < rows * K / 2; i += NT) {
      const unsigned w = raw[i];
      As[2 * i] = __uint_as_float(w << 16);
      As[2 * i + 1] = __uint_as_float(w & 0xffff0000u);
    }
  }
  for (int i = rows * K + threadIdx.x; i < RT * K; i += NT) As[i] = 0.f;
  if (width < K) {
    for (int i = threadIdx.x; i < rows * (K - width); i += NT) {
      const int r = i / (K - width);
      As[r * K + width + i - r * (K - width)] = 0.f;
    }
  }
  __syncthreads();
}

// LayerNorm of the RT staged rows at as into dst (dst may be as), warp r
// on row r in a fixed order: mu, then var, then (v - mu) / sqrt(var +
// 1e-5) * gain[k] for k < n and 0 beyond. mid: var = E[v^2] - mu^2 over n
// elements (the staged rows are zero from n to K); otherwise the two-pass
// E[(v - mu)^2] over n = K.
__device__ __noinline__ void layer_norm(int as, int dst_off, int K, int n, int gain_off, bool mid) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;
  const float* a = sh(as) + warp * K;
  float* dst = sh(dst_off) + warp * K;
  const float* gain = sh(gain_off);
  float s = 0.f, s2 = 0.f;
  for (int k = lane * 4; k < K; k += 128) {
    const float4 v = *reinterpret_cast<const float4*>(a + k);
    s += (v.x + v.y) + (v.z + v.w);
    s2 += (v.x * v.x + v.y * v.y) + (v.z * v.z + v.w * v.w);
  }
  const float mu = omt::warp_sum(s) / n;
  float var;
  if (mid) {
    var = omt::warp_sum(s2) / n - mu * mu;
  } else {
    float d2 = 0.f;
    for (int k = lane * 4; k < K; k += 128) {
      const float4 v = *reinterpret_cast<const float4*>(a + k);
      const float dx = v.x - mu, dy = v.y - mu, dz = v.z - mu, dw = v.w - mu;
      d2 += (dx * dx + dy * dy) + (dz * dz + dw * dw);
    }
    var = omt::warp_sum(d2) / n;
  }
  const float rs = rsqrtf(var + 1e-5f);
  for (int k = lane * 4; k < K; k += 128) {
    float4 v = *reinterpret_cast<const float4*>(a + k);
    v.x = k < n ? (v.x - mu) * rs * gain[k] : 0.f;
    v.y = k + 1 < n ? (v.y - mu) * rs * gain[k + 1] : 0.f;
    v.z = k + 2 < n ? (v.z - mu) * rs * gain[k + 2] : 0.f;
    v.w = k + 3 < n ? (v.w - mu) * rs * gain[k + 3] : 0.f;
    *reinterpret_cast<float4*>(dst + k) = v;
  }
  __syncthreads();
}

// four int8 in a word as floats: 0x4B0000uu is 2^23 + uu, uu the byte + 128
__device__ __forceinline__ float4 bytes_to_f4(int word) {
  const unsigned u = static_cast<unsigned>(word) ^ 0x80808080u;
  constexpr float kOff = 8388736.f;  // 2^23 + 128
  return make_float4(__int_as_float(__byte_perm(u, 0x4B000000u, 0x7440)) - kOff,
                     __int_as_float(__byte_perm(u, 0x4B000000u, 0x7441)) - kOff,
                     __int_as_float(__byte_perm(u, 0x4B000000u, 0x7442)) - kOff,
                     __int_as_float(__byte_perm(u, 0x4B000000u, 0x7443)) - kOff);
}

// One level of the butterfly: lanes that differ in bit H swap halves of
// their 2H values and each keeps the sum of one half.
template <int H>
__device__ __forceinline__ void fold_half(float (&v)[NC * RT], int lane) {
  const bool up = lane & H;
#pragma unroll
  for (int i = 0; i < H; ++i) {
    const float send = up ? v[i] : v[i + H];
    const float keep = up ? v[i + H] : v[i];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, send, H);
  }
}

__device__ __forceinline__ int first_groups(const Share& s) { return (s.split + NC - 1) / NC; }

// The block's warps take the share's items (column group, k slice): groups
// of NC columns of A0's columns, then of A1's; a slice is a run of the
// share's STEP-byte steps. A lane reads 4 bytes of each of the group's rows
// and the RT activation rows' matching float4s (a warp's reads are 128 and
// 512 consecutive bytes: no bank conflicts). The item's NC x RT sums meet in
// a butterfly that leaves lane l with (column l / RT, row l % RT), written to
// part[item * 32 + l]. Ends with __syncthreads.
__device__ __noinline__ void product(const Share s, int a0, int a1, int part_off) {
  const float* A0 = sh(a0);
  const float* A1 = sh(a1);
  float* part = sh(part_off);
  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;
  const int g0 = first_groups(s);
  const int groups = g0 + (s.R - s.split + NC - 1) / NC;
  const int steps = (s.K + STEP - 1) / STEP;
  for (int it = warp; it < groups * s.slices; it += NW) {
    const int grp = it / s.slices, sl = it - grp * s.slices;
    const int c0 = grp < g0 ? grp * NC : s.split + (grp - g0) * NC;
    const int nc = min(NC, (grp < g0 ? s.split : s.R) - c0);
    const float* A = grp < g0 ? A0 : A1;
    const int8_t* w = sh<const int8_t>(s.w) + c0 * s.K;
    float acc[NC * RT];
#pragma unroll
    for (int i = 0; i < NC * RT; ++i) acc[i] = 0.f;
    const int st1 = (sl + 1) * steps / s.slices;
    for (int st = sl * steps / s.slices; st < st1; ++st) {
      const int k = st * STEP + lane * 4;
      if (k < s.K) {
        float4 a[RT];
#pragma unroll
        for (int r = 0; r < RT; ++r) a[r] = *reinterpret_cast<const float4*>(A + r * s.K + k);
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const int word = c < nc ? *reinterpret_cast<const int*>(w + c * s.K + k) : 0;
          const float4 f = bytes_to_f4(word);
#pragma unroll
          for (int r = 0; r < RT; ++r) {
            float v = acc[c * RT + r];
            v = fmaf(a[r].x, f.x, v);
            v = fmaf(a[r].y, f.y, v);
            v = fmaf(a[r].z, f.z, v);
            v = fmaf(a[r].w, f.w, v);
            acc[c * RT + r] = v;
          }
        }
      }
    }
    fold_half<16>(acc, lane);
    fold_half<8>(acc, lane);
    fold_half<4>(acc, lane);
    fold_half<2>(acc, lane);
    fold_half<1>(acc, lane);
    part[it * 32 + lane] = acc[0];
  }
  __syncthreads();
}

// column c of the share, row r of the pass: its slices' sums in slice order
__device__ __forceinline__ float col_sum(const Share& s, int part_off, int c, int r) {
  const float* part = sh(part_off);
  const bool a = c < s.split;
  const int grp = a ? c / NC : first_groups(s) + (c - s.split) / NC;
  const int cc = a ? c % NC : (c - s.split) % NC;
  const float* q = part + grp * s.slices * 32 + cc * RT + r;
  float v = 0.f;
  for (int sl = 0; sl < s.slices; ++sl) v += q[sl * 32];
  return v;
}

// l2norm(v) * mul of one 64-vector held two elements a lane
__device__ __forceinline__ void unit(float& v0, float& v1, const float* __restrict__ mul) {
  const int lane = threadIdx.x & 31;
  const float n = fmaxf(sqrtf(omt::warp_sum(v0 * v0 + v1 * v1)), 1e-12f);
  v0 = v0 / n * __ldg(mul + lane);
  v1 = v1 / n * __ldg(mul + lane + 32);
}

__device__ __forceinline__ int8_t quant(float v, float s) {
  return static_cast<int8_t>(fminf(fmaxf(rintf(v / s), -127.f), 127.f));
}

template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return omt::to_f32(omt::from_f32<T>(v));
}

// The attention output of batch row r, head h: the chunks' partials and
// the fresh row folded in one softmax; head 0 also writes krow and the
// fresh row, quantized, into the cache at pos. One warp.
template <typename T>
__device__ __forceinline__ void fold_row(const Params<T>& p, int r, int h) {
  const int lane = threadIdx.x & 31, heads = p.heads, hd = heads * D, b = p.b;
  {
    constexpr int PRE = 16;  // chunks whose sums load with the first loads
    const int nch = p.n_chunks;
    const float* rec0 = p.part + (size_t)r * nch * heads * PW + h * PW;
    const size_t cs = (size_t)heads * PW;  // from one chunk's record to the next
    // every load that waits for nothing first: the row's k|v and q, lane c's
    // chunk max and denominator, the first PRE chunks' sums
    float k0 = __ldcg(p.kv_raw + (size_t)r * 2 * D + lane);
    float k1 = __ldcg(p.kv_raw + (size_t)r * 2 * D + lane + 32);
    const float v0 = __ldcg(p.kv_raw + (size_t)r * 2 * D + D + lane);
    const float v1 = __ldcg(p.kv_raw + (size_t)r * 2 * D + D + lane + 32);
    float q0 = __ldcg(p.q_raw + (size_t)r * hd + h * D + lane);
    float q1 = __ldcg(p.q_raw + (size_t)r * hd + h * D + lane + 32);
    float mx = -INFINITY, lx = 0.f;
    if (lane < nch) {
      mx = __ldcg(rec0 + lane * cs);
      lx = __ldcg(rec0 + lane * cs + 1);
    }
    float s0[PRE], s1[PRE];
#pragma unroll
    for (int t = 0; t < PRE; ++t) {
      s0[t] = t < nch ? __ldcg(rec0 + t * cs + 2 + lane) : 0.f;
      s1[t] = t < nch ? __ldcg(rec0 + t * cs + 2 + 32 + lane) : 0.f;
    }
    unit(k0, k1, p.k_scale);
    unit(q0, q1, p.q_scale);
    const float self = omt::warp_sum(q0 * k0 + q1 * k1) * p.scale + __ldg(p.bias_row + (size_t)p.pos * heads + h);
    float m = fmaxf(self, mx);
    for (int c = lane + 32; c < nch; c += 32) m = fmaxf(m, __ldcg(rec0 + c * cs));
    m = omt::warp_max(m);
    const float pself = expf(self - m);
    float l = pself, a0 = pself * v0, a1 = pself * v1;
    for (int cb = 0; cb < nch; cb += 32) {  // chunks in order, 32 weights at a time
      float f = 0.f, lc = 0.f;
      if (cb == 0) {
        f = lane < nch ? expf(mx - m) : 0.f;
        lc = lx * f;
      } else if (cb + lane < nch) {
        f = expf(__ldcg(rec0 + (cb + lane) * cs) - m);
        lc = __ldcg(rec0 + (cb + lane) * cs + 1) * f;
      }
      l += omt::warp_sum(lc);
      const int n = min(32, nch - cb);
      if (cb == 0) {
#pragma unroll
        for (int t = 0; t < PRE; ++t) {
          const float ft = __shfl_sync(0xffffffffu, f, t);
          a0 = fmaf(s0[t], ft, a0);
          a1 = fmaf(s1[t], ft, a1);
        }
      }
      for (int j0 = cb == 0 ? PRE : 0; j0 < n; j0 += 8) {  // 8 chunks' sums loaded before any is used
        float t0[8], t1[8];
#pragma unroll
        for (int t = 0; t < 8; ++t) {
          const float* rec = rec0 + (cb + j0 + t) * cs;
          t0[t] = j0 + t < n ? __ldcg(rec + 2 + lane) : 0.f;
          t1[t] = j0 + t < n ? __ldcg(rec + 2 + 32 + lane) : 0.f;
        }
#pragma unroll
        for (int t = 0; t < 8; ++t) {
          const float ft = __shfl_sync(0xffffffffu, f, (j0 + t) & 31);
          a0 = fmaf(t0[t], ft, a0);
          a1 = fmaf(t1[t], ft, a1);
        }
      }
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
}

template <typename T>
__global__ void __launch_bounds__(NT, 1) fused_layer_kernel(const Params<T> p) {
  cg::grid_group grid = cg::this_grid();
  const int tid = threadIdx.x, warp = tid / 32, lane = tid & 31;
  const int b = p.b, heads = p.heads, dim = p.dim, hd = p.heads * D, inner = p.inner,
            inner_p = p.inner_p;

  // ---- the plan: this block's (first unit, units, slices) per phase ----
  const int* mine = p.plan + HDR + blockIdx.x * PER_BLOCK;
  int first[NPH], units[NPH], slices[NPH];
#pragma unroll
  for (int ph = 0; ph < NPH; ++ph) {
    first[ph] = __ldg(mine + 3 * ph);
    units[ph] = __ldg(mine + 3 * ph + 1);
    slices[ph] = __ldg(mine + 3 * ph + 2);
  }
  int share[NPH];  // byte offsets in shared memory
#pragma unroll
  for (int ph = 0; ph < NPH; ++ph) share[ph] = __ldg(p.plan + ph);
  const int gamma_s = __ldg(p.plan + 4), gin_s = __ldg(p.plan + 5), gmid_s = __ldg(p.plan + 6);
  const int stage_o = __ldg(p.plan + 7), part = __ldg(p.plan + 8), bar = __ldg(p.plan + 9);
  float* stage_s = sh(stage_o);
  int staged = 0;  // uses of the staging mbarrier: its parity
  if (tid == 0) mbar_init(omt::smem_addr(sh<char>(bar)));
  __syncthreads();
  const int nq = max(0, min(units[0], hd - first[0]));  // B's q rows; the rest are k|v rows

  // ---- A: ask for every phase's weight share now, one commit group a phase;
  //      x's first rows are loaded between B's share and the rest, so that
  //      they do not queue behind the whole stream ----
  const int X = stage_o;                  // x rows
  const int XN = stage_o + 4 * RT * dim;  // LN(x) rows
  constexpr bool kBf16 = sizeof(T) == 2;
  prefetch(sh<int8_t>(share[0]), p.wqT + (size_t)first[0] * dim, nq * dim);
  prefetch(sh<int8_t>(share[0] + nq * dim), p.wkvT + (size_t)max(0, first[0] - hd) * dim,
           (units[0] - nq) * dim);
  prefetch_f32(sh(gamma_s), p.gamma, dim);
  omt::cp_async_commit();
  stage(X, p.x, kBf16, dim, dim, dim, 0, b, bar, staged++ & 1);
  prefetch(sh<int8_t>(share[1]), p.woT + (size_t)first[1] * hd, units[1] * hd);
  omt::cp_async_commit();
  prefetch(sh<int8_t>(share[2]), p.wvT + (size_t)first[2] * dim, units[2] * dim);
  prefetch(sh<int8_t>(share[2] + units[2] * dim), p.wgT + (size_t)first[2] * dim, units[2] * dim);
  prefetch_f32(sh(gin_s), p.gin, dim);
  omt::cp_async_commit();
  prefetch(sh<int8_t>(share[3]), p.ff_woT + (size_t)first[3] * inner_p, units[3] * inner_p);
  prefetch_f32(sh(gmid_s), p.gmid, inner);
  omt::cp_async_commit();

  // ---- B: q = LN(x) @ Wq * sq, k|v = x @ Wkv * skv ----
  {
    const Share s{share[0], dim, units[0], nq, slices[0]};
    omt::cp_async_wait<3>();
    for (int r0 = 0; r0 < b; r0 += RT) {
      if (r0 > 0) stage(X, p.x, kBf16, dim, dim, dim, r0, b, bar, staged++ & 1);
      layer_norm(X, XN, dim, dim, gamma_s, false);
      product(s, XN, X, part);
      for (int i = tid; i < s.R * RT; i += NT) {
        const int c = i / RT, r = i % RT, row = r0 + r;
        if (row >= b) continue;
        const float v = col_sum(s, part, c, r);
        const int col = first[0] + c;
        if (col < hd) p.q_raw[(size_t)row * hd + col] = v * __ldg(p.sq + col);
        else p.kv_raw[(size_t)row * 2 * D + col - hd] = v * __ldg(p.skv + col - hd);
      }
      __syncthreads();  // part is read before the next pass writes it
    }
  }
  grid.sync();

  // ---- C: attention partials of each (batch row, chunk of the rows < pos) ----
  {
    float(*ks)[D + 1] = reinterpret_cast<float(*)[D + 1]>(stage_s);
    float(*vs)[D + 1] = reinterpret_cast<float(*)[D + 1]>(stage_s + CHMAX * (D + 1));
    float* ksc = stage_s + 2 * CHMAX * (D + 1);
    float* vsc = ksc + CHMAX;
    float(*qs)[D] = reinterpret_cast<float(*)[D]>(vsc + CHMAX);
    float(*ps)[CHMAX] = reinterpret_cast<float(*)[CHMAX]>(vsc + CHMAX + MAXH * D);
    float* bs = vsc + CHMAX + MAXH * D + NW * CHMAX;  // bias rows [nk, heads]
    float* ms = bs + CHMAX * MAXH;                     // key mask [nk]
    int* last = sh<int>(bar + 8);  // beside the mbarrier
    const int n_items = max(1, p.n_chunks);  // at pos 0 an item of no rows still folds its row
    for (int item = blockIdx.x; item < b * n_items; item += gridDim.x) {
      const int r = item / n_items, c = item % n_items;
      const int c0 = c * p.chunk, nk = max(0, min(p.chunk, p.pos - c0));
      __syncthreads();  // the previous item's reads are done
      if (nk > 0) {
        // every load of the item first: the rows' 16-byte runs (K in the
        // first 4 of a row's 8), the scales, the bias rows, the mask, q
        const int4* kvb = reinterpret_cast<const int4*>(p.kv + ((size_t)r * p.N + c0) * 2 * D);
        int4 kvv[KV_LOADS];
#pragma unroll
        for (int i = 0; i < KV_LOADS; ++i) {
          const int v = tid + i * NT;
          if (v < nk * 8) kvv[i] = __ldg(kvb + v);
        }
        const float* bsrc = p.bias_row + (size_t)c0 * heads;
        float bv[BIAS_LOADS];
#pragma unroll
        for (int i = 0; i < BIAS_LOADS; ++i) {
          const int v = tid + i * NT;
          if (v < nk * heads) bv[i] = __ldg(bsrc + v);
        }
        float kscv = 0.f, vscv = 0.f, mv = 0.f;
        if (tid < nk) {
          kscv = __ldg(p.kv_scale + (size_t)r * p.N + c0 + tid);
          vscv = __ldg(p.kv_scale + ((size_t)b + r) * p.N + c0 + tid);
          mv = __ldg(p.add_mask + (size_t)r * p.N + c0 + tid);
        }
        float qv[MAXH / NW][2];
#pragma unroll
        for (int t = 0; t < MAXH / NW; ++t) {
          const int h = warp + t * NW;
          if (h < heads) {
            qv[t][0] = __ldcg(p.q_raw + (size_t)r * hd + h * D + lane);
            qv[t][1] = __ldcg(p.q_raw + (size_t)r * hd + h * D + lane + 32);
          }
        }
#pragma unroll
        for (int i = 0; i < KV_LOADS; ++i) {
          const int v = tid + i * NT;
          if (v < nk * 8) {
            const int j = v / 8, e0 = (v % 8) * 16;
            float* dst = e0 < D ? &ks[j][e0] : &vs[j][e0 - D];
            const int words[4] = {kvv[i].x, kvv[i].y, kvv[i].z, kvv[i].w};
#pragma unroll
            for (int t = 0; t < 4; ++t) {
              const char4 q = *reinterpret_cast<const char4*>(&words[t]);
              dst[4 * t] = q.x;
              dst[4 * t + 1] = q.y;
              dst[4 * t + 2] = q.z;
              dst[4 * t + 3] = q.w;
            }
          }
        }
#pragma unroll
        for (int i = 0; i < BIAS_LOADS; ++i) {
          const int v = tid + i * NT;
          if (v < nk * heads) bs[v] = bv[i];
        }
        if (tid < nk) {
          ksc[tid] = kscv;
          vsc[tid] = vscv;
          ms[tid] = mv;
        }
#pragma unroll
        for (int t = 0; t < MAXH / NW; ++t) {
          const int h = warp + t * NW;
          if (h < heads) {
            unit(qv[t][0], qv[t][1], p.q_scale);
            qs[h][lane] = qv[t][0];
            qs[h][lane + 32] = qv[t][1];
          }
        }
        __syncthreads();
        for (int h = warp; h < heads; h += NW) {
          float m = -INFINITY;
          for (int j = lane; j < nk; j += 32) {
            float dot = 0.f;
#pragma unroll 16
            for (int e = 0; e < D; ++e) dot = fmaf(qs[h][e], ks[j][e], dot);
            const float sc = dot * ksc[j] * p.scale + bs[j * heads + h] + ms[j];
            ps[warp][j] = sc;
            m = fmaxf(m, sc);
          }
          m = omt::warp_max(m);
          float l = 0.f;
          for (int j = lane; j < nk; j += 32) {
            const float e = expf(ps[warp][j] - m);
            l += e;
            ps[warp][j] = e * vsc[j];
          }
          l = omt::warp_sum(l);
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
          __syncwarp();  // this head's reads of ps are done before the next head's writes
        }
      }
      // ---- D: the block that finishes a batch row's last item folds the
      //      row's chunks and the fresh row together, one warp a head ----
      __threadfence();  // the partials are visible before the ticket is taken
      __syncthreads();
      if (tid == 0) *last = atomicAdd(p.tickets + r, 1) == n_items - 1;
      __syncthreads();
      if (!*last) continue;
      __threadfence();
      for (int h = warp; h < heads; h += NW) fold_row(p, r, h);
      if (tid == 0) p.tickets[r] = 0;  // ready for the next launch
    }
  }
  grid.sync();

  // ---- E: x2 = x + (attn @ Wo) * so, rounded to x's dtype ----
  {
    const Share s{share[1], hd, units[1], units[1], slices[1]};
    omt::cp_async_wait<2>();
    for (int r0 = 0; r0 < b; r0 += RT) {
      stage(stage_o, p.attn, false, hd, hd, hd, r0, b, bar, staged++ & 1);
      product(s, stage_o, stage_o, part);
      for (int i = tid; i < s.R * RT; i += NT) {
        const int c = i / RT, r = i % RT, row = r0 + r;
        if (row >= b) continue;
        const int col = first[1] + c;
        const size_t at = (size_t)row * dim + col;
        p.x2[at] = round_to<T>(omt::to_f32(p.x[at]) + col_sum(s, part, c, r) * __ldg(p.so + col));
      }
      __syncthreads();
    }
  }
  grid.sync();

  // ---- G: u = LN(x2) @ Wv|Wg * sv|sg, conv over the state, GEGLU ----
  {
    const int n = units[2];  // pairs: the share holds their v rows, then their g rows
    const Share s{share[2], dim, 2 * n, 2 * n, slices[2]};
    omt::cp_async_wait<1>();
    for (int r0 = 0; r0 < b; r0 += RT) {
      stage(stage_o, p.x2, false, dim, dim, dim, r0, b, bar, staged++ & 1);
      layer_norm(stage_o, stage_o, dim, dim, gin_s, false);
      product(s, stage_o, stage_o, part);
      for (int i = tid; i < n * RT; i += NT) {
        const int j = i / RT, r = i % RT, row = r0 + r;
        if (row >= b) continue;
        const int c = first[2] + j;
        const float uv = col_sum(s, part, j, r) * __ldg(p.sv + c);
        const float ug = col_sum(s, part, n + j, r) * __ldg(p.sg + c);
        T* s0 = p.state + (size_t)row * 4 * inner;  // state[row, 0, :]
        T* s1 = s0 + 2 * inner;                     // state[row, 1, :]
        const float s0v = omt::to_f32(s0[c]), s1v = omt::to_f32(s1[c]);
        const float s0g = omt::to_f32(s0[inner + c]), s1g = omt::to_f32(s1[inner + c]);
        const float cv = s0v * __ldg(p.conv_v + c) + s1v * __ldg(p.conv_v + inner + c) +
                         uv * __ldg(p.conv_v + 2 * inner + c);
        const float cgv = s0g * __ldg(p.conv_g + c) + s1g * __ldg(p.conv_g + inner + c) +
                          ug * __ldg(p.conv_g + 2 * inner + c);
        const float gelu = 0.5f * cgv * (1.f + erff(cgv * 0.7071067811865476f));
        p.g[(size_t)row * inner_p + c] = gelu * cv;
        s0[c] = s1[c];
        s0[inner + c] = s1[inner + c];
        s1[c] = omt::from_f32<T>(uv);
        s1[inner + c] = omt::from_f32<T>(ug);
      }
      __syncthreads();
    }
  }
  grid.sync();

  // ---- I: y = x2 + (midLN(g) @ Wout) * so ----
  {
    const Share s{share[3], inner_p, units[3], units[3], slices[3]};
    omt::cp_async_wait<0>();
    for (int r0 = 0; r0 < b; r0 += RT) {
      stage(stage_o, p.g, false, inner_p, inner, inner_p, r0, b, bar, staged++ & 1);
      layer_norm(stage_o, stage_o, inner_p, inner, gmid_s, true);
      product(s, stage_o, stage_o, part);
      for (int i = tid; i < s.R * RT; i += NT) {
        const int c = i / RT, r = i % RT, row = r0 + r;
        if (row >= b) continue;
        const int col = first[3] + c;
        const size_t at = (size_t)row * dim + col;
        p.y[at] = omt::from_f32<T>(__ldcg(p.x2 + at) + col_sum(s, part, c, r) * __ldg(p.ff_so + col));
      }
      __syncthreads();
    }
  }
}


// A cooperative launch of `grid` blocks needs them all resident at once:
// checked once per shared-memory size and device (host calls cost tens of us).
template <typename T>
int launch(const Params<T>& p, int grid, int smem, cudaStream_t s) {
  static int cached_smem = -1, cached_dev = -1, cached_fit = 0;
  auto fn = fused_layer_kernel<T>;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess && (smem != cached_smem || dev != cached_dev)) {
    int sms = 0, per_sm = 0;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess) e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e == cudaSuccess) e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, NT, smem);
    if (e == cudaSuccess) {
      cached_smem = smem;
      cached_dev = dev;
      cached_fit = per_sm * sms;
    }
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  if (grid > cached_fit) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  Params<T> args = p;
  void* argv[] = {&args};
  e = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(fn), dim3(grid), dim3(NT), argv,
                                  smem, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// Weights in the order of ops/fused_layer.py:_packed_specs; ``work`` is the
// float32 scratch of ops/fused_layer.py:workspace_floats, carved in its order.
template <typename T>
int run(const void* x, const void* const* w, void* kv, void* kv_scale, const void* bias_row,
        const void* add_mask, void* state, void* y, void* krow, float* work, long long work_floats,
        const int* plan, int* tickets, int grid, int smem, int b, int heads, int dim, int inner, int N, int pos,
        int chunk, int n_chunks, float scale, cudaStream_t s) {
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
  p.krow = static_cast<float*>(krow);
  p.plan = plan;
  p.tickets = tickets;
  p.b = b; p.heads = heads; p.dim = dim; p.inner = inner; p.inner_p = (inner + 15) / 16 * 16;
  p.N = N; p.pos = pos; p.chunk = chunk; p.n_chunks = n_chunks; p.scale = scale;
  const size_t hd = (size_t)heads * D;
  p.q_raw = work;
  p.kv_raw = p.q_raw + (size_t)b * hd;
  p.attn = p.kv_raw + (size_t)b * 2 * D;
  p.x2 = p.attn + (size_t)b * hd;
  p.g = p.x2 + (size_t)b * dim;
  p.part = p.g + (size_t)b * p.inner_p;
  if (p.part + (size_t)b * n_chunks * heads * PW > work + work_floats || chunk < 1 ||
      (long long)chunk * n_chunks < pos || chunk > CHMAX || heads > MAXH)
    return static_cast<int>(cudaErrorInvalidValue);
  return launch(p, grid, smem, s);
}

}  // namespace

extern "C" int omt_fused_layer(
    const void* x, const void* gamma, const void* wqT, const void* sq, const void* wkvT,
    const void* skv, const void* woT, const void* so, const void* q_scale, const void* k_scale,
    const void* gin, const void* wvT, const void* sv, const void* wgT, const void* sg,
    const void* conv_v, const void* conv_g, const void* gmid, const void* ff_woT,
    const void* ff_so, void* kv, void* kv_scale, const void* bias_row, const void* add_mask,
    void* state, void* y, void* krow, void* work, long long work_floats, const void* plan,
    void* tickets, int grid, int smem, int b, int heads, int dim, int inner, int N, int pos, int chunk,
    int n_chunks, float scale, int dtype, void* stream) {
  const void* const w[] = {gamma, wqT, sq, wkvT, skv, woT, so, q_scale, k_scale, gin,
                           wvT, sv, wgT, sg, conv_v, conv_g, gmid, ff_woT, ff_so};
  auto s = static_cast<cudaStream_t>(stream);
  auto ws = static_cast<float*>(work);
  auto pl = static_cast<const int*>(plan);
  auto tk = static_cast<int*>(tickets);
  if (dtype == 0)
    return run<float>(x, w, kv, kv_scale, bias_row, add_mask, state, y, krow, ws, work_floats, pl,
                      tk, grid, smem, b, heads, dim, inner, N, pos, chunk, n_chunks, scale, s);
  return run<__nv_bfloat16>(x, w, kv, kv_scale, bias_row, add_mask, state, y, krow, ws,
                            work_floats, pl, tk, grid, smem, b, heads, dim, inner, N, pos, chunk,
                            n_chunks, scale, s);
}
