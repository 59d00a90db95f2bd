// Kernel 1: prefill attention with one K/V head shared by all query heads.
//
// Replaces the Pallas kernel open_musiclm_tpu/ops/pallas_attention.py:
// shared_kv_attention_pallas (pallas_call at ops/pallas_attention.py:155,
// body _attn_kernel :32-78). For q [b, h, n, 64], k and v [b, m, 64]:
//   sim = q . k^T * scale + bias[h, n, m],  masked entries set to -1e9
//   (key mask, and the causal mask with offset m - n and an optional
//   bidirectional prefix), then an exact softmax over the keys and  . v.
// Output [b, n, h * 64]. Float32 accumulation throughout; the bias is read in
// its own type (float32 or bf16). When ``stats`` is
// given (the training forward), each row's softmax max and denominator go to
// stats [b, h, n, 2] float32 for the backward kernels (attention_bwd.cu).
//
// Masked scores are set to -1e9, not -inf, exactly as the plain version does
// (ops/attention.py:shared_kv_attention): a row whose every key is masked
// then softmaxes to the uniform mean of V over all m keys, with stats
// (-1e9, m), and the backward relies on that.
//
// What bounds it on the H100: at the serving and training shapes neither
// bytes (the bias, 19.9 MB bf16 at n 1116, is most of them: ~6 us) nor the
// tensor cores' FLOPs, but latency and instruction count: few tiles a block, each a
// chain of loads, products and a softmax. The design:
//   * bf16 runs on the tensor cores: mma.sync m16n8k16 bf16 -> float32 for
//     q.k^T and p.v, operands from shared memory by ldmatrix (FlashAttention-2's
//     shape), the online softmax in registers. A block owns 64 (head, query)
//     rows, 64 / h query positions x h heads (8 x 8 at musiclm's 8 heads), in
//     four warps of 16 rows, so b8 n216 is 216 blocks and the training shapes
//     260-306, all resident at once (168 registers, three blocks an SM). All
//     heads share K and V, so each K/V tile staged in shared memory serves
//     every head of the block's queries.
//   * K/V tiles of 64 keys arrive by 16-byte cp.async copies, two stages deep
//     (the next tile is in flight while this one is computed), each 16-byte
//     unit XOR-swizzled by its row so ldmatrix reads are free of bank
//     conflicts. The bias is read once per batch row straight into the score
//     fragment's layout (pairs of keys where the alignment allows), one tile
//     ahead of its use; rows past n are masked, not read.
//   * Key tiles past the block's last visible key (i_last + m - n, or the
//     prefix's ncp + m - n) are skipped, with or without a key mask: every
//     row that sees a key gives them weight exactly 0. A row whose every key
//     is masked (all its visited scores are -1e9) gets the keys it did not
//     visit added in an epilogue, so it still ends as mean(V[0:m]) with
//     stats (-1e9, m).
//   * float32 keeps full float32 arithmetic (the training gradient gate
//     holds float32 to float64, and bf16 or TF32 products would fail it):
//     one CUDA-core thread per row over 32-key tiles, as before, with the
//     same causal tile skipping and fully-masked epilogue.
#include "mma.cuh"

namespace {

using omt::causal_ok;
using omt::swz;
using omt::visible_end;

constexpr int D = 64;

// ---- float32: one thread per (head, query) row on the CUDA cores ----
constexpr int ROWS = 128;  // rows per block == threads per block
constexpr int KT = 32;     // keys per tile

template <typename B>
__global__ void __launch_bounds__(ROWS) prefill_attention_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const B* __restrict__ bias, const uint8_t* __restrict__ key_mask, float* __restrict__ out,
    float* __restrict__ stats, int heads, int n, int m, int causal, int ncp, float scale) {
  __shared__ float ks[KT][D];
  __shared__ float vs[KT][D];
  const int bq = ROWS / heads;  // query positions per block
  const int bi = blockIdx.y;
  const int i0 = blockIdx.x * bq;
  const int h = threadIdx.x / bq;
  const int i = i0 + threadIdx.x % bq;
  const bool active = i < n;
  const int off = m - n;

  float qr[D], acc[D];
  if (active) {
    const float* qp = q + (((size_t)bi * heads + h) * n + i) * D;
#pragma unroll
    for (int e = 0; e < D; ++e) qr[e] = qp[e];
  }
#pragma unroll
  for (int e = 0; e < D; ++e) acc[e] = 0.f;
  float mx = -INFINITY, l = 0.f;

  const int kv_end = visible_end(i0, i0 + bq, n, m, causal, ncp);
  const float* kb = k + (size_t)bi * m * D;
  const float* vb = v + (size_t)bi * m * D;
  const B* brow = bias ? bias + ((size_t)h * n + i) * m : nullptr;

  for (int j0 = 0; j0 < kv_end; j0 += KT) {
    const int nk = min(KT, kv_end - j0);
    __syncthreads();
    for (int t = threadIdx.x; t < nk * D; t += ROWS) {
      ks[t / D][t % D] = kb[(size_t)j0 * D + t];
      vs[t / D][t % D] = vb[(size_t)j0 * D + t];
    }
    __syncthreads();
    if (!active) continue;

    float s[KT];
    float tile_max = -INFINITY;
#pragma unroll
    for (int jj = 0; jj < KT; ++jj) {
      if (jj < nk) {
        const int j = j0 + jj;
        float dot = 0.f;
#pragma unroll
        for (int e = 0; e < D; ++e) dot = fmaf(qr[e], ks[jj][e], dot);
        float sv = dot * scale;
        if (brow) sv += omt::to_f32(brow[j]);
        const bool allowed = (key_mask == nullptr || key_mask[(size_t)bi * m + j] != 0) &&
                             causal_ok(i, j, off, causal, ncp);
        s[jj] = allowed ? sv : omt::kNegInf;
        tile_max = fmaxf(tile_max, s[jj]);
      }
    }
    const float m_new = fmaxf(mx, tile_max);
    const float alpha = expf(mx - m_new);
    l *= alpha;
#pragma unroll
    for (int e = 0; e < D; ++e) acc[e] *= alpha;
#pragma unroll
    for (int jj = 0; jj < KT; ++jj) {
      if (jj < nk) {
        const float p = expf(s[jj] - m_new);
        l += p;
#pragma unroll
        for (int e = 0; e < D; ++e) acc[e] = fmaf(p, vs[jj][e], acc[e]);
      }
    }
    mx = m_new;
  }
  if (!active) return;
  if (mx == omt::kNegInf) {  // every key masked: the skipped keys weigh 1 as well
    for (int j = kv_end; j < m; ++j) {
#pragma unroll
      for (int e = 0; e < D; ++e) acc[e] += vb[(size_t)j * D + e];
    }
    l += m - kv_end;
  }
  if (stats) {
    float* st = stats + (((size_t)bi * heads + h) * n + i) * 2;
    st[0] = mx;
    st[1] = l;
  }
  const float inv = 1.f / fmaxf(l, 1e-30f);
  float* op = out + ((size_t)bi * n + i) * heads * D + (size_t)h * D;
#pragma unroll
  for (int e = 0; e < D; ++e) op[e] = acc[e] * inv;
}

// ---- bf16: tensor cores ----
constexpr int BR = 64;  // (head, query) rows a block, 16 a warp
constexpr int BK = 64;  // keys a tile
constexpr int NT = 128;
// keys a key mask may cover in bf16 (a bit each in shared memory); the
// wrapper checks it against MAX_MASKED_KEYS in ops/attention.py
constexpr int MAX_MASKED_KEYS = 16384;

template <typename B>
__global__ void __launch_bounds__(NT, 3) prefill_attention_bf16_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const B* __restrict__ bias,
    const uint8_t* __restrict__ key_mask, __nv_bfloat16* __restrict__ out,
    float* __restrict__ stats, int heads, int n, int m, int causal, int ncp, float scale,
    int bias_paired) {
  __shared__ __align__(128) unsigned char qs[BR * D * 2];
  __shared__ __align__(128) unsigned char ks[2][BK * D * 2];
  __shared__ __align__(128) unsigned char vs[2][BK * D * 2];
  __shared__ unsigned kbits[MAX_MASKED_KEYS / 32];  // the key mask, a bit a key
  using BP = omt::BiasPair<B>;
  const int qb = BR / heads;  // query positions a block
  const int bi = blockIdx.y;
  // the blocks with the most key tiles (the last queries) start first
  const int i0 = (gridDim.x - 1 - blockIdx.x) * qb;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, tq = lane % 4;
  const int off = m - n;

  // Q rows: row r of the block is head r / qb, query i0 + r % qb; rows past n are zeros
  for (int c = tid; c < BR * 8; c += NT) {
    const int r = c / 8, u = c % 8, i = i0 + r % qb;
    const __nv_bfloat16* src = q + (((size_t)bi * heads + r / qb) * n + min(i, n - 1)) * D + u * 8;
    omt::cp_async16(qs + swz(r, u * 8), src, i < n ? 16 : 0);
  }
  const __nv_bfloat16* kb = k + (size_t)bi * m * D;
  const __nv_bfloat16* vb = v + (size_t)bi * m * D;
  auto load_kv = [&](int t, int stage) {
    for (int c = tid; c < BK * 8; c += NT) {
      const int r = c / 8, u = c % 8, j = t * BK + r;
      const size_t src = (size_t)min(j, m - 1) * D + u * 8;
      omt::cp_async16(ks[stage] + swz(r, u * 8), kb + src, j < m ? 16 : 0);
      omt::cp_async16(vs[stage] + swz(r, u * 8), vb + src, j < m ? 16 : 0);
    }
    omt::cp_async_commit();
  };

  const int kv_end = visible_end(i0, i0 + qb, n, m, causal, ncp);
  const int n_tiles = (kv_end + BK - 1) / BK;
  load_kv(0, 0);  // one group with Q

  // this thread's two rows: A = 16 warp + g, B = A + 8
  int ri[2], rh[2];
  bool rv[2];
#pragma unroll
  for (int x = 0; x < 2; ++x) {
    const int r = warp * 16 + g + 8 * x;
    rh[x] = r / qb;
    ri[x] = i0 + r % qb;
    rv[x] = ri[x] < n;
  }
  const B* brow[2];
#pragma unroll
  for (int x = 0; x < 2; ++x)
    brow[x] = bias && rv[x] ? bias + ((size_t)rh[x] * n + ri[x]) * m : nullptr;
  if (key_mask != nullptr) {  // keys [0, kv_end) as bits, a word of 32 per warp at a time
    const uint8_t* km = key_mask + (size_t)bi * m;
    for (int w0 = warp * 32; w0 < kv_end; w0 += NT) {
      const int j = w0 + lane;
      const unsigned word = __ballot_sync(0xffffffffu, j < kv_end && __ldg(km + j) != 0);
      if (lane == 0) kbits[w0 / 32] = word;
    }
  }

  // the bias of a tile in the score fragment's layout, in its own type (so
  // that the loads stay in flight until the tile is scored)
  typename BP::T bfr[8][2];
  auto load_bias = [&](int t) { omt::load_bias_frag<B>(bfr, brow, t * BK, m, bias_paired); };
  load_bias(0);

  float o[8][4];
#pragma unroll
  for (int dn = 0; dn < 8; ++dn)
#pragma unroll
    for (int c = 0; c < 4; ++c) o[dn][c] = 0.f;
  float mrow[2] = {-INFINITY, -INFINITY}, lrow[2] = {0.f, 0.f};  // lrow: this thread's share
  unsigned qa[4][4];  // Q's A fragments, 4 steps of 16 dims

  for (int t = 0; t < n_tiles; ++t) {
    const int stage = t & 1;
    omt::cp_async_wait<0>();
    __syncthreads();  // tile t (and Q) staged; the other stage is free
    if (t + 1 < n_tiles) load_kv(t + 1, stage ^ 1);
    if (t == 0) {
#pragma unroll
      for (int ds = 0; ds < 4; ++ds)
        omt::load_a(omt::smem_addr(qs), warp, ds, qa[ds]);
    }

    // S = Q K^T: 16 rows x 64 keys a warp
    float s[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[nt][c] = 0.f;
    omt::mma_a_bt(s, qa, omt::smem_addr(ks[stage]));

    // scale, bias, masks; then the online softmax
    float tmax[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const unsigned kw = key_mask != nullptr ? kbits[(t * BK + nt * 8) >> 5] : ~0u;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int x = c >> 1, j = t * BK + nt * 8 + 2 * tq + (c & 1);
        const float2 bv = BP::f32(bfr[nt][x]);
        float sv;
        if (j >= m) {
          sv = -INFINITY;  // past the keys: no weight
        } else if (((kw >> (j & 31)) & 1u) && causal_ok(ri[x], j, off, causal, ncp)) {
          sv = s[nt][c] * scale + ((c & 1) ? bv.y : bv.x);
        } else {
          sv = omt::kNegInf;
        }
        s[nt][c] = sv;
        tmax[x] = fmaxf(tmax[x], sv);
      }
    }
    if (t + 1 < n_tiles) load_bias(t + 1);  // in flight during p.v and the next q.k
    float alpha[2];
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      tmax[x] = fmaxf(tmax[x], __shfl_xor_sync(0xffffffffu, tmax[x], 1));
      tmax[x] = fmaxf(tmax[x], __shfl_xor_sync(0xffffffffu, tmax[x], 2));
      const float m_new = fmaxf(mrow[x], tmax[x]);
      alpha[x] = expf(mrow[x] - m_new);
      mrow[x] = m_new;
      lrow[x] *= alpha[x];
    }
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float p = expf(s[nt][c] - mrow[c >> 1]);
        lrow[c >> 1] += p;
        s[nt][c] = p;
      }
    }
#pragma unroll
    for (int dn = 0; dn < 8; ++dn)
#pragma unroll
      for (int c = 0; c < 4; ++c) o[dn][c] *= alpha[c >> 1];

    // O += P V: P's C fragments of key groups 2 ks, 2 ks + 1 are the A fragment of step ks
    omt::mma_c_b(o, s, omt::smem_addr(vs[stage]));
  }

  // epilogue: the rows' denominators over the quad, fully masked rows, stats, output
#pragma unroll
  for (int x = 0; x < 2; ++x) {
    lrow[x] += __shfl_xor_sync(0xffffffffu, lrow[x], 1);
    lrow[x] += __shfl_xor_sync(0xffffffffu, lrow[x], 2);
  }
  const int visited = min(n_tiles * BK, m);
#pragma unroll
  for (int x = 0; x < 2; ++x) {
    if (!rv[x]) continue;
    if (mrow[x] == omt::kNegInf && visited < m) {  // every key masked
      for (int j = visited; j < m; ++j) {
#pragma unroll
        for (int dn = 0; dn < 8; ++dn) {
          const float2 vv = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(vb + (size_t)j * D + dn * 8 + 2 * tq));
          o[dn][2 * x] += vv.x;
          o[dn][2 * x + 1] += vv.y;
        }
      }
      lrow[x] += m - visited;
    }
    if (stats && tq == 0) {
      float* st = stats + (((size_t)bi * heads + rh[x]) * n + ri[x]) * 2;
      st[0] = mrow[x];
      st[1] = lrow[x];
    }
    const float inv = 1.f / fmaxf(lrow[x], 1e-30f);
    __nv_bfloat16* op = out + ((size_t)bi * n + ri[x]) * heads * D + (size_t)rh[x] * D;
#pragma unroll
    for (int dn = 0; dn < 8; ++dn)
      *reinterpret_cast<__nv_bfloat162*>(op + dn * 8 + 2 * tq) =
          __floats2bfloat162_rn(o[dn][2 * x] * inv, o[dn][2 * x + 1] * inv);
  }
}

template <typename B>
void launch_bf16(const void* q, const void* k, const void* v, const void* bias,
                 const void* key_mask, void* out, float* stats, int b, int heads, int n, int m,
                 int causal, int ncp, float scale, cudaStream_t s) {
  const int qb = BR / heads;
  // pairs of bias elements load as one when every row starts aligned for it
  const int paired = m % 2 == 0 && reinterpret_cast<uintptr_t>(bias) % (2 * sizeof(B)) == 0;
  prefill_attention_bf16_kernel<B><<<dim3((n + qb - 1) / qb, b), NT, 0, s>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const B*>(bias),
      static_cast<const uint8_t*>(key_mask), static_cast<__nv_bfloat16*>(out), stats, heads, n,
      m, causal, ncp, scale, paired);
}

template <typename B>
void launch_f32(const void* q, const void* k, const void* v, const void* bias,
                const void* key_mask, void* out, float* stats, int b, int heads, int n, int m,
                int causal, int ncp, float scale, cudaStream_t s) {
  const int bq = ROWS / heads;
  prefill_attention_f32_kernel<B><<<dim3((n + bq - 1) / bq, b), ROWS, 0, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const B*>(bias), static_cast<const uint8_t*>(key_mask),
      static_cast<float*>(out), stats, heads, n, m, causal, ncp, scale);
}

}  // namespace

// heads must divide 64 (a bf16 block's rows); the wrapper checks it
extern "C" int omt_prefill_attention(const void* q, const void* k, const void* v,
                                     const void* bias, const void* key_mask, void* out,
                                     void* stats, int b,
                                     int heads, int n, int m, int causal, int ncp, float scale,
                                     int dtype, int bias_dtype, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto st = static_cast<float*>(stats);
  auto run = [&](auto b_tag) {
    using B = decltype(b_tag);
    if (dtype == 0)
      launch_f32<B>(q, k, v, bias, key_mask, out, st, b, heads, n, m, causal, ncp, scale, s);
    else
      launch_bf16<B>(q, k, v, bias, key_mask, out, st, b, heads, n, m, causal, ncp, scale, s);
  };
  if (bias_dtype == 0)
    run(float{});
  else
    run(__nv_bfloat16{});
  return static_cast<int>(cudaGetLastError());
}
