"""The port's hand-written CUDA kernels against their plain PyTorch versions.

These need a CUDA card (a kernel has no CPU mode) and skip without one. They
import torch and the port only, so they also run where JAX is absent:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Shapes are small and ragged (row counts and widths off the kernels' tile
sizes); float32 throughout, so the tolerance only covers float32
accumulation in another order.
"""

import pytest
import torch

from open_musiclm_torch.ops import attention, decode_attention, fused_ff, fused_layer, quant
from open_musiclm_torch.models.transformer import Attention, ConvFeedForward

TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _randn(g, *shape):
    return torch.randn(*shape, generator=g)


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,n,m,mask,ncp", [(2, 8, 37, 37, False, 0), (3, 4, 20, 45, True, 0), (1, 8, 70, 70, False, 9)])
def test_prefill_attention_kernel(dev, b, h, n, m, mask, ncp):
    g = torch.Generator().manual_seed(n)
    q = attention.l2norm(_randn(g, b, h, n, 64)).to(dev)
    k = attention.l2norm(_randn(g, b, m, 64)).to(dev)
    v = _randn(g, b, m, 64).to(dev)
    bias = _randn(g, h, n, m).to(dev)
    key_mask = (torch.rand(b, m, generator=g) > 0.3).to(dev) if mask else None
    want = attention.shared_kv_attention(q, k, v, attn_bias=bias, key_mask=key_mask, causal=True, non_causal_prefix=ncp)
    before = attention.shared_kv_attention_fused.launches
    got = attention.shared_kv_attention_fused(q, k, v, bias, key_mask, non_causal_prefix=ncp)
    assert attention.shared_kv_attention_fused.launches == before + 1
    torch.testing.assert_close(got, want, **TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,bias_dtype", [
    (torch.bfloat16, torch.bfloat16), (torch.bfloat16, torch.float32), (torch.float32, torch.bfloat16)])
def test_prefill_attention_kernel_bias_dtypes(dev, dtype, bias_dtype):
    """The kernel reads the bias in its own dtype: against the plain version
    in float32 on the same values (bf16 output: 2**-7 of the largest)."""
    g = torch.Generator().manual_seed(11)
    b, h, n = 2, 8, 45
    q = attention.l2norm(_randn(g, b, h, n, 64)).to(dev, dtype)
    k = attention.l2norm(_randn(g, b, n, 64)).to(dev, dtype)
    v = _randn(g, b, n, 64).to(dev, dtype)
    bias = _randn(g, h, n, n).to(dev, bias_dtype)
    key_mask = (torch.rand(b, n, generator=g) > 0.3).to(dev)
    out, stats = attention.shared_kv_attention_fused(q, k, v, bias, key_mask, return_stats=True)
    want, want_stats = attention.shared_kv_attention(
        q.float(), k.float(), v.float(), attn_bias=bias.float(), key_mask=key_mask, causal=True,
        return_stats=True)
    assert out.dtype == dtype
    rel = 2.0 ** -7 if dtype == torch.bfloat16 else 1e-4
    torch.testing.assert_close(out.float(), want, atol=rel * max(1.0, want.abs().max().item()), rtol=0)
    torch.testing.assert_close(stats, want_stats, atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
def test_prefill_attention_kernel_fully_masked_row(dev):
    q = attention.l2norm(torch.randn(1, 8, 6, 64)).to(dev)
    k = attention.l2norm(torch.randn(1, 6, 64)).to(dev)
    v = torch.randn(1, 6, 64).to(dev)
    key_mask = torch.zeros(1, 6, dtype=torch.bool, device=dev)
    want = attention.shared_kv_attention(q, k, v, key_mask=key_mask, causal=True)
    torch.testing.assert_close(attention.shared_kv_attention_fused(q, k, v, None, key_mask), want, **TOL)


# Kernel 1's tiles: bf16 on the tensor cores (64 rows a block, 64 keys a
# tile), float32 on the CUDA cores (32 keys a tile), both skipping the key
# tiles the causal mask hides, with or without a key mask. Each case is held
# against the plain version in float32 on the same values, output and row
# statistics: bf16 output within 2**-7 of the largest (one rounding of a
# float32 result, and p rounded to bf16 for p.v), float32 1e-4; the stats
# are float32 sums of float32 scores in both dtypes (1e-4).
ATTN_REL = {torch.float32: 1e-4, torch.bfloat16: 2.0 ** -7}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("h", [4, 8, 16])  # 16: musiclm_large's heads
@pytest.mark.parametrize("b,n,m,mask,ncp", [
    (2, 100, 100, None, 0),      # n off the tile and off a block's queries
    (2, 77, 150, "random", 0),   # m > n: the queries are the last n keys
    (1, 130, 130, None, 70),     # a non-causal prefix across the 64-key tile edge
    (2, 200, 260, "random", 66),  # all three, with the key mask and skipped tiles
    (2, 150, 150, "head", 0),    # rows 0..79 of batch 1 see no key: skipped tiles added back
])
def test_prefill_attention_kernel_tiles(dev, dtype, h, b, n, m, mask, ncp):
    g = torch.Generator().manual_seed(n + m + h)
    q = attention.l2norm(_randn(g, b, h, n, 64)).to(dev, dtype)
    k = attention.l2norm(_randn(g, b, m, 64)).to(dev, dtype)
    v = _randn(g, b, m, 64).to(dev, dtype)
    bias = _randn(g, h, n, m).to(dev, dtype)
    key_mask = None
    if mask == "random":
        key_mask = (torch.rand(b, m, generator=g) > 0.3).to(dev)
    elif mask == "head":
        key_mask = torch.ones(b, m, dtype=torch.bool, device=dev)
        key_mask[1, :80] = False
    opts = dict(causal=True, non_causal_prefix=ncp)
    before = attention.shared_kv_attention_fused.launches
    out, stats = attention.shared_kv_attention_fused(q, k, v, bias, key_mask, return_stats=True, **opts)
    assert attention.shared_kv_attention_fused.launches == before + 1
    want, want_stats = attention.shared_kv_attention(
        q.float(), k.float(), v.float(), attn_bias=bias.float(), key_mask=key_mask,
        return_stats=True, **opts)
    assert out.dtype == dtype and out.shape == (b, n, h * 64)
    _assert_within("out", out, want, ATTN_REL[dtype])
    torch.testing.assert_close(stats, want_stats, atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
def test_prefill_attention_wrapper_raises_on_heads(dev):
    q = torch.zeros(1, 3, 8, 64, device=dev, dtype=torch.bfloat16)
    k = torch.zeros(1, 8, 64, device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError):  # 3 heads do not divide a block's 64 rows
        attention.shared_kv_attention_fused(q, k, k)


@pytest.mark.cuda
def test_prefill_attention_kernel_long_key_mask(dev):
    """A key mask over more keys than the bf16 route keeps as bits: float32
    reads the mask from global memory and takes it, bf16 raises."""
    g = torch.Generator().manual_seed(3)
    b, h, n, m = 1, 8, 40, attention.MAX_MASKED_KEYS + 64
    q = attention.l2norm(_randn(g, b, h, n, 64)).to(dev)
    k = attention.l2norm(_randn(g, b, m, 64)).to(dev)
    v = _randn(g, b, m, 64).to(dev)
    key_mask = (torch.rand(b, m, generator=g) > 0.3).to(dev)
    want = attention.shared_kv_attention(q, k, v, key_mask=key_mask, causal=True)
    torch.testing.assert_close(attention.shared_kv_attention_fused(q, k, v, None, key_mask), want, **TOL)
    with pytest.raises(ValueError):
        attention.shared_kv_attention_fused(*(t.to(torch.bfloat16) for t in (q, k, v)), None, key_mask)


# Kernel 2 at musiclm_large's shapes: 16 heads, and the 2,816-row cache of
# its 10 s coarse window (12 + 1 CLAP, 499 + 1 semantic, 3 start tokens and
# 2,250 coarse steps: 2,766 rows, padded to the 256-row chunk), up to its
# last live row 2,765, in every row dtype.
@pytest.mark.cuda
@pytest.mark.parametrize("rows", ["int8", "bf16", "f32"])
@pytest.mark.parametrize("b,h,N,pos", [(8, 16, 1280, 1279), (8, 16, 2816, 2765), (2, 16, 2816, 1000),
                                       (1, 8, 2816, 2765), (16, 16, 2816, 2560), (2, 16, 2816, 0)])
def test_flash_decode_kernel_large(dev, rows, b, h, N, pos):
    g = torch.Generator().manual_seed(pos + b + h)
    k, v = attention.l2norm(_randn(g, b, N, 64)), _randn(g, b, N, 64)
    sc, q_dtype = None, torch.bfloat16
    if rows == "int8":
        kq, ks = decode_attention.quantize_kv_row(k)
        vq, vs = decode_attention.quantize_kv_row(v)
        kv, sc, q_dtype = torch.cat([kq, vq], -1).to(dev), torch.stack([ks, vs]).to(dev), torch.float32
    else:
        kv = torch.cat([k, v], -1).to(dev, torch.bfloat16 if rows == "bf16" else torch.float32)
    bias_row = _randn(g, N, h).to(dev)
    add_mask = torch.where(torch.rand(b, N, generator=g) > 0.2, 0.0, -1e9).to(dev)
    add_mask[:, 0] = 0.0
    q = attention.l2norm(_randn(g, b, h, 64)).to(dev, q_dtype)
    got = decode_attention.flash_decode_step(q, kv, pos, bias_row, add_mask, sc)
    want = decode_attention.flash_decode_step_plain(q.float(), kv, pos, bias_row, add_mask, sc)
    _assert_within("out", got, want, 1e-4 if q_dtype == torch.float32 else 2.0 ** -7)


@pytest.mark.cuda
def test_flash_decode_kernel_two_streams(dev):
    """Kernel 2 on two streams at once: each stream folds its splits with
    its own tickets, so both outputs are whole."""
    g = torch.Generator().manual_seed(5)
    b, h, N, pos = 8, 8, 1280, 1279
    kv = torch.cat([attention.l2norm(_randn(g, b, N, 64)), _randn(g, b, N, 64)], -1).to(dev, torch.bfloat16)
    bias_row, add_mask = _randn(g, N, h).to(dev), torch.zeros(b, N, device=dev)
    qs = [attention.l2norm(_randn(g, b, h, 64)).to(dev, torch.bfloat16) for _ in range(2)]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    outs = [[], []]
    for _ in range(10):
        with torch.cuda.stream(side):
            outs[0].append(decode_attention.flash_decode_step(qs[0], kv, pos, bias_row, add_mask))
        outs[1].append(decode_attention.flash_decode_step(qs[1], kv, pos, bias_row, add_mask))
    torch.cuda.synchronize()
    for q, got in zip(qs, outs):
        want = decode_attention.flash_decode_step_plain(q.float(), kv, pos, bias_row, add_mask)
        for i, o in enumerate(got):
            _assert_within(f"out (call {i + 1})", o, want, 2.0 ** -7)


@pytest.mark.cuda
@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("pos", [0, 63, 64, 255, 256, 511])
def test_flash_decode_kernel(dev, int8, pos):
    g = torch.Generator().manual_seed(pos)
    b, h, N = 3, 8, 512
    q = attention.l2norm(_randn(g, b, h, 64)).to(dev)
    k, v = attention.l2norm(_randn(g, b, N, 64)), _randn(g, b, N, 64)
    if int8:
        kq, ks = decode_attention.quantize_kv_row(k)
        vq, vs = decode_attention.quantize_kv_row(v)
        kv, sc = torch.cat([kq, vq], -1).to(dev), torch.stack([ks, vs]).to(dev)
    else:
        kv, sc = torch.cat([k, v], -1).to(dev), None
    bias_row = _randn(g, N, h).to(dev)
    add_mask = torch.where(torch.rand(b, N, generator=g) > 0.2, 0.0, -1e9).to(dev)
    add_mask[:, 0] = 0.0
    want = decode_attention.flash_decode_step_plain(q, kv, pos, bias_row, add_mask, sc)
    got = decode_attention.flash_decode_step(q, kv, pos, bias_row, add_mask, sc)
    torch.testing.assert_close(got, want, **TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("pos", [0, 300, 511])
def test_flash_decode_kernel_f32_rows_bf16_q(dev, pos):
    """The "f32" cache mode: float32 rows under bf16 queries, against the
    plain version in float32 on the same values (bf16 output)."""
    g = torch.Generator().manual_seed(pos)
    b, h, N = 3, 8, 512
    q = attention.l2norm(_randn(g, b, h, 64)).to(dev, torch.bfloat16)
    kv = torch.cat([attention.l2norm(_randn(g, b, N, 64)), _randn(g, b, N, 64)], -1).to(dev)
    bias_row = _randn(g, N, h).to(dev)
    add_mask = torch.zeros(b, N, device=dev)
    got = decode_attention.flash_decode_step(q, kv, pos, bias_row, add_mask)
    want = decode_attention.flash_decode_step_plain(q.float(), kv, pos, bias_row, add_mask)
    assert got.dtype == torch.bfloat16
    _assert_within("out", got, want, 2.0 ** -7)


# Kernel 2's split cache: positions at the chunk and split edges (b 16 at
# pos 1151 / 1152: 9 full splits of two chunks / a 10th split of one row),
# every batch size of the decode paths, every row dtype. Each case runs the
# kernel twice on the same stream with fresh queries: a batch row's ticket
# left non-zero by the first launch would leave the second's output unfolded.
@pytest.mark.cuda
@pytest.mark.parametrize("rows", ["int8", "bf16", "f32"])
@pytest.mark.parametrize("b", [1, 2, 8, 16])
@pytest.mark.parametrize("pos", [0, 63, 64, 700, 1151, 1152, 1279])
def test_flash_decode_kernel_splits(dev, rows, b, pos):
    g = torch.Generator().manual_seed(pos + 7 * b)
    h, N = 8, 1280
    k, v = attention.l2norm(_randn(g, b, N, 64)), _randn(g, b, N, 64)
    sc, q_dtype = None, torch.bfloat16
    if rows == "int8":
        kq, ks = decode_attention.quantize_kv_row(k)
        vq, vs = decode_attention.quantize_kv_row(v)
        kv, sc, q_dtype = torch.cat([kq, vq], -1).to(dev), torch.stack([ks, vs]).to(dev), torch.float32
    else:  # bf16 rows under bf16 queries; float32 rows under bf16 ("f32" mode)
        kv = torch.cat([k, v], -1).to(dev, torch.bfloat16 if rows == "bf16" else torch.float32)
    bias_row = _randn(g, N, h).to(dev)
    add_mask = torch.where(torch.rand(b, N, generator=g) > 0.2, 0.0, -1e9).to(dev)
    add_mask[:, 0] = 0.0
    splits, _ = decode_attention.decode_splits(pos, N)
    assert splits == 1 or pos >= 64
    for call in range(2):
        q = attention.l2norm(_randn(g, b, h, 64)).to(dev, q_dtype)
        before = decode_attention.flash_decode_step.launches
        got = decode_attention.flash_decode_step(q, kv, pos, bias_row, add_mask, sc)
        assert decode_attention.flash_decode_step.launches == before + 1
        want = decode_attention.flash_decode_step_plain(q.float(), kv, pos, bias_row, add_mask, sc)
        assert got.dtype == q_dtype
        _assert_within(f"out (call {call + 1}, {splits} splits)", got, want,
                       1e-4 if q_dtype == torch.float32 else 2.0 ** -7)


@pytest.mark.cuda
@pytest.mark.parametrize("b,dim", [(1, 64), (19, 96), (40, 1024)])
def test_fused_ff_kernel(dev, b, dim):
    g = torch.Generator().manual_seed(b)
    ff = ConvFeedForward(dim, generator=g)
    with torch.no_grad():
        ff.norm_in.gamma.normal_(1.0, 0.2, generator=g)
        ff.norm_mid.gamma.normal_(1.0, 0.2, generator=g)
    packed = {key: t.to(dev) for key, t in fused_ff.pack_ff_weights(ff).items()}
    x = _randn(g, b, dim).to(dev)
    state = _randn(g, b, 2, 2 * ff.inner_dim).to(dev)
    want = fused_ff.fused_ff_apply_plain(x, packed, state)
    got = fused_ff.fused_ff_apply(x, packed, state)
    torch.testing.assert_close(got[0], want[0], **TOL)
    torch.testing.assert_close(got[1], want[1], **TOL)


def _ff_case(g, dev, b, dim):
    ff = ConvFeedForward(dim, generator=g)
    with torch.no_grad():
        ff.norm_in.gamma.normal_(1.0, 0.2, generator=g)
        ff.norm_mid.gamma.normal_(1.0, 0.2, generator=g)
    packed = {key: t.to(dev) for key, t in fused_ff.pack_ff_weights(ff).items()}
    return packed, _randn(g, b, dim).to(dev), _randn(g, b, 2, 2 * ff.inner_dim).to(dev)


# Kernel 3's weight stream: column blocks of up to 128 columns, each split
# over k (ops/fused_ff.py:ff_in_grid, ff_out_grid), 8 activation rows a pass
# (b 17 and 40 take 3 and 5 passes), inner 170 and 2730 off every block
# width and rows of Wv and Wg off 4-byte alignment (shifted words); dim 35
# (inner 93) makes weight arrays of an odd byte count, whose last word is
# read bytewise. float32 within TOL of the plain
# version; bf16 against the plain version on the same bf16 values within
# 2**-7 of the largest output (both round their float32 result once to bf16).
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("dim", [35, 64, 1024])
@pytest.mark.parametrize("b", [1, 8, 16, 17, 40])
def test_fused_ff_kernel_rows(dev, dtype, dim, b):
    g = torch.Generator().manual_seed(b + dim)
    packed, x, state = _ff_case(g, dev, b, dim)
    x, state = x.to(dtype), state.to(dtype)
    before = fused_ff.fused_ff_apply.launches
    got = fused_ff.fused_ff_apply(x, packed, state)
    assert fused_ff.fused_ff_apply.launches == before + 1
    want = fused_ff.fused_ff_apply_plain(x.float(), packed, state.float())
    assert got[0].dtype == dtype and got[1].dtype == dtype
    for name, a, ref in zip(("y", "state"), got, want):
        if dtype == torch.float32:
            torch.testing.assert_close(a, ref, **TOL)
        else:
            _assert_within(name, a, ref, 2.0 ** -7)


@pytest.mark.cuda
def test_fused_ff_kernel_two_streams(dev):
    """Kernel 3 on two streams at once: each stream folds with its own
    tickets and partials, so both results are whole, and equal from call to
    call."""
    g = torch.Generator().manual_seed(9)
    packed, x, state = _ff_case(g, dev, 8, 1024)
    xs = [x.to(torch.bfloat16), _randn(g, 8, 1024).to(dev, torch.bfloat16)]
    state = state.to(torch.bfloat16)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    outs = [[], []]
    for _ in range(10):
        with torch.cuda.stream(side):
            outs[0].append(fused_ff.fused_ff_apply(xs[0], packed, state))
        outs[1].append(fused_ff.fused_ff_apply(xs[1], packed, state))
    torch.cuda.synchronize()
    for xi, got in zip(xs, outs):
        want = fused_ff.fused_ff_apply_plain(xi.float(), packed, state.float())
        for i, (y, st) in enumerate(got):
            _assert_within(f"y (call {i + 1})", y, want[0], 2.0 ** -7)
            assert torch.equal(y, got[0][0]) and torch.equal(st, got[0][1])


@pytest.mark.cuda
@pytest.mark.parametrize("B,K,N", [(1, 1024, 1025), (17, 100, 33), (300, 64, 1025)])
def test_int8_matmul_kernel(dev, B, K, N):
    g = torch.Generator().manual_seed(N)
    x = _randn(g, B, K).to(dev)
    wq, s = quant.quantize_weight(_randn(g, K, N))
    wq, s = wq.to(dev), s.to(dev)
    torch.testing.assert_close(quant.int8_matmul(x, wq, s), quant.int8_matmul_plain(x, wq, s), **TOL)


# Kernel 4 (ops/quant.py:int8_matmul): the weight stream (column blocks x k
# splits, 8 rows a pass, folded by ticket in split order) at every row
# count. float32 within
# TOL of the plain version; bf16 against the plain version on the same bf16
# values within 2**-7 of the largest output (both round their float32 result
# once to bf16).
# the int8 projections of the fused_ff=False decode step (musiclm_small):
# to_q, to_kv, to_out, proj_in, proj_out
PROJECTIONS = [(1024, 512), (1024, 128), (512, 1024), (1024, 5460), (2730, 1024)]


def _int8_case(seed, B, K, N, dev, dtype):
    g = torch.Generator().manual_seed(seed)
    x = _randn(g, B, K).to(dev, dtype)
    wq, s = quant.quantize_weight(_randn(g, K, N))
    return x, wq.to(dev), s.to(dev)


def _check_int8(x, wq, s):
    before = quant.int8_matmul.launches
    got = quant.int8_matmul(x, wq, s)
    assert quant.int8_matmul.launches == before + 1
    assert got.dtype == x.dtype and got.shape == (x.shape[0], wq.shape[1])
    want = quant.int8_matmul_plain(x.float(), wq, s)
    if x.dtype == torch.float32:
        torch.testing.assert_close(got, want, **TOL)
    else:
        _assert_within("out", got, want, 2.0 ** -7)
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("K,N", PROJECTIONS)
def test_int8_matmul_kernel_projections(dev, dtype, K, N):
    _check_int8(*_int8_case(K + N, 8, K, N, dev, dtype))


# the logit head (1024 x 1025) at the decode batch, the fine stage's rows
# (b 2 x 7 windows), one and two passes, 64 rows, the fine cap (256 rows),
# and beyond it
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("B", [1, 8, 14, 16, 64, 256, 300])
def test_int8_matmul_kernel_head(dev, dtype, B):
    _check_int8(*_int8_case(B, B, 1024, 1025, dev, dtype))


# row counts of one, a few and many passes, with K off the 16-row step
# (100, 1000) and N off 4 (33, 1027): stream rows off 4-byte alignment
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("B,K,N", [(8, 100, 33), (17, 1000, 1027), (64, 1024, 1025), (3, 72, 4096)])
def test_int8_matmul_kernel_routes(dev, dtype, B, K, N):
    _check_int8(*_int8_case(B + K + N, B, K, N, dev, dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("w_off", [1, 2, 3])
def test_int8_matmul_kernel_unaligned_weights(dev, w_off):
    """W as a view that starts 1-3 bytes past a 4-byte boundary (as a head
    of a stacked [Q, K, N] tensor can)."""
    x, wq, s = _int8_case(w_off, 12, 96, 130, dev, torch.float32)
    flat = torch.zeros(w_off + wq.numel(), dtype=torch.int8, device=dev)
    flat[w_off:] = wq.flatten()
    view = flat[w_off:].view(96, 130)
    assert view.data_ptr() % 4 == w_off
    _check_int8(x, view, s)


@pytest.mark.cuda
@pytest.mark.parametrize("B", [8, 14, 64])
def test_int8_matmul_kernel_two_streams(dev, B):
    """Kernel 4 on two streams at once, each folding with its own tickets
    and partials: both results whole, and the same bits call to call."""
    x, wq, s = _int8_case(B, B, 1024, 1025, dev, torch.bfloat16)
    xs = [x, torch.randn(B, 1024, generator=torch.Generator().manual_seed(1)).to(dev, torch.bfloat16)]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    outs = [[], []]
    for _ in range(10):
        with torch.cuda.stream(side):
            outs[0].append(quant.int8_matmul(xs[0], wq, s))
        outs[1].append(quant.int8_matmul(xs[1], wq, s))
    torch.cuda.synchronize()
    for xi, got in zip(xs, outs):
        want = quant.int8_matmul_plain(xi.float(), wq, s)
        for i, out in enumerate(got):
            _assert_within(f"out (call {i + 1})", out, want, 2.0 ** -7)
            assert torch.equal(out, got[0])


@pytest.mark.cuda
def test_wrappers_raise_on_bad_input(dev):
    x = torch.randn(4, 32, device=dev)
    wq = torch.zeros(32, 7, dtype=torch.int8, device=dev)
    with pytest.raises(ValueError):
        quant.int8_matmul(x, wq, torch.ones(8, device=dev))  # scale width
    with pytest.raises(ValueError):
        quant.int8_matmul(x, wq.t(), torch.ones(32, device=dev))  # w_q shape
    with pytest.raises(TypeError):
        quant.int8_matmul(x.half(), wq, torch.ones(7, device=dev))  # fp16 is not taken


# Kernels 5 and 6 (attention backward). bf16 inputs (the bias too, as the
# bf16 training path passes it) are held against the plain backward in
# float32 on the same bf16-valued inputs: the kernels round their float32
# results once to bf16, and the forward output that enters rowsum(dO * O) is
# bf16 too; the bound allows 2**-7 of the largest gradient (chip_smoke's bf16
# tolerance). float32: summation order only.
BWD_REL = {torch.float32: 1e-4, torch.bfloat16: 2.0 ** -7}


def _bwd_case(g, b, h, n, m, mask, dev):
    q = attention.l2norm(_randn(g, b, h, n, 64)) * 1.5
    k = attention.l2norm(_randn(g, b, m, 64)) * 1.5
    v = _randn(g, b, m, 64)
    bias = _randn(g, h, n, m)
    dout = _randn(g, b, n, h * 64)
    key_mask = None
    if mask:
        key_mask = torch.rand(b, m, generator=g) > 0.2
        key_mask[:, 0] = True
        key_mask = key_mask.to(dev)
    return [t.to(dev) for t in (q, k, v, bias, dout)] + [key_mask]


def _assert_within(name, got, want, rel):
    got, want = got.float(), want.float()
    assert torch.isfinite(got).all(), name
    tol = rel * max(1.0, want.abs().max().item())
    err = (got - want).abs().max().item()
    assert err <= tol, f"{name}: max abs err {err} > {tol}"


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("b,h,n,m,mask,ncp", [
    (2, 8, 37, 37, False, 0), (3, 4, 20, 45, True, 0), (1, 8, 70, 70, True, 9),
    (4, 8, 514, 514, True, 0), (2, 8, 1116, 1116, True, 0), (2, 8, 1217, 1217, False, 5),
    (2, 8, 1217, 1217, True, 7),
])
def test_attention_bwd_kernels(dev, dtype, b, h, n, m, mask, ncp):
    g = torch.Generator().manual_seed(n + m)
    q, k, v, bias, dout, key_mask = _bwd_case(g, b, h, n, m, mask, dev)
    q, k, v, bias, dout = (t.to(dtype) for t in (q, k, v, bias, dout))
    opts = dict(causal=True, non_causal_prefix=ncp)
    out, stats = attention.shared_kv_attention_fused(q, k, v, bias, key_mask, return_stats=True, **opts)
    _, want_stats = attention.shared_kv_attention(
        q.float(), k.float(), v.float(), attn_bias=bias.float(), key_mask=key_mask,
        return_stats=True, **opts)
    torch.testing.assert_close(stats, want_stats, atol=1e-4, rtol=1e-4)
    fn = attention.shared_kv_attention_bwd
    counts = (fn.launches, fn.dbias_launches)
    dq, dk, dv, dbias = fn(q, k, v, bias, key_mask, out, stats, dout, **opts)
    assert (fn.launches, fn.dbias_launches) == (counts[0] + 1, counts[1] + 1)
    assert (dq.dtype, dk.dtype, dv.dtype, dbias.dtype) == (dtype,) * 4
    want = attention.shared_kv_attention_bwd_plain(
        q.float(), k.float(), v.float(), dout.float(), attn_bias=bias.float(), key_mask=key_mask,
        **opts)
    for name, got, ref in zip(("dq", "dk", "dv", "dbias"), (dq, dk, dv, dbias), want):
        _assert_within(name, got, ref, BWD_REL[dtype])


@pytest.mark.cuda
def test_attention_bwd_kernels_fully_masked_row(dev):
    """A row whose every key is masked spreads its weight over all m keys."""
    g = torch.Generator().manual_seed(3)
    q, k, v, bias, dout, _ = _bwd_case(g, 2, 8, 40, 40, False, dev)
    key_mask = torch.ones(2, 40, dtype=torch.bool, device=dev)
    key_mask[1, :20] = False  # rows 0..19 of batch 1 see no key
    out, stats = attention.shared_kv_attention_fused(q, k, v, bias, key_mask, return_stats=True)
    got = attention.shared_kv_attention_bwd(q, k, v, bias, key_mask, out, stats, dout)
    want = attention.shared_kv_attention_bwd_plain(q, k, v, dout, attn_bias=bias, key_mask=key_mask)
    for name, a, ref in zip(("dq", "dk", "dv", "dbias"), got, want):
        _assert_within(name, a, ref, 1e-4)


# Kernel 5's bf16 route on the tensor cores: dk/dv blocks over (64-key tile,
# split, batch row) with a key tile's splits folded by ticket, dq blocks of 64
# (head, query) rows. Shapes off the 64-key tile (n 130, 200 / m 260) with a
# non-causal prefix across a tile edge, a key mask, 4 or 8 heads, key tiles
# of several splits (ops/attention.py:bwd_kv_splits), and a batch row whose
# first 80 queries see no key: dead rows in query tiles 0 and 1 of every
# head, whose gradient spreads over all m keys (so key tiles the causal mask
# hides from those queries visit them, in whichever split their rank falls).
# Held against the float32 plain backward on the same bf16 values within
# 2**-7 of the largest gradient.
@pytest.mark.cuda
@pytest.mark.parametrize("h", [4, 8, 16])  # 16: musiclm_large's heads
@pytest.mark.parametrize("b,n,m,mask,ncp", [
    (2, 130, 130, "random", 70), (1, 200, 260, "random", 66), (2, 150, 150, "head", 0),
    (3, 64, 64, None, 0), (2, 300, 300, "head", 5),
])
def test_attention_bwd_kernel_bf16_splits(dev, h, b, n, m, mask, ncp):
    g = torch.Generator().manual_seed(n + m + h)
    q, k, v, bias, dout, key_mask = _bwd_case(g, b, h, n, m, mask == "random", dev)
    if mask == "head":
        key_mask = torch.ones(b, m, dtype=torch.bool, device=dev)
        key_mask[1, :80] = False
    q, k, v, bias, dout = (t.to(torch.bfloat16) for t in (q, k, v, bias, dout))
    opts = dict(causal=True, non_causal_prefix=ncp)
    out, stats = attention.shared_kv_attention_fused(q, k, v, bias, key_mask, return_stats=True, **opts)
    got = attention.shared_kv_attention_bwd(q, k, v, bias, key_mask, out, stats, dout, **opts)
    want = attention.shared_kv_attention_bwd_plain(
        q.float(), k.float(), v.float(), dout.float(), attn_bias=bias.float(), key_mask=key_mask,
        **opts)
    for name, a, ref in zip(("dq", "dk", "dv", "dbias"), got, want):
        assert a.dtype == torch.bfloat16
        _assert_within(name, a, ref, 2.0 ** -7)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_attention_bwd_kernel_deterministic(dev, dtype):
    """Kernel 5 twice on the same inputs gives the same bits: every
    cross-block sum (a key tile's splits of dk/dv in bf16) is folded in a
    fixed order, whichever block finishes last."""
    g = torch.Generator().manual_seed(17)
    q, k, v, bias, dout, key_mask = _bwd_case(g, 2, 8, 514, 514, True, dev)
    q, k, v, bias, dout = (t.to(dtype) for t in (q, k, v, bias, dout))
    out, stats = attention.shared_kv_attention_fused(q, k, v, bias, key_mask, return_stats=True)
    first = attention.shared_kv_attention_bwd(q, k, v, bias, key_mask, out, stats, dout)
    for _ in range(3):
        again = attention.shared_kv_attention_bwd(q, k, v, bias, key_mask, out, stats, dout)
        for name, a, ref in zip(("dq", "dk", "dv", "dbias"), again, first):
            assert torch.equal(a, ref), name


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_prefill_attention_kernel_deterministic(dev, dtype):
    """Kernel 1 twice on the same inputs gives the same bits, output and row
    statistics: under remat the backward recomputes it, and kernels 5 and 6
    read what the recompute saved."""
    g = torch.Generator().manual_seed(19)
    q, k, v, bias, _, key_mask = _bwd_case(g, 2, 16, 514, 514, True, dev)
    q, k, v, bias = (t.to(dtype) for t in (q, k, v, bias))
    first = attention.shared_kv_attention_fused(q, k, v, bias, key_mask, return_stats=True)
    for _ in range(3):
        again = attention.shared_kv_attention_fused(q, k, v, bias, key_mask, return_stats=True)
        for name, a, ref in zip(("out", "stats"), again, first):
            assert torch.equal(a, ref), name


# Kernel 6's bf16 route (tensor cores, one block per (head, query tile, key
# tile) looping over the batch): with the bias in float32 or bf16, at the
# three training shapes with a key mask and at ragged ones, against the
# plain backward in float32 on the same bf16 values within 2**-7 of the
# largest gradient.
def _bwd_bf16(g, b, h, n, m, mask, dev, bias_dtype, ncp=0, key_mask=None):
    q, k, v, bias, dout, km = _bwd_case(g, b, h, n, m, mask, dev)
    key_mask = key_mask if key_mask is not None else km
    q, k, v, dout = (t.to(torch.bfloat16) for t in (q, k, v, dout))
    bias = bias.to(bias_dtype)
    opts = dict(causal=True, non_causal_prefix=ncp)
    out, stats = attention.shared_kv_attention_fused(q, k, v, bias, key_mask, return_stats=True, **opts)
    want = attention.shared_kv_attention_bwd_plain(
        q.float(), k.float(), v.float(), dout.float(), attn_bias=bias.float(), key_mask=key_mask,
        **opts)
    return (q, k, v, bias, key_mask, out, stats, dout), opts, want


@pytest.mark.cuda
@pytest.mark.parametrize("bias_dtype", [torch.float32, torch.bfloat16], ids=["bias_f32", "bias_bf16"])
@pytest.mark.parametrize("b,n,m,mask,ncp", [
    (4, 514, 514, True, 0), (2, 1116, 1116, True, 0), (2, 1217, 1217, True, 0),
    (3, 130, 201, True, 70), (2, 99, 99, False, 5),
])
def test_dbias_kernel_bf16(dev, bias_dtype, b, n, m, mask, ncp):
    g = torch.Generator().manual_seed(n + m + b)
    args, opts, want = _bwd_bf16(g, b, 8, n, m, mask, dev, bias_dtype, ncp)
    fn = attention.shared_kv_attention_bwd
    before = fn.dbias_launches
    got = fn(*args, **opts)
    assert fn.dbias_launches == before + 1
    assert got[3].dtype == bias_dtype
    for name, a, ref in zip(("dq", "dk", "dv", "dbias"), got, want):
        _assert_within(name, a, ref, 2.0 ** -7)


@pytest.mark.cuda
@pytest.mark.parametrize("bias_dtype", [torch.float32, torch.bfloat16], ids=["bias_f32", "bias_bf16"])
@pytest.mark.parametrize("b,n,m,mask,ncp", [(2, 514, 514, True, 0), (2, 130, 201, True, 70), (1, 99, 99, False, 5)])
def test_dbias_kernel_bf16_16_heads(dev, bias_dtype, b, n, m, mask, ncp):
    """Kernels 5 and 6 at musiclm_large's 16 heads."""
    g = torch.Generator().manual_seed(n + m + 16)
    args, opts, want = _bwd_bf16(g, b, 16, n, m, mask, dev, bias_dtype, ncp)
    got = attention.shared_kv_attention_bwd(*args, **opts)
    assert got[3].shape == (16, n, m)
    for name, a, ref in zip(("dq", "dk", "dv", "dbias"), got, want):
        _assert_within(name, a, ref, 2.0 ** -7)


@pytest.mark.cuda
@pytest.mark.parametrize("b", [1, 5])
@pytest.mark.parametrize("bias_dtype", [torch.float32, torch.bfloat16], ids=["bias_f32", "bias_bf16"])
def test_dbias_kernel_batch_loop(dev, b, bias_dtype):
    """One batch row, and five (more rows than the two staging buffers)."""
    g = torch.Generator().manual_seed(b)
    args, opts, want = _bwd_bf16(g, b, 4, 150, 150, True, dev, bias_dtype)
    got = attention.shared_kv_attention_bwd(*args, **opts)
    _assert_within("dbias", got[3], want[3], 2.0 ** -7)


@pytest.mark.cuda
@pytest.mark.parametrize("bias_dtype", [torch.float32, torch.bfloat16], ids=["bias_f32", "bias_bf16"])
def test_dbias_kernel_hidden_tiles_zero(dev, bias_dtype):
    """Tiles the causal mask hides from every batch row are written as
    zeros: dbias's memory is filled with NaN beforehand (the caching
    allocator hands the same block back), and every hidden element must come
    out exactly 0. m > n and an odd m put rows off 16-byte alignment."""
    g = torch.Generator().manual_seed(23)
    b, h, n, m = 2, 8, 260, 333
    args, opts, want = _bwd_bf16(g, b, h, n, m, True, dev, bias_dtype)
    for _ in range(2):
        poison = torch.full((h, n, m), float("nan"), dtype=bias_dtype, device=dev)
        del poison
        got = attention.shared_kv_attention_bwd(*args, **opts)[3]
        i = torch.arange(n, device=dev)[:, None]
        j = torch.arange(m, device=dev)[None, :]
        hidden = (j // 64 * 64 > (i // 64 * 64 + 63).clamp(max=n - 1) + (m - n)).expand(h, n, m)
        assert hidden.any()
        assert (got[hidden] == 0).all()
        _assert_within("dbias", got, want[3], 2.0 ** -7)


@pytest.mark.cuda
@pytest.mark.parametrize("bias_dtype", [torch.float32, torch.bfloat16], ids=["bias_f32", "bias_bf16"])
def test_dbias_kernel_fully_masked_row(dev, bias_dtype):
    """A batch row whose first 70 queries see no key: their weight spreads
    over all m keys, so key tiles the causal mask hides from query tiles 0
    and 1 are visited for that row (and only that row)."""
    g = torch.Generator().manual_seed(29)
    b, h, n = 3, 8, 200
    key_mask = torch.ones(b, n, dtype=torch.bool, device=dev)
    key_mask[1, :70] = False
    args, opts, want = _bwd_bf16(g, b, h, n, n, False, dev, bias_dtype, key_mask=key_mask)
    got = attention.shared_kv_attention_bwd(*args, **opts)
    assert got[3][:, :64, 128:].abs().max() > 0  # a causally hidden tile with dead rows
    for name, a, ref in zip(("dq", "dk", "dv", "dbias"), got, want):
        _assert_within(name, a, ref, 2.0 ** -7)


@pytest.mark.cuda
@pytest.mark.parametrize("bias_dtype", [torch.float32, torch.bfloat16], ids=["bias_f32", "bias_bf16"])
def test_dbias_kernel_deterministic(dev, bias_dtype):
    """Kernel 6's bf16 dbias is the same bits call to call: each element is
    summed over the batch in one block, in batch order, without atomics."""
    g = torch.Generator().manual_seed(31)
    args, opts, _ = _bwd_bf16(g, 4, 8, 514, 514, True, dev, bias_dtype)
    first = attention.shared_kv_attention_bwd(*args, **opts)[3]
    for _ in range(3):
        assert torch.equal(attention.shared_kv_attention_bwd(*args, **opts)[3], first)


@pytest.mark.cuda
def test_attention_train_autograd_on_card(dev):
    """The autograd Function on the card against torch.autograd of the plain
    forward, bias in bf16 (its gradient comes back in bf16)."""
    g = torch.Generator().manual_seed(5)
    q, k, v, bias, dout, key_mask = _bwd_case(g, 2, 8, 50, 50, True, dev)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)] + [bias.bfloat16().requires_grad_()]
    ref = [t.detach().clone().requires_grad_() for t in leaves]
    fn = attention.shared_kv_attention_bwd
    before = (fn.launches, fn.dbias_launches)
    attention.shared_kv_attention_train(*leaves, key_mask).backward(dout)
    assert (fn.launches, fn.dbias_launches) == (before[0] + 1, before[1] + 1)
    attention.shared_kv_attention(*ref[:3], attn_bias=ref[3], key_mask=key_mask, causal=True).backward(dout)
    assert leaves[3].grad.dtype == torch.bfloat16
    for a, r in zip(leaves, ref):
        _assert_within("grad", a.grad, r.grad, 2.0 ** -7 if a.dtype == torch.bfloat16 else 1e-4)


# Kernel 7 (one whole decode layer) at dim 256, 8 heads of 64, inner 682
# (the FF out-projection padded to 688), a 512-row int8 cache. bf16 inputs
# are held against the plain version in float32 on the same values (2**-7
# of the largest output, as above); float32: summation order only.
LAYER_REL = {torch.float32: 1e-4, torch.bfloat16: 2.0 ** -7}


def _layer_case(g, dev, b, dim=256, heads=8, N=512):
    attn, ff = Attention(dim, heads, 64, generator=g), ConvFeedForward(dim, generator=g)
    with torch.no_grad():
        for gamma in (attn.norm.gamma, ff.norm_in.gamma, ff.norm_mid.gamma):
            gamma.normal_(1.0, 0.2, generator=g)
        attn.q_scale.normal_(1.0, 0.1, generator=g)
        attn.k_scale.normal_(1.0, 0.1, generator=g)
    packed = {k: t.to(dev) for k, t in fused_layer.pack_layer_weights(attn, ff).items()}
    kq, ks = decode_attention.quantize_kv_row(attention.l2norm(_randn(g, b, N, 64)))
    vq, vs = decode_attention.quantize_kv_row(_randn(g, b, N, 64))
    add_mask = torch.where(torch.rand(b, N, generator=g) > 0.2, 0.0, -1e9)
    add_mask[:, 0] = 0.0
    return packed, dict(
        x=_randn(g, b, dim).to(dev), kv_cache=torch.cat([kq, vq], -1).to(dev),
        kv_scale=torch.stack([ks, vs]).to(dev), ff_state=_randn(g, b, 2, 2 * ff.inner_dim).to(dev),
        bias_row=_randn(g, N, heads).to(dev), add_mask=add_mask.to(dev))


def _check_layer(dev, dtype, b, pos, seed, **shape):
    """Kernel 7 once against the plain version on the same inputs: y, krow
    and the new state within LAYER_REL, the row written at pos, and every
    other cache row untouched. Returns the kernel's outputs."""
    heads = shape.get("heads", 8)
    g = torch.Generator().manual_seed(seed)
    packed, ins = _layer_case(g, dev, b, **shape)
    x, state = ins["x"].to(dtype), ins["ff_state"].to(dtype)
    cache = (ins["kv_cache"].clone(), ins["kv_scale"].clone())
    want = fused_layer.fused_layer_decode_step_plain(
        x.float(), packed, *cache, state.float().clone(), pos, ins["bias_row"], ins["add_mask"], heads=heads)
    kv, sc = ins["kv_cache"].clone(), ins["kv_scale"].clone()
    before = fused_layer.fused_layer_decode_step.launches
    got = fused_layer.fused_layer_decode_step(
        x, packed, kv, sc, state, pos, ins["bias_row"], ins["add_mask"], heads=heads)
    torch.cuda.synchronize()
    assert fused_layer.fused_layer_decode_step.launches == before + 1
    assert got[0].dtype == dtype and got[1].dtype == torch.float32 and got[2] is state
    for name, a, ref in zip(("y", "krow", "state"), got, want):
        _assert_within(name, a, ref, LAYER_REL[dtype])
    # the row written at pos is the kernel's own krow quantized as
    # quantize_kv_row does on the CPU (PyTorch's CUDA division by the scalar
    # 127 multiplies by its reciprocal, which can differ in the last bit)
    krow = got[1].cpu()
    kq, ks = decode_attention.quantize_kv_row(krow[:, :64])
    vq, vs = decode_attention.quantize_kv_row(krow[:, 64:])
    assert torch.equal(kv[:, pos].cpu(), torch.cat([kq, vq], -1))
    assert torch.equal(sc[:, :, pos].cpu(), torch.stack([ks, vs]))
    others = torch.arange(kv.shape[1], device=dev) != pos
    assert torch.equal(kv[:, others], ins["kv_cache"][:, others])
    assert torch.equal(sc[:, :, others], ins["kv_scale"][:, :, others])
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("b", [1, 3, 8])
@pytest.mark.parametrize("pos", [0, 5, 256, 289])
def test_fused_layer_kernel(dev, dtype, b, pos):
    _check_layer(dev, dtype, b, pos, 10 * pos + b)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("heads,b", [(8, 8), (16, 8), (8, 14), (8, 17), (16, 17)])
def test_fused_layer_kernel_full_width(dev, dtype, heads, b):
    """musiclm_small's (8 heads) and musiclm_large's (16 heads) layer at full
    width (dim 1024, inner 2730, each block holding its share of 9.6 / 10.6
    MB of weights) over a 1280-row cache at its last row; b 14 and 17 take a
    second and third pass over the resident weights, and their attention
    items a second round of the grid."""
    _check_layer(dev, dtype, b, 1279, heads + b, dim=1024, heads=heads, N=1280)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("heads,b,pos", [(16, 8, 2765), (16, 2, 1500), (8, 1, 2765), (16, 4, 2815)])
def test_fused_layer_kernel_long_cache(dev, dtype, heads, b, pos):
    """musiclm_large's layer over its coarse stage's 2,816-row cache (a 10 s
    window: 2,766 live rows), at the last live row, mid-cache and the last row."""
    _check_layer(dev, dtype, b, pos, heads + b + pos, dim=1024, heads=heads, N=2816)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_fused_layer_kernel_deterministic(dev, dtype):
    """Kernel 7 again on the same inputs gives the same bits: every sum
    (k slices, warp butterflies, LayerNorm statistics, chunk folds) is
    taken in a fixed order."""
    g = torch.Generator().manual_seed(23)
    packed, ins = _layer_case(g, dev, 17, dim=1024, heads=16, N=1280)
    x, state = ins["x"].to(dtype), ins["ff_state"].to(dtype)
    outs = []
    for _ in range(4):
        kv, sc, st = ins["kv_cache"].clone(), ins["kv_scale"].clone(), state.clone()
        y, krow, _ = fused_layer.fused_layer_decode_step(
            x, packed, kv, sc, st, 1279, ins["bias_row"], ins["add_mask"], heads=16)
        outs.append((y.clone(), krow.clone(), st, kv, sc))
    torch.cuda.synchronize()
    for again in outs[1:]:
        for name, a, ref in zip(("y", "krow", "state", "kv", "kv_scale"), again, outs[0]):
            assert torch.equal(a, ref), name


@pytest.mark.cuda
def test_fused_layer_wrapper_raises_on_bad_input(dev):
    g = torch.Generator().manual_seed(0)
    packed, ins = _layer_case(g, dev, 2)
    args = [ins[k] for k in ("x", "kv_cache", "kv_scale", "ff_state")]
    tail = (5, ins["bias_row"], ins["add_mask"])
    with pytest.raises(ValueError):  # heads that do not match the bias row
        fused_layer.fused_layer_decode_step(args[0], packed, *args[1:], *tail, heads=4)
    with pytest.raises(ValueError):  # a float cache
        fused_layer.fused_layer_decode_step(args[0], packed, args[1].float(), *args[2:], *tail, heads=8)
    with pytest.raises(ValueError):  # pos outside the cache
        fused_layer.fused_layer_decode_step(*args[:1], packed, *args[1:], 512, *tail[1:], heads=8)


@pytest.mark.cuda
@pytest.mark.parametrize("width", [2730, 1024, 1023])
def test_layer_norm_rows_independent_of_slot(dev, width):
    """The conv-FF's mid LayerNorm on the card: a row's bits do not depend
    on its batch slot, also with an odd sequence length, where rows of an odd
    width alternate between 16-byte-aligned and unaligned starts."""
    from open_musiclm_torch.models.transformer import layer_norm

    g = torch.Generator().manual_seed(width)
    x = (torch.randn(8, 465, width, generator=g) * 3).to(dev, torch.bfloat16)
    gamma = torch.randn(width, generator=g).to(dev)
    perm = torch.randperm(8, generator=g)
    got = layer_norm(x[perm], gamma)
    torch.testing.assert_close(got, layer_norm(x, gamma)[perm.to(dev)], atol=0, rtol=0)


@pytest.mark.cuda
def test_int16_round_trip_matches_cpu(dev):
    """The int16 round trip on the card gives the CPU's float32 values bit for
    bit (a division by a host scalar would be a product with its
    reciprocal there, a float32 ulp off for ~2 % of codes)."""
    from open_musiclm_torch.ops.audio import int16_round_trip

    x = torch.linspace(-1.2, 1.2, 200003)
    torch.testing.assert_close(int16_round_trip(x.to(dev)).cpu(), int16_round_trip(x), atol=0, rtol=0)


# Stage training from raw audio: small towers built from seeds on the CPU,
# copied to the card. A nearest-code choice whose CPU margin (second-best
# less best squared distance) is under TOKEN_TIE may go either way with
# float32 sums in another order, and is not checked.
TOKEN_TIE = 1e-3


def _small_tokenizers():
    """CLAP (a 2-stage HTSAT at 8 kHz, a 4 x 16 RVQ over 16-d embeddings),
    HuBERT (16x downsample, a 16-entry k-means) and Encodec (24 kHz, hop
    320, 2 filters) with seeded weights, float32, on the CPU, in eval mode."""
    from open_musiclm_torch.models.clap.clap import CLAP, ClapQuantized
    from open_musiclm_torch.models.clap.htsat import HTSATConfig
    from open_musiclm_torch.models.clap.roberta import RobertaConfig
    from open_musiclm_torch.models.encodec import EncodecModel
    from open_musiclm_torch.models.hubert import HubertConfig, HubertModel, HubertWithKmeans
    from open_musiclm_torch.models.rvq import rvq_init

    g = torch.Generator().manual_seed(3)
    audio = HTSATConfig(spec_size=32, patch_size=4, patch_stride=(4, 4), embed_dim=16, depths=(1, 1),
                        num_heads=(2, 4), window_size=4, num_classes=10, mel_bins=8, sample_rate=8000,
                        window_size_fft=64, hop_size=40, fmin=50.0, fmax=3500.0, clip_samples=5080)
    text = RobertaConfig(vocab_size=64, hidden_size=32, num_hidden_layers=1, num_attention_heads=2,
                         intermediate_size=64, max_position_embeddings=40)
    clap = ClapQuantized(model=CLAP(text, joint_embed_shape=16, generator=g, audio_cfg=audio).eval(),
                         rvq=rvq_init(4, 16, 16, g), num_quantizers=4, codebook_size=16, sample_rate=8000,
                         clip_samples=5080)
    hcfg = HubertConfig(conv_dim=(16,) * 7, hidden_size=32, num_hidden_layers=1, num_attention_heads=2,
                        intermediate_size=64, num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4,
                        conv_kernel=(4, 3, 2, 2, 1, 1, 1), conv_stride=(2, 2, 2, 2, 1, 1, 1))
    w2v = HubertWithKmeans(HubertModel(hcfg, generator=g), torch.randn(16, 32, generator=g), embed_layer=1,
                           target_sample_hz=160, seq_len_multiple_of=16, output_hz=10).eval()
    codec = EncodecModel(num_quantizers=4, codebook_size=16, dimension=8, n_filters=2, generator=g).eval()
    return clap, w2v, codec


def _decided(x, books, ids):
    """[n] bool: rows of x [n, D] whose residual nearest-code choices ids
    [n, Q] over books [Q, K, D] are each decided by more than TOKEN_TIE."""
    x, ok = x.double(), torch.ones(len(x), dtype=torch.bool)
    for q, cb in enumerate(books.double()):
        d2 = torch.cdist(x, cb) ** 2
        two = d2.topk(2, dim=-1, largest=False).values
        ok &= (two[:, 1] - two[:, 0] > TOKEN_TIE) & (d2.argmin(-1) == ids[:, q])
        x = x - cb[ids[:, q]]
    return ok


@pytest.mark.cuda
@pytest.mark.parametrize("stage", ["semantic", "coarse", "fine"])
def test_tokenizing_iterator_on_card_matches_cpu(dev, stage):
    """Two batches of 2 of a stage's views (2 s CLAP, 1 s semantic and
    acoustic windows): the token batches [2, 2, n_i] on the card equal the
    CPU's at every position the CPU decides beyond a near tie."""
    import copy

    import numpy as np

    from open_musiclm_torch.data.pipeline import tokenizing_iterator

    cpu = _small_tokenizers()
    gpu = tuple(copy.deepcopy(m).to(dev) for m in cpu[1:])
    clap_gpu = copy.copy(cpu[0])
    clap_gpu.model = copy.deepcopy(cpu[0].model).to(dev)
    clap_gpu.rvq = type(cpu[0].rvq)(*(None if t is None else t.to(dev) for t in cpu[0].rvq))
    rng = np.random.default_rng(0)
    lens = {"semantic": (16000, 320), "coarse": (16000, 160, 24000), "fine": (16000, 24000)}[stage]
    batches = [tuple((0.3 * rng.standard_normal((2, n))).astype(np.float32) for n in lens) for _ in range(2)]
    want = next(tokenizing_iterator(stage, iter(batches), *cpu, num_coarse_quantizers=2, accum=2))
    got = next(tokenizing_iterator(stage, iter(batches), clap_gpu, *gpu, num_coarse_quantizers=2, accum=2))
    assert all(t.device.type == dev.type and t.dtype == torch.long for t in got)
    clap, w2v, codec = cpu
    near = total = 0
    for a, batch in enumerate(batches):
        with torch.no_grad():
            emb = clap.audio_embedding(torch.from_numpy(batch[0]))
            masks = [_decided(emb, clap.rvq.codebooks, want[0][a])[:, None].expand(-1, 4)]
            if stage != "fine":
                f = w2v.features(torch.from_numpy(batch[1]))
                masks.append(_decided(f.reshape(-1, f.shape[-1]), w2v.centroids[None],
                                      want[1][a].reshape(-1, 1)).reshape(2, -1))
            if stage != "semantic":
                z = codec.embed(torch.from_numpy(batch[-1]))
                codes = codec.quantize_embedding(z)
                ok = _decided(z.reshape(-1, 8), codec.codebooks, codes.reshape(-1, 4)).reshape(2, -1)
                masks += [ok.repeat_interleave(2, 1)] * (1 if stage == "coarse" else 2)
        for t, w, m in zip(got, want, masks):
            assert torch.equal(t[a].cpu()[m], w[a][m])
            near, total = near + int((~m).sum()), total + m.numel()
    assert near <= 0.1 * total


@pytest.mark.cuda
def test_train_with_artifact_fn_launches_training_kernels(dev, tmp_path):
    """StageTrainer.train on the card, 2 steps at accum 2 with a valid batch
    and an artifact_fn at the save_results cadence: kernels 5 and 6 once a
    layer and micro-batch, kernel 1 in every forward (the training steps,
    the valid step and artifact_logits), and the token dump written."""
    from open_musiclm_torch.core.sequence import TokenSequenceSpec
    from open_musiclm_torch.models.token_cond import StageLossConfig, TokenConditionedTransformer
    from open_musiclm_torch.train.artifacts import save_predicted_tokens
    from open_musiclm_torch.train.trainer import StageTrainer

    g = torch.Generator().manual_seed(0)
    model = TokenConditionedTransformer((TokenSequenceSpec(16, 2), TokenSequenceSpec(16, 1)), 128, 2, heads=2,
                                        dim_head=64, generator=g).to(dev)
    trainer = StageTrainer(model=model, loss_cfg=StageLossConfig((0.5, 1.0)), grad_accum_every=2,
                           results_folder=str(tmp_path), save_results_every=1, stage_name="coarse",
                           use_tensorboard=False)

    def batches(accum):
        while True:
            yield (torch.randint(0, 16, (accum, 2, 6), generator=g), torch.randint(0, 16, (accum, 2, 40), generator=g))

    calls = []

    def artifact_fn(state, vb, step):
        logits, labels = trainer.artifact_logits(state, vb)
        calls.append((step, tuple(logits.shape), logits.device.type == dev.type))
        save_predicted_tokens(logits, labels, str(tmp_path), "coarse", step)

    fwd, bwd = attention.shared_kv_attention_fused, attention.shared_kv_attention_bwd
    fwd.launches = bwd.launches = bwd.dbias_launches = 0
    trainer.train(trainer.init_state(), batches(2), num_steps=2, generator=torch.Generator(device=dev).manual_seed(0),
                  valid_iter=(tuple(t[0] for t in b) for b in batches(1)), artifact_fn=artifact_fn)
    assert (bwd.launches, bwd.dbias_launches) == (2 * 2 * 2, 2 * 2 * 2)
    assert fwd.launches == 2 * 2 * 2 + 2 * 2 * 2  # train forwards, then a valid step and artifact_logits a step
    assert calls == [(0, (2, 41, 17), True), (1, (2, 41, 17), True)]
    assert (tmp_path / "coarse.tokens.1.txt").exists()


# A row's bits do not depend on its batch (ops/rows.py, kernels 2 and 7's
# grids, kernel 4's one route, Encodec a row at a time): row 1 alone against
# its slot in batches of 2, 4, 8 and 16, bit for bit.
BATCHES = (2, 4, 8, 16)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("tile", [64, 256])
def test_row_linear_rows_independent_of_batch(dev, dtype, tile):
    from open_musiclm_torch.ops.rows import row_linear

    g = torch.Generator().manual_seed(tile)
    w = _randn(g, 5460, 1024).to(dev, dtype)
    x = _randn(g, 16 * 37, 1024).to(dev, dtype)
    alone = row_linear(x[37:74], w, tile=tile)
    for b in BATCHES:
        torch.testing.assert_close(row_linear(x[:b * 37], w, tile=tile)[37:74], alone, atol=0, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_int8_matmul_rows_independent_of_batch_across_16_rows(dev, dtype):
    """Kernel 4 at 1..32 rows, across 16 rows (where a second route once
    took over): one row's bits in every batch."""
    g = torch.Generator().manual_seed(3)
    wq, s = quant.quantize_weight(_randn(g, 1024, 1025))
    wq, s, x = wq.to(dev), s.to(dev), _randn(g, 32, 1024).to(dev, dtype)
    alone = quant.int8_matmul(x[1:2].contiguous(), wq, s)
    for b in BATCHES + (17, 32):
        torch.testing.assert_close(quant.int8_matmul(x[:b], wq, s)[1:2], alone, atol=0, rtol=0)


def _row_stage(dev, dtype):
    from open_musiclm_torch.core.sequence import TokenSequenceSpec
    from open_musiclm_torch.models.token_cond import TokenConditionedTransformer

    specs = (TokenSequenceSpec(64, 2), TokenSequenceSpec(64, 3))
    model = TokenConditionedTransformer(specs, 128, 2, heads=2, generator=torch.Generator().manual_seed(5))
    return model.to(dev, dtype).eval()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("mode", [dict(quantized=True, flash_kv="int8"), dict(quantized=True, flash_kv="fused"),
                                  dict(quantized=True, flash_kv=None), dict(quantized=False)],
                         ids=["int8", "fused", "None", "fp"])
def test_stage_rows_independent_of_batch(dev, dtype, mode):
    """The prefill and 4 teacher-forced decode steps of a stage (dim 128, 2
    heads of 64): row 1's logits alone equal its logits in every batch."""
    from open_musiclm_torch.models.stages import Stage

    model = _row_stage(dev, dtype)
    g = torch.Generator().manual_seed(6)
    cond = torch.randint(0, 64, (16, 20), generator=g).to(dev)
    teacher = torch.randint(0, 64, (16, 4, 3), generator=g).to(dev)
    stage = Stage(model, **mode)

    def logits(rows):
        return stage.generate([cond[rows]], teacher_forced_ids=teacher[rows], max_time_steps=4,
                              temperature=0.0, return_logits=True)[1]

    alone = logits(slice(1, 2))[0]
    for b in BATCHES:
        torch.testing.assert_close(logits(slice(0, b))[1], alone, atol=0, rtol=0)
    with torch.no_grad():
        stream = model.assemble_stream([cond, torch.zeros((16, 0), dtype=torch.long, device=dev)])
        one = model.transformer.prefill(stream[1:2], model.transformer.init_cache(1, stream.shape[1]))[0]
        for b in BATCHES:
            got = model.transformer.prefill(stream[:b], model.transformer.init_cache(b, stream.shape[1]))[0]
            torch.testing.assert_close(got[1:2], one, atol=0, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["Cnn14", "Cnn10", "Cnn6"])
def test_pann_on_card_matches_cpu(dev, arch):
    """PANN (b2 x 0.5 s at 48 kHz, seeded weights): the card's eval forward
    within 1e-4 x max|x| of the CPU's, and its training forward moves the
    running statistics as the CPU's does."""
    import copy

    from open_musiclm_torch.models.clap.model_configs import PANNConfig
    from open_musiclm_torch.models.clap.pann import PANN

    cpu = PANN(PANNConfig(arch=arch, num_classes=16), generator=torch.Generator().manual_seed(0)).eval()
    card = copy.deepcopy(cpu).to(dev)
    x = 0.3 * torch.randn(2, 24000, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        want, got = cpu(x), card(x.to(dev))
        for key in ("embedding", "clipwise_output"):
            torch.testing.assert_close(got[key].cpu(), want[key], atol=1e-4 * float(want[key].abs().max()), rtol=0)
        cpu(x, train=True)
        card(x.to(dev), train=True)
    torch.testing.assert_close(card.bn0.running_var.cpu(), cpu.bn0.running_var, atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
def test_trace_records_card_kernels(dev, tmp_path):
    """profiling.trace on the card: the annotated range and CUDA kernel
    events are in the written trace; device_memory_stats reports a peak."""
    import json

    from open_musiclm_torch import profiling

    with profiling.trace(str(tmp_path)) as prof:
        with profiling.annotate("card_range"):
            (torch.randn(256, 256, device=dev) @ torch.randn(256, 256, device=dev)).sum().item()
    events = json.loads(open(prof.trace_path).read())["traceEvents"]
    assert any(e.get("name") == "card_range" for e in events)
    assert any(e.get("cat") == "kernel" for e in events)
    stats = profiling.device_memory_stats()
    assert stats[str(torch.device("cuda", 0))]["allocated_bytes.all.peak"] > 0
