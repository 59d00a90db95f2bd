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
@pytest.mark.parametrize("h", [4, 8])
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
    splits, _ = decode_attention.decode_splits(b, pos, N)
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
@pytest.mark.parametrize("h", [4, 8])
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


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("b", [1, 3, 8])
@pytest.mark.parametrize("pos", [0, 5, 256, 289])
def test_fused_layer_kernel(dev, dtype, b, pos):
    g = torch.Generator().manual_seed(10 * pos + b)
    packed, ins = _layer_case(g, dev, b)
    x, state = ins["x"].to(dtype), ins["ff_state"].to(dtype)
    cache = (ins["kv_cache"].clone(), ins["kv_scale"].clone())
    want = fused_layer.fused_layer_decode_step_plain(
        x.float(), packed, *cache, state.float().clone(), pos, ins["bias_row"], ins["add_mask"], heads=8)
    kv, sc = ins["kv_cache"].clone(), ins["kv_scale"].clone()
    before = fused_layer.fused_layer_decode_step.launches
    got = fused_layer.fused_layer_decode_step(
        x, packed, kv, sc, state, pos, ins["bias_row"], ins["add_mask"], heads=8)
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
