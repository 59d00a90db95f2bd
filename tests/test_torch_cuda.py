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

from open_musiclm_torch.ops import attention, decode_attention, fused_ff, quant
from open_musiclm_torch.models.transformer import ConvFeedForward

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
