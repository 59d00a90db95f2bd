"""How the wrappers of kernels 3 and 5 cut their work over blocks, and
their plain route on CPU tensors.

The kernels run only on a card; the grid each launch takes is chosen in
Python (``ops/attention.py:bwd_kv_splits``, ``ops/fused_ff.py:ff_in_grid``
and ``ff_out_grid``), so it is checked here at the shapes the main paths
use: every (key tile, head, query tile) pair, column and k row in exactly
one block, and each cross-block fold summing its parts in one fixed order.
"""

import numpy as np
import pytest
import torch

from open_musiclm_torch.models.transformer import ConvFeedForward
from open_musiclm_torch.ops import attention, fused_ff

# training shapes (b, n) of the three stages at musiclm_small's 8 heads
TRAIN = {"semantic": (4, 514), "coarse": (2, 1116), "fine": (2, 1217)}
SMS = 132


def _kv_blocks(b, h, n, m, causal, ncp, dead=frozenset()):
    """Kernel 5's bf16 dk/dv blocks as csrc/attention_bwd.cu walks them: for
    each key tile (0 first) its splits over the batch rows, split s taking
    the visible (head, query tile) pairs of rank s mod splits, and its
    partial's index in the fold. ``dead``: (batch row, head, query tile)
    triples holding a fully masked row, visited by every key tile."""
    splits = attention.bwd_kv_splits(h, n, m, causal, ncp)
    n_qt, off = -(-n // 64), m - n
    blocks, part0 = [], 0
    for jt, sp in enumerate(splits):
        j0 = jt * 64
        for blk in range(sp * b):
            s, bi = blk // b, blk % b
            vis = []
            for p in range(h * n_qt):
                hh, it = divmod(p, n_qt)
                i0 = it * 64
                seen = (not causal or j0 <= min(i0 + 64, n) - 1 + off
                        or (ncp > 0 and i0 < ncp and j0 < ncp + off) or (bi, hh, it) in dead)
                if seen:
                    vis.append((hh, it))
            blocks.append((jt, bi, part0 + s, vis[s::sp]))
        part0 += sp
    return splits, blocks


@pytest.mark.parametrize("stage", list(TRAIN))
def test_bwd_kv_splits_training_shapes(stage):
    """Every visible (head, query tile) pair of every key tile and batch row
    in exactly one dk/dv block, no block above BWD_PAIRS_PER_BLOCK pairs,
    and each key tile's partials folded in one order (split 0, 1, ...)."""
    b, n = TRAIN[stage]
    h = 8
    splits, blocks = _kv_blocks(b, h, n, n, True, 0)
    seen = {}
    for jt, bi, part, pairs in blocks:
        assert len(pairs) <= attention.BWD_PAIRS_PER_BLOCK
        for hh, it in pairs:
            key = (jt, bi, hh, it)
            assert key not in seen, key
            seen[key] = part
    n_qt = -(-n // 64)
    want = {(jt, bi, hh, it) for jt in range(len(splits)) for bi in range(b) for hh in range(h)
            for it in range(n_qt) if jt * 64 <= min(it * 64 + 64, n) - 1}
    assert set(seen) == want
    for jt in range(len(splits)):  # the fold's order: part indices part0 .. part0 + splits - 1
        parts = sorted({part for (t, bi, part, _) in blocks if t == jt and bi == 0})
        assert parts == list(range(parts[0], parts[0] + splits[jt]))
    assert len(blocks) >= SMS and max(splits) > 1


@pytest.mark.parametrize("b,h,n,m,ncp", [
    (1, 8, 70, 70, 9), (2, 8, 37, 37, 0), (3, 4, 20, 45, 0), (2, 8, 200, 260, 66),
    (2, 8, 130, 130, 70), (1, 4, 300, 300, 5)])
def test_bwd_kv_splits_other_shapes(b, h, n, m, ncp):
    """The same cover with queries the last n of m keys, a bidirectional
    prefix, and key tiles visited by query tiles holding fully masked rows
    (those blocks may take more pairs; the cover stays exact)."""
    n_qt = -(-n // 64)
    dead = frozenset((bi, hh, 0) for bi in range(b) for hh in range(h) if bi % 2 == 1)
    for causal in (True, False):
        splits, blocks = _kv_blocks(b, h, n, m, causal, ncp, dead)
        assert all(s >= 1 for s in splits) and len(splits) == -(-m // 64)
        cover = {}
        for jt, bi, part, pairs in blocks:
            for hh, it in pairs:
                cover[(jt, bi, hh, it)] = cover.get((jt, bi, hh, it), 0) + 1
        assert set(cover.values()) == {1}
        off = m - n
        for jt in range(len(splits)):
            for bi in range(b):
                for hh in range(h):
                    for it in range(n_qt):
                        i0, j0 = it * 64, jt * 64
                        must = (not causal or j0 <= min(i0 + 64, n) - 1 + off
                                or (ncp > 0 and i0 < ncp and j0 < ncp + off))
                        if must or (bi, hh, it) in dead:
                            assert (jt, bi, hh, it) in cover


@pytest.mark.parametrize("b", [1, 8, 16])
@pytest.mark.parametrize("dim,inner", [(1024, 2730), (64, 170), (96, 256), (1024, 100)])
def test_fused_ff_grids(b, dim, inner):
    """Each launch of kernel 3: column blocks of ``cols`` columns (a multiple
    of 4 within a warp's 32 words, 124 when the rows start off 4-byte
    alignment) x splits of ``per`` k rows, every output column and k row in
    exactly one block, no more blocks than SMs (ff_in leaves one to LN(x)'s
    statistics). The scratch of b rows holds each part without overlap, on
    16-byte boundaries, with a record for each (pass, column block, split)."""
    for (blocks, cols, splits, per), k, n, target in (
            (fused_ff.ff_in_grid(dim, inner), dim, inner, SMS - 1),
            (fused_ff.ff_out_grid(dim, inner), inner, dim, SMS)):
        assert cols % 4 == 0 and cols <= (128 if n % 4 == 0 else 124)
        assert (blocks - 1) * cols < n <= blocks * cols
        assert (splits - 1) * per < k <= splits * per
        assert blocks * splits <= max(target, blocks)
        cover = np.zeros((k, n), dtype=int)
        for c in range(blocks):
            for s in range(splits):
                cover[s * per: (s + 1) * per, c * cols: (c + 1) * cols] += 1
        assert (cover == 1).all()
    cb_in, _, s_in, _ = fused_ff.ff_in_grid(dim, inner)
    cb_out, _, s_out, _ = fused_ff.ff_out_grid(dim, inner)
    offs, n_floats, n_tickets = fused_ff.ff_scratch_layout(b, dim, inner)
    passes = -(-b // 8)
    sizes = [b * inner, 2 * b, 2 * b, cb_in * b * 2, passes * cb_in * s_in * 2 * 9 * 128,
             passes * cb_out * s_out * 8 * 128]
    assert all(o % 4 == 0 for o in offs) and n_tickets == cb_in + 1 + cb_out
    assert all(o + size <= nxt for o, size, nxt in zip(offs, sizes, offs[1:] + (n_floats,)))
    if (dim, inner) == (1024, 2730):  # musiclm_small: most of the card in both launches
        assert cb_in * s_in + 1 >= 0.85 * SMS and cb_out * s_out >= 0.95 * SMS


def _ff(dim, seed):
    g = torch.Generator().manual_seed(seed)
    ff = ConvFeedForward(dim, generator=g)
    with torch.no_grad():
        ff.norm_in.gamma.normal_(1.0, 0.2, generator=g)
        ff.norm_mid.gamma.normal_(1.0, 0.2, generator=g)
    return fused_ff.pack_ff_weights(ff), ff.inner_dim


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("b", [1, 17])
def test_fused_ff_apply_cpu_is_plain(dtype, b):
    packed, inner = _ff(64, b)
    rng = np.random.default_rng(b)
    x = torch.from_numpy(rng.standard_normal((b, 64), dtype=np.float32)).to(dtype)
    state = torch.from_numpy(rng.standard_normal((b, 2, 2 * inner), dtype=np.float32)).to(dtype)
    before = fused_ff.fused_ff_apply.launches
    got = fused_ff.fused_ff_apply(x, packed, state)
    want = fused_ff.fused_ff_apply_plain(x, packed, state)
    assert fused_ff.fused_ff_apply.launches == before  # no kernel off the card
    assert all(torch.equal(a, r) for a, r in zip(got, want))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("mask,ncp", [(False, 0), (True, 9)])
def test_attention_bwd_cpu_is_plain(dtype, mask, ncp):
    rng = np.random.default_rng(ncp)
    b, h, n = 2, 8, 70

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(dtype)

    q, k = attention.l2norm(t(b, h, n, 64)), attention.l2norm(t(b, n, 64))
    v, bias, dout = t(b, n, 64), t(h, n, n), t(b, n, h * 64)
    key_mask = torch.from_numpy(rng.random((b, n)) > 0.2) if mask else None
    opts = dict(causal=True, non_causal_prefix=ncp)
    fn = attention.shared_kv_attention_bwd
    before = (fn.launches, fn.dbias_launches)
    got = fn(q, k, v, bias, key_mask, None, None, dout, **opts)
    want = attention.shared_kv_attention_bwd_plain(
        q, k, v, dout, attn_bias=bias, key_mask=key_mask, **opts)
    assert (fn.launches, fn.dbias_launches) == before  # no kernel off the card
    assert all(torch.equal(a, r) for a, r in zip(got, want))
