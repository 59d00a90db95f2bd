"""How the wrappers of kernels 3, 4, 5 and 7 cut their work over blocks, and
their plain route on CPU tensors.

The kernels run only on a card; the grid each launch takes is chosen in
Python (``ops/attention.py:bwd_kv_splits``, ``ops/fused_ff.py:ff_in_grid``
and ``ff_out_grid``, ``ops/quant.py``'s two routes and ``int8_stream_grid``,
``ops/fused_layer.py:layer_plan`` and ``attn_chunk``),
so it is checked here at the shapes the main paths use: every (key tile,
head, query tile) pair, column and k row in exactly one block, each
cross-block fold summing its parts in one fixed order, and kernel 7's
resident weight shares within the card's shared memory.
"""

import numpy as np
import pytest
import torch

from open_musiclm_torch.models.transformer import ConvFeedForward
from open_musiclm_torch.ops import attention, fused_ff, fused_layer, quant

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


# kernel 4's weights (K, N): the logit head, the int8 projections of the
# fused_ff=False decode step, and ragged ones (K off the 16-row step, N off 4)
INT8_SHAPES = [(1024, 1025), (1024, 512), (1024, 128), (512, 1024), (1024, 5460), (2730, 1024),
               (100, 33), (1000, 1027), (72, 4096)]


@pytest.mark.parametrize("K,N,aligned", [(k, n, a) for k, n in INT8_SHAPES
                                         for a in ((True, False) if n % 4 == 0 else (False,))])
def test_int8_stream_grid(K, N, aligned):
    """Kernel 4's stream route: column blocks of ``cols`` columns (a multiple
    of 4; 124 at most when W's rows start off 4-byte alignment) x splits of
    ``per`` k rows in whole 16-row steps, every output column and k row in
    exactly one block, no more blocks than SMs (unless one column block a
    split is already more), the splits of a column block folded in order."""
    blocks, cols, splits, per = quant.int8_stream_grid(K, N, aligned)
    assert cols % 4 == 0 and cols <= (128 if aligned else 124) and per % 16 == 0
    assert (blocks - 1) * cols < N <= blocks * cols
    assert (splits - 1) * per < K <= splits * per
    assert blocks * splits <= max(SMS, blocks)
    cover = np.zeros((K, N), dtype=int)
    for c in range(blocks):
        for s in range(splits):
            cover[s * per: (s + 1) * per, c * cols: (c + 1) * cols] += 1
    assert (cover == 1).all()
    if (K, N) == (1024, 1025):  # the head: 9 column blocks x 13 splits
        assert (blocks, splits) == (9, 13)


@pytest.mark.parametrize("B", [1, 8, 14, 16, 32, 33, 64, 256, 300])
def test_int8_route(B):
    """Kernel 4's one route at B rows of the head: the stream at every B (so
    that a row's sums do not change with the batch), in passes of 8 (the
    scratch holds a record for each pass, column block and split), covers
    every output once."""
    _stream_cover(B, 1024, 1025)


def _stream_cover(B, K, N):
    out = np.zeros((B, N), dtype=int)
    blocks, cols, splits, per = quant.int8_stream_grid(K, N, False)
    passes = -(-B // 8)
    for p in range(passes):
        for c in range(blocks):
            out[p * 8:(p + 1) * 8, c * cols:(c + 1) * cols] += 1
    assert passes * 8 >= B > (passes - 1) * 8
    assert (out == 1).all()


@pytest.mark.parametrize("K,N", INT8_SHAPES)
@pytest.mark.parametrize("B", [33, 64, 256, 300])
def test_int8_stream_passes(B, K, N):
    """The stream at the fine stage's and larger row counts, over every
    weight shape: each output (row, column) in exactly one (pass, column
    block), every pass over the same grid."""
    _stream_cover(B, K, N)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("B", [1, 8, 17, 40, 64, 300])
def test_int8_matmul_cpu_is_plain(dtype, B):
    rng = np.random.default_rng(B)
    x = torch.from_numpy(rng.standard_normal((B, 96), dtype=np.float32)).to(dtype)
    wq, s = quant.quantize_weight(torch.from_numpy(rng.standard_normal((96, 130), dtype=np.float32)))
    before = quant.int8_matmul.launches
    got = quant.int8_matmul(x, wq, s)
    assert quant.int8_matmul.launches == before  # no kernel off the card
    assert torch.equal(got, quant.int8_matmul_plain(x, wq, s))


def test_quantize_weight_contiguous():
    """Projections quantized from a transposed [out, in] weight come out
    contiguous, as kernel 4 reads them (the fused_ff=False decode step)."""
    rng = np.random.default_rng(3)
    w = torch.from_numpy(rng.standard_normal((130, 96), dtype=np.float32))
    wq, s = quant.quantize_weight(w.t())
    assert wq.is_contiguous() and s.is_contiguous() and wq.shape == (96, 130)
    assert torch.equal(wq, quant.quantize_weight(w.t().contiguous())[0])


# kernel 7's layer shapes (heads, dim, inner): musiclm_small and musiclm_large
# (configs/model/*.json: dim 1024, 8 / 16 heads of 64, conv-FF inner 2730),
# and the card tests' narrow layer
LAYERS = {"small": (8, 1024, 2730), "large": (16, 1024, 2730), "narrow": (8, 256, 682)}


@pytest.mark.parametrize("blocks", [SMS, 114])  # H100 SXM, H100 PCIe
@pytest.mark.parametrize("layer", list(LAYERS))
def test_layer_plan_cover(layer, blocks):
    """Every output unit of every phase (B: the rows of [wqT; wkvT], E: woT,
    G: (wvT, wgT) row pairs, I: ff_woT) in exactly one block's contiguous
    run, runs in block order, and a phase's runs within one unit of each
    other: the shares differ by at most one weight row's bytes."""
    heads, dim, inner = LAYERS[layer]
    plan = fused_layer.layer_plan(heads, dim, inner, blocks)
    inner_p = -(-inner // 16) * 16
    assert plan.units == (heads * 64 + 128, dim, inner, dim)
    assert plan.unit_bytes == (dim, heads * 64, 2 * dim, inner_p)
    assert len(plan.blocks) == plan.grid == blocks
    for p in range(len(fused_layer.PHASES)):
        cover = np.zeros(plan.units[p], dtype=int)
        nxt = 0
        for entry in plan.blocks:
            first, n, _ = entry[p]
            assert first == nxt
            cover[first: first + n] += 1
            nxt = first + n
        assert (cover == 1).all()
        counts = [e[p][1] for e in plan.blocks]
        assert max(counts) - min(counts) <= 1
        assert (max(counts) - min(counts)) * plan.unit_bytes[p] <= max(plan.unit_bytes)
    held = [sum(e[p][1] * plan.unit_bytes[p] for p in range(4)) for e in plan.blocks]
    assert max(held) - min(held) <= sum(plan.unit_bytes)


@pytest.mark.parametrize("layer", list(LAYERS))
def test_layer_plan_warps_and_slices(layer):
    """A block's (column group, k slice) items: k slices within the row's
    128-byte steps, every warp with an item wherever the share has as many
    (group, step) pairs as the block has warps, and no warp with more than
    one item above its fair share."""
    heads, dim, inner = LAYERS[layer]
    plan = fused_layer.layer_plan(heads, dim, inner, SMS)
    warps = fused_layer.LAYER_WARPS
    for entry in plan.blocks:
        for p, (first, n, slices) in enumerate(entry):
            groups = fused_layer.layer_groups(p, first, n, heads * 64)
            steps = -(-plan.k[p] // fused_layer.LAYER_STEP)
            assert 1 <= slices <= steps
            cols = 2 * n if fused_layer.PHASES[p] == "G" else n
            assert groups * fused_layer.LAYER_COLS >= cols > (groups - 2) * fused_layer.LAYER_COLS or n == 0
            if groups * steps >= warps:
                assert groups * slices >= warps
            items = groups * slices
            assert items * 32 <= plan.part_floats


@pytest.mark.parametrize("layer", list(LAYERS))
def test_layer_plan_shared_memory(layer):
    """Shares, gains, staging, partials and the staging copies' mbarrier
    in disjoint 16-byte aligned regions of one block's shared memory, each as large as the
    largest block's need, all within the H100's 227 KB (both shipped
    configurations fit at 132 blocks), and the table the kernel reads laid
    out as its header then each block's entries."""
    heads, dim, inner = LAYERS[layer]
    plan = fused_layer.layer_plan(heads, dim, inner, SMS)
    hd, inner_p = heads * 64, -(-inner // 16) * 16
    ends = [off + max(e[p][1] for e in plan.blocks) * plan.unit_bytes[p]
            for p, off in enumerate(plan.share_off)]
    regions = ([(off, end) for off, end in zip(plan.share_off, ends)]
               + [(plan.vec_off[0], plan.vec_off[0] + 4 * dim), (plan.vec_off[1], plan.vec_off[1] + 4 * dim),
                  (plan.vec_off[2], plan.vec_off[2] + 4 * inner),
                  (plan.stage_off, plan.stage_off + 4 * plan.stage_floats),
                  (plan.part_off, plan.part_off + 4 * plan.part_floats),
                  (plan.bar_off, plan.bar_off + 16)])
    for (a0, a1), (b0, _) in zip(regions, regions[1:]):
        assert a0 % 16 == 0 and a1 <= b0
    assert regions[-1][1] == plan.smem <= fused_layer.SMEM_LIMIT
    rows = fused_layer.LAYER_ROWS
    # phase B holds x and LN(x) (x's bf16 rows land where LN(x) goes), the
    # attention items their tiles
    assert plan.stage_floats >= max(2 * rows * dim, rows * hd, rows * inner_p, fused_layer.ATTN_SMEM_FLOATS)
    header = plan.table[:fused_layer.PLAN_HEADER]
    assert header == (*plan.share_off, *plan.vec_off, plan.stage_off, plan.part_off, plan.bar_off,
                      plan.smem)
    assert len(plan.table) == fused_layer.PLAN_HEADER + SMS * fused_layer.PLAN_PER_BLOCK
    assert plan.table[fused_layer.PLAN_HEADER:] == tuple(v for e in plan.blocks for ph in e for v in ph)
    if layer != "narrow":  # the weights of one layer spread over the card: ~1/132 each
        total = sum(u * ub for u, ub in zip(plan.units, plan.unit_bytes))
        assert plan.vec_off[0] <= 1.1 * total / SMS


@pytest.mark.parametrize("heads,dim,inner", [(8, 1024, 16384), (16, 4096, 2730), (8, 1024, 2730)])
def test_layer_plan_over_budget_raises(heads, dim, inner):
    """A layer whose share and staging do not fit a block raises with the
    numbers (the wrapper calls layer_plan before it launches); at 8 blocks
    even musiclm_small's layer is over the limit."""
    blocks = 8 if inner == 2730 and dim == 1024 else SMS
    with pytest.raises(ValueError, match=r"bytes of shared memory a block .* over the 232448-byte limit"):
        fused_layer.layer_plan(heads, dim, inner, blocks)


@pytest.mark.parametrize("b,pos", [(8, 1279), (1, 1279), (14, 1279), (17, 700), (3, 5), (8, 1), (8, 0), (200, 1279)])
def test_attn_chunk_fills_grid(b, pos):
    """Each batch row's live rows j < pos in chunks of at most ATTN_MAX_CHUNK
    rows: the chunks cover [0, pos) exactly, and ATTN_BATCH (8) rows' chunks
    fill the grid once where the largest chunk allows (pos 1279: one round
    on 132 SMs). The cut is a function of pos alone: b rows' items take
    cdiv(b x chunks, grid) rounds, and a row's chunks fold in one order in
    any batch."""
    chunk, n_chunks = fused_layer.attn_chunk(pos, SMS)
    assert 1 <= chunk <= fused_layer.ATTN_MAX_CHUNK
    assert (n_chunks - 1) * chunk < pos <= n_chunks * chunk or pos == n_chunks == 0
    if -(-pos // (SMS // fused_layer.ATTN_BATCH)) <= fused_layer.ATTN_MAX_CHUNK:
        assert fused_layer.ATTN_BATCH * n_chunks <= SMS
    if pos == 1279:
        assert n_chunks == SMS // fused_layer.ATTN_BATCH and b * n_chunks <= SMS * -(-b // 8)


def test_layer_workspace_layout():
    """Kernel 7's scratch: the parts it reads in 16-byte runs (attention
    output, x2, g with rows padded to 16) start on 16-byte boundaries."""
    b, heads, dim, inner = 3, 16, 1024, 2730
    chunk, n_chunks = fused_layer.attn_chunk(1279, SMS)
    inner_p = -(-inner // 16) * 16
    sizes = [b * heads * 64, b * 128, b * heads * 64, b * dim, b * inner_p, b * n_chunks * heads * 66]
    offs = np.cumsum([0] + sizes[:-1])
    assert all(o % 4 == 0 for o in offs[:5])
    assert fused_layer.workspace_floats(b, heads, 64, dim, inner, n_chunks) == sum(sizes)


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


@pytest.mark.parametrize("dtype,bias_dtype", [
    (torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16), (torch.bfloat16, torch.float32)],
    ids=["f32", "bf16", "bf16-bias_f32"])
@pytest.mark.parametrize("mask,ncp", [(False, 0), (True, 9)])
def test_attention_bwd_cpu_is_plain(dtype, bias_dtype, mask, ncp):
    rng = np.random.default_rng(ncp)
    b, h, n = 2, 8, 70

    def t(*shape, dt=dtype):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(dt)

    q, k = attention.l2norm(t(b, h, n, 64)), attention.l2norm(t(b, n, 64))
    v, bias, dout = t(b, n, 64), t(h, n, n, dt=bias_dtype), t(b, n, h * 64)
    key_mask = torch.from_numpy(rng.random((b, n)) > 0.2) if mask else None
    opts = dict(causal=True, non_causal_prefix=ncp)
    fn = attention.shared_kv_attention_bwd
    before = (fn.launches, fn.dbias_launches)
    got = fn(q, k, v, bias, key_mask, None, None, dout, **opts)
    want = attention.shared_kv_attention_bwd_plain(
        q, k, v, dout, attn_bias=bias, key_mask=key_mask, **opts)
    assert (fn.launches, fn.dbias_launches) == before  # no kernel off the card
    assert all(torch.equal(a, r) for a, r in zip(got, want))
