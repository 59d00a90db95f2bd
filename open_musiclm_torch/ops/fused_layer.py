"""One whole decode layer in one launch
(port of open_musiclm_tpu/ops/fused_layer.py).

For one token x [b, dim] and one layer, all weights int8:

    LN -> int8 Q (from the normed x) and K/V (from the raw x) -> l2norm and
    scales -> attention over the cached int8 rows j < pos plus the fresh,
    unquantized K/V row (bias at distance 0) -> int8 out-projection +
    residual -> the fused int8 conv-FF block + residual

``fused_layer_decode_step`` is the wrapper of kernel 7
(``csrc/fused_layer.cu``, replacing the Pallas kernel
``ops/fused_layer.py:fused_layer_decode_step``);
``fused_layer_decode_step_plain`` is the plain version (the JAX
``fused_layer_decode_step_xla`` twin). ``layer_plan`` is kernel 7's plan:
which weight rows each block (one an SM) holds in shared memory for the
whole launch, where, and how its warps cut them; ``attn_chunk`` cuts the
live cache into the attention's work items. Both return (y [b, dim] in x's
dtype, krow [b, 2d] float32: the fresh l2normed-and-scaled K row and V row,
new conv state [b, 2, 2*inner]), and both also do what the JAX package
leaves to its caller: they write the fresh row, quantized as
``quantize_kv_row`` does, into the cache at ``pos`` and the new conv state
into ``ff_state``, in place.

Weights are stored output-major (``W^T``, [out, in]) so the kernel reads
each output column's weights as one contiguous run; kernel 7's FF
out-projection pads ``inner`` to a multiple of 16 with zero weights. The
quantization is per output column as in the JAX package, so the int8 values
and scales are the JAX ones in another layout.
"""

from __future__ import annotations

import functools
from typing import Dict, NamedTuple, Tuple

import torch
import torch.nn.functional as F

from . import cuda_lib
from .attention import NEG_INF, l2norm
from .decode_attention import quantize_kv_row
from .fused_ff import fused_ff_apply_plain, pack_ff_weights
from .quant import quantize_weight

ALIGN = 16  # the kernel reads weight runs in 16-byte vectors


def pack_layer_weights(attn, ff) -> Dict[str, torch.Tensor]:
    """Quantize one layer's attention and conv-FF weights for kernel 7.

    ``attn`` and ``ff`` are a ``models.transformer.Attention`` and
    ``ConvFeedForward``. Int8 weights are [out, in]; ``ff_woT`` is
    [dim, inner rounded up to 16]."""
    wq, sq = quantize_weight(attn.to_q.weight.detach().t())  # [dim, h*d]
    wkv, skv = quantize_weight(attn.to_kv.weight.detach().t())  # [dim, 2d]
    wo, so = quantize_weight(attn.to_out.weight.detach().t())  # [h*d, dim]
    f = pack_ff_weights(ff)
    inner = f["wv"].shape[1]
    pad = -inner % ALIGN
    return {
        "gamma": attn.norm.gamma.detach().float().contiguous(),
        "wqT": wq.t().contiguous(), "sq": sq,
        "wkvT": wkv.t().contiguous(), "skv": skv,
        "woT": wo.t().contiguous(), "so": so,
        "q_scale": attn.q_scale.detach().float().contiguous(),
        "k_scale": attn.k_scale.detach().float().contiguous(),
        "gin": f["gin"], "wvT": f["wv"].t().contiguous(), "sv": f["sv"],
        "wgT": f["wg"].t().contiguous(), "sg": f["sg"],
        "conv_v": f["conv_v"], "conv_g": f["conv_g"], "gmid": f["gmid"],
        "ff_woT": F.pad(f["wo"].t(), (0, pad)).contiguous(), "ff_so": f["so"],
    }


def _ln(x: torch.Tensor, gamma: torch.Tensor) -> torch.Tensor:
    mean = x.mean(dim=-1, keepdim=True)
    var = x.var(dim=-1, unbiased=False, keepdim=True)
    return (x - mean) * torch.rsqrt(var + 1e-5) * gamma


def _write_fresh_row(kv_cache, kv_scale, pos, krow):
    d = krow.shape[1] // 2
    kq, ks = quantize_kv_row(krow[:, :d])
    vq, vs = quantize_kv_row(krow[:, d:])
    kv_cache[:, pos] = torch.cat([kq, vq], dim=-1)
    kv_scale[0, :, pos] = ks
    kv_scale[1, :, pos] = vs


def fused_layer_decode_step_plain(
    x: torch.Tensor,  # [b, dim]
    packed: Dict[str, torch.Tensor],
    kv_cache: torch.Tensor,  # [b, N, 2d] int8, rows j < pos live; row pos written
    kv_scale: torch.Tensor,  # [2, b, N] f32
    ff_state: torch.Tensor,  # [b, 2, 2*inner], updated in place
    pos: int,
    bias_row: torch.Tensor,  # [N, h]
    add_mask: torch.Tensor,  # [b, N] f32 additive
    *,
    heads: int,
    scale: float = 8.0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Float32 math over the whole cache buffer, the JAX XLA twin's order."""
    b, dim = x.shape
    d = kv_cache.shape[2] // 2
    N = kv_cache.shape[1]
    xf = x.float()
    qv = (_ln(xf, packed["gamma"]) @ packed["wqT"].float().t()) * packed["sq"]
    kvp = (xf @ packed["wkvT"].float().t()) * packed["skv"]
    q = l2norm(qv.reshape(b, heads, d)) * packed["q_scale"]
    k_t = l2norm(kvp[:, :d]) * packed["k_scale"]
    v_t = kvp[:, d:]
    krow = torch.cat([k_t, v_t], dim=-1)

    # cached rows j < pos, then the fresh row folded into the same softmax
    kf = kv_cache[:, :, :d].float() * kv_scale[0][:, :, None]
    vf = kv_cache[:, :, d:].float() * kv_scale[1][:, :, None]
    sim = torch.einsum("bhd,bnd->bhn", q, kf) * scale
    sim = sim + bias_row.float().t()[None] + add_mask.float()[:, None, :]
    j = torch.arange(N, device=x.device)
    sim = sim.masked_fill(j[None, None, :] >= pos, NEG_INF)
    sim_self = (q * k_t[:, None, :]).sum(dim=-1) * scale + bias_row[pos].float()[None, :]
    m = torch.maximum(sim.amax(dim=-1), sim_self)
    p = torch.exp(sim - m[:, :, None])
    p_self = torch.exp(sim_self - m)
    denom = p.sum(dim=-1) + p_self
    acc = torch.einsum("bhn,bnd->bhd", p, vf) + p_self[:, :, None] * v_t[:, None, :]
    attn = acc / torch.clamp(denom, min=1e-30)[:, :, None]

    out = (attn.reshape(b, heads * d) @ packed["woT"].float().t()) * packed["so"]
    x2 = (xf + out).to(x.dtype)
    inner = packed["wvT"].shape[0]
    ff = {
        "gin": packed["gin"], "wv": packed["wvT"].t(), "sv": packed["sv"],
        "wg": packed["wgT"].t(), "sg": packed["sg"], "conv_v": packed["conv_v"],
        "conv_g": packed["conv_g"], "gmid": packed["gmid"],
        "wo": packed["ff_woT"][:, :inner].t(), "so": packed["ff_so"],
    }
    y, new_state = fused_ff_apply_plain(x2, ff, ff_state)
    _write_fresh_row(kv_cache, kv_scale, pos, krow)
    ff_state.copy_(new_state)
    return y, krow, ff_state


@functools.lru_cache(maxsize=16)
def _packed_specs(dim, hd, d, inner, inner_p):
    """packed key -> (shape, dtype) that kernel 7 reads."""
    i8, f32 = torch.int8, torch.float32
    return {
        "gamma": ((dim,), f32), "wqT": ((hd, dim), i8), "sq": ((hd,), f32),
        "wkvT": ((2 * d, dim), i8), "skv": ((2 * d,), f32),
        "woT": ((dim, hd), i8), "so": ((dim,), f32),
        "q_scale": ((d,), f32), "k_scale": ((d,), f32),
        "gin": ((dim,), f32), "wvT": ((inner, dim), i8), "sv": ((inner,), f32),
        "wgT": ((inner, dim), i8), "sg": ((inner,), f32),
        "conv_v": ((3, inner), f32), "conv_g": ((3, inner), f32), "gmid": ((inner,), f32),
        "ff_woT": ((dim, inner_p), i8), "ff_so": ((dim,), f32),
    }


# Kernel 7's block, as csrc/fused_layer.cu takes it (constants of the same names there)
LAYER_THREADS = 256  # NT: threads a block, one block an SM
LAYER_WARPS = LAYER_THREADS // 32  # NW
LAYER_ROWS = 8  # RT: activation rows a pass over the resident weights
LAYER_COLS = 4  # NC: output columns of one warp item
LAYER_STEP = 128  # bytes of a weight row a warp reads at a time (32 lanes x 4)
DIM_HEAD = 64  # D
MAX_HEADS = 16  # MAXH
ATTN_MAX_CHUNK = 128  # CHMAX: cache rows of one attention item at most
# shared floats of an attention item (ATTN_SMEM): K and V rows [CHMAX, D + 1],
# their scales, q [MAXH, D], a row of p for each warp, the bias rows, the mask
ATTN_SMEM_FLOATS = (2 * ATTN_MAX_CHUNK * (DIM_HEAD + 1) + 2 * ATTN_MAX_CHUNK + MAX_HEADS * DIM_HEAD
                    + LAYER_WARPS * ATTN_MAX_CHUNK + ATTN_MAX_CHUNK * MAX_HEADS + ATTN_MAX_CHUNK)
SMEM_LIMIT = 232448  # dynamic shared bytes a block may use on the H100 (227 KB)
PHASES = ("B", "E", "G", "I")  # q|k|v, out-projection, FF in (v|g pairs), FF out
PLAN_HEADER = 11  # ints before the blocks' entries in the plan table
PLAN_PER_BLOCK = 3 * len(PHASES)  # (first unit, units, k slices) a phase


class LayerPlan(NamedTuple):
    """Kernel 7's launch for one layer shape: which weight rows each block
    holds in shared memory, where, and how its warps cut them.

    ``units[p]`` is phase p's count of output units, ``unit_bytes[p]`` the
    int8 bytes of one and ``k[p]`` the length of one weight row: B takes the
    rows of [wqT; wkvT] (one unit a row), E the rows of woT, G pairs (row j
    of wvT with row j of wgT), I the rows of ff_woT. ``blocks[i][p]`` is
    block i's (first unit, units, k slices) in phase p: a contiguous run of
    units, its warps taking (column group of LAYER_COLS, k slice) items.
    ``share_off[p]`` is the byte offset of phase p's share in every block's
    shared memory and ``vec_off`` that of the LayerNorm gains gamma, gin and
    gmid (prefetched with phases B, G and I). The activations stage at
    ``stage_off`` (``stage_floats`` floats, also the attention items'
    tiles), the warp items' partial sums at ``part_off``, and the staging
    copies' mbarrier at ``bar_off`` (beside it the flag of the attention's
    ticket fold). ``table`` is the int32 table the kernel reads: the header
    (the four share offsets, the three gain offsets, stage_off, part_off,
    bar_off, smem), then PLAN_PER_BLOCK ints a block."""

    grid: int
    smem: int
    units: Tuple[int, ...]
    unit_bytes: Tuple[int, ...]
    k: Tuple[int, ...]
    blocks: Tuple[Tuple[Tuple[int, int, int], ...], ...]
    share_off: Tuple[int, ...]
    vec_off: Tuple[int, ...]
    stage_off: int
    stage_floats: int
    part_off: int
    part_floats: int
    bar_off: int
    table: Tuple[int, ...]


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _align16(n: int) -> int:
    return _cdiv(n, 16) * 16


def layer_groups(phase: int, first: int, n: int, hd: int) -> int:
    """Column groups of LAYER_COLS output columns of a block's share: B keeps
    its q columns (LN(x)) and its k|v columns (raw x) in separate groups, G
    holds its n pairs as 2n columns (the v rows, then the g rows)."""
    if PHASES[phase] == "B":
        nq = max(0, min(n, hd - first))
        return _cdiv(nq, LAYER_COLS) + _cdiv(n - nq, LAYER_COLS)
    return _cdiv((2 if PHASES[phase] == "G" else 1) * n, LAYER_COLS)


def layer_slices(groups: int, k: int) -> int:
    """k slices of each column group, so that the block's warps share
    ``groups`` x slices items evenly: every warp has an item where the work
    allows, and the longest warp's steps (plus one step's worth for each of
    its items' reductions) are the fewest; ties to fewer slices."""
    steps = _cdiv(k, LAYER_STEP)
    if groups == 0:
        return 1
    least = min(steps, _cdiv(LAYER_WARPS, groups))
    cost = {s: _cdiv(groups * s, LAYER_WARPS) * (_cdiv(steps, s) + 1) for s in range(least, steps + 1)}
    return min(cost, key=lambda s: (cost[s], s))


@functools.lru_cache(maxsize=None)
def layer_plan(heads: int, dim: int, inner: int, n_blocks: int) -> LayerPlan:
    """Kernel 7's plan at ``n_blocks`` blocks (one an SM). Each phase's units
    are shared out in contiguous runs whose lengths differ by at most one;
    the extra units of each phase (the largest phase first) go to the blocks
    holding the fewest bytes so far, so that the blocks' whole shares differ
    little. Raises (``cuda_lib.require``) when a block's share and staging
    do not fit in SMEM_LIMIT."""
    d, hd = DIM_HEAD, heads * DIM_HEAD
    inner_p = inner + (-inner % ALIGN)
    units = (hd + 2 * d, dim, inner, dim)
    unit_bytes = (dim, hd, 2 * dim, inner_p)
    ks = (dim, hd, dim, inner_p)
    counts = [[0] * len(PHASES) for _ in range(n_blocks)]
    held = [0] * n_blocks
    for p in sorted(range(len(PHASES)), key=lambda p: -units[p] * unit_bytes[p]):
        base, extra = divmod(units[p], n_blocks)
        lucky = set(sorted(range(n_blocks), key=lambda i: (held[i], i))[:extra])
        for i in range(n_blocks):
            counts[i][p] = base + (i in lucky)
            held[i] += counts[i][p] * unit_bytes[p]
    blocks, first = [], [0] * len(PHASES)
    for i in range(n_blocks):
        entry = []
        for p in range(len(PHASES)):
            n = counts[i][p]
            entry.append((first[p], n, layer_slices(layer_groups(p, first[p], n, hd), ks[p])))
            first[p] += n
        blocks.append(tuple(entry))
    share_off, off = [], 0
    for p in range(len(PHASES)):
        share_off.append(off)
        off += _align16(max(c[p] for c in counts) * unit_bytes[p])
    vec_off = (off, off + 4 * dim, off + 8 * dim)
    stage_off = off + 8 * dim + _align16(4 * inner)
    stage_floats = max(2 * LAYER_ROWS * dim, LAYER_ROWS * hd, LAYER_ROWS * inner_p, ATTN_SMEM_FLOATS)
    items = max(layer_groups(p, e[p][0], e[p][1], hd) * e[p][2] for e in blocks for p in range(len(PHASES)))
    part_floats = items * LAYER_COLS * LAYER_ROWS
    part_off = stage_off + 4 * stage_floats
    bar_off = part_off + 4 * part_floats
    smem = bar_off + 16
    cuda_lib.require(
        smem <= SMEM_LIMIT,
        f"fused_layer_decode_step: dim {dim}, {heads} heads, inner {inner} at {n_blocks} blocks needs "
        f"{smem} bytes of shared memory a block (weights and gains {stage_off}, staging "
        f"{4 * stage_floats}, partials {4 * part_floats}), over the {SMEM_LIMIT}-byte limit")
    header = (*share_off, *vec_off, stage_off, part_off, bar_off, smem)
    table = header + tuple(v for e in blocks for ph in e for v in ph)
    return LayerPlan(n_blocks, smem, units, unit_bytes, ks, tuple(blocks), tuple(share_off), vec_off, stage_off,
                     stage_floats, part_off, part_floats, bar_off, table)


def attn_chunk(b: int, pos: int, n_blocks: int) -> Tuple[int, int]:
    """(cache rows an attention item, items a batch row): the live rows j <
    pos of each batch row cut so that the b x items fill the grid once
    where ATTN_MAX_CHUNK allows."""
    per_row = max(1, n_blocks // b)
    chunk = min(ATTN_MAX_CHUNK, max(1, _cdiv(pos, per_row)))
    return chunk, _cdiv(pos, chunk)


def workspace_floats(b: int, heads: int, d: int, dim: int, inner: int, n_chunks: int) -> int:
    """Float32 scratch of one kernel 7 call, in the order the kernel carves
    it, each part a multiple of 16 floats: raw q [b, h*d], raw k|v [b, 2d],
    the attention output [b, h*d], x2 [b, dim], g [b, inner rounded up to
    16], then the attention partials [b, chunks, h, d + 2] (max,
    denominator, d sums of one chunk of the rows < pos)."""
    inner_p = inner + (-inner % ALIGN)
    return b * (2 * heads * d + 2 * d + dim + inner_p + n_chunks * heads * (d + 2))


@functools.lru_cache(maxsize=None)
def _device_plan(heads: int, dim: int, inner: int, device: torch.device):
    """(``layer_plan`` at one block an SM of ``device``, its table there)."""
    plan = layer_plan(heads, dim, inner, cuda_lib.sm_count(device))
    return plan, torch.tensor(plan.table, dtype=torch.int32, device=device)


def fused_layer_decode_step(
    x: torch.Tensor,
    packed: Dict[str, torch.Tensor],
    kv_cache: torch.Tensor,
    kv_scale: torch.Tensor,
    ff_state: torch.Tensor,
    pos: int,
    bias_row: torch.Tensor,
    add_mask: torch.Tensor,
    *,
    heads: int,
    scale: float = 8.0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Kernel 7, one cooperative launch of ``layer_plan``'s grid. Same
    contract as ``fused_layer_decode_step_plain``."""
    if not x.is_cuda:
        return fused_layer_decode_step_plain(
            x, packed, kv_cache, kv_scale, ff_state, pos, bias_row, add_mask,
            heads=heads, scale=scale)
    name = "fused_layer_decode_step"
    b, dim = x.shape
    N, two_d = kv_cache.shape[1], kv_cache.shape[2]
    d = two_d // 2
    inner = ff_state.shape[2] // 2
    inner_p = inner + (-inner % ALIGN)
    cuda_lib.require(d == DIM_HEAD, f"{name}: kernel takes dim_head {DIM_HEAD}, got {d}")
    cuda_lib.require(1 <= heads <= MAX_HEADS, f"{name}: kernel takes 1..{MAX_HEADS} heads, got {heads}")
    cuda_lib.require(dim % ALIGN == 0, f"{name}: dim must be a multiple of {ALIGN}, got {dim}")
    cuda_lib.require(0 <= pos < N, f"{name}: pos {pos} outside the {N}-row cache")
    cuda_lib.require(kv_cache.shape == (b, N, 2 * d) and kv_cache.dtype == torch.int8,
                     f"{name}: kv_cache int8 [b, N, 2d]")
    cuda_lib.require(kv_scale.shape == (2, b, N) and kv_scale.dtype == torch.float32,
                     f"{name}: kv_scale f32 [2, b, N]")
    cuda_lib.require(ff_state.shape == (b, 2, 2 * inner) and ff_state.dtype == x.dtype,
                     f"{name}: ff_state [b, 2, 2*inner] in x's dtype")
    cuda_lib.require(bias_row.dtype == torch.float32 and bias_row.shape == (N, heads),
                     f"{name}: bias_row f32 [N, h]")
    cuda_lib.require(add_mask.dtype == torch.float32 and add_mask.shape == (b, N),
                     f"{name}: add_mask f32 [b, N]")
    specs = _packed_specs(dim, heads * d, d, inner, inner_p)
    bad = [k for k, (shape, dtype) in specs.items() if packed[k].shape != shape or packed[k].dtype != dtype]
    cuda_lib.require(not bad, f"{name}: packed {bad} not as pack_layer_weights makes them "
                              f"for dim {dim}, {heads} heads, inner {inner}")
    weights = [packed[k] for k in specs]
    cuda_lib.require_cuda(name, x, kv_cache, kv_scale, ff_state, bias_row, add_mask, *weights)
    ptrs = [t.data_ptr() for t in (x, kv_cache, *weights)]
    cuda_lib.require(all(p % 16 == 0 for p in ptrs), f"{name}: x, the cache and the weights must "
                                                     f"start on 16-byte boundaries")
    plan, table = _device_plan(heads, dim, inner, x.device)
    chunk, n_chunks = attn_chunk(b, pos, plan.grid)
    y = torch.empty_like(x)
    krow = torch.empty(b, 2 * d, dtype=torch.float32, device=x.device)
    tickets, work = cuda_lib.stream_scratch(name, x, b, workspace_floats(b, heads, d, dim, inner, n_chunks))
    rc = cuda_lib.lib().omt_fused_layer(
        ptrs[0], *ptrs[2:], ptrs[1], kv_scale.data_ptr(), bias_row.data_ptr(), add_mask.data_ptr(),
        ff_state.data_ptr(), y.data_ptr(), krow.data_ptr(), work.data_ptr(), work.numel(),
        table.data_ptr(), tickets.data_ptr(), plan.grid, plan.smem, b, heads, dim, inner, N,
        int(pos), chunk, n_chunks, float(scale), cuda_lib.dtype_code(x.dtype), cuda_lib.stream(x),
    )
    cuda_lib.check(rc, name)
    fused_layer_decode_step.launches += 1
    return y, krow, ff_state


fused_layer_decode_step.launches = 0
