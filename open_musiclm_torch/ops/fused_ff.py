"""Fused int8 conv-feed-forward decode step (port of open_musiclm_tpu/ops/fused_ff.py).

One decode step of the conv-FF block for x [b, dim] and the conv state
[b, 2, 2*inner]:

    LN -> @ W_in (int8) -> causal 3-tap conv -> GEGLU -> mid-LN -> @ W_out (int8) -> + x

``fused_ff_apply`` is the wrapper of kernel 3 (``csrc/fused_ff.cu``,
replacing the Pallas kernel ``ops/fused_ff.py:fused_ff_apply``), two
launches behind one call; ``fused_ff_apply_plain`` is the plain version
(the JAX ``fused_ff_apply_xla`` twin). ``ff_in_grid`` and ``ff_out_grid``
give the two launches' grids, ``ff_scratch_layout`` their scratch. The JAX
package pads ``inner`` to 128 lanes for Mosaic; the port keeps the true
width. Quantization is per output column, so the int8 values and scales are
the JAX ones without the padding.
"""

from __future__ import annotations

import functools
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from . import cuda_lib
from .quant import quantize_weight

FF_ROWS = 8  # activation rows a pass of kernel 3 (csrc/fused_ff.cu: RB)
FF_SEG = 128  # columns a block at most: a row's 128 bytes over 8 lanes (csrc/fused_ff.cu: SEG)
FF_STEP = 16  # k rows a warp takes at a time (csrc/fused_ff.cu: KS)
FF_IN_RECORD = 2 * (FF_ROWS + 1) * FF_SEG  # floats of an ff_in block's partial (REC_IN)
FF_OUT_RECORD = FF_ROWS * FF_SEG  # floats of an ff_out block's partial (REC_OUT)
FF_TARGET_BLOCKS = 132  # one block for each of the H100's SMs
FF_MIN_ROWS = 64  # k rows a split at the least, so that a partial is small beside its weights


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def ff_grid(k_rows: int, n_cols: int, target: int) -> Tuple[int, int, int, int]:
    """(column blocks, columns a block, splits, k rows a split) of one of
    kernel 3's weight streams over int8 [k_rows, n_cols] matrices.

    A warp reads ``cols`` consecutive columns of 16 rows at a time as
    aligned 4-byte words: up to 128 columns when rows start 4-byte aligned,
    124 when not (the words start up to 3 bytes before the columns). Column
    blocks are as few as that allows, with the columns spread evenly over
    them; k is split so that the blocks reach ``target`` where k allows,
    ``FF_MIN_ROWS`` rows a split at the least, in whole 16-row steps. Block
    (c, s) takes columns [c * cols, (c + 1) * cols) and k rows [s * per,
    min((s + 1) * per, k_rows)); a column block's splits are summed in split
    order."""
    max_cols = FF_SEG if n_cols % 4 == 0 else FF_SEG - 4
    cols = _cdiv(_cdiv(n_cols, _cdiv(n_cols, max_cols)), 4) * 4
    blocks = _cdiv(n_cols, cols)
    want = max(1, min(_cdiv(k_rows, FF_MIN_ROWS), target // blocks))
    per = _cdiv(_cdiv(k_rows, want), FF_STEP) * FF_STEP
    return blocks, cols, _cdiv(k_rows, per), per


@functools.lru_cache(maxsize=None)
def ff_in_grid(dim: int, inner: int) -> Tuple[int, int, int, int]:
    """``ff_grid`` of kernel 3's first launch (Wv and Wg side by side); one
    SM is left to the block that computes LN(x)'s statistics."""
    return ff_grid(dim, inner, FF_TARGET_BLOCKS - 1)


@functools.lru_cache(maxsize=None)
def ff_out_grid(dim: int, inner: int) -> Tuple[int, int, int, int]:
    """``ff_grid`` of kernel 3's second launch (Wout)."""
    return ff_grid(inner, dim, FF_TARGET_BLOCKS)


@functools.lru_cache(maxsize=None)
def ff_scratch_layout(b: int, dim: int, inner: int) -> Tuple[Tuple[int, ...], int, int]:
    """(float offsets, floats, tickets) of kernel 3's scratch for b rows:
    g [b, inner], LN(x)'s and the mid-LN's statistics [b, 2] each, the
    column blocks' mid-LN sums [ff_in column blocks, b, 2], then the two
    launches' block partials [passes, column blocks, splits, record], each
    part on a 16-byte boundary; a ticket for each column block of the two
    launches and one for the mid-LN fold. The grids and this layout are
    kept for each shape, so a decode step does not work them out again."""
    cb_in, _, s_in, _ = ff_in_grid(dim, inner)
    cb_out, _, s_out, _ = ff_out_grid(dim, inner)
    passes = _cdiv(b, FF_ROWS)
    sizes = [b * inner, b * 2, b * 2, cb_in * b * 2, passes * cb_in * s_in * FF_IN_RECORD,
             passes * cb_out * s_out * FF_OUT_RECORD]
    offs = [0]
    for n in sizes[:-1]:
        offs.append(offs[-1] + _cdiv(n, 4) * 4)
    return tuple(offs), offs[-1] + sizes[-1], cb_in + 1 + cb_out


def pack_ff_weights(ff) -> Dict[str, torch.Tensor]:
    """Quantize one layer's conv-FF weights for the decode step.

    ``ff`` is a ``models.transformer.ConvFeedForward``. Int8 weights keep the
    JAX ``[in, out]`` layout; the vectors are float32.
    """
    w_in = ff.proj_in.weight.detach().t()  # [dim, 2*inner]
    inner = w_in.shape[1] // 2
    wv, sv = quantize_weight(w_in[:, :inner])
    wg, sg = quantize_weight(w_in[:, inner:])
    wo, so = quantize_weight(ff.proj_out.weight.detach().t())  # [inner, dim]
    conv = ff.conv_w.detach().float()  # [3, 2*inner]
    return {
        "gin": ff.norm_in.gamma.detach().float().contiguous(),
        "wv": wv.contiguous(), "sv": sv, "wg": wg.contiguous(), "sg": sg,
        "conv_v": conv[:, :inner].contiguous(), "conv_g": conv[:, inner:].contiguous(),
        "gmid": ff.norm_mid.gamma.detach().float().contiguous(),
        "wo": wo.contiguous(), "so": so,
    }


def fused_ff_apply_plain(
    x: torch.Tensor, packed: Dict[str, torch.Tensor], state: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (x + FF(x), new state [b, 2, 2*inner]) with float32 math."""
    inner = state.shape[2] // 2
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, unbiased=False, keepdim=True)
    h = (xf - mean) * torch.rsqrt(var + 1e-5) * packed["gin"][None, :]
    u_v = (h @ packed["wv"].float()) * packed["sv"][None, :]
    u_g = (h @ packed["wg"].float()) * packed["sg"][None, :]
    s0 = state[:, 0, :].float()
    s1 = state[:, 1, :].float()
    cv, cg = packed["conv_v"], packed["conv_g"]
    conv_v = s0[:, :inner] * cv[0] + s1[:, :inner] * cv[1] + u_v * cv[2]
    conv_g = s0[:, inner:] * cg[0] + s1[:, inner:] * cg[1] + u_g * cg[2]
    g = F.gelu(conv_g, approximate="none") * conv_v
    mu = g.sum(dim=-1, keepdim=True) / inner
    var_g = (g * g).sum(dim=-1, keepdim=True) / inner - mu * mu
    gn = (g - mu) * torch.rsqrt(var_g + 1e-5) * packed["gmid"][None, :]
    out = (gn @ packed["wo"].float()) * packed["so"][None, :]
    y = (xf + out).to(x.dtype)
    u = torch.cat([u_v, u_g], dim=-1).to(state.dtype)
    return y, torch.stack([state[:, 1, :], u], dim=1)


def fused_ff_apply(
    x: torch.Tensor, packed: Dict[str, torch.Tensor], state: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel 3. Same contract as ``fused_ff_apply_plain``."""
    if not x.is_cuda:
        return fused_ff_apply_plain(x, packed, state)
    name = "fused_ff_apply"
    b, dim = x.shape
    inner = state.shape[2] // 2
    cuda_lib.require(state.shape == (b, 2, 2 * inner), f"{name}: state [b, 2, 2*inner]")
    cuda_lib.require(state.dtype == x.dtype, f"{name}: state dtype must match x")
    for key, shape, dtype in (
        ("gin", (dim,), torch.float32), ("gmid", (inner,), torch.float32),
        ("wv", (dim, inner), torch.int8), ("wg", (dim, inner), torch.int8),
        ("sv", (inner,), torch.float32), ("sg", (inner,), torch.float32),
        ("conv_v", (3, inner), torch.float32), ("conv_g", (3, inner), torch.float32),
        ("wo", (inner, dim), torch.int8), ("so", (dim,), torch.float32),
    ):
        t = packed[key]
        cuda_lib.require(t.shape == shape and t.dtype == dtype, f"{name}: {key} must be {dtype} {shape}")
    cuda_lib.require_cuda(name, x, state, *packed.values())
    cuda_lib.require(all(packed[k].data_ptr() % 4 == 0 for k in ("wv", "wg", "wo")),
                     f"{name}: int8 weights must be 4-byte aligned")
    new_state = torch.empty_like(state)
    y = torch.empty_like(x)
    cb_in, cols_in, s_in, per_in = ff_in_grid(dim, inner)
    cb_out, cols_out, s_out, per_out = ff_out_grid(dim, inner)
    offs, n_floats, n_tickets = ff_scratch_layout(b, dim, inner)
    tickets, floats = cuda_lib.stream_scratch("fused_ff", x, n_tickets, n_floats)
    g, xstats, midstats, part_stats, part_in, part_out = (floats.data_ptr() + 4 * o for o in offs)
    lib, dt, st = cuda_lib.lib(), cuda_lib.dtype_code(x.dtype), cuda_lib.stream(x)
    p = {k: t.data_ptr() for k, t in packed.items()}
    rc = lib.omt_fused_ff_in(
        x.data_ptr(), p["gin"], p["wv"], p["sv"], p["wg"], p["sg"], p["conv_v"], p["conv_g"],
        state.data_ptr(), g, new_state.data_ptr(), xstats, part_in, part_stats, midstats,
        tickets.data_ptr(), b, dim, inner, cols_in, cb_in, s_in, per_in, dt, st,
    )
    cuda_lib.check(rc, name + " (in)")
    rc = lib.omt_fused_ff_out(
        g, midstats, p["gmid"], p["wo"], p["so"], x.data_ptr(), y.data_ptr(), part_out,
        tickets.data_ptr() + 4 * (cb_in + 1), b, inner, dim, cols_out, cb_out, s_out, per_out,
        dt, st,
    )
    cuda_lib.check(rc, name + " (out)")
    fused_ff_apply.launches += 1
    return y, new_state


fused_ff_apply.launches = 0
