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
``fused_layer_decode_step_xla`` twin). Both return (y [b, dim] in x's
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
from typing import Dict, Tuple

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


def workspace_floats(b: int, heads: int, d: int, dim: int, inner: int, pos: int) -> int:
    """Float32 scratch of one kernel 7 call, in the order the kernel carves
    it: krow [b, 2d], raw q [b, h*d], raw k|v [b, 2d], attention partials
    [b, chunks, h, d + 2] (max, denominator, d sums a 64-row chunk of the
    rows < pos), the attention output [b, h*d], x2 [b, dim], g [b, inner]."""
    chunks = -(-pos // 64)
    return b * (2 * d + heads * d + 2 * d + chunks * heads * (d + 2) + heads * d + dim + inner)


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
    """Kernel 7, one cooperative launch. Same contract as
    ``fused_layer_decode_step_plain``."""
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
    cuda_lib.require(d == 64, f"{name}: kernel takes dim_head 64, got {d}")
    cuda_lib.require(1 <= heads <= 16, f"{name}: kernel takes 1..16 heads, got {heads}")
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
    y = torch.empty_like(x)
    work = torch.empty(workspace_floats(b, heads, d, dim, inner, pos), dtype=torch.float32, device=x.device)
    rc = cuda_lib.lib().omt_fused_layer(
        x.data_ptr(), *(t.data_ptr() for t in weights), kv_cache.data_ptr(), kv_scale.data_ptr(),
        bias_row.data_ptr(), add_mask.data_ptr(), ff_state.data_ptr(), y.data_ptr(),
        work.data_ptr(), work.numel(), b, heads, dim, inner, N, int(pos), float(scale),
        cuda_lib.dtype_code(x.dtype), cuda_lib.stream(x),
    )
    cuda_lib.check(rc, name)
    fused_layer_decode_step.launches += 1
    return y, work[: b * 2 * d].view(b, 2 * d), ff_state


fused_layer_decode_step.launches = 0
