"""Fused int8 conv-feed-forward decode step (port of open_musiclm_tpu/ops/fused_ff.py).

One decode step of the conv-FF block for x [b, dim] and the conv state
[b, 2, 2*inner]:

    LN -> @ W_in (int8) -> causal 3-tap conv -> GEGLU -> mid-LN -> @ W_out (int8) -> + x

``fused_ff_apply`` is the wrapper of kernel 3 (``csrc/fused_ff.cu``,
replacing the Pallas kernel ``ops/fused_ff.py:fused_ff_apply``), two
launches behind one call; ``fused_ff_apply_plain`` is the plain version
(the JAX ``fused_ff_apply_xla`` twin). The JAX package pads ``inner`` to
128 lanes for Mosaic; the port keeps the true width. Quantization is per
output column, so the int8 values and scales are the JAX ones without the
padding.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from . import cuda_lib
from .quant import quantize_weight


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
    g = torch.empty((b, inner), dtype=torch.float32, device=x.device)
    new_state = torch.empty_like(state)
    y = torch.empty_like(x)
    lib, dt, st = cuda_lib.lib(), cuda_lib.dtype_code(x.dtype), cuda_lib.stream(x)
    p = {k: t.data_ptr() for k, t in packed.items()}
    rc = lib.omt_fused_ff_in(
        x.data_ptr(), p["gin"], p["wv"], p["sv"], p["wg"], p["sg"], p["conv_v"], p["conv_g"],
        state.data_ptr(), g.data_ptr(), new_state.data_ptr(), b, dim, inner, dt, st,
    )
    cuda_lib.check(rc, name + " (in)")
    rc = lib.omt_fused_ff_out(
        g.data_ptr(), p["gmid"], p["wo"], p["so"], x.data_ptr(), y.data_ptr(),
        b, inner, dim, dt, st,
    )
    cuda_lib.check(rc, name + " (out)")
    fused_ff_apply.launches += 1
    return y, new_state


fused_ff_apply.launches = 0
