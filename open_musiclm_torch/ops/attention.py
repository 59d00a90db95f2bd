"""Cosine-similarity shared-KV attention (port of open_musiclm_tpu/ops/attention.py).

Queries are multi-head ``[b, h, n, d]``; keys and values are ONE head
``[b, m, d]`` shared by all query heads. q and k arrive l2-normalised and
scaled; the similarity uses a fixed scale (8).

``shared_kv_attention`` is the plain version. ``shared_kv_attention_fused``
is the wrapper of kernel 1 (``csrc/prefill_attention.cu``, replacing the
Pallas kernel ``ops/pallas_attention.py:shared_kv_attention_pallas``): it
launches the kernel on CUDA tensors and takes the plain version only for
tensors on the CPU.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import cuda_lib

NEG_INF = -1e9


def l2norm(x: torch.Tensor, dim: int = -1, eps: float = 1e-12) -> torch.Tensor:
    """x / max(||x||, eps), like torch F.normalize and the JAX l2norm."""
    norm = torch.sqrt(torch.sum(x * x, dim=dim, keepdim=True))
    return x / torch.clamp(norm, min=eps)


def shared_kv_attention(
    q: torch.Tensor,  # [b, h, n, d]
    k: torch.Tensor,  # [b, m, d]
    v: torch.Tensor,  # [b, m, d]
    *,
    scale: float = 8.0,
    attn_bias: Optional[torch.Tensor] = None,  # [h, n, m]
    key_mask: Optional[torch.Tensor] = None,  # [b, m] bool, True = attend
    causal: bool = False,
    non_causal_prefix: int = 0,
) -> torch.Tensor:
    """Plain full-sequence attention. Returns [b, n, h*d]."""
    b, h, n, d = q.shape
    m = k.shape[1]
    sim = torch.einsum("bhnd,bmd->bhnm", q, k) * scale
    if attn_bias is not None:
        sim = sim + attn_bias[None].to(sim.dtype)
    if key_mask is not None:
        sim = sim.masked_fill(~key_mask[:, None, None, :], NEG_INF)
    if causal:
        i = torch.arange(n, device=q.device)[:, None]
        j = torch.arange(m, device=q.device)[None, :]
        allowed = j <= i + (m - n)  # queries are the last n of m keys
        if non_causal_prefix > 0:
            allowed = allowed | (
                (i < non_causal_prefix) & (j < non_causal_prefix + m - n)
            )
        sim = sim.masked_fill(~allowed, NEG_INF)
    attn = torch.softmax(sim, dim=-1)
    out = torch.einsum("bhnm,bmd->bhnd", attn, v)
    return out.transpose(1, 2).reshape(b, n, h * d)


def shared_kv_attention_fused(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    attn_bias: Optional[torch.Tensor] = None,
    key_mask: Optional[torch.Tensor] = None,
    *,
    scale: float = 8.0,
    causal: bool = True,
    non_causal_prefix: int = 0,
) -> torch.Tensor:
    """Kernel 1 (prefill attention). Same contract as ``shared_kv_attention``."""
    if not q.is_cuda:
        return shared_kv_attention(
            q, k, v, scale=scale, attn_bias=attn_bias, key_mask=key_mask,
            causal=causal, non_causal_prefix=non_causal_prefix,
        )
    b, h, n, d = q.shape
    m = k.shape[1]
    name = "shared_kv_attention_fused"
    cuda_lib.require(d == 64, f"{name}: kernel takes dim_head 64, got {d}")
    cuda_lib.require(128 % h == 0, f"{name}: heads must divide 128, got {h}")
    cuda_lib.require(k.shape == (b, m, d) and v.shape == (b, m, d), f"{name}: k/v shape")
    cuda_lib.require(m >= n, f"{name}: queries must be the last n of m keys")
    cuda_lib.require(k.dtype == q.dtype and v.dtype == q.dtype, f"{name}: q/k/v dtype")
    tensors = [q, k, v]
    if attn_bias is not None:
        cuda_lib.require(attn_bias.shape == (h, n, m), f"{name}: bias shape")
        attn_bias = attn_bias.float().contiguous()
        tensors.append(attn_bias)
    if key_mask is not None:
        cuda_lib.require(key_mask.shape == (b, m), f"{name}: key_mask shape")
        key_mask = key_mask.to(torch.uint8).contiguous()
        tensors.append(key_mask)
    cuda_lib.require_cuda(name, *tensors)
    out = torch.empty((b, n, h * d), dtype=q.dtype, device=q.device)
    rc = cuda_lib.lib().omt_prefill_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        attn_bias.data_ptr() if attn_bias is not None else None,
        key_mask.data_ptr() if key_mask is not None else None,
        out.data_ptr(), b, h, n, m, int(causal), int(non_causal_prefix),
        float(scale), cuda_lib.dtype_code(q.dtype), cuda_lib.stream(q),
    )
    cuda_lib.check(rc, name)
    shared_kv_attention_fused.launches += 1
    return out


shared_kv_attention_fused.launches = 0
