"""Cosine-similarity shared-KV attention (port of open_musiclm_tpu/ops/attention.py
and the differentiable wrapper of open_musiclm_tpu/ops/pallas_attention.py).

Queries are multi-head ``[b, h, n, d]``; keys and values are ONE head
``[b, m, d]`` shared by all query heads. q and k arrive l2-normalised and
scaled; the similarity uses a fixed scale (8).

``shared_kv_attention`` is the plain forward and ``shared_kv_attention_bwd_plain``
the plain backward; ``shared_kv_decode_step`` is the fp decode step's
attention over the cache (plain torch, as it is plain XLA in the JAX package). The kernel wrappers launch a kernel on CUDA tensors and
take the plain version only for tensors on the CPU:

  * ``shared_kv_attention_fused``: kernel 1 (``csrc/prefill_attention.cu``,
    replacing ``shared_kv_attention_pallas``), optionally with each row's
    softmax statistics for the backward;
  * ``shared_kv_attention_bwd``: kernels 5 and 6 (``csrc/attention_bwd.cu``,
    replacing ``_fused_bwd``'s ``_bwd_kernel`` and ``_dbias_kernel``): dq,
    dk, dv and, when asked, the bias gradient summed over the batch. Its
    ``launches`` counts kernel 5 and its ``dbias_launches`` kernel 6.

The kernels read the bias in its own dtype (float32 or bfloat16) and write
dbias in it.

``shared_kv_attention_train`` is the differentiable op the transformer calls:
a ``torch.autograd.Function`` whose forward is kernel 1 and whose backward is
kernels 5 and 6 (on the CPU, the plain forward and backward).
"""

from __future__ import annotations

from typing import Optional

import torch

from . import cuda_lib

NEG_INF = -1e9
# kernel 1's bf16 route keeps a key mask as bits in shared memory; must match
# MAX_MASKED_KEYS in csrc/prefill_attention.cu
MAX_MASKED_KEYS = 16384


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
    return_stats: bool = False,
):
    """Plain full-sequence attention. Returns [b, n, h*d]; with
    ``return_stats`` also each row's softmax max and denominator
    [b, h, n, 2] float32, as kernel 1 writes them."""
    b, h, n, d = q.shape
    sim = _masked_scores(q, k, scale, attn_bias, key_mask, causal, non_causal_prefix)
    attn = torch.softmax(sim, dim=-1)
    out = torch.einsum("bhnm,bmd->bhnd", attn, v)
    out = out.transpose(1, 2).reshape(b, n, h * d)
    if not return_stats:
        return out
    mx = sim.float().amax(dim=-1)
    denom = torch.exp(sim.float() - mx[..., None]).sum(dim=-1)
    return out, torch.stack([mx, denom], dim=-1)


def shared_kv_decode_step(
    q_t: torch.Tensor,  # [b, h, d] query at position ``pos`` (l2norm * q_scale)
    k_cache: torch.Tensor,  # [b, N, d] processed keys; rows > pos are junk
    v_cache: torch.Tensor,  # [b, N, d]
    pos: int,
    *,
    scale: float = 8.0,
    bias_table: Optional[torch.Tensor] = None,  # [2N-1, h] decode layout
    key_mask: Optional[torch.Tensor] = None,  # [b, N] bool, True = attend
) -> torch.Tensor:
    """One KV-cached decode step of the fp path, [b, h*d] in q_t's dtype.

    Scores and softmax are float32. The step's bias row is the slice
    ``[N-1-pos, 2N-1-pos)`` of the decode-layout table
    (``Transformer.bias_table``); keys ``j > pos`` are masked."""
    b, h, d = q_t.shape
    N = k_cache.shape[1]
    sim = torch.einsum("bhd,bnd->bhn", q_t.float(), k_cache.float()) * scale
    if bias_table is not None:
        sim = sim + bias_table[N - 1 - pos: 2 * N - 1 - pos].t()[None].float()
    j = torch.arange(N, device=q_t.device)
    sim = sim.masked_fill(j[None, None, :] > pos, NEG_INF)
    if key_mask is not None:
        sim = sim.masked_fill(~key_mask[:, None, :], NEG_INF)
    attn = torch.softmax(sim, dim=-1)
    out = torch.einsum("bhn,bnd->bhd", attn, v_cache.float())
    return out.reshape(b, h * d).to(q_t.dtype)


def _masked_scores(q, k, scale, attn_bias, key_mask, causal, non_causal_prefix):
    """q.k^T * scale + bias with masked scores set to NEG_INF, [b, h, n, m]."""
    n, m = q.shape[2], k.shape[1]
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
    return sim


def shared_kv_attention_bwd_plain(
    q: torch.Tensor,  # [b, h, n, d]
    k: torch.Tensor,  # [b, m, d]
    v: torch.Tensor,  # [b, m, d]
    dout: torch.Tensor,  # [b, n, h*d], the gradient of the forward's output
    *,
    scale: float = 8.0,
    attn_bias: Optional[torch.Tensor] = None,
    key_mask: Optional[torch.Tensor] = None,
    causal: bool = True,
    non_causal_prefix: int = 0,
):
    """Plain backward, recomputing the softmax as ``_bwd_kernel`` and
    ``_dbias_kernel`` do, in float32. Returns (dq, dk, dv, dbias) in the
    input dtypes (dbias None without a bias)."""
    b, h, n, d = q.shape
    qf, kf, vf = q.float(), k.float(), v.float()
    bias = attn_bias.float() if attn_bias is not None else None
    sim = _masked_scores(qf, kf, scale, bias, key_mask, causal, non_causal_prefix)
    e = torch.exp(sim - sim.amax(dim=-1, keepdim=True))
    p = e / torch.clamp(e.sum(dim=-1, keepdim=True), min=1e-30)
    do = dout.float().reshape(b, n, h, d).transpose(1, 2)  # [b, h, n, d]
    dp = torch.einsum("bhnd,bmd->bhnm", do, vf)
    ds = p * (dp - (dp * p).sum(dim=-1, keepdim=True))
    dq = torch.einsum("bhnm,bmd->bhnd", ds, kf) * scale
    dk = torch.einsum("bhnm,bhnd->bmd", ds, qf) * scale
    dv = torch.einsum("bhnm,bhnd->bmd", p, do)
    dbias = ds.sum(dim=0).to(attn_bias.dtype) if attn_bias is not None else None
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), dbias


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
    return_stats: bool = False,
):
    """Kernel 1 (prefill attention). Same contract as ``shared_kv_attention``.
    bf16 runs on the tensor cores, float32 in float32 on the CUDA cores; both
    skip the key tiles that the causal mask hides."""
    if not q.is_cuda:
        return shared_kv_attention(
            q, k, v, scale=scale, attn_bias=attn_bias, key_mask=key_mask,
            causal=causal, non_causal_prefix=non_causal_prefix, return_stats=return_stats,
        )
    b, h, n, _ = q.shape
    m = k.shape[1]
    name = "shared_kv_attention_fused"
    cuda_lib.require(64 % h == 0, f"{name}: heads must divide 64 (a block's rows), got {h}")
    attn_bias, key_mask = _check_attention_args(name, q, k, v, attn_bias, key_mask)
    cuda_lib.require(all(t.data_ptr() % 16 == 0 for t in (q, k, v)),
                     f"{name}: q, k and v must be 16-byte aligned")
    cuda_lib.require(key_mask is None or q.dtype != torch.bfloat16 or m <= MAX_MASKED_KEYS,
                     f"{name}: in bf16 a key mask covers at most {MAX_MASKED_KEYS} keys, got {m}")
    out = torch.empty((b, n, h * q.shape[-1]), dtype=q.dtype, device=q.device)
    stats = torch.empty((b, h, n, 2), dtype=torch.float32, device=q.device) if return_stats else None
    rc = cuda_lib.lib().omt_prefill_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(attn_bias), _ptr(key_mask),
        out.data_ptr(), _ptr(stats), b, h, n, m, int(causal), int(non_causal_prefix),
        float(scale), cuda_lib.dtype_code(q.dtype), _bias_code(attn_bias, q), cuda_lib.stream(q),
    )
    cuda_lib.check(rc, name)
    shared_kv_attention_fused.launches += 1
    return (out, stats) if return_stats else out


shared_kv_attention_fused.launches = 0


def _ptr(t: Optional[torch.Tensor]):
    return t.data_ptr() if t is not None else None


def _bias_code(attn_bias, q) -> int:
    """The kernels' dtype code of the bias (q's when there is none)."""
    return cuda_lib.dtype_code((attn_bias if attn_bias is not None else q).dtype)


def _check_attention_args(name, q, k, v, attn_bias, key_mask, *more):
    """Shape, dtype and device checks shared by the kernel wrappers; returns
    the bias contiguous in its own dtype and the key mask as uint8."""
    b, h, n, d = q.shape
    m = k.shape[1]
    cuda_lib.require(d == 64, f"{name}: kernel takes dim_head 64, got {d}")
    cuda_lib.require(k.shape == (b, m, d) and v.shape == (b, m, d), f"{name}: k/v shape")
    cuda_lib.require(m >= n, f"{name}: queries must be the last n of m keys")
    cuda_lib.require(k.dtype == q.dtype and v.dtype == q.dtype, f"{name}: q/k/v dtype")
    tensors = [q, k, v, *more]
    if attn_bias is not None:
        cuda_lib.require(attn_bias.shape == (h, n, m), f"{name}: bias shape")
        cuda_lib.dtype_code(attn_bias.dtype)
        attn_bias = attn_bias.contiguous()
        tensors.append(attn_bias)
    if key_mask is not None:
        cuda_lib.require(key_mask.shape == (b, m), f"{name}: key_mask shape")
        key_mask = key_mask.to(torch.uint8).contiguous()
        tensors.append(key_mask)
    cuda_lib.require_cuda(name, *tensors)
    return attn_bias, key_mask


def shared_kv_attention_bwd(
    q, k, v, attn_bias, key_mask, out, stats, dout, *,
    scale: float = 8.0, causal: bool = True, non_causal_prefix: int = 0, dbias: bool = True,
):
    """Kernels 5 and 6: (dq, dk, dv, dbias) of the attention, dq/dk/dv in
    the input dtypes and dbias [h, n, m] summed over the batch in the bias's
    dtype (None without a bias or with ``dbias=False``, which skips kernel 6).

    ``out`` [b, n, h*d] and ``stats`` [b, h, n, 2] are kernel 1's output and
    row statistics for these inputs; ``dout`` is the gradient of ``out``.
    On the CPU the plain backward recomputes everything (stats may be None).
    """
    want_dbias = dbias and attn_bias is not None
    if not q.is_cuda:
        dq, dk, dv, db = shared_kv_attention_bwd_plain(
            q, k, v, dout, scale=scale, attn_bias=attn_bias, key_mask=key_mask,
            causal=causal, non_causal_prefix=non_causal_prefix)
        return dq, dk, dv, db if want_dbias else None
    b, h, n, d = q.shape
    m = k.shape[1]
    name = "shared_kv_attention_bwd"
    cuda_lib.require(out.shape == (b, n, h * d) and dout.shape == (b, n, h * d),
                     f"{name}: out/dout shape")
    cuda_lib.require(out.dtype == q.dtype and dout.dtype == q.dtype, f"{name}: out/dout dtype")
    cuda_lib.require(stats is not None and stats.shape == (b, h, n, 2)
                     and stats.dtype == torch.float32,
                     f"{name}: needs kernel 1's float32 row statistics [b, h, n, 2]")
    attn_bias, key_mask = _check_attention_args(
        name, q, k, v, attn_bias, key_mask, out, stats, dout)
    f32 = dict(dtype=torch.float32, device=q.device)
    delta = torch.empty((b, h, n), **f32)
    dk_part = torch.empty((h, b, m, d), **f32)
    dv_part = torch.empty((h, b, m, d), **f32)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    db = torch.empty_like(attn_bias) if want_dbias else None
    rc = cuda_lib.lib().omt_attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(attn_bias), _ptr(key_mask),
        out.data_ptr(), stats.data_ptr(), dout.data_ptr(), delta.data_ptr(),
        dk_part.data_ptr(), dv_part.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        _ptr(db), b, h, n, m, int(causal), int(non_causal_prefix), float(scale),
        cuda_lib.dtype_code(q.dtype), _bias_code(attn_bias, q), cuda_lib.stream(q),
    )
    cuda_lib.check(rc, name)
    shared_kv_attention_bwd.launches += 1
    if db is not None:
        shared_kv_attention_bwd.dbias_launches += 1
    return dq, dk, dv, db


shared_kv_attention_bwd.launches = 0
shared_kv_attention_bwd.dbias_launches = 0


class _SharedKVAttention(torch.autograd.Function):
    """Forward: kernel 1 with row statistics. Backward: kernels 5 and 6. On
    the CPU: the plain forward and ``shared_kv_attention_bwd_plain``. No
    gradient flows to the key mask."""

    @staticmethod
    def forward(ctx, q, k, v, attn_bias, key_mask, scale, causal, non_causal_prefix):
        opts = dict(scale=scale, causal=causal, non_causal_prefix=non_causal_prefix)
        need_stats = q.is_cuda and any(ctx.needs_input_grad[:4])
        res = shared_kv_attention_fused(q, k, v, attn_bias, key_mask, return_stats=need_stats, **opts)
        out, stats = res if need_stats else (res, None)
        ctx.save_for_backward(q, k, v, attn_bias, key_mask, out, stats)
        ctx.opts = opts
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, bias, key_mask, out, stats = ctx.saved_tensors
        dout = dout.contiguous()
        dq, dk, dv, dbias = shared_kv_attention_bwd(
            q, k, v, bias, key_mask, out, stats, dout, dbias=ctx.needs_input_grad[3], **ctx.opts)
        return dq, dk, dv, dbias, None, None, None, None


def shared_kv_attention_train(
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
    """Differentiable attention (``shared_kv_attention_fused`` of the JAX
    package's ops/pallas_attention.py). Without gradients it is exactly
    kernel 1."""
    return _SharedKVAttention.apply(
        q, k, v, attn_bias, key_mask, float(scale), bool(causal), int(non_causal_prefix))
