"""int8 serving decode (port of open_musiclm_tpu/models/quant_decode.py).

An fp prefill (kernel 1), then one decode step per token. ``flash_kv``
selects the step:

  * ``None``: ``quant_decode_step`` over separate K/V caches, attention in
    plain torch (``shared_kv_decode_step``); with ``fused_ff`` (the default)
    the attention projections are plain matmuls and the conv-FF block is
    kernel 3, without it every one of the five layer matmuls is kernel 4;
  * ``"int8"``, ``"bf16"``, ``"f32"``: ``flash_quant_decode_step`` over the
    packed K|V cache through the flash-decode kernel (kernel 2) with int8,
    activation-dtype or float32 rows, then kernel 3;
  * ``"fused"``: ``fused_layer_step``, one launch of kernel 7 per layer
    (attention and conv-FF, all weights int8, int8 cache rows).

The logit head is kernel 4 in every mode, on its weight stream at any row
count. The plain products (the prefill's, and the attention projections of
the modes that keep them in the activations' dtype) run in fixed row tiles
(``ops/rows.py``), so a row's tokens do not depend on its batch's size. The
decode loop is a Python loop with ``pos`` a host integer; caches are
updated in place. The int8 modes need the conv feed-forward (the plain
``FeedForward`` runs the fp decode), as in the JAX package.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import torch

from ..ops.attention import l2norm, shared_kv_decode_step
from ..ops.decode_attention import flash_decode_step, quantize_kv_row, round_up_chunk
from ..ops.fused_ff import fused_ff_apply, pack_ff_weights
from ..ops.fused_layer import fused_layer_decode_step, pack_layer_weights
from ..ops.quant import int8_matmul, quantize_weight
from ..ops.rows import row_linear
from .token_cond import TokenConditionedTransformer, decode_loop, make_prompt
from .transformer import FeedForward, layer_norm

FLASH_KV_MODES = (None, "bf16", "f32", "int8", "fused")


@torch.no_grad()
def quantize_stage_params(model: TokenConditionedTransformer, fused: bool = False) -> Dict[str, Any]:
    """int8 side-tree for the decode paths: per layer the attention
    projections (``attn_{l}``: to_q, to_kv, to_out) and the conv-FF
    projections with kernel 3's pack (``ff_{l}``: proj_in, proj_out,
    packed), each an (int8 [in, out], scale [out]) pair; with ``fused`` also
    kernel 7's pack (``layer_{l}``). The final sequence's logit heads are
    per-head int8 [d, C] with per-column scales ([Q, d, C] and [Q, C]).
    The int8 decodes take the whole model: over a mesh's ``tp`` axis they run
    replicated, as the JAX package's shard_map does."""
    if model.tp_mesh is not None:
        raise ValueError("the int8 decodes take the whole model, not a tensor-parallel shard: "
                         "quantize the unsharded model (it runs replicated over tp)")
    if isinstance(model.transformer.ffs[0], FeedForward):
        # the JAX package's quantize_stage_params packs every layer's conv_w
        # too, and fails on the plain FeedForward (a KeyError)
        raise ValueError("the int8 decodes pack the conv feed-forward's weights: a stage with the "
                         "plain FeedForward (use_conv_ff=False) runs the fp decode (quantized=False)")
    q: Dict[str, Any] = {}
    for l, (attn, ff) in enumerate(zip(model.transformer.attns, model.transformer.ffs)):
        q[f"attn_{l}"] = {
            name: quantize_weight(getattr(attn, name).weight.detach().t())
            for name in ("to_q", "to_kv", "to_out")
        }
        q[f"ff_{l}"] = {
            "proj_in": quantize_weight(ff.proj_in.weight.detach().t()),
            "proj_out": quantize_weight(ff.proj_out.weight.detach().t()),
            "packed": pack_ff_weights(ff),
        }
        if fused:
            q[f"layer_{l}"] = pack_layer_weights(attn, ff)
    w = model.logit_heads[-1].detach()  # [Q, C, d]
    heads = [quantize_weight(w[i].t()) for i in range(w.shape[0])]
    q["logit_heads"] = (
        torch.stack([h[0] for h in heads]).contiguous(),
        torch.stack([h[1] for h in heads]).contiguous(),
    )
    return q


def quant_decode_step(
    model: TokenConditionedTransformer,
    qparams: Dict[str, Any],
    x_t: torch.Tensor,  # [b, dim]
    cache: Dict[str, torch.Tensor],  # separate K/V caches, updated in place
    pos: int,
    bias_table: Optional[torch.Tensor],  # [2N-1, h] decode layout
    *,
    fused_ff: bool = True,
) -> torch.Tensor:
    """The ``flash_kv=None`` step. Returns the normed h [b, dim]."""
    tfm = model.transformer
    d, heads = model.dim_head, model.heads
    k_all, v_all, ff_all = cache["k"], cache["v"], cache["ff"]
    x = x_t
    b = x.shape[0]
    for l, (attn, ff) in enumerate(zip(tfm.attns, tfm.ffs)):
        qa, qf = qparams[f"attn_{l}"], qparams[f"ff_{l}"]
        h = layer_norm(x, attn.norm.gamma)
        # K/V project from the UN-normed residual stream, Q from the normed one
        if fused_ff:
            qv, kv = row_linear(h, attn.to_q.weight), row_linear(x, attn.to_kv.weight)
        else:
            qv, kv = int8_matmul(h, *qa["to_q"]), int8_matmul(x, *qa["to_kv"])
        k_t, v_t = kv.chunk(2, dim=-1)
        qh = l2norm(qv.reshape(b, heads, d)) * attn.q_scale.to(qv.dtype)
        k_all[l, :, pos] = l2norm(k_t) * attn.k_scale.to(k_t.dtype)
        v_all[l, :, pos] = v_t
        out = shared_kv_decode_step(qh, k_all[l], v_all[l], pos, scale=attn.scale, bias_table=bias_table)
        if fused_ff:
            x = x + row_linear(out, attn.to_out.weight)
            x, ff_all[l] = fused_ff_apply(x, qf["packed"], ff_all[l])
            continue
        x = x + int8_matmul(out, *qa["to_out"])
        state = ff_all[l]
        u_t = int8_matmul(layer_norm(x, ff.norm_in.gamma), *qf["proj_in"])  # [b, 2*inner]
        w = ff.conv_w.to(u_t.dtype)
        conv = state[:, 0] * w[0] + state[:, 1] * w[1] + u_t * w[2]
        g = layer_norm(ff.geglu(conv), ff.norm_mid.gamma)
        x = x + int8_matmul(g, *qf["proj_out"])
        ff_all[l] = torch.stack([state[:, 1], u_t], dim=1)
    return layer_norm(x, tfm.final_norm.gamma)


def pack_kv_cache(cache: Dict[str, torch.Tensor], int8: bool,
                  cache_dtype: Optional[torch.dtype] = None) -> Dict[str, torch.Tensor]:
    """Separate K/V cache -> the flash kernels' packed layout: kv
    [depth, b, N, 2d] (K in lanes 0:d, V in d:2d); int8 mode adds per-row
    scales kvs [depth, 2, b, N]. ``cache_dtype`` overrides the row dtype of
    the unquantized modes ("f32": float32 rows)."""
    out = {"ff": cache["ff"]}
    if int8:
        kq, ks = quantize_kv_row(cache["k"])
        vq, vs = quantize_kv_row(cache["v"])
        out["kv"] = torch.cat([kq, vq], dim=-1).contiguous()
        out["kvs"] = torch.stack([ks, vs], dim=1).contiguous()
    else:
        kv = torch.cat([cache["k"], cache["v"]], dim=-1)
        out["kv"] = kv.to(cache_dtype or kv.dtype).contiguous()
    return out


def flash_quant_decode_step(
    model: TokenConditionedTransformer,
    qparams: Dict[str, Any],
    x_t: torch.Tensor,  # [b, dim]
    cache: Dict[str, torch.Tensor],  # packed layout, updated in place
    pos: int,
    bias_row: torch.Tensor,  # [N, h] f32 decode-layout row for this pos
    add_mask: torch.Tensor,  # [b, N] f32 additive key mask
    *,
    int8_kv: bool,
) -> torch.Tensor:
    """One decode step over the packed cache. Returns the normed h [b, dim]."""
    tfm = model.transformer
    d, heads = model.dim_head, model.heads
    kv_all, kvs_all, ff_all = cache["kv"], cache.get("kvs"), cache["ff"]
    x = x_t
    b = x.shape[0]
    for l, attn in enumerate(tfm.attns):
        h = layer_norm(x, attn.norm.gamma)
        # K/V project from the UN-normed residual stream, Q from the normed one
        qh = row_linear(h, attn.to_q.weight).reshape(b, heads, d)
        k_t, v_t = row_linear(x, attn.to_kv.weight).chunk(2, dim=-1)
        qh = (l2norm(qh) * attn.q_scale.to(qh.dtype)).contiguous()
        k_t = l2norm(k_t) * attn.k_scale.to(k_t.dtype)
        if int8_kv:
            kq, ks = quantize_kv_row(k_t)
            vq, vs = quantize_kv_row(v_t)
            kv_all[l, :, pos] = torch.cat([kq, vq], dim=-1)
            kvs_all[l, 0, :, pos] = ks
            kvs_all[l, 1, :, pos] = vs
        else:
            kv_all[l, :, pos] = torch.cat([k_t, v_t], dim=-1).to(kv_all.dtype)
        out = flash_decode_step(
            qh, kv_all[l], pos, bias_row, add_mask,
            kvs_all[l] if int8_kv else None, scale=attn.scale,
        )
        x = x + row_linear(out, attn.to_out.weight)
        x, ff_all[l] = fused_ff_apply(x, qparams[f"ff_{l}"]["packed"], ff_all[l])
    return layer_norm(x, tfm.final_norm.gamma)


def fused_layer_step(
    model: TokenConditionedTransformer,
    qparams: Dict[str, Any],
    x_t: torch.Tensor,  # [b, dim]
    cache: Dict[str, torch.Tensor],  # packed int8 layout, updated in place
    pos: int,
    bias_row: torch.Tensor,
    add_mask: torch.Tensor,
) -> torch.Tensor:
    """One decode step through kernel 7, one launch per layer. The kernel
    writes each layer's quantized fresh K/V row at ``pos`` and its new conv
    state in place. Returns the normed h [b, dim]."""
    tfm = model.transformer
    x = x_t
    for l in range(len(tfm.attns)):
        x, _, _ = fused_layer_decode_step(
            x, qparams[f"layer_{l}"], cache["kv"][l], cache["kvs"][l], cache["ff"][l],
            pos, bias_row, add_mask, heads=model.heads, scale=tfm.attns[l].scale,
        )
    return layer_norm(x, tfm.final_norm.gamma)


@torch.no_grad()
def generate_quantized(
    model: TokenConditionedTransformer,
    qparams: Dict[str, Any],
    conditioning_token_ids: Sequence[torch.Tensor],
    generator: Optional[torch.Generator] = None,
    *,
    max_time_steps: int,
    init_pred_ids: Optional[torch.Tensor] = None,
    filter_thres: float = 0.9,
    temperature: float = 1.0,
    allow_eos_in_output: bool = False,
    include_eos_in_output: bool = False,
    append_eos_to_conditioning_tokens: bool = True,
    fused_ff: bool = True,
    flash_kv: Optional[str] = "int8",
    teacher_ids: Optional[torch.Tensor] = None,
    return_logits: bool = False,
    per_row_keys: Optional[torch.Tensor] = None,
):
    """The int8 twin of ``token_cond.generate``: fp prefill, int8 decode
    steps of the ``flash_kv`` mode (see the module docstring; ``fused_ff``
    applies to ``flash_kv=None``). Same arguments and returns as
    ``token_cond.generate``."""
    if flash_kv not in FLASH_KV_MODES:
        raise ValueError(f"unknown flash_kv mode {flash_kv!r}: expected one of {FLASH_KV_MODES}")
    if flash_kv == "fused" and "layer_0" not in qparams:
        raise ValueError("flash_kv='fused' needs quantize_stage_params(model, fused=True)")
    prompt = make_prompt(model, conditioning_token_ids, max_time_steps=max_time_steps,
                         init_pred_ids=init_pred_ids, append_eos=append_eos_to_conditioning_tokens)
    tfm = model.transformer
    batch = prompt.init_flat.shape[0]
    max_len = prompt.prefill_len + prompt.n_new
    # the flash caches are padded to whole 256-row chunks, as in the JAX package
    alloc_len = round_up_chunk(max_len) if flash_kv else max_len
    cache = tfm.init_cache(batch, alloc_len)
    table = tfm.bias_table(alloc_len)
    h_all, cache = tfm.prefill(model.assemble_stream(prompt.prefill_ids), cache)

    if flash_kv is None:
        def step(emb, pos):
            return quant_decode_step(model, qparams, emb, cache, pos, table, fused_ff=fused_ff)
    else:
        cache = pack_kv_cache(cache, int8=flash_kv in ("int8", "fused"),
                              cache_dtype=torch.float32 if flash_kv == "f32" else None)
        device = h_all.device
        add_mask = torch.zeros((batch, alloc_len), dtype=torch.float32, device=device)  # all keys valid
        if table is None:
            table = torch.zeros((2 * alloc_len - 1, model.heads), device=device)
        table = table.float().contiguous()

        def step(emb, pos):
            bias_row = table[alloc_len - 1 - pos: 2 * alloc_len - 1 - pos]
            if flash_kv == "fused":
                return fused_layer_step(model, qparams, emb, cache, pos, bias_row, add_mask)
            return flash_quant_decode_step(
                model, qparams, emb, cache, pos, bias_row, add_mask, int8_kv=flash_kv == "int8")

    heads_q, heads_s = qparams["logit_heads"]
    return decode_loop(
        model, prompt, h_all[:, -1].contiguous(),
        lambda h, q_idx: int8_matmul(h, heads_q[q_idx], heads_s[q_idx]), step, generator,
        filter_thres=filter_thres, temperature=temperature,
        allow_eos_in_output=allow_eos_in_output, include_eos_in_output=include_eos_in_output,
        teacher_ids=teacher_ids, return_logits=return_logits, per_row_keys=per_row_keys,
    )
