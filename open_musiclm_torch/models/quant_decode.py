"""int8 serving decode (port of open_musiclm_tpu/models/quant_decode.py).

The serving path the JAX bench runs: an fp prefill (kernel 1), then one
decode step per token in which

  * attention reads the packed K|V cache through the flash-decode kernel
    (kernel 2) with int8 ("int8") or activation-dtype ("bf16") cache rows,
  * the conv-FF block runs through the fused int8 kernel (kernel 3),
  * the logit head is an int8 matmul (kernel 4).

The attention projections to_q / to_kv / to_out stay plain matmuls in the
parameter dtype, as in the JAX serving configuration. The decode loop is a
Python loop with ``pos`` a host integer; caches are updated in place.
Not ported yet: the ``flash_kv=None`` per-matmul int8 step, ``"f32"`` and
``"fused"`` cache modes, and per-row sampling keys.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import torch
import torch.nn.functional as F

from ..core.sampling import NEG_INF, append_eos_id, mask_out_after_eos_id, sample_top_k_gumbel
from ..ops.attention import l2norm
from ..ops.decode_attention import flash_decode_step, quantize_kv_row, round_up_chunk
from ..ops.fused_ff import fused_ff_apply, pack_ff_weights
from ..ops.quant import int8_matmul, quantize_weight
from .token_cond import PAD_ID, TokenConditionedTransformer
from .transformer import layer_norm

FLASH_KV_MODES = ("int8", "bf16")


@torch.no_grad()
def quantize_stage_params(model: TokenConditionedTransformer) -> Dict[str, Any]:
    """int8 side-tree for the decode path: each layer's packed conv-FF
    weights, and the final sequence's logit heads as per-head int8 [d, C]
    with per-column scales ([Q, d, C] and [Q, C])."""
    q: Dict[str, Any] = {
        f"ff_{l}": pack_ff_weights(ff) for l, ff in enumerate(model.transformer.ffs)
    }
    w = model.logit_heads[-1].detach()  # [Q, C, d]
    heads = [quantize_weight(w[i].t()) for i in range(w.shape[0])]
    q["logit_heads"] = (
        torch.stack([h[0] for h in heads]).contiguous(),
        torch.stack([h[1] for h in heads]).contiguous(),
    )
    return q


def pack_kv_cache(cache: Dict[str, torch.Tensor], int8: bool) -> Dict[str, torch.Tensor]:
    """Separate K/V cache -> the flash kernel's packed layout: kv
    [depth, b, N, 2d] (K in lanes 0:d, V in d:2d); int8 mode adds per-row
    scales kvs [depth, 2, b, N]."""
    out = {"ff": cache["ff"]}
    if int8:
        kq, ks = quantize_kv_row(cache["k"])
        vq, vs = quantize_kv_row(cache["v"])
        out["kv"] = torch.cat([kq, vq], dim=-1).contiguous()
        out["kvs"] = torch.stack([ks, vs], dim=1).contiguous()
    else:
        out["kv"] = torch.cat([cache["k"], cache["v"]], dim=-1).contiguous()
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
    for l, (attn, ff) in enumerate(zip(tfm.attns, tfm.ffs)):
        h = layer_norm(x, attn.norm.gamma)
        # K/V project from the UN-normed residual stream, Q from the normed one
        qh = F.linear(h, attn.to_q.weight).reshape(b, heads, d)
        k_t, v_t = F.linear(x, attn.to_kv.weight).chunk(2, dim=-1)
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
        x = x + F.linear(out, attn.to_out.weight)
        x, new_state = fused_ff_apply(x, qparams[f"ff_{l}"], ff_all[l])
        ff_all[l] = new_state
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
    flash_kv: str = "int8",
    teacher_ids: Optional[torch.Tensor] = None,
    return_logits: bool = False,
):
    """Sample the final sequence given the conditioning sequences.

    Returns [b, max_time_steps, Q] token ids (and, with ``return_logits``,
    the per-step float32 logits [b, n_new, C]). ``init_pred_ids`` is an
    already generated prefix ([b, t0, Q] or flattened). ``teacher_ids``
    feeds the teacher token forward instead of the sample, so every step is
    scored under the teacher's prefix.
    """
    if flash_kv not in FLASH_KV_MODES:
        raise NotImplementedError(
            f"flash_kv={flash_kv!r} is not ported; the port runs {FLASH_KV_MODES}"
        )
    specs = model.specs
    pred_spec = specs[-1]
    q_num = pred_spec.num_quantizers
    eos_id = pred_spec.eos_id
    batch = conditioning_token_ids[0].shape[0]
    device = model.start_tokens.device

    cond = [t.reshape(t.shape[0], -1).to(device, torch.long) for t in conditioning_token_ids]
    if append_eos_to_conditioning_tokens:
        cond = [append_eos_id(t, s.eos_id) for t, s in zip(cond, specs[:-1])]
    if init_pred_ids is not None:
        init_flat = init_pred_ids.reshape(batch, -1).to(device, torch.long)
    else:
        init_flat = torch.zeros((batch, 0), dtype=torch.long, device=device)
    n_init = init_flat.shape[-1]

    total_steps = max_time_steps * q_num
    n_new = total_steps - n_init
    if n_new <= 0:
        raise ValueError("nothing to generate")
    prefill_ids = cond + [init_flat]
    prefill_len = sum(t.shape[-1] for t in prefill_ids) + len(specs)
    alloc_len = round_up_chunk(prefill_len + n_new)

    tfm = model.transformer
    x = model.assemble_stream(prefill_ids)
    cache = tfm.init_cache(batch, alloc_len)
    table = tfm.bias_table(alloc_len)
    h_all, cache = tfm.prefill(x, cache)
    h_last = h_all[:, -1].contiguous()
    cache = pack_kv_cache(cache, int8=flash_kv == "int8")
    add_mask = torch.zeros((batch, alloc_len), dtype=torch.float32, device=device)  # all keys valid
    if table is None:
        table = torch.zeros((2 * alloc_len - 1, model.heads), device=device)
    table = table.float().contiguous()

    sampled = torch.full((batch, total_steps), eos_id, dtype=torch.long, device=device)
    sampled[:, :n_init] = init_flat
    emb_table = model.embeds[-1].weight
    heads_q, heads_s = qparams["logit_heads"]
    teacher_flat = teacher_ids.reshape(batch, -1).to(device, torch.long) if teacher_ids is not None else None
    step_logits = []

    for s in range(n_new):
        flat_idx = n_init + s
        q_idx = flat_idx % q_num
        logits = int8_matmul(h_last, heads_q[q_idx], heads_s[q_idx])  # [b, C]
        if not (allow_eos_in_output and q_idx == q_num - 1):
            logits[:, -1] = NEG_INF
        tok = sample_top_k_gumbel(logits, temperature, filter_thres, generator=generator)
        sampled[:, flat_idx] = tok
        fed = teacher_flat[:, flat_idx] if teacher_flat is not None else tok
        offset = q_idx * pred_spec.codebook_size if q_num > 1 else 0
        emb = emb_table[fed + offset]
        pos = prefill_len + s
        bias_row = table[alloc_len - 1 - pos: 2 * alloc_len - 1 - pos]
        h_last = flash_quant_decode_step(
            model, qparams, emb, cache, pos, bias_row, add_mask, int8_kv=flash_kv == "int8"
        )
        if return_logits:
            step_logits.append(logits.float())

    sampled = mask_out_after_eos_id(sampled, eos_id, mask_value=PAD_ID, keep_eos=include_eos_in_output)
    sampled = sampled.reshape(batch, max_time_steps, q_num)
    if return_logits:
        return sampled, torch.stack(step_logits, dim=1)
    return sampled
