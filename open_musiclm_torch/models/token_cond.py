"""Token-conditioned transformer over a concatenation of token sequences
(port of open_musiclm_tpu/models/token_cond.py).

One decoder over ``[start_0, tokens_0, start_1, tokens_1, ...]``: each
sequence has its own embedding table (per-quantizer id offsets, PAD = -1
embeds to zero), start token and per-quantizer logit heads ``[Q, C, d]``.
``generate`` is the fp KV-cached decode (the int8 serving decodes in
``models/quant_decode.py`` share its prompt set-up and sampling loop); the
training loss (``stage_training_loss``) and ``token_accuracy`` live here too.

``compute_dtype`` (None: the parameters' dtype) is the dtype of the stream:
bfloat16 training on float32 master weights casts the embeddings, start
tokens and logit heads at their use, as the JAX package's ``dtype`` does.
``remat`` recomputes each block's activations in the backward
(``Transformer``); like the JAX package's it is a field of the model
(``model.transformer.remat``), which no config or CLI flag sets.

``parallel/sharding.py:shard_module`` splits a model over a mesh's ``tp``
axis: the layers as ``Transformer`` says, an embedding table whose rows
divide by ``tp`` by rows (``embed_rows`` masks the ids outside the rank's
rows and sums over ``tp``), a logit head whose codes divide by ``tp`` by
codes (the logits are gathered along C). ``generate`` then runs the fp
decode on the shard: every rank keeps the whole K/V cache (one head), its
own channels of the conv-FF state and its heads of the bias table, and
samples the same token from the same gathered logits and keys.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..core.masks import conditioning_attn_mask, forgetful_causal_mask
from ..core.sampling import (
    NEG_INF,
    append_eos_id,
    mask_out_after_eos_id,
    mask_unique_consecutive,
    sample_top_k_gumbel,
    sample_top_k_gumbel_per_row,
    split_row_keys,
)
from ..core.sequence import SequenceLayout, TokenSequenceSpec, quantizer_offsets
from ..parallel.sharding import copy_to_tp, gather_from_tp, reduce_from_tp
from ..ops.rows import DECODE_TILE, row_linear
from .transformer import Transformer

PAD_ID = -1


class TokenConditionedTransformer(nn.Module):
    def __init__(self, specs: Tuple[TokenSequenceSpec, ...], dim: int, depth: int,
                 heads: int = 8, dim_head: int = 64, grad_shrink_alpha: float = 0.1,
                 non_causal_prefix_size: int = 0,
                 relative_position_bias_type: str = "continuous", ff_dropout: float = 0.0,
                 compute_dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None, remat: bool = False,
                 attn_dropout: float = 0.0, use_conv_ff: bool = True,
                 use_absolute_position_embeddings: bool = False,
                 max_absolute_position_embeddings: int = 262):
        super().__init__()
        self.specs = tuple(specs)
        self.compute_dtype = compute_dtype
        self.dim, self.depth, self.heads, self.dim_head = dim, depth, heads, dim_head
        with torch.no_grad():
            self.embeds = nn.ModuleList()
            self.logit_heads = nn.ParameterList()
            # absolute positions (no shipped config sets them): a table a
            # sequence, added to its embeddings at their positions
            self.pos_embeds = nn.ModuleList() if use_absolute_position_embeddings else None
            for spec in self.specs:
                emb = nn.Embedding(spec.embed_vocab, dim)
                nn.init.normal_(emb.weight, std=1.0, generator=generator)
                self.embeds.append(emb)
                w = torch.empty(spec.num_quantizers, spec.vocab_with_eos, dim)
                self.logit_heads.append(nn.Parameter(nn.init.normal_(w, generator=generator)))
                if self.pos_embeds is not None:
                    pos = nn.Embedding(max_absolute_position_embeddings, dim)
                    nn.init.normal_(pos.weight, std=1.0, generator=generator)
                    self.pos_embeds.append(pos)
            self.start_tokens = nn.Parameter(
                nn.init.normal_(torch.empty(len(self.specs), dim), generator=generator)
            )
        self.transformer = Transformer(
            dim, depth, heads, dim_head, grad_shrink_alpha, non_causal_prefix_size,
            relative_position_bias_type, ff_dropout=ff_dropout, generator=generator, remat=remat,
            attn_dropout=attn_dropout, use_conv_ff=use_conv_ff,
        )
        # set by shard_module: the mesh, which tables split by rows (codes),
        # the split parameters and the replicated ones with partial gradients
        self.tp_mesh = None
        self.embed_split = self.logit_split = (False,) * len(self.specs)
        self.tp_splits, self.tp_partial = {}, frozenset()

    def embed_rows(self, i: int, ids: torch.Tensor) -> torch.Tensor:
        """Rows ``ids`` (offset, no pad) of sequence i's embedding table, in
        the table's dtype; of a table split by rows, each rank's rows summed
        over ``tp``."""
        w = self.embeds[i].weight
        if not self.embed_split[i]:
            return F.embedding(ids, w)
        local = ids - self.tp_mesh.tp_rank * w.shape[0]
        inside = (local >= 0) & (local < w.shape[0])
        rows = F.embedding(torch.where(inside, local, torch.zeros_like(local)), w)
        return reduce_from_tp(rows.masked_fill(~inside[..., None], 0.0), self.tp_mesh)

    def head_logits(self, i: int, h: torch.Tensor, q: int, tile: Optional[int] = None) -> torch.Tensor:
        """``h @ head_q^T`` of sequence i's logit head q, in ``tile``-row calls
        on the card where given (``rows.row_linear``); a split head's codes
        are gathered along C (h's gradient, a share a rank, is summed over
        ``tp``)."""
        if not self.logit_split[i]:
            if tile is not None:
                return row_linear(h, self.logit_heads[i][q].to(h.dtype), tile=tile)
            return h @ self.logit_heads[i][q].to(h.dtype).t()
        h = copy_to_tp(h, self.tp_mesh)
        return gather_from_tp(h @ self.logit_heads[i][q].to(h.dtype).t(), self.tp_mesh)

    def embed_one_sequence(self, i: int, token_ids: torch.Tensor) -> torch.Tensor:
        """[b, n] flat ids (pad = -1) -> [b, n, dim] with quantizer offsets
        (t % Q) * codebook_size and zeroed pad embeddings."""
        spec = self.specs[i]
        n = token_ids.shape[-1]
        pad = token_ids == PAD_ID
        ids = torch.where(pad, torch.zeros_like(token_ids), token_ids)
        if spec.num_quantizers > 1:
            ids = ids + torch.as_tensor(quantizer_offsets(spec, n), device=ids.device)[None, :]
        emb = self.embed_rows(i, ids).to(self.compute_dtype or self.embeds[i].weight.dtype)
        emb = emb.masked_fill(pad[..., None], 0.0)
        if self.pos_embeds is not None:
            emb = emb + self.pos_embeds[i].weight[:n].to(emb.dtype)
        return emb

    def assemble_stream(self, all_token_ids: Sequence[torch.Tensor]) -> torch.Tensor:
        """Interleave [start_i, embed(tokens_i)] into one [b, total, dim]."""
        b = all_token_ids[0].shape[0]
        parts = []
        for i, ids in enumerate(all_token_ids):
            emb = self.embed_one_sequence(i, ids)
            parts.append(self.start_tokens[i].to(emb.dtype).expand(b, 1, self.dim))
            parts.append(emb)
        return torch.cat(parts, dim=1)

    def sequence_logits(self, i: int, h: torch.Tensor) -> torch.Tensor:
        """Logits [b, n, C] for sequence i's prediction window: position t
        uses head t % Q."""
        spec = self.specs[i]
        q_num = spec.num_quantizers
        out = h.new_empty(h.shape[:2] + (spec.vocab_with_eos,))
        for q in range(q_num):
            out[:, q::q_num] = self.head_logits(i, h[:, q::q_num], q)
        return out

    def step_logits(self, h_t: torch.Tensor, q_idx: int) -> torch.Tensor:
        """Decode-step logits [b, C] of the final sequence's head ``q_idx``."""
        return self.head_logits(len(self.specs) - 1, h_t, q_idx, DECODE_TILE)

    def embed_pred_token(self, ids: torch.Tensor, flat_idx: int) -> torch.Tensor:
        """[b] ids of the final sequence's token at ``flat_idx`` (quantizer
        offset added) -> its embedding [b, dim] in the compute dtype, plus
        the position's absolute embedding where the model has them."""
        last = len(self.specs) - 1
        dtype = self.compute_dtype or self.embeds[last].weight.dtype
        emb = self.embed_rows(last, ids).to(dtype)
        if self.pos_embeds is not None:
            emb = emb + self.pos_embeds[last].weight[flat_idx].to(dtype)
        return emb

    def forward(self, all_token_ids: Sequence[torch.Tensor], *,
                self_attn_mask: Optional[torch.Tensor] = None,
                return_only_final_seq_logits: bool = False,
                generator: Optional[torch.Generator] = None) -> List[Optional[torch.Tensor]]:
        """Per-sequence logits [b, pred_len_i, vocab_i]; pred_len_i = n_i, plus
        one for the last sequence (its final position predicts the next token).
        ``self_attn_mask`` [b, total] is the key mask (True = attend);
        ``generator`` draws the FF dropout in train() mode. Skipped
        sequences (``return_only_final_seq_logits``) give None."""
        layout = SequenceLayout(self.specs, tuple(int(t.shape[-1]) for t in all_token_ids))
        h = self.transformer(self.assemble_stream(all_token_ids), self_attn_mask=self_attn_mask,
                             generator=generator)
        out: List[Optional[torch.Tensor]] = []
        last = len(self.specs) - 1
        for i in range(len(self.specs)):
            if return_only_final_seq_logits and i != last:
                out.append(None)
                continue
            begin, n = layout.pred_slice(i)
            n = n + 1 if i == last else n
            out.append(self.sequence_logits(i, h[:, begin:begin + n]))
        return out


# ---------------------------------------------------------------------------
# KV-cached generation (open_musiclm_tpu/models/token_cond.py:generate)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Prompt:
    """A generate call's prompt: the prefill sequences (conditioning with
    EOS appended, then the given prefix of the final sequence) and the
    decode schedule in flat final-sequence positions."""

    prefill_ids: List[torch.Tensor]
    init_flat: torch.Tensor  # [b, n_init]
    n_new: int
    total_steps: int
    prefill_len: int  # stream positions before the first decoded token

    @property
    def n_init(self) -> int:
        return self.init_flat.shape[-1]


def make_prompt(model: TokenConditionedTransformer, conditioning_token_ids, *, max_time_steps: int,
                init_pred_ids: Optional[torch.Tensor], append_eos: bool) -> Prompt:
    specs = model.specs
    device = model.start_tokens.device
    batch = conditioning_token_ids[0].shape[0]
    cond = [t.reshape(t.shape[0], -1).to(device, torch.long) for t in conditioning_token_ids]
    if append_eos:
        cond = [append_eos_id(t, s.eos_id) for t, s in zip(cond, specs[:-1])]
    if init_pred_ids is not None:
        init_flat = init_pred_ids.reshape(batch, -1).to(device, torch.long)
    else:
        init_flat = torch.zeros((batch, 0), dtype=torch.long, device=device)
    total_steps = max_time_steps * specs[-1].num_quantizers
    n_new = total_steps - init_flat.shape[-1]
    if n_new <= 0:
        raise ValueError("nothing to generate")
    prefill_ids = cond + [init_flat]
    prefill_len = sum(t.shape[-1] for t in prefill_ids) + len(specs)
    return Prompt(prefill_ids, init_flat, n_new, total_steps, prefill_len)


def decode_loop(
    model: TokenConditionedTransformer,
    prompt: Prompt,
    h_last: torch.Tensor,  # [b, dim] normed output at the last prefill position
    logits_fn: Callable[[torch.Tensor, int], torch.Tensor],  # (h, q_idx) -> [b, C]
    step_fn: Callable[[torch.Tensor, int], torch.Tensor],  # (embedding, pos) -> next h
    generator: Optional[torch.Generator],
    *,
    filter_thres: float,
    temperature: float,
    allow_eos_in_output: bool,
    include_eos_in_output: bool,
    teacher_ids: Optional[torch.Tensor],
    return_logits: bool,
    per_row_keys: Optional[torch.Tensor] = None,
):
    """The sampling loop every decode mode shares: per step the head's
    logits (EOS masked unless allowed at the last quantizer), a top-k gumbel
    sample, and the fed token's embedding through ``step_fn``. Returns
    [b, T, Q] ids (and the per-step float32 logits [b, n_new, C]).

    With ``per_row_keys`` ([b] keys, ``core.sampling``) row i's draws come
    from its own key, split once a step for all rows, and ``generator`` is
    ignored."""
    spec = model.specs[-1]
    q_num, eos_id = spec.num_quantizers, spec.eos_id
    batch, n_init = h_last.shape[0], prompt.n_init
    sampled = torch.full((batch, prompt.total_steps), eos_id, dtype=torch.long, device=h_last.device)
    sampled[:, :n_init] = prompt.init_flat
    teacher_flat = teacher_ids.reshape(batch, -1).to(h_last.device, torch.long) if teacher_ids is not None else None
    if per_row_keys is not None:
        if per_row_keys.shape != (batch,):
            raise ValueError(f"per_row_keys {tuple(per_row_keys.shape)}: want one key per row ({batch},)")
        per_row_keys = per_row_keys.to(h_last.device)
    step_logits = []
    for s in range(prompt.n_new):
        flat_idx = n_init + s
        q_idx = flat_idx % q_num
        logits = logits_fn(h_last, q_idx)
        if not (allow_eos_in_output and q_idx == q_num - 1):
            logits[:, -1] = NEG_INF
        if per_row_keys is None:
            tok = sample_top_k_gumbel(logits, temperature, filter_thres, generator=generator)
        else:
            sub, per_row_keys = split_row_keys(per_row_keys)
            tok = sample_top_k_gumbel_per_row(sub, logits, temperature, filter_thres)
        sampled[:, flat_idx] = tok
        fed = teacher_flat[:, flat_idx] if teacher_flat is not None else tok
        offset = q_idx * spec.codebook_size if q_num > 1 else 0
        h_last = step_fn(model.embed_pred_token(fed + offset, flat_idx), prompt.prefill_len + s)
        if return_logits:
            step_logits.append(logits.float())
    sampled = mask_out_after_eos_id(sampled, eos_id, mask_value=PAD_ID, keep_eos=include_eos_in_output)
    sampled = sampled.reshape(batch, -1, q_num)
    if return_logits:
        return sampled, torch.stack(step_logits, dim=1)
    return sampled


@torch.no_grad()
def generate(
    model: TokenConditionedTransformer,
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
    teacher_ids: Optional[torch.Tensor] = None,
    return_logits: bool = False,
    per_row_keys: Optional[torch.Tensor] = None,
):
    """The fp decode: sample the final sequence given the conditioning
    sequences. Returns [b, max_time_steps, Q] ids (and, with
    ``return_logits``, the per-step float32 logits [b, n_new, C]).
    ``init_pred_ids`` is an already generated prefix ([b, t0, Q] or
    flattened); ``teacher_ids`` feeds the teacher's token forward instead of
    the sample, so every step is scored under the teacher's prefix.
    ``per_row_keys`` [b] draws each row from its own key (``decode_loop``)."""
    prompt = make_prompt(model, conditioning_token_ids, max_time_steps=max_time_steps,
                         init_pred_ids=init_pred_ids, append_eos=append_eos_to_conditioning_tokens)
    tfm = model.transformer
    batch = prompt.init_flat.shape[0]
    max_len = prompt.prefill_len + prompt.n_new
    cache = tfm.init_cache(batch, max_len)
    table = tfm.bias_table(max_len)
    h_all, cache = tfm.prefill(model.assemble_stream(prompt.prefill_ids), cache)
    return decode_loop(
        model, prompt, h_all[:, -1], model.step_logits,
        lambda emb, pos: tfm.decode_step(emb, cache, pos, table), generator,
        filter_thres=filter_thres, temperature=temperature,
        allow_eos_in_output=allow_eos_in_output, include_eos_in_output=include_eos_in_output,
        teacher_ids=teacher_ids, return_logits=return_logits, per_row_keys=per_row_keys,
    )


# ---------------------------------------------------------------------------
# Training loss (open_musiclm_tpu/models/token_cond.py:stage_training_loss)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class StageLossConfig:
    cross_entropy_loss_weights: Tuple[float, ...]
    mask_prob: float = 0.15
    pad_id: int = PAD_ID
    # the JAX package's fixed-shape stand-in for batch_unique_consecutive
    # (off in every shipped config): in the sequences whose spec sets
    # unique_consecutive, a repeat of the previous id becomes pad, hidden
    # from attention (conditioning) and left out of the cross-entropy
    unique_consecutive: bool = False


def stage_training_loss(
    model: TokenConditionedTransformer,
    all_token_ids: Sequence[torch.Tensor],
    cfg: StageLossConfig,
    *,
    generator: Optional[torch.Generator] = None,
    input_has_eos: bool = False,
    train: bool = True,
):
    """Weighted cross-entropy over all sequences, in float32.

    EOS is appended to every sequence (the final one's EOS is label only);
    conditioning pad/EOS ids are hidden from attention and zeroed; with
    ``train`` the forgetful causal mask drops keys (drawn from
    ``generator``, which also draws the FF dropout when the model is in
    train() mode). Returns (loss, {"logits": [...], "labels": [...]}).
    """
    specs = model.specs
    eos_ids = [s.eos_id for s in specs]
    ids = [t.reshape(t.shape[0], -1) for t in all_token_ids]
    if not input_has_eos:
        ids = [append_eos_id(t, e) for t, e in zip(ids, eos_ids)]
    unique = [cfg.unique_consecutive and s.unique_consecutive for s in specs]
    ids = [mask_unique_consecutive(t, cfg.pad_id) if u else t for t, u in zip(ids, unique)]
    labels = list(ids)
    ids[-1] = ids[-1][:, :-1]  # the final token (EOS) is label only

    attn_mask = conditioning_attn_mask(ids[:-1], eos_ids[:-1], cfg.pad_id, ids[-1].shape[-1] + 1)
    for i in range(len(ids) - 1):
        keep = (ids[i] != cfg.pad_id) & (ids[i] != eos_ids[i])
        ids[i] = torch.where(keep, ids[i], torch.zeros_like(ids[i]))
    if cfg.mask_prob > 0 and train:
        batch, seq = attn_mask.shape
        attn_mask = attn_mask & forgetful_causal_mask(
            batch, seq, cfg.mask_prob, generator, device=attn_mask.device)

    logits = model(ids, self_attn_mask=attn_mask, generator=generator)

    running_loss, total = 0.0, 0
    for lg, lb, w, u in zip(logits, labels, cfg.cross_entropy_loss_weights, unique):
        if w <= 0 or lg is None:
            continue
        logp = F.log_softmax(lg.float(), dim=-1)
        safe = torch.where(lb == cfg.pad_id, torch.zeros_like(lb), lb)
        nll = -logp.gather(-1, safe[..., None])[..., 0]
        if u:  # the mean over the labels that are not pad (the reference's ignore_index)
            valid = lb != cfg.pad_id
            num = valid.sum()
            mean_nll = torch.where(valid, nll, torch.zeros_like(nll)).sum() / num.clamp(min=1)
        else:
            num = lb.numel()
            mean_nll = nll.mean()
        running_loss = running_loss + mean_nll * num * w
        total = total + num
    loss = running_loss / (total.clamp(min=1) if torch.is_tensor(total) else max(total, 1))
    return loss, {"logits": logits, "labels": labels}


def token_accuracy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Fraction of argmax-correct predictions."""
    return (logits.argmax(dim=-1) == labels).float().mean()
