"""Token-conditioned transformer over a concatenation of token sequences
(port of open_musiclm_tpu/models/token_cond.py).

One decoder over ``[start_0, tokens_0, start_1, tokens_1, ...]``: each
sequence has its own embedding table (per-quantizer id offsets, PAD = -1
embeds to zero), start token and per-quantizer logit heads ``[Q, C, d]``.
KV-cached generation lives in ``models/quant_decode.py``; the training loss
(``stage_training_loss``) and ``token_accuracy`` live here.

``compute_dtype`` (None: the parameters' dtype) is the dtype of the stream:
bfloat16 training on float32 master weights casts the embeddings, start
tokens and logit heads at their use, as the JAX package's ``dtype`` does.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..core.masks import conditioning_attn_mask, forgetful_causal_mask
from ..core.sampling import append_eos_id
from ..core.sequence import SequenceLayout, TokenSequenceSpec, quantizer_offsets
from .transformer import Transformer

PAD_ID = -1


class TokenConditionedTransformer(nn.Module):
    def __init__(self, specs: Tuple[TokenSequenceSpec, ...], dim: int, depth: int,
                 heads: int = 8, dim_head: int = 64, grad_shrink_alpha: float = 0.1,
                 non_causal_prefix_size: int = 0,
                 relative_position_bias_type: str = "continuous", ff_dropout: float = 0.0,
                 compute_dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.specs = tuple(specs)
        self.compute_dtype = compute_dtype
        self.dim, self.depth, self.heads, self.dim_head = dim, depth, heads, dim_head
        with torch.no_grad():
            self.embeds = nn.ModuleList()
            self.logit_heads = nn.ParameterList()
            for spec in self.specs:
                emb = nn.Embedding(spec.embed_vocab, dim)
                nn.init.normal_(emb.weight, std=1.0, generator=generator)
                self.embeds.append(emb)
                w = torch.empty(spec.num_quantizers, spec.vocab_with_eos, dim)
                self.logit_heads.append(nn.Parameter(nn.init.normal_(w, generator=generator)))
            self.start_tokens = nn.Parameter(
                nn.init.normal_(torch.empty(len(self.specs), dim), generator=generator)
            )
        self.transformer = Transformer(
            dim, depth, heads, dim_head, grad_shrink_alpha, non_causal_prefix_size,
            relative_position_bias_type, ff_dropout=ff_dropout, generator=generator,
        )

    def embed_one_sequence(self, i: int, token_ids: torch.Tensor) -> torch.Tensor:
        """[b, n] flat ids (pad = -1) -> [b, n, dim] with quantizer offsets
        (t % Q) * codebook_size and zeroed pad embeddings."""
        spec = self.specs[i]
        n = token_ids.shape[-1]
        pad = token_ids == PAD_ID
        ids = torch.where(pad, torch.zeros_like(token_ids), token_ids)
        if spec.num_quantizers > 1:
            ids = ids + torch.as_tensor(quantizer_offsets(spec, n), device=ids.device)[None, :]
        emb = self.embeds[i](ids).to(self.compute_dtype or self.embeds[i].weight.dtype)
        return emb.masked_fill(pad[..., None], 0.0)

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
        w = self.logit_heads[i].to(h.dtype)  # [Q, C, d]
        out = h.new_empty(h.shape[:2] + (w.shape[1],))
        for q in range(w.shape[0]):
            out[:, q::w.shape[0]] = h[:, q::w.shape[0]] @ w[q].t()
        return out

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
# Training loss (open_musiclm_tpu/models/token_cond.py:stage_training_loss)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class StageLossConfig:
    cross_entropy_loss_weights: Tuple[float, ...]
    mask_prob: float = 0.15
    pad_id: int = PAD_ID
    # the JAX package's fixed-shape stand-in for batch_unique_consecutive;
    # off in every shipped config and not ported
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
    if cfg.unique_consecutive:
        raise NotImplementedError("unique_consecutive is not ported (no shipped config uses it)")
    specs = model.specs
    eos_ids = [s.eos_id for s in specs]
    ids = [t.reshape(t.shape[0], -1) for t in all_token_ids]
    if not input_has_eos:
        ids = [append_eos_id(t, e) for t, e in zip(ids, eos_ids)]
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
    for lg, lb, w in zip(logits, labels, cfg.cross_entropy_loss_weights):
        if w <= 0 or lg is None:
            continue
        logp = F.log_softmax(lg.float(), dim=-1)
        safe = torch.where(lb == cfg.pad_id, torch.zeros_like(lb), lb)
        nll = -logp.gather(-1, safe[..., None])[..., 0]
        running_loss = running_loss + nll.mean() * lb.numel() * w
        total += lb.numel()
    loss = running_loss / max(total, 1)
    return loss, {"logits": logits, "labels": labels}


def token_accuracy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Fraction of argmax-correct predictions."""
    return (logits.argmax(dim=-1) == labels).float().mean()
