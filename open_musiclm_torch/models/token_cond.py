"""Token-conditioned transformer over a concatenation of token sequences
(port of open_musiclm_tpu/models/token_cond.py).

One decoder over ``[start_0, tokens_0, start_1, tokens_1, ...]``: each
sequence has its own embedding table (per-quantizer id offsets, PAD = -1
embeds to zero), start token and per-quantizer logit heads ``[Q, C, d]``.
KV-cached generation lives in ``models/quant_decode.py``.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
from torch import nn

from ..core.sequence import SequenceLayout, TokenSequenceSpec, quantizer_offsets
from .transformer import Transformer

PAD_ID = -1


class TokenConditionedTransformer(nn.Module):
    def __init__(self, specs: Tuple[TokenSequenceSpec, ...], dim: int, depth: int,
                 heads: int = 8, dim_head: int = 64, grad_shrink_alpha: float = 0.1,
                 non_causal_prefix_size: int = 0,
                 relative_position_bias_type: str = "continuous",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.specs = tuple(specs)
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
            relative_position_bias_type, generator=generator,
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
        emb = self.embeds[i](ids)
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

    def forward(self, all_token_ids: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """Per-sequence logits [b, pred_len_i, vocab_i]; pred_len_i = n_i, plus
        one for the last sequence (its final position predicts the next token)."""
        layout = SequenceLayout(self.specs, tuple(int(t.shape[-1]) for t in all_token_ids))
        h = self.transformer(self.assemble_stream(all_token_ids))
        out = []
        last = len(self.specs) - 1
        for i in range(len(self.specs)):
            begin, n = layout.pred_slice(i)
            n = n + 1 if i == last else n
            out.append(self.sequence_logits(i, h[:, begin:begin + n]))
        return out
