"""RoBERTa-base text encoder, the CLAP text branch (port of
open_musiclm_tpu/models/clap/roberta.py).

Post-LN BERT layers with exact GELU; position ids follow the RoBERTa
convention, ``cumsum(mask) * mask + pad_token_id``. The CLAP path uses only
``pooler_output`` (tanh over a dense of the first position). The module's
``state_dict`` has the Hugging Face ``RobertaModel`` key layout
(``embeddings.*``, ``encoder.layer.{i}.*``, ``pooler.dense``); attention is
plain torch ops, as the JAX package computes it in plain XLA.

``compute_dtype`` (None: the parameters' dtype) runs the stream in another
dtype, the weights cast at their use; LayerNorm statistics and the softmax
are taken in float32.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn


@dataclasses.dataclass(frozen=True)
class RobertaConfig:
    vocab_size: int = 50265
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 514
    type_vocab_size: int = 1
    layer_norm_eps: float = 1e-5
    pad_token_id: int = 1


def _linear(x: torch.Tensor, layer: nn.Linear) -> torch.Tensor:
    return F.linear(x, layer.weight.to(x.dtype), layer.bias.to(x.dtype))


def _layer_norm(x: torch.Tensor, norm: nn.LayerNorm) -> torch.Tensor:
    return F.layer_norm(x.float(), norm.normalized_shape, norm.weight.float(), norm.bias.float(),
                        norm.eps).to(x.dtype)


class _SelfAttention(nn.Module):
    def __init__(self, hidden: int):
        super().__init__()
        self.query = nn.Linear(hidden, hidden)
        self.key = nn.Linear(hidden, hidden)
        self.value = nn.Linear(hidden, hidden)


class _AttentionOutput(nn.Module):
    def __init__(self, hidden: int, eps: float):
        super().__init__()
        self.dense = nn.Linear(hidden, hidden)
        self.LayerNorm = nn.LayerNorm(hidden, eps=eps)


class _Attention(nn.Module):
    def __init__(self, cfg: RobertaConfig):
        super().__init__()
        self.heads = cfg.num_attention_heads
        self.self = _SelfAttention(cfg.hidden_size)
        self.output = _AttentionOutput(cfg.hidden_size, cfg.layer_norm_eps)

    def forward(self, x: torch.Tensor, key_mask: torch.Tensor) -> torch.Tensor:
        """x [B, T, hidden], key_mask [B, 1, 1, T] bool -> post-LN output."""
        B, T, hidden = x.shape

        def heads(layer):  # [B, T, hidden] -> [B, heads, T, d]
            return _linear(x, layer).reshape(B, T, self.heads, -1).transpose(1, 2)

        q, k, v = heads(self.self.query), heads(self.self.key), heads(self.self.value)
        scores = (q / q.shape[-1] ** 0.5) @ k.transpose(-1, -2)
        scores = scores.float().masked_fill(~key_mask, torch.finfo(torch.float32).min)
        ctx = scores.softmax(dim=-1).to(v.dtype) @ v
        out = _linear(ctx.transpose(1, 2).reshape(B, T, hidden), self.output.dense)
        return _layer_norm(x + out, self.output.LayerNorm)


class _Dense(nn.Module):
    def __init__(self, d_in: int, d_out: int):
        super().__init__()
        self.dense = nn.Linear(d_in, d_out)


class _Output(nn.Module):
    def __init__(self, cfg: RobertaConfig):
        super().__init__()
        self.dense = nn.Linear(cfg.intermediate_size, cfg.hidden_size)
        self.LayerNorm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)


class RobertaLayer(nn.Module):
    def __init__(self, cfg: RobertaConfig):
        super().__init__()
        self.attention = _Attention(cfg)
        self.intermediate = _Dense(cfg.hidden_size, cfg.intermediate_size)
        self.output = _Output(cfg)

    def forward(self, x: torch.Tensor, key_mask: torch.Tensor) -> torch.Tensor:
        x = self.attention(x, key_mask)
        ff = F.gelu(_linear(x, self.intermediate.dense))  # exact (erf) GELU
        return _layer_norm(x + _linear(ff, self.output.dense), self.output.LayerNorm)


class _Embeddings(nn.Module):
    def __init__(self, cfg: RobertaConfig):
        super().__init__()
        self.word_embeddings = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.position_embeddings = nn.Embedding(cfg.max_position_embeddings, cfg.hidden_size)
        self.token_type_embeddings = nn.Embedding(cfg.type_vocab_size, cfg.hidden_size)
        self.LayerNorm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)


class _Encoder(nn.Module):
    def __init__(self, cfg: RobertaConfig):
        super().__init__()
        self.layer = nn.ModuleList(RobertaLayer(cfg) for _ in range(cfg.num_hidden_layers))


class RobertaModel(nn.Module):
    def __init__(self, cfg: RobertaConfig = RobertaConfig(),
                 compute_dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        """Weights N(0, 0.02) from ``generator`` (RoBERTa's own init), biases
        0, LayerNorms 1 and 0."""
        super().__init__()
        self.cfg = cfg
        self.compute_dtype = compute_dtype
        self.embeddings = _Embeddings(cfg)
        self.encoder = _Encoder(cfg)
        self.pooler = _Dense(cfg.hidden_size, cfg.hidden_size)
        init_normal_(self, generator)

    def forward(self, input_ids, attention_mask=None) -> Dict[str, torch.Tensor]:
        """input_ids [B, T] (and attention_mask [B, T], 1 = token) ->
        {"last_hidden_state": [B, T, hidden], "pooler_output": [B, hidden]}."""
        cfg, emb = self.cfg, self.embeddings
        if attention_mask is None:
            attention_mask = torch.ones_like(input_ids)
        mask = attention_mask.long()
        positions = torch.cumsum(mask, dim=-1) * mask + cfg.pad_token_id
        dtype = self.compute_dtype or emb.word_embeddings.weight.dtype
        h = (emb.word_embeddings(input_ids.long()) + emb.position_embeddings(positions)
             + emb.token_type_embeddings(torch.zeros_like(positions))).to(dtype)
        h = _layer_norm(h, emb.LayerNorm)
        key_mask = mask.bool()[:, None, None, :]
        for layer in self.encoder.layer:
            h = layer(h, key_mask)
        pooled = torch.tanh(_linear(h[:, 0], self.pooler.dense))
        return {"last_hidden_state": h, "pooler_output": pooled}


def init_normal_(module: nn.Module, generator: Optional[torch.Generator], std: float = 0.02) -> None:
    """Linear and embedding weights N(0, std) from ``generator``, biases 0,
    LayerNorms 1 and 0, in place."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, (nn.Linear, nn.Embedding)):
                m.weight.normal_(0.0, std, generator=generator)
            if isinstance(m, nn.Linear) and m.bias is not None:
                m.bias.zero_()
            if isinstance(m, nn.LayerNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()
