"""The CLIP text tower, CLAP's ``transformer`` text branch (port of
open_musiclm_tpu/models/clap/clip_text.py).

Token embedding + learned positions -> pre-LN causal transformer blocks
(``nn.MultiheadAttention`` with biased q/k/v/out, a 4x MLP with exact GELU
or ``quick_gelu``) -> ``ln_final`` -> the feature at each row's first
highest token id (the end of text) -> ``text_projection`` (Linear, ReLU,
Linear) into the joint space. No shipped MusicLM config takes this tower
(they take RoBERTa); the CLAP presets declare it. Parameter names follow
the laion CLAP checkpoint's CLIP text side: ``token_embedding``,
``positional_embedding``,
``transformer.resblocks.{i}.{ln_1,attn.in_proj_*,attn.out_proj,ln_2,mlp.c_fc,mlp.c_proj}``,
``ln_final``, ``text_projection.{0,2}``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ...ops.relpos import lecun_normal_


@dataclasses.dataclass(frozen=True)
class ClipTextConfig:
    context_length: int = 77
    vocab_size: int = 49408
    width: int = 512
    heads: int = 8
    layers: int = 12
    quick_gelu: bool = False


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


class ResidualAttentionBlock(nn.Module):
    def __init__(self, cfg: ClipTextConfig):
        super().__init__()
        self.quick_gelu = cfg.quick_gelu
        self.ln_1 = nn.LayerNorm(cfg.width)
        self.attn = nn.MultiheadAttention(cfg.width, cfg.heads, batch_first=True)
        self.ln_2 = nn.LayerNorm(cfg.width)
        self.mlp = nn.ModuleDict({"c_fc": nn.Linear(cfg.width, 4 * cfg.width),
                                  "c_proj": nn.Linear(4 * cfg.width, cfg.width)})

    def forward(self, x: torch.Tensor, causal_mask: torch.Tensor) -> torch.Tensor:
        h = self.ln_1(x)
        x = x + self.attn(h, h, h, attn_mask=causal_mask, need_weights=False, is_causal=True)[0]
        h = self.mlp["c_fc"](self.ln_2(x))
        return x + self.mlp["c_proj"](quick_gelu(h) if self.quick_gelu else F.gelu(h))


class ClipTextTransformer(nn.Module):
    """``forward(token_ids)`` [B, T <= context_length] -> [B, joint] (not
    normalized). A seeded init draws the embeddings (N(0, 0.02) tokens,
    N(0, 0.01) positions), then every projection (lecun-normal, zero bias)."""

    def __init__(self, cfg: ClipTextConfig = ClipTextConfig(), joint_embed_shape: int = 512,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        self.token_embedding = nn.Embedding(cfg.vocab_size, cfg.width)
        self.positional_embedding = nn.Parameter(torch.empty(cfg.context_length, cfg.width))
        self.transformer = nn.Module()
        self.transformer.resblocks = nn.ModuleList(ResidualAttentionBlock(cfg) for _ in range(cfg.layers))
        self.ln_final = nn.LayerNorm(cfg.width)
        self.text_projection = nn.Sequential(nn.Linear(cfg.width, joint_embed_shape), nn.ReLU(),
                                             nn.Linear(joint_embed_shape, joint_embed_shape))
        with torch.no_grad():
            self.token_embedding.weight.normal_(0.0, 0.02, generator=generator)
            self.positional_embedding.normal_(0.0, 0.01, generator=generator)
            for m in self.modules():
                if isinstance(m, nn.MultiheadAttention):
                    lecun_normal_(m.in_proj_weight, cfg.width, generator)
                    m.in_proj_bias.zero_()
                elif isinstance(m, nn.Linear):
                    lecun_normal_(m.weight, m.in_features, generator)
                    m.bias.zero_()

    def forward(self, token_ids: torch.Tensor) -> torch.Tensor:
        token_ids = token_ids.to(self.positional_embedding.device, torch.long)
        T = token_ids.shape[1]
        x = self.token_embedding(token_ids) + self.positional_embedding[:T]
        causal = nn.Transformer.generate_square_subsequent_mask(T, device=x.device, dtype=x.dtype)
        for block in self.transformer.resblocks:
            x = block(x, causal)
        x = self.ln_final(x)
        return self.text_projection(x[torch.arange(x.shape[0], device=x.device), token_ids.argmax(dim=-1)])
