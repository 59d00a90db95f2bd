"""HuBERT encoder, MERT-v0 geometry (port of open_musiclm_tpu/models/hubert.py).

16 kHz waveform -> 7-layer conv feature extractor (320x downsample, 50 Hz)
-> feature projection -> grouped-conv positional embedding -> 12 post-LN
transformer layers. ``hidden_states[i]`` follows Hugging Face's indexing:
entry 0 comes before layer 0, entry i after layer i - 1.
``HubertWithKmeans`` taps ``embed_layer`` (7), normalizes each frame and
assigns the k-means centroid: the semantic tokens of a prompt's audio.

Module and parameter names follow ``transformers.HubertModel``
(``feature_extractor.conv_layers.{i}.conv``, ``feature_projection.*``,
``encoder.pos_conv_embed.conv``, ``encoder.layers.{i}.attention.q_proj``, ...).
The positional conv holds the folded weight; a checkpoint's
``weight_g`` / ``weight_v`` pair is folded by ``import_torch.import_hubert``.

``HubertModel.compute_dtype`` (None: the parameters' dtype) runs the stream
in another dtype, flax's ``dtype``: the weights are cast at their use, the
GroupNorm / LayerNorm statistics taken in float32.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.audio import zero_mean_unit_var_norm as zero_mean_unit_var
from ..ops.relpos import conv, lecun_normal_, linear, norm
from .kmeans import kmeans_predict


@dataclasses.dataclass(frozen=True)
class HubertConfig:
    """The HubertConfig fields MERT-v0 / hubert-base need."""

    conv_dim: Tuple[int, ...] = (512,) * 7
    conv_kernel: Tuple[int, ...] = (10, 3, 3, 3, 3, 2, 2)
    conv_stride: Tuple[int, ...] = (5, 2, 2, 2, 2, 2, 2)
    conv_bias: bool = False
    feat_extract_norm: str = "group"  # 'group' (base) | 'layer' (large)
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    num_conv_pos_embeddings: int = 128
    num_conv_pos_embedding_groups: int = 16
    layer_norm_eps: float = 1e-5

    @property
    def downsample_factor(self) -> int:
        return math.prod(self.conv_stride)


def _init_(module: nn.Module, generator: Optional[torch.Generator]) -> None:
    """flax defaults: lecun-normal weights over fan_in, zero biases."""
    for m in module.modules():
        if isinstance(m, (nn.Linear, nn.Conv1d)):
            lecun_normal_(m.weight, m.weight[0].numel(), generator)
            if m.bias is not None:
                with torch.no_grad():
                    m.bias.zero_()


class ConvLayer(nn.Module):
    def __init__(self, cfg: HubertConfig, i: int):
        super().__init__()
        in_ch = 1 if i == 0 else cfg.conv_dim[i - 1]
        dim = cfg.conv_dim[i]
        self.conv = nn.Conv1d(in_ch, dim, cfg.conv_kernel[i], stride=cfg.conv_stride[i], bias=cfg.conv_bias)
        if cfg.feat_extract_norm == "group" and i == 0:
            self.layer_norm = nn.GroupNorm(dim, dim, eps=cfg.layer_norm_eps)
        elif cfg.feat_extract_norm == "layer":
            self.layer_norm = nn.LayerNorm(dim, eps=cfg.layer_norm_eps)
        else:
            self.layer_norm = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # [B, C, T]
        x = conv(x, self.conv)
        if isinstance(self.layer_norm, nn.LayerNorm):
            x = norm(x.transpose(1, 2), self.layer_norm).transpose(1, 2)
        elif self.layer_norm is not None:
            x = norm(x, self.layer_norm)
        return F.gelu(x)


class FeatureEncoder(nn.Module):
    def __init__(self, cfg: HubertConfig):
        super().__init__()
        self.conv_layers = nn.ModuleList(ConvLayer(cfg, i) for i in range(len(cfg.conv_dim)))

    def forward(self, wav: torch.Tensor) -> torch.Tensor:  # [B, T] -> [B, T', C]
        h = wav[:, None]
        for layer in self.conv_layers:
            h = layer(h)
        return h.transpose(1, 2)


class FeatureProjection(nn.Module):
    def __init__(self, cfg: HubertConfig):
        super().__init__()
        self.layer_norm = nn.LayerNorm(cfg.conv_dim[-1], eps=cfg.layer_norm_eps)
        self.projection = nn.Linear(cfg.conv_dim[-1], cfg.hidden_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return linear(norm(x, self.layer_norm), self.projection)


class PositionalConvEmbedding(nn.Module):
    def __init__(self, cfg: HubertConfig):
        super().__init__()
        k = cfg.num_conv_pos_embeddings
        self.conv = nn.Conv1d(cfg.hidden_size, cfg.hidden_size, k, padding=k // 2,
                              groups=cfg.num_conv_pos_embedding_groups)
        self.trim = 1 if k % 2 == 0 else 0  # HF SamePad drops the last step of an even kernel

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # [B, T, H]
        h = conv(x.transpose(1, 2), self.conv)
        if self.trim:
            h = h[..., :-self.trim]
        return F.gelu(h).transpose(1, 2)


class Attention(nn.Module):
    def __init__(self, cfg: HubertConfig):
        super().__init__()
        H = cfg.hidden_size
        self.heads = cfg.num_attention_heads
        self.q_proj, self.k_proj, self.v_proj, self.out_proj = (nn.Linear(H, H) for _ in range(4))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, T, H = x.shape

        def split(t):
            return t.reshape(B, T, self.heads, -1).transpose(1, 2)

        out = F.scaled_dot_product_attention(split(linear(x, self.q_proj)), split(linear(x, self.k_proj)),
                                             split(linear(x, self.v_proj)))
        return linear(out.transpose(1, 2).reshape(B, T, H), self.out_proj)


class FeedForward(nn.Module):
    def __init__(self, cfg: HubertConfig):
        super().__init__()
        self.intermediate_dense = nn.Linear(cfg.hidden_size, cfg.intermediate_size)
        self.output_dense = nn.Linear(cfg.intermediate_size, cfg.hidden_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return linear(F.gelu(linear(x, self.intermediate_dense)), self.output_dense)


class EncoderLayer(nn.Module):
    """Post-LN transformer layer (hubert-base, do_stable_layer_norm=False)."""

    def __init__(self, cfg: HubertConfig):
        super().__init__()
        self.attention = Attention(cfg)
        self.layer_norm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.feed_forward = FeedForward(cfg)
        self.final_layer_norm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = norm(x + self.attention(x), self.layer_norm)
        return norm(x + self.feed_forward(x), self.final_layer_norm)


class Encoder(nn.Module):
    def __init__(self, cfg: HubertConfig):
        super().__init__()
        self.pos_conv_embed = PositionalConvEmbedding(cfg)
        self.layer_norm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.layers = nn.ModuleList(EncoderLayer(cfg) for _ in range(cfg.num_hidden_layers))


class HubertModel(nn.Module):
    def __init__(self, cfg: HubertConfig = HubertConfig(), generator: Optional[torch.Generator] = None,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.cfg = cfg
        self.compute_dtype = compute_dtype
        self.feature_extractor = FeatureEncoder(cfg)
        self.feature_projection = FeatureProjection(cfg)
        self.encoder = Encoder(cfg)
        _init_(self, generator)

    def forward(self, wav: torch.Tensor, num_layers: Optional[int] = None) -> List[torch.Tensor]:
        """wav [B, T] at 16 kHz -> hidden states [B, T', H], Hugging Face
        indexing, through the first ``num_layers`` layers (all by default)."""
        wav = wav.to(self.compute_dtype or self.feature_projection.projection.weight.dtype)
        h = self.feature_projection(self.feature_extractor(wav))
        h = norm(h + self.encoder.pos_conv_embed(h), self.encoder.layer_norm)
        hidden_states = [h]
        for layer in self.encoder.layers[:num_layers]:
            h = layer(h)
            hidden_states.append(h)
        return hidden_states

    def extract_features(self, wav: torch.Tensor, layer: int = 7) -> torch.Tensor:
        """hidden_states[layer]; the layers after it are not run."""
        return self(wav, num_layers=layer)[layer]


class HubertWithKmeans(nn.Module):
    """HuBERT features + k-means assignment: [B, T] audio at
    ``target_sample_hz`` -> [B, T'] semantic token ids."""

    def __init__(self, model: HubertModel, centroids: torch.Tensor, *, embed_layer: int = 7,
                 normalize_embeds: bool = True, target_sample_hz: int = 16000,
                 seq_len_multiple_of: int = 320, output_hz: int = 50):
        super().__init__()
        self.model = model
        self.register_buffer("centroids", centroids)
        self.embed_layer = embed_layer
        self.normalize_embeds = normalize_embeds
        self.target_sample_hz = target_sample_hz
        self.seq_len_multiple_of = seq_len_multiple_of
        self.output_hz = output_hz

    @property
    def codebook_size(self) -> int:
        return int(self.centroids.shape[0])

    @torch.no_grad()
    def features(self, wav: torch.Tensor) -> torch.Tensor:
        """[B, T] -> [B, T', H] layer-``embed_layer`` features in float32,
        each frame normalized when ``normalize_embeds``."""
        if self.seq_len_multiple_of:
            wav = wav[..., : (wav.shape[-1] // self.seq_len_multiple_of) * self.seq_len_multiple_of]
        w = self.centroids
        emb = self.model.extract_features(wav.to(w.device, w.dtype), self.embed_layer).float()
        return zero_mean_unit_var(emb) if self.normalize_embeds else emb

    def forward(self, wav: torch.Tensor) -> torch.Tensor:
        return kmeans_predict(self.features(wav), self.centroids)
