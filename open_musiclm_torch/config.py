"""Model config loader and factories (port of open_musiclm_tpu/config.py).

The same dataclasses over the unchanged ``configs/model/*.json``; the
factories build the port's modules with a seeded random init from a
``torch.Generator``. Training configs, CLAP and HuBERT are not ported yet.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from typing import Optional

import torch

from .models.encodec import EncodecModel, create_encodec_24khz
from .models.stages import (
    Stage,
    create_coarse_transformer,
    create_fine_transformer,
    create_semantic_transformer,
)
from .models.token_cond import TokenConditionedTransformer


@dataclass
class ClapRVQConfig:
    rq_num_quantizers: int
    codebook_size: int
    enable_fusion: bool = False
    rq_ema_decay: float = 0.95
    threshold_ema_dead_code: float = 0.0
    checkpoint_path: Optional[str] = None
    amodel_type: str = "HTSAT-tiny"


@dataclass
class HubertKmeansConfig:
    model_name: str
    normalize_embeds: bool
    embed_layer: int = 7
    target_sample_hz: int = 16000
    seq_len_multiple_of: int = 320
    codebook_size: int = 1024
    output_hz: int = 50


@dataclass
class EncodecConfig:
    bandwidth: float
    codebook_size: int
    output_hz: int = 75


@dataclass
class StageTransformerConfig:
    dim: int = 1024
    depth: int = 6
    heads: int = 8
    attn_dropout: float = 0.0
    ff_dropout: float = 0.1
    use_conv_ff: bool = True
    grad_shrink_alpha: float = 0.1
    non_causal_prefix_size: int = 0
    relative_position_bias_type: str = "continuous"
    use_memory_efficient_attention: bool = False  # accepted for config parity
    use_absolute_position_embeddings: bool = False
    max_absolute_position_embeddings: int = 262


@dataclass
class SemanticConfig(StageTransformerConfig):
    max_absolute_position_embeddings: int = 12 + 250


@dataclass
class CoarseConfig(StageTransformerConfig):
    max_absolute_position_embeddings: int = 12 + 100 + 600


@dataclass
class FineConfig(StageTransformerConfig):
    max_absolute_position_embeddings: int = 12 + 300 + 900


@dataclass
class GlobalConfig:
    semantic_audio_length_seconds: float = 10.0
    coarse_audio_length_seconds: float = 4.0
    fine_audio_length_seconds: float = 2.0
    clap_audio_length_seconds: float = 10.0
    num_coarse_quantizers: int = 3
    num_fine_quantizers: int = 5


@dataclass
class MusicLMModelConfig:
    clap_rvq_cfg: ClapRVQConfig
    hubert_kmeans_cfg: HubertKmeansConfig
    encodec_cfg: EncodecConfig
    semantic_cfg: SemanticConfig
    coarse_cfg: CoarseConfig
    fine_cfg: FineConfig
    global_cfg: GlobalConfig


def load_model_config(path: str) -> MusicLMModelConfig:
    with open(path) as f:
        cfg = json.load(f)
    return MusicLMModelConfig(
        clap_rvq_cfg=ClapRVQConfig(**cfg["clap_rvq_cfg"]),
        hubert_kmeans_cfg=HubertKmeansConfig(**cfg["hubert_kmeans_cfg"]),
        encodec_cfg=EncodecConfig(**cfg["encodec_cfg"]),
        semantic_cfg=SemanticConfig(**cfg["semantic_cfg"]),
        coarse_cfg=CoarseConfig(**cfg["coarse_cfg"]),
        fine_cfg=FineConfig(**cfg["fine_cfg"]),
        global_cfg=GlobalConfig(**cfg["global_cfg"]),
    )


def _stage_kwargs(c: StageTransformerConfig) -> dict:
    """The config fields the port's inference modules take. Dropout is a
    training-time setting; the conv FF, no absolute position embeddings
    and the continuous rel-pos bias are the only ported variants."""
    if not c.use_conv_ff or c.use_absolute_position_embeddings:
        raise NotImplementedError("the port has the conv-FF stages without absolute positions")
    return dict(
        dim=c.dim,
        depth=c.depth,
        heads=c.heads,
        grad_shrink_alpha=c.grad_shrink_alpha,
        non_causal_prefix_size=c.non_causal_prefix_size,
        relative_position_bias_type=c.relative_position_bias_type,
    )


def build_semantic_transformer(mc: MusicLMModelConfig, generator=None) -> TokenConditionedTransformer:
    return create_semantic_transformer(
        clap_codebook_size=mc.clap_rvq_cfg.codebook_size,
        semantic_codebook_size=mc.hubert_kmeans_cfg.codebook_size,
        num_clap_quantizers=mc.clap_rvq_cfg.rq_num_quantizers,
        generator=generator,
        **_stage_kwargs(mc.semantic_cfg),
    )


def build_coarse_transformer(mc: MusicLMModelConfig, generator=None) -> TokenConditionedTransformer:
    return create_coarse_transformer(
        clap_codebook_size=mc.clap_rvq_cfg.codebook_size,
        semantic_codebook_size=mc.hubert_kmeans_cfg.codebook_size,
        acoustic_codebook_size=mc.encodec_cfg.codebook_size,
        num_clap_quantizers=mc.clap_rvq_cfg.rq_num_quantizers,
        num_coarse_quantizers=mc.global_cfg.num_coarse_quantizers,
        generator=generator,
        **_stage_kwargs(mc.coarse_cfg),
    )


def build_fine_transformer(mc: MusicLMModelConfig, generator=None) -> TokenConditionedTransformer:
    return create_fine_transformer(
        clap_codebook_size=mc.clap_rvq_cfg.codebook_size,
        acoustic_codebook_size=mc.encodec_cfg.codebook_size,
        num_clap_quantizers=mc.clap_rvq_cfg.rq_num_quantizers,
        num_coarse_quantizers=mc.global_cfg.num_coarse_quantizers,
        num_fine_quantizers=mc.global_cfg.num_fine_quantizers,
        generator=generator,
        **_stage_kwargs(mc.fine_cfg),
    )


def build_encodec(mc: MusicLMModelConfig, generator=None) -> EncodecModel:
    return create_encodec_24khz(
        bandwidth=mc.encodec_cfg.bandwidth,
        codebook_size=mc.encodec_cfg.codebook_size,
        generator=generator,
    )


def init_stage(
    mc: MusicLMModelConfig,
    stage: str,
    seed: int,
    *,
    device="cpu",
    dtype: torch.dtype = torch.float32,
    quantized: bool = False,
    flash_kv: Optional[str] = None,
) -> Stage:
    """A stage with a seeded random init (drawn in float32 on the CPU, then
    moved to ``device`` and cast to ``dtype``)."""
    factory = {
        "semantic": build_semantic_transformer,
        "coarse": build_coarse_transformer,
        "fine": build_fine_transformer,
    }[stage]
    model = factory(mc, generator=torch.Generator().manual_seed(seed))
    model = model.to(device=device, dtype=dtype).eval()
    return Stage(model, name=stage, quantized=quantized, flash_kv=flash_kv)
