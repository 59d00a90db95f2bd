"""Model config loader and factories (port of open_musiclm_tpu/config.py).

The same dataclasses over the unchanged ``configs/model/*.json`` and
``configs/training/*.json``; the factories build the port's modules with a
seeded random init from a ``torch.Generator``, on the card unless the caller
asks for the CPU (``device="cpu"``): the stages, the Encodec codec (encoder
and decoder), the CLAP (RoBERTa-base and HTSAT or PANN) with its RVQ, and HuBERT
(MERT-v0 geometry) with its k-means codebook.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from typing import List, Optional

import torch

from .models.clap.clap import CLAP, JOINT_EMBED, ClapQuantized
from .models.clap.model_configs import audio_config_from_name
from .models.clap.roberta import RobertaConfig
from .models.encodec import EncodecModel, create_encodec_24khz
from .models.hubert import HubertConfig, HubertModel, HubertWithKmeans
from .models.rvq import rvq_init, rvq_to
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


@dataclass
class ClapRVQTrainerConfig:
    folder: str
    num_train_steps: int
    batch_size: int
    accumulate_batches: int
    save_model_every: int
    save_results_every: int


@dataclass
class HubertKmeansTrainerConfig:
    folder: str
    feature_extraction_num_steps: int
    feature_extraction_batch_size: int


@dataclass
class SingleStageTrainerConfig:
    stage: str
    folder: str
    valid_frac: float
    lr: float
    lr_warmup: int
    batch_size: int
    grad_accum_every: int
    wd: float
    max_grad_norm: float
    cross_entropy_loss_weights: List[float]
    num_train_steps: int
    save_results_every: int
    save_model_every: int
    save_predicted_tokens: bool
    save_reconstructed_wave: bool
    use_preprocessed_data: bool


@dataclass
class DataPreprocessorConfig:
    folder: str = "./data/fma_large"
    metadata_folder: str = "./data/fma_metadata"
    results_folder: str = "./fma_preprocessed"
    max_audio_length_seconds: int = 30
    random_crop: bool = True
    num_crops: int = 1
    clap_batch_size: int = 32


@dataclass
class MusicLMTrainingConfig:
    clap_rvq_trainer_cfg: ClapRVQTrainerConfig
    hubert_kmeans_trainer_cfg: HubertKmeansTrainerConfig
    semantic_trainer_cfg: SingleStageTrainerConfig
    coarse_trainer_cfg: SingleStageTrainerConfig
    fine_trainer_cfg: SingleStageTrainerConfig
    data_preprocessor_cfg: DataPreprocessorConfig


def load_training_config(path: str) -> MusicLMTrainingConfig:
    with open(path) as f:
        cfg = json.load(f)
    return MusicLMTrainingConfig(
        clap_rvq_trainer_cfg=ClapRVQTrainerConfig(**cfg["clap_rvq_trainer_cfg"]),
        hubert_kmeans_trainer_cfg=HubertKmeansTrainerConfig(**cfg["hubert_kmeans_trainer_cfg"]),
        semantic_trainer_cfg=SingleStageTrainerConfig(**cfg["semantic_trainer_cfg"]),
        coarse_trainer_cfg=SingleStageTrainerConfig(**cfg["coarse_trainer_cfg"]),
        fine_trainer_cfg=SingleStageTrainerConfig(**cfg["fine_trainer_cfg"]),
        data_preprocessor_cfg=DataPreprocessorConfig(**cfg["data_preprocessor_cfg"]),
    )


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
    """The config fields the port's modules take (all but
    ``use_memory_efficient_attention``, which the JAX package accepts and
    ignores)."""
    return dict(
        dim=c.dim,
        depth=c.depth,
        heads=c.heads,
        attn_dropout=c.attn_dropout,
        ff_dropout=c.ff_dropout,
        use_conv_ff=c.use_conv_ff,
        grad_shrink_alpha=c.grad_shrink_alpha,
        non_causal_prefix_size=c.non_causal_prefix_size,
        relative_position_bias_type=c.relative_position_bias_type,
        use_absolute_position_embeddings=c.use_absolute_position_embeddings,
        max_absolute_position_embeddings=c.max_absolute_position_embeddings,
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


def target_device(device, caller: str) -> torch.device:
    """The device an entry point builds on; asking for the card without one
    is an error, never a quiet move to the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"{caller}: no CUDA card is available; the port runs on the card "
            "unless the caller asks for the CPU (device='cpu')"
        )
    return device


def build_encodec(mc: MusicLMModelConfig, generator=None, *, device="cuda",
                  dtype: torch.dtype = torch.float32) -> EncodecModel:
    """The Encodec codec with a seeded random init (the decoder, the
    codebooks, then the encoder), drawn in float32 on the CPU, then moved to
    ``device``. ``dtype`` is the compute dtype (the parameters stay float32),
    as the JAX package's flax ``dtype``; likewise for the other towers."""
    device = target_device(device, "build_encodec")
    return create_encodec_24khz(
        bandwidth=mc.encodec_cfg.bandwidth,
        codebook_size=mc.encodec_cfg.codebook_size,
        generator=generator,
        compute_dtype=dtype,
    ).to(device)


def build_clap(mc: MusicLMModelConfig, generator=None, *, device="cuda",
               dtype: torch.dtype = torch.float32) -> ClapQuantized:
    """The CLAP (RoBERTa-base and the text projection, then the audio tower
    of ``clap_rvq_cfg.amodel_type`` / ``enable_fusion`` and the audio
    projection) and a ``clap_rvq_cfg.rq_num_quantizers`` x ``codebook_size``
    x 512 RVQ, with a seeded random init drawn in float32 on the CPU (the
    CLAP, then the codebooks), then moved to ``device``, in eval() mode."""
    device = target_device(device, "build_clap")
    cfg = mc.clap_rvq_cfg
    audio_cfg = audio_config_from_name(cfg.amodel_type, enable_fusion=cfg.enable_fusion)
    model = CLAP(RobertaConfig(), generator=generator, audio_cfg=audio_cfg, compute_dtype=dtype)
    rvq = rvq_init(cfg.rq_num_quantizers, cfg.codebook_size, JOINT_EMBED, generator)
    return ClapQuantized(model=model.to(device).eval(), rvq=rvq_to(rvq, device),
                         num_quantizers=cfg.rq_num_quantizers, codebook_size=cfg.codebook_size,
                         sample_rate=audio_cfg.sample_rate, clip_samples=audio_cfg.clip_samples)


def build_hubert(mc: MusicLMModelConfig, generator=None, *, device="cuda",
                 dtype: torch.dtype = torch.float32) -> HubertWithKmeans:
    """HuBERT at the MERT-v0 geometry and a ``hubert_kmeans_cfg.codebook_size``
    x 768 k-means codebook (N(0, 1)), with a seeded random init drawn in
    float32 on the CPU (the model, then the codebook), then moved to
    ``device``, in eval() mode."""
    device = target_device(device, "build_hubert")
    hk = mc.hubert_kmeans_cfg
    cfg = HubertConfig()
    model = HubertModel(cfg, generator=generator, compute_dtype=dtype)
    centroids = torch.randn(hk.codebook_size, cfg.hidden_size, generator=generator)
    return HubertWithKmeans(
        model, centroids, embed_layer=hk.embed_layer, normalize_embeds=hk.normalize_embeds,
        target_sample_hz=hk.target_sample_hz, seq_len_multiple_of=hk.seq_len_multiple_of,
        output_hz=hk.output_hz,
    ).to(device).eval()


def init_stage(
    mc: MusicLMModelConfig,
    stage: str,
    seed: int,
    *,
    device="cuda",
    dtype: torch.dtype = torch.float32,
    compute_dtype: Optional[torch.dtype] = None,
    quantized: bool = False,
    flash_kv: Optional[str] = None,
) -> Stage:
    """A stage with a seeded random init (drawn in float32 on the CPU, then
    moved to ``device`` and cast to ``dtype``), in eval() mode.
    ``compute_dtype`` runs the stream in another dtype than the parameters
    (bfloat16 training on float32 master weights). ``flash_kv`` None leaves
    the Stage's default, ``$OPEN_MUSICLM_FLASH_KV``."""
    device = target_device(device, "init_stage")
    factory = {
        "semantic": build_semantic_transformer,
        "coarse": build_coarse_transformer,
        "fine": build_fine_transformer,
    }[stage]
    model = factory(mc, generator=torch.Generator().manual_seed(seed))
    model = model.to(device=device, dtype=dtype).eval()
    model.compute_dtype = compute_dtype
    mode = {} if flash_kv is None else {"flash_kv": flash_kv}
    return Stage(model, name=stage, quantized=quantized, **mode)


def stage_example_lengths(mc: MusicLMModelConfig, stage: str) -> tuple:
    """Flattened per-sequence token counts of a training example (before
    the appended EOS), as the JAX package's ``stage_example_lengths``."""
    g = mc.global_cfg
    sem_hz, ac_hz = mc.hubert_kmeans_cfg.output_hz, mc.encodec_cfg.output_hz
    n_clap = mc.clap_rvq_cfg.rq_num_quantizers
    if stage == "semantic":
        return (n_clap, int(g.semantic_audio_length_seconds * sem_hz) - 1)
    if stage == "coarse":
        sem = int(g.coarse_audio_length_seconds * sem_hz) - 1
        return (n_clap, sem, int(g.coarse_audio_length_seconds * ac_hz) * g.num_coarse_quantizers)
    if stage == "fine":
        coarse = int(g.fine_audio_length_seconds * ac_hz) * g.num_coarse_quantizers
        return (n_clap, coarse, int(g.fine_audio_length_seconds * ac_hz) * g.num_fine_quantizers)
    raise ValueError(stage)
