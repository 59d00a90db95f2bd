"""CLAP presets by name (port of open_musiclm_tpu/models/clap/model_configs.py).

Every audio-tower preset of the laion CLAP model configs resolves by name:
``audio_config_from_name`` gives the tower's geometry (an ``HTSATConfig``
for HTSAT-tiny / base / large / tiny-win-1536, a ``PANNConfig`` for the
PANN-* presets), ``clap_config_from_name`` the whole declaration (audio
tower, the CLIP text tower and the joint width). HTSAT sizes follow the
Swin geometry of tiny / base / large; the mel front end follows each
preset's JSON.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple, Union

from .clip_text import ClipTextConfig
from .htsat import HTSATConfig


@dataclasses.dataclass(frozen=True)
class PANNConfig:
    """Geometry of the PANN CNN towers (model_configs/PANN-*.json)."""

    arch: str = "Cnn14"
    num_classes: int = 527
    sample_rate: int = 48000
    window_size_fft: int = 1024
    hop_size: int = 480
    mel_bins: int = 64
    fmin: float = 50.0
    fmax: float = 14000.0
    clip_samples: int = 480000
    enable_fusion: bool = False  # no shipped config fuses a PANN tower
    fusion_type: str = "None"


# Swin geometry of each HTSAT size
_HTSAT_SIZES = {
    "tiny": dict(embed_dim=96, depths=(2, 2, 6, 2)),
    "base": dict(embed_dim=128, depths=(2, 2, 12, 2)),
    "large": dict(embed_dim=256, depths=(2, 2, 12, 2)),
}

# name -> (kind, size or arch, mel front-end overrides), one per model config JSON
_AUDIO_PRESETS = {
    "HTSAT-tiny": ("htsat", "tiny", {}),
    "HTSAT-base": ("htsat", "base", {}),
    "HTSAT-large": ("htsat", "large", {}),
    "HTSAT-tiny-win-1536": ("htsat", "tiny", {"window_size_fft": 1536}),
    "PANN-14": ("pann", "Cnn14", {}),
    "PANN-14-fmax-18k": ("pann", "Cnn14", {"fmax": 18000.0}),
    "PANN-14-fmax-8k-20s": ("pann", "Cnn14", {"fmax": 8000.0, "hop_size": 360, "clip_samples": 960000}),
    "PANN-14-win-1536": ("pann", "Cnn14", {"window_size_fft": 1536}),
    "PANN-14-tiny-transformer": ("pann", "Cnn14", {}),
    "PANN-10": ("pann", "Cnn10", {}),
    "PANN-6": ("pann", "Cnn6", {}),
}

# name -> (joint width, CLIP text tower overrides) each JSON declares; only
# PANN-14-tiny-transformer shrinks the 12-layer text tower, to 4 layers.
# The shipped MusicLM configs take RoBERTa and a 512-wide joint space instead.
_CLAP_PRESETS = {
    "HTSAT-tiny": (768, {}),
    "HTSAT-base": (1024, {}),
    "HTSAT-large": (2048, {}),
    "HTSAT-tiny-win-1536": (768, {}),
    "PANN-14": (2048, {}),
    "PANN-14-fmax-18k": (2048, {}),
    "PANN-14-fmax-8k-20s": (2048, {}),
    "PANN-14-win-1536": (2048, {}),
    "PANN-14-tiny-transformer": (2048, {"layers": 4}),
    "PANN-10": (1024, {}),
    "PANN-6": (512, {}),
}


def list_audio_presets() -> Tuple[str, ...]:
    return tuple(_AUDIO_PRESETS)


def audio_config_from_name(name: str, *, enable_fusion: bool = False,
                           fusion_type: str = "aff_2d") -> Union[HTSATConfig, PANNConfig]:
    """A preset name (``clap_rvq_cfg.amodel_type``) -> its HTSATConfig or PANNConfig."""
    if name not in _AUDIO_PRESETS:
        raise KeyError(f"unknown CLAP audio preset {name!r}; known: {sorted(_AUDIO_PRESETS)}")
    kind, size, overrides = _AUDIO_PRESETS[name]
    if kind == "htsat":
        return HTSATConfig(**_HTSAT_SIZES[size], num_heads=(4, 8, 16, 32), window_size=8, spec_size=256,
                           patch_size=4, patch_stride=(4, 4), enable_fusion=enable_fusion,
                           fusion_type=fusion_type, **overrides)
    return PANNConfig(arch=size, **overrides)


@dataclasses.dataclass(frozen=True)
class ClapPresetConfig:
    """A preset's whole declaration: the audio tower, the CLIP text tower and
    the joint width."""

    name: str
    audio_cfg: Union[HTSATConfig, PANNConfig]
    text_cfg: ClipTextConfig
    embed_dim: int


def clap_config_from_name(name: str, *, enable_fusion: bool = False,
                          fusion_type: str = "aff_2d") -> ClapPresetConfig:
    audio = audio_config_from_name(name, enable_fusion=enable_fusion, fusion_type=fusion_type)
    embed_dim, text_overrides = _CLAP_PRESETS[name]
    text = ClipTextConfig(context_length=77, vocab_size=49408, width=512, heads=8, **text_overrides)
    return ClapPresetConfig(name=name, audio_cfg=audio, text_cfg=text, embed_dim=embed_dim)
