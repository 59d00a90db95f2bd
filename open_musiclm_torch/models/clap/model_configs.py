"""CLAP audio presets by name (port of the HTSAT part of
open_musiclm_tpu/models/clap/model_configs.py).

``audio_config_from_name`` resolves ``clap_rvq_cfg.amodel_type`` to an
``HTSATConfig``. Only HTSAT-tiny, the tower every shipped model config
names, is ported; the other presets of the reference are named and raise
``NotImplementedError``.
"""

from __future__ import annotations

from .htsat import HTSATConfig

_UNPORTED = ("HTSAT-base", "HTSAT-large", "HTSAT-tiny-win-1536",
             "PANN-14", "PANN-14-fmax-18k", "PANN-14-fmax-8k-20s", "PANN-14-win-1536",
             "PANN-14-tiny-transformer", "PANN-10", "PANN-6")


def audio_config_from_name(name: str, *, enable_fusion: bool = False) -> HTSATConfig:
    if name in _UNPORTED:
        raise NotImplementedError(f"the CLAP audio tower {name} is not ported yet")
    if name != "HTSAT-tiny":
        raise KeyError(f"unknown CLAP audio preset {name!r}; known: {['HTSAT-tiny', *_UNPORTED]}")
    return HTSATConfig(enable_fusion=enable_fusion)
