"""Structural protocols of the pluggable tokenizers (port of
open_musiclm_tpu/model_types.py): a semantic tokenizer (``Wav2Vec``: wave ->
token ids, as ``models.hubert.HubertWithKmeans``) and an acoustic codec
(``NeuralCodec``: wave <-> multi-quantizer codes, as
``models.encodec.EncodecModel``), so that another tokenizer or codec plugs
into the stages without inheritance.
"""

from __future__ import annotations

from typing import Protocol, runtime_checkable

import torch


@runtime_checkable
class Wav2Vec(Protocol):
    """Semantic tokenizer: waveform -> discrete token ids."""

    target_sample_hz: int
    seq_len_multiple_of: int
    codebook_size: int
    output_hz: int

    def __call__(self, wav: torch.Tensor) -> torch.Tensor:
        """[B, T] audio at target_sample_hz -> [B, T'] token ids."""
        ...


@runtime_checkable
class NeuralCodec(Protocol):
    """Acoustic codec: waveform <-> multi-quantizer codes."""

    sample_rate: int
    num_quantizers: int
    codebook_size: int

    def encode(self, wav: torch.Tensor) -> torch.Tensor:
        """[B, T] -> [B, T', n_q] codes."""
        ...

    def decode(self, codes: torch.Tensor) -> torch.Tensor:
        """[B, T', n_q] -> [B, T]."""
        ...
