"""The CLAP convenience API, laion's ``CLAP_Module`` (port of
open_musiclm_tpu/models/clap/hook.py): one object that tokenizes text,
prepares audio of any length (int16 round trip, repeat-pad or crop; a
fusion CLAP keeps a longer clip whole for its mel stack) and returns
L2-normalized joint-space embeddings, on the device the CLAP's weights are
on, under ``torch.inference_mode()``. Text is tokenized on the host.
"""

from __future__ import annotations

import dataclasses
from typing import Any, List

import numpy as np
import torch

from ...data.audio_io import read_wav
from ...ops.audio import int16_round_trip
from .clap import CLAP, prepare_clap_audio


@dataclasses.dataclass
class ClapModule:
    """A frozen CLAP with laion's hook's entry points."""

    model: CLAP
    tokenizer: Any  # [B] strings -> {"input_ids", "attention_mask"}
    sample_rate: int = 48000
    clip_samples: int = 480000
    enable_fusion: bool = False

    @property
    def device(self) -> torch.device:
        return self.model.logit_scale_t.device

    @torch.inference_mode()
    def get_text_embedding(self, texts: List[str]) -> torch.Tensor:
        """[B] strings -> [B, joint] float32."""
        enc = self.tokenizer(texts)
        ids, mask = (torch.from_numpy(np.asarray(enc[k])).to(self.device, torch.long)
                     for k in ("input_ids", "attention_mask"))
        return self.model.get_text_embedding(ids, mask)

    @torch.inference_mode()
    def get_audio_embedding_from_data(self, wavs) -> torch.Tensor:
        """[B, T] float waves at ``sample_rate`` (numpy or a tensor) -> [B,
        joint] float32: the int16 round trip, then repeat-pad or crop to
        ``clip_samples`` unless a fusion CLAP takes a longer clip whole."""
        wavs = int16_round_trip(torch.as_tensor(wavs, dtype=torch.float32).to(self.device))
        if not (self.enable_fusion and wavs.shape[-1] > self.clip_samples):
            wavs = prepare_clap_audio(wavs, self.clip_samples)
        return self.model.get_audio_embedding(wavs)

    def get_audio_embedding_from_filelist(self, paths: List[str]) -> torch.Tensor:
        """Files decoded and resampled to ``sample_rate`` on the host, each
        zero-padded to the longest (at most ``clip_samples``), then embedded."""
        wavs = [read_wav(p, target_sr=self.sample_rate)[0] for p in paths]
        max_len = min(max(len(w) for w in wavs), self.clip_samples)
        batch = np.zeros((len(wavs), max_len), np.float32)
        for i, w in enumerate(wavs):
            n = min(len(w), max_len)
            batch[i, :n] = w[:n]
        return self.get_audio_embedding_from_data(batch)

    @staticmethod
    def cosine_similarity(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return (a * b).sum(dim=-1) / (torch.linalg.vector_norm(a, dim=-1) * torch.linalg.vector_norm(b, dim=-1)
                                      + 1e-12)
