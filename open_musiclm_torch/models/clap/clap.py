"""CLAP towers and the quantized conditioning tokens (port of
open_musiclm_tpu/models/clap/clap.py).

``CLAP.get_text_embedding``: RoBERTa pooler -> ``text_projection`` (Linear,
ReLU, Linear) -> L2-normalized 512-d joint embedding.
``CLAP.get_audio_embedding``: HTSAT ``embedding`` -> ``audio_projection`` ->
L2-normalized joint embedding. ``ClapQuantized`` quantizes an embedding
with the residual VQ into the [B, Q, 1] conditioning tokens every stage
takes, and prepares audio as the laion hook does (int16 round trip,
repeat-pad or crop to 10 s at 48 kHz). The ``state_dict`` keys follow the
laion CLAP checkpoint (``text_branch.*``, ``audio_branch.*``,
``{text,audio}_projection.{0,2}``, ``{text,audio}_transform.sequential.{0,3}``,
``logit_scale_{t,a}``). A fusion CLAP (``enable_fusion``, musiclm_large)
embeds every clip through the four-view mel stack (``wav_to_mel_fusion``),
a clip-length one with ``longer`` unset; longer clips keep their whole
length. ``learn_rvq_step`` is one step of the RVQ's EMA training. PANN is
not ported yet.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch
from torch import nn

from ...ops.audio import int16_round_trip
from ..rvq import RVQState, rvq_encode, rvq_update
from .fusion import build_mel_fusion
from .htsat import HTSAT, HTSATConfig
from .mel import logmel
from .roberta import RobertaConfig, RobertaModel, init_normal_

JOINT_EMBED = 512


def l2_normalize(x: torch.Tensor, dim: int = -1, eps: float = 1e-12) -> torch.Tensor:
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=dim, keepdim=True), min=eps)


def wav_to_mel_fusion(cfg: HTSATConfig, wav: torch.Tensor):
    """[B, T] wave -> ([B, 4, chunk_frames, mel_bins] view stack, [B] bool
    ``longer``): ``longer`` follows from the input's length (T > clip_samples)."""
    mel = logmel(wav.float(), sr=cfg.sample_rate, n_fft=cfg.window_size_fft, hop=cfg.hop_size,
                 n_mels=cfg.mel_bins, fmin=cfg.fmin, fmax=cfg.fmax)
    chunk_frames = cfg.clip_samples // cfg.hop_size + 1
    stacks = torch.stack([build_mel_fusion(m, chunk_frames) for m in mel])
    longer = torch.full((wav.shape[0],), wav.shape[-1] > cfg.clip_samples, device=wav.device)
    return stacks, longer


class Projection(nn.Sequential):
    """Linear -> ReLU -> Linear into the joint space (``fc1``, ``fc2`` of the
    JAX package; entries 0 and 2 of the laion checkpoint)."""

    def __init__(self, in_dim: int, out_dim: int = JOINT_EMBED):
        super().__init__(nn.Linear(in_dim, out_dim), nn.ReLU(), nn.Linear(out_dim, out_dim))


class MLPLayers(nn.Module):
    """The units=[512, 512, 512] head of the contrastive-training surface:
    Linear, ReLU, Linear (entries 0 and 3 of the laion checkpoint, whose
    entries 2 and 5 are dropout)."""

    def __init__(self, dim: int = JOINT_EMBED):
        super().__init__()
        self.sequential = nn.Sequential(nn.Linear(dim, dim), nn.ReLU(), nn.Identity(), nn.Linear(dim, dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.sequential(x)


class CLAP(nn.Module):
    """The dual-tower CLAP: RoBERTa-base, and HTSAT when ``audio_cfg`` is
    given (without it the CLAP has the text side only). The text side's
    weights are drawn first, as ``RobertaModel``'s, then the audio side's."""

    def __init__(self, text_cfg: RobertaConfig = RobertaConfig(), joint_embed_shape: int = JOINT_EMBED,
                 compute_dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None,
                 audio_cfg: Optional[HTSATConfig] = None):
        super().__init__()
        self.text_branch = RobertaModel(text_cfg, compute_dtype=compute_dtype, generator=generator)
        self.text_projection = Projection(text_cfg.hidden_size, joint_embed_shape)
        self.text_transform = MLPLayers(joint_embed_shape)
        self.logit_scale_t = nn.Parameter(torch.tensor(math.log(1 / 0.07)))
        init_normal_(self.text_projection, generator)
        init_normal_(self.text_transform, generator)
        self.audio_branch = None
        if audio_cfg is not None:
            self.audio_branch = HTSAT(audio_cfg, generator=generator, compute_dtype=compute_dtype)
            self.audio_projection = Projection(audio_cfg.num_features, joint_embed_shape)
            self.audio_transform = MLPLayers(joint_embed_shape)
            self.logit_scale_a = nn.Parameter(torch.tensor(math.log(1 / 0.07)))
            init_normal_(self.audio_projection, generator)
            init_normal_(self.audio_transform, generator)

    def get_text_embedding(self, input_ids: torch.Tensor, attention_mask: torch.Tensor) -> torch.Tensor:
        """Tokenized [B, T] -> L2-normalized [B, joint] in float32."""
        pooled = self.text_branch(input_ids, attention_mask)["pooler_output"]
        return l2_normalize(self.text_projection(pooled.to(self.text_projection[0].weight.dtype)).float())

    def get_audio_embedding(self, wav: torch.Tensor, *, train: bool = False,
                            generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """[B, T] at the tower's rate -> L2-normalized [B, joint] float32; a
        fusion CLAP always takes the four-view mel stack. ``train`` runs
        HTSAT's training forward (batch statistics; SpecAugment from
        ``generator`` without fusion)."""
        if self.audio_branch is None:
            raise ValueError("this CLAP was built without an audio tower (audio_cfg=None)")
        wav = wav.to(self.audio_projection[0].weight.device)
        if self.audio_branch.cfg.enable_fusion:
            return self.get_audio_embedding_fusion(*wav_to_mel_fusion(self.audio_branch.cfg, wav), train=train)
        return self._project_audio(self.audio_branch(wav.float(), train=train, generator=generator))

    def get_audio_embedding_fusion(self, mel_fusion: torch.Tensor, longer: torch.Tensor, *,
                                   train: bool = False) -> torch.Tensor:
        """mel_fusion [B, 4, frames, mel_bins], longer [B] bool -> [B, joint]."""
        return self._project_audio(self.audio_branch(mel_fusion=mel_fusion, longer=longer, train=train))

    def _project_audio(self, out: dict) -> torch.Tensor:
        w = self.audio_projection[0].weight
        return l2_normalize(self.audio_projection(out["embedding"].to(w.dtype)).float())


def prepare_clap_audio(wav: torch.Tensor, clip_samples: int = 480000) -> torch.Tensor:
    """Each [B, T] row cropped to its first ``clip_samples``, or repeated
    whole and zero-padded up to them (the hook's ``repeatpad``)."""
    T = wav.shape[-1]
    if T > clip_samples:
        return wav[..., :clip_samples]
    if T < clip_samples:
        wav = wav.repeat(1, clip_samples // T)
        wav = torch.nn.functional.pad(wav, (0, clip_samples - wav.shape[-1]))
    return wav


def _on(x, device: torch.device) -> torch.Tensor:
    """numpy or tensor ids -> int64 tensor on ``device``."""
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.asarray(x))
    return x.to(device=device, dtype=torch.long)


@dataclasses.dataclass
class ClapQuantized:
    """Frozen CLAP text branch + residual VQ over the joint embedding;
    ``tokenize_text`` gives the [B, Q, 1] conditioning tokens."""

    model: CLAP
    rvq: RVQState
    num_quantizers: int = 12
    codebook_size: int = 1024
    sample_rate: int = 48000
    clip_samples: int = 480000

    @torch.no_grad()
    def text_embedding(self, input_ids, attention_mask) -> torch.Tensor:
        """[B, T] ids and mask (numpy or tensors) -> [B, joint] float32 on
        the model's device; on the card a row at a time, so that a prompt's
        embedding (and its tokens) does not depend on the batch it comes in
        (cuBLAS picks its products' algorithms by their row count)."""
        device = self.model.logit_scale_t.device
        ids, mask = _on(input_ids, device), _on(attention_mask, device)
        if device.type == "cuda":
            return torch.cat([self.model.get_text_embedding(ids[i:i + 1], mask[i:i + 1])
                              for i in range(ids.shape[0])])
        return self.model.get_text_embedding(ids, mask)

    @torch.no_grad()
    def audio_embedding(self, wav: torch.Tensor) -> torch.Tensor:
        """[B, T] at ``sample_rate`` -> [B, joint] float32 on the model's
        device: int16 round trip, repeat-pad or crop to ``clip_samples``
        (a fusion CLAP keeps a longer clip whole)."""
        wav = int16_round_trip(wav)
        tower = self.model.audio_branch
        if not (tower is not None and tower.cfg.enable_fusion and wav.shape[-1] > self.clip_samples):
            wav = prepare_clap_audio(wav, self.clip_samples)
        return self.model.get_audio_embedding(wav)

    @torch.no_grad()
    def quantize(self, embedding: torch.Tensor) -> torch.Tensor:
        """[B, joint] -> [B, Q, 1] int64 token ids (on the card a row at a
        time, as ``text_embedding``)."""
        cbs = self.rvq.codebooks
        x = embedding.to(cbs.device, cbs.dtype)
        if x.is_cuda:
            return torch.cat([rvq_encode(self.rvq, x[i:i + 1]) for i in range(x.shape[0])])[..., None]
        return rvq_encode(self.rvq, x)[..., None]

    def tokenize_text(self, input_ids, attention_mask) -> torch.Tensor:
        return self.quantize(self.text_embedding(input_ids, attention_mask))

    def tokenize_audio(self, wav: torch.Tensor) -> torch.Tensor:
        return self.quantize(self.audio_embedding(wav))

    def learn_rvq_step(self, embedding: torch.Tensor, generator: Optional[torch.Generator] = None, *,
                       decay: float = 0.95, threshold_ema_dead_code: float = 0.0):
        """One EMA RVQ update on a batch of embeddings [n, joint]. Returns
        (a copy of self with the new RVQ, the mean squared quantization
        error as a 0-d tensor)."""
        embedding = embedding.to(self.rvq.codebooks.device, self.rvq.codebooks.dtype)
        new_state, quant, _ = rvq_update(self.rvq, embedding, generator, decay=decay,
                                         threshold_ema_dead_code=threshold_ema_dead_code)
        return dataclasses.replace(self, rvq=new_state), (quant - embedding).square().mean()
