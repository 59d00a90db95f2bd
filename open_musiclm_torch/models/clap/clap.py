"""CLAP text branch and the quantized conditioning tokens (port of the text
side of open_musiclm_tpu/models/clap/clap.py).

``CLAP.get_text_embedding``: RoBERTa pooler -> ``text_projection`` (Linear,
ReLU, Linear) -> L2-normalized 512-d joint embedding. ``ClapQuantized``
quantizes it with the residual VQ into the [B, Q, 1] conditioning tokens
every stage takes. The ``state_dict`` keys follow the laion CLAP checkpoint
(``text_branch.*``, ``text_projection.{0,2}``,
``text_transform.sequential.{0,3}``, ``logit_scale_t``). The audio tower,
``audio_embedding`` and the RVQ's EMA training are not ported yet.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch
from torch import nn

from ..rvq import RVQState, rvq_encode
from .roberta import RobertaConfig, RobertaModel, init_normal_

JOINT_EMBED = 512


def l2_normalize(x: torch.Tensor, dim: int = -1, eps: float = 1e-12) -> torch.Tensor:
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=dim, keepdim=True), min=eps)


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
    """The text side of the dual-tower CLAP (RoBERTa-base by default);
    weights drawn as ``RobertaModel``'s."""

    def __init__(self, text_cfg: RobertaConfig = RobertaConfig(), joint_embed_shape: int = JOINT_EMBED,
                 compute_dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.text_branch = RobertaModel(text_cfg, compute_dtype=compute_dtype, generator=generator)
        self.text_projection = Projection(text_cfg.hidden_size, joint_embed_shape)
        self.text_transform = MLPLayers(joint_embed_shape)
        self.logit_scale_t = nn.Parameter(torch.tensor(math.log(1 / 0.07)))
        init_normal_(self.text_projection, generator)
        init_normal_(self.text_transform, generator)

    def get_text_embedding(self, input_ids: torch.Tensor, attention_mask: torch.Tensor) -> torch.Tensor:
        """Tokenized [B, T] -> L2-normalized [B, joint] in float32."""
        pooled = self.text_branch(input_ids, attention_mask)["pooler_output"]
        return l2_normalize(self.text_projection(pooled.to(self.text_projection[0].weight.dtype)).float())

    def get_audio_embedding(self, wav: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError("the CLAP audio tower is not ported yet")


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

    @torch.no_grad()
    def text_embedding(self, input_ids, attention_mask) -> torch.Tensor:
        """[B, T] ids and mask (numpy or tensors) -> [B, joint] float32 on
        the model's device."""
        device = self.model.logit_scale_t.device
        return self.model.get_text_embedding(_on(input_ids, device), _on(attention_mask, device))

    def audio_embedding(self, wav):
        raise NotImplementedError("the CLAP audio tower is not ported yet")

    @torch.no_grad()
    def quantize(self, embedding: torch.Tensor) -> torch.Tensor:
        """[B, joint] -> [B, Q, 1] int64 token ids."""
        cbs = self.rvq.codebooks
        return rvq_encode(self.rvq, embedding.to(cbs.device, cbs.dtype))[..., None]

    def tokenize_text(self, input_ids, attention_mask) -> torch.Tensor:
        return self.quantize(self.text_embedding(input_ids, attention_mask))

    def tokenize_audio(self, wav):
        raise NotImplementedError("the CLAP audio tower is not ported yet")

    def learn_rvq_step(self, embedding, *args, **kwargs):
        raise NotImplementedError("the RVQ's EMA training is not ported yet")
