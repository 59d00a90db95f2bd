"""Sampling primitives (port of open_musiclm_tpu/core/sampling.py).

Randomness is an explicit ``torch.Generator`` or explicit uniforms: the
tests hand both packages the same uniform draws, since a torch generator
and a ``jax.random`` key give different numbers from the same seed.
"""

from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e9


def log(t: torch.Tensor, eps: float = 1e-20) -> torch.Tensor:
    return torch.log(t + eps)


def gumbel_sample(
    logits: torch.Tensor,
    temperature: float = 1.0,
    *,
    generator: Optional[torch.Generator] = None,
    uniforms: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """argmax(logits / T + gumbel) over the last axis; T == 0 is greedy.

    The noise is ``-log(-log(u))`` with the reference's eps of 1e-20 inside
    each log, drawn in the logits' dtype (``uniforms`` overrides the draw).
    """
    if temperature == 0.0:
        return torch.argmax(logits, dim=-1)
    if uniforms is None:
        uniforms = torch.rand(
            logits.shape, generator=generator, dtype=logits.dtype, device=logits.device
        )
    noise = -log(-log(uniforms.to(logits.dtype)))
    return torch.argmax(logits / temperature + noise, dim=-1)


def top_k_filter(logits: torch.Tensor, thres: float = 0.9) -> torch.Tensor:
    """Keep the top ``max(int((1-thres)*C), 1)`` logits (ties at the k-th
    value are kept), set the rest to NEG_INF."""
    k = max(int((1.0 - thres) * logits.shape[-1]), 1)
    kth = torch.topk(logits, k, dim=-1).values[..., -1:]
    return torch.where(logits < kth, torch.full_like(logits, NEG_INF), logits)


def sample_top_k_gumbel(
    logits: torch.Tensor,
    temperature: float = 1.0,
    filter_thres: float = 0.9,
    *,
    generator: Optional[torch.Generator] = None,
    uniforms: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    return gumbel_sample(
        top_k_filter(logits, filter_thres), temperature,
        generator=generator, uniforms=uniforms,
    )


def mask_out_after_eos_id(
    ids: torch.Tensor, eos_id: int, mask_value: int = -1, keep_eos: bool = True
) -> torch.Tensor:
    """Replace everything after (optionally including) the first EOS."""
    eos_mask = (ids == eos_id).to(torch.int32)
    if keep_eos:
        eos_mask = torch.nn.functional.pad(eos_mask, (1, 0))[..., :-1]
    after = torch.cumsum(eos_mask, dim=-1) > 0
    return torch.where(after, torch.full_like(ids, mask_value), ids)


def append_eos_id(ids: torch.Tensor, eos_id: int) -> torch.Tensor:
    eos = torch.full(ids.shape[:-1] + (1,), eos_id, dtype=ids.dtype, device=ids.device)
    return torch.cat([ids, eos], dim=-1)
