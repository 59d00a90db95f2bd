"""Attention masks for training (port of open_musiclm_tpu/core/masks.py).

Boolean masks, True = attend. The forgetful causal mask draws from an
explicit ``torch.Generator``; its draws differ from the JAX package's
(another generator), its structure does not.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch


def causal_mask(n: int, non_causal_prefix: int = 0, device=None) -> torch.Tensor:
    """[n, n] mask, optionally with a bidirectional prefix."""
    i = torch.arange(n, device=device)[:, None]
    j = torch.arange(n, device=device)[None, :]
    mask = j <= i
    if non_causal_prefix > 0:
        mask = mask | ((i < non_causal_prefix) & (j < non_causal_prefix))
    return mask


def forgetful_causal_mask(
    batch: int, seq: int, mask_prob: float, generator: Optional[torch.Generator] = None,
    device=None,
) -> torch.Tensor:
    """[batch, seq] keep-mask with ``min(int(seq * p), seq - 1)`` random
    dropped key positions per row, never position 0."""
    num_mask = min(int(seq * mask_prob), seq - 1)
    if num_mask <= 0:
        return torch.ones((batch, seq), dtype=torch.bool, device=device)
    rand = torch.randn((batch, seq), generator=generator, device=device)
    rand[:, 0] = -torch.inf
    drop_idx = rand.topk(num_mask, dim=-1).indices
    keep = torch.ones((batch, seq), dtype=torch.bool, device=device)
    return keep.scatter_(1, drop_idx, False)


def conditioning_attn_mask(
    token_ids_list: Sequence[torch.Tensor], eos_ids: Sequence[int], pad_id: int,
    pred_len_with_start: int,
) -> torch.Tensor:
    """[batch, total] key mask: conditioning pad/EOS tokens hidden; each start
    token and the predicted sequence (``pred_len_with_start`` wide) visible."""
    parts = []
    b = token_ids_list[0].shape[0]
    device = token_ids_list[0].device
    for ids, eos_id in zip(token_ids_list, eos_ids):
        keep = (ids != pad_id) & (ids != eos_id)
        parts.append(torch.cat([torch.ones((b, 1), dtype=torch.bool, device=device), keep], dim=-1))
    parts.append(torch.ones((b, pred_len_with_start), dtype=torch.bool, device=device))
    return torch.cat(parts, dim=-1)
