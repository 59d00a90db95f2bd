"""Residual vector quantization, inference side (port of the nearest-code
encode, decode and quantize of open_musiclm_tpu/models/rvq.py).

The CLAP conditioning tokens come from Q residual nearest-code lookups over
codebooks [Q, K, D], one [n, D] x [D, K] product each. The EMA codebook
training (``rvq_update`` and its k-means init) is not ported yet.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch


class RVQState(NamedTuple):
    codebooks: torch.Tensor  # [Q, K, D]


def rvq_init(num_quantizers: int, codebook_size: int, dim: int,
             generator: Optional[torch.Generator] = None) -> RVQState:
    """Standard-normal codebooks drawn from ``generator`` (on its device)."""
    device = generator.device if generator is not None else None
    return RVQState(torch.randn(num_quantizers, codebook_size, dim, generator=generator, device=device))


def _nearest(x: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    """x [n, D], codebook [K, D] -> indices [n]: argmin |x - c|^2 as argmax
    (2 x.c - |c|^2), the first index winning ties."""
    score = 2.0 * (x @ codebook.t()) - (codebook * codebook).sum(-1)[None, :]
    return torch.argmax(score, dim=-1)


def rvq_encode(state: RVQState, x: torch.Tensor) -> torch.Tensor:
    """x [n, D] -> indices [n, Q]."""
    resid, idxs = x, []
    for cb in state.codebooks:
        idx = _nearest(resid, cb)
        resid = resid - cb[idx]
        idxs.append(idx)
    return torch.stack(idxs, dim=-1)


def rvq_decode(state: RVQState, indices: torch.Tensor) -> torch.Tensor:
    """indices [n, Q] -> reconstruction [n, D]."""
    cbs = state.codebooks
    out = torch.zeros(indices.shape[:-1] + cbs.shape[-1:], dtype=cbs.dtype, device=cbs.device)
    for q in range(cbs.shape[0]):
        out = out + cbs[q][indices[..., q]]
    return out


def rvq_quantize(state: RVQState, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(quantized [n, D], indices [n, Q])."""
    idx = rvq_encode(state, x)
    return rvq_decode(state, idx), idx
