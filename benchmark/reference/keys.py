"""Per-row sampling draws of a served request, worked out from its seed.

A frozen copy of the arithmetic of ``open_musiclm_torch/core/sampling.py``
(``mix32``, ``seed_keys``, ``fold_in_rows``, ``split_row_keys``,
``row_uniforms``, the Gumbel noise) and of how ``MusicLM.generate`` folds
(stage, window) into a row's key: integer hashes on int64 tensors, every
intermediate below 2**63, so the same bits on any device.
"""

from __future__ import annotations

from typing import Iterable

import torch

MASK32 = 0xFFFFFFFF
_MUL1, _MUL2 = 0x21F0AAAD, 0x735A2D97
_SEED_LO, _SEED_HI, _FOLD, _SPLIT_SUB, _SPLIT_CARRY = (
    0x6A09E667, 0xBB67AE85, 0x3C6EF372, 0xA54FF53A, 0x510E527F)
_COLUMN = 0x9E3779B1
UNIFORM_BITS = 23


def mix32(x):
    x = x ^ (x >> 16)
    x = (x * _MUL1) & MASK32
    x = x ^ (x >> 15)
    x = (x * _MUL2) & MASK32
    return x ^ (x >> 15)


def seed_keys(seeds: Iterable[int], device=None) -> torch.Tensor:
    keys = []
    for s in seeds:
        s = int(s) & (2 ** 64 - 1)
        keys.append(mix32(mix32((s & MASK32) ^ _SEED_LO) ^ (s >> 32) ^ _SEED_HI))
    return torch.tensor(keys, dtype=torch.int64, device=device)


def fold(keys: torch.Tensor, *data: int) -> torch.Tensor:
    for d in data:
        keys = mix32(keys ^ mix32(int(d) ^ _FOLD))
    return keys


def step_subkeys(keys: torch.Tensor, n_steps: int) -> torch.Tensor:
    """[b] keys -> [b, n_steps] the subkey each decode step draws from."""
    subs = []
    for _ in range(n_steps):
        both = mix32(torch.stack((keys ^ _SPLIT_SUB, keys ^ _SPLIT_CARRY), dim=1))
        subs.append(both[:, 0])
        keys = both[:, 1]
    return torch.stack(subs, dim=1)


def gumbel(subkeys: torch.Tensor, n: int) -> torch.Tensor:
    """[...] subkeys -> [..., n] float32 Gumbel noise -log(-log(u))."""
    cols = (torch.arange(n, dtype=torch.int64, device=subkeys.device) * _COLUMN) & MASK32
    m = mix32(subkeys[..., None] ^ cols) >> (32 - UNIFORM_BITS)
    u = (m.to(torch.float32) + 0.5) * 2.0 ** -UNIFORM_BITS
    return -torch.log(-torch.log(u + 1e-20) + 1e-20)
