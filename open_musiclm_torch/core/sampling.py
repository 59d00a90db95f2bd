"""Sampling primitives (port of open_musiclm_tpu/core/sampling.py).

Randomness is an explicit ``torch.Generator``, explicit uniforms, or
per-row keys: the tests hand both packages the same uniform draws, since a
torch generator and a ``jax.random`` key give different numbers from the
same seed.

Per-row keys (``sample_top_k_gumbel_per_row``, ``split_row_keys``,
``fold_in_rows``) make row i's draws a function of its own key only, as the
JAX package's threefry keys do for serving. Threefry is not reproduced: a
row key is an int64 tensor [b] of 32-bit values, and keys, folds, splits
and uniforms are stateless integer hashes (``mix32``), every intermediate
kept in [0, 2**63) so that no product overflows and no shift sees a sign.
The same arithmetic on the card and on the CPU gives the same bits.
"""

from __future__ import annotations

from typing import Iterable, Optional, Tuple

import torch

NEG_INF = -1e9

MASK32 = 0xFFFFFFFF
# mix32's multipliers are odd and below 2**31, so a 32-bit value times one
# stays below 2**63 in int64
_MUL1, _MUL2 = 0x21F0AAAD, 0x735A2D97
# salts that keep seeds, folds, splits and column counters apart
_SEED_LO, _SEED_HI, _FOLD, _SPLIT_SUB, _SPLIT_CARRY = (
    0x6A09E667, 0xBB67AE85, 0x3C6EF372, 0xA54FF53A, 0x510E527F)
_COLUMN = 0x9E3779B1  # odd: column j's counter is j * _COLUMN mod 2**32
UNIFORM_BITS = 23  # a float32 uniform's bits: (m + 0.5) * 2**-23 is exact


def mix32(x):
    """A 32-bit integer hash (xor-shift-multiply) of x in [0, 2**32): a
    Python int or an int64 tensor, elementwise."""
    x = x ^ (x >> 16)
    x = (x * _MUL1) & MASK32
    x = x ^ (x >> 15)
    x = (x * _MUL2) & MASK32
    return x ^ (x >> 15)


def seed_keys(seeds: Iterable[int], device=None) -> torch.Tensor:
    """Row keys [b] (int64 in [0, 2**32)) of integer seeds, which may be
    negative or wider than 32 bits (two's complement in 64 bits)."""
    keys = []
    for s in seeds:
        s = int(s) & (2 ** 64 - 1)
        keys.append(mix32(mix32((s & MASK32) ^ _SEED_LO) ^ (s >> 32) ^ _SEED_HI))
    return torch.tensor(keys, dtype=torch.int64, device=device)


def fold_in_rows(row_keys: torch.Tensor, *data: int) -> torch.Tensor:
    """Each row key with the integers ``data`` (each in [0, 2**32)) folded
    in, in order."""
    for d in data:
        d = int(d)
        if not 0 <= d <= MASK32:
            raise ValueError(f"fold_in_rows: {d} is outside [0, 2**32)")
        row_keys = mix32(row_keys ^ mix32(d ^ _FOLD))
    return row_keys


def split_row_keys(row_keys: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """[b] keys -> ([b] subkeys for this draw, [b] new carry keys)."""
    both = mix32(torch.stack((row_keys ^ _SPLIT_SUB, row_keys ^ _SPLIT_CARRY), dim=1))
    return both[:, 0], both[:, 1]


def row_uniforms(row_keys: torch.Tensor, n: int) -> torch.Tensor:
    """[b] keys -> [b, n] float32 uniforms in (0, 1): element (i, j) is the
    top 23 bits m of mix32(key_i xor counter_j), as (m + 0.5) * 2**-23,
    exact in float32. A fixed number of tensor ops whatever b is."""
    cols = (torch.arange(n, dtype=torch.int64, device=row_keys.device) * _COLUMN) & MASK32
    m = mix32(row_keys[:, None] ^ cols[None, :]) >> (32 - UNIFORM_BITS)
    return (m.to(torch.float32) + 0.5) * 2.0 ** -UNIFORM_BITS


def log(t: torch.Tensor, eps: float = 1e-20) -> torch.Tensor:
    return torch.log(t + eps)


def gumbel_noise(shape, *, generator: Optional[torch.Generator] = None, dtype=torch.float32,
                 device=None) -> torch.Tensor:
    """-log(-log(u)) of uniforms u in [0, 1) drawn from ``generator``."""
    return -log(-log(torch.rand(shape, generator=generator, dtype=dtype, device=device)))


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


def sample_top_k_gumbel_per_row(
    row_keys: torch.Tensor,  # [b] one key per row
    logits: torch.Tensor,  # [b, C]
    temperature: float = 1.0,
    filter_thres: float = 0.9,
) -> torch.Tensor:
    """Per-row-keyed sampling: row i's token is a function of row_keys[i]
    and logits[i] only, whatever the batch around it. The top-k filter runs
    in the logits' dtype, as the generator path's does; the gumbel noise and
    the sum are float32 (the uniforms' dtype)."""
    filt = top_k_filter(logits, filter_thres)
    if temperature == 0.0:
        return torch.argmax(filt, dim=-1)
    noise = -log(-log(row_uniforms(row_keys, logits.shape[-1])))
    return torch.argmax(filt.float() / temperature + noise, dim=-1)


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


def all_rows_have_eos_id(ids: torch.Tensor, eos_id: int) -> torch.Tensor:
    """0-d bool: every row of ``ids`` holds ``eos_id``."""
    return (ids == eos_id).any(dim=-1).all()


def unique_consecutive_mask(ids: torch.Tensor) -> torch.Tensor:
    """[..., n] -> True at the first position of each run of equal ids
    (position 0 always): the fixed-shape stand-in for the reference's
    ``batch_unique_consecutive``, as the JAX package writes it."""
    prev = torch.cat([torch.full_like(ids[..., :1], -(10 ** 9)), ids[..., :-1]], dim=-1)
    return ids != prev


def mask_unique_consecutive(ids: torch.Tensor, pad_id: int = -1) -> torch.Tensor:
    """Consecutive duplicates replaced by ``pad_id``: positions stay, and
    the key mask and the loss then skip the duplicates."""
    return torch.where(unique_consecutive_mask(ids), ids, torch.full_like(ids, pad_id))
