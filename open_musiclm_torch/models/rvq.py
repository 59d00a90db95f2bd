"""Residual vector quantization (port of open_musiclm_tpu/models/rvq.py).

The CLAP conditioning tokens come from Q residual nearest-code lookups over
codebooks [Q, K, D], one [n, D] x [D, K] product each. ``rvq_update`` is one
step of EMA codebook learning: on the first batch every quantizer's
codebook is seeded by k-means over that quantizer's residual; then each
code's EMA count and sum are updated and the code set to their
Laplace-smoothed ratio, and a code whose EMA count fell below
``threshold_ema_dead_code`` is re-seeded from a random residual row. The
random draws come from a ``torch.Generator`` on the data's device.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from .kmeans import kmeans_fit


class RVQState(NamedTuple):
    """Codebooks [Q, K, D]; the EMA training state (counts [Q, K], sums
    [Q, K, D], whether the codebooks were seeded) is None in a state built
    from codebooks alone, which a training step treats as not seeded."""

    codebooks: torch.Tensor
    cluster_size: Optional[torch.Tensor] = None
    embed_avg: Optional[torch.Tensor] = None
    initted: Optional[torch.Tensor] = None


def rvq_init(num_quantizers: int, codebook_size: int, dim: int,
             generator: Optional[torch.Generator] = None) -> RVQState:
    """Standard-normal codebooks drawn from ``generator`` (on its device),
    zero EMA counts, not seeded."""
    device = generator.device if generator is not None else None
    codebooks = torch.randn(num_quantizers, codebook_size, dim, generator=generator, device=device)
    return RVQState(codebooks, torch.zeros(num_quantizers, codebook_size, device=codebooks.device),
                    codebooks.clone(), torch.tensor(False, device=codebooks.device))


def rvq_to(state: RVQState, device) -> RVQState:
    """The state with each of its tensors on ``device``."""
    return RVQState(*(None if t is None else t.to(device) for t in state))


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


def init_from_batch(x: torch.Tensor, num_quantizers: int, codebook_size: int,
                    generator: Optional[torch.Generator] = None, iters: int = 10) -> RVQState:
    """Seeded state from a batch x [n, D]: each quantizer's codebook is
    k-means (``iters`` Lloyd's steps) over the residual the codebooks before
    it leave; EMA counts of one, sums equal to the codes. Needs n >= K rows:
    with fewer, k-means would repeat rows as codes."""
    if x.shape[0] < codebook_size:
        raise ValueError(f"RVQ init needs at least codebook_size = {codebook_size} embeddings, "
                         f"got {x.shape[0]}")
    cbs, resid = [], x
    for _ in range(num_quantizers):
        cb = kmeans_fit(resid, codebook_size, generator, num_iters=iters)
        resid = resid - cb[_nearest(resid, cb)]
        cbs.append(cb)
    cbs = torch.stack(cbs)
    return RVQState(cbs, torch.ones(cbs.shape[:2], dtype=x.dtype, device=x.device), cbs.clone(),
                    torch.tensor(True, device=x.device))


def rvq_update(state: RVQState, x: torch.Tensor, generator: Optional[torch.Generator] = None, *,
               decay: float = 0.95, epsilon: float = 1e-5,
               threshold_ema_dead_code: float = 0.0) -> Tuple[RVQState, torch.Tensor, torch.Tensor]:
    """One EMA training step on x [n, D]. Returns (new state, quantized
    [n, D] through the new codebooks, indices [n, Q] from the old). The
    residual passed on at each quantizer is the old codebook's."""
    Q, K, _ = state.codebooks.shape
    n = x.shape[0]
    if state.initted is None or not bool(state.initted):
        state = init_from_batch(x, Q, K, generator)
    new_cb, new_sz, new_avg, idxs = [], [], [], []
    resid, quant = x, torch.zeros_like(x)
    for q in range(Q):
        cb = state.codebooks[q]
        idx = _nearest(resid, cb)
        counts = torch.zeros(K, dtype=x.dtype, device=x.device).index_add_(
            0, idx, torch.ones_like(idx, dtype=x.dtype))
        embed_sum = torch.zeros_like(cb).index_add_(0, idx, resid)
        sz = state.cluster_size[q] * decay + counts * (1.0 - decay)
        avg = state.embed_avg[q] * decay + embed_sum * (1.0 - decay)
        total = sz.sum()
        smoothed = (sz + epsilon) / (total + K * epsilon) * total  # Laplace smoothing
        cb_new = avg / smoothed[:, None]
        if threshold_ema_dead_code > 0:
            dead = sz < threshold_ema_dead_code
            samples = resid[torch.randint(0, n, (K,), generator=generator, device=x.device)]
            cb_new = torch.where(dead[:, None], samples, cb_new)
            sz = torch.where(dead, torch.clamp(sz, min=threshold_ema_dead_code), sz)
            avg = torch.where(dead[:, None], samples * sz[:, None], avg)
        quant = quant + cb_new[idx]
        resid = resid - cb[idx]
        idxs.append(idx)
        new_cb.append(cb_new)
        new_sz.append(sz)
        new_avg.append(avg)
    new_state = RVQState(torch.stack(new_cb), torch.stack(new_sz), torch.stack(new_avg),
                         torch.tensor(True, device=x.device))
    return new_state, quant, torch.stack(idxs, dim=-1)
