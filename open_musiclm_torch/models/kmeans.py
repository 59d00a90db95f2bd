"""K-means: assignment and the fits (port of open_musiclm_tpu/models/kmeans.py).

``kmeans_predict`` is one [n, D] x [D, K] product and an argmin of
``|c|^2 - 2 x.c``: the semantic token of a HuBERT feature row, ties to the
lowest index. ``kmeans_fit`` is full-batch Lloyd's from a k-means++ start
(the RVQ's init); ``minibatch_kmeans_init`` / ``minibatch_kmeans_update``
are count-weighted minibatch Lloyd's (Sculley 2010), which fits the
semantic codebook. Every step runs on the data's device; the k-means++
draws come from a ``torch.Generator`` (the JAX package draws from
``jax.random``, so the two starts differ; from the same start the fits
agree).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch


class KMeansState(NamedTuple):
    centroids: torch.Tensor  # [K, D]
    counts: torch.Tensor  # [K]


def kmeans_predict(x: torch.Tensor, centroids: torch.Tensor) -> torch.Tensor:
    """x [..., D], centroids [K, D] -> int64 indices [...]."""
    flat = x.reshape(-1, x.shape[-1])
    dots = flat @ centroids.t()
    c2 = centroids.square().sum(dim=-1)
    return torch.argmin(c2[None, :] - 2.0 * dots, dim=-1).reshape(x.shape[:-1])


def _plus_plus_lite_init(x: torch.Tensor, k: int, generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """k-means++: the first centroid uniform, each next one drawn with
    probability proportional to its squared distance from the nearest so
    far (``generator`` on ``x``'s device)."""
    n = x.shape[0]
    first = x[torch.randint(0, n, (), generator=generator, device=x.device)]
    cents = torch.zeros((k,) + x.shape[1:], dtype=x.dtype, device=x.device)
    cents[0] = first
    d2 = (x - first).square().sum(-1)
    for i in range(1, k):
        probs = d2 / torch.clamp(d2.sum(), min=1e-12)
        idx = torch.multinomial(probs + 1e-20, 1, generator=generator)[0]
        c = x[idx]
        cents[i] = c
        d2 = torch.minimum(d2, (x - c).square().sum(-1))
    return cents


def _assignment_sums(x: torch.Tensor, cents: torch.Tensor):
    """(count [K], sum [K, D]) of the rows of ``x`` nearest each centroid."""
    idx = kmeans_predict(x, cents)
    counts = torch.zeros(cents.shape[0], dtype=x.dtype, device=x.device).index_add_(
        0, idx, torch.ones_like(idx, dtype=x.dtype))
    sums = torch.zeros_like(cents).index_add_(0, idx, x)
    return counts, sums


def kmeans_fit(x: torch.Tensor, k: int, generator: Optional[torch.Generator] = None,
               num_iters: int = 50) -> torch.Tensor:
    """Full-batch Lloyd's on [n, D] -> centroids [K, D]; a centroid no row
    is nearest keeps its place."""
    cents = _plus_plus_lite_init(x, k, generator)
    for _ in range(num_iters):
        counts, sums = _assignment_sums(x, cents)
        cents = torch.where(counts[:, None] > 0, sums / torch.clamp(counts, min=1)[:, None], cents)
    return cents


def minibatch_kmeans_init(x0: torch.Tensor, k: int, generator: Optional[torch.Generator] = None) -> KMeansState:
    return KMeansState(_plus_plus_lite_init(x0, k, generator), torch.zeros(k, dtype=x0.dtype, device=x0.device))


def minibatch_kmeans_update(state: KMeansState, batch: torch.Tensor) -> KMeansState:
    """One count-weighted minibatch step: each centroid moves toward the
    mean of its rows by their share of all the rows it has seen."""
    n_assigned, sums = _assignment_sums(batch, state.centroids)
    new_counts = state.counts + n_assigned
    target = torch.where(n_assigned[:, None] > 0, sums / torch.clamp(n_assigned, min=1)[:, None],
                         state.centroids)
    lr = torch.where(new_counts > 0, n_assigned / torch.clamp(new_counts, min=1), torch.zeros_like(new_counts))
    return KMeansState(state.centroids + (target - state.centroids) * lr[:, None], new_counts)


def kmeans_inertia(x: torch.Tensor, centroids: torch.Tensor) -> torch.Tensor:
    """Mean squared distance of each row to its nearest centroid."""
    idx = kmeans_predict(x, centroids)
    return (x - centroids[idx]).square().sum(-1).mean()
