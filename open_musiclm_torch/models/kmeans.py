"""K-means assignment (port of ``kmeans_predict`` in
open_musiclm_tpu/models/kmeans.py).

One [n, D] x [D, K] product and an argmin of ``|c|^2 - 2 x.c``: the
semantic token of a HuBERT feature row. Ties go to the lowest index. The
minibatch fit is training and is not ported.
"""

from __future__ import annotations

import torch


def kmeans_predict(x: torch.Tensor, centroids: torch.Tensor) -> torch.Tensor:
    """x [..., D], centroids [K, D] -> int64 indices [...]."""
    flat = x.reshape(-1, x.shape[-1])
    dots = flat @ centroids.t()
    c2 = centroids.square().sum(dim=-1)
    return torch.argmin(c2[None, :] - 2.0 * dots, dim=-1).reshape(x.shape[:-1])
