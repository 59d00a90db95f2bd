"""Continuous relative position bias (port of open_musiclm_tpu/ops/relpos.py).

The bias is a function of the distance ``i - j`` only: the MLP runs once
per distance and the ``[h, n, n]`` matrix is a Toeplitz expansion of the
``[2n-1, h]`` table. Decode reads rows of a causal distance table.
The T5 bucketed variant is not ported: no shipped config uses it.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn


def toeplitz_from_table(table: torch.Tensor, n: int) -> torch.Tensor:
    """[2n-1, h] distance table -> [n, n, h] with out[i, j] = table[i - j + n - 1]."""
    i = torch.arange(n, device=table.device)[:, None]
    j = torch.arange(n, device=table.device)[None, :]
    return table[i - j + (n - 1)]


def lecun_normal_(w: torch.Tensor, fan_in: int, generator: Optional[torch.Generator]) -> torch.Tensor:
    """flax's lecun_normal: truncated normal (+-2 sigma) with variance 1/fan_in."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    with torch.no_grad():
        return nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std, generator=generator)


def linear(x: torch.Tensor, layer: nn.Linear) -> torch.Tensor:
    """``layer`` applied with its parameters cast to x's dtype (flax's Dense
    with ``dtype``: float32 master weights, a bfloat16 pass)."""
    bias = layer.bias.to(x.dtype) if layer.bias is not None else None
    return F.linear(x, layer.weight.to(x.dtype), bias)


def init_linear_(layer: nn.Linear, generator: Optional[torch.Generator]) -> None:
    """Dense layer init as flax does it: lecun-normal kernel, zero bias."""
    lecun_normal_(layer.weight, layer.in_features, generator)
    if layer.bias is not None:
        with torch.no_grad():
            layer.bias.zero_()


class ContinuousPositionBias(nn.Module):
    """SiLU MLP from a scalar distance to a per-head bias: Linear(1, dim),
    then ``num_layers - 1`` Linear(dim, dim), each followed by SiLU, then
    Linear(dim, heads) -- four Linear layers for num_layers=3."""

    def __init__(self, dim: int, heads: int, num_layers: int = 3,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.in_layer = nn.Linear(1, dim)
        self.mid_layers = nn.ModuleList(nn.Linear(dim, dim) for _ in range(num_layers - 1))
        self.out_layer = nn.Linear(dim, heads)
        for layer in (self.in_layer, *self.mid_layers, self.out_layer):
            init_linear_(layer, generator)

    def mlp(self, x: torch.Tensor) -> torch.Tensor:
        h = F.silu(linear(x, self.in_layer))
        for layer in self.mid_layers:
            h = F.silu(linear(h, layer))
        return linear(h, self.out_layer)

    def forward(self, n: int, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        """Full bias matrix [heads, n, n] for training and prefill, computed
        in ``dtype`` (default: the parameters'), distances included, as the
        JAX package computes it. Differentiable through the gather."""
        w = self.in_layer.weight
        dist = torch.arange(-n + 1, n, dtype=dtype or w.dtype, device=w.device)[:, None]
        return toeplitz_from_table(self.mlp(dist), n).permute(2, 0, 1)

    def distance_table(self, max_len: int) -> torch.Tensor:
        """Causal distance table [max_len, heads]; row d = bias at distance d."""
        w = self.in_layer.weight
        return self.mlp(torch.arange(0, max_len, dtype=w.dtype, device=w.device)[:, None])


def make_bias(kind: str, dim: int, heads: int,
              generator: Optional[torch.Generator] = None) -> Optional[nn.Module]:
    if kind == "continuous":
        return ContinuousPositionBias(dim=dim // 2, heads=heads, generator=generator)
    if kind == "none":
        return None
    raise NotImplementedError(f"relative position bias {kind!r} is not ported")
