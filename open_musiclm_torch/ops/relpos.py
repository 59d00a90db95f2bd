"""Relative position biases (port of open_musiclm_tpu/ops/relpos.py): the
continuous MLP bias of every shipped config, and the T5 bucketed bias.

Either bias is a function of the distance ``i - j`` only: the MLP (or the
bucket table) is read once per distance and the ``[h, n, n]`` matrix is a
Toeplitz expansion of the ``[2n-1, h]`` table. Decode reads rows of a
causal distance table.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from .rows import row_linear


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


def linear(x: torch.Tensor, layer: nn.Linear, tile: Optional[int] = None) -> torch.Tensor:
    """``layer`` applied with its parameters cast to x's dtype (flax's Dense
    with ``dtype``: float32 master weights, a bfloat16 pass); the module
    itself where the dtypes agree, as for ``norm``. ``tile``: the product's
    rows in calls of that many rows on the card (``rows.row_linear``: a
    row's bits then do not depend on its batch)."""
    bias = layer.bias.to(x.dtype) if layer.bias is not None else None
    if tile is not None:
        return row_linear(x, layer.weight.to(x.dtype), bias, tile)
    if layer.weight.dtype == x.dtype:
        return layer(x)
    return F.linear(x, layer.weight.to(x.dtype), bias)


def conv(x: torch.Tensor, layer: nn.Module) -> torch.Tensor:
    """A Conv1d / Conv2d ``layer`` applied with its parameters cast to x's
    dtype (the module itself where they agree, as for ``norm``). A grouped
    conv in a low-precision dtype runs in float32 on the rounded operands
    (what a float32-accumulating bf16 conv computes): the CPU's bf16 grouped
    conv gives wrong values at some group counts."""
    if layer.weight.dtype == x.dtype:
        return layer(x)
    w = layer.weight.to(x.dtype)
    bias = None if layer.bias is None else layer.bias.to(x.dtype)
    if layer.groups == 1 or x.dtype not in (torch.bfloat16, torch.float16):
        return layer._conv_forward(x, w, bias)
    return layer._conv_forward(x.float(), w.float(), None if bias is None else bias.float()).to(x.dtype)


def norm(x: torch.Tensor, layer: nn.Module) -> torch.Tensor:
    """A LayerNorm (over the last axis) or GroupNorm (over [B, C, T])
    ``layer`` in float32, returned in x's dtype. Where x and the parameters
    are float32 the module itself runs, so its forward hooks see the call
    (``chip_smoke.py`` counts a tower's work by them)."""
    if x.dtype == layer.weight.dtype == torch.float32:
        return layer(x)
    w, b = layer.weight.float(), layer.bias.float()
    if isinstance(layer, nn.GroupNorm):
        out = F.group_norm(x.float(), layer.num_groups, w, b, layer.eps)
    else:
        out = F.layer_norm(x.float(), layer.normalized_shape, w, b, layer.eps)
    return out.to(x.dtype)


def batch_norm(x: torch.Tensor, bn: nn.Module, train: bool = False) -> torch.Tensor:
    """x [B, C, ...] through a BatchNorm ``bn`` in float32. Without ``train``
    its running statistics normalize; with it the batch's (the biased
    variance), which then move the running statistics by ``bn.momentum``
    (torch's 0.1 is flax's momentum 0.9) with the biased variance, as the
    JAX package's flax BatchNorm does; torch's own training update would take
    the unbiased one."""
    x, w, b = x.float(), bn.weight.float(), bn.bias.float()
    if not train:
        return F.batch_norm(x, bn.running_mean.float(), bn.running_var.float(), w, b, False, 0.0, bn.eps)
    dims = [0] + list(range(2, x.dim()))
    mean, var = x.mean(dim=dims), x.var(dim=dims, unbiased=False)
    with torch.no_grad():
        m = bn.momentum
        bn.running_mean.mul_(1.0 - m).add_(mean.to(bn.running_mean.dtype), alpha=m)
        bn.running_var.mul_(1.0 - m).add_(var.to(bn.running_var.dtype), alpha=m)
        bn.num_batches_tracked += 1
    shape = (1, -1) + (1,) * (x.dim() - 2)
    return (x - mean.view(shape)) * (torch.rsqrt(var + bn.eps) * w).view(shape) + b.view(shape)


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

    def forward(self, n: int, dtype: Optional[torch.dtype] = None,
                heads: Optional[slice] = None) -> torch.Tensor:
        """Full bias matrix [heads, n, n] for training and prefill, computed
        in ``dtype`` (default: the parameters'), distances included, as the
        JAX package computes it. Differentiable through the gather.
        ``heads``: only those heads' matrices (a tensor-parallel rank's)."""
        w = self.in_layer.weight
        dist = torch.arange(-n + 1, n, dtype=dtype or w.dtype, device=w.device)[:, None]
        table = self.mlp(dist)
        if heads is not None:
            table = table[:, heads]
        return toeplitz_from_table(table, n).permute(2, 0, 1)

    def distance_table(self, max_len: int) -> torch.Tensor:
        """Causal distance table [max_len, heads]; row d = bias at distance d."""
        w = self.in_layer.weight
        return self.mlp(torch.arange(0, max_len, dtype=w.dtype, device=w.device)[:, None])


def t5_relative_bucket(rel_pos: torch.Tensor, causal: bool = True, num_buckets: int = 32,
                       max_distance: int = 128) -> torch.Tensor:
    """T5's bucket of each relative position, as the JAX package computes
    it: ``n = -rel_pos`` (clamped at 0 when causal), exact buckets below
    ``num_buckets // 2``, log-spaced ones up to ``max_distance`` above. The
    JAX package passes ``i - j`` as ``rel_pos``, so every causal distance
    falls in bucket 0 and only keys after the query (the bidirectional
    prefix) reach the others; the port keeps that."""
    ret = torch.zeros_like(rel_pos)
    n = -rel_pos
    if not causal:
        num_buckets //= 2
        ret = ret + (n < 0).long() * num_buckets
        n = n.abs()
    else:
        n = n.clamp(min=0)
    max_exact = num_buckets // 2
    large = max_exact + (torch.log(n.clamp(min=1).float() / max_exact) / math.log(max_distance / max_exact)
                         * (num_buckets - max_exact)).long()
    large = large.clamp(max=num_buckets - 1)
    return ret + torch.where(n < max_exact, n, large)


class T5RelativePositionBias(nn.Module):
    """A [num_buckets, heads] table (``embedding``, N(0, 1) init) read at
    each distance's T5 bucket."""

    def __init__(self, heads: int, num_buckets: int = 32, max_distance: int = 128, causal: bool = True,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.num_buckets, self.max_distance, self.causal = num_buckets, max_distance, causal
        self.embedding = nn.Parameter(torch.empty(num_buckets, heads))
        with torch.no_grad():
            nn.init.normal_(self.embedding, generator=generator)

    def table(self, dist: torch.Tensor, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        """The bias [len(dist), heads] at the relative positions ``dist``: a
        gather of the table's rows, whose gradient (the training path's)
        scatter-adds into the buckets' rows, n rows where the [h, n, n]
        matrix has n^2."""
        buckets = t5_relative_bucket(dist, self.causal, self.num_buckets, self.max_distance)
        return self.embedding.to(dtype or self.embedding.dtype)[buckets]

    def forward(self, n: int, dtype: Optional[torch.dtype] = None,
                heads: Optional[slice] = None) -> torch.Tensor:
        """Full bias matrix [heads, n, n] (``heads``: those heads' only)."""
        table = self.table(torch.arange(-n + 1, n, device=self.embedding.device), dtype)
        if heads is not None:
            table = table[:, heads]
        return toeplitz_from_table(table, n).permute(2, 0, 1)

    def distance_table(self, max_len: int) -> torch.Tensor:
        """Causal distance table [max_len, heads]; row d = bias at distance d."""
        return self.table(torch.arange(0, max_len, device=self.embedding.device))


def make_bias(kind: str, dim: int, heads: int,
              generator: Optional[torch.Generator] = None) -> Optional[nn.Module]:
    if kind == "continuous":
        return ContinuousPositionBias(dim=dim // 2, heads=heads, generator=generator)
    if kind == "t5":
        return T5RelativePositionBias(heads=heads, generator=generator)
    if kind == "none":
        return None
    raise ValueError(f"invalid relative position bias type: {kind}")
