"""Attentional feature fusion for the long-audio CLAP (port of
open_musiclm_tpu/models/clap/fusion.py).

musiclm_large's CLAP (``enable_fusion``) embeds a clip from four log-mel
views: a global view shrunk to one clip's frames and three local chunks
(front, middle, back), fused at the patch embed (``htsat.py``). The modules
work on torch's [B, C, H, W] layout; their parameter names follow the laion
checkpoint's ``feature_fusion.py`` (``local_att`` / ``global_att``
Sequentials: Conv2d 1x1, BatchNorm2d, ReLU, Conv2d 1x1, BatchNorm2d, the
global branch after an average pool). The BatchNorms normalize with their
running statistics, or with ``train`` with the batch's (and update the
running ones as flax does; ``ops.relpos.batch_norm``).
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch
from torch import nn

from ...ops.relpos import batch_norm, conv


def _att_branch(channels: int, r: int, global_pool: bool) -> nn.Sequential:
    inter = channels // r
    layers = [nn.Conv2d(channels, inter, 1), nn.BatchNorm2d(inter), nn.ReLU(),
              nn.Conv2d(inter, channels, 1), nn.BatchNorm2d(channels)]
    return nn.Sequential(*([nn.AdaptiveAvgPool2d(1)] if global_pool else []), *layers)


def _run(branch: nn.Sequential, x: torch.Tensor, train: bool = False) -> torch.Tensor:
    """A branch with its convs' parameters cast to x's dtype and its
    BatchNorms in float32."""
    for m in branch:
        if isinstance(m, nn.Conv2d):
            x = conv(x, m)
        elif isinstance(m, nn.BatchNorm2d):
            x = batch_norm(x, m, train).to(x.dtype)
        else:
            x = m(x)
    return x


class DAF(nn.Module):
    """Direct add fuse."""

    def forward(self, x: torch.Tensor, residual: torch.Tensor, train: bool = False) -> torch.Tensor:
        return x + residual


class AFF(nn.Module):
    """x, residual [B, C, H, W] -> the attentional blend
    2 x w + 2 residual (1 - w), w = sigmoid(local(x + residual) + global(x + residual))."""

    def __init__(self, channels: int = 64, r: int = 4):
        super().__init__()
        self.local_att = _att_branch(channels, r, False)
        self.global_att = _att_branch(channels, r, True)

    def forward(self, x: torch.Tensor, residual: torch.Tensor, train: bool = False) -> torch.Tensor:
        xa = x + residual
        wei = torch.sigmoid(_run(self.local_att, xa, train) + _run(self.global_att, xa, train))
        return 2.0 * x * wei + 2.0 * residual * (1.0 - wei)


class iAFF(nn.Module):
    """Iterative AFF. The second pass reuses ``global_att``, as the reference
    does; ``global_att2`` is held for the checkpoint's layout only."""

    def __init__(self, channels: int = 64, r: int = 4):
        super().__init__()
        self.local_att = _att_branch(channels, r, False)
        self.global_att = _att_branch(channels, r, True)
        self.local_att2 = _att_branch(channels, r, False)
        self.global_att2 = _att_branch(channels, r, True)

    def forward(self, x: torch.Tensor, residual: torch.Tensor, train: bool = False) -> torch.Tensor:
        xa = x + residual
        wei = torch.sigmoid(_run(self.local_att, xa, train) + _run(self.global_att, xa, train))
        xi = x * wei + residual * (1.0 - wei)
        wei2 = torch.sigmoid(_run(self.local_att2, xi, train) + _run(self.global_att, xi, train))
        return x * wei2 + residual * (1.0 - wei2)


def make_fusion(fusion_type: str, channels: int) -> nn.Module:
    kind = fusion_type.split("_")[0]
    if kind == "daf":
        return DAF()
    if kind == "aff":
        return AFF(channels)
    if kind == "iaff":
        return iAFF(channels)
    raise ValueError(f"unknown fusion type {fusion_type}")


@functools.lru_cache(maxsize=8)
def linear_resize_matrix(in_size: int, out_size: int) -> np.ndarray:
    """[in_size, out_size] float32 weights of ``jax.image.resize(...,
    method="linear")`` along one axis: a triangle kernel widened by
    in / out when shrinking (antialiased), each output's weights normalized
    to sum 1, computed in float32 as JAX computes them."""
    f32 = np.float32
    inv_scale = f32(1.0 / (out_size / in_size))
    kernel_scale = max(inv_scale, f32(1.0))
    sample_f = (np.arange(out_size, dtype=f32) + f32(0.5)) * inv_scale - f32(0.0) * inv_scale - f32(0.5)
    x = np.abs(sample_f[None, :] - np.arange(in_size, dtype=f32)[:, None]) / kernel_scale
    w = np.maximum(f32(0.0), f32(1.0) - np.abs(x))
    total = w.sum(axis=0, keepdims=True, dtype=f32)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, f32(1.0)), f32(0.0))
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return np.where(inside[None, :], w, f32(0.0)).astype(f32)


def build_mel_fusion(mel: torch.Tensor, chunk_frames: int) -> torch.Tensor:
    """[T, F] full-track log-mel -> [4, chunk_frames, F]: the whole track
    linearly shrunk to ``chunk_frames`` (antialiased, as JAX's resize), then
    the front, middle and back chunks. A track of at most ``chunk_frames``
    is zero-padded and repeated four times. The chunk positions are the
    inference ones (the JAX package draws them at random in training only)."""
    T, _ = mel.shape
    if T <= chunk_frames:
        m = torch.nn.functional.pad(mel, (0, 0, 0, chunk_frames - T))
        return torch.stack([m, m, m, m])
    w = torch.from_numpy(linear_resize_matrix(T, chunk_frames)).to(mel.device, mel.dtype)
    shrink = w.t() @ mel
    max_start = T - chunk_frames
    chunks = [mel[s: s + chunk_frames] for s in (0, max_start // 2, max_start)]
    return torch.stack([shrink] + chunks)


def fuse_patches(global_x: torch.Tensor, local: torch.Tensor, fusion: nn.Module,
                 longer: Optional[torch.Tensor], train: bool = False) -> torch.Tensor:
    """global_x [B, E, H, W] from the global view, local [B, 3, E, h, w]
    from the three chunks -> fused patches [B, E, H, W]: the chunks laid
    side by side along the width (padded or cut to W) and fused in where
    ``longer`` [B] is set (all rows when None)."""
    B, n, E, hh, ww = local.shape
    local = local.permute(0, 2, 3, 1, 4).reshape(B, E, hh, n * ww)
    W = global_x.shape[-1]
    if local.shape[-1] < W:
        local = torch.nn.functional.pad(local, (0, W - local.shape[-1]))
    else:
        local = local[..., :W]
    fused = fusion(global_x, local, train)
    if longer is None:
        return fused
    return torch.where(longer.to(fused.device)[:, None, None, None], fused, global_x)
