"""HTSAT, the CLAP audio tower (port of open_musiclm_tpu/models/clap/htsat.py).

48 kHz waveform -> log-mel [B, 1001, 64] -> BatchNorm over mel bins
(running statistics; in training, ``train=True``, the batch's, which update
the running ones as flax does, then SpecAugment when a generator is given
and fusion is off) -> fold into a 256 x 256 "image" (freq_ratio 4;
bicubic time resize with align_corners=True) -> patch embed (4 x 4) -> four
Swin stages (HTSAT-tiny: embed 96, depths 2/2/6/2, heads 4/8/16/32, window
8; shifted windows on odd blocks) -> LayerNorm -> freq-unfold pooling ->
768-d ``embedding``, and the token-semantic CAM head's clipwise and
framewise outputs. A stage whose grid is at most the window takes
window = min(H, W) and no shift. Parameter names follow the laion CLAP
checkpoint's ``audio_branch`` (``patch_embed.proj``,
``layers.{s}.blocks.{b}.attn.qkv``, ``layers.{s}.downsample.reduction``,
``tscam_conv``, ``bn0``).

With ``enable_fusion`` (musiclm_large) the tower takes a [B, 4, frames,
mel_bins] stack of log-mel views (``fusion.build_mel_fusion``): the global
view through the patch conv, the three local chunks through
``patch_embed.mel_conv2d`` (kernel and stride three times as wide), side by
side, fused into the global patches by ``patch_embed.fusion_model`` (the
config's ``fusion_type``, by default AFF, ``aff_2d``) where ``longer`` is set.

``compute_dtype`` (None: the parameters' dtype) runs the tower after bn0 in
another dtype, flax's ``dtype``: the weights are cast at their use; the mel
front end, bn0, the LayerNorm statistics and the softmax stay in float32.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...ops.relpos import batch_norm, conv, lecun_normal_, linear, norm
from .fusion import fuse_patches, make_fusion
from .mel import logmel, spec_augment


def _cubic_weights(t: torch.Tensor, a: float = -0.75):
    """Cubic convolution weights of the 4 taps at distances 1+t, t, 1-t, 2-t."""
    def near(d):  # |d| <= 1
        return (a + 2.0) * d ** 3 - (a + 3.0) * d ** 2 + 1.0

    def far(d):  # 1 < |d| < 2
        return a * d ** 3 - 5.0 * a * d ** 2 + 8.0 * a * d - 4.0 * a

    return far(1.0 + t), near(t), near(1.0 - t), far(2.0 - t)


def bicubic_resize_axis_align_corners(x: torch.Tensor, new_len: int, axis: int) -> torch.Tensor:
    """Resize one axis by bicubic interpolation (a = -0.75), align_corners=True,
    the edge taps clamped to the ends."""
    old_len = x.shape[axis]
    if old_len == new_len:
        return x
    x = x.movedim(axis, -1)
    pos = torch.arange(new_len, dtype=torch.float32, device=x.device) * ((old_len - 1) / max(new_len - 1, 1))
    i0 = torch.floor(pos).to(torch.long)
    t = (pos - i0).to(x.dtype)
    idx = torch.stack([i0 - 1, i0, i0 + 1, i0 + 2]).clamp(0, old_len - 1)  # [4, new_len]
    w = torch.stack(_cubic_weights(t))
    return (x[..., idx] * w).sum(dim=-2).movedim(-1, axis)


@functools.lru_cache(maxsize=32)
def relative_position_index(wh: int, ww: int) -> np.ndarray:
    """[wh*ww, wh*ww] indices into the (2wh-1)(2ww-1) bias table."""
    coords = np.stack(np.meshgrid(np.arange(wh), np.arange(ww), indexing="ij")).reshape(2, -1)
    rel = (coords[:, :, None] - coords[:, None, :]).transpose(1, 2, 0)
    rel[:, :, 0] += wh - 1
    rel[:, :, 1] += ww - 1
    rel[:, :, 0] *= 2 * ww - 1
    return rel.sum(-1)


@functools.lru_cache(maxsize=32)
def shifted_window_mask(H: int, W: int, window: int, shift: int) -> np.ndarray:
    """[nW, w*w, w*w] additive mask (0 / -100) of the shifted windows."""
    img = np.zeros((H, W))
    cnt = 0
    for h in (slice(0, -window), slice(-window, -shift), slice(-shift, None)):
        for w in (slice(0, -window), slice(-window, -shift), slice(-shift, None)):
            img[h, w] = cnt
            cnt += 1
    mw = img.reshape(H // window, window, W // window, window).transpose(0, 2, 1, 3)
    mw = mw.reshape(-1, window * window)
    return np.where(mw[:, None, :] - mw[:, :, None] != 0, -100.0, 0.0).astype(np.float32)


def window_partition(x: torch.Tensor, window: int) -> torch.Tensor:
    """[B, H, W, C] -> [B*nW, window*window, C]."""
    B, H, W, C = x.shape
    x = x.reshape(B, H // window, window, W // window, window, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, window * window, C)


def window_reverse(win: torch.Tensor, window: int, H: int, W: int) -> torch.Tensor:
    B = win.shape[0] // ((H // window) * (W // window))
    x = win.reshape(B, H // window, W // window, window, window, -1).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, H, W, -1)


@dataclasses.dataclass(frozen=True)
class HTSATConfig:
    """Audio-side geometry (model_configs/HTSAT-tiny.json)."""

    spec_size: int = 256
    patch_size: int = 4
    patch_stride: Tuple[int, int] = (4, 4)
    embed_dim: int = 96
    depths: Tuple[int, ...] = (2, 2, 6, 2)
    num_heads: Tuple[int, ...] = (4, 8, 16, 32)
    window_size: int = 8
    num_classes: int = 527
    mel_bins: int = 64
    sample_rate: int = 48000
    window_size_fft: int = 1024
    hop_size: int = 480
    fmin: float = 50.0
    fmax: float = 14000.0
    clip_samples: int = 480000
    enable_fusion: bool = False
    fusion_type: str = "aff_2d"

    @property
    def freq_ratio(self) -> int:
        return self.spec_size // self.mel_bins

    @property
    def num_features(self) -> int:
        return int(self.embed_dim * 2 ** (len(self.depths) - 1))


class WindowAttention(nn.Module):
    def __init__(self, dim: int, window: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)
        self.relative_position_bias_table = nn.Parameter(torch.zeros((2 * window - 1) ** 2, num_heads))
        self.register_buffer("relative_position_index",
                             torch.from_numpy(relative_position_index(window, window)), persistent=False)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        B_, N, C = x.shape
        h = self.num_heads
        q, k, v = linear(x, self.qkv).reshape(B_, N, 3, h, C // h).permute(2, 0, 3, 1, 4)
        attn = (q * (C // h) ** -0.5) @ k.transpose(-2, -1)
        bias = self.relative_position_bias_table[self.relative_position_index.reshape(-1)]
        attn = attn.float() + bias.float().reshape(N, N, h).permute(2, 0, 1)[None]
        if mask is not None:
            nW = mask.shape[0]
            attn = (attn.reshape(B_ // nW, nW, h, N, N) + mask[None, :, None]).reshape(B_, h, N, N)
        out = attn.softmax(dim=-1).to(v.dtype) @ v
        return linear(out.transpose(1, 2).reshape(B_, N, C), self.proj)


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return linear(F.gelu(linear(x, self.fc1)), self.fc2)


class SwinBlock(nn.Module):
    def __init__(self, dim: int, resolution: Tuple[int, int], num_heads: int, window: int = 8,
                 shift: int = 0, mlp_ratio: float = 4.0):
        super().__init__()
        H, W = resolution
        if min(H, W) <= window:
            window, shift = min(H, W), 0
        self.resolution, self.window, self.shift = (H, W), window, shift
        self.norm1 = nn.LayerNorm(dim)
        self.attn = WindowAttention(dim, window, num_heads)
        self.norm2 = nn.LayerNorm(dim)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))
        mask = torch.from_numpy(shifted_window_mask(H, W, window, shift)) if shift > 0 else None
        self.register_buffer("attn_mask", mask, persistent=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        (H, W), window, shift = self.resolution, self.window, self.shift
        B, L, C = x.shape
        h = norm(x, self.norm1).reshape(B, H, W, C)
        if shift > 0:
            h = torch.roll(h, (-shift, -shift), dims=(1, 2))
        h = window_reverse(self.attn(window_partition(h, window), self.attn_mask), window, H, W)
        if shift > 0:
            h = torch.roll(h, (shift, shift), dims=(1, 2))
        x = x + h.reshape(B, L, C)
        return x + self.mlp(norm(x, self.norm2))


class PatchMerging(nn.Module):
    def __init__(self, dim: int, resolution: Tuple[int, int]):
        super().__init__()
        self.resolution = resolution
        self.norm = nn.LayerNorm(4 * dim)
        self.reduction = nn.Linear(4 * dim, 2 * dim, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        (H, W), (B, _, C) = self.resolution, x.shape
        x = x.reshape(B, H, W, C)
        x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2], x[:, 1::2, 1::2]], dim=-1)
        return linear(norm(x.reshape(B, (H // 2) * (W // 2), 4 * C), self.norm), self.reduction)


class BasicLayer(nn.Module):
    """One Swin stage: its blocks, then the patch merging of every stage but the last."""

    def __init__(self, dim: int, resolution: Tuple[int, int], depth: int, num_heads: int,
                 window: int, merge: bool):
        super().__init__()
        self.blocks = nn.ModuleList(
            SwinBlock(dim, resolution, num_heads, window, 0 if bi % 2 == 0 else window // 2)
            for bi in range(depth))
        self.downsample = PatchMerging(dim, resolution) if merge else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for block in self.blocks:
            x = block(x)
        return x if self.downsample is None else self.downsample(x)


class PatchEmbed(nn.Module):
    def __init__(self, cfg: HTSATConfig):
        super().__init__()
        self.proj = nn.Conv2d(1, cfg.embed_dim, cfg.patch_size, stride=cfg.patch_stride)
        self.norm = nn.LayerNorm(cfg.embed_dim)
        if cfg.enable_fusion:
            p, s = cfg.patch_size, cfg.patch_stride
            self.mel_conv2d = nn.Conv2d(1, cfg.embed_dim, (p, 3 * p), stride=(s[0], 3 * s[1]))
            self.fusion_model = make_fusion(cfg.fusion_type, cfg.embed_dim)

    def forward(self, img: torch.Tensor, longer: Optional[torch.Tensor] = None,
                train: bool = False) -> torch.Tensor:
        """[B, H, W] image, or [B, 4, H, W] with fusion (the global view
        first) -> [B, H'*W', E]; ``train``: the fusion's BatchNorms on batch
        statistics."""
        if img.dim() == 3:
            h = conv(img[:, None], self.proj)
        else:
            B, n, H, W = img.shape
            local = conv(img[:, 1:].reshape(B * (n - 1), 1, H, W), self.mel_conv2d)
            h = fuse_patches(conv(img[:, :1], self.proj), local.reshape(B, n - 1, *local.shape[1:]),
                             self.fusion_model, longer, train)
        return norm(h.flatten(2).transpose(1, 2), self.norm)


class HTSAT(nn.Module):
    """``forward(wav)`` [B, T] at 48 kHz (or ``mel=`` [B, frames, mel_bins],
    before bn0) -> dict of ``embedding`` [B, num_features],
    ``clipwise_output`` [B, classes] and ``framewise_output``."""

    def __init__(self, cfg: HTSATConfig = HTSATConfig(), generator: Optional[torch.Generator] = None,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.cfg = cfg
        self.compute_dtype = compute_dtype
        self.bn0 = nn.BatchNorm1d(cfg.mel_bins)
        self.patch_embed = PatchEmbed(cfg)
        grid = (cfg.spec_size // cfg.patch_stride[0], cfg.spec_size // cfg.patch_stride[1])
        self.layers = nn.ModuleList()
        res, dim = grid, cfg.embed_dim
        for si, (depth, heads) in enumerate(zip(cfg.depths, cfg.num_heads)):
            self.layers.append(BasicLayer(dim, res, depth, heads, cfg.window_size, si < len(cfg.depths) - 1))
            if si < len(cfg.depths) - 1:
                res, dim = (res[0] // 2, res[1] // 2), dim * 2
        self.final_resolution = res
        self.norm = nn.LayerNorm(dim)
        self.tscam_conv = nn.Conv2d(dim, cfg.num_classes, (res[0] // cfg.freq_ratio, 3), padding=(0, 1))
        for m in self.modules():
            if isinstance(m, (nn.Linear, nn.Conv2d)):
                lecun_normal_(m.weight, m.weight[0].numel(), generator)
                if m.bias is not None:
                    with torch.no_grad():
                        m.bias.zero_()
            elif isinstance(m, WindowAttention):
                with torch.no_grad():
                    m.relative_position_bias_table.normal_(0.0, 0.02, generator=generator)

    def fold(self, mel: torch.Tensor) -> torch.Tensor:
        """reshape_wav2img: [B, frames, F] -> [B, spec_size, spec_size]."""
        cfg = self.cfg
        fr = cfg.freq_ratio
        target_T, target_F = cfg.spec_size * fr, cfg.spec_size // fr
        x = bicubic_resize_axis_align_corners(mel, target_T, axis=1)
        if mel.shape[2] < target_F:
            x = bicubic_resize_axis_align_corners(x, target_F, axis=2)
        x = x.transpose(1, 2).reshape(mel.shape[0], target_F, fr, target_T // fr).transpose(1, 2)
        return x.reshape(mel.shape[0], fr * target_F, target_T // fr)

    def forward(self, wav: Optional[torch.Tensor] = None, *, mel: Optional[torch.Tensor] = None,
                mel_fusion: Optional[torch.Tensor] = None, longer: Optional[torch.Tensor] = None,
                train: bool = False, generator: Optional[torch.Generator] = None) -> dict:
        """``mel_fusion`` [B, 4, frames, mel_bins] (before bn0) and ``longer``
        [B] bool (None: every row) take the fusion path. ``train``: the
        training forward (the BatchNorms on batch statistics, updating their
        running ones; SpecAugment drawn from ``generator`` when one is given
        and fusion is off)."""
        cfg = self.cfg
        fusion = cfg.enable_fusion and mel_fusion is not None
        if fusion:
            mel = mel_fusion
        elif mel is None:
            mel = logmel(wav.float(), sr=cfg.sample_rate, n_fft=cfg.window_size_fft, hop=cfg.hop_size,
                         n_mels=cfg.mel_bins, fmin=cfg.fmin, fmax=cfg.fmax)
        shape = mel.shape
        mel = mel.reshape(-1, *shape[-2:]).float()
        mel = batch_norm(mel.transpose(1, 2), self.bn0, train).transpose(1, 2)
        if train and generator is not None and not fusion:
            mel = spec_augment(generator, mel)
        img = self.fold(mel.to(self.compute_dtype or self.bn0.weight.dtype))
        h = self.patch_embed(img.reshape(*shape[:-2], *img.shape[-2:]), longer, train)
        for layer in self.layers:
            h = layer(h)
        h = norm(h, self.norm)

        # freq-unfold latent pooling
        B, (SF, ST), C = h.shape[0], self.final_resolution, h.shape[-1]
        c_freq_bin = SF // cfg.freq_ratio
        g = h.transpose(1, 2).reshape(B, C, SF // c_freq_bin, c_freq_bin, ST)
        g = g.permute(0, 1, 3, 2, 4).reshape(B, C, c_freq_bin, -1)
        tc = conv(g, self.tscam_conv).flatten(2).transpose(1, 2)  # [B, frames'', classes]
        return {
            "embedding": g.reshape(B, C, -1).mean(dim=-1),
            "clipwise_output": torch.sigmoid(tc.mean(dim=1)),
            "framewise_output": torch.sigmoid(tc),
        }
