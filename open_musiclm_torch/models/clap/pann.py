"""PANN CNN audio towers, Cnn14 / Cnn10 / Cnn6 (port of
open_musiclm_tpu/models/clap/pann.py), the CLAP audio branch of the PANN-*
presets.

Waveform -> log-mel [B, T, 64] -> BatchNorm over the mel bins (``bn0``) ->
conv blocks (two 3x3 conv + BN + ReLU, or one 5x5 for Cnn6) each followed
by a 2x2 average pool (Cnn14's last block by none) -> mean over frequency
-> max + mean over time -> ``fc1`` + ReLU = ``embedding`` (2048 / 1024 /
512 wide) -> ``fc_audioset`` + sigmoid = ``clipwise_output``. The JAX
package runs NHWC with H = time and W = mel; here the activations are NCHW
[B, C, time, mel]. ``train=True`` normalizes with the batch's statistics
and moves the running ones by flax's rule (momentum 0.9, the biased
variance). Parameter names follow laion's ``pann_model.py``: ``bn0``,
``conv_block{i}.conv{j}`` / ``bn{j}``, ``fc1``, ``fc_audioset``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ...ops.relpos import batch_norm, conv, init_linear_, lecun_normal_, linear
from .mel import logmel

CHANNELS = {
    "Cnn14": (64, 128, 256, 512, 1024, 2048),
    "Cnn10": (64, 128, 256, 512, 1024),
    "Cnn6": (64, 128, 256, 512),
}
EMBED_DIM = {"Cnn14": 2048, "Cnn10": 1024, "Cnn6": 512}


def _pool(x: torch.Tensor, pool_size: Tuple[int, int], pool_type: str) -> torch.Tensor:
    if pool_size == (1, 1):
        return x
    if pool_type == "avg":
        return F.avg_pool2d(x, pool_size)
    if pool_type == "max":
        return F.max_pool2d(x, pool_size)
    if pool_type == "avg+max":
        return F.avg_pool2d(x, pool_size) + F.max_pool2d(x, pool_size)
    raise ValueError(pool_type)


class ConvBlock(nn.Module):
    """Two 3x3 conv + BN + ReLU, then the pool."""

    kernel = 3

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.n_convs = 2 if self.kernel == 3 else 1
        for j in range(1, self.n_convs + 1):
            self.add_module(f"conv{j}", nn.Conv2d(in_channels if j == 1 else out_channels, out_channels,
                                                  self.kernel, padding=self.kernel // 2, bias=False))
            self.add_module(f"bn{j}", nn.BatchNorm2d(out_channels))

    def forward(self, x: torch.Tensor, pool_size=(2, 2), pool_type: str = "avg",
                train: bool = False) -> torch.Tensor:
        for j in range(1, self.n_convs + 1):
            h = batch_norm(conv(x, getattr(self, f"conv{j}")), getattr(self, f"bn{j}"), train)
            x = F.relu(h).to(x.dtype)
        return _pool(x, pool_size, pool_type)


class ConvBlock5x5(ConvBlock):
    """One 5x5 conv + BN + ReLU, then the pool (Cnn6)."""

    kernel = 5


class PANN(nn.Module):
    """``forward(wav)`` [B, T] at ``sample_rate`` (or ``mel=`` [B, frames,
    mel_bins], before bn0) -> dict of ``embedding`` [B, embed_dim] and
    ``clipwise_output`` [B, num_classes]. ``cfg`` is a ``PANNConfig``.
    ``compute_dtype`` runs the blocks after bn0 in another dtype (the
    BatchNorms in float32)."""

    def __init__(self, cfg, generator: Optional[torch.Generator] = None,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.cfg = cfg
        self.compute_dtype = compute_dtype
        self.channels = CHANNELS[cfg.arch]
        self.embed_dim = EMBED_DIM[cfg.arch]
        self.bn0 = nn.BatchNorm2d(cfg.mel_bins)
        block = ConvBlock5x5 if cfg.arch == "Cnn6" else ConvBlock
        for i, (cin, cout) in enumerate(zip((1,) + self.channels[:-1], self.channels)):
            self.add_module(f"conv_block{i + 1}", block(cin, cout))
        self.fc1 = nn.Linear(self.channels[-1], self.embed_dim)
        self.fc_audioset = nn.Linear(self.embed_dim, cfg.num_classes)
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                lecun_normal_(m.weight, m.weight[0].numel(), generator)
            elif isinstance(m, nn.Linear):
                init_linear_(m, generator)

    def blocks(self):
        return [getattr(self, f"conv_block{i + 1}") for i in range(len(self.channels))]

    def forward(self, wav: Optional[torch.Tensor] = None, *, mel: Optional[torch.Tensor] = None,
                train: bool = False) -> dict:
        cfg = self.cfg
        if mel is None:
            mel = logmel(wav.float(), sr=cfg.sample_rate, n_fft=cfg.window_size_fft, hop=cfg.hop_size,
                         n_mels=cfg.mel_bins, fmin=cfg.fmin, fmax=cfg.fmax)  # [B, T, F]
        x = batch_norm(mel.float().transpose(1, 2)[..., None], self.bn0, train)  # over the mel bins
        x = x.squeeze(-1).transpose(1, 2)[:, None].to(self.compute_dtype or torch.float32)  # [B, 1, T, F]
        blocks = self.blocks()
        for i, block in enumerate(blocks):
            last = i == len(blocks) - 1 and cfg.arch == "Cnn14"
            x = block(x, pool_size=(1, 1) if last else (2, 2), pool_type="avg", train=train)
        x = x.mean(dim=3)  # [B, C, T'], mean over frequency
        x = x.amax(dim=2) + x.mean(dim=2)
        emb = F.relu(linear(x, self.fc1))
        clipwise = torch.sigmoid(linear(emb, self.fc_audioset))
        return {"embedding": emb.float(), "clipwise_output": clipwise.float()}
