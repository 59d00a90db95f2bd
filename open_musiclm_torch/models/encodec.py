"""Encodec 24 kHz codec (port of open_musiclm_tpu/models/encodec.py).

Decode: SEANet causal conv decoder with a 2-layer LSTM stem: RVQ dequantize
-> conv_in -> LSTM (frame rate) -> transposed-conv upsampling + resblocks ->
conv_out (sample rate). Encode: the SEANet encoder (conv_in, per stage a
resblock and a strided downsampling conv, LSTM, conv_out) -> latent at the
frame rate -> residual nearest-code loop over the codebooks. Convolutions
run on torch's [B, C, T]; the public functions keep the JAX layouts
([B, T', n_q] codes, [B, T', D] latent and stem state, [B, T] waveform).

``EncodecModel.compute_dtype`` (None: the parameters' dtype) runs the convs
in another dtype, flax's ``dtype``, the weights cast at their use; the LSTM
recurs in its parameters' dtype and the nearest-code loop in the
codebooks'.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.relpos import conv, lecun_normal_


def _pad1d_reflect(x: torch.Tensor, left: int, right: int) -> torch.Tensor:
    """Reflect-pad the time axis of [B, C, T]; a signal shorter than the pad
    is zero-extended first and trimmed after (encodec's pad1d guard)."""
    T = x.shape[-1]
    extra = 0
    if max(left, right) >= T:
        extra = max(left, right) - T + 1
        x = F.pad(x, (0, extra))
    y = F.pad(x, (left, right), mode="reflect")
    return y[..., : y.shape[-1] - extra] if extra else y


def _init_conv_(conv: nn.Module, generator: Optional[torch.Generator]) -> None:
    """flax Conv init: lecun-normal over fan_in = kernel * in, zero bias."""
    w = conv.weight
    fan_in = w.shape[-1] * (w.shape[0] if isinstance(conv, nn.ConvTranspose1d) else w.shape[1])
    lecun_normal_(w, fan_in, generator)
    with torch.no_grad():
        conv.bias.zero_()


class CausalConv1d(nn.Module):
    """Conv1d with encodec's causal left padding, plus the right padding that
    completes a partial final frame."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int, stride: int = 1,
                 dilation: int = 1, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.conv = nn.Conv1d(in_ch, out_ch, kernel, stride=stride, dilation=dilation)
        _init_conv_(self.conv, generator)
        self.kernel, self.stride, self.dilation = kernel, stride, dilation

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # [B, C, T]
        eff_k = (self.kernel - 1) * self.dilation + 1
        pad_total = eff_k - self.stride
        T = x.shape[-1]
        n_frames = (T - eff_k + pad_total) / self.stride + 1
        ideal = (math.ceil(n_frames) - 1) * self.stride + (eff_k - pad_total)
        return conv(_pad1d_reflect(x, pad_total, max(ideal - T, 0)), self.conv)


class CausalConvTranspose1d(nn.Module):
    """ConvTranspose1d trimming ``kernel - stride`` samples from the right."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int, stride: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.convtr = nn.ConvTranspose1d(in_ch, out_ch, kernel, stride=stride)
        _init_conv_(self.convtr, generator)
        self.trim = kernel - stride

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        ct = self.convtr
        y = ct(x) if ct.weight.dtype == x.dtype else F.conv_transpose1d(
            x, ct.weight.to(x.dtype), ct.bias.to(x.dtype), stride=ct.stride)
        return y[..., : y.shape[-1] - self.trim] if self.trim > 0 else y


class SEANetResnetBlock(nn.Module):
    def __init__(self, dim: int, compress: int = 2, residual_kernel: int = 3,
                 dilation: int = 1, generator: Optional[torch.Generator] = None):
        super().__init__()
        hidden = dim // compress
        self.block_conv1 = CausalConv1d(dim, hidden, residual_kernel, dilation=dilation, generator=generator)
        self.block_conv2 = CausalConv1d(hidden, dim, 1, generator=generator)
        self.shortcut = CausalConv1d(dim, dim, 1, generator=generator)  # true_skip=False

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.block_conv2(F.elu(self.block_conv1(F.elu(x))))
        return self.shortcut(x) + h


class StreamLSTM(nn.Module):
    """2-layer LSTM with a skip connection (encodec SLSTM) over [B, T, C];
    the JAX package already uses torch's gate order (i, f, g, o). The
    recurrence runs in the LSTM parameters' dtype."""

    def __init__(self, hidden: int, num_layers: int = 2,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.lstm = nn.LSTM(hidden, hidden, num_layers=num_layers, batch_first=True)
        for layer in range(num_layers):
            for kind in ("ih", "hh"):
                w = getattr(self.lstm, f"weight_{kind}_l{layer}")
                lecun_normal_(w, w.shape[0], generator)  # flax fan_in of a [4H, C] kernel
                with torch.no_grad():
                    getattr(self.lstm, f"bias_{kind}_l{layer}").zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y, _ = self.lstm(x.to(self.lstm.weight_ih_l0.dtype))
        return x + y.to(x.dtype)


class SEANetDecoder(nn.Module):
    def __init__(self, channels: int = 1, dimension: int = 128, n_filters: int = 32,
                 ratios: Sequence[int] = (8, 5, 4, 2), kernel_size: int = 7,
                 last_kernel_size: int = 7, residual_kernel_size: int = 3,
                 compress: int = 2, lstm_layers: int = 2,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        mult = int(2 ** len(ratios))
        self.conv_in = CausalConv1d(dimension, mult * n_filters, kernel_size, generator=generator)
        self.lstm = StreamLSTM(mult * n_filters, lstm_layers, generator=generator)
        self.ups = nn.ModuleList()
        self.res = nn.ModuleList()
        for ratio in ratios:
            self.ups.append(CausalConvTranspose1d(
                mult * n_filters, mult * n_filters // 2, ratio * 2, ratio, generator=generator))
            self.res.append(SEANetResnetBlock(
                mult * n_filters // 2, compress, residual_kernel_size, 1, generator=generator))
            mult //= 2
        self.conv_out = CausalConv1d(n_filters, channels, last_kernel_size, generator=generator)

    def stem(self, z: torch.Tensor) -> torch.Tensor:  # [B, T', D] -> [B, T', C]
        """Frame-rate prefix: input conv + LSTM."""
        h = self.conv_in(z.transpose(1, 2)).transpose(1, 2)
        return self.lstm(h)

    def head(self, h: torch.Tensor) -> torch.Tensor:  # [B, T', C] -> [B, 1, T]
        """Upsampling suffix; rows are independent, so callers may chunk them."""
        h = h.transpose(1, 2)
        for up, res in zip(self.ups, self.res):
            h = res(up(F.elu(h)))
        return self.conv_out(F.elu(h))


class SEANetEncoder(nn.Module):
    def __init__(self, channels: int = 1, dimension: int = 128, n_filters: int = 32,
                 ratios: Sequence[int] = (8, 5, 4, 2), kernel_size: int = 7,
                 last_kernel_size: int = 7, residual_kernel_size: int = 3,
                 compress: int = 2, lstm_layers: int = 2,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        mult = 1
        self.conv_in = CausalConv1d(channels, n_filters, kernel_size, generator=generator)
        self.res = nn.ModuleList()
        self.downs = nn.ModuleList()
        for ratio in reversed(tuple(ratios)):
            self.res.append(SEANetResnetBlock(
                mult * n_filters, compress, residual_kernel_size, 1, generator=generator))
            self.downs.append(CausalConv1d(
                mult * n_filters, mult * n_filters * 2, ratio * 2, stride=ratio, generator=generator))
            mult *= 2
        self.lstm = StreamLSTM(mult * n_filters, lstm_layers, generator=generator)
        self.conv_out = CausalConv1d(mult * n_filters, dimension, last_kernel_size, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # [B, 1, T] -> [B, T', D]
        h = self.conv_in(x)
        for res, down in zip(self.res, self.downs):
            h = down(F.elu(res(h)))
        h = self.lstm(h.transpose(1, 2)).transpose(1, 2)
        return self.conv_out(F.elu(h)).transpose(1, 2)


class EncodecModel(nn.Module):
    """Codec: ``encode`` [B, T] waveform -> [B, T', n_q] codes, ``decode``
    the way back. Coarse codes are codes[..., :3], fine codes[..., 3:]. The
    encoder's seeded draws come after the decoder's and the codebooks'."""

    def __init__(self, sample_rate: int = 24000, channels: int = 1, num_quantizers: int = 8,
                 codebook_size: int = 1024, dimension: int = 128, n_filters: int = 32,
                 ratios: Sequence[int] = (8, 5, 4, 2),
                 generator: Optional[torch.Generator] = None,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.sample_rate = sample_rate
        self.compute_dtype = compute_dtype
        self.ratios = tuple(ratios)
        self.decoder = SEANetDecoder(channels, dimension, n_filters, ratios, generator=generator)
        with torch.no_grad():
            self.codebooks = nn.Parameter(nn.init.normal_(
                torch.empty(num_quantizers, codebook_size, dimension), generator=generator))
        self.encoder = SEANetEncoder(channels, dimension, n_filters, ratios, generator=generator)

    @property
    def hop_length(self) -> int:
        return math.prod(self.ratios)

    @property
    def num_quantizers(self) -> int:
        return self.codebooks.shape[0]

    @property
    def codebook_size(self) -> int:
        return self.codebooks.shape[1]

    @property
    def stream_dtype(self) -> torch.dtype:
        return self.compute_dtype or self.encoder.conv_in.conv.weight.dtype

    def embed(self, x: torch.Tensor) -> torch.Tensor:
        """[B, T] waveform -> latent [B, T', D] (before quantization)."""
        return self.encoder(x[:, None].to(self.stream_dtype))

    def quantize_embedding(self, z: torch.Tensor) -> torch.Tensor:
        """[B, T', D] -> int64 codes [B, T', n_q]: at each quantizer the code
        maximizing ``2 r.c - |c|^2`` (the first on a tie), subtracted from the
        residual r."""
        resid, idxs = z.to(self.codebooks.dtype), []
        for cb in self.codebooks:
            idx = torch.argmax(2.0 * resid @ cb.t() - cb.square().sum(-1), dim=-1)
            resid = resid - cb[idx]
            idxs.append(idx)
        return torch.stack(idxs, dim=-1)

    @torch.no_grad()
    def encode(self, x: torch.Tensor) -> torch.Tensor:
        """[B, T] waveform -> [B, T', n_q] codes."""
        return self.quantize_embedding(self.embed(x))

    def dequantize(self, codes: torch.Tensor) -> torch.Tensor:
        """[B, T', n_q] -> latent [B, T', D]."""
        out = self.codebooks[0][codes[..., 0]]
        for q in range(1, codes.shape[-1]):
            out = out + self.codebooks[q][codes[..., q]]
        return out

    def decode(self, codes: torch.Tensor) -> torch.Tensor:
        return self.decoder.head(self.decode_stem(codes))[:, 0]

    def decode_stem(self, codes: torch.Tensor) -> torch.Tensor:
        """codes -> frame-rate decoder state [B, T', C]."""
        return self.decoder.stem(self.dequantize(codes).to(self.stream_dtype))

    def decode_head(self, h: torch.Tensor) -> torch.Tensor:
        """Frame-rate state [B, T', C] -> [B, T] waveform."""
        return self.decoder.head(h)[:, 0]


def create_encodec_24khz(bandwidth: float = 6.0, codebook_size: int = 1024,
                         **kwargs) -> EncodecModel:
    """num_quantizers = bandwidth / 24 * 32 trained quantizers."""
    if bandwidth not in (1.5, 3.0, 6.0, 12.0, 24.0):
        raise ValueError(f"unsupported Encodec bandwidth {bandwidth}")
    return EncodecModel(num_quantizers=int(bandwidth / 24.0 * 32),
                        codebook_size=codebook_size, **kwargs)
