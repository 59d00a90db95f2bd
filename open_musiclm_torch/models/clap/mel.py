"""Log-mel front end of the CLAP audio tower (port of
open_musiclm_tpu/models/clap/mel.py).

Power STFT (periodic hann, center=True, reflect pad) -> slaney-norm mel
filterbank -> power_to_db (ref 1.0, amin 1e-10, no top_db), as
torchlibrosa's Spectrogram + LogmelFilterBank. CLAP's geometry: 48 kHz,
n_fft 1024, hop 480, 64 mels, 50 Hz to 14 kHz: 1001 frames for a 10 s clip.
The filterbank and window are numpy constants; the STFT is ``torch.fft.rfft``
over framed windows. ``spec_augment`` is the training-time SpecAugment
HTSAT applies after bn0 (``htsat.py``, ``train=True``).
"""

from __future__ import annotations

import functools
import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F


def hz_to_mel_slaney(f: np.ndarray) -> np.ndarray:
    f = np.asarray(f, dtype=np.float64)
    f_sp = 200.0 / 3
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = math.log(6.4) / 27.0
    return np.where(f >= min_log_hz, min_log_mel + np.log(np.maximum(f, 1e-10) / min_log_hz) / logstep,
                    f / f_sp)


def mel_to_hz_slaney(m: np.ndarray) -> np.ndarray:
    m = np.asarray(m, dtype=np.float64)
    f_sp = 200.0 / 3
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = math.log(6.4) / 27.0
    return np.where(m >= min_log_mel, min_log_hz * np.exp(logstep * (m - min_log_mel)), m * f_sp)


@functools.lru_cache(maxsize=8)
def mel_filterbank(sr: int, n_fft: int, n_mels: int, fmin: float, fmax: float) -> np.ndarray:
    """librosa.filters.mel (htk=False, norm='slaney'): [1 + n_fft // 2, n_mels] float32."""
    fftfreqs = np.linspace(0.0, sr / 2.0, 1 + n_fft // 2)
    mel_pts = np.linspace(hz_to_mel_slaney(np.array(fmin)), hz_to_mel_slaney(np.array(fmax)), n_mels + 2)
    mel_f = mel_to_hz_slaney(mel_pts)
    fdiff = np.diff(mel_f)
    ramps = mel_f[:, None] - fftfreqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))
    weights = weights * (2.0 / (mel_f[2: n_mels + 2] - mel_f[:n_mels]))[:, None]
    return weights.T.astype(np.float32)


@functools.lru_cache(maxsize=8)
def hann_window(n: int) -> np.ndarray:
    """Periodic hann (librosa get_window, fftbins=True), float32."""
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(n) / n)).astype(np.float32)


def stft_power(x: torch.Tensor, n_fft: int, hop: int, *, center: bool = True) -> torch.Tensor:
    """[B, T] -> power spectrogram [B, frames, 1 + n_fft // 2]."""
    if center:
        x = F.pad(x[:, None], (n_fft // 2, n_fft // 2), mode="reflect")[:, 0]
    frames = x.unfold(-1, n_fft, hop)  # [B, frames, n_fft]
    spec = torch.fft.rfft(frames * torch.from_numpy(hann_window(n_fft)).to(x.device, x.dtype), dim=-1)
    return spec.real.square() + spec.imag.square()


def logmel(
    x: torch.Tensor,
    *,
    sr: int = 48000,
    n_fft: int = 1024,
    hop: int = 480,
    n_mels: int = 64,
    fmin: float = 50.0,
    fmax: float = 14000.0,
    amin: float = 1e-10,
    ref: float = 1.0,
    top_db: Optional[float] = None,
) -> torch.Tensor:
    """[B, T] waveform -> [B, frames, n_mels] log-mel in dB."""
    power = stft_power(x, n_fft, hop)
    fb = torch.from_numpy(mel_filterbank(sr, n_fft, n_mels, fmin, fmax)).to(x.device, power.dtype)
    log_spec = 10.0 * torch.log10(torch.clamp(power @ fb, min=amin)) - 10.0 * math.log10(max(amin, ref))
    if top_db is not None:
        log_spec = torch.maximum(log_spec, log_spec.max() - top_db)
    return log_spec


def spec_augment_stripes(generator: Optional[torch.Generator], batch: int, length: int, drop_width: int,
                         stripes_num: int, device=None):
    """One axis's SpecAugment stripes, (starts, widths) [B, stripes_num]:
    each of width ``randint(0, drop_width + 1)`` starting at ``randint(0,
    max(length - width, 1))`` (torchlibrosa's DropStripes, as the JAX
    package draws them), from ``generator`` (the JAX package's
    ``jax.random`` draws cannot be reproduced)."""
    widths = torch.randint(0, drop_width + 1, (batch, stripes_num), generator=generator, device=device)
    high = torch.clamp(length - widths, min=1)
    u = torch.rand((batch, stripes_num), generator=generator, device=device, dtype=torch.float64)
    return (u * high).long(), widths


def stripe_mask(starts: torch.Tensor, widths: torch.Tensor, length: int) -> torch.Tensor:
    """[B, length] float32 keep mask: 0 on every stripe [start, start + width)."""
    pos = torch.arange(length, device=starts.device)[None, None, :]
    hit = (pos >= starts[..., None]) & (pos < (starts + widths)[..., None])
    return (~hit.any(dim=1)).float()


def spec_augment(generator: Optional[torch.Generator], mel: torch.Tensor, *, time_drop_width: int = 64,
                 time_stripes_num: int = 2, freq_drop_width: int = 8, freq_stripes_num: int = 2) -> torch.Tensor:
    """Training-time SpecAugment of mel [B, frames, mel_bins]: per example,
    time and frequency stripes (``spec_augment_stripes``) drawn from
    ``generator`` zero the spectrogram."""
    B, T, F_ = mel.shape
    time_mask = stripe_mask(*spec_augment_stripes(generator, B, T, time_drop_width, time_stripes_num,
                                                  mel.device), T)
    freq_mask = stripe_mask(*spec_augment_stripes(generator, B, F_, freq_drop_width, freq_stripes_num,
                                                  mel.device), F_)
    return apply_spec_augment(mel, time_mask, freq_mask)


def apply_spec_augment(mel: torch.Tensor, time_mask: torch.Tensor, freq_mask: torch.Tensor) -> torch.Tensor:
    """mel [B, frames, mel_bins] times the keep masks [B, frames] and
    [B, mel_bins], in the JAX package's order."""
    return mel * time_mask[:, :, None].to(mel.dtype) * freq_mask[:, None, :].to(mel.dtype)
