"""Audio resampling and prompt preparation (port of open_musiclm_tpu/ops/audio.py).

``resample`` is torchaudio's ``sinc_interp_hann`` polyphase resampler
(width 6, rolloff 0.99) written as one strided convolution: after the gcd
reduction of the two rates, a [new, K] filter bank slides over the padded
wave with stride ``orig`` and the ``new`` phases are interleaved.
``prepare_audio`` mixes to mono, normalizes, crops, resamples and rounds
through int16, as the reference's ``prepare_audio`` does.
"""

from __future__ import annotations

import functools
import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F


@functools.lru_cache(maxsize=32)
def _resample_kernel(
    orig_freq: int, new_freq: int, lowpass_filter_width: int = 6, rolloff: float = 0.99
) -> Tuple[np.ndarray, int]:
    """(kernels [new_freq, K] float32, width) for reduced rates."""
    if orig_freq <= 0 or new_freq <= 0:
        raise ValueError(f"rates must be positive, got {orig_freq} -> {new_freq}")
    base_freq = min(orig_freq, new_freq) * rolloff
    width = math.ceil(lowpass_filter_width * orig_freq / base_freq)
    idx = np.arange(-width, width + orig_freq, dtype=np.float64) / orig_freq
    t = idx[None, :] - np.arange(new_freq, dtype=np.float64)[:, None] / new_freq
    t = np.clip(t * base_freq, -lowpass_filter_width, lowpass_filter_width)
    window = np.cos(t * np.pi / lowpass_filter_width / 2) ** 2
    t_pi = t * np.pi
    kernel = np.where(t_pi == 0, 1.0, np.sin(t_pi) / np.where(t_pi == 0, 1.0, t_pi))
    kernel = kernel * window * (base_freq / orig_freq)
    return kernel.astype(np.float32), width


def resample(wav: torch.Tensor, orig_freq: int, new_freq: int, **kw) -> torch.Tensor:
    """[..., T] -> [..., ceil(T * new / orig)], torchaudio-compatible."""
    if orig_freq == new_freq:
        return wav
    g = math.gcd(int(orig_freq), int(new_freq))
    orig, new = int(orig_freq) // g, int(new_freq) // g
    kernels, width = _resample_kernel(orig, new, **kw)
    shape, T = wav.shape, wav.shape[-1]
    x = F.pad(wav.reshape(-1, 1, T), (width, width + orig))
    weight = torch.from_numpy(kernels).to(wav.device, wav.dtype)[:, None, :]
    y = F.conv1d(x, weight, stride=orig)  # [B, new, frames]
    B, P, n = y.shape
    target_len = int(math.ceil(new * T / orig))
    y = y.transpose(1, 2).reshape(B, n * P)[:, :target_len]
    return y.reshape(shape[:-1] + (target_len,))


def zero_mean_unit_var_norm(x: torch.Tensor, eps: float = 1e-7) -> torch.Tensor:
    """Per-row normalization over the last axis with the unbiased variance."""
    n = x.shape[-1]
    mean = x.mean(dim=-1, keepdim=True)
    var = (x - mean).square().mean(dim=-1, keepdim=True) * n / max(n - 1, 1)
    return (x - mean) / torch.sqrt(var + eps)


def int16_round_trip(x: torch.Tensor) -> torch.Tensor:
    """float -> int16 (truncating) -> float32 in [-1, 1]. The divisor is a
    tensor on ``x``'s device: CUDA divides by a host scalar as a product
    with its reciprocal, a float32 ulp off the quotient for ~2 % of codes."""
    q = (torch.clamp(x, -1.0, 1.0) * 32767.0).to(torch.int16)
    return q.to(torch.float32) / torch.tensor(32767.0, device=x.device)


def prepare_audio(
    wav: torch.Tensor,
    sample_hz: int,
    target_sample_hz: int,
    *,
    normalize: bool = True,
    target_length_seconds: Optional[float] = None,
) -> torch.Tensor:
    """[C, T] or [B, T] -> [1 or B, T'] at ``target_sample_hz``: a first
    axis longer than 1 is averaged (a [2, T] input is one stereo clip), then
    normalize, crop to ``target_length_seconds``, resample, int16 round trip."""
    if wav.ndim == 2 and wav.shape[0] > 1:
        wav = wav.mean(dim=0, keepdim=True)
    if normalize:
        wav = zero_mean_unit_var_norm(wav)
    if target_length_seconds is not None:
        wav = wav[..., : int(target_length_seconds * sample_hz)]
    return int16_round_trip(resample(wav, sample_hz, target_sample_hz))
