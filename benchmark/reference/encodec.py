"""Plain reference of the Encodec 24 kHz decoder (SEANet with an LSTM stem),
written from the published architecture and independent of the program.

codes [b, T, n_q] -> the sum of each quantizer's codebook rows [b, T, 128]
-> causal conv (k 7) to 512 channels -> a 2-layer LSTM with a skip -> per
ratio (8, 5, 4, 2): ELU, causal transposed conv (k 2r, stride r, the last
k - r samples trimmed), a residual block (ELU, conv k 3 to half the
channels, ELU, conv k 1 back, plus a k 1 shortcut of the input) -> ELU,
causal conv (k 7) to one channel. A causal conv pads on the left by
(k - 1) d + 1 - stride samples, reflected, and on the right as far as a
partial last frame needs.

``dtype`` float32 (with TF32 off, as the caller sets) or bfloat16, the
control of a float32 codec. Weights come as a ``{name: tensor}`` dict in
the layout ``benchmark/weights.py`` makes.
"""

from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F

RATIOS = (8, 5, 4, 2)


class EncodecDecoderReference:
    def __init__(self, weights: Dict[str, torch.Tensor], dtype: torch.dtype = torch.float32):
        self.dtype = dtype
        self.w = {k: v.detach().to(dtype) for k, v in weights.items()
                  if k.startswith("decoder.") or k == "codebooks"}

    def _conv(self, x: torch.Tensor, name: str, stride: int = 1, dilation: int = 1) -> torch.Tensor:
        w, b = self.w[name + ".conv.weight"], self.w[name + ".conv.bias"]
        k = w.shape[-1]
        eff = (k - 1) * dilation + 1
        pad = eff - stride
        T = x.shape[-1]
        frames = (T - eff + pad) / stride + 1
        right = max((math.ceil(frames) - 1) * stride + (eff - pad) - T, 0)
        extra = max(pad, right) - T + 1 if max(pad, right) >= T else 0
        if extra:
            x = F.pad(x, (0, extra))
        x = F.pad(x, (pad, right), mode="reflect")
        if extra:
            x = x[..., : x.shape[-1] - extra]
        return F.conv1d(x, w, b, stride=stride, dilation=dilation)

    def _lstm(self, x: torch.Tensor) -> torch.Tensor:
        """[b, T, C] through two LSTM layers (gates i, f, g, o), plus x."""
        h_in = x
        for layer in range(2):
            p = f"decoder.lstm.lstm."
            wi, wh = self.w[f"{p}weight_ih_l{layer}"], self.w[f"{p}weight_hh_l{layer}"]
            bias = self.w[f"{p}bias_ih_l{layer}"] + self.w[f"{p}bias_hh_l{layer}"]
            pre = h_in @ wi.t() + bias  # [b, T, 4H]
            H = wh.shape[1]
            h = x.new_zeros(x.shape[0], H)
            c = x.new_zeros(x.shape[0], H)
            outs = []
            for t in range(x.shape[1]):
                i, f, g, o = (pre[:, t] + h @ wh.t()).chunk(4, dim=-1)
                c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
                h = torch.sigmoid(o) * torch.tanh(c)
                outs.append(h)
            h_in = torch.stack(outs, dim=1)
        return x + h_in

    @torch.no_grad()
    def decode(self, codes: torch.Tensor) -> torch.Tensor:
        """codes [b, T, n_q] -> wave [b, T * 320] in float32."""
        books = self.w["codebooks"]
        z = sum(books[q][codes[..., q]] for q in range(codes.shape[-1]))  # [b, T, 128]
        h = self._conv(z.transpose(1, 2), "decoder.conv_in")
        h = self._lstm(h.transpose(1, 2)).transpose(1, 2)
        for i, r in enumerate(RATIOS):
            p = f"decoder.ups.{i}.convtr."
            h = F.conv_transpose1d(F.elu(h), self.w[p + "weight"], self.w[p + "bias"], stride=r)
            h = h[..., : h.shape[-1] - r]  # kernel 2r, stride r
            rp = f"decoder.res.{i}."
            y = self._conv(F.elu(h), rp + "block_conv1")
            y = self._conv(F.elu(y), rp + "block_conv2")
            h = self._conv(h, rp + "shortcut") + y
        out = self._conv(F.elu(h), "decoder.conv_out")[:, 0]
        return out if out.dtype == torch.float64 else out.float()
