"""Decoder-only transformer core (port of open_musiclm_tpu/models/transformer.py).

  * bias-free LayerNorm
  * cosine-sim attention with one K/V head shared by all query heads; K and
    V project from the UN-normed residual, Q from the normed one
  * continuous-MLP relative position bias
  * GEGLU conv feed-forward with a causal depthwise 3-tap conv

``forward`` is the full causal pass (training, with an optional key mask
and FF dropout in ``train()`` mode); ``prefill`` is the same pass that also
fills the decode cache (per-layer K, V and the conv-FF tap state). The
decode step itself lives in ``models/quant_decode.py``.

Parameters may be float32 master weights while the pass runs in bfloat16
(the JAX package's ``dtype=bfloat16`` with float32 params): every weight is
cast to the activations' dtype at its use, and LayerNorm returns the
activations' dtype. With weights already in the activations' dtype (the
serving path) the casts are no-ops. Attention dropout is not ported.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import l2norm, shared_kv_attention_train
from ..ops.relpos import init_linear_, lecun_normal_, linear, make_bias


def layer_norm(x: torch.Tensor, gamma: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Bias-free LayerNorm in float32, returned in x's dtype."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, unbiased=False, keepdim=True)
    return ((xf - mean) * torch.rsqrt(var + eps) * gamma.float()).to(x.dtype)


class LayerNorm(nn.Module):
    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.gamma = nn.Parameter(torch.ones(dim))
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm(x, self.gamma, self.eps)


def grad_shrink(x: torch.Tensor, alpha: float = 0.1) -> torch.Tensor:
    """Scale gradients by alpha; the value is x * alpha + x * (1 - alpha),
    rounded as the JAX package rounds it."""
    return x * alpha + x.detach() * (1.0 - alpha)


def dropout(u: torch.Tensor, rate: float, generator: Optional[torch.Generator]) -> torch.Tensor:
    """Inverted dropout as the JAX package writes it, ``where(keep, u / keep_prob, 0)``,
    with the keep mask drawn from ``generator`` (None: the default generator
    of u's device)."""
    keep_prob = 1.0 - rate
    keep = torch.rand(u.shape, generator=generator, device=u.device) < keep_prob
    return torch.where(keep, u / keep_prob, torch.zeros((), dtype=u.dtype, device=u.device))


def _linear(d_in: int, d_out: int, generator: Optional[torch.Generator]) -> nn.Linear:
    layer = nn.Linear(d_in, d_out, bias=False)
    init_linear_(layer, generator)
    return layer


class Attention(nn.Module):
    def __init__(self, dim: int, heads: int = 8, dim_head: int = 64, scale: float = 8.0,
                 non_causal_prefix: int = 0, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.heads, self.dim_head, self.scale = heads, dim_head, scale
        self.non_causal_prefix = non_causal_prefix
        self.norm = LayerNorm(dim)
        self.to_q = _linear(dim, heads * dim_head, generator)
        self.to_kv = _linear(dim, 2 * dim_head, generator)
        self.q_scale = nn.Parameter(torch.ones(dim_head))
        self.k_scale = nn.Parameter(torch.ones(dim_head))
        self.to_out = _linear(heads * dim_head, dim, generator)

    def qkv(self, h: torch.Tensor, x_raw: torch.Tensor):
        """h: normed [b, n, dim]; x_raw: the UN-normed input (K/V project from
        it, a reference quirk kept for checkpoint parity)."""
        b, n, _ = h.shape
        q = linear(h, self.to_q).reshape(b, n, self.heads, self.dim_head).transpose(1, 2)
        k, v = linear(x_raw, self.to_kv).chunk(2, dim=-1)
        q = l2norm(q) * self.q_scale.to(q.dtype)
        k = l2norm(k) * self.k_scale.to(k.dtype)
        return q.contiguous(), k.contiguous(), v.contiguous()

    def forward(self, x: torch.Tensor, *, attn_bias: Optional[torch.Tensor] = None,
                key_mask: Optional[torch.Tensor] = None):
        """key_mask: [b, n] bool, True = attend. Returns (output [b, n, dim], (k, v))."""
        q, k, v = self.qkv(self.norm(x), x)
        out = shared_kv_attention_train(
            q, k, v, attn_bias, key_mask, scale=self.scale, causal=True,
            non_causal_prefix=self.non_causal_prefix,
        )
        return linear(out, self.to_out), (k, v)


class ConvFeedForward(nn.Module):
    """LN -> Linear(2*inner) -> causal depthwise conv(k=3) -> GEGLU -> LN ->
    Linear(dim), inner = int(dim * 2 * mult / 3). ``conv_w`` is tap-major
    [3, 2*inner], the JAX layout."""

    def __init__(self, dim: int, mult: int = 4, generator: Optional[torch.Generator] = None,
                 dropout: float = 0.0):
        super().__init__()
        inner = int(dim * 2 * mult / 3)
        self.inner_dim = inner
        self.dropout = dropout
        self.norm_in = LayerNorm(dim)
        self.proj_in = _linear(dim, 2 * inner, generator)
        self.conv_w = nn.Parameter(torch.empty(3, 2 * inner))
        lecun_normal_(self.conv_w, 3, generator)  # flax fan_in of a [3, c] kernel
        self.norm_mid = LayerNorm(inner)
        self.proj_out = _linear(inner, dim, generator)

    def dsconv_full(self, u: torch.Tensor) -> torch.Tensor:
        """Causal depthwise conv over [b, n, c] with left pad 2."""
        w = self.conv_w.to(u.dtype)
        up = F.pad(u, (0, 0, 2, 0))
        return up[:, :-2] * w[0] + up[:, 1:-1] * w[1] + up[:, 2:] * w[2]

    @staticmethod
    def geglu(u: torch.Tensor) -> torch.Tensor:
        val, gate = u.chunk(2, dim=-1)  # first half value, second half gate
        return F.gelu(gate, approximate="none") * val

    def forward_with_state(
        self, x: torch.Tensor, generator: Optional[torch.Generator] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Full-sequence FF plus the last two pre-conv rows [b, 2, 2*inner]
        that seed the decode conv state (zero-padded for n < 2). In train()
        mode the mid activations get dropout drawn from ``generator``."""
        u = linear(self.norm_in(x), self.proj_in)
        n = u.shape[1]
        tail = u[:, -2:] if n >= 2 else F.pad(u, (0, 0, 2 - n, 0))
        h = self.norm_mid(self.geglu(self.dsconv_full(u)))
        if self.training and self.dropout > 0.0:
            h = dropout(h, self.dropout, generator)
        return linear(h, self.proj_out), tail

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        return self.forward_with_state(x, generator)[0]


class Transformer(nn.Module):
    def __init__(self, dim: int, depth: int, heads: int = 8, dim_head: int = 64,
                 grad_shrink_alpha: float = 0.1, non_causal_prefix_size: int = 0,
                 relative_position_bias_type: str = "continuous", attn_scale: float = 8.0,
                 ff_mult: int = 4, ff_dropout: float = 0.0,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dim, self.depth, self.heads, self.dim_head = dim, depth, heads, dim_head
        self.grad_shrink_alpha = grad_shrink_alpha
        self.rel_pos_bias = make_bias(relative_position_bias_type, dim, heads, generator)
        self.attns = nn.ModuleList(
            Attention(dim, heads, dim_head, attn_scale, non_causal_prefix_size, generator)
            for _ in range(depth)
        )
        self.ffs = nn.ModuleList(
            ConvFeedForward(dim, ff_mult, generator, dropout=ff_dropout) for _ in range(depth)
        )
        self.final_norm = LayerNorm(dim)

    @property
    def ff_state_dim(self) -> int:
        return 2 * self.ffs[0].inner_dim

    def _bias(self, n: int, dtype: torch.dtype) -> Optional[torch.Tensor]:
        return self.rel_pos_bias(n, dtype) if self.rel_pos_bias is not None else None

    def forward(self, x: torch.Tensor, *, self_attn_mask: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """x: [b, n, dim] in the compute dtype; self_attn_mask: [b, n] bool key
        mask, True = attend; generator: FF dropout draws in train() mode."""
        x = grad_shrink(x, self.grad_shrink_alpha)
        bias = self._bias(x.shape[1], x.dtype)
        for attn, ff in zip(self.attns, self.ffs):
            x = attn(x, attn_bias=bias, key_mask=self_attn_mask)[0] + x
            x = ff(x, generator) + x
        return self.final_norm(x)

    def init_cache(self, batch: int, max_len: int) -> Dict[str, torch.Tensor]:
        """Zeroed cache: stacked per-layer K/V and conv-FF tap state. Every
        prompt position is valid (the JAX cache's key mask is all True on the
        ported paths, so the port does not carry it)."""
        p = self.final_norm.gamma
        d, dt, dev = self.dim_head, self.attns[0].to_q.weight.dtype, p.device
        return {
            "k": torch.zeros((self.depth, batch, max_len, d), dtype=dt, device=dev),
            "v": torch.zeros((self.depth, batch, max_len, d), dtype=dt, device=dev),
            "ff": torch.zeros((self.depth, batch, 2, self.ff_state_dim), dtype=dt, device=dev),
        }

    def bias_table(self, max_len: int) -> Optional[torch.Tensor]:
        """Decode-layout rel-pos bias [2N-1, h]: reversed and padded so that
        row (N-1-pos)+j holds the bias at causal distance pos-j; a decode
        step's bias row is then the contiguous slice [N-1-pos, 2N-1-pos)."""
        if self.rel_pos_bias is None:
            return None
        table = self.rel_pos_bias.distance_table(max_len)  # [N, h]
        pad = table[:1].expand(max_len - 1, table.shape[1])
        return torch.cat([table.flip(0), pad], dim=0)

    def prefill(self, x: torch.Tensor, cache: Dict[str, torch.Tensor]):
        """Causal forward over the prompt that fills cache[:, :, :n] in place.
        Returns (normed outputs [b, n, dim], cache)."""
        n = x.shape[1]
        x = grad_shrink(x, self.grad_shrink_alpha)
        bias = self._bias(n, x.dtype)
        for i, (attn, ff) in enumerate(zip(self.attns, self.ffs)):
            out, (k, v) = attn(x, attn_bias=bias)
            x = out + x
            u, tail = ff.forward_with_state(x)
            x = u + x
            cache["k"][i, :, :n] = k
            cache["v"][i, :, :n] = v
            cache["ff"][i] = tail
        return self.final_norm(x), cache
